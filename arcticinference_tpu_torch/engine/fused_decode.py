"""Device-resident fused decode loop for speculative decoding.

Counterpart of ``arcticinference_tpu/engine/fused_decode.py`` on one GPU,
for suffix drafts, the Arctic MLP / LSTM drafters, or both.  While every
fusable running request sits at its decode frontier, one step is a pure
function of per-slot device state:

  state:  n_computed, last_token, drafts, draft_len, alive, limit,
          sampling params, stop ids, suffix ring / path, a generator
          (all [B]-shaped, on the device)
  step:   build positions / slots from the state
          -> model forward on the verify rows (drafts included)
          -> verify on the device (greedy prefix match, or sample and
             compare when temperature > 0)
          -> stop detection (eos, <= 4 stop ids, length)
          -> the drafter chain on the hidden row of each slot's bonus
             token (the last accepted row) as the next drafts
          -> advance the suffix path: ring buffer of emitted tokens, the
             host's path upload merged where its gap verifies against
             the ring, the surviving path walked as the next drafts
             (preferred over the drafter's while it lives; with a
             drafter the host uploads only paths whose score reaches
             ``num_speculative_tokens``)
  out:    an int32 telemetry block [B, K+2] the host drains with lag,
          and the verify rows' hidden states [B, K+1, hidden]

The step issues no host synchronisation: the host dispatches step N+1
before step N's telemetry lands (``pipeline_depth`` steps in flight) and
commits tokens and stops behind the device; block tables are extended
ahead for every step in flight.  The host picks each step's program from
what it already knows: wide (K+1 verify rows per slot), narrow (1 row),
or per slot (``rows_total``: each row its own qlen-1 sequence, 1 or K+1
rows a slot), and uploads a suffix path per slot walked from its
lag-synced prefix.  The width policy is suffix-only: with a drafter
every step is wide (K = the drafter's ``n_predict``), as in the JAX loop.

The step always returns the verify rows' hidden states, so that a
distillation capture (``spec/distill.py``) and the bench run the same
program; the host copies them, at the drain, only while the engine's
``hidden_capture`` hook is installed.

A SwiftKV model runs here too (the reference's "all-combined"
config: SwiftKV with a drafter and suffix decoding on this loop): at the
decode frontier every row is a sample row, so each program's forward
keeps all of them (``logits_indices`` = every row) and both of its
halves run the grouped decode kernel.

On a tp / sp / shift mesh every rank runs this loop in lockstep: the
forwards go through the runner's sharded forward at the mode of the
step's ``B * rows`` tokens (B a multiple of sp), the logits are the
gathered, whole-vocabulary ones, and the per-slot program is off, as in
the JAX loop.  On a served mesh (``parallel/multihost.py``) the leader
alone runs this controller: it announces the loop's initial state and
its generator's seed at entry, broadcasts each step's program key and
uploads (and the block table when it changed) before it dispatches, and
``fused_exit`` when it leaves; each follower replays the steps.  The
drafter's parameters are a copy that every rank holds.

With in-engine dp the slots are dp-major, as in the JAX loop: group g
owns slots ``[g*Bs, (g+1)*Bs)``, filled with its requests, whose block
tables hold its shard-local block ids; the state stays whole on every
rank, each rank's forward runs its group's slots, and the rows are
gathered over dp.  Under pp the step's ``B * rows`` rows are split into
pp microbatches of ``B / pp`` whole slots (B is a multiple of pp, and of
sp), and each microbatch runs the grouped decode kernel with its slots'
block tables and lengths (``parallel/pp.py``), where the JAX loop runs
its plain attention.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

import numpy as np
import torch

from arcticinference_tpu_torch import envs
from arcticinference_tpu_torch.engine.block_manager import NoFreeBlocksError
from arcticinference_tpu_torch.ops.sampling import sample

logger = logging.getLogger("arcticinference_tpu_torch")

NO_TOKEN = -1
MAX_STOP_IDS = 4


# --------------------------------------------------------------------- #
# The fused device step
# --------------------------------------------------------------------- #

def build_fused_step(runner, drafter, num_spec: int, need_sampling: bool,
                     eos_token_id: Optional[int], use_suffix: bool = True,
                     path_len_max: int = 32, ring_w: int = 64,
                     wide: bool = True, rows_total: Optional[int] = None):
    """One fused decode step for draft length ``num_spec`` and a fixed
    sampling mode; the batch width B is read from the state.

    Returns ``fn(spec_params, state, block_tables[, h_pack[, rplan]]) ->
    (state, telemetry, hidden)``: ``spec_params`` the drafter's parameters (None
    without ``drafter``, an ``ArcticProposer``), ``state`` the loop's dict
    of device tensors (the returned dict replaces it), ``h_pack`` [B,
    PLEN+2] int32 the host's path upload per slot (tokens | absolute
    anchor index | usable length, 0 = nothing to offer; only with
    ``use_suffix``), ``telemetry`` [B, K+2] int32 (emitted tokens, -1 past
    the accepted ones, then the verified draft count), ``hidden`` [B, K+1,
    hidden] the verify rows' hidden states (row j's produced emitted token
    j; zeros where a program ran no such row).  The KV cache
    ``runner.kv`` is written in place (the JAX step donates it).

    ``wide=False`` builds the 1-row program; ``rows_total=R`` the per-slot
    program, whose ``rplan`` (int32 [2R+2B] = row_slot | row_off |
    slot_start | slot_rows) gives each slot its rows.  Everything after
    the forward is shared by the three.  A drafter chains from the wide
    program's hidden rows, so it takes the wide program only.
    """
    arch = runner.arch
    bs = runner.block_size
    maxblk = runner.max_blocks_per_req
    k = num_spec
    r = k + 1
    # Benchmark-only acceptance control: each next-step draft token is
    # corrupted with this probability (0: the normal program).
    corrupt = envs.ARCTIC_TPU_FUSED_CORRUPT_RATE
    eos = -1 if eos_token_id is None else int(eos_token_id)
    plen = path_len_max
    w = ring_w
    run_r = r if wide else 1
    if drafter is not None and (not wide or rows_total is not None):
        raise ValueError("a drafter chains from the wide program's hidden "
                         "rows; the narrow and per-slot programs keep none")

    def rowvals_of(logits, temperature, top_k, top_p, gen):
        if need_sampling:
            return sample(logits, temperature, top_k, top_p, gen)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.inference_mode()
    def step(spec_params, state, block_tables, h_pack=None, rplan=None):
        dev = block_tables.device
        n_comp = state["n_computed"]                       # [B]
        alive = state["alive"]                             # [B] 0/1
        dlen = state["draft_len"]                          # [B]
        b = n_comp.shape[0]
        bidx = torch.arange(b, dtype=torch.int32, device=dev)
        if rows_total is not None:
            # A slot granted w rows verifies at most w-1 drafts this step;
            # the rest stay in its path state (as the narrow program's
            # dlen = 0: an unverifiable draft is invisible to verify).
            R = rows_total
            row_slot = rplan[:R]
            row_off = rplan[R:2 * R]
            slot_start = rplan[2 * R:2 * R + b]
            slot_rows = rplan[2 * R + b:2 * R + 2 * b]
            dlen = torch.minimum(dlen, (slot_rows - 1).clamp(min=0))
        elif not wide:
            # No verify rows: any device drafts must not be verified, or
            # a lucky column-0 match would accept a token never computed.
            dlen = torch.zeros_like(dlen)
        limit = state["limit"]                             # [B] max total
        drafts = state["drafts"]                           # [B, max(K,1)]
        gen = state["generator"]
        kv_scale = runner.kv_scale

        def fwd_rowvals(rr, dlen_rr):
            """The model on B*rr rows (row i*rr+j = slot i's j-th verify
            row) through the grouped decode kernel; (rowvals [B, rr], the
            rows' hidden states [B*rr, hidden])."""
            jr = torch.arange(rr, dtype=torch.int32, device=dev)[None, :]
            tokens = torch.cat([state["last_token"][:, None],
                                drafts[:, :rr - 1]], dim=1)    # [B, rr]
            pos = n_comp[:, None] + jr                         # [B, rr]
            row_valid = ((alive[:, None] > 0) & (jr <= dlen_rr[:, None])
                         & (pos < limit[:, None]))
            blk = torch.gather(block_tables, 1,
                               (pos // bs).clamp(0, maxblk - 1).long())
            slot = torch.where(row_valid, blk * bs + pos % bs, -1)
            bt, seqs = block_tables, n_comp + rr
            if runner.dp > 1:
                # This rank's dp group's slots; the forward gathers the
                # groups' rows back into slot order.
                nb = b // runner.dp
                mine = slice(runner.mesh.dp_rank * nb,
                             (runner.mesh.dp_rank + 1) * nb)
                tokens, pos, row_valid, slot, bt, seqs = (
                    x[mine] for x in (tokens, pos, row_valid, slot, bt,
                                      seqs))
            nb = bt.shape[0]
            inputs = {
                "input_ids": tokens.reshape(-1),
                "positions": pos.reshape(-1),
                "req_idx": torch.where(row_valid, bidx[:nb, None],
                                       -1).reshape(-1),
                "slot_mapping": slot.reshape(-1).to(torch.int32),
                "block_tables": bt,
                "seq_lens": seqs,
                "kv_scale": kv_scale,
            }
            if runner.swift:
                # SwiftKV: every verify row is a sample row.
                inputs["logits_indices"] = torch.arange(
                    nb * rr, dtype=torch.int32, device=dev)
            # On a mesh the step's mode follows its B*rr rows.
            h = runner.forward(inputs, 1, decode_qlen=rr,
                               total_tokens=b * rr)
            logits = runner.logits(h)                      # [B*rr, V]
            rep = lambda x: x[:, None].expand(b, rr).reshape(-1)  # noqa
            rv = rowvals_of(logits, rep(state["temperature"]),
                            rep(state["top_k"]), rep(state["top_p"]), gen)
            return rv.reshape(b, rr), h

        def fwd_slotted():
            """Per-slot rows: each of the R rows is its own qlen-1
            sequence (its own seq_len and block-table row), gathered back
            to the uniform [B, K+1] layout after the forward."""
            s = row_slot.clamp(0, b - 1).long()
            off = row_off.long()
            tok = torch.where(
                row_off == 0, state["last_token"][s],
                drafts[s, (off - 1).clamp(0, max(k - 1, 0))])
            pos = n_comp[s] + row_off                      # [R]
            valid = ((row_slot >= 0) & (alive[s] > 0)
                     & (row_off <= dlen[s]) & (pos < limit[s]))
            bt = block_tables[s]                           # [R, maxblk]
            blk = torch.gather(bt, 1, (pos // bs).clamp(
                0, maxblk - 1).long()[:, None])[:, 0]
            slotm = torch.where(valid, blk * bs + pos % bs, -1)
            inputs = {
                "input_ids": tok,
                "positions": pos,
                "req_idx": torch.where(
                    valid, torch.arange(R, dtype=torch.int32, device=dev),
                    -1),
                "slot_mapping": slotm.to(torch.int32),
                "block_tables": bt,
                "seq_lens": pos + 1,                       # per-row seq
                "kv_scale": kv_scale,
            }
            if runner.swift:
                inputs["logits_indices"] = torch.arange(
                    R, dtype=torch.int32, device=dev)
            # Never deferred: row j of a slot is its own sequence and
            # reads rows 0..j-1 of the slot from the cache, where only
            # the per-layer write puts them.  Deferred, they would be
            # neither in the cache (pos_base = pos) nor among the row's
            # injected rows (new_len = 1), and the row would attend
            # stale slots.
            h = runner.forward(inputs, 1, allow_deferral=False)
            logits = runner.logits(h)                      # [R, V]
            flat = rowvals_of(logits, state["temperature"][s],
                              state["top_k"][s], state["top_p"][s], gen)
            jj = torch.arange(r, dtype=torch.int32, device=dev)[None, :]
            idx = (slot_start[:, None] + jj).clamp(0, R - 1).long()
            in_slot = jj < slot_rows[:, None]
            h_rows = torch.where(in_slot[:, :, None], h[idx],
                                 torch.zeros((), dtype=h.dtype, device=dev))
            return torch.where(in_slot, flat[idx], NO_TOKEN), h_rows

        j = torch.arange(r, dtype=torch.int32, device=dev)[None, :]
        h = None                  # the wide program's rows, for a drafter
        if rows_total is not None:
            rowvals, h_out = fwd_slotted()
        elif wide:
            rowvals, h = fwd_rowvals(r, dlen)
            h_out = h.reshape(b, r, -1)
        else:
            rv1, h1 = fwd_rowvals(1, torch.zeros_like(dlen))
            # Only column 0 is consumed: the rest compare as NO_TOKEN.
            rowvals = torch.nn.functional.pad(rv1, (0, r - 1),
                                              value=NO_TOKEN)
            h_out = torch.nn.functional.pad(h1[:, None, :],
                                            (0, 0, 0, r - 1))

        # Greedy prefix-match verification (sample-and-compare when
        # temperature > 0: draft and target row come from one sampled
        # chain, so accept-on-equality stays unbiased).
        if k > 0:
            match = ((rowvals[:, :k] == drafts[:, :k])
                     & (torch.arange(k, device=dev)[None, :]
                        < dlen[:, None]))
            n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(
                dim=1).to(torch.int32)
        else:
            n_acc = torch.zeros_like(n_comp)
        # Never emit past the per-request length limit.
        n_acc = torch.minimum(n_acc, (limit - n_comp - 2).clamp(min=0))

        # Accepted drafts equal their target rows, so the emitted block is
        # the target chain up to and including the bonus position.
        emitted = torch.where((j <= n_acc[:, None]) & (alive[:, None] > 0),
                              rowvals, NO_TOKEN)           # [B, R]
        bonus = torch.gather(rowvals, 1, n_acc[:, None].long())[:, 0]
        n_emit = (1 + n_acc) * alive
        n_comp2 = n_comp + n_emit
        last2 = torch.where(alive > 0, bonus, state["last_token"])

        # Device-side stop detection mirrors Request.check_stop for the
        # conditions the loop admits (eos, <= 4 stop ids, length).
        em_real = emitted >= 0
        hit = ((emitted[:, :, None] == state["stop_ids"][:, None, :])
               & em_real[:, :, None]).any(-1)
        if eos >= 0:
            hit |= ((emitted == eos) & em_real
                    & (state["eos_mask"][:, None] > 0))
        stopped = hit.any(dim=1)
        length_done = n_comp2 + 1 >= limit
        alive2 = alive * (~stopped).to(torch.int32) * \
            (~length_done).to(torch.int32)
        headroom = (limit - n_comp2 - 2).clamp(0, k)

        # Next drafts: the drafter chain on the hidden row of each slot's
        # bonus token (row b*(K+1) + n_acc: the last accepted token's).
        if drafter is not None and k > 0:
            hrow = h[bidx.long() * r + n_acc.long()]
            drafts2 = drafter.generate(spec_params, bonus, hrow)
            dlen2 = headroom * alive2
        else:
            drafts2 = drafts
            dlen2 = torch.zeros_like(dlen)
        state2 = dict(state)

        if use_suffix:
            h_path = h_pack[:, :plen]
            h_start = h_pack[:, plen]
            h_len = h_pack[:, plen + 1]
            # 1. Ring buffer of emitted tokens, keyed by absolute token
            #    index mod W (emitted[:, j] has index n_comp + 1 + j);
            #    column W takes the rows that emitted nothing and is cut
            #    off.
            em_idx = n_comp[:, None] + 1 + j               # [B, R]
            ring_at = torch.where(em_real, em_idx % w, w).long()
            ring = torch.cat([state["ring"], state["ring"][:, :1]], dim=1)
            ring = ring.scatter(1, ring_at, emitted)[:, :w]

            # 2. Advance the current path past the emitted block, checking
            #    each emitted token against the path's prediction.
            path = state["path"]                           # [B, PLEN]
            p_off = state["path_off"]
            p_len = state["path_len"]
            pred = torch.gather(
                path, 1, (p_off[:, None] + j).clamp(0, plen - 1).long())
            in_path = (p_off[:, None] + j) < p_len[:, None]
            mism = (em_real & in_path & (pred != emitted)).any(dim=1)
            p_off = p_off + n_emit
            p_len = torch.where(mism, 0, p_len)

            # 3. Merge the host upload: usable if its anchor gap (tokens
            #    the host had not seen) verifies against the ring.
            gap = (n_comp2 + 1) - h_start                  # [B]
            t = torch.arange(plen, dtype=torch.int32, device=dev)[None, :]
            ring_tok = torch.gather(ring, 1,
                                    ((h_start[:, None] + t) % w).long())
            gap_ok = torch.where(t < gap[:, None], ring_tok == h_path,
                                 True).all(dim=1)
            usable = ((h_len > 0) & (gap >= 0) & (gap < h_len)
                      & (gap <= w) & gap_ok)
            path = torch.where(usable[:, None], h_path, path)
            p_off = torch.where(usable, gap, p_off)
            p_len = torch.where(usable, h_len, p_len)

            # 4. Walk the live path as the next drafts, before the
            #    drafter's (the host's uploads are score-gated).
            rem = (p_len - p_off).clamp(min=0)
            use_path = (rem > 0) & (alive2 > 0)
            jd = torch.arange(max(k, 1), dtype=torch.int32,
                              device=dev)[None, :]
            path_drafts = torch.gather(
                path, 1, (p_off[:, None] + jd).clamp(0, plen - 1).long())
            drafts2 = torch.where(use_path[:, None], path_drafts[:, :k],
                                  drafts2)
            dlen2 = torch.where(use_path,
                                torch.minimum(rem, headroom) * alive2, dlen2)
            state2.update(ring=ring, path=path, path_off=p_off,
                          path_len=p_len)
        if corrupt > 0 and k > 0:
            u = torch.rand(drafts2.shape, generator=gen, device=dev)
            drafts2 = torch.where(u < corrupt,
                                  (drafts2 + 1) % arch.vocab_size, drafts2)
        state2.update(n_computed=n_comp2, last_token=last2,
                      drafts=drafts2.to(torch.int32),
                      draft_len=dlen2.to(torch.int32), alive=alive2)
        telemetry = torch.cat([emitted, (dlen * alive)[:, None]], dim=1)
        return state2, telemetry.to(torch.int32), h_out

    return step


# --------------------------------------------------------------------- #
# Host controller
# --------------------------------------------------------------------- #

class _InflightFused:
    """A dispatched step's telemetry: a host copy (pinned on the card),
    the event recorded after the copy (None on the CPU), and the verify
    rows' hidden states on the device while a capture hook is installed
    (else None)."""

    __slots__ = ("telemetry", "event", "k", "hidden")

    def __init__(self, telemetry, event, k, hidden=None):
        self.telemetry = telemetry
        self.event = event
        self.k = k
        self.hidden = hidden


class FusedDecodeLoop:
    """Engine-side controller: entry and exit, block pre-extension,
    program choice, lagged telemetry commits.  One per engine; active
    between :meth:`enter` and :meth:`exit`."""

    #: drained steps a consumed draft keeps the wide program hot for
    #: (sticky on purpose: on tie-prone logits the wide and narrow
    #: programs can argmax-diverge, and a pass interleaving both poisons
    #: the suffix cache for the next repeat pass).
    CONSUME_MEMORY = 32
    #: initial cadence of wide retries while uploads are live but nothing
    #: was consumed recently (doubles to 64; resets on consumption).
    RETRY_PERIOD = 4
    #: fraction of alive slots that must have consumed drafts this entry
    #: for the batch to run the global wide program, not a per-slot one.
    HOT_BATCH_FRAC = 0.75

    def __init__(self, engine):
        self.engine = engine
        self.runner = engine.runner
        self.active = False
        self._fns: dict = {}
        self._inflight: list[_InflightFused] = []
        self._slots: list = []              # slot -> Request
        self._host_alive: list[bool] = []
        self._known_comp: list[int] = []    # drained n_computed per slot
        self._state: Optional[dict] = None  # device tensors
        self._bt_np = None                  # host block-table mirror
        self._bt_dev = None
        # A served mesh: the state the next broadcast announces (set at
        # entry), and whether the block table changed since the last.
        self._announce: Optional[dict] = None
        self._bt_dirty = False
        self._k = 0
        self._need_sampling = False
        self.depth = max(1, engine.config.scheduler.pipeline_depth)
        self._wide_ttl = 0
        self._retry = 0
        self._retry_period = self.RETRY_PERIOD
        # Did any entry consume drafts, and did this one?  A loop whose
        # last entry consumed re-enters wide (its own evidence lags by
        # the pipeline depth).
        self._hot_history = False
        self._consumed_this_entry = False
        self._entry_failed = 0
        self._engage_gate = 0
        self._consuming_slots: set = set()
        self._slot_arrays_ready = False
        #: dispatched fused steps by program width, and entries.
        self.width_stats = {"wide": 0, "narrow": 0, "entries": 0}
        #: tokens committed from drained telemetry (the engine reads the
        #: difference across a step).
        self.tokens_drained = 0
        self._suffix = engine._suffix_cache
        self._plen = 32
        self._ring_w = 64
        self._empty_paths_np = None
        self._empty_paths_dev = None
        # Each entry's device generator is seeded from this host stream.
        self._seeds = np.random.default_rng(engine.config.model.seed)
        self._logged: set = set()

    def _log_once(self, reason: str) -> None:
        if reason not in self._logged:
            self._logged.add(reason)
            logger.info("fused decode loop not engaged: %s; running the "
                        "synchronous step", reason)

    # -- entry ----------------------------------------------------------

    def eligible(self) -> bool:
        """Is there anything to speculate with: suffix drafts, a drafter
        or both?  Without either the engine keeps the loop uninstalled
        and the sync path keeps full drafting duties."""
        return self._suffix is not None or self.engine._drafter is not None

    @staticmethod
    def _fusable(req) -> bool:
        """Sampling semantics the device step can mirror."""
        sp = req.sampling
        return not (sp.guided is not None or sp.logprobs
                    or len(sp.stop_token_ids) > MAX_STOP_IDS
                    or sp.needs_penalties or sp.stop
                    or sp.min_p > 0 or sp.seed is not None)

    def _frontier_requests(self) -> list:
        return [r for r in self.engine.scheduler.running
                if r.num_computed_tokens == r.num_tokens - 1]

    def can_enter(self) -> bool:
        """Enter when any decode-frontier request is device-mirrorable;
        prefilling requests, arrivals and non-fusable requests ride
        interleaved sync steps (:meth:`_admission_step`)."""
        if not any(self._fusable(r) for r in self._frontier_requests()):
            return False
        if self.engine._spec_disabled_now():
            self._log_once("more running requests than "
                           "disable_by_batch_size")
            return False
        if envs.ARCTIC_TPU_DISABLE_FUSED:
            self._log_once("ARCTIC_TPU_DISABLE_FUSED=1")
            return False
        return True

    def enter(self) -> None:
        eng = self.engine
        # Entry width from history: a workload that consumed drafts in a
        # previous entry starts wide for depth+2 steps; a cold one probes.
        self._wide_ttl = (self.depth + 2) if self._hot_history else 0
        self._retry = 0
        self._retry_period = self.RETRY_PERIOD
        self._consumed_this_entry = False
        self._consuming_slots = set()
        self._entry_failed = 0
        self._engage_gate = 0
        self._slot_arrays_ready = False
        running = [r for r in self._frontier_requests() if self._fusable(r)]
        pcfg = eng.config.parallel
        # SP mode cuts the B*(K+1) token rows into sp chunks and PP into
        # pp microbatches of whole slots: B (a dp group's) is a multiple
        # of sp * pp (the extra slots stay dead).
        div = pcfg.ulysses_sequence_parallel_size * \
            pcfg.pipeline_parallel_size
        dp = self.runner.dp
        # dp-major slots: group g owns slots [g*Bs, (g+1)*Bs).
        per: list[list] = [[] for _ in range(dp)]
        for r_ in running:
            per[max(r_.dp_shard, 0)].append(r_)
        bsh = _bucket(max(len(g) for g in per),
                      eng.config.scheduler.max_num_seqs)
        bsh = -(-bsh // div) * div
        b = bsh * dp
        slot_of: list = []
        for g in per:
            slot_of += g + [None] * (bsh - len(g))
        sc = eng.config.speculative
        if eng._drafter is not None:
            k = eng._drafter.n_predict
        else:  # suffix only: a per-step cap on path consumption
            k = min(sc.num_speculative_tokens, sc.fused_suffix_spec_len)
        self._k = k
        r = k + 1
        self._ring_w = max(64, _bucket((self.depth + 2) * r, 1 << 16))
        self._need_sampling = any(r_.sampling.temperature > 0
                                  for r_ in running)
        self._slots = slot_of
        self._host_alive = [r_ is not None for r_ in slot_of]
        self._known_comp = [0 if r_ is None else r_.num_computed_tokens
                            for r_ in slot_of]
        maxblk = self.runner.max_blocks_per_req
        mml = eng.config.model.max_model_len

        n_comp = np.zeros(b, np.int32)
        last = np.zeros(b, np.int32)
        drafts = np.zeros((b, max(k, 1)), np.int32)
        dlen = np.zeros(b, np.int32)
        alive = np.zeros(b, np.int32)
        limit = np.ones(b, np.int32)  # dead slots: tiny limit
        temp = np.zeros(b, np.float32)
        top_k = np.zeros(b, np.int32)
        top_p = np.ones(b, np.float32)
        eos_mask = np.zeros(b, np.int32)
        stop_ids = np.full((b, MAX_STOP_IDS), -1, np.int32)
        self._bt_np = np.zeros((b, maxblk), np.int32)

        for i, req in enumerate(slot_of):
            if req is None:
                continue
            n_comp[i] = req.num_computed_tokens
            last[i] = req.all_token_ids[-1]
            d = [int(t) for t in req.spec_token_ids[:k]]
            drafts[i, :len(d)] = d
            dlen[i] = len(d)
            req.spec_token_ids = []
            alive[i] = 1
            limit[i] = min(len(req.prompt_token_ids)
                           + req.sampling.max_tokens, mml)
            sp = req.sampling
            temp[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
            eos_mask[i] = 0 if sp.ignore_eos else 1
            for s_i, sid in enumerate(sp.stop_token_ids[:MAX_STOP_IDS]):
                stop_ids[i, s_i] = sid
            self._bt_np[i, :len(req.block_ids)] = req.block_ids

        state = dict(
            n_computed=n_comp, last_token=last, drafts=drafts,
            draft_len=dlen, alive=alive, limit=limit, temperature=temp,
            top_k=top_k, top_p=top_p, eos_mask=eos_mask, stop_ids=stop_ids)
        if self._suffix is not None:
            state.update(
                ring=np.full((b, self._ring_w), -1, np.int32),
                path=np.zeros((b, self._plen), np.int32),
                path_off=np.zeros(b, np.int32),
                path_len=np.zeros(b, np.int32))
        dev = self.runner.device
        self._state = {key: torch.from_numpy(v).to(dev)
                       for key, v in state.items()}
        seed = int(self._seeds.integers(1 << 62))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self._state["generator"] = gen
        self._bt_dev = self.runner.upload_array(self._bt_np)
        # A served mesh's followers start from the same state and seed,
        # announced with the first step's broadcast.
        self._announce = (dict(state=state, gen_seed=seed)
                          if self.runner.mh_channel is not None else None)
        self._bt_dirty = True
        self._inflight = []
        self.active = True
        # Admission steps may preempt on block pressure; loop-owned
        # requests must never be victims (steps in flight write their
        # blocks until the loop drains).
        eng.scheduler.protected_ids = {
            r_.req_id for r_ in slot_of if r_ is not None}
        self.width_stats["entries"] += 1
        logger.debug("fused decode: entered with %d requests (B=%d, K=%d)",
                     len(running), b, k)

    # -- stepping -------------------------------------------------------

    def _admission_step(self) -> list:
        """One synchronous prefill-only step for arrivals, ongoing
        prefills and non-fusable decodes while the loop keeps decoding."""
        eng = self.engine
        sched_out = eng.scheduler.schedule(skip_decode=True)
        if not sched_out.scheduled:
            return []
        return eng._step_sync(sched_out)[2]

    def _absorbable(self) -> list:
        """Admitted fusable requests that reached the decode frontier:
        the loop exits once to re-enter with them in the batch."""
        slots = set(id(r) for r in self._slots)
        return [r for r in self._frontier_requests()
                if id(r) not in slots and self._fusable(r)]

    def step(self) -> list:
        """One fused iteration: maybe exit, else dispatch + lagged drain.
        Arrivals get an interleaved prefill step first."""
        eng = self.engine
        if not any(self._host_alive):
            return self.exit()
        finished: list = []
        owned = eng.scheduler.protected_ids
        if eng.scheduler.waiting or any(
                r.req_id not in owned for r in eng.scheduler.running
                if not r.status.is_finished):
            finished.extend(self._admission_step())
            if self._absorbable():
                # Admissions reached the frontier: exit once so the next
                # engine iteration re-enters with the larger batch.
                finished.extend(self.exit())
                return finished
            if not any(self._host_alive):
                return finished + self.exit()
        if not self._pre_extend_blocks():
            self._log_once("no free blocks to extend the block tables "
                           "ahead of the steps in flight")
            return finished + self.exit()

        # The host picks the program from what it already holds (no
        # device sync): wide while it holds live paths or drained
        # telemetry shows drafts consumed (the TTL keeps the merge step's
        # successor wide); draft-free wide drains open a backoff window
        # of narrow steps, empty uploads and no tree walks, with a retry
        # probe every RETRY_PERIOD steps.
        k_eff = self._k
        wide = True
        paths_np = None
        rplan_np = None
        r_bucket = None
        force = envs.ARCTIC_TPU_FUSED_FORCE_WIDTH
        # The width policies are suffix-only: with a drafter every step
        # is wide (the drafter chains from the wide program's rows).
        suffix_only = (self._suffix is not None and eng._drafter is None
                       and k_eff > 0)
        # The per-slot program is single-device, as in the JAX loop.
        slotted = (suffix_only and not force
                   and self.runner.mesh is None
                   and not envs.ARCTIC_TPU_DISABLE_SLOTTED)
        if force and suffix_only:
            wide = force == "wide"
            paths_np = (self._host_paths() if wide
                        else self._empty_paths())
        elif slotted:
            paths_np, rplan_np, r_bucket, wide = self._slot_policy()
        elif suffix_only:
            self._wide_ttl = max(0, self._wide_ttl - 1)
            self._retry = max(0, self._retry - 1)
            if self._consuming_slots and not any(
                    self._host_alive[i] for i in self._consuming_slots):
                # Every slot that earned the sticky TTL has finished.
                self._wide_ttl = 0
                self._consuming_slots.clear()
            if self._wide_ttl > 0:
                paths_np = self._host_paths()
            elif self._retry <= 0:
                # Retry probe.  "Live" = long enough to survive the
                # device's gap check (the host's anchor lags by about the
                # pipeline depth in tokens).
                paths_np = self._host_paths()
                if bool((paths_np[:, self._plen + 1]
                         > self.depth + 1).any()):
                    self._retry = self._retry_period
                    self._retry_period = min(64, self._retry_period * 2)
                    self._wide_ttl = self.depth + 2
                else:
                    self._retry = self.RETRY_PERIOD
                    paths_np = self._empty_paths()
            else:
                paths_np = self._empty_paths()   # backoff: no walks
            wide = self._wide_ttl > 0
        elif self._suffix is not None:
            paths_np = self._host_paths()
        self.width_stats["wide" if wide else "narrow"] += 1
        if envs.ARCTIC_TPU_FUSED_DEBUG:
            live_n = (-1 if paths_np is None
                      else int((paths_np[:, self._plen + 1] > 0).sum()))
            ever = (int(self._slot_consumed.sum())
                    if self._slot_arrays_ready else -1)
            print(f"[fused] {'W' if wide else 'n'} bucket={r_bucket} "
                  f"ever={ever} alive={sum(self._host_alive)} "
                  f"paths>0={live_n}", file=sys.stderr)
        b = self._state["n_computed"].shape[0]
        key = ((b, k_eff, self._need_sampling, "slot", r_bucket)
               if r_bucket is not None
               else (b, k_eff, self._need_sampling, wide))
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = build_fused_step(
                self.runner, eng._drafter, k_eff, self._need_sampling,
                eng.eos_token_id, use_suffix=self._suffix is not None,
                path_len_max=self._plen, ring_w=self._ring_w, wide=wide,
                rows_total=r_bucket)
        ch = self.runner.mh_channel
        if ch is not None:
            # Mirror the step on every follower (as runner.dispatch:
            # broadcast first, then run it).  The per-slot program is off
            # on a mesh, so no row plan goes out.
            announce = self._announce or dict(state=None, gen_seed=None)
            ch.broadcast(dict(
                announce, kind="fused", b=b, k=k_eff, wide=wide,
                need_sampling=self._need_sampling,
                use_suffix=self._suffix is not None, plen=self._plen,
                ring_w=self._ring_w, eos=eng.eos_token_id,
                bt=self._bt_np if self._bt_dirty else None,
                paths=paths_np))
            self._announce = None
            self._bt_dirty = False
        self._inflight.append(self._dispatch(fn, paths_np, rplan_np, k_eff))
        eng.engine_stats.num_steps += 1
        while len(self._inflight) > self.depth:
            finished.extend(self._drain_one())
        return finished

    def _dispatch(self, fn, paths_np, rplan_np, k_eff) -> _InflightFused:
        """Upload the step's host arrays, enqueue the step and the copy of
        its telemetry to the host; nothing here waits for the device."""
        if paths_np is None:                    # no suffix decoding
            h_pack = None
        elif paths_np is self._empty_paths_np:
            # Narrow / backoff steps reuse the cached device copy.
            if self._empty_paths_dev is None:
                self._empty_paths_dev = self.runner.upload_array(
                    paths_np)
            h_pack = self._empty_paths_dev
        else:
            h_pack = self.runner.upload_array(paths_np)
        args = () if rplan_np is None else (
            self.runner.upload_array(rplan_np),)
        drafter = self.engine._drafter
        self._state, telem, hidden = fn(
            None if drafter is None else drafter.params, self._state,
            self._bt_dev, h_pack, *args)
        self.runner.fold_digest(telem)
        if self.engine.hidden_capture is None:
            hidden = None
        if not telem.is_cuda:
            return _InflightFused(telem, None, k_eff, hidden)
        host = torch.empty(telem.shape, dtype=telem.dtype, pin_memory=True)
        host.copy_(telem, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _InflightFused(host, event, k_eff, hidden)

    # -- per-slot width policy -------------------------------------------

    def _ensure_slot_arrays(self):
        b = self._state["n_computed"].shape[0]
        if not self._slot_arrays_ready:
            init = (self.depth + 2) if self._hot_history else 0
            self._slot_ttl = np.full(b, init, np.int32)
            self._slot_retry = np.zeros(b, np.int32)
            self._slot_retry_period = np.full(b, self.RETRY_PERIOD,
                                              np.int32)
            self._slot_consumed = np.zeros(b, bool)
            self._slot_arrays_ready = True

    def _row_buckets(self, b: int, r: int) -> list:
        """Total-row buckets (one program each): a ~1.5x ladder between
        all-narrow (b) and all-wide (b*r)."""
        out = []
        for m in (1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0):
            v = min(int(-(-b * m // 8) * 8), b * r)
            if v not in out:
                out.append(v)
            if v >= b * r:
                break
        if out[-1] != b * r:
            out.append(b * r)
        return out

    def _slot_policy(self):
        """Per-slot widths -> (paths, row plan, bucket, any_wide).

        A slot keeps K+1 rows while it is alive and has consumed drafts
        this entry, or while an engagement TTL runs; every other slot
        gets 1 row.  Sticky by consumption, so a slot's rows (and the
        step's program) stay stable for its lifetime.  At least
        HOT_BATCH_FRAC of alive slots having consumed -> the global wide
        program; no wide slot -> global narrow; otherwise the bucketed
        per-slot program."""
        self._ensure_slot_arrays()
        b = self._state["n_computed"].shape[0]
        r = self._k + 1
        ttl, ret = self._slot_ttl, self._slot_retry
        per = self._slot_retry_period
        np.maximum(ttl - 1, 0, out=ttl)
        np.maximum(ret - 1, 0, out=ret)
        alive = np.asarray(self._host_alive, bool)
        ever = self._slot_consumed & alive
        hot = alive & (ever | (ttl > 0))
        probe = alive & ~hot & (ret <= 0)
        walk = hot | probe
        paths = (self._host_paths(mask=walk) if walk.any()
                 else self._empty_paths())
        live = paths[:, self._plen + 1] > self.depth + 1
        engage = probe & live
        self._engage_gate = max(0, self._engage_gate - 1)
        if engage.any():
            # Every engagement window this entry that drained with no
            # consumption raises the re-engagement floor for all slots
            # (8, 16, 32, then 64 steps) and rate-limits new engagements
            # batch-wide; any consumed draft resets it.
            esc = (0 if self._entry_failed < 2
                   else min(64, self.RETRY_PERIOD
                            << min(self._entry_failed - 1, 4)))
            if esc and self._engage_gate > 0:
                ret[engage] = self._engage_gate + 1
            else:
                win = self.depth + 2
                ttl[engage] = win
                # The retry cadence starts after the window drains.
                ret[engage] = win + np.maximum(per[engage], esc)
                per[engage] = np.minimum(
                    64, np.maximum(per[engage], esc) * 2)
                self._entry_failed += 1
                self._engage_gate = win + esc
        miss = probe & ~live
        if miss.any():
            ret[miss] = self.RETRY_PERIOD
        wide_slots = alive & (ever | (ttl > 0))
        if not wide_slots.any():
            return self._empty_paths(), None, None, False
        n_alive = int(alive.sum())
        if (not (alive & ~wide_slots).any()
                or (n_alive and ever.sum() / n_alive
                    >= self.HOT_BATCH_FRAC)):
            return paths, None, None, True
        widths = np.where(wide_slots, r, 1).astype(np.int64)
        buckets = self._row_buckets(b, r)
        r_real = int(widths.sum())
        r_bucket = next(v for v in buckets if v >= r_real)
        return paths, self._build_rplan(widths, r_bucket), r_bucket, True

    @staticmethod
    def _build_rplan(widths, r_bucket: int):
        b = len(widths)
        r_real = int(widths.sum())
        row_slot = np.full(r_bucket, -1, np.int32)
        row_off = np.zeros(r_bucket, np.int32)
        sstart = np.zeros(b, np.int32)
        sstart[1:] = np.cumsum(widths[:-1])
        rs = np.repeat(np.arange(b, dtype=np.int32),
                       widths.astype(np.int64))
        row_slot[:r_real] = rs
        row_off[:r_real] = np.arange(r_real, dtype=np.int32) - sstart[rs]
        return np.concatenate([row_slot, row_off, sstart,
                               widths.astype(np.int32)])

    def _empty_paths(self):
        """Zero-length path upload for narrow / backoff steps (rejected by
        the device's usable gate); its device copy is cached, so such a
        step uploads nothing."""
        b = self._state["n_computed"].shape[0]
        cached = self._empty_paths_np
        if cached is None or cached.shape[0] != b:
            cached = np.zeros((b, self._plen + 2), np.int32)
            self._empty_paths_np = cached
            self._empty_paths_dev = None
        return cached

    def _host_paths(self, mask=None):
        """A suffix path per alive slot (``mask``: only those slots),
        walked from the host's lag-synced prefix and anchored at its
        absolute token index; the device verifies the unseen gap against
        its ring and walks the tail."""
        eng = self.engine
        sc = eng.config.speculative
        b = self._state["n_computed"].shape[0]
        pack = np.zeros((b, self._plen + 2), np.int32)
        h_path = pack[:, :self._plen]
        h_start = pack[:, self._plen]
        h_len = pack[:, self._plen + 1]
        # A path beats the drafter only where its score reaches the
        # drafter's draft length.
        min_score = (0 if eng._drafter is None
                     else sc.num_speculative_tokens)
        # The first ``lag`` path tokens are verified for free against the
        # ring (already emitted), so they must not count against the
        # confidence cap match_len * factor + offset: extend the offset
        # by the worst-case lag.
        est_lag = (len(self._inflight) + 1) * (self._k + 1)
        if not eng._spec_disabled_now():
            items = []
            for i, req in enumerate(self._slots):
                if req is None or not self._host_alive[i]:
                    continue
                if mask is not None and not mask[i]:
                    continue
                pattern = req.all_token_ids[-sc.suffix_cache_max_depth:]
                if not pattern:
                    continue
                items.append((i, dict(
                    req_id=req.req_id, pattern=pattern,
                    max_spec_tokens=self._plen,
                    max_spec_factor=sc.suffix_max_spec_factor,
                    max_spec_offset=sc.suffix_max_spec_offset + est_lag,
                    min_token_prob=sc.suffix_min_token_prob,
                    use_cached_prompt=self._suffix.has_cached_prompt(
                        req.req_id))))
            results = self._suffix.speculate_batch(
                items, pool=eng._prompt_tree_pool)
            for i, res in results.items():
                if res.token_ids and res.score >= min_score:
                    n = min(len(res.token_ids), self._plen)
                    h_path[i, :n] = res.token_ids[:n]
                    h_start[i] = len(self._slots[i].all_token_ids)
                    h_len[i] = n
        return pack

    def _pre_extend_blocks(self) -> bool:
        """Grow block tables to cover the worst-case frontier of every
        step in flight and the next; upload the table if it changed."""
        eng = self.engine
        horizon = (len(self._inflight) + 1) * (self._k + 1) + 1
        changed = False
        for i, req in enumerate(self._slots):
            if req is None or not self._host_alive[i]:
                continue
            limit = min(len(req.prompt_token_ids) + req.sampling.max_tokens,
                        eng.config.model.max_model_len)
            ub = min(self._known_comp[i] + horizon, limit)
            before = len(req.block_ids)
            try:
                eng.scheduler.bm_for(req).grow_to(req.block_ids, ub)
            except NoFreeBlocksError:
                return False
            if len(req.block_ids) != before:
                self._bt_np[i, before:len(req.block_ids)] = \
                    req.block_ids[before:]
                changed = True
        if changed:
            self._bt_dev = self.runner.upload_array(self._bt_np)
            self._bt_dirty = True
        return True

    def _drain_one(self) -> list:
        eng = self.engine
        step = self._inflight.pop(0)
        if step.event is not None:
            step.event.synchronize()
        telem = step.telemetry.numpy()
        r = step.k + 1
        finished: list = []
        capture = (eng.hidden_capture if step.hidden is not None else None)
        capture_items: list = []
        for i, req in enumerate(self._slots):
            if req is None or not self._host_alive[i]:
                continue
            row = telem[i]
            toks = [int(t) for t in row[:r] if t >= 0]
            if capture is not None:
                # Verify row j of slot i (flat row i*(K+1)+j) produced
                # emitted token j.
                capture_items.extend((req.req_id, i * r + j, t)
                                     for j, t in enumerate(toks))
            dlen_used = int(row[r])
            if not toks:
                continue
            self._known_comp[i] += len(toks)
            req.num_computed_tokens += len(toks)
            req.output_token_ids.extend(toks)
            eng.scheduler.register_computed(req)
            if dlen_used > 0:
                # Consumption: keep the wide program hot.
                self._wide_ttl = max(self._wide_ttl, self.CONSUME_MEMORY)
                self._retry_period = self.RETRY_PERIOD
                self._hot_history = True
                self._consumed_this_entry = True
                self._entry_failed = 0
                self._engage_gate = 0
                self._consuming_slots.add(i)
                if self._slot_arrays_ready:
                    self._slot_ttl[i] = max(self._slot_ttl[i],
                                            self.CONSUME_MEMORY)
                    self._slot_retry_period[i] = self.RETRY_PERIOD
                    self._slot_consumed[i] = True
                eng._observe_drafts(req, dlen_used,
                                    min(len(toks) - 1, dlen_used))
            eng.engine_stats.num_generated_tokens += len(toks)
            self.tokens_drained += len(toks)
            if req.first_token_time is None:
                req.first_token_time = time.time()
            eng._update_suffix_cache(req, toks)
            stop = req.check_stop(eng.eos_token_id,
                                  eng.config.model.max_model_len)
            if stop is not None:
                # The device cleared this slot's alive flag in the same
                # step (its stop logic mirrors check_stop), so no later
                # step in flight writes these blocks: safe to free now.
                req.finish_time = time.time()
                req.num_computed_tokens = req.num_tokens - 1
                eng.scheduler.finish_request(req, stop)
                eng._evict_spec_state(req)
                self._host_alive[i] = False
                finished.append(req)
                eng.engine_stats.num_finished += 1
        if capture is not None and capture_items:
            capture(step.hidden.reshape(telem.shape[0] * r, -1),
                    capture_items)
        return finished

    # -- exit -----------------------------------------------------------

    def exit(self) -> list:
        finished: list = []
        while self._inflight:
            finished.extend(self._drain_one())
        if self.active:
            # A fully dry entry resets the history: the next entry probes.
            self._hot_history = self._consumed_this_entry
            if self.runner.mh_channel is not None:
                self.runner.mh_channel.broadcast({"kind": "fused_exit"})
        self.engine.scheduler.protected_ids = set()
        self.active = False
        self._state = None
        self._bt_dev = None
        self._announce = None
        logger.debug("fused decode: exited")
        return finished


def _bucket(n: int, cap: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, max(cap, n))
