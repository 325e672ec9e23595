"""The host arrays of in-engine dp and of the pipeline against the JAX
runner's.

For the same scheduler outputs (the port's scheduler with one block
space a dp group), the port's ``ModelRunner.prepare_inputs`` builds,
array for array, what the JAX runner builds: the dp-major layout of
``_prepare_inputs_dp`` (each group's token window, the per-group block
tables, lengths and work items, SwiftKV's per-group sample rows and
``logits_indices_dp``, sample rows, penalties, host-mask and device-pool
guided rows, passthrough tokens) and, under pp, the per-microbatch work
items (``pp``-prefixed, stacked ``[pp, ...]``; ``[dp, pp, ...]`` under
dp x pp, a drained dp group included).  Both runners are driven without
a model (only their host-array state), as their host code needs none.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from arcticinference_tpu.engine.runner import ModelRunner as JaxRunner
from arcticinference_tpu_torch.config import CacheConfig, SchedulerConfig
from arcticinference_tpu_torch.engine.request import Request, SamplingParams
from arcticinference_tpu_torch.engine.runner import ModelRunner
from arcticinference_tpu_torch.engine.scheduler import Scheduler
from arcticinference_tpu_torch.serving.structured import make_guided_decoder
from arcticinference_tpu_torch.utils import default_token_buckets

from tests.test_torch_guided_dfa import ByteTokenizer

VOCAB = len(ByteTokenizer().vocab)
BUDGET = 32


def runners(dp: int, pp: int, swift: bool):
    """(port, JAX) runners holding only the state their host arrays
    read."""
    state = dict(
        dp=dp, b_max=4, block_size=8, max_blocks_per_req=32, swift=swift,
        token_buckets=default_token_buckets(BUDGET),
        sample_buckets=default_token_buckets(max(16, BUDGET)),
        arch=SimpleNamespace(vocab_size=VOCAB),
        config=SimpleNamespace(
            parallel=SimpleNamespace(pipeline_parallel_size=pp),
            model=SimpleNamespace(max_model_len=256)))
    port = ModelRunner.__new__(ModelRunner)
    port.__dict__.update(state, pp=pp)
    ref = JaxRunner.__new__(JaxRunner)
    ref.__dict__.update(state)
    return port, ref


CASES = {
    # (dp, pp, swift, drafts, guided on the device pool)
    "dp2": (2, 1, False, False, False),
    "dp2_pp2": (2, 2, False, False, False),
    "dp2_swift": (2, 1, True, True, False),
    "dp2_guided_pool": (2, 1, False, False, True),
    "pp2": (1, 2, False, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_arrays_match_the_jax_runner(monkeypatch, case):
    # Both runners route pure-decode steps to attn_qb == 1 (the JAX
    # runner only on a TPU or in interpret mode).
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    dp, pp, swift, drafts, pool = CASES[case]
    port, ref = runners(dp, pp, swift)
    sched = Scheduler(SchedulerConfig(max_num_seqs=4,
                                      max_num_batched_tokens=BUDGET),
                      CacheConfig(num_blocks=64, block_size=8), 32,
                      num_shards=dp)
    rng = np.random.default_rng(3)
    dec = make_guided_decoder(ByteTokenizer(), {"regex": "[a-c]{2,6}"})
    lives = (1, 2, 9, 2, 9)           # group 1's requests finish early
    for i, n in enumerate((40, 7, 21, 12, 5)):
        sp = SamplingParams(max_tokens=lives[i], ignore_eos=True)
        if i == 2:
            sp = SamplingParams(max_tokens=lives[i], temperature=0.7,
                                seed=11, repetition_penalty=1.2,
                                presence_penalty=0.3,
                                frequency_penalty=0.1, ignore_eos=True)
        elif i == 4 and dp > 1:
            sp = SamplingParams(max_tokens=lives[i], guided=dec.clone(),
                                ignore_eos=True)
        sched.add_request(Request(
            f"r{i}", [int(x) for x in rng.integers(1, 97, n)], sp))
    seen = {"drained": False, "qbs": set(), "steps": 0, "keys": set()}
    while sched.num_unfinished:
        if drafts:
            for r in sched.running:
                if r.num_computed_tokens == r.num_tokens - 1:
                    r.spec_token_ids = [7, 8]
        out = sched.schedule()
        passthrough = {s.request.req_id: 3 for s in out.scheduled
                       if s.request.num_computed_tokens
                       == s.request.num_tokens - 1}
        guided_dev = ({s.request.req_id: (1, -1, 0) for s in out.scheduled
                       if s.request.sampling.guided is not None}
                      if pool else None)
        got = port.prepare_inputs(out, passthrough, guided_dev)
        want = ref.prepare_inputs(out, passthrough, guided_dev)
        assert (got.t_pad, got.s_pad, got.attn_qb, got.total_tokens,
                got.gstate_count) == (want.t_pad, want.s_pad, want.attn_qb,
                                      want.total_tokens, want.gstate_count)
        assert got.sample_row_start == want.sample_row_start
        assert got.sample_row_count == want.sample_row_count
        assert got.guided_index == want.guided_index
        assert got.arrays.keys() == want.arrays.keys()
        for k, a in want.arrays.items():
            b = got.arrays[k]
            assert b.dtype == a.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=k)
        shards = {s.request.dp_shard for s in out.scheduled}
        seen["drained"] |= dp > 1 and len(shards) == 1
        seen["qbs"].add(got.attn_qb)
        seen["steps"] += 1
        seen["keys"] |= set(want.arrays)
        seen["passthrough"] = seen.get("passthrough", 0) + int(
            (want.arrays["input_src"] >= 0).sum())
        for s in out.scheduled:
            req = s.request
            done = req.num_computed_tokens + s.num_new_tokens >= \
                req.num_tokens
            sched.update_after_step(s, [97] if done else [], 0)
            stop = req.check_stop(None, 256)
            if stop is not None:
                sched.finish_request(req, stop)
        for s in out.scheduled:
            s.request.spec_token_ids = []
    assert seen["steps"] > 3 and seen["passthrough"] > 0
    # Pure-decode steps go to kernel 2 (attn_qb 1) except under pp.
    assert 32 in seen["qbs"]
    assert (1 in seen["qbs"]) == (pp == 1 and not drafts)
    assert "pen_out_tokens" in seen["keys"]
    if dp > 1:
        assert seen["drained"]         # a group with no rows ran
        assert ("gd_slot" if pool else "guided_mask") in seen["keys"]
    if swift:
        assert "logits_indices_dp" in seen["keys"]
    if pp > 1:
        shape = want.arrays["ppattn_item_req"].shape
        assert shape[:2] == ((dp, pp) if dp > 1 else (pp, shape[1]))
