"""Paged attention on the card: wrappers of the three CUDA kernels in
``csrc/ragged_attention.cu``.

- :func:`ragged_paged_attention_kernel` replaces
  ``arcticinference_tpu/ops/pallas/ragged_attention.py::ragged_paged_attention_kernel``
  (prefill, mixed and verify steps, over the host-built work items of
  :func:`build_work_items`), with its tree-mask path (token-tree
  verification: a 9-tuple schedule carrying ``item_tree_start`` and
  ``item_tree_mask``).
- :func:`grouped_decode_attention_kernel` replaces
  ``...::grouped_decode_attention_kernel`` (pure-decode steps: ``qlen``
  rows per sequence, sequence-major), with its deferred-write path
  (``knew`` / ``vnew`` / ``slot_mapping``: the step's new K/V rows are
  attended from the operands, their cache write comes later).
- :func:`decode_paged_attention_kernel` replaces
  ``...::decode_paged_attention_kernel``: the grouped kernel's function
  without deferral, split over fixed page ranges (one CTA per (sequence,
  kv head, range of :data:`RANGE_PAGES` pages; :func:`range_plan`), the
  ranges' states merged in range order.  As in the JAX package, nothing
  on the engine's path calls it.

Decode attention is bound by the KV bytes it reads (3.35 TB/s on an
H100), a long prefill by the tensor cores' rate (the ragged and grouped
kernels run their products on them); the source note in the ``.cu``
file says what each design does about it.

A wrapper given CPU tensors computes the plain version
(``ops/attention.py``); given CUDA tensors (bf16 q, a bf16 or fp8-e4m3
cache, head dim 64 or 128) it launches its kernel, and raises on anything
else.  Each launch adds one to its counter: ``ragged_attention_launches``
(a schedule without a tree), ``tree_attention_launches`` (one with a tree
mask), ``grouped_decode_launches`` or ``deferred_decode_launches`` (a
grouped launch with injected rows), ``decode_paged_launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from arcticinference_tpu_torch.ops.attention import (
    grouped_decode_deferred_reference, ragged_paged_attention_reference)

SOURCE = "ragged_attention.cu"

#: Kernel launches since the last :func:`reset_launch_counts`.
ragged_attention_launches = 0
tree_attention_launches = 0
grouped_decode_launches = 0
deferred_decode_launches = 0
decode_paged_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_RAGGED_ARGTYPES = [_P] * 14 + [_I] * 8 + [ctypes.c_int64] + [_I] * 2 + [
    ctypes.c_float, _P]
_GROUPED_ARGTYPES = [_P] * 10 + [_I] * 8 + [ctypes.c_int64] + [_I] * 2 + [
    ctypes.c_float, _P]
_DECODE_PAGED_ARGTYPES = [_P] * 9 + [_I] * 8 + [ctypes.c_int64] + [
    _I] * 3 + [ctypes.c_float, _P]

_KV_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)
_BLOCK_SIZE = 32
#: Most nodes of a draft tree: a row's ancestor bitmask has 32 bits, bit 0
#: for the frontier and bit i + 1 for node i (the kernel reads bits 1..31).
MAX_TREE_NODES = 30
#: Most rows per sequence of a deferred-write step (one lane per new row).
MAX_DEFERRED_QLEN = 32
#: Pages per range of kernel 4: one CTA per (sequence, kv head, range).
RANGE_PAGES = 64
#: Floats per row of kernel 4's range states: o [D], then m, l and padding.
_PART_PAD = 4
#: Query rows per warp of the ragged kernel (the m16 tile of its tensor-core
#: products): the only rows-per-tile value its entry point takes.
RAGGED_ROWS_PER_WARP = 16


# Kernel 4's arrival counters per CUDA device ([B, Hkv] int32, zero
# between launches: the last CTA of a (sequence, kv head) resets its own),
# grown as needed.  Launches that share them run on one stream.
_range_counters: dict[int, torch.Tensor] = {}


def reset_launch_counts() -> None:
    global ragged_attention_launches, tree_attention_launches, \
        grouped_decode_launches, deferred_decode_launches, \
        decode_paged_launches
    ragged_attention_launches = 0
    tree_attention_launches = 0
    grouped_decode_launches = 0
    deferred_decode_launches = 0
    decode_paged_launches = 0


def _lib() -> ctypes.CDLL:
    from arcticinference_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if lib.ragged_attention_launch.argtypes is None:
        lib.ragged_attention_launch.argtypes = _RAGGED_ARGTYPES
        lib.ragged_attention_launch.restype = _I
        lib.grouped_decode_launch.argtypes = _GROUPED_ARGTYPES
        lib.grouped_decode_launch.restype = _I
        lib.decode_paged_launch.argtypes = _DECODE_PAGED_ARGTYPES
        lib.decode_paged_launch.restype = _I
    return lib


def build_work_items(query_lens: np.ndarray, positions_last: np.ndarray,
                     qb: int, block_size: int, num_items: int,
                     total_tokens: int):
    """Host-side schedule: split each request's query chunk into <=QB items.

    query_lens: [B] new tokens per request; positions_last: [B] last
    absolute position of each request this step.  Returns the prefetch
    arrays plus the token->(item, offset) back-map.
    """
    b = len(query_lens)
    item_req = np.zeros(num_items, np.int32)
    item_qstart = np.zeros(num_items, np.int32)
    item_qlen = np.zeros(num_items, np.int32)
    item_pages = np.zeros(num_items, np.int32)
    item_pos_base = np.zeros(num_items, np.int32)
    token_item = np.zeros(total_tokens, np.int32)
    token_off = np.zeros(total_tokens, np.int32)
    it = 0
    qpos = 0
    for r in range(b):
        qlen = int(query_lens[r])
        if qlen == 0:
            continue
        first_pos = int(positions_last[r]) - qlen + 1
        done = 0
        while done < qlen:
            n = min(qb, qlen - done)
            if it >= num_items:
                raise ValueError("work item overflow; raise num_items")
            aligned = qpos & ~7  # sublane-tile alignment for the kernel DMA
            item_req[it] = r
            item_qstart[it] = aligned
            item_qlen[it] = n
            # Window row 0 is `aligned`; the item's first real token sits at
            # offset qpos-aligned with position first_pos+done.
            item_pos_base[it] = first_pos + done - (qpos - aligned)
            last_pos = first_pos + done + n - 1
            item_pages[it] = last_pos // block_size + 1
            token_item[qpos:qpos + n] = it
            token_off[qpos:qpos + n] = np.arange(qpos - aligned,
                                                 qpos - aligned + n)
            done += n
            qpos += n
            it += 1
    return (item_req, item_qstart, item_qlen, item_pages, item_pos_base,
            token_item, token_off)


def tree_masks(parents) -> tuple[np.ndarray, np.ndarray]:
    """Depth and ancestor bitmask of each node of a draft tree
    (``parents[i]``: node i's parent, -1 for a child of the frontier):
    ``mask[i] = mask[parent] | 1 << (i + 1)``, a root also carrying bit 0
    (the frontier)."""
    n = len(parents)
    if n > MAX_TREE_NODES:
        raise ValueError(
            f"a draft tree has at most {MAX_TREE_NODES} nodes, got {n}")
    depth = np.zeros(n, np.int32)
    mask = np.zeros(n, np.int32)
    for i, p in enumerate(parents):
        if p < 0:
            mask[i] = 1 | (1 << (i + 1))
        else:
            depth[i] = depth[p] + 1
            mask[i] = mask[p] | (1 << (i + 1))
    return depth, mask


def tree_work_items(row_tree_mask: np.ndarray, tree_start: np.ndarray,
                    item_req: np.ndarray, token_item: np.ndarray,
                    token_off: np.ndarray, qb: int):
    """Lower per-row tree masks onto the work items: per item its
    request's frontier slot (-1 = no tree rows) and, per window offset
    (``token_off``, from the item's 8-aligned window start), the row's
    bitmask, ``[items, qb + 8]``: the two arrays a 9-tuple schedule
    adds."""
    it_ts = np.full(item_req.shape[0], -1, np.int32)
    it_mask = np.zeros((item_req.shape[0], qb + 8), np.int32)
    for tt in np.nonzero(row_tree_mask)[0]:
        it = token_item[tt]
        it_mask[it, token_off[tt]] = row_tree_mask[tt]
        it_ts[it] = tree_start[item_req[it]]
    return it_ts, it_mask


def _layer_and_scale(kv_cache, kv_scale, layer):
    """(stacked cache, layer index, [L, 2] float32 scales), as the JAX
    wrappers normalise them: no layer = a single-layer cache view; no
    scale = ones; a scalar scale applies to K and V of every layer."""
    if layer is None:
        kv_cache = kv_cache[None]
        layer = 0
    num_layers = kv_cache.shape[0]
    dev = kv_cache.device
    if kv_scale is None:
        kv_scale = torch.ones((num_layers, 2), dtype=torch.float32,
                              device=dev)
    else:
        kv_scale = torch.as_tensor(kv_scale, dtype=torch.float32,
                                   device=dev)
        if kv_scale.ndim != 2:
            kv_scale = kv_scale.reshape(-1)[0].expand(num_layers, 2)
    return kv_cache, int(layer), kv_scale.contiguous()


def _plain(q, kv_cache, layer, kv_scale, positions, req_idx, block_tables,
           seq_lens, scale, tree=None):
    tree_start, row_tree_mask = tree or (None, None)
    return ragged_paged_attention_reference(
        q, kv_cache[layer], positions, req_idx, block_tables, seq_lens,
        scale=scale, kv_scale=kv_scale[layer], tree_start=tree_start,
        row_tree_mask=row_tree_mask)


def _plain_uniform(q, kv_cache, layer, kv_scale, pos_base, block_tables,
                   seq_lens, qlen, scale):
    """The plain version of a uniform-``qlen`` decode step: rows
    ``[s*qlen, (s+1)*qlen)`` at positions ``pos_base[s] + j``; rows past
    ``B * qlen`` and rows of dead slots (``seq_lens == 0``) are padding."""
    t = q.shape[0]
    b = block_tables.shape[0]
    rows = torch.arange(t, device=q.device)
    seq = torch.div(rows, qlen, rounding_mode="floor")
    live = seq < b
    seq_c = seq.clamp(max=b - 1)
    live &= seq_lens.to(q.device)[seq_c] > 0
    req = torch.where(live, seq_c, -1)
    positions = pos_base.to(q.device)[seq_c] + rows % qlen
    return _plain(q, kv_cache, layer, kv_scale, positions, req,
                  block_tables, seq_lens, scale)


def tree_rows(schedule, req_idx, num_reqs: int):
    """The plain version's tree arrays from a 9-tuple schedule: per request
    the frontier slot (``tree_start`` [B], -1 = no tree) and per token row
    its ancestor bitmask (``row_tree_mask`` [T]), read back from the work
    items' per-window-offset masks."""
    item_req, token_item, token_off, item_ts, item_mask = (
        torch.as_tensor(schedule[i]).cpu().long() for i in (0, 5, 6, 7, 8))
    tree_start = torch.full((num_reqs,), -1, dtype=torch.int32)
    has = item_ts >= 0
    tree_start[item_req[has]] = item_ts[has].int()
    live = torch.as_tensor(req_idx).cpu() >= 0
    t = live.shape[0]
    rows = item_mask[token_item[:t], token_off[:t]].int()
    return tree_start, torch.where(live, rows, 0)


def _check(q, kv_cache):
    """Raise on anything the kernels do not take."""
    if not (q.is_cuda and kv_cache.device == q.device):
        raise ValueError("q and kv_cache must be on the same CUDA device")
    if kv_cache.dtype not in _KV_DTYPES:
        raise TypeError(f"kv cache dtype {kv_cache.dtype} not supported "
                        f"(need one of {_KV_DTYPES})")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q dtype {q.dtype} not supported (bfloat16 only)")
    t, hq, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported (64 or 128)")
    _, _, two, bs, hkv_d = kv_cache.shape
    if two != 2 or bs != _BLOCK_SIZE:
        raise ValueError(f"cache pages must be [2, {_BLOCK_SIZE}, Hkv*D], "
                         f"got {tuple(kv_cache.shape[2:])}")
    if hkv_d % d or hq % (hkv_d // d):
        raise ValueError(f"q heads {hq} do not group over kv width {hkv_d}")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("q and kv_cache must be contiguous")
    if kv_cache.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("q and kv_cache must be 16-byte aligned")


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ragged_paged_attention_kernel(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    positions: torch.Tensor,
    req_idx: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float | None = None,
    qb: int = 32,
    schedule: tuple | None = None,
    kv_scale: torch.Tensor | None = None,
    layer: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal attention of a flat ragged query batch against the paged
    cache; same contract as the JAX kernel.

    ``schedule`` is the 7-tuple from :func:`build_work_items` (the
    engine's fast path), or a 9-tuple that adds ``item_tree_start``
    [items] and ``item_tree_mask`` [items, qb + 8] for token-tree
    verification; without one it is derived on the host from
    ``req_idx``/``positions``.  ``kv_cache`` is the stacked
    ``[L, N, 2, Bs, Hkv*D]`` cache with ``layer`` its layer index (or one
    layer ``[N, 2, Bs, Hkv*D]`` when ``layer`` is None); ``kv_scale`` the
    per-layer ``[L, 2]`` dequant scales.  Padding tokens (req_idx < 0)
    come out zero.
    """
    global ragged_attention_launches, tree_attention_launches
    t, hq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    kv_cache, layer, kv_scale = _layer_and_scale(kv_cache, kv_scale, layer)
    if schedule is not None and len(schedule) not in (7, 9):
        raise ValueError(f"schedule has {len(schedule)} arrays (7 or 9)")
    use_tree = schedule is not None and len(schedule) == 9
    if not q.is_cuda:
        tree = (tree_rows(schedule, req_idx, block_tables.shape[0])
                if use_tree else None)
        return _plain(q, kv_cache, layer, kv_scale, positions, req_idx,
                      block_tables, seq_lens, scale, tree)
    _check(q, kv_cache)
    dev = q.device
    if schedule is None:
        req_np = req_idx.cpu().numpy()
        pos_np = positions.cpu().numpy()
        b = block_tables.shape[0]
        qlens = np.zeros(b, np.int64)
        last = np.zeros(b, np.int64)
        for i in range(t):
            r = req_np[i]
            if r >= 0:
                qlens[r] += 1
                last[r] = max(last[r], pos_np[i])
        schedule = build_work_items(qlens, last, qb, kv_cache.shape[3],
                                    -(-t // qb) + b, t)
    # token_off is not needed: the kernel writes rows in token order.
    item_req, item_qstart, item_qlen, item_pages, item_pos_base, \
        token_item = (_i32(a, dev) for a in schedule[:6])
    tree_ptrs, tree_qw = (None, None), 0
    if use_tree:
        item_ts, item_mask = _i32(schedule[7], dev), _i32(schedule[8], dev)
        n_items = item_req.numel()
        if item_mask.ndim != 2 or item_mask.shape[0] != n_items or \
                item_ts.numel() != n_items:
            raise ValueError("tree arrays do not match the work items")
        tree_ptrs = (item_ts.data_ptr(), item_mask.data_ptr())
        tree_qw = item_mask.shape[1]
    req_idx = _i32(req_idx, dev)
    block_tables = _i32(block_tables, dev)
    out = torch.empty_like(q)
    num_layers, n_blocks, _, bs, hkv_d = kv_cache.shape
    rc = _lib().ragged_attention_launch(
        q.data_ptr(), out.data_ptr(), kv_cache.data_ptr(),
        kv_scale.data_ptr(), item_req.data_ptr(), item_qstart.data_ptr(),
        item_qlen.data_ptr(), item_pages.data_ptr(),
        item_pos_base.data_ptr(), token_item.data_ptr(), req_idx.data_ptr(),
        block_tables.data_ptr(), *tree_ptrs, tree_qw, layer,
        item_req.numel(), t, hq,
        hkv_d // d, d, block_tables.shape[1], n_blocks * 2 * bs * hkv_d,
        int(kv_cache.dtype == torch.float8_e4m3fn), RAGGED_ROWS_PER_WARP,
        float(scale), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ragged_attention_launch failed: CUDA error {rc}")
    if use_tree:
        tree_attention_launches += 1
    else:
        ragged_attention_launches += 1
    return out


def grouped_decode_attention_kernel(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    pos_base: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    qlen: int = 1,
    gsz: int = 8,
    scale: float | None = None,
    kv_scale: torch.Tensor | None = None,
    layer: int | torch.Tensor | None = None,
    knew: torch.Tensor | None = None,
    vnew: torch.Tensor | None = None,
    slot_mapping: torch.Tensor | None = None,
) -> torch.Tensor:
    """Uniform-``qlen`` decode attention: rows ``[s*qlen, (s+1)*qlen)``
    of ``q`` are sequence ``s``'s frontier tokens at positions
    ``pos_base[s] + j``.

    ``q`` may have more or fewer rows than ``B * qlen`` (the token bucket
    against the sequence-slot axis, as the JAX dispatch's ``fit`` pads
    and trims): rows past ``B * qlen`` and rows of dead slots
    (``seq_lens == 0``) come out zero.

    Deferred writes: ``knew`` / ``vnew`` ([t, Hkv*D] in the cache's dtype,
    divided by the layer's k / v scale like cache rows) and
    ``slot_mapping`` [t] come together.  The step's new rows are then not
    in the cache yet: each row reads the cache below ``pos_base`` and
    attends new row j of its sequence iff j <= its own index and j <
    ``new_len`` (the sequence's rows with a slot >= 0; rows past ``t``
    count as slot -1).  At most :data:`MAX_DEFERRED_QLEN` rows per
    sequence.

    ``gsz`` (sequences per TPU grid program, which amortised the TPU's
    per-program cost) is accepted so the signatures match, and ignored:
    the CUDA kernel runs one CTA per (sequence, kv head), its rows in m16
    tiles on the tensor cores.  A row's output does not depend on its row
    index or on ``qlen``: 16-slot chunks go to the kernel's four page
    streams by slot index.
    """
    global grouped_decode_launches, deferred_decode_launches
    del gsz
    t, hq, d = q.shape
    b = block_tables.shape[0]
    if scale is None:
        scale = d ** -0.5
    kv_cache, layer, kv_scale = _layer_and_scale(kv_cache, kv_scale, layer)
    deferred = knew is not None
    if deferred != (vnew is not None) or deferred != (slot_mapping
                                                      is not None):
        raise ValueError("knew, vnew and slot_mapping come together")
    if deferred:
        width = kv_cache.shape[-1]
        if knew.shape != (t, width) or vnew.shape != (t, width) or \
                slot_mapping.shape != (t,):
            raise ValueError(
                f"knew / vnew must be [{t}, {width}] and slot_mapping "
                f"[{t}]; got {tuple(knew.shape)}, {tuple(vnew.shape)}, "
                f"{tuple(slot_mapping.shape)}")
        if knew.dtype != kv_cache.dtype or vnew.dtype != kv_cache.dtype:
            raise TypeError("knew / vnew must be in the cache's dtype "
                            f"{kv_cache.dtype}")
        if qlen > MAX_DEFERRED_QLEN:
            raise ValueError(f"qlen {qlen} > {MAX_DEFERRED_QLEN} rows per "
                             "sequence with deferred writes")
    if not q.is_cuda:
        if deferred:
            return grouped_decode_deferred_reference(
                q, kv_cache[layer], pos_base, block_tables, seq_lens, qlen,
                knew, vnew, slot_mapping, scale=scale,
                kv_scale=kv_scale[layer])
        return _plain_uniform(q, kv_cache, layer, kv_scale, pos_base,
                              block_tables, seq_lens, qlen, scale)
    _check(q, kv_cache)
    dev = q.device
    pos_base = _i32(pos_base, dev)
    seq_lens = _i32(seq_lens, dev)
    block_tables = _i32(block_tables, dev)
    inject = (None, None, None)
    if deferred:
        if knew.device != dev or vnew.device != dev or \
                not (knew.is_contiguous() and vnew.is_contiguous()):
            raise ValueError("knew / vnew must be contiguous on q's device")
        if knew.data_ptr() % 16 or vnew.data_ptr() % 16:
            raise ValueError("knew / vnew must be 16-byte aligned")
        slot_mapping = _i32(slot_mapping, dev)
        inject = (knew.data_ptr(), vnew.data_ptr(), slot_mapping.data_ptr())
    out = torch.empty_like(q)
    num_layers, n_blocks, _, bs, hkv_d = kv_cache.shape
    # Rows of a (sequence, kv head) per pass over the pages: one m16 tile
    # up to 16 rows (qlen 1 and 4 at group 4), two beyond (qlen 8 in one
    # pass; deferred steps of up to 32 rows take further passes).
    rows_per_tile = 16 if int(qlen) * hq // (hkv_d // d) <= 16 else 32
    rc = _lib().grouped_decode_launch(
        q.data_ptr(), out.data_ptr(), kv_cache.data_ptr(),
        kv_scale.data_ptr(), pos_base.data_ptr(), seq_lens.data_ptr(),
        block_tables.data_ptr(), *inject, layer, b, t, int(qlen), hq,
        hkv_d // d, d, block_tables.shape[1], n_blocks * 2 * bs * hkv_d,
        int(kv_cache.dtype == torch.float8_e4m3fn), rows_per_tile,
        float(scale), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"grouped_decode_launch failed: CUDA error {rc}")
    if deferred:
        deferred_decode_launches += 1
    else:
        grouped_decode_launches += 1
    return out


def range_plan(seq_len: int,
               range_pages: int | None = None) -> list[tuple[int, int]]:
    """Kernel 4's page ranges of a sequence whose rows attend ``seq_len``
    slots: ``[(first page, end page)]``, range r covering pages ``[r *
    range_pages, min((r + 1) * range_pages, pages))``.  It depends on
    nothing but the length and ``range_pages``, never on the batch or
    qlen; the kernel computes the same ranges from each sequence's last
    attended slot.  ``range_pages`` defaults to :data:`RANGE_PAGES`."""
    range_pages = range_pages or RANGE_PAGES
    pages = -(-seq_len // _BLOCK_SIZE)
    return [(p, min(p + range_pages, pages))
            for p in range(0, pages, range_pages)]


def _counters(device: torch.device, n: int) -> torch.Tensor:
    cnt = _range_counters.get(device.index)
    if cnt is None or cnt.numel() < n:
        cnt = _range_counters[device.index] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=device)
    return cnt


def decode_paged_attention_kernel(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    pos_base: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    qlen: int,
    scale: float | None = None,
    kv_scale: torch.Tensor | None = None,
    layer: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """Uniform-``qlen`` decode attention over the paged cache; the JAX
    kernel's contract.

    q: [B*qlen, Hq, D] sequence-major (token j of sequence i at row
    i*qlen + j); pos_base [B]: absolute position of each sequence's first
    new token; seq_lens [B]: its total tokens (context and new; 0 = a
    dead slot, whose rows come out zero).  Row j attends positions
    ``<= pos_base + j``.  As for the grouped kernel, rows past ``B *
    qlen`` come out zero.

    On the card one CTA per (sequence, kv head, page range)
    (:func:`range_plan`); a sequence over several ranges has its ranges'
    float32 states merged in range order, through scratch of ``B * Hkv *
    ceil(max_blk / RANGE_PAGES) * qlen * group`` rows of D + 4 floats.  A
    row's output does not depend on ``qlen``.
    """
    global decode_paged_launches
    t, hq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    kv_cache, layer, kv_scale = _layer_and_scale(kv_cache, kv_scale, layer)
    if not q.is_cuda:
        return _plain_uniform(q, kv_cache, layer, kv_scale, pos_base,
                              block_tables, seq_lens, qlen, scale)
    _check(q, kv_cache)
    num_layers, n_blocks, _, bs, hkv_d = kv_cache.shape
    hkv = hkv_d // d
    dev = q.device
    pos_base = _i32(pos_base, dev)
    seq_lens = _i32(seq_lens, dev)
    block_tables = _i32(block_tables, dev)
    b, max_blk = block_tables.shape
    out = torch.empty_like(q)
    rows_head = int(qlen) * hq // hkv
    # The kernel's grid has a CTA for every range of the longest sequence
    # the block table holds; those past a sequence's last range exit.
    range_pages = RANGE_PAGES
    n_ranges = len(range_plan(max_blk * _BLOCK_SIZE, range_pages))
    part = counter = None
    if n_ranges > 1:
        part = torch.empty(b * hkv * n_ranges * rows_head * (d + _PART_PAD),
                           dtype=torch.float32, device=dev)
        counter = _counters(dev, b * hkv)
    rc = _lib().decode_paged_launch(
        q.data_ptr(), out.data_ptr(), kv_cache.data_ptr(),
        kv_scale.data_ptr(), pos_base.data_ptr(), seq_lens.data_ptr(),
        block_tables.data_ptr(), None if part is None else part.data_ptr(),
        None if counter is None else counter.data_ptr(), layer, b, t,
        int(qlen), hq, hkv, d, max_blk, n_blocks * 2 * bs * hkv_d,
        int(kv_cache.dtype == torch.float8_e4m3fn),
        16 if rows_head <= 16 else 32, range_pages, float(scale),
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"decode_paged_launch failed: CUDA error {rc}")
    decode_paged_launches += 1
    return out
