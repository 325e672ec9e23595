"""Ragged paged attention: the plain PyTorch version.

:func:`ragged_paged_attention_reference` computes what
``arcticinference_tpu/ops/attention.py::ragged_paged_attention_reference``
computes, and is the plain version of both CUDA kernels in
``ops/cuda/ragged_attention.py``: the CPU path of their wrappers, and what
they are held against on the card.

Metadata contract (tensors on one device):
  q               [T, Hq, D]    flat new-token queries
  kv_cache        [N, 2, Bs, Hkv*D]  one layer of the paged cache
  positions       [T]           absolute position of each query token
  req_idx         [T]           which request each token belongs to (padding: -1)
  block_tables    [B, MaxBlk]   physical block ids per request
  seq_lens        [B]           total context length per request (incl. new)

The JAX reference gathers every request's whole page list for every
token (``[T, MaxBlk*Bs, Hkv, D]``); at the main path's sizes that is tens
of GiB, so this version walks the requests and their query rows in
chunks instead.  The arithmetic per row is the same: float32 scores,
``-inf`` outside ``kv_pos <= position and kv_pos < seq_len`` (or, on a
token-tree row, outside its ancestor bitmask), softmax, float32 products
with V.
"""

from __future__ import annotations

import torch

#: Query rows per chunk: bounds the [rows, Hq, S] score tensor.
_ROW_CHUNK = 256


def _kv_scales(kv_scale) -> tuple[float, float] | None:
    """This layer's (k_scale, v_scale): a [2] pair, or one value for
    both; None = no dequant scaling."""
    if kv_scale is None:
        return None
    ks = torch.as_tensor(kv_scale, dtype=torch.float32).reshape(-1)
    return float(ks[0]), float(ks[-1])


def ragged_paged_attention_reference(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    positions: torch.Tensor,
    req_idx: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float | None = None,
    kv_scale=None,
    tree_start: torch.Tensor | None = None,
    row_tree_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Every query token t attends to kv positions j of its request with
    j <= positions[t] (causal) and j < seq_lens[req].  Padding tokens
    (req_idx < 0) produce zeros.

    ``kv_scale``: this layer's [k_scale, v_scale] dequant pair (or a
    scalar applied to both; None = no dequant scaling).

    Tree-draft verification (token-tree speculation): ``tree_start`` [B]
    is the frontier token's cache slot per request (-1 = none) and
    ``row_tree_mask`` [T] a per-row ancestor bitmask.  A row with a
    non-zero mask attends slot ``tree_start + r`` (r in 1..31) iff bit r
    is set, and the real context up to ``tree_start`` as usual, so a
    draft row sees exactly its ancestor chain, never a sibling branch.
    Rows with mask 0 stay causal.  The two tree arrays come together.
    """
    tree = tree_start is not None
    if tree != (row_tree_mask is not None):
        raise ValueError("tree_start and row_tree_mask come together")
    if tree:
        ts_host = tree_start.cpu()
        row_tree_mask = row_tree_mask.to(q.device)
    t_, hq, d = q.shape
    bs = kv_cache.shape[2]
    hkv = kv_cache.shape[3] // d
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    scales = _kv_scales(kv_scale)
    out = torch.zeros((t_, hq, d), dtype=torch.float32, device=q.device)
    req_host = req_idx.cpu()
    seq_host = seq_lens.cpu()
    for r in torch.unique(req_host[req_host >= 0]).tolist():
        rows = torch.nonzero(req_host == r).flatten().to(q.device)
        # A sequence ends at its block table's end: a uniform decode step
        # near max_model_len gives its rows past the limit a longer
        # seq_len, and no valid row attends that far.
        s_len = min(int(seq_host[r]), block_tables.shape[1] * bs)
        pages = block_tables[r, :-(-s_len // bs)].long()
        kv = kv_cache[pages]                          # [P, 2, Bs, Hkv*D]
        k = kv[:, 0].reshape(-1, hkv, d)[:s_len].float()
        v = kv[:, 1].reshape(-1, hkv, d)[:s_len].float()
        if scales is not None:
            k = k * scales[0]
            v = v * scales[1]
        kv_pos = torch.arange(s_len, device=q.device)
        for lo in range(0, rows.numel(), _ROW_CHUNK):
            rr = rows[lo:lo + _ROW_CHUNK]
            qg = (q[rr].float() * scale).reshape(-1, hkv, group, d)
            scores = torch.einsum("thgd,shd->thgs", qg, k)
            valid = kv_pos[None, :] <= positions[rr].long()[:, None]
            if tree:
                m = row_tree_mask[rr].long()[:, None]
                rel = kv_pos[None, :] - int(ts_host[r])
                bit = (m >> rel.clamp(0, 31)) & 1
                override = (m != 0) & (rel >= 1)
                valid = torch.where(override, (rel < 32) & (bit > 0), valid)
            scores = scores.masked_fill(~valid[:, None, None, :],
                                        float("-inf"))
            p = torch.softmax(scores, dim=-1)
            o = torch.einsum("thgs,shd->thgd", p, v)
            out[rr] = o.reshape(-1, hq, d)
    return out.to(q.dtype)


def grouped_decode_deferred_reference(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    pos_base: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    qlen: int,
    knew: torch.Tensor,
    vnew: torch.Tensor,
    slot_mapping: torch.Tensor,
    scale: float | None = None,
    kv_scale=None,
) -> torch.Tensor:
    """Uniform-``qlen`` decode attention with the step's new K/V rows
    injected instead of read back from the cache: the plain version of the
    grouped decode kernel's deferred-write path (the JAX kernel's
    ``knew=`` branch, ``ops/pallas/ragged_attention.py``).

    Rows ``[s*qlen, (s+1)*qlen)`` of ``q`` [T, Hq, D] are sequence s's.
    Row j of sequence s attends the cache slots ``< pos_base[s]`` of its
    pages (``kv_cache`` is one layer, [N, 2, Bs, Hkv*D]) and the new rows
    ``knew`` / ``vnew`` [T, Hkv*D] (cache dtype; ``kv_scale`` applies to
    them as to cache rows) of its sequence at ``j' <= j`` and ``j' <
    new_len[s]``, where ``new_len[s]`` counts the sequence's rows with
    ``slot_mapping >= 0`` (rows past T count as -1, as the JAX dispatch
    pads them).  Rows past ``B*qlen`` and rows of dead sequences
    (``seq_lens == 0``) come out zero.
    """
    t_, hq, d = q.shape
    b = block_tables.shape[0]
    bs = kv_cache.shape[2]
    hkv = kv_cache.shape[3] // d
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    scales = _kv_scales(kv_scale)
    out = torch.zeros((t_, hq, d), dtype=torch.float32, device=q.device)
    slots = torch.full((b * qlen,), -1, dtype=torch.long)
    n = min(t_, b * qlen)
    slots[:n] = slot_mapping[:n].cpu().long()
    new_len = (slots.reshape(b, qlen) >= 0).sum(1).tolist()
    seq_host = seq_lens.cpu().tolist()
    base_host = pos_base.cpu().tolist()
    for s in range(b):
        r0 = s * qlen
        if seq_host[s] <= 0 or r0 >= t_:
            continue
        nq = min(qlen, t_ - r0)
        ctx = min(int(base_host[s]), int(seq_host[s]))
        pages = block_tables[s, :-(-ctx // bs)].long()
        kc = kv_cache[pages]                          # [P, 2, Bs, Hkv*D]
        nl = new_len[s]
        k = torch.cat([kc[:, 0].reshape(-1, hkv * d)[:ctx],
                       knew[r0:r0 + nl]]).reshape(-1, hkv, d).float()
        v = torch.cat([kc[:, 1].reshape(-1, hkv * d)[:ctx],
                       vnew[r0:r0 + nl]]).reshape(-1, hkv, d).float()
        if scales is not None:
            k = k * scales[0]
            v = v * scales[1]
        qg = (q[r0:r0 + nq].float() * scale).reshape(nq, hkv, group, d)
        scores = torch.einsum("thgd,shd->thgs", qg, k)
        col = torch.arange(ctx + nl, device=q.device)
        row = torch.arange(nq, device=q.device)
        valid = (col[None, :] < ctx) | (col[None, :] - ctx <= row[:, None])
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
        p = torch.softmax(scores, dim=-1)
        out[r0:r0 + nq] = torch.einsum("thgs,shd->thgd", p, v).reshape(
            nq, hq, d)
    return out.to(q.dtype)
