"""Device-resident grammar state for pipelined guided decoding (plain
torch ops).

Counterpart of ``arcticinference_tpu/ops/guided.py``.  The synchronous
guided path ships one host-computed vocab bitmask per guided row and
step (``serving/guided_dfa.py``).  On the pipelined step the whole
grammar lives in a device pool instead: a per-state mask table and an
interval transition table.  The automaton state rides the step's packed
output vector (as passthrough tokens do), and the state advance happens
on the device by walking the committed token's codepoints through the
transition table, so a guided request needs no host work per step.

Data layout (built by ``TokenDfaIndex.device_tables``):

- ``masks [P, S_pad, W] int32``: per-slot per-state vocab bitmask;
- ``keys [P, I_pad] int32``: ``state << 21 | interval_lo``, ascending
  (one ``searchsorted`` resolves a (state, codepoint) step), padded with
  the int32 maximum;
- ``hi [P, I_pad] int32``: interval upper bounds (inclusive);
- ``nxt [P, I_pad] int32``: interval target states;
- ``cps [V, L] int32``: per-token codepoint rows, ``PAD_CP`` padded
  (shared by every slot).

The dead state is -1; its mask is the sentinel "bit 0 only", so sampling
stays defined after grammar completion (the host trims tokens sampled
past it when it drains the step, as it trims length overshoot).
"""

from __future__ import annotations

import torch

from arcticinference_tpu_torch.serving.guided_dfa import PAD_CP


def guided_mask_rows(states: torch.Tensor, slots: torch.Tensor,
                     masks_pool: torch.Tensor) -> torch.Tensor:
    """Each guided row's current mask: [G, W] int32.

    states / slots: [G] (-1 padded).  Dead and padding rows get the
    sentinel bit-0 mask.
    """
    p, s_pad, w = masks_pool.shape
    rows = masks_pool[slots.clamp(0, p - 1).long(),
                      states.clamp(0, s_pad - 1).long()]
    # Built on the device: writing a host scalar into it would wait.
    sentinel = (torch.arange(w, device=masks_pool.device) == 0) \
        .to(masks_pool.dtype)
    ok = (states >= 0) & (states < s_pad) & (slots >= 0)
    return torch.where(ok[:, None], rows, sentinel[None, :])


def guided_advance(states: torch.Tensor, slots: torch.Tensor,
                   tokens: torch.Tensor, cps_matrix: torch.Tensor,
                   keys_pool: torch.Tensor, hi_pool: torch.Tensor,
                   nxt_pool: torch.Tensor) -> torch.Tensor:
    """Advance each row's DFA state by its token's codepoints.

    states / slots / tokens: [G] int32; returns the next states [G]
    int32 (-1 = dead).  Padding rows (slot < 0) pass through unchanged.
    One batched ``searchsorted`` per codepoint of the fixed
    ``cps_matrix`` width (``DEVICE_LMAX``).
    """
    g = states.shape[0]
    p, i_pad = keys_pool.shape
    v, lmax = cps_matrix.shape
    safe_slot = slots.clamp(0, p - 1).long()
    cps = cps_matrix[tokens.clamp(0, v - 1).long()].to(torch.int32)
    keys = keys_pool[safe_slot]          # [G, I]
    his = hi_pool[safe_slot]
    nxts = nxt_pool[safe_slot]
    rng = torch.arange(g, device=states.device)
    st = states.to(torch.int32)
    for i in range(lmax):
        cp = cps[:, i]
        key = torch.where(st >= 0, (st << 21) | cp, 0)
        j = torch.searchsorted(keys, key[:, None], right=True)[:, 0] - 1
        sj = j.clamp(0, i_pad - 1)
        kk = keys[rng, sj]
        hit = (j >= 0) & ((kk >> 21) == st) & (cp <= his[rng, sj])
        stepped = torch.where(hit, nxts[rng, sj], -1)
        st = torch.where(cp == PAD_CP, st,
                         torch.where(st >= 0, stepped, -1))
    return torch.where(slots >= 0, st, states.to(torch.int32))
