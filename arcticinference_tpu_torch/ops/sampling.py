"""Token sampling, penalties and speculative verification (plain torch).

Counterpart of ``arcticinference_tpu/ops/sampling.py``:

- :func:`sample`: greedy / temperature / top-k / top-p / min-p over a
  batch of logit rows with per-row parameters;
- :func:`apply_penalties`: repetition / presence / frequency penalties
  (vLLM semantics);
- :func:`apply_vocab_mask`: a packed grammar bitmask over sample rows;
- :func:`verify_greedy` / :func:`verify_stochastic`: greedy-accept and
  rejection-sampling verification of a padded draft batch.

Random numbers come from ``torch.Generator``s, so a seed gives other
tokens than the JAX package's PRNG; the distribution is the same.
"""

from __future__ import annotations

import torch

NO_TOKEN = -1


def _row_uniforms(n: int, v: int, generator: torch.Generator,
                  device: torch.device, seeds, counters) -> torch.Tensor:
    """[n, v] uniforms in (0, 1): rows with seed >= 0 draw from a
    generator seeded with (seed, counter), so a seeded request reproduces
    its stream however it was co-scheduled; other rows draw from the
    engine's ``generator``."""
    u = torch.rand((n, v), generator=generator, device=device)
    if seeds is not None:
        seeds_h = seeds.tolist()
        counters_h = (counters.tolist() if counters is not None
                      else [0] * n)
        for i, (s, c) in enumerate(zip(seeds_h, counters_h)):
            if s >= 0:
                g = torch.Generator(device=device)
                g.manual_seed((int(s) << 32) | (int(c) & 0xFFFFFFFF))
                u[i] = torch.rand(v, generator=g, device=device)
    return u.clamp_(min=torch.finfo(torch.float32).tiny)


def sample(logits: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor,
           generator: torch.Generator,
           min_p: torch.Tensor | None = None,
           seeds: torch.Tensor | None = None,
           counters: torch.Tensor | None = None) -> torch.Tensor:
    """Sample one token per row.

    logits: [N, V] fp32; temperature/top_k/top_p: [N] (temperature 0 =>
    greedy; top_k 0 => disabled; top_p 1 => disabled).  min_p: [N]
    (0 => disabled): drop tokens whose probability is below min_p *
    max-probability (after temperature).  seeds/counters: [N] per-row
    seeded sampling (seed < 0 = the step generator).  Returns [N] int32.
    """
    n, v = logits.shape
    neg_inf = float("-inf")
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)

    t = torch.where(temperature > 0, temperature, 1.0)[:, None]
    scaled = logits / t

    if min_p is not None:
        probs = torch.softmax(scaled, dim=-1)
        cutoff = min_p[:, None] * probs.max(dim=-1, keepdim=True).values
        scaled = scaled.masked_fill((probs < cutoff) & (min_p[:, None] > 0),
                                    neg_inf)

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, v).long()
    kth = torch.gather(sorted_desc, 1, (k[:, None] - 1).clamp(0, v - 1))
    scaled = scaled.masked_fill(scaled < kth, neg_inf)

    # Top-p over the sorted distribution: keep tokens whose exclusive
    # cumulative probability is < top_p.
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep = (cum - probs_sorted) < top_p[:, None]
    thresh = torch.where(keep, sorted_desc, float("inf")).min(dim=-1).values
    scaled = scaled.masked_fill(scaled < thresh[:, None], neg_inf)

    # Categorical draw as argmax of logits + Gumbel noise.
    u = _row_uniforms(n, v, generator, logits.device, seeds, counters)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature == 0, greedy, sampled)


def apply_penalties(logits: torch.Tensor, output_tokens: torch.Tensor,
                    all_tokens: torch.Tensor,
                    repetition_penalty: torch.Tensor,
                    presence_penalty: torch.Tensor,
                    frequency_penalty: torch.Tensor) -> torch.Tensor:
    """Repetition / presence / frequency penalties (vLLM semantics).

    logits: [N, V]; output_tokens: [N, Lo] the request's generated tokens
    (-1 padded); all_tokens: [N, La] prompt + generated (-1 padded);
    penalties: [N] (repetition 1.0 / presence 0.0 / frequency 0.0 =>
    no-op).  Frequency and presence act on output counts; repetition
    divides positive (multiplies negative) logits of any token present in
    prompt or output.
    """
    n, v = logits.shape
    dev = logits.device

    def scatter(tokens, reduce):
        valid = (tokens >= 0).float()
        idx = tokens.long().clamp(0, v - 1)
        out = torch.zeros((n, v), dtype=torch.float32, device=dev)
        return out.scatter_reduce_(1, idx, valid, reduce=reduce)

    counts = scatter(output_tokens, "sum")
    seen = scatter(all_tokens, "amax")
    logits = logits - frequency_penalty[:, None] * counts
    logits = logits - presence_penalty[:, None] * (counts > 0)
    rp = repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    return torch.where(seen > 0, penalized, logits)


def apply_vocab_mask(logits: torch.Tensor, rows: torch.Tensor,
                     mask_words: torch.Tensor) -> torch.Tensor:
    """Grammar-guided vocab bitmask over sample rows.

    logits: [N, V]; rows: [G] sample-row indices (-1 = padding, dropped);
    mask_words: [G, W] packed little-endian bitmask (int32 bit i of word
    w = token ``32*w + i``), W*32 >= V.  Disallowed tokens' logits become
    the dtype's minimum; other rows are returned unchanged.
    """
    g, w = mask_words.shape
    v = logits.shape[-1]
    shifts = torch.arange(32, dtype=mask_words.dtype,
                          device=mask_words.device)
    bits = (mask_words[:, :, None] >> shifts) & 1
    allow = bits.reshape(g, w * 32)[:, :v] != 0
    keep = rows >= 0
    tgt = rows[keep].long()
    out = logits.clone()
    out[tgt] = torch.where(allow[keep], logits[tgt],
                           torch.finfo(logits.dtype).min)
    return out


def verify_greedy(draft_tokens: torch.Tensor, num_draft: torch.Tensor,
                  target_argmax: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy-accept verification.

    draft_tokens: [B, K] (padded with anything); num_draft: [B] drafts
    per row; target_argmax: [B, K+1] the target's argmax after consuming
    j drafts.  Returns (out_tokens [B, K+1] int32 padded with
    :data:`NO_TOKEN`, num_out [B]): the longest prefix of drafts equal
    to the argmax chain, then the bonus token (the argmax at the first
    mismatch, or after all drafts).
    """
    b, k = draft_tokens.shape
    dev = draft_tokens.device
    pos = torch.arange(k, device=dev)[None, :]
    match = (draft_tokens == target_argmax[:, :k]) & \
        (pos < num_draft[:, None])
    num_accepted = torch.cumprod(match.int(), dim=-1).sum(-1)
    return _emit(draft_tokens, num_accepted,
                 torch.gather(target_argmax, 1, num_accepted[:, None].long()))


def verify_stochastic(draft_tokens: torch.Tensor, draft_probs: torch.Tensor,
                      num_draft: torch.Tensor, target_probs: torch.Tensor,
                      generator: torch.Generator
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rejection sampling (Leviathan et al.) against the target model.

    draft_tokens: [B, K]; draft_probs: [B, K] the probability the drafter
    gave each drafted token; target_probs: [B, K+1, V].  Returns
    (out_tokens [B, K+1], num_out [B]).  Draft j is accepted when
    ``u * q_j <= p_j``; at the first rejection the token is resampled
    from the target row with the drafted token's point mass removed
    (the exact residual for a deterministic, one-hot drafter, as in the
    JAX package), and after all drafts a bonus token is sampled from the
    next target row.
    """
    b, k = draft_tokens.shape
    v = target_probs.shape[-1]
    dev = draft_tokens.device
    u = torch.rand((b, k), generator=generator, device=dev)
    idx = draft_tokens.long()
    p_target = torch.gather(target_probs[:, :k, :], 2, idx[..., None])[..., 0]
    pos = torch.arange(k, device=dev)[None, :]
    accept = ((u * draft_probs.clamp(min=1e-20)) <= p_target) & \
        (pos < num_draft[:, None])
    num_accepted = torch.cumprod(accept.int(), dim=-1).sum(-1)

    rows = torch.arange(b, device=dev)
    first_rej = torch.clamp(num_accepted, max=k - 1).long()
    p_res = target_probs[rows, first_rej].clone()
    p_res[rows, idx[rows, first_rej]] = 0.0
    p_res = p_res / p_res.sum(-1, keepdim=True).clamp(min=1e-20)
    # Categorical over max(p, 1e-20), as the JAX package draws it.
    resample = torch.multinomial(p_res.clamp(min=1e-20), 1,
                                 generator=generator)[:, 0]
    bonus_probs = target_probs[rows, num_draft.long()]
    bonus = torch.multinomial(bonus_probs.clamp(min=1e-20), 1,
                              generator=generator)[:, 0]
    extra = torch.where(num_accepted >= num_draft, bonus, resample)
    return _emit(draft_tokens, num_accepted, extra[:, None])


def _emit(draft_tokens, num_accepted, extra):
    """[B, K+1] outputs: the accepted drafts, then ``extra`` [B, 1] at
    position ``num_accepted``, :data:`NO_TOKEN` after; and num_out."""
    b, k = draft_tokens.shape
    dev = draft_tokens.device
    out_pos = torch.arange(k + 1, device=dev)[None, :]
    drafts_ext = torch.cat(
        [draft_tokens, torch.zeros((b, 1), dtype=draft_tokens.dtype,
                                   device=dev)], dim=-1)
    out = torch.where(out_pos == num_accepted[:, None],
                      extra.to(draft_tokens.dtype), drafts_ext)
    out = torch.where(out_pos <= num_accepted[:, None], out, NO_TOKEN)
    return out.to(torch.int32), (num_accepted + 1).to(num_accepted.dtype)
