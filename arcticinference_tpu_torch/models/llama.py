"""Llama as plain functions over a parameter dictionary.

Counterpart of ``arcticinference_tpu/models/llama.py``.  Parameters keep
the JAX package's keys and layout: per-layer weights are stacked along a
leading layer axis, matmul weights are ``[in, out]``, and after
:func:`fuse_params` q|k|v and gate|up are one weight each.  The layer
stack is a Python loop (the JAX package's ``lax.scan``); each layer
indexes its weights in place, so no weight is copied per step.

The paged cache ``[L, N_blk, 2, Bs, Hkv*D]`` is written in place
(``_write_kv_layer``), and attention receives the whole stacked cache
plus the layer index, so no per-layer cache slice is copied either.
With ``ARCTIC_TPU_DEFERRED_KV=1`` a grouped decode step defers the
writes instead: each layer's attention takes its new K/V rows as
operands, and one in-place scatter lands all layers' rows after the
stack (``_bulk_write_kv``).

Weight-only quantization (``quantization="fp8" | "int8" | "int4"``)
turns the matmul weights and the LM head into ``QuantizedLinear`` leaves
(``ops/fp8.py``) and, when the LM head is untied, the embedding table
into fp8.

The Qwen families share this decoder body (``models/qwen2.py``,
``models/qwen3.py``): ``attention_bias`` adds q/k/v biases after the
projections (``bq``/``bk``/``bv``, fused to ``bqkv``), ``qk_norm`` a
per-head RMSNorm on q and k before RoPE (``q_norm``/``k_norm``).  Biases
and norms are never quantized; a bias is added to the product's output,
after a quantized matmul kernel returns, as the JAX package adds it
outside its Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from arcticinference_tpu_torch import envs
from arcticinference_tpu_torch.ops.attention import (
    ragged_paged_attention_reference)
from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
    grouped_decode_attention_kernel, ragged_paged_attention_kernel)
from arcticinference_tpu_torch.ops.fp8 import (QuantizedLinear,
                                               fp8_quantize, fuse_quantized,
                                               matmul, quantize_layers,
                                               weight_quantize)
from arcticinference_tpu_torch.ops.kv_cache import write_kv
from arcticinference_tpu_torch.ops.layers import (apply_rope,
                                                  compute_rope_freqs,
                                                  rms_norm)
from arcticinference_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class LlamaArch:  # registry alias: Arch (see bottom of module)
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 4
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    max_position: int = 131072
    eos_token_id: Optional[int] = None
    # Family variants sharing the Llama decoder body:
    attention_bias: bool = False   # Qwen2/2.5: biases on q/k/v projections
    qk_norm: bool = False          # Qwen3: per-head RMSNorm on q and k
    # Interleaved [q|k|v] / [gate|up] groups in a rank's fused weights
    # (fuse_params' interleave; set by ParallelContext.arch_view).
    fused_seg: int = 1

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "LlamaArch":
        num_heads = cfg.get("num_attention_heads", 16)
        hidden = cfg.get("hidden_size", 2048)
        rope_scaling = cfg.get("rope_scaling")
        if rope_scaling is not None:
            rope_scaling = dict(rope_scaling)
            # HF historically uses "type" or "rope_type".
            rope_scaling.setdefault(
                "rope_type", rope_scaling.get("type", "default"))
        return cls(
            vocab_size=cfg.get("vocab_size", 32000),
            hidden_size=hidden,
            intermediate_size=cfg.get("intermediate_size", 4 * hidden),
            num_layers=cfg.get("num_hidden_layers", 4),
            num_heads=num_heads,
            num_kv_heads=cfg.get("num_key_value_heads", num_heads),
            head_dim=cfg.get("head_dim") or hidden // num_heads,
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            max_position=cfg.get("max_position_embeddings", 131072),
            eos_token_id=_first_eos(cfg.get("eos_token_id")),
            attention_bias=cfg.get("attention_bias", False),
            qk_norm=cfg.get("qk_norm", False),
        )


def _first_eos(eos):
    if isinstance(eos, (list, tuple)):
        return eos[0] if eos else None
    return eos


def init_params(arch: LlamaArch, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                quantization: Optional[str] = None,
                device: torch.device | str | None = None,
                keep: Optional[Callable] = None,
                layers: Optional[range] = None) -> dict:
    """Randomly initialised parameters (benchmarks / tests).

    Drawn on ``device`` (by default the generator's) from ``generator``
    (which must live on that device), so the weights of a full-size model
    never pass through the host.  Normal(0, 0.02) like the JAX package,
    not the same numbers.  Stacked layer weights are drawn one layer at a
    time, and with ``quantization`` each layer is quantized as soon as it
    is drawn, so the full bf16 model never exists; the untied embedding
    is fp8 in every mode, as in the JAX package.

    ``keep(path, leaf)`` (a rank of a mesh: its cut, ``parallel/mesh.py``)
    takes each leaf as soon as it is drawn, a layer weight one layer at a
    time (``path`` ``("layers", key)``, the leaf without its layer axis),
    so one layer of the global weights is alive at a time; the draws are
    the same with and without it.  ``layers`` (a pipeline stage's range)
    keeps only those layers of each stacked weight: the others are drawn,
    to keep the draws the same, and dropped unquantized.
    """
    if device is None:
        device = generator.device
    d, hq, hkv, dh = (arch.hidden_size, arch.num_heads, arch.num_kv_heads,
                      arch.head_dim)
    li, nl = arch.intermediate_size, arch.num_layers
    quant = quantization is not None

    def w(*shape):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return x.mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    if keep is None:
        keep = lambda path, leaf: leaf  # noqa: E731

    kept = range(nl) if layers is None else layers

    def layer(key, draw, *shape, quantize=False):
        """A stacked ``[len(kept), *shape]`` layer weight, one layer at a
        time."""
        parts = []
        for i in range(nl):
            x = draw(*shape)
            if i not in kept:
                continue
            if quantize and quant:
                x = weight_quantize(x, quantization)
            parts.append(keep(("layers", key), x))
        if isinstance(parts[0], QuantizedLinear):
            return QuantizedLinear(torch.stack([p.weight for p in parts]),
                                   torch.stack([p.scale for p in parts]))
        return torch.stack(parts)

    embed = w(arch.vocab_size, d)
    if quant and not arch.tie_word_embeddings:
        # A row gather dequantizes with a scalar scale: fp8 in every mode.
        embed = fp8_quantize(embed)
    params = {
        "embed": keep(("embed",), embed),
        "layers": {
            "input_norm": layer("input_norm", ones, d),
            "post_norm": layer("post_norm", ones, d),
            "wq": layer("wq", w, d, hq * dh, quantize=True),
            "wk": layer("wk", w, d, hkv * dh, quantize=True),
            "wv": layer("wv", w, d, hkv * dh, quantize=True),
            "wo": layer("wo", w, hq * dh, d, quantize=True),
            "w_gate": layer("w_gate", w, d, li, quantize=True),
            "w_up": layer("w_up", w, d, li, quantize=True),
            "w_down": layer("w_down", w, li, d, quantize=True),
        },
        "final_norm": keep(("final_norm",), ones(d)),
    }
    if arch.attention_bias:
        params["layers"]["bq"] = layer("bq", w, hq * dh)
        params["layers"]["bk"] = layer("bk", w, hkv * dh)
        params["layers"]["bv"] = layer("bv", w, hkv * dh)
    if arch.qk_norm:
        params["layers"]["q_norm"] = layer("q_norm", ones, dh)
        params["layers"]["k_norm"] = layer("k_norm", ones, dh)
    if not arch.tie_word_embeddings:
        head = w(d, arch.vocab_size)
        params["lm_head"] = keep(("lm_head",),
                                 weight_quantize(head, quantization)
                                 if quant else head)
    return params


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "wqkv", "w_gateup")


def quantize_params(params: dict, mode: str = "fp8") -> dict:
    """Convert the large matmul weights to weight-only fp8 / int8 / int4.

    Norms stay as they are; the LM head quantizes in ``mode`` and, when
    there is one (untied), the input embedding to fp8.  Tied-embedding
    models keep the table unquantized (the tied logits read it
    transposed).  Stacked weights are quantized one layer at a time
    (:func:`quantize_layers`: the same bytes and scales).
    """
    out = dict(params)
    layers = dict(params["layers"])
    for k in _QUANT_KEYS:
        if k in layers and not isinstance(layers[k], QuantizedLinear):
            layers[k] = quantize_layers(layers[k], mode)
    out["layers"] = layers
    if "lm_head" in out and not isinstance(out["lm_head"], QuantizedLinear):
        out["lm_head"] = weight_quantize(out["lm_head"], mode)
    if "lm_head" in out and not isinstance(out["embed"], QuantizedLinear):
        out["embed"] = fp8_quantize(out["embed"])
    return out


def embed_lookup(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Input-embedding gather; an fp8 table is dequantized row by row
    (gathered rows times the scalar scale, in the norms' dtype)."""
    e = params["embed"]
    if isinstance(e, QuantizedLinear):
        rows = e.weight[ids.long()].float() * e.scale
        return rows.to(params["final_norm"].dtype)
    return e[ids.long()]


def fuse_params(params: dict, interleave: Optional[int] = 1) -> dict:
    """Fuse q|k|v -> ``wqkv`` (and their biases -> ``bqkv``) and
    gate|up -> ``w_gateup`` (one matmul each), quantized parts through
    :func:`fuse_quantized` (per-part scales kept exactly, as per-column
    scales).  The unfused tensors are dropped as soon as their fused one
    exists, so at most one extra group is alive at a time.

    ``interleave=W`` fuses per-shard segments (column order
    ``[q_0|k_0|v_0|q_1|k_1|v_1|..]`` over W shards), so the order
    survives a contiguous W-way split of the out axis: the tp cut and
    the shift re-slice (``parallel/ulysses.py``).  Fusing a tp piece
    with ``W / tp`` gives that piece of the global fusion with ``W``.
    ``interleave=None`` fuses nothing (a mesh whose pieces would split a
    head or a column group: the runner's gate)."""
    if interleave is None:
        return params
    def bias_fuse(parts):
        segs = []
        for f in range(interleave):
            for p in parts:
                nf = p.shape[-1] // interleave
                segs.append(p[..., f * nf:(f + 1) * nf])
        return torch.cat(segs, dim=-1)

    layers = dict(params["layers"])
    if "wq" in layers:
        layers["wqkv"] = fuse_quantized(
            [layers.pop("wq"), layers.pop("wk"), layers.pop("wv")],
            interleave)
        if "bq" in layers:
            layers["bqkv"] = bias_fuse(
                [layers.pop("bq"), layers.pop("bk"), layers.pop("bv")])
    if "w_gate" in layers:
        layers["w_gateup"] = fuse_quantized(
            [layers.pop("w_gate"), layers.pop("w_up")], interleave)
    out = dict(params)
    out["layers"] = layers
    return out


def _qkv(h, lp, arch):
    t = h.shape[0]
    if "wqkv" in lp:
        y = matmul(h, lp["wqkv"])
        if "bqkv" in lp:      # Qwen2: the bias in the product's dtype
            y = y + lp["bqkv"].to(y.dtype)
        nq = arch.num_heads * arch.head_dim
        nkv = arch.num_kv_heads * arch.head_dim
        g = arch.fused_seg
        if g > 1:
            # g interleaved [q_f|k_f|v_f] groups (an SP-mode tp piece of
            # shift-enabled fused weights): group-major regrouping gives
            # the heads in order.
            y3 = y.reshape(t, g, (nq + 2 * nkv) // g)
            q = y3[:, :, :nq // g].reshape(t, nq)
            k = y3[:, :, nq // g:(nq + nkv) // g].reshape(t, nkv)
            v = y3[:, :, (nq + nkv) // g:].reshape(t, nkv)
        else:
            q, k, v = y[:, :nq], y[:, nq:nq + nkv], y[:, nq + nkv:]
    else:
        q = matmul(h, lp["wq"])
        k = matmul(h, lp["wk"])
        v = matmul(h, lp["wv"])
        if "bq" in lp:
            q = q + lp["bq"].to(q.dtype)
            k = k + lp["bk"].to(k.dtype)
            v = v + lp["bv"].to(v.dtype)
    q = q.reshape(t, arch.num_heads, arch.head_dim)
    k = k.reshape(t, arch.num_kv_heads, arch.head_dim)
    v = v.reshape(t, arch.num_kv_heads, arch.head_dim)
    if "q_norm" in lp:        # Qwen3: per-head RMSNorm before RoPE
        q = rms_norm(q, lp["q_norm"], arch.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], arch.rms_norm_eps)
    return q, k, v


def _quantize_kv_rows(k, v, dtype, kv_scale=None):
    """New K/V rows in the cache's dtype, ``[t, Hkv*D]`` each: the bytes
    the cache stores.  ``kv_scale`` (this layer's [k, v] dequant scales)
    divides values before an fp8 cast so the attention read's ``*scale``
    dequant round-trips."""
    t = k.shape[0]
    if kv_scale is not None and dtype == torch.float8_e4m3fn:
        k = k.float() / kv_scale[0]
        v = v.float() / kv_scale[1]
    # Contiguous: v is a column slice of the fused qkv product.
    return (k.reshape(t, -1).to(dtype).contiguous(),
            v.reshape(t, -1).to(dtype).contiguous())


def _write_kv_layer(kv, layer, k, v, slot_mapping, kv_scale=None):
    """Scatter new tokens' K/V (:func:`_quantize_kv_rows`) into the
    stacked cache at one layer, in place (slot -1 lands in the reserved
    block 0)."""
    write_kv(kv[layer], *_quantize_kv_rows(k, v, kv.dtype, kv_scale),
             slot_mapping)
    return kv


def _bulk_write_kv(kv, k_rows, v_rows, slot_mapping):
    """Scatter the step's deferred K/V rows (``[L, t, Hkv*D]`` each, one
    slot per row shared by every layer) into the stacked cache in place,
    in one ``index_put_`` over its flat ``[L*N_blk, 2, Bs, Hkv*D]`` view;
    slot -1 lands in the reserved block 0, as in ``write_kv``."""
    num_layers, nblk, _, bs, kvd = kv.shape
    t = k_rows.shape[1]
    slots = torch.where(slot_mapping < 0, 0, slot_mapping).long()
    blk, off = slots // bs, slots % bs
    lidx = torch.arange(num_layers, device=kv.device)[:, None] * nblk
    blk_l = (lidx + torch.cat([blk, blk])[None, :]).reshape(-1)
    sel = torch.cat([torch.zeros(t, dtype=torch.long, device=kv.device),
                     torch.ones(t, dtype=torch.long, device=kv.device)])
    rows = torch.cat([k_rows, v_rows], dim=1).reshape(-1, kvd)
    # As bytes: one scatter for every cache dtype (fp8 included).
    kv.view(num_layers * nblk, 2, bs, kvd).view(torch.uint8).index_put_(
        (blk_l, sel.repeat(num_layers),
         torch.cat([off, off]).repeat(num_layers)),
        rows.to(kv.dtype).view(torch.uint8))
    return kv


def _defer_kv_writes(attn_impl, arch) -> bool:
    """Deferred writes run on grouped decode steps
    (``attn_impl.is_grouped_decode``) with ``ARCTIC_TPU_DEFERRED_KV=1``
    and a head dim the CUDA kernel has instances for (64, 128), on the
    card or, through the plain version, on the CPU.  (The JAX package
    also needs a 128-multiple head dim: its CPU path is a jnp reference
    without the injection.)"""
    return (getattr(attn_impl, "is_grouped_decode", False)
            and envs.ARCTIC_TPU_DEFERRED_KV
            and arch.head_dim in (64, 128))


def _mlp(x, lp, groups: int = 1):
    # As the JAX model's _mlp: gate/up come out in x.dtype, and the
    # SwiGLU product is taken in float32.
    if "w_gateup" in lp:
        y = matmul(x, lp["w_gateup"])
        li = y.shape[-1] // 2
        if groups > 1:
            # Interleaved [gate_f|up_f] groups (see _qkv), regrouped so
            # the columns meet w_down's rows in order.
            t = y.shape[0]
            y3 = y.reshape(t, groups, 2 * li // groups)
            g = y3[:, :, :li // groups].reshape(t, li)
            u = y3[:, :, li // groups:].reshape(t, li)
        else:
            g, u = y[:, :li], y[:, li:]
    else:
        g = matmul(x, lp["w_gate"])
        u = matmul(x, lp["w_up"])
    h = (torch.nn.functional.silu(g.float()) * u.float()).to(x.dtype)
    return matmul(h, lp["w_down"])


def _dense_mlp_fn(x, lp, arch, pctx=None):
    """The dense SwiGLU block, :func:`scan_layers`'s default ``mlp_fn``
    (``arch`` as the rank sees it under a parallel context)."""
    del pctx
    return _mlp(x, lp, arch.fused_seg)


def forward(params: dict, arch: LlamaArch, kv: torch.Tensor,
            inputs: dict[str, torch.Tensor],
            attn_impl=None,
            allow_deferral: bool = True,
            pctx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the decoder stack over a flat ragged token batch.

    inputs: input_ids [T], positions [T], req_idx [T], slot_mapping [T],
    block_tables [B, MaxBlk], seq_lens [B], the work-item schedule
    (``attn_*``) and optionally kv_scale [L, 2].
    Returns (kv, hidden[T, D]); ``kv`` is updated in place.
    ``allow_deferral=False`` keeps the per-layer cache writes even where
    :func:`_defer_kv_writes` would defer them.

    ``pctx`` (``parallel/ulysses.py``: ``ParallelContext``) runs one
    rank's part of a mesh: its weight re-slice, the Ulysses all-to-all
    around attention and the row-parallel sums; in SP mode ``input_ids``
    and ``positions_local`` are the rank's chunk of the tokens and the
    hidden rows returned are that chunk's.  Without it every hook is the
    identity.
    """
    h = embed_lookup(params, inputs["input_ids"])
    kv, h = scan_layers(params["layers"], arch, kv, h, inputs,
                        attn_impl=attn_impl, allow_deferral=allow_deferral,
                        pctx=pctx)
    return kv, finalize_hidden(params, arch, h)


def finalize_hidden(params: dict, arch: LlamaArch,
                    h: torch.Tensor) -> torch.Tensor:
    """The final norm after the layer stack (the pipeline's last stage
    applies it to each microbatch)."""
    return rms_norm(h, params["final_norm"], arch.rms_norm_eps)


def scan_layers(layers: dict, arch: LlamaArch, kv: torch.Tensor,
                h: torch.Tensor, inputs: dict, attn_impl=None,
                allow_deferral: bool = True, mlp_fn=None, pctx=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked decoder layers over hidden states ``h``.

    On a deferred-write step (:func:`_defer_kv_writes`) each layer's
    attention injects the layer's new K/V rows and the cache is written
    once after the stack (:func:`_bulk_write_kv`); never under a parallel
    context ``pctx`` (see :func:`forward`), as in the JAX package.
    ``mlp_fn(x, lp, arch, pctx) -> y`` replaces the dense SwiGLU block
    (the MoE models put their expert-routed block here, over the rank's
    experts); its result is summed over the context's group like the
    dense block's."""
    if attn_impl is None:
        attn_impl = _default_attn
    if mlp_fn is None:
        mlp_fn = _dense_mlp_fn
    num_layers = next(iter(layers.values())).shape[0]
    arch_q = pctx.arch_view(arch) if pctx is not None else arch
    psum = pctx.psum if pctx is not None else (lambda x: x)
    # Positions of the tokens this rank holds (its chunk in SP mode).
    rope_positions = inputs.get("positions_local", inputs["positions"])
    inv_freq = compute_rope_freqs(arch.head_dim, arch.rope_theta,
                                  arch.rope_scaling, device=h.device)
    ks = inputs.get("kv_scale")
    defer = (allow_deferral and pctx is None
             and _defer_kv_writes(attn_impl, arch))
    new_k, new_v = [], []
    for layer in range(num_layers):
        lp = {k: v[layer] for k, v in layers.items()}
        x = rms_norm(h, lp["input_norm"], arch.rms_norm_eps)
        q, k, v = _qkv(x, lp, arch_q)
        q = apply_rope(q, rope_positions, inv_freq)
        k = apply_rope(k, rope_positions, inv_freq)
        if pctx is not None:
            q, k, v = pctx.dispatch(q, k, v)
        scale = None if ks is None else ks[layer]
        if defer:
            kq, vq = _quantize_kv_rows(k, v, kv.dtype, scale)
            o = attn_impl(q, kv, layer, inputs, knew=kq, vnew=vq)
            new_k.append(kq)
            new_v.append(vq)
        else:
            _write_kv_layer(kv, layer, k, v, inputs["slot_mapping"], scale)
            o = attn_impl(q, kv, layer, inputs)
        if pctx is not None:
            o = pctx.combine(o)
        h = h + psum(matmul(o.reshape(o.shape[0], -1), lp["wo"]))
        x = rms_norm(h, lp["post_norm"], arch.rms_norm_eps)
        h = h + psum(mlp_fn(x, lp, arch_q, pctx))
    if defer:
        _bulk_write_kv(kv, torch.stack(new_k), torch.stack(new_v),
                       inputs["slot_mapping"])
    return kv, h


_SCHEDULE_KEYS = ("attn_item_req", "attn_item_qstart", "attn_item_qlen",
                  "attn_item_pages", "attn_item_pos_base",
                  "attn_token_item", "attn_token_off")


def make_attn_impl(attn_qb: int = 32, decode_qlen: int = 1):
    """Build the attention dispatcher.  ``attn_qb == 1`` marks a uniform
    decode step (every request contributes ``decode_qlen`` frontier rows
    in request order) and goes to the grouped decode kernel; otherwise
    the ragged kernel runs over the step's work-item schedule, with the
    items' tree masks when the step verifies token trees.  Each wrapper
    launches its CUDA kernel for tensors on the card and computes the
    plain version for tensors on the CPU."""

    def _attn(q, kv, layer, inputs, knew=None, vnew=None):
        if attn_qb == 1:
            seq_lens = inputs["seq_lens"]
            # The same for every layer: computed once per step.
            pos_base = inputs.get("decode_pos_base")
            if pos_base is None:
                pos_base = inputs["decode_pos_base"] = torch.clamp(
                    seq_lens - decode_qlen, min=0)
            inject = {}
            if knew is not None:
                # Deferred writes: the new rows ride as operands; their
                # cache slots are written after the layer stack.
                inject = dict(knew=knew, vnew=vnew,
                              slot_mapping=inputs["slot_mapping"])
            return grouped_decode_attention_kernel(
                q, kv, pos_base,
                inputs["block_tables"], seq_lens, qlen=decode_qlen,
                kv_scale=inputs.get("kv_scale"), layer=layer, **inject)
        if knew is not None:
            raise ValueError("deferred KV rows need the grouped decode path")
        schedule = tuple(inputs[k] for k in _SCHEDULE_KEYS)
        if "attn_item_tree_start" in inputs:
            schedule += (inputs["attn_item_tree_start"],
                         inputs["attn_item_tree_mask"])
        return ragged_paged_attention_kernel(
            q, kv, inputs["positions"], inputs["req_idx"],
            inputs["block_tables"], inputs["seq_lens"], qb=attn_qb,
            schedule=schedule, kv_scale=inputs.get("kv_scale"), layer=layer)

    _attn.is_grouped_decode = attn_qb == 1
    return _attn


def plain_attn(q, kv, layer, inputs):
    """Attention through the plain version on any device (the yardstick
    the kernels are held against)."""
    ks = inputs.get("kv_scale")
    return ragged_paged_attention_reference(
        q, kv[layer], inputs["positions"], inputs["req_idx"],
        inputs["block_tables"], inputs["seq_lens"],
        kv_scale=None if ks is None else ks[layer],
        tree_start=inputs.get("attn_tree_start"),
        row_tree_mask=inputs.get("attn_row_tree_mask"))


_default_attn = make_attn_impl()


def compute_logits(params: dict, hidden_rows: torch.Tensor) -> torch.Tensor:
    """LM head over selected hidden rows; fp32 logits (a quantized head
    goes through its matmul kernel with a float32 output)."""
    head = params.get("lm_head")
    if head is None:
        return matmul(hidden_rows, params["embed"].t(), torch.float32)
    return matmul(hidden_rows, head, torch.float32)


# ---------------------------------------------------------------------------
# HF checkpoint mapping
# ---------------------------------------------------------------------------

# name templates in HF Llama checkpoints -> (our key, transpose?)
_LAYER_MAP = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "input_layernorm.weight": ("input_norm", False),
    "post_attention_layernorm.weight": ("post_norm", False),
    # Family variants (absent in plain Llama checkpoints):
    "self_attn.q_proj.bias": ("bq", False),        # Qwen2/2.5
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.q_norm.weight": ("q_norm", False),  # Qwen3
    "self_attn.k_norm.weight": ("k_norm", False),
}

_OPTIONAL_LAYER_KEYS = ("bq", "bk", "bv", "q_norm", "k_norm")


def load_hf_state(arch: LlamaArch, tensors: dict[str, torch.Tensor],
                  dtype: torch.dtype = torch.bfloat16,
                  quantization: Optional[str] = None,
                  device: torch.device | str | None = None) -> dict:
    """Assemble the parameters from a flat HF state dict (name ->
    tensor, as safetensors gives it) on ``device`` (``cuda:0`` by
    default).

    A pre-quantized fp8 checkpoint (``<name>.weight_scale`` beside each
    weight) keeps its values, with the per-layer scales stacked ``[L]``.
    Otherwise ``quantization`` quantizes the weights on the device
    (:func:`quantize_params`); with it, an untied embedding becomes fp8.
    Optional per-layer fp8-KV scales (``k_scale``/``v_scale``) land in
    ``params["kv_scales"]`` [L, 2]."""
    device = resolve_device(device)
    nl = arch.num_layers
    stacks: dict[str, list] = {k: [None] * nl for k, _ in _LAYER_MAP.values()}
    scales: dict[str, list] = {k: [None] * nl for k, _ in _LAYER_MAP.values()}
    kv_scales = torch.ones((nl, 2), dtype=torch.float32)
    have_kv_scales = False
    params: dict = {"layers": {}}

    def put(x):
        return x.to(device=device, dtype=dtype)

    for name, arr in tensors.items():
        if name == "model.embed_tokens.weight":
            params["embed"] = put(arr)
        elif name == "model.norm.weight":
            params["final_norm"] = put(arr)
        elif name == "lm_head.weight":
            params["lm_head"] = put(arr.t().contiguous())
        elif name.startswith("model.layers."):
            idx_s, _, leaf = name[len("model.layers."):].partition(".")
            layer = int(idx_s)
            if leaf in ("self_attn.k_scale", "self_attn.v_scale",
                        "self_attn.attn.k_scale", "self_attn.attn.v_scale"):
                col = 0 if leaf.endswith("k_scale") else 1
                kv_scales[layer, col] = float(arr.reshape(()))
                have_kv_scales = True
                continue
            is_scale = leaf.endswith(".weight_scale")
            base = leaf.replace(".weight_scale", ".weight")
            if base not in _LAYER_MAP:
                continue
            key, transpose = _LAYER_MAP[base]
            if is_scale:
                scales[key][layer] = arr.float().reshape(())
            else:
                stacks[key][layer] = arr.t() if transpose else arr
    for key, stack in stacks.items():
        if key in _OPTIONAL_LAYER_KEYS and all(s is None for s in stack):
            continue  # a variant's parameter this checkpoint lacks
        missing = [i for i, s in enumerate(stack) if s is None]
        if missing:
            raise ValueError(f"missing layers {missing} for {key}")
        if all(s is not None for s in scales[key]):
            # Pre-quantized fp8: values as stored, scales stacked per layer.
            params["layers"][key] = QuantizedLinear(
                torch.stack(stack).to(device),
                torch.stack(scales[key]).to(device))
        else:
            params["layers"][key] = put(torch.stack(stack))
    if arch.tie_word_embeddings:
        params.pop("lm_head", None)
    if quantization and not isinstance(params["layers"]["wq"],
                                       QuantizedLinear):
        params = quantize_params(params, quantization)
    if quantization and "lm_head" in params and \
            not isinstance(params["embed"], QuantizedLinear):
        # Pre-quantized checkpoints ship an unquantized embedding.
        params["embed"] = fp8_quantize(params["embed"])
    if have_kv_scales:
        params["kv_scales"] = kv_scales
    return params


# Registry interface alias.
Arch = LlamaArch
