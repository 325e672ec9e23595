"""LlamaSwiftKV: early-exit prefill with projected KV for the later layers.

Counterpart of ``arcticinference_tpu/models/llama_swiftkv.py``.  The
first ``num_key_value_layers`` (K) decoder layers run as Llama's; at the
K-layer boundary one projection produces the K/V of every later layer
from one normed hidden state (``norm_swiftkv`` and the stacked
``wk_swift`` / ``wv_swift``), and only the rows to be sampled
(``logits_indices``) run the later layers: the token drop that cuts
prefill compute by up to ~50%.

The later layers attend over the surviving rows with a second ragged
schedule the runner builds (the ``swift_*`` arrays, swapped in for the
``attn_*`` ones); each writes its projected K/V for every row of the step
into its own cache layer first.  A uniform decode step (``attn_qb == 1``)
keeps every row, and both halves run the grouped decode kernel.  KV
writes are never deferred (``allow_deferral`` is accepted and ignored),
as in the JAX package.

:func:`fuse_params` concatenates the stacked K and V projections into one
``[D, 2 * kb * Hkv * Dh]`` operand (``wkv_swift``; quantized parts through
``fuse_quantized``, per-layer scales kept exactly as per-column scales),
so a step runs the projection as one matmul: ``torch.matmul`` in bf16,
one quantized-matmul launch with quantized weights.  The JAX package
dequantizes quantized stacks to the activations' dtype before a float32
einsum; the matmul kernel here scales the float32 sums of the bf16
activations instead, so the two agree to a tolerance, not bit for bit.

On a tp / sp / shift mesh (``parallel/``) the first K layers run in the
step's mode; the later layers and the K / V projection run in the shift
(fused ``(tp, sp)``) layout in both modes, after an all-gather of the
hidden rows over sp in SP mode, so the projected pages are the ones the
SP-mode cache holds.  :func:`mesh_layout` re-slices the later layers and
the stacked projections to that layout once, at load, and only then
fuses them: a contiguous piece of the fused ``wkv_swift`` is not a rank's
piece.  dp and pp are not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from arcticinference_tpu_torch.models import llama
# Re-exported module interface (registry contract, models/__init__.py):
from arcticinference_tpu_torch.models.llama import (  # noqa: F401
    _QUANT_KEYS, LlamaArch, compute_logits, embed_lookup, make_attn_impl,
    plain_attn)
from arcticinference_tpu_torch.ops.fp8 import (QuantizedLinear,
                                               fuse_quantized,
                                               quantize_layers)
from arcticinference_tpu_torch.ops.layers import (apply_rope,
                                                  compute_rope_freqs,
                                                  rms_norm)
from arcticinference_tpu_torch.parallel import mesh as mesh_lib
from arcticinference_tpu_torch.parallel.ulysses import (ParallelContext,
                                                        all_gather_cat)
from arcticinference_tpu_torch.utils import resolve_device

# The runner adapts its step to these flags: forward returns the sample
# rows' hidden states, and needs the swift_* schedule over them.
RETURNS_SAMPLE_ROWS = True
NEEDS_SWIFT_SCHEDULE = True


@dataclass(frozen=True)
class LlamaSwiftKVArch(LlamaArch):
    num_key_value_layers: int = 0  # 0 -> num_layers (plain Llama)

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "LlamaSwiftKVArch":
        base = LlamaArch.from_hf_config(cfg)
        kvl = cfg.get("num_key_value_layers") or base.num_layers
        return cls(**{**base.__dict__, "num_key_value_layers": kvl})

    @property
    def num_swift_layers(self) -> int:
        return self.num_layers - self.num_key_value_layers


Arch = LlamaSwiftKVArch


def param_specs() -> dict:
    """Which axis of each leaf is cut over ``tp`` (the JAX module's
    ``param_specs`` as tuples): the first K layers like Llama's, the
    later ones without wk / wv, the stacked K / V projections ``[kb, D,
    Hkv*Dh]`` on their out axis."""
    base = mesh_lib.param_specs()
    return {
        "embed": base["embed"],
        "final_norm": base["final_norm"],
        "lm_head": base["lm_head"],
        "layers_a": base["layers"],
        "layers_b": {k: v for k, v in base["layers"].items()
                     if k not in ("wk", "wv")},
        "wk_swift": (None, None, "tp"),
        "wv_swift": (None, None, "tp"),
        "norm_swiftkv": (None,),
    }


def _llama_arch(arch: LlamaSwiftKVArch, **changes) -> LlamaArch:
    """The Llama arch of ``arch``'s dims with ``changes``."""
    fields = {f.name: getattr(arch, f.name)
              for f in dataclasses.fields(LlamaArch)}
    return LlamaArch(**{**fields, **changes})


def init_params(arch: LlamaSwiftKVArch, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                quantization: Optional[str] = None,
                device: torch.device | str | None = None,
                keep: Optional[Callable] = None) -> dict:
    """Randomly initialised parameters, drawn on ``device`` from
    ``generator`` as :func:`llama.init_params` draws them (Normal(0,
    0.02), each weight quantized as soon as it is drawn): the first K
    layers with the embedding and LM head, then the later layers'
    q / o / MLP weights, then their stacked K and V projections.

    ``keep(path, leaf)`` (a rank of a mesh: its cut) takes each leaf as
    :func:`llama.init_params` hands it over, a layer weight one layer at
    a time (``path`` ``("layers_a", key)`` or ``("layers_b", key)``), a
    stacked projection whole; the draws are the same with and without
    it."""
    if device is None:
        device = generator.device
    kb = arch.num_swift_layers
    d, hkv, dh = arch.hidden_size, arch.num_kv_heads, arch.head_dim

    def under(stack):
        """``keep`` of the layers of ``stack`` (llama's ``layers``)."""
        if keep is None:
            return None

        def keep_in(path, leaf):
            if path[0] != "layers":
                return keep(path, leaf)
            if stack == "layers_b" and path[1] in ("wk", "wv"):
                return leaf       # drawn for the draw order, then dropped
            return keep((stack,) + path[1:], leaf)
        return keep_in

    base = llama.init_params(
        _llama_arch(arch, num_layers=arch.num_key_value_layers), generator,
        dtype, quantization, device, keep=under("layers_a"))
    params = {k: v for k, v in base.items() if k != "layers"}
    params["layers_a"] = base["layers"]
    if kb > 0:
        # A one-row tied table: the later layers need no embedding or
        # LM head of their own.
        layers_b = llama.init_params(
            _llama_arch(arch, num_layers=kb, vocab_size=1,
                        tie_word_embeddings=True),
            generator, dtype, quantization, device,
            keep=under("layers_b"))["layers"]
        del layers_b["wk"], layers_b["wv"]
        params["layers_b"] = layers_b
        for key in ("wk_swift", "wv_swift"):
            w = torch.randn((kb, d, hkv * dh), generator=generator,
                            dtype=dtype, device=device).mul_(0.02)
            w = quantize_layers(w, quantization) if quantization else w
            params[key] = w if keep is None else keep((key,), w)
        params["norm_swiftkv"] = torch.ones(d, dtype=dtype, device=device)
    return params


def quantize_params(params: dict, mode: str = "fp8") -> dict:
    """Weight-only quantization of both layer stacks and the stacked K / V
    projections (one layer at a time: the JAX package's bytes and
    scales).  The embedding and LM head are left as they are, as the JAX
    package leaves them here (its loaders quantize them with the first
    K layers)."""
    out = dict(params)
    for key in ("layers_a", "layers_b"):
        if key not in out:
            continue
        layers = dict(out[key])
        for k in _QUANT_KEYS:
            if k in layers and not isinstance(layers[k], QuantizedLinear):
                layers[k] = quantize_layers(layers[k], mode)
        out[key] = layers
    for key in ("wk_swift", "wv_swift"):
        if key in out and not isinstance(out[key], QuantizedLinear):
            out[key] = quantize_layers(out[key], mode)
    return out


def fuse_swift_kv(wk, wv):
    """The stacked ``[kb, D, E]`` K and V projections as one ``[D,
    2 * kb * E]`` operand: the K columns of layers 0..kb-1, then their V
    columns.  Quantized stacks fuse through :func:`fuse_quantized`, so
    ``dequant(fused)`` holds each layer's dequantized part bit for bit."""
    kb = wk.shape[0]
    return fuse_quantized([w[i] for w in (wk, wv) for i in range(kb)])


def fuse_params(params: dict, interleave: Optional[int] = 1) -> dict:
    """:func:`llama.fuse_params` on the first K layers (``interleave``
    None leaves them unfused, as it does); gate|up fused in the later
    layers (``wq`` stays alone: their K / V come from the stacked
    projection), and the stacked K / V projections fused into
    ``wkv_swift`` (:func:`fuse_swift_kv`).  The later layers fuse with
    no interleave: on a mesh they are already in the shift layout
    (:func:`mesh_layout`), one fused piece a rank."""
    out = dict(params)
    out["layers_a"] = llama.fuse_params(
        {"layers": params["layers_a"]}, interleave)["layers"]
    if "layers_b" in params:
        layers = dict(params["layers_b"])
        layers["w_gateup"] = fuse_quantized(
            [layers.pop("w_gate"), layers.pop("w_up")])
        out["layers_b"] = layers
    if "wk_swift" in out:
        out["wkv_swift"] = fuse_swift_kv(out.pop("wk_swift"),
                                         out.pop("wv_swift"))
    return out


def _slice_swift_kv_proj(w, b_ctx):
    """This rank's fused ``(tp, sp)`` piece of a stacked ``[kb, D,
    Hkv*Dh]`` projection from its tp piece (the sp-th sub-slice of the
    out axis), as a contiguous copy.  Under kv-head replication
    (``num_kv_heads < sp*tp``) the sub-slice is head-granular, as the
    layers' wk / wv re-slice: rank ``(t, s)`` keeps the whole head
    ``(s*g)//sp`` of its tp piece's ``g`` heads, so the ranks that share
    a head project the same copy.  A per-layer scale is left whole, a
    per-column one sliced alike."""
    if b_ctx.sp == 1:
        return w
    s = b_ctx.mesh.sp_rank
    if b_ctx.kv_rep > 1:
        g = b_ctx.num_kv_heads // b_ctx.tp
        d = b_ctx.head_dim
        start, size = (s * g) // b_ctx.sp * d, d
    else:
        size = w.shape[-1] // b_ctx.sp
        start = s * size

    def cut(x, ax):
        return x.narrow(ax, start, size).contiguous()

    if isinstance(w, QuantizedLinear):
        return QuantizedLinear(cut(w.weight, 2),
                               ParallelContext._slice_scale(w, 2, cut))
    return cut(w, 2)


def mesh_layout(params: dict, arch: LlamaSwiftKVArch, mesh) -> dict:
    """A rank's tp-cut parameters with the later layers in the shift
    layout, which they run in in both modes: ``layers_b`` re-sliced to
    the fused ``(tp, sp)`` piece (``ParallelContext.reslice_layers``,
    its in-axis pieces copied too, so no tp piece stays alive) and the
    stacked K / V projections too (:func:`_slice_swift_kv_proj`).  Once,
    at load, before :func:`fuse_params` (the runner): a contiguous piece
    of the fused ``wkv_swift`` is no rank's piece."""
    if arch.num_swift_layers == 0:
        return params
    b_ctx = ParallelContext(mesh, "shift", num_kv_heads=arch.num_kv_heads,
                            head_dim=arch.head_dim)
    out = dict(params)

    def own(x):
        if isinstance(x, QuantizedLinear):
            return QuantizedLinear(own(x.weight), own(x.scale))
        return x.clone() if x._base is not None else x

    out["layers_b"] = {k: own(v) for k, v in
                       b_ctx.reslice_layers(params["layers_b"]).items()}
    for key in ("wk_swift", "wv_swift"):
        out[key] = _slice_swift_kv_proj(out[key], b_ctx)
    return out


def _live_rows(rows: torch.Tensor) -> torch.Tensor:
    """Which sample rows are real: the runners list each step's sample
    rows in increasing token order and pad the list with row 0, so a row
    is real iff it is the first or lies past its predecessor."""
    live = torch.ones_like(rows, dtype=torch.bool)
    live[1:] = rows[1:] > rows[:-1]
    return live


def forward(params: dict, arch: LlamaSwiftKVArch, kv: torch.Tensor,
            inputs: dict[str, torch.Tensor], attn_impl=None,
            allow_deferral: bool = True, pctx=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (kv, hidden states of the sample rows ``[S_pad, D]``, after
    the final norm); ``kv`` is updated in place.  ``params`` are
    :func:`fuse_params`'s (on a mesh, :func:`mesh_layout`'s first).

    Needs ``inputs["logits_indices"]`` (the surviving rows) and, on a
    step through the ragged kernel, the ``swift_*`` schedule over them.
    Padding sample rows (:func:`_live_rows`) run the later layers as
    padding tokens (request -1), so no kernel leaves them unwritten.
    ``allow_deferral`` is ignored: SwiftKV writes each layer's K/V before
    its attention, as the JAX package does.

    ``pctx`` (``parallel/ulysses.py``) runs one rank's part of a mesh:
    the first K layers in its mode (in SP mode over the rank's chunk of
    the tokens, whose hidden rows are then gathered over sp), the
    projection and the later layers in the shift layout of the same
    rank; every rank returns the same sample rows."""
    del allow_deferral
    if attn_impl is None:
        attn_impl = llama._default_attn
    ka = arch.num_key_value_layers
    kb = arch.num_swift_layers
    h = embed_lookup(params, inputs["input_ids"])
    kv, h = llama.scan_layers(params["layers_a"], arch, kv, h, inputs,
                              attn_impl=attn_impl, allow_deferral=False,
                              pctx=pctx)
    arch_b, b_psum = arch, (lambda x: x)
    if pctx is not None:
        if pctx.mode == "sp" and pctx.sp > 1:
            h = all_gather_cat(h, pctx.mesh.sp_group)
        b_ctx = pctx if pctx.mode == "shift" else ParallelContext(
            pctx.mesh, "shift", pctx.num_kv_heads, pctx.head_dim)
        arch_b, b_psum = b_ctx.arch_view(arch), b_ctx.psum
    rows = inputs["logits_indices"].long()
    if kb == 0:
        h = rms_norm(h, params["final_norm"], arch.rms_norm_eps)
        return kv, h[rows]

    # One projection for the K/V of every later layer, RoPE on K.
    t = h.shape[0]
    hkv, dh = arch_b.num_kv_heads, arch.head_dim
    positions = inputs["positions"]
    inv_freq = compute_rope_freqs(dh, arch.rope_theta, arch.rope_scaling,
                                  device=h.device)
    x = rms_norm(h, params["norm_swiftkv"], arch.rms_norm_eps)
    y = llama.matmul(x, params["wkv_swift"]).view(t, 2, kb * hkv, dh)
    k_all = apply_rope(y[:, 0], positions, inv_freq).view(t, kb, hkv * dh)
    v_all = y[:, 1].reshape(t, kb, hkv * dh)

    # Token drop: only the sample rows go on, on the swift schedule.
    hs = h[rows]
    swift_inputs = dict(inputs)
    swift_inputs["positions"] = positions[rows]
    swift_inputs["req_idx"] = torch.where(
        _live_rows(rows), inputs["req_idx"][rows], -1)
    for key in llama._SCHEDULE_KEYS:
        swift = key.replace("attn_", "swift_")
        if swift in inputs:
            swift_inputs[key] = inputs[swift]
    ks = inputs.get("kv_scale")
    s = hs.shape[0]
    layers = params["layers_b"]
    for i in range(kb):
        layer = ka + i
        lp = {k: v[i] for k, v in layers.items()}
        # This layer's projected K/V, every row of the step, first.
        llama._write_kv_layer(kv, layer, k_all[:, i], v_all[:, i],
                              inputs["slot_mapping"],
                              None if ks is None else ks[layer])
        x = rms_norm(hs, lp["input_norm"], arch.rms_norm_eps)
        q = llama.matmul(x, lp["wq"]).reshape(s, arch_b.num_heads, dh)
        q = apply_rope(q, swift_inputs["positions"], inv_freq)
        o = attn_impl(q, kv, layer, swift_inputs)
        hs = hs + b_psum(llama.matmul(o.reshape(s, -1), lp["wo"]))
        x = rms_norm(hs, lp["post_norm"], arch.rms_norm_eps)
        hs = hs + b_psum(llama._mlp(x, lp))
    return kv, rms_norm(hs, params["final_norm"], arch.rms_norm_eps)


# ---------------------------------------------------------------------------
# HF checkpoint mapping (Snowflake/Llama-3.1-SwiftKV-* checkpoints)
# ---------------------------------------------------------------------------

# Leaves of a later layer -> (our key, transpose?); both names of the
# q projection occur in published checkpoints.
_LAYER_B_MAP = {
    "self_attn.q_proj_swiftkv.weight": ("wq", True),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "input_layernorm.weight": ("input_norm", False),
    "post_attention_layernorm.weight": ("post_norm", False),
}


def load_hf_state(arch: LlamaSwiftKVArch, tensors: dict[str, torch.Tensor],
                  dtype: torch.dtype = torch.bfloat16,
                  quantization: Optional[str] = None,
                  device: torch.device | str | None = None) -> dict:
    """Assemble the parameters from a flat HF state dict on ``device``
    (``cuda:0`` by default): the first K layers, the embedding, the final
    norm and the LM head through :func:`llama.load_hf_state`; each later
    layer's fused ``kv_proj_swiftkv`` [2 * Hkv * Dh, D] split into its K
    rows, then its V rows.  ``quantization`` quantizes every matmul
    weight (:func:`quantize_params` for the later layers).  Pre-quantized
    later layers (``weight_scale`` tensors) raise; fp8-KV scales
    (``k_scale`` / ``v_scale``) are not kept, as the JAX loader keeps
    none for this model."""
    device = resolve_device(device)
    ka, kb = arch.num_key_value_layers, arch.num_swift_layers
    e = arch.num_kv_heads * arch.head_dim
    sub_a: dict = {}
    norm_swiftkv = None
    wk: list = [None] * kb
    wv: list = [None] * kb
    stacks: dict[str, list] = {k: [None] * kb
                               for k, _ in _LAYER_B_MAP.values()}
    for name, arr in tensors.items():
        if name == "model.norm_swiftkv.weight":
            norm_swiftkv = arr
            continue
        if name.startswith("model.layers."):
            idx_s, _, leaf = name[len("model.layers."):].partition(".")
            layer = int(idx_s)
            if layer >= ka:
                i = layer - ka
                if leaf.endswith(".weight_scale"):
                    raise NotImplementedError(
                        f"{name}: pre-quantized SwiftKV layers are not "
                        "ported; load the bf16 checkpoint with "
                        "quantization= instead")
                if leaf == "self_attn.kv_proj_swiftkv.weight":
                    wk[i], wv[i] = arr[:e].t(), arr[e:].t()
                elif leaf in _LAYER_B_MAP:
                    key, transpose = _LAYER_B_MAP[leaf]
                    stacks[key][i] = arr.t() if transpose else arr
                continue
        sub_a[name] = arr
    base = llama.load_hf_state(_llama_arch(arch, num_layers=ka), sub_a,
                               dtype, quantization, device)
    params = {k: v for k, v in base.items()
              if k not in ("layers", "kv_scales")}
    params["layers_a"] = base["layers"]
    if kb > 0:
        def put(xs, what):
            missing = [i for i, x in enumerate(xs) if x is None]
            if missing:
                raise ValueError(f"missing swift layers {missing} for {what}")
            return torch.stack(xs).to(device=device, dtype=dtype)

        params["layers_b"] = {k: put(v, k) for k, v in stacks.items()}
        params["wk_swift"] = put(wk, "kv_proj_swiftkv")
        params["wv_swift"] = put(wv, "kv_proj_swiftkv")
        if norm_swiftkv is None:
            raise ValueError("missing model.norm_swiftkv.weight")
        params["norm_swiftkv"] = norm_swiftkv.to(device=device, dtype=dtype)
    if quantization:
        params = quantize_params(params, quantization)
    return params
