"""Mixtral-family sparse mixture of experts on the Llama decoder body.

Counterpart of ``arcticinference_tpu/models/mixtral.py``.
Attention, the embedding and the LM head are the Llama stack's; the
expert block takes the dense MLP's place through ``scan_layers``'s
``mlp_fn`` hook.  The block is dropless (:func:`_moe_mlp`): the router
picks each token's top ``k`` experts, the ``(token, k)`` assignments are
sorted by expert, the three SwiGLU products run per expert group in the
grouped matmul kernel (``ops/cuda/grouped_matmul.py``, the counterpart of
``jax.lax.ragged_dot``) and each token's contributions are summed back
(``ops/moe.py``).  The group bounds stay on the device: a step reads
nothing back.

Parameters keep the JAX package's keys and layout: experts stacked
``[L, E, in, out]`` (``w_gate``, ``w_up``, ``w_down``), the router
``[L, d, E]`` (never quantized), attention as in Llama.  Quantized
experts carry the JAX package's bytes and scales: fp8 one scale per
layer (``[L]``), int8 per expert and column (``[L, E, out]``), int4 per
group and column (``[L, E, in/128, out]``), and are dequantized to bf16
inside the products, as ``_deq`` does before ``ragged_dot``.  As in the
JAX module the embedding stays unquantized, there is no ``fuse_params``
(the runner runs q, k and v as three products), sliding-window attention
is not applied.

Expert parallelism on a mesh (``parallel/``) is the expert axis of the
stacked expert weights cut over tp (:func:`param_specs`; SP mode) or
re-sliced to the fused ``(tp, sp)`` axis (:data:`SHIFT_SLICE_AXES`;
shift mode): a rank runs the rows routed to its experts
(``ParallelContext.moe_expert_range``) and the row-parallel sum adds the
ranks' shares.  ``moe_capacity_factor > 0`` then bounds each rank's rows
to a static window of the sorted assignments, as the JAX package does.

Expert stacks are built one layer at a time (:func:`init_params`,
:func:`load_hf_state`): Mixtral-8x7B's bf16 experts (~93 GB) never exist
whole; a quantized model holds one layer's bf16 experts at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from arcticinference_tpu_torch.models import llama as llama_mod
from arcticinference_tpu_torch.models.llama import (  # noqa: F401
    LlamaArch, compute_logits, embed_lookup, finalize_hidden,
    make_attn_impl, plain_attn)
from arcticinference_tpu_torch.ops import moe
from arcticinference_tpu_torch.ops.fp8 import (FP8_DTYPE, QuantizedLinear,
                                               fp8_quantize, fp8_scale,
                                               quantize_layers,
                                               weight_quantize)
from arcticinference_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class MixtralArch(LlamaArch):
    num_experts: int = 8
    num_experts_per_tok: int = 2
    #: 0: dropless.  > 0 sizes the expert-parallel shards' windows, which
    #: one device does not have.
    moe_capacity_factor: float = 0.0

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "MixtralArch":
        base = LlamaArch.from_hf_config(cfg)
        return cls(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(LlamaArch)},
            num_experts=cfg.get("num_local_experts", 8),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        )


Arch = MixtralArch

#: Shift-mode re-slice axes of the per-layer weights: attention's
#: feature axes; the experts' leading expert axis (the JAX module's).
SHIFT_SLICE_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 0,
                    "w_gate": 0, "w_up": 0, "w_down": 0}

_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
_QUANT_KEYS = _ATTN_KEYS + _EXPERT_KEYS


def quantize_experts(w: torch.Tensor, mode: str) -> QuantizedLinear:
    """One layer's expert stack ``[E, in, out]`` quantized as the JAX
    package quantizes the whole ``[L, E, in, out]`` stack: fp8 with one
    scale over the layer (a 0-d scale), int8 / int4 per expert and
    column (and group).  fp8 is :func:`fp8_quantize` of the flattened
    stack, one expert at a time against the layer's scale (the same
    bytes), so its float32 working copies are one expert's, not the
    layer's: ranks sharing a card draw their layers side by side."""
    if mode != "fp8":
        return weight_quantize(w, mode)
    scale = fp8_scale(w)
    q = torch.empty(w.shape, dtype=FP8_DTYPE, device=w.device)
    for e in range(w.shape[0]):
        q[e] = fp8_quantize(w[e], scale).weight
    return QuantizedLinear(q, scale)


def _stacked(num_layers: int, layer: Callable[[int], Any]):
    """``layer(l)`` (a tensor or a :class:`QuantizedLinear`) for every
    layer, stacked along a new leading axis into storage allocated once:
    one layer's working copy exists at a time."""
    first = layer(0)
    parts = ((first.weight, first.scale)
             if isinstance(first, QuantizedLinear) else (first,))
    stacks = [p.new_empty((num_layers,) + tuple(p.shape)) for p in parts]
    for i in range(num_layers):
        cur = first if i == 0 else layer(i)
        cur = (cur.weight, cur.scale) if isinstance(
            cur, QuantizedLinear) else (cur,)
        for s, p in zip(stacks, cur):
            s[i].copy_(p)
    return QuantizedLinear(*stacks) if len(stacks) == 2 else stacks[0]


def param_specs() -> dict:
    """Which axis of each leaf is cut over ``tp`` (the JAX module's
    ``param_specs`` as tuples): attention like Llama's, the expert stacks
    ``[L, E, in, out]`` on their expert axis, the router whole.  An fp8
    expert stack's one scale per layer stays whole; int8's ``[L, E,
    out]`` scales are cut with the experts (``quantized_leaf_spec``)."""
    col, row = (None, None, "tp"), (None, "tp", None)
    experts = (None, "tp", None, None)
    return {
        "embed": (None, None),
        "final_norm": (None,),
        "lm_head": (None, "tp"),
        "layers": {
            "input_norm": (None, None), "post_norm": (None, None),
            "wq": col, "wk": col, "wv": col, "wo": row,
            "w_router": (None, None, None),
            "w_gate": experts, "w_up": experts, "w_down": experts,
        },
    }


def init_params(arch: MixtralArch, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                quantization: Optional[str] = None,
                device: torch.device | str | None = None,
                keep: Optional[Callable] = None,
                layers: Optional[range] = None) -> dict:
    """Randomly initialised parameters (benchmarks / tests), drawn on
    ``device`` (by default the generator's) from ``generator``:
    Normal(0, 0.02) like the JAX package, not the same numbers.  Each
    layer's expert stack is drawn and, with ``quantization``, quantized
    before the next is drawn.

    ``keep(path, leaf)`` (a rank of a mesh: its cut) takes each leaf as
    :func:`llama.init_params` hands it over, a layer weight one layer at
    a time (``path`` ``("layers", key)``): a rank of Mixtral-8x7B keeps
    one layer's share of the experts before the next layer is drawn.
    The draws are the same with and without it.  ``layers`` (a pipeline
    stage's range) keeps only those layers of each stacked weight: the
    others are drawn, to keep the draws the same, and dropped before
    they are quantized."""
    if device is None:
        device = generator.device
    d, hq, hkv, dh = (arch.hidden_size, arch.num_heads, arch.num_kv_heads,
                      arch.head_dim)
    li, nl, e = arch.intermediate_size, arch.num_layers, arch.num_experts
    quant = quantization is not None
    cut = keep is not None
    if keep is None:
        keep = lambda path, leaf: leaf  # noqa: E731
    kept = range(nl) if layers is None else layers
    mine = slice(kept.start, kept.stop)
    nk = len(kept)

    def w(*shape):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return x.mul_(0.02)

    def layers_of(key, x):
        """A stacked leaf drawn whole (the stage's layers of it), kept
        one layer at a time."""
        if not cut:
            return x
        if isinstance(x, QuantizedLinear):
            return _stacked(nk, lambda i: keep(("layers", key),
                                               QuantizedLinear(x.weight[i],
                                                               x.scale[i])))
        return _stacked(nk, lambda i: keep(("layers", key), x[i]))

    def qw(key, *shape):
        x = w(*shape)[mine].contiguous()
        return layers_of(key, quantize_layers(x, quantization)
                         if quant else x)

    def experts(key, n_in, n_out):
        def layer(_):
            x = w(e, n_in, n_out)
            return keep(("layers", key), quantize_experts(x, quantization)
                        if quant else x)
        for _ in range(kept.start):      # earlier stages' layers
            w(e, n_in, n_out)
        out = _stacked(nk, layer)
        for _ in range(kept.stop, nl):   # later stages' layers
            w(e, n_in, n_out)
        return out

    ones = torch.ones((nk, d), dtype=dtype, device=device)
    params = {
        "embed": keep(("embed",), w(arch.vocab_size, d)),
        "layers": {
            "input_norm": layers_of("input_norm", ones),
            "post_norm": layers_of("post_norm", ones),
            "wq": qw("wq", nl, d, hq * dh),
            "wk": qw("wk", nl, d, hkv * dh),
            "wv": qw("wv", nl, d, hkv * dh),
            "wo": qw("wo", nl, hq * dh, d),
            "w_router": layers_of("w_router",
                                  w(nl, d, e)[mine].contiguous()),
            "w_gate": experts("w_gate", d, li),
            "w_up": experts("w_up", d, li),
            "w_down": experts("w_down", li, d),
        },
        "final_norm": keep(("final_norm",),
                           torch.ones((d,), dtype=dtype, device=device)),
    }
    if not arch.tie_word_embeddings:
        head = w(d, arch.vocab_size)
        params["lm_head"] = keep(("lm_head",),
                                 weight_quantize(head, quantization)
                                 if quant else head)
    return params


def quantize_params(params: dict, mode: str = "fp8") -> dict:
    """Quantize attention, the experts (one layer at a time, the JAX
    package's bytes) and the LM head; the router, norms and embedding
    stay as they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in _ATTN_KEYS:
        if not isinstance(layers[k], QuantizedLinear):
            layers[k] = quantize_layers(layers[k], mode)
    for k in _EXPERT_KEYS:
        stack = layers[k]
        if not isinstance(stack, QuantizedLinear):
            layers[k] = _stacked(stack.shape[0], lambda i, s=stack:
                                 quantize_experts(s[i], mode))
    out["layers"] = layers
    if "lm_head" in out and not isinstance(out["lm_head"], QuantizedLinear):
        out["lm_head"] = weight_quantize(out["lm_head"], mode)
    return out


# ---------------------------------------------------------------------------
# The MoE block (the scan's mlp_fn)
# ---------------------------------------------------------------------------

# The expert products (``ops/moe.grouped_matmul``); a module name, so that
# a caller can route them through the plain version as it routes
# ``llama.matmul``.
grouped_matmul = moe.grouped_matmul


def _moe_mlp(x: torch.Tensor, lp: dict, arch: MixtralArch,
             pctx=None) -> torch.Tensor:
    """Routed SwiGLU over the experts this rank holds, as the JAX
    ``_moe_mlp``: ``g`` and ``u`` float32, ``silu(g) * u`` in float32
    cast to ``x.dtype``, the down product float32, the weighted sum
    float32, the result cast to ``x.dtype`` (the dense ``_mlp``'s
    products come out in ``x.dtype`` instead).

    Under a parallel context ``pctx`` the rank holds experts ``e0 ..
    e0 + el - 1`` (``moe_expert_range``): every sorted row runs, its
    expert id made local and clamped into ``[0, el)`` (a sorted list
    stays sorted, so the out-of-range rows join the first or the last
    group), and the gate of a row outside the range is zeroed; the
    caller's row-parallel sum completes each token.  With
    ``moe_capacity_factor > 0`` and more than one rank, a rank keeps only
    a static window of ``cap = min(T*k, max(8, ceil(ceil(T*k * cf) /
    ep)))`` sorted rows from its first expert's, clipped to the list
    (rows past it lose their expert's share, as in the JAX package); the
    window is taken on the device, so a step reads nothing back."""
    gate, top_i = moe.route(x, lp["w_router"], arch.num_experts_per_tok)
    order, sorted_e, tok = moe.sort_assignments(top_i)
    if pctx is None:
        e0, el = 0, arch.num_experts
    else:
        e0, el = pctx.moe_expert_range(arch.num_experts)
    rows = sorted_e.shape[0]
    ep = arch.num_experts // el
    cf = arch.moe_capacity_factor
    window = None
    if cf and ep > 1:
        cap = min(rows, max(8, -(-int(math.ceil(rows * cf)) // ep)))
        if cap < rows:
            first = torch.searchsorted(
                sorted_e, torch.full((1,), e0, dtype=sorted_e.dtype,
                                     device=sorted_e.device))
            start = first.clamp(0, rows - cap)
            window = start + torch.arange(cap, device=sorted_e.device)
            sorted_e, tok = sorted_e[window], tok[window]
    sharded = el < arch.num_experts
    if sharded:
        local = sorted_e - e0
        valid = (local >= 0) & (local < el)
        sorted_e = local.clamp(0, el - 1)
    offsets = moe.group_offsets(sorted_e, el)
    xs = x[tok]
    g = grouped_matmul(xs, lp["w_gate"], offsets)
    u = grouped_matmul(xs, lp["w_up"], offsets)
    mid = (torch.nn.functional.silu(g) * u).to(x.dtype)
    y = grouped_matmul(mid, lp["w_down"], offsets)
    if sharded:
        y = torch.where(valid[:, None], y, 0.0)
        if window is not None:
            # The window's rows back at their places of the sorted list;
            # the rows outside it contribute nothing.
            y = y.new_zeros((rows, y.shape[1])).index_copy_(0, window, y)
    return moe.combine(y, gate, order).to(x.dtype)


def scan_layers(layers: dict, arch: MixtralArch, kv: torch.Tensor,
                h: torch.Tensor, inputs: dict, attn_impl=None,
                allow_deferral: bool = True, pctx=None):
    return llama_mod.scan_layers(layers, arch, kv, h, inputs,
                                 attn_impl=attn_impl,
                                 allow_deferral=allow_deferral,
                                 mlp_fn=_moe_mlp, pctx=pctx)


def forward(params: dict, arch: MixtralArch, kv: torch.Tensor,
            inputs: dict[str, torch.Tensor], attn_impl=None,
            allow_deferral: bool = True,
            pctx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Llama's ``forward`` with the expert block (see there for the
    inputs and ``pctx``); returns (kv, hidden[T, D]) with ``kv`` updated
    in place."""
    h = embed_lookup(params, inputs["input_ids"])
    kv, h = scan_layers(params["layers"], arch, kv, h, inputs,
                        attn_impl=attn_impl, allow_deferral=allow_deferral,
                        pctx=pctx)
    return kv, finalize_hidden(params, arch, h)


# ---------------------------------------------------------------------------
# HF checkpoint mapping (MixtralForCausalLM)
# ---------------------------------------------------------------------------

_ATTN_MAP = {
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
}
_NORM_MAP = {
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_norm",
}
# experts.N.w1 -> gate, w3 -> up, w2 -> down (HF Mixtral naming)
_EXPERT_MAP = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}


def load_hf_state(arch: MixtralArch, tensors: dict[str, torch.Tensor],
                  dtype: torch.dtype = torch.bfloat16,
                  quantization: Optional[str] = None,
                  device: torch.device | str | None = None) -> dict:
    """Assemble the parameters from a flat HF Mixtral state dict (name ->
    tensor) on ``device`` (``cuda:0`` by default).

    Unquantized checkpoints only, as the JAX loader.  Each layer's
    experts are stacked in ``dtype`` on the host and, with
    ``quantization``, quantized there before they move to the device, so
    a bf16 expert stack of more than one layer never exists there.  The
    parameters equal the JAX loader's bit for bit."""
    device = resolve_device(device)
    nl, e = arch.num_layers, arch.num_experts
    attn: dict[str, list] = {k: [None] * nl for k in _ATTN_MAP.values()}
    norms: dict[str, list] = {k: [None] * nl for k in _NORM_MAP.values()}
    routers: list = [None] * nl
    experts: dict[str, list] = {
        k: [[None] * e for _ in range(nl)] for k in _EXPERT_MAP.values()}
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
            if leaf in _ATTN_MAP:
                attn[_ATTN_MAP[leaf]][layer] = arr.t()
            elif leaf in _NORM_MAP:
                norms[_NORM_MAP[leaf]][layer] = arr
            elif leaf == "block_sparse_moe.gate.weight":
                routers[layer] = arr.t()                      # [d, E]
            elif leaf.startswith("block_sparse_moe.experts."):
                eidx_s, _, wname = leaf[
                    len("block_sparse_moe.experts."):].partition(".")
                key = _EXPERT_MAP.get(wname.replace(".weight", ""))
                if key is not None:
                    experts[key][layer][int(eidx_s)] = arr.t()  # [in, out]

    layers = params["layers"]
    for key, stack in {**attn, **norms}.items():
        missing = [i for i, s in enumerate(stack) if s is None]
        if missing:
            raise ValueError(f"missing layers {missing} for {key}")
        layers[key] = put(torch.stack(stack))
    if any(r is None for r in routers):
        raise ValueError("missing block_sparse_moe.gate weights")
    layers["w_router"] = put(torch.stack(routers))
    for key, per_layer in experts.items():
        for layer, row in enumerate(per_layer):
            missing = [i for i, s in enumerate(row) if s is None]
            if missing:
                raise ValueError(
                    f"layer {layer} missing experts {missing} for {key}")

    def expert_layer(key):
        def layer(i):
            x = torch.stack(experts[key][i]).to(dtype)
            if quantization:
                return quantize_experts(x, quantization).to(device)
            return x.to(device)
        return layer

    for key in _EXPERT_MAP.values():
        layers[key] = _stacked(nl, expert_layer(key))

    if arch.tie_word_embeddings:
        params.pop("lm_head", None)
    if quantization:
        params = quantize_params(params, quantization)
    return params
