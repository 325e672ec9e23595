"""Mixtral-family sparse mixture of experts on the Llama decoder body.

Counterpart of ``arcticinference_tpu/models/mixtral.py`` on one device.
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
is not applied, and ``moe_capacity_factor`` acts only under expert
parallelism, which the port does not run.

Expert stacks are built one layer at a time (:func:`init_params`,
:func:`load_hf_state`): Mixtral-8x7B's bf16 experts (~93 GB) never exist
whole; a quantized model holds one layer's bf16 experts at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from arcticinference_tpu_torch.models import llama as llama_mod
from arcticinference_tpu_torch.models.llama import (  # noqa: F401
    LlamaArch, compute_logits, embed_lookup, make_attn_impl, plain_attn)
from arcticinference_tpu_torch.ops import moe
from arcticinference_tpu_torch.ops.fp8 import (QuantizedLinear,
                                               fp8_quantize, quantize_layers,
                                               weight_quantize)
from arcticinference_tpu_torch.ops.layers import rms_norm
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

_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
_QUANT_KEYS = _ATTN_KEYS + _EXPERT_KEYS


def quantize_experts(w: torch.Tensor, mode: str) -> QuantizedLinear:
    """One layer's expert stack ``[E, in, out]`` quantized as the JAX
    package quantizes the whole ``[L, E, in, out]`` stack: fp8 with one
    scale over the layer (a 0-d scale), int8 / int4 per expert and
    column (and group)."""
    if mode == "fp8":
        q = fp8_quantize(w.reshape(-1, w.shape[-1]))
        return QuantizedLinear(q.weight.reshape(w.shape), q.scale)
    return weight_quantize(w, mode)


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


def init_params(arch: MixtralArch, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                quantization: Optional[str] = None,
                device: torch.device | str | None = None) -> dict:
    """Randomly initialised parameters (benchmarks / tests), drawn on
    ``device`` (by default the generator's) from ``generator``:
    Normal(0, 0.02) like the JAX package, not the same numbers.  Each
    layer's expert stack is drawn and, with ``quantization``, quantized
    before the next is drawn."""
    if device is None:
        device = generator.device
    d, hq, hkv, dh = (arch.hidden_size, arch.num_heads, arch.num_kv_heads,
                      arch.head_dim)
    li, nl, e = arch.intermediate_size, arch.num_layers, arch.num_experts
    quant = quantization is not None

    def w(*shape):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return x.mul_(0.02)

    def qw(*shape):
        return quantize_layers(w(*shape), quantization) if quant \
            else w(*shape)

    def experts(n_in, n_out):
        def layer(_):
            x = w(e, n_in, n_out)
            return quantize_experts(x, quantization) if quant else x
        return _stacked(nl, layer)

    params = {
        "embed": w(arch.vocab_size, d),
        "layers": {
            "input_norm": torch.ones((nl, d), dtype=dtype, device=device),
            "post_norm": torch.ones((nl, d), dtype=dtype, device=device),
            "wq": qw(nl, d, hq * dh),
            "wk": qw(nl, d, hkv * dh),
            "wv": qw(nl, d, hkv * dh),
            "wo": qw(nl, hq * dh, d),
            "w_router": w(nl, d, e),
            "w_gate": experts(d, li),
            "w_up": experts(d, li),
            "w_down": experts(li, d),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not arch.tie_word_embeddings:
        head = w(d, arch.vocab_size)
        params["lm_head"] = (weight_quantize(head, quantization)
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


def _moe_mlp(x: torch.Tensor, lp: dict, arch: MixtralArch) -> torch.Tensor:
    """Routed SwiGLU over every expert, as the JAX ``_moe_mlp`` on one
    device: ``g`` and ``u`` float32, ``silu(g) * u`` in float32 cast to
    ``x.dtype``, the down product float32, the weighted sum float32, the
    result cast to ``x.dtype`` (the dense ``_mlp``'s products come out in
    ``x.dtype`` instead)."""
    gate, top_i = moe.route(x, lp["w_router"], arch.num_experts_per_tok)
    order, sorted_e, tok = moe.sort_assignments(top_i)
    offsets = moe.group_offsets(sorted_e, arch.num_experts)
    xs = x[tok]
    g = grouped_matmul(xs, lp["w_gate"], offsets)
    u = grouped_matmul(xs, lp["w_up"], offsets)
    mid = (torch.nn.functional.silu(g) * u).to(x.dtype)
    y = grouped_matmul(mid, lp["w_down"], offsets)
    return moe.combine(y, gate, order).to(x.dtype)


def scan_layers(layers: dict, arch: MixtralArch, kv: torch.Tensor,
                h: torch.Tensor, inputs: dict, attn_impl=None,
                allow_deferral: bool = True):
    return llama_mod.scan_layers(layers, arch, kv, h, inputs,
                                 attn_impl=attn_impl,
                                 allow_deferral=allow_deferral,
                                 mlp_fn=_moe_mlp)


def forward(params: dict, arch: MixtralArch, kv: torch.Tensor,
            inputs: dict[str, torch.Tensor], attn_impl=None,
            allow_deferral: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Llama's ``forward`` with the expert block (see there for the
    inputs); returns (kv, hidden[T, D]) with ``kv`` updated in place."""
    h = embed_lookup(params, inputs["input_ids"])
    kv, h = scan_layers(params["layers"], arch, kv, h, inputs,
                        attn_impl=attn_impl, allow_deferral=allow_deferral)
    h = rms_norm(h, params["final_norm"], arch.rms_norm_eps)
    return kv, h


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
