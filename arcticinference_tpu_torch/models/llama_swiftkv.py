"""LlamaSwiftKV: early-exit prefill with projected KV for the later layers.

Counterpart of ``arcticinference_tpu/models/llama_swiftkv.py`` on one
device.  The first ``num_key_value_layers`` (K) decoder layers run as
Llama's; at the K-layer boundary one projection produces the K/V of every
later layer from one normed hidden state (``norm_swiftkv`` and the
stacked ``wk_swift`` / ``wv_swift``), and only the rows to be sampled
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

Not ported: the sharded (tp / sp / dp) layouts of the swift half.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

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


def _llama_arch(arch: LlamaSwiftKVArch, **changes) -> LlamaArch:
    """The Llama arch of ``arch``'s dims with ``changes``."""
    fields = {f.name: getattr(arch, f.name)
              for f in dataclasses.fields(LlamaArch)}
    return LlamaArch(**{**fields, **changes})


def init_params(arch: LlamaSwiftKVArch, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                quantization: Optional[str] = None,
                device: torch.device | str | None = None) -> dict:
    """Randomly initialised parameters, drawn on ``device`` from
    ``generator`` as :func:`llama.init_params` draws them (Normal(0,
    0.02), each weight quantized as soon as it is drawn): the first K
    layers with the embedding and LM head, then the later layers'
    q / o / MLP weights, then their stacked K and V projections."""
    if device is None:
        device = generator.device
    kb = arch.num_swift_layers
    d, hkv, dh = arch.hidden_size, arch.num_kv_heads, arch.head_dim
    base = llama.init_params(
        _llama_arch(arch, num_layers=arch.num_key_value_layers), generator,
        dtype, quantization, device)
    params = {k: v for k, v in base.items() if k != "layers"}
    params["layers_a"] = base["layers"]
    if kb > 0:
        # A one-row tied table: the later layers need no embedding or
        # LM head of their own.
        layers_b = llama.init_params(
            _llama_arch(arch, num_layers=kb, vocab_size=1,
                        tie_word_embeddings=True),
            generator, dtype, quantization, device)["layers"]
        del layers_b["wk"], layers_b["wv"]
        params["layers_b"] = layers_b
        for key in ("wk_swift", "wv_swift"):
            w = torch.randn((kb, d, hkv * dh), generator=generator,
                            dtype=dtype, device=device).mul_(0.02)
            params[key] = (quantize_layers(w, quantization)
                           if quantization else w)
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


def fuse_params(params: dict, interleave: int = 1) -> dict:
    """:func:`llama.fuse_params` on the first K layers; gate|up fused in
    the later layers (``wq`` stays alone: their K / V come from the
    stacked projection), and the stacked K / V projections fused into
    ``wkv_swift`` (:func:`fuse_swift_kv`)."""
    out = dict(params)
    out["layers_a"] = llama.fuse_params(
        {"layers": params["layers_a"]}, interleave)["layers"]
    if "layers_b" in params:
        layers = dict(params["layers_b"])
        if "w_gate" in layers:
            layers["w_gateup"] = fuse_quantized(
                [layers.pop("w_gate"), layers.pop("w_up")], interleave)
        out["layers_b"] = layers
    if "wk_swift" in out:
        out["wkv_swift"] = fuse_swift_kv(out.pop("wk_swift"),
                                         out.pop("wv_swift"))
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
            allow_deferral: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (kv, hidden states of the sample rows ``[S_pad, D]``, after
    the final norm); ``kv`` is updated in place.  ``params`` are
    :func:`fuse_params`'s.

    Needs ``inputs["logits_indices"]`` (the surviving rows) and, on a
    step through the ragged kernel, the ``swift_*`` schedule over them.
    Padding sample rows (:func:`_live_rows`) run the later layers as
    padding tokens (request -1), so no kernel leaves them unwritten.
    ``allow_deferral`` is ignored: SwiftKV writes each layer's K/V before
    its attention, as the JAX package does."""
    del allow_deferral
    if attn_impl is None:
        attn_impl = llama._default_attn
    ka = arch.num_key_value_layers
    kb = arch.num_swift_layers
    h = embed_lookup(params, inputs["input_ids"])
    kv, h = llama.scan_layers(params["layers_a"], arch, kv, h, inputs,
                              attn_impl=attn_impl, allow_deferral=False)
    rows = inputs["logits_indices"].long()
    if kb == 0:
        h = rms_norm(h, params["final_norm"], arch.rms_norm_eps)
        return kv, h[rows]

    # One projection for the K/V of every later layer, RoPE on K.
    t = h.shape[0]
    hkv, dh = arch.num_kv_heads, arch.head_dim
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
        q = llama.matmul(x, lp["wq"]).reshape(s, arch.num_heads, dh)
        q = apply_rope(q, swift_inputs["positions"], inv_freq)
        o = attn_impl(q, kv, layer, swift_inputs)
        hs = hs + llama.matmul(o.reshape(s, -1), lp["wo"])
        x = rms_norm(hs, lp["post_norm"], arch.rms_norm_eps)
        hs = hs + llama._mlp(x, lp)
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
