"""The decode weight stream, one matmul at a time, on the card.

Counterpart of ``benchmarks/stream_microbench.py``: ``x [64, K] bf16 @
dequant(w [K, N]) -> bf16`` at the five Llama-3.1-8B decode shapes
(:data:`SHAPES`), for each dequantization variant of
``stream_matmul_kernel`` (``ops/cuda/stream_matmul.py``), beside two
yardsticks on the same bytes: ``fp8_matmul_kernel`` with a unit scale on
the same e4m3 / int8 weights, and one ``torch.mm`` on the weight
dequantized to bf16 ahead of time.

Each variant runs over a chain of ``LAYERS`` distinct weights (as the
decoder's 32 layers), so no weight is cache-resident, timed with CUDA
events behind a spinning kernel (the host's launch rate does not show):
the time per matmul is the chain's time over ``LAYERS * reps``.  Weights
are drawn as ``gen_ws`` draws them (N(0, 1) * 0.02 in bf16, then e4m3,
or int8 through a 0.001 step), so they hold no NaN codes.  The first
layer of each variant is held against its plain version.

    python -m arcticinference_tpu_torch.benchmarks.stream_microbench \\
        [gateup down qo gateup-fused qkv-fused]

Prints one JSON line per (shape, variant) and a last summary line; needs
a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from arcticinference_tpu_torch.utils import chip_specs, events_ms

LAYERS = 32
M = 64
SHAPES = (("gateup", 4096, 14336), ("down", 14336, 4096),
          ("qo", 4096, 4096), ("gateup-fused", 4096, 28672),
          ("qkv-fused", 4096, 6144))
# ~20 ms of a spinning kernel at H100 clocks: longer than the host needs
# to enqueue one chain.
SLEEP_CYCLES = 40_000_000
REPS = 3
#: The weights of :func:`weights` each variant reads.
WEIGHT_OF = {"f16trick": "fp8asint8", "bittrick": "fp8asint8",
             "astype_e4m3": "fp8", "astype_int8": "int8"}


def weights(k: int, n: int, gen: torch.Generator,
            layers: int = LAYERS) -> dict:
    """``layers`` distinct [k, n] weights per dtype, drawn as ``gen_ws``
    draws them: e4m3 (``fp8``), its bytes as int8 (``fp8asint8``, a
    view), ``int8`` and the bf16 originals (``bf16``)."""
    fp8 = torch.empty((layers, k, n), dtype=torch.float8_e4m3fn,
                      device="cuda")
    i8 = torch.empty((layers, k, n), dtype=torch.int8, device="cuda")
    bf = torch.empty((layers, k, n), dtype=torch.bfloat16, device="cuda")
    for layer in range(layers):
        w = (torch.randn((k, n), generator=gen, device="cuda")
             .to(torch.bfloat16) * 0.02)
        bf[layer] = w
        fp8[layer] = w.to(torch.float8_e4m3fn)
        i8[layer] = torch.clamp(torch.round(w.float() / 0.001), -127,
                                127).to(torch.int8)
        del w
    return {"fp8": fp8, "fp8asint8": fp8.view(torch.int8), "int8": i8,
            "bf16": bf}


def chain_ms(fn) -> float:
    """Device ms per call of ``fn(layer)`` over ``REPS`` passes of the
    layer chain."""
    def chain():
        for layer in range(LAYERS):
            fn(layer)
    return events_ms(chain, REPS, SLEEP_CYCLES) / LAYERS


def run(labels=None, log=print) -> list:
    """Every variant and yardstick at every shape (or those named in
    ``labels``); returns one dict per (shape, variant)."""
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm

    _, peak_bps, _ = chip_specs()
    gen = torch.Generator(device="cuda").manual_seed(0)
    unit = torch.ones(1, dtype=torch.float32, device="cuda")
    rows = []
    for label, k, n in SHAPES:
        if labels and label not in labels:
            continue
        x = torch.randn((M, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        ws = weights(k, n, gen)
        nbytes = k * n + M * k * 2 + M * n * 2
        bound_ms = nbytes / peak_bps * 1e3 if peak_bps else None
        dense = ws["bf16"]                        # pre-dequantized bf16
        mm_ms = chain_ms(lambda l: torch.mm(x, dense[l]))
        for variant in sm.VARIANTS:
            w = ws[WEIGHT_OF[variant]]
            out = sm.stream_matmul_kernel(x, w[0], variant)
            ref = sm.stream_matmul_reference(x, w[0], variant)
            diff = (out.float() - ref.float()).abs()
            rel = float((out.float() - ref.float()).norm()
                        / ref.float().norm())
            ms = chain_ms(lambda l: sm.stream_matmul_kernel(x, w[l],
                                                            variant))
            k5 = ws["int8" if variant == "astype_int8" else "fp8"]
            k5_ms = chain_ms(lambda l: fm.fp8_matmul_kernel(
                x, k5[l], unit, torch.bfloat16))
            row = dict(shape=label, k=k, n=n, m=M, variant=variant,
                       ms=ms, gbps=nbytes / ms / 1e6,
                       bound_ms=bound_ms,
                       kernel5_unit_scale_ms=k5_ms,
                       torch_mm_bf16_ms=mm_ms,
                       max_abs_err=float(diff.max()), rel_err=rel,
                       finite=bool(torch.isfinite(out).all()))
            rows.append(row)
            log(json.dumps(row))
        del ws, dense, x
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("stream_microbench: no CUDA device", file=sys.stderr)
        return 2
    labels = set(sys.argv[1:] if argv is None else argv)
    rows = run(labels)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": card, "m": M, "layers": LAYERS,
                      "rows": len(rows),
                      "max_rel_err": max(r["rel_err"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
