#!/usr/bin/env python3
"""Time the quantized matmul kernels of the checkout in the current
directory at chip_smoke.py's phase-3 shapes:

    cd <checkout> && python3 <path>/scripts/time_matmul_kernels.py

Cases (seed 0): kernel 5 (``fp8_matmul_kernel``) on Llama-3.1-8B's wqkv,
wo, w_gateup and w_down at 16, 64, 128, 256 and 2048 rows and its LM head
at 16 and 64 (fp8; int8 on w_gateup at 16, 64 and 2048), the Arctic
drafter's projection and head at 64 rows (float32 out); kernel 6
(``int4_matmul_kernel``) on the same layer shapes at 16, 64, 256 and
2048 rows; kernel 8 (``stream_matmul_kernel``, its four dequant variants)
at the stream microbench's five shapes, 64 rows.  Each is timed with CUDA
events over 20 launches behind a spinning kernel, on weight copies that
cycle past the 50 MB L2 (``chip_smoke.cuda_time_ms``, ``rotating``),
with its wrapper's host microseconds per call (``host_time_us``) and one
``torch.mm`` on the weight dequantized to bf16 as a yardstick.  Prints
the card's name and power limit, then one JSON line ``{case: {"ms",
"host_us", "torch_mm_ms"}}``.  To compare two trees, run it in each, in
turns (A, B, B, A), in one call on the card.  Needs a CUDA device.
"""

import json
import sys

import torch

# Layer shapes of phase 3: (name, K, N, fused part widths).
LAYERS = (("wqkv", 4096, 6144, (4096, 1024, 1024)),
          ("wo", 4096, 4096, None),
          ("w_gateup", 4096, 28672, (14336, 14336)),
          ("w_down", 14336, 4096, None))
FP8_ROWS = (16, 64, 128, 256, 2048)
INT4_ROWS = (16, 64, 256, 2048)
INT8_ROWS = (16, 64, 2048)
HEAD = ("lm_head", 4096, 128256)
DRAFTER = (("drafter proj", 4096, 4096), ("drafter head", 4096, 128256))


def main() -> int:
    sys.path.insert(0, ".")  # the checkout being timed
    import chip_smoke as cs
    from arcticinference_tpu_torch.benchmarks import stream_microbench as smb
    from arcticinference_tpu_torch.ops import fp8
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm

    if not torch.cuda.is_available():
        print("time_matmul_kernels: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    def time_case(label, kernel, q, k, m, out_dtype=torch.bfloat16):
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        copies = cs.rotating(q, q.weight.nbytes + q.scale.nbytes)

        def kern():
            c = next(copies)
            kernel(x, c.weight, c.scale, out_dtype)

        wd = fp8.fp8_dequantize(q, torch.bfloat16)
        dense = cs.rotating(wd, wd.nbytes)
        out[label] = dict(
            ms=cs.cuda_time_ms(kern, 20),
            host_us=cs.host_time_us(
                lambda: kernel(x, q.weight, q.scale, out_dtype)),
            torch_mm_ms=cs.cuda_time_ms(lambda: torch.mm(x, next(dense)), 20))
        del copies, dense, wd

    for mode, rows in (("fp8", FP8_ROWS), ("int8", INT8_ROWS),
                       ("int4", INT4_ROWS)):
        kernel = (im.int4_matmul_kernel if mode == "int4"
                  else fm.fp8_matmul_kernel)
        for name, k, n, parts in LAYERS:
            if mode == "int8" and name != "w_gateup":
                continue
            q = cs.quantized_weight(mode, k, n, parts, gen)
            for m in rows:
                time_case(f"{mode} {name} M={m}", kernel, q, k, m)
            del q
            torch.cuda.empty_cache()
    q = cs.quantized_weight("fp8", HEAD[1], HEAD[2], None, gen)
    for m in (16, 64):
        time_case(f"fp8 {HEAD[0]} M={m}", fm.fp8_matmul_kernel, q, HEAD[1],
                  m, torch.float32)
    del q
    for name, k, n in DRAFTER:
        q = cs.quantized_weight("fp8", k, n, None, gen)
        time_case(f"fp8 {name} M=64", fm.fp8_matmul_kernel, q, k, 64,
                  torch.float32)
        del q
        torch.cuda.empty_cache()
    for label, k, n in smb.SHAPES:
        x = torch.randn((smb.M, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        ws = {key: w[0] for key, w in smb.weights(k, n, gen, 1).items()}
        for variant in sm.VARIANTS:
            w = ws[smb.WEIGHT_OF[variant]]
            copies = cs.rotating(w, w.nbytes)
            dense = cs.rotating(sm.dequant(w, variant).to(torch.bfloat16),
                                2 * w.nbytes)
            out[f"stream {variant} {label} M={smb.M}"] = dict(
                ms=cs.cuda_time_ms(
                    lambda: sm.stream_matmul_kernel(x, next(copies), variant),
                    20),
                host_us=cs.host_time_us(
                    lambda: sm.stream_matmul_kernel(x, w, variant)),
                torch_mm_ms=cs.cuda_time_ms(
                    lambda: torch.mm(x, next(dense)), 20))
            del copies, dense
        del ws, x
        torch.cuda.empty_cache()
    print(cs.smi(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
