#!/usr/bin/env python3
"""Time the attention kernels of the checkout in the current directory on
chip_smoke.py's phase-3 steps, bf16 KV (``--kv fp8``: fp8 KV):

    cd <checkout> && python3 <path>/scripts/time_attention_kernels.py

Steps (seed 0; phase 3's shapes): the ragged kernel (kernel 1) on a mixed
step (512- and 1024-token chunks beside 32 decode rows at contexts
128-4096, bucket 2048) and on a 2048-token prefill chunk at context 2048,
each at qb 8 and 32; the grouped decode kernel (kernel 2) on B=64
sequences at contexts 128-4096, qlen 1, 4 and 8, and the per-sequence
decode kernel (kernel 4) on the same steps; the deferred-KV path (kernel
3) on B=64 sequences at contexts 128-2048, qlen 1 and 8; kernel 2 on the
bench's decode shape (B=64 at contexts 192-320, qlen 1 and 4); kernels 2
and 4 on long contexts (B=8 at 16384-32768 tokens, qlen 1 and 8, a
one-layer cache).  Prints
one JSON line of milliseconds per call (CUDA events over 20 launches
behind a spinning kernel, ``chip_smoke.cuda_time_ms``), with masked SDPA
on each grouped and deferred step (``Case.library_ms``) as a yardstick
and the host microseconds a call of kernels 2 and 4's wrappers at B=64
(``chip_smoke.host_time_us``), after the card's name and power limit.
To compare two trees, run it in each, in turns (A, B, B, A), in one call
on the card.  Needs a CUDA device.
"""

import argparse
import json
import sys

import numpy as np
import torch


def main() -> int:
    sys.path.insert(0, ".")  # the checkout being timed
    import chip_smoke as cs
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kv", choices=("bf16", "fp8"), default="bf16")
    kv_dtype = dict(bf16=torch.bfloat16, fp8=torch.float8_e4m3fn)[
        ap.parse_args().kv]
    if not torch.cuda.is_available():
        print("time_attention_kernels: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(0)
    out = {}
    decode = [(int(c), 1) for c in rng.integers(128, 4096, 32)]
    for name, reqs in (("mixed", [(0, 512), (1024, 1024)] + decode),
                       ("prefill", [(2048, 2048)])):
        case = cs.Case(name, reqs, kv_dtype, rng, t_pad=2048)
        for qb in (8, 32):
            sched = case.schedule(qb)

            def ragged(case=case, qb=qb, sched=sched):
                return ra.ragged_paged_attention_kernel(
                    case.q, case.kv, case.positions, case.req_idx,
                    case.block_tables, case.seq_lens, qb=qb, schedule=sched,
                    kv_scale=case.kv_scale, layer=case.layer)

            out[f"ragged {name} qb={qb}"] = cs.cuda_time_ms(ragged, 20)
        del case
    for qlen in (1, 4, 8):
        reqs = [(int(c), qlen) for c in rng.integers(128, 4096, 64)]
        case = cs.Case("decode", reqs, kv_dtype, rng, t_pad=64 * qlen,
                       slot_rows=qlen)
        pos_base = torch.clamp(case.seq_lens - qlen, min=0)

        def grouped(case=case, qlen=qlen, pos_base=pos_base):
            return ra.grouped_decode_attention_kernel(
                case.q, case.kv, pos_base, case.block_tables, case.seq_lens,
                qlen=qlen, kv_scale=case.kv_scale, layer=case.layer)

        def paged(case=case, qlen=qlen, pos_base=pos_base):
            return ra.decode_paged_attention_kernel(
                case.q, case.kv, pos_base, case.block_tables, case.seq_lens,
                qlen, kv_scale=case.kv_scale, layer=case.layer)

        out[f"grouped B=64 qlen={qlen}"] = cs.cuda_time_ms(grouped, 20)
        out[f"decode_paged B=64 qlen={qlen}"] = cs.cuda_time_ms(paged, 20)
        out[f"grouped B=64 qlen={qlen} host_us"] = cs.host_time_us(grouped)
        out[f"decode_paged B=64 qlen={qlen} host_us"] = cs.host_time_us(
            paged)
        out[f"sdpa decode B=64 qlen={qlen}"] = case.library_ms()
        del case
    for qlen in (1, 8):
        reqs = [(int(c), qlen) for c in rng.integers(128, 2049, 64)]
        case = cs.DeferredCase("deferred", reqs, qlen, {}, kv_dtype, rng)

        def deferred(case=case, qlen=qlen):
            return ra.grouped_decode_attention_kernel(
                case.q, case.kv, case.pos_base, case.block_tables,
                case.seq_lens, qlen=qlen, kv_scale=case.kv_scale,
                layer=case.layer, knew=case.knew, vnew=case.vnew,
                slot_mapping=case.slot_mapping)

        out[f"deferred B=64 qlen={qlen}"] = cs.cuda_time_ms(deferred, 20)
        out[f"sdpa deferred B=64 qlen={qlen}"] = case.library_ms()
        del case
    for qlen in (1, 4):
        reqs = [(int(c), qlen) for c in rng.integers(192, 321, 64)]
        case = cs.Case("short", reqs, kv_dtype, rng, t_pad=64 * qlen,
                       slot_rows=qlen)
        pos_base = torch.clamp(case.seq_lens - qlen, min=0)

        def short(case=case, qlen=qlen, pos_base=pos_base):
            return ra.grouped_decode_attention_kernel(
                case.q, case.kv, pos_base, case.block_tables, case.seq_lens,
                qlen=qlen, kv_scale=case.kv_scale, layer=case.layer)

        out[f"grouped B=64 ctx 192-320 qlen={qlen}"] = cs.cuda_time_ms(
            short, 20)
        out[f"sdpa B=64 ctx 192-320 qlen={qlen}"] = case.library_ms()
        del case
    layers, cs.LAYERS = cs.LAYERS, 1      # one layer of 1-2 GiB
    for qlen in (1, 8):
        reqs = [(int(c), qlen) for c in rng.integers(16384, 32769, 8)]
        case = cs.Case("long", reqs, kv_dtype, rng, t_pad=8 * qlen,
                       slot_rows=qlen, layer=0)
        pos_base = torch.clamp(case.seq_lens - qlen, min=0)
        for key, fn in (("grouped", ra.grouped_decode_attention_kernel),
                        ("decode_paged", ra.decode_paged_attention_kernel)):
            out[f"{key} B=8 ctx 16k-32k qlen={qlen}"] = cs.cuda_time_ms(
                lambda fn=fn, case=case, qlen=qlen, pos_base=pos_base: fn(
                    case.q, case.kv, pos_base, case.block_tables,
                    case.seq_lens, qlen=qlen, kv_scale=case.kv_scale,
                    layer=case.layer), 20)
        out[f"sdpa B=8 ctx 16k-32k qlen={qlen}"] = case.library_ms()
        del case
        torch.cuda.empty_cache()
    cs.LAYERS = layers
    print(cs.smi(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
