#!/usr/bin/env python3
"""What gloo does with CUDA tensors between two ranks of one card.

    python3 scripts/gloo_p2p_probe.py [--rows 1024] [--width 4096]

The pipeline's stages (``arcticinference_tpu_torch/parallel/pp.py``) hand
an activation from one process to the next.  On one card the ranks share
``cuda:0`` over gloo (NCCL refuses two ranks on one device).  This script
starts two ranks, each in a fresh pair of processes so that a crash of
one way cannot hide the others, and tries each way of moving a
``[rows, width]`` bf16 tensor on ``cuda:0`` from rank 0 to rank 1:

- ``send_recv``: ``dist.send`` / ``dist.recv`` of the CUDA tensors;
- ``send_recv_host``: the same through host copies;
- ``broadcast_pair``: ``dist.broadcast`` over the two ranks' group, the
  pipeline's way.

For each it prints one JSON line: whether it ran, the error (type and
message) or exit code of each rank, whether rank 1 received the values,
and the ms per call (CUDA synchronised around each; host-staged gloo, not
NCCL).  The last line is the card's name and power limit.  Exits 0 when
every way was tried, whatever each did.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time
import traceback

WAYS = ("send_recv", "send_recv_host", "broadcast_pair")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(way: str, rank: int, port: int, rows: int, width: int) -> None:
    import torch
    import torch.distributed as dist

    out = {"way": way, "rank": rank}
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=2, timeout=datetime.timedelta(seconds=60))
        pair = dist.new_group([0, 1])
        dev = torch.device("cuda:0")
        want = torch.arange(rows * width, device=dev).reshape(
            rows, width).to(torch.bfloat16)
        x = want.clone() if rank == 0 else torch.zeros_like(want)

        def once():
            if way == "send_recv":
                if rank == 0:
                    dist.send(x, dst=1)
                else:
                    dist.recv(x, src=0)
            elif way == "send_recv_host":
                if rank == 0:
                    dist.send(x.cpu(), dst=1)
                else:
                    h = torch.empty(x.shape, dtype=x.dtype)
                    dist.recv(h, src=0)
                    x.copy_(h)
            else:
                dist.broadcast(x, src=0, group=pair)
            torch.cuda.synchronize()

        once()
        out["received"] = bool(torch.equal(x, want))
        iters = 10
        t = time.perf_counter()
        for _ in range(iters):
            once()
        out["ms"] = (time.perf_counter() - t) / iters * 1e3
        out["ok"] = True
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (the probe reports the error)
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"[:400]
        out["where"] = traceback.format_exc().splitlines()[-3:]
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--rank-of", nargs=2, default=None,
                    help=argparse.SUPPRESS)   # (way, rank): one rank
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_of is not None:
        way, rank = args.rank_of
        rank_main(way, int(rank), args.port, args.rows, args.width)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("gloo_p2p_probe: no CUDA device", file=sys.stderr)
        return 2
    for way in WAYS:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-of", way,
             str(r), "--port", str(port), "--rows", str(args.rows),
             "--width", str(args.width)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in (0, 1)]
        ranks = []
        for r, p in enumerate(procs):
            try:
                so, se = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
                ranks.append({"rank": r, "timed_out": True})
                continue
            line = [ln for ln in so.splitlines() if ln.startswith("{")]
            rec = json.loads(line[-1]) if line else {"rank": r}
            rec["exit_code"] = p.returncode
            if p.returncode != 0:
                rec["stderr_tail"] = se.strip().splitlines()[-3:]
            ranks.append(rec)
        print(json.dumps({"way": way, "rows": args.rows,
                          "width": args.width, "dtype": "bfloat16",
                          "ranks": ranks}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
