"""Combined launcher: the port's engine server and the Dynasor proxy in
one command.

Counterpart of ``arcticinference_tpu/dynasor/launcher.py``: spawns the
OpenAI-compatible server on ``port+1``, polls its /health, then runs the
Dynasor proxy on the requested port in front of it.  Arguments it does
not know (``--config``, ``--device``, ...) go to the server.

    python -m arcticinference_tpu_torch.dynasor.launcher --model DIR \\
        --port 8000 [--device cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
import urllib.error
import urllib.request

from arcticinference_tpu_torch.dynasor.proxy import DynasorProxy


def wait_healthy(url: str, timeout: float, proc: subprocess.Popen) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"backend exited prematurely (code {proc.returncode})")
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                if r.status == 200:
                    return
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(1.0)
    raise TimeoutError(f"backend not healthy within {timeout}s")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--probe-interval", type=int, default=64)
    parser.add_argument("--certainty-window", type=int, default=2)
    parser.add_argument("--startup-timeout", type=float, default=1800.0)
    args, extra = parser.parse_known_args(argv)

    backend_port = args.port + 1
    backend = subprocess.Popen(
        [sys.executable, "-m", "arcticinference_tpu_torch", "serve",
         "--model", args.model, "--host", "127.0.0.1",
         "--port", str(backend_port), *extra])
    try:
        wait_healthy(f"http://127.0.0.1:{backend_port}/health",
                     args.startup_timeout, backend)
        proxy = DynasorProxy(f"http://127.0.0.1:{backend_port}",
                             args.probe_interval, args.certainty_window)
        proxy.app.run(args.host, args.port)
    finally:
        backend.terminate()
        try:
            backend.wait(timeout=10)
        except subprocess.TimeoutExpired:
            backend.kill()


if __name__ == "__main__":
    main()
