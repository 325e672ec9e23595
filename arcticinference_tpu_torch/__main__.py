"""CLI entry: python -m arcticinference_tpu_torch <command> ...

Commands:
  serve      OpenAI-compatible HTTP server (serving/openai_server.py)
  embed      Embedding replica manager (embedding/replica_manager.py)
  dynasor    CoT early-exit proxy (dynasor/proxy.py)
  simulate   Suffix-decoding offline simulator (spec/simulator.py)
"""

import sys


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        return
    cmd = sys.argv.pop(1)
    if cmd == "serve":
        from arcticinference_tpu_torch.serving.openai_server import main as m
    elif cmd == "embed":
        from arcticinference_tpu_torch.embedding.replica_manager import (
            main as m)
    elif cmd == "dynasor":
        from arcticinference_tpu_torch.dynasor.proxy import main as m
    elif cmd == "simulate":
        from arcticinference_tpu_torch.spec.simulator import main as m
    else:
        print(f"unknown command {cmd!r}\n{__doc__}")
        sys.exit(2)
    m()


if __name__ == "__main__":
    main()
