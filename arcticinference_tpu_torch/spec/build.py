"""Build the native suffix tree (``csrc/suffix_tree.cc``) with g++.

Host code: it builds wherever a C++ compiler is, the CPU included, and is
kept apart from ``ops/cuda/build.py`` (which needs ``nvcc``).  The library
goes to ``arcticinference_tpu_torch/csrc/_build/`` (git-ignored), named by
a hash of the source and the flags, and is built at first use, never when
a module is imported.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCE = "suffix_tree.cc"

CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden")

_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def library_path() -> Path:
    """Where the suffix tree's library is (or will be) built."""
    digest = hashlib.sha256((CSRC / SOURCE).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsuffixtree-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/suffix_tree.cc`` if its library is not built yet
    and return the library's path; raises :class:`NativeBuildError`
    with g++'s output on failure."""
    out = library_path()
    with _lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(CSRC / SOURCE),
               "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError(f"C++ compiler not found: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out
