"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under
``arcticinference_tpu_torch/csrc/_build/`` (git-ignored), named by a hash
of the source, every shared header (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt.  :func:`build_all` starts one
``nvcc`` per source at once.  Nothing is built when a module is
imported: the CPU paths never reach this file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# The build's flags: nvcc's report (registers, shared memory, spills) too.
_FLAGS = NVCC_FLAGS + ("-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's report (``-Xptxas -v``: registers, shared memory, spills) per
#: source, from the build made in this process.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_digest(source: str) -> str:
    """Hash of ``csrc/<source>``, every shared header (``csrc/*.cuh``)
    and the build flags: the name of the source's library."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return digest.hexdigest()[:16]


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` (if its library is not built yet) and
    return the library path.  Raises with nvcc's output on failure."""
    src = CSRC / source
    out = BUILD_DIR / f"lib{src.stem}-{source_digest(source)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    build_logs[source] = log
    return out


def build_all(sources) -> list[Path]:
    """Build every source in ``sources`` at once, one ``nvcc`` each;
    raises the first failure after all have ended."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        futures = [pool.submit(build, s) for s in sources]
        return [f.result() for f in futures]


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built at first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _libs[source] = lib
        return lib
