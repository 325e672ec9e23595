"""Read and write ``.safetensors`` files without the ``safetensors``
package.

The format: an 8-byte little-endian header length ``n``, ``n`` bytes of
a JSON header (``{name: {"dtype", "shape", "data_offsets": [begin,
end]}, "__metadata__": {str: str}}``, offsets relative to the end of the
header, padded with spaces to 8 bytes), then the raw little-endian
tensor bytes.  The port reads the JAX package's drafter checkpoints and
Hugging Face shards with :func:`load_file`, and writes its own distilled
drafters with :func:`save_file`; ``safetensors`` itself reads those back
byte for byte.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Union

import numpy as np
import torch

_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _DTYPES.items()}

PathLike = Union[str, Path]


def read_header(path: PathLike) -> tuple[dict, int]:
    """(the JSON header, the byte offset where tensor data starts)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: PathLike, device: Union[str, torch.device] = "cpu"
              ) -> dict[str, torch.Tensor]:
    """Every tensor of ``path`` on ``device``, in its stored dtype."""
    header, start = read_header(path)
    out = {}
    with open(path, "rb") as f:
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _DTYPES.get(info["dtype"])
            if dtype is None:
                raise TypeError(f"{path}: tensor {name!r} has unsupported "
                                f"dtype {info['dtype']}")
            lo, hi = info["data_offsets"]
            t = torch.empty(hi - lo, dtype=torch.uint8)
            f.seek(start + lo)
            if f.readinto(t.numpy()) != hi - lo:
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            out[name] = t.view(dtype).reshape(tuple(info["shape"])).to(
                device)
    return out


def save_file(tensors: dict, path: PathLike) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays; any layout) to
    ``path``, in name order as ``safetensors`` does."""
    header: dict = {}
    blobs = []
    off = 0
    for name in sorted(tensors):
        t = tensors[name]
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"tensor {name!r}: dtype {t.dtype} unsupported")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
