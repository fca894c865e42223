"""The safetensors file format, read and written with torch alone.

A `.safetensors` file is an 8-byte little-endian header length N, N bytes
of JSON header, then the tensors' raw little-endian bytes back to back.
The header maps each tensor name to `{"dtype", "shape", "data_offsets":
[begin, end]}` (offsets into the byte buffer after the header) and may
hold a `"__metadata__"` map of strings.  This is what the `safetensors`
package and diffusers read and write; the port keeps its own codec so a
host without that package still reads and writes diffusers checkpoints.

Writing: the header is padded with spaces to a multiple of 8 bytes and the
tensors follow in name order, each contiguous.  Reading: every entry must
lie inside the buffer and the entries must tile it without gaps or
overlaps (the package's own rule).
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_HEADER_LIMIT = 100 * 1024 * 1024  # the package refuses larger headers too

if sys.byteorder != "little":  # raw bytes are little-endian on disk
    raise ImportError("the safetensors codec assumes a little-endian host")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` (name -> torch tensor or numpy array) to `path`;
    returns the bytes written."""
    items = [(name, _as_tensor(x)) for name, x in sorted(tensors.items())]
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def read_header(path: str) -> Tuple[dict, int]:
    """(header, size of the prefix before the byte buffer) of a file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > _HEADER_LIMIT:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file at `path`, as CPU tensors of its dtypes."""
    header, start = read_header(path)
    size = os.path.getsize(path) - start
    entries = sorted(((name, info) for name, info in header.items()
                      if name != "__metadata__"), key=lambda e: tuple(e[1]["data_offsets"]))
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    with open(path, "rb") as f:
        f.seek(start)
        for name, info in entries:
            begin, end = info["data_offsets"]
            dtype = _DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            shape = tuple(int(s) for s in info["shape"])
            n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            if begin != pos or end - begin != n or end > size:
                raise ValueError(f"{path}: {name} has offsets {info['data_offsets']} "
                                 f"(expected [{pos}, {pos + n}] within {size} bytes)")
            buf = bytearray(n)
            if f.readinto(buf) != n:
                raise ValueError(f"{path}: {name} is cut short")
            t = torch.frombuffer(buf, dtype=dtype) if n else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(shape)
            pos = end
    if pos != size:
        raise ValueError(f"{path}: the tensors cover {pos} of {size} bytes")
    return out
