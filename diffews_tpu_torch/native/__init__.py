"""ctypes loader for the native mask codec (builds lazily with cc).

Port of `diffews_tpu/native/__init__.py`.  `load()` returns the loaded CDLL
or None.  The shared object is built from `maskcodec.cc` on first use
(g++/cc, ~1 s) into `build/native/` at the root of the checkout (git-ignored;
the source tree may be read-only), under a name that carries a hash of the
source, so an edited source never loads a stale build.  Set
``DIFFEWS_TPU_NATIVE=0`` to force the pure-Python fallbacks in
`diffews_tpu_torch.data.masks`.  A build failure is never fatal — callers
fall back to NumPy/PIL.  This is host code: the codec runs on the CPU that
feeds the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "maskcodec.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_pi64 = ctypes.POINTER(ctypes.c_int64)
_pu8 = ctypes.POINTER(ctypes.c_uint8)
_pdbl = ctypes.POINTER(ctypes.c_double)


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"maskcodec-{digest[:12]}.so"


def _build(target: Path) -> bool:
    cc = shutil.which("g++") or shutil.which("cc") or shutil.which("clang++")
    if cc is None:
        return False
    tmp = target.with_name(target.name + f".tmp.{os.getpid()}")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cc, *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            tmp.unlink()
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rle_decode_counts.restype = _i64
    lib.rle_decode_counts.argtypes = [ctypes.c_char_p, _i64, _pi64, _i64]
    lib.rle_encode_counts.restype = _i64
    lib.rle_encode_counts.argtypes = [_pi64, _i64, ctypes.c_char_p, _i64]
    lib.rle_expand.restype = None
    lib.rle_expand.argtypes = [_pi64, _i64, _i64, _i64, _pu8]
    lib.rle_from_mask.restype = _i64
    lib.rle_from_mask.argtypes = [_pu8, _i64, _i64, _pi64, _i64]
    lib.polys_to_mask.restype = None
    lib.polys_to_mask.argtypes = [_pdbl, _pi64, _i64, _i64, _i64, _pu8]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native codec; None if unavailable."""
    global _lib, _tried
    if os.environ.get("DIFFEWS_TPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        target = _target()
        if not target.exists() and not _build(target):
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(target)))
        except OSError:
            _lib = None
        return _lib
