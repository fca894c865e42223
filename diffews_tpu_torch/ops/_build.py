"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `ops/csrc/*.cu` source is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/<name>-<hash>.so <name>.cu

The library name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header never loads a
stale build.  `build/` sits at the root of the
checkout and is git-ignored.  Libraries are built at first use: nothing
here runs at import time, so CPU-only hosts import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME (as torch resolves it), else from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    """The library path of `csrc/<name>.cu`, keyed by the source, every
    `csrc/*.cuh` header (any source may include any of them) and the
    flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that have no current
    library, one nvcc each, all started together.  Returns {name: compiler
    output, with ptxas's register and shared-memory report}; raises if any
    build fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for n in names:
        out = _target(n)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        jobs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
                   tmp, out)
    logs, failed = {}, []
    for n, (proc, tmp, out) in jobs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
