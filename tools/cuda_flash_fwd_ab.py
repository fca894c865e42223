"""Time versions of the CUDA flash-attention forward against each other.

Each argument is `label=path/to/flash_attention_fwd.cu` (any version with
the port's C entry point `flash_attention_fwd`, e.g. one unpacked from an
earlier commit).  Every source is compiled with the port's nvcc flags, one
nvcc each, all started together; the sources' own directory and the
port's `ops/csrc` are on the include path, in that order.  Then, at every
shape of `chip_smoke.KERNEL_SHAPES`, in bf16:

  - each version's output and LSE against the plain f32 version
    (max |err|), and
  - each version's device time: CUDA events around 20 calls back to back,
    3 rounds of the versions in turns (forward, then reversed order), the
    median of the 6 readings per version.

Needs one CUDA card.  Run from the root of a checkout:

    python3 tools/cuda_flash_fwd_ab.py parent=old/flash_attention_fwd.cu \
        this=diffews_tpu_torch/ops/csrc/flash_attention_fwd.cu [--shapes a,b]

Prints one JSON object per (shape, version) and the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

INNER, ROUNDS = 20, 3


def build(versions: dict, out_dir: Path) -> dict:
    from diffews_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    jobs = {}
    for label, src in versions.items():
        lib = out_dir / f"{label}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(Path(src).resolve().parent),
               "-I", str(_build.CSRC), "-o", str(lib), str(src)]
        jobs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{label}: nvcc failed\n{log}")
        dll = ctypes.CDLL(str(lib))
        dll.flash_attention_fwd.restype = ctypes.c_int
        dll.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                            + [ctypes.c_float, ctypes.c_void_p])
        libs[label] = dll
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="label=path/to/flash_attention_fwd.cu")
    ap.add_argument("--shapes", default="", help="comma-separated KERNEL_SHAPES labels")
    args = ap.parse_args()
    versions = dict(v.split("=", 1) for v in args.versions)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from diffews_tpu_torch.ops.flash_attention import flash_attention_reference

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build" if (ROOT / "build").is_dir()
                                     else None) as tmp:
        libs = build(versions, Path(tmp))
        wanted = set(filter(None, args.shapes.split(",")))
        for label, b, h, sq, skv, d, mk in chip_smoke.KERNEL_SHAPES:
            if wanted and label not in wanted:
                continue
            q32, k32, v32, mask = chip_smoke._kernel_inputs(b, h, sq, skv, d, mk, seed=7)
            q, k, v = q32.bfloat16(), k32.bfloat16(), v32.bfloat16()
            del q32, k32, v32
            ref_o, ref_l = flash_attention_reference(q.float(), k.float(), v.float(),
                                                     kv_mask=mask)
            o = torch.empty_like(q)
            lse = torch.empty((b, sq, h), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            mptr = None if mask is None else mask.data_ptr()

            def run(name):
                err = libs[name].flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), mptr, o.data_ptr(),
                    lse.data_ptr(), b, h, sq, skv, d, 1, d ** -0.5, stream)
                if err != 0:
                    raise SystemExit(f"{name} at {label}: CUDA error {err}")

            errs = {}
            for name in libs:
                o.zero_()
                run(name)
                torch.cuda.synchronize()
                errs[name] = ((o.float() - ref_o).abs().max().item(),
                              (lse - ref_l).abs().max().item())
            times = {name: [] for name in libs}
            order = list(libs) + list(libs)[::-1]
            for _ in range(ROUNDS):
                for name in order:
                    for _ in range(3):
                        run(name)
                    a = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(INNER):
                        run(name)
                    e.record()
                    e.synchronize()
                    times[name].append(a.elapsed_time(e) / INNER)
            skv_valid = skv if mask is None else mask.float().sum(1).mean().item()
            flops = 4.0 * b * h * sq * skv_valid * d
            for name in libs:
                ms = statistics.median(times[name])
                print(json.dumps({"shape": label, "version": name, "ms": ms,
                                  "ms_min": min(times[name]), "ms_max": max(times[name]),
                                  "tflops_valid_keys": flops / (ms * 1e-3) / 1e12,
                                  "max_abs_err": errs[name][0],
                                  "lse_max_abs_err": errs[name][1]}), flush=True)
            del q, k, v, ref_o, ref_l, o, lse
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
