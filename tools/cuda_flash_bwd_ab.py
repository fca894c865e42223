"""Time versions of the CUDA flash-attention backward against each other.

Each argument is `label=path/to/flash_attention_bwd.cu`: this tree's, or one
unpacked from an earlier commit.  Two C interfaces are known: the current
one (`flash_attention_bwd_plan`; the dq kernel computes delta from O and
writes the row statistics that dkv reads) and the earlier one (LSE and
delta as (B, Sq, H) f32 inputs of both kernels, delta computed in torch).
Every source is compiled with the port's nvcc flags, one nvcc each, all
started together; the source's own directory and the port's `ops/csrc` are
on the include path, in that order.  Then, at every shape of
`chip_smoke.BWD_SHAPES`, in bf16, on the forward kernel's O and LSE:

  - each version's dq, dk and dv against the plain version
    (`flash_attention_bwd_reference` in f32): max |err| / max |plain|;
  - each version's device time of dq, of dkv (each with its own reductions
    of split walks) and of the whole backward (delta included; for the
    earlier interface, the torch delta): CUDA events around 20 calls back
    to back, 3 rounds of the versions in turns (forward, then reversed
    order), the median of the 6 readings per version.

Needs one CUDA card.  Run from the root of a checkout:

    python3 tools/cuda_flash_bwd_ab.py parent=old/flash_attention_bwd.cu \\
        this=diffews_tpu_torch/ops/csrc/flash_attention_bwd.cu [--shapes a,b]

Prints the card's name and power limit, then one JSON object per (shape,
version).
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
P = ctypes.c_void_p
TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, P]


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
        current = hasattr(dll, "flash_attention_bwd_plan")
        dll.flash_attention_bwd_dq.restype = ctypes.c_int
        dll.flash_attention_bwd_dkv.restype = ctypes.c_int
        if current:
            dll.flash_attention_bwd_plan.restype = ctypes.c_int
            dll.flash_attention_bwd_plan.argtypes = [ctypes.c_int] * 5 + [P]
            dll.flash_attention_bwd_dq.argtypes = [P] * 11 + TAIL
            dll.flash_attention_bwd_dkv.argtypes = [P] * 9 + TAIL
        else:
            dll.flash_attention_bwd_dq.argtypes = [P] * 8 + TAIL
            dll.flash_attention_bwd_dkv.argtypes = [P] * 9 + TAIL
        libs[label] = (dll, current)
    return libs


def runner(dll, current, q, k, v, g, out, lse, mask, label):
    """(dq(), dkv(), whole(), outputs) for one version at one shape."""
    import torch

    b, sq, h, d = q.shape
    skv = k.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    mptr = None if mask is None else mask.data_ptr()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tail = (b, h, sq, skv, d, 1, d ** -0.5, stream)

    def ok(err, what):
        if err != 0:
            raise SystemExit(f"{label}: {what} failed: CUDA error {err}")

    if current:
        plan = (ctypes.c_int * 3)()
        ok(dll.flash_attention_bwd_plan(b, h, sq, skv, 1, ctypes.addressof(plan)), "plan")
        stats = torch.empty((2, b * h, plan[2]), device="cuda")
        w_dq = (torch.empty(plan[0] * q.numel(), device="cuda") if plan[0] > 1 else None)
        w_kv = (torch.empty(plan[1] * 2 * k.numel(), device="cuda") if plan[1] > 1 else None)
        ptr = lambda t: None if t is None else t.data_ptr()

        def run_dq():
            ok(dll.flash_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                          out.data_ptr(), None, lse.data_ptr(), mptr,
                                          dq.data_ptr(), stats.data_ptr(), ptr(w_dq), *tail),
               "dq")

        def run_dkv():
            ok(dll.flash_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           g.data_ptr(), stats.data_ptr(), mptr, dk.data_ptr(),
                                           dv.data_ptr(), ptr(w_kv), *tail), "dkv")

        def whole():
            run_dq()
            run_dkv()
    else:
        delta = (out.float() * g.float()).sum(-1)

        def run_dq():
            ok(dll.flash_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                          lse.data_ptr(), delta.data_ptr(), mptr, dq.data_ptr(),
                                          *tail), "dq")

        def run_dkv():
            ok(dll.flash_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           g.data_ptr(), lse.data_ptr(), delta.data_ptr(), mptr,
                                           dk.data_ptr(), dv.data_ptr(), *tail), "dkv")

        def whole():
            torch.sum(out.float() * g.float(), -1, out=delta)
            run_dq()
            run_dkv()
    return run_dq, run_dkv, whole, (dq, dk, dv)


def timed(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(INNER):
        fn()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / INNER


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="label=path/to/flash_attention_bwd.cu")
    ap.add_argument("--shapes", default="", help="comma-separated BWD_SHAPES labels")
    args = ap.parse_args()
    versions = dict(v.split("=", 1) for v in args.versions)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    from diffews_tpu_torch.ops.flash_attention import (flash_attention_bwd_reference,
                                                       flash_attention_lse)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build" if (ROOT / "build").is_dir()
                                     else None) as tmp:
        libs = build(versions, Path(tmp))
        wanted = set(filter(None, args.shapes.split(",")))
        for i, (label, b, h, sq, skv, d, mk) in enumerate(chip_smoke.BWD_SHAPES):
            if wanted and label not in wanted:
                continue
            q32, k32, v32, mask = chip_smoke._kernel_inputs(b, h, sq, skv, d, mk, seed=300 + i)
            g32 = torch.randn(q32.shape, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(i))
            q, k, v, g = (x.bfloat16() for x in (q32, k32, v32, g32))
            del q32, k32, v32, g32
            out, lse = flash_attention_lse(q, k, v, kv_mask=mask)
            want = flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask,
                                                 out.float(), lse, g.float(), d ** -0.5)
            runs, errs = {}, {}
            for name, (dll, current) in libs.items():
                runs[name] = runner(dll, current, q, k, v, g, out, lse, mask, name)
                runs[name][2]()
                torch.cuda.synchronize()
                errs[name] = {key: ((a.float() - r).abs().max() / r.abs().max()).item()
                              for key, a, r in zip(("dq", "dk", "dv"), runs[name][3], want)}
            del want
            times = {name: {"dq": [], "dkv": [], "whole": []} for name in libs}
            order = list(libs) + list(libs)[::-1]
            for _ in range(ROUNDS):
                for name in order:
                    run_dq, run_dkv, whole, _ = runs[name]
                    for part, fn in (("dq", run_dq), ("dkv", run_dkv), ("whole", whole)):
                        times[name][part].append(timed(fn))
            skv_valid = skv if mask is None else mask.float().sum(1).mean().item()
            flops = {"dq": 6.0 * b * h * sq * skv_valid * d, "dkv": 8.0 * b * h * sq * skv_valid * d}
            flops["whole"] = flops["dq"] + flops["dkv"]
            for name in libs:
                rec = {"shape": label, "version": name, "rel_err": errs[name]}
                for part, ts in times[name].items():
                    ms = statistics.median(ts)
                    rec[f"{part}_ms"] = ms
                    rec[f"{part}_ms_range"] = [min(ts), max(ts)]
                    rec[f"{part}_tflops_valid_keys"] = flops[part] / (ms * 1e-3) / 1e12
                print(json.dumps(rec), flush=True)
            del runs, q, k, v, g, out, lse
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
