"""Time versions of the CUDA conv kernels (fused GroupNorm+SiLU+conv3x3,
the stride-2 downsample and the W8A8 int8 conv) against each other.

Each argument is `label=path/to/csrc` (a directory that holds
`fused_resnet.cu`, `downsample.cu` and `quant_int8.cu` with the port's C
entry points `fused_gn_silu_conv3x3`, `fused_resnet_tile`,
`downsample_conv2x` and `conv2d_int8`, and the headers they include, e.g.
one unpacked from an earlier commit).  The sources that `--only` needs are
compiled with the port's nvcc flags, one nvcc each, all started together,
with the source's own directory on the include path.  Then:

  - the fused conv (bf16) at every shape the fused VAE gives it in a
    1-shot batch-4 512px episode (`FUSED_SHAPES`: encode B = 12, decode
    B = 4);
  - the downsample (bf16) at the VAE encoder's three downsample inputs at
    B = 12 and B = 3 (`DOWN_SHAPES`);
  - the int8 conv at the 19 distinct int8 conv shapes of the 1-shot b4
    episode under `vae_impl="int8"` (`INT8_SHAPES`: the encoder at B = 12
    with its three stride-2 downsamples and its 512 -> 8 head, the decoder
    at B = 4 with its 128 -> 3 head), writing bf16 and f32, on int8 codes
    and weights from `quant.quantize_s8_reference` / `quantize_weight`
    with a static scale;

each version's output against the plain version (max and mean |err| over
max|plain|; for the fused conv also its statistics against a fresh f64
sum of its own output; the int8 conv bit for bit, `torch.equal` with
`conv2d_int8_reference`, and a repeat bit-identical), and each version's
device time: CUDA events around 10 calls back to back, 3 rounds of the
versions in turns (forward, then reversed order), the median of the 6
readings per version.  Beside them the library call's time (cuDNN's
`F.conv2d`; `F.pad` + strided `F.conv2d` for the downsample; for the int8
conv cuDNN's bf16 `F.conv2d` at the shape, a yardstick of another
function: no PyTorch call takes int8 on the card), TFLOP/s (TOP/s) and the
share of the bound (operations at 989 TFLOP/s bf16, or 1979 TOP/s int8,
against bytes at 3.35 TB/s, as `chip_smoke.py` counts them).

Needs one CUDA card.  Run from the root of a checkout:

    python3 tools/cuda_conv_ab.py parent=old/diffews_tpu_torch/ops/csrc \\
        this=diffews_tpu_torch/ops/csrc [--only fused|down|int8]

Prints the card's name and power limit first, then one JSON object per
(shape, version).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

INNER, ROUNDS = 10, 3
PEAK_BF16, PEAK_INT8, MEM_BW = 989e12, 1979e12, 3.35e12

# (B, H, W, Cin, Cout, residual): the 22 fused-VAE shapes at 512px, 1-shot
# batch 4 (encode of 12 images, decode of 4 latents); the first is the main
# shape (the encoder's 512² resnet conv2)
FUSED_SHAPES = [
    (12, 512, 512, 128, 128, True), (12, 512, 512, 128, 128, False),
    (12, 256, 256, 128, 256, False), (12, 256, 256, 256, 256, True),
    (12, 256, 256, 256, 256, False), (12, 128, 128, 256, 512, False),
    (12, 128, 128, 512, 512, True), (12, 128, 128, 512, 512, False),
    (12, 64, 64, 512, 512, True), (12, 64, 64, 512, 512, False), (12, 64, 64, 512, 8, False),
    (4, 64, 64, 512, 512, True), (4, 64, 64, 512, 512, False),
    (4, 128, 128, 512, 512, True), (4, 128, 128, 512, 512, False),
    (4, 256, 256, 512, 256, False), (4, 256, 256, 256, 256, True),
    (4, 256, 256, 256, 256, False), (4, 512, 512, 256, 128, False),
    (4, 512, 512, 128, 128, True), (4, 512, 512, 128, 128, False), (4, 512, 512, 128, 3, False),
]
# (B, H, W, Cin, Cout): the encoder's three downsample inputs
DOWN_SHAPES = [(b, 512 >> i, 512 >> i, c, c) for b in (12, 3)
               for i, c in enumerate((128, 256, 512))]
# (B, H, W, Cin, Cout, stride, (top, bottom, left, right) padding): the 19
# int8 conv shapes of the 1-shot b4 episode (3x3 convs with Cin >= 32);
# the first is the main shape (the encoder's 512² resnet convs)
_SAME, _DOWN = (1, 1, 1, 1), (0, 1, 0, 1)
INT8_SHAPES = [
    (12, 512, 512, 128, 128, 1, _SAME), (12, 512, 512, 128, 128, 2, _DOWN),
    (12, 256, 256, 128, 256, 1, _SAME), (12, 256, 256, 256, 256, 1, _SAME),
    (12, 256, 256, 256, 256, 2, _DOWN), (12, 128, 128, 256, 512, 1, _SAME),
    (12, 128, 128, 512, 512, 1, _SAME), (12, 128, 128, 512, 512, 2, _DOWN),
    (12, 64, 64, 512, 512, 1, _SAME), (12, 64, 64, 512, 8, 1, _SAME),
    (4, 64, 64, 512, 512, 1, _SAME), (4, 128, 128, 512, 512, 1, _SAME),
    (4, 256, 256, 512, 512, 1, _SAME), (4, 256, 256, 512, 256, 1, _SAME),
    (4, 256, 256, 256, 256, 1, _SAME), (4, 512, 512, 256, 256, 1, _SAME),
    (4, 512, 512, 256, 128, 1, _SAME), (4, 512, 512, 128, 128, 1, _SAME),
    (4, 512, 512, 128, 3, 1, _SAME),
]
SOURCES = {"fused": "fused_resnet", "down": "downsample", "int8": "quant_int8"}


def build(versions: dict, out_dir: Path, names) -> dict:
    from diffews_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    jobs = {}
    for label, src_dir in versions.items():
        for name in names:
            src = Path(src_dir).resolve() / f"{name}.cu"
            lib = out_dir / f"{label}_{name}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(src.parent), "-o", str(lib), str(src)]
            jobs[(label, name)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {label: {} for label in versions}
    for (label, name), (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{label} {name}: nvcc failed\n{log}")
        dll = ctypes.CDLL(str(lib))
        if name == "fused_resnet":
            fn = dll.fused_gn_silu_conv3x3
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            dll.fused_resnet_tile.restype = ctypes.c_int
            dll.fused_resnet_tile.argtypes = [ctypes.c_int]
        elif name == "downsample":
            fn = dll.downsample_conv2x
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        else:
            fn = dll.conv2d_int8
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[label][name] = dll
    return libs


def time_in_turns(run: dict, lib_call=None) -> dict:
    """{version: [ms, ...]} and the library call's readings (if any), in
    turns."""
    import torch

    calls = dict(run) if lib_call is None else dict(run, library=lib_call)
    times = {name: [] for name in calls}
    order = list(calls) + list(calls)[::-1]
    for _ in range(ROUNDS):
        for name in order:
            for _ in range(2):
                calls[name]()
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(INNER):
                calls[name]()
            e.record()
            e.synchronize()
            times[name].append(a.elapsed_time(e) / INNER)
    return times


def _rel(got, want):
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    return err.max().item() / top, err.mean().item() / top


def _bound_ms(flops, nbytes, peak=PEAK_BF16):
    t_ops, t_mem = flops / peak, nbytes / MEM_BW
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def fused_rows(libs, stream, only=()):
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops import fused_resnet as FR

    for i, (bsz, h, w, cin, cout, has_res) in enumerate(FUSED_SHAPES):
        if only and i not in only:
            continue
        g = torch.Generator(device="cuda").manual_seed(400 + i)
        x = torch.randn((bsz, h, w, cin), generator=g, device="cuda").bfloat16()
        a = torch.rand((bsz, cin), generator=g, device="cuda") + 0.5
        b = torch.rand((bsz, cin), generator=g, device="cuda") * 0.6 - 0.3
        wt = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda")
              * (1.0 / (3 * cin ** 0.5))).bfloat16()
        bias = torch.randn((cout,), generator=g, device="cuda") * 0.1
        res = (torch.randn((bsz, h, w, cout), generator=g, device="cuda").bfloat16()
               if has_res else None)
        want = FR.gn_silu_conv3x3_reference(x, a, b, wt, bias, res)[0]
        wk = wt.permute(2, 3, 0, 1).contiguous()
        y = torch.empty((bsz, h, w, cout), dtype=torch.bfloat16, device="cuda")
        s1 = torch.empty((bsz, cout), device="cuda")
        s2 = torch.empty_like(s1)
        parts = {}

        def runner(name):
            dll = libs[name]["fused_resnet"]
            n_part = math.ceil(h / dll.fused_resnet_tile(0)) * math.ceil(w / dll.fused_resnet_tile(1))
            part = parts.setdefault(name, torch.empty((bsz, n_part, 2, cout), device="cuda"))

            def run():
                err = dll.fused_gn_silu_conv3x3(
                    x.data_ptr(), a.data_ptr(), b.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                    None if res is None else res.data_ptr(), y.data_ptr(), part.data_ptr(),
                    s1.data_ptr(), s2.data_ptr(), bsz, h, w, cin, cout, n_part, 1, stream)
                if err != 0:
                    raise SystemExit(f"{name} at {FUSED_SHAPES[i]}: CUDA error {err}")
            return run

        run = {name: runner(name) for name in libs}
        errs = {}
        for name in libs:
            y.zero_()
            run[name]()
            torch.cuda.synchronize()
            yf = y.double()
            d1 = ((s1.double() - yf.sum((1, 2))).abs() / yf.abs().sum((1, 2)).clamp_min(1e-30))
            sq = yf.square().sum((1, 2))
            d2 = (s2.double() - sq).abs() / sq.clamp_min(1e-30)
            errs[name] = _rel(y, want) + (max(d1.max().item(), d2.max().item()),)
        del want
        xc, wc = x.permute(0, 3, 1, 2), wt.to(memory_format=torch.channels_last)
        bc = bias.bfloat16()
        times = time_in_turns(run, lambda: F.conv2d(xc, wc, bc, padding=1))
        flops = 2.0 * bsz * h * w * 9 * cin * cout
        nbytes = ((x.numel() + y.numel() + (0 if res is None else res.numel()) + wt.numel()) * 2
                  + 2 * bsz * cin * 4 + 2 * bsz * cout * 4 + cout * 4)
        bound, by = _bound_ms(flops, nbytes)
        lib_ms = statistics.median(times["library"])
        for name in libs:
            ms = statistics.median(times[name])
            print(json.dumps({
                "kernel": "fused_gn_silu_conv3x3", "shape": list(FUSED_SHAPES[i]),
                "version": name, "ms": ms, "ms_min": min(times[name]),
                "ms_max": max(times[name]), "tflops": flops / ms / 1e9,
                "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms,
                "library_ms": lib_ms, "max_rel_err": errs[name][0],
                "mean_rel_err": errs[name][1], "stats_rel_err": errs[name][2]}), flush=True)
        del x, wt, res, y, wk, xc, wc
        torch.cuda.empty_cache()


def down_rows(libs, stream):
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops import downsample as DS

    for i, (bsz, h, w, cin, cout) in enumerate(DOWN_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(500 + i)
        x = torch.randn((bsz, h, w, cin), generator=g, device="cuda").bfloat16()
        wt = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda")
              * (1.0 / (3 * cin ** 0.5))).bfloat16()
        bias = torch.randn((cout,), generator=g, device="cuda") * 0.1
        want = DS.downsample_conv2x_reference(x, wt, bias)
        wk = wt.permute(2, 3, 0, 1).contiguous()
        y = torch.empty((bsz, h // 2, w // 2, cout), dtype=torch.bfloat16, device="cuda")

        def runner(name):
            dll = libs[name]["downsample"]

            def run():
                err = dll.downsample_conv2x(x.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                                            y.data_ptr(), bsz, h, w, cin, cout, 1, stream)
                if err != 0:
                    raise SystemExit(f"{name} at {DOWN_SHAPES[i]}: CUDA error {err}")
            return run

        run = {name: runner(name) for name in libs}
        errs = {}
        for name in libs:
            y.zero_()
            run[name]()
            torch.cuda.synchronize()
            errs[name] = _rel(y, want)
        del want
        xc, wc = x.permute(0, 3, 1, 2), wt.to(memory_format=torch.channels_last)
        bc = bias.bfloat16()
        times = time_in_turns(
            run, lambda: F.conv2d(F.pad(xc, (0, 1, 0, 1)), wc, bc, stride=2))
        flops = 2.0 * y.numel() * 9 * cin
        nbytes = (x.numel() + y.numel() + wt.numel()) * 2 + cout * 4
        bound, by = _bound_ms(flops, nbytes)
        lib_ms = statistics.median(times["library"])
        for name in libs:
            ms = statistics.median(times[name])
            print(json.dumps({
                "kernel": "downsample_conv2x", "shape": list(DOWN_SHAPES[i]), "version": name,
                "ms": ms, "ms_min": min(times[name]), "ms_max": max(times[name]),
                "tflops": flops / ms / 1e9, "bound_ms": bound, "bound_by": by,
                "share_of_bound": bound / ms, "library_ms": lib_ms,
                "max_rel_err": errs[name][0], "mean_rel_err": errs[name][1]}), flush=True)
        del x, wt, y, wk, xc, wc
        torch.cuda.empty_cache()


def int8_rows(libs, stream, only=()):
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops import quant as Q

    for i, (bsz, h, w, cin, cout, stride, pads) in enumerate(INT8_SHAPES):
        if only and i not in only:
            continue
        g = torch.Generator(device="cuda").manual_seed(600 + i)
        x = torch.randn((bsz, h, w, cin), generator=g, device="cuda").bfloat16()
        wf = torch.randn((cout, 3, 3, cin), generator=g, device="cuda") * 0.05
        w8, s_w = Q.quantize_weight(wf, (1, 2, 3))
        bias = torch.randn((cout,), generator=g, device="cuda") * 0.1
        s = Q.static_s_a(3.0, "cuda")
        xq = Q.quantize_s8_reference(x, s)
        ho, wo = Q._conv_out_hw(h, w, stride, pads)
        want32 = Q.conv2d_int8_reference(xq, w8, s_w, s, bias, stride, pads, torch.float32)
        wants = {torch.float32: want32, torch.bfloat16: want32.bfloat16()}
        ys = {dt: torch.empty((bsz, ho, wo, cout), dtype=dt, device="cuda") for dt in wants}

        def runner(name, dt):
            dll = libs[name]["quant_int8"]
            y = ys[dt]

            def run():
                err = dll.conv2d_int8(xq.data_ptr(), w8.data_ptr(), s_w.data_ptr(),
                                      s.data_ptr(), bias.data_ptr(), y.data_ptr(), bsz, h, w,
                                      cin, cout, ho, wo, stride, pads[0], pads[2],
                                      Q._DTYPE_CODE[dt], stream)
                if err != 0:
                    raise SystemExit(f"{name} at {INT8_SHAPES[i]}: CUDA error {err}")
            return run

        checks = {}
        for name in libs:
            for dt, want in wants.items():
                ys[dt].zero_()
                runner(name, dt)()
                torch.cuda.synchronize()
                first = ys[dt].clone()
                runner(name, dt)()
                torch.cuda.synchronize()
                checks[(name, dt)] = (torch.equal(first, want), torch.equal(first, ys[dt]),
                                      (first.float() - want.float()).abs().max().item())
                del first
        del want32, wants
        # cuDNN's bf16 conv at the shape (channels-last, dequantized weights)
        wc = (w8.float() * s_w[:, None, None, None]).bfloat16().permute(0, 3, 1, 2)
        xc, cpad = x.permute(0, 3, 1, 2), (pads[0], pads[2])
        if (pads[0], pads[2]) != (pads[1], pads[3]):
            xc = F.pad(xc, (pads[2], pads[3], pads[0], pads[1])).contiguous(
                memory_format=torch.channels_last)
            cpad = 0
        bc = bias.bfloat16()
        t16 = time_in_turns({name: runner(name, torch.bfloat16) for name in libs},
                            lambda: F.conv2d(xc, wc, bc, stride=stride, padding=cpad))
        t32 = time_in_turns({name: runner(name, torch.float32) for name in libs})
        ops = 2.0 * bsz * ho * wo * cout * 9 * cin
        in_bytes = bsz * h * w * cin + cout * 9 * cin + cout * 8
        bound16, by16 = _bound_ms(ops, in_bytes + bsz * ho * wo * cout * 2, PEAK_INT8)
        bound32, by32 = _bound_ms(ops, in_bytes + bsz * ho * wo * cout * 4, PEAK_INT8)
        lib_ms = statistics.median(t16["library"])
        for name in libs:
            ms, ms32 = statistics.median(t16[name]), statistics.median(t32[name])
            ok16, rep16, err16 = checks[(name, torch.bfloat16)]
            ok32, rep32, err32 = checks[(name, torch.float32)]
            print(json.dumps({
                "kernel": "conv2d_int8", "shape": [bsz, h, w, cin, cout], "stride": stride,
                "padding": list(pads), "version": name, "ms": ms, "ms_min": min(t16[name]),
                "ms_max": max(t16[name]), "tops": ops / ms / 1e9, "bound_ms": bound16,
                "bound_by": by16, "share_of_bound": bound16 / ms, "library_ms": lib_ms,
                "f32_ms": ms32, "f32_tops": ops / ms32 / 1e9, "f32_bound_ms": bound32,
                "f32_share_of_bound": bound32 / ms32,
                "bit_identical": ok16 and ok32, "repeat_identical": rep16 and rep32,
                "max_abs_err_bf16": err16, "max_abs_err_f32": err32}), flush=True)
        del x, wf, w8, xq, ys, wc, xc
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="label=path/to/csrc")
    ap.add_argument("--only", choices=tuple(SOURCES), default=None)
    ap.add_argument("--fused-shapes", default="",
                    help="comma-separated indices into FUSED_SHAPES (default: all)")
    ap.add_argument("--int8-shapes", default="",
                    help="comma-separated indices into INT8_SHAPES (default: all)")
    args = ap.parse_args()
    versions = dict(v.split("=", 1) for v in args.versions)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0], flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        groups = list(SOURCES) if args.only is None else [args.only]
        libs = build(versions, Path(tmp), [SOURCES[k] for k in groups])
        stream = torch.cuda.current_stream().cuda_stream
        if "fused" in groups:
            fused_rows(libs, stream, [int(i) for i in args.fused_shapes.split(",") if i])
        if "down" in groups:
            down_rows(libs, stream)
        if "int8" in groups:
            int8_rows(libs, stream, [int(i) for i in args.int8_shapes.split(",") if i])


if __name__ == "__main__":
    main()
