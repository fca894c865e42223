#!/usr/bin/env python3
"""Drive the PyTorch port (`diffews_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. device: the card's name and power limit (`nvidia-smi`);
  2. build: compile every `diffews_tpu_torch/ops/csrc/*.cu` with nvcc;
  3. kernel: the flash-attention kernel against its plain version at every
     shape a 512px episode gives it, in f32 (TF32 off) and bf16, O and
     LSE, with kernel / plain / `F.scaled_dot_product_attention` times;
  4. tiny: a tiny-config f32 episode on the card (kernel) against the same
     episode on the CPU (plain version);
  5. full: random-weight SD-2.1 UNet (8-ch `conv_in_ref`), SD VAE and
     OpenCLIP ViT-H text tower at their published widths, bf16, 512px:
     a 1-shot batch-4 episode (34 kernel launches per `predict`) and a
     5-shot episode with two padded shots against the 3-shot episode.

Every line before the last is plain text or JSON; the last line is
`{"ok": true, "device": {...}}`.  Detailed results also go to
`chiprun_out/chip_smoke.json`.  `--phases` runs a subset (for debugging).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # H100 SXM dense tensor-core FLOP/s
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
MEM_BW = 3.35e12     # H100 SXM HBM3 bytes/s
TOL = {"f32_abs": 2e-4, "bf16_max": 2e-2, "bf16_mean": 2e-3, "lse": 1e-3}
RESULTS: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median device time of `fn()` in ms (CUDA events per run)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    RESULTS["card"] = card
    RESULTS["torch"] = torch.__version__
    RESULTS["cuda"] = torch.version.cuda
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return card


def phase_build():
    from diffews_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build()
    secs = time.time() - t0
    for name in _build.sources():
        _build.load(name)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[{name}] {line.strip()}", flush=True)
    RESULTS["build_s"] = secs
    emit({"phase": "build", "sources": _build.sources(), "seconds": round(secs, 2)})


def _attn_bound_ms(b, h, sq, skv_valid, skv, d, elt):
    """Least time for the work: the larger of FLOPs at the tensor-core (bf16)
    or f32 peak and bytes (each input read once, each output written once)
    at the memory rate.  FLOPs count the valid keys only."""
    flops = 4.0 * b * h * sq * skv_valid * d
    peak = PEAK_BF16 if elt == 2 else PEAK_F32
    nbytes = (b * sq * h * d * 2 + b * skv * h * d * 2) * elt + b * sq * h * 4 + b * skv
    t_ops, t_mem = flops / peak, nbytes / MEM_BW
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


# (label, B, H, Sq, Skv, d, mask kind); B and H as a 1-shot batch-4 episode
# at 512px gives them (5-shot: batch 1).
KERNEL_SHAPES = [
    ("unet64_support", 4, 5, 4096, 4096, 64, None),
    ("unet64_query_1shot", 4, 5, 4096, 8192, 64, None),
    ("unet32_query_1shot", 4, 10, 1024, 2048, 64, None),
    ("unet16_query_1shot", 4, 20, 256, 512, 64, None),
    ("unet8_mid_query_1shot", 4, 20, 64, 128, 64, None),
    ("unet64_query_5shot_2padded", 1, 5, 4096, 24576, 64, "shots"),
    ("unet64_query_attnmask", 4, 5, 4096, 8192, 64, "attnmask"),
    ("vae_mid_d512", 12, 1, 4096, 4096, 512, None),
]
MAIN_SHAPE = "unet64_query_1shot"


def _kernel_inputs(b, h, sq, skv, d, mask_kind, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device="cuda")
    k = torch.randn((b, skv, h, d), generator=g, device="cuda")
    v = torch.randn((b, skv, h, d), generator=g, device="cuda")
    mask = None
    if mask_kind == "shots":  # [own ‖ 5 shots], shots 4 and 5 padded
        s = sq
        mask = torch.ones((b, skv), dtype=torch.bool, device="cuda")
        mask[:, s * 4:] = False
    elif mask_kind == "attnmask":  # own keys kept; support keys by a {0,1} mask
        m = torch.rand((b, skv - sq), generator=g, device="cuda") > 0.5
        bias = torch.cat([torch.zeros((b, sq), device="cuda"), (1.0 - m.float()) * -1e4], 1)
        mask = bias >= -1e3
    return q, k, v, mask


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops.flash_attention import (flash_attention_lse,
                                                       flash_attention_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("kernel phase: TF32 off (torch.backends.cuda.matmul.allow_tf32 = False, "
         "torch.backends.cudnn.allow_tf32 = False); tolerances " + json.dumps(TOL))
    rows = []
    for i, (label, b, h, sq, skv, d, mk) in enumerate(KERNEL_SHAPES):
        q32, k32, v32, mask = _kernel_inputs(b, h, sq, skv, d, mk, seed=100 + i)
        skv_valid = skv if mask is None else mask.float().sum(1).mean().item()
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            out, lse = flash_attention_lse(q, k, v, kv_mask=mask)
            torch.cuda.synchronize()
            ref_o, ref_l = flash_attention_reference(q.float(), k.float(), v.float(),
                                                     scale=d ** -0.5, kv_mask=mask)
            err = (out.float() - ref_o).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            lse_err = (lse - ref_l).abs().max().item()
            check(bool(torch.isfinite(out.float()).all()), f"{label} {dt}: non-finite O")
            if dt == torch.float32:
                ok = max_err <= TOL["f32_abs"]
            else:
                ok = max_err <= TOL["bf16_max"] and mean_err <= TOL["bf16_mean"]
            ok = ok and lse_err <= TOL["lse"]
            ms = cuda_ms(lambda: flash_attention_lse(q, k, v, kv_mask=mask))
            plain_ms = cuda_ms(lambda: flash_attention_reference(
                q, k, v, scale=d ** -0.5, kv_mask=mask), reps=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            am = None if mask is None else mask[:, None, None, :]
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am))
            bound_ms, bound_by = _attn_bound_ms(b, h, sq, skv_valid, skv, d, q.element_size())
            row = {"shape": label, "dtype": str(dt).replace("torch.", ""), "B": b, "H": h,
                   "Sq": sq, "Skv": skv, "d": d, "mask": mk, "max_abs_err": max_err,
                   "mean_abs_err": mean_err, "lse_max_abs_err": lse_err, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "ok": ok}
            rows.append(row)
            emit(row)
            check(ok, f"kernel disagrees with the plain version at {label} {dt}: "
                      f"max {max_err:.3g} mean {mean_err:.3g} lse {lse_err:.3g}")
            del out, lse, ref_o, ref_l
        torch.cuda.empty_cache()
    RESULTS["kernel"] = rows
    return rows


def _episode(b, n, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    sup = rng.integers(0, 256, (b, n, s, s, 3), dtype=np.uint8)
    # blob-like masks: a random rectangle per shot
    m = np.zeros((b, n, s, s), np.uint8)
    for i in range(b):
        for j in range(n):
            y0, x0 = rng.integers(0, s // 2, 2)
            m[i, j, y0:y0 + s // 2, x0:x0 + s // 2] = 1
    return q, sup, m


def _uint8_close(a, b, what):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    frac = float((d != 0).mean())
    check(d.max() <= 1 and frac < 0.01,
          f"{what}: max uint8 diff {d.max()}, {frac:.4f} of pixels differ "
          "(allowed: <= 1 count on < 1% of pixels)")
    return int(d.max()), frac


def phase_tiny():
    import torch
    from diffews_tpu_torch.checkpoint import random_pipeline_bundle
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from diffews_tpu_torch.ops.flash_attention import flash_attention
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgs = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
            SchedulerConfig.diffews())
    out = {}
    for variant in (False, True):
        pipes = {dev: DiffewsPipeline(random_pipeline_bundle(*cfgs, seed=0),
                                      device=dev, attn_mask_variant=variant)
                 for dev in ("cpu", "cuda")}
        q, sup, m = _episode(2, 3, 32, seed=1)
        sm = np.array([[True, True, False], [True, True, True]])
        before = flash_attention.launches
        res = {dev: p.predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
               for dev, p in pipes.items()}
        launched = flash_attention.launches - before
        check(launched > 0, "tiny episode on the card launched no kernel")
        mx, frac = _uint8_close(res["cuda"].seg_colored, res["cpu"].seg_colored,
                                f"tiny GPU vs CPU (attn_mask_variant={variant})")
        flips = float((res["cuda"].mask != res["cpu"].mask).mean())
        check(flips < 0.01, f"tiny GPU vs CPU: {flips:.4f} of mask pixels flip")
        key = "attn_mask" if variant else "kv_fusion"
        out[key] = {"max_uint8_diff": mx, "frac_differ": frac, "mask_flips": flips,
                    "kernel_launches": launched}
    RESULTS["tiny"] = out
    emit({"phase": "tiny", "dtype": "float32", "tf32": False, **out})


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention_fwd"
    if "fprop" in n or "conv" in n or "cudnn" in n:
        return "conv (cuDNN)"
    if "gemm" in n or "cutlass" in n or "nvjet" in n or "cublas" in n:
        return "matmul (cuBLAS)"
    if "reduce" in n:
        return "reductions"
    return "elementwise/other"


def profile_episode(fn) -> dict:
    """Device time of one episode by kernel class (torch.profiler), and the
    device's idle share of the episode's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_class, by_name = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_class[_kernel_class(e.name)] = by_class.get(_kernel_class(e.name), 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy = sum(by_class.values())
    if busy == 0:
        return {"device_ms_by_class": "not measured (no device events)",
                "wall_ms_profiled": wall_ms}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "device_ms_by_class": {k: round(v, 3) for k, v in
                                   sorted(by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:80], round(v, 3)] for n, v in top]}


def phase_full(card):
    import torch
    from diffews_tpu_torch.checkpoint import random_pipeline_bundle
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from diffews_tpu_torch.ops.flash_attention import flash_attention
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.time()
    bundle = random_pipeline_bundle(UNetConfig.sd21(), VAEConfig.sd(),
                                    CLIPTextConfig.sd21(), SchedulerConfig.diffews(),
                                    seed=0, device="cuda")
    pipe = DiffewsPipeline(bundle, device="cuda", compute_dtype=torch.bfloat16)
    del bundle
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    res = {"setup_s": setup_s}

    # (a) 1-shot, batch 4
    q, sup, m = _episode(4, 1, 512, seed=2)
    warm = pipe.predict(q, sup, m, r_threshold=0.25)  # cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.time()
    out = pipe.predict(q, sup, m, r_threshold=0.25)
    wall = time.time() - t0
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == 34, f"1-shot predict launched the kernel {launches} times, not 34")
    walls = []
    for _ in range(3):
        t0 = time.time()
        pipe.predict(q, sup, m, r_threshold=0.25)
        walls.append(time.time() - t0)
    check(out.seg_colored.shape == (4, 512, 512, 3) and out.seg_colored.dtype == np.uint8,
          f"seg {out.seg_colored.shape} {out.seg_colored.dtype}")
    check(out.mask.shape == (4, 512, 512) and out.mask.dtype == bool, "mask shape/dtype")
    check(np.array_equal(warm.seg_colored, out.seg_colored), "repeat episode differs")
    with torch.inference_mode():
        x0 = pipe._x0_latent(*(pipe._put(x) for x in (q, sup, m)),
                             pipe.empty_text_embed, None, 1)
    check(tuple(x0.shape) == (4, 64, 64, 4) and bool(torch.isfinite(x0.float()).all()),
          f"x0 {tuple(x0.shape)} not finite")
    res["profile_1shot_b4"] = profile_episode(lambda: pipe.predict(q, sup, m, r_threshold=0.25))
    emit({"phase": "profile_1shot_b4_512px_bf16", **res["profile_1shot_b4"], "card": card})

    # yardstick for bf16 rounding that depends on the batch shape: the first
    # query of the batch-4 episode run alone
    one = pipe.predict(q[:1], sup[:1], m[:1], r_threshold=0.25)
    d1 = np.abs(one.seg_colored[0].astype(np.int32) - out.seg_colored[0].astype(np.int32))
    res["one_shot_b4"] = {
        "kernel_launches": launches, "wall_s_first": wall,
        "wall_s_median": statistics.median(walls), "peak_mem_gb": peak / 1e9,
        "mask_fraction": float(out.mask.mean()),
        "seg_mean": float(out.seg_colored.mean()),
        "b1_vs_b4_row0_max_uint8_diff": int(d1.max()),
        "b1_vs_b4_row0_frac_differ": float((d1 != 0).mean()), "card": card}
    emit({"phase": "full_1shot_b4_512px_bf16", **res["one_shot_b4"]})

    # (b) 5-shot, batch 1, shots 4 and 5 padded by shot_mask
    q5, sup5, m5 = _episode(1, 5, 512, seed=3)
    sm = np.array([[True, True, True, False, False]])
    pad = pipe.predict(q5, sup5, m5, shot_mask=sm, r_threshold=0.25)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe.predict(q5, sup5, m5, shot_mask=sm, r_threshold=0.25)
    wall5 = time.time() - t0
    peak5 = torch.cuda.max_memory_allocated()
    # same shapes, other content in the padded shots: bit-identical, so a
    # padded shot carries no weight
    sup_o, m_o = sup5.copy(), m5.copy()
    sup_o[:, 3:], m_o[:, 3:] = 255 - sup5[:, 3:], 1 - m5[:, 3:]
    other = pipe.predict(q5, sup_o, m_o, shot_mask=sm, r_threshold=0.25)
    check(np.array_equal(pad.seg_colored, other.seg_colored),
          "padded shots' content changed the bf16 prediction")
    # against the 3-shot episode of the same data: bf16 (reported; its batch
    # shapes differ, so rounding differs) and f32 with TF32 off (held)
    three = pipe.predict(q5, sup5[:, :3], m5[:, :3], r_threshold=0.25)
    d3 = np.abs(pad.seg_colored.astype(np.int32) - three.seg_colored.astype(np.int32))
    del pipe
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = random_pipeline_bundle(UNetConfig.sd21(), VAEConfig.sd(),
                                    CLIPTextConfig.sd21(), SchedulerConfig.diffews(),
                                    seed=0, device="cuda")
    pipe32 = DiffewsPipeline(bundle, device="cuda", compute_dtype=torch.float32)
    del bundle
    pad32 = pipe32.predict(q5, sup5, m5, shot_mask=sm, r_threshold=0.25)
    three32 = pipe32.predict(q5, sup5[:, :3], m5[:, :3], r_threshold=0.25)
    mx, frac = _uint8_close(pad32.seg_colored, three32.seg_colored,
                            "f32 5-shot with 2 padded shots vs 3-shot")
    flips = float((pad32.mask != three32.mask).mean())
    check(flips < 0.01, f"f32 padded vs 3-shot: {flips:.4f} of mask pixels flip")
    res["five_shot_padded_b1"] = {
        "bf16_padded_content_invariant": True,
        "bf16_max_uint8_diff_vs_3shot": int(d3.max()),
        "bf16_frac_differ_vs_3shot": float((d3 != 0).mean()),
        "f32_max_uint8_diff_vs_3shot": mx, "f32_frac_differ_vs_3shot": frac,
        "f32_mask_flips_vs_3shot": flips, "bf16_wall_s": wall5,
        "bf16_peak_mem_gb": peak5 / 1e9, "card": card}
    emit({"phase": "full_5shot_2padded_b1_512px", **res["five_shot_padded_b1"]})
    RESULTS["full"] = res
    return launches


def kernel_record(rows, launches):
    main = [r for r in rows if r["shape"] == MAIN_SHAPE and r["dtype"] == "bfloat16"][0]
    return {"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "diffews_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "diffews_tpu/ops/flash_attention.py:73",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"]}]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,build,kernel,tiny,full",
                    help="comma-separated subset of the phases (all by default)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    t_start = time.time()
    card = phase_device()
    if "build" in phases:
        phase_build()
    rows = phase_kernel() if "kernel" in phases else []
    if "tiny" in phases:
        phase_tiny()
    launches = phase_full(card) if "full" in phases else None
    RESULTS["seconds"] = time.time() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)
    if rows and launches is not None:
        emit(kernel_record(rows, launches))
    else:
        fail(f"phases {sorted(phases)} ran; the kernel record needs kernel and full")
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
