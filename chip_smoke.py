#!/usr/bin/env python3
"""Drive the PyTorch port (`diffews_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. device: the card's name and power limit (`nvidia-smi`);
  2. build: compile every `diffews_tpu_torch/ops/csrc/*.cu` with nvcc (one
     process each, started together), print ptxas's registers/spills,
     and report the wgmma kernels' (bf16: flash forward, backward dq and
     dkv, fused conv, downsample; int8: the W8A8 conv) registers, shared
     memory and their SASS's wgmma (HGMMA bf16, IGMMA int8), TMA (UTMALDG)
     and mma.sync (HMMA, IMMA) instructions; the fused-conv and downsample
     libraries must hold HGMMA and UTMALDG and no HMMA, the int8 library
     IGMMA and UTMALDG and no IMMA;
  3. kernel: the flash-attention forward kernel against its plain version
     at every shape a 512px episode gives it, in f32 (TF32 off) and bf16,
     O and LSE, with kernel / plain / `F.scaled_dot_product_attention`
     times (kernel and SDPA: ten calls back to back between CUDA events),
     TFLOP/s over the valid keys and the share of the bound;
  4. bwd: the backward kernels (dq, dkv) against their plain version at
     every shape a B = 1, 1-shot, 512px training micro-step gives them,
     plus the 5-shot padded and attn-mask query shapes, f32 (TF32 off) and
     bf16, masked keys' dK / dV exactly zero, bf16 repeats bit-identical,
     with dq / dkv / whole-call (δ included) / plain / SDPA-backward times
     (the whole call and SDPA's backward also as device time alone, from
     the profiler) and the bounds;
  5. norm: the GroupNorm kernels (stats, apply) against their plain version
     at every GroupNorm+SiLU shape of a 1-shot batch-4 512px episode
     (recorded from the episode itself), f32 (TF32 off) and bf16, with
     kernel / plain / `F.group_norm` + `F.silu` times and the byte bounds;
  6. fused: the fused GroupNorm-apply + SiLU + 3x3 conv kernel against its
     plain version at every shape the fused VAE gives it at 512px (encode
     B = 12, decode B = 4), f32 (TF32 off) and bf16, statistics against a
     fresh sum of its output, bit-identical repeats, with kernel / plain /
     cuDNN `F.conv2d` times, TFLOP/s and the share of the bound;
  7. downsample: the 3x3 stride-2 downsample kernel through its entry point
     `downsample_conv2x` on the inputs and weights of the VAE encoder's
     three Downsample2D, recorded from the encoder of a 512px episode at
     B = 12 (1-shot batch 4) and B = 3 (batch 1): the three B = 12 calls
     counted and held against the encoder's own outputs, then kernel
     against plain version in f32 (TF32 off) and bf16, each image alone
     against its batch row, bit-identical repeats, with kernel / plain /
     cuDNN (`F.pad` + `F.conv2d`) times, TFLOP/s and the share of the
     bound;
  7b. adamw: the multi-tensor clip -> AdamW -> apply_if_finite kernels
     (`ops/adamw.py`) at the SD-2.1 UNet's 688 leaves (865.9 M float32
     masters, 4-D ones channels-last, bf16 first moment, clipped): the
     update against the plain version bit for bit given the same norm, the
     norm within 1e-6 of the plain one; device times (CUDA events) of the
     norm pass, the apply pass, the whole kernel update and the plain
     update, the kernel update's host time, its CUDA launch calls (the
     profiler's runtime calls) and port launches a step, the byte bound,
     and `torch.optim.AdamW(fused=True)` over the same leaves (no clip, f32
     moments) as the yardstick;
  8. tiny: tiny-config f32 episodes on the card (kernels) against the same
     episodes on the CPU (plain versions), under `vae_impl` "xla",
     "fused", "mixed" (threshold lowered) and "auto"; and cached-support
     serving (`precompute_supports` + `predict_cached`) on the card against
     the CPU and against `predict`, both conditioning variants, padded
     shots, a batch-1 cache under a batch-3 query;
  9. tiny_train: two tiny f32 training steps at gas 2 on the card against
     the same steps on the CPU, both conditioning variants;
 10. full: random-weight SD-2.1 UNet (8-ch `conv_in_ref`), SD VAE and
     OpenCLIP ViT-H text tower at their published widths, bf16, 512px:
     the 1-shot batch-4 episode under `vae_impl` "xla" (34 flash, 94 + 94
     GroupNorm launches per `predict`), "fused" (44 + 44 GroupNorm, 50
     fused) and "mixed", and a batch-1 episode under "auto", each timed and
     profiled, with each one's device busy and fused-conv device time;
     `predict_async`'s host time per b4 episode through the custom ops
     (`torch.ops.diffews_tpu_torch.*`) against the launchers called
     directly, in turns (the same prediction); b1
     "auto" against b1 "xla" in turns, three runs each (walls, busy); a
     5-shot episode with two padded shots against the 3-shot episode,
     under "xla" and "fused"; the f32 (TF32 off) fused-vs-xla VAE encode
     and decode;
 11. depth: the depth head (`predict_depth`): (a) tiny f32 (TF32 off)
     depth episodes on the card against the CPU under `vae_impl` "xla",
     "fused", "mixed", "auto" (batch 1) and "int8" (the CPU's codes fed
     forward past ties), with and without a resize, within
     `tests/helpers/depth_check.py`'s contract (raw map 5e-5 + 1e-4 rel,
     `depth_np` 1e-4 / range, the colourised map on < 1% of pixels by at
     most one colormap step); (b) full width, bf16, 512px, phase full's
     weights and episode: 1-shot b4 under "xla" and "auto" and b1 under
     "auto", each with phase full's launches (34 flash, 94 + 94 GroupNorm
     under "xla"), a bit-identical repeat, the raw map equal bit for bit
     to the channel mean of `vae.decode(_x0_latent(...))` recomputed; the
     bilinear resize to 375x500 on the card against the CPU function
     (1e-6); two padded shots of a 5-shot b1 episode change no bit;
     `predict_depth` against `predict` in turns (walls, busy, idle); (c)
     the utils on the card: `find_batch_size` reads its memory (the 32
     GiB row), `profiling.trace` of a depth episode names the flash
     forward kernel, `StageTimer` waits for the card; (d) the port's CLIs
     on a tiny tree with `--device cuda`: `verify_parity --skip_golden`'s
     mIoU equals the eval CLI's, `measure_baseline --subject self`
     reports its rate;
 12. int8: W8A8 (`vae_impl="int8"`, `unet_int8`) at the same widths: (a)
     the int8 kernels (`quantize_s8`, `conv2d_int8`) against their plain
     versions bit for bit at every int8 conv shape of the 1-shot b4
     episode (recorded from it: encoder B = 12, decoder B = 4, the three
     stride-2 downsamples, Cout 3 and 8), bf16 and f32, static and dynamic
     scales, repeats bit-identical, with kernel / plain / cuDNN bf16 conv
     times, TOP/s and the share of the bound; (b) the pipeline's int8
     weights (56 convs, 128 linears) quantized on the card equal the CPU's
     bit for bit; (c) the bf16 episodes under "int8" and "int8" +
     `unet_int8` with exact launches, beside "xla" in turns (walls, busy,
     idle, masks against "xla"'s); (d) `precompute_supports` +
     `predict_cached` under both (exact launches, a batch-1 cache equal to
     its 4 copies), and in f32 (TF32 off) under `unet_int8` cached against
     joint within the cached contract with the joint run's int8 codes fed
     forward past quantizer ties; (e) tiny f32 episodes card against CPU
     (the CPU's codes fed forward); (f) the `--vae_impl int8` artifact
     exported on the card equal to `predict` bit for bit;
 13. eval: the eval harness (`diffews_tpu_torch.cli.evaluate`) on a
     synthetic COCO tree (`tests/helpers/synthetic_data.make_coco`): the CLI
     from a tiny checkpoint written from the port's seeded modules
     (`tests/helpers/port_checkpoint.py`) on the card and on the CPU, f32
     with TF32 off, 8 episodes at 32px under `vae_impl` "xla" and "auto"
     (equal mIoU and FB-IoU, every episode within the episode contract);
     then `evaluate(args, pipe=...)` with the full-width bf16 pipeline at
     512px, 1-shot, 8 batches at bsz 4 and at bsz 1: every batch's
     launches (34 flash, 94 + 94 GroupNorm under "xla") and its prediction
     bit for bit equal to a bare `predict` on the same batch; dispatch-ahead
     2 and 1 (and 2 with two loader workers) give identical metrics;
     the query upload returns while a spin kernel holds the device (it
     does not wait for the device); episodes/s of each, the bare `predict` loop's
     wall on the same batches, the loader's seconds per batch,
     `predict_async`'s host time, and one profiled run's device busy and
     idle share;
 14. cached: cached-support serving at the same widths, bf16, 512px, under
     `vae_impl` "xla" and "auto": `precompute_supports` for a 1-shot and a
     5-shot (two padded) support set (33 flash launches each) and
     `predict_cached` at batch 4 and 1 (18 flash launches), each with exact
     launch counts, times, a profile and peak memory; the cache's size; in
     bf16 a repeat is bit-identical, padded shots' content changes no bit
     and a batch-1 cache equals its four copies; in f32 (TF32 off) cached
     equals the joint episode within one uint8 count;
 15. serve: the serving daemon (`diffews_tpu_torch.cli.serve`) and the AOT
     serving artifact (`diffews_tpu_torch.serving`): (a) tiny f32 daemons
     from a port-written checkpoint on the card and on the CPU under
     `vae_impl` "xla" and "auto" (one-off, supports.add + cached, four
     single-query requests coalesced by the card's micro-batcher) within
     the episode contract; (b) the full-width bf16 daemon (bsz 4, 1-shot,
     buckets 1,2,4, `warm_start` timed) over HTTP: a one-off b4 request
     (34 flash, 94 + 94 GroupNorm) equal to a bare `predict`, supports.add
     (33 / 65 + 65), cached b4 and b1 requests (18 / 94 + 94) equal to
     `predict_cached`, bit for bit; load with `tools/cuda_serve_bench.py`
     (16 clients x 2 (window 0) or 4 (window 30 ms) cached single-query
     requests, PNG and raw; depth 1 and 2; 4 clients x 6 one-off
     requests): q/s,
     `/v1/stats` p50 / p99, device-lock occupancy, one profile, the
     micro-batcher replayed without HTTP, the bare `predict_cached` rate at
     b4 and b1; a cold daemon's first cached request; (c) the full-width
     b4 artifact exported on the card (seconds, bytes), loaded in a fresh
     process that imports only `diffews_tpu_torch.serving` and here: 34 /
     94 + 94 launches per call, equal to `predict` bit for bit, served by a
     daemon in artifact mode (supports.add 400), its wall against
     `predict`'s in turns;
 16. train: the training step at the same widths (bf16 compute, f32
     masters, remat, AdamW): launches per micro-step (65 flash forward, 32
     dq, 32 dkv, 109 + 109 GroupNorm), step times at gas 1 and 4, peak
     memory, a profile (and the micro-step's forward and backward flash
     ms), the f32 kernel path against the dense path,
     padded-shot invariance of loss and gradients, and the attn-mask
     variant's decaying `conv_in_ref`;
 17. train_cli: the training CLI (`diffews_tpu_torch.cli.train`) on a
     synthetic COCO tree: (a) tiny f32 (TF32 off) runs from a checkpoint
     written by the port's savers, the card against the CPU (losses per
     step from `--metrics_jsonl` within rtol 1e-4, checkpoint-4's weights
     under phase tiny_train's rule), also with `--lora_rank 2 --use_ema`,
     and a preemption after step 3 plus a `latest` resume bit for bit equal
     to the straight run on the card; (b) full width, bf16, 512px, 1-shot
     b1: a seeded SD-2.1 / SD-VAE / ViT-H checkpoint written by the savers
     (seconds, bytes), 3 steps with checkpoints at 2 and 3 and validation
     at 2 (each step 65 flash / 32 dq / 32 dkv / 109 + 109 GroupNorm, each
     validation episode 34 / 94 + 94), then checkpoint-2 resumed in a fresh
     directory under the CLI's own `cudnn.deterministic`: checkpoint-3 and
     the step-3 loss bit for bit equal, and the process's setting put back
     after each run; 2 steps without the setting (its cost in step wall); step walls, snapshot and write seconds and bytes,
     load and resume seconds, peak memory; (c) LoRA rank 8 on the
     attention projections, 2 steps: the same launches, `unet/` float32
     and different from the base exactly at the adapted sites; (d)
     `tools/torch_train_capability.py` at the CI-bound 60 steps / 200 VAE
     steps / 16 episodes under its pass rule;
 18. multi: multi-device serving and training (`diffews_tpu_torch.parallel`)
     on the one card, each group of ranks started by `torchrun` (any
     rank's failure fails the run): (a) 2 ranks over gloo (its all_reduce
     takes CUDA tensors; NCCL refuses two ranks on one device), a
     ("shots",) mesh, the full-width 2-shot batch-1 512px episode: in f32
     (TF32 off) the x0 latent within 2e-3 of max|single-process| and the
     uint8 mask within one count on < 1% of pixels; in bf16 both ranks'
     masks equal bit for bit, a repeat bit-identical, a 1-valid + 3-padded
     episode (rank 1 holds padded shots only) finite and unchanged by the
     padded shots' content, per rank the single-process episode's
     launches and 16 log-sum-exp merges, the sharded wall beside the
     single-process one; (b) two tiny f32 data-parallel steps at gas 2
     over gloo against the same steps on the whole batch in one process
     (phase tiny_train's rules), and the full-width bf16 train CLI with
     `--num_data_shards 2` (b1 a rank; the smoke builds the CLI's data
     mesh on gloo), 2 steps: launches, losses, step walls, each rank's
     peak memory; (c) NCCL at world size 1, in a fresh process: the eval
     CLI run plainly, then with `--num_data_shards 1`, then plainly again
     (equal metrics, warm walls); then the train CLI with
     `--num_data_shards 1 --fsdp` (launches, step walls beside the plain
     CLI's); (d) tensor parallelism on 2 ranks over gloo (a ("data",
     "model") mesh of 1 x 2): two tiny f32 (TF32 off) steps on a state born
     tensor-parallel against the same steps in one process (phase
     tiny_train's rules), and the full-width bf16 train CLI with
     `--num_model_shards 2`, 1-shot b1, 2 steps: per rank the single CLI's
     launches a micro-step (65 / 32 / 32 / 109 + 109, the flash kernels at
     3 + 2, 5 + 5 and 10 + 10 heads) and 162 all_reduces (asserted), their
     bytes, step walls, peak memory beside the DP run's; (e) the sharded
     daemon at full width, bf16, 2 ranks over gloo: `--num_data_shards 2`
     at bsz 4 (one-off, supports.add, cached) and `--num_shot_shards 2` at
     nshot 2 (one-off; `/v1/supports` 400): each answer equal to the bare
     pipeline call on the same mesh bit for bit, rank 0's launches a
     request the single daemon's, each follower's over the session equal
     to rank 0's, healthz's mesh JAX's, q/s.  (b)'s CLI, (d)'s CLI and (e)
     run in one torchrun, in turn.  Phases eval and serve run at 8 batches
     and 2 / 4 requests a client to make room for (d) and (e).

Every line before the last is plain text or JSON; the last line is
`{"ok": true, "device": {...}}`.  Detailed results also go to
`chiprun_out/chip_smoke.json`.  `--phases` runs a subset (for debugging).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # H100 SXM dense tensor-core FLOP/s
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
MEM_BW = 3.35e12     # H100 SXM HBM3 bytes/s
TOL = {"f32_abs": 2e-4, "bf16_max": 2e-2, "bf16_mean": 2e-3, "lse": 1e-3}
# GroupNorm and fused-resnet kernels against their plain versions, relative
# to max|plain|: f32 (TF32 off) max; bf16 max and mean; statistics against
# a fresh sum of the kernel's own output, relative to Σ|y| and Σy²
OP_TOL = {"f32_max": 1e-4, "bf16_max": 2e-2, "bf16_mean": 2e-3, "stats": 1e-5}
RESULTS: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 5, warmup: int = 2, inner: int = 1) -> float:
    """Median device time of `fn()` in ms: CUDA events around `inner` calls
    back to back, over `inner`.  With inner > 1 the host's launch time of
    one call hides behind the device time of the one before it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
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
    report = [f"[{name}] {line.strip()}" for name, log in logs.items()
              for line in log.splitlines()
              if "registers" in line or "spill" in line or "Compiling" in line]
    for line in report:
        print(line, flush=True)
    RESULTS["build_s"] = secs
    RESULTS["build_report"] = report
    emit({"phase": "build", "sources": _build.sources(), "seconds": round(secs, 2)})
    RESULTS["flash_fwd_build"] = fwd = flash_resources(_build, "flash_attention_fwd")
    emit({"phase": "build_flash_fwd", **fwd})
    check(fwd["sass"].get("HGMMA", 0) > 0 or fwd["sass"] == {},
          f"the flash forward library holds no HGMMA: {fwd['sass']}")
    RESULTS["flash_bwd_build"] = bwd = flash_resources(_build, "flash_attention_bwd")
    emit({"phase": "build_flash_bwd", **bwd})
    check(bwd["sass"] == {} or (bwd["sass"]["HGMMA"] > 0 and bwd["sass"]["UTMALDG"] > 0
                                and bwd["sass"]["HMMA"] == 0),
          f"the flash backward library must hold HGMMA and UTMALDG and no HMMA: {bwd['sass']}")
    for name in ("fused_resnet", "downsample"):
        RESULTS[f"{name}_build"] = conv = flash_resources(_build, name)
        emit({"phase": f"build_{name}", **conv})
        check(conv["sass"] == {} or (conv["sass"]["HGMMA"] > 0 and conv["sass"]["UTMALDG"] > 0
                                     and conv["sass"]["HMMA"] == 0),
              f"the {name} library must hold HGMMA and UTMALDG and no HMMA: {conv['sass']}")
    # the int8 conv: wgmma s8 (IGMMA) fed by TMA, no mma.sync (IMMA)
    RESULTS["quant_int8_build"] = i8 = flash_resources(_build, "quant_int8")
    emit({"phase": "build_quant_int8", **i8})
    check(i8["sass"] == {} or (i8["sass"]["IGMMA"] > 0 and i8["sass"]["UTMALDG"] > 0
                               and i8["sass"]["IMMA"] == 0),
          f"the quant_int8 library must hold IGMMA and UTMALDG and no IMMA: {i8['sass']}")


def flash_resources(_build, name: str) -> dict:
    """A library's bf16 wgmma kernels' registers a thread at launch, dynamic
    shared memory and threads per CTA (from the library:
    `flash_attention_fwd_info` at each head dim, `flash_attention_bwd_info`
    for dq and dkv, `fused_resnet_info` for BN 128 and the heads' BN 8,
    `downsample_info`, `conv2d_int8_info` for stride 1 and 2 at BN 128 and
    the heads' BN 8), and the counts of wgmma (HGMMA bf16, IGMMA int8),
    TMA-load (UTMALDG) and mma.sync (HMMA, IMMA) instructions in its SASS
    (`cuobjdump -sass`, where the toolkit has it; else {})."""
    import ctypes
    import shutil

    lib = _build.load(name)
    res = {}
    if name == "flash_attention_fwd":
        calls = {f"d{d}": (lambda *r, d=d: lib.flash_attention_fwd_info(d, *r))
                 for d in (16, 32, 64, 512)}
    elif name == "flash_attention_bwd":
        calls = {f"{kind}_d{d}": (lambda *r, d=d, i=i: lib.flash_attention_bwd_info(d, i, *r))
                 for i, kind in enumerate(("dq", "dkv")) for d in (16, 32, 64)}
    elif name == "fused_resnet":
        calls = {f"bn{bn}": (lambda *r, i=i: lib.fused_resnet_info(i, *r))
                 for i, bn in enumerate((128, 8))}
    elif name == "quant_int8":
        calls = {key: (lambda *r, i=i: lib.conv2d_int8_info(i, *r))
                 for i, key in enumerate(("s1_bn128", "s2_bn128", "s1_bn8", "s2_bn8"))}
    else:
        calls = {"bn128": lambda *r: lib.downsample_info(0, *r)}
    for key, call in calls.items():
        regs, smem, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = call(ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(threads))
        check(err == 0, f"{name} info ({key}) failed: CUDA error {err}")
        res[key] = {"registers_at_launch": regs.value, "dynamic_smem_bytes": smem.value,
                    "threads": threads.value}
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = {}
    if os.path.exists(cuobjdump):
        out = subprocess.run([cuobjdump, "-sass", str(_build._target(name))],
                             capture_output=True, text=True, timeout=120).stdout
        sass = {op: len(re.findall(rf"\b{op}\b", out))
                for op in ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")}
    return {"kernels": res, "sass": sass}


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
            # ten calls between events: a single call's time would carry the
            # wrapper's host time (~0.1 ms), as large as the small shapes'
            ms = cuda_ms(lambda: flash_attention_lse(q, k, v, kv_mask=mask), inner=10)
            plain_ms = cuda_ms(lambda: flash_attention_reference(
                q, k, v, scale=d ** -0.5, kv_mask=mask), reps=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            am = None if mask is None else mask[:, None, None, :]
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am),
                             inner=10)
            bound_ms, bound_by = _attn_bound_ms(b, h, sq, skv_valid, skv, d, q.element_size())
            tflops = 4.0 * b * h * sq * skv_valid * d / (ms * 1e-3) / 1e12
            row = {"shape": label, "dtype": str(dt).replace("torch.", ""), "B": b, "H": h,
                   "Sq": sq, "Skv": skv, "d": d, "mask": mk, "max_abs_err": max_err,
                   "mean_abs_err": mean_err, "lse_max_abs_err": lse_err, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "tflops_valid_keys": tflops,
                   "share_of_bound": bound_ms / ms, "ok": ok}
            rows.append(row)
            emit(row)
            check(ok, f"kernel disagrees with the plain version at {label} {dt}: "
                      f"max {max_err:.3g} mean {mean_err:.3g} lse {lse_err:.3g}")
            del out, lse, ref_o, ref_l
        torch.cuda.empty_cache()
    RESULTS["kernel"] = rows
    return rows


# (label, B, H, Sq, Skv, d, mask kind): every shape a B = 1, 1-shot, 512px
# training micro-step gives the backward kernels (support rows attend over
# their own tokens, query rows over [own ‖ support]), and the 5-shot padded
# and attn-mask query shapes.
BWD_SHAPES = [
    ("unet64_support", 1, 5, 4096, 4096, 64, None),
    ("unet64_query_1shot", 1, 5, 4096, 8192, 64, None),
    ("unet32_support", 1, 10, 1024, 1024, 64, None),
    ("unet32_query_1shot", 1, 10, 1024, 2048, 64, None),
    ("unet16_support", 1, 20, 256, 256, 64, None),
    ("unet16_query_1shot", 1, 20, 256, 512, 64, None),
    ("unet8_mid_support", 1, 20, 64, 64, 64, None),
    ("unet8_mid_query_1shot", 1, 20, 64, 128, 64, None),
    ("unet64_query_5shot_2padded", 1, 5, 4096, 24576, 64, "shots"),
    ("unet64_query_attnmask", 1, 5, 4096, 8192, 64, "attnmask"),
]
BWD_MAIN_SHAPE = "unet64_query_1shot"
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # max |kernel − plain| / max |plain|


def _bwd_bound_ms(kind, b, h, sq, skv_valid, skv, d, elt, masked):
    """Least time for one backward kernel: dq does 6·B·H·Sq·Skv_valid·d
    FLOPs, dkv 8·; both read q, k, v, g (input dtype), LSE and δ (f32) and
    the mask once; dq writes dQ, dkv dK and dV."""
    flops = (6.0 if kind == "dq" else 8.0) * b * h * sq * skv_valid * d
    peak = PEAK_BF16 if elt == 2 else PEAK_F32
    nbytes = ((2 * b * sq * h * d + 2 * b * skv * h * d) * elt + 2 * b * sq * h * 4
              + (b * skv if masked else 0)
              + (b * sq * h * d if kind == "dq" else 2 * b * skv * h * d) * elt)
    t_ops, t_mem = flops / peak, nbytes / MEM_BW
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def _device_ms_per_call(fn, calls: int = 10):
    """Device time of one `fn()`: the profiler's sum of kernel times over
    `calls` calls after a warm-up, over `calls` (None if it sees none)."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof = profile_episode(lambda: [fn() for _ in range(calls)])
    busy = prof.get("device_busy_ms")
    return None if busy is None else busy / calls


def phase_bwd():
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                       flash_attention_bwd_dkv,
                                                       flash_attention_bwd_dq,
                                                       flash_attention_bwd_reference,
                                                       flash_attention_lse)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("bwd phase: TF32 off; tolerance max|kernel - plain| / max|plain| "
         + json.dumps(BWD_TOL))
    rows = []
    for i, (label, b, h, sq, skv, d, mk) in enumerate(BWD_SHAPES):
        q32, k32, v32, mask = _kernel_inputs(b, h, sq, skv, d, mk, seed=200 + i)
        g32 = torch.randn(q32.shape, generator=torch.Generator(device="cuda").manual_seed(i),
                          device="cuda")
        skv_valid = skv if mask is None else mask.float().sum(1).mean().item()
        scale = d ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = (x.to(dt) for x in (q32, k32, v32, g32))
            out, lse = flash_attention_lse(q, k, v, kv_mask=mask)
            got = flash_attention_bwd(q, k, v, out, lse, g, scale=scale, kv_mask=mask)
            want = flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask,
                                                 out.float(), lse, g.float(), scale)
            torch.cuda.synchronize()
            name = str(dt).replace("torch.", "")
            rel, absd = {}, {}
            for key, a, r in zip(("dq", "dk", "dv"), got, want):
                check(bool(torch.isfinite(a.float()).all()), f"{label} {name}: non-finite {key}")
                err = (a.float() - r).abs().max().item()
                absd[key], rel[key] = err, err / max(r.abs().max().item(), 1e-30)
            zero_masked = True
            if mask is not None:
                dead = ~mask[:, :, None, None].expand_as(got[1])
                zero_masked = bool((got[1][dead] == 0).all() and (got[2][dead] == 0).all())
            del want
            again = flash_attention_bwd(q, k, v, out, lse, g, scale=scale, kv_mask=mask)
            repeat_same = all(torch.equal(a, r) for a, r in zip(got, again))
            del again
            stats = flash_attention_bwd_dq(q, k, v, g, out, lse, scale=scale, kv_mask=mask)[1]
            # ten calls back to back between events, here and for SDPA's
            # backward: one call alone would carry the wrapper's host time
            dq_ms = cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, g, out, lse, scale=scale,
                                                           kv_mask=mask), inner=10)
            dkv_ms = cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, g, stats, scale=scale,
                                                             kv_mask=mask), inner=10)
            # the whole call (δ, dq, dkv): the fair comparison with SDPA's backward
            bwd_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, g, scale=scale,
                                                         kv_mask=mask), inner=10)
            plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
                q, k, v, mask, out, lse, g, scale), reps=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            am = None if mask is None else mask[:, None, None, :]
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
            gt = g.transpose(1, 2)
            lib_call = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), gt, retain_graph=True)
            lib_ms = cuda_ms(lib_call, inner=10)
            # device time alone (the profiler's kernel time over ten calls): SDPA's
            # backward through autograd carries more host time than the device
            # needs below the largest shapes, so events time its host path there
            lib_dev_ms = _device_ms_per_call(lib_call)
            bwd_dev_ms = _device_ms_per_call(lambda: flash_attention_bwd(
                q, k, v, out, lse, g, scale=scale, kv_mask=mask))
            del o_lib, qt, kt, vt
            bounds = {kind: _bwd_bound_ms(kind, b, h, sq, skv_valid, skv, d, q.element_size(),
                                          mask is not None) for kind in ("dq", "dkv")}
            ok = max(rel.values()) <= BWD_TOL[name] and zero_masked and repeat_same
            row = {"shape": label, "dtype": name, "B": b, "H": h, "Sq": sq, "Skv": skv,
                   "Skv_valid": skv_valid, "d": d, "mask": mk, "rel_err": rel,
                   "max_abs_err": absd, "masked_keys_zero": zero_masked,
                   "repeat_bit_identical": repeat_same, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
                   "bwd_ms": bwd_ms, "bwd_device_ms": bwd_dev_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                   "dq_bound_ms": bounds["dq"][0],
                   "dq_bound_by": bounds["dq"][1], "dkv_bound_ms": bounds["dkv"][0],
                   "dkv_bound_by": bounds["dkv"][1], "ok": ok}
            rows.append(row)
            emit(row)
            check(ok, f"backward kernels disagree with the plain version at {label} {name}: "
                      f"{rel}, masked keys zero: {zero_masked}, repeat: {repeat_same}")
            del got, out, lse, stats
        torch.cuda.empty_cache()
    RESULTS["bwd"] = rows
    return rows


def _full_bundle(**kw):
    from diffews_tpu_torch.checkpoint import random_pipeline_bundle
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)

    return random_pipeline_bundle(UNetConfig.sd21(), VAEConfig.sd(), CLIPTextConfig.sd21(),
                                  SchedulerConfig.diffews(), seed=0, device="cuda", **kw)


def episode_shapes():
    """The GroupNorm+SiLU shapes of a 1-shot batch-4 512px bf16 episode
    under `vae_impl="xla"` and the fused-resnet shapes under "fused", as
    the episode gives them: one full-width episode each with recorders in
    place of the two ops, which compute the plain versions meanwhile.  Also
    the inputs, weights and outputs of the VAE encoder's three Downsample2D
    in the first episode (B = 12) and in a batch-1 episode (B = 3)."""
    import torch
    from diffews_tpu_torch.models import layers
    from diffews_tpu_torch.ops import fused_resnet, groupnorm
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    gn, gn_fused, fr, down = {}, {}, {}, []
    rec = {"gn": gn}

    def down_rec(module, inputs, output):
        down.append({"x": inputs[0].detach(), "w": module.conv.weight.detach(),
                     "bias": module.conv.bias.detach(), "y": output.detach()})

    def gn_rec(x, weight, bias, *, groups, eps, act=None, impl="auto"):
        key = (tuple(x.shape), groups)
        rec["gn"][key] = rec["gn"].get(key, 0) + 1
        return groupnorm.group_norm_act_reference(x, weight, bias, groups=groups, eps=eps,
                                                  act=act)

    def fr_rec(x, a, b, w, bias, residual=None, *, impl="auto"):
        key = tuple(x.shape) + (w.shape[0], residual is not None)
        fr[key] = fr.get(key, 0) + 1
        return fused_resnet.gn_silu_conv3x3_reference(x, a, b, w, bias, residual)

    saved = (layers.group_norm_act, fused_resnet.gn_silu_conv3x3)
    layers.group_norm_act, fused_resnet.gn_silu_conv3x3 = gn_rec, fr_rec
    try:
        pipe = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.bfloat16)
        q, sup, m = _episode(4, 1, 512, seed=2)
        hooks = [blk.downsamplers[0].register_forward_hook(down_rec)
                 for blk in pipe.vae.encoder.down_blocks if hasattr(blk, "downsamplers")]
        pipe.predict(q, sup, m)
        rec["gn"] = {}  # the batch-1 episode's GroupNorm shapes are not kept
        pipe.predict(q[:1], sup[:1], m[:1])
        for hook in hooks:
            hook.remove()
        pipe.vae_impl, rec["gn"] = "fused", gn_fused
        pipe.predict(q, sup, m)
        n_gn, n_gn_fused = sum(gn.values()), sum(gn_fused.values())
    finally:
        layers.group_norm_act, fused_resnet.gn_silu_conv3x3 = saved
    del pipe
    torch.cuda.empty_cache()
    check(n_gn == 94 and n_gn_fused == 44 and sum(fr.values()) == 50,
          f"episode sites: {n_gn} GroupNorm+SiLU (xla VAE; expected 94), {n_gn_fused} "
          f"(fused VAE; 44), {sum(fr.values())} fused convs (50)")
    check([tuple(d["x"].shape) for d in down] == [
        (b, 512 >> i, 512 >> i, c) for b in (12, 3) for i, c in enumerate((128, 256, 512))],
        f"the encoder's downsamples saw {[tuple(d['x'].shape) for d in down]}")
    return gn, fr, down


def _op_errors(got, want, dtype):
    """max |got − want|, and max and mean |got − want| relative to
    max|want|, and whether they are within OP_TOL for the dtype."""
    import torch

    err = (got.float() - want.float()).abs()
    top = max(want.float().abs().max().item(), 1e-30)
    mx, mean = err.max().item() / top, err.mean().item() / top
    ok = bool(torch.isfinite(got.float()).all())
    if dtype == "float32":
        ok = ok and mx <= OP_TOL["f32_max"]
    else:
        ok = ok and mx <= OP_TOL["bf16_max"] and mean <= OP_TOL["bf16_mean"]
    return err.max().item(), mx, mean, ok


def _stats_rel(y, s1, s2):
    """The larger of |s1 − Σy| / Σ|y| and |s2 − Σy²| / Σy² over (b, c), the
    sums of y taken in f64; and the largest of |s1 − Σy|, |s2 − Σy²|."""
    yf = y.double()
    d1 = (s1.double() - yf.sum((1, 2))).abs()
    sq = yf.square().sum((1, 2))
    d2 = (s2.double() - sq).abs()
    e1 = (d1 / yf.abs().sum((1, 2)).clamp_min(1e-30)).max().item()
    e2 = (d2 / sq.clamp_min(1e-30)).max().item()
    return max(e1, e2), max(d1.max().item(), d2.max().item())


NORM_MAIN_SHAPE = (12, 512, 512, 128)  # the VAE encoder's first resnets


def phase_norm(gn_shapes):
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops import groupnorm as G
    from diffews_tpu_torch.ops.fused_resnet import gn_affine, gn_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("norm phase: TF32 off; tolerances relative to max|plain| " + json.dumps(OP_TOL))
    rows = []
    for i, ((shape, groups), sites) in enumerate(sorted(gn_shapes.items())):
        bsz, h, w, c = shape
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        x32 = torch.randn(shape, generator=g, device="cuda") * 1.5 + 0.3
        w32 = torch.rand((c,), generator=g, device="cuda") + 0.5
        b32 = torch.randn((c,), generator=g, device="cuda") * 0.1
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            x, wt, bt = x32.to(dt), w32.to(dt), b32.to(dt)
            y = G.group_norm_act(x, wt, bt, groups=groups, eps=1e-6, act="silu")
            want = G.group_norm_act_reference(x, wt, bt, groups=groups, eps=1e-6, act="silu")
            s1, s2 = G.gn_stats_kernel(x)
            torch.cuda.synchronize()
            err, mx, mean, ok = _op_errors(y, want, name)
            srel, serr = _stats_rel(x, s1, s2)
            same = torch.equal(y, G.group_norm_act(x, wt, bt, groups=groups, eps=1e-6,
                                                   act="silu"))
            ok = ok and srel <= OP_TOL["stats"] and same
            a, bb = gn_affine(s1, s2, wt, bt, groups=groups, n=h * w * (c // groups), eps=1e-6)
            a, bb = a.to(dt), bb.to(dt)
            ms = cuda_ms(lambda: G.group_norm_act(x, wt, bt, groups=groups, eps=1e-6,
                                                  act="silu"))
            stats_ms = cuda_ms(lambda: G.gn_stats_kernel(x))
            apply_ms = cuda_ms(lambda: G.gn_apply_kernel(x, a, bb, act="silu"))
            plain_ms = cuda_ms(lambda: G.group_norm_act_reference(
                x, wt, bt, groups=groups, eps=1e-6, act="silu"))
            stats_plain_ms = cuda_ms(lambda: gn_stats(x))
            xc = x.permute(0, 3, 1, 2)
            lib_ms = cuda_ms(lambda: F.silu(F.group_norm(xc, groups, wt, bt, 1e-6)))
            elt = x.element_size()
            # stats reads x, writes two (B, C) f32; apply reads x, A and B,
            # writes y; the whole op is both
            stats_bound = (x.numel() * elt + 2 * bsz * c * 4) / MEM_BW * 1e3
            apply_bound = (2 * x.numel() * elt + 2 * bsz * c * elt) / MEM_BW * 1e3
            row = {"shape": list(shape), "groups": groups, "sites_per_episode": sites,
                   "dtype": name, "max_abs_err": err, "max_rel_err": mx,
                   "mean_rel_err": mean, "stats_max_abs_err": serr, "stats_rel_err": srel,
                   "repeat_bit_identical": same, "ms": ms, "stats_ms": stats_ms,
                   "apply_ms": apply_ms, "plain_ms": plain_ms,
                   "stats_plain_ms": stats_plain_ms,
                   "library_ms": lib_ms, "bound_ms": stats_bound + apply_bound,
                   "stats_bound_ms": stats_bound, "apply_bound_ms": apply_bound,
                   "bound_by": "bytes", "ok": ok}
            rows.append(row)
            emit(row)
            check(ok, f"GroupNorm kernels disagree with the plain version at {shape} {name}: "
                      f"{row}")
            del x, y, want, a, bb
        del x32
        torch.cuda.empty_cache()
    check(any(tuple(r["shape"]) == NORM_MAIN_SHAPE for r in rows),
          f"the episode gave no GroupNorm at {NORM_MAIN_SHAPE}")
    RESULTS["norm"] = rows
    return rows


FUSED_MAIN_SHAPE = (12, 512, 512, 128, 128, True)  # encoder, 512², conv2 with residual


def phase_fused(fr_shapes):
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops import fused_resnet as FR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("fused phase: TF32 off; tolerances relative to max|plain| " + json.dumps(OP_TOL))
    rows = []
    for i, (key, sites) in enumerate(sorted(fr_shapes.items())):
        bsz, h, w, cin, cout, has_res = key
        g = torch.Generator(device="cuda").manual_seed(400 + i)
        r = lambda *sh: torch.randn(sh, generator=g, device="cuda")
        x32 = r(bsz, h, w, cin)
        a = torch.rand((bsz, cin), generator=g, device="cuda") + 0.5
        b = torch.rand((bsz, cin), generator=g, device="cuda") * 0.6 - 0.3
        w32 = r(cout, cin, 3, 3) * (1.0 / (3 * cin ** 0.5))
        bias = r(cout) * 0.1
        res32 = r(bsz, h, w, cout) if has_res else None
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            x, wt = x32.to(dt), w32.to(dt)
            res = None if res32 is None else res32.to(dt)
            y, s1, s2 = FR.gn_silu_conv3x3(x, a, b, wt, bias, res)
            want = FR.gn_silu_conv3x3_reference(x, a, b, wt, bias, res)[0]
            torch.cuda.synchronize()
            err, mx, mean, ok = _op_errors(y, want, name)
            srel, serr = _stats_rel(y, s1, s2)
            again = FR.gn_silu_conv3x3(x, a, b, wt, bias, res)
            same = all(torch.equal(p, q) for p, q in zip((y, s1, s2), again))
            ok = ok and srel <= OP_TOL["stats"] and same
            del want, again
            reps = (5, 2) if dt == torch.bfloat16 else (2, 1)
            ms = cuda_ms(lambda: FR.gn_silu_conv3x3(x, a, b, wt, bias, res), *reps)
            plain_ms = cuda_ms(lambda: FR.gn_silu_conv3x3_reference(x, a, b, wt, bias, res),
                               reps=2, warmup=1)
            # the library yardstick: cuDNN's conv of the same shape and dtype
            # (no norm, activation, residual or statistics)
            xc, wc = x.permute(0, 3, 1, 2), wt.to(memory_format=torch.channels_last)
            bc = bias.to(dt)
            lib_ms = cuda_ms(lambda: F.conv2d(xc, wc, bc, padding=1), *reps)
            elt = x.element_size()
            flops = 2.0 * bsz * h * w * 9 * cin * cout
            nbytes = ((x.numel() + y.numel() + (0 if res is None else res.numel())
                       + wt.numel()) * elt + 2 * bsz * cin * 4 + 2 * bsz * cout * 4 + cout * 4)
            t_ops = flops / (PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
            t_mem = nbytes / MEM_BW
            row = {"shape": [bsz, h, w, cin, cout], "residual": has_res,
                   "sites_per_episode": sites, "dtype": name, "max_abs_err": err,
                   "max_rel_err": mx, "mean_rel_err": mean, "stats_max_abs_err": serr,
                   "stats_rel_err": srel, "repeat_bit_identical": same,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": max(t_ops, t_mem) * 1e3,
                   "bound_by": "operations" if t_ops >= t_mem else "bytes",
                   "tflops": flops / ms / 1e9, "share_of_bound": max(t_ops, t_mem) * 1e3 / ms,
                   "ok": ok}
            rows.append(row)
            emit(row)
            check(ok, f"fused resnet kernel disagrees with the plain version at {key} {name}: "
                      f"{row}")
            del x, wt, res, y, s1, s2
        del x32, res32
        torch.cuda.empty_cache()
    check(FUSED_MAIN_SHAPE in fr_shapes, f"the fused episode gave no call at {FUSED_MAIN_SHAPE}")
    RESULTS["fused"] = rows
    return rows


DOWN_MAIN_SHAPE = (12, 512, 512, 128, 128)  # the encoder's first downsample, 1-shot b4
# the kernel against the encoder's own output (cuDNN, bf16): two roundings
# of f32 sums taken in different orders, relative to max|output|
DOWN_VS_MODULE_TOL = 2e-2


def phase_downsample(recorded):
    """`recorded`: the encoder's three downsamples at B = 12 then B = 3
    (`episode_shapes`).  Returns (rows, the launches of the counted drive)."""
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops import downsample as DS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("downsample phase: TF32 off; tolerances relative to max|plain| " + json.dumps(OP_TOL))
    for d in recorded:
        check(d["x"].is_contiguous() and d["x"].dtype == torch.bfloat16,
              f"the encoder gave its downsample a {d['x'].dtype} input with strides "
              f"{d['x'].stride()}")

    # the op's own path: its entry point on the B = 12 encoder inputs, counted,
    # and held against what the encoder's Downsample2D computed from them
    _zero_counts()
    drive = [DS.downsample_conv2x(d["x"], d["w"], d["bias"]) for d in recorded[:3]]
    torch.cuda.synchronize()
    launches = _launch_counts()
    check(launches == {**_expect(0, 0, 0), "downsample_conv2x": 3},
          f"three downsample_conv2x calls launched {launches}")
    vs_module = []
    for d, y in zip(recorded, drive):
        check(tuple(y.shape) == tuple(d["y"].shape) and y.dtype == d["y"].dtype
              and bool(torch.isfinite(y.float()).all()), f"downsample output {tuple(y.shape)}")
        err = (y.float() - d["y"].float()).abs().max().item() / d["y"].float().abs().max().item()
        check(err <= DOWN_VS_MODULE_TOL, f"downsample kernel vs the encoder's own output at "
              f"{tuple(d['x'].shape)}: {err:.3g} of max (tolerance {DOWN_VS_MODULE_TOL})")
        vs_module.append(err)
    del drive
    emit({"phase": "downsample_entry_point_b12", "kernel_launches": launches,
          "max_rel_err_vs_encoder_output": vs_module})

    rows, made = [], 0
    before = DS.downsample_conv2x.launches
    for d in recorded:
        bsz, h, w, cin = d["x"].shape
        cout = d["w"].shape[0]
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            x, wt, bias = d["x"].to(dt), d["w"].to(dt), d["bias"].float()
            y = DS.downsample_conv2x(x, wt, bias)
            want = DS.downsample_conv2x_reference(x, wt, bias)
            torch.cuda.synchronize()
            err, mx, mean, ok = _op_errors(y, want, name)
            same = torch.equal(y, DS.downsample_conv2x(x, wt, bias))
            # an image's bottom padding row is zeros, never the next image's
            # first row: each image alone equals its row of the batch
            alone = all(torch.equal(DS.downsample_conv2x(x[i:i + 1], wt, bias)[0], y[i])
                        for i in range(bsz))
            made += 2 + bsz
            ok = ok and same and alone
            del want
            reps = (5, 2) if dt == torch.bfloat16 else (2, 1)
            ms = cuda_ms(lambda: DS.downsample_conv2x(x, wt, bias), *reps)
            made += sum(reps)
            plain_ms = cuda_ms(lambda: DS.downsample_conv2x_reference(x, wt, bias),
                               reps=2, warmup=1)
            # the library yardstick: the pad and cuDNN's strided conv
            xc, wc = x.permute(0, 3, 1, 2), wt.to(memory_format=torch.channels_last)
            bc = bias.to(dt)
            lib_ms = cuda_ms(lambda: F.conv2d(F.pad(xc, (0, 1, 0, 1)), wc, bc, stride=2), *reps)
            elt = x.element_size()
            flops = 2.0 * y.numel() * 9 * cin
            nbytes = (x.numel() + y.numel() + wt.numel()) * elt + cout * 4
            t_ops = flops / (PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
            t_mem = nbytes / MEM_BW
            row = {"shape": [bsz, h, w, cin, cout], "dtype": name, "max_abs_err": err,
                   "max_rel_err": mx, "mean_rel_err": mean, "repeat_bit_identical": same,
                   "image_alone_equals_batch_row": alone, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": max(t_ops, t_mem) * 1e3,
                   "bound_by": "operations" if t_ops >= t_mem else "bytes",
                   "tflops": flops / ms / 1e9, "gbytes_per_s": nbytes / ms / 1e6,
                   "share_of_bound": max(t_ops, t_mem) * 1e3 / ms, "ok": ok}
            rows.append(row)
            emit(row)
            check(ok, f"downsample kernel disagrees with the plain version at "
                      f"{row['shape']} {name}: {row}")
            del x, wt, y
        torch.cuda.empty_cache()
    check(DS.downsample_conv2x.launches - before == made,
          f"the launch counter rose by {DS.downsample_conv2x.launches - before} over {made} "
          "kernel calls")
    RESULTS["downsample"] = {"entry_point_b12": {"kernel_launches": launches,
                                                 "max_rel_err_vs_encoder_output": vs_module},
                             "rows": rows}
    return rows, launches


def phase_adamw(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from diffews_tpu_torch.ops import adamw
    from diffews_tpu_torch.training import lr, optim
    from helpers import adamw_leaves as L

    dev = torch.device("cuda")
    params, grads, state = L.draw(L.sd21_shapes(), dev, seed=0)
    names = list(params)
    n = sum(p.numel() for p in params.values())
    tx = optim.make_optimizer(lr.polynomial_with_warmup(1e-5, 20000), max_grad_norm=1.0)
    plain_norm = float(optim.global_norm(list(grads.values())))

    # the update against the plain version, given the kernels' norm
    params2 = {k: p.clone() for k, p in params.items()}
    state2 = L.clone_state(state)
    gk = tx.update(grads, state, params)
    keep_norm = optim.global_norm
    optim.global_norm = lambda ts: gk.clone()
    try:
        tx.plain(grads, state2, params2)
    finally:
        optim.global_norm = keep_norm
    bits = lambda t: t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)  # noqa: E731
    differ = [k for k in names if not (torch.equal(bits(params[k]), bits(params2[k]))
                                       and torch.equal(bits(state.mu[k]), bits(state2.mu[k]))
                                       and torch.equal(bits(state.nu[k]), bits(state2.nu[k])))]
    check(not differ, f"adamw: the kernels' update differs from the plain version at "
                      f"{differ[:5]} ({len(differ)} leaves)")
    norm_rel = abs(float(gk) - plain_norm) / plain_norm
    check(norm_rel <= 1e-6, f"adamw: norm {float(gk)} against plain {plain_norm}")
    del params2, state2
    torch.cuda.empty_cache()

    # device times
    lists = ([grads[k] for k in names], [params[k] for k in names],
             [state.mu[k] for k in names], [state.nu[k] for k in names])
    kernels = adamw.MultiTensor((1.0, 0.1, 0.8984375, 1e-3, 0.999, 1e-8, 1e-2))
    step = kernels.norm(*lists, [0] * len(names))
    f32 = dict(dtype=torch.float32, device=dev)
    scalars = (step.norm, torch.ones((), dtype=torch.bool, device=dev),
               torch.ones((), dtype=torch.bool, device=dev), torch.full((), 0.5, **f32),
               torch.full((), 0.1, **f32), torch.full((), -1e-5, **f32))
    norm_ms = cuda_ms(lambda: kernels.norm(*lists, [0] * len(names)), inner=5)
    apply_ms = cuda_ms(lambda: step.apply(*scalars), inner=5)
    update = lambda: tx.update(grads, state, params)  # noqa: E731
    update_ms = cuda_ms(update, inner=5)
    plain_ms = cuda_ms(lambda: tx.plain(grads, state, params), reps=3, warmup=1)
    torch.cuda.synchronize()
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        update()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    _zero_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            update()
        torch.cuda.synchronize()
    port = {k: _launch_counts()[k] / 3 for k in ADAMW_COUNTS}
    calls = {}
    for e in prof.events():
        if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cudaMemcpyAsync"):
            calls[e.name] = calls.get(e.name, 0) + 1
    calls = {k: v / 3 for k, v in calls.items()}

    # the yardstick: torch's fused AdamW over the same leaves (f32 moments, no clip)
    del step
    for k in names:
        params[k].grad = grads[k]
    lib = torch.optim.AdamW([params[k] for k in names], lr=1e-5, fused=True)
    library_ms = cuda_ms(lib.step, inner=3)
    del lib
    bound_ms = (24 + 4) * n / MEM_BW * 1e3
    row = {"leaves": len(names), "params": n, "bits_equal": True, "norm_rel": norm_rel,
           "norm_ms": norm_ms, "apply_ms": apply_ms, "ms": update_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "apply_bound_ms": 24 * n / MEM_BW * 1e3, "norm_bound_ms": 4 * n / MEM_BW * 1e3,
           "share_of_bound": bound_ms / update_ms, "host_ms": statistics.median(host),
           "cuda_calls_per_step": calls, "port_launches_per_step": port, "card": card}
    RESULTS["adamw"] = row
    emit({"phase": "adamw", **row})
    return row


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


def _diff_stats(a, b):
    """Largest uint8 difference and the share of values that differ."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d != 0).mean())


def _uint8_close(a, b, what):
    mx, frac = _diff_stats(a, b)
    check(mx <= 1 and frac < 0.01,
          f"{what}: max uint8 diff {mx}, {frac:.4f} of pixels differ "
          "(allowed: <= 1 count on < 1% of pixels)")
    return mx, frac


# the optimizer kernels' counters (`ops/adamw.py`): one norm, finalise and
# apply launch an optimizer step, and no gradient copied into its master's
# layout
ADAMW_COUNTS = ("adamw_norm", "adamw_finalise", "adamw_apply", "adamw_layout_copies")


def _launch_counts():
    from diffews_tpu_torch.ops import adamw, downsample, fused_resnet, groupnorm, quant
    from diffews_tpu_torch.ops.flash_attention import flash_attention

    return {"flash_attention_fwd": flash_attention.launches,
            "gn_stats": groupnorm.gn_stats_kernel.launches,
            "gn_apply": groupnorm.gn_apply_kernel.launches,
            "fused_gn_silu_conv3x3": fused_resnet.gn_silu_conv3x3.launches,
            "downsample_conv2x": downsample.downsample_conv2x.launches,
            "quantize_s8": quant.quantize_s8.launches,
            "conv2d_int8": quant.conv2d_int8.launches,
            "int_mm": quant.linear_int8.launches,
            "adamw_norm": adamw.norm_pass.launches,
            "adamw_finalise": adamw.finalise_pass.launches,
            "adamw_apply": adamw.apply_pass.launches,
            "adamw_layout_copies": adamw.match_layouts.layout_copies}


def _zero_counts():
    from diffews_tpu_torch.ops import adamw, downsample, fused_resnet, groupnorm, quant
    from diffews_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd

    flash_attention.launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    groupnorm.gn_stats_kernel.launches = groupnorm.gn_apply_kernel.launches = 0
    fused_resnet.gn_silu_conv3x3.launches = 0
    downsample.downsample_conv2x.launches = 0
    quant.quantize_s8.launches = quant.conv2d_int8.launches = quant.linear_int8.launches = 0
    adamw.norm_pass.launches = adamw.finalise_pass.launches = adamw.apply_pass.launches = 0
    adamw.match_layouts.layout_copies = 0


def _expect(flash, gn, fused):
    """Launch counts of a pipeline path: `gn` of each GroupNorm kernel, and
    no downsample launch (the op is on no pipeline path, as in the JAX
    package), no int8 launch (W8A8 is opt-in, phase int8) and no optimizer
    launch."""
    return {"flash_attention_fwd": flash, "gn_stats": gn, "gn_apply": gn,
            "fused_gn_silu_conv3x3": fused, "downsample_conv2x": 0, "quantize_s8": 0,
            "conv2d_int8": 0, "int_mm": 0, **{k: 0 for k in ADAMW_COUNTS}}


def phase_tiny():
    import torch
    from diffews_tpu_torch.checkpoint import random_pipeline_bundle
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from diffews_tpu_torch.models import vae
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgs = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
            SchedulerConfig.diffews())
    out = {}
    # (label, attn_mask_variant, vae_impl, batch, shots); "mixed" with the
    # threshold lowered to the tiny VAE's full 32x32 grid; "auto" at batch 1,
    # 1 shot (3 encoded images: the fused encode on the card, "xla" on the CPU)
    runs = [("kv_fusion", False, "xla", 2, 3), ("attn_mask", True, "xla", 2, 3),
            ("vae_fused", False, "fused", 2, 3), ("vae_mixed", False, "mixed", 2, 3),
            ("vae_auto_b1", False, "auto", 1, 1)]
    threshold = vae.MIXED_MIN_PIXELS
    for label, variant, vae_impl, b, n in runs:
        vae.MIXED_MIN_PIXELS = 32 * 32 if vae_impl == "mixed" else threshold
        try:
            pipes = {dev: DiffewsPipeline(random_pipeline_bundle(*cfgs, seed=0), device=dev,
                                          attn_mask_variant=variant, vae_impl=vae_impl)
                     for dev in ("cpu", "cuda")}
            q, sup, m = _episode(b, n, 32, seed=1)
            sm = np.array([[True, True, False], [True, True, True]]) if n == 3 else None
            res = {"cpu": pipes["cpu"].predict(q, sup, m, shot_mask=sm, r_threshold=0.25)}
            _zero_counts()
            res["cuda"] = pipes["cuda"].predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
            counts = _launch_counts()
        finally:
            vae.MIXED_MIN_PIXELS = threshold
        what = f"tiny GPU vs CPU ({label})"
        check(counts["flash_attention_fwd"] > 0, f"{what}: no flash launch: {counts}")
        if vae_impl in ("xla", "mixed", "auto"):  # decode through group_norm_act
            check(counts["gn_stats"] > 0 and counts["gn_apply"] > 0,
                  f"{what}: no GroupNorm launch: {counts}")
        if vae_impl in ("fused", "mixed", "auto"):
            check(counts["fused_gn_silu_conv3x3"] > 0, f"{what}: no fused launch: {counts}")
        mx, frac = _uint8_close(res["cuda"].seg_colored, res["cpu"].seg_colored, what)
        flips = float((res["cuda"].mask != res["cpu"].mask).mean())
        check(flips < 0.01, f"{what}: {flips:.4f} of mask pixels flip")
        out[label] = {"vae_impl": vae_impl, "max_uint8_diff": mx, "frac_differ": frac,
                      "mask_flips": flips, "kernel_launches": counts}
    RESULTS["tiny"] = out
    emit({"phase": "tiny", "dtype": "float32", "tf32": False, **out})

    # cached-support serving: the card against the CPU and against `predict`
    cached = {}
    for label, variant in (("kv_fusion", False), ("attn_mask", True)):
        pipes = {dev: DiffewsPipeline(random_pipeline_bundle(*cfgs, seed=0), device=dev,
                                      attn_mask_variant=variant) for dev in ("cpu", "cuda")}
        # (a) a batch-2 cache of 3 shots, one of row 0's padded
        q, sup, m = _episode(2, 3, 32, seed=4)
        sm = np.array([[True, True, False], [True, True, True]])
        res = {}
        for dev, pipe in pipes.items():
            _zero_counts()
            cache = pipe.precompute_supports(sup, m, shot_mask=sm)
            n_capture = _launch_counts()["flash_attention_fwd"]
            res[dev] = pipe.predict_cached(q, cache, r_threshold=0.25)
            n_cached = _launch_counts()["flash_attention_fwd"] - n_capture
        what = f"tiny cached GPU vs CPU ({label})"
        check(n_capture > n_cached > 0, f"{what}: {n_capture} flash launches in the capture, "
              f"{n_cached} in the cached predict")
        mx, frac = _uint8_close(res["cuda"].seg_colored, res["cpu"].seg_colored, what)
        flips = float((res["cuda"].mask != res["cpu"].mask).mean())
        check(flips < 0.01, f"{what}: {flips:.4f} of mask pixels flip")
        joint = pipes["cuda"].predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
        jmx, jfrac = _uint8_close(res["cuda"].seg_colored, joint.seg_colored,
                                  f"tiny cached vs joint predict ({label})")
        # (b) a batch-1 cache (2 shots, one padded) under a batch-3 query,
        # against three joint batch-1 episodes
        _, sup1, m1 = _episode(1, 2, 32, seed=5)
        q3 = _episode(3, 1, 32, seed=6)[0]
        sm1 = np.array([[True, False]])
        cache1 = pipes["cuda"].precompute_supports(sup1, m1, shot_mask=sm1)
        got3 = pipes["cuda"].predict_cached(q3, cache1)
        bmx = bfrac = 0
        for i in range(3):
            one = pipes["cuda"].predict(q3[i:i + 1], sup1, m1, shot_mask=sm1)
            a, b = _uint8_close(got3.seg_colored[i:i + 1], one.seg_colored,
                                f"tiny batch-1 cache under a batch-3 query, row {i} ({label})")
            bmx, bfrac = max(bmx, a), max(bfrac, b)
        cached[label] = {"flash_launches_capture": n_capture, "flash_launches_cached": n_cached,
                         "max_uint8_diff_vs_cpu": mx, "frac_differ_vs_cpu": frac,
                         "mask_flips_vs_cpu": flips, "max_uint8_diff_vs_joint": jmx,
                         "frac_differ_vs_joint": jfrac, "broadcast_max_uint8_diff": bmx,
                         "broadcast_frac_differ": bfrac}
    RESULTS["tiny_cached"] = cached
    emit({"phase": "tiny_cached", "dtype": "float32", "tf32": False, **cached})


def _train_batch(gas, b, n, s, seed, padded=0, device="cpu"):
    """Synthetic uint8 episodes with binary masks, as the training step
    takes them ((G, B, ...) leading axes); the last `padded` shots of every
    row are masked out by `shot_mask`."""
    import torch

    rng = np.random.default_rng(seed)
    img = lambda *sh: rng.integers(0, 256, sh + (s, s, 3), dtype=np.uint8)
    m = np.zeros((gas, b, 1 + n, s, s), np.uint8)  # a random rectangle per image
    for idx in np.ndindex(gas, b, 1 + n):
        y0, x0 = rng.integers(0, s // 2, 2)
        m[idx + (slice(y0, y0 + s // 2), slice(x0, x0 + s // 2))] = 1
    shot_mask = np.ones((gas, b, n), bool)
    if padded:
        shot_mask[:, :, n - padded:] = False
    batch = {"query": img(gas, b), "q_mask3": m[:, :, 0], "supports": img(gas, b, n),
             "s_mask3": m[:, :, 1:], "shot_mask": shot_mask}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _n_images(b, n, variant):
    return 2 * b + b * n * (1 if variant else 2)


def _params_close(got, want, mu_hist, lr, steps, what):
    """The params after `steps` steps on two devices: within 1e-3·lr on at
    least 99.9% of the entries and within 2·lr per step everywhere.  An
    entry whose gradient is within float noise of zero can flip the sign of
    an Adam step, so entries off by more than 1e-3·lr must have had a first
    moment within 1e-2 of their leaf's largest after some step."""
    off = total = 0
    worst = 0.0
    for name, p in got.items():
        d = (p.detach().cpu() - want[name].detach().cpu()).abs()
        bad = d > 1e-3 * lr
        noisy = None
        for mu in mu_hist:
            m = mu[name].abs()
            small = m <= 1e-2 * m.max()
            noisy = small if noisy is None else noisy | small
        stray = bad & ~noisy
        if bool(stray.any()):
            fail(f"{what}: {name} differs by {d[stray].max().item() / lr:.3g}·lr where the "
                 "gradient is not small")
        check(d.max().item() <= 2 * lr * steps, f"{what}: {name} off by "
              f"{d.max().item() / lr:.3g}·lr")
        off, total = off + int(bad.sum()), total + bad.numel()
        worst = max(worst, d.max().item() / lr)
    check(off <= 1e-3 * total, f"{what}: {off} of {total} entries off by more than 1e-3·lr")
    return {"entries_off": off, "entries": total, "max_diff_over_lr": worst}


def phase_tiny_train():
    import torch
    from diffews_tpu_torch.configs import UNetConfig, VAEConfig
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL
    from diffews_tpu_torch.ops import groupnorm
    from diffews_tpu_torch.ops.flash_attention import flash_attention_bwd
    from diffews_tpu_torch.training.state import TrainerConfig, init_state, make_train_step
    from diffews_tpu_torch.utils.init import build_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
    gas, b, n, px, lr = 2, 2, 2, 32, 1e-3
    text = np.random.default_rng(3).normal(0, 0.5, (1, 77, ucfg.cross_attention_dim))
    out = {}
    for variant in (False, True):
        cfg = TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32,
                            learning_rate=lr, max_train_steps=10,
                            attn_mask_variant=variant)
        noise = np.random.default_rng(4).normal(
            size=(2, gas, _n_images(b, n, variant), px // 2, px // 2, 4)).astype(np.float32)
        runs = {}
        for dev in ("cpu", "cuda"):
            # NHWC activations stay contiguous on the card (the GroupNorm
            # kernels take nothing else), as the pipeline and trainer set it
            fmt = torch.channels_last if dev == "cuda" else torch.contiguous_format
            unet = build_module(UNet2DConditionModel, ucfg, seed=0).to(dev, memory_format=fmt)
            vae = build_module(AutoencoderKL, vcfg, seed=1).to(
                dev, memory_format=fmt).requires_grad_(False)
            state = init_state(cfg, dict(unet.named_parameters()), device=dev)
            step = make_train_step(cfg, unet)
            dq0, dkv0 = flash_attention_bwd.dq_launches, flash_attention_bwd.dkv_launches
            gn0 = groupnorm.gn_stats_kernel.launches
            metrics, mu_hist = [], []
            for i in range(2):
                batch = _train_batch(gas, b, n, px, seed=10 + i, padded=1, device=dev)
                state, m = step(state, batch, torch.from_numpy(noise[i]).to(dev), vae,
                                torch.tensor(text, dtype=torch.float32, device=dev))
                metrics.append({k: float(v) for k, v in m.items()})
                mu_hist.append({k: v.detach().cpu().clone() for k, v in state.opt_state.mu.items()})
            runs[dev] = (metrics, state, mu_hist, flash_attention_bwd.dq_launches - dq0,
                         flash_attention_bwd.dkv_launches - dkv0,
                         groupnorm.gn_stats_kernel.launches - gn0)
        (m_cpu, s_cpu, mu_cpu, *_), (m_gpu, s_gpu, _, dq_n, dkv_n, gn_n) = (runs["cpu"],
                                                                          runs["cuda"])
        what = f"tiny train GPU vs CPU (attn_mask_variant={variant})"
        check(dq_n > 0 and dkv_n > 0, f"{what}: the backward kernels were not launched")
        check(gn_n > 0, f"{what}: the GroupNorm kernels were not launched")
        for i, (a, c) in enumerate(zip(m_gpu, m_cpu)):
            check(abs(a["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
                  f"{what}: step {i} loss {a['loss']} vs {c['loss']}")
            check(abs(a["grad_norm"] - c["grad_norm"]) <= 1e-4 * abs(c["grad_norm"]),
                  f"{what}: step {i} grad norm {a['grad_norm']} vs {c['grad_norm']}")
            check(a["notfinite_count"] == c["notfinite_count"] == 0
                  and a["total_notfinite"] == c["total_notfinite"] == 0, f"{what}: counters")
        check(int(s_gpu.step) == int(s_cpu.step) == 2, f"{what}: step counters")
        params = _params_close(s_gpu.params, s_cpu.params, mu_cpu, lr, 2, what)
        out["attn_mask" if variant else "kv_fusion"] = {
            "loss_gpu": [m["loss"] for m in m_gpu], "loss_cpu": [m["loss"] for m in m_cpu],
            "grad_norm_gpu": [m["grad_norm"] for m in m_gpu],
            "grad_norm_cpu": [m["grad_norm"] for m in m_cpu],
            "dq_launches": dq_n, "dkv_launches": dkv_n, "gn_stats_launches": gn_n, **params}
    RESULTS["tiny_train"] = out
    emit({"phase": "tiny_train", "dtype": "float32", "tf32": False, "gas": gas, **out})


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention_fwd"
    if "flash_bwd" in n:
        return "flash_attention_bwd"
    if "gn_stats_partial" in n:
        return "gn_stats (B4a)"
    if "gn_apply" in n:
        return "gn_apply (B4b)"
    if "conv2d_int8" in n:  # conv2d_int8_wgmma_kernel<stride, BN, out type>, heads included
        return "conv2d_int8 (A12)"
    if "conv_wgmma_kernel" in n or "conv_f32_kernel" in n:
        return "fused_gn_silu_conv3x3 (B5)"
    if "down_wgmma_kernel" in n or "down_f32_kernel" in n:
        return "downsample_conv2x (B6)"
    if "quantize_s8_kernel" in n:
        return "quantize_s8 (A12)"
    if "sum_partials" in n:
        return "statistics partial sums (B4a, B5)"
    if "fprop" in n or "conv" in n or "cudnn" in n:
        return "conv (cuDNN)"
    if "gemm" in n or "cutlass" in n or "nvjet" in n or "cublas" in n:
        return "matmul (cuBLAS)"
    if "reduce" in n:
        return "reductions"
    return "elementwise/other"


def profile_episode(fn) -> dict:
    """Device time of one run of `fn` (an episode or a training step) by
    kernel class (torch.profiler), and the device's idle share of its wall
    time."""
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
    flash = {n[:90]: round(v, 3) for n, v in by_name.items() if "flash" in n.lower()}
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy, "flash_kernels_ms": flash,
            "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "device_ms_by_class": {k: round(v, 3) for k, v in
                                   sorted(by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:80], round(v, 3)] for n, v in top]}


# launches per 1-shot batch-4 predict by `vae_impl` ("auto" at batch 1):
# 34 flash forward (32 UNet + 2 VAE mid blocks); GroupNorm+SiLU sites: 44
# in the UNet's 22 resnets, 21 in the encoder (10 resnets + head) and 29 in
# the decoder (14 + head) unless fused; fused convs: 2 per fused resnet + 1
# per fused head.  "mixed" fuses the encoder's 512² and 256² resnets and the
# decoder's 256² and 512² resnets and head; "auto" fuses the encode of 3
# images, never the decode.
EPISODE_LAUNCHES = {"xla": _expect(34, 94, 0), "fused": _expect(34, 44, 50),
                    "mixed": _expect(34, 73, 21), "auto_b1": _expect(34, 73, 21)}
VAE_F32_TOL = 2e-3  # fused vs xla VAE, f32, TF32 off: max|Δ| / max|xla|


def _same_seg(a, b) -> bool:
    return np.array_equal(a.seg_colored, b.seg_colored)


def _timed_run(run, same, expected, label, card):
    """Warm up, then one `run()` with the launch counts zeroed before it and
    read after it (they must equal `expected`, and its result the warm-up's
    by `same`), three timed repeats and a profile; every run is timed to the
    device's end.  Returns (result of the counted run, record)."""
    import torch

    def timed():
        t0 = time.time()
        out = run()
        torch.cuda.synchronize()
        return out, time.time() - t0

    warm, _ = timed()  # cuDNN plans, allocator
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out, wall = timed()
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts == expected, f"{label} launched {counts}, expected {expected}")
    check(same(warm, out), f"{label}: repeat differs")
    del warm
    walls = [timed()[1] for _ in range(3)]
    prof = profile_episode(run)
    emit({"phase": f"profile_{label}_512px_bf16", **prof, "card": card})
    rec = {"kernel_launches": counts, "wall_s_first": wall,
           "wall_s": walls, "wall_s_median": statistics.median(walls),
           "peak_mem_gb": peak / 1e9, "profile": prof, "card": card}
    return out, rec


def _timed_episode(pipe, vae_impl, args, label, card):
    """`_timed_run` of `pipe.predict(*args)` under `vae_impl`."""
    pipe.vae_impl = vae_impl
    out, rec = _timed_run(lambda: pipe.predict(*args, r_threshold=0.25), _same_seg,
                          EPISODE_LAUNCHES[label], label, card)
    return out, {"vae_impl": vae_impl, **rec}


def _padded_invariant(pipe, vae_impl, q5, sup5, m5, sm):
    """bf16 5-shot episode: the two padded shots' content changes no bit."""
    pipe.vae_impl = vae_impl
    pad = pipe.predict(q5, sup5, m5, shot_mask=sm, r_threshold=0.25)
    sup_o, m_o = sup5.copy(), m5.copy()
    sup_o[:, 3:], m_o[:, 3:] = 255 - sup5[:, 3:], 1 - m5[:, 3:]
    other = pipe.predict(q5, sup_o, m_o, shot_mask=sm, r_threshold=0.25)
    check(np.array_equal(pad.seg_colored, other.seg_colored),
          f"padded shots' content changed the bf16 prediction (vae_impl={vae_impl})")
    return pad


class _DirectLaunches:
    """The eager route before the custom ops, for an A/B in one process: the
    wrappers call the kernels' launchers directly instead of going through
    `torch.ops.diffews_tpu_torch.*` (which call the same launchers)."""

    def __enter__(self):
        from diffews_tpu_torch.ops import fused_resnet as fr
        from diffews_tpu_torch.ops import flash_attention as fa
        from diffews_tpu_torch.ops import groupnorm as gn

        self.saved = [(fa, "flash_attention_fwd", fa.flash_attention_fwd),
                      (gn, "gn_stats", gn.gn_stats), (gn, "gn_apply", gn.gn_apply),
                      (fr, "fused_gn_silu_conv3x3", fr.fused_gn_silu_conv3x3)]
        fa.flash_attention_fwd = lambda q, k, v, kv_mask, scale: fa._launch(q, k, v, scale,
                                                                            kv_mask)
        gn.gn_stats = gn.gn_stats_kernel
        gn.gn_apply = lambda x, a, b, act: gn.gn_apply_kernel(x, a, b, act=act)
        fr.fused_gn_silu_conv3x3 = fr._launch
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _predict_async_host_ab(pipe, args, rounds: int = 3, calls: int = 5) -> dict:
    """`predict_async`'s host time per call (the call alone; the device idle
    when it starts, the result awaited after), through the custom ops and
    through the launchers directly, in turns (ops, direct, direct, ops, ...);
    both routes must give the same prediction."""
    import torch

    times = {"custom_ops": [], "direct_launchers": []}
    outs = {}
    for rnd in range(rounds):
        for route in (("custom_ops", "direct_launchers") if rnd % 2 == 0
                      else ("direct_launchers", "custom_ops")):
            with (_DirectLaunches() if route == "direct_launchers" else nullcontext()):
                for _ in range(calls):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pend = pipe.predict_async(*args, r_threshold=0.25)
                    times[route].append(time.perf_counter() - t0)
                    outs[route] = pend.result()
    check(_same_seg(outs["custom_ops"], outs["direct_launchers"]),
          "the custom-op route and the direct launcher route predict differently")
    return {route: {"median_s": statistics.median(t), "min_s": min(t), "all_s": t}
            for route, t in times.items()}


def phase_full(card):
    import torch
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.time()
    pipe = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    res = {"setup_s": time.time() - t0}

    # (a) 1-shot, batch 4, under each vae_impl; batch 1 under "auto"
    q, sup, m = _episode(4, 1, 512, seed=2)
    out, res["one_shot_b4"] = _timed_episode(pipe, "xla", (q, sup, m), "xla", card)
    check(out.seg_colored.shape == (4, 512, 512, 3) and out.seg_colored.dtype == np.uint8,
          f"seg {out.seg_colored.shape} {out.seg_colored.dtype}")
    check(out.mask.shape == (4, 512, 512) and out.mask.dtype == bool, "mask shape/dtype")
    with torch.inference_mode():
        x0 = pipe._x0_latent(*(pipe._put(x) for x in (q, sup, m)),
                             pipe.empty_text_embed, None, 1)
    check(tuple(x0.shape) == (4, 64, 64, 4) and bool(torch.isfinite(x0.float()).all()),
          f"x0 {tuple(x0.shape)} not finite")
    # yardstick for bf16 rounding that depends on the batch shape: the first
    # query of the batch-4 episode run alone
    one = pipe.predict(q[:1], sup[:1], m[:1], r_threshold=0.25)
    d1 = np.abs(one.seg_colored[0].astype(np.int32) - out.seg_colored[0].astype(np.int32))
    res["one_shot_b4"].update({
        "mask_fraction": float(out.mask.mean()), "seg_mean": float(out.seg_colored.mean()),
        "b1_vs_b4_row0_max_uint8_diff": int(d1.max()),
        "b1_vs_b4_row0_frac_differ": float((d1 != 0).mean())})
    emit({"phase": "full_1shot_b4_512px_bf16", **{k: v for k, v in res["one_shot_b4"].items()
                                                   if k != "profile"}})
    res["predict_async_host_b4"] = {**_predict_async_host_ab(pipe, (q, sup, m)), "card": card}
    emit({"phase": "full_predict_async_host_b4_custom_ops_vs_direct",
          **{k: ({kk: vv for kk, vv in v.items() if kk != "all_s"} if isinstance(v, dict) else v)
             for k, v in res["predict_async_host_b4"].items()}})
    for label in ("fused", "mixed"):
        got, rec = _timed_episode(pipe, label, (q, sup, m), label, card)
        dv = np.abs(got.seg_colored.astype(np.int32) - out.seg_colored.astype(np.int32))
        rec.update({"bf16_max_uint8_diff_vs_xla": int(dv.max()),
                    "bf16_frac_differ_vs_xla": float((dv != 0).mean())})
        res[f"one_shot_b4_{label}"] = rec
        emit({"phase": f"full_1shot_b4_512px_bf16_{label}",
              **{k: v for k, v in rec.items() if k != "profile"}})
    _, rec = _timed_episode(pipe, "auto", (q[:1], sup[:1], m[:1]), "auto_b1", card)
    res["one_shot_b1_auto"] = rec
    emit({"phase": "full_1shot_b1_512px_bf16_auto",
          **{k: v for k, v in rec.items() if k != "profile"}})
    # b1: "auto" (fused encode, the card's rule for <= 4 images) against
    # "xla", in turns, three runs each: walls and device busy
    b1_cmp = {"auto": [], "xla": []}
    for rnd in range(3):
        for vi in (("auto", "xla") if rnd % 2 == 0 else ("xla", "auto")):
            _, r1 = _timed_episode(pipe, vi, (q[:1], sup[:1], m[:1]),
                                   "auto_b1" if vi == "auto" else "xla", card)
            b1_cmp[vi].append({"wall_s": r1["wall_s"],
                               "device_busy_ms": r1["profile"].get("device_busy_ms"),
                               "fused_conv_ms": (r1["profile"].get("device_ms_by_class") or {})
                               .get("fused_gn_silu_conv3x3 (B5)", 0.0)
                               if isinstance(r1["profile"].get("device_ms_by_class"), dict)
                               else None})
    b1_sum = {vi: {"wall_s_median": statistics.median(w for r in runs for w in r["wall_s"]),
                   "device_busy_ms": [r["device_busy_ms"] for r in runs],
                   "fused_conv_ms": [r["fused_conv_ms"] for r in runs]}
              for vi, runs in b1_cmp.items()}
    res["b1_auto_vs_xla"] = {"runs": b1_cmp, "summary": b1_sum, "card": card}
    emit({"phase": "full_1shot_b1_512px_bf16_auto_vs_xla", **b1_sum, "card": card})

    # device busy per episode, and the fused conv's part of it
    busy = {}
    for label, key in (("xla", "one_shot_b4"), ("fused", "one_shot_b4_fused"),
                       ("mixed", "one_shot_b4_mixed"), ("auto_b1", "one_shot_b1_auto")):
        prof = res[key]["profile"]
        by_class = prof.get("device_ms_by_class")
        fused_ms = by_class.get("fused_gn_silu_conv3x3 (B5)", 0.0) if isinstance(by_class, dict) \
            else None
        busy[label] = {"device_busy_ms": prof.get("device_busy_ms"), "fused_conv_ms": fused_ms,
                       "wall_s_median": res[key]["wall_s_median"]}
    res["device_busy"] = busy
    emit({"phase": "full_device_busy_512px_bf16", **busy, "card": card})

    # (b) 5-shot, batch 1, shots 4 and 5 padded by shot_mask: under "xla"
    # and "fused" their content changes no bit of the bf16 prediction
    q5, sup5, m5 = _episode(1, 5, 512, seed=3)
    sm = np.array([[True, True, True, False, False]])
    _padded_invariant(pipe, "fused", q5, sup5, m5, sm)
    pad = _padded_invariant(pipe, "xla", q5, sup5, m5, sm)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe.predict(q5, sup5, m5, shot_mask=sm, r_threshold=0.25)
    wall5 = time.time() - t0
    peak5 = torch.cuda.max_memory_allocated()
    # against the 3-shot episode of the same data: bf16 (reported; its batch
    # shapes differ, so rounding differs) and f32 with TF32 off (held)
    three = pipe.predict(q5, sup5[:, :3], m5[:, :3], r_threshold=0.25)
    d3 = np.abs(pad.seg_colored.astype(np.int32) - three.seg_colored.astype(np.int32))
    del pipe
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe32 = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.float32)
    pad32 = pipe32.predict(q5, sup5, m5, shot_mask=sm, r_threshold=0.25)
    three32 = pipe32.predict(q5, sup5[:, :3], m5[:, :3], r_threshold=0.25)
    mx, frac = _uint8_close(pad32.seg_colored, three32.seg_colored,
                            "f32 5-shot with 2 padded shots vs 3-shot")
    flips = float((pad32.mask != three32.mask).mean())
    check(flips < 0.01, f"f32 padded vs 3-shot: {flips:.4f} of mask pixels flip")
    res["five_shot_padded_b1"] = {
        "bf16_padded_content_invariant": {"xla": True, "fused": True},
        "bf16_max_uint8_diff_vs_3shot": int(d3.max()),
        "bf16_frac_differ_vs_3shot": float((d3 != 0).mean()),
        "f32_max_uint8_diff_vs_3shot": mx, "f32_frac_differ_vs_3shot": frac,
        "f32_mask_flips_vs_3shot": flips, "bf16_wall_s": wall5,
        "bf16_peak_mem_gb": peak5 / 1e9, "card": card}
    emit({"phase": "full_5shot_2padded_b1_512px", **res["five_shot_padded_b1"]})

    # (c) f32, TF32 off: the fused VAE against the xla VAE at full width, on
    # the three images of a 1-shot episode (encode) and their latents (decode)
    with torch.inference_mode():
        imgs = torch.cat([pipe32._norm_img(pipe32._put(x)) for x in (q[:1], sup[0, :1])]
                         + [pipe32._norm_mask(pipe32._put(m[:1]))[0]], dim=0)
        enc = {k: pipe32.vae.encode_moments(imgs, resnet_impl=k) for k in ("xla", "fused")}
        z = enc["xla"][..., :4] * pipe32.vae_cfg.scaling_factor
        dec = {k: pipe32.vae.decode(z, resnet_impl=k) for k in ("xla", "fused")}
    vae_cmp = {}
    for name, pair in (("encode_moments", enc), ("decode", dec)):
        ref = pair["xla"]
        err = (pair["fused"] - ref).abs()
        top = ref.abs().max().item()
        vae_cmp[name] = {"shape": list(ref.shape), "max_abs": err.max().item(),
                         "mean_abs": err.mean().item(), "max_abs_xla": top,
                         "max_rel": err.max().item() / top}
        check(bool(torch.isfinite(pair["fused"]).all())
              and err.max().item() <= VAE_F32_TOL * top,
              f"f32 fused vs xla VAE {name}: {vae_cmp[name]} (tolerance {VAE_F32_TOL})")
    res["vae_f32_fused_vs_xla"] = {"tolerance_rel_to_max": VAE_F32_TOL, **vae_cmp}
    emit({"phase": "full_vae_f32_fused_vs_xla", **res["vae_f32_fused_vs_xla"]})
    del pipe32, enc, dec
    torch.cuda.empty_cache()
    RESULTS["full"] = res
    return {k: res[r]["kernel_launches"] for k, r in (
        ("episode_1shot_b4", "one_shot_b4"), ("episode_1shot_b4_fused", "one_shot_b4_fused"),
        ("episode_1shot_b4_mixed", "one_shot_b4_mixed"),
        ("episode_1shot_b1_auto", "one_shot_b1_auto"))}


# ---------------------------------------------------------------------------
# phase depth: the depth head (`predict_depth`)
# ---------------------------------------------------------------------------

DEPTH_OUT_SIZE = (375, 500)  # a PASCAL-sized query: the bilinear resize's check
DEPTH_RESIZE_TOL = 1e-6  # the card's resize against the CPU's on the same map


def _depth_tiny(card):
    """(a) tiny f32 (TF32 off) depth episodes, the card against the CPU,
    under every `vae_impl` (int8 with the CPU's codes fed forward past
    ties), with and without a resize: `helpers/depth_check.py`'s contract."""
    import torch
    from diffews_tpu_torch.checkpoint import random_pipeline_bundle
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from diffews_tpu_torch.models import vae
    from diffews_tpu_torch.pipeline import DiffewsPipeline, depth_output
    from helpers.depth_check import depth_close

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgs = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
            SchedulerConfig.diffews())
    out = {}
    threshold = vae.MIXED_MIN_PIXELS
    # "auto" at batch 1, 1 shot: 3 encoded images, the fused encode on the card
    for vae_impl, b, n in (("xla", 2, 2), ("fused", 2, 2), ("mixed", 2, 2), ("auto", 1, 1),
                           ("int8", 2, 2)):
        vae.MIXED_MIN_PIXELS = 32 * 32 if vae_impl == "mixed" else threshold
        try:
            pipes = {dev: DiffewsPipeline(random_pipeline_bundle(*cfgs, seed=0), device=dev,
                                          vae_impl=vae_impl) for dev in ("cpu", "cuda")}
            q, sup, m = _episode(b, n, 32, seed=11)
            sm = np.array([[True, False], [True, True]]) if n == 2 else None
            for out_size in (None, (45, 37)):
                call = lambda p: p.predict_depth_raw(q, sup, m, shot_mask=sm,
                                                     out_size=out_size).cpu().numpy()
                if vae_impl == "int8":
                    raw_cpu, raw_gpu, stats, counts = _forced_tiny(pipes, call)
                    check(max(d for _, d in stats) <= 1 and max(s for s, _ in stats) <= 1e-3,
                          f"tiny depth int8: codes differ beyond ties: {stats}")
                else:
                    raw_cpu = call(pipes["cpu"])
                    _zero_counts()
                    raw_gpu = call(pipes["cuda"])
                    counts = _launch_counts()
                what = f"tiny depth card vs CPU ({vae_impl}, out_size {out_size})"
                check(counts["flash_attention_fwd"] > 0, f"{what}: no flash launch: {counts}")
                check((counts["fused_gn_silu_conv3x3"] > 0) == (vae_impl != "xla"
                                                                and vae_impl != "int8"),
                      f"{what}: fused launches {counts}")
                check((counts["conv2d_int8"] > 0) == (vae_impl == "int8"),
                      f"{what}: int8 launches {counts}")
                stats, bad = depth_close(raw_gpu, raw_cpu, depth_output(raw_gpu),
                                         depth_output(raw_cpu))
                check(not bad, f"{what}: {bad}")
                # the entry point itself on the card gives the same output
                if vae_impl != "int8":
                    full = pipes["cuda"].predict_depth(q, sup, m, shot_mask=sm,
                                                       out_size=out_size)
                    check(np.array_equal(full.depth_colored,
                                         depth_output(raw_gpu).depth_colored),
                          f"{what}: predict_depth differs from its raw map's output")
                out[f"{vae_impl}_{'resized' if out_size else 'native'}"] = {
                    **stats, "kernel_launches": counts}
        finally:
            vae.MIXED_MIN_PIXELS = threshold
    return out


def _depth_full(card):
    """(b) full width, bf16, 512px, phase full's weights and episode."""
    import torch
    from diffews_tpu_torch.ops.resize import bilinear_resize
    from diffews_tpu_torch.pipeline import DiffewsPipeline, depth_output

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    pipe = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.bfloat16)
    q, sup, m = _episode(4, 1, 512, seed=2)
    res, launches = {}, {}
    same = lambda a, b: np.array_equal(a.depth_np, b.depth_np) and np.array_equal(
        a.depth_colored, b.depth_colored)
    for label, vae_impl, b, expect in (("depth_1shot_b4", "xla", 4, "xla"),
                                       ("depth_1shot_b4_auto", "auto", 4, "xla"),
                                       ("depth_1shot_b1_auto", "auto", 1, "auto_b1")):
        pipe.vae_impl = vae_impl
        args = (q[:b], sup[:b], m[:b])
        got, rec = _timed_run(lambda: pipe.predict_depth(*args), same,
                              EPISODE_LAUNCHES[expect], label, card)
        launches[label] = rec["kernel_launches"]
        check(got.depth_np.shape == (b, 512, 512) and got.depth_np.dtype == np.float32
              and np.isfinite(got.depth_np).all() and got.depth_colored.shape == (b, 512, 512, 3),
              f"{label}: depth {got.depth_np.shape} {got.depth_np.dtype}")
        with torch.inference_mode():
            raw = pipe.predict_depth_raw(*args)
            raw2 = pipe.predict_depth_raw(*args)
            x0 = pipe._x0_latent(*(pipe._put(x) for x in args), pipe.empty_text_embed, None, 1)
            img = pipe.vae.decode(x0, attn_impl=pipe.attn_impl,
                                  resnet_impl=pipe._decode_resnet_impl())
            ref = img.float().mean(dim=-1).clamp(-1.0, 1.0) * 0.5 + 0.5
        check(torch.equal(raw, raw2), f"{label}: a repeat of the raw map differs")
        check(torch.equal(raw, ref), f"{label}: the raw map differs from the channel mean of "
              "vae.decode(_x0_latent(...)) recomputed")
        check(same(depth_output(raw.cpu().numpy()), got),
              f"{label}: predict_depth differs from its raw map's host part")
        rec.update({"raw_min": raw.min().item(), "raw_max": raw.max().item(),
                    "depth_np_mean": float(got.depth_np.mean())})
        res[label] = rec
        emit({"phase": f"{label}_512px_bf16", **{k: v for k, v in rec.items() if k != "profile"}})

    # the bilinear resize: the card's against the CPU function on the same map,
    # and the entry point's out_size path against both
    pipe.vae_impl = "xla"
    with torch.inference_mode():
        raw = pipe.predict_depth_raw(q, sup, m)
        dev = bilinear_resize(raw[..., None], DEPTH_OUT_SIZE)[..., 0]
        host = bilinear_resize(raw.cpu()[..., None], DEPTH_OUT_SIZE)[..., 0]
        sized = pipe.predict_depth_raw(q, sup, m, out_size=DEPTH_OUT_SIZE)
    rerr = (dev.cpu() - host).abs().max().item()
    check(tuple(dev.shape) == (4,) + DEPTH_OUT_SIZE and rerr <= DEPTH_RESIZE_TOL,
          f"bilinear resize on the card vs the CPU: {rerr} (tolerance {DEPTH_RESIZE_TOL})")
    check(torch.equal(sized, dev), "predict_depth_raw(out_size) differs from the resize")
    res["resize_375x500"] = {"max_abs_card_vs_cpu": rerr, "tolerance": DEPTH_RESIZE_TOL}

    # 5-shot batch 1, shots 4 and 5 padded: their content changes no bit
    q5, sup5, m5 = _episode(1, 5, 512, seed=3)
    sm = np.array([[True, True, True, False, False]])
    sup_o, m_o = sup5.copy(), m5.copy()
    sup_o[:, 3:], m_o[:, 3:] = 255 - sup5[:, 3:], 1 - m5[:, 3:]
    with torch.inference_mode():
        a = pipe.predict_depth_raw(q5, sup5, m5, shot_mask=sm)
        b = pipe.predict_depth_raw(q5, sup_o, m_o, shot_mask=sm)
    check(torch.equal(a, b), "padded shots' content changed the bf16 depth map")
    res["five_shot_2padded_b1"] = {"bf16_padded_content_invariant": True}

    # walls: predict_depth against predict, in turns, three rounds each
    walls = {"predict_depth": [], "predict": []}
    calls = {"predict_depth": lambda: pipe.predict_depth(q, sup, m),
             "predict": lambda: pipe.predict(q, sup, m, r_threshold=0.25)}
    for rnd in range(3):
        for name in (("predict_depth", "predict") if rnd % 2 == 0
                     else ("predict", "predict_depth")):
            torch.cuda.synchronize()
            t0 = time.time()
            calls[name]()
            torch.cuda.synchronize()
            walls[name].append(time.time() - t0)
    prof = {name: profile_episode(fn) for name, fn in calls.items()}
    res["depth_vs_seg_b4"] = {
        name: {"wall_s": walls[name], "wall_s_median": statistics.median(walls[name]),
               "device_busy_ms": prof[name].get("device_busy_ms"),
               "device_idle_share": prof[name].get("device_idle_share"),
               "wall_ms_profiled": prof[name].get("wall_ms_profiled")}
        for name in calls}
    res["depth_vs_seg_b4"]["card"] = card
    emit({"phase": "depth_vs_predict_1shot_b4_512px_bf16", **res["depth_vs_seg_b4"]})
    return pipe, res, launches


def _depth_utils(pipe, card, tmp):
    """(c) the utils on the card: the batch sizer reads its memory, a
    trace of one depth episode names the flash forward kernel, and the
    stage timer waits for the card."""
    import torch
    from diffews_tpu_torch.utils import batchsize, profiling

    q, sup, m = _episode(4, 1, 512, seed=2)
    gib = batchsize.device_memory_gib("cuda")
    bs = {res: {dt: batchsize.find_batch_size(100, res, bf16=dt == "bf16")
                for dt in ("bf16", "f32")} for res in (512, 768)}
    want = {512: {"bf16": 48, "f32": 24}, 768: {"bf16": 20, "f32": 10}}
    check(gib >= 32 and bs == want, f"find_batch_size on a {gib:.1f} GiB card: {bs}, "
          f"expected the 32 GiB row {want}")
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir):
        with profiling.annotate("depth_episode"):
            pipe.predict_depth(q, sup, m)
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    text = "".join(open(f).read() for f in files)
    check(len(files) == 1 and "flash_fwd" in text and "depth_episode" in text,
          f"profiling.trace wrote {files} without the flash forward kernel or the annotation")
    torch.cuda.synchronize()
    t0 = time.time()
    torch.cuda._sleep(10 ** 8)
    torch.cuda.synchronize()
    cycles = int(0.3 * 10 ** 8 / (time.time() - t0))  # about 0.3 s of device time
    timers = {}
    for sync in (True, False):
        st = profiling.StageTimer(sync=sync, device="cuda")
        with st.stage("spin"):
            torch.cuda._sleep(cycles)
        timers[sync] = st.totals["spin"]
        torch.cuda.synchronize()
    check(timers[True] >= 0.2 > timers[False],
          f"StageTimer: {timers[True]:.3f} s with sync, {timers[False]:.3f} s without, "
          "for about 0.3 s of device work")
    return {"device_memory_gib": gib, "find_batch_size": bs, "trace_bytes": len(text),
            "stage_timer_s": {"sync": timers[True], "no_sync": timers[False]}, "card": card}


def _depth_clis(tmp, card):
    """(d) the port's CLIs on the card on a tiny tree: verify_parity
    --skip_golden's mIoU equals the eval CLI's on the same protocol, and
    measure_baseline --subject self times the eval CLI."""
    import contextlib
    import io

    import torch
    from diffews_tpu_torch.cli import evaluate, measure_baseline, verify_parity
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from helpers.port_checkpoint import write_checkpoint
    from helpers.synthetic_data import make_coco

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = os.path.join(tmp, "data")
    make_coco(data)
    ckpt = write_checkpoint(os.path.join(tmp, "tiny_ckpt"), UNetConfig.tiny(), VAEConfig.tiny(),
                            CLIPTextConfig.tiny(), SchedulerConfig.diffews(), seed=0)
    proto = ["--checkpoint", ckpt, "--datapath", data, "--benchmark", "coco", "--fold", "0",
             "--nshot", "1", "--img-size", "32", "--max_episodes", "8", "--device", "cuda"]
    vp_args = verify_parity.build_parser().parse_args(proto + ["--out", os.path.join(tmp, "vp"),
                                                               "--skip_golden"])
    t0 = time.time()
    rc = verify_parity.main(proto + ["--out", os.path.join(tmp, "vp"), "--skip_golden"])
    vp_s = time.time() - t0
    with open(os.path.join(tmp, "vp", "parity_report.json")) as f:
        report = json.load(f)
    miou, fb = evaluate.main(verify_parity.eval_argv(vp_args))
    check(rc == 0 and report["golden"]["status"] == "skipped"
          and report["miou"] == round(miou, 4) and report["fb_iou"] == round(fb, 4),
          f"verify_parity (rc {rc}) reported {report.get('miou')} / {report.get('fb_iou')}, "
          f"the eval CLI {miou} / {fb}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = measure_baseline.main(["--subject", "self", "--checkpoint", ckpt, "--datapath", data,
                                    "--img-size", "32", "--max_episodes", "60",
                                    "--log-root", os.path.join(tmp, "mb"), "--timeout", "300",
                                    "--device", "cuda"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and rec["markers"] >= 2 and rec["qps"] > 0,
          f"measure_baseline --subject self: rc {rc}, {rec}")
    return {"verify_parity": {"miou": report["miou"], "fb_iou": report["fb_iou"],
                              "eval_cli_miou": miou, "eval_cli_fb_iou": fb, "seconds": vp_s},
            "measure_baseline_self": rec, "card": card}


def phase_depth(card):
    """The depth head on the card: (a) tiny card vs CPU, (b) full width,
    (c) the utils, (d) the port's CLIs."""
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    res = {"tiny": _depth_tiny(card)}
    emit({"phase": "depth_tiny_card_vs_cpu", "dtype": "float32", "tf32": False, **res["tiny"]})
    pipe, res["full"], launches = _depth_full(card)
    with tempfile.TemporaryDirectory() as tmp:
        res["utils"] = _depth_utils(pipe, card, tmp)
        emit({"phase": "depth_utils_on_the_card", **res["utils"]})
        del pipe
        torch.cuda.empty_cache()
        res["clis"] = _depth_clis(tmp, card)
        emit({"phase": "depth_port_clis_on_the_card", **res["clis"]})
    RESULTS["depth"] = res
    return launches


# ---------------------------------------------------------------------------
# phase int8: W8A8 (vae_impl="int8", unet_int8)
# ---------------------------------------------------------------------------

PEAK_INT8 = 1979e12  # H100 SXM dense int8 tensor-core OP/s
# (B, H, W, Cin, Cout, stride): the encoder's first resnet convs, 1-shot b4
INT8_MAIN_SHAPE = (12, 512, 512, 128, 128, 1)


def _expect_int8(flash, gn, convs, linears):
    """Launch counts of an int8 path: a quantize before each int8 conv and
    each int8 linear, a `torch._int_mm` in each linear."""
    return {**_expect(flash, gn, 0), "quantize_s8": convs + linears, "conv2d_int8": convs,
            "int_mm": linears}


# W8A8 launches.  The SD VAE has 56 int8 convs (3x3, Cin >= 32): 24 in the
# encoder (16 resnet convs, 3 downsamples, 4 in the mid block, conv_out) and
# 32 in the decoder (4 mid, 24 resnet convs, 3 upsamplers, conv_out); the
# SD-2.1 UNet 128 int8 linears (8 in each of its 16 transformers: attn1
# q/k/v/out, the two feed-forward projections, proj_in, proj_out).  The
# graph is "xla"'s, so flash and GroupNorm launch as under "xla".  A capture
# runs the encoder (2 images) and the joint UNet; a cached predict the
# encoder, the query-only UNet and the decoder.
INT8_LAUNCHES = {"vae": _expect_int8(34, 94, 56, 0), "vae_unet": _expect_int8(34, 94, 56, 128),
                 "capture": _expect_int8(33, 65, 24, 128),
                 "cached": _expect_int8(18, 94, 56, 128)}


def _int8_conv_inputs(pipe, q, sup, m):
    """One input per distinct int8 conv call of the episode, recorded from
    the episode: {(B, H, W, Cin, Cout, stride, pads): (module, x)}, and the
    number of int8 conv calls."""
    from diffews_tpu_torch.ops import quant as Q

    seen, calls = {}, [0]

    def pre(mod, args, kwargs):
        x = args[0]
        pad = kwargs.get("padding", args[1] if len(args) > 1 else None)
        pads = Q._pads(mod.padding if pad is None else pad)
        key = tuple(x.shape) + (mod.out_channels, mod.stride, pads)
        seen.setdefault(key, (mod, x.detach()))
        calls[0] += 1

    hooks = [mod.register_forward_pre_hook(pre, with_kwargs=True)
             for mod in pipe.vae.modules() if isinstance(mod, Q.Int8Conv2d)]
    try:
        pipe.predict(q, sup, m)
    finally:
        for h in hooks:
            h.remove()
    return seen, calls[0]


def _int8_conv_rows(shapes):
    """(a) At every recorded shape, through the wrappers the int8 modules
    call (`quant.quantize_s8`, `quant.conv2d_int8`: scale selection, the
    custom ops, the padding as the episode passes it): the quantize against
    its plain version (the bf16 input and its f32 copy), the conv against
    `conv2d_int8_reference` of the plain codes, writing bf16 and f32, static
    and dynamic scales, bit for bit, and a repeat bit-identical; times
    (bf16, static) of the kernels alone (their launchers), of cuDNN's bf16
    conv at the shape, and of the plain versions at the main shape."""
    import torch
    import torch.nn.functional as F
    from diffews_tpu_torch.ops import quant as Q

    rows = []
    for key, (mod, x) in shapes.items():
        b, h, w, cin, cout, stride, pads = key
        pt, pb, pl, pr = pads
        padding = ((pt, pb), (pl, pr))
        for scale in ("static", "dynamic"):
            s_arg = mod.s_a if scale == "static" else None
            s = mod.s_a if scale == "static" else Q.dynamic_s_a(x)
            xq_ref = Q.quantize_s8_reference(x, s)
            check(torch.equal(Q.quantize_s8(x, s), xq_ref),
                  f"int8 quantize {key} {scale} bf16 differs")
            check(torch.equal(Q.quantize_s8(x.float(), s), xq_ref),
                  f"int8 quantize {key} {scale} f32 differs")
            # the plain version rounds once to the output dtype from f32
            want32 = Q.conv2d_int8_reference(xq_ref, mod.weight_q, mod.w_scale, s, mod.bias,
                                             stride, padding, torch.float32)
            for xin in (x, x.float()):
                want = want32.to(xin.dtype)
                conv = lambda: Q.conv2d_int8(xin, mod.weight_q, mod.w_scale, mod.bias,
                                             s_a=s_arg, stride=stride, padding=padding)
                y = conv()
                check(y.dtype == xin.dtype and torch.equal(y, want),
                      f"int8 conv {key} {scale} {xin.dtype}: max |Δ| "
                      f"{(y.float() - want.float()).abs().max().item()}")
                check(torch.equal(y, conv()), f"int8 conv {key} {scale} {xin.dtype}: a "
                                              "repeat differs")
            del want32, want, y
        s = mod.s_a
        xq = Q._quant_launch(x, s)
        conv = lambda: Q._conv_launch(xq, mod.weight_q, mod.w_scale, s, mod.bias, stride,
                                      pads, torch.bfloat16)
        y = conv()
        ho, wo = y.shape[1], y.shape[2]
        ms = cuda_ms(conv, reps=3, warmup=1, inner=3)
        q_ms = cuda_ms(lambda: Q._quant_launch(x, s), reps=3, warmup=1, inner=3)
        # cuDNN's bf16 conv at the shape (channels-last, dequantized weights)
        wc = (mod.weight_q.float() * mod.w_scale[:, None, None, None]).to(torch.bfloat16)
        wc = wc.permute(0, 3, 1, 2)
        xc, cpad = x.permute(0, 3, 1, 2), (pt, pl)
        if (pt, pl) != (pb, pr):  # the encoder's downsample: pad first, as `layers.conv2d`
            xc = F.pad(xc, (pl, pr, pt, pb)).contiguous(memory_format=torch.channels_last)
            cpad = 0
        bc = mod.bias.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: F.conv2d(xc, wc, bc, stride=stride, padding=cpad), reps=3,
                         warmup=1, inner=3)
        ops = 2.0 * b * ho * wo * cout * 9 * cin
        nbytes = b * h * w * cin + cout * 9 * cin + b * ho * wo * cout * 2 + cout * 8
        bound_ops, bound_bytes = ops / PEAK_INT8 * 1e3, nbytes / MEM_BW * 1e3
        q_bytes = b * h * w * cin * 3
        row = {"shape": [b, h, w, cin, cout], "stride": stride, "padding": list(pads),
               "ms": ms, "tops": ops / (ms * 1e-3) / 1e12,
               "bound_ms": max(bound_ops, bound_bytes),
               "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
               "share_of_bound": max(bound_ops, bound_bytes) / ms, "cudnn_bf16_ms": lib_ms,
               "quantize_ms": q_ms, "quantize_bound_ms": q_bytes / MEM_BW * 1e3,
               "max_abs_err": 0.0, "bit_identical": True}
        if (b, h, w, cin, cout, stride) == INT8_MAIN_SHAPE:
            row["plain_ms"] = cuda_ms(lambda: Q.conv2d_int8_reference(
                xq, mod.weight_q, mod.w_scale, s, mod.bias, stride, pads, torch.bfloat16),
                reps=2, warmup=1)
            row["quantize_plain_ms"] = cuda_ms(lambda: Q.quantize_s8_reference(x, s), reps=2,
                                               warmup=1)
        rows.append(row)
        del xq, y, wc, xc
    return rows


def _forced_tiny(pipes, call):
    """`call(pipe)` on the CPU recording each int8 site's codes, then on the
    card with the CPU's codes fed forward past each tie (one code at a tie
    moves a tiny random model's output by many uint8 counts, see
    `tests/helpers/int8_ties.py`): (CPU out, forced card out, per-site
    (share of codes that differ, max |diff|), the card run's launches)."""
    import torch
    from helpers import int8_force

    codes, stats = [], []
    with int8_force.recording(codes):
        cpu = call(pipes["cpu"])
    _zero_counts()
    with int8_force.force(codes, stats):
        gpu = call(pipes["cuda"])
        torch.cuda.synchronize()
    return cpu, gpu, stats, _launch_counts()


def _cached_vs_joint_forced(pipe, q2, sup, m):
    """f32 `unet_int8`: the cached path (a batch-1 cache of `sup`, `m`,
    under the 2 queries `q2`) against the joint episode of the 2 queries
    with the support set repeated, with the joint run's codes fed into the
    cached runs past each tie, row for row: the joint UNet's rows are [2
    support rows, 2 query rows]; the capture's [the support row, a zero
    dummy query] takes the joint's first support row (its dummy row keeps
    its own codes), the cached predict's [2 query rows] the joint's query
    rows.  Returns (joint, forced cached, unforced cached, tie stats)."""
    from helpers import int8_force

    joint_codes, stats = {}, []

    def record(own, name, x, s):
        joint_codes[name] = own(x, s)
        return joint_codes[name]

    def capture(own, name, x, s):
        mine = own(x, s)
        want = mine.clone()
        want[:1] = joint_codes[name][:1]
        stats.append(int8_force.tie_stats(mine[:1], want[:1]))
        return want

    def cached(own, name, x, s):
        mine, want = own(x, s), joint_codes[name][2:]
        stats.append(int8_force.tie_stats(mine, want))
        return want

    sup2, m2 = np.repeat(sup, 2, 0), np.repeat(m, 2, 0)
    with int8_force.by_site(pipe.unet, record):
        joint = pipe.predict(q2, sup2, m2, r_threshold=0.25)
    with int8_force.by_site(pipe.unet, capture):
        cache = pipe.precompute_supports(sup, m)
    with int8_force.by_site(pipe.unet, cached):
        got = pipe.predict_cached(q2, cache, r_threshold=0.25)
    free = pipe.predict_cached(q2, pipe.precompute_supports(sup, m), r_threshold=0.25)
    check(len(stats) == 2 * len(joint_codes), f"{len(stats)} forced sites, "
                                              f"{len(joint_codes)} joint sites")
    return joint, got, free, stats


def phase_int8(card):
    import torch
    from diffews_tpu_torch.checkpoint import random_pipeline_bundle
    from diffews_tpu_torch.cli import export
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from diffews_tpu_torch.ops import quant as Q
    from diffews_tpu_torch.pipeline import DiffewsPipeline
    from diffews_tpu_torch import serving
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    t0 = time.time()
    res = {"card": card}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    q, sup, m = _episode(4, 1, 512, seed=2)  # phase full's 1-shot b4 episode

    # (b) weights quantized on the card equal the same weights quantized on
    # the CPU: the pipeline's int8 VAE convs and UNet linears against the
    # CPU quantization of the seeded bf16 weights
    bundle = _full_bundle()
    cpu_w = {("vae", n): c.weight.detach().to(torch.bfloat16).cpu()
             for n, c in Q.conv_sites(bundle.vae).items()}
    cpu_w.update({("unet", n): c.weight.detach().to(torch.bfloat16).cpu()
                  for n, c in Q.linear_sites(bundle.unet).items()})
    t1 = time.time()
    both = DiffewsPipeline(bundle, device="cuda", compute_dtype=torch.bfloat16,
                           vae_impl="int8", unet_int8=True)
    torch.cuda.synchronize()
    res["setup_s_int8_vae_unet"] = time.time() - t1
    mods = {("vae", n): mm for n, mm in both.vae.named_modules()
            if isinstance(mm, Q.Int8Conv2d)}
    mods.update({("unet", n): mm for n, mm in both.unet.named_modules()
                 if isinstance(mm, Q.Int8Linear)})
    check(set(mods) == set(cpu_w) and len([k for k in mods if k[0] == "vae"]) == 56
          and len([k for k in mods if k[0] == "unet"]) == 128,
          f"int8 sites: {len(mods)} quantized, {len(cpu_w)} eligible (56 + 128)")
    for key, w in cpu_w.items():
        w8, s_w = Q.quantize_weight(w.permute(0, 2, 3, 1) if w.ndim == 4 else w,
                                    (1, 2, 3) if w.ndim == 4 else (1,))
        check(torch.equal(mods[key].weight_q.cpu(), w8)
              and torch.equal(mods[key].w_scale.cpu(), s_w),
              f"int8 weights of {key} quantized on the card differ from the CPU's")
    res["weights_card_equal_cpu"] = {"sites": len(cpu_w), "bit_identical": True}
    del bundle, cpu_w
    emit({"phase": "int8_weights_card_vs_cpu", **res["weights_card_equal_cpu"]})

    # (a) the kernels against their plain versions at every int8 conv shape
    # of the episode, recorded from it
    shapes, n_calls = _int8_conv_inputs(both, q, sup, m)
    check(n_calls == 56, f"the int8 episode made {n_calls} int8 conv calls (expected 56)")
    rows = _int8_conv_rows(shapes)
    del shapes
    torch.cuda.empty_cache()
    main = [r for r in rows if tuple(r["shape"]) + (r["stride"],) == INT8_MAIN_SHAPE][0]
    emit({"phase": "int8_kernels", "shapes": len(rows), "main": main, "card": card})
    for r in rows:
        emit({"phase": "int8_conv_row", **r})

    # (c) the full-width episodes: vae "int8", "int8" + unet_int8, and the
    # bf16 "xla" episode beside them
    t1 = time.time()
    vae8 = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.bfloat16,
                           vae_impl="int8")
    res["setup_s_int8_vae"] = time.time() - t1
    xla = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.bfloat16)
    runs = {"xla": (xla, EPISODE_LAUNCHES["xla"]), "int8": (vae8, INT8_LAUNCHES["vae"]),
            "int8_unet": (both, INT8_LAUNCHES["vae_unet"])}
    outs, eps = {}, {}
    for label, (pipe, expected) in runs.items():
        outs[label], eps[label] = _timed_run(
            lambda: pipe.predict(q, sup, m, r_threshold=0.25), _same_seg, expected,
            f"episode_1shot_b4_{label}", card)
    for label in ("int8", "int8_unet"):
        d = _diff_stats(outs[label].seg_colored, outs["xla"].seg_colored)
        eps[label].update({"mask_frac_differ_vs_xla": float((outs[label].mask
                                                             != outs["xla"].mask).mean()),
                           "seg_max_uint8_diff_vs_xla": d[0], "seg_frac_differ_vs_xla": d[1]})
    check(all(np.isfinite(o.seg_colored).all() and o.seg_colored.shape == (4, 512, 512, 3)
              for o in outs.values()), "int8 episode outputs")
    # in turns: walls of each, three rounds
    turns = {k: [] for k in runs}
    for rnd in range(3):
        for label in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t1 = time.time()
            runs[label][0].predict(q, sup, m, r_threshold=0.25)
            torch.cuda.synchronize()
            turns[label].append(time.time() - t1)
    res["episodes"] = {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                       for k, v in eps.items()}
    res["episode_busy"] = {k: {"device_busy_ms": v["profile"].get("device_busy_ms"),
                               "device_idle_share": v["profile"].get("device_idle_share"),
                               "device_ms_by_class": v["profile"].get("device_ms_by_class"),
                               "wall_s_in_turns": turns[k],
                               "wall_s_in_turns_median": statistics.median(turns[k])}
                           for k, v in eps.items()}
    emit({"phase": "int8_full_1shot_b4_512px_bf16", **res["episodes"], "card": card})
    emit({"phase": "int8_full_busy_in_turns", **res["episode_busy"], "card": card})
    del vae8, xla, outs
    torch.cuda.empty_cache()

    # (d) the cached path under unet_int8 (and the int8 VAE)
    cache1, cap = _timed_run(lambda: both.precompute_supports(sup[:1], m[:1]), _same_cache,
                             INT8_LAUNCHES["capture"], "int8_precompute_supports_1shot_b1", card)
    out4, cached = _timed_run(lambda: both.predict_cached(q, cache1, r_threshold=0.25),
                              _same_seg, INT8_LAUNCHES["cached"],
                              "int8_predict_cached_1shot_b4", card)
    copies = both.predict_cached(q, _repeat_cache(cache1, 4), r_threshold=0.25)
    check(_same_seg(copies, out4), "int8: a batch-1 cache under 4 queries differs from the "
                                   "batch-4 cache of 4 copies")
    res["cached"] = {"precompute_supports_1shot_b1": {k: v for k, v in cap.items()
                                                      if k != "profile"},
                     "predict_cached_1shot_b4": {k: v for k, v in cached.items()
                                                 if k != "profile"},
                     "bf16_batch1_cache_equals_4_copies": True}
    del both, cache1, copies
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p32 = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.float32,
                          unet_int8=True)
    j32, c32, free, stats = _cached_vs_joint_forced(p32, q[:2], sup[:1], m[:1])
    check(max(d for _, d in stats) <= 1 and max(sh for sh, _ in stats) <= 1e-3,
          f"int8 f32 cached vs joint: codes differ beyond ties: {stats}")
    mx, frac = _uint8_close(c32.seg_colored, j32.seg_colored,
                            "int8 f32 cached vs joint, the joint codes fed forward")
    flips = float((c32.mask != j32.mask).mean())
    check(flips < 0.01, f"int8 f32 cached vs joint: {flips:.4f} of mask pixels flip")
    fmx, ffrac = _diff_stats(free.seg_colored, j32.seg_colored)
    res["cached"]["f32_cached_vs_joint_unet_int8"] = {
        "forced_max_uint8_diff": mx, "forced_frac_differ": frac, "forced_mask_flips": flips,
        "sites": len(stats), "sites_with_ties": sum(sh > 0 for sh, _ in stats),
        "max_tie_share": max(sh for sh, _ in stats), "unforced_max_uint8_diff": fmx,
        "unforced_frac_differ": ffrac,
        "unforced_mask_flips": float((free.mask != j32.mask).mean())}
    emit({"phase": "int8_cached_512px", **res["cached"], "card": card})
    del p32
    torch.cuda.empty_cache()

    # (e) tiny f32 int8 episodes, the card against the CPU
    cfgs = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
            SchedulerConfig.diffews())
    tiny = {}
    for label, kw in (("vae_int8", {"vae_impl": "int8"}), ("unet_int8", {"unet_int8": True}),
                      ("unet_int8_attn_mask", {"unet_int8": True, "attn_mask_variant": True}),
                      ("vae_int8_unet_int8", {"vae_impl": "int8", "unet_int8": True})):
        pipes = {dev: DiffewsPipeline(random_pipeline_bundle(*cfgs, seed=0), device=dev, **kw)
                 for dev in ("cpu", "cuda")}
        tq, tsup, tm = _episode(2, 3, 32, seed=1)
        sm = np.array([[True, True, False], [True, True, True]])
        run = lambda p: p.predict(tq, tsup, tm, shot_mask=sm, r_threshold=0.25)
        free = run(pipes["cuda"])
        cpu, gpu, stats, counts = _forced_tiny(pipes, run)
        what = f"tiny int8 card vs CPU ({label})"
        check(counts["quantize_s8"] > 0 and (counts["conv2d_int8"] > 0) == ("vae_impl" in kw)
              and (counts["int_mm"] > 0) == ("unet_int8" in kw), f"{what}: launches {counts}")
        check(max(d for _, d in stats) <= 1 and max(s for s, _ in stats) <= 1e-3,
              f"{what}: codes differ beyond ties: {stats}")
        mx, frac = _uint8_close(gpu.seg_colored, cpu.seg_colored, what + ", forced")
        fmx, ffrac = _diff_stats(free.seg_colored, cpu.seg_colored)
        first = next((i for i, (s, _) in enumerate(stats) if s > 0), None)
        tiny[label] = {"forced_max_uint8_diff": mx, "forced_frac_differ": frac,
                       "sites": len(stats), "sites_with_ties": sum(s > 0 for s, _ in stats),
                       "max_tie_share": max(s for s, _ in stats), "first_tie_site": first,
                       "unforced_max_uint8_diff": fmx, "unforced_frac_differ": ffrac,
                       "unforced_mask_flips": float((free.mask != cpu.mask).mean()),
                       "kernel_launches": counts}
    res["tiny"] = tiny
    emit({"phase": "int8_tiny_card_vs_cpu", "dtype": "float32", "tf32": False, **tiny})

    # (f) the --vae_impl int8 artifact exported on the card equals the int8
    # predict bit for bit
    from helpers.port_checkpoint import write_checkpoint

    tmp = tempfile.mkdtemp(prefix="int8_art_")
    try:
        ckpt = write_checkpoint(os.path.join(tmp, "ckpt"), *cfgs, seed=0)
        out = export.main(["--checkpoint", ckpt, "--out", os.path.join(tmp, "art"), "--bsz",
                           "2", "--nshot", "1", "--img-size", "32", "--vae_impl", "int8"])
        art = serving.load(out)
        pipe = DiffewsPipeline.from_pretrained(ckpt, device="cuda", vae_impl="int8")
        tq, tsup, tm = _episode(2, 1, 32, seed=3)
        _zero_counts()
        got = art(tq, tsup, tm).cpu().numpy()
        counts = _launch_counts()
        n_conv = sum(isinstance(mm, Q.Int8Conv2d) for mm in pipe.vae.modules())
        check(counts["conv2d_int8"] == n_conv and counts["quantize_s8"] == n_conv,
              f"the int8 artifact launched {counts} ({n_conv} int8 convs)")
        check(np.array_equal(got, pipe.predict(tq, tsup, tm).seg_colored),
              "the int8 artifact exported on the card differs from the int8 predict")
        res["artifact_tiny_f32"] = {"equals_predict": True, "kernel_launches": counts}
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "int8_artifact_card", **res["artifact_tiny_f32"]})
    res["rows"] = rows
    res["seconds"] = time.time() - t0
    emit({"phase": "int8", "seconds": res["seconds"]})
    RESULTS["int8"] = res
    launches = {"episode_1shot_b4_int8": eps["int8"]["kernel_launches"],
                "episode_1shot_b4_int8_unet_int8": eps["int8_unet"]["kernel_launches"],
                "int8_precompute_supports_1shot_b1": cap["kernel_launches"],
                "int8_predict_cached_1shot_b4": cached["kernel_launches"]}
    return rows, launches


# launches of cached-support serving by (`vae_impl`, call).  A capture runs
# the encoder (1 flash launch in its mid block, 21 GroupNorm+SiLU sites) and
# the joint UNet over the support rows and a dummy query (16 sites x 2 flash
# launches, 44 GroupNorm+SiLU sites) and no decoder; a cached predict runs
# the encoder, the query-only UNet (16 flash launches) and the decoder (1
# flash launch, 29 GroupNorm+SiLU sites).  "auto" fuses an encode of <= 4
# images (21 fused convs in place of the encoder's 21 GroupNorm launches):
# the 1-shot capture (2 images) and the batch-4 and batch-1 predicts, not the
# 5-shot capture (10 images).
CACHED_LAUNCHES = {
    ("xla", "capture"): _expect(33, 65, 0), ("xla", "predict"): _expect(18, 94, 0),
    ("auto", "capture_small"): _expect(33, 44, 21), ("auto", "capture"): _expect(33, 65, 0),
    ("auto", "predict"): _expect(18, 73, 21),
}
CACHE_SITES = 16  # fused self-attention sites of the SD-2.1 UNet


def _same_cache(a, b) -> bool:
    import torch

    return len(a.entries) == len(b.entries) and all(
        (x is None and y is None) or torch.equal(x, y)
        for ea, eb in zip(a.entries, b.entries) for x, y in zip(ea, eb))


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for e in cache.entries for t in e if t is not None)


def _repeat_cache(cache, b):
    """The batch-b cache made of b copies of a batch-1 cache's entries."""
    from diffews_tpu_torch.pipeline import SupportCache

    rep = lambda t: None if t is None else t.repeat((b,) + (1,) * (t.ndim - 1))
    return SupportCache(entries=tuple(tuple(rep(t) for t in e) for e in cache.entries),
                        shot_mask=rep(cache.shot_mask), n_shots=cache.n_shots, batch=b)


def phase_cached(card):
    import torch
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.time()
    pipe = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    res = {"setup_s": time.time() - t0}
    joint = RESULTS.get("full", {}).get("one_shot_b4", {})
    res["joint_episode_1shot_b4"] = {k: joint.get(k) for k in ("wall_s_median", "wall_s")}
    res["joint_episode_1shot_b4"]["device_busy_ms"] = joint.get("profile", {}).get(
        "device_busy_ms")
    q, sup, m = _episode(4, 1, 512, seed=2)     # phase full's 1-shot episode
    q5, sup5, m5 = _episode(1, 5, 512, seed=3)  # and its 5-shot one
    sm = np.array([[True, True, True, False, False]])
    sup_o, m_o = sup5.copy(), m5.copy()
    sup_o[:, 3:], m_o[:, 3:] = 255 - sup5[:, 3:], 1 - m5[:, 3:]
    paths = {}
    slim = lambda rec: {k: v for k, v in rec.items() if k != "profile"}
    for vae_impl in ("xla", "auto"):
        pipe.vae_impl = vae_impl
        tag = "" if vae_impl == "xla" else "_auto"
        small = "capture_small" if vae_impl == "auto" else "capture"
        runs = {}
        # the caches: one shot at batch 1; five shots, the last two padded
        cache1, runs["precompute_supports_1shot_b1"] = _timed_run(
            lambda: pipe.precompute_supports(sup[:1], m[:1]), _same_cache,
            CACHED_LAUNCHES[vae_impl, small], f"precompute_supports_1shot_b1{tag}", card)
        cache5, runs["precompute_supports_5shot_2padded_b1"] = _timed_run(
            lambda: pipe.precompute_supports(sup5, m5, shot_mask=sm), _same_cache,
            CACHED_LAUNCHES[vae_impl, "capture"], f"precompute_supports_5shot_b1{tag}", card)
        for name, cache, n in (("1shot", cache1, 1), ("5shot", cache5, 5)):
            ok = len(cache.entries) == CACHE_SITES and all(
                k.is_contiguous() and v.is_contiguous() and bias is None
                and k.shape[:2] == (1, n) and k.dtype == torch.bfloat16
                and k.untyped_storage().nbytes() == k.numel() * k.element_size()
                for k, v, bias in cache.entries)
            check(ok, f"{name} cache: {len(cache.entries)} entries, shapes "
                      f"{[tuple(e[0].shape) for e in cache.entries]}")
        runs["precompute_supports_1shot_b1"]["cache_bytes"] = _cache_bytes(cache1)
        runs["precompute_supports_5shot_2padded_b1"]["cache_bytes"] = _cache_bytes(cache5)
        # the cached predicts
        expect = CACHED_LAUNCHES[vae_impl, "predict"]
        out4, runs["predict_cached_1shot_b4"] = _timed_run(
            lambda: pipe.predict_cached(q, cache1, r_threshold=0.25), _same_seg, expect,
            f"predict_cached_1shot_b4{tag}", card)
        out1, runs["predict_cached_1shot_b1"] = _timed_run(
            lambda: pipe.predict_cached(q[:1], cache1, r_threshold=0.25), _same_seg, expect,
            f"predict_cached_1shot_b1{tag}", card)
        out5, runs["predict_cached_5shot_2padded_b1"] = _timed_run(
            lambda: pipe.predict_cached(q5, cache5, r_threshold=0.25), _same_seg, expect,
            f"predict_cached_5shot_b1{tag}", card)
        check(out4.seg_colored.shape == (4, 512, 512, 3) and out4.seg_colored.dtype == np.uint8
              and out4.mask.shape == (4, 512, 512) and out4.mask.dtype == bool,
              f"cached seg {out4.seg_colored.shape} {out4.seg_colored.dtype}")
        # bf16, exact: the padded shots' content reaches no output bit
        other = pipe.predict_cached(q5, pipe.precompute_supports(sup_o, m_o, shot_mask=sm),
                                    r_threshold=0.25)
        check(_same_seg(other, out5), f"padded shots' content changed the cached bf16 "
                                      f"prediction (vae_impl={vae_impl})")
        # bf16, exact: the batch-1 cache under 4 queries equals the batch-4
        # cache made of 4 copies of its entries
        copies = pipe.predict_cached(q, _repeat_cache(cache1, 4), r_threshold=0.25)
        check(_same_seg(copies, out4), "a batch-1 cache under 4 queries differs from the "
                                       f"batch-4 cache of 4 copies (vae_impl={vae_impl})")
        # reported: against the cache captured from 4 copies of the support
        # set, against the joint episode and against the batch-1 cached
        # predict; all run the VAE or UNet at another batch shape, which in
        # bf16 with random weights moves outputs by tens of counts
        cap4 = pipe.precompute_supports(np.repeat(sup[:1], 4, 0), np.repeat(m[:1], 4, 0))
        d_cap4 = _diff_stats(pipe.predict_cached(q, cap4, r_threshold=0.25).seg_colored,
                             out4.seg_colored)
        d_joint = _diff_stats(pipe.predict(q, np.repeat(sup[:1], 4, 0), np.repeat(m[:1], 4, 0),
                                           r_threshold=0.25).seg_colored, out4.seg_colored)
        d_b1 = _diff_stats(out1.seg_colored[0], out4.seg_colored[0])
        del cap4, other, copies
        held = {
            "bf16_repeat_bit_identical": True, "bf16_padded_content_invariant": True,
            "bf16_batch1_cache_equals_4_copies": True,
            "bf16_vs_cache_captured_at_batch4": {"max_uint8_diff": d_cap4[0],
                                                 "frac_differ": d_cap4[1]},
            "bf16_vs_joint_episode": {"max_uint8_diff": d_joint[0], "frac_differ": d_joint[1]},
            "bf16_b1_vs_b4_row0": {"max_uint8_diff": d_b1[0], "frac_differ": d_b1[1]}}
        emit({"phase": f"cached_512px_bf16_{vae_impl}",
              **{k: slim(v) for k, v in runs.items()}, **held})
        res[vae_impl] = {**runs, **held}
        paths.update({k + tag: v["kernel_launches"] for k, v in runs.items()})
        del cache1, cache5
    del pipe
    torch.cuda.empty_cache()

    # f32, TF32 off: cached equals the joint episode within one uint8 count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe32 = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.float32)
    res["f32_cached_vs_joint"] = {}
    sup2, m2 = np.repeat(sup[:1], 2, 0), np.repeat(m[:1], 2, 0)
    for label, qq, cargs, jargs, kw in (
            ("1shot_batch1_cache_under_b2", q[:2], (sup[:1], m[:1]), (sup2, m2), {}),
            ("5shot_2padded_b1", q5, (sup5, m5), (sup5, m5), {"shot_mask": sm})):
        cached = pipe32.predict_cached(qq, pipe32.precompute_supports(*cargs, **kw),
                                       r_threshold=0.25)
        full = pipe32.predict(qq, *jargs, r_threshold=0.25, **kw)
        mx, frac = _uint8_close(cached.seg_colored, full.seg_colored,
                                f"f32 cached vs joint ({label})")
        flips = float((cached.mask != full.mask).mean())
        check(flips < 0.01, f"f32 cached vs joint ({label}): {flips:.4f} of mask pixels flip")
        res["f32_cached_vs_joint"][label] = {"max_uint8_diff": mx, "frac_differ": frac,
                                             "mask_flips": flips}
    emit({"phase": "cached_512px_f32_vs_joint", "tf32": False, **res["f32_cached_vs_joint"]})
    del pipe32
    torch.cuda.empty_cache()
    RESULTS["cached"] = res
    return paths


def _unraw(ent) -> np.ndarray:
    import base64

    return np.frombuffer(base64.b64decode(ent["raw"]), np.uint8).reshape(ent["shape"])


def _contract(got: dict, want: dict, what: str):
    """Two daemons' answers within the episode contract: segs within one
    uint8 count on < 1% of pixels, masks differing only where the seg does."""
    mx = frac = 0
    for i, (sg, sw) in enumerate(zip(got["seg"], want["seg"])):
        a, b = _unraw(sg), _unraw(sw)
        m1, f1 = _uint8_close(a, b, f"{what}, query {i}")
        mx, frac = max(mx, m1), max(frac, f1)
        flips = _unraw(got["masks"][i]) != _unraw(want["masks"][i])
        check(not flips[(a == b).all(-1)].any(),
              f"{what}, query {i}: masks differ where the segs agree")
    return mx, frac


def _serve_tiny(tmp):
    """(a) The daemon from a tiny port-written checkpoint on the card and on
    the CPU (`make_server` with `--device`), f32 with TF32 off, under
    `vae_impl` "xla" and "auto": one-off, supports.add + cached, and four
    single-query cached requests coalesced by the card's micro-batcher."""
    import threading

    import torch
    from diffews_tpu_torch.cli import serve
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from helpers.port_checkpoint import write_checkpoint
    import cuda_serve_bench as SB

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt = write_checkpoint(os.path.join(tmp, "tiny_ckpt"), UNetConfig.tiny(), VAEConfig.tiny(),
                            CLIPTextConfig.tiny(), SchedulerConfig.diffews(), seed=0)
    q, sup, m = _episode(4, 1, 32, seed=7)
    enc = lambda xs: [SB.raw(x) for x in xs]
    out = {}
    for vae_impl in ("xla", "auto"):
        servers = {dev: serve.make_server(serve.build_parser().parse_args(
            ["--checkpoint", ckpt, "--device", dev, "--img-size", "32", "--bsz", "4",
             "--nshot", "2", "--batch_buckets", "1,2,4", "--vae_impl", vae_impl]))
            for dev in ("cpu", "cuda")}
        servers["cuda"].batch_window = 0.3
        res = {}
        for dev, ms in servers.items():
            _zero_counts()
            r = {"oneoff": ms.segment({"query": enc(q[:2]), "supports": enc(sup[0, :1]),
                                       "masks": enc(m[0, :1]), "return_seg": True,
                                       "encoding": "raw"})}
            cid = ms.add_supports({"images": enc(sup[0, :1]), "masks": enc(m[0, :1])})["cache_id"]
            r["cached"] = ms.segment({"query": enc(q[:3]), "cache_id": cid, "return_seg": True,
                                      "encoding": "raw"})
            singles = [None] * 4
            barrier = threading.Barrier(4)

            def one(i, ms=ms, cid=cid, singles=singles, barrier=barrier):
                barrier.wait()
                singles[i] = ms.segment({"query": enc(q[i:i + 1]), "cache_id": cid,
                                         "return_seg": True, "encoding": "raw"})

            threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
            [t.start() for t in threads]
            [t.join() for t in threads]
            r["coalesced"] = {k: [s[k][0] for s in singles] for k in ("seg", "masks")}
            r["device_calls"] = ms.stats.snapshot()["device_calls"]
            r["counts"] = _launch_counts()
            res[dev] = r
        counts = res["cuda"]["counts"]
        what = f"serve tiny GPU vs CPU ({vae_impl})"
        check(counts["flash_attention_fwd"] > 0 and counts["gn_apply"] > 0
              and (counts["fused_gn_silu_conv3x3"] > 0) == (vae_impl == "auto"),
              f"{what}: kernel launches {counts}")
        # 1 one-off, 1 supports.add, 1 cached, the coalesced window: < 4 calls
        check(res["cuda"]["device_calls"] < 3 + 4,
              f"{what}: {res['cuda']['device_calls']} device calls: no coalescing")
        rec = {"kernel_launches": counts, "device_calls_cuda": res["cuda"]["device_calls"]}
        for kind in ("oneoff", "cached", "coalesced"):
            rec[kind] = dict(zip(("max_uint8_diff", "frac_differ"),
                                 _contract(res["cuda"][kind], res["cpu"][kind],
                                           f"{what}, {kind}")))
        out[vae_impl] = rec
    return out


SERVE_PX = 512  # phase serve's image size


def _serve_load(pipe, sup1, m1, frames, card):
    """(b) Load through the daemon's HTTP API (`tools/cuda_serve_bench.py`):
    a fresh daemon per setting, so its `/v1/stats` window holds that run."""
    from diffews_tpu_torch.cli import serve
    import cuda_serve_bench as SB

    def daemon(window, depth):
        return serve.ModelServer(pipe=pipe, bsz=4, nshot=1, img_size=SERVE_PX, r_threshold=0.25,
                                 batch_window_ms=window, dispatch_depth=depth,
                                 batch_buckets="1,2,4", model_desc="random-init sd21")

    runs = {}
    # window 0 serves one query a call (≈ 3.5–4 q/s): 2 requests a client
    # there keep the phase's time, 4 elsewhere (3 / 6 before phase multi
    # took (d) and (e))
    for name, window, depth, mode, oneoff, clients in (
            ("cached_w0_png", 0, 2, "png", False, 16), ("cached_w30_png", 30, 2, "png", False, 16),
            ("cached_w0_raw", 0, 2, "raw", False, 16), ("cached_w30_raw", 30, 2, "raw", False, 16),
            ("cached_w30_raw_depth1", 30, 1, "raw", False, 16),
            ("oneoff_w0_png", 0, 2, "png", True, 4)):
        ms = daemon(window, depth)
        httpd, base = SB.start_daemon(ms)
        try:
            enc = SB.raw if mode == "raw" else SB.png
            if oneoff:
                bodies = [{"query": enc(f), "supports": [enc(sup1)], "masks": [enc(m1 * 255)]}
                          for f in frames]
            else:
                cid = SB.post(base, "/v1/supports", {"images": [enc(sup1)],
                                                     "masks": [enc(m1 * 255)]})["cache_id"]
                bodies = [{"query": enc(f), "cache_id": cid} for f in frames]
            if mode == "raw":
                bodies = [{**b, "encoding": "raw"} for b in bodies]
            SB.post(base, "/v1/segment", bodies[0])
            reqs = 2 if window == 0 and not oneoff else 4
            run = SB.http_run(base, bodies, clients=clients, reqs=reqs)
            if name == "cached_w30_raw":
                run["profile"] = profile_episode(
                    lambda: SB.http_run(base, bodies, clients=clients, reqs=2))
                run["replay"] = SB.replay(ms, cid, frames, clients=clients, reqs=4)
                run["bare_predict_cached"] = {
                    f"b{b}": SB.bare_rate(pipe, ms._caches[cid], b, SERVE_PX) for b in (4, 1)}
                run["dispatch_probe"] = SB.dispatch_probe(pipe, ms._caches[cid], SERVE_PX)
        finally:
            httpd.shutdown()
            httpd.server_close()
        check(run["errors"] == 0 and run["ok"] == clients * reqs,
              f"serve load {name}: {run['errors']} errors, first {run['first_error']}")
        runs[name] = {"window_ms": window, "dispatch_depth": depth, "payload": mode,
                      "requests_per_client": reqs,
                      "request": "one-off episode" if oneoff else "cached", **run, "card": card}
        emit({"phase": f"serve_load_{name}", **{k: v for k, v in runs[name].items()
                                                if k != "profile"},
              **({"device_busy_ms": run["profile"].get("device_busy_ms"),
                  "device_idle_share": run["profile"].get("device_idle_share"),
                  "wall_ms_profiled": run["profile"].get("wall_ms_profiled")}
                 if "profile" in run else {})})
    return runs


_ARTIFACT_CHILD = """
import json, sys, time
import numpy as np
t0 = time.time()
import diffews_tpu_torch.serving as serving
mod = serving.load(sys.argv[1])
load_s = time.time() - t0
e = np.load(sys.argv[2])
fa = sys.modules["diffews_tpu_torch.ops.flash_attention"].flash_attention
gn = sys.modules["diffews_tpu_torch.ops.groupnorm"]
t0 = time.time()
out = mod(e["q"], e["sup"], e["msk"], e["sm"]).cpu().numpy()
call_s = time.time() - t0
np.save(sys.argv[3], out)
print(json.dumps({"load_s": load_s, "first_call_s": call_s, "device": str(mod.device),
                  "launches": {"flash_attention_fwd": fa.launches,
                               "gn_stats": gn.gn_stats_kernel.launches,
                               "gn_apply": gn.gn_apply_kernel.launches},
                  "jax_or_reference_loaded": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith("jax.") or m == "diffews_tpu"
                      or m.startswith("diffews_tpu."))}))
"""


def _serve_artifact(pipe, tmp, q, sup1, m1, card):
    """(c) The full-width bf16 1-shot b4 artifact exported on the card, loaded
    in a fresh process that imports only `diffews_tpu_torch.serving`, and in
    this one; a daemon in artifact mode."""
    import torch
    from diffews_tpu_torch import serving
    from diffews_tpu_torch.cli import serve
    import cuda_serve_bench as SB

    art = os.path.join(tmp, "artifact")
    t0 = time.time()
    program, manifest = serving.export_predict(pipe, bsz=4, nshot=1, img_size=SERVE_PX)
    export_s = time.time() - t0
    serving.write_artifact(program, manifest, art)
    save_s = time.time() - t0 - export_s
    nbytes = sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art))
    sup = np.ascontiguousarray(np.broadcast_to(sup1, (4, 1) + sup1.shape))
    msk = np.ascontiguousarray(np.broadcast_to(m1, (4, 1) + m1.shape))
    sm = np.ones((4, 1), bool)
    np.savez(os.path.join(tmp, "episode.npz"), q=q, sup=sup, msk=msk, sm=sm)
    t0 = time.time()
    child = subprocess.run([sys.executable, "-c", _ARTIFACT_CHILD, art,
                            os.path.join(tmp, "episode.npz"), os.path.join(tmp, "child.npy")],
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                           capture_output=True, text=True, timeout=600)
    child_s = time.time() - t0
    check(child.returncode == 0, f"artifact child process failed: {child.stderr[-3000:]}")
    child_rec = json.loads(child.stdout.strip().splitlines()[-1])
    check(not child_rec["jax_or_reference_loaded"] and child_rec["device"] == "cuda"
          and child_rec["launches"]["flash_attention_fwd"] == 34
          and child_rec["launches"]["gn_stats"] == 94 and child_rec["launches"]["gn_apply"] == 94,
          f"artifact child: {child_rec}")
    child_out = np.load(os.path.join(tmp, "child.npy"))

    # this process calls the program it exported (the fresh process above
    # loaded the saved one)
    mod = serving.ServingModule(program, manifest)
    _zero_counts()
    got = mod(q, sup, msk, sm).cpu().numpy()
    counts = _launch_counts()
    check(counts == EPISODE_LAUNCHES["xla"], f"artifact call launched {counts}")
    want = pipe.predict(q, sup, msk, shot_mask=sm, r_threshold=0.25).seg_colored
    no_mask = pipe.predict(q, sup, msk, r_threshold=0.25).seg_colored
    d_pred, d_child = _diff_stats(got, want), _diff_stats(child_out, got)
    check(d_pred == (0, 0.0) and d_child == (0, 0.0),
          f"artifact vs predict {d_pred}, fresh process vs this one {d_child}")

    ms = serve.ModelServer(artifact=mod, bsz=4, nshot=1, img_size=SERVE_PX, r_threshold=0.25,
                           model_desc="artifact")
    httpd, base = SB.start_daemon(ms)
    try:
        resp = SB.post(base, "/v1/segment", {
            "query": [SB.raw(x) for x in q], "supports": [SB.raw(sup1)],
            "masks": [SB.raw(m1)], "return_seg": True, "encoding": "raw"})
        try:
            SB.post(base, "/v1/supports", {"images": [SB.raw(sup1)], "masks": [SB.raw(m1)]})
            add = None
        except Exception as e:  # noqa: BLE001  (the expected 400)
            add = getattr(e, "code", repr(e))
    finally:
        httpd.shutdown()
        httpd.server_close()
    check(all(np.array_equal(_unraw(s), got[i]) for i, s in enumerate(resp["seg"])),
          "the artifact daemon's one-off answer differs from the artifact's output")
    check(add == 400, f"supports.add in artifact mode: {add}")

    # the artifact call's wall and predict's, b4, in turns
    walls = {"artifact": [], "predict": []}
    for rnd in range(3):
        for name in (("artifact", "predict") if rnd % 2 == 0 else ("predict", "artifact")):
            torch.cuda.synchronize()
            t0 = time.time()
            if name == "artifact":
                mod(q, sup, msk, sm).cpu()
            else:
                pipe.predict(q, sup, msk, shot_mask=sm, r_threshold=0.25)
            walls[name].append(time.time() - t0)
    del mod, ms, program
    torch.cuda.empty_cache()
    return {"export_s": export_s, "save_s": save_s, "artifact_bytes": nbytes,
            "child_process_s": child_s,
            "child": child_rec, "kernel_launches": counts,
            "artifact_equals_predict": True, "fresh_process_equals_this_one": True,
            "predict_with_all_true_shot_mask_equals_without": _diff_stats(want, no_mask)
            == (0, 0.0),
            "walls_s": walls, "wall_s_median": {k: statistics.median(v)
                                                for k, v in walls.items()},
            "daemon_artifact_oneoff_equals_artifact": True, "daemon_supports_add_status": add,
            "card": card}


def phase_serve(card):
    """The serving daemon (`diffews_tpu_torch.cli.serve`) and the AOT
    serving artifact (`diffews_tpu_torch.serving`) on the card."""
    import tempfile

    import torch
    from diffews_tpu_torch.cli import serve
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import cuda_serve_bench as SB

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["tiny"] = _serve_tiny(tmp)
        emit({"phase": "serve_tiny", "dtype": "float32", "tf32": False, **res["tiny"]})

        # (b) full width, bf16, 512px, vae_impl "xla"
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        pipe = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.bfloat16)
        ms = serve.ModelServer(pipe=pipe, bsz=4, nshot=1, img_size=SERVE_PX, r_threshold=0.25,
                               batch_buckets="1,2,4", model_desc="random-init sd21")
        torch.cuda.synchronize()
        t0 = time.time()
        ms.warm_start()
        torch.cuda.synchronize()
        res["warm_start_s"] = time.time() - t0
        q, sup, m = _episode(4, 1, SERVE_PX, seed=2)  # phase full's episode
        sup1, m1 = sup[0, 0], m[0, 0]
        httpd, base = SB.start_daemon(ms)
        paths = {}
        try:
            def counted(path, body):
                _zero_counts()
                out = SB.post(base, path, body)
                torch.cuda.synchronize()
                return out, _launch_counts()

            raw_q = [SB.raw(x) for x in q]
            oneoff, paths["serve_oneoff_b4"] = counted("/v1/segment", {
                "query": raw_q, "supports": [SB.raw(sup1)], "masks": [SB.raw(m1)],
                "return_seg": True, "encoding": "raw"})
            sup4 = np.broadcast_to(sup1, (4, 1) + sup1.shape)
            m4 = np.broadcast_to(m1.astype(np.float32), (4, 1) + m1.shape)
            bare = pipe.predict(q, sup4, m4, r_threshold=0.25)
            check(all(np.array_equal(_unraw(s), bare.seg_colored[i])
                      and np.array_equal(_unraw(k) > 0, bare.mask[i])
                      for i, (s, k) in enumerate(zip(oneoff["seg"], oneoff["masks"]))),
                  "the daemon's one-off b4 answer differs from a bare predict")
            added, paths["serve_supports_add"] = counted(
                "/v1/supports", {"images": [SB.raw(sup1)], "masks": [SB.raw(m1)]})
            cache = ms._caches[added["cache_id"]]
            for n in (4, 1):
                got, paths[f"serve_cached_b{n}"] = counted("/v1/segment", {
                    "query": raw_q[:n], "cache_id": added["cache_id"], "return_seg": True,
                    "encoding": "raw"})
                want = pipe.predict_cached(q[:n], cache, r_threshold=0.25)
                check(all(np.array_equal(_unraw(s), want.seg_colored[i])
                          for i, s in enumerate(got["seg"])),
                      f"the daemon's cached b{n} answer differs from predict_cached")
        finally:
            httpd.shutdown()
            httpd.server_close()
        for path, counts in paths.items():
            expect = {"serve_oneoff_b4": EPISODE_LAUNCHES["xla"],
                      "serve_supports_add": CACHED_LAUNCHES["xla", "capture"]}.get(
                          path, CACHED_LAUNCHES["xla", "predict"])
            check(counts == expect, f"{path} launched {counts}, expected {expect}")
        res["paths"] = paths
        emit({"phase": "serve_512px_bf16_exact", "warm_start_s": res["warm_start_s"],
              "launches": paths, "oneoff_equals_predict": True,
              "cached_equals_predict_cached": True, "card": card})

        frames = [_episode(1, 1, SERVE_PX, seed=20 + i)[0][0] for i in range(4)]
        res["load"] = _serve_load(pipe, sup1, m1, frames, card)

        # a cold daemon (kernels already built in this process): the first
        # cached request's latency, and the second's
        torch.cuda.empty_cache()
        cold = serve.ModelServer(pipe=pipe, bsz=4, nshot=1, img_size=SERVE_PX, r_threshold=0.25,
                                 batch_buckets="1,2,4")
        httpd, base = SB.start_daemon(cold)
        try:
            cid = SB.post(base, "/v1/supports", {"images": [SB.raw(sup1)],
                                                 "masks": [SB.raw(m1)]})["cache_id"]
            lat = []
            for i in range(2):
                t0 = time.time()
                SB.post(base, "/v1/segment", {"query": SB.raw(frames[i]), "cache_id": cid})
                lat.append(time.time() - t0)
        finally:
            httpd.shutdown()
            httpd.server_close()
        res["cold_daemon_cached_request_s"] = {"first": lat[0], "second": lat[1]}
        emit({"phase": "serve_cold_daemon", **res["cold_daemon_cached_request_s"],
              "card": card})

        res["artifact"] = _serve_artifact(pipe, tmp, q, sup1, m1, card)
        paths["artifact_call_b4"] = res["artifact"]["kernel_launches"]
        emit({"phase": "serve_artifact_512px_bf16", **res["artifact"]})
        del pipe, ms, cache
        torch.cuda.empty_cache()
    RESULTS["serve"] = res
    return paths


EVAL_BATCHES = 8  # batches of each full-width harness run (16 before phase multi took (d), (e))


def _eval_argv(data, logs, *extra):
    return ["--checkpoint", "unused", "--datapath", data, "--benchmark", "coco",
            "--fold", "0", "--nshot", "1", "--threshold", "0", "--r_threshold", "0.25",
            "--log-root", logs, *extra]


class _KeepSeg:
    """The pipeline as the harness sees it, keeping every batch: its inputs,
    the kernel launches of its `predict_async`, the host time that call took
    and the `SegOutput` the harness drained (seg included)."""

    def __init__(self, pipe):
        self.pipe, self.calls = pipe, []

    def predict_async(self, *args, **kw):
        before = _launch_counts()
        t0 = time.time()
        pending = self.pipe.predict_async(*args, **kw)
        rec = {"args": args, "kw": kw, "host_s": time.time() - t0,
               "launches": {k: v - before[k] for k, v in _launch_counts().items()}}
        self.calls.append(rec)
        result = pending.result

        def keep(need_seg=True):
            rec["out"] = result(need_seg=True)
            return rec["out"]

        pending.result = keep
        return pending


def _eval_tiny(tmp, data):
    """The CLI from a tiny port-written checkpoint on the card and on the
    CPU, f32 with TF32 off, 8 episodes at 32px, under "xla" and "auto":
    equal metrics, every episode within the episode contract."""
    import torch
    from diffews_tpu_torch import pipeline as TP
    from diffews_tpu_torch.cli import evaluate as TE
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from helpers.port_checkpoint import write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt = write_checkpoint(os.path.join(tmp, "tiny_ckpt"), UNetConfig.tiny(), VAEConfig.tiny(),
                            CLIPTextConfig.tiny(), SchedulerConfig.diffews(), seed=0)
    out = {}
    orig = TP.PendingSeg.result
    for vae_impl in ("xla", "auto"):
        res = {}
        for dev in ("cpu", "cuda"):
            segs = []

            def keep(self, need_seg=True):
                segs.append(orig(self, need_seg))
                return segs[-1]

            argv = _eval_argv(data, os.path.join(tmp, "logs_tiny"), "--img-size", "32",
                              "--max_episodes", "8", "--vae_impl", vae_impl)
            argv[argv.index("--checkpoint") + 1] = ckpt
            TP.PendingSeg.result = keep
            try:
                _zero_counts()
                metrics = TE.main(argv + ["--device", dev])
                counts = _launch_counts()
            finally:
                TP.PendingSeg.result = orig
            res[dev] = (metrics, segs, counts)
        what = f"eval tiny GPU vs CPU ({vae_impl})"
        (m_cpu, s_cpu, _), (m_gpu, s_gpu, counts) = res["cpu"], res["cuda"]
        check(len(s_cpu) == len(s_gpu) == 8, f"{what}: {len(s_cpu)} / {len(s_gpu)} episodes")
        check(counts["flash_attention_fwd"] > 0 and counts["gn_apply"] > 0
              and (counts["fused_gn_silu_conv3x3"] > 0) == (vae_impl == "auto"),
              f"{what}: kernel launches {counts}")
        mx = frac = flips = 0
        for i, (a, b) in enumerate(zip(s_gpu, s_cpu)):
            m1, f1 = _uint8_close(a.seg_colored, b.seg_colored, f"{what}, episode {i}")
            mx, frac = max(mx, m1), max(frac, f1)
            flips = max(flips, float((a.mask != b.mask).mean()))
        check(flips < 0.01, f"{what}: {flips:.4f} of mask pixels flip")
        check(abs(m_gpu[0] - m_cpu[0]) <= 1e-9 and abs(m_gpu[1] - m_cpu[1]) <= 1e-9,
              f"{what}: (mIoU, FB-IoU) {m_gpu} on the card, {m_cpu} on the CPU")
        out[vae_impl] = {"miou_fbiou_cuda": list(m_gpu), "miou_fbiou_cpu": list(m_cpu),
                         "max_uint8_diff": mx, "max_frac_differ": frac,
                         "max_mask_flips": flips, "kernel_launches": counts}
    return out


def _upload_while_busy(pipe, x):
    """The host time of the pipeline's upload of `x` while a spin kernel
    queued just before it holds the device for about a second, and the time
    to the device's end: an upload that waited for the device would turn
    every episode's dispatch into a synchronisation point."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    torch.cuda._sleep(10 ** 8)
    torch.cuda.synchronize()
    cycles = int(10 ** 8 / (time.time() - t0))  # about one second
    torch.cuda._sleep(cycles)
    t0 = time.time()
    pipe._put(x)
    host = time.time() - t0
    torch.cuda.synchronize()
    return host, time.time() - t0


def _loader_s_per_batch(data, bsz):
    """The data layer alone: seconds per batch of the seeded eval stream at
    512px (PIL decode and resizes, no device)."""
    from diffews_tpu_torch.data.dataset import FSSDataset

    FSSDataset.initialize(512, data, raw_images=True)
    loader = FSSDataset.build_dataloader("coco", bsz, 0, 0, "test", 1)
    np.random.seed(0)
    t0 = time.time()
    n = sum(1 for _, _ in zip(range(EVAL_BATCHES), loader))
    return (time.time() - t0) / n


def phase_eval(card):
    """The eval harness (`diffews_tpu_torch.cli.evaluate`) on the card."""
    import tempfile

    import torch
    from diffews_tpu_torch.cli import evaluate as TE
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from helpers.synthetic_data import make_coco

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = make_coco(os.path.join(tmp, "data"))
        res["tiny"] = _eval_tiny(tmp, data)
        emit({"phase": "eval_tiny", "dtype": "float32", "tf32": False, **res["tiny"]})

        # full width, bf16, 512px, the default vae_impl "xla"
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        pipe = DiffewsPipeline(_full_bundle(), device="cuda", compute_dtype=torch.bfloat16)
        logs = os.path.join(tmp, "logs")
        expected = EPISODE_LAUNCHES["xla"]
        for bsz in (4, 1):
            label = f"b{bsz}"
            args = lambda depth, *extra: TE.build_parser().parse_args(_eval_argv(
                data, logs, "--img-size", "512", "--bsz", str(bsz), "--max_episodes",
                str(EVAL_BATCHES), "--dispatch_ahead", str(depth), *extra))
            # (a) one counted run through the recorder: every batch's launches
            # are a bare predict's, and its mask is `predict`'s on that batch
            keep = _KeepSeg(pipe)
            _zero_counts()
            metrics = TE.evaluate(args(2), pipe=keep)
            torch.cuda.synchronize()
            total = _launch_counts()
            check(len(keep.calls) == EVAL_BATCHES, f"eval {label}: {len(keep.calls)} batches")
            for i, rec in enumerate(keep.calls):
                check(rec["launches"] == expected,
                      f"eval {label} batch {i} launched {rec['launches']}, expected {expected}")
            check(total == {k: v * EVAL_BATCHES for k, v in expected.items()},
                  f"eval {label}: the run launched {total}")
            bare_counts = None
            for i, rec in enumerate(keep.calls):
                _zero_counts()
                ref = pipe.predict(*rec["args"], **rec["kw"])
                bare_counts = bare_counts or _launch_counts()
                check(np.array_equal(rec["out"].seg_colored, ref.seg_colored)
                      and np.array_equal(rec["out"].mask, ref.mask),
                      f"eval {label} batch {i}: the harness's prediction differs from "
                      "`predict` on the same batch")
            check(bare_counts == expected, f"bare predict launched {bare_counts}")
            busy_host, busy_total = _upload_while_busy(pipe, keep.calls[0]["args"][0])
            check(busy_host < 0.5 and busy_total > 0.8,
                  f"eval {label}: the query upload took {busy_host:.3f} s of the host while "
                  f"the device was held busy ({busy_total:.3f} s to its end): it waits for "
                  "the device")
            check(all(np.isfinite(metrics)), f"eval {label}: metrics {metrics}")
            # (b) timed runs: dispatch-ahead 2 and 1 (and 2 with two loader
            # workers), each to the device's end; identical metrics
            timed = {}
            for name, a in (("dispatch2", args(2)), ("dispatch1", args(1)),
                            ("dispatch2_nworker2", args(2, "--nworker", "2"))):
                torch.cuda.synchronize()
                t0 = time.time()
                m = TE.evaluate(a, pipe=pipe)
                torch.cuda.synchronize()
                wall = time.time() - t0
                check(m == metrics, f"eval {label} {name}: metrics {m} != {metrics}")
                timed[name] = {"wall_s": wall, "episodes_per_s": EVAL_BATCHES * bsz / wall}
            # (c) the bare predict loop on the same batches, synchronous
            torch.cuda.synchronize()
            t0 = time.time()
            for rec in keep.calls:
                pipe.predict(*rec["args"], **rec["kw"])
            torch.cuda.synchronize()
            bare = time.time() - t0
            prof = profile_episode(lambda: TE.evaluate(args(2), pipe=pipe))
            host = sorted(r["host_s"] for r in keep.calls[1:])
            res[label] = {
                "miou_fbiou": list(metrics), "batches": EVAL_BATCHES,
                "episodes": EVAL_BATCHES * bsz,
                "launches_per_batch": expected, "launches_run": total,
                "timed": timed, "bare_predict_wall_s": bare,
                "bare_predict_episodes_per_s": EVAL_BATCHES * bsz / bare,
                "harness_host_cost_s": timed["dispatch2"]["wall_s"] - bare,
                "loader_s_per_batch": _loader_s_per_batch(data, bsz),
                "predict_async_host_s_median": host[len(host) // 2],
                "upload_host_s_device_busy_1s": busy_host,
                "profile": prof, "card": card}
            emit({"phase": f"eval_1shot_{label}_512px_bf16",
                  **{k: v for k, v in res[label].items() if k != "profile"},
                  "device_busy_ms": prof.get("device_busy_ms"),
                  "device_idle_share": prof.get("device_idle_share"),
                  "wall_ms_profiled": prof.get("wall_ms_profiled")})
        del pipe
        torch.cuda.empty_cache()
    RESULTS["eval"] = res
    return {f"eval_harness_1shot_b4_{EVAL_BATCHES}_batches": res["b4"]["launches_run"]}


def _grads_compare(ga, gb):
    """Global-norm relative difference and the least per-leaf cosine."""
    import torch

    na = torch.stack([g.float().square().sum() for g in ga.values()]).sum().sqrt().item()
    nb = torch.stack([g.float().square().sum() for g in gb.values()]).sum().sqrt().item()
    worst, worst_name = 1.0, None
    for name in ga:
        a, b = ga[name].double().flatten(), gb[name].double().flatten()
        den = (a.norm() * b.norm()).item()
        cos = 1.0 if den == 0 and a.norm().item() == b.norm().item() else (a @ b).item() / den
        if cos < worst:
            worst, worst_name = cos, name
    return abs(na - nb) / nb, worst, worst_name


def phase_train(card):
    import dataclasses

    import torch
    from diffews_tpu_torch.configs import CLIPTextConfig, UNetConfig, VAEConfig
    from diffews_tpu_torch.models.clip_text import CLIPTextModel
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL
    from diffews_tpu_torch.ops.flash_attention import flash_attention_bwd
    from diffews_tpu_torch.training import lr as lr_lib
    from diffews_tpu_torch.training.state import (TrainerConfig, TrainState, bind_params,
                                                  init_state, make_episode_loss,
                                                  make_grad_fn, make_optimizer,
                                                  make_train_step, training_text_embed)
    from diffews_tpu_torch.utils.init import build_module

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    cl = torch.channels_last
    t0 = time.time()
    unet = build_module(UNet2DConditionModel, UNetConfig.sd21(), seed=0,
                        device="cuda").to(memory_format=cl)
    vae_f32 = build_module(AutoencoderKL, VAEConfig.sd(), seed=1,
                           device="cuda").to(memory_format=cl).requires_grad_(False)
    vae = build_module(AutoencoderKL, VAEConfig.sd(), seed=1, device="cuda").to(
        dtype=torch.bfloat16, memory_format=cl).requires_grad_(False)
    text_cfg = CLIPTextConfig.sd21()
    text = build_module(CLIPTextModel, text_cfg, seed=2, device="cuda")
    text_embed = training_text_embed(text, text_cfg)  # (1, 77, 1024) f32
    del text
    cfg = TrainerConfig()  # bf16, remat, AdamW 1e-5 (wd 1e-2, clip 1.0, bf16 mu)
    state = init_state(cfg, dict(unet.named_parameters()), device="cuda")
    step = make_train_step(cfg, unet)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    res = {"setup_s": time.time() - t0, "config": {
        "unet": "SD-2.1 (8-ch conv_in_ref)", "vae": "SD", "text": "OpenCLIP ViT-H",
        "px": 512, "batch": 1, "shots": 1, "compute": "bf16", "master": "f32",
        "remat": cfg.remat, "lr": cfg.learning_rate, "weight_decay": cfg.adam_weight_decay,
        "max_grad_norm": cfg.max_grad_norm, "adam_mu": "bf16"}}
    snap = lambda: {n: state.params[n].detach().clone() for n in (
        "conv_in.weight", "conv_in_ref.weight", "conv_out.weight",
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight")}

    # (a) launches of one micro-step, then a few steps
    b1 = _train_batch(1, 1, 1, 512, seed=5, device="cuda")
    state, m = step(state, b1, gen, vae, text_embed)  # cuDNN plans, allocator
    torch.cuda.synchronize()
    _zero_counts()
    state, m = step(state, b1, gen, vae, text_embed)
    torch.cuda.synchronize()
    counts = _launch_counts()
    launches = {**counts, "flash_attention_bwd_dq": flash_attention_bwd.dq_launches,
                "flash_attention_bwd_dkv": flash_attention_bwd.dkv_launches}
    check(launches == TRAIN_CLI_LAUNCHES,
          f"a 1-shot micro-step launched {launches}; expected 65 flash forward (32 + 32 "
          "recomputed under remat + 1 VAE encode), 32 dq, 32 dkv, 109 GroupNorm stats and "
          "apply (44 + 44 recomputed + 21 in the VAE encode), the optimizer's norm, finalise "
          "and apply, no gradient copied into another layout, and no other kernel")
    before = snap()
    torch.cuda.reset_peak_memory_stats()
    synced, losses = [], []
    for i in range(3):
        batch = _train_batch(1, 1, 1, 512, seed=10 + i, device="cuda")
        t1 = time.time()
        state, m = step(state, batch, gen, vae, text_embed)
        losses.append(float(m["loss"]))  # host read: the step's sync
        synced.append(time.time() - t1)
        check(np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0,
              f"step {i}: loss {losses[-1]}, grad norm {float(m['grad_norm'])}")
    peak = torch.cuda.max_memory_allocated()
    after = snap()
    moved = {n: not torch.equal(before[n], after[n]) for n in before}
    check(all(moved.values()), f"params did not move: {moved}")

    def window(gas, n_steps):
        batches = [_train_batch(gas, 1, 1, 512, seed=100 + i, device="cuda")
                   for i in range(n_steps)]
        nonlocal state
        torch.cuda.synchronize()
        t1 = time.time()
        for batch in batches:
            state, m = step(state, batch, gen, vae, text_embed)
        loss = float(m["loss"])  # one host read for the window
        return (time.time() - t1) / n_steps, loss

    win1, _ = window(1, 5)
    b4 = _train_batch(4, 1, 1, 512, seed=20, device="cuda")
    state, m = step(state, b4, gen, vae, text_embed)  # warm-up at gas 4
    synced4 = []
    for i in range(2):
        t1 = time.time()
        state, m = step(state, b4, gen, vae, text_embed)
        float(m["loss"])
        synced4.append(time.time() - t1)
    win4, _ = window(4, 3)
    prof = profile_episode(lambda: step(state, b1, gen, vae, text_embed))
    res["step"] = {"kernel_launches_per_micro_step": launches, "losses": losses,
                   "grad_norm_last": float(m["grad_norm"]), "params_moved": moved,
                   "gas1_synced_s": synced, "gas1_synced_s_median": statistics.median(synced),
                   "gas1_window5_s_per_step": win1, "gas4_synced_s": synced4,
                   "gas4_window3_s_per_step": win4, "peak_mem_gb_gas1": peak / 1e9,
                   "card": card}
    emit({"phase": "train_1shot_b1_512px_bf16", **res["step"]})
    res["profile_step_gas1"] = prof
    emit({"phase": "profile_train_step_gas1", **prof, "card": card})
    # where a gas-1 step goes: the micro-step (forward, recompute, backward)
    # and the optimizer update, each profiled alone
    micro1, grads = {k: v[0] for k, v in b1.items()}, None

    def micro_step():
        nonlocal grads
        grads = make_grad_fn(cfg, unet)(state.params, vae, text_embed, micro1, gen)[1]

    res["profile_micro_step"] = prof_micro = profile_episode(micro_step)
    if isinstance(prof_micro.get("flash_kernels_ms"), dict):
        for kind in ("fwd", "bwd"):  # the bwd sum includes the split passes' sums
            prof_micro[f"flash_{kind}_ms"] = sum(
                ms for n, ms in prof_micro["flash_kernels_ms"].items() if f"flash_{kind}" in n)
    res["profile_optimizer"] = profile_episode(
        lambda: make_optimizer(cfg).update(grads, state.opt_state, state.params))
    del grads
    for part in ("micro_step", "optimizer"):
        emit({"phase": f"profile_train_{part}", **res[f"profile_{part}"], "card": card})

    # (b) f32, TF32 off: the micro-step through the kernels vs the dense path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    micro = {k: v[0] for k, v in b1.items()}
    noise32 = torch.randn((_n_images(1, 1, False), 64, 64, 4), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(8))
    l_k, g_k = make_grad_fn(cfg32, unet)(state.params, vae_f32, text_embed, micro, noise32)
    l_d, g_d = make_grad_fn(dataclasses.replace(cfg32, attn_impl="dense"), unet)(
        state.params, vae_f32, text_embed, micro, noise32)
    loss_rel = abs(l_k.item() - l_d.item()) / abs(l_d.item())
    norm_rel, min_cos, min_cos_leaf = _grads_compare(g_k, g_d)
    del g_d
    # a first-order check of the gradient at full width: stepping the
    # weights by −ε·g/‖g‖ lowers the loss by ≈ ε·‖g‖ while ε is small; an
    # Adam step from a fresh state, ≈ −lr·sign(g), by ≈ lr·‖g‖₁
    eval_loss = make_episode_loss(dataclasses.replace(cfg32, remat=False), unet)
    g_l2 = torch.stack([g.square().sum() for g in g_k.values()]).sum().sqrt().item()
    g_l1 = sum(g.abs().sum().item() for g in g_k.values())
    with torch.no_grad():
        with bind_params(unet, {n: p.detach() for n, p in state.params.items()}):
            l_0 = eval_loss(vae_f32, text_embed, micro, noise32).item()
        probes = []
        for eps in (1e-2, 1e-3, 1e-4):
            w = {n: p.detach() - (eps / g_l2) * g_k[n] for n, p in state.params.items()}
            with bind_params(unet, w):
                d_l = eval_loss(vae_f32, text_embed, micro, noise32).item() - l_0
            probes.append({"eps": eps, "predicted": -eps * g_l2, "measured": d_l,
                           "ratio": d_l / (-eps * g_l2)})
            del w
    del g_k
    torch.cuda.empty_cache()
    res["gradient_probe_f32"] = {"loss": l_0, "grad_l2": g_l2, "grad_l1": g_l1,
                                 "steps_along_minus_grad": probes,
                                 "adam_first_step_first_order_dloss": {
                                     "lr1e-4": -1e-4 * g_l1, "lr1e-5": -1e-5 * g_l1}}
    emit({"phase": "train_gradient_probe_f32", **res["gradient_probe_f32"]})
    res["f32_kernels_vs_dense"] = {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                                   "min_leaf_cosine": min_cos, "min_cosine_leaf": min_cos_leaf}
    emit({"phase": "train_f32_kernels_vs_dense", **res["f32_kernels_vs_dense"]})
    check(loss_rel <= 1e-5 and norm_rel <= 1e-3 and min_cos >= 0.999,
          f"f32 micro-step, kernels vs dense: {res['f32_kernels_vs_dense']}")
    # the loss over 5 steps on one fixed batch with fixed noise, each run
    # from the same weights and a fresh optimizer state: bf16 at lr 1e-4, and
    # beside it f32 (TF32 off) at lr 1e-4 and bf16 at lr 1e-5; with the share
    # of bf16 compute weights the 5 steps changed
    start = {n: p.detach().clone() for n, p in state.params.items()}
    res["fixed_batch"] = {}
    for label, dt, lr in (("bf16_lr1e-4", torch.bfloat16, 1e-4),
                          ("f32_lr1e-4", torch.float32, 1e-4),
                          ("bf16_lr1e-5", torch.bfloat16, 1e-5)):
        c = dataclasses.replace(cfg, learning_rate=lr, lr_scheduler="constant", compute_dtype=dt)
        params = {n: p.clone().requires_grad_() for n, p in start.items()}
        st = TrainState(params, make_optimizer(c).init(params), None,
                        torch.zeros((), dtype=torch.int32, device="cuda"))
        run = make_train_step(c, unet)
        losses = []
        for _ in range(5):
            st, m = run(st, b1, torch.Generator(device="cuda").manual_seed(7),
                        vae_f32 if dt == torch.float32 else vae, text_embed)
            losses.append(float(m["loss"]))
        changed = sum(int((params[n].bfloat16() != start[n].bfloat16()).sum()) for n in start)
        total = sum(p.numel() for p in start.values())
        res["fixed_batch"][label] = {"losses": losses, "falls": losses[-1] < losses[0],
                                     "monotone": all(x > y for x, y in zip(losses, losses[1:])),
                                     "bf16_weights_changed": changed / total}
        del st, params
        torch.cuda.empty_cache()
    del start, vae_f32
    emit({"phase": "train_fixed_batch", **res["fixed_batch"]})
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    # (c) 5 shots, the last two padded, bf16: their content changes nothing
    grad5 = make_grad_fn(cfg, unet)
    b5 = {k: v[0] for k, v in _train_batch(1, 1, 5, 512, seed=30, padded=2,
                                           device="cuda").items()}
    b5o = dict(b5, supports=b5["supports"].clone(), s_mask3=b5["s_mask3"].clone())
    b5o["supports"][:, 3:] = 255 - b5["supports"][:, 3:]
    b5o["s_mask3"][:, 3:] = 1 - b5["s_mask3"][:, 3:]
    noise5 = torch.randn((_n_images(1, 5, False), 64, 64, 4), device="cuda",
                         dtype=torch.bfloat16,
                         generator=torch.Generator(device="cuda").manual_seed(9))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    l_a, g_a = grad5(state.params, vae, text_embed, b5, noise5)
    l_r, g_r = grad5(state.params, vae, text_embed, b5, noise5)
    repeat_same = torch.equal(l_a, l_r) and all(torch.equal(g_a[n], g_r[n]) for n in g_a)
    del g_r
    l_o, g_o = grad5(state.params, vae, text_embed, b5o, noise5)
    torch.backends.cudnn.deterministic = det
    padded_same = torch.equal(l_a, l_o) and all(torch.equal(g_a[n], g_o[n]) for n in g_a)
    max_diff = max((g_a[n].float() - g_o[n].float()).abs().max().item() for n in g_a)
    del g_a, g_o
    torch.cuda.empty_cache()
    res["five_shot_padded"] = {"repeat_bit_identical": repeat_same,
                               "padded_content_bit_identical": padded_same,
                               "loss": l_a.item(), "loss_other_padding": l_o.item(),
                               "max_grad_diff": max_diff}
    emit({"phase": "train_5shot_2padded_bf16", **res["five_shot_padded"]})
    check(padded_same, f"padded shots' content changed the loss or a gradient: "
                       f"{res['five_shot_padded']}")

    # (d) the attn-mask variant: conv_in_ref is unused, gets a zero gradient
    # and still decays (p ← p − lr·wd·p); a fresh optimizer state isolates it
    cfg_am = dataclasses.replace(cfg, attn_mask_variant=True)
    st_am = TrainState(state.params, make_optimizer(cfg_am).init(state.params), None,
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    ref0 = state.params["conv_in_ref.weight"].detach().clone()
    st_am, m = make_train_step(cfg_am, unet)(st_am, b1, gen, vae, text_embed)
    lr0 = lr_lib.get_schedule(cfg.lr_scheduler, cfg.learning_rate, cfg.max_train_steps,
                              cfg.lr_warmup_steps, power=cfg.lr_power)(st_am.step - 1)
    expect = ref0 + (-lr0) * (cfg.adam_weight_decay * ref0)
    ref1 = st_am.params["conv_in_ref.weight"].detach()
    decayed = torch.equal(ref1, expect) and not torch.equal(ref1, ref0)
    res["attn_mask_step"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "conv_in_ref_decayed_exactly": decayed,
                             "conv_in_ref_max_change": (ref1 - ref0).abs().max().item()}
    emit({"phase": "train_attn_mask_variant", **res["attn_mask_step"]})
    check(np.isfinite(res["attn_mask_step"]["loss"]) and decayed,
          f"attn-mask variant step: {res['attn_mask_step']}")
    RESULTS["train"] = res
    return launches


# ---------------------------------------------------------------------------
# phase train_cli: the training CLI (`diffews_tpu_torch.cli.train`)
# ---------------------------------------------------------------------------


def _du(path) -> int:
    """Bytes of the files under `path`."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class _CountedSteps:
    """The CLI's step function with every call's kernel launches recorded
    (counts read just before and just after the call), its synced wall (the
    device drained before it, the loss read after it), and the
    `torch.distributed.all_reduce` calls it made and their bytes."""

    def __init__(self, make):
        self.make, self.calls = make, []

    def __call__(self, *a, **kw):
        import torch
        from diffews_tpu_torch.ops.flash_attention import flash_attention_bwd

        step = self.make(*a, **kw)

        def counts():
            c = _launch_counts()
            c["flash_attention_bwd_dq"] = flash_attention_bwd.dq_launches
            c["flash_attention_bwd_dkv"] = flash_attention_bwd.dkv_launches
            return c

        def run(*args):
            import torch.distributed as dist

            real, sizes = dist.all_reduce, []

            def counted_all_reduce(t, *a, **kw):
                sizes.append(t.numel() * t.element_size())
                return real(t, *a, **kw)

            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            dist.all_reduce = counted_all_reduce
            try:
                state, m = step(*args)
                float(m["loss"])
            finally:
                dist.all_reduce = real
            self.calls.append({"launches": {k: v - before[k] for k, v in counts().items()},
                               "synced_s": time.perf_counter() - t0, "loss": float(m["loss"]),
                               "all_reduces": len(sizes), "all_reduce_bytes": sum(sizes)})
            return state, m

        return run


TRAIN_CLI_LAUNCHES = {"flash_attention_fwd": 65, "flash_attention_bwd_dq": 32,
                      "flash_attention_bwd_dkv": 32, "gn_stats": 109, "gn_apply": 109,
                      "fused_gn_silu_conv3x3": 0, "downsample_conv2x": 0, "quantize_s8": 0,
                      "conv2d_int8": 0, "int_mm": 0, "adamw_norm": 1, "adamw_finalise": 1,
                      "adamw_apply": 1, "adamw_layout_copies": 0}


def _train_cli_tiny(tmp, data):
    """(a) tiny f32 (TF32 off) CLI runs, the card against the CPU, with
    float32 first moments (as phase tiny_train: card-vs-CPU gradient noise
    must not flip a bf16 rounding): losses per step from `--metrics_jsonl`
    within rtol 1e-4, checkpoint-4's weights under `_params_close`; the same
    with `--lora_rank 2 --use_ema` on the adapters; a preemption after step
    3 plus a `latest` resume on the card bit for bit equal to the straight
    run's checkpoint-4."""
    import functools
    import shutil

    import torch
    from diffews_tpu_torch import checkpoint as TCK
    from diffews_tpu_torch.cli import train as TT
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from diffews_tpu_torch.training import checkpoints as tck
    from helpers.port_checkpoint import write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt = write_checkpoint(os.path.join(tmp, "tiny_ckpt"), UNetConfig.tiny(), VAEConfig.tiny(),
                            CLIPTextConfig.tiny(), SchedulerConfig.diffews(), seed=0,
                            safetensors=True)
    lr, steps = 1e-3, 4

    def argv(out, dev, *extra):
        return ["--pretrained_model_name_or_path", ckpt, "--datapath", data,
                "--benchmark", "coco", "--fold", "0", "--nshot", "2", "--resolution", "32",
                "--train_batch_size", "2", "--gradient_accumulation_steps", "2",
                "--max_train_steps", str(steps), "--checkpointing_steps", "1",
                "--logging_steps", "1", "--learning_rate", str(lr),
                "--mixed_precision", "no", "--seed", "0", "--output_dir", out,
                "--metrics_jsonl", os.path.join(out, "metrics.jsonl"), "--device", dev,
                *extra]

    cfg_f32 = functools.partial(TT.TrainerConfig, adam_mu_dtype=torch.float32)
    out = {}
    for label, extra in (("full", ()), ("lora_ema", ("--lora_rank", "2", "--use_ema"))):
        runs = {}
        for dev in ("cpu", "cuda"):
            d = os.path.join(tmp, f"tiny_{label}_{dev}")
            orig = TT.TrainerConfig
            TT.TrainerConfig = cfg_f32
            try:
                _zero_counts()
                TT.main(argv(d, dev, *extra))
                counts = _launch_counts()
            finally:
                TT.TrainerConfig = orig
            runs[dev] = (d, counts)
        (d_cpu, _), (d_gpu, counts) = runs["cpu"], runs["cuda"]
        what = f"train_cli tiny card vs CPU ({label})"
        check(counts["flash_attention_fwd"] > 0 and counts["gn_apply"] > 0,
              f"{what}: kernel launches {counts}")
        l_cpu = [r["loss"] for r in _jsonl(os.path.join(d_cpu, "metrics.jsonl"))]
        l_gpu = [r["loss"] for r in _jsonl(os.path.join(d_gpu, "metrics.jsonl"))]
        check(len(l_cpu) == len(l_gpu) == steps
              and all(abs(a - c) <= 1e-4 * abs(c) for a, c in zip(l_gpu, l_cpu)),
              f"{what}: losses {l_gpu} on the card, {l_cpu} on the CPU")
        ts = lambda d, s: tck.read_train_state(os.path.join(d, f"checkpoint-{s}"))  # noqa: E731
        mu_hist = [ts(d_cpu, s)["opt_state"]["mu"] for s in range(1, steps + 1)]
        if label == "full":
            got = TCK.load_unet_state(os.path.join(d_gpu, f"checkpoint-{steps}", "unet"))
            want = TCK.load_unet_state(os.path.join(d_cpu, f"checkpoint-{steps}", "unet"))
        else:
            got, want = ts(d_gpu, steps)["lora"], ts(d_cpu, steps)["lora"]
        params = _params_close(got, want, mu_hist, lr, steps, what)
        out[label] = {"loss_cuda": l_gpu, "loss_cpu": l_cpu, "kernel_launches": counts,
                      **params}
        if label == "full":
            # preempted after step 3, resumed from `latest`, on the card
            d = os.path.join(tmp, "tiny_preempted")

            class _TripAfter:
                calls = 0

                def is_set(self):
                    self.calls += 1
                    return self.calls >= 3

            orig_cfg, orig_h = TT.TrainerConfig, TT._install_preemption_handler
            TT.TrainerConfig = cfg_f32
            try:
                TT._install_preemption_handler = lambda: (_TripAfter(), lambda: None)
                rep = TT.main(argv(d, "cuda"))
                TT._install_preemption_handler = orig_h
                check(rep["preempted"] and rep["global_step"] == 3
                      and not os.path.exists(os.path.join(d, "checkpoint-4")),
                      f"{what}: the preempted run ended at {rep['global_step']}")
                TT.main(argv(d, "cuda", "--resume_from_checkpoint", "latest"))
            finally:
                TT.TrainerConfig, TT._install_preemption_handler = orig_cfg, orig_h
            a = TCK.load_unet_state(os.path.join(d, f"checkpoint-{steps}", "unet"))
            differ = [n for n in got if not torch.equal(a[n], got[n])]
            same = not differ
            check(same, f"{what}: the preempted + resumed run differs from the straight one "
                        f"in {len(differ)} weights ({differ[:3]})")
            out[label]["preempt_resume_bit_identical"] = same
            shutil.rmtree(d)
        for d in {d_cpu, d_gpu}:
            shutil.rmtree(d)
    return out


def _loss_at(report, step):
    return [r["loss"] for r in report["log"] if r["step"] == step][0]


def _step_wall(report, step):
    """The CLI's wall from the log of `step - 1` to that of `step` (data,
    upload, step and the loss's read)."""
    walls = {r["step"]: r["wall_s"] for r in report["log"]}
    return walls[step] - walls[step - 1]


def _train_cli_full(tmp, data, card, disk):
    """(b) full width, full fine-tuning (also without the CLI's
    `cudnn.deterministic`, for its cost), and (c) LoRA, through the CLI.
    The checkpoint stays in `tmp/full_ckpt` for phase multi."""
    import shutil

    import torch
    from diffews_tpu_torch import checkpoint as TCK
    from diffews_tpu_torch import pipeline as TP
    from diffews_tpu_torch.cli import train as TT
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                           UNetConfig, VAEConfig)
    from diffews_tpu_torch.training import checkpoints as tck
    from diffews_tpu_torch.training import lora as lora_lib
    from helpers.port_checkpoint import write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    res = {}
    t0 = time.time()
    ckpt = write_checkpoint(os.path.join(tmp, "full_ckpt"), UNetConfig.sd21(), VAEConfig.sd(),
                            CLIPTextConfig.sd21(), SchedulerConfig.diffews(), seed=0,
                            safetensors=True, device="cuda")
    torch.cuda.empty_cache()
    res["base_checkpoint"] = {"write_s": time.time() - t0, "bytes": _du(ckpt),
                              "unet_bytes": _du(os.path.join(ckpt, "unet"))}
    disk.append(_du(tmp))

    def argv(out, *extra):
        return ["--pretrained_model_name_or_path", ckpt, "--datapath", data,
                "--benchmark", "coco", "--fold", "0", "--nshot", "1", "--resolution", "512",
                "--train_batch_size", "1", "--gradient_accumulation_steps", "1",
                "--logging_steps", "1", "--seed", "0", "--output_dir", out,
                "--device", "cuda", *extra]

    def run(make_attr, owner, args):
        """One CLI run with its steps counted; validation episodes counted
        through `DiffewsPipeline.predict`."""
        counted = _CountedSteps(getattr(owner, make_attr))
        val = []
        orig_predict = TP.DiffewsPipeline.predict

        def predict(self, *a, **kw):
            before = _launch_counts()
            out = orig_predict(self, *a, **kw)
            val.append({k: v - before[k] for k, v in _launch_counts().items()})
            return out

        setattr(owner, make_attr, counted)
        TP.DiffewsPipeline.predict = predict
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.time()
            report = TT.main(args)
            torch.cuda.synchronize()
            wall = time.time() - t1
        finally:
            setattr(owner, make_attr, counted.make)
            TP.DiffewsPipeline.predict = orig_predict
        report.update(wall_s=wall, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                      steps=counted.calls, validation=val)
        torch.cuda.empty_cache()
        return report

    # (b) full fine-tuning, 3 steps, checkpoints at 2 and 3, validation at 2;
    # then checkpoint-2 resumed in a fresh directory up to step 3
    straight_dir = os.path.join(tmp, "full_straight")
    resumed_dir = os.path.join(tmp, "full_resumed")
    common = ("--max_train_steps", "3", "--checkpointing_steps", "2")
    check(not torch.backends.cudnn.deterministic, "train_cli: cudnn.deterministic set "
          "before the CLI ran")
    straight = run("make_train_step", TT, argv(straight_dir, *common, "--validation_steps",
                                              "2", "--validation_episodes", "2"))
    check(not torch.backends.cudnn.deterministic,
          "train_cli: the CLI left cudnn.deterministic set after it returned")
    disk.append(_du(tmp))
    for i, s in enumerate(straight["steps"]):
        check(s["launches"] == TRAIN_CLI_LAUNCHES,
              f"train_cli full step {i + 1} launched {s['launches']}, expected "
              f"{TRAIN_CLI_LAUNCHES}")
    check(len(straight["validation"]) == 2
          and all(v == EPISODE_LAUNCHES["xla"] for v in straight["validation"]),
          f"train_cli validation episodes launched {straight['validation']}")
    ck3 = os.path.join(straight_dir, "checkpoint-3")
    want = TCK.load_unet_state(os.path.join(ck3, "unet"))
    want_state = tck.read_train_state(ck3)
    want_mu = {n: t.clone() for n, t in want_state["opt_state"]["mu"].items()}
    del want_state
    shutil.rmtree(ck3)
    resumed = run("make_train_step", TT, argv(resumed_dir, *common,
                                              "--resume_from_checkpoint",
                                              os.path.join(straight_dir, "checkpoint-2")))
    disk.append(_du(tmp))
    got = TCK.load_unet_state(os.path.join(resumed_dir, "checkpoint-3", "unet"))
    got_mu = tck.read_train_state(os.path.join(resumed_dir, "checkpoint-3"))["opt_state"]["mu"]
    differ = [n for n in want if not torch.equal(got[n], want[n])]
    mu_differ = [n for n in want_mu if not torch.equal(got_mu[n], want_mu[n])]
    loss_same = _loss_at(straight, 3) == _loss_at(resumed, 3)
    check(not differ and not mu_differ and loss_same,
          f"train_cli full: the resumed checkpoint-3 differs from the straight run's in "
          f"{len(differ)} weights ({differ[:3]}) and {len(mu_differ)} first moments; "
          f"step-3 loss {_loss_at(resumed, 3)} vs {_loss_at(straight, 3)}")
    del got, got_mu, want_mu
    shutil.rmtree(straight_dir)
    shutil.rmtree(resumed_dir)
    # 2 of the same steps with cuDNN's default (nondeterministic) algorithms:
    # the cost of the CLI's `cudnn.deterministic` in step wall
    nondet_dir = os.path.join(tmp, "full_nondet")
    set_det, seen = TT._deterministic_cudnn, []
    TT._deterministic_cudnn = lambda: seen.append(torch.backends.cudnn.deterministic)
    try:
        nondet = run("make_train_step", TT, argv(nondet_dir, "--max_train_steps", "2",
                                                 "--checkpointing_steps", "2"))
    finally:
        TT._deterministic_cudnn = set_det
    check(seen == [False], f"the run without the setting saw {seen}")
    shutil.rmtree(nondet_dir)
    keep = ("load_s", "resume_s", "trainable_params", "saves", "wall_s", "peak_mem_gb")
    res["full"] = {
        "straight": {k: straight.get(k) for k in keep},
        "resumed": {k: resumed.get(k) for k in keep},
        "losses": [r["loss"] for r in straight["log"]],
        "resumed_step3_loss_bit_identical": loss_same,
        "resumed_checkpoint3_bit_identical": True,
        "launches_per_micro_step": straight["steps"][0]["launches"],
        "validation_episode_launches": straight["validation"][0],
        "cli_step2_wall_s": _step_wall(straight, 2),
        "cli_resumed_step3_wall_s": resumed["log"][0]["wall_s"],
        "step_fn_synced_s": [s["synced_s"] for s in straight["steps"]],
        "cli_step2_wall_s_without_deterministic": _step_wall(nondet, 2),
        "step_fn_synced_s_without_deterministic": [s["synced_s"] for s in nondet["steps"]],
        "card": card}
    emit({"phase": "train_cli_full_1shot_b1_512px_bf16", **res["full"]})

    # (c) LoRA rank 8 on the attention projections, 2 steps, checkpoint at 2
    lora_dir = os.path.join(tmp, "lora")
    lora = run("make_lora_train_step", lora_lib,
               argv(lora_dir, "--max_train_steps", "2", "--checkpointing_steps", "2",
                    "--lora_rank", "8", "--lora_targets", "attn"))
    disk.append(_du(tmp))
    for i, s in enumerate(lora["steps"]):
        check(s["launches"] == TRAIN_CLI_LAUNCHES,
              f"train_cli LoRA step {i + 1} launched {s['launches']}")
    merged = TCK.load_unet_state(os.path.join(lora_dir, "checkpoint-2", "unet"))
    base = TCK.load_unet_state(os.path.join(ckpt, "unet"))
    sites = {p + ".weight" for p in lora_lib.lora_sites(base, lora_lib.attn_target)}
    wrong = [n for n, t in merged.items()
             if t.dtype != torch.float32 or torch.equal(t, base[n]) == (n in sites)]
    check(set(merged) == set(base) and not wrong,
          f"train_cli LoRA: unet/ must be f32 and differ from the base exactly at the "
          f"{len(sites)} adapted sites; wrong: {wrong[:4]}")
    del merged, base
    shutil.rmtree(lora_dir)
    res["lora"] = {
        "rank": 8, "targets": "attn", "adapted_sites": len(sites),
        "trainable_params": lora["trainable_params"],
        "trainable_params_full": res["full"]["straight"]["trainable_params"],
        "launches_per_micro_step": lora["steps"][0]["launches"],
        "cli_step2_wall_s": _step_wall(lora, 2),
        "step_fn_synced_s": [s["synced_s"] for s in lora["steps"]],
        "peak_mem_gb": lora["peak_mem_gb"],
        "peak_mem_gb_full": res["full"]["straight"]["peak_mem_gb"],
        "saves": lora["saves"], "unet_f32_differs_at_adapted_sites_only": True, "card": card}
    emit({"phase": "train_cli_lora8_1shot_b1_512px_bf16", **res["lora"]})
    launches = {"train_cli_micro_step_1shot_b1": res["full"]["launches_per_micro_step"],
                "train_cli_lora_micro_step_1shot_b1": res["lora"]["launches_per_micro_step"],
                "train_cli_validation_episode_1shot_b1": dict(
                    res["full"]["validation_episode_launches"], flash_attention_bwd_dq=0,
                    flash_attention_bwd_dkv=0)}
    return res, launches


def _train_cli_capability(tmp, card):
    """(d) `tools/torch_train_capability.py` on the card under its pass
    rule, at the CI-bound sizes of `tests/test_training.py:483-518` (60
    steps, 200 VAE steps, 16 episodes, 4 validation episodes): the JAX
    artifact's sizes (400 / 600 / 60) took 133 s on the card, past the
    phase's budget (PERF.md, PR 10)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_train_capability as cap

    rep = cap.main(["--device", "cuda", "--workdir", os.path.join(tmp, "capability"),
                    "--steps", "60", "--vae_steps", "200", "--episodes", "16",
                    "--validation_episodes", "4"])
    check(not rep["failed"], f"train_cli capability: {rep['failed']}: {rep}")
    rep["card"] = card
    rep["jax_artifact_cpu"] = "19.0 -> 95.0 mIoU (artifacts/train_capability.json; CPU)"
    return rep


def phase_train_cli(card, work):
    """The training CLI on the card: (a) tiny card vs CPU, (b) full width
    full fine-tuning with a bit-exact resume under the CLI's own cuDNN
    setting, (c) full width LoRA, (d) the capability run.  Leaves the
    full-width checkpoint and the data tree in `work` for phase multi."""
    import shutil

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from helpers.synthetic_data import make_coco

    t0 = time.time()
    res, disk = {}, []
    res["disk_free_gb_at_start"] = shutil.disk_usage(work).free / 1e9
    data = make_coco(os.path.join(work, "data"))
    res["tiny"] = _train_cli_tiny(work, data)
    emit({"phase": "train_cli_tiny", "dtype": "float32", "tf32": False, **res["tiny"]})
    full, launches = _train_cli_full(work, data, card, disk)
    res.update(full)
    res["capability"] = _train_cli_capability(work, card)
    emit({"phase": "train_cli_capability",
          **{k: v for k, v in res["capability"].items() if k != "workdir"}})
    res["seconds"] = time.time() - t0
    res["peak_disk_gb"] = max(disk) / 1e9
    emit({"phase": "train_cli", "seconds": res["seconds"], "peak_disk_gb": res["peak_disk_gb"],
          "disk_free_gb_at_start": res["disk_free_gb_at_start"]})
    RESULTS["train_cli"] = res
    return launches


MULTI_RANKS = 2  # two ranks on the one card (gloo) for (a) and (b)
SHOT_TOL = 2e-3  # sharded x0 latent vs single-process, relative to max|single| (f32)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(cmd, log, timeout, what):
    """Run `cmd` in its own session, output to `log`; returns the wall.
    Fails the run on a non-zero exit or on the timeout, after which the
    whole session (every process it started) is killed."""
    import signal

    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
    t0 = time.time()
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                             start_new_session=True)
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            rc = None
    wall = time.time() - t0
    if rc != 0:
        with open(log) as f:
            tail = f.read()[-6000:]
        fail(f"{what} {'timed out' if rc is None else f'exited {rc}'}:\n{tail}")
    return wall


def _torchrun(nproc, target, log, timeout):
    """`torchrun --nproc_per_node nproc <target>` on this node (a static
    rendezvous on a free local port); any rank's failure (torchrun then
    stops the others) or the timeout fails the run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), *target]
    return _launch(cmd, log, timeout, f"torchrun {' '.join(target[1:3])} ({nproc} ranks)")


def _rank_results(out_dir, n):
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _rank_shot_serving(rank, out_dir):
    """(a), on each of the two ranks of a gloo ("shots",) mesh on the one
    card: the 2-shot batch-1 512px episode in f32 (TF32 off) and bf16, the
    1-valid + 3-padded episode in bf16; rank 0 also runs the single-process
    `predict` of the same episodes while rank 1 waits."""
    import torch
    import torch.distributed as dist
    from diffews_tpu_torch.ops.attention import shot_parallel_fused_kv_attention as spa
    from diffews_tpu_torch.parallel import mesh as M
    from diffews_tpu_torch.pipeline import DiffewsPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = M.make_shot_mesh("cpu", MULTI_RANKS)
    bundle = _full_bundle()
    q, sup, m = _episode(1, 2, 512, seed=61)
    res, x0s = {}, []

    def pipeline(dtype, shot_mesh):
        pipe = DiffewsPipeline(bundle, device="cuda", compute_dtype=dtype, shot_mesh=shot_mesh)
        decode = pipe._decode_seg

        def recording(x0):
            x0s.append(x0.float().cpu())
            return decode(x0)

        pipe._decode_seg = recording
        return pipe

    def timed(pipe, *args, **kw):
        pipe.predict(*args, **kw)  # warm
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = pipe.predict(*args, **kw)
            walls.append(time.perf_counter() - t0)
        return out, statistics.median(walls)

    # f32: sharded against single-process
    sharded = pipeline(torch.float32, mesh)
    out = sharded.predict(q, sup, m, r_threshold=0.25)
    x0_sh = x0s[-1]
    dist.barrier()
    if rank == 0:
        single = pipeline(torch.float32, None).predict(q, sup, m, r_threshold=0.25)
        x0_one = x0s[-1]
        err = float((x0_sh - x0_one).abs().max())
        scale = float(x0_one.abs().max())
        check(bool(torch.isfinite(x0_sh).all()) and err <= SHOT_TOL * scale,
              f"multi (a) f32: sharded x0 off by {err} (allowed {SHOT_TOL}·{scale})")
        mx, frac = _uint8_close(out.seg_colored, single.seg_colored, "multi (a) f32 mask")
        res["f32"] = {"x0_max_abs_err": err, "x0_max_abs": scale, "mask_max_uint8_diff": mx,
                      "mask_frac_differ": frac}
    dist.barrier()
    del sharded
    x0s.clear()

    # bf16: the sharded episode (its launches counted), a repeat, the walls
    sharded = pipeline(torch.bfloat16, mesh)
    sharded.predict(q, sup, m, r_threshold=0.25)
    torch.cuda.synchronize()
    _zero_counts()
    spa.merges = 0
    first = sharded.predict(q, sup, m, r_threshold=0.25)
    torch.cuda.synchronize()
    res["launches_per_episode"] = dict(_launch_counts(), lse_merges=spa.merges)
    again, res["sharded_wall_s"] = timed(sharded, q, sup, m, r_threshold=0.25)
    check(np.array_equal(first.seg_colored, again.seg_colored),
          f"multi (a) bf16: rank {rank}'s repeat is not bit-identical")
    np.save(os.path.join(out_dir, f"rank{rank}_bf16_seg.npy"), first.seg_colored)
    # 1 valid + 3 padded shots: rank 1 holds two padded shots only
    q4, sup4, m4 = _episode(1, 4, 512, seed=62)
    sm = np.array([[True, False, False, False]])
    n0 = len(x0s)
    pad = sharded.predict(q4, sup4, m4, shot_mask=sm, r_threshold=0.25)
    sup_o, m_o = sup4.copy(), m4.copy()
    sup_o[:, 1:], m_o[:, 1:] = 255 - sup4[:, 1:], 1 - m4[:, 1:]
    other = sharded.predict(q4, sup_o, m_o, shot_mask=sm, r_threshold=0.25)
    check(all(bool(torch.isfinite(x).all()) for x in x0s[n0:]),
          "multi (a) bf16 padded episode: a NaN or inf in x0")
    check(np.array_equal(pad.seg_colored, other.seg_colored),
          f"multi (a) bf16: the padded shots' content changed rank {rank}'s prediction")
    res["padded_invariant"] = True
    dist.barrier()
    if rank == 0:
        single = pipeline(torch.bfloat16, None)
        single.predict(q, sup, m, r_threshold=0.25)
        torch.cuda.synchronize()
        _zero_counts()
        one = single.predict(q, sup, m, r_threshold=0.25)
        torch.cuda.synchronize()
        res["single_launches_per_episode"] = _launch_counts()
        _, res["single_wall_s"] = timed(single, q, sup, m, r_threshold=0.25)
        mx, frac = _diff_stats(first.seg_colored, one.seg_colored)
        res["bf16_vs_single"] = {"max_uint8_diff": mx, "frac_differ": frac}
    dist.barrier()
    return res


def _rank_dp_tiny(rank):
    """(b), on each rank of a gloo ("data",) mesh on the one card: two tiny
    f32 steps at gas 2 on this rank's row of a batch of 2 (one padded shot
    a row); rank 0 then runs the same steps unsharded and holds the two
    under phase tiny_train's rules."""
    import torch
    import torch.distributed as dist
    from diffews_tpu_torch.cli.train import _rank_noise
    from diffews_tpu_torch.configs import UNetConfig, VAEConfig
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL
    from diffews_tpu_torch.parallel import mesh as M
    from diffews_tpu_torch.training.state import TrainerConfig, init_state, make_train_step
    from diffews_tpu_torch.utils.init import build_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = M.make_mesh("cpu", MULTI_RANKS)
    gas, b, n, px, lr = 2, 2, 2, 32, 1e-3
    cfg = TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32,
                        learning_rate=lr, max_train_steps=10)
    text = torch.tensor(np.random.default_rng(3).normal(
        0, 0.5, (1, 77, UNetConfig.tiny().cross_attention_dim)), dtype=torch.float32,
        device="cuda")
    noise = np.random.default_rng(4).normal(
        size=(2, gas, _n_images(b, n, False), px // 2, px // 2, 4)).astype(np.float32)

    def run(data_mesh):
        unet = build_module(UNet2DConditionModel, UNetConfig.tiny(), seed=0).to(
            "cuda", memory_format=torch.channels_last)
        vae = build_module(AutoencoderKL, VAEConfig.tiny(), seed=1).to(
            "cuda", memory_format=torch.channels_last).requires_grad_(False)
        state = init_state(cfg, dict(unet.named_parameters()), device="cuda")
        group = None if data_mesh is None else M.axis_group(data_mesh, "data")
        step = make_train_step(cfg, unet, data_group=group)
        metrics, mu_hist = [], []
        for i in range(2):
            batch = _train_batch(gas, b, n, px, seed=10 + i, padded=1, device="cuda")
            nz = torch.from_numpy(noise[i])
            if data_mesh is not None:
                batch = M.put_global_batch(batch, data_mesh)
                nz = _rank_noise(nz, b, n, M.rows(b, MULTI_RANKS, rank), False)
            state, mt = step(state, batch, nz.to("cuda"), vae, text)
            metrics.append({k: float(v) for k, v in mt.items()})
            mu_hist.append({k: v.detach().cpu().clone() for k, v in state.opt_state.mu.items()})
        return metrics, state, mu_hist

    dp, dp_state, _ = run(mesh)
    res = {"loss": [x["loss"] for x in dp], "grad_norm": [x["grad_norm"] for x in dp]}
    dist.barrier()
    if rank == 0:
        one, one_state, mu_hist = run(None)
        what = "multi (b) tiny DP vs single-process"
        for i, (a, c) in enumerate(zip(dp, one)):
            check(abs(a["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
                  f"{what}: step {i} loss {a['loss']} vs {c['loss']}")
            check(abs(a["grad_norm"] - c["grad_norm"]) <= 1e-4 * abs(c["grad_norm"]),
                  f"{what}: step {i} grad norm {a['grad_norm']} vs {c['grad_norm']}")
        res.update(_params_close(dp_state.params, one_state.params, mu_hist, lr, 2, what),
                   loss_single=[x["loss"] for x in one])
    dist.barrier()
    return res


def _rank_tp_tiny(rank):
    """(d), on each rank of a gloo ("data", "model") mesh of 1 x 2 on the one
    card: two tiny f32 steps at gas 2 (one padded shot a row) on a state
    born tensor-parallel (whole heads and GEGLU blocks a rank, remat on);
    rank 0 then runs the same steps unsharded and holds the two under
    phase tiny_train's rules.  Under cuDNN's deterministic algorithms (as
    the train CLI runs on the card): the ranks compute their replicated
    leaves alike, so their losses are equal bit for bit (cuDNN's default
    f32 convolution gradients sum with atomics at these shapes, and the
    replicas would drift apart by float noise)."""
    import torch
    import torch.distributed as dist
    from diffews_tpu_torch.configs import UNetConfig, VAEConfig
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL
    from diffews_tpu_torch.parallel import mesh as M
    from diffews_tpu_torch.training import checkpoints as tck
    from diffews_tpu_torch.training.state import TrainerConfig, init_state, make_train_step
    from diffews_tpu_torch.utils.init import build_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = M.make_mesh("cpu", 1, MULTI_RANKS)
    gas, b, n, px, lr = 2, 2, 2, 32, 1e-3
    cfg = TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32,
                        learning_rate=lr, max_train_steps=10)
    text = torch.tensor(np.random.default_rng(5).normal(
        0, 0.5, (1, 77, UNetConfig.tiny().cross_attention_dim)), dtype=torch.float32,
        device="cuda")
    noise = np.random.default_rng(6).normal(
        size=(2, gas, _n_images(b, n, False), px // 2, px // 2, 4)).astype(np.float32)

    def run(tp_mesh):
        unet = build_module(UNet2DConditionModel, UNetConfig.tiny(), seed=0)
        vae = build_module(AutoencoderKL, VAEConfig.tiny(), seed=1).to(
            "cuda", memory_format=torch.channels_last).requires_grad_(False)
        if tp_mesh is None:
            layout = None
            unet = unet.to("cuda", memory_format=torch.channels_last)
            state = init_state(cfg, dict(unet.named_parameters()), device="cuda")
        else:
            state, layout = M.init_state_sharded(cfg, dict(unet.named_parameters()), tp_mesh,
                                                 tensor_parallel=True,
                                                 fsdp=False, units=M.tp_units(unet),
                                                 device="cuda")
        step = make_train_step(cfg, unet, layout=layout)
        metrics, mu_hist = [], []
        for i in range(2):
            batch = _train_batch(gas, b, n, px, seed=30 + i, padded=1, device="cuda")
            state, mt = step(state, batch, torch.from_numpy(noise[i]).to("cuda"), vae, text)
            metrics.append({k: float(v) for k, v in mt.items()})
            mu_hist.append(tck.host_fetch(state.opt_state.mu, layout))
        return metrics, tck.host_fetch(state.params, layout), mu_hist, layout

    tp_run, tp_params, _, layout = run(mesh)
    level0 = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    res = {"loss": [x["loss"] for x in tp_run], "grad_norm": [x["grad_norm"] for x in tp_run],
           "model_ranges_level0_to_q": layout.model_ranges(level0)}
    dist.barrier()
    if rank == 0:
        one, one_params, mu_hist, _ = run(None)
        what = "multi (d) tiny TP vs single-process"
        for i, (a, c) in enumerate(zip(tp_run, one)):
            check(abs(a["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
                  f"{what}: step {i} loss {a['loss']} vs {c['loss']}")
            check(abs(a["grad_norm"] - c["grad_norm"]) <= 1e-4 * abs(c["grad_norm"]),
                  f"{what}: step {i} grad norm {a['grad_norm']} vs {c['grad_norm']}")
        res.update(_params_close(tp_params, one_params, mu_hist, lr, 2, what),
                   loss_single=[x["loss"] for x in one])
    dist.barrier()
    torch.backends.cudnn.deterministic = deterministic
    return res


def _rank_serve_train(out_dir):
    import torch.distributed as dist
    from diffews_tpu_torch.parallel import mesh as M

    # gloo: NCCL refuses two ranks on one device; gloo's all_reduce takes
    # CUDA tensors, which is all the shot merge and the gradient mean need
    M.maybe_initialize_distributed(device_type="cpu")
    rank = M.rank()
    res = {"rank": rank, "backend": dist.get_backend()}
    res["serve"] = _rank_shot_serving(rank, out_dir)
    res["train"] = _rank_dp_tiny(rank)
    res["tp"] = _rank_tp_tiny(rank)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


SHARDED_SERVE_TIMED = 4  # timed requests of each kind on a sharded daemon


def _serve_sharded(ckpt, label, flags) -> dict:
    """(e), on each of the ranks of a gloo mesh on the one card: the
    full-width bf16 daemon of `cli.serve` with `flags` (`--num_data_shards 2
    --bsz 4` or `--num_shot_shards 2 --nshot 2 --bsz 1`), its mesh built on
    gloo.  First every rank makes the bare pipeline calls (the warm-up, a
    one-off episode, under the data mesh a batch-1 cache and a cached call);
    then rank 0 serves HTTP in a thread of its own and its main thread asks:
    the one-off request (and supports.add and a cached request), each
    counted and equal to its bare call bit for bit, then timed requests;
    the followers follow.  Every rank counts its launches over the
    session."""
    import torch
    from diffews_tpu_torch.cli import serve
    from diffews_tpu_torch.parallel import mesh as M

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import cuda_serve_bench as SB

    setup = serve._setup_meshes
    serve._setup_meshes = lambda args, device_type: setup(args, "cpu")
    try:
        ms = serve.make_server(serve.build_parser().parse_args(
            ["--checkpoint", ckpt, "--half_precision", "--device", "cuda",
             "--img-size", str(SERVE_PX), *flags]))
    finally:
        serve._setup_meshes = setup
    pipe, b, n, data = ms.pipe, ms.bsz, ms.nshot, "--num_data_shards" in flags
    q, sup, m = _episode(b, n, SERVE_PX, seed=40)
    sup_n, m_n = sup[0], m[0].astype(np.float32)  # the request's shots
    supb = np.broadcast_to(sup_n[None], (b,) + sup_n.shape)
    mb = np.broadcast_to(m_n[None], (b,) + m_n.shape)
    pipe.predict(q, supb, mb, r_threshold=0.25)  # warm: builds the kernels
    bare = {"oneoff": pipe.predict(q, supb, mb, r_threshold=0.25)}
    if data:
        c1 = pipe.precompute_supports(sup_n[None], m_n[None])
        bare["cached"] = pipe.predict_cached(q, c1, r_threshold=0.25)
        del c1
    torch.cuda.synchronize()
    res = {"label": label, "mesh": serve.mesh_desc(pipe), "rank": M.rank()}
    _zero_counts()
    if ms.follower:
        ms.follow()
        torch.cuda.synchronize()
        res["session_launches"] = _launch_counts()
        return res

    httpd, base = SB.start_daemon(ms)
    try:
        def counted(path, body):
            before = _launch_counts()
            out = SB.post(base, path, body)
            torch.cuda.synchronize()
            return out, {k: v - before[k] for k, v in _launch_counts().items()}

        raw_q = [SB.raw(x) for x in q]
        oneoff_body = {"query": raw_q, "supports": [SB.raw(x) for x in sup_n],
                       "masks": [SB.raw(x) for x in m[0]], "return_seg": True,
                       "encoding": "raw"}
        got, launches = counted("/v1/segment", oneoff_body)
        res["launches"] = {"oneoff": launches}
        want = bare["oneoff"]
        check(all(np.array_equal(_unraw(sg), want.seg_colored[i])
                  and np.array_equal(_unraw(k) > 0, want.mask[i])
                  for i, (sg, k) in enumerate(zip(got["seg"], got["masks"]))),
              f"multi (e) {label}: the one-off answer differs from the bare call")
        bodies = {"oneoff": oneoff_body}
        if data:
            added, res["launches"]["supports_add"] = counted(
                "/v1/supports", {"images": [SB.raw(sup_n[0])], "masks": [SB.raw(m[0][0])]})
            bodies["cached"] = {"query": raw_q, "cache_id": added["cache_id"],
                                "return_seg": True, "encoding": "raw"}
            got, res["launches"]["cached"] = counted("/v1/segment", bodies["cached"])
            check(all(np.array_equal(_unraw(sg), bare["cached"].seg_colored[i])
                      for i, sg in enumerate(got["seg"])),
                  f"multi (e) {label}: the cached answer differs from the bare call")
        else:
            st = None
            try:
                SB.post(base, "/v1/supports", {"images": [SB.raw(sup_n[0])],
                                               "masks": [SB.raw(m[0][0])]})
            except Exception as e:  # urllib's HTTPError carries the status
                st = getattr(e, "code", None)
            check(st == 400, f"multi (e) {label}: /v1/supports answered {st}, not 400")
        res["health_mesh"] = SB.get(base, "/healthz")["mesh"]
        for kind, body in bodies.items():
            t0 = time.time()
            for _ in range(SHARDED_SERVE_TIMED):
                SB.post(base, "/v1/segment", body)
            wall = time.time() - t0
            res[f"{kind}_qps"] = SHARDED_SERVE_TIMED * b / wall
            res[f"{kind}_request_s"] = wall / SHARDED_SERVE_TIMED
    finally:
        httpd.shutdown()
        httpd.server_close()
        ms.close()
    torch.cuda.synchronize()
    res["session_launches"] = _launch_counts()
    res["stats"] = ms.stats_snapshot()
    return res


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                 "ROLE_RANK", "ROLE_WORLD_SIZE", "GROUP_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "TORCHELASTIC_RUN_ID")


def _run_cli(kind, argv) -> dict:
    """`main(argv)` of the train CLI (its steps counted by `_CountedSteps`;
    "train_gloo": its mesh built on gloo, which lets two ranks share the
    one card where NCCL refuses them) or the eval CLI ("eval";
    "eval_plain": with torchrun's environment hidden, so that it runs as
    one plain process), or the sharded daemon ("serve_sharded",
    `_serve_sharded`), its wall and the peak memory."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hidden = {k: os.environ.pop(k) for k in _TORCHRUN_ENV
              if kind == "eval_plain" and k in os.environ}
    if kind in ("train_gloo", "serve_sharded"):
        # one gloo process group for all the rank's runs: a process group
        # destroyed and made again in one process next to groups of its own
        # (the daemon's) can hang or abort at exit
        from diffews_tpu_torch.parallel import mesh as M

        M.maybe_initialize_distributed(device_type="cpu")
    t0 = time.time()
    try:
        if kind == "serve_sharded":
            res = _serve_sharded(argv[0], argv[1], argv[2:])
        elif kind.startswith("train"):
            from diffews_tpu_torch.cli import train as TT

            counted, setup = _CountedSteps(TT.make_train_step), TT._setup_mesh
            TT.make_train_step = counted
            if kind == "train_gloo":
                TT._setup_mesh = lambda args, device_type: setup(args, "cpu")
            try:
                report = TT.main(argv)
            finally:
                TT.make_train_step, TT._setup_mesh = counted.make, setup
            res = {"log": report["log"], "saves": report["saves"],
                   "load_s": report.get("load_s"), "steps": counted.calls}
        else:
            from diffews_tpu_torch.cli import evaluate as TE

            res = {"metrics": list(TE.main(argv))}
    finally:
        os.environ.update(hidden)
    res.update(wall_s=time.time() - t0, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return res


def rank_main(argv):
    """One rank of phase multi, started by `torchrun`:
    `chip_smoke.py --rank-task serve_train <out_dir>`, or
    `chip_smoke.py --rank-task cli <out_dir> -- <kind> <argv> [-- <kind> <argv> ...]`
    (CLI runs in turn in this process, kind train / train_gloo / eval /
    eval_plain / serve_sharded)."""
    task, out_dir = argv[0], argv[1]
    sys.path.insert(0, ROOT)
    if task == "serve_train":
        return _rank_serve_train(out_dir)
    rank = int(os.environ["RANK"])
    runs, cur = [], None
    for tok in argv[2:]:
        if tok == "--":
            cur = None
        elif cur is None:
            cur = (tok, [])
            runs.append(cur)
        else:
            cur[1].append(tok)
    res = [dict(_run_cli(kind, cli_argv), kind=kind, rank=rank) for kind, cli_argv in runs]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _multi_serve_train(tmp):
    """(a) shot-parallel serving, (b)'s tiny DP steps and (d)'s tiny TP
    steps: 2 ranks, gloo."""
    out = os.path.join(tmp, "serve_train")
    os.makedirs(out)
    wall = _torchrun(MULTI_RANKS, [os.path.join(ROOT, "chip_smoke.py"), "--rank-task",
                                   "serve_train", out], os.path.join(tmp, "serve_train.log"),
                     timeout=600)
    ranks = _rank_results(out, MULTI_RANKS)
    segs = [np.load(os.path.join(out, f"rank{r}_bf16_seg.npy")) for r in range(MULTI_RANKS)]
    check(np.array_equal(segs[0], segs[1]),
          "multi (a) bf16: the two ranks' predictions differ")
    s0 = ranks[0]["serve"]
    for r in ranks:
        got, want = r["serve"]["launches_per_episode"], s0["single_launches_per_episode"]
        check(got["lse_merges"] == CACHE_SITES,
              f"multi (a): rank {r['rank']} merged {got['lse_merges']} sites, expected "
              f"{CACHE_SITES}")
        check({k: v for k, v in got.items() if k != "lse_merges"} == want,
              f"multi (a): rank {r['rank']} launched {got}, the single-process episode "
              f"{want}")
        check(r["train"]["loss"] == ranks[0]["train"]["loss"],
              "multi (b): the ranks' DP losses differ")
    check(all(r["tp"]["loss"] == ranks[0]["tp"]["loss"] for r in ranks),
          f"multi (d): the ranks' tiny TP losses differ: {[r['tp']['loss'] for r in ranks]}")
    return {"wall_s": wall, "backend": ranks[0]["backend"],
            "serve": [r["serve"] for r in ranks], "train_tiny": [r["train"] for r in ranks],
            "tp_tiny": [r["tp"] for r in ranks]}


def _multi_cli(tmp, name, nproc, runs, timeout):
    """CLI runs [(kind, argv), ...] in turn in each of `nproc` torchrun
    ranks: (torchrun wall, each rank's list of results)."""
    out = os.path.join(tmp, name)
    os.makedirs(out)
    target = [os.path.join(ROOT, "chip_smoke.py"), "--rank-task", "cli", out]
    for kind, argv in runs:
        target += ["--", kind, *argv]
    wall = _torchrun(nproc, target, os.path.join(tmp, f"{name}.log"), timeout)
    return wall, _rank_results(out, nproc)


# all_reduces per tensor-parallel CLI micro-step (gas 1, remat) of a rank,
# over "model" (the data axis has one rank, whose collectives are skipped):
# per transformer block 3 row-parallel sums in the forward, 3 again in the
# recomputation, 3 input-gradient sums (attn1, attn2's query, the FFN) and
# the GEGLU bias's gradient gather: 10; 16 blocks; then the optimizer's
# non-finite vote and global norm
TP_CLI_ALL_REDUCES = 16 * 10 + 2


def _sharded_serve_summary(ranks, card) -> dict:
    """(e)'s checks over the ranks' results ([data, shots] per rank): rank
    0's requests launched what the single-device daemon's do, each
    follower launched what rank 0 did over the session, healthz names JAX's
    mesh; the q/s."""
    out = {}
    for i, (label, mesh) in enumerate((("data", "data=2xmodel=1"), ("shots", "shots=2"))):
        r0, followers = ranks[0][i], [r[i] for r in ranks[1:]]
        expect = {"oneoff": EPISODE_LAUNCHES["xla"],
                  "supports_add": CACHED_LAUNCHES["xla", "capture"],
                  "cached": CACHED_LAUNCHES["xla", "predict"]}
        for kind, counts in r0["launches"].items():
            check(counts == expect[kind], f"multi (e) {label} {kind} launched {counts}, "
                  f"expected {expect[kind]}")
        for f in followers:
            check(f["session_launches"] == r0["session_launches"],
                  f"multi (e) {label}: rank {f['rank']} launched {f['session_launches']}, "
                  f"rank 0 {r0['session_launches']}")
        check(r0["mesh"] == r0["health_mesh"] == mesh,
              f"multi (e) {label}: healthz mesh {r0['health_mesh']!r}, expected {mesh!r}")
        out[label] = {k: v for k, v in r0.items() if k not in ("rank", "label")}
        out[label].update(peak_mem_gb=[r[i]["peak_mem_gb"] for r in ranks],
                          main_wall_s=[r[i]["wall_s"] for r in ranks], card=card,
                          ranks=len(ranks), backend="gloo", answers_equal_bare_calls=True)
        emit({"phase": f"multi_sharded_daemon_{label}_512px_bf16",
              **{k: v for k, v in out[label].items() if k != "stats"}})
    return out


def phase_multi(card, work):
    """Multi-device serving and training on the one card: (a) shot-parallel
    serving and (b) data-parallel training on 2 ranks over gloo, (c) the
    train CLI (FSDP) and the eval CLI at world size 1 over NCCL, (d)
    tensor-parallel training and (e) the sharded daemon on 2 ranks over
    gloo."""
    import shutil

    t0 = time.time()
    ckpt, data = os.path.join(work, "full_ckpt"), os.path.join(work, "data")
    tmp = os.path.join(work, "multi")
    os.makedirs(tmp)
    res = _multi_serve_train(tmp)
    emit({"phase": "multi_shot_parallel_2shot_b1_512px", "ranks": MULTI_RANKS,
          "backend": res["backend"], "card": card,
          **{k: v for k, v in res["serve"][0].items()},
          "rank1": {k: res["serve"][1][k] for k in ("launches_per_episode", "sharded_wall_s")}})
    emit({"phase": "multi_dp_tiny_f32", "ranks": MULTI_RANKS, **res["train_tiny"][0]})
    emit({"phase": "multi_tp_tiny_f32", "ranks": MULTI_RANKS, "mesh": "data=1xmodel=2",
          **res["tp_tiny"][0],
          "rank1_model_ranges_level0_to_q": res["tp_tiny"][1]["model_ranges_level0_to_q"]})

    def train_argv(out, *extra):
        return ["--pretrained_model_name_or_path", ckpt, "--datapath", data,
                "--benchmark", "coco", "--fold", "0", "--nshot", "1", "--resolution", "512",
                "--gradient_accumulation_steps", "1", "--logging_steps", "1", "--seed", "0",
                "--output_dir", out, "--device", "cuda", "--max_train_steps", "2",
                "--checkpointing_steps", "100", *extra]

    def steps_summary(runs):
        """Two CLI steps (the second the steady one) of each rank's run."""
        r0 = runs[0]
        for r in runs:
            for i, st in enumerate(r["steps"]):
                check(st["launches"] == TRAIN_CLI_LAUNCHES,
                      f"multi CLI rank {r['rank']} step {i + 1} launched {st['launches']}")
        losses = [x["loss"] for x in r0["log"]]
        check(len(losses) == 2 and all(np.isfinite(losses)), f"multi CLI losses {losses}")
        walls = {x["step"]: x["wall_s"] for x in r0["log"]}
        return {"losses": losses, "cli_step2_wall_s": walls[2] - walls[1],
                "step_fn_synced_s": [[st["synced_s"] for st in r["steps"]] for r in runs],
                "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
                "launches_per_micro_step": r0["steps"][0]["launches"],
                "main_wall_s": [r["wall_s"] for r in runs], "load_s": r0["load_s"]}

    # in one torchrun of 2 ranks over gloo, one run after another: (b) the
    # full-width bf16 CLI data-parallel, b1 a rank; (d) the same CLI tensor
    # parallel over 2 ranks (the b1 batch whole on each); (e) the daemon on
    # a data mesh (bsz 4) and on a shot mesh (2 shots, bsz 1)
    dp_out, tp_out = os.path.join(tmp, "dp_full"), os.path.join(tmp, "tp_full")
    wall, ranks = _multi_cli(tmp, "gloo_cli", MULTI_RANKS, [
        ("train_gloo", train_argv(dp_out, "--train_batch_size", "2", "--num_data_shards", "2")),
        ("train_gloo", train_argv(tp_out, "--train_batch_size", "1", "--num_data_shards", "1",
                                  "--num_model_shards", str(MULTI_RANKS))),
        ("serve_sharded", [ckpt, "data", "--num_data_shards", "2", "--bsz", "4",
                           "--nshot", "1"]),
        ("serve_sharded", [ckpt, "shots", "--num_shot_shards", "2", "--bsz", "1",
                           "--nshot", "2"])], timeout=900)
    res["gloo_torchrun_wall_s"] = wall
    res["dp_full"] = dict(steps_summary([r[0] for r in ranks]), card=card, ranks=MULTI_RANKS,
                          backend="gloo")
    emit({"phase": "multi_dp_cli_full_1shot_b1_per_rank_512px_bf16", **res["dp_full"]})
    tp = [r[1] for r in ranks]
    res["tp_full"] = dict(steps_summary(tp), card=card, ranks=MULTI_RANKS, backend="gloo",
                          dp_peak_mem_gb=res["dp_full"]["peak_mem_gb"],
                          all_reduces_per_micro_step=[[st["all_reduces"] for st in r["steps"]]
                                                      for r in tp],
                          all_reduce_bytes_per_micro_step=[
                              [st["all_reduce_bytes"] for st in r["steps"]] for r in tp])
    check(all(n == TP_CLI_ALL_REDUCES for r in res["tp_full"]["all_reduces_per_micro_step"]
              for n in r), f"multi (d): all_reduces per step "
          f"{res['tp_full']['all_reduces_per_micro_step']}, expected {TP_CLI_ALL_REDUCES}")
    # the CLI runs cuDNN's deterministic algorithms on the card: every rank
    # computes the replicated leaves alike, so the ranks' losses are equal
    tp_losses = [[st["loss"] for st in r["steps"]] for r in tp]
    check(all(x == tp_losses[0] for x in tp_losses),
          f"multi (d): the TP CLI ranks' losses differ: {tp_losses}")
    for out in (dp_out, tp_out):
        shutil.rmtree(out)
    emit({"phase": "multi_tp_cli_full_1shot_b1_model2_512px_bf16", **res["tp_full"]})
    res["serve_sharded"] = _sharded_serve_summary([r[2:] for r in ranks], card)

    # (c) world size 1 over NCCL, in one fresh process: the eval CLI
    # plainly (torchrun's environment hidden) first, so that nothing run
    # before it in the process sets its numerics, then with
    # --num_data_shards 1 (a data mesh over the process group), then plainly
    # again (a warm wall beside the NCCL run's); then the train CLI under
    # --fsdp
    out = os.path.join(tmp, "fsdp_full")
    eval_argv = ["--checkpoint", ckpt, "--datapath", data, "--benchmark", "coco", "--fold",
                 "0", "--nshot", "1", "--threshold", "0", "--r_threshold", "0.25",
                 "--img-size", "512", "--bsz", "4", "--max_episodes", "4", "--half_precision",
                 "--device", "cuda"]
    runs = [(kind, eval_argv + ["--log-root", os.path.join(tmp, f"eval{i}"), *extra])
            for i, (kind, extra) in enumerate((("eval_plain", ()),
                                               ("eval", ("--num_data_shards", "1")),
                                               ("eval_plain", ())))]
    runs.append(("train", train_argv(out, "--train_batch_size", "1", "--num_data_shards", "1",
                                     "--fsdp")))
    wall, ranks = _multi_cli(tmp, "nccl_cli", 1, runs, timeout=400)
    plain, nccl, plain_warm, train = ranks[0]
    single = RESULTS.get("train_cli", {}).get("full", {})
    res["fsdp_full_world1"] = dict(
        steps_summary([train]), torchrun_wall_s=wall, card=card, backend="nccl",
        plain_cli_step2_wall_s=single.get("cli_step2_wall_s"),
        plain_cli_step2_wall_s_without_deterministic=single.get(
            "cli_step2_wall_s_without_deterministic"))
    shutil.rmtree(out)
    emit({"phase": "multi_fsdp_cli_world1_full_1shot_b1_512px_bf16", **res["fsdp_full_world1"]})
    check(nccl["metrics"] == plain["metrics"] == plain_warm["metrics"],
          f"multi (c) eval CLI over NCCL {nccl['metrics']} vs plain {plain['metrics']}, "
          f"{plain_warm['metrics']}")
    res["eval_world1"] = {"metrics": plain["metrics"], "main_wall_s": nccl["wall_s"],
                          "plain_main_wall_s": plain_warm["wall_s"],
                          "plain_first_in_process_main_wall_s": plain["wall_s"],
                          "peak_mem_gb": nccl["peak_mem_gb"], "backend": "nccl",
                          "batches": 4, "bsz": 4, "card": card,
                          "order": "plain (first in its process), over NCCL, plain "
                                   "again, then the FSDP train CLI, in one process"}
    emit({"phase": "multi_eval_cli_world1_1shot_b4_512px_bf16", **res["eval_world1"]})
    shutil.rmtree(tmp)
    res["seconds"] = time.time() - t0
    emit({"phase": "multi", "seconds": res["seconds"]})
    RESULTS["multi"] = res
    s = res["serve"][0]
    sd = res["serve_sharded"]
    return {"shot_parallel_episode_2shot_b1_per_rank": s["launches_per_episode"],
            "dp_cli_micro_step_1shot_b1_per_rank": res["dp_full"]["launches_per_micro_step"],
            "fsdp_cli_world1_micro_step_1shot_b1":
                res["fsdp_full_world1"]["launches_per_micro_step"],
            "tp_cli_micro_step_1shot_b1_model2_per_rank":
                res["tp_full"]["launches_per_micro_step"],
            "sharded_daemon_data2_oneoff_b4_per_rank": sd["data"]["launches"]["oneoff"],
            "sharded_daemon_data2_cached_b4_per_rank": sd["data"]["launches"]["cached"],
            "sharded_daemon_shots2_oneoff_2shot_b1_per_rank": sd["shots"]["launches"]["oneoff"]}


def kernel_record(rows, bwd_rows, norm_rows, fused_rows, down_rows, episode_launches,
                  train_launches, cached_launches, down_launches, eval_launches,
                  serve_launches, train_cli_launches, multi_launches, int8_rows, int8_launches,
                  depth_launches, adamw_row):
    """One entry per kernel.  `launches` is the count on the path of the
    slice that ported it (the training micro-step for the flash kernels,
    the default episode for the GroupNorm kernels, the `vae_impl="fused"`
    episode for the fused conv, the entry point `downsample_conv2x` on the
    encoder's three B = 12 inputs for the downsample kernel, which no
    pipeline path calls; the `vae_impl="int8"` episode for the int8
    kernels); `launches_by_path` gives every path's."""
    main = [r for r in rows if r["shape"] == MAIN_SHAPE and r["dtype"] == "bfloat16"][0]
    bmain = [r for r in bwd_rows
             if r["shape"] == BWD_MAIN_SHAPE and r["dtype"] == "bfloat16"][0]
    nmain = [r for r in norm_rows
             if tuple(r["shape"]) == NORM_MAIN_SHAPE and r["dtype"] == "bfloat16"][0]
    fmain = [r for r in fused_rows if tuple(r["shape"]) + (r["residual"],) == FUSED_MAIN_SHAPE
             and r["dtype"] == "bfloat16"][0]
    dmain = [r for r in down_rows
             if tuple(r["shape"]) == DOWN_MAIN_SHAPE and r["dtype"] == "bfloat16"][0]
    paths = dict(episode_launches, **depth_launches, **int8_launches, **cached_launches,
                 **eval_launches,
                 **serve_launches, **train_cli_launches, **multi_launches,
                 train_micro_step_1shot_b1=train_launches,
                 downsample_conv2x_encoder_inputs_b12=down_launches)
    by_path = lambda key: {p: c[key] for p, c in paths.items()}
    src = "diffews_tpu_torch/ops/csrc/"
    fwd = {"name": "flash_attention_fwd", "route": "cuda", "source": src + "flash_attention_fwd.cu",
           "replaces": "diffews_tpu/ops/flash_attention.py:73",
           "design": "bf16: warp-specialised (a TMA producer warp, two wgmma consumer "
                     "warpgroups, setmaxnreg); d <= 64: 128x128 tiles in a 3-stage "
                     "mbarrier ring, P from registers; d = 512: 64x64 tiles, K and V "
                     "staged apart, O's dims split over the warpgroups; KV tiles with "
                     "no valid key skipped; f32: FMA kernel",
           "launches": train_launches["flash_attention_fwd"],
           "launches_by_path": by_path("flash_attention_fwd"),
           "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": main["ms"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": main["library_ms"]}
    out = [fwd]
    for kind, line, errs in (("dq", 179, ("dq",)), ("dkv", 212, ("dk", "dv"))):
        name = f"flash_attention_bwd_{kind}"
        out.append({
            "name": name, "route": "cuda", "source": src + "flash_attention_bwd.cu",
            "replaces": f"diffews_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name],
            "launches_by_path": {"train_micro_step_1shot_b1": train_launches[name],
                                 **{p: c[name] for p, c in train_cli_launches.items()},
                                 **{p: c[name] for p, c in multi_launches.items()
                                    if name in c}},
            "max_abs_err": max(r["max_abs_err"][e] for r in bwd_rows for e in errs),
            "ms": bmain[f"{kind}_ms"], "plain_ms": bmain["plain_ms"],
            "bound_ms": bmain[f"{kind}_bound_ms"], "bound_by": bmain[f"{kind}_bound_by"],
            "library_ms": bmain["library_ms"], "whole_bwd_ms": bmain["bwd_ms"],
            "library_device_ms": bmain["library_device_ms"],
            "whole_bwd_device_ms": bmain["bwd_device_ms"],
            "design": "bf16: warp-specialised (a TMA producer warp, two wgmma consumer "
                      "warpgroups, setmaxnreg); dq: 128 query rows per CTA, 128-key tiles "
                      "in a 3-stage ring, masked key tiles skipped, delta computed; dkv: "
                      "128 keys per CTA, 64-row q-tiles in a 4-stage ring; walks split "
                      "over CTAs for small grids, f32 partials summed in order; f32: FMA",
            "shape": f"B1 H5 4096x8192 d64 bf16; plain_ms, library_ms and whole_bwd_ms "
                     "are the whole backward (dq, dk, dv; whole_bwd_ms: the "
                     "flash_attention_bwd call, delta included); *_device_ms: the "
                     "profiler's kernel time alone"})
    gn_shape = "x".join(map(str, NORM_MAIN_SHAPE))
    out.append({
        "name": "gn_stats", "route": "cuda", "source": src + "groupnorm.cu",
        "replaces": "diffews_tpu/ops/groupnorm.py:53",
        "launches": episode_launches["episode_1shot_b4"]["gn_stats"],
        "launches_by_path": by_path("gn_stats"),
        "max_abs_err": max(r["stats_max_abs_err"] for r in norm_rows),
        "ms": nmain["stats_ms"], "plain_ms": nmain["stats_plain_ms"],
        "bound_ms": nmain["stats_bound_ms"], "bound_by": "bytes",
        "library_ms": nmain["library_ms"],
        "shape": f"{gn_shape} (B, H, W, C) bf16, 32 groups; plain_ms is the plain Σx, Σx², "
                 "library_ms F.group_norm + F.silu (the whole op)"})
    out.append({
        "name": "gn_apply", "route": "cuda", "source": src + "groupnorm.cu",
        "replaces": "diffews_tpu/ops/groupnorm.py:73",
        "launches": episode_launches["episode_1shot_b4"]["gn_apply"],
        "launches_by_path": by_path("gn_apply"),
        "max_abs_err": max(r["max_abs_err"] for r in norm_rows),
        "ms": nmain["apply_ms"], "plain_ms": nmain["plain_ms"],
        "bound_ms": nmain["apply_bound_ms"], "bound_by": "bytes",
        "library_ms": nmain["library_ms"],
        "whole_op_ms": nmain["ms"],
        "shape": f"{gn_shape} bf16 with SiLU; plain_ms and library_ms (F.group_norm + "
                 "F.silu) are the whole GroupNorm+SiLU, as is whole_op_ms (stats, fold, "
                 "apply)"})
    out.append({
        "name": "fused_gn_silu_conv3x3", "route": "cuda", "source": src + "fused_resnet.cu",
        "replaces": "diffews_tpu/ops/fused_resnet.py:88",
        "launches": episode_launches["episode_1shot_b4_fused"]["fused_gn_silu_conv3x3"],
        "launches_by_path": by_path("fused_gn_silu_conv3x3"),
        "max_abs_err": max(r["max_abs_err"] for r in fused_rows),
        "ms": fmain["ms"], "plain_ms": fmain["plain_ms"], "bound_ms": fmain["bound_ms"],
        "bound_by": fmain["bound_by"], "library_ms": fmain["library_ms"],
        "tflops": fmain["tflops"], "share_of_bound": fmain["share_of_bound"],
        "design": "bf16: persistent implicit GEMM on the shared wgmma core (conv_common.cuh): "
                  "16x16-pixel tiles, weights by TMA (all nine taps of a 16-channel chunk), "
                  "the halo patch by cp.async from a producer warpgroup, two wgmma consumer "
                  "warpgroups (A: the patch's no-swizzle core-matrix windows, one per tap) "
                  "that apply affine + SiLU to chunk k+1's patch in place while chunk k's "
                  "products run, residual staged in shared memory, 16-byte output stores; "
                  "BN 128, heads BN 8; f32: FMA kernel",
        "shape": "B12 512x512 128->128 with residual, bf16; library_ms is cuDNN's conv "
                 "alone (F.conv2d with bias)"})
    out.append({
        "name": "downsample_conv2x", "route": "cuda", "source": src + "downsample.cu",
        "replaces": "diffews_tpu/ops/downsample.py:86",
        "launches": down_launches["downsample_conv2x"],
        "launches_by_path": by_path("downsample_conv2x"),
        "max_abs_err": max(r["max_abs_err"] for r in down_rows),
        "ms": dmain["ms"], "plain_ms": dmain["plain_ms"], "bound_ms": dmain["bound_ms"],
        "bound_by": dmain["bound_by"], "library_ms": dmain["library_ms"],
        "tflops": dmain["tflops"], "share_of_bound": dmain["share_of_bound"],
        "design": "bf16: persistent implicit GEMM on the shared wgmma core (conv_common.cuh): "
                  "16x16 output tiles, weights by TMA, the 33x33 stride-2 patch (even columns "
                  "before odd) by cp.async that arrives on the stage's mbarrier as it lands, "
                  "two wgmma consumer warpgroups, N blocks of a tile adjacent in the walk; "
                  "f32: FMA kernel",
        "shape": "B12 512x512 128->128 bf16 (the encoder's first downsample); launches: "
                 "the entry point on the encoder's three B = 12 inputs, 0 on every "
                 "pipeline path (no model calls the op, as in the JAX package); "
                 "library_ms is F.pad + cuDNN's strided F.conv2d"})
    imain = [r for r in int8_rows
             if tuple(r["shape"]) + (r["stride"],) == INT8_MAIN_SHAPE][0]
    i8_shape = "x".join(map(str, imain["shape"]))
    out.append({
        "name": "quantize_s8", "route": "cuda", "source": src + "quant_int8.cu",
        "replaces": "diffews_tpu/ops/quant.py:327 (XLA ops, no pallas_call)",
        "launches": int8_launches["episode_1shot_b4_int8"]["quantize_s8"],
        "launches_by_path": by_path("quantize_s8"), "max_abs_err": 0.0,
        "ms": imain["quantize_ms"], "plain_ms": imain["quantize_plain_ms"],
        "bound_ms": imain["quantize_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "design": "8 elements a thread, 16-byte loads, a grid-stride loop; true division "
                  "and rintf (the plain version's torch ops bit for bit)",
        "shape": f"{i8_shape} (B, H, W, C) bf16 -> int8, static scale; no PyTorch call "
                 "computes this function (library_ms null); bit for bit equal to its "
                 "plain version at every shape"})
    out.append({
        "name": "conv2d_int8", "route": "cuda", "source": src + "quant_int8.cu",
        "replaces": "diffews_tpu/ops/quant.py:317 (XLA ops, no pallas_call)",
        "launches": int8_launches["episode_1shot_b4_int8"]["conv2d_int8"],
        "launches_by_path": by_path("conv2d_int8"), "max_abs_err": 0.0,
        "ms": imain["ms"], "plain_ms": imain["plain_ms"], "bound_ms": imain["bound_ms"],
        "bound_by": imain["bound_by"], "library_ms": None,
        "cudnn_bf16_ms": imain["cudnn_bf16_ms"], "tops": imain["tops"],
        "share_of_bound": imain["share_of_bound"],
        "design": "persistent implicit GEMM on the shared wgmma core (conv_common.cuh) in "
                  "int8: 16x16 output tiles, the nine taps' weights by one TMA box read in "
                  "place from the (Cout, 3, 3, Cin) codes, the patch by cp.async (zero fill "
                  "at the image edge and past Cin), 32-channel chunks in a 4-stage ring (3 "
                  "at stride 2), two consumer warpgroups of wgmma m64n128k32 s8 -> s32; the "
                  "heads (Cout <= 8) m64n8k32 at two CTAs an SM; epilogue f32(acc) * "
                  "(w_scale * s_a) + bias without FMA contraction",
        "shape": f"{i8_shape} -> {imain['shape'][4]} stride {imain['stride']}, int8 in, bf16 "
                 "out; no PyTorch call computes the int8 conv (library_ms null; cudnn_bf16_ms "
                 "is cuDNN's bf16 F.conv2d at the shape, the yardstick); bit for bit equal "
                 "to its plain version at every shape"})
    out.append({
        "name": "adamw_multi_tensor", "route": "cuda", "source": src + "adamw.cu",
        "replaces": "none: the JAX package leaves the optax chain to XLA's fusion",
        "launches": train_launches["adamw_apply"],
        "launches_by_kernel": {k: train_launches[k] for k in ADAMW_COUNTS},
        "launches_by_path": {"train_micro_step_1shot_b1": train_launches["adamw_apply"],
                             **{p: c["adamw_apply"] for p, c in train_cli_launches.items()},
                             **{p: c["adamw_apply"] for p, c in multi_launches.items()
                                if "adamw_apply" in c}},
        "cuda_calls_per_step": adamw_row["cuda_calls_per_step"],
        "max_abs_err": 0.0, "ms": adamw_row["ms"], "plain_ms": adamw_row["plain_ms"],
        "bound_ms": adamw_row["bound_ms"], "bound_by": "bytes",
        "library_ms": adamw_row["library_ms"], "share_of_bound": adamw_row["share_of_bound"],
        "design": "a chunk table over every leaf, one block a 65536-element chunk: a norm "
                  "pass (f32 partial Σg² and isfinite flag a chunk), a one-block finalise "
                  "(partials added in chunk order into the norm groups), then one apply "
                  "pass (clip, AdamW, apply_if_finite; correctly rounded f32 ops, 16-byte "
                  "accesses); nothing read on the host",
        "shape": "the SD-2.1 UNet's 688 leaves (865.9 M float32 masters, bf16 first "
                 "moment); bit for bit the plain update given the same norm; library_ms "
                 "is torch.optim.AdamW(fused=True) over the same leaves (f32 moments, no "
                 "clip), never on the port's path"})
    return {"kernels": out}


PHASES = ("device,build,kernel,bwd,norm,fused,downsample,adamw,tiny,tiny_train,full,depth,int8,eval,"
          "cached,serve,train,train_cli,multi")


def main():
    if sys.argv[1:2] == ["--rank-task"]:
        return rank_main(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=PHASES,
                    help="comma-separated subset of the phases (all by default)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    t_start = time.time()
    seconds = RESULTS.setdefault("phase_seconds", {})

    def run(name, fn, *args, default=None):
        """`fn(*args)` if phase `name` was asked for (else `default`), timed."""
        if name not in phases:
            return default
        t0 = time.time()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.time() - t0

    card = phase_device()
    run("build", phase_build)
    rows = run("kernel", phase_kernel, default=[])
    bwd_rows = run("bwd", phase_bwd, default=[])
    norm_rows, fused_rows, down_rows, down_launches = [], [], [], None
    if phases & {"norm", "fused", "downsample"}:
        t0 = time.time()
        gn_shapes, fr_shapes, down_inputs = episode_shapes()
        seconds["episode_shapes"] = time.time() - t0
        norm_rows = run("norm", phase_norm, gn_shapes, default=[])
        fused_rows = run("fused", phase_fused, fr_shapes, default=[])
        down_rows, down_launches = run("downsample", phase_downsample, down_inputs,
                                       default=([], None))
        del down_inputs
        torch.cuda.empty_cache()
    adamw_row = run("adamw", phase_adamw, card)
    run("tiny", phase_tiny)
    run("tiny_train", phase_tiny_train)
    episode_launches = run("full", phase_full, card)
    depth_launches = run("depth", phase_depth, card)
    int8_rows, int8_launches = run("int8", phase_int8, card, default=([], None))
    eval_launches = run("eval", phase_eval, card)
    cached_launches = run("cached", phase_cached, card)
    serve_launches = run("serve", phase_serve, card)
    train_launches = run("train", phase_train, card)
    import shutil
    import tempfile

    # phase train_cli leaves its full-width checkpoint and data for phase multi
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        train_cli_launches = run("train_cli", phase_train_cli, card, work)
        multi_launches = (run("multi", phase_multi, card, work)
                          if "train_cli" in phases else None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    RESULTS["seconds"] = time.time() - t_start
    emit({"phase": "phase_seconds", **seconds, "total": RESULTS["seconds"]})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)
    if phases != set(PHASES.split(",")):
        fail(f"phases {sorted(phases)} ran; the kernel record needs all of {PHASES}")
    emit(kernel_record(rows, bwd_rows, norm_rows, fused_rows, down_rows, episode_launches,
                       train_launches, cached_launches, down_launches, eval_launches,
                       serve_launches, train_cli_launches, multi_launches, int8_rows,
                       int8_launches, depth_launches, adamw_row))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
