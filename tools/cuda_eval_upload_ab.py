"""Time the eval harness with the pipeline's uploads from pageable memory
against uploads through pinned memory (`diffews_tpu_torch.utils.to_device`).

A copy from pageable host memory waits for the work queued on the stream,
so each episode's upload waits for the episode before it; a copy from
pinned memory does not.  This runs `diffews_tpu_torch.cli.evaluate` with the
random-weight SD-2.1 pipeline (bf16, 512px, 1-shot, `vae_impl` "xla") on a
synthetic COCO tree, 16 batches a run, at bsz 4 and 1 and dispatch-ahead 2
and 1, the two upload variants in turns (pageable, pinned, pinned,
pageable; twice), each run timed to the device's end, and checks that both
variants give the same metrics.

Needs one CUDA card.  Run from the root of a checkout:

    python3 tools/cuda_eval_upload_ab.py

Prints the card's name and power limit, then one JSON object per (bsz,
dispatch-ahead) with every run's episodes/s and the medians.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from diffews_tpu_torch import pipeline as TP  # noqa: E402
from diffews_tpu_torch.checkpoint import random_pipeline_bundle  # noqa: E402
from diffews_tpu_torch.cli import evaluate as TE  # noqa: E402
from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,  # noqa: E402
                                       UNetConfig, VAEConfig)
from helpers.synthetic_data import make_coco  # noqa: E402

BATCHES = 16
VARIANTS = {"pinned": TP.to_device,
            "pageable": lambda t, device: t.to(device, non_blocking=True)}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    pipe = TP.DiffewsPipeline(
        random_pipeline_bundle(UNetConfig.sd21(), VAEConfig.sd(), CLIPTextConfig.sd21(),
                               SchedulerConfig.diffews(), seed=0, device="cuda"),
        device="cuda", compute_dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        data = make_coco(os.path.join(tmp, "data"))

        def run(variant, bsz, depth):
            TP.to_device = VARIANTS[variant]
            try:
                args = TE.build_parser().parse_args([
                    "--checkpoint", "unused", "--datapath", data, "--benchmark", "coco",
                    "--fold", "0", "--nshot", "1", "--img-size", "512", "--threshold", "0",
                    "--r_threshold", "0.25", "--bsz", str(bsz), "--max_episodes",
                    str(BATCHES), "--dispatch_ahead", str(depth),
                    "--log-root", os.path.join(tmp, "logs")])
                torch.cuda.synchronize()
                t0 = time.time()
                metrics = TE.evaluate(args, pipe=pipe)
                torch.cuda.synchronize()
                return metrics, BATCHES * bsz / (time.time() - t0)
            finally:
                TP.to_device = VARIANTS["pinned"]

        for bsz in (4, 1):
            run("pinned", bsz, 2)  # warm-up: cuDNN plans, allocator, pinned blocks
            for depth in (2, 1):
                eps, metrics = {"pageable": [], "pinned": []}, set()
                for variant in ("pageable", "pinned", "pinned", "pageable") * 2:
                    m, e = run(variant, bsz, depth)
                    metrics.add(m)
                    eps[variant].append(e)
                if len(metrics) != 1:
                    sys.exit(f"bsz {bsz} dispatch-ahead {depth}: metrics differ: {metrics}")
                print(json.dumps({
                    "bsz": bsz, "dispatch_ahead": depth, "batches": BATCHES,
                    "episodes_per_s": eps,
                    "median": {k: statistics.median(v) for k, v in eps.items()},
                    "pinned_wins": sum(a > b for a, b in zip(eps["pinned"], eps["pageable"])),
                    "card": card}), flush=True)


if __name__ == "__main__":
    main()
