#!/usr/bin/env python3
"""Which op of the training micro-step makes a rerun differ on the card.

Runs a training micro-step's gradient twice on the same inputs, at two
sizes: "tiny" (the tiny configs in f32 with TF32 off, 2 shots, batch 2,
32px: the train CLI runs of `chip_smoke.py` phase train_cli (a), whose
resume on the card is exact only under `cudnn.deterministic`)
and "full" (SD-2.1 UNet with the 8-channel `conv_in_ref`, SD VAE, ViT-H
text embedding; bf16 compute, f32 masters, remat; 1-shot batch 1 at
512px); seeded random weights and inputs.  For each size, under cuDNN's
default algorithms and under `torch.backends.cudnn.deterministic`:

  - the leaves whose two gradients differ (their count, how many are 4-D
    conv weights, the first few names);
  - the CUDA kernels the micro-step launches (one profiled run), so that
    the kernels launched only without the setting name the algorithms it
    replaces;

and under `torch.use_deterministic_algorithms(True, warn_only=True)` the
ops torch warns about, after a control op that must warn (`torch.histc`
on the card, which has no deterministic implementation), which shows
that the warnings are caught.

Run on a host with a CUDA card (about two minutes):

    python3 tools/torch_cudnn_determinism.py [--out cudnn_determinism.json]

The last line of its output is the report as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _batch(b: int, n: int, px: int, seed: int) -> dict:
    """A micro-batch of uint8 images and {0,1} masks, a random rectangle
    each (as `chip_smoke.py`'s training batches)."""
    rng = np.random.default_rng(seed)
    img = lambda *sh: rng.integers(0, 256, sh + (px, px, 3), dtype=np.uint8)  # noqa: E731
    m = np.zeros((b, 1 + n, px, px), np.uint8)
    for idx in np.ndindex(b, 1 + n):
        y0, x0 = rng.integers(0, px // 2, 2)
        m[idx + (slice(y0, y0 + px // 2), slice(x0, x0 + px // 2))] = 1
    batch = {"query": img(b), "q_mask3": m[:, 0], "supports": img(b, n), "s_mask3": m[:, 1:],
             "shot_mask": np.ones((b, n), bool)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _micro_step(size: str):
    """`grads()`: the float32 gradients of one micro-step on fixed inputs."""
    from diffews_tpu_torch.configs import CLIPTextConfig, UNetConfig, VAEConfig
    from diffews_tpu_torch.models.clip_text import CLIPTextModel
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL
    from diffews_tpu_torch.training.state import (TrainerConfig, init_state, make_grad_fn,
                                                  training_text_embed)
    from diffews_tpu_torch.utils.init import build_module

    tiny = size == "tiny"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not tiny
    ucfg, vcfg, tcfg = ((UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()) if tiny
                        else (UNetConfig.sd21(), VAEConfig.sd(), CLIPTextConfig.sd21()))
    cfg = (TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32)
           if tiny else TrainerConfig())  # the full size: the train CLI's defaults
    cl = torch.channels_last
    unet = build_module(UNet2DConditionModel, ucfg, seed=0, device="cuda").to(memory_format=cl)
    vae = build_module(AutoencoderKL, vcfg, seed=1, device="cuda").to(
        dtype=cfg.compute_dtype, memory_format=cl).requires_grad_(False)
    text = build_module(CLIPTextModel, tcfg, seed=2, device="cuda")
    text_embed = training_text_embed(text, tcfg)
    del text
    state = init_state(cfg, dict(unet.named_parameters()), device="cuda")
    grad_fn = make_grad_fn(cfg, unet)
    b, n, px = (2, 2, 32) if tiny else (1, 1, 512)
    micro = _batch(b, n, px, seed=0)
    lh = px // (2 if tiny else 8)
    noise = torch.randn((2 * b + 2 * b * n, lh, lh, 4),
                        generator=torch.Generator().manual_seed(1)).cuda()

    def grads():
        _, g = grad_fn(state.params, vae, text_embed, micro, noise)
        return {k: t.detach().clone() for k, t in g.items()}

    return grads


def _probe(grads) -> dict:
    out = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        grads()  # warm: cuDNN's algorithm choice
        a, b = grads(), grads()
        differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            grads()
            torch.cuda.synchronize()
        out["deterministic" if det else "default"] = {
            "leaves_differ": len(differ), "leaves": len(a),
            "conv_weights_differ": sum(a[k].ndim == 4 for k in differ),
            "first_differ": differ[:8],
            "kernels": sorted({e.key for e in prof.key_averages()
                               if e.device_type == torch.autograd.DeviceType.CUDA})}
        del a, b
    torch.backends.cudnn.deterministic = False
    out["kernels_only_without_setting"] = sorted(
        set(out["default"]["kernels"]) - set(out["deterministic"]["kernels"]))
    for k in ("default", "deterministic"):
        out[k]["kernels"] = len(out[k]["kernels"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            control = torch.histc(torch.rand(8, device="cuda"))
            n_control = len(caught)
            grads()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    del control
    out["control_warned"] = n_control > 0
    out["deterministic_algorithms_warnings"] = sorted(
        {str(w.message) for w in caught[n_control:]})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    report = {"card": smi.stdout.strip(), "torch": torch.__version__}
    for size in ("tiny", "full"):
        report[size] = _probe(_micro_step(size))
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
