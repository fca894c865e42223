"""A diffusers-layout checkpoint written from the port's own seeded modules.

`write_checkpoint(root, ...)` draws a pipeline bundle from a seed
(`diffews_tpu_torch.checkpoint.random_pipeline_bundle`) and writes it in the
layout `diffews_tpu_torch.checkpoint.load_pipeline_bundle` reads: `unet/`,
`vae/` (`config.json` + `diffusion_pytorch_model.bin`), `text_encoder/`
(`config.json` + `pytorch_model.bin`, `text_model.`-prefixed keys) and
`scheduler/scheduler_config.json`.  Imports torch and the port only, so the
GPU tests and `chip_smoke.py` use it on a host without JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from diffews_tpu_torch import checkpoint as TC


def _save(module, cfg_dict, out_dir, weights_name, prefix=""):
    os.makedirs(out_dir, exist_ok=True)
    state = {prefix + k: v.detach().cpu().contiguous() for k, v in module.state_dict().items()}
    torch.save(state, os.path.join(out_dir, weights_name))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f)


def write_checkpoint(root, unet_cfg, vae_cfg, text_cfg, scheduler_cfg, seed: int = 0) -> str:
    """Write the seeded bundle under `root` and return `root`."""
    b = TC.random_pipeline_bundle(unet_cfg, vae_cfg, text_cfg, scheduler_cfg, seed=seed)
    _save(b.unet, unet_cfg.to_diffusers_dict(), os.path.join(root, "unet"), TC.WEIGHTS_BIN)
    _save(b.vae, vae_cfg.to_diffusers_dict(), os.path.join(root, "vae"), TC.WEIGHTS_BIN)
    _save(b.text, dataclasses.asdict(text_cfg), os.path.join(root, "text_encoder"),
          TC.TEXT_BIN, prefix="text_model.")
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(scheduler_cfg.to_diffusers_dict(), f)
    return str(root)
