"""A diffusers-layout checkpoint written from the port's own seeded modules.

`write_checkpoint(root, ...)` draws a pipeline bundle from a seed
(`diffews_tpu_torch.checkpoint.random_pipeline_bundle`) and writes it in the
layout `diffews_tpu_torch.checkpoint.load_pipeline_bundle` reads: `unet/`,
`vae/` (`config.json` + `diffusion_pytorch_model.bin`), `text_encoder/`
(`config.json` + `pytorch_model.bin`, `text_model.`-prefixed keys) and
`scheduler/scheduler_config.json`.  With `safetensors=True` the weights go
through the port's savers instead (`diffusion_pytorch_model.safetensors`,
`model.safetensors`), as the JAX package and diffusers write them.
Imports torch and the port only, so the GPU tests and `chip_smoke.py` use
it on a host without JAX.
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


def write_checkpoint(root, unet_cfg, vae_cfg, text_cfg, scheduler_cfg, seed: int = 0,
                     safetensors: bool = False, device="cpu") -> str:
    """Write the seeded bundle, drawn on `device`, under `root` and return
    `root`."""
    b = TC.random_pipeline_bundle(unet_cfg, vae_cfg, text_cfg, scheduler_cfg, seed=seed,
                                  device=device)
    if safetensors:
        TC.save_unet(b.unet, unet_cfg, os.path.join(root, "unet"))
        TC.save_vae(b.vae, vae_cfg, os.path.join(root, "vae"))
        text_dir = os.path.join(root, "text_encoder")
        TC.save_torch_weights({"text_model." + k: v for k, v in b.text.state_dict().items()},
                              text_dir, TC.TEXT_SAFETENSORS)
        with open(os.path.join(text_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(text_cfg), f)
    else:
        _save(b.unet, unet_cfg.to_diffusers_dict(), os.path.join(root, "unet"), TC.WEIGHTS_BIN)
        _save(b.vae, vae_cfg.to_diffusers_dict(), os.path.join(root, "vae"), TC.WEIGHTS_BIN)
        _save(b.text, dataclasses.asdict(text_cfg), os.path.join(root, "text_encoder"),
              TC.TEXT_BIN, prefix="text_model.")
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(scheduler_cfg.to_diffusers_dict(), f)
    return str(root)
