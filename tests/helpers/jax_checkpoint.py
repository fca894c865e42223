"""A tiny diffusers-layout checkpoint written by the JAX package's savers
(as `tests/test_cli.py` writes it): UNet (JAX seed 0), VAE (seed 1), CLIP
text encoder (seed 2) and the DiffewS scheduler config.  Both packages'
`load_pipeline_bundle` read it.  `tiny_params` gives the same UNet and VAE
weights, computed once a process: the jitted initialisers take tens of
seconds to compile on one CPU, and a test worker runs several modules."""

from __future__ import annotations

import functools
import json
import os

import jax

from diffews_tpu import checkpoint as JC
from diffews_tpu.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu.models import clip_text, unet, vae


@functools.lru_cache(maxsize=None)
def _tiny_params():
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
    return (jax.jit(lambda r: unet.init_params(r, ucfg))(jax.random.PRNGKey(0)),
            jax.jit(lambda r: vae.init_params(r, vcfg))(jax.random.PRNGKey(1)))


def tiny_params():
    """(UNet params of `UNetConfig.tiny()` from JAX seed 0, VAE params of
    `VAEConfig.tiny()` from seed 1), on the host."""
    return jax.device_get(_tiny_params())


def write_jax_checkpoint(ck: str) -> str:
    ucfg, vcfg, tcfg = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
    up, vp = tiny_params()
    JC.save_unet(up, ucfg, os.path.join(ck, "unet"))
    JC.save_vae(vp, vcfg, os.path.join(ck, "vae"))
    tp = clip_text.init_params(jax.random.PRNGKey(2), tcfg)
    state = {"text_model." + k: v for k, v in JC.pytree_to_torch_state(tp).items()}
    JC.save_torch_weights(state, os.path.join(ck, "text_encoder"), JC.TEXT_SAFETENSORS)
    with open(os.path.join(ck, "text_encoder", "config.json"), "w") as f:
        json.dump({"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
                   "num_hidden_layers": 2, "num_attention_heads": 4}, f)
    os.makedirs(os.path.join(ck, "scheduler"), exist_ok=True)
    with open(os.path.join(ck, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(SchedulerConfig.diffews().to_diffusers_dict(), f)
    return ck
