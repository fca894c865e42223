"""Weights for the port: diffusers checkpoints and JAX parameter trees.

Port of `diffews_tpu/checkpoint.py`: loaders, savers and the checkpoint
surgery.  `.safetensors` files go through the port's own codec
(`utils/safetensors_codec.py`), so neither reading nor writing needs the
`safetensors` package; the savers write what the JAX package's
`save_unet` / `save_vae` write (`checkpoint.py:160-216`): `config.json`
and `diffusion_pytorch_model.safetensors` with the diffusers key names and
torch layouts of `pytree_to_torch_state`, float32 as the state holds it.
The port's modules
carry the diffusers key names, so a diffusers directory loads with
`load_state_dict(strict=True)` after two mechanical fixes the JAX loader
also makes: the legacy VAE attention names (query/key/value/proj_attn ->
to_q/to_k/to_v/to_out.0, `checkpoint.py:52-57,76-78`) and the CLIP text
encoder's `text_model.` prefix; non-parameter buffers (position_ids) are
dropped.

`state_dict_from_jax` carries a JAX parameter tree (nested dicts of numpy
arrays, JAX layouts) over with the rules of `pytree_to_torch_state`
(`checkpoint.py:105-125`): conv kernel HWIO -> OIHW, linear kernel
(in, out) -> (out, in), norm `scale` -> `weight`, `embedding` -> `weight`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig, UNetConfig,
                                       VAEConfig, load_json_config)
from diffews_tpu_torch.models.clip_text import CLIPTextModel
from diffews_tpu_torch.models.unet import UNet2DConditionModel
from diffews_tpu_torch.models.vae import AutoencoderKL
from diffews_tpu_torch.utils import safetensors_codec
from diffews_tpu_torch.utils.init import build_module

WEIGHTS_SAFETENSORS = "diffusion_pytorch_model.safetensors"
WEIGHTS_BIN = "diffusion_pytorch_model.bin"
TEXT_SAFETENSORS = "model.safetensors"
TEXT_BIN = "pytorch_model.bin"

_LEGACY_VAE_ALIASES = {"query": "to_q", "key": "to_k", "value": "to_v",
                       "proj_attn": "to_out.0"}


def state_dict_from_jax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested JAX param tree (numpy leaves) -> flat torch state dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, order="C"))

    def rec(node, path):
        w, b = (".".join(path + [leaf]) for leaf in ("weight", "bias"))
        if "kernel" in node:
            arr = np.asarray(node["kernel"])
            put(w, arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
        if "scale" in node:
            put(w, np.asarray(node["scale"]))
        if "embedding" in node:
            put(w, np.asarray(node["embedding"]))
        if "bias" in node:
            put(b, np.asarray(node["bias"]))
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, path + [k])

    rec(tree, [prefix] if prefix else [])
    return out


def normalize_diffusers_keys(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Map a diffusers/transformers state dict onto the port's keys: strip
    `text_model.`, rename legacy VAE attention modules, and keep only
    `weight`/`bias` entries."""
    out = {}
    for key, val in state.items():
        if key.startswith("text_model."):
            key = key[len("text_model."):]
        parts = key.split(".")
        if parts[-1] not in ("weight", "bias"):
            continue
        if len(parts) >= 2 and parts[-2] in _LEGACY_VAE_ALIASES:
            parts = parts[:-2] + _LEGACY_VAE_ALIASES[parts[-2]].split(".") + parts[-1:]
        out[".".join(parts)] = val
    return out


def _load_torch_weights(model_dir: str, names: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    for name in names:
        path = os.path.join(model_dir, name)
        index = path + ".index.json"
        if name.endswith(".safetensors") and (os.path.exists(path) or os.path.exists(index)):
            if os.path.exists(path):
                return safetensors_codec.load_file(path)
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            state: Dict[str, torch.Tensor] = {}
            for shard in shards:
                state.update(safetensors_codec.load_file(os.path.join(model_dir, shard)))
            return state
        if os.path.exists(path):
            return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weights file in {model_dir} (tried {names})")


def _state_of(weights) -> Dict[str, torch.Tensor]:
    """A module's state dict, or a name -> tensor map as given."""
    return weights.state_dict() if isinstance(weights, torch.nn.Module) else dict(weights)


def save_torch_weights(state, model_dir: str, name: str = WEIGHTS_SAFETENSORS) -> int:
    """Write `state` (name -> tensor or array) as `model_dir/name`; returns
    the bytes written.  A `.safetensors` name uses the codec (with
    diffusers' `{"format": "pt"}` metadata), another `torch.save`."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, name)
    if name.endswith(".safetensors"):
        return safetensors_codec.save_file(state, path, metadata={"format": "pt"})
    torch.save({k: v.detach().cpu().contiguous() for k, v in state.items()}, path)
    return os.path.getsize(path)


def _save_model(weights, cfg_dict: dict, model_dir: str) -> int:
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    return save_torch_weights(_state_of(weights), model_dir)


def save_unet(weights, cfg: UNetConfig, model_dir: str) -> int:
    """A diffusers-layout UNet directory that the reference, the JAX
    package and the port read; `weights` is the module or its state dict
    (name -> tensor).  Returns the weight file's bytes."""
    return _save_model(weights, cfg.to_diffusers_dict(), model_dir)


def save_vae(weights, cfg: VAEConfig, model_dir: str) -> int:
    return _save_model(weights, cfg.to_diffusers_dict(), model_dir)


def load_unet_state(model_dir: str) -> Dict[str, torch.Tensor]:
    """The weights of a diffusers UNet directory by the port's names, on
    the host, without building the module."""
    return normalize_diffusers_keys(
        _load_torch_weights(model_dir, (WEIGHTS_SAFETENSORS, WEIGHTS_BIN)))


def _load_module(cls, cfg, state, device, dtype):
    module = build_module(cls, cfg, device=device, dtype=dtype)
    module.load_state_dict(normalize_diffusers_keys(state), strict=True)
    return module


def load_unet(model_dir: str, device="cpu",
              dtype=torch.float32) -> Tuple[UNet2DConditionModel, UNetConfig]:
    cfg_d = load_json_config(os.path.join(model_dir, "config.json"))
    state = _load_torch_weights(model_dir, (WEIGHTS_SAFETENSORS, WEIGHTS_BIN))
    if "conv_in_ref.weight" in state:
        cfg_d = dict(cfg_d, ref_in_channels=state["conv_in_ref.weight"].shape[1])
    cfg = UNetConfig.from_diffusers_dict(cfg_d)
    return _load_module(UNet2DConditionModel, cfg, state, device, dtype), cfg


def load_vae(model_dir: str, device="cpu",
             dtype=torch.float32) -> Tuple[AutoencoderKL, VAEConfig]:
    cfg = VAEConfig.from_diffusers_dict(load_json_config(os.path.join(model_dir, "config.json")))
    state = _load_torch_weights(model_dir, (WEIGHTS_SAFETENSORS, WEIGHTS_BIN))
    return _load_module(AutoencoderKL, cfg, state, device, dtype), cfg


def load_text_encoder(model_dir: str, device="cpu",
                      dtype=torch.float32) -> Tuple[CLIPTextModel, CLIPTextConfig]:
    cfg = CLIPTextConfig.from_diffusers_dict(
        load_json_config(os.path.join(model_dir, "config.json")))
    state = _load_torch_weights(model_dir, (TEXT_SAFETENSORS, TEXT_BIN))
    return _load_module(CLIPTextModel, cfg, state, device, dtype), cfg


def make_ref_conv_surgery(state: Dict[str, torch.Tensor],
                          duplicate: int = 2) -> Dict[str, torch.Tensor]:
    """Fabricate `conv_in_ref` from `conv_in` on a vanilla SD UNet state
    dict (JAX `make_ref_conv_surgery`, `checkpoint.py:223-239`): the input
    channels repeated `duplicate` times and divided by `duplicate`, so the
    initial response to (rgb ‖ mask) is the original response to rgb.  JAX
    tiles the HWIO kernel's I axis, which is axis 1 of the OIHW weight."""
    w = state["conv_in.weight"]
    out = dict(state)
    out["conv_in_ref.weight"] = w.repeat(1, duplicate, 1, 1) / duplicate
    out["conv_in_ref.bias"] = state["conv_in.bias"]
    return out


def surgery_checkpoint(src_ckpt: str, dst_ckpt: str):
    """Clone a diffusers SD checkpoint, adding the 8-channel `conv_in_ref`
    (JAX `surgery_checkpoint`, `checkpoint.py:242-267`): every other
    subdirectory is copied as it is, the UNet is written in float32, as the
    JAX package writes it, with `ref_in_channels = 2 · in_channels`."""
    import dataclasses
    import shutil

    unet_dir = os.path.join(src_ckpt, "unet")
    cfg = UNetConfig.from_diffusers_dict(load_json_config(os.path.join(unet_dir, "config.json")))
    state = make_ref_conv_surgery({k: v.float() for k, v in load_unet_state(unet_dir).items()})
    os.makedirs(dst_ckpt, exist_ok=True)
    for sub in os.listdir(src_ckpt):
        s, d = os.path.join(src_ckpt, sub), os.path.join(dst_ckpt, sub)
        if sub == "unet" or not os.path.isdir(s):
            continue
        if not os.path.exists(d):
            shutil.copytree(s, d)
    cfg = dataclasses.replace(cfg, ref_in_channels=cfg.in_channels * 2)
    save_unet(state, cfg, os.path.join(dst_ckpt, "unet"))
    mi = os.path.join(src_ckpt, "model_index.json")
    if os.path.exists(mi):
        shutil.copy(mi, os.path.join(dst_ckpt, "model_index.json"))


class PipelineBundle:
    """The modules and configs the inference pipeline needs.  `text` may be
    None (the pipeline then uses a zero empty-prompt embedding)."""

    def __init__(self, unet, unet_cfg, vae, vae_cfg, text, text_cfg, scheduler_cfg):
        self.unet, self.unet_cfg = unet, unet_cfg
        self.vae, self.vae_cfg = vae, vae_cfg
        self.text, self.text_cfg = text, text_cfg
        self.scheduler_cfg = scheduler_cfg


def load_pipeline_bundle(checkpoint: str, unet_dir: Optional[str] = None,
                         scheduler_dir: Optional[str] = None, device="cpu",
                         dtype=torch.float32) -> PipelineBundle:
    """The reference eval loading flow (`main_oss.py:338-372`): the base
    checkpoint supplies VAE and text encoder, `unet_dir` overrides the
    UNet, `scheduler_dir` the scheduler config."""
    unet, unet_cfg = load_unet(unet_dir or os.path.join(checkpoint, "unet"), device, dtype)
    vae, vae_cfg = load_vae(os.path.join(checkpoint, "vae"), device, dtype)
    text, text_cfg = load_text_encoder(os.path.join(checkpoint, "text_encoder"), device, dtype)
    sched_dir = scheduler_dir or os.path.join(checkpoint, "scheduler")
    scheduler_cfg = SchedulerConfig.from_diffusers_dict(
        load_json_config(os.path.join(sched_dir, "scheduler_config.json")))
    return PipelineBundle(unet, unet_cfg, vae, vae_cfg, text, text_cfg, scheduler_cfg)


def random_pipeline_bundle(unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                           text_cfg: Optional[CLIPTextConfig],
                           scheduler_cfg: SchedulerConfig, *, seed: int = 0,
                           device="cpu") -> PipelineBundle:
    """A bundle with f32 weights drawn from `seed` (fan-in uniform init) on
    `device`; `text_cfg=None` leaves the text encoder out."""
    unet = build_module(UNet2DConditionModel, unet_cfg, seed=seed, device=device)
    vae = build_module(AutoencoderKL, vae_cfg, seed=seed + 1, device=device)
    text = (None if text_cfg is None else
            build_module(CLIPTextModel, text_cfg, seed=seed + 2, device=device))
    return PipelineBundle(unet, unet_cfg, vae, vae_cfg, text, text_cfg or CLIPTextConfig(),
                          scheduler_cfg)
