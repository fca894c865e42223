"""LoRA adapters: parameter-efficient fine-tuning of the DiffewS UNet.

Port of `diffews_tpu/training/lora.py`.  No reference equivalent: the
reference only fine-tunes the whole 866M-parameter UNet.  LoRA trains
rank-r factors with ΔW = (α/r)·B@A on the attention (optionally FFN)
projections instead: about 1.6M trainable parameters at rank 8, an
optimizer state a few hundred times smaller, and checkpoints that keep the
reference layout because the merged W + ΔW is what gets written.

Adapters are a sparse map from a module path (the prefix of a
`named_parameters()` name, e.g. `...attn1.to_q`) to `{"lora_a": (r, in),
"lora_b": (out, r)}` float32 tensors: torch's (out, in) layout of the
JAX package's (in, r) / (r, out) factors (`lora_from_jax` converts).  B
starts at zero, so step 0 is exactly the base model.  The train state
holds them flat (`flatten` / `unflatten`: `<path>.lora_a`, `<path>.lora_b`),
so the optimizer and EMA treat them as any parameters.

Inside the step the merge takes the JAX package's arithmetic
(`lora.py:89-109`): the compute-dtype base plus scale·(B@A) accumulated in
float32, cast back to the compute dtype.  The merged weights are bound to
the UNet for the forward and the backward pass (`state.bind_params`,
outside the remat regions), so the recompute reads them and the gradient
reaches only A and B.
"""

from __future__ import annotations

import math
import zlib
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from diffews_tpu_torch.pipeline import _true_div
from diffews_tpu_torch.training import state as state_lib

Adapters = Dict[str, Dict[str, torch.Tensor]]
_SITE = ".weight"


def attn_target(path: str) -> bool:
    """Default adaptation sites: every attention projection (self- and
    cross-attention q/k/v/out, the common SD LoRA target set)."""
    return (".attn1." in path or ".attn2." in path) and any(
        path.endswith(s) for s in (".to_q", ".to_k", ".to_v", ".to_out.0"))


def attn_ff_target(path: str) -> bool:
    """The wider set: attention projections + GEGLU feed-forward +
    transformer proj_in/out."""
    return attn_target(path) or ".ff." in path \
        or path.endswith(".proj_in") or path.endswith(".proj_out")


def target_filter(name: str) -> Callable[[str], bool]:
    return {"attn": attn_target, "attn+ff": attn_ff_target}[name]


def lora_sites(params: Dict[str, torch.Tensor],
               path_filter: Callable[[str], bool] = attn_target) -> Dict[str, torch.Size]:
    """path -> weight shape of every 2-D (linear) weight whose module path
    passes `path_filter`, in `params`' order."""
    return {n[:-len(_SITE)]: p.shape for n, p in params.items()
            if n.endswith(_SITE) and p.ndim == 2 and path_filter(n[:-len(_SITE)])}


def init_lora(seed: int, params: Dict[str, torch.Tensor], rank: int,
              path_filter: Callable[[str], bool] = attn_target, device=None) -> Adapters:
    """Adapters over `params` (name -> tensor): A ~ N(0, 1/sqrt(in)) from a
    generator keyed by `seed` and the crc32 of the path (stable across
    runs), B zeros.  Raises when no site matches."""
    out: Adapters = {}
    for path, (dout, din) in lora_sites(params, path_filter).items():
        key = ((int(seed) & 0xFFFFFFFF) << 32) | zlib.crc32(path.encode())
        gen = torch.Generator().manual_seed(key)
        a = _true_div(torch.randn((rank, din), generator=gen), math.sqrt(din))
        out[path] = {"lora_a": a.to(device), "lora_b": torch.zeros((dout, rank), device=device)}
    if not out:
        raise ValueError("no LoRA target sites matched the parameters")
    return out


def lora_from_jax(tree: dict) -> Adapters:
    """A JAX adapter tree (nested dicts of arrays, A (in, r), B (r, out))
    as the port's adapters (A (r, in), B (out, r)), float32 on the CPU."""
    out: Adapters = {}

    def rec(node, path):
        if "lora_a" in node:
            out[path] = {k: torch.from_numpy(np.array(np.asarray(node[k], np.float32).T))
                         for k in ("lora_a", "lora_b")}
            return
        for k, v in node.items():
            rec(v, f"{path}.{k}" if path else k)

    rec(tree, "")
    return out


def flatten(lora: Adapters) -> Dict[str, torch.Tensor]:
    return {f"{path}.{k}": t for path, ab in lora.items() for k, t in ab.items()}


def unflatten(flat: Dict[str, torch.Tensor]) -> Adapters:
    out: Adapters = {}
    for name, t in flat.items():
        path, _, k = name.rpartition(".")
        out.setdefault(path, {})[k] = t
    return out


def merge_lora(params: Dict[str, torch.Tensor], lora: Adapters,
               scale: float) -> Dict[str, torch.Tensor]:
    """`params` with weight + scale·(B@A) at every adapted site: the
    product and the sum in float32, the result in the weight's dtype.
    Differentiable with respect to the factors; the other entries are
    `params`' own tensors."""
    out = dict(params)
    for path, ab in lora.items():
        w = params[path + _SITE]
        delta = (ab["lora_b"].float() @ ab["lora_a"].float()) * scale
        out[path + _SITE] = (w.float() + delta).to(w.dtype)
    return out


def lora_scale(cfg: state_lib.TrainerConfig) -> float:
    alpha = cfg.lora_alpha if cfg.lora_alpha is not None else float(cfg.lora_rank)
    return alpha / cfg.lora_rank


def make_lora_grad_fn(cfg: state_lib.TrainerConfig, unet: nn.Module) -> state_lib.GradFn:
    """`grad_fn(adapters, base_c, vae, text_embed, micro, noise) -> (loss,
    grads)`: the episode loss of the compute-dtype base `base_c` (name ->
    tensor) merged with the flat `adapters`, and its float32 gradients
    with respect to the adapters."""
    episode_loss = state_lib.make_episode_loss(cfg, unet)
    scale = lora_scale(cfg)

    def grad_fn(adapters, base_c, vae, text_embed, micro, noise):
        names = list(adapters)
        merged = merge_lora(base_c, unflatten(adapters), scale)
        with state_lib.bind_params(unet, merged):
            loss = episode_loss(vae, text_embed, micro, noise)
            grads = torch.autograd.grad(loss, [adapters[n] for n in names], allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(adapters[n]) if g is None else g
                               for n, g in zip(names, grads)}

    return grad_fn


def make_lora_train_step(cfg: state_lib.TrainerConfig, unet: nn.Module, *, data_group=None):
    """Returns `step_fn(state, batch, rng, base_c, vae, text_embed) ->
    (state, metrics)`: `state.make_train_step`'s objective, optimizer and
    EMA over the flat adapters in `state.params`, with the frozen
    compute-dtype base `base_c` (name -> tensor) merged in at every
    micro-step, so the optimizer state is adapter-sized.  `data_group`: as
    in `state.make_train_step` (LoRA composes with data parallelism)."""
    return state_lib.step_from_grad_fn(cfg, make_lora_grad_fn(cfg, unet),
                                       data_group=data_group)
