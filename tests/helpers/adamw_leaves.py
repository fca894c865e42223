"""Optimizer leaves for the multi-tensor AdamW kernels' checks on the card
(`tests/test_torch_adamw_gpu.py`, `tests/helpers/adamw_ranks.py`,
`chip_smoke.py` phase adamw).  Imports no JAX.

  - `sd21_shapes()`: the SD-2.1 UNet's 688 leaves, name -> shape, from the
    model built on the meta device (nothing allocated);
  - `RAGGED`: ragged leaf shapes around the kernels' 4-element accesses and
    65536-element chunks;
  - `draw(shapes, device, seed, ...)`: (params, grads, opt state) as the
    train step holds them: float32 masters, 4-D ones channels-last on the
    card; float32 gradients in the masters' layout; moments drawn as after
    a few steps (count 3), the first in `mu_dtype`;
  - `clone_state(state)`: a copy of an `OptState`, its dicts' tensors
    cloned with their layout.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

RAGGED = {"one": (1,), "three": (3,), "chunk_plus_one": (65537,), "five_by_seven": (5, 7),
          "conv": (4, 3, 3, 3), "two_chunks": (131072,), "conv_1x1": (6, 10, 1, 1),
          "two_chunks_plus_five": (131077,)}


def sd21_shapes() -> Dict[str, Tuple[int, ...]]:
    from diffews_tpu_torch.configs import UNetConfig
    from diffews_tpu_torch.models.unet import UNet2DConditionModel

    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sd21())
    return {n: tuple(p.shape) for n, p in unet.named_parameters()}


def draw(shapes: Dict[str, Tuple[int, ...]], device, seed: int, *,
         mu_dtype: torch.dtype = torch.bfloat16, g_scale: float = 1e-3):
    """(params, grads, opt state) with every tensor drawn from `seed` on
    `device`."""
    from diffews_tpu_torch.training.optim import OptState

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format

    def normal(shape, scale):
        t = torch.randn(shape, generator=gen, device=device) * scale
        return t.contiguous(memory_format=fmt) if len(shape) == 4 else t

    params = {n: normal(s, 0.05) for n, s in shapes.items()}
    grads = {n: normal(s, g_scale) for n, s in shapes.items()}
    mu = {n: normal(s, g_scale).to(mu_dtype) for n, s in shapes.items()}
    nu = {n: normal(s, g_scale).square() for n, s in shapes.items()}
    count = lambda v: torch.full((), v, dtype=torch.int32, device=device)  # noqa: E731
    return params, grads, OptState(count(3), mu, nu, count(0), count(0))


def clone_state(state):
    from diffews_tpu_torch.training.optim import OptState

    keep = lambda d: {n: t.clone() for n, t in d.items()}  # noqa: E731
    return OptState(state.count.clone(), keep(state.mu), keep(state.nu),
                    state.notfinite_count.clone(), state.total_notfinite.clone())
