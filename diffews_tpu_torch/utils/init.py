"""Parameter initializers (torch-default-compatible fan-in uniform).

Counterpart of `diffews_tpu/utils/init.py`: conv and linear weights and
biases are drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), norm scales are
one and shifts zero, embeddings N(0, 0.02).  Every draw comes from one
`torch.Generator`, in module-registration order, so a seed fixes every
weight.  Real DiffewS runs start from pretrained SD-2.1 weights; these
inits serve tests and the full-width random-weight runs on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from diffews_tpu_torch.models.layers import Conv2d, GroupNorm, LayerNorm


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    t.copy_(torch.rand(t.shape, generator=gen, device=t.device,
                       dtype=torch.float32).mul_(2 * bound).sub_(bound))


@torch.no_grad()
def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of `module` in place from `generator`.

    The generator must live on the parameters' device (a CUDA generator
    for weights on the card)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[1] * (w[0, 0].numel() if w.ndim == 4 else 1)
            bound = 1.0 / math.sqrt(fan_in)
            _uniform_(w, bound, generator)
            if m.bias is not None:
                _uniform_(m.bias, bound, generator)
        elif isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                       device=m.weight.device) * 0.02)
    return module


def build_module(cls, cfg, *, seed: Optional[int] = None,
                 device="cpu", dtype=torch.float32) -> nn.Module:
    """Construct `cls(cfg)` without a host-side default init, place it on
    `device`, and (with `seed`) draw its weights from a generator there.

    Without a seed the parameters are left uninitialised (a checkpoint
    load follows)."""
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to_empty(device=device)
    if seed is not None:
        gen = torch.Generator(device=device).manual_seed(seed)
        init_module_(module, gen)
    return module.to(dtype)
