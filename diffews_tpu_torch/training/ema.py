"""Exponential moving average of parameters (port of `training/ema.py`).

Counterpart of the diffusers `EMAModel` the reference optionally maintains
(`train_tools/train_icl_*_v3.py:1108-1112,1400-1401`): decay warms up as
min(max_decay, (1 + step) / (10 + step)).  The EMA tree is a copy of the
parameters (never an alias of the live buffers) and `update` changes it in
place; the step counter and decay stay on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class EMAState:
    params: Dict[str, torch.Tensor]
    step: torch.Tensor  # int32 scalar


def init(params: Dict[str, torch.Tensor]) -> EMAState:
    ema = {n: p.detach().clone() for n, p in params.items()}
    device = next(iter(ema.values())).device
    return EMAState(params=ema, step=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def update(state: EMAState, new_params: Dict[str, torch.Tensor],
           max_decay: float = 0.9999) -> EMAState:
    """e ← e·decay + p·(1 − decay), in place; returns `state`."""
    step = state.step + 1
    decay = torch.clamp((1.0 + step) / (10.0 + step), max=max_decay)
    keep = 1.0 - decay
    for name, e in state.params.items():
        e.mul_(decay).add_(new_params[name].to(e.dtype) * keep)
    state.step = step
    return state
