"""LR schedules (diffusers `get_scheduler` semantics), port of `training/lr.py`.

The canonical DiffewS config uses `polynomial` with zero warmup over
20000 * num_processes steps (`train_tools/train_icl_*_v3.py:1217-1223`):
linear decay from lr_init to lr_end = 1e-7 (power 1.0).

A schedule maps a step (an int or an integer tensor, on any device) to a
0-d float32 tensor on that step's device, computed in float32 as the JAX
package computes it; the optimizer evaluates it on its device step
counter, so a window of steps needs no host read.  `cosine` is the port's
own copy of optax's `warmup_cosine_decay_schedule` formula (linear warmup
from 0, or none, then cosine decay to 0 over the remaining steps).
Divisions are true divisions by device tensors: CUDA turns a Python-scalar
divisor into a reciprocal multiply.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[object], torch.Tensor]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _div(x: torch.Tensor, c) -> torch.Tensor:
    return x / torch.full((), float(c), dtype=torch.float32, device=x.device)


def polynomial_with_warmup(lr_init: float, num_training_steps: int,
                           num_warmup_steps: int = 0, lr_end: float = 1e-7,
                           power: float = 1.0) -> Schedule:
    def schedule(step):
        step = _step(step)
        warm = (_div(step, max(num_warmup_steps, 1)) if num_warmup_steps > 0
                else torch.ones_like(step))
        decay_steps = max(num_training_steps - num_warmup_steps, 1)
        pct = (1.0 - _div(step - num_warmup_steps, decay_steps)).clamp(0.0, 1.0)
        decayed = (lr_init - lr_end) * pct ** power + lr_end
        return torch.where(step < num_warmup_steps, lr_init * warm, decayed)

    return schedule


def constant(lr_init: float) -> Schedule:
    return lambda step: torch.full_like(_step(step), lr_init)


def cosine(lr_init: float, num_training_steps: int,
           num_warmup_steps: int = 0) -> Schedule:
    """optax `warmup_cosine_decay_schedule(0 if warmup else lr, lr, warmup,
    total)` with end value 0 and exponent 1."""
    decay_steps = num_training_steps - num_warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"cosine schedule needs decay steps > 0, got {decay_steps}")

    def schedule(step):
        step = _step(step)
        if num_warmup_steps > 0:  # linear 0 -> lr over the warmup
            frac = 1.0 - _div(step.clamp(0, num_warmup_steps), num_warmup_steps)
            warm = (0.0 - lr_init) * frac + lr_init
        else:
            warm = torch.full_like(step, lr_init)
        count = torch.minimum(step - num_warmup_steps,
                              torch.full_like(step, float(decay_steps)))
        decayed = 0.5 * (1.0 + torch.cos(_div(math.pi * count, decay_steps)))
        return torch.where(step < num_warmup_steps, warm, lr_init * decayed)

    return schedule


def get_schedule(name: str, lr_init: float, num_training_steps: int,
                 num_warmup_steps: int = 0, power: float = 1.0) -> Schedule:
    if name == "polynomial":
        return polynomial_with_warmup(lr_init, num_training_steps, num_warmup_steps,
                                      power=power)
    if name == "constant":
        return constant(lr_init)
    if name == "cosine":
        return cosine(lr_init, num_training_steps, num_warmup_steps)
    if name == "linear":
        return polynomial_with_warmup(lr_init, num_training_steps, num_warmup_steps,
                                      lr_end=0.0)
    raise ValueError(f"unknown lr schedule {name!r}")
