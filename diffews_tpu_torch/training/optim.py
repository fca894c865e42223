"""The optimizer: clip_by_global_norm → AdamW → apply_if_finite, as optax.

Port of the optax chain of `training/state.py:101-121`, written out as
plain functions over dicts of tensors, with optax's order of operations
(optax 0.2: `clipping.clip_by_global_norm`, `transform.scale_by_adam`,
`add_decayed_weights`, `scale_by_learning_rate`,
`apply_if_finite`).  Per leaf, with g the gradient averaged over the
micro-batches:

  g  ← g                   if ‖g‖ < max_norm  else (g / ‖g‖)·max_norm
  mu ← (1−b1)·g + b1·mu     (mu stored in `mu_dtype`, bf16 by default)
  nu ← (1−b2)·g² + b2·nu    (f32)
  u  ← (mu / (1−b1^t)) / (sqrt(nu / (1−b2^t)) + eps) + wd·p
  p  ← p − lr(t−1)·u        (t: the count after this step)

`torch.optim.AdamW` is not used, for three reasons: it skips a parameter
whose gradient is None, while optax decays every leaf every step (the
attn-mask variant's unused `conv_in_ref` gets a zero gradient here and
still decays); it has no low-precision first moment; and it has no
`apply_if_finite`.  apply_if_finite: a step whose gradients are not all
finite changes nothing (params, moments and the inner count stay) unless
more than `max_nonfinite_steps` such steps came in a row;
`notfinite_count` counts the current run of them, `total_notfinite` all.

With a low-precision first moment the decay is optax's under jit: JAX's
weak typing casts the Python `b1` to the moment's dtype before it
multiplies the stored moment (bf16(0.9) = 0.8984375), and XLA keeps that
product and the sum in f32, rounding only the stored result.  So the port
computes `(1−b1)·g + b1_r·mu.float()` in f32 with `b1_r = b1` rounded to
`mu_dtype`; an f32 moment is `(1−b1)·g + b1·mu` as written.

Under FSDP (`layout`, a `parallel.mesh.FsdpLayout`) each rank updates its
shards: the global norm is the SUM `all_reduce` of the sharded leaves'
squares plus the replicated leaves' own (the same on every rank), and
apply_if_finite's finite bit is a MAX `all_reduce` of each rank's
non-finite flag, so every rank takes the same decision.

Everything stays on the device (no host read), so a window of steps runs
without synchronising.  `update` changes the parameters and the state in
place; a skipped step leaves them bit for bit as they were.  The adam and
the schedule counts of optax always move together in this chain, so one
`count` serves both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch
import torch.distributed as dist

from diffews_tpu_torch.training.lr import Schedule


@dataclasses.dataclass
class OptState:
    count: torch.Tensor            # int32: accepted steps
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    notfinite_count: torch.Tensor  # int32: current run of non-finite steps
    total_notfinite: torch.Tensor  # int32


class Optimizer(NamedTuple):
    init: object    # (params) -> OptState
    update: object  # (grads, state, params) -> pre-clip global norm


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in float32 (optax `global_norm`)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def make_optimizer(schedule: Schedule, *, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, weight_decay: float = 1e-2,
                   max_grad_norm: float = 1.0, mu_dtype: torch.dtype = torch.bfloat16,
                   max_nonfinite_steps: int = 10, layout=None) -> Optimizer:
    """optax.apply_if_finite(chain(clip_by_global_norm(max_grad_norm),
    adamw(schedule, b1, b2, eps, weight_decay=..., mu_dtype=...)),
    max_nonfinite_steps); `max_nonfinite_steps` 0 leaves out the
    apply_if_finite wrapper (every step applies), as in the JAX package."""
    low_mu = mu_dtype != torch.float32
    # optax's weak-typed b1 meets a bf16 moment as bf16(b1)
    b1_r = float(torch.tensor(b1, dtype=mu_dtype)) if low_mu else b1

    def init(params: Dict[str, torch.Tensor]) -> OptState:
        device = next(iter(params.values())).device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
        return OptState(
            count=zero(),
            mu={n: torch.zeros_like(p, dtype=mu_dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            notfinite_count=zero(), total_notfinite=zero())

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]) -> torch.Tensor:
        names = list(params)
        gs = [grads[n] for n in names]
        f32 = dict(dtype=torch.float32, device=gs[0].device)
        finite = torch.stack([torch.isfinite(g).all() for g in gs]).all()
        if layout is not None:
            bad = (~finite).to(torch.int32)
            dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=layout.group)
            finite = bad == 0
        if max_nonfinite_steps > 0:
            notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                    state.notfinite_count + 1)
            apply = finite | (notfinite > max_nonfinite_steps)
            state.notfinite_count = notfinite
            state.total_notfinite = state.total_notfinite + (~finite).to(torch.int32)
        else:
            apply = torch.ones((), dtype=torch.bool, device=gs[0].device)

        gnorm = global_norm(gs) if layout is None else _sharded_norm(names, gs, layout)
        keep = gnorm < max_grad_norm  # optax's trigger: NaN norms clip
        t = (state.count + 1).to(torch.float32)
        bc1 = 1.0 - torch.full((), b1, **f32) ** t
        bc2 = 1.0 - torch.full((), b2, **f32) ** t
        neg_lr = -schedule(state.count).to(**f32)
        for n, g in zip(names, gs):
            p = params[n]
            g = torch.where(keep, g, (g / gnorm) * max_grad_norm)
            if low_mu:
                mu = (1.0 - b1) * g + b1_r * state.mu[n].float()
            else:
                mu = (1.0 - b1) * g + b1 * state.mu[n]
            nu = (1.0 - b2) * (g * g) + b2 * state.nu[n]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + weight_decay * p
            p.copy_(torch.where(apply, p + neg_lr * u, p))
            state.mu[n].copy_(torch.where(apply, mu.to(mu_dtype), state.mu[n]))
            state.nu[n].copy_(torch.where(apply, nu, state.nu[n]))
        state.count = state.count + apply.to(torch.int32)
        return gnorm

    return Optimizer(init, update)


def _sharded_norm(names, gs, layout) -> torch.Tensor:
    """The global norm of gradients of which `layout` shards some leaves."""
    sq = lambda ts: (torch.stack([t.float().square().sum() for t in ts]).sum()  # noqa: E731
                     if ts else torch.zeros((), dtype=torch.float32, device=gs[0].device))
    sharded = sq([g for n, g in zip(names, gs) if layout.sharded(n)])
    dist.all_reduce(sharded, op=dist.ReduceOp.SUM, group=layout.group)
    return (sharded + sq([g for n, g in zip(names, gs) if not layout.sharded(n)])).sqrt()
