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

Under FSDP or tensor parallelism (`layout`, a `parallel.mesh.ShardLayout`)
each rank updates its parts: the global norm sums each leaf's squares over
the axes it is split over (SUM `all_reduce`s over "data", then "model"),
and counts a replicated leaf once (its gradient is the same on every
rank); apply_if_finite's finite bit is a MAX `all_reduce` of each rank's
non-finite flag over both axes, so every rank takes the same decision.

On CUDA tensors `update` runs this arithmetic as three kernel launches
over every leaf (`ops/adamw.py`): the norm and the finite bit, then every
element's update, bit for bit the plain loop's given the same norm.  The
scalar prologue (apply_if_finite's decision and counters, the clip
trigger, the bias corrections, the learning rate) is 0-d torch ops shared
by both paths.  CPU tensors take the plain version, the per-leaf torch
loop (`Optimizer.plain`).

Everything stays on the device (no host read), so a window of steps runs
without synchronising.  `update` changes the parameters and the state in
place; a skipped step leaves them bit for bit as they were.  The adam and
the schedule counts of optax always move together in this chain, so one
`count` serves both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple

import torch
import torch.distributed as dist

from diffews_tpu_torch.ops import adamw
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
    plain: object   # update's plain version, on any device (the card's tests use it)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in float32 (optax `global_norm`)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def leaf_groups(names, layout) -> List[int]:
    """Each leaf's group of the global norm: 0 replicated, 1 split over
    "data", 2 over "model", 3 over both; all 0 without a layout."""
    if layout is None:
        return [0] * len(names)
    return [int(layout.sharded(n)) + 2 * int(layout.model_sharded(n)) for n in names]


def make_optimizer(schedule: Schedule, *, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, weight_decay: float = 1e-2,
                   max_grad_norm: float = 1.0, mu_dtype: torch.dtype = torch.bfloat16,
                   max_nonfinite_steps: int = 10, layout=None) -> Optimizer:
    """optax.apply_if_finite(chain(clip_by_global_norm(max_grad_norm),
    adamw(schedule, b1, b2, eps, weight_decay=..., mu_dtype=...)),
    max_nonfinite_steps); `max_nonfinite_steps` 0 leaves out the
    apply_if_finite wrapper (every step applies), as in the JAX package.
    `update` runs the plain version on CPU tensors and the kernels of
    `ops/adamw.py` on CUDA tensors."""
    low_mu = mu_dtype != torch.float32
    # optax's weak-typed b1 meets a bf16 moment as bf16(b1)
    b1_r = float(torch.tensor(b1, dtype=mu_dtype)) if low_mu else b1
    kernels = adamw.MultiTensor((max_grad_norm, 1.0 - b1, b1_r, 1.0 - b2, b2, eps,
                                 weight_decay))

    def init(params: Dict[str, torch.Tensor]) -> OptState:
        device = next(iter(params.values())).device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
        return OptState(
            count=zero(),
            mu={n: torch.zeros_like(p, dtype=mu_dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            notfinite_count=zero(), total_notfinite=zero())

    def apply_if_finite(state: OptState, finite: torch.Tensor) -> torch.Tensor:
        """Whether the step applies: the finite bit agreed over the layout's
        groups, and apply_if_finite's counters moved."""
        if layout is not None:
            bad = (~finite).to(torch.int32)
            for group in _groups(layout):
                dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
            finite = bad == 0
        if max_nonfinite_steps > 0:
            notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                    state.notfinite_count + 1)
            apply = finite | (notfinite > max_nonfinite_steps)
            state.notfinite_count = notfinite
            state.total_notfinite = state.total_notfinite + (~finite).to(torch.int32)
            return apply
        return torch.ones((), dtype=torch.bool, device=finite.device)

    def step_scalars(state: OptState, gnorm: torch.Tensor):
        """The clip trigger and AdamW's scalars: (keep, bc1, bc2, −lr)."""
        f32 = dict(dtype=torch.float32, device=gnorm.device)
        keep = gnorm < max_grad_norm  # optax's trigger: NaN norms clip
        t = (state.count + 1).to(torch.float32)
        bc1 = 1.0 - torch.full((), b1, **f32) ** t
        bc2 = 1.0 - torch.full((), b2, **f32) ** t
        neg_lr = -schedule(state.count).to(**f32)
        return keep, bc1, bc2, neg_lr

    @torch.no_grad()
    def plain(grads: Dict[str, torch.Tensor], state: OptState,
              params: Dict[str, torch.Tensor]) -> torch.Tensor:
        names = list(params)
        gs = [grads[n] for n in names]
        apply = apply_if_finite(state, torch.stack([torch.isfinite(g).all() for g in gs]).all())
        gnorm = global_norm(gs) if layout is None else _sharded_norm(names, gs, layout)
        keep, bc1, bc2, neg_lr = step_scalars(state, gnorm)
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

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]) -> torch.Tensor:
        names = list(params)
        if params[names[0]].device.type == "cpu":
            return plain(grads, state, params)
        step = kernels.norm([grads[n] for n in names], [params[n] for n in names],
                            [state.mu[n] for n in names], [state.nu[n] for n in names],
                            leaf_groups(names, layout))
        apply = apply_if_finite(state, step.finite)
        gnorm = step.norm if layout is None else reduce_groups(step.group_sums, layout)
        keep, bc1, bc2, neg_lr = step_scalars(state, gnorm)
        step.apply(gnorm, keep, apply, bc1, bc2, neg_lr)
        state.count = state.count + apply.to(torch.int32)
        return gnorm

    return Optimizer(init, update, plain)


def _spans(group) -> bool:
    """`group` holds more than one rank (a collective over it does work)."""
    return group is not None and dist.get_world_size(group) > 1


def _groups(layout):
    """The layout's process groups of more than one rank."""
    return [g for g in (layout.data_group, layout.model_group) if _spans(g)]


def _sharded_norm(names, gs, layout) -> torch.Tensor:
    """The global norm of gradients of which `layout` splits some leaves:
    each group's squares (`leaf_groups`) summed, then `reduce_groups`."""
    sq = [[], [], [], []]  # replicated, "data", "model", both
    for group, g in zip(leaf_groups(names, layout), gs):
        sq[group].append(g.float().square().sum())
    zero = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    return reduce_groups(torch.stack([torch.stack(x).sum() if x else zero for x in sq]), layout)


def reduce_groups(parts: torch.Tensor, layout) -> torch.Tensor:
    """The global norm from this rank's four group sums of squares `parts`
    (replicated, "data", "model", both): those split over "data" (and over
    both axes) summed over "data", then those split over "model" (and
    both) over "model"; a replicated leaf counts once."""
    if _spans(layout.data_group):
        over_data = parts[1::2].clone()  # data, both
        dist.all_reduce(over_data, op=dist.ReduceOp.SUM, group=layout.data_group)
        parts = torch.stack([parts[0], over_data[0], parts[2], over_data[1]])
    if _spans(layout.model_group):
        over_model = parts[2:].clone()  # model, both
        dist.all_reduce(over_model, op=dist.ReduceOp.SUM, group=layout.model_group)
        parts = torch.cat([parts[:2], over_model])
    return parts.sum().sqrt()
