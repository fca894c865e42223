"""Tensor-parallel (Megatron) operators and the head-aligned split.

The JAX package shards attention and feed-forward weights over a "model"
mesh axis (`diffews_tpu/parallel/mesh.py:_TP_RULES`) and lets XLA insert
the collectives.  In PyTorch one process drives one device, so the port
writes them itself, around each transformer block's matmuls:

  - column-parallel `to_q` / `to_k` / `to_v` and `ff.net.0.proj`: the input
    enters through `copy_to_model` (identity forward, SUM `all_reduce` of
    the input gradient backward) and each rank multiplies by its rows of
    the weight;
  - row-parallel `to_out.0` and `ff.net.2`: each rank multiplies its slice
    of the activation by its columns of the weight, `reduce_from_model`
    sums the partial products (SUM `all_reduce` forward, identity
    backward), and the bias is added once, after the sum;
  - a replicated bias of a column-parallel linear is sliced to the rank's
    rows by `scatter_to_model`, whose backward writes the slice's gradient
    into a zero-filled whole and sums it over the group, so every rank
    holds the whole bias gradient.

Every collective is an `all_reduce` (a gather is an `all_reduce` of a
zero-filled buffer with the rank's slice written in): gloo carries CUDA
tensors through `all_reduce` and `broadcast` only, and two ranks on one
card can only run over gloo.  One path serves both backends.

Heads are never split: a rank holds whole heads (`part`, with unit = the
head width), so attention stays local.  Where the heads do not divide the
model axis the shards are uneven (5 heads over 2 ranks: 3 + 2; 2 over 4:
1, 1, 0, 0), which JAX's even column split (2.5 heads a rank, resharded by
GSPMD) computes as the same function.  The GEGLU projection's rows are
two halves (`h`, then `gate`): a rank holds its block of each, so that
`chunk(2)` of its product gives its own `h` and `gate` and the GEGLU is
local.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

Ranges = Sequence[Tuple[int, int]]


def part(total: int, n: int, rank: int, unit: int = 1) -> Tuple[int, int]:
    """[start, stop) of `rank`'s part when `total` (a multiple of `unit`)
    splits over `n` ranks in whole units, the first `units % n` ranks one
    unit more."""
    if total % unit:
        raise ValueError(f"{total} is not a multiple of the unit {unit}")
    base, extra = divmod(total // unit, n)
    start = (rank * base + min(rank, extra)) * unit
    return start, start + (base + (rank < extra)) * unit


def halves(total: int, n: int, rank: int, unit: int = 1) -> List[Tuple[int, int]]:
    """The rank's `part` of each half of a dim of `2·total` (the GEGLU
    projection's `h` rows, then its `gate` rows)."""
    a, b = part(total, n, rank, unit)
    return [(a, b), (total + a, total + b)]


def take(x: torch.Tensor, dim: int, ranges: Ranges) -> torch.Tensor:
    """The `ranges` of `x` along `dim`, concatenated."""
    pieces = [x.narrow(dim, a, b - a) for a, b in ranges]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


def place(part_: torch.Tensor, dim: int, ranges: Ranges, size: int) -> torch.Tensor:
    """A zero-filled tensor of `size` along `dim` with `part_` written at
    `ranges` (the inverse of `take`)."""
    shape = list(part_.shape)
    shape[dim] = size
    full = part_.new_zeros(shape)
    at = 0
    for a, b in ranges:
        full.narrow(dim, a, b - a).copy_(part_.narrow(dim, at, b - a))
        at += b - a
    return full


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """SUM `all_reduce` of a contiguous copy; the group of one is a no-op."""
    if dist.get_world_size(group) == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather(part_: torch.Tensor, dim: int, ranges: Ranges, size: int, group) -> torch.Tensor:
    """The whole tensor from every rank's `ranges` along `dim` (ranks'
    ranges tile `size`): an `all_reduce` of the zero-filled placement."""
    return all_reduce_sum(place(part_, dim, ranges, size), group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group) if dist.get_world_size(group) > 1 else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ranges, group):
        ctx.dim, ctx.ranges, ctx.size, ctx.group = dim, ranges, x.shape[dim], group
        return take(x, dim, ranges).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.dim, ctx.ranges, ctx.size, ctx.group), None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel linear: identity; its gradient is
    summed over the model group."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The partial products of a row-parallel linear summed over the group;
    the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, group)


def scatter_to_model(x: torch.Tensor, dim: int, ranges: Ranges, group) -> torch.Tensor:
    """This rank's `ranges` of a replicated `x`; the backward gathers the
    ranks' slices of the gradient, so each holds the whole one."""
    return _ScatterToModel.apply(x, dim, tuple(ranges), group)

