"""Multi-tensor clip → AdamW → apply_if_finite: the train step's optimizer
on the card, three CUDA kernel launches over every leaf
(`ops/csrc/adamw.cu`) in place of the plain version's ~25 torch ops a leaf.

`training/optim.py`'s update takes this path for CUDA tensors and its
plain version (the per-leaf torch loop, in that module) for CPU tensors.
A step:

  1. `norm_pass`: per chunk of every leaf, the f32 Σg² and a non-finite
     flag;
  2. `finalise_pass`: the partials summed in a fixed order into the norm's
     groups (`training/optim.py::leaf_groups`), the unsharded norm and the
     finite bit, all on the device;
  3. the optimizer's scalar prologue in torch on 0-d device tensors (and,
     under a sharded layout, its all_reduces);
  4. `apply_pass`: every element's update, written only where the step
     applies.

Nothing is read on the host.  Steps 1-2 are the torch op
`diffews_tpu_torch::adamw_norm` and step 4 `diffews_tpu_torch::adamw_apply`
(whose schema names the masters and moments it writes in place), so the
profiler links each kernel to the op that launched it, as it does the
forward kernels'.  `Plan` holds, for one set of (p, mu, nu) leaves, the
device leaf table (pointers and sizes) and chunk table (`chunk_table`);
`MultiTensor` builds it once and keeps it while the leaves' data pointers
stay the same.  The gradients' pointers change every step: one
host-to-device copy a step from pinned memory.  A gradient not laid out as
its master (other strides on a dim of size > 1) is first copied into the
master's layout and counted (`match_layouts.layout_copies`); p, mu and nu
share a layout by construction (`zeros_like`), and the plan checks it.

Launch counters: `norm_pass.launches`, `finalise_pass.launches`,
`apply_pass.launches` (`utils/profiling.launch_counts()`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

CHUNK = 1 << 16  # elements a block; a multiple of 4 keeps chunks 16-byte aligned
_MU_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ptr = torch.Tensor.data_ptr


def chunk_table(numels: Sequence[int], groups: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """(n_chunks, 4) int32 rows (leaf, index, group, 0): leaf i of numels[i]
    elements is cut into ceil(numel / chunk) chunks, chunk k holding its
    elements [k·chunk, min((k + 1)·chunk, numel)); an empty leaf has none.
    `groups[i]` is leaf i's group of the global norm."""
    numels = np.asarray(numels, dtype=np.int64).reshape(-1)
    per = -(-numels // chunk)
    leaf = np.repeat(np.arange(len(numels)), per)
    first = np.repeat(np.cumsum(per) - per, per)
    index = np.arange(len(leaf)) - first
    group = np.asarray(groups, dtype=np.int64).reshape(-1)[leaf]
    return np.stack([leaf, index, group, np.zeros_like(leaf)], axis=1).astype(np.int32)


def _dense(t: torch.Tensor) -> bool:
    """`t`'s elements fill numel consecutive slots, in any order of dims."""
    expect = 1
    for stride, size in sorted((st, sz) for sz, st in zip(t.shape, t.stride()) if sz > 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _same_layout(t: torch.Tensor, shape, stride) -> bool:
    """`t` has `shape` and the same strides on every dim of size > 1."""
    return tuple(t.shape) == shape and all(
        a == b for a, b, n in zip(t.stride(), stride, shape) if n > 1)


class Plan:
    """The device tables of one set of leaves: `leaves`, (n_leaves, 4) int64
    rows (p, mu, nu, numel); `chunks`, `chunk_table`'s rows.  `key` is the
    leaves' data pointers."""

    def __init__(self, key, ps: List[torch.Tensor], mus: List[torch.Tensor],
                 nus: List[torch.Tensor], groups: Sequence[int]):
        self.key, self.device = key, ps[0].device
        if self.device.type != "cuda":
            raise ValueError(f"the optimizer kernels run on CUDA tensors; got {self.device}")
        if mus[0].dtype not in _MU_CODE:
            raise TypeError(f"the optimizer kernels take a float32 or bfloat16 first moment; "
                            f"got {mus[0].dtype}")
        for p, mu, nu in zip(ps, mus, nus):
            if p.dtype != torch.float32 or nu.dtype != torch.float32 or mu.dtype != mus[0].dtype:
                raise TypeError(f"the optimizer kernels take float32 masters and second "
                                f"moments and one first-moment dtype; got {p.dtype}, "
                                f"{nu.dtype}, {mu.dtype}")
            if any(t.device != self.device for t in (p, mu, nu)):
                raise ValueError(f"every leaf must be on {self.device}")
            if not _dense(p) or not all(_same_layout(t, tuple(p.shape), p.stride())
                                        for t in (mu, nu)):
                raise ValueError(f"a master and its moments must be dense and share a "
                                 f"layout; got {tuple(p.shape)} strides {p.stride()}, "
                                 f"{mu.stride()}, {nu.stride()}")
        self.layouts = [(tuple(p.shape), p.stride()) for p in ps]
        rows = np.array([[_ptr(p), _ptr(mu), _ptr(nu), p.numel()]
                         for p, mu, nu in zip(ps, mus, nus)], dtype=np.int64)
        self.leaves = torch.from_numpy(rows).to(self.device)
        self.chunks = torch.from_numpy(chunk_table([p.numel() for p in ps], groups)).to(
            self.device)

    def upload(self, gs: List[torch.Tensor]) -> torch.Tensor:
        """The gradients' pointers on the device: one copy from pinned
        memory, in stream order behind the work that made them (torch's
        caching host allocator keeps the buffer until the copy has run)."""
        host = torch.empty(len(gs), dtype=torch.int64, pin_memory=True)
        host.numpy()[:] = [_ptr(g) for g in gs]
        return host.to(self.device, non_blocking=True)


def match_layouts(gs: List[torch.Tensor], plan: Plan) -> List[torch.Tensor]:
    """`gs`, each laid out as its master: a float32 gradient with other
    strides on a dim of size > 1 is copied into the master's layout (and
    counted in `match_layouts.layout_copies`); another dtype, shape or
    device raises."""
    out = list(gs)
    for i, (g, (shape, stride)) in enumerate(zip(gs, plan.layouts)):
        if (g.dtype == torch.float32 and g.stride() == stride and g.shape == shape
                and g.device == plan.device):
            continue
        if g.dtype != torch.float32:
            raise TypeError(f"the optimizer kernels take float32 gradients; got {g.dtype}")
        if g.device != plan.device or tuple(g.shape) != shape:
            raise ValueError(f"gradient {i}: {tuple(g.shape)} on {g.device}, its master "
                             f"{shape} on {plan.device}")
        if not _same_layout(g, shape, stride):
            out[i] = torch.empty_strided(shape, stride, dtype=torch.float32,
                                         device=plan.device).copy_(g)
            match_layouts.layout_copies += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from diffews_tpu_torch.ops import _build

    lib = _build.load("adamw")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adamw_norm.argtypes = [ptr] * 3 + [i32] * 2 + [ptr] * 3
    lib.adamw_finalise.argtypes = [ptr] * 3 + [i32] + [ptr] * 3
    lib.adamw_apply.argtypes = [ptr] * 3 + [i32] * 3 + [ptr] * 6 + [f32] * 7 + [ptr]
    for fn in (lib.adamw_norm, lib.adamw_finalise, lib.adamw_apply):
        fn.restype = ctypes.c_int
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def norm_pass(leaves: torch.Tensor, chunks: torch.Tensor, grads: torch.Tensor,
              partial: torch.Tensor, flags: torch.Tensor) -> None:
    """Per chunk: `partial` (f32) Σg², `flags` (int32) 1 where a value is
    not finite.  `leaves`, `chunks`: a `Plan`'s tables; `grads`: the device
    table of the gradients' pointers."""
    n, dev = chunks.shape[0], chunks.device
    with torch.cuda.device(dev):
        _check(_lib().adamw_norm(_ptr(leaves), _ptr(chunks), _ptr(grads), n, CHUNK,
                                 _ptr(partial), _ptr(flags), _stream(dev)), "adamw_norm")
    norm_pass.launches += n > 0


def finalise_pass(chunks: torch.Tensor, partial: torch.Tensor, flags: torch.Tensor,
                  sums: torch.Tensor, finite: torch.Tensor) -> None:
    """`sums` (5 f32): each group's Σg², then the square root of their
    total; `finite` (0-d bool): no chunk flagged."""
    dev = chunks.device
    with torch.cuda.device(dev):
        _check(_lib().adamw_finalise(_ptr(chunks), _ptr(partial), _ptr(flags), chunks.shape[0],
                                     _ptr(sums), _ptr(finite), _stream(dev)), "adamw_finalise")
    finalise_pass.launches += 1


def apply_pass(leaves: torch.Tensor, chunks: torch.Tensor, grads: torch.Tensor,
               mu_dtype: torch.dtype, hyper: Sequence[float], gnorm, keep, apply, bc1, bc2,
               neg_lr) -> None:
    """The update of every element in place where `apply` (0-d bool) is
    true; `hyper`: (max_grad_norm, 1 − b1, b1 as the moment's dtype
    rounds it, 1 − b2, b2, eps, weight decay)."""
    n, dev = chunks.shape[0], chunks.device
    for t, dtype in ((gnorm, torch.float32), (keep, torch.bool), (apply, torch.bool),
                     (bc1, torch.float32), (bc2, torch.float32), (neg_lr, torch.float32)):
        if t.dtype != dtype or t.numel() != 1 or t.device != dev:
            raise ValueError(f"the step's scalars must be one-element {dtype} tensors on "
                             f"{dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    with torch.cuda.device(dev):
        _check(_lib().adamw_apply(_ptr(leaves), _ptr(chunks), _ptr(grads), n, CHUNK,
                                  _MU_CODE[mu_dtype], _ptr(gnorm), _ptr(keep), _ptr(apply),
                                  _ptr(bc1), _ptr(bc2), _ptr(neg_lr), *hyper, _stream(dev)),
               "adamw_apply")
    apply_pass.launches += n > 0


norm_pass.launches = 0
finalise_pass.launches = 0
apply_pass.launches = 0
match_layouts.layout_copies = 0


# The two ops, defined on the dispatcher with a CUDA kernel alone: a
# `torch.library.custom_op` would add its Python autograd and
# ADInplaceOrView layers, each of which turns the 2752 tensors of the
# lists into Python objects again (beside an H100, 8.8 ms of host time an
# update against 3.5 with the launches called directly).  `adamw_apply`'s schema marks
# p, mu and nu as written; its kernel bumps their version counters, as
# torch's own in-place ops do.
_LIB = torch.library.Library("diffews_tpu_torch", "FRAGMENT")
_LIB.define("adamw_norm(Tensor[] gs, Tensor leaves, Tensor chunks, Tensor grads) "
            "-> (Tensor, Tensor)")
_LIB.define("adamw_apply(Tensor(a!)[] ps, Tensor(b!)[] mus, Tensor(c!)[] nus, Tensor[] gs, "
            "Tensor leaves, Tensor chunks, Tensor grads, Tensor gnorm, Tensor keep, "
            "Tensor apply, Tensor bc1, Tensor bc2, Tensor neg_lr, float[] hyper) -> ()")


def _norm_cuda(gs: List[torch.Tensor], leaves: torch.Tensor, chunks: torch.Tensor,
               grads: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`adamw_norm`: the norm pass and its finalise over gradients `gs`;
    (sums, finite) as `finalise_pass` writes them.  `leaves`, `chunks`: a
    `Plan`'s tables; `grads`: `gs`' pointers on the device."""
    dev = chunks.device
    partial = torch.empty(chunks.shape[0], dtype=torch.float32, device=dev)
    flags = torch.empty(chunks.shape[0], dtype=torch.int32, device=dev)
    sums = torch.empty(5, dtype=torch.float32, device=dev)
    finite = torch.empty((), dtype=torch.bool, device=dev)
    norm_pass(leaves, chunks, grads, partial, flags)
    finalise_pass(chunks, partial, flags, sums, finite)
    return sums, finite


def _apply_cuda(ps, mus, nus, gs, leaves, chunks, grads, gnorm, keep, apply, bc1, bc2,
                neg_lr, hyper) -> None:
    """`adamw_apply`: masters `ps` and moments `mus`, `nus` updated in
    place from gradients `gs` (the leaves `leaves`, `chunks` and `grads`
    point at) where `apply` is true; the scalars and `hyper` as
    `apply_pass` takes them."""
    apply_pass(leaves, chunks, grads, mus[0].dtype, hyper, gnorm, keep, apply, bc1, bc2, neg_lr)
    torch.autograd.graph.increment_version(ps + mus + nus)


_LIB.impl("adamw_norm", _norm_cuda, "CUDA")
_LIB.impl("adamw_apply", _apply_cuda, "CUDA")
adamw_norm = torch.ops.diffews_tpu_torch.adamw_norm
adamw_apply = torch.ops.diffews_tpu_torch.adamw_apply


class Step:
    """One step's norm pass: `finite` (0-d bool), `group_sums` (4 f32: the
    groups' Σg²) and `norm` (0-d f32: the unsharded global norm), on the
    device; `apply(...)` then runs the update."""

    def __init__(self, plan: Plan, gs: List[torch.Tensor], ps: List[torch.Tensor],
                 mus: List[torch.Tensor], nus: List[torch.Tensor], hyper: List[float]):
        self.plan, self.gs, self.written, self.hyper = plan, gs, (ps, mus, nus), hyper
        self.grads = plan.upload(gs)
        sums, self.finite = adamw_norm(gs, plan.leaves, plan.chunks, self.grads)
        self.group_sums, self.norm = sums[:4], sums[4]

    def apply(self, gnorm, keep, apply, bc1, bc2, neg_lr) -> None:
        adamw_apply(*self.written, self.gs, self.plan.leaves, self.plan.chunks, self.grads,
                    gnorm, keep, apply, bc1, bc2, neg_lr, self.hyper)


class MultiTensor:
    """The kernel path of one optimizer: `hyper` as `apply_pass` takes it;
    the plan of the last leaves it saw."""

    def __init__(self, hyper: Sequence[float]):
        self.hyper = [float(h) for h in hyper]
        self._plan = None

    def norm(self, gs: List[torch.Tensor], ps: List[torch.Tensor], mus: List[torch.Tensor],
             nus: List[torch.Tensor], groups: Sequence[int]) -> Step:
        """The norm pass over gradients `gs` of masters `ps` with moments
        `mus`, `nus`; `groups`: each leaf's norm group."""
        key = (tuple(map(_ptr, ps)), tuple(map(_ptr, mus)), tuple(map(_ptr, nus)))
        if self._plan is None or self._plan.key != key:
            self._plan = Plan(key, ps, mus, nus, groups)
        return Step(self._plan, match_layouts(gs, self._plan), ps, mus, nus, self.hyper)
