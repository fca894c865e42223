"""GroupNorm with an optional fused SiLU: two hand-written CUDA kernels and
their plain version.

Port of `diffews_tpu/ops/groupnorm.py` (`group_norm_act` with its custom
VJP).  Its two Pallas kernels become the CUDA kernels in
`ops/csrc/groupnorm.cu`:

  - `_stats_kernel` -> `gn_stats_kernel`: per-(B, C) f32 Σx and Σx² over
    H·W, one read of x, deterministic (per-slab partials summed in a fixed
    order);
  - `_apply_kernel` -> `gn_apply_kernel`: y = act(x·A + B), one read of x
    and one write of y, SiLU in f32.

Between them the group fold runs in plain torch on (B, C) tensors, as in
the JAX package: group mean and rstd from the channel sums, composed with
the GroupNorm scale and bias into per-channel A and B, cast to x's dtype.
The apply kernel rounds like the plain version's two torch ops (product,
then sum, in x's dtype), so where A and B agree the two agree bit for bit
before the activation.

Dispatch (`impl`, the JAX package's strings): "auto" and "pallas" launch
the kernels on a CUDA tensor; a CPU tensor, "xla", or an input that is not
4-D (B, H, W, C) takes the plain version `group_norm_act_reference`
(`layers.group_norm`, then SiLU).  The JAX package resolves "auto" to XLA
on every backend: on the TPU the Pallas boundaries moved XLA's layout
copies instead of removing them.  On the card the activations are
contiguous NHWC tensors and a kernel boundary costs no copy, so "auto"
takes the kernels there, as `fused_resnet.gn_silu_conv3x3` does.  There is
no fallback from a kernel: a CUDA tensor it does not take raises.  On the
card the two kernels are reached through the custom ops
`torch.ops.diffews_tpu_torch.gn_stats` and `.gn_apply` (CUDA: the
launchers below; CPU: the plain statistics and apply; fake
implementations for `torch.export`).

Differentiation: one `torch.autograd.Function` on both devices whose
backward differentiates the plain formula, recomputed under autograd (the
JAX custom VJP).  The UNet's resnets run through it in every training
micro-step.  Launch counters: `gn_stats_kernel.launches`,
`gn_apply_kernel.launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from diffews_tpu_torch.ops.fused_resnet import gn_affine
from diffews_tpu_torch.ops.fused_resnet import gn_stats as plain_stats

IMPLS = ("auto", "xla", "pallas")
ACTS = (None, "none", "silu")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 2048  # stats blocks per launch: ~16 per SM on 132 SMs
_MIN_SLAB_ROWS = 32


def group_norm_act_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                             groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """The plain version (JAX `_xla_reference`): `layers.group_norm`, then
    SiLU when act == "silu"."""
    from diffews_tpu_torch.models.layers import group_norm

    y = group_norm(x, weight, bias, groups=groups, eps=eps)
    return F.silu(y) if act == "silu" else y


def _vec(x: torch.Tensor, *others: torch.Tensor) -> int:
    """Channels per 16-byte (or narrower) access: the largest width that
    divides C and keeps every pointer aligned."""
    c, elt = x.shape[-1], x.element_size()
    for v in (16 // elt, 8 // elt, 4 // elt, 2 // elt, 1):
        if v >= 1 and c % v == 0 and all(t.data_ptr() % (v * elt) == 0 for t in (x,) + others):
            return v
    return 1


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the GroupNorm kernels take float32 or bfloat16; got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"the GroupNorm kernels take (B, H, W, C); got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    if x.shape[0] > 65535 or x.numel() == 0:
        raise ValueError(f"unsupported extent {tuple(x.shape)}")


def gn_stats_kernel(x: torch.Tensor):
    """Per-channel f32 (Σx, Σx²) over H·W of a contiguous NHWC CUDA tensor,
    by the stats kernel.  Returns two (B, C) f32 tensors."""
    from diffews_tpu_torch.ops import _build

    _check(x)
    fn = _build.load("groupnorm").gn_stats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bsz, h, w, c = x.shape
    hw = h * w
    vec = _vec(x)
    bx = min(32, c // vec)
    chunks = math.ceil(c // vec / bx)
    want = max(1, _TARGET_BLOCKS // (bsz * chunks))
    rows = max(_MIN_SLAB_ROWS, math.ceil(hw / want))
    nslab = math.ceil(hw / rows)
    part = torch.empty((bsz, nslab, 2, c), dtype=torch.float32, device=x.device)
    s1 = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), part.data_ptr(), s1.data_ptr(), s2.data_ptr(), bsz, hw, c,
                 _DTYPE_CODE[x.dtype], vec, rows, nslab,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_stats launch failed: CUDA error {err}")
    gn_stats_kernel.launches += 1
    return s1, s2


def gn_apply_kernel(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                    act: Optional[str] = None) -> torch.Tensor:
    """y = act(x·a + b) by the apply kernel: x a contiguous NHWC CUDA
    tensor, a and b (B, C) in x's dtype."""
    from diffews_tpu_torch.ops import _build

    _check(x)
    bsz, h, w, c = x.shape
    for name, t in (("a", a), ("b", b)):
        if (tuple(t.shape) != (bsz, c) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({bsz}, {c}) {x.dtype} tensor on "
                             f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    fn = _build.load("groupnorm").gn_apply
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h * w, c,
                 _DTYPE_CODE[x.dtype], _vec(x, a, b, y), int(act == "silu"),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_apply launch failed: CUDA error {err}")
    gn_apply_kernel.launches += 1
    return y


gn_stats_kernel.launches = 0
gn_apply_kernel.launches = 0


def gn_apply_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       act: str = "none") -> torch.Tensor:
    """The apply kernel's arithmetic in plain torch: x·a + b in x's dtype
    (product, then sum), then SiLU when act == "silu"; contiguous."""
    y = x * a[:, None, None, :] + b[:, None, None, :]
    return (F.silu(y) if act == "silu" else y).contiguous()


@torch.library.custom_op("diffews_tpu_torch::gn_stats", mutates_args=(), device_types="cuda")
def gn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 (Σx, Σx²) of a (B, H, W, C) tensor as a custom op:
    two contiguous (B, C) f32 tensors.  CUDA: the stats kernel; CPU:
    `fused_resnet.gn_stats`."""
    return gn_stats_kernel(x)


@gn_stats.register_kernel("cpu")
def _gn_stats_cpu(x):
    return plain_stats(x)


@gn_stats.register_fake
def _gn_stats_fake(x):
    shape = (x.shape[0], x.shape[-1])
    return x.new_empty(shape, dtype=torch.float32), x.new_empty(shape, dtype=torch.float32)


@torch.library.custom_op("diffews_tpu_torch::gn_apply", mutates_args=(), device_types="cuda")
def gn_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, act: str) -> torch.Tensor:
    """y = act(x·a + b) as a custom op (act "silu" or "none"), contiguous
    like x.  CUDA: the apply kernel; CPU: `gn_apply_reference`."""
    return gn_apply_kernel(x, a, b, act=act)


@gn_apply.register_kernel("cpu")
def _gn_apply_cpu(x, a, b, act):
    return gn_apply_reference(x, a, b, act)


@gn_apply.register_fake
def _gn_apply_fake(x, a, b, act):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _kernels(x, weight, bias, groups, eps, act):
    """The kernel path: stats kernel, group fold in torch, apply kernel."""
    s1, s2 = gn_stats(x)
    bsz, h, w, c = x.shape
    a, b = gn_affine(s1, s2, weight, bias, groups=groups, n=h * w * (c // groups), eps=eps)
    return gn_apply(x, a.to(x.dtype), b.to(x.dtype), act or "none")


def _forward(x, weight, bias, groups, eps, act, impl):
    if impl == "xla" or x.ndim != 4 or x.device.type == "cpu":
        return group_norm_act_reference(x, weight, bias, groups=groups, eps=eps, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"no GroupNorm kernel for device {x.device}")
    return _kernels(x, weight, bias, groups, eps, act)


class _GroupNormAct(torch.autograd.Function):
    """The forward of `_forward`; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, act, impl):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (groups, eps, act)
        return _forward(x, weight, bias, groups, eps, act, impl)

    @staticmethod
    def backward(ctx, g):
        groups, eps, act = ctx.cfg
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            y = group_norm_act_reference(*ins, groups=groups, eps=eps, act=act)
            grads = iter(torch.autograd.grad(y, [t for t, n in zip(ins, needs) if n], g))
        return tuple(next(grads) if n else None for n in needs) + (None,) * 4


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                   groups: int, eps: float, act: Optional[str] = None,
                   impl: str = "auto") -> torch.Tensor:
    """GroupNorm over (B, ..., C) with an optional fused activation (None,
    "none" or "silu"); impl "auto", "xla" or "pallas" (see the module
    docstring).  Differentiable in x, weight and bias."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r} (expected one of {ACTS})")
    act = "silu" if act == "silu" else None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return _GroupNormAct.apply(x, weight, bias, groups, eps, act, impl)
    return _forward(x, weight, bias, groups, eps, act, impl)
