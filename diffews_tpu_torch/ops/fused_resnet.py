"""Fused GroupNorm-apply + SiLU + 3x3 conv: a hand-written CUDA kernel and
its plain version.

Port of `diffews_tpu/ops/fused_resnet.py` (`gn_silu_conv3x3` with its
custom VJP, `gn_affine`, `gn_stats`, `fused_resnet_block`,
`fused_norm_conv_out`).  Its Pallas megakernel `_kernel` becomes the CUDA
kernel in `ops/csrc/fused_resnet.cu`: one pass that applies the GroupNorm
affine and SiLU to x while loading it, convolves with zero padding on the
activation, adds bias and residual, writes y once and returns the f32
per-channel (Σy, Σy²) the next GroupNorm of a resnet chain needs.  So a
resnet block is two kernel calls with no separate norm pass in between.

Layouts: x, residual and y are NHWC; the weight is the port's Conv2d weight
(Cout, Cin, 3, 3), repacked per call for the kernel (the JAX package also
repacks per call).  a and b are (B, Cin) f32: unlike `group_norm_act`,
which casts its per-channel affine to x's dtype, this chain keeps it in f32,
as the JAX package does, so the two paths round differently on purpose.

Dispatch (`impl`): "auto" launches the kernel on a CUDA tensor and takes
the plain version `gn_silu_conv3x3_reference` on the CPU (the JAX package:
the kernel on the TPU, XLA elsewhere); "pallas" names the kernel (its plain
version on the CPU); "xla" is the plain version everywhere.  There is no
fallback from the kernel: a CUDA tensor it does not take raises.  On the
card the kernel is reached through the custom op
`torch.ops.diffews_tpu_torch.fused_gn_silu_conv3x3` (CUDA: the launcher;
CPU: the plain version; a fake implementation for `torch.export`).  The
backward is the plain version's, recomputed under autograd, on both
devices (the VAE is frozen in DiffewS training; the backward is there for
completeness, as in the JAX package).  Launch counter:
`gn_silu_conv3x3.launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

IMPLS = ("auto", "xla", "pallas")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gn_silu_conv3x3_reference(x, a, b, w, bias, residual=None):
    """The kernel's arithmetic in plain torch (JAX `_reference`): f32
    affine and SiLU, an f32 convolution (zero padding on the activation),
    + bias, rounded to x's dtype, + residual in x's dtype; f32 (Σy, Σy²)
    of that y over H, W.  Returns (y, s1, s2), s1 and s2 (B, Cout)."""
    actf = x.float() * a.float()[:, None, None, :] + b.float()[:, None, None, :]
    act = F.silu(actf)
    y = F.conv2d(act.permute(0, 3, 1, 2), w.float(), padding=1).permute(0, 2, 3, 1)
    y = (y + bias.float()).to(x.dtype)
    if residual is not None:
        y = y + residual
    return (y,) + gn_stats(y)


def _check(x, a, b, w, bias, residual):
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, Cin); got {tuple(x.shape)}")
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the fused resnet kernel takes float32 or bfloat16 x; got {x.dtype}")
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"w must be (Cout, {cin}, 3, 3); got {tuple(w.shape)}")
    if x.dtype == torch.bfloat16 and cin % 8:
        raise ValueError(f"the bf16 kernel needs Cin % 8 == 0; got Cin = {cin}")
    for name, t, shape in (("a", a, (bsz, cin)), ("b", b, (bsz, cin)), ("bias", bias, (cout,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32; got {t.dtype} {tuple(t.shape)}")
    if residual is not None and (tuple(residual.shape) != (bsz, h, wd, cout)
                                 or residual.dtype != x.dtype):
        raise ValueError(f"residual must be {(bsz, h, wd, cout)} {x.dtype}; got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    for name, t in (("x", x), ("a", a), ("b", b), ("bias", bias), ("residual", residual)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x and residual: NHWC)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(x, a, b, w, bias, residual):
    from diffews_tpu_torch.ops import _build

    _check(x, a, b, w, bias, residual)
    lib = _build.load("fused_resnet")
    tile = lib.fused_resnet_tile
    tile.restype, tile.argtypes = ctypes.c_int, [ctypes.c_int]
    fn = lib.fused_gn_silu_conv3x3
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    # [tap][Cout][Cin] for the tensor-core kernel, [tap][Cin][Cout] for f32
    perm = (2, 3, 0, 1) if x.dtype == torch.bfloat16 else (2, 3, 1, 0)
    wk = w.to(x.dtype).permute(*perm).contiguous()
    bias32 = bias.contiguous()
    n_part = math.ceil(h / tile(0)) * math.ceil(wd / tile(1))
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((bsz, n_part, 2, cout), dtype=torch.float32, device=x.device)
    s1 = torch.empty((bsz, cout), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), wk.data_ptr(), bias32.data_ptr(),
                 None if residual is None else residual.data_ptr(), y.data_ptr(),
                 part.data_ptr(), s1.data_ptr(), s2.data_ptr(), bsz, h, wd, cin, cout, n_part,
                 _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gn_silu_conv3x3 launch failed: CUDA error {err}")
    gn_silu_conv3x3.launches += 1
    return y, s1, s2


@torch.library.custom_op("diffews_tpu_torch::fused_gn_silu_conv3x3", mutates_args=(),
                         device_types="cuda")
def fused_gn_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, residual: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernel as a custom op: (y (B, H, W, Cout) in x's dtype, s1,
    s2 (B, Cout) f32), all contiguous.  CUDA: `_launch`; CPU: the plain
    version."""
    return _launch(x, a, b, w, bias, residual)


@fused_gn_silu_conv3x3.register_kernel("cpu")
def _fused_cpu(x, a, b, w, bias, residual):
    y, s1, s2 = gn_silu_conv3x3_reference(x, a, b, w, bias, residual)
    return y.contiguous(), s1, s2


@fused_gn_silu_conv3x3.register_fake
def _fused_fake(x, a, b, w, bias, residual):
    bsz, h, wd, _ = x.shape
    cout = w.shape[0]
    return (x.new_empty((bsz, h, wd, cout)), x.new_empty((bsz, cout), dtype=torch.float32),
            x.new_empty((bsz, cout), dtype=torch.float32))


def _forward(x, a, b, w, bias, residual, impl):
    if impl == "xla" or x.device.type == "cpu":
        return gn_silu_conv3x3_reference(x, a, b, w, bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"no fused resnet kernel for device {x.device}")
    return fused_gn_silu_conv3x3(x, a, b, w, bias, residual)


class _GnSiluConv3x3(torch.autograd.Function):
    """(y, s1, s2) from `_forward`; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias, residual, impl):
        ctx.save_for_backward(x, a, b, w, bias, residual)
        return _forward(x, a, b, w, bias, residual, impl)

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, needs)]
            outs = gn_silu_conv3x3_reference(*ins)
            wrt = [t for t, n in zip(ins, needs) if n]
            pairs = [(o, g) for o, g in zip(outs, (gy, gs1, gs2)) if g is not None]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                             [g for _, g in pairs], allow_unused=True))
        return tuple(next(grads) if n else None for n in needs) + (None,)


def gn_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor, residual: Optional[torch.Tensor] = None, *,
                    impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """conv3x3(silu(x·a + b)) + bias (+ residual), with the f32 per-channel
    (Σy, Σy²) of the output for the next GroupNorm in the chain.

    x: (B, H, W, Cin); a, b: (B, Cin) f32 (see `gn_affine`); w: (Cout, Cin,
    3, 3); bias: (Cout,); residual: (B, H, W, Cout) or None.  Returns (y,
    s1, s2), s1 and s2 (B, Cout) f32."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    a, b, bias = a.float(), b.float(), bias.float()
    ts = (x, a, b, w, bias, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts):
        return _GnSiluConv3x3.apply(x, a, b, w, bias, residual, impl)
    return _forward(x, a, b, w, bias, residual, impl)


gn_silu_conv3x3.launches = 0


def gn_affine(s1, s2, scale, bias, *, groups: int, n: int, eps: float):
    """Fold GroupNorm statistics (per-channel f32 sums over n elements per
    group) with the learned scale and bias into a per-(B, C) f32 affine
    y = x·a + b."""
    bsz, c = s1.shape
    s1g = s1.reshape(bsz, groups, -1).sum(-1)
    s2g = s2.reshape(bsz, groups, -1).sum(-1)
    mean = s1g / n
    var = s2g / n - mean.square()
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(c // groups, dim=1)
    mean_c = mean.repeat_interleave(c // groups, dim=1)
    sf, bf = scale.float()[None], bias.float()[None]
    return inv_c * sf, bf - mean_c * inv_c * sf


def gn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 (Σx, Σx²) over H, W: the chain's seed at the seams
    (after conv_in, a resampler or the attention), where no kernel call
    produced them."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), xf.square().sum(dim=(1, 2))


def fused_resnet_block(block, x: torch.Tensor,
                       in_stats: Optional[Tuple[torch.Tensor, torch.Tensor]], *,
                       groups: int, eps: float, impl: str = "auto"):
    """diffusers ResnetBlock2D (no temb) as two fused calls with the
    GroupNorm statistics threaded through.  `block` is a
    `layers.ResnetBlock2D`; in_stats: x's (Σ, Σ²) from the previous call of
    an unbroken chain, or None.  Returns (out, out_stats)."""
    bsz, h, wd, cin = x.shape
    cout = block.conv1.weight.shape[0]
    if in_stats is None:
        in_stats = gn_stats(x)
    a1, b1 = gn_affine(*in_stats, block.norm1.weight, block.norm1.bias,
                       groups=groups, n=h * wd * (cin // groups), eps=eps)
    hmid, t1, t2 = gn_silu_conv3x3(x, a1, b1, block.conv1.weight, block.conv1.bias, impl=impl)
    a2, b2 = gn_affine(t1, t2, block.norm2.weight, block.norm2.bias,
                       groups=groups, n=h * wd * (cout // groups), eps=eps)
    res = block.conv_shortcut(x) if hasattr(block, "conv_shortcut") else x
    out, s1, s2 = gn_silu_conv3x3(hmid, a2, b2, block.conv2.weight, block.conv2.bias, res,
                                  impl=impl)
    return out, (s1, s2)


def fused_norm_conv_out(norm, conv, x: torch.Tensor,
                        in_stats: Optional[Tuple[torch.Tensor, torch.Tensor]], *,
                        groups: int, eps: float, impl: str = "auto") -> torch.Tensor:
    """conv_out(silu(group_norm(x))), the VAE head, as one fused call;
    `norm` is a `layers.GroupNorm`, `conv` a 3x3 `layers.Conv2d`."""
    bsz, h, wd, c = x.shape
    if in_stats is None:
        in_stats = gn_stats(x)
    a, b = gn_affine(*in_stats, norm.weight, norm.bias, groups=groups,
                     n=h * wd * (c // groups), eps=eps)
    return gn_silu_conv3x3(x, a, b, conv.weight, conv.bias, impl=impl)[0]
