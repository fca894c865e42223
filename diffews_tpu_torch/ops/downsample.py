"""3x3 stride-2 downsample conv (the VAE encoder's Downsample2D): a
hand-written CUDA kernel and its plain version.

Port of `diffews_tpu/ops/downsample.py` (`downsample_conv2x` with its
custom VJP).  Its Pallas kernel `_kernel` becomes the CUDA kernel in
`ops/csrc/downsample.cu`: in bf16 an implicit GEMM on the shared Hopper
core of `ops/csrc/conv_common.cuh` (TMA-fed weights, wgmma), over 16 x 16
tiles of output pixels whose 33 x 33 input patch is copied into shared
memory with the bottom row and the right column bounds-checked, so the
asymmetric (0,1),(0,1) zero padding costs no padded copy of x; in f32 an
FMA kernel over 8 x 16 tiles.

As in the JAX package, no model calls this op (the VAE's `Downsample2D`
goes through the plain convolution); it is an op of its own, held against
its plain version and the JAX op.

Layouts: x and y are NHWC; the weight is the port's Conv2d weight (Cout,
Cin, 3, 3), repacked per call for the kernel.  Arithmetic: f32
accumulation, bias added in f32, one rounding to x's dtype.

Dispatch (`impl`): "auto" and "pallas" launch the kernel on a CUDA tensor
and take the plain version `downsample_conv2x_reference` on the CPU; "xla"
is the plain version everywhere.  There is no fallback from the kernel: a
CUDA tensor it does not take raises.  On the card the kernel is reached
through the custom op `torch.ops.diffews_tpu_torch.downsample_conv2x`
(CUDA: the launcher; CPU: the plain version; a fake implementation for
`torch.export`).  The backward is the plain version's,
recomputed under autograd, on both devices (the JAX custom VJP does the
same; the VAE is frozen in DiffewS training).  Launch counter:
`downsample_conv2x.launches`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

IMPLS = ("auto", "xla", "pallas")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def downsample_conv2x_reference(x, w, bias):
    """The kernel's arithmetic in plain torch (JAX `_xla_reference`): an f32
    convolution of the upcast inputs at stride 2 with (0,1),(0,1) zero
    padding, + bias in f32, rounded once to x's dtype."""
    xc = F.pad(x.float().permute(0, 3, 1, 2), (0, 1, 0, 1))
    y = F.conv2d(xc, w.float(), stride=2).permute(0, 2, 3, 1)
    return (y + bias.float()).to(x.dtype)


def _check(x, w, bias):
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, Cin); got {tuple(x.shape)}")
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    if h % 2 or wd % 2:
        raise ValueError(f"H and W must be even; got {h} x {wd}")
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"w must be (Cout, {cin}, 3, 3); got {tuple(w.shape)}")
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be ({cout},); got {tuple(bias.shape)}")


def _check_kernel(x, w, bias):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the downsample kernel takes float32 or bfloat16 x; got {x.dtype}")
    if x.dtype == torch.bfloat16 and x.shape[-1] % 8:
        raise ValueError(f"the bf16 kernel needs Cin % 8 == 0; got Cin = {x.shape[-1]}")
    if x.numel() == 0:
        raise ValueError(f"unsupported extent {tuple(x.shape)}")
    for name, t in (("w", w), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def _launch(x, w, bias):
    from diffews_tpu_torch.ops import _build

    _check_kernel(x, w, bias)
    fn = _build.load("downsample").downsample_conv2x
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    # [tap][Cout][Cin] for the tensor-core kernel, [tap][Cin][Cout] for f32
    perm = (2, 3, 0, 1) if x.dtype == torch.bfloat16 else (2, 3, 1, 0)
    wk = w.to(x.dtype).permute(*perm).contiguous()
    bias32 = bias.float().contiguous()
    y = torch.empty((bsz, h // 2, wd // 2, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wk.data_ptr(), bias32.data_ptr(), y.data_ptr(), bsz, h, wd, cin,
                 cout, _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"downsample_conv2x launch failed: CUDA error {err}")
    downsample_conv2x.launches += 1
    return y


@torch.library.custom_op("diffews_tpu_torch::downsample_conv2x", mutates_args=(),
                         device_types="cuda")
def downsample_conv2x_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The downsample kernel as a custom op: (B, H/2, W/2, Cout) in x's
    dtype, contiguous.  CUDA: `_launch`; CPU: the plain version."""
    return _launch(x, w, bias)


@downsample_conv2x_op.register_kernel("cpu")
def _downsample_cpu(x, w, bias):
    return downsample_conv2x_reference(x, w, bias).contiguous()


@downsample_conv2x_op.register_fake
def _downsample_fake(x, w, bias):
    bsz, h, wd, _ = x.shape
    return x.new_empty((bsz, h // 2, wd // 2, w.shape[0]))


def _forward(x, w, bias, impl):
    if impl == "xla" or x.device.type == "cpu":
        return downsample_conv2x_reference(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no downsample kernel for device {x.device}")
    return downsample_conv2x_op(x, w, bias)


class _DownsampleConv2x(torch.autograd.Function):
    """y from `_forward`; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, w, bias, impl):
        ctx.save_for_backward(x, w, bias)
        return _forward(x, w, bias, impl)

    @staticmethod
    def backward(ctx, gy):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            y = downsample_conv2x_reference(*ins)
            grads = iter(torch.autograd.grad(y, [t for t, n in zip(ins, needs) if n], gy))
        return tuple(next(grads) if n else None for n in needs) + (None,)


def downsample_conv2x(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """3x3 stride-2 conv with (0,1),(0,1) zero padding, + bias.

    x: (B, H, W, Cin) NHWC with H and W even; w: (Cout, Cin, 3, 3); bias:
    (Cout,).  Returns (B, H/2, W/2, Cout) in x's dtype.  impl: "auto" |
    "pallas" (the kernel on a CUDA tensor) | "xla" (the plain version)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    _check(x, w, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, bias)):
        return _DownsampleConv2x.apply(x, w, bias, impl)
    return _forward(x, w, bias, impl)


downsample_conv2x.launches = 0
