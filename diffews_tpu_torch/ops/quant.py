"""W8A8 int8 post-training quantization: the VAE's 3x3 convolutions
(`vae_impl="int8"`) and the UNet's attention / feed-forward linears
(`unet_int8`).

Port of `diffews_tpu/ops/quant.py`.  The JAX package computes it with XLA
ops, not Pallas.  On the card the int8 convolution has no PyTorch route
(`F.conv2d` refuses int8 CUDA tensors), so two hand-written CUDA kernels in
`ops/csrc/quant_int8.cu` carry it:

  - `quantize_s8`: xq = int8(clip(round_half_even(f32(x) / s_a), ±127)),
    the quantize of `quant.py:322-328`, with `s_a` a 0-d f32 device tensor;
  - `conv2d_int8`: the implicit-GEMM 3x3 convolution of int8 NHWC
    activations with int8 (Cout, 3, 3, Cin) weights, summed in int32 on the
    tensor cores, and the epilogue `f32(acc) * (w_scale * s_a) + bias`
    rounded once to the output dtype (`quant.py:331-340`).

The int8 linears are plain matrix products (XLA's dot in the JAX package):
`quantize_s8`, then `torch._int_mm` on the card, then the same epilogue in
torch ops.

Scheme (symmetric): per-output-channel weight scales `s_w = max(amax|k| /
127, 1e-12)`, `k8 = clip(round(k / s_w), ±127)`, quantized once; a
per-tensor activation scale, static (`s_a = a_scale / 127` from a
calibrated `a_scale`) or dynamic (`amax|x| / 127` on the device).  Only 3x3
convolutions with at least `MIN_QUANT_CIN` input channels quantize, and
only the linears `unet_attention_linear` accepts.

The integer part is exact (|acc| <= 127² · 9 · Cin < 2³¹), so the kernels
equal their plain versions bit for bit: the plain convolution runs in f64
on the int8 values (every sum < 2⁵³), the plain linear an f64 matmul.
`/ 127` is a multiply by f32(1/127), as XLA compiles it in the JAX
package; `x / s_a` and `w / s_w` are true divisions (tensor divisors; CUDA
turns only a Python-scalar divisor into a reciprocal multiply).

Dispatch: a CPU tensor takes the plain versions; a CUDA tensor launches the
kernels (through the custom ops `torch.ops.diffews_tpu_torch.quantize_s8`
and `conv2d_int8`) or raises.  Launch counters: `quantize_s8.launches`,
`conv2d_int8.launches` and `linear_int8.launches` (the `torch._int_mm`
calls).

Calibration (`calibrate_scales`) records the f32 amax(|x|) at every site
over one run, under a lock, and multiplies it by `margin` (1.25) in Python
floats, as the JAX package's `calibrate_conv_scales` does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffews_tpu_torch.models.layers import Conv2d

MIN_QUANT_CIN = 32
CALIB_MARGIN = 1.25
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# calibration hooks of two runs at once would record each other's sites
_CALIB_LOCK = threading.Lock()


# 1/127 in f32.  The JAX package's `v / 127.0` compiles to `v * f32(1/127)`
# (XLA folds a division by a constant into a multiply by its reciprocal),
# so every `/ 127` here is that multiply: the scales equal JAX's bit for bit.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _div127(x: torch.Tensor) -> torch.Tensor:
    """JAX's f32 `x / 127.0`: x times f32(1/127), filled on x's device."""
    return x * torch.full((), INV_127, dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# scales and weights
# ---------------------------------------------------------------------------


def static_s_a(a_scale: float, device=None) -> torch.Tensor:
    """The static activation scale `max(f32(a_scale) / 127, 1e-12)` as a
    0-d f32 tensor (JAX: `jnp.float32(a_scale) / 127.0`, in f32)."""
    s = np.maximum(np.float32(a_scale) * np.float32(INV_127), np.float32(1e-12))
    return torch.tensor(s, dtype=torch.float32, device=device)


def dynamic_s_a(x: torch.Tensor) -> torch.Tensor:
    """`max(amax|x| / 127, 1e-12)` on x's device, 0-d f32."""
    return torch.clamp_min(_div127(x.abs().amax().float()), 1e-12)


def quantize_weight(w: torch.Tensor, reduce_dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 weights (output channels on dim 0): s_w =
    max(amax|w| / 127, 1e-12) over `reduce_dims`, w8 = clip(round(w / s_w),
    ±127).  Returns (w8 int8 in w's layout, s_w f32 (Cout,))."""
    k = w.float()
    s_w = torch.clamp_min(_div127(k.abs().amax(dim=reduce_dims)), 1e-12)
    shape = (-1,) + (1,) * (k.ndim - 1)
    w8 = torch.clamp(torch.round(k / s_w.reshape(shape)), -127, 127).to(torch.int8)
    return w8, s_w


def should_quantize_conv(conv: nn.Module) -> bool:
    """The site rule of `quant.py:170-172`: 3x3 kernels with Cin >= 32."""
    return (isinstance(conv, Conv2d) and tuple(conv.kernel_size) == (3, 3)
            and conv.in_channels >= MIN_QUANT_CIN)


def unet_attention_linear(path: str) -> bool:
    """The opt-in int8 UNet's linears (`quant.py:231-240`): the
    self-attention projections (attn1 q/k/v/out), the GEGLU feed-forward and
    the transformers' proj_in/proj_out.  Cross-attention (attn2) stays fp."""
    return (".attn1." in path or ".ff." in path
            or path.endswith(".proj_in") or path.endswith(".proj_out"))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def quantize_s8_reference(x: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    """int8(clip(round_half_even(f32(x) / s_a), ±127))."""
    return torch.clamp(torch.round(x.float() / s_a), -127, 127).to(torch.int8)


def _pads(padding) -> tuple[int, int, int, int]:
    """int, ((top, bottom), (left, right)) or [top, bottom, left, right] ->
    (top, bottom, left, right)."""
    if isinstance(padding, int):
        return padding, padding, padding, padding
    if len(padding) == 4:
        return tuple(int(p) for p in padding)
    (pt, pb), (pl, pr) = padding
    return int(pt), int(pb), int(pl), int(pr)


def _dequant(acc_f32, w_scale, s_a, bias, out_dtype):
    """JAX's epilogue: `acc * (w_scale * s_a)`, then `+ bias`, each an f32
    op, then one rounding to the output dtype."""
    y = acc_f32 * (w_scale * s_a)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def conv2d_int8_reference(xq, w_q, w_scale, s_a, bias, stride: int, padding,
                          out_dtype) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: an f64 convolution of the
    int8 values (exact), rounded to f32, then the epilogue as separate
    ops.  xq: (B, H, W, Cin) int8; w_q: (Cout, 3, 3, Cin) int8."""
    pt, pb, pl, pr = _pads(padding)
    xc = F.pad(xq.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    acc = F.conv2d(xc, w_q.double().permute(0, 3, 1, 2), stride=stride)
    return _dequant(acc.permute(0, 2, 3, 1).float(), w_scale, s_a, bias, out_dtype)


def _int_mm_reference(xq2: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """xq2 (M, K) @ w_q (N, K)ᵀ as exact integers, in f32 (f64 matmul)."""
    return (xq2.double() @ w_q.double().t()).float()


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_device(x, **others):
    for name, t in others.items():
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _quant_launch(x: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    from diffews_tpu_torch.ops import _build

    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the quantize kernel takes float32 or bfloat16 x; got {x.dtype}")
    _check_device(x, s_a=s_a)
    if s_a.dtype != torch.float32 or s_a.numel() != 1:
        raise ValueError(f"s_a must be one float32 value; got {s_a.dtype} {tuple(s_a.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned tensor")
    fn = _build.load("quant_int8").quantize_s8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), s_a.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_s8 launch failed: CUDA error {err}")
    quantize_s8.launches += 1
    return y


def _conv_out_hw(h, w, stride, pads):
    pt, pb, pl, pr = pads
    return (h + pt + pb - 3) // stride + 1, (w + pl + pr - 3) // stride + 1


def _conv_launch(xq, w_q, w_scale, s_a, bias, stride: int, padding, out_dtype):
    from diffews_tpu_torch.ops import _build

    pads = _pads(padding)
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"the int8 conv takes int8 x and weights; got {xq.dtype}, {w_q.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"the int8 conv writes float32 or bfloat16; got {out_dtype}")
    bsz, h, w, cin = xq.shape
    cout = w_q.shape[0]
    if cin % 16:
        raise ValueError(f"the int8 conv kernel needs Cin % 16 == 0; got Cin = {cin}")
    if stride not in (1, 2) or any(p not in (0, 1) for p in pads):
        raise ValueError(f"the int8 conv kernel takes stride 1 or 2 and paddings 0 or 1; "
                         f"got stride {stride}, padding {pads}")
    ho, wo = _conv_out_hw(h, w, stride, pads)
    if min(bsz, ho, wo, cout) <= 0:
        raise ValueError(f"unsupported extent: x {tuple(xq.shape)}, output {ho} x {wo} x {cout}")
    _check_device(xq, w_q=w_q, w_scale=w_scale, s_a=s_a, bias=bias)
    for name, t in (("x", xq), ("w_q", w_q), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor")
    if (w_scale.dtype != torch.float32 or s_a.dtype != torch.float32
            or (bias is not None and bias.dtype != torch.float32)):
        raise TypeError("w_scale, s_a and bias must be float32")
    fn = _build.load("quant_int8").conv2d_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    y = torch.empty((bsz, ho, wo, cout), dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), s_a.data_ptr(),
                 0 if bias is None else bias.data_ptr(), y.data_ptr(), bsz, h, w, cin, cout,
                 ho, wo, stride, pads[0], pads[2], _DTYPE_CODE[out_dtype],
                 torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv2d_int8 launch failed: CUDA error {err}")
    conv2d_int8.launches += 1
    return y


@torch.library.custom_op("diffews_tpu_torch::quantize_s8", mutates_args=(),
                         device_types="cuda")
def quantize_s8_op(x: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    """The quantize kernel as a custom op: int8 of x's shape, contiguous.
    CUDA: `_quant_launch`; CPU: the plain version."""
    return _quant_launch(x, s_a)


@quantize_s8_op.register_kernel("cpu")
def _quantize_cpu(x, s_a):
    return quantize_s8_reference(x, s_a).contiguous()


@quantize_s8_op.register_fake
def _quantize_fake(x, s_a):
    return x.new_empty(x.shape, dtype=torch.int8)


@torch.library.custom_op("diffews_tpu_torch::conv2d_int8", mutates_args=(),
                         device_types="cuda")
def conv2d_int8_op(xq: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                   s_a: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
                   padding: List[int], out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 conv kernel as a custom op: (B, Ho, Wo, Cout) in
    `out_dtype`, contiguous; padding = [top, bottom, left, right].  CUDA:
    `_conv_launch`; CPU: the plain version."""
    return _conv_launch(xq, w_q, w_scale, s_a, bias, stride, padding, out_dtype)


@conv2d_int8_op.register_kernel("cpu")
def _conv_cpu(xq, w_q, w_scale, s_a, bias, stride, padding, out_dtype):
    return conv2d_int8_reference(xq, w_q, w_scale, s_a, bias, stride, padding,
                                 out_dtype).contiguous()


@conv2d_int8_op.register_fake
def _conv_fake(xq, w_q, w_scale, s_a, bias, stride, padding, out_dtype):
    bsz, h, w, _ = xq.shape
    ho, wo = _conv_out_hw(h, w, stride, _pads(padding))
    return xq.new_empty((bsz, ho, wo, w_q.shape[0]), dtype=out_dtype)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _on(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    return True


def quantize_s8(x: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    """int8(clip(round(f32(x) / s_a), ±127)): the kernel on a CUDA tensor,
    the plain version on a CPU one."""
    if _on(x, "quantize"):
        return torch.ops.diffews_tpu_torch.quantize_s8(x, s_a)
    return quantize_s8_reference(x, s_a)


quantize_s8.launches = 0


def conv2d_int8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, s_a: Optional[torch.Tensor] = None,
                stride: int = 1, padding=((1, 1), (1, 1))) -> torch.Tensor:
    """W8A8 3x3 convolution (JAX `quant.conv2d_int8`).

    x: (B, H, W, Cin) NHWC float32 or bfloat16; w_q: (Cout, 3, 3, Cin) int8;
    w_scale: (Cout,) f32; bias: (Cout,) f32 or None; s_a: the static 0-d
    f32 activation scale, or None for the dynamic one; padding: int or
    ((top, bottom), (left, right)).  Returns (B, Ho, Wo, Cout) in x's
    dtype."""
    s = dynamic_s_a(x) if s_a is None else s_a
    xq = quantize_s8(x, s)
    if _on(x, "int8 conv"):
        return torch.ops.diffews_tpu_torch.conv2d_int8(xq, w_q, w_scale, s, bias, stride,
                                                       list(_pads(padding)), x.dtype)
    return conv2d_int8_reference(xq, w_q, w_scale, s, bias, stride, padding, x.dtype)


conv2d_int8.launches = 0


def _int_mm(xq2: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """`torch._int_mm(xq2, w_qᵀ)` in f32, with the operands zero-padded to
    what it takes on the card (M > 16, K and N multiples of 8)."""
    m, k = xq2.shape
    n = w_q.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        xq2 = F.pad(xq2, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w_q = F.pad(w_q, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(xq2, w_q.t())
    linear_int8.launches += 1
    return y[:m, :n].float()


def linear_int8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                s_a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 linear (JAX `quant.linear_int8`): x (..., K) float32 or
    bfloat16; w_q: (N, K) int8 (the nn.Linear layout); w_scale: (N,) f32;
    bias: (N,) f32 or None; s_a: static 0-d f32 scale or None (dynamic, over
    the whole x).  Returns (..., N) in x's dtype."""
    s = dynamic_s_a(x) if s_a is None else s_a
    xq = quantize_s8(x, s).reshape(-1, x.shape[-1])
    acc = _int_mm(xq, w_q) if _on(x, "int8 linear") else _int_mm_reference(xq, w_q)
    return _dequant(acc, w_scale, s, bias, x.dtype).reshape(x.shape[:-1] + (w_q.shape[0],))


linear_int8.launches = 0


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Int8Conv2d(nn.Module):
    """A quantized `layers.Conv2d` (3x3): int8 weights in the kernel's
    (Cout, 3, 3, Cin) layout, per-channel `w_scale`, the bias in f32 and
    an optional static scale `s_a` (None: dynamic), all buffers.  Its
    forward keeps `Conv2d`'s signature."""

    def __init__(self, conv: Conv2d, a_scale: Optional[float] = None):
        super().__init__()
        w = conv.weight.detach()
        w8, s_w = quantize_weight(w.permute(0, 2, 3, 1), (1, 2, 3))
        self.register_buffer("weight_q", w8.contiguous())
        self.register_buffer("w_scale", s_w)
        self.register_buffer("bias", None if conv.bias is None else conv.bias.detach().float())
        self.register_buffer("s_a", None if a_scale is None else static_s_a(a_scale, w.device))
        self.stride, self.padding = conv.stride[0], conv.padding[0]
        self.out_channels = conv.out_channels

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        return conv2d_int8(x, self.weight_q, self.w_scale, self.bias, s_a=self.s_a,
                           stride=self.stride,
                           padding=self.padding if padding is None else padding)


class Int8Linear(nn.Module):
    """A quantized `nn.Linear`: int8 (out, in) weights, per-output
    `w_scale`, the bias in f32 and an optional static `s_a`, all buffers."""

    def __init__(self, lin: nn.Linear, a_scale: Optional[float] = None):
        super().__init__()
        w = lin.weight.detach()
        w8, s_w = quantize_weight(w, (1,))
        self.register_buffer("weight_q", w8.contiguous())
        self.register_buffer("w_scale", s_w)
        self.register_buffer("bias", None if lin.bias is None else lin.bias.detach().float())
        self.register_buffer("s_a", None if a_scale is None else static_s_a(a_scale, w.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_int8(x, self.weight_q, self.w_scale, self.bias, s_a=self.s_a)


def conv_sites(module: nn.Module) -> dict:
    """{qualified name: Conv2d} of the convolutions that quantize."""
    return {n: m for n, m in module.named_modules() if should_quantize_conv(m)}


def linear_sites(module: nn.Module, path_filter: Callable = unet_attention_linear) -> dict:
    """{qualified name: nn.Linear} of the linears `path_filter` accepts."""
    return {n: m for n, m in module.named_modules()
            if isinstance(m, nn.Linear) and path_filter(n)}


def _a_scale(a_scales, path):
    """The static scale of a site: a dict keyed by qualified name (absent:
    dynamic), one float for every site, or None (dynamic)."""
    if isinstance(a_scales, dict):
        return a_scales.get(path)
    return a_scales


def _swap(module: nn.Module, sites: dict, make) -> nn.Module:
    for name, child in sites.items():
        parent, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(parent) if parent else module, leaf, make(name, child))
    return module


def quantize_conv_modules(module: nn.Module, a_scales=None) -> nn.Module:
    """Swap every eligible `Conv2d` of `module` for an `Int8Conv2d`, in
    place (JAX `quantize_conv_tree`): a_scales None (dynamic scales), a
    float (one static scale) or {qualified name: float} (static where
    named, dynamic elsewhere), e.g. from `calibrate_vae_scales`."""
    return _swap(module, conv_sites(module),
                 lambda name, c: Int8Conv2d(c, _a_scale(a_scales, name)))


def quantize_linear_modules(module: nn.Module, path_filter: Callable = unet_attention_linear,
                            a_scales=None) -> nn.Module:
    """Swap every `nn.Linear` whose qualified name passes `path_filter` for
    an `Int8Linear`, in place (JAX `quantize_linear_tree`); `a_scales` as in
    `quantize_conv_modules`."""
    return _swap(module, linear_sites(module, path_filter),
                 lambda name, lin: Int8Linear(lin, _a_scale(a_scales, name)))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def calibrate_scales(run_fn: Callable[[], object], sites: dict,
                     margin: float = CALIB_MARGIN) -> dict:
    """{site name: float amax(|x|) * margin} over one `run_fn()`, recording
    each site's input through a forward pre-hook (JAX
    `calibrate_conv_scales`).  Runs under a lock: two calibrations at once
    would record each other's activations."""
    amax: dict = {}

    def hook(name):
        def pre(_module, args):
            a = args[0].detach().abs().amax().float()
            amax[name] = a if name not in amax else torch.maximum(amax[name], a)
        return pre

    with _CALIB_LOCK:
        handles = [m.register_forward_pre_hook(hook(n)) for n, m in sites.items()]
        try:
            with torch.inference_mode():
                run_fn()
        finally:
            for h in handles:
                h.remove()
    return {k: float(v) * margin for k, v in amax.items()}


def vae_calibration_batch(resolution: int = 256) -> torch.Tensor:
    """The synthetic calibration images of `quant.calibrate_vae_scales`
    (f32, NHWC, on the CPU): low-frequency noise (2 x 16 x 16 uniform,
    linearly upsampled) plus N(0, 0.08) noise, clipped to [-1, 1]."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.uniform(-1.0, 1.0, (2, 16, 16, 3)).astype(np.float32))
    imgs = F.interpolate(base.permute(0, 3, 1, 2), size=(resolution, resolution),
                         mode="bilinear", align_corners=False,
                         antialias=False).permute(0, 2, 3, 1)
    noise = torch.from_numpy(rng.normal(0, 0.08, tuple(imgs.shape)).astype(np.float32))
    return torch.clamp(imgs + noise, -1.0, 1.0)


def calibrate_vae_scales(vae: nn.Module, *, attn_impl: str = "auto",
                         dtype=torch.bfloat16, resolution: int = 256,
                         margin: float = CALIB_MARGIN) -> dict:
    """Static activation scales of every eligible VAE conv (encode and
    decode sites) from one synthetic batch, on the VAE's device, through
    the "xla" resnet graph (JAX `calibrate_vae_scales`)."""
    device = next(vae.parameters()).device
    imgs = vae_calibration_batch(resolution).to(device=device, dtype=dtype)

    def run():
        lat = vae.encode_mean_latent(imgs, attn_impl=attn_impl, resnet_impl="xla")
        return vae.decode(lat, attn_impl=attn_impl)

    return calibrate_scales(run, conv_sites(vae), margin)


def calibrate_unet_scales(unet: nn.Module, context: torch.Tensor, *, attn_impl: str = "auto",
                          margin: float = CALIB_MARGIN) -> dict:
    """Static activation scales of the int8 UNet's linears (JAX
    `pipeline.py:226-248`): one joint forward at timestep 1 over a
    standard-normal query latent (1, 32, 32, 4) and support latent
    (1, 1, 32, 32, 8), drawn in that order from `default_rng(0)`, with
    `context` (the empty-prompt embedding)."""
    rng = np.random.default_rng(0)
    dev, dt = context.device, context.dtype
    lat = torch.from_numpy(rng.normal(size=(1, 32, 32, 4))).to(dev, dt)
    ref = torch.from_numpy(rng.normal(size=(1, 1, 32, 32, 8))).to(dev, dt)
    run = lambda: unet(lat, 1, context, ref_sample=ref, attn_impl=attn_impl)
    return calibrate_scales(run, linear_sites(unet), margin)
