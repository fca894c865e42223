"""Flash attention: hand-written CUDA kernels and their plain versions.

Port of `diffews_tpu/ops/flash_attention.py` (`flash_attention` with its
custom VJP, and `flash_attention_lse`).  Its three Pallas kernels become
CUDA kernels: `_flash_kernel` (`ops/csrc/flash_attention_fwd.cu`) and the
backward pair `_bwd_dq_kernel` / `_bwd_dkv_kernel`
(`ops/csrc/flash_attention_bwd.cu`).  DiffewS query tokens attend over
`[own ‖ n-shot support]` keys, so at 512px the UNet's 64x64 level runs
Sq = 4096 against Skv = 4096·(1+n); the VAE mid block runs one head with
d = 512.  The kernels stream tiles through shared memory and never write
the (Sq, Skv) probabilities to device memory; bf16 runs on the tensor
cores, f32 on the FMA pipes.

Dispatch: a CUDA tensor launches the kernels (or raises); a CPU tensor
takes the plain versions, `flash_attention_reference` (dense f32 softmax
with the same boolean mask and the same LSE) and
`flash_attention_bwd_reference` (the backward written as the kernels'
formula).  There is no fallback from a kernel.  On the card the forward
goes through the custom op `torch.ops.diffews_tpu_torch.flash_attention_fwd`
(CUDA: the kernel's launcher; CPU: the plain version; a fake
implementation for `torch.export`), so an exported program carries the
kernel as one node.  `flash_attention` is one
`torch.autograd.Function` on both devices: it saves (q, k, v, mask, O, LSE)
and its backward calls `flash_attention_bwd`.  `flash_attention_lse` is
forward-only, as in the JAX package: on the card it raises when an input
requires grad, and so does `flash_attention` at a head dim with no
backward kernel (d = 512).  Launch counters: `flash_attention.launches`
(forward, both entry points), `flash_attention_bwd.dq_launches` and
`.dkv_launches`.

Masked keys get exactly zero weight (and zero dK/dV); a query row with no
valid key gets O = 0, LSE = -inf and dQ = 0 (the main path never builds
one: every query row keeps its own tokens).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

HEAD_DIMS = (16, 32, 64, 512)  # the forward kernel's instantiations
BWD_HEAD_DIMS = (16, 32, 64)   # the backward kernels'; the VAE's d = 512 is frozen
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: Optional[float] = None, kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dense version: f32 softmax(scale·QKᵀ | mask)·V.

    q: (B, Sq, H, D); k, v: (B, Skv, H, D); kv_mask: optional (B, Skv) bool.
    Returns (out (B, Sq, H, D) in q's dtype, lse (B, Sq, H) f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float())
    lse = torch.where(l > 0, m_safe + torch.log(l_safe),
                      torch.full_like(l, float("-inf")))
    return out.to(q.dtype), lse[..., 0].permute(0, 2, 1)


def _check(q, k, v, kv_mask):
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"expected q (B,Sq,H,D), k/v (B,Skv,H,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel has no head dim {d} (built: {HEAD_DIMS})")
    if sq == 0 or k.shape[1] == 0 or b * h > 65535:
        raise ValueError(f"unsupported extent B={b} H={h} Sq={sq} Skv={k.shape[1]}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (B, S, H, D)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv_mask is not None:
        if (kv_mask.dtype != torch.bool or kv_mask.shape != (b, k.shape[1])
                or kv_mask.device != dev or not kv_mask.is_contiguous()):
            raise ValueError(f"kv_mask must be a contiguous (B, Skv) bool tensor "
                             f"on {dev}; got {kv_mask.dtype} {tuple(kv_mask.shape)}")


def _launch(q, k, v, scale, kv_mask):
    from diffews_tpu_torch.ops import _build

    _check(q, k, v, kv_mask)
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_mask is None else kv_mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), b, h, sq, k.shape[1], d,
                 _DTYPE_CODE[q.dtype], float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


@torch.library.custom_op("diffews_tpu_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor],
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel as a custom op: (out (B, Sq, H, D) like q, lse
    (B, Sq, H) f32), both contiguous.  CUDA: `_launch`; CPU: the plain
    version."""
    return _launch(q, k, v, scale, kv_mask)


@flash_attention_fwd.register_kernel("cpu")
def _flash_attention_fwd_cpu(q, k, v, kv_mask, scale):
    out, lse = flash_attention_reference(q, k, v, scale=scale, kv_mask=kv_mask)
    return out.contiguous(), lse.contiguous()


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, kv_mask, scale):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, sq, h), dtype=torch.float32))


def _requires_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _forward(q, k, v, scale, kv_mask):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale, kv_mask=kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return flash_attention_fwd(q, k, v, kv_mask, float(scale))


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: Optional[float] = None, kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention` that also returns the f32 log-sum-exp (B, Sq, H).

    Forward-only, as its JAX counterpart: on the card it raises when an
    input requires grad (the kernel's outputs carry no gradient); take
    gradients through `flash_attention`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda" and _requires_grad(q, k, v):
        raise RuntimeError("flash_attention_lse is forward-only: its inputs require "
                           "grad; use flash_attention for a differentiable call")
    return _forward(q, k, v, scale, kv_mask)


class _FlashAttention(torch.autograd.Function):
    """O = flash attention; backward through `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        out, lse = _forward(q, k, v, scale, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, scale=ctx.scale,
                                         kv_mask=kv_mask)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: Optional[float] = None, kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention over (B, Sq, H, D) queries and (B, Skv, H, D) keys and
    values.  kv_mask: optional (B, Skv) bool, True = attend.  Returns
    (B, Sq, H, D) in q's dtype; differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not _requires_grad(q, k, v):
        return _forward(q, k, v, scale, kv_mask)[0]
    if q.device.type == "cuda" and q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(f"flash attention has no backward kernel for head dim "
                         f"{q.shape[-1]} (built: {BWD_HEAD_DIMS}); run it without grad")
    return _FlashAttention.apply(q, k, v, kv_mask, float(scale))


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def flash_attention_bwd_reference(q, k, v, kv_mask, out, lse, g, scale):
    """Plain backward, written as the kernels' formula (not autograd through
    the dense forward): p = exp(scale·QKᵀ − LSE) with p = 0 for masked keys
    and for rows with LSE = -inf, dp = g·Vᵀ, δ = rowsum(O∘g),
    ds = p∘(dp − δ); dQ = scale·ds·K, dK = scale·dsᵀ·Q, dV = pᵀ·g, in f32.

    q, out, g: (B, Sq, H, D); k, v: (B, Skv, H, D); kv_mask: (B, Skv) bool
    or None; lse: (B, Sq, H) f32.  Returns (dq, dk, dv) in the input dtype."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    lse_t = lse.permute(0, 2, 1)[..., None]                # (B, H, Sq, 1)
    ok = torch.isfinite(lse_t).expand(s.shape)
    if kv_mask is not None:
        ok = ok & kv_mask[:, None, None, :]
    p = torch.where(ok, torch.exp(s - torch.where(torch.isfinite(lse_t), lse_t, 0.0)),
                    torch.zeros((), dtype=s.dtype, device=s.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (out.float() * gf).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, g, lse, out, kv_mask):
    _check(q, k, v, kv_mask)
    b, sq, h, d = q.shape
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash backward has no head dim {d} (built: {BWD_HEAD_DIMS})")
    for name, t in (("g", g), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {tuple(q.shape)} {q.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    if lse.shape != (b, sq, h) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous (B, Sq, H) float32 tensor; "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    for name, t in (("g", g), ("out", out), ("lse", lse)):
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned on {q.device}")


@functools.lru_cache(maxsize=None)
def _bwd_fn(name, n_ptr):
    from diffews_tpu_torch.ops import _build

    fn = getattr(_build.load("flash_attention_bwd"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
    return fn


def _bwd_plan(q, k):
    """(dq splits, dkv splits, Sq_pad) of the kernels at these extents: the
    split passes need f32 scratch; the row statistics are (2, B·H, Sq_pad)."""
    b, sq, h, _ = q.shape
    return _bwd_plan_at(b, h, sq, k.shape[1], _DTYPE_CODE[q.dtype], q.device)


@functools.lru_cache(maxsize=1024)
def _bwd_plan_at(b, h, sq, skv, dtype_code, device):
    from diffews_tpu_torch.ops import _build

    fn = _build.load("flash_attention_bwd").flash_attention_bwd_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = fn(b, h, sq, skv, dtype_code, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_plan failed: CUDA error {err}")
    return tuple(out)


def _bwd_launch(fn, name, ptrs, q, k, scale):
    b, sq, h, d = q.shape
    with torch.cuda.device(q.device):
        err = fn(*ptrs, b, h, sq, k.shape[1], d, _DTYPE_CODE[q.dtype], float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_bwd_dq(q, k, v, g, out, lse, *, scale: float,
                           kv_mask: Optional[torch.Tensor] = None):
    """dQ on the card (the dq kernel), from the forward's O (`out`) and LSE.
    Returns (dq, stats): stats, (2, B·H, Sq_pad) f32, holds each row's
    −LSE·log2(e) and δ = rowsum(O∘g) for the dkv pass
    (`flash_attention_bwd_dkv`).  The bf16 kernel computes δ itself; the f32
    kernel takes it from torch, as the plain version computes it, so f32
    gradients keep the plain path's rounding."""
    _check_bwd(q, k, v, g, lse, out, kv_mask)
    splits, _, sq_pad = _bwd_plan(q, k)
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    stats = torch.empty((2, b * h, sq_pad), dtype=torch.float32, device=q.device)
    work = (torch.empty((splits, b, sq, h, d), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    delta = (out.float() * g.float()).sum(-1) if q.dtype == torch.float32 else None
    _bwd_launch(_bwd_fn("flash_attention_bwd_dq", 11), "flash_attention_bwd_dq",
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
                 _ptr(delta), lse.data_ptr(), _ptr(kv_mask), dq.data_ptr(), stats.data_ptr(),
                 _ptr(work)), q, k, scale)
    flash_attention_bwd.dq_launches += 1
    return dq, stats


def flash_attention_bwd_dkv(q, k, v, g, stats, *, scale: float,
                            kv_mask: Optional[torch.Tensor] = None):
    """(dK, dV) on the card (the dkv kernel), from the row statistics that
    `flash_attention_bwd_dq` returned for the same call."""
    _check(q, k, v, kv_mask)
    _, splits, sq_pad = _bwd_plan(q, k)
    b, sq, h, d = q.shape
    if (stats.shape != (2, b * h, sq_pad) or stats.dtype != torch.float32
            or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be the (2, B·H, Sq_pad) float32 tensor of the dq "
                         f"pass; got {stats.dtype} {tuple(stats.shape)}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    work = (torch.empty((splits, 2, b, k.shape[1], h, d), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    _bwd_launch(_bwd_fn("flash_attention_bwd_dkv", 9), "flash_attention_bwd_dkv",
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), stats.data_ptr(),
                 _ptr(kv_mask), dk.data_ptr(), dv.data_ptr(), _ptr(work)),
                q, k, scale)
    flash_attention_bwd.dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, g, *, scale: float,
                        kv_mask: Optional[torch.Tensor] = None):
    """Gradients (dq, dk, dv) of `flash_attention` given the forward's O and
    LSE and the output gradient g; shapes as `flash_attention_bwd_reference`.
    A CUDA tensor launches the dq kernel (which, in bf16, also computes δ)
    and the dkv kernel, a CPU tensor takes the plain version."""
    g = g.contiguous()
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, kv_mask, out, lse, g, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention backward for device {q.device}")
    dq, stats = flash_attention_bwd_dq(q, k, v, g, out, lse, scale=scale, kv_mask=kv_mask)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, stats, scale=scale, kv_mask=kv_mask)
    return dq, dk, dv


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0
