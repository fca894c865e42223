"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Port of `diffews_tpu/ops/flash_attention.py` (`flash_attention` and
`flash_attention_lse`, whose Pallas kernel is `_flash_kernel`).  DiffewS
query tokens attend over `[own ‖ n-shot support]` keys, so at 512px the
UNet's 64x64 level runs Sq = 4096 against Skv = 4096·(1+n); the VAE mid
block runs one head with d = 512.  The kernel
(`ops/csrc/flash_attention_fwd.cu`) streams K/V tiles through shared
memory with an online softmax and never writes the (Sq, Skv) probabilities
to device memory; bf16 runs on the tensor cores, f32 on the FMA pipes.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
`flash_attention_reference`, the plain dense f32 softmax with the same
boolean mask and the same LSE.  There is no fallback from the kernel.
`flash_attention.launches` counts kernel launches (both entry points).

Masked keys get exactly zero weight; a query row with no valid key gets
O = 0 and LSE = -inf (the main path never builds one: every query row
keeps its own tokens).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

HEAD_DIMS = (16, 32, 64, 512)  # the kernel's instantiations
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


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: Optional[float] = None, kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention` that also returns the f32 log-sum-exp (B, Sq, H)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale, kv_mask=kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _launch(q, k, v, scale, kv_mask)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: Optional[float] = None, kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention over (B, Sq, H, D) queries and (B, Skv, H, D) keys and
    values.  kv_mask: optional (B, Skv) bool, True = attend.  Returns
    (B, Sq, H, D) in q's dtype."""
    return flash_attention_lse(q, k, v, scale=scale, kv_mask=kv_mask)[0]


flash_attention.launches = 0
