"""Multi-head attention ops, including the KV-fusion (concat-KV) form.

Port of `diffews_tpu/ops/attention.py`.  Query tokens attend over
`[own K/V ‖ shot-folded support K/V]`, own tokens first
(`attention.py:91-92`, the reference's `attention_processor.py:258,267`).
Operands are (B, S, H, D).

`fused_kv_attention(impl=...)`:
  - "flash" (and "auto"): `ops.flash_attention`, the CUDA kernel on the
    card and its plain version on the CPU.  The additive key bias (padded
    shots -1e9, the attn-mask variant's -1e4) becomes a boolean mask at
    `>= -1e3`, as on the TPU kernel path (`attention.py:114-120`).
  - "dense": plain torch with the additive bias (the JAX "xla" path).
"""

from __future__ import annotations

from typing import Optional

import torch

from diffews_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -1e9


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None,
                    kv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention in plain torch ops: f32 logits and softmax, probabilities
    cast to q's dtype before the product with V.

    q: (B, Sq, H, D); k, v: (B, Skv, H, D); kv_bias broadcastable to
    (B, H, Sq, Skv).  Returns (B, Sq, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_bias is not None:
        logits = logits + kv_bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def fused_kv_attention(
    q: torch.Tensor,
    k_own: torch.Tensor,
    v_own: torch.Tensor,
    k_sup: Optional[torch.Tensor],
    v_sup: Optional[torch.Tensor],
    *,
    shot_mask: Optional[torch.Tensor] = None,
    support_bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention over [own tokens ‖ support tokens].

    q, k_own, v_own: (B, S, H, D).  k_sup, v_sup: (B, N, S_ref, H, D) or None
    (plain self-attention).  shot_mask: optional (B, N) bool, False marks a
    padded shot.  support_bias: optional (B, N*S_ref) additive bias on the
    support keys.  Returns (B, S, H, D)."""
    b, s, h, d = q.shape
    bias = None
    if k_sup is None:
        k, v = k_own, v_own
    else:
        n, s_ref = k_sup.shape[1], k_sup.shape[2]
        k = torch.cat([k_own, k_sup.reshape(b, n * s_ref, h, d)], dim=1)
        v = torch.cat([v_own, v_sup.reshape(b, n * s_ref, h, d)], dim=1)
        sup_bias = None
        if shot_mask is not None:
            token_ok = shot_mask.repeat_interleave(s_ref, dim=1)
            sup_bias = torch.where(token_ok, 0.0, NEG_INF).float()
        if support_bias is not None:
            sb = support_bias.float()
            sup_bias = sb if sup_bias is None else sup_bias + sb
        if sup_bias is not None:
            own = torch.zeros((b, s), dtype=torch.float32, device=q.device)
            bias = torch.cat([own, sup_bias], dim=1)  # (B, Skv)

    if impl == "auto":
        impl = "flash"
    if impl == "dense":
        return dense_attention(
            q, k, v, scale=scale,
            kv_bias=None if bias is None else bias[:, None, None, :])
    if impl == "flash":
        # bias values are 0 or very negative (-1e9 padding, -1e4 mask
        # bias): both give exp() == 0 in f32, so a boolean mask is the
        # same function
        kv_mask = None if bias is None else bias >= -1e3
        return flash_attention(q, k, v, scale=scale, kv_mask=kv_mask)
    raise ValueError(f"unknown attention impl {impl!r}")


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-attention onto the text context (2 or 77 tokens): dense.

    key_mask: optional (B, Skv) bool, True keeps a context token."""
    bias = None
    if key_mask is not None:
        bias = torch.where(key_mask, 0.0, NEG_INF).float()[:, None, None, :]
    return dense_attention(q, k, v, scale=scale, kv_bias=bias)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)
