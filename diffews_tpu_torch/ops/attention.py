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

`shot_parallel_fused_kv_attention` is the same attention with the support
shots sharded over a process group (JAX `attention.py:148-230`): each rank
attends over `[own ‖ its local shots]`, and one MAX and two SUM
`all_reduce`s of query-sized tensors merge the partial softmaxes exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from diffews_tpu_torch.ops.flash_attention import flash_attention, flash_attention_lse

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


def _dense_attention_lse(q, k, v, *, scale=None, kv_bias=None):
    """`dense_attention` that also returns the f32 log-sum-exp (B, Sq, H)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_bias is not None:
        logits = logits + kv_bias.float()
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(q.dtype), v)
    return out, (m + torch.log(l))[..., 0].permute(0, 2, 1)


def shot_parallel_fused_kv_attention(
    q: torch.Tensor,
    k_own: torch.Tensor,
    v_own: torch.Tensor,
    k_sup: torch.Tensor,
    v_sup: torch.Tensor,
    *,
    group,
    shot_mask: Optional[torch.Tensor] = None,
    support_bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """`fused_kv_attention` with the support shots sharded over `group`.

    Each rank holds its local shard of shots and computes a partial
    softmax over `[own ‖ local shots]`: the own tokens are biased to -1e9
    on every rank but rank 0 of the group, so they count once.  The exact
    result is the log-sum-exp merge

        out = Σ_i out_i·exp(lse_i − m) / Σ_i exp(lse_i − m),  m = max_i lse_i

    from one MAX `all_reduce` of the detached LSE and two SUM `all_reduce`s
    (numerator, denominator) of query-sized tensors.  A rank whose local
    shots are all padded has query rows with no valid key: the flash kernel
    gives them O = 0 and LSE = -inf, the dense path a -1e9-sized LSE, and
    either way their weight is exactly 0.

    q, k_own, v_own: (B, S, H, D), the same on every rank; k_sup, v_sup:
    (B, N_local, S_ref, H, D) this rank's shots; shot_mask: optional
    (B, N_local) bool; support_bias: optional (B, N_local*S_ref).
    impl: "dense" (differentiable: the sums go through
    `torch.distributed.nn.functional.all_reduce`, whose backward sums the
    gradients as JAX's psum does) or "flash"/"auto" (`flash_attention_lse`,
    forward only).  Returns (B, S, H, D), the same on every rank of the
    group."""
    b, s, h, d = q.shape
    n, s_ref = k_sup.shape[1], k_sup.shape[2]
    k = torch.cat([k_own, k_sup.reshape(b, n * s_ref, h, d)], dim=1)
    v = torch.cat([v_own, v_sup.reshape(b, n * s_ref, h, d)], dim=1)
    own = 0.0 if dist.get_rank(group) == 0 else NEG_INF
    bias = torch.full((b, s + n * s_ref), 0.0, dtype=torch.float32, device=q.device)
    bias[:, :s] = own
    if shot_mask is not None:
        token_ok = shot_mask.repeat_interleave(s_ref, dim=1)
        bias[:, s:] += torch.where(token_ok, 0.0, NEG_INF).float()
    if support_bias is not None:
        bias[:, s:] += support_bias.float()

    if impl == "auto":
        impl = "flash"
    if impl == "flash":
        # the same 0-or-very-negative -> boolean mask as fused_kv_attention
        out_i, lse_i = flash_attention_lse(q, k, v, scale=scale, kv_mask=bias >= -1e3)
        reduce_sum = _all_reduce_sum
    elif impl == "dense":
        out_i, lse_i = _dense_attention_lse(q, k, v, scale=scale,
                                            kv_bias=bias[:, None, None, :])
        reduce_sum = _all_reduce_sum_differentiable
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    shot_parallel_fused_kv_attention.merges += 1
    # a shift by any constant cancels in num/den, so the max carries no
    # gradient (JAX stops it too: pmax has no differentiation rule)
    lse_max = lse_i.detach().clone()
    dist.all_reduce(lse_max, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse_i - lse_max)
    num = reduce_sum(out_i.float() * w[..., None], group)
    den = reduce_sum(w, group)
    return (num / den[..., None]).to(q.dtype)


shot_parallel_fused_kv_attention.merges = 0


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_reduce_sum_differentiable(x: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


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
