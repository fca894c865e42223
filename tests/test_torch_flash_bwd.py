"""Port parity: the flash-attention backward on the CPU.

The port's plain backward (`flash_attention_bwd_reference`) and autograd
through its `flash_attention` (one `torch.autograd.Function`, whose CPU
backward is that plain version) against `jax.vjp` through the JAX
`flash_attention`, whose custom VJP runs the Pallas backward kernels
`_bwd_dq_kernel` / `_bwd_dkv_kernel` in interpret mode (as
`tests/test_flash_attention.py` runs them).  f32 to 1e-4; bf16 inputs
within 3e-2 of max |grad| (`test_flash_attention.py:78-107`).  Also the
repair of a silent fault: gradients reach q, k and v through
`fused_kv_attention(impl="auto")`; and the plain backward against the
Pallas backward at the mask and extent patterns the CUDA kernels' tiles
meet (whole 64- and 128-key tiles masked, tails, a row with no valid key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.ops import attention as JA
from diffews_tpu.ops import flash_attention as JF
from diffews_tpu_torch.ops import attention as TA
from diffews_tpu_torch.ops import flash_attention as TF
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(x)).to(dtype).requires_grad_(grad)


def _jax_vjp(fn, args, g):
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(a, np.float32) for a in vjp(g)]


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_pallas_kernels(d, masked):
    b, sq, skv, h = 2, 37, 53, 2
    q, k, v, g = _x(b, sq, h, d, seed=1), _x(b, skv, h, d, seed=2), _x(b, skv, h, d, seed=3), \
        _x(b, sq, h, d, seed=4)
    mask = (np.random.default_rng(5).random((b, skv)) > 0.3) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want = _jax_vjp(lambda q, k, v: JF.flash_attention(q, k, v, kv_mask=jm),
                    [jnp.asarray(a) for a in (q, k, v)], jnp.asarray(g))
    tm = None if mask is None else _t(mask, torch.bool)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = TF.flash_attention(tq, tk, tv, kv_mask=tm)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    _, lse = TF.flash_attention_reference(tq.detach(), tk.detach(), tv.detach(), kv_mask=tm)
    plain = TF.flash_attention_bwd_reference(tq.detach(), tk.detach(), tv.detach(), tm,
                                             out.detach(), lse, _t(g), d ** -0.5)
    for a, p, w in zip(got, plain, want):
        assert torch.equal(a, p)  # the CPU backward is the plain version
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-4)


def test_bf16_backward_matches_pallas_kernels():
    b, sq, skv, h, d = 1, 40, 72, 2, 64
    arrs = [_x(b, sq, h, d, seed=6), _x(b, skv, h, d, seed=7), _x(b, skv, h, d, seed=8)]
    g = _x(b, sq, h, d, seed=9)
    mask = np.random.default_rng(10).random((b, skv)) > 0.2
    want = _jax_vjp(lambda q, k, v: JF.flash_attention(q, k, v, kv_mask=jnp.asarray(mask)),
                    [jnp.asarray(a, jnp.bfloat16) for a in arrs], jnp.asarray(g, jnp.bfloat16))
    ts = [_t(a, torch.bfloat16, grad=True) for a in arrs]
    out = TF.flash_attention(*ts, kv_mask=_t(mask, torch.bool))
    got = torch.autograd.grad(out, ts, _t(g, torch.bfloat16))
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        err = np.abs(a.float().numpy() - w).max()
        assert err <= 3e-2 * np.abs(w).max(), err


@pytest.mark.parametrize("case", ["shot_mask", "support_bias", "both"])
def test_fused_kv_attention_grads_match_pallas(case):
    b, n, s, h, d = 2, 3, 16, 2, 16
    q, ko, vo = (_x(b, s, h, d, seed=i) for i in (11, 12, 13))
    ks, vs = _x(b, n, s, h, d, seed=14), _x(b, n, s, h, d, seed=15)
    g = _x(b, s, h, d, seed=16)
    sm = (np.array([[True, True, False], [True, True, True]])
          if case in ("shot_mask", "both") else None)
    sb = ((1.0 - (np.random.default_rng(17).random((b, n * s)) > 0.4)) * -1e4
          ).astype(np.float32) if case in ("support_bias", "both") else None
    opt = lambda a, f: None if a is None else f(a)
    want = _jax_vjp(
        lambda *a: JA.fused_kv_attention(*a, shot_mask=opt(sm, jnp.asarray),
                                         support_bias=opt(sb, jnp.asarray), impl="pallas"),
        [jnp.asarray(a) for a in (q, ko, vo, ks, vs)], jnp.asarray(g))
    ts = [_t(a, grad=True) for a in (q, ko, vo, ks, vs)]
    out = TA.fused_kv_attention(*ts, shot_mask=opt(sm, lambda a: _t(a, torch.bool)),
                                support_bias=opt(sb, _t), impl="auto")
    got = torch.autograd.grad(out, ts, _t(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-4)


def test_gradients_reach_qkv_through_fused_kv_attention():
    """The repaired fault: every gradient through self-attention reaches
    q, k and v (and the padded shot's keys get none)."""
    b, n, s, h, d = 1, 2, 12, 2, 16
    ts = [_t(_x(*sh, seed=20 + i), grad=True)
          for i, sh in enumerate([(b, s, h, d)] * 3 + [(b, n, s, h, d)] * 2)]
    out = TA.fused_kv_attention(*ts, shot_mask=torch.tensor([[True, False]]), impl="auto")
    grads = torch.autograd.grad(out.square().sum(), ts)
    for gr in grads:
        assert gr is not None and torch.isfinite(gr).all() and gr.abs().sum() > 0
    assert torch.all(grads[3][0, 1] == 0) and torch.all(grads[4][0, 1] == 0)
    dense = torch.autograd.grad(TA.fused_kv_attention(
        *ts, shot_mask=torch.tensor([[True, False]]), impl="dense").square().sum(), ts)
    for a, w in zip(grads, dense):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_masked_keys_and_empty_rows():
    """Masked keys get dK = dV = 0 exactly; a row with no valid key gets a
    finite, zero dQ (and gives nothing to dK/dV)."""
    b, sq, skv, h, d = 2, 9, 14, 2, 16
    q, k, v, g = (_t(_x(*sh, seed=30 + i)) for i, sh in
                  enumerate([(b, sq, h, d), (b, skv, h, d), (b, skv, h, d), (b, sq, h, d)]))
    mask = torch.from_numpy(np.random.default_rng(34).random((b, skv)) > 0.5)
    mask[1] = False
    out, lse = TF.flash_attention_reference(q, k, v, kv_mask=mask)
    dq, dk, dv = TF.flash_attention_bwd_reference(q, k, v, mask, out, lse, g, d ** -0.5)
    dead = ~mask[:, :, None, None].expand_as(dk)
    assert torch.all(dk[dead] == 0) and torch.all(dv[dead] == 0)
    assert torch.all(dq[1] == 0) and torch.isfinite(dq).all()
    assert torch.all(dk[1] == 0) and torch.all(dv[1] == 0)


def test_forward_only_entry_and_no_grad_paths_stay_plain():
    """`flash_attention_lse` and calls without grad take the plain forward
    (no autograd node); with grad the output carries one."""
    q = _t(_x(1, 6, 1, 16, seed=40), grad=True)
    assert TF.flash_attention(q, q, q).grad_fn is not None
    with torch.no_grad():
        assert TF.flash_attention(q, q, q).grad_fn is None
    o, lse = TF.flash_attention_lse(q.detach(), q.detach(), q.detach())
    assert o.grad_fn is None and lse.dtype == torch.float32


@pytest.mark.parametrize("bad", ["head_dim", "g_shape", "g_dtype", "g_noncontig", "lse_shape",
                                 "lse_dtype", "out_shape"])
def test_backward_wrapper_rejects(bad):
    """The backward kernels' checks (shared by every dq/dkv launch) refuse
    what the kernels do not take, such as the VAE's d = 512."""
    d = 512 if bad == "head_dim" else 64
    q = torch.zeros(1, 8, 2, d)
    k = v = torch.zeros(1, 12, 2, d)
    g = torch.zeros(1, 8, 2, d)
    out = torch.zeros(1, 8, 2, d)
    lse = torch.zeros(1, 8, 2)
    if bad == "g_shape":
        g = torch.zeros(1, 9, 2, d)
    elif bad == "g_dtype":
        g = g.bfloat16()
    elif bad == "g_noncontig":
        g = torch.zeros(1, 2, 8, d).transpose(1, 2)
    elif bad == "lse_shape":
        lse = torch.zeros(1, 2, 8)
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "out_shape":
        out = torch.zeros(1, 8, 2, d // 2)
    with pytest.raises(ValueError):
        TF._check_bwd(q, k, v, g, lse, out, None)
    if bad == "head_dim":
        return
    TF._check_bwd(q, k, v, torch.zeros(1, 8, 2, d), torch.zeros(1, 8, 2), torch.zeros(1, 8, 2, d),
                  None)  # the same call with every argument right passes


def _mask_pattern(b, skv, pattern):
    m = np.ones((b, skv), bool)
    if pattern == "tile64":      # one whole 64-key tile masked
        m[:, 64:128] = False
    elif pattern == "tile128":   # one whole 128-key tile masked, and the tail
        m[:, 128:256] = False
        m[:, 290:] = False
    elif pattern == "partial":   # set partly inside every tile
        m &= np.random.default_rng(50).random((b, skv)) > 0.5
        m[:, 0] = True
    elif pattern == "empty_row":  # batch row 1 has no valid key
        m[:, 200:] = False
        m[1] = False
    return m


@pytest.mark.parametrize("sq,skv", [(70, 300), (130, 193)])
@pytest.mark.parametrize("pattern", ["tile64", "tile128", "partial", "empty_row"])
def test_plain_backward_at_tile_patterns(sq, skv, pattern):
    """The plain backward, which the kernels are held to on the card,
    against the Pallas backward (`_flash_backward` through the JAX custom
    VJP, interpret mode) at the patterns the kernels' tile skipping touches:
    whole 64- and 128-key tiles masked, Sq and Skv off the kernels' tile
    multiples, a row with no valid key.  Such a row differs by design: the
    JAX kernels add a -1e30 bias (uniform weights over the masked keys),
    the port gives p = 0 exactly (dQ = 0, nothing to dK / dV), so that batch
    row is held to the port's rule and the others to JAX."""
    b, h, d = 2, 2, 16
    q, g = _x(b, sq, h, d, seed=51), _x(b, sq, h, d, seed=52)
    k, v = _x(b, skv, h, d, seed=53), _x(b, skv, h, d, seed=54)
    mask = _mask_pattern(b, skv, pattern)
    want = _jax_vjp(lambda q, k, v: JF.flash_attention(q, k, v, kv_mask=jnp.asarray(mask)),
                    [jnp.asarray(a) for a in (q, k, v)], jnp.asarray(g))
    tq, tk, tv, tg = (_t(a) for a in (q, k, v, g))
    tm = _t(mask, torch.bool)
    out, lse = TF.flash_attention_reference(tq, tk, tv, kv_mask=tm)
    got = TF.flash_attention_bwd_reference(tq, tk, tv, tm, out, lse, tg, d ** -0.5)
    rows = [1] if pattern == "empty_row" else []
    keep = [i for i in range(b) if i not in rows]
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy()[keep], w[keep], rtol=1e-4, atol=1e-4)
    dead = ~tm[:, :, None, None].expand_as(got[1])
    assert torch.all(got[1][dead] == 0) and torch.all(got[2][dead] == 0)
    for i in rows:
        assert torch.all(got[0][i] == 0) and torch.all(got[1][i] == 0) and torch.all(got[2][i] == 0)
