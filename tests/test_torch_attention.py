"""Port parity: `diffews_tpu_torch.ops.attention` / `ops.flash_attention`.

Dense and KV-fused attention against the JAX ops; the flash kernel's plain
version against the JAX Pallas kernel run in interpret mode on the CPU (as
`tests/test_flash_attention.py` runs it), at prime and odd extents.
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


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("with_bias", [False, True])
def test_dense_attention(with_bias):
    q, k, v = _x(2, 12, 3, 16, seed=1), _x(2, 20, 3, 16, seed=2), _x(2, 20, 3, 16, seed=3)
    bias = (np.where(np.random.default_rng(4).random((2, 20)) > 0.3, 0.0, -1e9)
            .astype(np.float32)[:, None, None, :] if with_bias else None)
    got = TA.dense_attention(_t(q), _t(k), _t(v), kv_bias=None if bias is None else _t(bias))
    want = JA.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_bias=None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("case", ["plain", "shot_mask", "support_bias", "both"])
def test_fused_kv_attention(impl, case):
    b, n, s, h, d = 2, 3, 16, 2, 16
    q, ko, vo = (_x(b, s, h, d, seed=i) for i in (5, 6, 7))
    ks, vs = _x(b, n, s, h, d, seed=8), _x(b, n, s, h, d, seed=9)
    shot_mask = (np.array([[True, True, False], [True, True, True]])
                 if case in ("shot_mask", "both") else None)
    sup_bias = ((1.0 - (np.random.default_rng(10).random((b, n * s)) > 0.4)) * -1e4
                ).astype(np.float32) if case in ("support_bias", "both") else None
    got = TA.fused_kv_attention(
        _t(q), _t(ko), _t(vo), _t(ks), _t(vs),
        shot_mask=None if shot_mask is None else _t(shot_mask),
        support_bias=None if sup_bias is None else _t(sup_bias), impl=impl)
    want = JA.fused_kv_attention(
        jnp.asarray(q), jnp.asarray(ko), jnp.asarray(vo), jnp.asarray(ks), jnp.asarray(vs),
        shot_mask=None if shot_mask is None else jnp.asarray(shot_mask),
        support_bias=None if sup_bias is None else jnp.asarray(sup_bias), impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fused_kv_padded_shot_equals_dropped_shot():
    b, n, s, h, d = 1, 3, 16, 2, 16
    q, ko, vo = (_x(b, s, h, d, seed=i) for i in (11, 12, 13))
    ks, vs = _x(b, n, s, h, d, seed=14), _x(b, n, s, h, d, seed=15)
    padded = TA.fused_kv_attention(_t(q), _t(ko), _t(vo), _t(ks), _t(vs),
                                   shot_mask=torch.tensor([[True, False, True]]))
    dropped = TA.fused_kv_attention(_t(q), _t(ko), _t(vo), _t(ks[:, [0, 2]]),
                                    _t(vs[:, [0, 2]]))
    np.testing.assert_allclose(padded.numpy(), dropped.numpy(), rtol=1e-6, atol=1e-6)


def test_cross_attention_key_mask():
    q, k, v = _x(2, 10, 2, 8, seed=16), _x(2, 4, 2, 8, seed=17), _x(2, 4, 2, 8, seed=18)
    km = np.array([[True, True, False, True], [True, False, False, True]])
    got = TA.cross_attention(_t(q), _t(k), _t(v), key_mask=_t(km))
    want = JA.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              key_mask=jnp.asarray(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,skv,d,masked", [
    (96, 112, 80, False), (97, 101, 64, True), (64, 160, 48, False), (61, 127, 16, True)])
def test_flash_reference_matches_pallas_kernel(sq, skv, d, masked):
    """The plain version against the TPU kernel in interpret mode: O to
    2e-4, LSE to 1e-4; the CPU path launches no kernel."""
    b, h = 2, 2
    q, k, v = _x(b, sq, h, d, seed=21), _x(b, skv, h, d, seed=22), _x(b, skv, h, d, seed=23)
    mask = (np.random.default_rng(24).random((b, skv)) > 0.3) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want_o, want_l = JF.flash_attention_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            kv_mask=jm)
    want_o2 = JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jm)
    before = TF.flash_attention.launches
    got_o, got_l = TF.flash_attention_lse(_t(q), _t(k), _t(v),
                                          kv_mask=None if mask is None else _t(mask))
    got_o2 = TF.flash_attention(_t(q), _t(k), _t(v), kv_mask=None if mask is None else _t(mask))
    assert TF.flash_attention.launches == before
    assert got_l.shape == (b, sq, h) and got_l.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_o2.numpy(), np.asarray(want_o2), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-4, atol=1e-4)


def test_flash_reference_bf16_output_dtype():
    q, k, v = (_t(_x(1, 9, 1, 16, seed=s)).bfloat16() for s in (31, 32, 33))
    o, lse = TF.flash_attention_reference(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


def test_flash_reference_row_without_valid_key():
    """A query row with every key masked: O = 0 and LSE = -inf (never NaN)."""
    q, k, v = (_t(_x(2, 5, 2, 16, seed=s)) for s in (34, 35, 36))
    mask = torch.tensor([[False] * 5, [True, False, True, True, False]])
    o, lse = TF.flash_attention_reference(q, k, v, kv_mask=mask)
    assert torch.all(o[0] == 0) and torch.all(torch.isneginf(lse[0]))
    assert torch.isfinite(o[1]).all() and torch.isfinite(lse[1]).all()


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed_dtype", "noncontig",
                                 "mask_dtype", "mask_shape", "kv_shape"])
def test_kernel_wrapper_rejects(bad):
    """The kernel wrapper's checks (shared by every CUDA launch) refuse what
    the kernel does not take."""
    q = torch.zeros(1, 8, 2, 64)
    k = v = torch.zeros(1, 12, 2, 64)
    mask = None
    if bad == "head_dim":
        q, k, v = (torch.zeros(t.shape[:-1] + (80,)) for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "noncontig":
        q = torch.zeros(1, 2, 8, 64).transpose(1, 2)
    elif bad == "mask_dtype":
        mask = torch.ones(1, 12, dtype=torch.int8)
    elif bad == "mask_shape":
        mask = torch.ones(1, 11, dtype=torch.bool)
    elif bad == "kv_shape":
        v = torch.zeros(1, 13, 2, 64)
    with pytest.raises((ValueError, TypeError)):
        TF._check(q, k, v, mask)


def test_split_merge_heads_roundtrip():
    x = _t(_x(2, 7, 24, seed=40))
    s = TA.split_heads(x, 3)
    assert s.shape == (2, 7, 3, 8)
    np.testing.assert_array_equal(s.numpy(), np.asarray(JA.split_heads(jnp.asarray(x.numpy()), 3)))
    assert torch.equal(TA.merge_heads(s), x)
