"""Port parity: `diffews_tpu_torch.ops.fused_resnet` against
`diffews_tpu.ops.fused_resnet` on the CPU.

The same numpy inputs go through both, f32: `gn_silu_conv3x3` against the
JAX `_reference` (the kernel's arithmetic in XLA) at the JAX tests' shapes
plus the VAE heads' Cout = 3 and 8, and against the Pallas kernel in
interpret mode on one small case; `gn_affine` / `gn_stats`;
`fused_resnet_block` with a `conv_shortcut`; the statistics chain (a
chained block equals a fresh one); `fused_norm_conv_out`; and gradients
through the port's autograd Function against the JAX custom VJP.
Tolerances: outputs 2e-5 abs / 1e-5 rel, statistics 1e-5 rel of Σ|y| and
Σy², gradients 1e-4.  Weights are carried with `state_dict_from_jax` or
transposed from HWIO to the port's OIHW by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.models import layers as JL
from diffews_tpu.ops import fused_resnet as JF
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.models import layers as TL
from diffews_tpu_torch.ops import fused_resnet as TF
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(B, H, W, Cin, Cout, res, seed=0):
    """As `tests/test_fused_resnet.py::_inputs`; w is HWIO (JAX)."""
    r = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    x = f(r.normal(size=(B, H, W, Cin)))
    a = f(r.uniform(0.5, 1.5, (B, Cin)))
    b = f(r.uniform(-0.3, 0.3, (B, Cin)))
    w = f(r.normal(size=(3, 3, Cin, Cout)) * 0.05)
    bias = f(r.normal(size=(Cout,)) * 0.1)
    rr = f(r.normal(size=(B, H, W, Cout))) if res else None
    return x, a, b, w, bias, rr


def _port(x, a, b, w, bias, rr, **kw):
    t = lambda v: None if v is None else torch.from_numpy(v)
    return TF.gn_silu_conv3x3(t(x), t(a), t(b), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                              t(bias), t(rr), **kw)


def _stats_close(got, want, y):
    """Σ and Σ² within 1e-5 of Σ|y| and Σy² per (b, c)."""
    yf = np.asarray(y, np.float64)
    np.testing.assert_array_less(np.abs(np.asarray(got[0]) - np.asarray(want[0])),
                                 1e-5 * np.abs(yf).sum((1, 2)) + 1e-6)
    np.testing.assert_array_less(np.abs(np.asarray(got[1]) - np.asarray(want[1])),
                                 1e-5 * np.square(yf).sum((1, 2)) + 1e-6)


@pytest.mark.parametrize("shape", [
    (1, 16, 16, 128, 128, False),
    (2, 32, 16, 128, 256, True),   # Cin != Cout, batch, residual
    (1, 8, 8, 256, 128, True),
    (1, 16, 8, 32, 32, True),      # the tiny configs' widths
    (2, 16, 16, 32, 3, False),     # the decoder head
    (2, 8, 8, 64, 8, False),       # the encoder head
])
@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_matches_jax_reference(shape, impl):
    args = _inputs(*shape, seed=shape[1] + shape[4])
    want = JF._reference(*(None if v is None else jnp.asarray(v) for v in args))
    with torch.no_grad():
        got = _port(*args, impl=impl)
    assert got[0].shape == shape[:3] + (shape[4],) and got[1].shape == (shape[0], shape[4])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    _stats_close([s.numpy() for s in got[1:]], want[1:], want[0])


def test_matches_jax_pallas_interpret():
    """The JAX package's megakernel, interpreted on the CPU."""
    args = _inputs(1, 16, 8, 32, 32, True, seed=11)
    want = JF.gn_silu_conv3x3(*(None if v is None else jnp.asarray(v) for v in args),
                              impl="pallas")
    with torch.no_grad():
        got = _port(*args)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    _stats_close([s.numpy() for s in got[1:]], want[1:], want[0])


def test_gn_affine_and_stats_match_jax():
    r = np.random.default_rng(12)
    x = r.normal(size=(2, 6, 5, 32)).astype(np.float32) + 0.5
    scale = r.uniform(0.5, 1.5, (32,)).astype(np.float32)
    bias = (r.normal(size=(32,)) * 0.1).astype(np.float32)
    js = JF.gn_stats(jnp.asarray(x))
    ts = TF.gn_stats(torch.from_numpy(x))
    _stats_close([t.numpy() for t in ts], js, x)
    ja = JF.gn_affine(*js, jnp.asarray(scale), jnp.asarray(bias), groups=8, n=6 * 5 * 4,
                      eps=1e-6)
    ta = TF.gn_affine(*ts, torch.from_numpy(scale), torch.from_numpy(bias), groups=8,
                      n=6 * 5 * 4, eps=1e-6)
    for t, j in zip(ta, ja):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _block(cin, cout, seed):
    """A JAX resnet param tree with non-trivial norms, and the port's block
    carrying it."""
    r = np.random.default_rng(seed)
    f = lambda *s: np.asarray(r.normal(size=s), np.float32)
    p = {"norm1": {"scale": 1 + 0.2 * f(cin), "bias": 0.1 * f(cin)},
         "conv1": {"kernel": 0.05 * f(3, 3, cin, cout), "bias": 0.1 * f(cout)},
         "norm2": {"scale": 1 + 0.2 * f(cout), "bias": 0.1 * f(cout)},
         "conv2": {"kernel": 0.05 * f(3, 3, cout, cout), "bias": 0.1 * f(cout)}}
    if cin != cout:
        p["conv_shortcut"] = {"kernel": 0.1 * f(1, 1, cin, cout), "bias": 0.1 * f(cout)}
    blk = TL.ResnetBlock2D(cin, cout, None, groups=8, eps=1e-6)
    blk.load_state_dict(state_dict_from_jax(p), strict=True)
    return p, blk


@pytest.mark.parametrize("cin,cout", [(32, 64), (32, 32)])
def test_fused_resnet_block_matches_jax(cin, cout):
    p, blk = _block(cin, cout, seed=cin + cout)
    x = np.random.default_rng(13).normal(size=(2, 16, 16, cin)).astype(np.float32)
    want, wst = JF.fused_resnet_block(p, jnp.asarray(x), None, groups=8, eps=1e-6)
    with torch.no_grad():
        got, gst = TF.fused_resnet_block(blk, torch.from_numpy(x), None, groups=8, eps=1e-6)
        plain = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _stats_close([s.numpy() for s in gst], wst, want)
    # and the plain resnet block (JAX `layers.resnet_block`)
    np.testing.assert_allclose(plain.numpy(), np.asarray(
        JL.resnet_block(p, jnp.asarray(x), None, groups=8, eps=1e-6)), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_stats_chain_equals_fresh():
    """Two chained blocks equal the second block started from fresh
    statistics of the first one's output (the JAX chain test)."""
    (_, b1), (_, b2) = _block(32, 32, seed=1), _block(32, 32, seed=2)
    x = torch.from_numpy(np.random.default_rng(14).normal(size=(1, 16, 16, 32)).astype(
        np.float32))
    with torch.no_grad():
        h1, st = TF.fused_resnet_block(b1, x, None, groups=8, eps=1e-6, impl="pallas")
        chained, _ = TF.fused_resnet_block(b2, h1, st, groups=8, eps=1e-6, impl="pallas")
        fresh, _ = TF.fused_resnet_block(b2, h1, None, groups=8, eps=1e-6, impl="pallas")
    np.testing.assert_allclose(chained.numpy(), fresh.numpy(), **TOL)
    _stats_close([s.numpy() for s in st], [s.numpy() for s in TF.gn_stats(h1)], h1.numpy())


@pytest.mark.parametrize("cout", [3, 8])
def test_fused_norm_conv_out_matches_jax(cout):
    r = np.random.default_rng(15 + cout)
    c = 32
    pn = {"scale": r.uniform(0.5, 1.5, (c,)).astype(np.float32),
          "bias": (r.normal(size=(c,)) * 0.1).astype(np.float32)}
    pc = {"kernel": (r.normal(size=(3, 3, c, cout)) * 0.05).astype(np.float32),
          "bias": (r.normal(size=(cout,)) * 0.1).astype(np.float32)}
    x = r.normal(size=(2, 16, 16, c)).astype(np.float32)
    want = JF.fused_norm_conv_out(pn, pc, jnp.asarray(x), None, groups=8, eps=1e-6)
    norm, conv = TL.GroupNorm(8, c, 1e-6), TL.Conv2d(c, cout, 3, padding=1)
    norm.load_state_dict(state_dict_from_jax(pn))
    conv.load_state_dict(state_dict_from_jax(pc))
    with torch.no_grad():
        got = TF.fused_norm_conv_out(norm, conv, torch.from_numpy(x), None, groups=8, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gradients_match_jax_custom_vjp():
    """Grads for x, b, w and the residual through the autograd Function
    (y, s1 and s2 all in the loss) against the JAX custom VJP."""
    x, a, b, w, bias, rr = _inputs(1, 8, 8, 32, 32, True)

    def loss(y, s1, s2):
        return (y ** 2).sum() + s1.sum() * 0.1 + s2.sum() * 0.01

    def jloss(x, a, b, w, bias, rr):
        return loss(*JF.gn_silu_conv3x3(x, a, b, w, bias, rr, impl="pallas"))

    want = jax.grad(jloss, argnums=(0, 2, 3, 5))(
        *(jnp.asarray(v) for v in (x, a, b, w, bias, rr)))
    xt, bt, rt = (torch.from_numpy(v).requires_grad_() for v in (x, b, rr))
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    out = TF.gn_silu_conv3x3(xt, torch.from_numpy(a), bt, wt, torch.from_numpy(bias), rt)
    assert "GnSiluConv3x3" in type(out[0].grad_fn).__name__
    loss(*out).backward()
    got = (xt.grad, bt.grad, wt.grad.permute(2, 3, 1, 0), rt.grad)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **GRAD_TOL)


def test_cpu_launches_no_kernel_and_rejects_unknown_impl():
    args = _inputs(1, 8, 8, 16, 16, False)
    before = TF.gn_silu_conv3x3.launches
    with torch.no_grad():
        _port(*args, impl="pallas")
    assert TF.gn_silu_conv3x3.launches == before
    with pytest.raises(ValueError, match="impl"):
        _port(*args, impl="cudnn")
