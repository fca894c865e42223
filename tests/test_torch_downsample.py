"""Port parity: `diffews_tpu_torch.ops.downsample` against
`diffews_tpu.ops.downsample` on the CPU.

The same numpy inputs go through both: the port's plain version (what
`downsample_conv2x` takes for a CPU tensor) against the JAX `_xla_reference`
and against the Pallas kernel in interpret mode, f32 at 2e-5 abs / 1e-5 rel;
bf16 within one bf16 ulp of the f32 result (f32 accumulation, one
rounding); gradients of Σy² for x, w and bias through the port's autograd
Function against the JAX custom VJP at 1e-4; and the inputs the op
refuses.  Weights go from JAX's HWIO to the port's OIHW by
`transpose(3, 2, 0, 1)`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.ops import downsample as JD
from diffews_tpu_torch.ops import downsample as TD
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(B, H, W, Cin, Cout, seed=0):
    """x NHWC, w HWIO (JAX), bias; f32."""
    r = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return (f(r.normal(size=(B, H, W, Cin))), f(r.normal(size=(3, 3, Cin, Cout)) * 0.2),
            f(r.normal(size=(Cout,))))


def _port(x, w, bias, impl="auto", dtype=torch.float32):
    return TD.downsample_conv2x(torch.from_numpy(x).to(dtype),
                                torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(dtype),
                                torch.from_numpy(bias).to(dtype), impl)


SHAPES = [(2, 16, 16, 8, 8), (1, 8, 12, 16, 32), (3, 4, 6, 8, 24), (1, 2, 2, 4, 4),
          (2, 32, 16, 32, 16)]


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_jax_xla_reference(shape, impl):
    x, w, bias = _inputs(*shape, seed=sum(shape))
    want = JD._xla_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    with torch.no_grad():
        got = _port(x, w, bias, impl)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[4])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 8), (1, 8, 16, 8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_matches_jax_pallas_interpret(shape):
    """The JAX package's kernel, interpreted on the CPU."""
    x, w, bias = _inputs(*shape, seed=7)
    want = JD.downsample_conv2x(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), "interpret")
    with torch.no_grad():
        got = _port(x, w, bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_padding_is_bottom_and_right_only():
    """Output (0, 0) reads rows and columns 0..2 of x, no padding; the last
    output row and column read one row and column of zeros."""
    x, w, bias = _inputs(1, 4, 4, 4, 4, seed=3)
    with torch.no_grad():
        got = _port(x, w, bias).numpy()
    want00 = np.einsum("hwk,hwkn->n", x[0, :3, :3], w) + bias
    xp = np.pad(x[0], ((0, 1), (0, 1), (0, 0)))
    want11 = np.einsum("hwk,hwkn->n", xp[2:5, 2:5], w) + bias
    np.testing.assert_allclose(got[0, 0, 0], want00, **TOL)
    np.testing.assert_allclose(got[0, 1, 1], want11, **TOL)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 8), (1, 8, 12, 16, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_is_one_rounding_of_the_f32_result(shape):
    """bf16 inputs: f32 accumulation and one rounding, so the output is
    within one bf16 ulp of the f32 result on the same (bf16-valued) inputs,
    and equals the JAX op on them."""
    x, w, bias = _inputs(*shape, seed=11)
    rb = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    x, w, bias = rb(x), rb(w), rb(bias)
    with torch.no_grad():
        got = _port(x, w, bias, dtype=torch.bfloat16)
        f32 = _port(x, w, bias).numpy()
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.frexp(f32)[1] - 8.0)   # bf16 keeps 8 significant bits
    assert (np.abs(got.float().numpy() - f32) <= ulp).all()
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = JD._xla_reference(jb(x), jb(w), jb(bias))
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert (diff <= ulp).all()


def test_gradients_match_jax_custom_vjp():
    x, w, bias = _inputs(2, 16, 16, 8, 8, seed=7)

    def jloss(x, w, b):
        return (JD.downsample_conv2x(x, w, b, "interpret") ** 2).sum()

    want = jax.grad(jloss, (0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = TD.downsample_conv2x(xt, wt, bt)
    assert "DownsampleConv2x" in type(y.grad_fn).__name__
    (y ** 2).sum().backward()
    got = (xt.grad, wt.grad.permute(2, 3, 1, 0), bt.grad)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **GRAD_TOL)


def test_gradient_for_x_alone():
    """Frozen weights (the VAE in training): only x gets a gradient."""
    x, w, bias = _inputs(1, 8, 8, 8, 8, seed=5)
    want = jax.grad(lambda x: (JD._xla_reference(x, jnp.asarray(w), jnp.asarray(bias)) ** 2
                               ).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    (TD.downsample_conv2x(xt, wt, torch.from_numpy(bias)) ** 2).sum().backward()
    assert wt.grad is None
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **GRAD_TOL)


def test_cpu_launches_no_kernel():
    x, w, bias = _inputs(1, 8, 8, 8, 8)
    before = TD.downsample_conv2x.launches
    with torch.no_grad():
        _port(x, w, bias, "pallas")
    assert TD.downsample_conv2x.launches == before


@pytest.mark.parametrize("impl", ["interpret", "cudnn"])
def test_rejects_unknown_impl(impl):
    """"interpret" names the Pallas interpreter and means nothing here."""
    with pytest.raises(ValueError, match="impl"):
        _port(*_inputs(1, 8, 8, 8, 8), impl)


@pytest.mark.parametrize("hw", [(7, 8), (8, 5)])
def test_rejects_odd_extents(hw):
    with pytest.raises(ValueError, match="even"):
        _port(*_inputs(1, *hw, 8, 8))


def test_rejects_wrong_shapes():
    x, w, bias = _inputs(1, 8, 8, 8, 8)
    t = torch.from_numpy
    wt = t(w.transpose(3, 2, 0, 1).copy())
    with pytest.raises(ValueError, match="w must be"):
        TD.downsample_conv2x(t(x), t(w), t(bias))          # HWIO, not OIHW
    with pytest.raises(ValueError, match="bias"):
        TD.downsample_conv2x(t(x), wt, t(bias)[:4])
    with pytest.raises(ValueError, match="x must be"):
        TD.downsample_conv2x(t(x)[0], wt, t(bias))
