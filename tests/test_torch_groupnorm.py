"""Port parity: `diffews_tpu_torch.ops.groupnorm.group_norm_act` against
`diffews_tpu.ops.groupnorm.group_norm_act` on the CPU.

The same numpy inputs go through both, f32.  Forward against JAX impl
"xla" (the plain formula) and, on one small case, impl "pallas" (the two
Pallas kernels in interpret mode): 2e-5 abs, 1e-5 rel.  Gradients for x,
scale and bias against the JAX custom VJP: 1e-4.  On the CPU the port's
wrapper always takes its plain version, so no kernel is launched here (the
kernels are held against it on the card by `test_torch_groupnorm_gpu.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.ops import groupnorm as JG
from diffews_tpu_torch.models import layers as TL
from diffews_tpu_torch.ops import groupnorm as TG
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(shape, seed=0):
    r = np.random.default_rng(seed)
    c = shape[-1]
    x = (r.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
    scale = r.uniform(0.5, 1.5, (c,)).astype(np.float32)
    bias = (r.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, scale, bias


def _jax(x, scale, bias, groups, eps, act, impl):
    return np.asarray(JG.group_norm_act({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                        jnp.asarray(x), groups=groups, eps=eps, act=act,
                                        impl=impl))


def _torch(x, scale, bias, groups, eps, act, impl="auto"):
    return TG.group_norm_act(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), groups=groups, eps=eps, act=act,
                             impl=impl).numpy()


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 32), 8),      # the tiny configs' widths
    ((1, 4, 6, 48), 16),     # 3 channels per group, a non-square grid
    ((3, 5, 5, 40), 8),      # C not a power of two
])
@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_matches_jax_xla(shape, groups, act, impl):
    x, scale, bias = _inputs(shape, seed=sum(shape))
    want = _jax(x, scale, bias, groups, 1e-6, act, "xla")
    got = _torch(x, scale, bias, groups, 1e-6, act, impl)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("act", [None, "silu"])
def test_matches_jax_pallas_interpret(act):
    """The JAX package's two Pallas kernels, interpreted on the CPU."""
    x, scale, bias = _inputs((2, 4, 8, 16), seed=3)
    want = _jax(x, scale, bias, 4, 1e-5, act, "pallas")
    np.testing.assert_allclose(_torch(x, scale, bias, 4, 1e-5, act), want, **TOL)


def test_not_4d_takes_the_plain_formula():
    """(B, S, C) inputs: the plain formula in both packages (JAX
    `groupnorm.py:192-194`)."""
    x, scale, bias = _inputs((2, 10, 32), seed=4)
    want = _jax(x, scale, bias, 8, 1e-6, "silu", "pallas")
    np.testing.assert_allclose(_torch(x, scale, bias, 8, 1e-6, "silu", "pallas"), want, **TOL)


def test_reference_is_group_norm_then_silu():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 16), seed=5))
    want = torch.nn.functional.silu(TL.group_norm(x, scale, bias, groups=4, eps=1e-6))
    got = TG.group_norm_act_reference(x, scale, bias, groups=4, eps=1e-6, act="silu")
    assert torch.equal(got, want)


def test_cpu_launches_no_kernel_and_rejects_unknown_strings():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 16), seed=6))
    before = (TG.gn_stats_kernel.launches, TG.gn_apply_kernel.launches)
    TG.group_norm_act(x, scale, bias, groups=4, eps=1e-6, act="silu", impl="pallas")
    assert (TG.gn_stats_kernel.launches, TG.gn_apply_kernel.launches) == before
    with pytest.raises(ValueError, match="impl"):
        TG.group_norm_act(x, scale, bias, groups=4, eps=1e-6, impl="triton")
    with pytest.raises(ValueError, match="act"):
        TG.group_norm_act(x, scale, bias, groups=4, eps=1e-6, act="gelu")


@pytest.mark.parametrize("act", [None, "silu"])
def test_gradients_match_jax_custom_vjp(act):
    """Grads for x, scale and bias through the port's autograd Function
    against the JAX custom VJP (impl "pallas": its backward is the XLA
    formula's VJP)."""
    x, scale, bias = _inputs((2, 4, 4, 16), seed=7)
    g = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(x, s, b):
        y = JG.group_norm_act({"scale": s, "bias": b}, x, groups=4, eps=1e-6, act=act,
                              impl="pallas")
        return jnp.sum(y * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(bias))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = TG.group_norm_act(*ts, groups=4, eps=1e-6, act=act, impl="pallas")
    assert y.grad_fn is not None and "GroupNormAct" in type(y.grad_fn).__name__
    (y * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


def test_gradient_only_where_asked():
    """needs_input_grad: a frozen norm gets no weight/bias gradient."""
    x, scale, bias = _inputs((1, 4, 4, 16), seed=9)
    xt = torch.from_numpy(x).requires_grad_()
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    TG.group_norm_act(xt, st, bt, groups=4, eps=1e-6, act="silu").sum().backward()
    assert xt.grad is not None and st.grad is None and bt.grad is None
    ref = torch.from_numpy(x).requires_grad_()
    TG.group_norm_act_reference(ref, st, bt, groups=4, eps=1e-6, act="silu").sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref.grad.numpy(), rtol=0, atol=1e-6)
