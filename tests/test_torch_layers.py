"""Port parity: `diffews_tpu_torch.models.layers` against the JAX layers.

Same numpy inputs and the same JAX params (carried over with
`state_dict_from_jax`) through both; f32 on the CPU, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.models import layers as JL
from diffews_tpu.utils import init as JI
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.models import layers as TL
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _params(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _rng(i):
    return jax.random.PRNGKey(i)


def _norm_params(c, seed):
    r = np.random.default_rng(seed)
    return {"scale": r.normal(1.0, 0.2, c).astype(np.float32),
            "bias": r.normal(0.0, 0.2, c).astype(np.float32)}


def test_linear():
    p = _params(JI.linear_params(_rng(0), 24, 40))
    x = _x(3, 7, 24)
    m = _load(torch.nn.Linear(24, 40), p)
    _close(m(torch.from_numpy(x)), JL.linear(p, jnp.asarray(x)))


@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, 1), (1, 1, 0), (3, 2, 1), (3, 2, ((0, 1), (0, 1)))])
def test_conv2d(k, stride, padding):
    p = _params(JI.conv_params(_rng(1), k, k, 6, 10))
    x = _x(2, 9, 11, 6, seed=1)
    m = _load(TL.Conv2d(6, 10, k, stride=stride), p)
    got = m(torch.from_numpy(x), padding=padding)
    _close(got, JL.conv2d(p, jnp.asarray(x), stride=stride, padding=padding))


@pytest.mark.parametrize("shape,groups,eps", [
    ((2, 8, 6, 32), 8, 1e-5), ((2, 5, 7, 16), 4, 1e-6), ((3, 10, 32), 8, 1e-6)])
def test_group_norm(shape, groups, eps):
    p = _norm_params(shape[-1], 2)
    x = _x(*shape, seed=2) * 3 + 1
    m = _load(TL.GroupNorm(groups, shape[-1], eps), p)
    _close(m(torch.from_numpy(x)), JL.group_norm(p, jnp.asarray(x), groups=groups, eps=eps))


def test_layer_norm():
    p = _norm_params(48, 3)
    x = _x(2, 5, 48, seed=3) * 2 - 0.5
    m = _load(TL.LayerNorm(48), p)
    _close(m(torch.from_numpy(x)), JL.layer_norm(p, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activations(name):
    x = _x(4, 33, seed=4) * 4
    _close(getattr(TL, name)(torch.from_numpy(x)), getattr(JL, name)(jnp.asarray(x)))


@pytest.mark.parametrize("dim,flip,shift", [(32, True, 0), (32, False, 1), (17, True, 0)])
def test_timestep_embedding(dim, flip, shift):
    ts = np.array([0, 1, 999, 250], dtype=np.float32)
    got = TL.timestep_embedding(torch.from_numpy(ts), dim, flip_sin_to_cos=flip,
                                downscale_freq_shift=shift)
    want = JL.timestep_embedding(jnp.asarray(ts), dim, flip_sin_to_cos=flip,
                                 downscale_freq_shift=shift)
    _close(got, want)


def test_time_embedding_mlp():
    p = _params({"linear_1": JI.linear_params(_rng(5), 16, 64),
                 "linear_2": JI.linear_params(_rng(6), 64, 64)})
    x = _x(3, 16, seed=5)
    m = _load(TL.TimestepEmbedding(16, 64), p)
    _close(m(torch.from_numpy(x)), JL.time_embedding_mlp(p, jnp.asarray(x)))


@pytest.mark.parametrize("cin,cout,temb", [(16, 16, 32), (16, 24, 32), (16, 24, None)])
def test_resnet_block(cin, cout, temb):
    p = {"norm1": _norm_params(cin, 7), "conv1": JI.conv_params(_rng(7), 3, 3, cin, cout),
         "norm2": _norm_params(cout, 8), "conv2": JI.conv_params(_rng(8), 3, 3, cout, cout)}
    if temb:
        p["time_emb_proj"] = JI.linear_params(_rng(9), temb, cout)
    if cin != cout:
        p["conv_shortcut"] = JI.conv_params(_rng(10), 1, 1, cin, cout)
    p = _params(p)
    x = _x(2, 8, 8, cin, seed=6)
    e = _x(2, temb or 1, seed=7)
    m = _load(TL.ResnetBlock2D(cin, cout, temb, groups=4, eps=1e-5), p)
    got = m(torch.from_numpy(x), torch.from_numpy(e) if temb else None)
    want = JL.resnet_block(p, jnp.asarray(x), jnp.asarray(e) if temb else None,
                           groups=4, eps=1e-5)
    _close(got, want)


@pytest.mark.parametrize("asym", [False, True])
def test_downsample2d(asym):
    p = _params({"conv": JI.conv_params(_rng(11), 3, 3, 8, 8)})
    x = _x(2, 10, 10, 8, seed=8)
    m = _load(TL.Downsample2D(8, asymmetric_pad=asym), p)
    _close(m(torch.from_numpy(x)), JL.downsample2d(p, jnp.asarray(x), asymmetric_pad=asym))


def test_upsample2d():
    p = _params({"conv": JI.conv_params(_rng(12), 3, 3, 8, 8)})
    x = _x(2, 5, 6, 8, seed=9)
    m = _load(TL.Upsample2D(8), p)
    _close(m(torch.from_numpy(x)), JL.upsample2d(p, jnp.asarray(x)))


def test_geglu_ff():
    p = _params({"net": {"0": {"proj": JI.linear_params(_rng(13), 16, 128)},
                         "2": JI.linear_params(_rng(14), 64, 16)}})
    x = _x(2, 9, 16, seed=10)
    m = _load(TL.FeedForward(16), p)
    _close(m(torch.from_numpy(x)), JL.geglu_ff(p, jnp.asarray(x)))


def test_group_norm_bf16_rounds_like_jax():
    """bf16: the f32-statistics / `x*A+B` formula, not F.group_norm."""
    p = _norm_params(32, 11)
    x = (_x(2, 8, 8, 32, seed=11) * 5 + 2)
    got = TL.group_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(p["scale"]),
                        torch.from_numpy(p["bias"]), groups=8, eps=1e-5)
    want = JL.group_norm(p, jnp.asarray(x).astype(jnp.bfloat16), groups=8, eps=1e-5)
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    # one bf16 ulp at most: both apply x*A+B in bf16 from the same A, B
    assert np.mean(g != w) < 0.02
    np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=2 ** -7)
