"""Port parity: the joint support+query UNet forward against the JAX UNet
(tiny config, f32, 1e-4 abs): plain, 1-shot, 2-shot with a padded shot and
the attn-mask variant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.configs import UNetConfig
from diffews_tpu.models import unet as JU
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.configs import UNetConfig as TUNetConfig
from diffews_tpu_torch.models.unet import UNet2DConditionModel
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
_jforward = jax.jit(JU.forward, static_argnums=(1,), static_argnames=("attn_impl",))


@pytest.fixture(scope="module")
def models():
    params = jax.device_get(jax.jit(lambda r: JU.init_params(r, UNetConfig.tiny()))(
        jax.random.PRNGKey(0)))
    model = UNet2DConditionModel(TUNetConfig.tiny())
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, model.eval()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _run(models, b, n, *, shot_mask=None, ref_mask=None, ref_ch=8, t=1, impl="auto"):
    params, model = models
    cfg = UNetConfig.tiny()
    s = 8
    x = _x(b, s, s, 4, seed=1)
    ctx = _x(b, 2, cfg.cross_attention_dim, seed=2)
    ref = _x(b, n, s, s, ref_ch, seed=3) if n else None
    j = lambda a: None if a is None else jnp.asarray(a)
    want = _jforward(params, cfg, j(x), t, j(ctx), ref_sample=j(ref), shot_mask=j(shot_mask),
                      ref_mask=j(ref_mask), attn_impl="xla")
    tt = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    with torch.no_grad():
        got = models[1](tt(x), t, tt(ctx), ref_sample=tt(ref), shot_mask=tt(shot_mask),
                        ref_mask=tt(ref_mask), attn_impl=impl)
    assert got.shape == (b, s, s, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    return got


def test_plain_forward(models):
    _run(models, 2, 0, t=999)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_joint_one_shot(models, impl):
    _run(models, 2, 1, impl=impl)


def test_joint_two_shot_with_padded_shot(models):
    got = _run(models, 2, 2, shot_mask=np.array([[True, False], [True, True]]))
    # the padded shot carries no weight: row 0 equals its 1-shot forward
    params, model = models
    cfg = UNetConfig.tiny()
    x, ctx, ref = _x(2, 8, 8, 4, seed=1), _x(2, 2, cfg.cross_attention_dim, seed=2), \
        _x(2, 2, 8, 8, 8, seed=3)
    with torch.no_grad():
        one = model(torch.from_numpy(x[:1]), 1, torch.from_numpy(ctx[:1]),
                    ref_sample=torch.from_numpy(ref[:1, :1]))
    np.testing.assert_allclose(got[:1].numpy(), one.numpy(), rtol=0, atol=1e-5)


def test_attn_mask_variant(models):
    rm = (np.random.default_rng(4).random((2, 2, 32, 32)) > 0.5).astype(np.float32)
    _run(models, 2, 2, ref_mask=rm, ref_ch=4)


def test_timestep_per_row(models):
    params, model = models
    cfg = UNetConfig.tiny()
    x, ctx = _x(2, 8, 8, 4, seed=5), _x(2, 2, cfg.cross_attention_dim, seed=6)
    ts = np.array([1, 500])
    want = _jforward(params, cfg, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                      attn_impl="xla")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
