"""Port parity: `diffews_tpu_torch.models.vae` against the JAX VAE (tiny
config, f32, the JAX "xla" resnet path, 1e-4 abs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.configs import VAEConfig
from diffews_tpu.models import vae as JV
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.configs import VAEConfig as TVAEConfig
from diffews_tpu_torch.models.vae import AutoencoderKL
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    params = jax.device_get(jax.jit(lambda r: JV.init_params(r, VAEConfig.tiny()))(
        jax.random.PRNGKey(1)))
    model = AutoencoderKL(TVAEConfig.tiny())
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, model.eval()


def _img(b=2, s=32, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_encode_moments(models, impl):
    params, model = models
    x = _img()
    want = JV.encode_moments(params, VAEConfig.tiny(), jnp.asarray(x), attn_impl="xla",
                             resnet_impl="xla")
    with torch.no_grad():
        got = model.encode_moments(torch.from_numpy(x), attn_impl=impl)
    assert got.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_encode_mean_latent(models):
    params, model = models
    x = _img(seed=1)
    want = JV.encode_mean_latent(params, VAEConfig.tiny(), jnp.asarray(x), attn_impl="xla",
                                 resnet_impl="xla")
    with torch.no_grad():
        got = model.encode_mean_latent(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_decode(models):
    params, model = models
    z = np.random.default_rng(2).normal(size=(2, 16, 16, 4)).astype(np.float32) * 0.2
    want = JV.decode(params, VAEConfig.tiny(), jnp.asarray(z), attn_impl="xla",
                     resnet_impl="xla")
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_odd_input_size(models):
    """The encoder's (0,1),(0,1) downsample pad on an odd extent."""
    params, model = models
    x = _img(b=1, s=33, seed=3)
    want = JV.encode_moments(params, VAEConfig.tiny(), jnp.asarray(x), attn_impl="xla",
                             resnet_impl="xla")
    with torch.no_grad():
        got = model.encode_moments(torch.from_numpy(x))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
