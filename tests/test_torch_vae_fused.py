"""Port parity: the tiny VAE under `resnet_impl` "fused", "mixed" and
"pallas" against the JAX VAE under the same impl, on the same weights
(carried with `state_dict_from_jax`) and inputs, f32 on the CPU: 5e-5 abs,
1e-4 rel.

"mixed" runs with `MIXED_MIN_PIXELS` lowered to 32·32 in both packages, so
the tiny VAE switches between the fused chain and the plain blocks
mid-way (as `tests/test_fused_resnet.py` does for the JAX package).  The
JAX "pallas" impl interprets the megakernel on the CPU; the port's takes
the kernel's plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.configs import VAEConfig
from diffews_tpu.models import vae as JV
from diffews_tpu_torch.checkpoint import state_dict_from_jax
from diffews_tpu_torch.configs import VAEConfig as TVAEConfig
from diffews_tpu_torch.models import vae as TV
from diffews_tpu_torch.ops import fused_resnet as TF
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=5e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    params = jax.device_get(jax.jit(lambda r: JV.init_params(r, VAEConfig.tiny()))(
        jax.random.PRNGKey(0)))
    model = TV.AutoencoderKL(TVAEConfig.tiny())
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, model.eval()


def _count_fused_calls(monkeypatch):
    calls = []
    real = TF.gn_silu_conv3x3

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(TF, "gn_silu_conv3x3", spy)
    return calls


@pytest.mark.parametrize("impl", ["fused", "mixed", "pallas"])
@pytest.mark.parametrize("fn", ["encode", "decode"])
def test_matches_jax(models, fn, impl, monkeypatch):
    params, model = models
    if impl == "mixed":
        monkeypatch.setattr(JV, "MIXED_MIN_PIXELS", 32 * 32)
        monkeypatch.setattr(TV, "MIXED_MIN_PIXELS", 32 * 32)
    calls = _count_fused_calls(monkeypatch)
    r = np.random.default_rng(0)
    cfg = VAEConfig.tiny()
    if fn == "encode":
        x = r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        want = JV.encode_moments(params, cfg, jnp.asarray(x), resnet_impl=impl)
        with torch.no_grad():
            got = model.encode_moments(torch.from_numpy(x), resnet_impl=impl)
    else:
        z = (r.normal(size=(2, 16, 16, cfg.latent_channels)) * 0.2).astype(np.float32)
        want = JV.decode(params, cfg, jnp.asarray(z), resnet_impl=impl)
        with torch.no_grad():
            got = model.decode(torch.from_numpy(z), resnet_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the calls that went through the fused op (two per resnet, one per
    # head): the tiny encoder has 4 resnets, 1 of them at 32x32; the
    # decoder 6, 2 at 32x32; "mixed" (threshold 32·32) fuses those and the
    # decoder's head, "fused" every resnet and both heads
    full = {("encode", "fused"): 4 * 2 + 1, ("decode", "fused"): 6 * 2 + 1,
            ("encode", "mixed"): 1 * 2, ("decode", "mixed"): 2 * 2 + 1}
    full[(fn, "pallas")] = full[(fn, "fused")]
    assert len(calls) == full[(fn, impl)], calls


def test_resnet_impl_validation(models):
    _, model = models
    with pytest.raises(ValueError, match="resnet_impl"):
        model.decode(torch.zeros(1, 4, 4, 4), resnet_impl="int8")


@pytest.mark.parametrize("impl", ["fused", "auto"])
def test_sample_latent_takes_resnet_impl(models, impl):
    """The training-path posterior sample through the fused chain equals
    the plain one (f32, the same noise)."""
    _, model = models
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    noise = torch.from_numpy(r.normal(size=(1, 16, 16, 4)).astype(np.float32))
    with torch.no_grad():
        want = model.sample_latent(x, noise, resnet_impl="xla")
        got = model.sample_latent(x, noise, resnet_impl=impl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
