"""Port parity: `diffews_tpu_torch.scheduler` against the JAX scheduler."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import scheduler as JS
from diffews_tpu.configs import SchedulerConfig
from diffews_tpu_torch import scheduler as TS
from diffews_tpu_torch.configs import SchedulerConfig as TSchedulerConfig
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CONFIGS = {
    "diffews": SchedulerConfig.diffews(),
    "default": SchedulerConfig(),
    "scaled_linear": SchedulerConfig(beta_schedule="scaled_linear", beta_end=0.012,
                                     beta_start=0.00085),
    "power": SchedulerConfig(beta_schedule="scaled_linear_power", power_beta_curve=3.0),
    "cosine_zero_snr": SchedulerConfig(beta_schedule="squaredcos_cap_v2",
                                       rescale_betas_zero_snr=True),
}


def _port_cfg(cfg):
    return TSchedulerConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_beta_tables_bit_equal(name):
    cfg = CONFIGS[name]
    np.testing.assert_array_equal(TS.make_betas(_port_cfg(cfg)), JS.make_betas(cfg))
    for spacing in ("leading", "linspace", "trailing"):
        c = dataclasses.replace(cfg, timestep_spacing=spacing)
        for n in (1, 10, 50):
            np.testing.assert_array_equal(TS.inference_timesteps(_port_cfg(c), n),
                                          JS.inference_timesteps(c, n))


def test_diffews_one_step_is_degenerate():
    """set_timesteps(1) -> [1]; x0 == -v and prev == sample, bit for bit."""
    sched = TS.DDIMScheduler(TSchedulerConfig.diffews())
    np.testing.assert_array_equal(sched.set_timesteps(1), [1])
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    prev, x0 = sched.step(v, 1, x)
    assert torch.equal(x0, -v)
    assert torch.equal(prev, x)


@pytest.mark.parametrize("pred", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_step_matches_jax(pred, eta):
    cfg = dataclasses.replace(SchedulerConfig(), prediction_type=pred, clip_sample=True)
    js, ts = JS.DDIMScheduler(cfg), TS.DDIMScheduler(_port_cfg(cfg))
    js.set_timesteps(10)
    ts.set_timesteps(10)
    rng = np.random.default_rng(1)
    mo, x, nz = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    for t in js.timesteps[:3]:
        jp, jx0 = js.step(jnp.asarray(mo), int(t), jnp.asarray(x), eta=eta,
                          noise=jnp.asarray(nz))
        tp, tx0 = ts.step(torch.from_numpy(mo), int(t), torch.from_numpy(x), eta=eta,
                          noise=torch.from_numpy(nz))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-5, atol=1e-5)


def test_thresholding_matches_jax():
    cfg = dataclasses.replace(SchedulerConfig(), thresholding=True, sample_max_value=1.5)
    js, ts = JS.DDIMScheduler(cfg), TS.DDIMScheduler(_port_cfg(cfg))
    js.set_timesteps(4)
    ts.set_timesteps(4)
    rng = np.random.default_rng(2)
    mo, x = (rng.normal(size=(3, 4, 4, 4)).astype(np.float32) * 3 for _ in range(2))
    t = int(js.timesteps[0])
    _, jx0 = js.step(jnp.asarray(mo), t, jnp.asarray(x))
    _, tx0 = ts.step(torch.from_numpy(mo), t, torch.from_numpy(x))
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-5, atol=1e-5)
