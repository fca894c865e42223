"""Port parity of the scheduler's training helpers (`add_noise`,
`get_velocity`), `DDPMScheduler` and `from_pretrained` against the JAX
scheduler, for every config of `test_torch_scheduler.CONFIGS` and every
prediction type, with and without noise (rtol 1e-5, atol 1e-5: host float64
coefficients times float32 tensors in both; DDPM's timestep tables equal)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import scheduler as JS
from diffews_tpu_torch import scheduler as TS
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_scheduler import CONFIGS, _port_cfg

PREDS = ["epsilon", "sample", "v_prediction"]


def _arrays(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 4, 4, 4)).astype(np.float32) for _ in range(n)]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_add_noise_and_velocity_match_jax(name):
    cfg = CONFIGS[name]
    js, ts = JS.DDIMScheduler(cfg), TS.DDIMScheduler(_port_cfg(cfg))
    x, nz = _arrays(0, 2)
    for t in (0, 1, 499, cfg.num_train_timesteps - 1):
        _close(ts.add_noise(torch.from_numpy(x), torch.from_numpy(nz), t),
               js.add_noise(jnp.asarray(x), jnp.asarray(nz), t))
        _close(ts.get_velocity(torch.from_numpy(x), torch.from_numpy(nz), t),
               js.get_velocity(jnp.asarray(x), jnp.asarray(nz), t))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("pred", PREDS)
@pytest.mark.parametrize("with_noise", [False, True])
def test_ddpm_steps_match_jax(name, pred, with_noise):
    cfg = dataclasses.replace(CONFIGS[name], prediction_type=pred, clip_sample=True)
    js, ts = JS.DDPMScheduler(cfg), TS.DDPMScheduler(_port_cfg(cfg))
    np.testing.assert_array_equal(ts.set_timesteps(10), js.set_timesteps(10))
    mo, x, nz = _arrays(1)
    for t in list(js.timesteps[:3]) + [int(js.timesteps[-1])]:
        noise = (torch.from_numpy(nz), jnp.asarray(nz)) if with_noise else (None, None)
        tp, tx0 = ts.step(torch.from_numpy(mo), int(t), torch.from_numpy(x), eta=0.5,
                          noise=noise[0])
        jp, jx0 = js.step(jnp.asarray(mo), int(t), jnp.asarray(x), eta=0.5, noise=noise[1])
        _close(tp, jp)
        _close(tx0, jx0)


def test_ddpm_without_set_timesteps_matches_jax():
    """A DDPM step before `set_timesteps` steps by one training timestep."""
    cfg = CONFIGS["default"]
    js, ts = JS.DDPMScheduler(cfg), TS.DDPMScheduler(_port_cfg(cfg))
    mo, x, nz = _arrays(2)
    tp, _ = ts.step(torch.from_numpy(mo), 500, torch.from_numpy(x), noise=torch.from_numpy(nz))
    jp, _ = js.step(jnp.asarray(mo), 500, jnp.asarray(x), noise=jnp.asarray(nz))
    _close(tp, jp)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_pretrained_reads_scheduler_json(name, tmp_path):
    cfg = CONFIGS[name]
    d = tmp_path / "scheduler"
    d.mkdir()
    (d / "scheduler_config.json").write_text(json.dumps(cfg.to_diffusers_dict()))
    for path in (str(d), str(d / "scheduler_config.json")):
        got, want = TS.from_pretrained(path), JS.from_pretrained(path)
        assert isinstance(got, TS.DDIMScheduler)
        assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
        np.testing.assert_array_equal(got.betas, want.betas)
        np.testing.assert_array_equal(got.set_timesteps(4), want.set_timesteps(4))
