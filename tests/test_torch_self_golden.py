"""The port held to the pinned self-goldens (`tests/golden/self_golden.npz`).

`tools/make_self_golden.py` pins the JAX package's tiny-model outputs
(fixed `jax.random` init keys, fixed NumPy inputs, CPU f32).  Here the
port, on `state_dict_from_jax` of the same inits and on the same NumPy
inputs (drawn in the tool's order), is compared with the pinned values at
`tests/test_self_golden.py`'s RTOL 1e-4 and ATOL 1e-5: the joint and
attn-mask UNet forwards, the VAE moments / mean latent / decode, the CLIP
text encoder, the degenerate DDIM step, the training loss and gradient
norm (the posterior noise of `PRNGKey(3)`, as the JAX loss draws it), and
the pipeline episode under `test_self_golden.py`'s uint8 rule.  The JAX
fixtures are not recomputed.
"""

import os

import jax
import numpy as np
import pytest
import torch

from diffews_tpu.configs import CLIPTextConfig, UNetConfig, VAEConfig
from diffews_tpu.models import clip_text as JCLIP
from diffews_tpu.models import unet as JU
from diffews_tpu.models import vae as JV
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch.pipeline import DiffewsPipeline
from diffews_tpu_torch.scheduler import DDIMScheduler
from diffews_tpu_torch.training import state as tstate
from diffews_tpu_torch.training.optim import global_norm
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "self_golden.npz")
RTOL, ATOL = 1e-4, 1e-5  # tests/test_self_golden.py's


@pytest.fixture(scope="module")
def got_want():
    ucfg, vcfg, ccfg = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
    init = lambda f, cfg, seed: jax.device_get(  # noqa: E731
        jax.jit(lambda r: f(r, cfg))(jax.random.PRNGKey(seed)))
    unet = TC.UNet2DConditionModel(TCF.UNetConfig.tiny())
    unet.load_state_dict(TC.state_dict_from_jax(init(JU.init_params, ucfg, 0)), strict=True)
    vae = TC.AutoencoderKL(TCF.VAEConfig.tiny())
    vae.load_state_dict(TC.state_dict_from_jax(init(JV.init_params, vcfg, 1)), strict=True)
    clip = TC.CLIPTextModel(TCF.CLIPTextConfig.tiny())
    clip.load_state_dict(TC.state_dict_from_jax(
        jax.device_get(JCLIP.init_params(jax.random.PRNGKey(2), ccfg))), strict=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731

    out = {}
    rng = np.random.default_rng(1234)  # the tool's draws, in its order
    sample = rng.standard_normal((1, 8, 8, ucfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, ucfg.cross_attention_dim)).astype(np.float32)
    ref = rng.standard_normal((1, 2, 8, 8, ucfg.ref_in_channels)).astype(np.float32)
    with torch.no_grad():
        out["unet_joint"] = unet(t(sample), 1, t(ctx), ref_sample=t(ref),
                                 shot_mask=t(np.array([[True, False]])))
        ref4 = rng.standard_normal((1, 2, 8, 8, ucfg.in_channels)).astype(np.float32)
        rmask = (rng.random((1, 2, 32, 32)) > 0.5).astype(np.float32)
        out["unet_attnmask"] = unet(t(sample), 1, t(ctx), ref_sample=t(ref4),
                                    ref_mask=t(rmask))
        img = t(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
        out["vae_moments"] = vae.encode_moments(img)
        out["vae_mean"] = mean = vae.encode_mean_latent(img)
        out["vae_dec"] = vae.decode(mean)
        ids = (np.arange(8, dtype=np.int64)[None, :] * 37 + 3) % ccfg.vocab_size
        out["clip_out"] = clip(t(ids))
    sched = DDIMScheduler(TCF.SchedulerConfig.diffews())
    sched.set_timesteps(1)
    model_out = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    lat = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    step = sched.step(t(model_out), int(sched.timesteps[0]), t(lat))
    out["sched_t"] = np.array([int(sched.timesteps[0])])
    out["sched_x0"], out["sched_prev"] = step.pred_original_sample, step.prev_sample

    pipe = DiffewsPipeline(TC.PipelineBundle(unet, TCF.UNetConfig.tiny(), vae,
                                             TCF.VAEConfig.tiny(), None,
                                             TCF.CLIPTextConfig.tiny(),
                                             TCF.SchedulerConfig.diffews()), device="cpu")
    q = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    sup = rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    msk = np.where(rng.random((1, 2, 32, 32, 3)) > 0.5, 1.0, -1.0).astype(np.float32)
    seg = pipe.predict(q, sup, msk, r_threshold=0.25)
    out["pipe_seg"], out["pipe_mask"] = seg.seg_colored, seg.mask.astype(np.uint8)

    cfg = tstate.TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32,
                               remat=False, max_nshot=2)
    micro = {
        "query": rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
        "q_mask3": np.where(rng.random((1, 32, 32, 3)) > 0.5, 1.0, -1.0).astype(np.float32),
        "supports": rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32),
        "s_mask3": np.where(rng.random((1, 2, 32, 32, 3)) > 0.5, 1.0,
                            -1.0).astype(np.float32),
        "shot_mask": np.array([[True, True]]),
    }
    text_embed = rng.standard_normal((1, 7, ucfg.cross_attention_dim)).astype(np.float32)
    # the loss's posterior sample: 6 images (query, its mask, 2 supports,
    # their masks) at the tiny VAE's 16x16x4 latent
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (6, 16, 16, 4)))
    params = {n: p.detach().clone().requires_grad_() for n, p in unet.named_parameters()}
    loss, grads = tstate.make_grad_fn(cfg, unet)(
        params, vae.requires_grad_(False), t(text_embed),
        {k: t(v) for k, v in micro.items()}, t(noise))
    out["train_loss"] = loss[None]
    out["train_grad_norm"] = global_norm(list(grads.values()))[None]
    got = {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in out.items()}
    return got, dict(np.load(FIXTURE))


FLOAT_KEYS = ["unet_joint", "unet_attnmask", "vae_moments", "vae_mean", "vae_dec",
              "clip_out", "sched_x0", "sched_prev", "train_loss", "train_grad_norm"]


@pytest.mark.parametrize("key", FLOAT_KEYS)
def test_float_surface_matches_pinned(got_want, key):
    got, want = got_want
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL)


def test_scheduler_timestep_matches_pinned(got_want):
    got, want = got_want
    np.testing.assert_array_equal(got["sched_t"], want["sched_t"])


def test_pipeline_episode_matches_pinned(got_want):
    """uint8 seg + mask within `test_self_golden.py`'s rule: one count on
    < 1% of pixels, < 1% of mask pixels flipped."""
    got, want = got_want
    seg_d = np.abs(got["pipe_seg"].astype(np.int16) - want["pipe_seg"].astype(np.int16))
    assert seg_d.max() <= 1 and (seg_d > 0).mean() < 0.01
    assert (got["pipe_mask"] != want["pipe_mask"]).mean() < 0.01
