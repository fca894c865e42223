"""Port parity of W8A8 int8 (`vae_impl="int8"`, `unet_int8`) in the
pipeline: `diffews_tpu_torch.pipeline` against `diffews_tpu.pipeline` on
the same tiny weights (CPU, f32).

Held:
  - the quantized sites are the same set as JAX's, every int8 weight and
    `w_scale` equal JAX's bit for bit, every static activation scale within
    1e-5 of JAX's (both calibrate on the same synthetic batch; the float
    activations they take amax over differ in the last bits);
  - `predict` under both flags (KV fusion, batch 2 with 2 shots, one
    padded) and under `unet_int8` with the attn-mask variant, and
    `precompute_supports` + `predict_cached` under both flags, against the
    JAX pipeline's same calls: at every int8 site the port's codes equal
    JAX's but at ties (one code apart on < 0.1% of a site's codes), and
    with JAX's codes fed forward past each tie (`helpers/int8_ties.py`:
    one code at a tie moves a tiny random model's output by tens of uint8
    counts) the uint8 segs meet the episode contract (one count on < 1%
    of pixels); the thresholded masks of the runs without feeding differ on
    < 1% of pixels.
`vae_impl="int8"` alone and `unet_int8` alone are held the same way in
`test_torch_pipeline.py::test_unported_options_raise`.  Both packages
calibrate the int8 VAE at 64 px here (`int8_ties.small_calibration`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import checkpoint as JC
from diffews_tpu import pipeline as JP
from diffews_tpu.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch import pipeline as TP
from diffews_tpu_torch.ops import quant as TQ
from helpers.int8_ties import assert_forced_episode, int8_parity
from helpers.jax_checkpoint import tiny_params
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FLAGS = {"both": {"vae_impl": "int8", "unet_int8": True},
         "unet_attn_mask": {"unet_int8": True, "attn_mask_variant": True}}


@pytest.fixture(scope="module")
def ties():
    with int8_parity() as t:
        yield t


@pytest.fixture(scope="module")
def pipes(ties):
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
    up, vp = tiny_params()
    jb = JC.PipelineBundle(up, ucfg, vp, vcfg, None, CLIPTextConfig.tiny(),
                           SchedulerConfig.diffews())

    def port():
        tc = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                       TCF.SchedulerConfig.diffews())
        tc.unet.load_state_dict(TC.state_dict_from_jax(up), strict=True)
        tc.vae.load_state_dict(TC.state_dict_from_jax(vp), strict=True)
        return tc

    return {k: (JP.DiffewsPipeline(jb, **kw), TP.DiffewsPipeline(port(), device="cpu", **kw))
            for k, kw in FLAGS.items()}


def _episode(b, n, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, n, s, s, 3), dtype=np.uint8),
            (rng.random((b, n, s, s)) > 0.5).astype(np.uint8))


def _jax_sites(tree, pre=""):
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            yield pre, tree
        for k, v in tree.items():
            yield from _jax_sites(v, f"{pre}.{k}" if pre else k)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_quantized_modules_equal_jax(pipes, flags):
    jp, tp = pipes[flags]
    trees = [("vae", jp.vae_params, tp.vae)] if flags == "both" else []
    trees.append(("unet", jp.unet_params, tp.unet))
    for name, params, module in trees:
        want = dict(_jax_sites(params))
        got = {n: m for n, m in module.named_modules()
               if isinstance(m, (TQ.Int8Conv2d, TQ.Int8Linear))}
        assert want and set(got) == set(want), (name, set(got) ^ set(want))
        for site, p in want.items():
            m = got[site]
            w8 = m.weight_q.numpy()
            w8 = w8.transpose(1, 2, 3, 0) if w8.ndim == 4 else w8.T  # to HWIO / (in, out)
            np.testing.assert_array_equal(w8, np.asarray(p["kernel_q"]), err_msg=site)
            np.testing.assert_array_equal(m.w_scale.numpy(), np.asarray(p["w_scale"]),
                                          err_msg=site)
            s_jax = np.float32(np.asarray(p["a_scale"])) * np.float32(TQ.INV_127)
            assert abs(float(m.s_a) - s_jax) <= 1e-5 * s_jax, (site, float(m.s_a), s_jax)
    if flags != "both":
        assert not any(isinstance(m, TQ.Int8Conv2d) for m in tp.vae.modules())


@pytest.mark.parametrize("flags,b,n,shot_mask", [
    ("both", 2, 2, [[True, False], [True, True]]), ("unet_attn_mask", 2, 1, None)])
def test_episode_matches_jax(pipes, ties, flags, b, n, shot_mask):
    jp, tp = pipes[flags]
    q, sup, m = _episode(b, n, seed=b + n)
    sm = None if shot_mask is None else np.asarray(shot_mask)
    run = lambda p: lambda: p.predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
    want, got = assert_forced_episode(run(jp), run(tp), ties)
    assert got.seg_colored.dtype == np.uint8 and got.seg_colored.shape == (b, 32, 32, 3)
    free = tp.predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
    assert (free.mask != want.mask).mean() < 0.01


def test_cached_matches_jax(pipes, ties):
    """`precompute_supports` (a batch-1 cache of 2 shots, one padded) and
    `predict_cached` of 3 queries under both flags."""
    jp, tp = pipes["both"]
    _, sup, m = _episode(1, 2, seed=7)
    q = _episode(3, 1, seed=8)[0]
    sm = np.array([[True, False]])

    def run(p):
        return lambda: p.predict_cached(q, p.precompute_supports(sup, m, shot_mask=sm),
                                        r_threshold=0.25)

    want, got = assert_forced_episode(run(jp), run(tp), ties)
    free = run(tp)()
    assert (free.mask != want.mask).mean() < 0.01


def test_x0_latent_of_the_int8_unet_near_jax(pipes, ties):
    """The forced x0 latent of the joint UNet (float after each site) within
    1e-4 of JAX's, as the float pipelines' (`test_torch_pipeline.py`)."""
    jp, tp = pipes["both"]
    q, sup, m = _episode(1, 1, seed=9)
    x0 = {}

    def jax_x0():
        x0["jax"] = np.asarray(jax.jit(jp._x0_latent, static_argnames=("denoising_steps",))(
            jp.unet_params, jp.vae_params, jnp.asarray(q), jnp.asarray(sup), jnp.asarray(m),
            jp.empty_text_embed, None, denoising_steps=1))
        return x0["jax"]

    def port_x0():
        with torch.inference_mode():
            x0["port"] = tp._x0_latent(torch.from_numpy(q), torch.from_numpy(sup),
                                       torch.from_numpy(m), tp.empty_text_embed, None,
                                       1).numpy()
        return x0["port"]

    ties.take()
    jax_x0()
    jax.effects_barrier()
    codes = ties.take()
    ties.stats.clear()
    with ties.force(codes):
        port_x0()
    ties.check_ties()
    np.testing.assert_allclose(x0["port"], x0["jax"], rtol=0, atol=1e-4)
