"""Port parity: a tiny few-shot episode through `diffews_tpu_torch.pipeline`
against `diffews_tpu.pipeline` on the same weights and inputs (CPU, f32).

uint8 seg within 1 count on < 1% of pixels, the x0 latent to 1e-4, the
same thresholded masks; `device_mask_from_seg` equal to the host formula.
Every `vae_impl` the port takes ("xla", "fused", "mixed", "auto", "int8")
and `unet_int8` are held against the JAX pipeline with the same flag (the
int8 options past quantizer ties, `helpers/int8_ties.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import checkpoint as JC
from diffews_tpu import pipeline as JP
from diffews_tpu.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu.models import vae as JV
from diffews_tpu_torch.models import vae as TV
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch import pipeline as TP
from helpers.depth_check import depth_close
from helpers.int8_ties import assert_forced_episode, int8_parity
from helpers.jax_checkpoint import tiny_params
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _bundles():
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

    return jb, port


@pytest.fixture(scope="module")
def bundles():
    return _bundles()


@pytest.fixture(scope="module")
def pipes(bundles):
    jb, port = bundles
    return {"jax": JP.DiffewsPipeline(jb), "torch": TP.DiffewsPipeline(port(), device="cpu"),
            "jax_am": JP.DiffewsPipeline(jb, attn_mask_variant=True),
            "torch_am": TP.DiffewsPipeline(port(), device="cpu", attn_mask_variant=True)}


def _episode(b, n, s=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    sup = rng.integers(0, 256, (b, n, s, s, 3), dtype=np.uint8)
    m = (rng.random((b, n, s, s)) > 0.5).astype(np.uint8)
    return q, sup, m


def _uint8_close(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1, f"max uint8 diff {d.max()}"
    assert (d != 0).mean() < 0.01, f"{(d != 0).mean():.4f} of pixels differ"


@pytest.mark.parametrize("variant", ["kv_fusion", "attn_mask"])
@pytest.mark.parametrize("n,shot_mask", [(1, None), (2, [[True, False], [True, True]])])
def test_episode_matches_jax(pipes, variant, n, shot_mask):
    jp, tp = (pipes["jax"], pipes["torch"]) if variant == "kv_fusion" else \
        (pipes["jax_am"], pipes["torch_am"])
    q, sup, m = _episode(2, n, seed=n)
    sm = None if shot_mask is None else np.asarray(shot_mask)
    want = jp.predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
    got = tp.predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
    assert got.seg_colored.dtype == np.uint8 and got.seg_colored.shape == (2, 32, 32, 3)
    _uint8_close(got.seg_colored, want.seg_colored)
    assert (got.mask != want.mask).mean() < 0.01
    # x0 latent
    jsm = None if sm is None else jnp.asarray(sm)
    x0j = jax.jit(jp._x0_latent, static_argnames=("denoising_steps",))(
        jp.unet_params, jp.vae_params, jnp.asarray(q), jnp.asarray(sup), jnp.asarray(m),
        jp.empty_text_embed, jsm, denoising_steps=1)
    with torch.inference_mode():
        x0t = tp._x0_latent(torch.from_numpy(q), torch.from_numpy(sup), torch.from_numpy(m),
                            tp.empty_text_embed, None if sm is None else torch.from_numpy(sm), 1)
    np.testing.assert_allclose(x0t.numpy(), np.asarray(x0j), rtol=0, atol=1e-4)


def test_out_size_nearest_resize(pipes):
    q, sup, m = _episode(1, 1, seed=5)
    want = pipes["jax"].predict(q, sup, m, out_size=(45, 37), threshold=0.4)
    got = pipes["torch"].predict(q, sup, m, out_size=(45, 37), threshold=0.4)
    assert got.seg_colored.shape == (1, 45, 37, 3)
    _uint8_close(got.seg_colored, want.seg_colored)
    assert (got.mask != want.mask).mean() < 0.01


def test_float_and_nchw_inputs_match_uint8(pipes):
    """uint8 ingestion equals host-normalised float NCHW inputs bit for bit."""
    tp = pipes["torch"]
    q, sup, m = _episode(1, 2, seed=6)
    qf = (q.astype(np.float32) / 255.0 - 0.5) / 0.5
    sf = (sup.astype(np.float32) / 255.0 - 0.5) / 0.5
    mf = np.repeat(m[..., None].astype(np.float32), 3, axis=-1) * 2.0 - 1.0
    a = tp.predict(q, sup, m, r_threshold=0.25)
    b = tp.predict(np.moveaxis(qf, -1, 1), np.moveaxis(sf, -1, 2), np.moveaxis(mf, -1, 2),
                   r_threshold=0.25)
    np.testing.assert_array_equal(a.seg_colored, b.seg_colored)
    np.testing.assert_array_equal(a.mask, b.mask)


def test_reference_call_contract(pipes):
    """`__call__` takes [supports (B*N,3,H,W), query (B,3,H,W), masks] in [-1,1]."""
    q, sup, m = _episode(1, 2, seed=7)
    to = lambda x: (x.astype(np.float32) / 255.0 - 0.5) / 0.5
    sup_f = np.moveaxis(to(sup), -1, 2).reshape(2, 3, 32, 32)
    q_f = np.moveaxis(to(q), -1, 1)
    m_f = np.repeat(m[:, :, None].astype(np.float32), 3, axis=2).reshape(2, 3, 32, 32) * 2 - 1
    want = pipes["jax"]([sup_f, q_f, m_f])
    got = pipes["torch"]([sup_f, q_f, m_f])
    _uint8_close(got.seg_colored, want.seg_colored)
    # mode="depth" is ported: JAX's depth output within the depth head's
    # contract (`helpers/depth_check.py`); modes outside seg/depth raise
    want_d = pipes["jax"]([sup_f, q_f, m_f], mode="depth")
    got_d = pipes["torch"]([sup_f, q_f, m_f], mode="depth")
    _, bad = depth_close(got_d.depth_np, want_d.depth_np, got_d, want_d)
    assert not bad, bad
    with pytest.raises(NotImplementedError):
        pipes["torch"]([sup_f, q_f, m_f], mode="sr")


@pytest.mark.parametrize("relative,thr", [(True, 0.25), (True, 0.7), (False, 0.45)])
def test_device_mask_equals_host_and_jax(relative, thr):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    got = TP.device_mask_from_seg(torch.from_numpy(img), thr, relative).numpy()
    want = np.asarray(JP.device_mask_from_seg(jnp.asarray(img), jnp.float32(thr), relative))
    np.testing.assert_array_equal(got, want)
    host = TP.PendingSeg(torch.from_numpy(img), thr if relative else 0.0,
                         0.0 if relative else thr).result().mask
    np.testing.assert_array_equal(got, host)


def test_mask_on_device_path(pipes):
    q, sup, m = _episode(1, 1, seed=9)
    pend = pipes["torch"].predict_async(q, sup, m, r_threshold=0.25, mask_on_device=True)
    dev = pend.result(need_seg=False)
    host = pipes["torch"].predict(q, sup, m, r_threshold=0.25)
    assert dev.seg_colored is None
    np.testing.assert_array_equal(dev.mask, host.mask)


class _TensorParallelMesh:
    """A 2 x 2 mesh with JAX's ("data", "model") axes, seen from the rank at
    (1, 0)."""
    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return 2

    def get_local_rank(self, name):
        return {"data": 1, "model": 0}[name]

    def get_group(self, name):
        return f"{name} group"


@pytest.mark.parametrize("kw", [{"vae_impl": "int8"}, {"unet_int8": True},
                                {"mesh": _TensorParallelMesh()},
                                {"shot_mesh": _TensorParallelMesh()}])
def test_unported_options_raise(bundles, kw):
    """A ("data", "model") `mesh` is taken as JAX's pipeline takes it: the
    rows split over "data" and replicated over "model" (held on ranks in
    `test_torch_tensor_parallel.py`); a `shot_mesh` with a "model" axis
    raises.  The data and shot meshes are held in `test_torch_parallel.py`
    and `test_torch_shot_parallel.py`.  The
    int8 options (A12, ported) run against the JAX pipeline with the same
    flag: the int8 codes equal JAX's but at ties and, with JAX's codes fed
    forward past each tie, the segs meet the episode contract
    (`helpers/int8_ties.py`); the masks of the run without feeding differ
    on < 1% of pixels (both calibrate at 64 px)."""
    if "vae_impl" not in kw and "unet_int8" not in kw:
        b = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                      TCF.SchedulerConfig.diffews())
        if "shot_mesh" in kw:
            with pytest.raises(ValueError, match='no "model" axis'):
                TP.DiffewsPipeline(b, device="cpu", **kw)
            return
        p = TP.DiffewsPipeline(b, device="cpu", **kw)
        assert (p._n_data, p._data_rank, p._data_group) == (2, 1, "data group")
        assert p._shot_group is None and p._n_shots == 1
        return
    jb, port = bundles
    with int8_parity() as ties:
        jp, tp = JP.DiffewsPipeline(jb, **kw), TP.DiffewsPipeline(port(), device="cpu", **kw)
        q, sup, m = _episode(2, 1, seed=11)
        run = lambda p: lambda: p.predict(q, sup, m, r_threshold=0.25)
        want, _ = assert_forced_episode(run(jp), run(tp), ties)
    assert (tp.predict(q, sup, m, r_threshold=0.25).mask != want.mask).mean() < 0.01


@pytest.mark.parametrize("vae_impl", ["fused", "mixed", "auto"])
def test_vae_impl_episode_matches_jax(bundles, vae_impl, monkeypatch):
    """The episode under each fused VAE option against the JAX pipeline
    with the same option.  "mixed" lowers `MIXED_MIN_PIXELS` to 32·32 in
    both packages so that its fused blocks run at this size; "auto" picks
    "xla" on the CPU in both (the fused encode is for the accelerator)."""
    if vae_impl == "mixed":
        monkeypatch.setattr(JV, "MIXED_MIN_PIXELS", 32 * 32)
        monkeypatch.setattr(TV, "MIXED_MIN_PIXELS", 32 * 32)
    jb, port = bundles
    jp = JP.DiffewsPipeline(jb, vae_impl=vae_impl)
    tp = TP.DiffewsPipeline(port(), device="cpu", vae_impl=vae_impl)
    q, sup, m = _episode(1, 1, seed=10)
    want = jp.predict(q, sup, m, r_threshold=0.25)
    got = tp.predict(q, sup, m, r_threshold=0.25)
    _uint8_close(got.seg_colored, want.seg_colored)
    assert (got.mask != want.mask).mean() < 0.01
    assert tp._decode_resnet_impl() == jp._decode_resnet_impl()


def test_unknown_vae_impl_raises():
    b = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                  TCF.SchedulerConfig.diffews())
    with pytest.raises(ValueError, match="vae_impl"):
        TP.DiffewsPipeline(b, device="cpu", vae_impl="cudnn")


def _option_pipes(bundles, *, text=False, scheduler=None, **kw):
    """A JAX and a port pipeline on the same tiny weights with the same
    options: optionally a tiny CLIP text encoder (JAX-initialised) and
    another scheduler config."""
    from diffews_tpu.models import clip_text as JCT
    from diffews_tpu_torch.models import clip_text as TCT

    jb, port = bundles
    tb = port()
    if text:
        tcfg = CLIPTextConfig.tiny()
        tparams = jax.device_get(jax.jit(lambda r: JCT.init_params(r, tcfg))(
            jax.random.PRNGKey(2)))
        jb = JC.PipelineBundle(jb.unet_params, jb.unet_cfg, jb.vae_params, jb.vae_cfg,
                               tparams, tcfg, jb.scheduler_cfg)
        tb.text, tb.text_cfg = TCT.CLIPTextModel(TCF.CLIPTextConfig.tiny()), \
            TCF.CLIPTextConfig.tiny()
        tb.text.load_state_dict(TC.state_dict_from_jax(tparams), strict=True)
    if scheduler is not None:
        jb = JC.PipelineBundle(jb.unet_params, jb.unet_cfg, jb.vae_params, jb.vae_cfg,
                               jb.text_params, jb.text_cfg, SchedulerConfig(**scheduler))
        tb.scheduler_cfg = TCF.SchedulerConfig(**scheduler)
    return JP.DiffewsPipeline(jb, **kw), TP.DiffewsPipeline(tb, device="cpu", **kw)


# The pipeline options the eval harness passes straight through
# (`--encode_chunks`, `--test_timestep`, `--denoise_steps`) and a bundle with
# a text encoder (the harness's checkpoints carry one).
@pytest.mark.parametrize("case", [
    {"kw": {"encode_chunks": 3}, "n": 2},  # 2 + 2·2 + 2·2 = 10 images, 3 chunks
    {"kw": {"test_timestep": 500}, "n": 1},
    {"kw": {}, "n": 1, "steps": 3,
     "scheduler": {"prediction_type": "v_prediction", "clip_sample": False}},
    {"kw": {}, "n": 2, "text": True},
], ids=["encode_chunks3", "test_timestep500", "v_prediction_3_steps", "text_encoder"])
def test_pipeline_options_match_jax(bundles, case):
    jp, tp = _option_pipes(bundles, text=case.get("text", False),
                           scheduler=case.get("scheduler"), **case["kw"])
    if case.get("text"):
        assert float(np.abs(tp.empty_text_embed.numpy()).max()) > 0
        np.testing.assert_allclose(tp.empty_text_embed.numpy(),
                                   np.asarray(jp.empty_text_embed), rtol=1e-5, atol=1e-5)
    q, sup, m = _episode(2, case["n"], seed=11)
    steps = case.get("steps", 1)
    want = jp.predict(q, sup, m, denoising_steps=steps, r_threshold=0.25)
    got = tp.predict(q, sup, m, denoising_steps=steps, r_threshold=0.25)
    _uint8_close(got.seg_colored, want.seg_colored)
    assert (got.mask != want.mask).mean() < 0.01
