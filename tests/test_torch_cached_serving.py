"""Port parity: support-KV cache serving (`kv_capture` / `kv_cache` in the
UNet, `precompute_supports` / `predict_cached` in the pipeline) against the
JAX package and against the port's own joint episode, on the CPU in f32.

UNet level (tiny config, JAX weights carried by `state_dict_from_jax`):
capture + cached use equals the joint forward (1e-5 rel / 1e-5 abs: the
cached forward runs the query rows alone, and torch's CPU matmuls round by
their row count, which moves an output by ~1e-6), with a shot mask, with a batch-1 cache under a larger
query batch and in the attn-mask variant; every captured `(k_sup, v_sup,
bias)` equals the JAX capture (2e-5 abs / 1e-5 rel); the guards raise.
Pipeline level: `predict_cached` against the port's `predict` and against
JAX `predict_cached` (uint8 within 1 count on < 1% of pixels), uint8
ingestion bit for bit, `mask_on_device`, `out_size`, and the two
rejections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import checkpoint as JC
from diffews_tpu import pipeline as JP
from diffews_tpu.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu.models import unet as JU
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch import pipeline as TP
from diffews_tpu_torch.models.unet import UNet2DConditionModel
from helpers.jax_checkpoint import tiny_params
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = UNetConfig.tiny()
ENTRY_TOL = dict(atol=2e-5, rtol=1e-5)
JOINT_TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def unet_pair():
    params = jax.device_get(jax.jit(lambda r: JU.init_params(r, CFG))(jax.random.PRNGKey(1)))
    model = UNet2DConditionModel(TCF.UNetConfig.tiny())
    model.load_state_dict(TC.state_dict_from_jax(params), strict=True)
    return params, model.eval()


def _capture(model, ref, ctx, ref_mask=None):
    cap = []
    with torch.no_grad():
        dummy = torch.zeros((ref.shape[0], 8, 8, 4))
        model(dummy, 1, _t(ctx), ref_sample=_t(ref), ref_mask=_t(ref_mask), kv_capture=cap)
    return tuple(cap)


def _cached(model, x, ctx, entries, shot_mask=None):
    with torch.no_grad():
        return model(_t(x), 1, _t(ctx), kv_cache=entries, shot_mask=_t(shot_mask)).numpy()


def _joint(model, x, ctx, ref, **kw):
    with torch.no_grad():
        return model(_t(x), 1, _t(ctx), ref_sample=_t(ref),
                     **{k: _t(v) for k, v in kw.items()}).numpy()


class TestUNetCaptureUse:
    def test_cached_equals_joint(self, unet_pair):
        _, model = unet_pair
        x, ctx = _rand(2, 8, 8, 4, seed=0), _rand(2, 2, CFG.cross_attention_dim, seed=1)
        ref = _rand(2, 3, 8, 8, 8, seed=2)
        entries = _capture(model, ref, ctx)
        np.testing.assert_allclose(_cached(model, x, ctx, entries),
                                   _joint(model, x, ctx, ref), **JOINT_TOL)

    def test_cached_with_shot_mask_equals_joint(self, unet_pair):
        _, model = unet_pair
        x, ctx = _rand(1, 8, 8, 4, seed=3), _rand(1, 2, CFG.cross_attention_dim, seed=4)
        ref = _rand(1, 3, 8, 8, 8, seed=5)
        sm = np.array([[True, True, False]])
        entries = _capture(model, ref, ctx)
        np.testing.assert_allclose(_cached(model, x, ctx, entries, shot_mask=sm),
                                   _joint(model, x, ctx, ref, shot_mask=sm), **JOINT_TOL)

    def test_cache_broadcasts_over_query_batch(self, unet_pair):
        """A batch-1 cache (with its batch-1 shot mask) serves a larger
        query batch row for row."""
        _, model = unet_pair
        ref = _rand(1, 2, 8, 8, 8, seed=6)
        ctx1 = _rand(1, 2, CFG.cross_attention_dim, seed=7)
        sm = np.array([[True, False]])
        entries = _capture(model, ref, ctx1)
        xs = _rand(3, 8, 8, 4, seed=8)
        ctx3 = np.broadcast_to(ctx1, (3,) + ctx1.shape[1:]).copy()
        for mask in (None, sm):
            batched = _cached(model, xs, ctx3, entries, shot_mask=mask)
            for i in range(3):
                kw = {} if mask is None else {"shot_mask": mask}
                np.testing.assert_allclose(batched[i:i + 1],
                                           _joint(model, xs[i:i + 1], ctx1, ref, **kw),
                                           **JOINT_TOL)

    def test_attn_mask_variant_cached_equals_joint(self, unet_pair):
        """The per-level key biases are captured with the K/V and applied
        again from the cache, also from a batch-1 cache under two queries."""
        _, model = unet_pair
        x, ctx = _rand(1, 8, 8, 4, seed=9), _rand(1, 2, CFG.cross_attention_dim, seed=10)
        ref4 = _rand(1, 1, 8, 8, 4, seed=11)
        mask = (np.random.default_rng(12).random((1, 1, 64, 64)) > 0.5).astype(np.float32)
        entries = _capture(model, ref4, ctx, ref_mask=mask)
        assert all(e[2] is not None for e in entries)
        want = _joint(model, x, ctx, ref4, ref_mask=mask)
        np.testing.assert_allclose(_cached(model, x, ctx, entries), want, **JOINT_TOL)
        two = _cached(model, np.concatenate([x, x]), np.concatenate([ctx, ctx]), entries)
        np.testing.assert_allclose(two[1:], want, **JOINT_TOL)

    @pytest.mark.parametrize("variant", ["kv_fusion", "attn_mask"])
    def test_captured_entries_match_jax(self, unet_pair, variant):
        """Every site's (k_sup, v_sup, bias), in forward order."""
        params, model = unet_pair
        am = variant == "attn_mask"
        ctx = _rand(2, 2, CFG.cross_attention_dim, seed=13)
        ref = _rand(2, 2, 8, 8, 4 if am else 8, seed=14)
        mask = (np.random.default_rng(15).random((2, 2, 64, 64)) > 0.5).astype(
            np.float32) if am else None

        @jax.jit
        def jcapture(params, ref, ctx, mask):
            cap = []
            JU.forward(params, CFG, jnp.zeros((2, 8, 8, 4), ref.dtype), 1, ctx,
                       ref_sample=ref, ref_mask=mask, kv_capture=cap)
            return tuple(cap)

        want = jcapture(params, jnp.asarray(ref), jnp.asarray(ctx),
                        None if mask is None else jnp.asarray(mask))
        got = _capture(model, ref, ctx, ref_mask=mask)
        assert len(got) == len(want) > 0
        for (gk, gv, gb), (wk, wv, wb) in zip(got, want):
            assert gk.shape == wk.shape and gk.is_contiguous() and gv.is_contiguous()
            np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **ENTRY_TOL)
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **ENTRY_TOL)
            assert (gb is None) == (wb is None) == (not am)
            if am:
                np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))

    def test_capture_keeps_support_rows_only(self, unet_pair):
        """An entry owns its storage: the support rows, not a view of the
        whole site's K/V."""
        _, model = unet_pair
        entries = _capture(model, _rand(1, 2, 8, 8, 8, seed=16),
                           _rand(1, 2, CFG.cross_attention_dim, seed=17))
        for k, v, _ in entries:
            assert k.untyped_storage().nbytes() == k.numel() * k.element_size()
            assert v.untyped_storage().nbytes() == v.numel() * v.element_size()

    def test_guards(self, unet_pair):
        _, model = unet_pair
        x, ctx = _t(_rand(1, 8, 8, 4)), _t(_rand(1, 2, CFG.cross_attention_dim))
        ref = _rand(1, 1, 8, 8, 8)
        with pytest.raises(ValueError, match="kv_capture requires"):
            model(x, 1, ctx, kv_capture=[])
        with pytest.raises(ValueError, match="not both"):
            model(x, 1, ctx, ref_sample=_t(ref), kv_cache=())
        with pytest.raises(ValueError, match="remat"):
            model(x, 1, ctx, ref_sample=_t(ref), kv_capture=[], remat=True)
        with pytest.raises(ValueError, match="remat"):
            model(x, 1, ctx, kv_cache=(), remat=True)
        entries = _capture(model, ref, ctx.numpy())
        with torch.no_grad():
            with pytest.raises(ValueError, match="more entries"):
                model(x, 1, ctx, kv_cache=entries + entries[:1])
            with pytest.raises(ValueError, match="fewer entries"):
                model(x, 1, ctx, kv_cache=entries[:-1])


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
    up, vp = tiny_params()
    jb = JC.PipelineBundle(up, ucfg, vp, vcfg, None, CLIPTextConfig.tiny(),
                           SchedulerConfig.diffews())

    def port(**kw):
        tb = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                       TCF.SchedulerConfig.diffews())
        tb.unet.load_state_dict(TC.state_dict_from_jax(up), strict=True)
        tb.vae.load_state_dict(TC.state_dict_from_jax(vp), strict=True)
        return TP.DiffewsPipeline(tb, device="cpu", **kw)

    return {"jax": JP.DiffewsPipeline(jb), "torch": port(),
            "jax_am": JP.DiffewsPipeline(jb, attn_mask_variant=True),
            "torch_am": port(attn_mask_variant=True)}


def _episode(b=1, n=1, s=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    sup = rng.integers(0, 256, (b, n, s, s, 3), dtype=np.uint8)
    m = (rng.random((b, n, s, s)) > 0.5).astype(np.uint8)
    return q, sup, m


def _uint8_close(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1, f"max uint8 diff {d.max()}"
    assert (d != 0).mean() < 0.01, f"{(d != 0).mean():.4f} of pixels differ"


class TestPipelineCachedServing:
    @pytest.mark.parametrize("variant", ["kv_fusion", "attn_mask"])
    def test_predict_cached_equals_predict_and_jax(self, pipes, variant):
        jp, tp = (pipes["jax"], pipes["torch"]) if variant == "kv_fusion" else \
            (pipes["jax_am"], pipes["torch_am"])
        q, sup, m = _episode(b=2, n=2, seed=0)
        full = tp.predict(q, sup, m, r_threshold=0.25)
        cache = tp.precompute_supports(sup, m)
        assert cache.batch == 2 and cache.n_shots == 2 and cache.shot_mask is None
        jcache = jp.precompute_supports(sup, m)
        assert len(cache.entries) == len(jcache.entries)
        cached = tp.predict_cached(q, cache, r_threshold=0.25)
        _uint8_close(cached.seg_colored, full.seg_colored)
        assert (cached.mask != full.mask).mean() <= 0.01
        want = jp.predict_cached(q, jcache, r_threshold=0.25)
        _uint8_close(cached.seg_colored, want.seg_colored)
        assert (cached.mask != want.mask).mean() <= 0.01

    def test_predict_cached_with_padded_shots(self, pipes):
        jp, tp = pipes["jax"], pipes["torch"]
        q, sup, m = _episode(b=1, n=3, seed=1)
        sm = np.array([[True, True, False]])
        full = tp.predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
        cache = tp.precompute_supports(sup, m, shot_mask=sm)
        assert cache.shot_mask.dtype == torch.bool
        cached = tp.predict_cached(q, cache, r_threshold=0.25)
        _uint8_close(cached.seg_colored, full.seg_colored)
        want = jp.predict_cached(q, jp.precompute_supports(sup, m, shot_mask=sm),
                                 r_threshold=0.25)
        _uint8_close(cached.seg_colored, want.seg_colored)
        # the padded shot's content reaches no output bit
        sup_o, m_o = sup.copy(), m.copy()
        sup_o[:, 2], m_o[:, 2] = 255 - sup[:, 2], 1 - m[:, 2]
        other = tp.predict_cached(q, tp.precompute_supports(sup_o, m_o, shot_mask=sm),
                                  r_threshold=0.25)
        np.testing.assert_array_equal(other.seg_colored, cached.seg_colored)

    def test_one_support_set_many_queries(self, pipes):
        """One batch-1 support set, a batch of queries: each row equals its
        own full episode, and the batch-3 cache made of three copies."""
        tp = pipes["torch"]
        _, sup, m = _episode(b=1, n=1, seed=2)
        qs = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
        batched = tp.predict_cached(qs, tp.precompute_supports(sup, m))
        for i in range(3):
            _uint8_close(batched.seg_colored[i:i + 1],
                         tp.predict(qs[i:i + 1], sup, m).seg_colored)
        copies = tp.precompute_supports(np.repeat(sup, 3, 0), np.repeat(m, 3, 0))
        _uint8_close(tp.predict_cached(qs, copies).seg_colored, batched.seg_colored)

    def test_uint8_ingestion(self, pipes):
        """Raw uint8 images and {0,1} masks equal host-normalised floats
        through the cache path, bit for bit."""
        tp = pipes["torch"]
        q8, s8, m1 = _episode(b=1, n=2, seed=4)
        qf = (q8.astype(np.float32) / 255.0 - 0.5) / 0.5
        sf = (s8.astype(np.float32) / 255.0 - 0.5) / 0.5
        mf = np.repeat(m1[..., None].astype(np.float32), 3, axis=-1) * 2.0 - 1.0
        a = tp.predict_cached(q8, tp.precompute_supports(s8, m1))
        ref = tp.predict_cached(qf, tp.precompute_supports(sf, mf))
        np.testing.assert_array_equal(a.seg_colored, ref.seg_colored)
        nchw = tp.predict_cached(np.moveaxis(qf, -1, 1), tp.precompute_supports(
            np.moveaxis(sf, -1, 2), np.moveaxis(mf, -1, 2)))
        np.testing.assert_array_equal(a.seg_colored, nchw.seg_colored)

    def test_out_size_and_mask_on_device(self, pipes):
        tp = pipes["torch"]
        q, sup, m = _episode(b=2, n=1, seed=5)
        cache = tp.precompute_supports(sup, m)
        host = tp.predict_cached_async(q, cache, r_threshold=0.25).result()
        dev = tp.predict_cached_async(q, cache, r_threshold=0.25,
                                      mask_on_device=True).result(need_seg=False)
        np.testing.assert_array_equal(dev.mask, host.mask)
        assert dev.seg_colored is None  # masks only: no seg transfer
        both = tp.predict_cached_async(q, cache, r_threshold=0.25,
                                       mask_on_device=True).result()
        np.testing.assert_array_equal(both.seg_colored, host.seg_colored)
        absolute = tp.predict_cached(q, cache, threshold=0.4, mask_on_device=True)
        np.testing.assert_array_equal(absolute.mask,
                                      tp.predict_cached(q, cache, threshold=0.4).mask)
        big = tp.predict_cached(q, cache, out_size=(45, 37))
        assert big.seg_colored.shape == (2, 45, 37, 3)
        want = pipes["jax"].predict_cached(q, pipes["jax"].precompute_supports(sup, m),
                                           out_size=(45, 37))
        _uint8_close(big.seg_colored, want.seg_colored)

    def test_multistep_rejected(self, pipes):
        q, sup, m = _episode()
        cache = pipes["torch"].precompute_supports(sup, m)
        with pytest.raises(NotImplementedError, match="one-step"):
            pipes["torch"].predict_cached(q, cache, denoising_steps=2)

    def test_batch_mismatch_rejected(self, pipes):
        q, sup, m = _episode(b=2, n=1, seed=5)
        cache = pipes["torch"].precompute_supports(sup, m)  # batch 2
        with pytest.raises(ValueError, match="cache batch"):
            pipes["torch"].predict_cached(q[:1], cache)

    def test_bad_mask_rank_rejected(self, pipes):
        _, sup, m = _episode()
        with pytest.raises(ValueError, match="support_masks"):
            pipes["torch"].precompute_supports(sup, m[0])
