"""Port parity of the depth head and its helpers against the JAX package
(CPU, f32, the same numpy inputs and tiny weights).

Held:
  - `ops.resize.bilinear_resize` against JAX's at test_ops' shapes and the
    depth head's 64² -> 512² and 512² -> 375x500, to 1e-6 abs (the same
    float64 tables and blend order; `F.interpolate` is only within 1e-4);
    `uint8_quantize` and `utils.image.norm_to_rgb` bit for bit;
  - `utils.image.colorize_depth_maps` (the port's own Spectral table, no
    matplotlib) against JAX's matplotlib one: equal floats, and the uint8
    cast of `predict_depth` bit for bit;
  - `predict_depth` under every `vae_impl`, batch 2 with 2 shots (one
    padded), with and without `out_size`, and `mode="depth"` through
    `__call__`, within `helpers/depth_check.py`'s contract (raw map 5e-5 +
    1e-4 rel, `depth_np` 1e-4 / range, the colourised map on < 1% of pixels
    by at most one colormap step); "int8" with the JAX run's codes fed
    forward past quantizer ties (`helpers/int8_ties.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu import pipeline as JP
from diffews_tpu.models import vae as JV
from diffews_tpu.ops import resize as JR
from diffews_tpu.utils import image as JI
from diffews_tpu_torch import pipeline as TP
from diffews_tpu_torch.models import vae as TV
from diffews_tpu_torch.ops import resize as TR
from diffews_tpu_torch.utils import image as TI
from helpers.depth_check import depth_close
from helpers.int8_ties import int8_parity
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_pipeline import _bundles, _episode

RESIZE_TOL = 1e-6


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hin,win,hout,wout", [(16, 16, 37, 41), (37, 41, 16, 16),
                                               (64, 64, 512, 512), (512, 512, 375, 500),
                                               (7, 5, 7, 5)])
def test_bilinear_resize_matches_jax(hin, win, hout, wout):
    x = _rand(2, hin, win, 3, seed=hout)
    want = np.asarray(JR.bilinear_resize(jnp.asarray(x), (hout, wout)))
    got = TR.bilinear_resize(torch.from_numpy(x), (hout, wout)).numpy()
    assert got.shape == want.shape == (2, hout, wout, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


def test_uint8_quantize_and_norm_to_rgb_bit_equal():
    x = _rand(3, 20, 20, 3) * 300
    np.testing.assert_array_equal(TR.uint8_quantize(torch.from_numpy(x)).numpy(),
                                  np.asarray(JR.uint8_quantize(jnp.asarray(x))))
    norm = _rand(3, 9, 11, seed=1) * 1.5
    np.testing.assert_array_equal(TI.norm_to_rgb(norm), JI.norm_to_rgb(norm))
    np.testing.assert_array_equal(TI.chw2hwc(norm), JI.chw2hwc(norm))


@pytest.mark.parametrize("case", ["bhw", "hw", "range", "valid_mask", "edges"])
def test_colorize_matches_matplotlib(case):
    rng = np.random.default_rng(2)
    d = rng.random((3, 40, 50)).astype(np.float32)
    kw = {"min_depth": 0.0, "max_depth": 1.0}
    if case == "hw":
        d = d[0]
    elif case == "range":
        kw = {"min_depth": 0.2, "max_depth": 0.7}
    elif case == "valid_mask":
        kw["valid_mask"] = rng.random((3, 40, 50)) > 0.3
    elif case == "edges":  # bin edges, both ends, out of range and NaN
        d = np.concatenate([np.arange(257, dtype=np.float32) / 256,
                            [-0.5, 1.5, np.nan, np.nextafter(np.float32(1), np.float32(0))]]
                           ).astype(np.float32)[None, None]
    want = JI.colorize_depth_maps(d, **kw)
    got = TI.colorize_depth_maps(d, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal((got * 255).astype(np.uint8), (want * 255).astype(np.uint8))


def test_colorize_rejects_other_colormaps():
    """The port carries matplotlib's "Spectral" only: another name raises
    instead of colouring with it."""
    with pytest.raises(ValueError, match="Spectral"):
        TI.colorize_depth_maps(np.zeros((4, 4), np.float32), 0, 1, cmap="viridis")


@pytest.fixture(scope="module")
def ties():
    with int8_parity() as t:
        yield t


@pytest.fixture(scope="module")
def bundles():
    return _bundles()


def _jax_raw(jp, q, sup, m, sm, out_size):
    raw = jp._predict_depth_jit(jp.unet_params, jp.vae_params, jnp.asarray(q),
                                jnp.asarray(sup), jnp.asarray(m), jp.empty_text_embed,
                                None if sm is None else jnp.asarray(sm), 1)
    if out_size is not None:
        raw = JR.bilinear_resize(raw[..., None], out_size)[..., 0]
    return np.asarray(raw)


def _mask3(m):
    return np.repeat(m[..., None].astype(np.float32), 3, axis=-1) * 2 - 1


@pytest.mark.parametrize("vae_impl", ["xla", "fused", "mixed", "auto", "int8"])
def test_depth_matches_jax(bundles, ties, vae_impl, monkeypatch):
    """The raw map, `depth_np` and the colourised map against JAX's, with
    and without a resize.  "mixed" with the threshold lowered to the tiny
    VAE's full 32x32 grid in both packages, so it fuses."""
    if vae_impl == "mixed":
        monkeypatch.setattr(JV, "MIXED_MIN_PIXELS", 32 * 32)
        monkeypatch.setattr(TV, "MIXED_MIN_PIXELS", 32 * 32)
    jb, port = bundles
    jp = JP.DiffewsPipeline(jb, vae_impl=vae_impl)
    tp = TP.DiffewsPipeline(port(), device="cpu", vae_impl=vae_impl)
    q, sup, m = _episode(2, 2, seed=3)
    m5 = _mask3(m)  # the JAX head takes 3-channel masks only
    sm = np.array([[True, False], [True, True]])
    for out_size in (None, (45, 37)):
        if vae_impl == "int8":
            ties.take()
            want_raw = _jax_raw(jp, q, sup, m5, sm, out_size)
            jax.effects_barrier()
            codes = ties.take()
            assert codes, "the JAX run recorded no int8 site"
            ties.stats.clear()
            with ties.force(codes):
                got_raw = tp.predict_depth_raw(q, sup, m5, shot_mask=sm,
                                               out_size=out_size).numpy()
            ties.check_ties()
            want, got = TP.depth_output(want_raw), TP.depth_output(got_raw)
        else:
            want_raw = _jax_raw(jp, q, sup, m5, sm, out_size)
            got_raw = tp.predict_depth_raw(q, sup, m5, shot_mask=sm, out_size=out_size).numpy()
            want = jp.predict_depth(q, sup, m5, shot_mask=sm, out_size=out_size)
            got = tp.predict_depth(q, sup, m5, shot_mask=sm, out_size=out_size)
            # the JAX host part on the JAX raw map is `depth_output`'s
            np.testing.assert_array_equal(TP.depth_output(want_raw).depth_np, want.depth_np)
            np.testing.assert_array_equal(TP.depth_output(got_raw).depth_colored,
                                          got.depth_colored)
        hw = out_size or (32, 32)
        assert got.depth_np.shape == (2,) + hw and got.depth_np.dtype == np.float32
        assert got.depth_colored.shape == (2,) + hw + (3,)
        assert got.depth_colored.dtype == np.uint8
        stats, bad = depth_close(got_raw, want_raw, got, want)
        assert not bad, (bad, stats)


def test_depth_4d_masks_equal_3_channel_masks(bundles):
    """The port also takes {0,1} (B, N, H, W) masks, as `predict` does:
    the same map as their 3-channel [-1, 1] form, bit for bit."""
    _, port = bundles
    tp = TP.DiffewsPipeline(port(), device="cpu")
    q, sup, m = _episode(1, 2, seed=4)
    np.testing.assert_array_equal(tp.predict_depth_raw(q, sup, m).numpy(),
                                  tp.predict_depth_raw(q, sup, _mask3(m)).numpy())


def test_reference_call_depth_mode(bundles):
    """`__call__(mode="depth")` against JAX's, resized to the input size;
    modes outside seg/semseg/depth raise in both."""
    jb, port = bundles
    jp, tp = JP.DiffewsPipeline(jb), TP.DiffewsPipeline(port(), device="cpu")
    q, sup, m = _episode(1, 2, seed=7, s=24)
    to = lambda x: (x.astype(np.float32) / 255.0 - 0.5) / 0.5  # noqa: E731
    imgs = [np.moveaxis(to(sup), -1, 2).reshape(2, 3, 24, 24), np.moveaxis(to(q), -1, 1),
            np.moveaxis(_mask3(m), -1, 2).reshape(2, 3, 24, 24)]
    want, got = jp(imgs, mode="depth"), tp(imgs, mode="depth")
    assert isinstance(got, TP.DepthOutput) and got.depth_np.shape == (1, 24, 24)
    raw_j = _jax_raw(jp, q, sup, _mask3(m), None, None)
    raw_t = tp.predict_depth_raw(q, sup, _mask3(m)).numpy()
    _, bad = depth_close(raw_t, raw_j, got, want)
    assert not bad, bad
    for mode in ("sr", "normal"):
        with pytest.raises(NotImplementedError):
            tp(imgs, mode=mode)
        with pytest.raises(NotImplementedError):
            jp(imgs, mode=mode)
