"""Port parity of the W8A8 ops: `diffews_tpu_torch.ops.quant` against
`diffews_tpu.ops.quant` (CPU).

Held: the quantized sites (the 3x3 / Cin >= 32 rule, the UNet linear
filter) are JAX's by qualified name; int8 weights and `w_scale` equal
JAX's bit for bit in f32 and bf16 (a zero channel included); the int8
activations equal JAX's bit for bit (static and dynamic scales, ties,
saturation); `conv2d_int8` (stride 1 and 2, the encoder's (0,1),(0,1)
padding, static and dynamic) and `linear_int8` (3-D input, static and
dynamic) within 1e-6·max|JAX| in f32, and the convolution against the f64
torch oracle of `tests/test_int8_oracle.py` (rtol 1e-5, atol 1e-6, as that
file holds JAX); the quantized modules' forwards; the synthetic
calibration batch at 256 px within 1e-6 of JAX's (`jax.image.resize`
"linear" against `F.interpolate` bilinear); calibrated scales within 1e-5
relative of JAX's, for the VAE at 64 px and for the UNet; the CPU wrappers
launch nothing.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffews_tpu.configs import UNetConfig, VAEConfig
from diffews_tpu.models import unet as JU
from diffews_tpu.ops import quant as JQ
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch.models import layers as TL
from diffews_tpu_torch.models.unet import UNet2DConditionModel
from diffews_tpu_torch.models.vae import AutoencoderKL
from diffews_tpu_torch.ops import quant as TQ
from helpers import torch_oracle as TO
from helpers.int8_ties import CALIB_PX, _jax_codes
from helpers.jax_checkpoint import tiny_params
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def models():
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
    up, vp = tiny_params()
    tu = UNet2DConditionModel(TCF.UNetConfig.tiny()).eval().requires_grad_(False)
    tv = AutoencoderKL(TCF.VAEConfig.tiny()).eval().requires_grad_(False)
    tu.load_state_dict(TC.state_dict_from_jax(up), strict=True)
    tv.load_state_dict(TC.state_dict_from_jax(vp), strict=True)
    return up, vp, tu, tv


def _jax_paths(tree, pred, pre=""):
    out = []
    if isinstance(tree, dict):
        if pred(tree):
            out.append(pre)
        for k, v in tree.items():
            out += _jax_paths(v, pred, f"{pre}.{k}" if pre else k)
    return out


def test_sites_are_jax_sites(models):
    up, vp, tu, tv = models
    convs = _jax_paths(JQ.tag_conv_sites(vp), lambda d: "q_site" in d)
    lins = _jax_paths(JQ.tag_linear_sites(up), lambda d: "q_site" in d)
    assert convs and sorted(TQ.conv_sites(tv)) == sorted(convs)
    assert lins and sorted(TQ.linear_sites(tu)) == sorted(lins)
    for path in ("a.attn1.to_q", "a.attn2.to_q", "a.ff.net.2", "b.proj_in", "b.proj_out",
                 "time_embedding.linear_1", "x.attn1", "proj_in.x"):
        assert TQ.unet_attention_linear(path) == JQ.unet_attention_linear(path), path


def _weights(shape, dtype, seed):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.05
    w[..., 1] = 0.0  # an all-zero output channel: s_w = 1e-12
    wj = jnp.asarray(w, dtype)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32)))  # the same values
    return wj, wt.to(torch.bfloat16) if dtype == jnp.bfloat16 else wt


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_weight_quantization_equals_jax(dtype):
    kj, kt = _weights((3, 3, 48, 24), dtype, 0)  # HWIO
    k8, s_w = JQ._quantize_kernel(kj)
    w8, s_wt = TQ.quantize_weight(kt.permute(3, 0, 1, 2), (1, 2, 3))  # (Cout, 3, 3, Cin)
    np.testing.assert_array_equal(w8.permute(1, 2, 3, 0).numpy(), np.asarray(k8))
    np.testing.assert_array_equal(s_wt.numpy(), np.asarray(s_w))
    lj, lt = _weights((40, 24), dtype, 1)  # (in, out)
    k8, s_w = JQ._quantize_linear_kernel(lj)
    w8, s_wt = TQ.quantize_weight(lt.t(), (1,))
    np.testing.assert_array_equal(w8.t().numpy(), np.asarray(k8))
    np.testing.assert_array_equal(s_wt.numpy(), np.asarray(s_w))


@pytest.mark.parametrize("a_scale", [None, 3.7, 1e-20], ids=["dynamic", "static", "tiny"])
def test_codes_equal_jax(a_scale):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 9, 11, 32)) * 2).astype(np.float32)
    x[0, 0, 0, :16] = (np.arange(16) - 8 + 0.5) * np.float32(3.7 / 127)  # near ties
    x[1, 0, 0, 0] = 40.0  # saturates under the static scale
    p = {} if a_scale is None else {"a_scale": jnp.float32(a_scale)}
    want = np.asarray(_jax_codes(p, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    s = TQ.dynamic_s_a(xt) if a_scale is None else TQ.static_s_a(a_scale)
    np.testing.assert_array_equal(TQ.quantize_s8(xt, s).numpy(), want)


def _conv_case(seed, cin=48, cout=24):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.05
    b = rng.normal(size=(cout,)).astype(np.float32) * 0.01
    x = rng.normal(size=(2, 10, 12, cin)).astype(np.float32)
    conv = TL.Conv2d(cin, cout, 3, padding=1)
    conv.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    conv.bias.data = torch.from_numpy(b)
    return {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}, conv, x


@pytest.mark.parametrize("a_scale", [None, 2.5], ids=["dynamic", "static"])
@pytest.mark.parametrize("stride,padding", [(1, ((1, 1), (1, 1))), (2, ((1, 1), (1, 1))),
                                            (2, ((0, 1), (0, 1)))],
                         ids=["s1", "s2", "s2_encoder_down"])
def test_conv2d_int8_matches_jax(stride, padding, a_scale):
    p, conv, x = _conv_case(3)
    want = np.asarray(JQ.conv2d_int8(JQ.quantize_conv_tree(p, a_scales=a_scale),
                                     jnp.asarray(x), stride=stride, padding=padding))
    conv.stride = (stride, stride)
    m = TQ.Int8Conv2d(conv, a_scale)
    before = (TQ.quantize_s8.launches, TQ.conv2d_int8.launches)
    got = m(torch.from_numpy(x), padding=padding).numpy()
    assert (TQ.quantize_s8.launches, TQ.conv2d_int8.launches) == before  # plain on the CPU
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("a_scale", [None, 2.5], ids=["dynamic", "static"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_int8_matches_torch_oracle(stride, a_scale):
    """Against `tests/helpers/torch_oracle.int8_w8a8`, the f64 emulation
    `tests/test_int8_oracle.py` holds the JAX op to (NCHW, symmetric
    padding)."""
    _, conv, x = _conv_case(4, cin=32, cout=32)
    sd = {"c.weight": conv.weight.data, "c.bias": conv.bias.data}
    with torch.no_grad(), TO.int8_w8a8(None if a_scale is None else {"c": a_scale}):
        want = TO._conv(sd, "c", torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride,
                        padding=1).permute(0, 2, 3, 1).numpy()
    conv.stride = (stride, stride)
    got = TQ.Int8Conv2d(conv, a_scale)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("a_scale", [None, 4.0], ids=["dynamic", "static"])
def test_linear_int8_matches_jax(a_scale):
    rng = np.random.default_rng(5)
    k = rng.normal(size=(64, 96)).astype(np.float32) * 0.1
    b = rng.normal(size=(96,)).astype(np.float32) * 0.1
    x = rng.normal(size=(3, 50, 64)).astype(np.float32)
    p = JQ.quantize_linear_tree({"l": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}},
                                lambda _: True, a_scales=a_scale)["l"]
    want = np.asarray(JQ.linear_int8(p, jnp.asarray(x)))
    lin = torch.nn.Linear(64, 96)
    lin.weight.data, lin.bias.data = torch.from_numpy(k.T.copy()), torch.from_numpy(b)
    before = TQ.linear_int8.launches
    got = TQ.Int8Linear(lin, a_scale)(torch.from_numpy(x)).numpy()
    assert TQ.linear_int8.launches == before  # no torch._int_mm on the CPU
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_quantize_modules_swaps_in_place(models):
    _, _, tu, tv = models
    v = TQ.quantize_conv_modules(copy.deepcopy(tv), a_scales={"encoder.conv_out": 1.0})
    q = {n: m for n, m in v.named_modules() if isinstance(m, TQ.Int8Conv2d)}
    assert sorted(q) == sorted(TQ.conv_sites(tv))
    assert float(q["encoder.conv_out"].s_a) == float(TQ.static_s_a(1.0))
    assert all(m.s_a is None for n, m in q.items() if n != "encoder.conv_out")  # dynamic
    u = TQ.quantize_linear_modules(copy.deepcopy(tu), a_scales=2.0)
    lq = [m for m in u.modules() if isinstance(m, TQ.Int8Linear)]
    assert len(lq) == len(TQ.linear_sites(tu)) and all(
        float(m.s_a) == float(TQ.static_s_a(2.0)) for m in lq)


def test_calibration_batch_equals_jax():
    rng = np.random.default_rng(0)
    base = rng.uniform(-1.0, 1.0, (2, 16, 16, 3)).astype(np.float32)
    imgs = jax.image.resize(jnp.asarray(base), (2, 256, 256, 3), "linear")
    want = np.asarray(jnp.clip(imgs + jnp.asarray(rng.normal(0, 0.08, imgs.shape),
                                                  jnp.float32), -1.0, 1.0))
    got = TQ.vae_calibration_batch(256).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6


def _rel(got, want):
    assert want and set(got) == set(want), set(got) ^ set(want)
    return max(abs(got[k] - want[k]) / want[k] for k in want)


def test_vae_scales_match_jax(models):
    _, vp, _, tv = models
    want = JQ.calibrate_vae_scales(vp, VAEConfig.tiny(), dtype=jnp.float32,
                                   resolution=CALIB_PX)
    got = TQ.calibrate_vae_scales(tv, dtype=torch.float32, resolution=CALIB_PX)
    assert _rel(got, want) <= 1e-5


def test_unet_scales_match_jax(models):
    """JAX's procedure (`pipeline.py:226-248`) against
    `calibrate_unet_scales`, with a zero context (no text encoder)."""
    up, _, tu, _ = models
    ucfg = UNetConfig.tiny()
    ctx = np.zeros((1, 2, ucfg.cross_attention_dim), np.float32)
    rng = np.random.default_rng(0)
    lat = jnp.asarray(rng.normal(size=(1, 32, 32, 4)), jnp.float32)
    ref = jnp.asarray(rng.normal(size=(1, 1, 32, 32, 8)), jnp.float32)
    run = lambda p, lat, ref, c: JU.forward(p, ucfg, lat, 1, c, ref_sample=ref)
    want = JQ.calibrate_conv_scales(run, JQ.tag_linear_sites(up), lat, ref, jnp.asarray(ctx))
    got = TQ.calibrate_unet_scales(tu, torch.from_numpy(ctx))
    assert _rel(got, want) <= 1e-5
