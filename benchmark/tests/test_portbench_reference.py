"""The plain float32 reference against the port's plain path (CPU, tiny
configurations, float32): the models part by part, the episode and the
cached query end to end, and W8A8's derived scales and quantized sites.

The test may import both; the reference imports nothing of the port
(`test_portbench_isolation.py`)."""

import numpy as np
import pytest
import torch

from benchmark import core, generator, weights
from benchmark.reference import episode as ref_lib
from benchmark.reference import model as M
from benchmark.tests import tiny

SEED = 2 ** 40 + 3


def _pair(cfg, seed=SEED):
    ref = ref_lib.Reference(cfg, weights.as_float32(weights.make(cfg, seed, "cpu")), "cpu")
    pipe = core.build_program(cfg, weights.make(cfg, seed, "cpu"), tiny.CPU)
    return ref, pipe


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _close(got, want, rel=1e-4):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.abs().max().item(), (err, want.abs().max().item())


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair(tiny.config("sd21-bf16"))


def test_weights_load_strictly_into_the_port(bf16_pair):
    """The reference's layout is the port's state_dict, name for name and
    shape for shape (`build_program` loads with strict=True)."""
    ref, pipe = bf16_pair
    assert set(ref.unet.weights) == set(pipe.unet.state_dict())
    assert set(ref.vae.weights) == set(pipe.vae.state_dict())


def test_text_embedding(bf16_pair):
    ref, pipe = bf16_pair
    _close(pipe.empty_text_embed, ref.context)


def test_vae_and_unet(bf16_pair):
    ref, pipe = bf16_pair
    g = torch.Generator().manual_seed(1)
    img = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    with torch.no_grad():
        lat = M.vae_encode_mean(ref.vae, ref.vae_cfg, img)
        _close(pipe.vae.encode_mean_latent(_nhwc(img), attn_impl="auto", resnet_impl="xla"),
               _nhwc(lat))
        _close(pipe.vae.decode(_nhwc(lat), attn_impl="auto", resnet_impl="xla"),
               _nhwc(M.vae_decode(ref.vae, ref.vae_cfg, lat)))
        q = torch.randn((2, 4, 16, 16), generator=g)
        sup = torch.randn((2, 3, 8, 16, 16), generator=g)
        want = M.unet(ref.unet, ref.unet_cfg, q, 1, ref.context, ref=sup)
        got = pipe.unet(_nhwc(q), 1, pipe.empty_text_embed.expand(2, -1, -1),
                        ref_sample=sup.permute(0, 1, 3, 4, 2).contiguous())
        _close(got, _nhwc(want))


@pytest.mark.parametrize("traffic", ["episode-1shot-b8", "cached-5shot-b8"])
def test_outputs_end_to_end(bf16_pair, traffic):
    """uint8 images within one count (float32 rounding at a truncation
    edge), masks equal but at such pixels."""
    ref, pipe = bf16_pair
    t = tiny.traffic(traffic)
    inputs = generator.make(t, SEED, 32, "cpu")
    got = {}
    if t["mode"] == "cached":
        s = inputs["support_set"]
        cache = pipe.precompute_supports(s["supports"], s["masks"])
        for i, b in enumerate(inputs["batches"]):
            got[i] = pipe.predict_cached(b["query"], cache, r_threshold=t["r_threshold"])
    else:
        for i, b in enumerate(inputs["batches"]):
            got[i] = pipe.predict(b["query"], b["supports"], b["masks"], r_threshold=t["r_threshold"])
    want = checks_outputs(ref, t, inputs)
    for i, out in got.items():
        d = np.abs(out.seg_colored.astype(int) - want[i][0].astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
        assert (out.mask != want[i][1]).mean() <= (d > 0).mean()


def checks_outputs(ref, t, inputs):
    from benchmark import checks
    return checks.reference_outputs(ref, t, inputs, range(len(inputs["batches"])), "cpu")


def test_w8a8_scales_and_sites():
    """The reference calibrates the same static scales (float32 rounding
    apart) at the same sites; with the port's scales its quantized VAE and
    UNet compute the port's functions."""
    from diffews_tpu_torch.ops import quant

    cfg = tiny.config("sd21-w8a8")
    ref, _ = _pair(cfg)
    plain = core.build_program({**cfg, "vae_impl": "xla", "unet_int8": False},
                               weights.make(cfg, SEED, "cpu"), tiny.CPU)
    vs = quant.calibrate_vae_scales(plain.vae, dtype=torch.float32)
    us = quant.calibrate_unet_scales(plain.unet, plain.empty_text_embed)
    rv, ru = ref.vae.quant.scales, ref.unet.quant.scales
    assert set(vs) == set(rv) and set(us) == set(ru) and len(ru) > 0 and len(rv) > 0
    assert max(abs(vs[k] / rv[k] - 1) for k in vs) < 1e-5
    assert max(abs(us[k] / ru[k] - 1) for k in us) < 1e-5

    quant.quantize_conv_modules(plain.vae, a_scales=vs)
    quant.quantize_linear_modules(plain.unet, a_scales=us)
    ref.vae.quant.scales, ref.unet.quant.scales = vs, us
    g = torch.Generator().manual_seed(2)
    img = torch.rand((2, 3, 32, 32), generator=g) * 2 - 1
    with torch.no_grad():
        lat = M.vae_encode_mean(ref.vae, ref.vae_cfg, img)
        _close(plain.vae.encode_mean_latent(_nhwc(img), resnet_impl="xla"), _nhwc(lat))
        _close(plain.vae.decode(_nhwc(lat), resnet_impl="xla"),
               _nhwc(M.vae_decode(ref.vae, ref.vae_cfg, lat)))
        q = torch.randn((2, 4, 16, 16), generator=g)
        sup = torch.randn((2, 1, 8, 16, 16), generator=g)
        _close(plain.unet(_nhwc(q), 1, plain.empty_text_embed.expand(2, -1, -1),
                          ref_sample=sup.permute(0, 1, 3, 4, 2).contiguous()),
               _nhwc(M.unet(ref.unet, ref.unet_cfg, q, 1, ref.context, ref=sup)))


def test_training_step_in_float32_follows_the_reference():
    """The port's training step in float32 (compute and first moment)
    follows the float32 reference through every compared step: losses,
    gradient norms and each leaf's change (the schedule, bias corrections,
    clip and AdamW of the later steps, not only the first)."""
    from benchmark.kinds import train

    c = tiny.cell("sd21.train-1shot-b4")
    c.traffic["trainer"]["first_moment_dtype"] = "float32"
    _, nums = core.run_cell(c, SEED, 0.3, False, "cpu")
    assert set(nums) == set(train.NUMBERS)
    assert max(nums.values()) < 2e-4, nums
