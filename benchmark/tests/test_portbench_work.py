"""The benchmark's work counts against `torch.utils.flop_counter` on the
meta device: the reference's walk, and the port's own modules (plain
GroupNorm, dense attention), at tiny and full SD-2.1 sizes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import model as M
from benchmark.tests import tiny


def _meta(*s):
    return torch.empty(s, device="meta")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _port_modules(cfg):
    from diffews_tpu_torch import configs
    from diffews_tpu_torch.models.unet import UNet2DConditionModel
    from diffews_tpu_torch.models.vae import AutoencoderKL

    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    with torch.device("meta"):
        return (UNet2DConditionModel(configs.UNetConfig(**tup(cfg["unet"]))),
                AutoencoderKL(configs.VAEConfig(**tup(cfg["vae"]))))


def _episode_parts(cfg, b, n):
    """Per part of a b-row, n-shot episode: (counted by the reference's
    Work, by FlopCounterMode on the reference, by FlopCounterMode on the
    port's modules)."""
    uc, vc, r = cfg["unet"], cfg["vae"], cfg["resolution"]
    h = r // 2 ** (len(vc["block_out_channels"]) - 1)
    unet, vae = _port_modules(cfg)
    ctx = _meta(1, 2, uc["cross_attention_dim"])
    img, lat = _meta(b, 3, r, r), _meta(b, uc["in_channels"], h, h)
    ref = _meta(b, n, uc["ref_in_channels"], h, h)
    nhwc = lambda x: torch.empty((x.shape[0],) + tuple(x.shape[2:]) + (x.shape[1],), device="meta")
    parts = {
        "encode": (lambda net: M.vae_encode_mean(net, vc, img),
                   lambda: vae.encode_mean_latent(nhwc(img), attn_impl="dense", resnet_impl="xla")),
        "decode": (lambda net: M.vae_decode(net, vc, _meta(b, vc["latent_channels"], h, h)),
                   lambda: vae.decode(nhwc(lat), attn_impl="dense", resnet_impl="xla")),
        "unet": (lambda net: M.unet(net, uc, lat, 1, ctx, ref=ref),
                 lambda: unet(nhwc(lat), 1, ctx.expand(b, -1, -1), attn_impl="dense",
                              ref_sample=torch.empty((b, n, h, h, uc["ref_in_channels"]),
                                                     device="meta"))),
    }
    out = {}
    for k, (walk, port) in parts.items():
        w = M.Work()
        walk(M.Net(work=w))
        out[k] = (w.flops, _counted(lambda: walk(M.Net())), _counted(port))
    return out


@pytest.fixture
def plain_groupnorm(monkeypatch):
    """The port's GroupNorm+SiLU as its plain formula (it has no meta
    kernel; GroupNorm adds no products)."""
    from diffews_tpu_torch.models import layers
    from diffews_tpu_torch.ops import groupnorm

    monkeypatch.setattr(layers, "group_norm_act",
                        lambda x, w, b, *, groups, eps, act: groupnorm.group_norm_act_reference(
                            x, w, b, groups=groups, eps=eps, act=act))


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_counts_equal_flop_counter(size, plain_groupnorm):
    cfg = tiny.config() if size == "tiny" else json.loads(
        (tiny.BENCH / "configs" / "sd21-bf16.json").read_text())
    for part, (mine, ref_fc, port_fc) in _episode_parts(cfg, 2, 1).items():
        assert mine == ref_fc, (part, mine, ref_fc)
        # the port projects the one time embedding once per row (every row
        # shares the timestep); the model needs it once
        assert port_fc >= mine and port_fc == pytest.approx(mine, rel=1e-3), (part, port_fc)


def test_full_size_episode_work(plain_groupnorm):
    """A 1-shot SD-2.1 episode at 512px: 3 encodes + the joint UNet + 1
    decode = 7.58 TFLOP, 77% of it the VAE; the 5-shot joint UNet 5.39."""
    cfg = json.loads((tiny.BENCH / "configs" / "sd21-bf16.json").read_text())
    p = {k: v[0] for k, v in _episode_parts(cfg, 1, 1).items()}
    assert p["encode"] == pytest.approx(1.117e12, rel=1e-3)
    assert p["decode"] == pytest.approx(2.515e12, rel=1e-3)
    assert p["unet"] == pytest.approx(1.716e12, rel=1e-3)
    total = 3 * p["encode"] + p["unet"] + p["decode"]
    assert total == pytest.approx(7.58e12, rel=2e-3)
    assert (3 * p["encode"] + p["decode"]) / total == pytest.approx(0.77, abs=0.01)
    assert _episode_parts(cfg, 1, 5)["unet"][0] == pytest.approx(5.394e12, rel=1e-3)
    t = json.loads((tiny.BENCH / "traffic" / "episode-1shot-b8.json").read_text())
    # the batch shares one time embedding where eight episodes count eight
    assert work.batch_work(cfg, t).flops == pytest.approx(8 * total, rel=1e-5)


def test_site_lists_at_full_size():
    """The sites the rooflines count, per b8 batch: 34 flash launches (16
    UNet self-attention sites as 32 launches, 2 VAE mid blocks), 94
    GroupNorm+SiLU sites, 56 int8 convs under W8A8 (128 int8 linears)."""
    cfg = json.loads((tiny.BENCH / "configs" / "sd21-bf16.json").read_text())
    t = json.loads((tiny.BENCH / "traffic" / "episode-1shot-b8.json").read_text())
    w = work.batch_work(cfg, t)
    assert len(w.attention) == 34 and len(w.gn_silu) == 94 and w.int8_ops == 0
    w8 = work.batch_work({**cfg, "vae_impl": "int8", "unet_int8": True}, t)
    assert len(w8.int8_conv) == 56 and 0 < w8.int8_ops < w8.flops
    c = json.loads((tiny.BENCH / "traffic" / "cached-5shot-b8.json").read_text())
    wc = work.batch_work(cfg, c)
    assert len(wc.attention) == 16 + 2 and wc.attention[1][2:4] == (4096, 6 * 4096)
