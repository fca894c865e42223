"""The architectures the reference walks.

SD-2.1: the layouts (so every seed's draws) and the work of each cell are
pinned to the values the harness read before the walk learnt SDXL's
options.  SDXL base 1.0: at its published widths on the meta device, the
walk gives the published parameter counts; a tiny SDXL-shaped
configuration draws its weights and runs the reference on the CPU, and
each added path moves the output."""

import hashlib
import json
import math

import pytest
import torch

from benchmark import generator, weights, work
from benchmark.reference import episode as ref_lib
from benchmark.reference import model as M
from benchmark.tests import sdxl, tiny

# Computed on the harness as it was before the walk took per-level depth,
# added conditioning and a second tower (SD-2.1 only): a layout's tensors,
# elements and the digest of its (name, shape) list in walk order.
LAYOUTS = {"unet": (688, 865934084, "675ce78c0646341d"),
           "vae": (248, 83653863, "5d30255fdf4c9df4"),
           "text": (372, 340387840, "50166468ed322651")}
# ... and each cell's `batch_work`: flops, int8 operations, the numbers of
# flash, flash-backward, GroupNorm+SiLU and int8 conv sites, and the digest
# of the four site lists.
WORK = {"sd21.episode-1shot-b8": (60646410551296.0, 0.0, 34, 0, 94, 0, "6e20d4d3ae7d1f81"),
        "w8a8.episode-1shot-b8": (60646410551296.0, 48700097298432.0, 34, 0, 94, 56,
                                  "57bb7473dc96715c"),
        "sd21.train-1shot-b4": (38637480574976.0, 0.0, 33, 32, 21, 0, "a832fddbfdcaa42d"),
        "sd21.cached-5shot-b8": (40324482334720.0, 0.0, 18, 0, 94, 0, "a529e168ad591e83")}


def _digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _spec():
    return json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


def _config(name):
    file = next(c["file"] for c in _spec()["configs"] if c["name"] == name)
    return json.loads((tiny.ROOT / file).read_text())


@pytest.mark.parametrize("name", ["sd21-bf16", "sd21-w8a8"])
def test_sd21_layouts_are_unchanged(name):
    lay = weights.layouts(_config(name))
    assert list(lay) == ["unet", "vae", "text"]
    for key, layout in lay.items():
        text = "".join(f"{n}:{','.join(map(str, s))};" for n, s in layout.items())
        got = (len(layout), sum(math.prod(s) for s in layout.values()), _digest(text))
        assert got == LAYOUTS[key], (key, got)


@pytest.mark.parametrize("cell", sorted(WORK))
def test_sd21_batch_work_is_unchanged(cell):
    entry = next(w for w in _spec()["workloads"] if w["name"] == cell)
    traffic = json.loads((tiny.BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    w = work.batch_work(_config(entry["config"]), traffic, tiny.ROOT)
    sites = _digest(repr((w.attention, w.attention_bwd, w.gn_silu, w.int8_conv)))
    got = (w.flops, w.int8_ops, len(w.attention), len(w.attention_bwd), len(w.gn_silu),
           len(w.int8_conv), sites)
    assert got == WORK[cell]


def _count(layout, skip=()):
    return sum(math.prod(s) for n, s in layout.items() if not n.startswith(skip))


def test_sdxl_base_at_published_widths():
    """SDXL base 1.0's UNet has 2,567,463,684 parameters (23,360 more with
    DiffewS's conv_in_ref), 70 self-attention sites that KV-fusion
    replaces, and an `add_embedding` from 2816 wide; CLIP ViT-L/14 has
    123,060,480 and bigG/14 with its projection 694,659,840."""
    lay = weights.layouts(sdxl.published())
    unet = lay["unet"]
    assert list(lay) == ["unet", "vae", "text", "text_2"]
    assert _count(unet, ("conv_in_ref.",)) == 2_567_463_684
    assert _count(unet) == 2_567_487_044
    assert sum(n.endswith(".attn1.to_q.weight") for n in unet) == 70
    assert unet["add_embedding.linear_1.weight"] == (1280, 2816)
    assert "down_blocks.2.attentions.1.transformer_blocks.9.attn1.to_q.weight" in unet
    assert "mid_block.attentions.0.transformer_blocks.9.ff.net.2.weight" in unet
    assert "down_blocks.0.attentions.0.norm.weight" not in unet
    assert _count(lay["text"]) == 123_060_480 and "text_projection.weight" not in lay["text"]
    assert _count(lay["text_2"]) == 694_659_840
    assert lay["text_2"]["text_projection.weight"] == (1280, 1280)
    assert lay["unet"]["down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k.weight"] == (
        640, 2048)


def test_sdxl_episode_work():
    """A 1-shot SDXL episode at 1024 px: the joint UNet 14.11 TFLOP (16% of
    it flash attention, its 70 sites as 140 launches: support and query
    streams), 3 encodes 14.64, 1 decode 10.47; the batch's work adds them,
    with the VAE's two mid-block flash sites."""
    cfg = sdxl.published()
    ctx, added = M.conditioning({k: M.Net() for k in M.TOWERS}, cfg, False, "meta")
    meta = lambda *s: torch.empty(s, device="meta")
    u = M.Work()
    M.unet(M.Net(work=u), cfg["unet"], meta(1, 4, 128, 128), 1, ctx, ref=meta(1, 1, 8, 128, 128),
           added=added)
    flash = sum(4.0 * b * h * sq * skv * d for b, h, sq, skv, d in u.attention)
    assert u.flops == pytest.approx(14.109e12, rel=1e-4) and len(u.attention) == 140
    assert flash / u.flops == pytest.approx(0.16, abs=0.005)
    t = json.loads((tiny.BENCH / "traffic" / "episode-1shot-b8.json").read_text())
    w = work.batch_work(cfg, {**t, "batch": 1})
    assert w.flops == pytest.approx((14.109 + 14.637 + 10.470) * 1e12, rel=1e-4)
    assert len(w.attention) == 142


def test_tiny_sdxl_layout_takes_depth_per_level():
    """Down level i takes depth [i], the mid block [-1], up block i the
    reversed list's [i]."""
    u = weights.layouts(sdxl.config())["unet"]
    has = lambda blk, k: f"{blk}.transformer_blocks.{k}.attn1.to_q.weight" in u
    for blk, depth in (("down_blocks.1.attentions.0", 2), ("down_blocks.2.attentions.0", 3),
                       ("mid_block.attentions.0", 3), ("up_blocks.0.attentions.1", 3),
                       ("up_blocks.1.attentions.1", 2)):
        assert has(blk, depth - 1) and not has(blk, depth), blk
    assert not any(n.startswith(("down_blocks.0.attentions", "up_blocks.2.attentions")) for n in u)


@pytest.fixture(scope="module")
def tiny_sdxl():
    cfg = sdxl.config()
    wts = weights.as_float32(weights.make(cfg, 2 ** 41 + 11, "cpu"))
    return cfg, wts, ref_lib.Reference(cfg, wts, "cpu")


def test_tiny_sdxl_episode_runs(tiny_sdxl):
    cfg, _, ref = tiny_sdxl
    assert ref.context.shape == (1, 2, cfg["unet"]["cross_attention_dim"])
    pooled, tids = ref.added
    assert pooled.shape == (1, 24) and tids.tolist() == [32.0, 32.0, 0.0, 0.0, 32.0, 32.0]
    inputs = generator.make(tiny.traffic(), 5, cfg["resolution"], "cpu")
    b = inputs["batches"][0]
    t = lambda a: generator.as_tensor(a, torch.device("cpu"))
    seg = ref.episode(t(b["query"]), t(b["supports"]), t(b["masks"]))
    assert seg.shape == (2, 32, 32, 3) and seg.dtype == torch.uint8


def _prediction(ref, context, added):
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 4, 8, 8), generator=g)
    sup = torch.randn((1, 1, 8, 8, 8), generator=g)
    with torch.no_grad():
        return M.unet(ref.unet, ref.unet_cfg, q, 1, context, ref=sup, added=added)


def test_tiny_sdxl_each_added_path_is_live(tiny_sdxl):
    """The UNet's output moves with the pooled embedding, the time ids and
    the towers' context layer; a UNet that asks for added conditioning
    refuses to run without it."""
    cfg, wts, ref = tiny_sdxl
    pooled, tids = ref.added
    base = _prediction(ref, ref.context, ref.added)
    assert torch.isfinite(base).all()
    moved = {"pooled": _prediction(ref, ref.context, (pooled * 1.5, tids)),
             "time_ids": _prediction(ref, ref.context,
                                     M.conditioning({k: M.Net(wts[k]) for k in M.TOWERS}, {
                                         **cfg, "resolution": 64}, False, "cpu")[1])}
    final = {**cfg, "text": {**cfg["text"], "context_layer": "final"},
             "text_2": {**cfg["text_2"], "context_layer": "final"}}
    ctx, added = M.conditioning({k: M.Net(wts[k]) for k in M.TOWERS}, final, False, "cpu")
    assert torch.equal(added[0], pooled)
    moved["context_layer"] = _prediction(ref, ctx, added)
    for name, out in moved.items():
        assert torch.isfinite(out).all() and (out - base).abs().max() > 1e-4, name
    with pytest.raises(ValueError, match="addition_embed_type"):
        _prediction(ref, ref.context, None)


def test_quick_gelu():
    x = torch.linspace(-6, 6, 101)
    assert torch.equal(M.activation("quick_gelu", x), x * torch.sigmoid(1.702 * x))
    assert torch.equal(M.activation("gelu", x), torch.nn.functional.gelu(x))
    with pytest.raises(ValueError, match="hidden_act"):
        M.activation("relu", x)
