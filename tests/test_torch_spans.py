"""The port's spans (`utils/profiling.py`): off, they cost one global read
and record nothing; on, a tiny episode, a cached query and a training step
record each stage and module once per call where the model says so, each
inside its outer span, and compute bit for bit what they compute with
spans off.  CPU, tiny configs, random weights (no JAX)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch import pipeline as TP
from diffews_tpu_torch.training import state as TS
from diffews_tpu_torch.utils import profiling
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

PIPELINE_LEAVES = ("diffews.pipeline.upload", "diffews.pipeline.encode",
                   "diffews.pipeline.unet", "diffews.pipeline.decode",
                   "diffews.pipeline.threshold")
TRAIN_LEAVES = ("diffews.train.latents", "diffews.train.forward", "diffews.train.backward",
                "diffews.train.optimizer")


@pytest.fixture(scope="module")
def pipe():
    bundle = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                       TCF.SchedulerConfig.diffews())
    return TP.DiffewsPipeline(bundle, device="cpu")


def _episode(b=2, n=1, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, n, s, s, 3), dtype=np.uint8),
            (rng.random((b, n, s, s)) > 0.5).astype(np.uint8))


def _captured(fn):
    """fn()'s result and the `diffews.*` events it recorded, as (name,
    start µs, end µs, thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
             if e.name.startswith("diffews.")]
    return out, spans


def _count(spans, name):
    return sum(1 for s in spans if s[0] == name)


def _inside(spans, leaves, outer):
    """Every event of `leaves` lies within an `outer` event."""
    outs = [s for s in spans if s[0] == outer]
    for name, t0, t1, _ in spans:
        if name in leaves:
            assert any(o[1] <= t0 and t1 <= o[2] for o in outs), (name, outer)


def _predict(pipe, **kw):
    q, sup, m = _episode()
    out = pipe.predict_async(q, sup, m, r_threshold=0.5, **kw).result()
    return out.seg_colored, out.mask


def test_spans_off_are_one_null_context(pipe):
    assert profiling.annotate("diffews.pipeline.encode") is profiling.annotate("x")
    assert isinstance(profiling.annotate("x"), type(profiling._OFF))
    _, spans = _captured(lambda: _predict(pipe))
    assert spans == []


def test_spans_on_restores_the_state_before():
    with profiling.spans_on():
        with profiling.spans_on():
            pass
        assert profiling.annotate("x") is not profiling._OFF
    assert profiling.annotate("x") is profiling._OFF


def test_episode_spans_and_outputs(pipe):
    """One episode: the stages once each (an upload per host array), one
    down/up block span per level, one span per resnet and transformer of
    the UNet; the uint8 image and mask bit for bit as with spans off."""
    want = _predict(pipe)
    with profiling.spans_on():
        got, spans = _captured(lambda: _predict(pipe, mask_on_device=True))
        got_host, _ = _captured(lambda: _predict(pipe))
    for a, b in zip(want + want, got + got_host):
        np.testing.assert_array_equal(a, b)
    ucfg, vcfg = pipe.unet_cfg, pipe.vae_cfg
    n = ucfg.num_levels
    assert _count(spans, "diffews.pipeline.predict") == 1
    assert _count(spans, "diffews.pipeline.upload") == 3
    for name in ("encode", "unet", "decode", "threshold"):
        assert _count(spans, f"diffews.pipeline.{name}") == 1, name
    assert _count(spans, "diffews.pending.result") == 1
    for i in range(n):
        assert _count(spans, f"diffews.unet.down{i}") == 1
        assert _count(spans, f"diffews.unet.up{i}") == 1
    assert _count(spans, "diffews.unet.mid") == 1
    resnets = n * ucfg.layers_per_block + 2 + n * (ucfg.layers_per_block + 1)
    assert _count(spans, "diffews.unet.resnet") == resnets
    levels = len(vcfg.block_out_channels)
    for i in range(levels):
        assert _count(spans, f"diffews.vae.encoder.down{i}") == 1
        assert _count(spans, f"diffews.vae.decoder.up{i}") == 1
    for name in ("encoder.mid", "encoder.head", "decoder.mid", "decoder.head"):
        assert _count(spans, f"diffews.vae.{name}") == 1, name
    assert _count(spans, "diffews.vae.attention") == 2
    _inside(spans, PIPELINE_LEAVES, "diffews.pipeline.predict")
    _inside(spans, ("diffews.unet.down0", "diffews.unet.mid"), "diffews.pipeline.unet")
    _inside(spans, ("diffews.vae.encoder.down0",), "diffews.pipeline.encode")
    _inside(spans, ("diffews.vae.decoder.up0",), "diffews.pipeline.decode")


def test_cached_spans_and_outputs(pipe):
    q, sup, m = _episode(b=1, n=2, seed=1)
    cache = pipe.precompute_supports(sup, m)
    want = pipe.predict_cached(q, cache).seg_colored
    with profiling.spans_on():
        (_, got), spans = _captured(
            lambda: (c := pipe.precompute_supports(sup, m),
                     pipe.predict_cached(q, c).seg_colored))
    np.testing.assert_array_equal(want, got)
    assert _count(spans, "diffews.pipeline.capture") == 1
    assert _count(spans, "diffews.pipeline.predict_cached") == 1
    assert _count(spans, "diffews.pipeline.encode") == 2  # the supports', the query's
    assert _count(spans, "diffews.pipeline.decode") == 1
    t = next(s[1] for s in spans if s[0] == "diffews.pipeline.predict_cached")
    capture = [s for s in spans if s[1] < t]
    query = [s for s in spans if s[1] >= t]
    _inside(capture, ("diffews.pipeline.upload", "diffews.pipeline.encode",
                      "diffews.pipeline.unet"), "diffews.pipeline.capture")
    _inside(query, PIPELINE_LEAVES, "diffews.pipeline.predict_cached")
    assert {s[0] for s in query if s[0] in PIPELINE_LEAVES} == set(PIPELINE_LEAVES)


def _train_step():
    """The loss and the parameters after one f32 remat step of a tiny
    model from fixed weights, batch and posterior draws."""
    bundle = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                       TCF.SchedulerConfig.diffews(), seed=3)
    cfg = TS.TrainerConfig(compute_dtype=torch.float32, adam_mu_dtype=torch.float32,
                           max_train_steps=10, learning_rate=1e-3, remat=True)
    unet, vae = bundle.unet, bundle.vae.requires_grad_(False)
    state = TS.init_state(cfg, {n: p.detach().clone() for n, p in unet.named_parameters()},
                          device="cpu")
    rng = np.random.default_rng(4)
    f = lambda *sh: torch.from_numpy(rng.uniform(-1, 1, sh).astype(np.float32))
    batch = {"query": f(1, 1, 32, 32, 3), "q_mask3": f(1, 1, 32, 32, 3),
             "supports": f(1, 1, 1, 32, 32, 3), "s_mask3": f(1, 1, 1, 32, 32, 3),
             "shot_mask": torch.ones((1, 1, 1), dtype=torch.bool)}
    text = f(1, 77, unet.cfg.cross_attention_dim)
    state, metrics = TS.make_train_step(cfg, unet)(
        state, batch, torch.Generator().manual_seed(5), vae, text)
    return metrics["loss"], state.params, unet.cfg


def test_train_step_spans_and_outputs():
    loss, params, ucfg = _train_step()
    with profiling.spans_on():
        (loss_on, params_on, _), spans = _captured(_train_step)
    assert torch.equal(loss, loss_on)
    assert all(torch.equal(params[n], params_on[n]) for n in params)
    assert _count(spans, "diffews.train.step") == 1
    for name in TRAIN_LEAVES:
        assert _count(spans, name) == 1, name
    assert _count(spans, "diffews.train.reduce") == _count(spans, "diffews.train.ema") == 0
    _inside(spans, TRAIN_LEAVES, "diffews.train.step")
    for i in range(ucfg.num_levels):
        assert _count(spans, f"diffews.unet.down{i}") == 1
    # remat recomputes every layer in the backward: each resnet twice
    resnets = ucfg.num_levels * (2 * ucfg.layers_per_block + 1) + 2
    assert _count(spans, "diffews.unet.resnet") == 2 * resnets
    _inside(spans, ("diffews.vae.encoder.down0",), "diffews.train.latents")
    _inside(spans, ("diffews.unet.down0",), "diffews.train.forward")


def test_launch_counts_reads_every_counter():
    from diffews_tpu_torch.ops import adamw, downsample, fused_resnet, groupnorm, quant
    from diffews_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd

    want = {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention_bwd.dq_launches,
            "flash_attention_bwd_dkv": flash_attention_bwd.dkv_launches,
            "gn_stats": groupnorm.gn_stats_kernel.launches,
            "gn_apply": groupnorm.gn_apply_kernel.launches,
            "fused_gn_silu_conv3x3": fused_resnet.gn_silu_conv3x3.launches,
            "downsample_conv2x": downsample.downsample_conv2x.launches,
            "quantize_s8": quant.quantize_s8.launches,
            "conv2d_int8": quant.conv2d_int8.launches,
            "int_mm": quant.linear_int8.launches,
            "adamw_norm": adamw.norm_pass.launches,
            "adamw_finalise": adamw.finalise_pass.launches,
            "adamw_apply": adamw.apply_pass.launches,
            "adamw_layout_copies": adamw.match_layouts.layout_copies}
    assert profiling.launch_counts() == want
    flash_attention.launches += 7
    try:
        assert profiling.launch_counts()["flash_attention_fwd"] == want["flash_attention_fwd"] + 7
    finally:
        flash_attention.launches -= 7
