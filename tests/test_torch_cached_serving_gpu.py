"""Cached-support serving on the card: the cases that need the kernels.

Tiny configs, f32 with TF32 off: `precompute_supports` + `predict_cached`
on the card (flash and GroupNorm kernels) against the same on the CPU
(plain versions) and against the joint `predict` on the card, both
conditioning variants, with padded shots (uint8 within 1 count on < 1% of
pixels); a batch-1 cache under a batch-4 query against four batch-1 calls
and against the batch-4 cache made of four copies; the cache's entries are
contiguous copies on the card; a repeat is bit-identical.  Marked `gpu`:
each test skips without a CUDA device.  This file imports no JAX (the GPU
host has none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_cached_serving_gpu.py
"""

import numpy as np
import pytest
import torch

from diffews_tpu_torch.checkpoint import random_pipeline_bundle
from diffews_tpu_torch.configs import SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu_torch.ops.flash_attention import flash_attention
from diffews_tpu_torch.pipeline import DiffewsPipeline

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _pipe(device, **kw):
    bundle = random_pipeline_bundle(UNetConfig.tiny(), VAEConfig.tiny(), None,
                                    SchedulerConfig.diffews(), seed=0)
    return DiffewsPipeline(bundle, device=device, **kw)


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


@pytest.mark.parametrize("variant", [False, True], ids=["kv_fusion", "attn_mask"])
def test_cached_on_the_card_equals_cpu_and_joint(cuda, variant):
    gpu, cpu = _pipe(cuda, attn_mask_variant=variant), _pipe("cpu", attn_mask_variant=variant)
    q, sup, m = _episode(2, 3, seed=1)
    sm = np.array([[True, True, False], [True, True, True]])
    before = flash_attention.launches
    cache = gpu.precompute_supports(sup, m, shot_mask=sm)
    captured = flash_attention.launches - before
    assert captured > 0
    got = gpu.predict_cached(q, cache, r_threshold=0.25)
    assert 0 < flash_attention.launches - before - captured < captured
    for k, v, bias in cache.entries:
        assert k.is_cuda and k.is_contiguous() and v.is_contiguous()
        assert k.untyped_storage().nbytes() == k.numel() * k.element_size()
        assert (bias is not None) == variant
    want = cpu.predict_cached(q, cpu.precompute_supports(sup, m, shot_mask=sm),
                              r_threshold=0.25)
    _uint8_close(got.seg_colored, want.seg_colored)
    assert (got.mask != want.mask).mean() < 0.01
    joint = gpu.predict(q, sup, m, shot_mask=sm, r_threshold=0.25)
    _uint8_close(got.seg_colored, joint.seg_colored)
    again = gpu.predict_cached(q, cache, r_threshold=0.25)
    np.testing.assert_array_equal(again.seg_colored, got.seg_colored)


def test_batch1_cache_under_a_batch4_query(cuda):
    """The broadcast entries reach the flash launcher as contiguous tensors:
    the batch equals four batch-1 calls and the cache made of four copies."""
    gpu = _pipe(cuda)
    _, sup, m = _episode(1, 2, seed=2)
    qs = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    sm = np.array([[True, False]])
    cache = gpu.precompute_supports(sup, m, shot_mask=sm)
    batched = gpu.predict_cached(qs, cache, r_threshold=0.25, mask_on_device=True)
    for i in range(4):
        one = gpu.predict_cached(qs[i:i + 1], cache)
        _uint8_close(batched.seg_colored[i:i + 1], one.seg_colored)
    copies = gpu.precompute_supports(np.repeat(sup, 4, 0), np.repeat(m, 4, 0),
                                     shot_mask=np.repeat(sm, 4, 0))
    _uint8_close(gpu.predict_cached(qs, copies).seg_colored, batched.seg_colored)
    host = gpu.predict_cached(qs, cache, r_threshold=0.25)
    np.testing.assert_array_equal(batched.mask, host.mask)
