"""The serving daemon, the serving artifact and the custom ops on the card.

Tiny configs, f32 with TF32 off: every custom op (`torch.ops.diffews_tpu_torch`)
passes `torch.library.opcheck` on CUDA tensors (its fake implementation's
strides against the kernel's), launches its kernel once per call and agrees
with its plain version (f32: 1e-4, bf16: 2e-2 of max |plain|); the daemon's
one-off and cached answers equal a bare `predict` / `predict_cached` on the
same padded batch bit for bit, with the same kernel launches; the
micro-batcher's answers equal the unbatched daemon's; a cache evicted while
its call is in flight still gives that call's answer; an artifact exported
on the card and loaded back launches the same kernels as `predict` and
equals it bit for bit.  Marked `gpu`: each test
skips without a CUDA device.  This file imports no JAX (the GPU host has
none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_serve_gpu.py
"""

import base64
import gc
import threading

import numpy as np
import pytest
import torch

from diffews_tpu_torch import serving
from diffews_tpu_torch.checkpoint import random_pipeline_bundle
from diffews_tpu_torch.cli import serve
from diffews_tpu_torch.configs import SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu_torch.ops import downsample, flash_attention, fused_resnet, groupnorm
from diffews_tpu_torch.pipeline import DiffewsPipeline

pytestmark = pytest.mark.gpu
S = 32
OPS = torch.ops.diffews_tpu_torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _counts():
    return (flash_attention.flash_attention.launches, groupnorm.gn_stats_kernel.launches,
            groupnorm.gn_apply_kernel.launches, fused_resnet.gn_silu_conv3x3.launches,
            downsample.downsample_conv2x.launches)


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def _r(*shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype).cuda()


def _op_cases(dt):
    """name -> (op, args, plain version, index of its launch counter)."""
    q, k, v = _r(2, 200, 3, 64, seed=0, dtype=dt), _r(2, 300, 3, 64, seed=1, dtype=dt), \
        _r(2, 300, 3, 64, seed=2, dtype=dt)
    mask = torch.rand(2, 300, generator=torch.Generator().manual_seed(3)).cuda() > 0.3
    x = _r(2, 20, 24, 32, seed=4, dtype=dt)
    a, b = _r(2, 32, seed=5, dtype=dt), _r(2, 32, seed=6, dtype=dt)
    a32, b32 = _r(2, 32, seed=7), _r(2, 32, seed=8)
    w, bias = _r(16, 32, 3, 3, seed=9, dtype=dt) * 0.1, _r(16, seed=10)
    return {
        "flash_attention_fwd": (OPS.flash_attention_fwd, (q, k, v, mask, 0.125),
                                lambda: flash_attention.flash_attention_reference(
                                    q, k, v, scale=0.125, kv_mask=mask), 0),
        "gn_stats": (OPS.gn_stats, (x,), lambda: fused_resnet.gn_stats(x), 1),
        "gn_apply": (OPS.gn_apply, (x, a, b, "silu"),
                     lambda: groupnorm.gn_apply_reference(x, a, b, "silu"), 2),
        "fused_gn_silu_conv3x3": (OPS.fused_gn_silu_conv3x3, (x, a32, b32, w, bias, None),
                                  lambda: fused_resnet.gn_silu_conv3x3_reference(
                                      x, a32, b32, w, bias), 3),
        "downsample_conv2x": (OPS.downsample_conv2x, (x, w, bias),
                              lambda: downsample.downsample_conv2x_reference(x, w, bias), 4),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["flash_attention_fwd", "gn_stats", "gn_apply",
                                  "fused_gn_silu_conv3x3", "downsample_conv2x"])
def test_custom_op_on_the_card_matches_plain(cuda, case, dtype):
    op, args, plain, counter = _op_cases(dtype)[case]
    torch.library.opcheck(op, args)
    before = _counts()
    got = op(*args)
    torch.cuda.synchronize()
    assert _delta(before)[counter] == 1 and sum(_delta(before)) == 1
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.shape == w.shape and g.dtype == w.dtype
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= tol * w.abs().max().item(), case


def _pipe(device):
    bundle = random_pipeline_bundle(UNetConfig.tiny(), VAEConfig.tiny(), None,
                                    SchedulerConfig.diffews(), seed=0)
    return DiffewsPipeline(bundle, device=device)


def _raw(arr):
    return {"raw": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode(),
            "shape": list(arr.shape)}


def _unraw(ent):
    return np.frombuffer(base64.b64decode(ent["raw"]), np.uint8).reshape(ent["shape"])


def _episode(b, s=S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    sup = rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
    m = np.zeros((s, s), np.uint8)
    m[4:20, 8:28] = 1
    return q, sup, m


def test_daemon_equals_bare_predict_with_its_launches(cuda):
    pipe = _pipe(cuda)
    ms = serve.ModelServer(pipe=pipe, bsz=2, nshot=1, img_size=S, r_threshold=0.25,
                           batch_buckets="1,2")
    q, sup, m = _episode(2)
    # one-off, 2 queries: the bare predict on the same batch
    before = _counts()
    got = ms.segment({"query": [_raw(x) for x in q], "supports": [_raw(sup)],
                      "masks": [_raw(m)], "return_seg": True, "encoding": "raw"})
    n_daemon = _delta(before)
    before = _counts()
    want = pipe.predict(q, np.broadcast_to(sup, (2, 1) + sup.shape),
                        np.broadcast_to(m.astype(np.float32), (2, 1) + m.shape),
                        r_threshold=0.25)
    assert n_daemon == _delta(before) and n_daemon[0] > 0 and n_daemon[2] > 0
    for i in range(2):
        np.testing.assert_array_equal(_unraw(got["seg"][i]), want.seg_colored[i])
        np.testing.assert_array_equal(_unraw(got["masks"][i]) > 0, want.mask[i])
    # supports.add, then cached requests of 2 and of 1 (bucket 1)
    cid = ms.add_supports({"images": [_raw(sup)], "masks": [_raw(m)]})["cache_id"]
    cache = ms._caches[cid]
    for n in (2, 1):
        before = _counts()
        got = ms.segment({"query": [_raw(x) for x in q[:n]], "cache_id": cid,
                          "return_seg": True, "encoding": "raw"})
        n_daemon = _delta(before)
        before = _counts()
        want = pipe.predict_cached(q[:n], cache, r_threshold=0.25)
        assert n_daemon == _delta(before) and n_daemon[0] > 0
        for i in range(n):
            np.testing.assert_array_equal(_unraw(got["seg"][i]), want.seg_colored[i])


def test_micro_batcher_equals_unbatched(cuda):
    pipe = _pipe(cuda)
    ms = serve.ModelServer(pipe=pipe, bsz=4, nshot=1, img_size=S, r_threshold=0.25,
                           batch_window_ms=300)
    direct = serve.ModelServer(pipe=pipe, bsz=4, nshot=1, img_size=S, r_threshold=0.25)
    q, sup, m = _episode(4, seed=1)
    body = {"images": [_raw(sup)], "masks": [_raw(m)]}
    cid, cid_d = ms.add_supports(body)["cache_id"], direct.add_supports(body)["cache_id"]
    results, barrier = [None] * 4, threading.Barrier(4)
    kws = [{"r_threshold": 0.25}, {"r_threshold": 0.5}, {"threshold": 0.4},
           {"return_seg": True}]

    def go(i):
        barrier.wait()
        results[i] = ms.segment({"query": _raw(q[i]), "cache_id": cid, **kws[i]})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    for i in range(4):
        assert results[i] == direct.segment({"query": _raw(q[i]), "cache_id": cid_d, **kws[i]})


def test_cache_evicted_while_its_call_is_in_flight(cuda):
    pipe = _pipe(cuda)
    ms = serve.ModelServer(pipe=pipe, bsz=2, nshot=1, img_size=S, r_threshold=0.25,
                           max_caches=1)
    q, sup, m = _episode(2, seed=2)
    body = {"images": [_raw(sup)], "masks": [_raw(m)]}
    query = {"query": [_raw(x) for x in q], "return_seg": True}
    want = ms.segment({**query, "cache_id": ms.add_supports(body)["cache_id"]})
    cid = ms.add_supports(body)["cache_id"]
    dispatched, release = threading.Event(), threading.Event()
    real = pipe.predict_cached_async

    def in_flight(*a, **kw):
        pend = real(*a, **kw)
        torch.cuda._sleep(50_000_000)  # keep the stream busy past the eviction
        result = pend.result

        def wait_then_result(**rkw):
            dispatched.set()
            assert release.wait(60)
            return result(**rkw)

        pend.result = wait_then_result
        return pend

    out = []
    pipe.predict_cached_async = in_flight
    try:
        t = threading.Thread(target=lambda: out.append(ms.segment({**query, "cache_id": cid})))
        t.start()
        assert dispatched.wait(60)
        ms.add_supports({"images": [_raw(255 - sup)], "masks": [_raw(1 - m)]})  # evicts cid
        gc.collect()
        release.set()
        t.join(60)
    finally:
        pipe.predict_cached_async = real
    assert out and out[0] == want


def test_card_artifact_launches_and_equals_predict(cuda, tmp_path):
    pipe = _pipe(cuda)
    b, s = 2, S
    rng = np.random.default_rng(4)
    q = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    sup = rng.integers(0, 256, (b, 2, s, s, 3), dtype=np.uint8)
    m = (rng.random((b, 2, s, s)) > 0.5).astype(np.uint8)
    sm = np.array([[True, False], [True, True]])
    out_dir = serving.save_serving_artifact(pipe, str(tmp_path / "art"), bsz=b, nshot=2,
                                            img_size=s)
    before = _counts()
    want = pipe.predict(q, sup, m, shot_mask=sm).seg_colored
    n_predict = _delta(before)
    mod = serving.load(out_dir)
    assert mod.manifest["platforms"] == ["cuda"]
    before = _counts()
    got = mod(q, sup, m, sm)
    assert got.device.type == "cuda"
    got = got.cpu().numpy()
    assert _delta(before) == n_predict and n_predict[0] > 0 and n_predict[1] > 0
    np.testing.assert_array_equal(got, want)
