"""Port parity of the serving daemon: `diffews_tpu_torch.cli.serve` (on the
CPU) against `diffews_tpu.cli.serve` on the same tiny weights (JAX init,
carried to the port by `state_dict_from_jax`).

Held against the JAX daemon, for the same requests over HTTP: one-off
episodes and the support cache give segs within the episode contract
(uint8 within 1 count on < 1% of pixels) and masks that differ only at
pixels whose seg differs; every error path of `tests/test_serve.py` gives
the same status code and the same error message; healthz has the same
keys.  Held on the port daemon alone, as `tests/test_serve.py` holds the
JAX one: the cache lifecycle and FIFO eviction (also while a call on the
evicted cache is in flight), micro-batch coalescing and error surfacing,
stats, depth 1 without deadlock, raw against PNG ingestion and responses,
the body limit, buckets against full padding and their range check,
`warm_start`, artifact mode (one-off answers equal the artifact's output
and the port pipeline's, bit for bit), the multi-device (A11) flags'
checks outside a launch, the int8 (A12) flags against the JAX daemon's past quantizer ties,
a host without a card raising, and SIGTERM's drain of a real
`python -m diffews_tpu_torch.cli.serve --device cpu` process.
"""

import base64
import gc
import http.client
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from diffews_tpu import checkpoint as JC
from diffews_tpu import pipeline as JP
from diffews_tpu.cli import serve as JS
from diffews_tpu.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu_torch import checkpoint as TC
from diffews_tpu_torch import configs as TCF
from diffews_tpu_torch import pipeline as TP
from diffews_tpu_torch import serving
from diffews_tpu_torch.cli import serve
from diffews_tpu_torch.data.transforms import ImageTransform, nearest_resize_mask
from helpers.int8_ties import assert_forced_episode, int8_parity
from helpers.jax_checkpoint import tiny_params, write_jax_checkpoint
from helpers.port_checkpoint import write_checkpoint
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

S = 32  # server img_size (tiny configs)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _b64_png(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _png(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _raw_entry(arr: np.ndarray) -> dict:
    return {"raw": base64.b64encode(np.ascontiguousarray(arr).tobytes())
            .decode("ascii"), "shape": list(arr.shape)}


def _rgb(seed, h=40, w=48):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


def _mask(seed, h=40, w=48):
    m = np.zeros((h, w), np.uint8)
    r = np.random.default_rng(seed)
    y, x = int(r.integers(0, h // 2)), int(r.integers(0, w // 2))
    m[y:y + h // 2, x:x + w // 2] = 255
    return m


def _episode_contract(got: dict, want: dict) -> None:
    """Segs within 1 uint8 count on < 1% of pixels; masks differ only where
    the seg differs."""
    for i, (sg, sw) in enumerate(zip(got["seg"], want["seg"])):
        a, b = _png(sg).astype(np.int32), _png(sw).astype(np.int32)
        d = np.abs(a - b)
        assert d.max() <= 1 and (d != 0).mean() < 0.01, (i, d.max(), (d != 0).mean())
        flips = _png(got["masks"][i]) != _png(want["masks"][i])
        assert not flips[~(d != 0).any(-1)].any(), i


@pytest.fixture(scope="module")
def pipes():
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
    up, vp = tiny_params()
    jb = JC.PipelineBundle(up, ucfg, vp, vcfg, None, CLIPTextConfig.tiny(),
                           SchedulerConfig.diffews())
    tb = TC.random_pipeline_bundle(TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(), None,
                                   TCF.SchedulerConfig.diffews())
    tb.unet.load_state_dict(TC.state_dict_from_jax(up), strict=True)
    tb.vae.load_state_dict(TC.state_dict_from_jax(vp), strict=True)
    return {"jax": JP.DiffewsPipeline(jb), "torch": TP.DiffewsPipeline(tb, device="cpu")}


@pytest.fixture(scope="module")
def pipe(pipes):
    return pipes["torch"]


def _serve(ms):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(ms))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(pipes):
    """The port daemon and the JAX daemon, same configuration, over HTTP."""
    out, httpds = {}, []
    for name, mod in (("torch", serve), ("jax", JS)):
        ms = mod.ModelServer(pipe=pipes[name], bsz=2, nshot=2, img_size=S,
                             r_threshold=0.25, max_caches=2, model_desc="tiny")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(ms))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        httpds.append(httpd)
        out[name] = (f"http://127.0.0.1:{httpd.server_address[1]}", ms)
    yield out
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def server(servers):
    return servers["torch"]


def _call(base, method, path, body=None, data=None):
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- against the JAX daemon ---------------------------------------------------


def test_healthz_matches_jax_keys(servers):
    (tb, _), (jb, _) = servers["torch"], servers["jax"]
    st, got = _call(tb, "GET", "/healthz")
    sj, want = _call(jb, "GET", "/healthz")
    assert st == sj == 200 and set(got) == set(want)
    assert got["ok"] and got["mode"] == "pipeline" and got["platform"] == "cpu"
    assert got["bsz"] == 2 and got["nshot"] == 2 and got["mesh"] == ""


def test_one_off_episode_matches_jax_and_direct_pipeline(servers, pipe):
    (tb, _), (jb, _) = servers["torch"], servers["jax"]
    q, s, m = _rgb(1), _rgb(2), _mask(3)
    body = {"query": _b64_png(q), "supports": [_b64_png(s)], "masks": [_b64_png(m)],
            "return_seg": True}
    st, got = _call(tb, "POST", "/v1/segment", body)
    sj, want = _call(jb, "POST", "/v1/segment", body)
    assert st == sj == 200, (got, want)
    mask = _png(got["masks"][0])
    assert mask.shape == (40, 48) and set(np.unique(mask)) <= {0, 255}
    _episode_contract(got, want)

    # direct pipeline call with the same preprocessing = same mask, bit for bit
    tf = ImageTransform(S, raw=True)
    qb = np.stack([tf(Image.fromarray(q))] * 2)
    sb = np.broadcast_to(np.stack([tf(Image.fromarray(s))] * 2)[:, None], (2, 2, S, S, 3))
    mm = nearest_resize_mask((m >= 128).astype(np.float32), (S, S))
    mb = np.broadcast_to(mm[None, None], (2, 2, S, S))
    shot_mask = np.zeros((2, 2), bool)
    shot_mask[:, :1] = True
    out = pipe.predict(qb, sb, mb, shot_mask=shot_mask, r_threshold=0.25)
    direct = nearest_resize_mask(out.mask[0].astype(np.float32), (40, 48))
    np.testing.assert_array_equal(mask > 0, direct > 0)


def test_cached_segment_matches_jax(servers):
    (tb, _), (jb, _) = servers["torch"], servers["jax"]
    sup = {"images": [_b64_png(_rgb(4))], "masks": [_b64_png(_mask(5))]}
    seg = {"query": [_b64_png(_rgb(6)), _b64_png(_rgb(7, h=30, w=30))], "return_seg": True}
    res = {}
    for name, base in (("torch", tb), ("jax", jb)):
        status, body = _call(base, "POST", "/v1/supports", sup)
        assert status == 200 and body["n_shots"] == 1
        status, res[name] = _call(base, "POST", "/v1/segment",
                                  {**seg, "cache_id": body["cache_id"]})
        assert status == 200, res[name]
    assert [_png(m).shape for m in res["torch"]["masks"]] == [(40, 48), (30, 30)]
    _episode_contract(res["torch"], res["jax"])


def _raw_post(base, path, data: bytes, headers: dict):
    """A POST with hand-set headers: (status, JSON body, Connection header)."""
    conn = http.client.HTTPConnection(base[len("http://"):], timeout=60)
    conn.putrequest("POST", path, skip_accept_encoding=True)
    for k, v in headers.items():
        conn.putheader(k, v)
    conn.endheaders()
    if data:
        conn.send(data)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read()), resp.getheader("Connection")
    conn.close()
    return out


_EP = {"query": _b64_png(_rgb(50)), "supports": [_b64_png(_rgb(51))],
       "masks": [_b64_png(_mask(52))]}
_PNG = base64.b64decode(_b64_png(_rgb(53)))
_GOOD_Q = _raw_entry(_rgb(123))
_RAW_MASK = _raw_entry(_mask(124) // 255)
# every error path of tests/test_serve.py: (method, path, JSON body or raw bytes)
ERRORS = {
    "no_query": ("POST", "/v1/segment", {}),
    "no_cache_or_supports": ("POST", "/v1/segment", {"query": _b64_png(_rgb(0))}),
    "more_queries_than_bsz": ("POST", "/v1/segment", {
        "query": [_b64_png(_rgb(0))] * 3, "supports": [_b64_png(_rgb(1))],
        "masks": [_b64_png(_mask(2))]}),
    "not_base64_png": ("POST", "/v1/segment", {"query": "not-base64-png!!", "cache_id": "x"}),
    "no_route_get": ("GET", "/nope", None),
    "no_route_post": ("POST", "/v1/nope", {}),
    "no_route_delete": ("DELETE", "/v2/x", None),
    "bad_json": ("POST", "/v1/segment", b"{oops"),
    "non_dict_json": ("POST", "/v1/segment", b"[1,2]"),
    "zero_thresholds": ("POST", "/v1/segment", {**_EP, "r_threshold": 0}),
    "bad_threshold": ("POST", "/v1/segment", {**_EP, "r_threshold": "abc"}),
    "truncated_png": ("POST", "/v1/segment", {
        **_EP, "query": base64.b64encode(_PNG[:len(_PNG) // 2]).decode()}),
    "bad_encoding": ("POST", "/v1/segment", {**_EP, "encoding": "jpg"}),
    "unknown_cache_segment": ("POST", "/v1/segment", {"query": _b64_png(_rgb(8)),
                                                      "cache_id": "nope"}),
    "unknown_cache_delete": ("DELETE", "/v1/supports/nope", None),
    "supports_unequal": ("POST", "/v1/supports", {"images": [_b64_png(_rgb(9))],
                                                  "masks": []}),
    "more_supports_than_nshot": ("POST", "/v1/segment", {
        "query": _b64_png(_rgb(10)), "supports": [_b64_png(_rgb(11))] * 3,
        "masks": [_b64_png(_mask(12))] * 3}),
    **{f"raw_{name}": ("POST", "/v1/segment", {"query": bad, "supports": [_GOOD_Q],
                                                "masks": [_RAW_MASK]})
       for name, bad in (
           ("byte_count", {"raw": "aGk=", "shape": [40, 48, 3]}),
           ("image_not_hw3", {"raw": "aGk=", "shape": [40, 48]}),
           ("missing_raw", {"shape": [40, 48, 3]}),
           ("undecodable_b64", {"raw": "!!!", "shape": [2, 2, 3]}),
           ("negative_dims", {"raw": "aGkh", "shape": [-1, -1, 3]}),
           ("zero_size", {"raw": "", "shape": [0, 0, 3]}))},
    "raw_mask_not_hw": ("POST", "/v1/segment", {"query": _GOOD_Q, "supports": [_GOOD_Q],
                                                "masks": [_GOOD_Q]}),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_paths_match_jax(servers, case):
    method, path, body = ERRORS[case]
    res = {}
    for name in ("torch", "jax"):
        base, ms = servers[name]
        before = ms.stats_snapshot()
        if isinstance(body, bytes):
            res[name] = _raw_post(base, path, body, {"Content-Length": str(len(body))})[:2]
        else:
            res[name] = _call(base, method, path, body)
        after = ms.stats_snapshot()
        assert after["queries"] == before["queries"], name
    assert 400 <= res["torch"][0] < 500, res
    # PIL's messages name the BytesIO object by its address
    no_addr = lambda r: (r[0], re.sub(r" at 0x[0-9a-f]+", "", r[1]["error"]))
    assert no_addr(res["torch"]) == no_addr(res["jax"])


def test_body_limit_and_content_length_match_jax(servers):
    """Bodies above --max_body_mb 413 BEFORE being read (and close the
    connection); a negative Content-Length 400s; chunked bodies 411."""
    res = {}
    for name in ("torch", "jax"):
        base, ms = servers[name]
        old = ms.max_body_bytes
        ms.max_body_bytes = 100
        try:
            res[name] = [_raw_post(base, "/v1/segment", b"",
                                   {"Content-Type": "application/json",
                                    "Content-Length": str(1 << 20)}),
                         _call(base, "POST", "/v1/segment", {"query": []})]
        finally:
            ms.max_body_bytes = old
        res[name] += [_raw_post(base, "/v1/segment", b"", {"Content-Length": "-5"})[:2],
                      _raw_post(base, "/v1/segment", b"0\r\n\r\n",
                                {"Transfer-Encoding": "chunked"})[:2]]
    (s413, body, conn), (s400, small) = res["torch"][:2]
    assert s413 == 413 and "max_body_mb" in body["error"] and conn == "close"
    assert s400 == 400 and "query" in small["error"]
    assert res["torch"][2][0] == 400 and res["torch"][3][0] == 411
    assert res["torch"] == res["jax"]


def test_bucket_range_check_matches_jax(pipes):
    msgs = []
    for mod, p in ((serve, pipes["torch"]), (JS, pipes["jax"])):
        with pytest.raises(ValueError, match="batch_buckets") as ei:
            mod.ModelServer(pipe=p, bsz=2, nshot=1, img_size=S, r_threshold=0.25,
                            model_desc="tiny", batch_buckets="1,8")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# -- the port daemon, as tests/test_serve.py holds the JAX one ----------------


def test_cache_lifecycle_and_parity(server):
    base, ms = server
    s, m = _rgb(4), _mask(5)
    status, body = _call(base, "POST", "/v1/supports",
                         {"images": [_b64_png(s)], "masks": [_b64_png(m)]})
    assert status == 200 and body["n_shots"] == 1
    cid = body["cache_id"]
    q1 = _rgb(6)
    status, got = _call(base, "POST", "/v1/segment", {"query": [_b64_png(q1)],
                                                      "cache_id": cid})
    assert status == 200, got
    status, oneoff = _call(base, "POST", "/v1/segment", {
        "query": _b64_png(q1), "supports": [_b64_png(s)], "masks": [_b64_png(m)]})
    assert status == 200
    # cached and one-off run the VAE and UNet at other batch shapes: the
    # odd mask pixel at a uint8 rounding boundary may flip
    assert np.mean(_png(got["masks"][0]) != _png(oneoff["masks"][0])) < 0.02
    status, _ = _call(base, "DELETE", f"/v1/supports/{cid}")
    assert status == 200
    status, err = _call(base, "POST", "/v1/segment", {"query": _b64_png(q1), "cache_id": cid})
    assert status == 404 and "unknown cache_id" in err["error"]


def test_cache_fifo_eviction(server):
    base, ms = server
    ids = []
    for i in range(3):  # max_caches=2
        _, body = _call(base, "POST", "/v1/supports",
                        {"images": [_b64_png(_rgb(10 + i))], "masks": [_b64_png(_mask(20 + i))]})
        ids.append(body["cache_id"])
    assert len(ms._caches) == 2
    assert ids[0] not in ms._caches and ids[2] in ms._caches


def test_eviction_while_a_call_is_in_flight(pipe):
    """A cache evicted (dropped, collected) after its call was dispatched and
    before the call is awaited: the call still returns the cache's result."""
    ms = serve.ModelServer(pipe=pipe, bsz=2, nshot=1, img_size=S, r_threshold=0.25,
                           max_caches=1, model_desc="tiny")
    body = {"images": [_b64_png(_rgb(40))], "masks": [_b64_png(_mask(41))]}
    query = {"query": _b64_png(_rgb(42)), "return_seg": True}
    want = ms.segment({**query, "cache_id": ms.add_supports(body)["cache_id"]})
    cid = ms.add_supports(body)["cache_id"]
    dispatched, release = threading.Event(), threading.Event()
    real = pipe.predict_cached_async

    def in_flight(*a, **kw):
        pend = real(*a, **kw)
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
        ms.add_supports(body)  # FIFO-evicts `cid` (max_caches=1)
        assert cid not in ms._caches
        gc.collect()
        release.set()
        t.join(60)
    finally:
        pipe.predict_cached_async = real
    assert out and out[0] == want


def test_concurrent_requests(server):
    base, _ = server
    payload = {"query": _b64_png(_rgb(30)), "supports": [_b64_png(_rgb(31))],
               "masks": [_b64_png(_mask(32))]}
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(_call(base, "POST", "/v1/segment", payload)))
        for _ in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert len(results) == 4 and all(s == 200 for s, _ in results)
    assert all(r["masks"][0] == results[0][1]["masks"][0] for _, r in results)


def test_zero_threshold_return_seg(server):
    base, _ = server
    status, got = _call(base, "POST", "/v1/segment",
                        {**_EP, "r_threshold": 0, "return_seg": True})
    assert status == 200 and "masks" not in got and len(got["seg"]) == 1
    assert _png(got["seg"][0]).shape == (40, 48, 3)


def test_micro_batching_coalesces_concurrent_requests(pipe):
    """batch_window_ms > 0: concurrent single-query cached requests share
    device calls; per-item thresholds still apply (on the device, bit for
    bit the host formula); results equal the unbatched server's."""
    ms = serve.ModelServer(pipe=pipe, bsz=2, nshot=1, img_size=S, r_threshold=0.25,
                           batch_window_ms=1000, model_desc="tiny")
    direct = serve.ModelServer(pipe=pipe, bsz=2, nshot=1, img_size=S, r_threshold=0.25,
                               model_desc="tiny")
    body = {"images": [_b64_png(_rgb(60))], "masks": [_b64_png(_mask(61))]}
    cid, cid_d = ms.add_supports(body)["cache_id"], direct.add_supports(body)["cache_id"]
    calls = []
    real = pipe.predict_cached_async

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    pipe.predict_cached_async = counting
    try:
        queries = [_rgb(70 + i) for i in range(4)]
        thresholds = [{"r_threshold": 0.25}, {"r_threshold": 0.5}, {"threshold": 0.4},
                      {"r_threshold": 0.25, "return_seg": True}]
        results = [None] * 4
        barrier = threading.Barrier(4)

        def go(i):
            barrier.wait()
            results[i] = ms.segment({"query": _b64_png(queries[i]), "cache_id": cid,
                                     **thresholds[i]})

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        n_batched = len(calls)
        assert n_batched < 4  # coalesced (a late thread may lead a second window)
        for i in range(4):
            want = direct.segment({"query": _b64_png(queries[i]), "cache_id": cid_d,
                                   **thresholds[i]})
            assert results[i] == want
        assert len(calls) == n_batched + 4
    finally:
        pipe.predict_cached_async = real


def test_micro_batching_surfaces_errors(pipe):
    """A mid-window cache drop fails the queued waiters with the 404."""
    ms = serve.ModelServer(pipe=pipe, bsz=2, nshot=1, img_size=S, r_threshold=0.25,
                           batch_window_ms=400, model_desc="tiny")
    cid = ms.add_supports({"images": [_b64_png(_rgb(80))],
                           "masks": [_b64_png(_mask(81))]})["cache_id"]
    errors = []
    barrier = threading.Barrier(3)

    def go():
        barrier.wait()
        try:
            ms.segment({"query": _b64_png(_rgb(82)), "cache_id": cid})
        except serve.ServeError as e:
            errors.append(e.status)

    threads = [threading.Thread(target=go) for _ in range(2)]
    [t.start() for t in threads]
    barrier.wait()
    ms.drop_supports(cid)
    [t.join() for t in threads]
    assert errors == [404, 404]


def test_stats_endpoint(server):
    base, ms = server
    _call(base, "GET", "/healthz")
    assert _call(base, "POST", "/v1/segment", {})[0] == 400
    _call(base, "POST", "/v1/segment", {"query": _b64_png(_rgb(90)),
                                        "supports": [_b64_png(_rgb(91))],
                                        "masks": [_b64_png(_mask(92))]})
    status, stats = _call(base, "GET", "/v1/stats")
    assert status == 200
    eps = stats["endpoints"]
    assert eps["healthz"]["count"] >= 1 and eps["healthz"]["errors"] == 0
    seg = eps["segment"]
    assert seg["count"] >= 2 and seg["errors"] >= 1
    assert 0 < seg["mean_ms"] and seg["p50_ms"] <= seg["p99_ms"]
    assert stats["queries"] >= 1 and stats["device_calls"] >= 1 and stats["device_s"] > 0
    assert stats["uptime_s"] > 0


def test_pipelined_dispatch_depth1_no_deadlock_and_slot_release(pipe):
    ms = serve.ModelServer(pipe=pipe, bsz=2, nshot=2, img_size=S, r_threshold=0.25,
                           batch_window_ms=20.0, dispatch_depth=1, model_desc="tiny-d1")
    for _ in range(3):  # failing dispatches release their slot
        with pytest.raises(serve.ServeError):
            ms.segment({"query": _b64_png(_rgb(80)), "cache_id": "nope"})
    cid = ms.add_supports({"images": [_b64_png(_rgb(81))],
                           "masks": [_b64_png(_mask(82))]})["cache_id"]
    results, errors = [], []

    def run(body):
        try:
            results.append(ms.segment(body))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    bodies = [{"query": _b64_png(_rgb(83 + k)), "cache_id": cid} for k in range(4)]
    bodies += [{"query": _b64_png(_rgb(90 + k)), "supports": [_b64_png(_rgb(91 + k))],
                "masks": [_b64_png(_mask(92 + k))]} for k in range(2)]
    threads = [threading.Thread(target=run, args=(b,)) for b in bodies]
    [t.start() for t in threads]
    [t.join(timeout=300) for t in threads]
    assert not any(t.is_alive() for t in threads), "server deadlocked"
    assert not errors, errors
    assert len(results) == 6 and all(r["masks"] for r in results)
    assert ms.segment({"query": _b64_png(_rgb(99)), "cache_id": cid})["masks"]


def test_raw_tensor_ingestion_matches_png(server):
    base, _ = server
    q, sup, msk = _rgb(120), _rgb(121), _mask(122)
    png_body = {"query": _b64_png(q), "supports": [_b64_png(sup)], "masks": [_b64_png(msk)]}
    raw_body = {"query": _raw_entry(q), "supports": [_raw_entry(sup)],
                "masks": [_raw_entry((msk >= 128).astype(np.uint8))]}
    s_png, want = _call(base, "POST", "/v1/segment", png_body)
    s_raw, got = _call(base, "POST", "/v1/segment", raw_body)
    assert s_png == s_raw == 200 and got["masks"] == want["masks"]
    _, c_png = _call(base, "POST", "/v1/supports",
                     {"images": [_b64_png(sup)], "masks": [_b64_png(msk)]})
    _, c_raw = _call(base, "POST", "/v1/supports",
                     {"images": [_raw_entry(sup)],
                      "masks": [_raw_entry((msk >= 128).astype(np.uint8))]})
    _, m_png = _call(base, "POST", "/v1/segment", {"query": _b64_png(q),
                                                   "cache_id": c_png["cache_id"]})
    _, m_raw = _call(base, "POST", "/v1/segment", {"query": _raw_entry(q),
                                                   "cache_id": c_raw["cache_id"]})
    assert m_raw["masks"] == m_png["masks"]
    s3, got255 = _call(base, "POST", "/v1/segment", {**raw_body, "masks": [_raw_entry(msk)]})
    assert s3 == 200 and got255["masks"] == want["masks"]


def test_raw_response_encoding_matches_png(server):
    base, _ = server
    body = {"query": _b64_png(_rgb(130)), "supports": [_b64_png(_rgb(131))],
            "masks": [_b64_png(_mask(132))], "return_seg": True}
    s1, png_resp = _call(base, "POST", "/v1/segment", body)
    s2, raw_resp = _call(base, "POST", "/v1/segment", {**body, "encoding": "raw"})
    assert s1 == s2 == 200
    for key in ("masks", "seg"):
        ent = raw_resp[key][0]
        got = np.frombuffer(base64.b64decode(ent["raw"]), np.uint8).reshape(ent["shape"])
        assert np.array_equal(got, _png(png_resp[key][0])), key


def test_batch_buckets_match_full_padding(pipe):
    msb = serve.ModelServer(pipe=pipe, bsz=4, nshot=1, img_size=S, r_threshold=0.25,
                            model_desc="tiny", batch_buckets="1,2")
    msf = serve.ModelServer(pipe=pipe, bsz=4, nshot=1, img_size=S, r_threshold=0.25,
                            model_desc="tiny")
    assert msb.buckets == [1, 2, 4]
    body = {"images": [_b64_png(_rgb(90))], "masks": [_b64_png(_mask(91))]}
    cidb, cidf = msb.add_supports(body)["cache_id"], msf.add_supports(body)["cache_id"]
    for nq in (1, 2, 3, 4):
        q = np.stack([_rgb(95 + i) for i in range(nq)])
        qb, nb = msb._pad_batch(q)
        assert nb == nq and qb.shape[0] == {1: 1, 2: 2, 3: 4, 4: 4}[nq]
        got = msb.segment({"query": [_b64_png(qi) for qi in q], "cache_id": cidb})
        want = msf.segment({"query": [_b64_png(qi) for qi in q], "cache_id": cidf})
        assert got["masks"] == want["masks"]


def test_warm_start_runs_all_paths(pipe):
    ms = serve.ModelServer(pipe=pipe, bsz=2, nshot=1, img_size=S, r_threshold=0.25,
                           model_desc="tiny", batch_buckets="1")
    calls = []
    real_c, real_e = pipe.predict_cached_async, pipe.predict_async
    pipe.predict_cached_async = lambda q, *a, **kw: calls.append(("cached", len(q))) or \
        real_c(q, *a, **kw)
    pipe.predict_async = lambda q, *a, **kw: calls.append(("episode", len(q))) or \
        real_e(q, *a, **kw)
    try:
        ms.warm_start()
    finally:
        pipe.predict_cached_async, pipe.predict_async = real_c, real_e
    assert calls == [("cached", 1), ("episode", 1), ("cached", 2), ("episode", 2)]
    cid = ms.add_supports({"images": [_b64_png(_rgb(120))],
                           "masks": [_b64_png(_mask(121))]})["cache_id"]
    assert ms.segment({"query": _b64_png(_rgb(122)), "cache_id": cid})["masks"]
    assert ms.segment({"query": _b64_png(_rgb(123)), "supports": [_b64_png(_rgb(124))],
                       "masks": [_b64_png(_mask(125))]})["masks"]


def test_artifact_mode(pipe):
    """The daemon serves an exported artifact with no model code: one-off
    answers equal the artifact's own output and the port pipeline's, bit
    for bit; the cache endpoint gets the JAX daemon's 400."""
    # (saving and loading are held by tests/test_torch_serving.py)
    mod = serving.ServingModule(*serving.export_predict(pipe, bsz=2, nshot=1, img_size=S))
    ms = serve.ModelServer(artifact=mod, bsz=mod.manifest["bsz"], nshot=mod.manifest["nshot"],
                           img_size=S, r_threshold=0.25, model_desc="artifact")
    ms.warm_start()
    httpd, base = _serve(ms)
    try:
        status, body = _call(base, "GET", "/healthz")
        assert status == 200 and body["mode"] == "artifact" and body["platform"] == "cpu"
        sup = {"images": [_b64_png(_rgb(1))], "masks": [_b64_png(_mask(2))]}
        status, err = _call(base, "POST", "/v1/supports", sup)
        with pytest.raises(JS.ServeError) as ei:  # the JAX daemon's artifact-mode 400
            JS.ModelServer(artifact=object(), bsz=2, nshot=1, img_size=S,
                           r_threshold=0.25).add_supports(sup)
        assert (status, err["error"]) == (ei.value.status, str(ei.value))
        q, s, m = _rgb(3), _rgb(4), _mask(5)
        status, got = _call(base, "POST", "/v1/segment", {
            "query": _b64_png(q), "supports": [_b64_png(s)], "masks": [_b64_png(m)],
            "return_seg": True, "encoding": "raw"})
        assert status == 200, got
        seg = np.frombuffer(base64.b64decode(got["seg"][0]["raw"]), np.uint8)
        seg = seg.reshape(got["seg"][0]["shape"])
        assert seg.shape == (40, 48, 3)
        tf = ImageTransform(S, raw=True)
        qb = np.stack([tf(Image.fromarray(q))] * 2)
        sb = np.stack([tf(Image.fromarray(s))] * 2)[:, None]
        mb = np.broadcast_to(nearest_resize_mask((m >= 128).astype(np.float32), (S, S)),
                             (2, 1, S, S)).astype(np.uint8)
        art = mod(qb, sb, mb).numpy()
        np.testing.assert_array_equal(art, pipe.predict(qb, sb, mb).seg_colored)
        back = art[0][np.ix_(*(serve._nearest_indices(S, n) for n in (40, 48)))]
        np.testing.assert_array_equal(seg, back)
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("flags,item", [
    (["--num_data_shards", "2"], "A11"), (["--num_shot_shards", "2"], "A11"),
    (["--vae_impl", "int8"], "A12"), (["--unet_int8"], "A12")])
def test_unported_flags_raise_before_loading(flags, item, tmp_path_factory):
    """The multi-device flags (A11, ported) raise before anything is loaded:
    with a batch or shot count the shards do not divide, as JAX's
    `test_make_server_mesh_flag_validation` (SystemExit), and outside a
    `torchrun` launch, saying how to launch them
    (`test_torch_serve_sharded.py` serves under one).  The
    int8 flags (A12, ported) build a daemon from a JAX-saved checkpoint and
    answer as the JAX daemon with the same flags does: `--vae_impl int8` a
    one-off episode, `--unet_int8` supports.add and a cached request; the
    int8 codes equal JAX's but at ties and, with JAX's codes fed forward
    past each tie (`helpers/int8_ties.py`), the responses meet the episode
    contract (both calibrate at 64 px)."""
    if item == "A11":
        argv = ["--checkpoint", "/nonexistent", "--device", "cpu", *flags]
        undivided = ["--bsz", "3"] if flags[0] == "--num_data_shards" else ["--nshot", "3"]
        for mod in (serve, JS):
            with pytest.raises(SystemExit, match="must be divisible"):
                mod.make_server(mod.build_parser().parse_args(
                    [a for a in argv if a not in ("--device", "cpu")] + undivided
                    if mod is JS else argv + undivided))
        with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
            serve.make_server(serve.build_parser().parse_args(argv + ["--nshot", "2"]))
        return
    ck = tmp_path_factory.getbasetemp() / "int8_ckpt"
    if not ck.exists():
        write_jax_checkpoint(str(ck))
    argv = ["--checkpoint", str(ck), "--bsz", "2", "--img-size", str(S), *flags]
    sup = {"images": [_b64_png(_rgb(4))], "masks": [_b64_png(_mask(5))]}
    query = {"query": [_b64_png(_rgb(6)), _b64_png(_rgb(7, h=30, w=30))], "return_seg": True}

    def answer(ms):
        if "--unet_int8" in flags:
            return lambda: ms.segment({**query, "cache_id": ms.add_supports(sup)["cache_id"]})
        return lambda: ms.segment({**query, "supports": sup["images"], "masks": sup["masks"]})

    with int8_parity() as ties:
        jms = JS.make_server(JS.build_parser().parse_args(argv))
        tms = serve.make_server(serve.build_parser().parse_args(argv + ["--device", "cpu"]))
        want, got = assert_forced_episode(answer(jms), answer(tms), ties,
                                          seg=lambda r: np.stack([_png(x) for x in r["seg"][:1]]))
    _episode_contract(got, want)


def test_artifact_on_another_device_than_asked_raises(monkeypatch):
    """`--artifact` with a `--device` of another type than the artifact's
    exits instead of serving on the artifact's device."""
    stub = type("Stub", (), {"device": torch.device("cpu"),
                             "manifest": {"bsz": 1, "nshot": 1, "img_size": S}})()
    monkeypatch.setattr(serving, "load", lambda path: stub)
    args = serve.build_parser().parse_args(["--artifact", "/nonexistent", "--device", "cuda"])
    with pytest.raises(SystemExit, match="exported on cpu"):
        serve.make_server(args)
    args = serve.build_parser().parse_args(["--artifact", "/nonexistent", "--device", "cpu"])
    assert serve.make_server(args).artifact is stub


def test_no_card_raises_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    args = serve.build_parser().parse_args(["--checkpoint", "/nonexistent"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.make_server(args)


def test_sigterm_graceful_drain(tmp_path):
    """A real `python -m diffews_tpu_torch.cli.serve --device cpu` process:
    a request whose body is still arriving when SIGTERM lands is finished
    (200), an idle keep-alive connection does not hold the drain forever,
    and the process exits 0 after draining."""
    ck = write_checkpoint(str(tmp_path / "ckpt"), TCF.UNetConfig.tiny(), TCF.VAEConfig.tiny(),
                          TCF.CLIPTextConfig.tiny(), TCF.SchedulerConfig.diffews(), seed=0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "diffews_tpu_torch.cli.serve", "--checkpoint", ck,
         "--device", "cpu", "--port", "0", "--bsz", "1", "--nshot", "1",
         "--img-size", str(S)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        line, seen = "", []
        for _ in range(50):
            line = proc.stdout.readline()
            seen.append(line)
            if not line or "serving on http://" in line:
                break
        assert "serving on http://" in line, seen
        base = line.split()[2]
        host, port = base[len("http://"):].split(":")
        # the request in flight: half its body now, the rest after SIGTERM
        data = json.dumps({"query": _b64_png(_rgb(200)), "supports": [_b64_png(_rgb(201))],
                           "masks": [_b64_png(_mask(202))]}).encode()
        conn = http.client.HTTPConnection(host, int(port), timeout=600)
        conn.putrequest("POST", "/v1/segment")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(len(data)))
        conn.endheaders()
        conn.send(data[:len(data) // 2])
        idle = socket.create_connection((host, int(port)))
        time.sleep(0.5)  # the handler is reading the body
        proc.send_signal(signal.SIGTERM)
        time.sleep(1.0)  # serve_forever has seen the shutdown request
        conn.send(data[len(data) // 2:])
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        assert json.loads(resp.read())["masks"]
        conn.close()
        out, _ = proc.communicate(timeout=600)
        idle.close()
        assert proc.returncode == 0, out
        assert "drained and stopped" in out, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
