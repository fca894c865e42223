"""Serving-daemon throughput on the card: HTTP clients against the bare
cached-serving rate.

Port of `tools/tpu_serve_bench.py` for `diffews_tpu_torch.cli.serve`.  It
measures the whole serving stack (JSON and base64, PNG decode or raw
tensors, HTTP on the loopback, micro-batching, the device call, the device
threshold, the response encode) against the bare `predict_cached` rate of
the same pipeline.  The daemon runs in this process over the random-weight
SD-2.1 pipeline (bf16, 512px, 1-shot), warmed with `warm_start`.

    python3 tools/cuda_serve_bench.py [--bsz 4] [--window_ms 30]
        [--clients 16] [--reqs 6] [--depth 2] [--buckets] [--raw | --ab]
        [--oneoff] [--replay] [--tiny --device cpu]

Modes: HTTP clients sending cached single-query requests (PNG queries and
PNG responses, or with --raw raw tensors both ways; --ab runs png, raw,
png in one process); --oneoff sends one-off 1-query episodes (support and
mask in the body); --replay drives the micro-batcher directly with decoded
uint8 arrays from N threads (no HTTP, no codec) and reports device-lock
occupancy.  Each run reports q/s, client-side p50 / p99, the server's p50 /
p99 from `/v1/stats` (a fresh daemon per run, so its window holds that run
alone) and device-lock occupancy (Δ`device_s` / wall).  `--tiny --device
cpu` smoke-tests the script on the CPU (tiny configs, 32px); its numbers
are no measurement of the card.

The client and measurement functions (`start_daemon`, `http_run`,
`replay`, `bare_rate`, `dispatch_probe`) are also used by `chip_smoke.py`'s
phase serve.
"""

from __future__ import annotations

import base64
import io
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def png(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def raw(arr: np.ndarray) -> dict:
    return {"raw": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode("ascii"),
            "shape": list(arr.shape)}


def post(base: str, path: str, body: dict, timeout: float = 600) -> dict:
    req = urllib.request.Request(base + path, json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def start_daemon(ms):
    """Serve a `ModelServer` on a loopback port: (httpd, base URL).  Stop it
    with `httpd.shutdown(); httpd.server_close()`."""
    from diffews_tpu_torch.cli import serve

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(ms))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _pct(lat, q):
    """Nearest-rank percentile of a sorted list (as `/v1/stats` computes it)."""
    return lat[max(0, math.ceil(len(lat) * q) - 1)]


def http_run(base: str, bodies: list, *, clients: int, reqs: int) -> dict:
    """`clients` threads, each posting `reqs` requests to /v1/segment
    (client k's i-th request is bodies[(k + i) % len(bodies)]).  Returns
    q/s, client-side latencies, and the server's segment p50 / p99 and
    Δdevice_s from /v1/stats."""
    done, errs = [], []

    def client(k):
        for i in range(reqs):
            try:
                t0 = time.perf_counter()
                post(base, "/v1/segment", bodies[(k + i) % len(bodies)])
                done.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001  (counted and reported)
                errs.append(repr(e))

    s0 = get(base, "/v1/stats")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    wall = time.perf_counter() - t0
    # stats.record runs after the response is written: wait for the count
    want = s0["endpoints"].get("segment", {}).get("count", 0) + len(done) + len(errs)
    for _ in range(50):
        s1 = get(base, "/v1/stats")
        if s1["endpoints"].get("segment", {}).get("count", 0) >= want:
            break
        time.sleep(0.1)
    lat = sorted(done)
    seg = s1["endpoints"].get("segment", {})
    ddev = s1["device_s"] - s0["device_s"]
    return {"clients": clients, "reqs": reqs, "ok": len(done), "errors": len(errs),
            "first_error": errs[0] if errs else None, "wall_s": wall,
            "qps": len(done) / wall,
            "client_p50_ms": _pct(lat, 0.5) * 1e3 if lat else None,
            "client_p99_ms": _pct(lat, 0.99) * 1e3 if lat else None,
            "server_p50_ms": seg.get("p50_ms"), "server_p99_ms": seg.get("p99_ms"),
            "device_calls": s1["device_calls"] - s0["device_calls"],
            "device_lock_s": ddev, "device_lock_occupancy": ddev / wall}


def replay(ms, cache_id: str, frames: list, *, clients: int, reqs: int) -> dict:
    """Decoded uint8 queries straight into the daemon's cached path (the
    micro-batcher when its window is > 0), masks only, from `clients`
    threads: q/s, p50 and device-lock occupancy without HTTP or codecs."""
    done, errs = [], []

    def client(k):
        for i in range(reqs):
            try:
                t0 = time.perf_counter()
                ms._segment_cached(frames[(k + i) % len(frames)][None], cache_id, 0.25, 0.0,
                                   need_seg=False)
                done.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001  (counted and reported)
                errs.append(repr(e))

    dev0 = ms.stats.snapshot()["device_s"]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    wall = time.perf_counter() - t0
    ddev = ms.stats.snapshot()["device_s"] - dev0
    lat = sorted(done)
    return {"clients": clients, "reqs": reqs, "window_ms": ms.batch_window * 1e3,
            "ok": len(done), "errors": len(errs), "wall_s": wall, "qps": len(done) / wall,
            "p50_ms": _pct(lat, 0.5) * 1e3 if lat else None,
            "device_lock_s": ddev, "device_lock_occupancy": ddev / wall}


def bare_rate(pipe, cache, b: int, img_size: int, *, calls: int = 6, reps: int = 2) -> dict:
    """The bare `predict_cached_async` rate at batch b with two calls in
    flight, each result awaited (masks only on the device), best of
    `reps` runs: the ceiling the daemon's cached path is measured against."""
    q = np.random.default_rng(0).integers(0, 256, (b, img_size, img_size, 3), np.uint8)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        pend = []
        for _ in range(calls):
            pend.append(pipe.predict_cached_async(q, cache, r_threshold=0.25,
                                                  mask_on_device=True))
            if len(pend) >= 2:
                pend.pop(0).result(need_seg=False)
        while pend:
            pend.pop(0).result(need_seg=False)
        best = min(best, time.perf_counter() - t0)
    return {"batch": b, "calls": calls, "wall_s": best, "qps": calls * b / best,
            "ms_per_call": best / calls * 1e3}


def dispatch_probe(pipe, cache, img_size: int, *, calls: int = 6) -> dict:
    """Where a cached call's host time goes in a daemon: `predict_cached_async`
    alone (the device idle when it starts, the result awaited after), and
    the same calls from two threads that take turns under one lock, each
    awaiting its own result outside it (the daemon's dispatch pattern
    without HTTP, codecs or the micro-batcher): per-call lock time at b1
    and b4, in ms."""
    import torch

    out = {}
    for b in (1, 4):
        q = np.random.default_rng(b).integers(0, 256, (b, img_size, img_size, 3), np.uint8)
        alone = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pend = pipe.predict_cached_async(q, cache, r_threshold=0.25, mask_on_device=True)
            alone.append(time.perf_counter() - t0)
            pend.result(need_seg=False)
        lock, held = threading.Lock(), []

        def worker():
            for _ in range(calls):
                with lock:
                    t0 = time.perf_counter()
                    pend = pipe.predict_cached_async(q, cache, r_threshold=0.25,
                                                     mask_on_device=True)
                    held.append(time.perf_counter() - t0)
                pend.result(need_seg=False)

        threads = [threading.Thread(target=worker) for _ in range(2)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        out[f"b{b}"] = {"alone_ms": sorted(alone)[len(alone) // 2] * 1e3,
                        "two_threads_lock_ms": sorted(held)[len(held) // 2] * 1e3}
    return out


def main():
    import torch

    sys.path.insert(0, ROOT)
    from diffews_tpu_torch import pipeline as TP
    from diffews_tpu_torch.checkpoint import random_pipeline_bundle
    from diffews_tpu_torch.cli import serve
    from diffews_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig, UNetConfig,
                                           VAEConfig)

    arg = lambda flag, default: (type(default)(sys.argv[sys.argv.index(flag) + 1])
                                 if flag in sys.argv else default)
    bsz, window, clients, reqs = (arg("--bsz", 4), arg("--window_ms", 30.0),
                                  arg("--clients", 16), arg("--reqs", 6))
    depth, device = arg("--depth", 2), arg("--device", "cuda")
    cfgs, s = (UNetConfig.sd21(), VAEConfig.sd(), CLIPTextConfig.sd21()), 512
    if "--tiny" in sys.argv:
        cfgs, s = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()), 32
    if device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA card (or --tiny --device cpu)")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    else:
        card = "cpu (no device measurement)"
    print(card, flush=True)
    pipe = TP.DiffewsPipeline(
        random_pipeline_bundle(*cfgs, SchedulerConfig.diffews(), seed=0, device=device),
        device=device, compute_dtype=torch.bfloat16 if device == "cuda" else torch.float32)
    rng = np.random.default_rng(0)
    sup = rng.integers(0, 256, (s, s, 3), np.uint8)
    msk = ((rng.random((s, s)) > 0.5) * 255).astype(np.uint8)
    frames = [rng.integers(0, 256, (s, s, 3), np.uint8) for _ in range(4)]

    def daemon():
        return serve.ModelServer(pipe=pipe, bsz=bsz, nshot=1, img_size=s, r_threshold=0.25,
                                 batch_window_ms=window, dispatch_depth=depth,
                                 model_desc="random-init sd21",
                                 batch_buckets="1,2,4" if "--buckets" in sys.argv else "")

    ms = daemon()
    t0 = time.perf_counter()
    ms.warm_start()
    print(json.dumps({"warm_start_s": time.perf_counter() - t0}), flush=True)
    results = {"card": card, "bsz": bsz, "window_ms": window, "depth": depth}
    if "--replay" in sys.argv:
        cid = ms.add_supports({"images": [raw(sup)], "masks": [raw(msk)]})["cache_id"]
        results["replay"] = replay(ms, cid, frames, clients=clients, reqs=reqs)
        print(json.dumps(results["replay"]), flush=True)
    else:
        modes = (("png", "raw", "png") if "--ab" in sys.argv
                 else ("raw",) if "--raw" in sys.argv else ("png",))
        for i, mode in enumerate(modes):
            ms = daemon()  # a fresh daemon: /v1/stats holds this run alone
            httpd, base = start_daemon(ms)
            enc = raw if mode == "raw" else png
            if "--oneoff" in sys.argv:
                bodies = [{"query": enc(f), "supports": [enc(sup)], "masks": [enc(msk)]}
                          for f in frames]
            else:
                cid = post(base, "/v1/supports", {"images": [enc(sup)],
                                                  "masks": [enc(msk)]})["cache_id"]
                bodies = [{"query": enc(f), "cache_id": cid} for f in frames]
            if mode == "raw":
                bodies = [{**b, "encoding": "raw"} for b in bodies]
            post(base, "/v1/segment", bodies[0])  # this daemon's first request
            run = http_run(base, bodies, clients=clients, reqs=reqs)
            httpd.shutdown()
            httpd.server_close()
            results[f"http_{mode}_{i}"] = {"mode": mode, **run}
            print(json.dumps(results[f"http_{mode}_{i}"]), flush=True)
    cache = pipe.precompute_supports(sup[None, None], (msk[None, None] > 0).astype(np.uint8))
    for b in sorted({bsz, 1}):
        results[f"bare_predict_cached_b{b}"] = bare_rate(pipe, cache, b, s)
        print(json.dumps(results[f"bare_predict_cached_b{b}"]), flush=True)
    if device == "cuda":
        results["dispatch_probe"] = dispatch_probe(pipe, cache, s)
        print(json.dumps(results["dispatch_probe"]), flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
