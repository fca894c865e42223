"""Production serving daemon: an HTTP API over the DiffewS pipeline (port).

Port of `diffews_tpu/cli/serve.py`: the same endpoints, bodies, status
codes, error messages, stats and flags, over the port's `DiffewsPipeline`
on the CUDA card.  The repeated-support cache is the primary serving
pattern (one annotated support set answering many queries):

    python -m diffews_tpu_torch.cli.serve --checkpoint <dir> --port 8710

Endpoints (JSON bodies; every image/mask is either a base64-encoded
PNG/JPEG string or a raw tensor {"raw": b64(uint8 bytes), "shape":
[H, W, 3]} ([H, W] for masks, nonzero = foreground) — raw skips the
image codec):
    GET  /healthz
        -> {"ok", "platform" (the torch device type), "caches", "model"}
    GET  /v1/stats
        -> request metrics: per-endpoint count/errors/mean/p50/p99 latency
           (percentiles over the last 512 requests), queries served, and
           the wall time spent holding the device-dispatch lock (dispatch
           is async, so this measures enqueue serialization; request
           latency percentiles capture execution time)
    POST /v1/supports      {"images": [b64, ...], "masks": [b64, ...]}
        -> {"cache_id", "n_shots"}          (precomputes the support K/V)
    DELETE /v1/supports/<cache_id>
    POST /v1/segment       {"query": b64 | [b64, ...],
                            "cache_id": id           # cached supports, OR
                            "supports": [...], "masks": [...],  # one-off
                            "r_threshold": 0.25}     # optional overrides
        -> {"masks": [b64 gray PNG 0/255, ...]}  at each query's original
           size (+ "seg": [b64 RGB PNG] when "return_seg" is true);
           "encoding": "raw" in the body switches the response to raw
           tensor objects {"raw": b64(uint8 bytes), "shape": [...]}
           (codec-free, symmetric with raw ingestion)

Shape discipline (as in the JAX daemon, whose programs are traced once per
shape): queries pad to the configured --bsz (or the smallest covering
--batch_buckets entry) and results slice back; one-off episode supports pad
to --nshot with a shot validity mask.  A support cache is captured at its
request's exact shot count.  Concurrent requests serialize their device
DISPATCH on a lock but wait for results outside it, so up to
--dispatch_depth device calls are in flight.  All work runs on one CUDA
stream, so a result's copy to the host queues behind the kernels dispatched
before it: depth 2 bounds queued outputs but overlaps no execution with a
transfer yet.  Batch queries client-side (up to --bsz per request) for
throughput.

What is cold on the card is not a compile but the nvcc build of each
kernel library at first use (`ops/_build.py`) and the caching allocator;
--warm_start builds the libraries and runs every path before taking
traffic.

Serving-artifact mode (`--artifact <dir>` from `cli/export.py`) runs the
AOT-exported `torch.export` program instead of model code: only one-off
episodes at the artifact's frozen (bsz, nshot) — no cache endpoints.

Runs on the CUDA card unless `--device cpu` is given (the kernels' plain
versions); on a host without a card it raises.  `--vae_impl int8` and
`--unet_int8` (W8A8) calibrate their static scales when the daemon loads;
the cached endpoints run the int8 UNet too.

Multi-device serving (JAX `serve.py:852-890`), one process per device:

    torchrun --nproc_per_node 2 -m diffews_tpu_torch.cli.serve \
        --checkpoint <dir> --num_data_shards 2 --bsz 4     # or --num_shot_shards 2

`--num_data_shards` splits the server batch over a ("data",) mesh,
`--num_shot_shards` a one-off episode's shots over a ("shots",) mesh
(("data", "shots") with both), with JAX's divisibility checks; the shot
mesh refuses `/v1/supports` as JAX's does.  Rank 0 runs the HTTP server;
the other ranks follow it (`_Peers`): every device call goes through
the dispatch lock, and under it rank 0 broadcasts the call's name, options
and arrays to the followers before making it, so every rank runs the same
pipeline calls in the same order.  A follower keeps its own support caches
under rank 0's ids (inserted and FIFO-evicted in the same order) and
waits for each result before the next call, so its device memory cannot
grow.  SIGTERM drains rank 0 and then broadcasts a stop: every rank exits
0 (the followers ignore the signal that `torchrun` forwards them).  A
follower that dies fails rank 0's next broadcast (its connection is
closed): the request answers 503 and the daemon stops with exit code 1.
"""

from __future__ import annotations

import argparse
import base64
import datetime
import io
import json
import math
import signal
import threading
import time
import traceback
import uuid
from collections import OrderedDict, deque
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from diffews_tpu_torch.data.transforms import ImageTransform, nearest_resize_mask
from diffews_tpu_torch.ops.resize import _nearest_indices
from diffews_tpu_torch.parallel import mesh as mesh_lib
from diffews_tpu_torch.pipeline import (ATTN_IMPLS, DiffewsPipeline, PendingSeg, SegOutput,
                                        device_mask_from_seg, resolve_device)


class ServeError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Stats:
    """Thread-safe per-endpoint request metrics for `GET /v1/stats`.

    Keeps a bounded ring of recent latencies per endpoint (percentiles are
    over that window, not all-time) plus all-time counters; `device_s`
    accumulates wall time spent inside the device-dispatch lock (the
    host's enqueue of the kernels, which execute asynchronously).
    """

    WINDOW = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._ep: dict = {}  # name -> [count, errors, total_s, ring deque]
        self.queries = 0     # query images served (segment successes)
        self.device_s = 0.0  # wall time holding the device-dispatch lock
        self.device_calls = 0

    def record(self, name: str, seconds: float, error: bool) -> None:
        with self._lock:
            e = self._ep.setdefault(
                name, [0, 0, 0.0, deque(maxlen=self.WINDOW)])
            e[0] += 1
            e[1] += int(error)
            e[2] += seconds
            e[3].append(seconds)

    def add_queries(self, n: int) -> None:
        with self._lock:
            self.queries += n

    def add_device(self, seconds: float) -> None:
        with self._lock:
            self.device_s += seconds
            self.device_calls += 1

    def snapshot(self) -> dict:
        with self._lock:
            eps = {}
            for name, (count, errors, total, ring) in self._ep.items():
                lat = sorted(ring)
                eps[name] = {
                    "count": count,
                    "errors": errors,
                    "mean_ms": round(total / count * 1e3, 3),
                    "p50_ms": round(lat[len(lat) // 2] * 1e3, 3),
                    # nearest-rank percentile: ceil(q*n)-1 (int(q*n)-1
                    # underestimates by a rank and inverts vs p50 at n=2)
                    "p99_ms": round(
                        lat[max(0, math.ceil(len(lat) * 0.99) - 1)] * 1e3, 3),
                }
            return {
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "queries": self.queries,
                "device_calls": self.device_calls,
                "device_s": round(self.device_s, 3),
                "endpoints": eps,
            }


class _MBItem:
    """One queued single-query request in the micro-batcher."""

    __slots__ = ("q", "event", "seg", "mask", "error", "r_thr", "thr",
                 "need_seg")

    def __init__(self, q: np.ndarray, r_thr: float = 0.0, thr: float = 0.0,
                 need_seg: bool = True):
        self.q = q
        self.r_thr = r_thr
        self.thr = thr
        self.need_seg = need_seg
        self.event = threading.Event()
        self.seg = None
        self.mask = None
        self.error = None


def _b64_to_pil(data: str) -> Image.Image:
    try:
        im = Image.open(io.BytesIO(base64.b64decode(data)))
        im.load()  # PIL decodes lazily; force truncation errors out HERE
        return im
    except Exception as e:
        raise ServeError(400, f"undecodable image payload: {e}")


def _png_b64(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _as_list(x) -> List:
    return x if isinstance(x, list) else [x]


class _Peers:
    """The daemon's ranks under a mesh: rank 0 broadcasts each device call
    (`send`), the followers receive them in order (`recv`).  The calls ride
    a gloo group of their own (CPU tensors, whatever the mesh's backend)
    whose timeout is long: an idle follower waits for the next request
    without timing out.  A dead follower's closed connection fails rank
    0's next `send` at once."""

    IDLE_TIMEOUT = datetime.timedelta(days=365)

    def __init__(self):
        self.group = dist.new_group(backend="gloo", timeout=self.IDLE_TIMEOUT)
        self.rank = dist.get_rank()

    def send(self, op: str, **payload) -> None:
        dist.broadcast_object_list([(op, payload)], src=0, group=self.group)

    def recv(self) -> Tuple[str, dict]:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def mesh_desc(pipe) -> str:
    """The serving mesh as JAX's healthz names it ("data=2xmodel=1",
    "shots=2", "data=2xshots=2"; JAX's data mesh has both of
    `make_mesh`'s axes), "" for one device."""
    for m in (pipe.mesh, pipe.shot_mesh):
        if m is not None:
            names = tuple(m.mesh_dim_names)
            desc = "x".join(f"{ax}={m.size(i)}" for i, ax in enumerate(names))
            return desc + "xmodel=1" if names == ("data",) else desc
    return ""


class ModelServer:
    """Request decoding + shape padding + device dispatch (lock-serialized).

    Split from the HTTP handler so tests can drive it directly and the
    handler stays transport-only.
    """

    def __init__(self, pipe=None, artifact=None, *, bsz: int, nshot: int,
                 img_size: int, r_threshold: float, max_caches: int = 8,
                 batch_window_ms: float = 0.0, dispatch_depth: int = 2,
                 max_body_mb: float = 64.0, model_desc: str = "",
                 batch_buckets: str = "", peers: "_Peers" = None):
        assert (pipe is None) != (artifact is None)
        # multi-device: the ranks' device calls (None for one process)
        self._peers = peers
        self.peer_error = None  # the follower failure that stops rank 0
        self.on_peer_failure = lambda: None  # set by main: stop serving
        self.max_body_bytes = int(max_body_mb * 1024 * 1024)
        self.pipe = pipe
        self.artifact = artifact
        self.bsz = bsz
        # Batch-size buckets (pipe mode only — artifact shapes are frozen):
        # a request/window of n queries pads to the smallest bucket >= n
        # instead of always to bsz, cutting padded-batch waste at partial
        # load.  Each bucket's first call meets a cold allocator (and the
        # first call of all builds the kernel libraries; --warm_start).
        self.buckets = [bsz]
        if batch_buckets and pipe is not None:
            bks = sorted({int(x) for x in batch_buckets.split(",")
                          if x.strip()})
            if any(b < 1 or b > bsz for b in bks):
                raise ValueError(f"batch_buckets {bks} must lie in "
                                 f"[1, bsz={bsz}]")
            self.buckets = sorted(set(bks) | {bsz})
        self.nshot = nshot
        self.img_size = img_size
        self.r_threshold = r_threshold
        self.batch_window = batch_window_ms / 1e3
        self.model_desc = model_desc
        self._tf = ImageTransform(img_size, raw=True)
        self._caches: OrderedDict[str, object] = OrderedDict()
        self._max_caches = max_caches
        self._lock = threading.Lock()  # device dispatch + cache mutation
        # Pipelined serving: the lock serializes DISPATCH only; requests
        # wait for their results outside it, so the next request's kernels
        # queue while the previous result is awaited.  The semaphore bounds
        # in-flight results so queued output buffers can't accumulate
        # device memory under high client concurrency.
        self._inflight = threading.BoundedSemaphore(max(1, dispatch_depth))
        # cross-request micro-batching (batch_window_ms > 0): concurrent
        # single-query requests against the same cache coalesce into one
        # padded device call instead of each paying a full padded batch
        self._mb_lock = threading.Lock()
        self._mb_queues: dict = {}
        self.stats = _Stats()

    @contextmanager
    def _device(self):
        """The device-dispatch lock, with held-time accounted in stats."""
        dt = 0.0
        try:
            with self._lock:
                t0 = time.monotonic()
                try:
                    yield
                finally:
                    dt = time.monotonic() - t0
        finally:
            # after the lock releases (stats has its own lock); also on the
            # error path — a failing device call still held the lock
            self.stats.add_device(dt)

    @property
    def follower(self) -> bool:
        """A rank other than 0 of a multi-device daemon (it serves no HTTP)."""
        return self._peers is not None and self._peers.rank != 0

    def _send(self, op: str, **payload) -> None:
        """Hand a device call to the followers; called under the dispatch
        lock, right before rank 0 makes the same call.  A follower that
        cannot take it stops the daemon."""
        if self._peers is None:
            return
        if self.peer_error is not None:
            raise ServeError(503, f"a follower rank failed: {self.peer_error}")
        try:
            self._peers.send(op, **payload)
        except RuntimeError as e:
            self.peer_error = e
            self.on_peer_failure()
            raise ServeError(503, f"a follower rank failed: {e}")

    def close(self) -> None:
        """Stop the followers (rank 0, after the HTTP server drained)."""
        if self._peers is None or self.follower or self.peer_error is not None:
            return
        with self._lock:
            try:
                self._peers.send("stop")
            except RuntimeError as e:
                self.peer_error = e

    def follow(self) -> None:
        """A follower's loop: make each device call rank 0 broadcasts, in
        order, until the stop.  A call that raises here raised on rank 0 on
        the same inputs, which answered it; the loop goes on."""
        while True:
            op, kw = self._peers.recv()
            if op == "stop":
                return
            try:
                if op == "supports.add":
                    self._insert_cache(kw["cache_id"], self.pipe.precompute_supports(
                        kw["sup"][None], kw["msk"][None]))
                elif op == "supports.drop":
                    self._caches.pop(kw["cache_id"], None)
                elif op == "cached":
                    self.pipe.predict_cached_async(kw["q"], self._caches[kw["cache_id"]],
                                                   **kw["opts"]).result(need_seg=False)
                elif op == "episode":
                    self._episode_call(kw["q"], kw["sup"], kw["msk"], kw["shot_mask"],
                                       kw["opts"]).result(need_seg=False)
                elif op == "warm_start":
                    self._warm_paths()
                else:
                    raise ValueError(f"unknown device call {op!r}")
            except Exception:
                traceback.print_exc()

    def _insert_cache(self, cache_id: str, cache) -> None:
        """Add a cache, FIFO-evicting past --max_caches (under the lock, so
        that every rank inserts and evicts in the same order)."""
        self._caches[cache_id] = cache
        while len(self._caches) > self._max_caches:
            self._caches.popitem(last=False)  # FIFO eviction

    def _dispatch_pipelined(self, dispatch):
        """Run `dispatch` (device-call enqueue) under the lock; return its
        pending handle.  Pair with `_await` — the semaphore slot acquired
        here is released there."""
        self._inflight.acquire()
        try:
            with self._device():
                return dispatch()
        except BaseException:
            self._inflight.release()
            raise

    def _await(self, pend, **result_kw):
        """Wait for a `_dispatch_pipelined` handle outside the device lock
        (device execution + host transfer overlap the next dispatch).
        result_kw forwards to `PendingSeg.result` (e.g. need_seg=False
        for masks-only transfers)."""
        try:
            return pend.result(**result_kw)
        finally:
            self._inflight.release()

    # -- request decoding ---------------------------------------------------
    #
    # Every image/mask entry is either a b64 PNG/JPEG string or a raw
    # tensor object {"raw": b64(uint8 bytes), "shape": [H, W, 3]} ([H, W]
    # for masks, nonzero = foreground).  Raw entries skip the image codec
    # (tools/cuda_serve_bench.py --ab measures both) at more payload bytes
    # than a PNG.

    @staticmethod
    def _raw_entry(p: dict, channels) -> np.ndarray:
        try:
            buf = base64.b64decode(p["raw"])
            shape = tuple(int(x) for x in p["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise ServeError(400, f"bad raw tensor entry: {e}")
        if channels is not None and (len(shape) != 3 or shape[2] != channels):
            raise ServeError(400, f"raw image shape must be [H, W, "
                                  f"{channels}]; got {list(shape)}")
        if channels is None and len(shape) != 2:
            raise ServeError(400, f"raw mask shape must be [H, W]; "
                                  f"got {list(shape)}")
        if any(d <= 0 for d in shape):
            # -1s would slip past the np.prod size check and crash reshape
            # (a 500); 0-size arrays blow up downstream in Image.fromarray
            raise ServeError(400, f"raw shape dims must be positive; "
                                  f"got {list(shape)}")
        arr = np.frombuffer(buf, np.uint8)
        need = int(np.prod(shape))
        if arr.size != need:
            raise ServeError(400, f"raw buffer has {arr.size} bytes; "
                                  f"shape {list(shape)} needs {need}")
        return arr.reshape(shape)

    def _decode_images(self, payloads: List[str]) -> Tuple[np.ndarray, list]:
        """entries -> (N, S, S, 3) uint8 + original (w, h) sizes."""
        imgs, sizes = [], []
        for p in payloads:
            if isinstance(p, dict):
                arr = self._raw_entry(p, 3)
                h, w = arr.shape[:2]
                sizes.append((w, h))
                if (h, w) != (self.img_size, self.img_size):
                    # same bilinear semantics as the codec path
                    arr = np.asarray(Image.fromarray(arr).resize(
                        (self.img_size, self.img_size), Image.BILINEAR))
                imgs.append(arr)
            else:
                im = _b64_to_pil(p)
                sizes.append(im.size)
                imgs.append(self._tf(im))  # PIL-bilinear resize, uint8 HWC
        return np.stack(imgs), sizes

    def _decode_masks(self, payloads: List[str]) -> np.ndarray:
        """entries -> (N, S, S) {0,1} float32 (codec path: >=128 foreground,
        the FSS-1000 rule `fss.py:77-81`; raw path: nonzero foreground;
        resize keeps torch-nearest index semantics)."""
        out = []
        for p in payloads:
            if isinstance(p, dict):
                m = (self._raw_entry(p, None) > 0).astype(np.float32)
            else:
                m = np.asarray(_b64_to_pil(p).convert("L"))
                m = (m >= 128).astype(np.float32)
            out.append(nearest_resize_mask(m, (self.img_size, self.img_size)))
        return np.stack(out)

    # -- endpoints ----------------------------------------------------------

    def healthz(self) -> dict:
        device = (self.pipe or self.artifact).device
        return {"ok": True, "platform": device.type,
                "caches": len(self._caches), "model": self.model_desc,
                "bsz": self.bsz, "nshot": self.nshot,
                "batch_window_ms": self.batch_window * 1e3,
                "mesh": "" if self.pipe is None else mesh_desc(self.pipe),
                "mode": "artifact" if self.artifact is not None else "pipeline"}

    def stats_snapshot(self) -> dict:
        return self.stats.snapshot()

    def add_supports(self, body: dict) -> dict:
        if self.artifact is not None:
            raise ServeError(400, "artifact mode has no support cache "
                                  "(the exported program is a fixed-shape "
                                  "full episode); use /v1/segment with "
                                  "supports+masks")
        if self.pipe.shot_mesh is not None:
            raise ServeError(400, "the support-KV cache does not compose "
                                  "with shot-parallel serving "
                                  "(--num_shot_shards); use /v1/segment "
                                  "with supports+masks")
        images = _as_list(body.get("images") or [])
        masks = _as_list(body.get("masks") or [])
        if not images or len(images) != len(masks):
            raise ServeError(400, "need equal-length non-empty "
                                  "'images' and 'masks'")
        sup, _ = self._decode_images(images)
        msk = self._decode_masks(masks)
        cache_id = uuid.uuid4().hex[:12]
        with self._device():  # device work: VAE encodes + support UNet pass
            self._send("supports.add", cache_id=cache_id, sup=sup, msk=msk)
            cache = self.pipe.precompute_supports(sup[None], msk[None])
            self._insert_cache(cache_id, cache)
        return {"cache_id": cache_id, "n_shots": len(images)}

    def _get_cache(self, cache_id: str):
        """Host-only cache lookup (doesn't count as a device call).  An
        eviction racing an in-flight dispatch is safe: the caching
        allocator is stream-ordered and all work runs on one stream, so a
        freed cache's memory is reused only by work queued after the
        kernels that still read it."""
        with self._lock:
            cache = self._caches.get(cache_id)
        if cache is None:
            raise ServeError(404, f"unknown cache_id {cache_id}")
        return cache

    def drop_supports(self, cache_id: str) -> dict:
        with self._lock:
            if self._caches.pop(cache_id, None) is None:
                raise ServeError(404, f"unknown cache_id {cache_id}")
            self._send("supports.drop", cache_id=cache_id)
        return {"ok": True}

    def segment(self, body: dict) -> dict:
        queries = _as_list(body.get("query") or [])
        if not queries:
            raise ServeError(400, "need 'query' (b64 image or list)")
        try:
            r_thr = float(body.get("r_threshold", self.r_threshold))
            thr = float(body.get("threshold", 0.0))
        except (TypeError, ValueError) as e:
            raise ServeError(400, f"bad threshold value: {e}")
        if r_thr <= 0 and thr <= 0 and not body.get("return_seg"):
            raise ServeError(400, "r_threshold and threshold are both 0 — "
                                  "no mask would be produced; set one > 0 "
                                  "or request 'return_seg'")
        # validate the response encoding BEFORE any device work: a bad
        # value must not burn a full episode dispatch per rejected request
        enc_raw = body.get("encoding", "png") == "raw"
        if body.get("encoding", "png") not in ("png", "raw"):
            raise ServeError(400, "encoding must be 'png' or 'raw'")
        q, sizes = self._decode_images(queries)
        need_seg = bool(body.get("return_seg"))

        cache_id = body.get("cache_id")
        if cache_id is not None:
            preds = self._segment_cached(q, cache_id, r_thr, thr,
                                         need_seg=need_seg)
        else:
            supports = _as_list(body.get("supports") or [])
            masks = _as_list(body.get("masks") or [])
            if not supports or len(supports) != len(masks):
                raise ServeError(400, "need 'cache_id' or equal-length "
                                      "'supports' and 'masks'")
            sup, _ = self._decode_images(supports)
            msk = self._decode_masks(masks)
            preds = self._segment_episode(q, sup, msk, r_thr, thr,
                                          need_seg=need_seg)
        self.stats.add_queries(len(queries))

        def _enc(arr: np.ndarray):
            if enc_raw:  # codec-free, symmetric with raw ingestion
                return {"raw": base64.b64encode(
                            np.ascontiguousarray(arr).tobytes()).decode(),
                        "shape": list(arr.shape)}
            return _png_b64(arr)

        resp = {}
        if preds.mask is not None:
            resp["masks"] = []
        if body.get("return_seg"):
            resp["seg"] = []
        for i, (w, h) in enumerate(sizes):
            if preds.mask is not None:
                m = preds.mask[i].astype(np.float32)
                m = nearest_resize_mask(m, (h, w))  # back to query size
                resp["masks"].append(_enc((m * 255).astype(np.uint8)))
            if body.get("return_seg"):
                # same geometry as the mask: torch-nearest back to the
                # query's original size, per channel
                seg = preds.seg_colored[i]
                if seg.shape[:2] != (h, w):
                    ih = _nearest_indices(seg.shape[0], h)
                    iw = _nearest_indices(seg.shape[1], w)
                    seg = seg[np.ix_(ih, iw)]
                resp["seg"].append(_enc(seg))
        return resp

    # -- device work (lock-held) ---------------------------------------------

    def warm_start(self) -> None:
        """Warm every serving path BEFORE taking traffic.  There is no
        compile: what is cold on the card is the nvcc build of each kernel
        library at first use and the caching allocator.  So: build every
        library the configured path launches, then run BOTH the cached path
        (not under a shot mesh, which has no cache) and the one-off episode
        path at every batch bucket (incl. their device mask stages) on
        throwaway random inputs; under a mesh every rank does.  Without it,
        the first request builds the kernels under the dispatch lock.
        Artifact mode runs one artifact call (its kernels build on that
        call)."""
        if self.pipe is None:
            sup, msk, q1 = self._warm_inputs()
            b = self.bsz
            self.artifact(np.repeat(q1, b, axis=0), np.broadcast_to(sup, (b,) + sup.shape[1:]),
                          np.broadcast_to(msk, (b,) + msk.shape[1:])).cpu()
            return
        with self._lock:
            self._send("warm_start")
            self._warm_paths()

    def _warm_inputs(self):
        s = self.img_size
        rng = np.random.default_rng(0)
        sup = rng.integers(0, 256, (1, self.nshot, s, s, 3), np.uint8)
        msk = (rng.random((1, self.nshot, s, s)) > 0.5).astype(np.uint8)
        q1 = rng.integers(0, 256, (1, s, s, 3), np.uint8)
        return sup, msk, q1

    def _warm_paths(self) -> None:
        sup, msk, q1 = self._warm_inputs()
        if self.pipe.device.type == "cuda":
            from diffews_tpu_torch.ops import _build

            names = ["flash_attention_fwd", "groupnorm"]
            if self.pipe.vae_impl != "xla":
                names.append("fused_resnet")
            _build.build(names)
            for name in names:
                _build.load(name)
        cache = self.pipe.precompute_supports(sup, msk) if self.pipe.shot_mesh is None else None
        for bucket in self.buckets:
            if cache is not None:
                self.pipe.predict_cached_async(
                    np.repeat(q1, bucket, axis=0), cache,
                    r_threshold=self.r_threshold,
                    mask_on_device=True).result(need_seg=False)
            self.pipe.predict_async(
                np.repeat(q1, bucket, axis=0),
                np.broadcast_to(sup, (bucket,) + sup.shape[1:]),
                np.broadcast_to(msk, (bucket,) + msk.shape[1:]),
                r_threshold=self.r_threshold,
                mask_on_device=True).result(need_seg=False)

    def _pad_batch(self, q: np.ndarray) -> Tuple[np.ndarray, int]:
        n = q.shape[0]
        if n > self.bsz:
            raise ServeError(400, f"{n} queries > server batch {self.bsz}; "
                                  f"split the request")
        cap = next(b for b in self.buckets if b >= n)  # sorted; bsz last
        if n < cap:
            q = np.concatenate([q, np.repeat(q[-1:], cap - n, axis=0)])
        return q, n

    def _segment_cached(self, q, cache_id, r_thr, thr, need_seg=True):
        if self.artifact is not None:
            raise ServeError(400, "artifact mode has no support cache")
        if self.batch_window > 0 and q.shape[0] == 1:
            return self._segment_cached_batched(q, cache_id, r_thr, thr,
                                                need_seg)
        qp, n = self._pad_batch(q)
        cache = self._get_cache(cache_id)
        # mask_on_device + need_seg=False: the default masks-only response
        # transfers the packed bool mask instead of the full uint8 seg
        # (~24x fewer d2h bytes — pipeline.device_mask_from_seg)
        out = self._await(self._dispatch_pipelined(self._cached_call(
            qp, cache_id, cache, r_threshold=r_thr, threshold=thr, mask_on_device=True)),
                          need_seg=need_seg)
        return _slice_out(out, n)

    def _cached_call(self, qp, cache_id, cache, **opts):
        """The dispatch of a cached call: under the lock the followers get
        it, then rank 0 makes it.  Under a mesh a cache evicted since the
        lookup is gone on every rank (404); one process keeps the looked-up
        cache alive for the call."""
        def dispatch():
            if self._peers is not None:
                if cache_id not in self._caches:
                    raise ServeError(404, f"unknown cache_id {cache_id}")
                self._send("cached", cache_id=cache_id, q=qp, opts=opts)
            return self.pipe.predict_cached_async(qp, cache, **opts)
        return dispatch

    def _segment_cached_batched(self, q, cache_id, r_thr, thr,
                                need_seg=True):
        """Coalesce concurrent single-query requests on one cache.

        The first arrival becomes the leader: it sleeps the window, drains
        whatever queued behind it (in bsz chunks), runs ONE device call per
        chunk, and hands each waiter its row.  Thresholding runs IN-GRAPH
        on the chunk's device seg image, one tiny mask stage per distinct
        (r_threshold, threshold) pair among the chunk's items (normally
        one), so the masks-only common case transfers packed bool rows
        instead of the full uint8 seg (~24× fewer d2h bytes); the seg
        image itself is transferred only if some item asked for it (or
        has no threshold at all).
        """
        item = _MBItem(q, r_thr, thr, need_seg)
        with self._mb_lock:
            queue = self._mb_queues.setdefault(cache_id, [])
            queue.append(item)
            leader = len(queue) == 1
        if leader:
            time.sleep(self.batch_window)
            with self._mb_lock:
                batch = self._mb_queues.pop(cache_id, [])
            try:
                for i in range(0, len(batch), self.bsz):
                    chunk = batch[i:i + self.bsz]
                    qp, n = self._pad_batch(
                        np.concatenate([it.q for it in chunk]))
                    cache = self._get_cache(cache_id)
                    # dispatch under the lock, wait outside it: while this
                    # batch executes/transfers, the next window's leader
                    # (or a one-off request) dispatches behind it
                    pend = self._dispatch_pipelined(
                        self._cached_call(qp, cache_id, cache))
                    try:
                        img_dev = pend._img
                        pairs = {(it.r_thr, it.thr) for it in chunk
                                 if it.r_thr > 0 or it.thr > 0}
                        masks = {}
                        with torch.inference_mode():
                            for (pr, pt) in pairs:
                                rel = pr > 0
                                masks[(pr, pt)] = device_mask_from_seg(
                                    img_dev, float(pr if rel else pt),
                                    rel).cpu().numpy()
                            seg_host = None
                            if any(it.need_seg or (it.r_thr <= 0 and
                                                   it.thr <= 0)
                                   for it in chunk):
                                seg_host = img_dev.cpu().numpy()
                    finally:
                        # .cpu() waited for the device: safe to free the
                        # in-flight slot _await would release
                        self._inflight.release()
                    for j, it in enumerate(chunk):
                        m = masks.get((it.r_thr, it.thr))
                        it.mask = None if m is None else m[j:j + 1]
                        it.seg = (None if seg_host is None
                                  else seg_host[j:j + 1])
                        it.event.set()
            except Exception as e:
                for it in batch:
                    if not it.event.is_set():
                        it.error = e
                        it.event.set()
        if not item.event.wait(timeout=600):
            raise ServeError(503, "batched request timed out")
        if item.error is not None:
            raise item.error
        return SegOutput(seg_colored=item.seg, mask=item.mask)

    def _segment_episode(self, q, sup, msk, r_thr, thr, need_seg=True):
        qp, n = self._pad_batch(q)
        ns = sup.shape[0]
        if ns > self.nshot:
            raise ServeError(400, f"{ns} supports > server nshot "
                                  f"{self.nshot}")
        nb = qp.shape[0]  # the padded bucket size (== bsz without buckets)
        shot_mask = None
        if ns < self.nshot:  # pad + validity mask (static shapes)
            pad = np.repeat(sup[-1:], self.nshot - ns, axis=0)
            sup = np.concatenate([sup, pad])
            msk = np.concatenate(
                [msk, np.repeat(msk[-1:], self.nshot - ns, axis=0)])
            shot_mask = np.zeros((nb, self.nshot), bool)
            shot_mask[:, :ns] = True

        def dispatch():
            if self.artifact is not None:
                # the exported program's signature is frozen at uint8
                # {0,1} masks (serving.export_predict specs); the exported
                # graph ends at the seg image, so thresholding stays host
                img = self.artifact(qp, _each_row(sup, nb),
                                    _each_row(msk, nb).astype(np.uint8), shot_mask)
                return PendingSeg(img, r_thr, thr)
            opts = dict(r_threshold=r_thr, threshold=thr, mask_on_device=True)
            self._send("episode", q=qp, sup=sup, msk=msk, shot_mask=shot_mask, opts=opts)
            return self._episode_call(qp, sup, msk, shot_mask, opts)

        # artifact PendingSeg has no device mask -> need_seg is a no-op
        # there (the host formula needs the seg anyway)
        out = self._await(self._dispatch_pipelined(dispatch),
                          need_seg=need_seg)
        return _slice_out(out, n)

    def _episode_call(self, qp, sup, msk, shot_mask, opts) -> PendingSeg:
        """`predict_async` of a one-off episode: the request's supports and
        masks (N, S, S, ...) serve every row of the padded batch `qp`."""
        nb = qp.shape[0]
        return self.pipe.predict_async(qp, _each_row(sup, nb), _each_row(msk, nb),
                                       shot_mask=shot_mask, **opts)


def _each_row(x: np.ndarray, rows: int) -> np.ndarray:
    """`x` for each of `rows` batch rows (a broadcast view)."""
    return np.broadcast_to(x[None], (rows,) + x.shape)


def _slice_out(out, n: int):
    if out.seg_colored is not None:
        out.seg_colored = out.seg_colored[:n]
    if out.mask is not None:
        out.mask = out.mask[:n]
    return out


def make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Socket timeout on EVERY blocking socket op (not just the idle
        # keep-alive readline): without it a keep-alive client that parks
        # an idle pooled connection leaves its handler thread blocked in
        # readline() forever — the non-daemon thread keeps the interpreter
        # alive and server_close()'s drain join never returns (SIGTERM
        # would end in SIGKILL, not exit 0).  On timeout
        # BaseHTTPRequestHandler closes the connection, so an idle
        # connection bounds the drain by this many seconds.  Side effect:
        # a client that stalls >30 s mid-body-upload or mid-response-read
        # is also dropped — a transfer must make SOME progress every 30 s
        # (at --max_body_mb=64 that asks for >=2 MB/s of sustained upload;
        # slower links need a proxy that buffers, e.g. nginx).  Device
        # work (kernel builds, episode dispatch) is not a socket read and
        # is unaffected.
        timeout = 30

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, status: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if getattr(self.server, "draining", False):
                # hard drain bound: once shutdown begins, every response
                # closes its connection, so a busy keep-alive client can't
                # keep its handler thread (and the drain join) alive
                # indefinitely — each connection gets at most one more
                # response after the SIGTERM
                self.close_connection = True
            if self.close_connection:
                # e.g. the 413 reject path closes without draining the
                # body; without this header a conforming keep-alive client
                # would pool the dead connection and fail its next request
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _dispatch(self, name, fn, *args):
            t0 = time.monotonic()
            ok = False
            try:
                try:
                    resp = fn(*args)
                except ServeError as e:
                    self._send(e.status, {"error": str(e)})
                except Exception as e:  # surface, don't kill the thread
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                else:
                    self._send(200, resp)
                    ok = True  # only after the response is fully written
            except Exception:
                # the client hung up mid-write: a half-written response
                # can't carry a second status line — just account the
                # error (stats would otherwise undercount exactly the
                # timeout/disconnect failures an operator wants to see)
                pass
            finally:
                server.stats.record(name, time.monotonic() - t0, not ok)

        def _body(self) -> dict:
            if "chunked" in (self.headers.get("Transfer-Encoding") or ""):
                raise ServeError(411, "chunked bodies unsupported; send "
                                      "Content-Length")
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                raise ServeError(400, "bad Content-Length header")
            if n < 0:
                raise ServeError(400, "bad Content-Length header")
            if n > server.max_body_bytes:
                # reject BEFORE reading: a bogus huge Content-Length must
                # not allocate (the connection is closed, not drained)
                self.close_connection = True
                raise ServeError(
                    413, f"body {n} bytes > limit {server.max_body_bytes} "
                         f"(--max_body_mb)")
            raw = self.rfile.read(n) if n else b"{}"
            try:
                body = json.loads(raw or b"{}")
            except json.JSONDecodeError as e:
                raise ServeError(400, f"bad JSON body: {e}")
            if not isinstance(body, dict):
                raise ServeError(400, "body must be a JSON object")
            return body

        def do_GET(self):
            if self.path == "/healthz":
                self._dispatch("healthz", server.healthz)
            elif self.path == "/v1/stats":
                self._dispatch("stats", server.stats_snapshot)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                body = self._body()
            except ServeError as e:
                return self._send(e.status, {"error": str(e)})
            if self.path == "/v1/supports":
                self._dispatch("supports.add", server.add_supports, body)
            elif self.path == "/v1/segment":
                self._dispatch("segment", server.segment, body)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_DELETE(self):
            prefix = "/v1/supports/"
            if self.path.startswith(prefix):
                self._dispatch("supports.drop", server.drop_supports,
                               self.path[len(prefix):])
            else:
                self._send(404, {"error": f"no route {self.path}"})

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "DiffewS serving daemon (PyTorch port)", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="diffusers-layout checkpoint dir")
    src.add_argument("--artifact",
                     help="AOT serving-artifact dir from cli/export.py "
                          "(fixed-shape episodes, no support cache)")
    p.add_argument("--unet_ckpt_path", default=None)
    p.add_argument("--scheduler_load_path", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8710)
    p.add_argument("--bsz", type=int, default=4,
                   help="server batch: requests pad to this query count")
    p.add_argument("--nshot", type=int, default=1,
                   help="max supports for one-off episodes (pad + mask)")
    p.add_argument("--img-size", dest="img_size", type=int, default=512)
    p.add_argument("--r_threshold", type=float, default=0.25,
                   help="default relative threshold (eval protocol value)")
    p.add_argument("--max_caches", type=int, default=8,
                   help="support caches kept on device (FIFO eviction)")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="coalesce concurrent single-query cached requests "
                        "for this long into one padded device call "
                        "(0 = off); adds up to this much latency per "
                        "request, multiplies throughput up to --bsz under "
                        "concurrent load")
    p.add_argument("--warm_start", action="store_true",
                   help="build the kernel libraries and run every serving "
                        "path (each batch bucket + the one-off episode "
                        "path) on random inputs BEFORE accepting traffic, "
                        "so no request builds kernels under the dispatch "
                        "lock (recommended with --batch_buckets)")
    p.add_argument("--batch_buckets", type=str, default="",
                   help="comma list of batch sizes (e.g. '1,2,4') to pad "
                        "partial batches/windows to, instead of always "
                        "--bsz: cuts padded-batch compute waste at light "
                        "load. Pipe mode only")
    p.add_argument("--dispatch_depth", type=int, default=2,
                   help="in-flight device results; dispatch serializes on "
                        "the lock but requests wait outside it; bounds "
                        "queued outputs' device memory under load")
    p.add_argument("--max_body_mb", type=float, default=64.0,
                   help="reject request bodies above this size with 413 "
                        "before reading them (a bogus Content-Length must "
                        "not allocate)")
    p.add_argument("--num_data_shards", type=int, default=1,
                   help="shard the server batch over this many devices "
                        "(('data',) mesh; --bsz must divide evenly); one "
                        "process per device under torchrun")
    p.add_argument("--num_shot_shards", type=int, default=1,
                   help="shard episode SUPPORT SHOTS over this many devices "
                        "(('shots',) mesh with an exact per-attention softmax "
                        "merge; --nshot must divide evenly; composes with "
                        "--num_data_shards as a 2-D mesh). Disables "
                        "/v1/supports caching (the cache does not compose with "
                        "the cross-device merge); under torchrun")
    p.add_argument("--half_precision", action="store_true",
                   help="bf16 compute (the serving configuration on the card)")
    p.add_argument("--attn_impl", default="auto", choices=sorted(ATTN_IMPLS),
                   help="auto / pallas: the CUDA flash kernel on the card (its "
                        "plain version on the CPU); xla: dense attention")
    p.add_argument("--vae_impl", default="xla",
                   choices=["xla", "fused", "mixed", "auto", "int8"],
                   help="VAE resnet implementation; 'int8' quantizes the VAE's "
                        "3x3 convs W8A8 (static scales calibrated at load, the "
                        "int8 conv kernel on the card)")
    p.add_argument("--unet_int8", action="store_true",
                   help="W8A8 UNet self-attention, feed-forward and proj_in/out "
                        "linears (static scales calibrated at load); the cached "
                        "endpoints run them too")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, which must be "
                        "present; 'cpu' runs the kernels' plain versions)")
    return p


def _setup_meshes(args, device_type: str):
    """(mesh, shot_mesh) of a torchrun launch on `device_type`'s backend:
    the JAX daemon's meshes (`serve.py:874-890`)."""
    nds, nss = args.num_data_shards, args.num_shot_shards
    if not mesh_lib.launched():
        raise RuntimeError(
            "--num_data_shards / --num_shot_shards > 1: launch one process per device "
            f"with torchrun --nproc_per_node {nds * nss} -m diffews_tpu_torch.cli.serve ...")
    mesh_lib.maybe_initialize_distributed(device_type=device_type)
    if nss > 1:
        return None, mesh_lib.make_shot_mesh(device_type, nss, n_data=nds)
    return mesh_lib.make_mesh(device_type, nds), None


def make_server(args) -> ModelServer:
    # raised before any checkpoint or artifact is touched
    nds, nss = args.num_data_shards, args.num_shot_shards
    if args.artifact:
        if nds > 1 or nss > 1:
            raise SystemExit("--artifact serves a fixed single-device "
                             "program; export with the desired sharding "
                             "instead of --num_*_shards")
        from diffews_tpu_torch import serving

        mod = serving.load(args.artifact)
        if args.device is not None and torch.device(args.device).type != mod.device.type:
            raise SystemExit(f"{args.artifact} was exported on {mod.device.type}; "
                             f"--device {args.device} cannot serve it")
        return ModelServer(
            artifact=mod, bsz=mod.manifest["bsz"],
            nshot=mod.manifest["nshot"],
            img_size=mod.manifest.get("img_size", args.img_size),
            r_threshold=args.r_threshold,
            dispatch_depth=args.dispatch_depth,
            max_body_mb=args.max_body_mb, model_desc=args.artifact)
    if nds > 1 and args.bsz % nds:
        raise SystemExit(f"--bsz {args.bsz} must be divisible by "
                         f"--num_data_shards {nds}")
    if nss > 1 and args.nshot % nss:
        raise SystemExit(f"--nshot {args.nshot} must be divisible by "
                         f"--num_shot_shards {nss}")
    # no card and no --device cpu: raise before the checkpoint is loaded
    device = resolve_device(args.device)
    mesh = shot_mesh = peers = None
    if nds > 1 or nss > 1:
        mesh, shot_mesh = _setup_meshes(args, device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        peers = _Peers()
    pipe = DiffewsPipeline.from_pretrained(
        args.checkpoint, unet_dir=args.unet_ckpt_path,
        scheduler_dir=args.scheduler_load_path, device=device,
        compute_dtype=torch.bfloat16 if args.half_precision else torch.float32,
        attn_impl=ATTN_IMPLS[args.attn_impl], vae_impl=args.vae_impl,
        unet_int8=args.unet_int8, mesh=mesh, shot_mesh=shot_mesh)
    return ModelServer(pipe=pipe, bsz=args.bsz, nshot=args.nshot,
                       img_size=args.img_size, r_threshold=args.r_threshold,
                       max_caches=args.max_caches,
                       batch_window_ms=args.batch_window_ms,
                       dispatch_depth=args.dispatch_depth,
                       max_body_mb=args.max_body_mb,
                       model_desc=args.checkpoint,
                       batch_buckets=args.batch_buckets, peers=peers)


class _DrainingHTTPServer(ThreadingHTTPServer):
    # non-daemon handler threads + block_on_close: server_close() joins
    # in-flight requests, so a graceful stop finishes the work it accepted
    daemon_threads = False
    draining = False  # set by shutdown(); handlers then close connections

    def shutdown(self):
        self.draining = True
        super().shutdown()


def _follow(server: ModelServer) -> None:
    """A follower rank: no HTTP server; the device calls rank 0 hands it,
    until its stop.  The SIGTERM that torchrun forwards to every rank is
    ignored here: the follower stops when rank 0 has drained."""
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: None)
    except ValueError:
        pass  # not the main thread
    server.follow()
    print(f"serve: rank {server._peers.rank} stopped", flush=True)


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = make_server(args)
    try:
        if server.follower:
            return _follow(server)
        _serve(args, server)
    finally:
        if server._peers is not None and dist.is_initialized():
            dist.destroy_process_group()
    if server.peer_error is not None:
        raise SystemExit(f"serve: a follower rank failed ({server.peer_error}); stopped")


def _serve(args, server: ModelServer) -> None:
    if args.warm_start:
        t0 = time.monotonic()
        print("warm-start: building kernels and running serving paths "
              f"(buckets {server.buckets} + one-off episode)", flush=True)
        server.warm_start()
        print(f"warm-start done in {time.monotonic() - t0:.1f}s", flush=True)
    httpd = _DrainingHTTPServer((args.host, args.port), make_handler(server))
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"({server.healthz()['mode']} mode, bsz {server.bsz}, "
          f"nshot {server.nshot})", flush=True)

    # Graceful stop on SIGTERM (the orchestrator stop signal — kubernetes,
    # systemd, SLURM): stop ACCEPTING, finish in-flight requests, exit 0.
    # shutdown() must not run on the signal frame (it joins serve_forever's
    # own loop), so hand it to a thread.  A follower rank that fails stops
    # the daemon the same way.
    def _stop(signum=None, frame=None):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    server.on_peer_failure = _stop
    try:
        signal.signal(signal.SIGTERM, _stop)
    except ValueError:
        pass  # not the main thread (tests drive main() directly)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()  # joins in-flight handler threads
        server.close()  # then the followers stop
        print("serve: drained and stopped", flush=True)


if __name__ == "__main__":
    main()
