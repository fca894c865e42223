"""Serving-daemon quickstart for the PyTorch port: the HTTP API end to end.

Starts the port's daemon (`diffews_tpu_torch.cli.serve.ModelServer` behind
its HTTP handler) on a loopback port with a tiny random-weight model (real
use: `python -m diffews_tpu_torch.cli.serve --checkpoint <dir>`), then
drives it as a client would:

  1. register an annotated support set once  (POST /v1/supports)
  2. segment a stream of queries against it   (POST /v1/segment, cache_id)
  3. read the request metrics                 (GET  /v1/stats)

The daemon's API is the JAX package's, so `examples/serve_client.py`'s
client calls work against either daemon.  Runs on the CUDA card unless
given `--device cpu`:

    python examples/torch/serve_client.py [--device cpu]

(It lives in a directory of its own: the JAX package's examples beside it
run on the CPU with no arguments, this one on the card.)
"""

import argparse
import base64
import io
import json
import os
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
from PIL import Image

from diffews_tpu_torch.checkpoint import random_pipeline_bundle
from diffews_tpu_torch.cli import serve
from diffews_tpu_torch.configs import CLIPTextConfig, SchedulerConfig, UNetConfig, VAEConfig
from diffews_tpu_torch.pipeline import DiffewsPipeline


def b64_png(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # --- daemon (real use: the CLI with a checkpoint dir) ---------------
    bundle = random_pipeline_bundle(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                    SchedulerConfig.diffews(), seed=0)
    ms = serve.ModelServer(pipe=DiffewsPipeline(bundle, device=args.device), bsz=2, nshot=2,
                           img_size=32, r_threshold=0.25, model_desc="tiny")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(ms))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        print("daemon:", call(base, "GET", "/healthz"))

        # --- one support set, many queries ------------------------------
        rng = np.random.default_rng(0)
        support = rng.integers(0, 255, (48, 48, 3), np.uint8)
        mask = np.zeros((48, 48), np.uint8)
        mask[8:40, 8:40] = 255
        cache = call(base, "POST", "/v1/supports",
                     {"images": [b64_png(support)], "masks": [b64_png(mask)]})
        print("support cache:", cache)

        for i in range(3):  # e.g. frames of a video, images of a dataset
            frame = rng.integers(0, 255, (48, 48, 3), np.uint8)
            out = call(base, "POST", "/v1/segment",
                       {"query": b64_png(frame), "cache_id": cache["cache_id"]})
            got = Image.open(io.BytesIO(base64.b64decode(out["masks"][0])))
            print(f"frame {i}: mask {got.size}, {int((np.asarray(got) > 0).sum())} px on")

        # --- codec-free raw-tensor path (high request rates) -------------
        # {"raw": b64(uint8 bytes), "shape": [H, W, 3]} entries skip the PNG
        # codec on both ends; "encoding": "raw" answers the same way.
        frame = rng.integers(0, 255, (48, 48, 3), np.uint8)
        out = call(base, "POST", "/v1/segment",
                   {"query": {"raw": base64.b64encode(frame.tobytes()).decode(),
                              "shape": list(frame.shape)},
                    "cache_id": cache["cache_id"], "encoding": "raw"})
        ent = out["masks"][0]
        m = np.frombuffer(base64.b64decode(ent["raw"]), np.uint8).reshape(ent["shape"])
        print(f"raw frame: mask {m.shape}, {int((m > 0).sum())} px on")

        stats = call(base, "GET", "/v1/stats")
        seg = stats["endpoints"]["segment"]
        print(f"stats: {stats['queries']} queries, segment p50 {seg['p50_ms']} ms, "
              f"device {stats['device_s']} s over {stats['device_calls']} calls")
    finally:
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
