"""Queries against one cached support set: `precompute_supports` once in
set-up (set-up the traffic needs), then batches of queries through
`predict_cached_async` → `PendingSeg.result`, in a closed loop with
`dispatch_ahead` batches in flight (`core.serve`)."""

from __future__ import annotations

from benchmark import checks, core, generator
from benchmark.reference import model as M

NUMBERS = checks.NUMBERS


def draw(d: generator.Draws, traffic: dict, latent) -> dict:
    """`pool` batches of {"query"}, then one "support_set" {"supports":
    (C, N, H, W, 3), "masks": (C, N, H, W)} of `cache_batch` rows."""
    b, n, pool, c = traffic["batch"], traffic["shots"], traffic["pool"], traffic["cache_batch"]
    q = d.images(pool, b)
    return {"batches": [{"query": q[i]} for i in range(pool)],
            "support_set": {"supports": d.images(c, n), "masks": d.masks(c, n)}}


def count(s) -> None:
    """The query encode, the query stream against the cache, the decode
    (the capture is set-up's, not the batch's)."""
    uc, vc = s.cfg["unet"], s.cfg["vae"]
    entries: list = []
    M.unet(M.Net(), uc, s.meta(1, uc["in_channels"], s.h, s.h), s.t, s.ctx,
           ref=s.meta(1, s.n, uc["ref_in_channels"], s.h, s.h), capture=entries)
    M.vae_encode_mean(s.vae, vc, s.meta(s.b, 3, s.r, s.r))
    M.unet(s.unet, uc, s.meta(s.b, uc["in_channels"], s.h, s.h), s.t, s.ctx, cache=entries)
    M.vae_decode(s.vae, vc, s.meta(s.b, vc["latent_channels"], s.h, s.h))


def submitter(pipe, traffic: dict, inputs: dict):
    """fn(i) queueing the queries of batch i of the pool (cycled) against
    the support set's cache, made here; and the cache."""
    pool, kw = inputs["batches"], core.serve_options(traffic)
    s = inputs["support_set"]
    cache = pipe.precompute_supports(s["supports"], s["masks"])

    def submit(i):
        return pipe.predict_cached_async(pool[i % len(pool)]["query"], cache, **kw)
    return submit, cache


def reference(ref, traffic: dict, inputs: dict, t):
    """fn(batch) -> the reference's uint8 image of the batch's queries
    against its own capture of the support set."""
    s = inputs["support_set"]
    entries = ref.capture(t(s["supports"]), t(s["masks"]))
    return lambda b: ref.cached(t(b["query"]), entries)


def run(cell, seed, seconds, traced, dev, t_start, program=None):
    return core.serve(cell, seed, seconds, traced, dev, t_start, program, submitter, reference)
