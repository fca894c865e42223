"""Joint episodes: batches of (query, supports, masks) through
`DiffewsPipeline.predict_async` → `PendingSeg.result`, in a closed loop
with `dispatch_ahead` batches in flight (`core.serve`)."""

from __future__ import annotations

from benchmark import checks, core, generator
from benchmark.reference import model as M

NUMBERS = checks.NUMBERS


def draw(d: generator.Draws, traffic: dict, latent) -> dict:
    return generator.episodes(d, traffic)


def count(s) -> None:
    """Query, support and mask images in one batched encode, as the
    program runs it; the joint UNet; the decode."""
    uc, vc = s.cfg["unet"], s.cfg["vae"]
    M.vae_encode_mean(s.vae, vc, s.meta(s.b + 2 * s.b * s.n, 3, s.r, s.r))
    M.unet(s.unet, uc, s.meta(s.b, uc["in_channels"], s.h, s.h), s.t, s.ctx,
           ref=s.meta(s.b, s.n, uc["ref_in_channels"], s.h, s.h))
    M.vae_decode(s.vae, vc, s.meta(s.b, vc["latent_channels"], s.h, s.h))


def submitter(pipe, traffic: dict, inputs: dict):
    """fn(i) queueing batch i of the pool (cycled) and returning its
    pending result; and what it keeps alive (nothing)."""
    pool, kw = inputs["batches"], core.serve_options(traffic)

    def submit(i):
        b = pool[i % len(pool)]
        return pipe.predict_async(b["query"], b["supports"], b["masks"], **kw)
    return submit, None


def reference(ref, traffic: dict, inputs: dict, t):
    """fn(batch) -> the reference's uint8 image of the batch."""
    return lambda b: ref.episode(t(b["query"]), t(b["supports"]), t(b["masks"]))


def run(cell, seed, seconds, traced, dev, t_start, program=None):
    return core.serve(cell, seed, seconds, traced, dev, t_start, program, submitter, reference)
