"""Hold the port's int8 path against the JAX package's past quantizer ties.

W8A8 rounds every activation to one of 255 codes.  The port and the JAX
package compute the activations in front of a quantizer in another order,
so a value within an ulp of a half-code boundary may round to the
neighbouring code in one of them.  The next layers carry that one-code step
(1/127 of the site's range) on, every later quantizer meets a perturbation
far above an ulp, and a tiny random-weight model turns the first such step
into tens of uint8 counts at the output: the float episode contract
(uint8 within one count on < 1% of pixels) cannot hold between the two int8
paths as it holds between their float paths.

`Int8Ties` holds it in two runs of the same calls:

  - `record()` (while active, in the JAX package): every int8 site
    (`quant.conv2d_int8`, `quant.linear_int8`) hands its int8 activations
    to the host through an ordered `jax.debug.callback`, in program order.
    It must be active when the JAX function is traced: a jitted function
    traced before keeps no callback.
  - `force()` (while active, in the port): `quant.quantize_s8` computes its
    own codes, compares them with the JAX run's codes of the same site (the
    next in order) and goes on with JAX's (`int8_force.py`, which needs no
    JAX, does this part).

So every site after the first sees JAX's codes, and the arithmetic around
them (weights, scales, integer sums, dequantization, and all the float
layers) must meet the float contract.  `stats` keeps, per site, the share
of codes that differed and the largest difference: a tie rounds one code
away, never more.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from diffews_tpu.ops import quant as JQ
from diffews_tpu_torch.ops import quant as TQ
from helpers import int8_force


def _jax_codes(p, x):
    """`quant.conv2d_int8` / `linear_int8`'s int8 activations."""
    if "a_scale" in p:
        s_a = p["a_scale"] / 127.0
    else:
        s_a = jnp.max(jnp.abs(x.astype(jnp.float32))) / 127.0
    s_a = jnp.maximum(s_a, 1e-12)
    return jnp.clip(jnp.round(x.astype(jnp.float32) / s_a), -127, 127).astype(jnp.int8)


class Int8Ties:
    def __init__(self):
        self.codes: list = []
        self.stats: list = []  # per forced site: (share of codes that differ, max |diff|)

    @contextlib.contextmanager
    def record(self):
        sink = self.codes
        saved = JQ.conv2d_int8, JQ.linear_int8

        def wrap(fn):
            def site(p, x, **kw):
                jax.debug.callback(lambda c: sink.append(np.asarray(c)), _jax_codes(p, x),
                                   ordered=True)
                return fn(p, x, **kw)
            return site

        JQ.conv2d_int8, JQ.linear_int8 = wrap(saved[0]), wrap(saved[1])
        try:
            yield self
        finally:
            JQ.conv2d_int8, JQ.linear_int8 = saved

    def take(self) -> list:
        """The codes recorded so far, in order; the record starts empty."""
        out = list(self.codes)
        self.codes.clear()
        return out

    def force(self, codes: list):
        """The port's quantizer, for the calls made while active, compares
        with and then returns `codes` in order (`int8_force.force`)."""
        return int8_force.force(codes, self.stats)

    def check_ties(self, max_share: float = 1e-3):
        """Every forced site's codes equal JAX's but at ties: at most one
        code apart, on at most `max_share` of a site's codes."""
        return int8_force.check_ties(self.stats, max_share)


CALIB_PX = 64


@contextlib.contextmanager
def small_calibration(px: int = CALIB_PX):
    """Both packages' pipelines calibrate their int8 VAE on the synthetic
    batch at `px` instead of 256 px.  The tiny VAE downsamples only 2x, so
    at 256 px its mid-block attention spans 128² = 16384 tokens and each
    pipeline's calibration takes seconds on one CPU thread; the scheme is
    the same at any size (`tests/test_torch_quant.py` holds the 256 px
    batch itself against JAX's)."""
    saved = JQ.calibrate_vae_scales, TQ.calibrate_vae_scales
    JQ.calibrate_vae_scales = lambda *a, **kw: saved[0](*a, **{"resolution": px, **kw})
    TQ.calibrate_vae_scales = lambda *a, **kw: saved[1](*a, **{"resolution": px, **kw})
    try:
        yield
    finally:
        JQ.calibrate_vae_scales, TQ.calibrate_vae_scales = saved


@contextlib.contextmanager
def int8_parity():
    """`small_calibration` and an `Int8Ties` recording the JAX package's
    int8 sites, for the life of a test module's int8 pipelines."""
    ties = Int8Ties()
    with small_calibration(), ties.record():
        yield ties


def assert_forced_episode(jax_call, port_call, ties: Int8Ties, seg=lambda o: o.seg_colored):
    """Run `jax_call()` (recording its int8 codes), then `port_call()` forced
    onto them: codes equal but at ties, and the uint8 segs within the
    episode contract (one count on < 1% of pixels).  Returns (JAX output,
    forced port output)."""
    ties.take()
    want = jax_call()
    jax.effects_barrier()
    codes = ties.take()
    assert codes, "the JAX run recorded no int8 site"
    ties.stats.clear()
    with ties.force(codes):
        got = port_call()
    ties.check_ties()
    a, b = np.asarray(seg(got)).astype(np.int32), np.asarray(seg(want)).astype(np.int32)
    d = np.abs(a - b)
    assert a.shape == b.shape and d.max() <= 1 and (d != 0).mean() < 0.01, (
        d.max(), (d != 0).mean())
    return want, got
