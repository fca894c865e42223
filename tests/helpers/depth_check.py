"""The depth head's contract between two runs of it (the port against the
JAX package on the CPU, the card against the CPU in `chip_smoke.py`).

  - the raw map (before the min-max): |got − want| <= 5e-5 + 1e-4·|want|;
  - `depth_np`: per row, |got − want| <= 1e-4 / (max − min of want's raw
    row): the normalisation divides by that range;
  - `depth_colored`: < 1% of pixels differ, and by at most one step of the
    colormap's uint8 table.  A raw value within an ulp of a table bin's
    edge may fall in the neighbouring bin, and neighbouring entries of the
    Spectral table are up to `lut_step()` counts apart (more than one).

Imports numpy and the port only, so `chip_smoke.py` uses it on a host
without JAX.
"""

from __future__ import annotations

import numpy as np

RAW_ABS, RAW_REL = 5e-5, 1e-4
NORM_ABS = 1e-4
COLORED_SHARE = 0.01


def lut_step() -> int:
    """Largest per-channel uint8 difference between neighbouring entries of
    the Spectral table, as `depth_output` casts it."""
    from diffews_tpu_torch.utils.image import _lookup_table

    lut = (_lookup_table() * 255).astype(np.uint8).astype(np.int32)
    return int(np.abs(np.diff(lut, axis=0)).max())


def depth_close(raw_got, raw_want, got, want) -> tuple[dict, list]:
    """(stats, broken rules) of two depth runs: raw (B, H, W) maps and the
    two `DepthOutput`s made from them."""
    raw_got, raw_want = (np.asarray(x, np.float64) for x in (raw_got, raw_want))
    bad = []
    err = np.abs(raw_got - raw_want)
    over = err - (RAW_ABS + RAW_REL * np.abs(raw_want))
    if raw_got.shape != raw_want.shape or over.max() > 0:
        bad.append(f"raw map: max |diff| {err.max():.3g} over 5e-5 + 1e-4|want| "
                   f"by {over.max():.3g}")
    b = raw_want.shape[0]
    span = raw_want.reshape(b, -1).max(1) - raw_want.reshape(b, -1).min(1)
    nerr = np.abs(got.depth_np.astype(np.float64) - want.depth_np).reshape(b, -1).max(1)
    if (nerr > NORM_ABS / np.maximum(span, 1e-8)).any():
        bad.append(f"depth_np: per-row max |diff| {nerr.tolist()} over 1e-4 / range "
                   f"{span.tolist()}")
    stats = {"raw_max_abs": float(err.max()), "depth_np_max_abs": float(nerr.max()),
             "raw_range_min": float(span.min())}
    if want.depth_colored is not None:
        dc = np.abs(got.depth_colored.astype(np.int32) - want.depth_colored.astype(np.int32))
        share = float((dc.max(-1) > 0).mean())
        step = lut_step()
        if share >= COLORED_SHARE or dc.max() > step:
            bad.append(f"depth_colored: {share:.4f} of pixels differ, max {dc.max()} counts "
                       f"(allowed < {COLORED_SHARE} and <= one table step, {step})")
        stats.update(colored_max_diff=int(dc.max()), colored_share_differ=share)
    return stats, bad
