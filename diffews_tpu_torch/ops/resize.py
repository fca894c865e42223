"""Resizes with torch `F.interpolate`'s index rules, and the uint8 cast.

Port of `diffews_tpu/ops/resize.py`:

  - `nearest_resize`: the legacy nearest rule `src = floor(dst * in/out)`
    (computed in float64, clamped), applied by explicit index gathers on
    NHWC (or NHW) tensors so the layout matches the JAX package;
  - `bilinear_resize`: align_corners=False without antialias, the depth
    head's resize.  The index and weight tables come from float64 NumPy and
    are cast to float32, and the blend is JAX's arithmetic (`top*(1-hf) +
    bot*hf` over the height, then the same over the width), not
    `F.interpolate`'s, which agrees with it only to about 1e-4;
  - `uint8_quantize`: clip to [0, 255], then the truncating cast.
"""

from __future__ import annotations

import numpy as np
import torch

from diffews_tpu_torch.utils import to_device


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size, dtype=np.float64) * (in_size / out_size))
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def nearest_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC (or NHW) tensors, torch-`interpolate` compatible."""
    h_out, w_out = out_hw
    squeeze = x.ndim == 3
    if squeeze:
        x = x[..., None]
    h, w = x.shape[1], x.shape[2]
    if (h, w) != (h_out, w_out):
        ih = to_device(torch.from_numpy(_nearest_indices(h, h_out)), x.device)
        iw = to_device(torch.from_numpy(_nearest_indices(w, w_out)), x.device)
        x = x.index_select(1, ih).index_select(2, iw)
    return x[..., 0] if squeeze else x


def _bilinear_axis(in_size: int, out_size: int):
    """(lo, hi, frac) of one axis: source indices and the float32 weight of
    `hi`, from float64 arithmetic (JAX `resize.py:52-58`)."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (align_corners=False, no antialias) of an NHWC tensor."""
    h_out, w_out = out_hw
    h, w = x.shape[1], x.shape[2]
    if (h, w) == (h_out, w_out):
        return x
    put = lambda a: to_device(torch.from_numpy(a), x.device)  # noqa: E731
    hlo, hhi, hf = (put(a) for a in _bilinear_axis(h, h_out))
    wlo, whi, wf = (put(a) for a in _bilinear_axis(w, w_out))
    hf, wf = hf[None, :, None, None], wf[None, None, :, None]  # f32, as in JAX
    row = x.index_select(1, hlo) * (1 - hf) + x.index_select(1, hhi) * hf
    return row.index_select(2, wlo) * (1 - wf) + row.index_select(2, whi) * wf


def uint8_quantize(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 255], then the truncating cast to uint8: the reference's
    `clip(0, 255).cpu().numpy().astype(np.uint8)` round trip."""
    return x.clamp(0, 255).to(torch.uint8)
