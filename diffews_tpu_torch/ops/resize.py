"""Nearest resize with torch `F.interpolate(mode="nearest")`'s index rule.

Port of `diffews_tpu/ops/resize.py::nearest_resize`: the legacy nearest
rule is `src = floor(dst * in/out)` (computed in float64, clamped), applied
by explicit index gathers on NHWC (or NHW) tensors so the layout matches
the JAX package.
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
