"""Per-episode intersection/union computation.

Reproduces the 2-bin-histogram IoU semantics of the reference evaluator
(`evaluation_util/common/evaluation.py:12-39`), including the PASCAL
ignore-255 protocol (PFE-Net evaluation scheme): boundary pixels flagged in
`query_ignore_idx` are set to 255 in both gt and pred so they land outside
the [0,1] histogram range and count toward neither class.

Host-side NumPy: metric math is O(HW) per episode and does not belong on
the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IGNORE_INDEX = 255


def _hist2(x: np.ndarray) -> np.ndarray:
    """torch.histc(x, bins=2, min=0, max=1): [count in [0,.5], count in (.5,1]]."""
    x = x[(x >= 0) & (x <= 1)]
    lo = np.count_nonzero(x <= 0.5)
    return np.array([lo, x.size - lo], dtype=np.float64)


class Evaluator:
    """Computes per-episode foreground/background intersection and union."""

    ignore_index = IGNORE_INDEX

    @classmethod
    def classify_prediction(
        cls,
        pred_mask: np.ndarray,   # (B, H, W) {0,1}
        gt_mask: np.ndarray,     # (B, H, W) {0,1}
        query_ignore_idx: Optional[np.ndarray] = None,  # (B, H, W) {0,1}
    ) -> Tuple[np.ndarray, np.ndarray]:
        pred_mask = np.asarray(pred_mask).astype(np.int64).copy()
        gt_mask = np.asarray(gt_mask).astype(np.int64).copy()

        if query_ignore_idx is not None:
            ig = np.asarray(query_ignore_idx).astype(np.int64)
            assert np.logical_and(ig, gt_mask).sum() == 0
            gt_mask = gt_mask + ig * cls.ignore_index
            pred_mask[gt_mask == cls.ignore_index] = cls.ignore_index

        inter, pred_area, gt_area = [], [], []
        for p, g in zip(pred_mask, gt_mask):
            agree = p[p == g]
            inter.append(_hist2(agree) if agree.size else np.zeros(2))
            pred_area.append(_hist2(p))
            gt_area.append(_hist2(g))
        area_inter = np.stack(inter, axis=1)  # (2, B)
        area_union = np.stack(pred_area, axis=1) + np.stack(gt_area, axis=1) - area_inter
        return area_inter, area_union
