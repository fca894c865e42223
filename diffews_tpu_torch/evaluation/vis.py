"""Optional episode visualization dumps.

Counterpart of `evaluation_util/common/vis.py:30-74`: per-episode horizontal
strip of [support(s) with mask overlay | query with gt overlay | query with
prediction overlay], saved under the vis dir named by class id and IoU.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image

_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
_STD = np.array([0.5, 0.5, 0.5], np.float32)
_MASK_COLOR = np.array([255, 50, 50], np.float32)


def _denorm(img_chw: np.ndarray) -> np.ndarray:
    if img_chw.dtype == np.uint8:  # raw-ingestion episodes are uint8 HWC
        return img_chw
    """(3,H,W) in [-1,1] -> (H,W,3) uint8."""
    x = img_chw.transpose(1, 2, 0) * _STD + _MEAN
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def _overlay(img: np.ndarray, mask: np.ndarray, alpha=0.5) -> np.ndarray:
    out = img.astype(np.float32)
    m = mask.astype(bool)
    out[m] = out[m] * (1 - alpha) + _MASK_COLOR * alpha
    return out.astype(np.uint8)


def episode_strip(support_imgs, support_masks, query_img, query_mask,
                  pred_mask) -> np.ndarray:
    """One episode -> horizontal [supports+mask | query+gt | query+pred]
    uint8 strip (the reference's per-episode panel layout, `vis.py:30-74`).

    support_imgs: (N,3,H,W) [-1,1] or (N,H,W,3) uint8; support_masks
    (N,H,W) binary or (N,3,H,W) [-1,1]; query_img (3,H,W)/(H,W,3);
    query_mask/pred_mask (H,W).
    """
    panels = []
    for s in range(support_imgs.shape[0]):
        sm = support_masks[s]
        if sm.ndim == 3:  # (3,H,W) in [-1,1] -> binary
            sm = sm[0] > 0
        panels.append(_overlay(_denorm(support_imgs[s]), sm))
    panels.append(_overlay(_denorm(query_img), query_mask))
    panels.append(_overlay(_denorm(query_img), pred_mask))
    return np.concatenate(panels, axis=1)


class Visualizer:
    visualize: bool = False
    vis_path: str = "./vis"

    @classmethod
    def initialize(cls, visualize: bool, vis_path: str = "./vis"):
        cls.visualize = visualize
        cls.vis_path = vis_path
        if visualize:
            os.makedirs(vis_path, exist_ok=True)

    @classmethod
    def visualize_prediction_batch(
        cls, support_imgs, support_masks, query_img, query_mask,
        pred_mask, class_id, batch_idx, iou: Optional[np.ndarray] = None,
    ):
        if not cls.visualize:
            return
        for b in range(query_img.shape[0]):
            strip = episode_strip(support_imgs[b], support_masks[b],
                                  query_img[b], query_mask[b], pred_mask[b])
            tag = f"{batch_idx}_class-{int(np.atleast_1d(class_id)[b])}"
            if iou is not None:
                tag += f"_iou-{float(np.atleast_1d(iou)[b]):.2f}"
            Image.fromarray(strip).save(os.path.join(cls.vis_path, tag + ".jpg"))
