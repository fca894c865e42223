"""Host-side episode preprocessing.

Reproduces the reference transform stack exactly
(`evaluation_util/data/dataset.py:36-40`): PIL bilinear resize to
(img_size, img_size) + ToTensor + Normalize(0.5, 0.5) for images, and
torch-`interpolate(mode='nearest')` semantics for masks
(`coco.py:42-47` etc.).  PIL performs the same antialiased bilinear resample
torchvision applies to PIL inputs, so using PIL here is bit-faithful.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image

from diffews_tpu_torch.ops.resize import _nearest_indices


class ImageTransform:
    """PIL RGB image -> float32 (3, S, S) in [-1, 1].

    With `raw=True`, stops after the bilinear resize and returns uint8
    (S, S, 3) HWC — the pipeline then performs the identical `/255, -0.5,
    /0.5` f32 arithmetic in-graph (`DiffewsPipeline._x0_latent`), which
    shrinks the host->device episode upload 4x with bit-identical results.
    """

    def __init__(self, img_size: int, raw: bool = False):
        self.img_size = img_size
        self.raw = raw

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = img.convert("RGB").resize((self.img_size, self.img_size), Image.BILINEAR)
        if self.raw:
            return np.asarray(img, dtype=np.uint8)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        arr = (arr - 0.5) / 0.5
        return arr.transpose(2, 0, 1)


def nearest_resize_mask(mask: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) mask -> (h, w) with torch-nearest index semantics."""
    h, w = mask.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return mask.astype(np.float32)
    ih = _nearest_indices(h, oh)
    iw = _nearest_indices(w, ow)
    return mask[np.ix_(ih, iw)].astype(np.float32)


def resize_max_res(img: Image.Image, max_edge_resolution: int) -> Image.Image:
    """Aspect-preserving downscale so the longer edge == max_edge_resolution
    (counterpart of `marigold/util/image_util.py:64-84`; only used for PIL
    pipeline inputs)."""
    w, h = img.size
    scale = min(max_edge_resolution / w, max_edge_resolution / h)
    return img.resize((int(w * scale), int(h * scale)))
