"""Shared episodic-dataset machinery.

Episodes are host-side NumPy; devices only ever see fixed-shape batches.
Sampling uses the *global* NumPy legacy RNG in the same call order as the
reference datasets so that `seed(0)` replays the identical 1000/2300/2500
evaluation episodes (SURVEY.md §7 "Seeded episode-sampling parity").
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from diffews_tpu_torch.data.transforms import ImageTransform, nearest_resize_mask


class _LazyCrop:
    """A pending `img.crop(box)` that decodes only when consumed.

    Quacks like the slice of PIL image the transform needs: `.size` comes
    from the box arithmetic (no decode), `.convert(mode)` decodes the
    source, crops, and converts — on whichever thread calls it (a finalize
    worker under `defer_finalize`).  Needed because PIL's `crop` is eager
    since Pillow 3.4."""

    def __init__(self, img: Image.Image, box):
        self._img = img
        self._box = box

    @property
    def size(self):
        left, upper, right, lower = self._box
        return (right - left, lower - upper)

    def convert(self, mode: str) -> Image.Image:
        return self._img.crop(self._box).convert(mode)


class EpisodicDataset:
    """Base: subclasses set `benchmark`, `class_ids` and implement
    `__len__`/`get_episode(idx) -> dict`."""

    benchmark: str = ""
    class_ids: List[int] = []

    def __init__(self, datapath: str, fold: int, transform: ImageTransform,
                 split: str, shot: int, use_original_imgsize: bool = False):
        self.datapath = datapath
        self.fold = fold
        self.transform = transform
        self.split = "val" if split in ("val", "test") else "trn"
        self.shot = shot
        self.use_original_imgsize = use_original_imgsize
        # When True, get_episode returns {"_finalize": fn} and the expensive
        # image decode/resize work runs when fn() is called — the loader's
        # worker pool parallelizes it while episode SAMPLING (all RNG draws)
        # stays serialized in the producer, preserving the seeded episode
        # sequence exactly (SURVEY.md §7).
        self.defer_finalize = False
        # RNG hook for episode sampling.  Defaults to the global NumPy
        # legacy RNG module, replaying the reference's exact `seed(0)` draw
        # sequence (`evaluation_util/main_oss.py:33-36`).  Training swaps in
        # a private counter-keyed `np.random.RandomState` per batch
        # (loader `batch_seed` mode) so the train stream is a pure function
        # of (seed, batch index): exactly resumable with no RNG state in
        # checkpoints, and immune to other global-RNG consumers (e.g. the
        # periodic-validation protocol re-seeding).  `RandomState(s)` draws
        # the identical sequence as `np.random.seed(s)` + global calls, so
        # both paths share one behavior contract.
        self.rng = np.random

    # -- helpers ------------------------------------------------------------

    def _img(self, path: str) -> Image.Image:
        # Lazy open: PIL reads only the header here (size available); the
        # full decode happens at convert/resize time inside the transform,
        # i.e. on a finalize worker when deferral is on.
        return Image.open(path)

    @staticmethod
    def _crop_img(img: Image.Image, x0, y0, x1, y1) -> "_LazyCrop":
        """Deferred box crop with numpy-slice clamping semantics.

        Returns a `_LazyCrop` proxy: the source stays un-decoded until the
        transform's `convert()` runs — i.e. the JPEG decode lands on a
        finalize worker, not the in-order producer (PIL's own `crop` is
        EAGER since Pillow 3.4, so it cannot be used here directly).
        Because pointwise mode conversion commutes with cropping, the
        transform's later `convert("RGB")` handles palette/CMYK sources
        correctly (an `np.asarray` of a raw palette image yields palette
        INDICES and corrupts the episode).  Bounds are clamped like
        `arr[y0:y1, x0:x1]` for non-negative boxes (PIL would otherwise
        zero-pad out-of-range crops)."""
        w, h = img.size
        left = min(max(int(x0), 0), w)
        upper = min(max(int(y0), 0), h)
        right = min(max(int(x1), left), w)
        lower = min(max(int(y1), upper), h)
        return _LazyCrop(img, (left, upper, right, lower))

    def _episode(
        self,
        query_img: Image.Image,
        query_mask: np.ndarray,
        support_imgs: List[Image.Image],
        support_masks: List[np.ndarray],
        class_id: int,
        query_name: str,
        support_names: List[str],
        rgb_path: str,
        org_qry_imsize,
        query_ignore_idx: Optional[np.ndarray] = None,
    ) -> Dict:
        """Apply transforms and assemble the episode dict (NCHW, [-1,1]).

        With `defer_finalize` set, returns `{"_finalize": fn}` instead; the
        loader calls `fn()` (possibly on a worker thread) to run this body.
        No RNG is consumed past this point in any dataset, so deferral
        cannot perturb the seeded episode sequence."""

        def finalize():
            s = self.transform.img_size
            q = self.transform(query_img)
            qm, qi = query_mask, query_ignore_idx
            if not self.use_original_imgsize:
                qm = nearest_resize_mask(qm, (s, s))
                if qi is not None:
                    qi = nearest_resize_mask(qi, (s, s))
            sup = np.stack([self.transform(im) for im in support_imgs])
            smasks = np.stack([nearest_resize_mask(m, (s, s)) for m in support_masks])
            ep = {
                "rgb_path": rgb_path,
                "query_img": q,
                "query_mask": qm.astype(np.float32),
                "query_name": query_name,
                "org_query_imsize": org_qry_imsize,
                "support_imgs": sup,
                "support_masks": smasks,
                "support_names": support_names,
                "class_id": int(class_id),
            }
            if qi is not None:
                ep["query_ignore_idx"] = qi.astype(np.float32)
            return ep

        if self.defer_finalize:
            return {"_finalize": finalize}
        return finalize()

    def __getitem__(self, idx: int) -> Dict:
        return self.get_episode(idx)

    def get_episode(self, idx: int) -> Dict:  # pragma: no cover - abstract
        raise NotImplementedError
