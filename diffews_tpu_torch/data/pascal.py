"""PASCAL-5i episodic benchmark (+ cross-domain variant).

Behavior contract (`evaluation_util/data/pascal.py`):
  - 20 classes, 4 folds; val classes `fold*5 + i` (`:115-123`)
  - DETERMINISTIC query from `splits/{split}/fold{f}.txt` lines
    "name__classid" with `idx %= len` (`:37-38,104-113,135-148`); supports
    rejection-sampled via global np.random
  - masks are class-id PNGs in `SegmentationClassAug/`; ignore boundary is
    pixel value 255, returned as `query_ignore_idx` (`:78-83`)

Cross-domain variant (`pascal_voc_cd.py`): fold classes come from
`cd_folds.pth`/`class_names.pth` (1-based ids, `:111-120`), and val
metadata aggregates all 4 fold files filtered to those classes (`:131-140`).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from diffews_tpu_torch.data.base import EpisodicDataset

PASCAL_CLASS_NAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "potted plant", "sheep", "sofa", "train", "tv/monitor",
]


class DatasetPASCAL(EpisodicDataset):
    benchmark = "pascal"

    def __init__(self, datapath, fold, transform, split, shot, use_original_imgsize=False):
        super().__init__(datapath, fold, transform, split, shot, use_original_imgsize)
        self.nfolds = 4
        self.nclass = 20
        self.base_path = os.path.join(datapath, "VOC2012")
        self.img_path = os.path.join(self.base_path, "JPEGImages")
        self.ann_path = os.path.join(self.base_path, "SegmentationClassAug")

        self.class_ids = self._build_class_ids()
        self.cats = [PASCAL_CLASS_NAMES[i] for i in self.class_ids]
        self.img_metadata = self._build_metadata()
        self.img_metadata_classwise = {c: [] for c in range(self.nclass)}
        for name, cls in self.img_metadata:
            self.img_metadata_classwise[cls].append(name)

    def _build_class_ids(self):
        n = self.nclass // self.nfolds
        val_ids = [self.fold * n + i for i in range(n)]
        if self.split == "trn":
            return [c for c in range(self.nclass) if c not in val_ids]
        return val_ids

    def _read_fold_file(self, split, fold_id):
        path = os.path.join(self.base_path, "splits", split, f"fold{fold_id}.txt")
        with open(path) as f:
            lines = [ln for ln in f.read().split("\n") if ln]
        return [(ln.split("__")[0], int(ln.split("__")[1]) - 1) for ln in lines]

    def _build_metadata(self):
        if self.split == "trn":
            meta = []
            for fid in range(self.nfolds):
                if fid != self.fold:
                    meta += self._read_fold_file(self.split, fid)
            return meta
        return self._read_fold_file("val", self.fold)

    def __len__(self):
        return len(self.img_metadata) if self.split == "trn" else 1000

    def _read_class_mask(self, name):
        return np.array(Image.open(os.path.join(self.ann_path, name) + ".png"))

    @staticmethod
    def _binarize(raw: np.ndarray, class_id: int):
        """Returns (binary mask, ignore-boundary mask) — `pascal.py:78-83`."""
        boundary = np.floor(raw / 255.0)
        mask = (raw == class_id + 1).astype(np.float32)
        return mask, boundary.astype(np.float32)

    def get_episode(self, idx):
        idx %= len(self.img_metadata)
        query_name, class_id = self.img_metadata[idx]
        pool = self.img_metadata_classwise[class_id]
        support_names = []
        while True:
            cand = self.rng.choice(pool, 1, replace=False)[0]
            if cand != query_name:
                support_names.append(cand)
            if len(support_names) == self.shot:
                break

        query_img = self._img(os.path.join(self.img_path, query_name) + ".jpg")
        q_raw = self._read_class_mask(query_name)
        s = self.transform.img_size
        # Resize the RAW class mask first, then binarize — matches the
        # reference order (interpolate cmask, then extract_ignore_idx).
        from diffews_tpu_torch.data.transforms import nearest_resize_mask

        if not self.use_original_imgsize:
            q_raw = nearest_resize_mask(q_raw, (s, s))
        query_mask, query_ignore = self._binarize(q_raw, class_id)

        support_imgs, support_masks = [], []
        for n in support_names:
            support_imgs.append(self._img(os.path.join(self.img_path, n) + ".jpg"))
            s_raw = nearest_resize_mask(self._read_class_mask(n), (s, s))
            sm, _ = self._binarize(s_raw, class_id)
            support_masks.append(sm)

        ep = self._episode(
            query_img, query_mask, support_imgs, support_masks,
            class_id, query_name, support_names,
            rgb_path=os.path.join(self.img_path, query_name) + ".jpg",
            org_qry_imsize=query_img.size,
            query_ignore_idx=query_ignore,
        )
        # masks were already resized above; _episode's extra resize is a no-op
        return ep


class DatasetPASCALCD(DatasetPASCAL):
    """Cross-domain PASCAL variant (`pascal_voc_cd.py`)."""

    benchmark = "pascal"

    def __init__(self, datapath, fold, transform, split, shot, use_original_imgsize=False):
        import torch

        self._fold_classes = torch.load(
            os.path.join(datapath, "VOC2012", "cd_folds.pth"), weights_only=False
        )
        super().__init__(datapath, fold, transform, split, shot, use_original_imgsize)

    def _build_class_ids(self):
        val_ids = [x - 1 for x in self._fold_classes[self.fold]]
        if self.split == "trn":
            return [c for c in range(self.nclass) if c not in val_ids]
        return val_ids

    def _read_fold_file(self, split, fold_id):
        path = os.path.join(self.base_path, "splits", split, f"fold{fold_id}.txt")
        keep = set(self._fold_classes[self.fold])
        with open(path) as f:
            lines = [ln for ln in f.read().split("\n") if ln]
        return [
            (ln.split("__")[0], int(ln.split("__")[1]) - 1)
            for ln in lines
            if int(ln.split("__")[1]) in keep
        ]

    def _build_metadata(self):
        if self.split == "trn":
            meta = []
            for fid in range(self.nfolds):
                if fid != self.fold:
                    meta += self._read_fold_file(self.split, fid)
            return meta
        # CD val aggregates all fold files (filtered to fold classes)
        meta = []
        for fid in range(self.nfolds):
            meta += self._read_fold_file("val", fid)
        return meta
