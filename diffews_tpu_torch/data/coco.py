"""COCO-20i episodic benchmark.

Behavior contract (`evaluation_util/data/coco.py`):
  - 80 classes, 4 folds; val classes `fold + 4*v` (`:62-68`)
  - episodes sampled RANDOMLY, ignoring the loader index (`:33-35,88-103`):
    class -> query -> rejection-sampled supports, via global np.random
  - masks come pre-rendered as `annotations/<img>.png` with pixel value
    class_id+1 (`:81-86,95-97`); metadata from `splits/{split}/fold{f}.pkl`
  - test length fixed at 1000 episodes (`:30`)
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from PIL import Image

from diffews_tpu_torch.data.base import EpisodicDataset


class DatasetCOCO(EpisodicDataset):
    benchmark = "coco"

    def __init__(self, datapath, fold, transform, split, shot, use_original_imgsize=False):
        super().__init__(datapath, fold, transform, split, shot, use_original_imgsize)
        self.nfolds = 4
        self.nclass = 80
        self.base_path = os.path.join(datapath, "COCO2014")

        nclass_val = self.nclass // self.nfolds
        val_ids = [self.fold + self.nfolds * v for v in range(nclass_val)]
        trn_ids = [c for c in range(self.nclass) if c not in val_ids]
        self.class_ids = trn_ids if self.split == "trn" else val_ids

        with open(os.path.join(self.base_path, "splits", self.split, f"fold{self.fold}.pkl"), "rb") as f:
            self.img_metadata_classwise = pickle.load(f)
        names = set()
        for v in self.img_metadata_classwise.values():
            names.update(v)
        self.img_metadata = sorted(names)

    def __len__(self):
        return len(self.img_metadata) if self.split == "trn" else 1000

    def _class_mask(self, img_name: str, class_id: int) -> np.ndarray:
        png = os.path.splitext(os.path.join(self.base_path, "annotations", img_name))[0] + ".png"
        raw = np.array(Image.open(png))
        return (raw == class_id + 1).astype(np.float32)

    def get_episode(self, idx):
        # idx intentionally ignored: uniform class sampling per episode.
        class_id = self.rng.choice(self.class_ids, 1, replace=False)[0]
        pool = self.img_metadata_classwise[class_id]
        query_name = self.rng.choice(pool, 1, replace=False)[0]

        support_names = []
        while True:
            cand = self.rng.choice(pool, 1, replace=False)[0]
            if cand != query_name:
                support_names.append(cand)
            if len(support_names) == self.shot:
                break

        query_img = self._img(os.path.join(self.base_path, query_name))
        query_mask = self._class_mask(query_name, class_id)
        support_imgs = [self._img(os.path.join(self.base_path, n)) for n in support_names]
        support_masks = [self._class_mask(n, class_id) for n in support_names]

        return self._episode(
            query_img, query_mask, support_imgs, support_masks,
            class_id, query_name, support_names,
            rgb_path=os.path.join(self.base_path, query_name),
            org_qry_imsize=query_img.size,
        )
