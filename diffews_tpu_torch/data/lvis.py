"""LVIS-92i episodic benchmark.

Behavior contract (`evaluation_util/data/lvis.py`): metadata pickles
`lvis_{train,val}.pkl` map category -> {img_name -> {'annotations': [...]}};
categories with <= shot samples are dropped (`:73-75`); 10 folds interleave
the surviving val categories (`:80-82`); the episode class cycles
deterministically via `idx % len(class_ids)` (`:39-40,122`) while query and
supports are sampled via global np.random; per-image masks union all
annotations of the class (`:131-137`); test length 2300 (`:34`).

Mask decode uses the native codecs in `diffews_tpu_torch.data.masks` instead of
pycocotools/detectron2.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from diffews_tpu_torch.data.base import EpisodicDataset
from diffews_tpu_torch.data.masks import segmentation_to_mask


class DatasetLVIS(EpisodicDataset):
    benchmark = "lvis"

    def __init__(self, datapath, fold, transform, split, shot, use_original_imgsize=False):
        super().__init__(datapath, fold, transform, split, shot, use_original_imgsize)
        self.nfolds = 10
        self.anno_path = os.path.join(datapath, "LVIS")
        self.base_path = os.path.join(datapath, "LVIS", "coco")

        with open(os.path.join(self.anno_path, "lvis_train.pkl"), "rb") as f:
            train_anno = pickle.load(f)
        with open(os.path.join(self.anno_path, "lvis_val.pkl"), "rb") as f:
            val_anno = pickle.load(f)

        train_cat_ids = [c for c in train_anno if len(train_anno[c]) > self.shot]
        val_cat_ids = [c for c in val_anno if len(val_anno[c]) > self.shot]
        n_val_split = len(val_cat_ids) // self.nfolds
        class_ids_val = [val_cat_ids[self.fold + self.nfolds * v] for v in range(n_val_split)]
        class_ids_trn = [c for c in train_cat_ids if c not in class_ids_val]

        self.class_ids_ori = class_ids_trn if self.split == "trn" else class_ids_val
        self.img_metadata_classwise = train_anno if self.split == "trn" else val_anno
        self.class_ids_c = {cid: i for i, cid in enumerate(self.class_ids_ori)}
        self.class_ids = sorted(self.class_ids_c.values())

        names = set()
        for k in self.img_metadata_classwise:
            names.update(self.img_metadata_classwise[k].keys())
        self.img_metadata = sorted(names)

    def __len__(self):
        return len(self.img_metadata) if self.split == "trn" else 2300

    def _union_mask(self, annos, size_wh):
        w, h = size_wh
        out = np.zeros((h, w), bool)
        for anno in annos:
            out |= segmentation_to_mask(anno["segmentation"], h, w)
        return out.astype(np.float32)

    def get_episode(self, idx):
        class_id = self.class_ids_ori[idx % len(self.class_ids)]
        pool = self.img_metadata_classwise[class_id]

        query_name = self.rng.choice(list(pool.keys()), 1, replace=False)[0]
        query_img = self._img(os.path.join(self.base_path, query_name))
        query_mask = self._union_mask(pool[query_name]["annotations"], query_img.size)

        support_names = []
        while True:
            cand = self.rng.choice(list(pool.keys()), 1, replace=False)[0]
            if cand != query_name:
                support_names.append(cand)
            if len(support_names) == self.shot:
                break

        support_imgs, support_masks = [], []
        for n in support_names:
            im = self._img(os.path.join(self.base_path, n))
            support_imgs.append(im)
            support_masks.append(self._union_mask(pool[n]["annotations"], im.size))

        return self._episode(
            query_img, query_mask, support_imgs, support_masks,
            self.class_ids_c[class_id], query_name, support_names,
            rgb_path=os.path.join(self.base_path, query_name),
            org_qry_imsize=query_img.size,
        )
