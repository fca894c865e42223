"""FSS-1000 episodic benchmark.

Behavior contract (`evaluation_util/data/fss.py`): 1000 categories split
520/240/240 (trn/val/test) with class-id offsets 520/760 (`:92-98,100-107`);
queries iterate the sorted per-category jpg listing; supports are sampled
among image indices 1..10 of the query's folder with rejection of the query
itself (`:92-98`); masks threshold grayscale >= 128 (`:77-81`).
"""

from __future__ import annotations

import glob
import os

import numpy as np
from PIL import Image

from diffews_tpu_torch.data.base import EpisodicDataset


class DatasetFSS(EpisodicDataset):
    benchmark = "fss"

    def __init__(self, datapath, fold, transform, split, shot, use_original_imgsize=False):
        super().__init__(datapath, fold, transform, split, shot, use_original_imgsize)
        self.split = split  # fss keeps 'test' distinct from 'val'
        self.base_path = os.path.join(datapath, "FSS-1000", "data")
        with open(os.path.join(datapath, "FSS-1000", "splits", f"{split}.txt")) as f:
            self.categories = sorted([c for c in f.read().split("\n") if c])

        self.class_ids = {
            "trn": range(0, 520), "val": range(520, 760), "test": range(760, 1000)
        }[split]

        self.img_metadata = []
        for cat in self.categories:
            paths = sorted(glob.glob(os.path.join(self.base_path, cat, "*")))
            self.img_metadata += [p for p in paths if p.endswith(".jpg")]

    def __len__(self):
        return len(self.img_metadata)

    def _read_mask(self, jpg_path):
        stem = os.path.splitext(os.path.basename(jpg_path))[0]
        png = os.path.join(os.path.dirname(jpg_path), stem + ".png")
        gray = np.array(Image.open(png).convert("L"))
        return (gray >= 128).astype(np.float32)

    def get_episode(self, idx):
        query_path = self.img_metadata[idx]
        cat = query_path.split("/")[-2]
        class_id = self.categories.index(cat)
        class_id += {"trn": 0, "val": 520, "test": 760}[self.split]

        support_paths = []
        while True:
            i = self.rng.choice(range(1, 11), 1, replace=False)[0]
            cand = os.path.join(os.path.dirname(query_path), f"{i}.jpg")
            if cand != query_path:
                support_paths.append(cand)
            if len(support_paths) == self.shot:
                break

        query_img = self._img(query_path)
        return self._episode(
            query_img, self._read_mask(query_path),
            [self._img(p) for p in support_paths],
            [self._read_mask(p) for p in support_paths],
            class_id, query_path, support_paths,
            rgb_path=query_path, org_qry_imsize=query_img.size,
        )
