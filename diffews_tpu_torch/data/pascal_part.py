"""Pascal-Part episodic benchmark.

Behavior contract (`evaluation_util/data/pascal_part.py`): super-category per
fold `['animals','indoor','person','vehicles'][fold]` (`:16`); obj+part
classes enumerated from `all_obj_part_to_image.json`, keeping only pairs
with both train and val images and skipping 'aeroplane+TAIL' (`:33-46`);
per-image part annotations live in
`Annotations_Part_json_merged_part_classes/{img}.json` with RLE masks whose
counts need ascii re-encoding (`:125-128`); episode class cycles via
`idx % len(class_ids)` (`:66-67`); query/support rejection loops re-draw
when the drawn object has no matching part (`:103-131,145-178`); box_crop
(xyxy) crops to the object (`:188-206`); test length min(len, 2500).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from diffews_tpu_torch.data.base import EpisodicDataset
from diffews_tpu_torch.data.masks import rle_decode

SUPER_CATEGORIES = ["animals", "indoor", "person", "vehicles"]


def _crop_xyxy(arr: np.ndarray, box):
    # clamp negatives to 0 to stay aligned with `base._crop_img` (raw numpy
    # slicing would wrap a negative start to the far edge: empty slice)
    x0, y0, x1, y1 = (int(v) for v in box)
    x0, y0 = max(x0, 0), max(y0, 0)
    return arr[y0 : max(y1, y0), x0 : max(x1, x0)]


class DatasetPASCALPart(EpisodicDataset):
    benchmark = "pascal_part"

    def __init__(self, datapath, fold, transform, split, shot,
                 use_original_imgsize=False, box_crop=True):
        super().__init__(datapath, fold, transform, split, shot, use_original_imgsize)
        # note: reference maps trn->'train' for the metadata split keys
        self.meta_split = "val" if split in ("val", "test") else "train"
        self.cat = SUPER_CATEGORIES[fold]
        self.box_crop = box_crop
        root = os.path.join(datapath, "Pascal-Part", "VOCdevkit", "VOC2010")
        self.img_file = os.path.join(root, "JPEGImages", "{}.jpg")
        self.anno_file = os.path.join(
            root, "Annotations_Part_json_merged_part_classes", "{}.json"
        )
        with open(os.path.join(root, "all_obj_part_to_image.json")) as f:
            self.cat_annos = json.load(f)[self.cat]

        names, ids = [], []
        new_id = 0
        for obj in self.cat_annos["object"]:
            for part in self.cat_annos["object"][obj]["part"]:
                entry = self.cat_annos["object"][obj]["part"][part]
                if len(entry["train"]) > 0 and len(entry["val"]) > 0:
                    if obj + "+" + part == "aeroplane+TAIL":
                        continue
                    names.append(obj + "+" + part)
                    ids.append(new_id)
                    new_id += 1
        self.cat_part_name = names
        self.class_ids = self.cat_part_id = ids
        self.nclass = len(ids)

        self.img_metadata = []
        for obj in self.cat_annos["object"]:
            for part in self.cat_annos["object"][obj]["part"]:
                self.img_metadata += self.cat_annos["object"][obj]["part"][part][self.meta_split]

    def __len__(self):
        if self.meta_split == "train":
            return len(self.img_metadata)
        return min(len(self.img_metadata), 2500)

    def _draw_instance(self, obj_n, part_n, img_id):
        """Pick an object instance of `obj_n` in the image; return its
        (bbox_xyxy, part union mask) or None when it has no `part_n`."""
        with open(self.anno_file.format(img_id)) as f:
            anno = json.load(f)
        candidates = [o for o in anno["object"] if o["name"] == obj_n]
        assert candidates
        sel_obj = self.rng.choice(candidates, 1, replace=False)[0]
        parts = [p for p in sel_obj["parts"] if p["name"] == part_n]
        if not parts:
            return None
        rles = []
        for p in parts:
            rles.extend(p["mask"])
        mask = None
        for r in rles:
            r = dict(r)
            if isinstance(r["counts"], str):
                r["counts"] = r["counts"].encode("ascii")
            m = rle_decode(r).astype(bool)
            mask = m if mask is None else (mask | m)
        if mask is None or mask.size == 0:
            return None
        bbox = [int(sel_obj["bndbox"][b]) for b in sel_obj["bndbox"]]
        return bbox, mask.astype(np.float32)

    def get_episode(self, idx):
        idx %= len(self.class_ids)
        class_name = self.cat_part_name[idx]
        obj_n, part_n = class_name.split("+")
        pool = self.cat_annos["object"][obj_n]["part"][part_n][self.meta_split]

        while True:
            query_id = self.rng.choice(pool, 1, replace=False)[0]
            got = self._draw_instance(obj_n, part_n, query_id)
            if got is not None:
                q_bbox, query_mask = got
                break

        query_img = self._img(self.img_file.format(query_id))

        support_ids, support_masks, support_boxes = [], [], []
        while len(support_ids) < self.shot:
            sup_id = self.rng.choice(pool, 1, replace=False)[0]
            if sup_id == query_id or sup_id in support_ids:
                continue
            got = self._draw_instance(obj_n, part_n, sup_id)
            if got is None:
                continue
            bbox, mask = got
            support_ids.append(sup_id)
            support_masks.append(mask)
            support_boxes.append(bbox)

        support_imgs = [self._img(self.img_file.format(i)) for i in support_ids]

        if self.box_crop:
            # lazy PIL crops: decode lands on a finalize worker and
            # palette/CMYK sources convert correctly later (base._crop_img)
            query_img = self._crop_img(query_img, *q_bbox)
            query_mask = _crop_xyxy(query_mask, q_bbox)
            new_imgs, new_masks = [], []
            for im, m, box in zip(support_imgs, support_masks, support_boxes):
                new_imgs.append(self._crop_img(im, *box))
                new_masks.append(_crop_xyxy(m, box))
            support_imgs, support_masks = new_imgs, new_masks

        ep = self._episode(
            query_img, query_mask, support_imgs, support_masks,
            self.class_ids[self.cat_part_name.index(class_name)],
            str(query_id), [str(i) for i in support_ids],
            rgb_path=self.img_file.format(query_id),
            org_qry_imsize=query_img.size,
        )
        ep["category"] = class_name
        return ep
