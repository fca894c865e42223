"""PACO-Part episodic benchmark (object-part few-shot segmentation).

Behavior contract (`evaluation_util/data/paco_part.py`): metadata pickles
`paco_part_{train,val}.pkl` with 'cid2img' (category -> [{img_id: path}])
and 'img2anno' (img_id -> annotation list); val cid2img entries are
de-duplicated per image id (`:70-84`); 448 part classes, 4 folds interleaved
`fold + 4*v` filtered to categories with > shot val images (`:88-93`);
episodes sample class -> image -> one object instance, unioning that
object's part masks (`:127-152`); with `box_crop=True` (default) query and
supports are cropped to the object bbox (xywh) before transform
(`:202-222`); test length 2500 (`:33`).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from PIL import Image

from diffews_tpu_torch.data.base import EpisodicDataset
from diffews_tpu_torch.data.masks import segmentation_to_mask


def _crop_xywh(arr: np.ndarray, box):
    # clamp negatives to 0 so the mask crop stays aligned with the paired
    # image crop (`base._crop_img` clamps; raw numpy slicing would WRAP a
    # negative start to the array's far edge and yield an empty slice)
    x, y, w, h = (int(v) for v in box)
    x0, y0 = max(x, 0), max(y, 0)
    return arr[y0 : max(y + h, y0), x0 : max(x + w, x0)]


class DatasetPACOPart(EpisodicDataset):
    benchmark = "paco_part"

    def __init__(self, datapath, fold, transform, split, shot,
                 use_original_imgsize=False, box_crop=True):
        super().__init__(datapath, fold, transform, split, shot, use_original_imgsize)
        self.nfolds = 4
        self.nclass = 448
        self.box_crop = box_crop
        self.img_path = os.path.join(datapath, "PACO-Part", "coco")
        self.anno_path = os.path.join(datapath, "PACO-Part", "paco")

        with open(os.path.join(self.anno_path, "paco_part_train.pkl"), "rb") as f:
            train_anno = pickle.load(f)
        with open(os.path.join(self.anno_path, "paco_part_val.pkl"), "rb") as f:
            test_anno = pickle.load(f)

        # de-duplicate val images per category (reference `:70-84`)
        dedup = {}
        for cid, imgs in test_anno["cid2img"].items():
            seen, keep = set(), []
            for img in imgs:
                img_id = list(img.keys())[0]
                if img_id not in seen:
                    seen.add(img_id)
                    keep.append(img)
            dedup[cid] = keep
        test_anno["cid2img"] = dedup

        train_cat_ids = list(train_anno["cid2img"].keys())
        test_cat_ids = [c for c in test_anno["cid2img"] if len(test_anno["cid2img"][c]) > self.shot]
        n = self.nclass // self.nfolds
        class_ids_val = [train_cat_ids[self.fold + self.nfolds * v] for v in range(n)]
        class_ids_val = [c for c in class_ids_val if c in test_cat_ids]
        class_ids_trn = [c for c in train_cat_ids if c not in class_ids_val]

        anno = train_anno if self.split == "trn" else test_anno
        self.class_ids_ori = class_ids_trn if self.split == "trn" else class_ids_val
        self.cid2img = anno["cid2img"]
        self.img2anno = anno["img2anno"]
        self.class_ids_c = {cid: i for i, cid in enumerate(self.class_ids_ori)}
        self.class_ids = sorted(self.class_ids_c.values())

        self.img_metadata = []
        for k in self.cid2img:
            self.img_metadata += self.cid2img[k]

    def __len__(self):
        return len(self.img_metadata) if self.split == "trn" else 2500

    def _pick_object(self, img_id, class_id, size_wh, decode: bool):
        """Group annotations by object instance, pick one via np.random;
        returns (bbox, part segmentations or decoded union mask)."""
        w, h = size_wh
        objs = {}
        for anno in self.img2anno[img_id]:
            if anno["category_id"] == class_id:
                objs.setdefault(anno["obj_ann_id"], {"bbox": [], "segms": []})
                objs[anno["obj_ann_id"]]["bbox"].append(anno["obj_bbox"])
                objs[anno["obj_ann_id"]]["segms"].append(anno["segmentation"])
        sel = self.rng.choice(list(objs.keys()), 1, replace=False)[0]
        bbox = objs[sel]["bbox"][0]
        segms = objs[sel]["segms"]
        if not decode:
            return bbox, segms
        mask = np.zeros((h, w), bool)
        for s in segms:
            mask |= segmentation_to_mask(s, h, w)
        return bbox, mask.astype(np.float32)

    def _decode_union(self, segms, size_wh):
        w, h = size_wh
        mask = np.zeros((h, w), bool)
        for s in segms:
            mask |= segmentation_to_mask(s, h, w)
        return mask.astype(np.float32)

    def get_episode(self, idx):
        # idx ignored: uniform class sampling (reference `:36-38,128`)
        class_id = self.rng.choice(self.class_ids_ori, 1, replace=False)[0]
        pool = self.cid2img[class_id]

        query = self.rng.choice(pool, 1, replace=False)[0]
        query_id, query_path = next(iter(query.items()))
        query_name = "/".join(query_path.split("/")[-2:])
        query_img = self._img(os.path.join(self.img_path, query_name))
        q_bbox, query_mask = self._pick_object(query_id, class_id, query_img.size, decode=True)

        support_names, support_segms, support_boxes = [], [], []
        while True:
            sup = self.rng.choice(pool, 1, replace=False)[0]
            sup_id, sup_path = next(iter(sup.items()))
            sup_name = "/".join(sup_path.split("/")[-2:])
            if sup_name != query_name:
                support_names.append(sup_name)
                bbox, segms = self._pick_object(sup_id, class_id, (1, 1), decode=False)
                support_boxes.append(bbox)
                support_segms.append(segms)
            if len(support_names) == self.shot:
                break

        support_imgs, support_masks = [], []
        for name, segms in zip(support_names, support_segms):
            im = self._img(os.path.join(self.img_path, name))
            support_imgs.append(im)
            support_masks.append(self._decode_union(segms, im.size))

        if self.box_crop:
            # lazy PIL crops: decode lands on a finalize worker and
            # palette/CMYK sources convert correctly later (base._crop_img)
            x, y, w, h = (int(v) for v in q_bbox)
            query_img = self._crop_img(query_img, x, y, x + w, y + h)
            query_mask = _crop_xywh(query_mask, q_bbox)
            cropped_imgs, cropped_masks = [], []
            for im, m, box in zip(support_imgs, support_masks, support_boxes):
                x, y, w, h = (int(v) for v in box)
                cropped_imgs.append(self._crop_img(im, x, y, x + w, y + h))
                cropped_masks.append(_crop_xywh(m, box))
            support_imgs, support_masks = cropped_imgs, cropped_masks

        return self._episode(
            query_img, query_mask, support_imgs, support_masks,
            self.class_ids_c[class_id], query_name, support_names,
            rgb_path=os.path.join(self.img_path, query_name),
            org_qry_imsize=query_img.size,
        )
