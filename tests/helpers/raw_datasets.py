"""Raw dataset downloads in miniature, for the `prepare` CLIs' tests.

The fixtures of `tests/test_prepare.py`, as functions that write under a
given root: a raw COCO 2014 download (polygons, compressed and
uncompressed RLE, a crowd annotation, non-contiguous category ids), LVIS
v1 (two instances of one category on one image, an RLE-only category),
VOC2012 + SBD (a VOC/SBD overlap where VOC wins, an ignore boundary,
SBD-only images), PASCAL-Part (laterality and instance merging, a partless
object, a listed image without annotations), PACO-LVIS (parts of two
objects on one image, an orphaned part annotation) and FSS-1000.  Imports
numpy, PIL, scipy and the port's mask codec only (no JAX).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from diffews_tpu_torch.data import masks as mask_codec


def poly_rect(x0, y0, x1, y1):
    """COCO polygon (flat xy list) for an axis-aligned rectangle."""
    return [[x0, y0, x1, y0, x1, y1, x0, y1]]


def rle_rect(h, w, y0, y1, x0, x1, compressed):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    rle = mask_codec.rle_encode(m)
    counts = rle["counts"]
    if compressed:
        counts = counts.decode("ascii")
    else:
        # uncompressed COCO RLE: plain run-length list, column-major
        flat = m.flatten(order="F")
        edges = np.flatnonzero(np.diff(flat))
        counts = np.diff(np.concatenate([[0], edges + 1, [flat.size]])).tolist()
        if flat[0] == 1:  # counts always start with a background run
            counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rect(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


def _write_list(p, names):
    with open(p, "w") as f:
        f.write("\n".join(names) + "\n")


def raw_coco(root: str) -> str:
    """A raw COCO 2014 download: images + instances_*.json."""
    rng = np.random.default_rng(0)
    H, W = 32, 48
    # category ids non-contiguous (real COCO skips ids): 7, 13, 90
    cats = [{"id": 13, "name": "b"}, {"id": 7, "name": "a"}, {"id": 90, "name": "c"}]

    def build_split(split):
        images, annotations = [], []

        def add_img(idx):
            name = f"COCO_{split}_{idx:012d}.jpg"
            p = os.path.join(root, split, name)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(p)
            images.append({"id": idx, "file_name": name, "height": H, "width": W})

        def add_ann(img_id, cat, segm, crowd=0):
            annotations.append({"id": len(annotations) + 1, "image_id": img_id,
                                "category_id": cat, "segmentation": segm, "iscrowd": crowd})

        add_img(1)  # polygon class 0 overlapped by polygon class 1 (paint order)
        add_ann(1, 7, poly_rect(4, 4, 20, 20))
        add_ann(1, 13, poly_rect(10, 10, 30, 24))
        add_img(2)  # compressed-RLE class 2 + a crowd annotation of class 0
        add_ann(2, 90, rle_rect(H, W, 2, 12, 2, 12, compressed=True))
        add_ann(2, 7, rle_rect(H, W, 20, 30, 20, 40, compressed=True), crowd=1)
        add_img(3)  # uncompressed-RLE class 1
        add_ann(3, 13, rle_rect(H, W, 8, 16, 8, 40, compressed=False))
        add_img(4)  # no annotations at all
        add_img(5)  # class 0 only
        add_ann(5, 7, poly_rect(0, 0, 16, 16))
        add_img(6)  # a second class-2 image
        add_ann(6, 90, poly_rect(8, 8, 28, 24))
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": cats}, f)

    build_split("train2014")
    build_split("val2014")
    return root


def raw_lvis(root: str) -> str:
    """A raw LVIS v1 download: lvis_v1_{train,val}.json + coco images."""
    rng = np.random.default_rng(1)
    H, W = 24, 36
    cats = [5 * k + 3 for k in range(10)]

    def build(split, coco_split):
        images, annotations = [], []
        for i in range(1, 5):
            name = f"{i:012d}.jpg"
            p = os.path.join(root, "coco", coco_split, name)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(p)
            images.append({"id": i, "height": H, "width": W,
                           "coco_url": f"http://images.cocodataset.org/{coco_split}/{name}"})
        for cat in cats:
            for img_id in (1, 2, 3):
                annotations.append({"id": len(annotations) + 1, "image_id": img_id,
                                    "category_id": cat,
                                    "segmentation": poly_rect(2, 2, 14, 12)})
        annotations.append({"id": len(annotations) + 1, "image_id": 1, "category_id": 3,
                            "segmentation": poly_rect(20, 14, 32, 22)})
        annotations.append({"id": len(annotations) + 1, "image_id": 4, "category_id": 9999,
                            "segmentation": rle_rect(H, W, 4, 12, 4, 20, compressed=True)})
        with open(os.path.join(root, f"lvis_v1_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": c} for c in cats + [9999]]}, f)

    build("train", "train2017")
    build("val", "val2017")
    return root


def raw_pascal(root: str) -> tuple[str, str]:
    """Raw VOC2012 + SBD downloads: (voc root, sbd root)."""
    from scipy.io import savemat

    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    sbd = os.path.join(root, "benchmark_RELEASE", "dataset")
    rng = np.random.default_rng(2)
    H, W = 30, 40
    for d in ("JPEGImages", "SegmentationClass", os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(voc, d))
    os.makedirs(os.path.join(sbd, "cls"))

    def class_map(classes):
        m = np.zeros((H, W), np.uint8)
        for i, c in enumerate(classes):
            m[5 * i + 2: 5 * i + 8, 4:24] = c
        return m

    def add(name, classes, voc_png=False, sbd_mat=False, sbd_classes=None):
        Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(
            os.path.join(voc, "JPEGImages", name + ".jpg"))
        if voc_png:
            m = class_map(classes)
            m[0, :] = 255  # VOC ignore boundary
            Image.fromarray(m).save(os.path.join(voc, "SegmentationClass", name + ".png"))
        if sbd_mat:
            savemat(os.path.join(sbd, "cls", name + ".mat"),
                    {"GTcls": {"Segmentation": class_map(sbd_classes or classes)}})

    add("a", [1, 6], voc_png=True, sbd_mat=True, sbd_classes=[9])  # VOC must win
    add("v1", [1], voc_png=True)
    add("v2", [1, 2], voc_png=True)
    add("v3", [2], voc_png=True)
    add("s1", [2], sbd_mat=True)
    add("s2", [6], sbd_mat=True)
    _write_list(os.path.join(voc, "ImageSets", "Segmentation", "train.txt"), ["a"])
    _write_list(os.path.join(voc, "ImageSets", "Segmentation", "val.txt"), ["v1", "v2", "v3"])
    _write_list(os.path.join(sbd, "train.txt"), ["a", "s1"])
    _write_list(os.path.join(sbd, "val.txt"), ["s2"])
    return voc, sbd


def raw_pascal_part(root: str) -> tuple[str, str]:
    """Raw PASCAL-Part download: (Annotations_Part root, VOC2010 root)."""
    from scipy.io import savemat

    voc = os.path.join(root, "VOCdevkit", "VOC2010")
    parts = os.path.join(root, "Annotations_Part")
    os.makedirs(os.path.join(voc, "JPEGImages"))
    os.makedirs(os.path.join(voc, "ImageSets", "Main"))
    os.makedirs(parts)
    rng = np.random.default_rng(3)
    H, W = 24, 32

    def mat_obj(cls, part_masks):
        return {"class": cls, "mask": rect(H, W, 0, H, 0, W), "parts":
                np.array([{"part_name": n, "mask": m} for n, m in part_masks], dtype=object)}

    def add(name, objs):
        Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(
            os.path.join(voc, "JPEGImages", name + ".jpg"))
        if objs is not None:
            savemat(os.path.join(parts, name + ".mat"),
                    {"anno": {"imname": name, "objects": np.array(objs, dtype=object)}})

    def cat_obj():
        return mat_obj("cat", [("head", rect(H, W, 2, 6, 4, 10)),
                               ("lear", rect(H, W, 0, 2, 4, 6)),
                               ("torso", rect(H, W, 6, 14, 4, 12)),
                               ("lfleg", rect(H, W, 14, 20, 4, 7))])

    def plane_obj():
        return mat_obj("aeroplane", [("body", rect(H, W, 8, 14, 2, 22)),
                                     ("tail", rect(H, W, 4, 8, 20, 24)),
                                     ("engine_1", rect(H, W, 14, 16, 6, 9)),
                                     ("engine_2", rect(H, W, 14, 16, 12, 15))])

    add("t_cat", [cat_obj(), mat_obj("boat", [])])  # the partless object is dropped
    add("t_plane", [plane_obj()])
    add("v_cat1", [cat_obj()])
    add("v_cat2", [cat_obj()])
    add("v_plane1", [plane_obj()])
    add("v_plane2", [plane_obj()])
    add("no_mat", None)  # listed in the split but no part annotations
    _write_list(os.path.join(voc, "ImageSets", "Main", "train.txt"),
                ["t_cat", "t_plane", "no_mat"])
    _write_list(os.path.join(voc, "ImageSets", "Main", "val.txt"),
                ["v_cat1", "v_cat2", "v_plane1", "v_plane2"])
    return parts, voc


def raw_paco(root: str) -> tuple[str, str]:
    """Raw PACO-LVIS download: (paco root, COCO 2017 image root)."""
    rng = np.random.default_rng(5)
    H, W = 24, 32
    cats = [{"id": 1, "name": "mug"}, {"id": 2, "name": "mug:handle"},
            {"id": 3, "name": "mug:body"}, {"id": 4, "name": "cup"},
            {"id": 5, "name": "cup:rim"}]
    for split in ("train", "val"):
        images, annotations = [], []
        for i in range(1, 4):
            name = f"{i:012d}.jpg"
            p = os.path.join(root, "coco", f"{split}2017", name)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(p)
            images.append({"id": i, "file_name": f"{split}2017/{name}", "height": H,
                           "width": W})

        def add(img, cat, segm, bbox, obj=None):
            annotations.append({"id": len(annotations) + 1, "image_id": img,
                                "category_id": cat, "segmentation": segm, "bbox": bbox,
                                **({} if obj is None else {"obj_ann_id": obj})})
            return len(annotations)

        for img in (1, 2, 3):
            mug = add(img, 1, poly_rect(2, 2, 20, 20), [2, 2, 18, 18])
            add(img, 2, poly_rect(14, 6, 20, 14), [14, 6, 6, 8], obj=mug)
            add(img, 3, rle_rect(H, W, 2, 20, 2, 14, compressed=True), [2, 2, 12, 18], obj=mug)
        cup = add(3, 4, poly_rect(22, 2, 30, 12), [22, 2, 8, 10])  # two objects on image 3
        add(3, 5, poly_rect(22, 2, 30, 4), [22, 2, 8, 2], obj=cup)
        add(2, 5, poly_rect(0, 0, 4, 4), [0, 0, 4, 4], obj=999)  # orphaned part
        with open(os.path.join(root, f"paco_lvis_v1_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": cats}, f)
    return root, os.path.join(root, "coco")


def raw_fss(root: str) -> str:
    """A raw FSS-1000 release: `fewshot_data/<class>/<i>.{jpg,png}`."""
    raw = os.path.join(root, "fewshot_data")
    rng = np.random.default_rng(4)
    for c in (f"class_{i:02d}" for i in range(10)):
        d = os.path.join(raw, c)
        os.makedirs(d)
        for i in range(1, 11):
            Image.fromarray(rng.integers(0, 255, (20, 20, 3), np.uint8)).save(
                os.path.join(d, f"{i}.jpg"))
            Image.fromarray(rng.integers(0, 2, (20, 20), np.uint8) * 255).save(
                os.path.join(d, f"{i}.png"))
    with open(os.path.join(raw, "notes.txt"), "w") as f:
        f.write("not a class dir")
    return root
