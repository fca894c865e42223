"""Benchmark-tree preparation from raw dataset downloads (a copy of
`diffews_tpu/cli/prepare.py` for the port, on its own mask codec).

The reference has no data-preparation code at all: its README delegates to
an external repo ("Preparing the dataset following Matcher ... You only need
to download the COCO 2014 dataset", `README.md:59-61`), whose users download
pre-rendered COCO-20i mask PNGs and fold metadata pickles.  This CLI builds
every benchmark tree self-contained from its raw download:

    coco         COCO-20i      from a raw COCO 2014 download
    pascal       PASCAL-5i     from raw VOC2012 (+ optional SBD)
    fss          FSS-1000      from the raw GitHub release
    lvis         LVIS-92i      from raw lvis_v1_{train,val}.json
    paco_part    PACO-Part     from raw paco_lvis_v1_{train,val}.json
    pascal_part  Pascal-Part   from the raw Annotations_Part .mat release

(PASCAL-CD reuses the `pascal` tree.)  Mask rasterization uses the repo's
own pycocotools-parity codec (`diffews_tpu_torch/data/masks.py`, native C++ when
available).  Each subcommand's docstring documents its conventions; where
the canonical artifact is distributed rather than generated (PASCAL-5i /
FSS-1000 split lists, PACO/Pascal-Part metadata), the built tree is
episode-protocol-compatible, and overwriting those files with canonical
ones restores exact seeded-episode parity.  The COCO-20i details below:

    python -m diffews_tpu_torch.cli.prepare coco \
        --coco_root /data/coco2014 --out /data/FSSBench/COCO2014

Input layout (the standard COCO 2014 download):
    {coco_root}/train2014/COCO_train2014_*.jpg
    {coco_root}/val2014/COCO_val2014_*.jpg
    {coco_root}/annotations/instances_train2014.json
    {coco_root}/annotations/instances_val2014.json

Output layout (what `data/coco.py` / the reference's
`evaluation_util/data/coco.py:74-87` read):
    {out}/train2014/, {out}/val2014/          symlinked image dirs
    {out}/annotations/{split}/<img>.png       uint8, pixel = class_id + 1
    {out}/splits/{trn,val}/fold{0..3}.pkl     {class_id: [img names]}

Conventions (documented because the canonical artifact is distributed, not
generated, and its generator is not public — episode-level parity with a
downloaded tree therefore depends on matching these choices):
  - class_id is the CONTIGUOUS index of the sorted COCO category ids
    (0..79), the standard COCO-20i convention; mask pixel = class_id + 1.
  - annotations paint in JSON order, later instances overwriting earlier
    ones where they overlap; crowd (iscrowd=1) annotations are skipped by
    default (`--include_crowd` paints them too).
  - a class counts as present in an image if the FINAL rendered mask
    (i.e. after overlap overwrites) has >= --min_pixels of it.
  - trn/fold{f}.pkl keys are the fold's 60 training classes and, by
    default, exclude images that also contain any of the fold's 20
    validation classes (the episodic-FSS anti-leakage rule;
    `--keep_val_class_images` disables).  val/fold{f}.pkl keys are the
    fold's 20 validation classes over val2014 images.
  - image lists are sorted (the seeded episode protocol indexes into them,
    so list ORDER affects which episodes seed 0 visits).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pickle
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from diffews_tpu_torch.data import masks as mask_codec

# (split dir, instances json, pkl split name) per COCO 2014 half
_COCO_SPLITS = (("train2014", "instances_train2014.json", "trn"),
                ("val2014", "instances_val2014.json", "val"))
_NFOLDS = 4
_NCLASS = 80


def contiguous_class_index(categories: Sequence[Dict]) -> Dict[int, int]:
    """Sorted COCO category ids -> contiguous 0..79 class ids."""
    cat_ids = sorted(c["id"] for c in categories)
    return {cid: i for i, cid in enumerate(cat_ids)}


def render_class_mask(height: int, width: int,
                      anns: Sequence[Tuple[int, object]]) -> np.ndarray:
    """Paint (class_id, segmentation) annotations into a uint8 class map.

    Pixel value = class_id + 1; later annotations overwrite earlier ones
    (JSON order), mirroring how the distributed COCO-20i PNGs resolve
    instance overlap.
    """
    out = np.zeros((height, width), np.uint8)
    for class_id, segm in anns:
        m = mask_codec.segmentation_to_mask(segm, height, width)
        out[m.astype(bool)] = class_id + 1
    return out


def _render_one(job) -> Tuple[str, List[int]]:
    """Worker: render + save one image's PNG; return classes present."""
    png_path, height, width, anns, min_pixels = job
    mask = render_class_mask(height, width, anns)
    os.makedirs(os.path.dirname(png_path), exist_ok=True)
    Image.fromarray(mask).save(png_path)
    present = [int(v) - 1 for v, n in
               zip(*np.unique(mask, return_counts=True))
               if v != 0 and n >= min_pixels]
    return png_path, present


def _val_ids(fold: int) -> List[int]:
    return [fold + _NFOLDS * v for v in range(_NCLASS // _NFOLDS)]


def prepare_coco(coco_root: str, out: str, workers: int = 0,
                 include_crowd: bool = False, min_pixels: int = 1,
                 keep_val_class_images: bool = False,
                 link_images: bool = True,
                 log=print) -> Dict[str, Dict[str, List[str]]]:
    """Build the COCO-20i tree; returns {split: {img_name: [class ids]}}."""
    presence_by_split = {}
    for split_dir, ann_json, pkl_split in _COCO_SPLITS:
        json_path = os.path.join(coco_root, "annotations", ann_json)
        with open(json_path) as f:
            coco = json.load(f)
        cat_to_idx = contiguous_class_index(coco["categories"])
        imgs = {im["id"]: im for im in coco["images"]}
        per_image: Dict[int, List[Tuple[int, object]]] = {}
        for ann in coco["annotations"]:  # JSON order = paint order
            if ann.get("iscrowd", 0) and not include_crowd:
                continue
            per_image.setdefault(ann["image_id"], []).append(
                (cat_to_idx[ann["category_id"]], ann["segmentation"]))

        jobs = []
        names = {}
        for img_id, anns in per_image.items():
            im = imgs[img_id]
            name = f"{split_dir}/{im['file_name']}"
            png = os.path.join(out, "annotations",
                               os.path.splitext(name)[0] + ".png")
            names[png] = name
            jobs.append((png, im["height"], im["width"], anns, min_pixels))

        log(f"{split_dir}: rendering {len(jobs)} masks "
            f"({len(imgs) - len(jobs)} images have no usable annotations)")
        if workers > 0:
            with multiprocessing.get_context("spawn").Pool(workers) as pool:
                results = pool.map(_render_one, jobs, chunksize=64)
        else:
            results = [_render_one(j) for j in jobs]
        presence = {names[png]: classes for png, classes in results}
        presence_by_split[split_dir] = presence

        if link_images:
            src = os.path.realpath(os.path.join(coco_root, split_dir))
            dst = os.path.join(out, split_dir)
            # lexists: a dangling symlink from a moved raw root must be
            # replaced, not crashed into
            if os.path.islink(dst) and os.path.realpath(dst) != src:
                os.unlink(dst)
            if not os.path.lexists(dst):
                os.makedirs(out, exist_ok=True)
                os.symlink(src, dst)

        # fold metadata: class id -> sorted image-name list.  Invert the
        # presence map once (class -> images, image -> class set) so the
        # per-fold pass is linear, not folds x classes x images scans —
        # real train2014 has ~82k annotated images.
        class_sets = {n: frozenset(cs) for n, cs in presence.items()}
        by_class: Dict[int, List[str]] = {c: [] for c in range(_NCLASS)}
        for n in sorted(presence):
            for c in class_sets[n]:
                by_class[c].append(n)  # names visit in sorted order
        pkl_dir = os.path.join(out, "splits", pkl_split)
        os.makedirs(pkl_dir, exist_ok=True)
        for fold in range(_NFOLDS):
            val_ids = frozenset(_val_ids(fold))
            if pkl_split == "val":
                fold_classes = sorted(val_ids)
                excluded = frozenset()
            else:
                fold_classes = [c for c in range(_NCLASS) if c not in val_ids]
                excluded = frozenset() if keep_val_class_images else \
                    frozenset(n for n, cs in class_sets.items()
                              if cs & val_ids)
            # every fold class keeps a key (possibly empty on toy inputs)
            # so the loader's classwise lookup never KeyErrors
            meta = {c: [n for n in by_class[c] if n not in excluded]
                    for c in fold_classes}
            with open(os.path.join(pkl_dir, f"fold{fold}.pkl"), "wb") as f:
                pickle.dump(meta, f)
            log(f"  {pkl_split}/fold{fold}.pkl: "
                f"{sum(len(v) for v in meta.values())} (class, image) pairs "
                f"over {len(meta)} classes")
    return presence_by_split


def _read_name_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _sbd_class_mask(mat_path: str) -> np.ndarray:
    """Class map from an SBD `cls/*.mat` (MATLAB GTcls struct)."""
    from scipy.io import loadmat

    gt = loadmat(mat_path, squeeze_me=True, struct_as_record=False)["GTcls"]
    return np.asarray(gt.Segmentation, dtype=np.uint8)


def prepare_pascal(voc_root: str, out: str, sbd_root: str = "",
                   min_pixels: int = 1, link_images: bool = True,
                   log=print) -> Dict[str, List[int]]:
    """Build the PASCAL-5i tree from raw VOC2012 (+ SBD) downloads.

    The canonical tree (what the reference's `evaluation_util/data/pascal.py`
    reads) ships as pre-built artifacts: DrSleep's `SegmentationClassAug`
    PNGs and HSNet's `splits/{trn,val}/fold{0..3}.txt` pair lists.  This
    builds both from the raw sources:

    Input:
        {voc_root}/JPEGImages/*.jpg                  (contains every SBD image)
        {voc_root}/SegmentationClass/*.png           palette class maps, 255 boundary
        {voc_root}/ImageSets/Segmentation/{train,val}.txt
        {sbd_root}/cls/*.mat + {sbd_root}/{train,val}.txt   (optional extra
            masks — the Berkeley SBD "benchmark_RELEASE/dataset" dir)

    Output (point --datapath at the PARENT of --out; name --out VOC2012):
        {out}/JPEGImages                             symlink
        {out}/SegmentationClassAug/{name}.png        uint8 class map (1..20,
                                                     255 = ignore boundary)
        {out}/splits/{trn,val}/fold{0..3}.txt        lines "name__cc"
                                                     (1-based class id)

    Conventions (documented because the canonical artifacts are distributed,
    not generated — exact seeded-episode parity with a downloaded tree
    requires the canonical split files, which can simply overwrite
    `splits/` here):
      - masks: the VOC `SegmentationClass` PNG wins where both exist (it
        carries the 255 ignore boundary); SBD `.mat` otherwise (no boundary).
      - fold f covers 1-based classes {5f+1..5f+5}; a (name, class) pair is
        listed when the class has >= --min_pixels pixels in the final mask.
      - trn pairs draw from (VOC train ∪ SBD train ∪ SBD val) minus VOC val
        (the standard "trainaug minus val" rule); val pairs from VOC val.
      - lines sort by (name, class) — the seeded protocol indexes into the
        val list, so line ORDER defines which episodes seed 0 visits.
    """
    seg_dir = os.path.join(voc_root, "ImageSets", "Segmentation")
    voc_train = _read_name_list(os.path.join(seg_dir, "train.txt"))
    voc_val = _read_name_list(os.path.join(seg_dir, "val.txt"))
    sbd_names: List[str] = []
    if sbd_root:
        for part in ("train.txt", "val.txt"):
            p = os.path.join(sbd_root, part)
            if os.path.exists(p):
                sbd_names += _read_name_list(p)

    names = sorted(set(voc_train) | set(voc_val) | set(sbd_names))
    ann_dir = os.path.join(out, "SegmentationClassAug")
    os.makedirs(ann_dir, exist_ok=True)
    voc_png_dir = os.path.join(voc_root, "SegmentationClass")
    presence: Dict[str, List[int]] = {}
    n_voc = n_sbd = 0
    for name in names:
        voc_png = os.path.join(voc_png_dir, name + ".png")
        if os.path.exists(voc_png):
            mask = np.array(Image.open(voc_png), dtype=np.uint8)
            n_voc += 1
        else:
            mask = _sbd_class_mask(os.path.join(sbd_root, "cls", name + ".mat"))
            n_sbd += 1
        Image.fromarray(mask).save(os.path.join(ann_dir, name + ".png"))
        vals, counts = np.unique(mask, return_counts=True)
        presence[name] = [int(v) for v, c in zip(vals, counts)
                          if 1 <= v <= 20 and c >= min_pixels]
    log(f"SegmentationClassAug: {len(names)} masks "
        f"({n_voc} from VOC PNGs, {n_sbd} from SBD .mat)")

    if link_images:
        src = os.path.realpath(os.path.join(voc_root, "JPEGImages"))
        dst = os.path.join(out, "JPEGImages")
        if os.path.islink(dst) and os.path.realpath(dst) != src:
            os.unlink(dst)
        if not os.path.lexists(dst):
            os.symlink(src, dst)

    val_set = frozenset(voc_val)
    pools = {"trn": [n for n in names if n not in val_set],
             "val": [n for n in names if n in val_set]}
    for split, pool in pools.items():
        d = os.path.join(out, "splits", split)
        os.makedirs(d, exist_ok=True)
        for fold in range(4):
            fold_cids = range(fold * 5 + 1, fold * 5 + 6)  # 1-based
            lines = [f"{n}__{c:02d}" for n in pool
                     for c in fold_cids if c in presence[n]]
            with open(os.path.join(d, f"fold{fold}.txt"), "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
            log(f"  splits/{split}/fold{fold}.txt: {len(lines)} pairs")
    return presence


# PASCAL VOC class names, 1-based order (class id c -> name [c-1])
PASCAL_CLASS_NAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# Contiguous COCO-80 class index (1-based) of each PASCAL class — the index
# the COCO-20i protocol folds over (`data/coco.py`: 0-based class c is a
# fold-f val class iff c % 4 == f).
_PASCAL_TO_COCO80 = {
    "aeroplane": 5, "bicycle": 2, "bird": 15, "boat": 9, "bottle": 40,
    "bus": 6, "car": 3, "cat": 16, "chair": 56, "cow": 20,
    "diningtable": 60, "dog": 17, "horse": 18, "motorbike": 4, "person": 1,
    "pottedplant": 58, "sheep": 19, "sofa": 57, "train": 7, "tvmonitor": 62,
}


def prepare_pascal_cd(out: str, folds_json: str = "", log=print) -> dict:
    """Add the cross-domain metadata to a prepared PASCAL-5i tree.

    `DatasetPASCALCD` (reference `pascal_voc_cd.py:27-28`) reads two torch
    pickles next to the PASCAL tree that the reference ships as opaque
    author artifacts with no in-repo provenance:

        {out}/cd_folds.pth       {fold: [1-based PASCAL class ids]}
        {out}/class_names.pth    [20 class names, id order]

    This generates both.  `--folds_json` reproduces an EXTERNAL fold spec
    exactly (a JSON object {"0": [ids...], ...} or list of 4 id lists —
    use this for parity with a specific published grouping, or simply drop
    the authors' own .pth files into the tree instead).  Without it, the
    default grouping is derived from the COCO-to-PASCAL protocol the CD
    benchmark models (train on COCO-20i fold f, evaluate on the PASCAL
    classes COCO fold f held out): each PASCAL class joins fold
    `(coco80_index - 1) % 4` of its contiguous COCO-80 class index — the
    same fold rule `data/coco.py` applies to COCO classes.  The derivation
    is deterministic and documented here precisely because the canonical
    artifact is not reconstructible from the reference repo.

    `out` is the VOC2012 dir produced by `prepare pascal` (the tree itself
    is shared; only these two files are CD-specific).
    """
    import torch

    if folds_json:
        with open(folds_json) as f:
            spec = json.load(f)
        if isinstance(spec, dict):
            folds = {int(k): [int(c) for c in v] for k, v in spec.items()}
        else:
            folds = {i: [int(c) for c in v] for i, v in enumerate(spec)}
    else:
        folds = {f: [] for f in range(4)}
        for cid, name in enumerate(PASCAL_CLASS_NAMES, start=1):
            folds[(_PASCAL_TO_COCO80[name] - 1) % 4].append(cid)
    ids = sorted(c for v in folds.values() for c in v)
    if ids != list(range(1, 21)) or sorted(folds) != [0, 1, 2, 3]:
        raise SystemExit(
            "fold spec must partition the 1-based PASCAL class ids 1..20 "
            f"over folds 0..3 (got folds {sorted(folds)}, ids {ids})")
    os.makedirs(out, exist_ok=True)
    torch.save(folds, os.path.join(out, "cd_folds.pth"))
    torch.save(list(PASCAL_CLASS_NAMES), os.path.join(out, "class_names.pth"))
    for f in range(4):
        log(f"  fold {f}: " + ", ".join(
            f"{c}:{PASCAL_CLASS_NAMES[c - 1]}" for c in sorted(folds[f])))
    return folds


def prepare_lvis(lvis_root: str, out: str, coco_images: str = "",
                 link_images: bool = True, log=print) -> None:
    """Build the LVIS-92i metadata tree from a raw LVIS v1 download.

    Input: `{lvis_root}/lvis_v1_train.json` + `lvis_v1_val.json` (images
    are the COCO 2017 set).  Output (what `data/lvis.py` / the reference's
    `evaluation_util/data/lvis.py:68-71` read):

        {out}/lvis_{train,val}.pkl   {cat_id: {img_name: {"annotations":
                                      [{"segmentation": ...}, ...]}}}
        {out}/coco/                  symlink to the COCO 2017 image root
                                     (train2017/ + val2017/ inside)

    Image names derive from each LVIS image's `coco_url` (its last two
    path components — LVIS val uses images from BOTH coco splits, so the
    split dir must come from the URL, not the json name).  Annotation
    dicts keep only the `segmentation` key (all the loader reads); the
    loader itself drops categories with <= nshot images and interleaves
    the 10 folds, so no fold filtering happens here.
    """
    for split in ("train", "val"):
        with open(os.path.join(lvis_root, f"lvis_v1_{split}.json")) as f:
            lvis = json.load(f)
        name_of = {im["id"]: "/".join(im["coco_url"].split("/")[-2:])
                   for im in lvis["images"]}
        meta: Dict[int, Dict[str, Dict]] = {}
        for ann in lvis["annotations"]:
            img = name_of[ann["image_id"]]
            entry = meta.setdefault(ann["category_id"], {}).setdefault(
                img, {"annotations": []})
            entry["annotations"].append(
                {"segmentation": ann["segmentation"]})
        # sort categories and per-category image keys: the loader's fold
        # interleave (val_cat_ids[fold + 10*v]) and episode sampling
        # (rng.choice over list(pool.keys())) both follow dict order, so
        # pkl ordering must be deterministic, not JSON-appearance order
        meta = {c: dict(sorted(meta[c].items())) for c in sorted(meta)}
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"lvis_{split}.pkl"), "wb") as f:
            pickle.dump(meta, f)
        log(f"lvis_{split}.pkl: {len(meta)} categories, "
            f"{sum(len(v) for v in meta.values())} (category, image) pairs")
    if link_images and coco_images:
        src = os.path.realpath(coco_images)
        dst = os.path.join(out, "coco")
        if os.path.islink(dst) and os.path.realpath(dst) != src:
            os.unlink(dst)
        if not os.path.lexists(dst):
            os.symlink(src, dst)


def prepare_paco_part(paco_root: str, out: str, coco_images: str = "",
                      link_images: bool = True, log=print) -> None:
    """Build the PACO-Part metadata pickles from a raw PACO-LVIS download.

    The reference reads Matcher-preprocessed `paco_part_{train,val}.pkl`
    (`evaluation_util/data/paco_part.py:40-44`); this builds them from the
    raw `{paco_root}/paco_lvis_v1_{train,val}.json` (images are COCO 2017).

    Output (what `data/paco_part.py` reads; --out should be named PACO-Part):
        {out}/paco/paco_part_{train,val}.pkl
            {"cid2img": {part_cat_id: [{img_id: "split2017/name.jpg"}]},
             "img2anno": {img_id: [{"category_id", "obj_ann_id",
                                    "obj_bbox", "segmentation"}]}}
        {out}/coco/    symlink to the COCO 2017 image root

    Conventions (the canonical pickles are distributed, not generated —
    exact seeded-episode parity requires them; this tree is episode-
    protocol-compatible, not episode-identical):
      - part categories are those whose name contains ':' (PACO's
        "object:part" naming); object annotations are located via each part
        annotation's `obj_ann_id` and contribute `obj_bbox` (xywh).
      - cid2img lists ONE entry per (part category, object instance) — an
        image repeats once per object carrying that part, weighting episode
        sampling by instance count (the loader de-duplicates val lists,
        reference `:70-84`); entries sort by (image name, obj_ann_id).
      - cid2img KEYS sort by category id; the loader derives the val folds
        from key order (`train_cat_ids[fold + 4*v]`, reference `:88-93`).
    """
    for split in ("train", "val"):
        with open(os.path.join(paco_root,
                               f"paco_lvis_v1_{split}.json")) as f:
            paco = json.load(f)
        part_cids = {c["id"] for c in paco["categories"]
                     if ":" in c["name"]}
        img_name = {}
        for im in paco["images"]:
            fn = im.get("file_name") or im.get("coco_url", "")
            img_name[im["id"]] = "/".join(fn.split("/")[-2:])
        ann_by_id = {a["id"]: a for a in paco["annotations"]}
        img2anno: Dict[int, List[Dict]] = {}
        instances: Dict[int, set] = {}
        dropped = 0
        for a in paco["annotations"]:
            if a["category_id"] not in part_cids:
                continue
            obj = ann_by_id.get(a.get("obj_ann_id"))
            if obj is None:  # orphaned part annotation
                dropped += 1
                continue
            img2anno.setdefault(a["image_id"], []).append(
                {"category_id": a["category_id"],
                 "obj_ann_id": a["obj_ann_id"],
                 "obj_bbox": obj["bbox"],
                 "segmentation": a["segmentation"]})
            instances.setdefault(a["category_id"], set()).add(
                (a["image_id"], a["obj_ann_id"]))
        cid2img = {
            cid: [{img_id: img_name[img_id]} for img_id, _ in
                  sorted(instances[cid],
                         key=lambda t: (img_name[t[0]], t[1]))]
            for cid in sorted(instances)}
        os.makedirs(os.path.join(out, "paco"), exist_ok=True)
        with open(os.path.join(out, "paco",
                               f"paco_part_{split}.pkl"), "wb") as f:
            pickle.dump({"cid2img": cid2img, "img2anno": img2anno}, f)
        log(f"paco_part_{split}.pkl: {len(cid2img)} part categories, "
            f"{sum(len(v) for v in cid2img.values())} instance entries"
            + (f" ({dropped} orphaned part annotations dropped)"
               if dropped else ""))
    if link_images and coco_images:
        src = os.path.realpath(coco_images)
        dst = os.path.join(out, "coco")
        if os.path.islink(dst) and os.path.realpath(dst) != src:
            os.unlink(dst)
        if not os.path.lexists(dst):
            os.makedirs(out, exist_ok=True)
            os.symlink(src, dst)


def prepare_fss(fss_root: str, out: str, link_images: bool = True,
                log=print) -> Dict[str, List[str]]:
    """Build the FSS-1000 benchmark tree from the raw dataset download.

    The raw release (`fewshot_data/<class>/{1..10}.{jpg,png}`) has no split
    lists; the 520/240/240 trn/val/test class partition the reference reads
    (`evaluation_util/data/fss.py:100-107`) ships as distributed text files.
    This writes both the layout and a split:

    Output (what `data/fss.py` reads; --out should be named FSS-1000):
        {out}/data                      symlink to the raw class dirs
        {out}/splits/{trn,val,test}.txt one class name per line

    Conventions: classes sort by name and partition 52%/24%/24% in that
    order (520/240/240 at the full 1000).  The canonical partition is a
    distributed artifact, not a derivable one — overwrite `splits/` with
    the canonical lists for exact seeded parity; the loader sorts each
    list, so order within a file does not matter.
    """
    if os.path.isdir(os.path.join(fss_root, "fewshot_data")):
        fss_root = os.path.join(fss_root, "fewshot_data")
    classes = sorted(
        d for d in os.listdir(fss_root)
        if os.path.isdir(os.path.join(fss_root, d))
        and any(f.endswith(".jpg")
                for f in os.listdir(os.path.join(fss_root, d))))
    if not classes:
        raise SystemExit(f"no class dirs with .jpg images under {fss_root}")
    n = len(classes)
    n_trn, n_val = round(0.52 * n), round(0.24 * n)
    splits = {"trn": classes[:n_trn],
              "val": classes[n_trn:n_trn + n_val],
              "test": classes[n_trn + n_val:]}
    os.makedirs(os.path.join(out, "splits"), exist_ok=True)
    for split, cats in splits.items():
        with open(os.path.join(out, "splits", f"{split}.txt"), "w") as f:
            f.write("\n".join(cats) + ("\n" if cats else ""))
        log(f"splits/{split}.txt: {len(cats)} classes")
    if link_images:
        src = os.path.realpath(fss_root)
        dst = os.path.join(out, "data")
        if os.path.islink(dst) and os.path.realpath(dst) != src:
            os.unlink(dst)
        if not os.path.lexists(dst):
            os.symlink(src, dst)
    return splits


# Pascal-Part raw part names -> merged part classes (instance suffixes
# like "engine_2" are stripped before lookup).  The reference's merged
# tree comes from an external preprocessor whose mapping is not public;
# this grouping follows the dataset's own laterality/instance structure
# (left/right/front/back copies of one anatomical part merge together).
_PPART_MERGE = {
    "HEAD": ("head", "leye", "reye", "lear", "rear", "nose", "muzzle",
             "beak", "lhorn", "rhorn", "lebrow", "rebrow", "mouth", "hair"),
    "TORSO": ("torso", "neck"),
    "WING": ("lwing", "rwing"),
    "TAIL": ("tail",),
    "LEG": ("lleg", "rleg", "lfleg", "rfleg", "lbleg", "rbleg",
            "lfuleg", "lflleg", "rfuleg", "rflleg", "lbuleg", "lblleg",
            "rbuleg", "rblleg", "llleg", "luleg", "rlleg", "ruleg"),
    "FOOT": ("lfoot", "rfoot", "lfpa", "rfpa", "lbpa", "rbpa",
             "lfho", "rfho", "lbho", "rbho"),
    "ARM": ("llarm", "luarm", "rlarm", "ruarm"),
    "HAND": ("lhand", "rhand"),
    "BODY": ("body",),
    "CAP": ("cap",),
    "POT": ("pot",),
    "PLANT": ("plant",),
    "SCREEN": ("screen",),
    "STERN": ("stern",),
    "ENGINE": ("engine",),
    "WHEEL": ("wheel", "fwheel", "bwheel", "chainwheel"),
    "SADDLE": ("saddle",),
    "HANDLEBAR": ("handlebar",),
    "LIGHT": ("headlight",),
    "DOOR": ("door",),
    "WINDOW": ("window",),
    "MIRROR": ("leftmirror", "rightmirror"),
    "PLATE": ("fliplate", "bliplate"),
    "SIDE": ("frontside", "leftside", "rightside", "backside", "roofside",
             "hfrontside", "hleftside", "hrightside", "hbackside",
             "hroofside", "cfrontside", "cleftside", "crightside",
             "cbackside", "croofside"),
    "COACH": ("coach",),
}
_PPART_RAW2MERGED = {raw: merged for merged, raws in _PPART_MERGE.items()
                     for raw in raws}
# object class -> super-category (fold); objects without part annotations
# (boat, chair, diningtable, sofa) never appear in the .mat parts and
# drop out naturally.
_PPART_SUPER = {
    "animals": ("bird", "cat", "cow", "dog", "horse", "sheep"),
    "indoor": ("bottle", "pottedplant", "tvmonitor"),
    "person": ("person",),
    "vehicles": ("aeroplane", "bicycle", "bus", "car", "motorbike",
                 "train"),
}
_PPART_OBJ2SUPER = {obj: sc for sc, objs in _PPART_SUPER.items()
                    for obj in objs}


def _merged_part_name(raw: str) -> str:
    base = raw.rsplit("_", 1)[0] if raw.rsplit("_", 1)[-1].isdigit() else raw
    return _PPART_RAW2MERGED.get(base, base.upper())


def _load_part_mat(mat_path: str):
    """(obj name, part name->bool mask dict) list from an Annotations_Part
    .mat (MATLAB `anno` struct: objects[].class/.mask/.parts[].part_name)."""
    from scipy.io import loadmat

    anno = loadmat(mat_path, squeeze_me=True, struct_as_record=False)["anno"]
    objects = []
    for o in np.atleast_1d(anno.objects):
        parts = getattr(o, "parts", None)
        plist = []
        if parts is not None and np.size(parts):
            for pt in np.atleast_1d(parts):
                plist.append((str(pt.part_name),
                              np.asarray(pt.mask, dtype=bool)))
        objects.append((str(getattr(o, "class")), plist))
    return objects


def prepare_pascal_part(parts_root: str, voc_root: str, out: str,
                        link_images: bool = True, log=print) -> Dict:
    """Build the Pascal-Part merged-class JSON tree from the raw dataset.

    The reference reads Matcher-preprocessed per-image JSONs plus a
    (super-category -> object -> part -> split image lists) index
    (`evaluation_util/data/pascal_part.py:26-46,125-128`); this builds both
    from the raw PASCAL-Part release (`Annotations_Part/*.mat`) and a
    VOC2010 download.

    Input:
        {parts_root}/*.mat                        the Annotations_Part dir
        {voc_root}/JPEGImages/*.jpg               VOC2010
        {voc_root}/ImageSets/Main/{train,val}.txt

    Output (what `data/pascal_part.py` reads; --out should be named
    Pascal-Part and --datapath should point at its parent):
        {out}/VOCdevkit/VOC2010/JPEGImages                  symlink
        {out}/VOCdevkit/VOC2010/
            Annotations_Part_json_merged_part_classes/{img}.json
                {"object": [{"name", "bndbox": {xmin,ymin,xmax,ymax},
                             "parts": [{"name": MERGED,
                                        "mask": [ascii-RLE]}]}]}
        {out}/VOCdevkit/VOC2010/all_obj_part_to_image.json
            {supercat: {"object": {obj: {"part":
                {MERGED: {"train": [ids], "val": [ids]}}}}}}

    Conventions (the canonical tree is distributed, not generated, and its
    merger is not public — this tree is episode-protocol-compatible, not
    episode-identical; overwrite both artifacts with canonical ones for
    exact seeded parity):
      - raw part names merge per `_PPART_MERGE` (laterality/instance copies
        of one part union into an UPPERCASE class; unknown names pass
        through uppercased); per-object union masks are re-encoded as one
        compressed COCO RLE with ascii counts.
      - bndbox is the object part-union's tight extent (xmin/ymin inclusive,
        xmax/ymax exclusive) — the raw release has object masks but no
        boxes, and the loader crops [y0:y1, x0:x1] (`pascal_part.py:29-34`).
      - objects with no part annotations are dropped; the split index lists
        an image under (obj, part) iff some instance in it has that part,
        so the loader's instance re-draw loop always terminates.
      - index keys sort by name at every level — the loader enumerates them
        in insertion order to assign episode class ids.
    """
    sets_dir = os.path.join(voc_root, "ImageSets", "Main")
    split_names = {split: _read_name_list(os.path.join(sets_dir, f"{split}.txt"))
                   for split in ("train", "val")}
    root = os.path.join(out, "VOCdevkit", "VOC2010")
    json_dir = os.path.join(root, "Annotations_Part_json_merged_part_classes")
    os.makedirs(json_dir, exist_ok=True)

    # {supercat: {obj: {part: {split: set(names)}}}}
    index: Dict[str, Dict[str, Dict[str, Dict[str, set]]]] = {}
    n_imgs = n_objs = 0
    missing = 0
    for split, names in split_names.items():
        for name in names:
            mat_path = os.path.join(parts_root, name + ".mat")
            if not os.path.exists(mat_path):
                missing += 1
                continue
            out_objects = []
            for obj_name, raw_parts in _load_part_mat(mat_path):
                if not raw_parts:
                    continue
                merged: Dict[str, np.ndarray] = {}
                for raw_name, pmask in raw_parts:
                    key = _merged_part_name(raw_name)
                    merged[key] = (pmask if key not in merged
                                   else (merged[key] | pmask))
                union = np.zeros_like(next(iter(merged.values())))
                for m in merged.values():
                    union |= m
                ys, xs = np.nonzero(union)
                if ys.size == 0:
                    continue
                parts_json = []
                for pname in sorted(merged):
                    rle = mask_codec.rle_encode(
                        merged[pname].astype(np.uint8))
                    rle["counts"] = rle["counts"].decode("ascii")
                    parts_json.append({"name": pname, "mask": [rle]})
                    sc = _PPART_OBJ2SUPER.get(obj_name)
                    if sc is not None:
                        (index.setdefault(sc, {})
                              .setdefault(obj_name, {})
                              .setdefault(pname, {"train": set(),
                                                  "val": set()})
                         [split].add(name))
                out_objects.append({
                    "name": obj_name,
                    "bndbox": {"xmin": int(xs.min()), "ymin": int(ys.min()),
                               "xmax": int(xs.max()) + 1,
                               "ymax": int(ys.max()) + 1},
                    "parts": parts_json,
                })
                n_objs += 1
            if out_objects:
                with open(os.path.join(json_dir, name + ".json"), "w") as f:
                    json.dump({"object": out_objects}, f)
                n_imgs += 1
    log(f"part JSONs: {n_imgs} images, {n_objs} objects"
        + (f" ({missing} split images without part annotations skipped)"
           if missing else ""))

    obj_part = {
        sc: {"object": {obj: {"part": {part: {s: sorted(v)
                                              for s, v in splits.items()}
                                       for part, splits in
                                       sorted(parts.items())}}
                        for obj, parts in sorted(objs.items())}}
        for sc, objs in sorted(index.items())}
    with open(os.path.join(root, "all_obj_part_to_image.json"), "w") as f:
        json.dump(obj_part, f)
    for sc in obj_part:
        pairs = sum(len(o["part"]) for o in obj_part[sc]["object"].values())
        log(f"  {sc}: {len(obj_part[sc]['object'])} objects, "
            f"{pairs} (object, part) classes")

    if link_images:
        src = os.path.realpath(os.path.join(voc_root, "JPEGImages"))
        dst = os.path.join(root, "JPEGImages")
        if os.path.islink(dst) and os.path.realpath(dst) != src:
            os.unlink(dst)
        if not os.path.lexists(dst):
            os.symlink(src, dst)
    return obj_part


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "DiffewS benchmark preparation (PyTorch port)",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="benchmark", required=True)
    c = sub.add_parser("coco", help="COCO-20i from a raw COCO 2014 download")
    c.add_argument("--coco_root", required=True,
                   help="dir with train2014/ val2014/ annotations/*.json")
    c.add_argument("--out", required=True,
                   help="output benchmark dir (point --datapath at its "
                        "parent; name it COCO2014)")
    c.add_argument("--workers", type=int,
                   default=max(1, (os.cpu_count() or 2) // 2),
                   help="mask-rendering processes (0 = in-process)")
    c.add_argument("--include_crowd", action="store_true",
                   help="paint iscrowd=1 annotations too (default: skip)")
    c.add_argument("--min_pixels", type=int, default=1,
                   help="min pixels of a class in the final mask for the "
                        "image to list under that class")
    c.add_argument("--keep_val_class_images", action="store_true",
                   help="keep training images that contain the fold's "
                        "validation classes (default: exclude — the "
                        "episodic-FSS anti-leakage rule)")
    c.add_argument("--no_link_images", action="store_true",
                   help="do not symlink the image dirs into --out")
    pa = sub.add_parser("pascal",
                        help="PASCAL-5i from raw VOC2012 (+ SBD) downloads")
    pa.add_argument("--voc_root", required=True,
                    help="VOCdevkit/VOC2012 dir (JPEGImages, "
                         "SegmentationClass, ImageSets/Segmentation)")
    pa.add_argument("--sbd_root", default="",
                    help="SBD benchmark_RELEASE/dataset dir (cls/*.mat, "
                         "train.txt, val.txt); omit to build from VOC only")
    pa.add_argument("--out", required=True,
                    help="output benchmark dir (point --datapath at its "
                         "parent; name it VOC2012)")
    pa.add_argument("--min_pixels", type=int, default=1,
                    help="min pixels of a class in the mask for the "
                         "(image, class) pair to be listed")
    pa.add_argument("--no_link_images", action="store_true")
    cd = sub.add_parser("pascal_cd",
                        help="PASCAL-CD metadata (cd_folds.pth + "
                             "class_names.pth) onto a prepared PASCAL tree")
    cd.add_argument("--out", required=True,
                    help="the VOC2012 dir `prepare pascal` produced")
    cd.add_argument("--folds_json", default="",
                    help="optional JSON fold spec ({\"0\": [ids...], ...} "
                         "or 4 lists, 1-based class ids) to reproduce an "
                         "external grouping exactly; default derives folds "
                         "from the COCO-20i rule on each class's COCO-80 "
                         "index")
    lv = sub.add_parser("lvis", help="LVIS-92i from a raw LVIS v1 download")
    lv.add_argument("--lvis_root", required=True,
                    help="dir with lvis_v1_train.json + lvis_v1_val.json")
    lv.add_argument("--out", required=True,
                    help="output benchmark dir (name it LVIS)")
    lv.add_argument("--coco_images", default="",
                    help="COCO 2017 image root (contains train2017/ and "
                         "val2017/); symlinked as {out}/coco")
    lv.add_argument("--no_link_images", action="store_true")
    pp = sub.add_parser("paco_part",
                        help="PACO-Part from a raw PACO-LVIS download")
    pp.add_argument("--paco_root", required=True,
                    help="dir with paco_lvis_v1_{train,val}.json")
    pp.add_argument("--out", required=True,
                    help="output benchmark dir (name it PACO-Part)")
    pp.add_argument("--coco_images", default="",
                    help="COCO 2017 image root (contains train2017/ and "
                         "val2017/); symlinked as {out}/coco")
    pp.add_argument("--no_link_images", action="store_true")
    qq = sub.add_parser("pascal_part",
                        help="Pascal-Part from the raw PASCAL-Part "
                             "annotations + VOC2010")
    qq.add_argument("--parts_root", required=True,
                    help="the raw Annotations_Part dir (*.mat)")
    qq.add_argument("--voc_root", required=True,
                    help="VOCdevkit/VOC2010 dir (JPEGImages, "
                         "ImageSets/Main/{train,val}.txt)")
    qq.add_argument("--out", required=True,
                    help="output benchmark dir (point --datapath at its "
                         "parent; name it Pascal-Part)")
    qq.add_argument("--no_link_images", action="store_true")
    fs = sub.add_parser("fss",
                        help="FSS-1000 from the raw dataset download")
    fs.add_argument("--fss_root", required=True,
                    help="the raw download's class-dir root (the dir "
                         "containing fewshot_data/ also works)")
    fs.add_argument("--out", required=True,
                    help="output benchmark dir (point --datapath at its "
                         "parent; name it FSS-1000)")
    fs.add_argument("--no_link_images", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.benchmark == "coco":
        prepare_coco(args.coco_root, args.out, workers=args.workers,
                     include_crowd=args.include_crowd,
                     min_pixels=args.min_pixels,
                     keep_val_class_images=args.keep_val_class_images,
                     link_images=not args.no_link_images)
        print(f"COCO-20i tree ready at {args.out}")
    elif args.benchmark == "pascal":
        prepare_pascal(args.voc_root, args.out, sbd_root=args.sbd_root,
                       min_pixels=args.min_pixels,
                       link_images=not args.no_link_images)
        print(f"PASCAL-5i tree ready at {args.out}")
    elif args.benchmark == "pascal_cd":
        prepare_pascal_cd(args.out, folds_json=args.folds_json)
        print(f"PASCAL-CD metadata ready at {args.out}")
    elif args.benchmark == "lvis":
        prepare_lvis(args.lvis_root, args.out, coco_images=args.coco_images,
                     link_images=not args.no_link_images)
        print(f"LVIS-92i tree ready at {args.out}")
    elif args.benchmark == "paco_part":
        prepare_paco_part(args.paco_root, args.out,
                          coco_images=args.coco_images,
                          link_images=not args.no_link_images)
        print(f"PACO-Part tree ready at {args.out}")
    elif args.benchmark == "pascal_part":
        prepare_pascal_part(args.parts_root, args.voc_root, args.out,
                            link_images=not args.no_link_images)
        print(f"Pascal-Part tree ready at {args.out}")
    elif args.benchmark == "fss":
        prepare_fss(args.fss_root, args.out,
                    link_images=not args.no_link_images)
        print(f"FSS-1000 tree ready at {args.out}")
    else:  # pragma: no cover - argparse enforces the choice
        sys.exit(f"unknown benchmark {args.benchmark}")


if __name__ == "__main__":
    main()
