"""The port's `cli/prepare.py` against the JAX package's: every subcommand
on the same raw downloads (`helpers/raw_datasets.py`, the miniatures of
`tests/test_prepare.py`) writes the same tree, byte for byte (symlinks to
the same targets), and the port's episodic loader reads it."""

import json
import os

import numpy as np
import pytest

from diffews_tpu.cli import prepare as JPrep
from diffews_tpu_torch.cli import prepare as TPrep
from diffews_tpu_torch.data.dataset import FSSDataset
from helpers import raw_datasets as raw
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _tree(root):
    """{relative path: ("link", target) | ("file", bytes) | ("dir",)}."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.path.realpath(p))
            elif os.path.isdir(p):
                out[rel] = ("dir",)
            else:
                with open(p, "rb") as f:
                    out[rel] = ("file", f.read())
        dirnames[:] = [d for d in dirnames if not os.path.islink(os.path.join(dirpath, d))]
    return out


def _same_trees(tmp_path, argv_of, name):
    """Run both CLIs with `argv_of(out)` (a list of argv lists, run in
    order); return the port's output root after asserting equal trees."""
    outs = {}
    for pkg, mod in (("jax", JPrep), ("torch", TPrep)):
        out = str(tmp_path / pkg / name)
        for argv in argv_of(out):
            mod.main(argv)
        outs[pkg] = out
    got, want = _tree(outs["torch"]), _tree(outs["jax"])
    assert sorted(got) == sorted(want)
    diff = [k for k in want if got[k] != want[k]]
    assert not diff, diff
    assert any(v[0] == "file" for v in got.values())
    return outs["torch"]


def test_prepare_coco_equals_jax(tmp_path):
    src = raw.raw_coco(str(tmp_path / "raw"))
    out = _same_trees(tmp_path, lambda o: [["coco", "--coco_root", src, "--out", o,
                                             "--workers", "0"]], "COCO2014")
    _same_trees(tmp_path, lambda o: [["coco", "--coco_root", src, "--out", o, "--workers", "0",
                                      "--include_crowd", "--keep_val_class_images"]],
                "COCO2014_crowd")
    FSSDataset.initialize(img_size=32, datapath=os.path.dirname(out), raw_images=True)
    ds = FSSDataset.build_dataset("coco", fold=2, split="val", shot=1)
    ds.class_ids = [2]  # the toy tree populates only class 2 of this fold
    np.random.seed(0)
    ep = ds.get_episode(0)
    assert int(ep["class_id"]) == 2 and ep["query_img"].shape == (32, 32, 3)
    assert ep["query_mask"].max() == 1


def test_prepare_lvis_equals_jax(tmp_path):
    src = raw.raw_lvis(str(tmp_path / "raw"))
    _same_trees(tmp_path, lambda o: [["lvis", "--lvis_root", src, "--out", o,
                                      "--coco_images", os.path.join(src, "coco")]], "LVIS")


def test_prepare_pascal_and_cd_equal_jax(tmp_path):
    voc, sbd = raw.raw_pascal(str(tmp_path / "raw"))
    spec = tmp_path / "folds.json"
    spec.write_text(json.dumps({str(f): [f * 5 + i + 1 for i in range(5)] for f in range(4)}))
    _same_trees(tmp_path, lambda o: [["pascal", "--voc_root", voc, "--sbd_root", sbd,
                                      "--out", o], ["pascal_cd", "--out", o]], "VOC2012")
    out = _same_trees(tmp_path, lambda o: [["pascal", "--voc_root", voc, "--out", o],
                                           ["pascal_cd", "--out", o, "--folds_json",
                                            str(spec)]], "VOC2012_nosbd")
    FSSDataset.initialize(img_size=32, datapath=os.path.dirname(out), raw_images=True)
    with pytest.raises(SystemExit):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps([[1], [2], [3], [4]]))
        TPrep.main(["pascal_cd", "--out", out, "--folds_json", str(bad)])


def test_prepare_pascal_part_equals_jax(tmp_path):
    parts, voc = raw.raw_pascal_part(str(tmp_path / "raw"))
    out = _same_trees(tmp_path, lambda o: [["pascal_part", "--parts_root", parts, "--voc_root",
                                            voc, "--out", o]], "Pascal-Part")
    FSSDataset.initialize(img_size=32, datapath=os.path.dirname(out), raw_images=True)
    ds = FSSDataset.build_dataset("pascal_part", fold=0, split="val", shot=1)
    assert ds.cat_part_name == ["cat+HEAD", "cat+LEG", "cat+TORSO"]


def test_prepare_paco_part_equals_jax(tmp_path):
    paco, coco = raw.raw_paco(str(tmp_path / "raw"))
    _same_trees(tmp_path, lambda o: [["paco_part", "--paco_root", paco, "--out", o,
                                      "--coco_images", coco]], "PACO-Part")


def test_prepare_fss_equals_jax(tmp_path):
    src = raw.raw_fss(str(tmp_path / "raw"))
    out = _same_trees(tmp_path, lambda o: [["fss", "--fss_root", src, "--out", o]], "FSS-1000")
    FSSDataset.initialize(img_size=32, datapath=os.path.dirname(out), raw_images=True)
    assert len(FSSDataset.build_dataset("fss", fold=0, split="test", shot=1)) == 30


def test_merged_part_names_equal_jax():
    for raw_name in ("engine_2", "lfuleg", "rbpa", "cleftside_1", "blob", "head"):
        assert TPrep._merged_part_name(raw_name) == JPrep._merged_part_name(raw_name)
