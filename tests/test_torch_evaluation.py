"""Port parity of the scoring layer: `diffews_tpu_torch.evaluation` against
`diffews_tpu.evaluation` on seeded inputs.

`Evaluator.classify_prediction` (with and without the ignore-255 mask),
`AverageMeter` (updates, mIoU / FB-IoU, the `[Batch: ...]` and result
lines) and `Visualizer`'s episode strips equal the JAX package's; the two
`EvalLogger`s write to separate `log.txt` files in one process.  Mirrors
`tests/test_evaluation.py`.
"""

import os

import numpy as np
import pytest

from diffews_tpu.evaluation import AverageMeter as JMeter
from diffews_tpu.evaluation import Evaluator as JEval
from diffews_tpu.evaluation import vis as JV
from diffews_tpu.evaluation.meter import EvalLogger as JLog
from diffews_tpu_torch.evaluation import AverageMeter as TMeter
from diffews_tpu_torch.evaluation import Evaluator as TEval
from diffews_tpu_torch.evaluation import vis as TV
from diffews_tpu_torch.evaluation.meter import NCLASS, EvalLogger as TLog
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_classify_prediction_equals_jax(seed, ignore):
    rng = np.random.default_rng(seed)
    pred = (rng.random((3, 17, 13)) > 0.5).astype(np.int64)
    gt = (rng.random((3, 17, 13)) > 0.6).astype(np.float32)
    ig = None
    if ignore:
        ig = ((rng.random((3, 17, 13)) > 0.8) & (gt == 0)).astype(np.float32)
    got = TEval.classify_prediction(pred, gt, ig)
    want = JEval.classify_prediction(pred, gt, ig)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == (2, 3)
        np.testing.assert_array_equal(a, b)


def test_classify_prediction_known_values():
    pred = np.array([[[1, 1, 0, 0]]])
    gt = np.array([[[1, 0, 0, 0]]])
    inter, union = TEval.classify_prediction(pred, gt, np.array([[[0, 0, 0, 1]]]))
    np.testing.assert_array_equal(inter[:, 0], [1, 1])
    np.testing.assert_array_equal(union[:, 0], [2, 2])


@pytest.mark.parametrize("bench", sorted(NCLASS))
def test_meter_equals_jax(bench):
    rng = np.random.default_rng(len(bench))
    n = NCLASS[bench]
    class_ids = sorted(rng.choice(n, min(n, 7), replace=False).tolist())
    meters = [TMeter(bench, class_ids), JMeter(bench, class_ids)]
    for _ in range(5):
        inter = rng.integers(0, 50, (2, 3)).astype(np.float64)
        union = inter + rng.integers(0, 50, (2, 3))
        cid = rng.choice(class_ids, 3)
        for m in meters:
            m.update(inter, union, cid)
    (tm, tf, tc), (jm, jf, jc) = (m.compute_iou() for m in meters)
    assert (tm, tf) == (jm, jf)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(meters[0].intersection_buf, meters[1].intersection_buf)
    np.testing.assert_array_equal(meters[0].union_buf, meters[1].union_buf)


def test_meter_known_values():
    m = TMeter("coco", class_ids=[0, 4])
    m.update(np.array([[10], [5]]), np.array([[20], [10]]), [0])
    m.update(np.array([[10], [10]]), np.array([[10], [10]]), [4])
    miou, fb_iou, _ = m.compute_iou()
    assert abs(miou - 75.0) < 1e-6
    assert abs(fb_iou - ((0.75 + 2 / 3) / 2 * 100)) < 1e-6


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def test_loggers_write_separate_files_with_the_same_lines(tmp_path):
    """Both harnesses in one process: each `log.txt` gets its own package's
    lines only, and the `[Batch: ...]` and result lines are the same text."""
    TLog.initialize(None, root=str(tmp_path / "t"), benchmark="coco")
    JLog.initialize(None, root=str(tmp_path / "j"), benchmark="coco")
    metas = {}
    for name, meter_cls, log in (("t", TMeter, TLog), ("j", JMeter, JLog)):
        m = meter_cls("coco", [0, 4])
        m.update(np.array([[10], [5]]), np.array([[20], [10]]), [0])
        m.write_process(0, 8)
        m.write_process(1, 8)  # not a multiple of 50: no line
        m.write_result("Test", 0)
        log.info(f"only-{name}")
        metas[name] = log.logpath
    t_lines, j_lines = (_lines(os.path.join(metas[k], "log.txt")) for k in ("t", "j"))
    assert "only-t" in t_lines and "only-j" not in t_lines
    assert "only-j" in j_lines and "only-t" not in j_lines
    assert [s for s in t_lines if s != "only-t"] == [s for s in j_lines if s != "only-j"]
    assert any(s.startswith("[Batch: 0001/0008]") for s in t_lines)
    assert os.path.basename(metas["t"]).startswith("_TEST_coco_")
    assert metas["t"].endswith(".log")


def test_visualizer_strips_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    b, n, s = 2, 2, 16
    args = (rng.uniform(-1, 1, (b, n, 3, s, s)).astype(np.float32),
            rng.integers(0, 2, (b, n, s, s)).astype(np.float32),
            rng.uniform(-1, 1, (b, 3, s, s)).astype(np.float32),
            rng.integers(0, 2, (b, s, s)).astype(np.float32),
            rng.integers(0, 2, (b, s, s)).astype(np.float32))
    raw = (rng.integers(0, 256, (b, n, s, s, 3), dtype=np.uint8), args[1],
           rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8), args[3], args[4])
    for inputs in (args, raw):
        for i in range(b):
            got = TV.episode_strip(*(x[i] for x in inputs))
            want = JV.episode_strip(*(x[i] for x in inputs))
            assert got.dtype == np.uint8 and got.shape == (s, s * (n + 2), 3)
            np.testing.assert_array_equal(got, want)
    for name, mod in (("t", TV), ("j", JV)):
        mod.Visualizer.initialize(True, str(tmp_path / name))
        try:
            mod.Visualizer.visualize_prediction_batch(*args, np.array([3, 7]), batch_idx=0,
                                                      iou=np.array([0.5, 0.25]))
        finally:
            mod.Visualizer.initialize(False)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == b
    for f in names:
        np.testing.assert_array_equal(np.asarray(_open(tmp_path / "t" / f)),
                                      np.asarray(_open(tmp_path / "j" / f)))


def _open(path):
    from PIL import Image

    with Image.open(path) as im:
        return im.copy()


def test_visualizer_noop_when_disabled(tmp_path):
    TV.Visualizer.initialize(False, str(tmp_path / "vis"))
    TV.Visualizer.visualize_prediction_batch(None, None, np.zeros((1, 3, 4, 4)), None, None,
                                             [0], 0)
    assert not (tmp_path / "vis").exists()
