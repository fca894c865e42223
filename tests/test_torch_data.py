"""Port parity of the episodic data layer: `diffews_tpu_torch.data` against
`diffews_tpu.data` on the synthetic benchmark trees.

For each of the seven benchmarks both `FSSDataset`s, seeded alike, yield
identical episodes (every key, every array bit for bit) over six episodes,
with raw uint8 and with host-normalised images.  Also held: the COCO
sampler's global-RNG call sequence, threaded prefetch with two workers, the
counter-keyed `batch_seed` stream with resume mid-epoch and across an
epoch, the nearest mask resize, and `_LazyCrop`'s clamping of negative
boxes.  Mirrors `tests/test_data.py`.
"""

import numpy as np
import pytest

from diffews_tpu.data import base as JB
from diffews_tpu.data import loader as JL
from diffews_tpu.data.dataset import FSSDataset as JFSS
from diffews_tpu.data.paco_part import _crop_xywh as j_crop_xywh
from diffews_tpu.data.pascal_part import _crop_xyxy as j_crop_xyxy
from diffews_tpu.data.transforms import ImageTransform as JImageTransform
from diffews_tpu.data.transforms import nearest_resize_mask as j_nearest
from diffews_tpu_torch.data import base as TB
from diffews_tpu_torch.data import loader as TL
from diffews_tpu_torch.data.dataset import FSSDataset as TFSS
from diffews_tpu_torch.data.paco_part import _crop_xywh as t_crop_xywh
from diffews_tpu_torch.data.pascal_part import _crop_xyxy as t_crop_xyxy
from diffews_tpu_torch.data.transforms import ImageTransform as TImageTransform
from diffews_tpu_torch.data.transforms import nearest_resize_mask as t_nearest
from helpers import synthetic_data as syn
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)

# benchmark -> (tree writer, fold)
BENCHMARKS = {
    "coco": (syn.make_coco, 0),
    "pascal": (syn.make_pascal, 1),
    "fss": (syn.make_fss, 0),
    "lvis": (syn.make_lvis, 0),
    "paco_part": (lambda root: syn.make_paco(root, n_classes=448, imgs_per_class=3), 0),
    "pascal_part": (syn.make_pascal_part, 0),
    "pascal_cd": (syn.make_pascal_cd, 1),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One synthetic tree per benchmark, written on first use."""
    made = {}

    def get(bench):
        if bench not in made:
            root = str(tmp_path_factory.mktemp(bench))
            BENCHMARKS[bench][0](root)
            made[bench] = root
        return made[bench]

    return get


def assert_same_episode(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _datasets(root, bench, raw, shot=1, size=32):
    fold = BENCHMARKS[bench][1]
    out = []
    for fss in (JFSS, TFSS):
        fss.initialize(size, root, raw_images=raw)
        out.append(fss.build_dataset(bench, fold=fold, split="test", shot=shot))
    return out


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "normalised"])
@pytest.mark.parametrize("bench", sorted(BENCHMARKS))
def test_episodes_equal_jax(trees, bench, raw):
    jds, tds = _datasets(trees(bench), bench, raw)
    assert len(tds) == len(jds) and tds.class_ids == jds.class_ids
    assert tds.benchmark == jds.benchmark
    np.random.seed(0)
    want = [jds[i] for i in range(6)]
    np.random.seed(0)
    got = [tds[i] for i in range(6)]
    for a, b in zip(got, want):
        assert_same_episode(a, b)
    if raw:
        assert got[0]["query_img"].dtype == np.uint8


def test_two_shot_original_size_episodes_equal_jax(trees):
    """`use_original_imgsize` keeps the query mask at its native size."""
    root = trees("pascal")
    for fss in (JFSS, TFSS):
        fss.initialize(32, root, use_original_imgsize=True, raw_images=True)
    jds = JFSS.build_dataset("pascal", fold=1, split="test", shot=2)
    tds = TFSS.build_dataset("pascal", fold=1, split="test", shot=2)
    np.random.seed(3)
    want = [jds[i] for i in range(4)]
    np.random.seed(3)
    got = [tds[i] for i in range(4)]
    for a, b in zip(got, want):
        assert_same_episode(a, b)
    assert got[0]["query_mask"].shape != (32, 32)
    assert got[0]["support_imgs"].shape == (2, 32, 32, 3)


def test_rng_call_sequence_matches_reference_protocol(trees):
    """The port's COCO sampler replays the reference's exact global-RNG
    call sequence (`coco.py:88-103`)."""
    import os
    import pickle

    root = trees("coco")
    TFSS.initialize(32, root)
    ds = TFSS.build_dataset("coco", fold=0, split="test", shot=1)
    with open(os.path.join(root, "COCO2014/splits/val/fold0.pkl"), "rb") as f:
        meta = pickle.load(f)
    class_ids = [c for c in (0 + 4 * v for v in range(20)) if c in meta]
    np.random.seed(0)
    expected = []
    for _ in range(5):
        cls = np.random.choice(class_ids, 1, replace=False)[0]
        qry = np.random.choice(meta[cls], 1, replace=False)[0]
        while True:
            s = np.random.choice(meta[cls], 1, replace=False)[0]
            if s != qry:
                break
        expected.append((qry, (s,)))
    np.random.seed(0)
    got = [(ep["query_name"], tuple(ep["support_names"])) for ep in (ds[i] for i in range(5))]
    assert got == expected
    # and the global RNG is left where the reference leaves it
    np.random.seed(0)
    JFSS.initialize(32, root)
    jds = JFSS.build_dataset("coco", fold=0, split="test", shot=1)
    [jds[i] for i in range(5)]
    want_next = np.random.random()
    np.random.seed(0)
    [ds[i] for i in range(5)]
    assert np.random.random() == want_next


@pytest.mark.parametrize("bench", ["coco", "pascal_part"])
def test_threaded_prefetch_equals_sequential_and_jax(trees, bench):
    """`nworker` 2 defers decode/resize to a pool behind the in-order
    producer: the batches equal the sequential loader's and the JAX
    loader's, keys set after `_episode` included (pascal_part)."""
    jds, tds = _datasets(trees(bench), bench, raw=True)
    np.random.seed(0)
    want = [b for _, b in zip(range(3), JL.EpisodeLoader(jds, 2))]
    for workers in (0, 2):
        np.random.seed(0)
        got = [b for _, b in zip(range(3), TL.EpisodeLoader(tds, 2, num_workers=workers))]
        assert tds.defer_finalize is False
        for a, b in zip(got, want):
            assert_same_episode(a, b)


def test_worker_exception_surfaces(trees):
    TFSS.initialize(32, trees("coco"))
    ds = TFSS.build_dataset("coco", fold=0, split="test", shot=1)
    orig, calls = ds.get_episode, []

    def boom(idx):
        calls.append(idx)
        if len(calls) == 3:
            raise RuntimeError("bad episode")
        return orig(idx)

    ds.get_episode = boom
    np.random.seed(0)
    with pytest.raises(RuntimeError, match="bad episode"):
        for _ in TL.EpisodeLoader(ds, 1, num_workers=2):
            pass


def test_abandoned_iteration_reaps_producer(trees):
    import threading
    import time

    TFSS.initialize(32, trees("coco"))
    ds = TFSS.build_dataset("coco", fold=0, split="test", shot=1)
    before = set(threading.enumerate())
    np.random.seed(0)
    it = iter(TL.EpisodeLoader(ds, 1, num_workers=2))
    next(it)
    it.close()
    deadline = time.time() + 10.0
    while True:
        leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
        if not leaked or time.time() > deadline:
            break
        time.sleep(0.05)
    assert not leaked, f"leaked threads: {leaked}"
    assert ds.defer_finalize is False


class TestBatchSeedStream:
    """Training-mode stream (`batch_seed`): a pure function of (seed, batch
    counter), equal to the JAX loader's, resumable by `set_position`."""

    @pytest.fixture(scope="class")
    def small_coco(self, tmp_path_factory):
        root = str(tmp_path_factory.mktemp("bs_data"))
        # trn fold0 => 60 classes x 2 imgs = 120 episodes = 10 batches @ bsz 12
        syn.make_coco(root, imgs_per_class=2)
        return root

    @staticmethod
    def _loader(fss, root, batch_seed=123, workers=0):
        fss.initialize(32, root)
        return fss.build_dataloader("coco", 12, workers, 0, "trn", 1, batch_seed=batch_seed)

    @staticmethod
    def _take(loader, n):
        out = []
        while len(out) < n:
            for b in loader:
                out.append((list(b["query_name"]), [list(s) for s in b["support_names"]]))
                if len(out) == n:
                    break
        return out

    def test_stream_equals_jax_and_is_worker_invariant(self, small_coco):
        want = self._take(self._loader(JFSS, small_coco), 12)  # crosses an epoch
        assert self._take(self._loader(TFSS, small_coco), 12) == want
        assert self._take(self._loader(TFSS, small_coco, workers=2), 12) == want
        assert self._take(self._loader(TFSS, small_coco, batch_seed=7), 12) != want

    @pytest.mark.parametrize("k", [3, 10, 13])  # mid-epoch, boundary, next epoch
    def test_exact_resume(self, small_coco, k):
        full = self._take(self._loader(JFSS, small_coco), 16)
        resumed = self._loader(TFSS, small_coco)
        resumed.set_position(k)
        assert self._take(resumed, 16 - k) == full[k:]

    def test_isolated_from_global_rng(self, small_coco):
        clean = self._take(self._loader(TFSS, small_coco), 4)
        loader = self._loader(TFSS, small_coco)
        noisy = []
        for i in range(4):
            np.random.seed(i)
            np.random.random(17)
            noisy.extend(self._take(loader, 1))
        assert noisy == clean

    def test_set_position_needs_batch_seed(self, small_coco):
        with pytest.raises(ValueError, match="batch_seed"):
            self._loader(TFSS, small_coco, batch_seed=None).set_position(2)


def test_collate_equals_jax():
    rng = np.random.default_rng(0)
    eps = [{"a": rng.random((2, 3)), "n": i, "f": 0.5 * i, "s": f"x{i}", "l": [i, i]}
           for i in range(3)]
    assert_same_episode(TL.collate(eps), JL.collate(eps))


@pytest.mark.parametrize("out_hw", [(64, 64), (17, 50), (30, 41)])
def test_nearest_resize_mask_equals_jax_and_torch(out_hw):
    import torch
    import torch.nn.functional as F

    m = (np.random.default_rng(2).random((30, 41)) > 0.5).astype(np.float32)
    got = t_nearest(m, out_hw)
    np.testing.assert_array_equal(got, j_nearest(m, out_hw))
    want = F.interpolate(torch.from_numpy(m)[None, None], out_hw, mode="nearest")[0, 0]
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("raw", [True, False])
def test_image_transform_equals_jax(raw):
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(1).integers(0, 255, (30, 40, 3), np.uint8))
    got, want = TImageTransform(48, raw=raw)(img), JImageTransform(48, raw=raw)(img)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_lazy_crop_clamps_like_jax():
    """Negative and out-of-range boxes clamp alike for the image proxy and
    the mask crops (`base.py:84-102`), palette sources convert first."""
    from PIL import Image

    rng = np.random.default_rng(5)
    img = Image.fromarray(rng.integers(0, 255, (30, 40, 3), np.uint8)).convert(
        "P", palette=Image.ADAPTIVE)
    mask = rng.integers(0, 2, (30, 40)).astype(np.uint8)
    for box in [(-3, 2, 7, 12), (-5, -2, 8, 9), (30, 25, 99, 99), (3, 5, 33, 30)]:
        got = TB.EpisodicDataset._crop_img(img, *box)
        want = JB.EpisodicDataset._crop_img(img, *box)
        assert got.size == want.size
        np.testing.assert_array_equal(np.asarray(got.convert("RGB")),
                                      np.asarray(want.convert("RGB")))
    for xywh in [(-3, 2, 10, 10), (5, -4, 8, 9)]:
        np.testing.assert_array_equal(t_crop_xywh(mask, xywh), j_crop_xywh(mask, xywh))
    for xyxy in [(-5, -2, 8, 9), (10, 3, 60, 50)]:
        np.testing.assert_array_equal(t_crop_xyxy(mask, xyxy), j_crop_xyxy(mask, xyxy))
