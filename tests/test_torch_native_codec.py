"""Port parity of the mask codec: `diffews_tpu_torch.native` +
`diffews_tpu_torch.data.masks` against `diffews_tpu.native` +
`diffews_tpu.data.masks`.

Compressed-RLE bytes, decoded masks and rasterized polygons are equal
between the two packages, on the native C++ path and on the NumPy/PIL
fallback (`DIFFEWS_TPU_NATIVE=0`), and the port's native and fallback paths
equal each other.  The port builds its library under `build/native/`, not
next to its source.  Mirrors `tests/test_native_codec.py`.
"""

import numpy as np
import pytest

from diffews_tpu import native as j_native
from diffews_tpu.data import masks as JM
from diffews_tpu_torch import native as t_native
from diffews_tpu_torch.data import masks as TM
from helpers.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    """Run the test body on the native codec (both packages' libraries
    built) or on the pure-NumPy fallback."""
    if request.param == "native":
        monkeypatch.setenv("DIFFEWS_TPU_NATIVE", "1")
        if t_native.load() is None or j_native.load() is None:
            pytest.skip("no C++ compiler: the native codec is unavailable")
    else:
        monkeypatch.setenv("DIFFEWS_TPU_NATIVE", "0")
    return request.param


def _random_mask(rng, h, w):
    base = rng.random((h // 4 + 1, w // 4 + 1))
    up = np.kron(base, np.ones((4, 4)))[:h, :w]
    return ((up > 0.6) | (rng.random((h, w)) > 0.995)).astype(np.uint8)


def _polygons(rng, trial):
    k = int(rng.integers(3, 13))
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rng.uniform(3, 80, k)
    cx, cy = rng.uniform(30, 170, 2)
    poly = [np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1).reshape(-1)]
    if trial % 3 == 0:
        poly.append(poly[0] + rng.uniform(-15, 15))
    return poly


def test_library_builds_outside_the_source_tree():
    lib = t_native.load()
    if lib is None:
        pytest.skip("no C++ compiler: the native codec is unavailable")
    assert t_native.BUILD_DIR.name == "native" and t_native.BUILD_DIR.parent.name == "build"
    assert list(t_native.BUILD_DIR.glob("maskcodec-*.so"))
    assert not list(t_native._SRC.parent.glob("*.so"))


def test_switch_off_returns_none(monkeypatch):
    monkeypatch.setenv("DIFFEWS_TPU_NATIVE", "0")
    assert t_native.load() is None


def test_rle_bytes_and_masks_equal_jax(path):
    rng = np.random.default_rng(0)
    for h, w in [(1, 1), (7, 3), (64, 64), (333, 217), (480, 640)]:
        m = _random_mask(rng, h, w)
        rle_t, rle_j = TM.rle_encode(m), JM.rle_encode(m)
        assert rle_t["counts"] == rle_j["counts"] and list(rle_t["size"]) == list(rle_j["size"])
        dec = TM.rle_decode(rle_j)
        np.testing.assert_array_equal(dec, JM.rle_decode(rle_j))
        np.testing.assert_array_equal(dec, m)
        # str counts and uncompressed list counts decode alike
        as_str = {"size": rle_j["size"], "counts": rle_j["counts"].decode("ascii")}
        np.testing.assert_array_equal(TM.rle_decode(as_str), m)


def test_counts_codec_equals_jax(path):
    counts = [100, 3, 1, 200, 4, 2, 1, 50]  # negative deltas: sign extension
    s = TM._encode_counts(counts)
    assert s == JM._encode_counts(counts)
    assert TM._decode_counts(s) == JM._decode_counts(s) == counts
    rle = {"size": [4, 3], "counts": [2, 5, 5]}
    np.testing.assert_array_equal(TM.rle_decode(rle), JM.rle_decode(rle))


def test_polygons_equal_jax(path):
    rng = np.random.default_rng(1)
    for trial in range(16):
        poly = _polygons(rng, trial)
        got = TM.polygons_to_bitmask(poly, 200, 200)
        assert got.sum() > 0
        np.testing.assert_array_equal(got, JM.polygons_to_bitmask(poly, 200, 200))
    for poly, h, w in [([np.array([1, 1, 1, 4, 4, 4, 4, 1], np.float64)], 6, 7),
                       ([np.array([2, 2, 3, 3], np.float64)], 5, 5),
                       ([np.array([-10, -10, -10, 30, 30, 30, 30, -10], np.float64)], 20, 20)]:
        np.testing.assert_array_equal(TM.polygons_to_bitmask(poly, h, w),
                                      JM.polygons_to_bitmask(poly, h, w))


def test_segmentation_dispatch_equals_jax(path):
    m = np.eye(8, dtype=np.uint8)
    for seg in ([[1.0, 1.0, 6.0, 1.0, 6.0, 6.0, 1.0, 6.0]], JM.rle_encode(m), m):
        np.testing.assert_array_equal(TM.segmentation_to_mask(seg, 8, 8),
                                      JM.segmentation_to_mask(seg, 8, 8))


def test_native_equals_fallback(monkeypatch):
    """The port's two paths give the same bytes and masks."""
    if t_native.load() is None:
        pytest.skip("no C++ compiler: the native codec is unavailable")
    rng = np.random.default_rng(2)
    m = _random_mask(rng, 97, 131)
    polys = [_polygons(rng, t) for t in range(4)]
    res = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("DIFFEWS_TPU_NATIVE", flag)
        rle = TM.rle_encode(m)
        res[flag] = (rle["counts"], TM.rle_decode(rle),
                     [TM.polygons_to_bitmask(p, 200, 200) for p in polys])
    assert res["1"][0] == res["0"][0]
    np.testing.assert_array_equal(res["1"][1], res["0"][1])
    for a, b in zip(res["1"][2], res["0"][2]):
        np.testing.assert_array_equal(a, b)
