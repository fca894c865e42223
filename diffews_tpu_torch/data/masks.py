"""Mask codecs: COCO RLE and polygon rasterization.

Replaces the external native dependencies the reference leans on for
LVIS/PACO/Pascal-Part (`pycocotools.mask.decode`,
detectron2 `polygons_to_bitmask` — `evaluation_util/data/lvis.py:97-116`,
`paco_part.py:105-124`, `pascal_part.py:125-128`):

  - `rle_decode` handles both compressed (char-codec) and uncompressed
    COCO RLEs, column-major run order;
  - `rle_encode` produces the compressed form (round-trip tested);
  - `polygons_to_bitmask` rasterizes COCO polygon lists (boundary-inclusive
    fill, matching pycocotools' convention of including outline pixels).

Each function dispatches to the native C++ codec
(`diffews_tpu_torch/native/maskcodec.cc`, loaded via ctypes, built lazily) when
available and falls back to pure NumPy implementations that are
BIT-IDENTICAL to the native path — including polygon rasterization, which
both implement via the COCO upsample-x5 crossing-parity convention — so
LVIS/PACO/Pascal-Part masks and metrics reproduce exactly between hosts
with and without a C++ toolchain.  Set ``DIFFEWS_TPU_NATIVE=0`` to force
the fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Union

import numpy as np

from diffews_tpu_torch import native as _native


# ---------------------------------------------------------------------------
# COCO compressed RLE char codec
# ---------------------------------------------------------------------------


def _decode_counts_array(s: Union[bytes, str]):
    """Native char-codec decode -> int64 array, or None if unavailable."""
    if isinstance(s, str):
        s = s.encode("ascii")
    lib = _native.load()
    if lib is None:
        return None
    out = np.empty(max(len(s), 1), dtype=np.int64)
    n = lib.rle_decode_counts(
        s, len(s), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.size)
    return out[:n] if n >= 0 else None


def _encode_counts_array(counts: np.ndarray) -> Union[bytes, None]:
    """Native char-codec encode from an int64 array, or None."""
    lib = _native.load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(counts, dtype=np.int64)
    buf = ctypes.create_string_buffer(13 * max(arr.size, 1))
    n = lib.rle_encode_counts(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), arr.size,
        buf, len(buf))
    return buf.raw[:n] if n >= 0 else None


def _decode_counts(s: Union[bytes, str]) -> List[int]:
    """Decode the COCO compressed-RLE count string (5-bit varint, delta>2)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    arr = _decode_counts_array(s)
    if arr is not None:
        return arr.tolist()
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts(counts: Sequence[int]) -> bytes:
    enc = _encode_counts_array(np.asarray(counts, dtype=np.int64))
    if enc is not None:
        return enc
    out = bytearray()
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def rle_decode(rle: Dict) -> np.ndarray:
    """COCO RLE dict {'size': [h, w], 'counts': bytes|str|list} -> (h, w) uint8.

    Runs alternate background/foreground in column-major (Fortran) order,
    matching `pycocotools.mask.decode`.
    """
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        arr = _decode_counts_array(counts)
        counts = _decode_counts(counts) if arr is None else arr
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    lib = _native.load()
    if lib is not None:
        out = np.empty((h, w), dtype=np.uint8)
        lib.rle_expand(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.size, h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
    return _rle_expand_py(counts, h, w)


def _rle_expand_py(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Expand column-major run counts to a row-major (h, w) uint8 mask."""
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < h * w:
        flat = np.pad(flat, (0, h * w - flat.size))
    return flat[: h * w].reshape(w, h).T


def rle_encode(mask: np.ndarray) -> Dict:
    """(h, w) binary mask -> compressed COCO RLE dict."""
    h, w = mask.shape
    lib = _native.load()
    if lib is not None:
        m = np.ascontiguousarray(mask, dtype=np.uint8)
        out = np.empty(h * w + 1, dtype=np.int64)
        n = lib.rle_from_mask(
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), out.size)
        if n >= 0:
            enc = _encode_counts_array(out[:n])
            if enc is not None:
                return {"size": [h, w], "counts": enc}
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)
    # run-length encode with leading zero-run
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": _encode_counts(counts)}


# ---------------------------------------------------------------------------
# polygons
# ---------------------------------------------------------------------------


def _poly_to_counts_py(pts: np.ndarray, h: int, w: int) -> np.ndarray:
    """One polygon ((k, 2) float64 points) -> column-major run counts, via
    the COCO crossing-parity convention (upsample x5 + round, walk every
    lattice point of every edge, column-boundary crossings, fill by
    parity).  Line-for-line NumPy port of `maskcodec.cc::poly_to_counts`;
    bit-identical output (both compute in float64)."""
    k = pts.shape[0]
    if k < 3:
        return np.asarray([h * w], np.int64)
    scale = 5.0
    x = np.floor(scale * pts[:, 0] + 0.5).astype(np.int64)
    y = np.floor(scale * pts[:, 1] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    # every lattice point along every (upsampled) edge, in edge order
    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ye - ys)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = 0.0 if dx == 0 else (ye - ys) / dx
            d = np.arange(dx + 1, dtype=np.int64)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.floor(ys + s * t + 0.5).astype(np.int64))
        else:
            s = 0.0 if dy == 0 else (xe - xs) / dy
            d = np.arange(dy + 1, dtype=np.int64)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.floor(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # column-boundary crossings, downsampled to pixel resolution
    j = np.nonzero(u[1:] != u[:-1])[0] + 1
    uj, ujm = u[j], u[j - 1]
    xd = np.where(uj < ujm, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    ok = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.minimum(v[j], v[j - 1]).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0.0, float(h)))
    cx = xd[ok].astype(np.int64)
    cy = yd[ok].astype(np.int64)

    # crossings -> run counts by parity, in column-major flat order
    a = np.sort(np.concatenate([cx * h + cy, [h * w]]))
    d = np.diff(np.concatenate([[np.int64(0)], a]))
    # zero-length runs mean two crossings coincide: the parity flips cancel,
    # so the NEXT run extends the PREVIOUS one instead of starting a new one
    counts = [int(d[0])]
    i = 1
    while i < len(d):
        if d[i] > 0:
            counts.append(int(d[i]))
            i += 1
        else:
            i += 1
            if i < len(d):
                counts[-1] += int(d[i])
                i += 1
    return np.asarray(counts, np.int64)


def polygons_to_bitmask(polygons: Sequence[np.ndarray], height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygon list ([x0,y0,x1,y1,...] flat arrays) to a mask.

    Union of filled polygons via the COCO crossing-parity convention
    (outline pixels included); native and NumPy paths are bit-identical.
    """
    if len(polygons) == 0 or height <= 0 or width <= 0:
        return np.zeros((max(height, 0), max(width, 0)), dtype=bool)
    lib = _native.load()
    if lib is not None:
        flats = [np.ascontiguousarray(np.asarray(p, np.float64).reshape(-1))
                 for p in polygons]
        xy = (np.concatenate(flats) if flats
              else np.zeros((0,), np.float64))
        lens = np.asarray([f.size // 2 for f in flats], dtype=np.int64)
        out = np.empty((height, width), dtype=np.uint8)
        lib.polys_to_mask(
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens.size, height, width,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.astype(bool)
    out = np.zeros((height, width), dtype=bool)
    for p in polygons:
        pts = np.asarray(p, dtype=np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        counts = _poly_to_counts_py(pts, height, width)
        out |= _rle_expand_py(counts, height, width).astype(bool)
    return out


def segmentation_to_mask(segm, height: int, width: int) -> np.ndarray:
    """Polymorphic segmentation -> bool mask (list=polygons, dict=RLE, ndarray=mask),
    mirroring the reference's `get_mask` dispatch (`lvis.py:97-116`)."""
    if isinstance(segm, list):
        return polygons_to_bitmask([np.asarray(p) for p in segm], height, width)
    if isinstance(segm, dict):
        return rle_decode(segm).astype(bool)
    if isinstance(segm, np.ndarray):
        assert segm.ndim == 2
        return segm.astype(bool)
    raise NotImplementedError(type(segm))


def merge_rles_decode(rles: Sequence[Dict]) -> np.ndarray:
    """Decode a list of RLEs and union them (pycocotools decode of a list
    stacks along the last axis; callers then `.sum(-1) > 0`)."""
    out = None
    for r in rles:
        m = rle_decode(r).astype(bool)
        out = m if out is None else (out | m)
    return out if out is not None else np.zeros((0, 0), bool)
