"""Image utilities of the depth head (port of `diffews_tpu/utils/image.py`).

`colorize_depth_maps` maps depth through matplotlib's "Spectral" colormap.
The port does not import matplotlib: it carries the colormap itself, as
matplotlib builds it.  The 11 control points are `matplotlib._cm.
_Spectral_data` (ColorBrewer's Spectral); `LinearSegmentedColormap.
from_list` spaces them evenly over [0, 1] and samples them into a 256-entry
float64 lookup table (`colors._create_lookup_table`); `Colormap.__call__`
looks a float up as `x * N` (in the input's dtype), maps `N` to `N - 1`
and truncates, and gives NaN the "bad" colour (0, 0, 0).
"""

from __future__ import annotations

import functools

import numpy as np

_SPECTRAL = (
    (0.6196078431372549, 0.00392156862745098, 0.25882352941176473),
    (0.8352941176470589, 0.24313725490196078, 0.30980392156862746),
    (0.9568627450980393, 0.42745098039215684, 0.2627450980392157),
    (0.9921568627450981, 0.6823529411764706, 0.3803921568627451),
    (0.996078431372549, 0.8784313725490196, 0.5450980392156862),
    (1.0, 1.0, 0.7490196078431373),
    (0.9019607843137255, 0.9607843137254902, 0.596078431372549),
    (0.6705882352941176, 0.8666666666666667, 0.6431372549019608),
    (0.4, 0.7607843137254902, 0.6470588235294118),
    (0.19607843137254902, 0.5333333333333333, 0.7411764705882353),
    (0.3686274509803922, 0.30980392156862746, 0.6352941176470588),
)
_LUT_SIZE = 256


@functools.lru_cache()
def _lookup_table() -> np.ndarray:
    """(N, 3) float64 RGB table of the Spectral colours, evenly spaced."""
    pts = np.asarray(_SPECTRAL, dtype=np.float64)
    n = _LUT_SIZE
    x = np.linspace(0, 1, len(pts)) * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.empty((n, 3), np.float64)
    for c in range(3):
        y = pts[:, c]
        lut[:, c] = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1],
                                    [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _apply_colormap(x: np.ndarray) -> np.ndarray:
    """RGB float64 Spectral colours of the floats `x` in [0, 1] (or NaN)."""
    lut = _lookup_table()
    n = lut.shape[0]
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    under, over = xa < 0, xa >= n
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over] = 0, n - 1
    rgb = lut.take(idx, axis=0, mode="clip")
    rgb[bad] = 0.0
    return rgb


def norm_to_rgb(norm: np.ndarray) -> np.ndarray:
    """(3, H, W) surface normals in [-1, 1] -> uint8 RGB."""
    return ((norm + 1.0) * 0.5 * 255).clip(0, 255).astype(np.uint8)


def chw2hwc(chw: np.ndarray) -> np.ndarray:
    assert chw.ndim == 3
    return np.transpose(chw, (1, 2, 0))


def colorize_depth_maps(depth_map, min_depth: float, max_depth: float,
                        cmap: str = "Spectral", valid_mask=None) -> np.ndarray:
    """Depth (H, W) or (B, H, W) -> colourised (B, 3, H, W) in [0, 1].
    The port carries the "Spectral" colormap only."""
    if cmap != "Spectral":
        raise ValueError(f"colormap {cmap!r} is not carried by the port (only 'Spectral')")
    depth = np.asarray(depth_map, dtype=np.float32)
    if depth.ndim == 2:
        depth = depth[None]
    depth = depth.squeeze() if depth.ndim == 4 else depth
    if depth.ndim == 2:
        depth = depth[None]
    depth = (depth - min_depth) / max(max_depth - min_depth, 1e-8)
    img = _apply_colormap(depth.clip(0, 1))  # (B, H, W, 3)
    if valid_mask is not None:
        vm = np.asarray(valid_mask).squeeze()
        if vm.ndim == 2:
            vm = vm[None]
        img[~vm] = 0
    return np.transpose(img, (0, 3, 1, 2))
