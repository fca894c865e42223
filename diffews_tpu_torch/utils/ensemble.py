"""Affine-invariant depth ensembling (a copy of `diffews_tpu/utils/ensemble.py`).

Counterpart of `marigold/util/ensemble.py:24-116` (depth mode only; the seg
path ensembles by plain mean — pipeline `:468`): per-member scale/shift are
optimized to minimize pairwise inter-member distance (scipy BFGS), then the
aligned stack is reduced by mean/median with an uncertainty map.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def inter_distances(t: np.ndarray) -> np.ndarray:
    dists = []
    n = t.shape[0]
    for i in range(n):
        for j in range(i + 1, n):
            dists.append(t[i] - t[j])
    return np.stack(dists)


def ensemble_depths(
    input_images: np.ndarray,  # (E, H, W) affine-invariant depth members
    regularizer_strength: float = 0.02,
    max_iter: int = 2,
    tol: float = 1e-3,
    reduction: str = "median",
    max_res: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """Align ensemble members by per-member (scale, shift), reduce, and
    return (depth (H,W) in [0,1], uncertainty (H,W))."""
    from scipy.optimize import minimize

    imgs = np.asarray(input_images, dtype=np.float64)
    e = imgs.shape[0]
    original_input = imgs.copy()

    # init: normalize each member to [0,1]
    mins = imgs.reshape(e, -1).min(axis=1)
    maxs = imgs.reshape(e, -1).max(axis=1)
    s_init = 1.0 / np.maximum(maxs - mins, 1e-8)
    t_init = -s_init * mins
    x0 = np.concatenate([s_init, t_init])

    # optional downscale for the objective
    obj_imgs = imgs
    h, w = imgs.shape[1:]
    if max(h, w) > max_res:
        step = int(np.ceil(max(h, w) / max_res))
        obj_imgs = imgs[:, ::step, ::step]

    def objective(x):
        s, t = x[:e], x[e:]
        aligned = obj_imgs * s[:, None, None] + t[:, None, None]
        dists = inter_distances(aligned)
        sqrt_dist = np.sqrt(np.mean(dists**2))
        # regularize the ensemble toward the [0,1] range
        near = np.sqrt(np.mean((aligned.min() - 0) ** 2 + (aligned.max() - 1) ** 2))
        return sqrt_dist + near * regularizer_strength

    res = minimize(objective, x0, method="BFGS",
                   options={"maxiter": max_iter, "gtol": tol})
    s, t = res.x[:e], res.x[e:]
    aligned = original_input * s[:, None, None] + t[:, None, None]

    if reduction == "mean":
        depth = aligned.mean(axis=0)
        uncertainty = aligned.std(axis=0)
    elif reduction == "median":
        depth = np.median(aligned, axis=0)
        uncertainty = np.median(np.abs(aligned - depth[None]), axis=0)
    else:
        raise ValueError(reduction)

    dmin, dmax = depth.min(), depth.max()
    depth = (depth - dmin) / max(dmax - dmin, 1e-8)
    return depth.astype(np.float32), uncertainty.astype(np.float32)
