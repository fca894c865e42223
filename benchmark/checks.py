"""The comparison that decides `correct`: the program's outputs of a
sample of the window's batches against the reference's, on the same
inputs and weights, once the program is gone.

Numbers (those named in `benchmark/workloads/<cell>.json` are compared
with their limits there; the others are reported by `control.py`):
  seg_mae          mean |program − reference| of the uint8 segmentation
                   images, in counts;
  seg_far_share    share of uint8 values more than 8 counts apart;
  mask_mismatch    share of mask pixels on which the program's mask and
                   the reference's (from its own image) disagree;
  mask_threshold_mismatch  share of pixels on which the program's mask is
                   not the protocol's relative threshold of the program's
                   own image (exact: the threshold is a fixed float32
                   formula of a uint8 image).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generator, weights as weights_lib
from benchmark.reference import episode as ref_lib

FAR = 8
NUMBERS = ("seg_mae", "seg_far_share", "mask_mismatch", "mask_threshold_mismatch")


def numbers(seg: np.ndarray, mask: np.ndarray, ref_seg: np.ndarray, ref_mask: np.ndarray,
            r_threshold: float) -> dict:
    d = np.abs(seg.astype(np.int32) - ref_seg.astype(np.int32))
    return {"seg_mae": float(d.mean()), "seg_far_share": float((d > FAR).mean()),
            "mask_mismatch": float((mask != ref_mask).mean()),
            "mask_threshold_mismatch": float(
                (mask != ref_lib.threshold_mask(seg, r_threshold)).mean())}


def reference(cfg: dict, seed: int, device, bits: int = 8) -> ref_lib.Reference:
    ref_lib.plain_float32()
    wts = weights_lib.as_float32(weights_lib.make(cfg, seed, device))
    return ref_lib.Reference(cfg, wts, device, bits=bits)


def reference_outputs(ref: ref_lib.Reference, traffic: dict, inputs: dict, indices, device,
                      reference=None):
    """{batch index: (seg, mask)} as numpy, computed by `ref` through the
    kind's `reference` (the traffic's kind's if None)."""
    from benchmark import kinds

    pool, dev = inputs["batches"], torch.device(device)
    reference = reference or kinds.load(traffic["mode"]).reference
    seg_of = reference(ref, traffic, inputs, lambda a: generator.as_tensor(a, dev))
    out = {}
    for i in indices:
        seg = seg_of(pool[i % len(pool)]).cpu().numpy()
        out[i] = (seg, ref_lib.threshold_mask(seg, traffic["r_threshold"]))
    return out


def pooled(pairs, r_threshold: float) -> dict:
    """The numbers over every compared batch together."""
    seg = np.concatenate([p[0] for p in pairs])
    mask = np.concatenate([p[1] for p in pairs])
    rseg = np.concatenate([p[2] for p in pairs])
    rmask = np.concatenate([p[3] for p in pairs])
    return numbers(seg, mask, rseg, rmask, r_threshold)


def compare(cfg: dict, traffic: dict, seed: int, inputs: dict, produced: dict, device,
            reference_fn=None) -> dict:
    """The numbers of the program's `produced` {batch index: SegOutput};
    `reference_fn`: the kind's `reference`."""
    if not produced:
        return {}
    ref = reference(cfg, seed, device)
    want = reference_outputs(ref, traffic, inputs, sorted(produced), device, reference_fn)
    return pooled([(produced[i].seg_colored, produced[i].mask) + want[i] for i in sorted(produced)],
                  traffic["r_threshold"])


def within(nums: dict, limits: dict) -> bool:
    return all(k in nums and np.isfinite(nums[k]) and nums[k] <= lim for k, lim in limits.items())
