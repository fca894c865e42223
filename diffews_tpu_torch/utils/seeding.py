"""Seed pinning (port of `diffews_tpu/utils/seeding.py`).

The eval protocol is defined by the global RNG state: the harness calls
this before it builds its data loaders (`main_oss.py:33-36`).  Episode
sampling uses Python's and the legacy NumPy global RNGs; torch's CPU and
CUDA generators are seeded too (`torch.manual_seed` seeds every device's).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def fix_randseed(seed: int | None) -> int:
    """Pin Python's, NumPy's and torch's global RNGs; a None seed is drawn
    from NumPy's.  Returns the seed."""
    if seed is None:
        seed = int(np.random.randint(0, 2**31))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
