"""Episodic data layer of the port: the seven benchmarks behind `FSSDataset`.

A copy of `diffews_tpu/data/` (the port imports nothing of the JAX package):
NumPy/PIL host code that draws episodes from the global NumPy RNG in the
reference's call order (eval) or from a counter-keyed private RNG
(training, `EpisodeLoader(batch_seed=...)`), and hands host arrays to the
pipeline.
"""

from diffews_tpu_torch.data.dataset import FSSDataset  # noqa: F401
