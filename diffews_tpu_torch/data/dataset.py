"""Benchmark registry / loader factory.

Counterpart of `FSSDataset` (`evaluation_util/data/dataset.py:15-49`):
7 episodic benchmarks behind one `initialize` + `build_dataloader` API with
the shared 512px transform; shuffle only for 'trn', no workers for eval
(seeded-episode reproducibility).
"""

from __future__ import annotations

from diffews_tpu_torch.data.coco import DatasetCOCO
from diffews_tpu_torch.data.fss import DatasetFSS
from diffews_tpu_torch.data.loader import EpisodeLoader
from diffews_tpu_torch.data.lvis import DatasetLVIS
from diffews_tpu_torch.data.paco_part import DatasetPACOPart
from diffews_tpu_torch.data.pascal import DatasetPASCAL, DatasetPASCALCD
from diffews_tpu_torch.data.pascal_part import DatasetPASCALPart
from diffews_tpu_torch.data.transforms import ImageTransform


class FSSDataset:
    datasets = {
        "coco": DatasetCOCO,
        "pascal": DatasetPASCAL,
        "fss": DatasetFSS,
        "paco_part": DatasetPACOPart,
        "pascal_part": DatasetPASCALPart,
        "lvis": DatasetLVIS,
        "pascal_cd": DatasetPASCALCD,
    }

    @classmethod
    def initialize(cls, img_size: int, datapath: str, use_original_imgsize: bool = False,
                   raw_images: bool = False):
        """raw_images=True keeps episode images as resized uint8 HWC; the
        pipeline normalizes in-graph (same arithmetic, ~8x smaller h2d)."""
        cls.img_size = img_size
        cls.datapath = datapath
        cls.use_original_imgsize = use_original_imgsize
        cls.transform = ImageTransform(img_size, raw=raw_images)

    @classmethod
    def build_dataset(cls, benchmark: str, fold: int, split: str, shot: int = 1):
        return cls.datasets[benchmark](
            cls.datapath, fold=fold, transform=cls.transform, split=split,
            shot=shot, use_original_imgsize=cls.use_original_imgsize,
        )

    @classmethod
    def build_dataloader(cls, benchmark: str, bsz: int, nworker: int, fold: int,
                         split: str, shot: int = 1,
                         batch_seed=None) -> EpisodeLoader:
        shuffle = split == "trn"
        # The reference forces nworker=0 for eval to keep the seeded episode
        # sequence reproducible (`dataset.py:46-47`).  Our threaded loader is
        # a SINGLE in-order producer, so prefetch preserves the exact RNG
        # consumption order — eval can overlap host IO with device compute.
        # `batch_seed` (training) switches sampling to the counter-keyed
        # private-RNG stream: deterministic, exactly resumable
        # (`EpisodeLoader.set_position`), isolated from global-RNG consumers.
        dataset = cls.build_dataset(benchmark, fold, split, shot)
        return EpisodeLoader(dataset, batch_size=bsz, shuffle=shuffle,
                             num_workers=nworker, batch_seed=batch_seed)
