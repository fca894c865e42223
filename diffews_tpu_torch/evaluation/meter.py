"""Metric accumulation and run logging.

Counterparts of `AverageMeter`/`Logger`
(`evaluation_util/common/logger.py:11-119`): per-class fg/bg
intersection/union buffers, fold-restricted mIoU (x100) and FB-IoU, a
timestamped `_TEST_{benchmark}_{time}` log directory mirrored to console.

The port logs under `LOGGER_NAME` ("diffews_tpu_torch"), not the JAX
package's "diffews_tpu": each `EvalLogger.initialize` clears its logger's
handlers, so one shared name would make two harnesses in one process write
into each other's `log.txt`.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Sequence

import numpy as np

LOGGER_NAME = "diffews_tpu_torch"

NCLASS = {
    "pascal": 20,
    "coco": 80,
    "fss": 1000,
    "paco_part": 448,
    "pascal_part": 100,
    "lvis": 1203,
    "pascal_cd": 20,
}


class AverageMeter:
    """Accumulates per-class intersection/union over episodes."""

    def __init__(self, benchmark: str, class_ids: Sequence[int], nclass: Optional[int] = None):
        self.benchmark = benchmark
        self.class_ids_interest = np.asarray(list(class_ids), dtype=np.int64)
        n = nclass if nclass is not None else NCLASS[benchmark]
        self.intersection_buf = np.zeros((2, n), dtype=np.float64)
        self.union_buf = np.zeros((2, n), dtype=np.float64)
        self.loss_buf: list[float] = []

    def update(self, inter_b: np.ndarray, union_b: np.ndarray, class_id, loss=None):
        """inter_b/union_b: (2, B); class_id: (B,) int."""
        class_id = np.atleast_1d(np.asarray(class_id, dtype=np.int64))
        np.add.at(self.intersection_buf.T, class_id, np.asarray(inter_b).T)
        np.add.at(self.union_buf.T, class_id, np.asarray(union_b).T)
        self.loss_buf.append(0.0 if loss is None else float(loss))

    def compute_iou(self):
        iou = self.intersection_buf / np.maximum(self.union_buf, 1.0)
        iou_sel = iou[:, self.class_ids_interest]
        miou = float(iou_sel[1].mean() * 100)
        inter_sel = self.intersection_buf[:, self.class_ids_interest].sum(axis=1)
        union_sel = self.union_buf[:, self.class_ids_interest].sum(axis=1)
        fb_iou = float((inter_sel / np.maximum(union_sel, 1e-12)).mean() * 100)
        return miou, fb_iou, iou_sel[1][: min(len(iou_sel[1]), 20)]

    def write_process(self, batch_idx: int, datalen: int, epoch: int = -1,
                      write_batch_idx: int = 50):
        if batch_idx % write_batch_idx == 0:
            miou, fb_iou, _ = self.compute_iou()
            msg = "" if epoch == -1 else f"[Epoch: {epoch:02d}] "
            msg += f"[Batch: {batch_idx+1:04d}/{datalen:04d}] "
            msg += f"mIoU: {miou:5.2f}  |  FB-IoU: {fb_iou:5.2f}"
            EvalLogger.info(msg)

    def write_result(self, split: str, epoch: int = 0):
        miou, fb_iou, cats_iou = self.compute_iou()
        loss = np.mean(self.loss_buf) if self.loss_buf else 0.0
        msg = f"\n*** {split} [@Epoch {epoch:02d}] Avg L: {loss:6.5f}  "
        msg += f"mIoU: {miou:5.2f}   FB-IoU: {fb_iou:5.2f}   ***\n"
        EvalLogger.info(msg)
        return miou, fb_iou


class EvalLogger:
    """Timestamped eval log dir + file/console logging."""

    logpath: Optional[str] = None

    @classmethod
    def initialize(cls, args=None, root: str = "logs", benchmark: str = "coco"):
        stamp = datetime.datetime.now().strftime("%m%d_%H%M%S")
        cls.logpath = os.path.join(root, f"_TEST_{benchmark}_{stamp}.log")
        os.makedirs(cls.logpath, exist_ok=True)

        logger = logging.getLogger(LOGGER_NAME)
        logger.setLevel(logging.INFO)
        logger.handlers.clear()
        fh = logging.FileHandler(os.path.join(cls.logpath, "log.txt"), mode="w")
        fh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(sh)

        if args is not None:
            logger.info("\n:=========== DiffewS-TPU few-shot seg ===========")
            for k, v in sorted(vars(args).items()):
                logger.info("| %20s: %-24s" % (k, str(v)))
            logger.info(":================================================\n")

    @classmethod
    def info(cls, msg: str):
        logging.getLogger(LOGGER_NAME).info(msg)
