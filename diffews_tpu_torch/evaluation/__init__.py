"""Scoring of the port's eval harness: per-episode IoU, the fold-restricted
mIoU / FB-IoU meter, the run log and the optional strips.  A copy of
`diffews_tpu/evaluation/` that logs under its own logger name."""

from diffews_tpu_torch.evaluation.evaluator import Evaluator  # noqa: F401
from diffews_tpu_torch.evaluation.meter import AverageMeter, EvalLogger  # noqa: F401
