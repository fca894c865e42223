"""GroupNorm+SiLU kernels: the batch's sites' least time (bytes) over the stats, apply and partial-sum kernels' device time, %."""

from benchmark import readers


def read(run):
    return readers.groupnorm_roofline(run)
