"""Flash attention forward: the batch's attention sites' least time over the flash kernels' device time, %."""

from benchmark import readers


def read(run):
    return readers.attention_roofline(run)
