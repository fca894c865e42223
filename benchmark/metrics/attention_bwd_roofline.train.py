"""Flash attention backward (dQ, dK-dV and split-sum kernels): the step's differentiated attention sites' least time over their device time, %."""

from benchmark import readers


def read(run):
    return readers.attention_bwd_roofline(run)
