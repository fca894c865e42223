"""Flash attention forward of the query stream against the cached support K/V: least time over device time, %."""

from benchmark import readers


def read(run):
    return readers.attention_roofline(run)
