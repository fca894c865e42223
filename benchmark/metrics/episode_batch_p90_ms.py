"""90th percentile of a batch's time from its queueing call to its result on the host, over every batch of the window."""

from benchmark import readers


def read(run):
    return readers.latency_percentile_ms(run, 90)
