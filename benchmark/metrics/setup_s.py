"""Seconds from the process's start to the end of warm-up: imports, weights,
kernel loads, set-up the traffic needs, the warm batches."""


def read(run):
    return run.setup_s
