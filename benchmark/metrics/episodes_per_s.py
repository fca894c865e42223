"""Episodes whose masks reached the host inside the window, over the window."""

from benchmark import readers


def read(run):
    return readers.items_per_s(run)
