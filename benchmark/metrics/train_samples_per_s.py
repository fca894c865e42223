"""Training episodes of every optimizer step finished in the window, over the window, timed to the device's end."""

from benchmark import readers


def read(run):
    return readers.items_per_s(run)
