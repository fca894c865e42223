"""The whole batch's model products at the card's peaks times the window's batch rate, % of the peak."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run)
