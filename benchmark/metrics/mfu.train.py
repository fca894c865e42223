"""The step's model products (forward and backward, remat's recompute left out) at the card's peak times the window's step rate, % of the peak."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run)
