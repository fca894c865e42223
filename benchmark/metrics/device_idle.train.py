"""Share of the traced stretch in which no device op ran, %."""

from benchmark import readers


def read(run):
    return readers.device_idle_pct(run)
