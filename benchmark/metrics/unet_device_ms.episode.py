"""Device ms per batch of the ops launched inside the pipeline's UNet call, traced stretch."""

from benchmark import readers


def read(run):
    return readers.range_device_ms(run, "bench.unet")
