"""Device ms per batch of the ops launched inside the pipeline's VAE calls (encode and decode), traced stretch."""

from benchmark import readers


def read(run):
    return readers.range_device_ms(run, "bench.vae")
