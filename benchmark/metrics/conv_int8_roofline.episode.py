"""int8 3x3 convolution kernel: the batch's int8 conv sites' least time over its device time, %."""

from benchmark import readers


def read(run):
    return readers.conv_int8_roofline(run)
