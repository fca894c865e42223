"""Host ms of one predict_cached_async call, mean over the window."""

from benchmark import readers


def read(run):
    return readers.enqueue_ms(run)
