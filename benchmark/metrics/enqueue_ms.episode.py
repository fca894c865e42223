"""Host ms of one predict_async call (queueing a batch), mean over the window."""

from benchmark import readers


def read(run):
    return readers.enqueue_ms(run)
