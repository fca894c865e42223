"""Host ms of one call of the training step (the host's dispatch of an optimizer step), mean over the window."""

from benchmark import readers


def read(run):
    return readers.enqueue_ms(run)
