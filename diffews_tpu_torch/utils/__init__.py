"""Helpers shared by the port's modules."""

import torch


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device` without waiting for the device: a CUDA copy
    from pageable memory waits for the work queued on the stream (every
    upload would be a synchronisation point, defeating dispatch-ahead); a
    copy from pinned memory does not.  A broadcast view (stride 0, as the
    daemon's `np.broadcast_to` supports) is made dense first: pinning
    refuses overlapping memory."""
    if device.type == "cuda":
        t = t.contiguous().pin_memory()
    return t.to(device, non_blocking=True)
