"""Inference micro-batch sizing (port of `diffews_tpu/utils/batchsize.py`).

Counterpart of `marigold/util/batchsize.py:9-62`, a memory-keyed lookup for
ensemble micro-batches, with the JAX package's table.  The memory is the
CUDA device's (`torch.cuda.get_device_properties(device).total_memory`),
or `hbm_gib` when given.  Where neither is known the port raises: it does
not assume a size (JAX's falls back to 16 GiB).
"""

from __future__ import annotations

import torch

# {memory_gib_floor: {resolution_ceiling: {bf16: bs, f32: bs}}}
_BS_TABLE = {
    32: {512: {True: 48, False: 24}, 768: {True: 20, False: 10}},
    16: {512: {True: 16, False: 8}, 768: {True: 6, False: 3}},
    8: {512: {True: 8, False: 4}, 768: {True: 3, False: 1}},
}


def device_memory_gib(device=None) -> float:
    """Total memory of a CUDA device (default: the current one), in GiB."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"find_batch_size: no CUDA device memory to read on {device}; pass hbm_gib")
    return torch.cuda.get_device_properties(device).total_memory / (1 << 30)


def find_batch_size(ensemble_size: int, input_res: int, bf16: bool = True,
                    hbm_gib: float | None = None, device=None) -> int:
    """Largest safe episode micro-batch for the device, capped at the work."""
    if hbm_gib is None:
        hbm_gib = device_memory_gib(device)
    for floor in sorted(_BS_TABLE, reverse=True):
        if hbm_gib >= floor:
            table = _BS_TABLE[floor]
            break
    else:
        return 1
    for res_ceiling in sorted(table):
        if input_res <= res_ceiling:
            bs = table[res_ceiling][bf16]
            break
    else:
        bs = 1
    return max(1, min(bs, ensemble_size))
