"""Multi-device runs over `torch.distributed` (port of `diffews_tpu/parallel`)."""
