"""Command-line entry points of the port (`python -m diffews_tpu_torch.cli.<name>`)."""
