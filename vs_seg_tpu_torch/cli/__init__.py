"""Command-line entry points of the port (`python -m vs_seg_tpu_torch.cli.
inference ...`)."""
