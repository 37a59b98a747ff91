"""Runnable DMFT programs on edipack_tpu_torch (``python -m
edipack_tpu_torch.examples.<name>``)."""
