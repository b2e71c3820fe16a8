"""Data parallelism over `torch.distributed` (port of `leod_tpu/parallel/`)."""
