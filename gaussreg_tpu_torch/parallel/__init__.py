"""Data parallelism over torch.distributed (port of gaussreg_tpu/parallel/)."""
