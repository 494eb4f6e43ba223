"""Sequence parallelism on torch.distributed (port of omnivideo_tpu/parallel)."""
