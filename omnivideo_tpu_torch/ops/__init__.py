"""Ops of the port: norms, rope, attention and the two CUDA kernels
(qk_prep, flash_attention) with their plain PyTorch twins."""
