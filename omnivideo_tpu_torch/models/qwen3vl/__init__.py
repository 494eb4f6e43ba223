"""Qwen3-VL (vision tower + MoE text decoder) in PyTorch: the x2x
pipeline's conditioning stage."""
