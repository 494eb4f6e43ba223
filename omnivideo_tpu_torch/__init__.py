"""PyTorch + CUDA port of omnivideo_tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference `omnivideo_tpu/`, mirroring its
tree (configs/, ops/, models/, schedulers/, pipelines/, training/, utils/,
tools/). It imports torch and numpy only — never jax, never omnivideo_tpu.
The TPU Pallas kernels on the ported paths (generate, the Qwen3-VL stage,
training) are hand-written CUDA C++ kernels under `csrc/`, built with
nvcc on first use (ops/_kernels.py); each has a plain PyTorch twin that the
wrapper takes for CPU tensors only.

Entry points default to device="cuda" and raise when no CUDA device is
present, unless the caller asks for device="cpu" (as the CPU tests do).
"""

from .configs import T2V_1_3B, PipelineConfig, VAEConfig, WanDiTConfig
from .device import resolve_device

__all__ = ["T2V_1_3B", "PipelineConfig", "VAEConfig", "WanDiTConfig",
           "resolve_device"]
