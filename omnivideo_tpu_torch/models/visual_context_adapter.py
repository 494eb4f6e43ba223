"""Visual context adapter: source-video VAE latents → conditioning tokens
(port of omnivideo_tpu/models/visual_context_adapter.py).

Conv3d patchify with stride == kernel (1, 4, 4) as a GEMM → non-affine layer
norm → Linear → non-affine layer norm. Parameters stay in the JAX package's
dict layout: {"patch_embedding": {"kernel": [in, out], "bias"},
"projection": {...}}.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..ops.norms import layer_norm
from .wan_dit import patchify


def kernel_dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x @ kernel + bias for a JAX-layout dense ({"kernel": [in, out],
    "bias"}), with JAX's dtype promotion and the bias added after."""
    w = p["kernel"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    return y + p["bias"].to(dt)


def init_vca(
    patch_size: Tuple[int, int, int] = (1, 4, 4),
    in_channels: int = 16,
    hidden_dim: int = 2048,
    out_dim: int = 4096,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Xavier-uniform kernels, zero biases (f32)."""
    in_patch = in_channels * int(math.prod(patch_size))

    def xavier(fan_in, fan_out):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(fan_in, fan_out, device=device).uniform_(-a, a, generator=generator)

    return {
        "patch_embedding": {"kernel": xavier(in_patch, hidden_dim),
                            "bias": torch.zeros(hidden_dim, device=device)},
        "projection": {"kernel": xavier(hidden_dim, out_dim),
                       "bias": torch.zeros(out_dim, device=device)},
    }


def vca_apply(params, x: torch.Tensor, patch_size: Tuple[int, int, int] = (1, 4, 4),
              eps: float = 1e-6) -> torch.Tensor:
    """x: [B, C, F, H, W] (or [C, F, H, W]) latents → [B, N, out_dim] tokens."""
    if x.ndim == 4:
        x = x[None]
    pdtype = params["patch_embedding"]["kernel"].dtype
    h = kernel_dense(params["patch_embedding"], patchify(x.to(pdtype), patch_size))
    h = layer_norm(h, eps)
    h = kernel_dense(params["projection"], h)
    return layer_norm(h, eps)
