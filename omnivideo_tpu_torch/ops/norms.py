"""Normalization primitives in float32 (port of omnivideo_tpu/ops/norms.py).

Same casts as the JAX package: WanRMSNorm normalizes in f32, casts back to
the input dtype, then multiplies by the weight cast to that dtype; the layer
norm computes in f32 and returns f32 or the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x̂ = x·rsqrt(mean(x²)+eps) in f32, cast back to x.dtype, then ·weight."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * weight.to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    eps: float = 1e-6,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    out_f32: bool = False,
) -> torch.Tensor:
    """f32 layer norm with optional affine; cast back unless out_f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y if out_f32 else y.to(x.dtype)
