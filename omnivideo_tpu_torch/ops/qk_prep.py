"""Fused q/k preparation for the Wan DiT attention prologue.

Port of omnivideo_tpu/ops/pallas/qk_prep.py. Per q or k projection
x [B, L, d]: RMS norm (f32) → bf16 cast → ×bf16 gain → interleaved RoPE in
f32 (rows past the table unrotated) → bf16 store, plus the per-(b, head)
max row norm of the f32 pre-cast values, inflated by (1 + 2⁻⁷) so it stays
an upper bound after the bf16 cast. The op order is the contract.

`qk_prep` launches the CUDA kernel `csrc/qk_prep.cu` for CUDA tensors and
takes `qk_prep_plain` only for CPU tensors. Bound and design: see the
kernel source. The kernel has no backward: on CUDA the wrapper raises when
grad mode is on and an input requires grad (training takes the unfused
chain).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .rope import expanded_tables, pair_swap

ROW_NORM_SLACK = 1.0 + 2.0**-7  # covers the bf16 round-up of y


def row_tiles(L: int) -> int:
    """Row tiles of the kernel's grid for L rows, as the kernel library sizes
    them (one [B, tiles, N] f32 row-norm maximum per tile)."""
    return _kernels.library().qk_prep_tiles(L)


def qk_prep_plain(
    x: torch.Tensor,
    gain: torch.Tensor,
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    num_heads: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same math and casts as the kernel."""
    B, L, d = x.shape
    hd = d // num_heads
    xf = x.float()
    rs = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xh = (xf * rs).to(x.dtype) * gain.to(x.dtype)
    x3 = xh.view(B, L, num_heads, hd).float()
    if cos is not None:
        ce, se = expanded_tables(cos.to(x.device), sin.to(x.device), L)
        y3 = x3 * ce[None, :, None, :] + pair_swap(x3) * se[None, :, None, :]
    else:
        y3 = x3
    rn = y3.square().sum(-1).amax(dim=1).sqrt() * ROW_NORM_SLACK
    return y3.to(x.dtype), rn


def qk_prep(
    x: torch.Tensor,
    gain: torch.Tensor,
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    num_heads: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, d] raw projection output; gain: [d]; cos/sin: [Lr, hd//2]
    f32 RoPE tables or None (norm + gain only, e.g. cross-attention).
    Returns (y [B, L, N, hd] in x.dtype, row-norm bound [B, N] f32)."""
    if x.device.type == "cpu":
        return qk_prep_plain(x, gain, cos, sin, num_heads, eps)
    _kernels.check_no_grad("qk_prep", x, gain)
    if not x.is_cuda:
        raise ValueError(f"qk_prep: unsupported device {x.device}")
    B, L, d = x.shape
    hd = d // num_heads
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("qk_prep kernel takes contiguous bf16 x")
    if d % num_heads or hd % 8 or d % 8:
        raise ValueError(f"qk_prep kernel needs head_dim % 8 == 0 (d={d}, N={num_heads})")
    if gain.shape != (d,):
        raise ValueError(f"gain shape {tuple(gain.shape)} != ({d},)")
    with_rope = cos is not None
    if with_rope:
        cos = cos.to(device=x.device, dtype=torch.float32).contiguous()
        sin = sin.to(device=x.device, dtype=torch.float32).contiguous()
        if cos.shape[1] != hd // 2 or sin.shape != cos.shape:
            raise ValueError(f"rope tables {tuple(cos.shape)} do not fit head_dim {hd}")
    y = torch.empty_like(x)
    if L == 0:
        return y.view(B, L, num_heads, hd), x.new_zeros(B, num_heads, dtype=torch.float32)
    tile_max = torch.empty(B, row_tiles(L), num_heads, device=x.device, dtype=torch.float32)
    g = gain.to(device=x.device, dtype=torch.bfloat16).contiguous()
    code = _kernels.library().qk_prep_launch(
        x.data_ptr(), g.data_ptr(),
        cos.data_ptr() if with_rope else None,
        sin.data_ptr() if with_rope else None,
        y.data_ptr(), tile_max.data_ptr(), B, L, d, num_heads,
        cos.shape[0] if with_rope else 0, int(with_rope), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(code, "qk_prep")
    qk_prep.launches += 1
    return y.view(B, L, num_heads, hd), tile_max.amax(dim=1) * ROW_NORM_SLACK


qk_prep.launches = 0
