"""3D-factorized rotary position embedding (port of omnivideo_tpu/ops/rope.py).

Tables are built on the host in float64 numpy and stored as float32 cos/sin
[L, head_dim//2]; head_dim/2 complex lanes split `c−2(c//3), c//3, c//3`
across (frame, height, width). The rotation acts on interleaved (re, im)
pairs in f32. The JAX package expresses the pair swap as a ±1 matmul (a TPU
MXU trick); here it is a plain swap, exact either way.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def axis_freqs(max_len: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """Angles θ[p, j] = p · theta^(−2j/dim) for one axis, f64."""
    assert dim % 2 == 0
    inv = 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)
    return np.outer(np.arange(max_len, dtype=np.float64), inv)


@functools.lru_cache(maxsize=32)
def rope_3d_tables(
    grid: Tuple[int, int, int],
    head_dim: int,
    max_len: int = 1024,
    theta: float = 10000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables [F·H·W, head_dim//2] float32 for a (F, H, W) grid."""
    f, h, w = grid
    c = head_dim // 2
    ct = c - 2 * (c // 3)
    ch = cw = c // 3
    ang_t = axis_freqs(max_len, 2 * ct, theta)[:f]
    ang_h = axis_freqs(max_len, 2 * ch, theta)[:h]
    ang_w = axis_freqs(max_len, 2 * cw, theta)[:w]
    ang = np.concatenate(
        [
            np.broadcast_to(ang_t[:, None, None, :], (f, h, w, ct)),
            np.broadcast_to(ang_h[None, :, None, :], (f, h, w, ch)),
            np.broadcast_to(ang_w[None, None, :, :], (f, h, w, cw)),
        ],
        axis=-1,
    ).reshape(f * h * w, c)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    cos.flags.writeable = False  # shared by every caller through the cache
    sin.flags.writeable = False
    return cos, sin


def expanded_tables(cos: torch.Tensor, sin: torch.Tensor, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane f32 tables [L, D]: Ce[l, 2j] = Ce[l, 2j+1] = cos[l, j]; rows
    at or past the table length get cos 1, sin 0 (they pass unrotated)."""
    ce = cos.float().repeat_interleave(2, dim=-1)[:L]
    se = sin.float().repeat_interleave(2, dim=-1)[:L]
    if ce.shape[0] < L:
        pad = L - ce.shape[0]
        ce = torch.cat([ce, ce.new_ones(pad, ce.shape[1])])
        se = torch.cat([se, se.new_zeros(pad, se.shape[1])])
    return ce, se


def pair_swap(x: torch.Tensor) -> torch.Tensor:
    """y[..., 2j] = −x[..., 2j+1], y[..., 2j+1] = x[..., 2j]."""
    xp = x.unflatten(-1, (-1, 2))
    return torch.stack([-xp[..., 1], xp[..., 0]], dim=-1).flatten(-2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the packed (re, im) lanes of q/k.

    x: [B, L, N, D]; cos/sin: [Lr, D//2] f32. Rows past Lr pass through
    unrotated. Math in f32 (x·Ce + swap(x)·Se, each product rounded as in
    the JAX form), result cast back to x.dtype."""
    L = x.shape[1]
    ce, se = expanded_tables(cos.to(x.device), sin.to(x.device), L)
    xf = x.float()
    y = xf * ce[None, :, None, :] + pair_swap(xf) * se[None, :, None, :]
    return y.to(x.dtype)
