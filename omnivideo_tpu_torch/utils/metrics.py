"""Video generation quality metrics (port of omnivideo_tpu/utils/metrics.py).

- PSNR / SSIM between generated and reference clips (editing fidelity: the
  unedited regions of a V2V edit should match the source);
- temporal consistency (mean adjacent-frame SSIM: a flicker detector);
- motion magnitude (mean adjacent-frame difference: catches frozen frames).

Torch ops in f64 on the frames' device (a numpy clip is read on the CPU),
so the card computes them for clips it holds; the values are the JAX
package's numpy f64 ones up to summation order. SSIM is the JAX package's
global-statistics form: the grayscale frame (the channel mean) in 8x8
blocks, each block's SSIM from its means, variances and covariance,
averaged. Clips are [T, H, W, C] uint8 or float.
"""

from __future__ import annotations

from typing import Dict

import torch


def _f64(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.float64)


def psnr(a, b, data_range: float = 255.0) -> float:
    """a, b: [T, H, W, C] of the same shape."""
    a = _f64(a)
    mse = (a - _f64(b, a.device)).square().mean()
    if float(mse) == 0.0:
        return float("inf")
    return float(10.0 * torch.log10(data_range**2 / mse))


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """[T, H, W] → [T, blocks, 64]: the 8x8 blocks of each frame, row-major."""
    T, H, W = x.shape
    h, w = H // 8 * 8, W // 8 * 8
    x = x[:, :h, :w].reshape(T, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(T, -1, 64)


def _ssim_frames(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """[T] SSIM of each frame pair a[t], b[t] ([T, H, W, C] or [T, H, W])."""
    a = a.mean(-1) if a.ndim == 4 else a
    b = b.mean(-1) if b.ndim == 4 else b
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    xa, xb = _blocks(a), _blocks(b)
    mua, mub = xa.mean(-1), xb.mean(-1)
    va, vb = xa.var(-1, unbiased=False), xb.var(-1, unbiased=False)
    cov = ((xa - mua[..., None]) * (xb - mub[..., None])).mean(-1)
    s = ((2 * mua * mub + c1) * (2 * cov + c2)) / ((mua**2 + mub**2 + c1) * (va + vb + c2))
    return s.mean(-1)


def ssim(a, b, data_range: float = 255.0) -> float:
    """Mean per-frame SSIM over the common frames. a, b: [T, H, W, C]."""
    a = _f64(a)
    b = _f64(b, a.device)
    T = min(len(a), len(b))
    return float(_ssim_frames(a[:T], b[:T], data_range).mean())


def temporal_consistency(v) -> float:
    """Mean adjacent-frame SSIM: near 1.0 means no flicker. v: [T, H, W, C]."""
    if len(v) < 2:
        return 1.0
    v = _f64(v)
    return float(_ssim_frames(v[:-1], v[1:]).mean())


def motion_magnitude(v) -> float:
    """Mean absolute adjacent-frame difference (0 = frozen frame)."""
    if len(v) < 2:
        return 0.0
    v = _f64(v)
    return float((v[1:] - v[:-1]).abs().mean())


def evaluate_pair(generated, reference) -> Dict[str, float]:
    return {
        "psnr": psnr(generated, reference),
        "ssim": ssim(generated, reference),
        "temporal_consistency": temporal_consistency(generated),
        "motion_magnitude": motion_magnitude(generated),
    }


def evaluate_single(generated) -> Dict[str, float]:
    return {
        "temporal_consistency": temporal_consistency(generated),
        "motion_magnitude": motion_magnitude(generated),
    }
