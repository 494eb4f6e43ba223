"""Misc utilities (port of omnivideo_tpu/utils/misc.py, the role of the
reference's `omnivideo/utils/utils.py:78-158`)."""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from ..device import resolve_device


def str2bool(v) -> bool:
    """argparse bool coercion."""
    if isinstance(v, bool):
        return v
    v = str(v).lower()
    if v in ("yes", "true", "t", "y", "1"):
        return True
    if v in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def masks_like(shape: Tuple[int, ...], zero_first_frame: bool = False,
               device="cuda") -> torch.Tensor:
    """f32 ones over a latent [C, F, H, W] on `device`, frame 0 zeroed with
    `zero_first_frame` (first-frame conditioning in i2v-style tasks)."""
    m = torch.ones(shape, dtype=torch.float32, device=resolve_device(device))
    if zero_first_frame:
        m[:, 0] = 0.0
    return m


def best_output_size(w: int, h: int, dw: int, dh: int, expected_area: int) -> Tuple[int, int]:
    """Aspect-fit output size under an area budget, divisor-aligned."""
    ratio = w / h
    ow = (expected_area * ratio) ** 0.5 // dw * dw
    oh = expected_area / ow // dh * dh
    ow2 = ow + dw
    oh2 = expected_area / ow2 // dh * dh
    if abs(ow / oh - ratio) < abs(ow2 / oh2 - ratio):
        return int(ow), int(oh)
    return int(ow2), int(oh2)
