"""Pixel-budget resizing for Qwen-VL inputs (own copy of smart_resize and its
rounding helpers from omnivideo_tpu/utils/qwen_vl_media.py:30-72; pure
Python, no numpy needed).

The arithmetic is value-identical to the public `qwen-vl-utils` package,
because the VLM was trained on exactly these target sizes: snap both sides
to the patch factor, then, if the snapped area leaves the budget, rescale by
the square root of the area ratio, flooring to the factor when shrinking and
ceiling when growing.
"""

from __future__ import annotations

import math
from typing import Tuple

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200


def round_by_factor(number: float, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> Tuple[int, int]:
    """Target (h, w) for a pixel-budgeted, patch-aligned resize."""
    ratio = max(height, width) / min(height, width)
    if ratio > MAX_RATIO:
        raise ValueError(f"aspect ratio {ratio:.2f}:1 exceeds the {MAX_RATIO}:1 limit")
    h = max(factor, round_by_factor(height, factor))
    w = max(factor, round_by_factor(width, factor))
    if h * w > max_pixels:
        shrink = math.sqrt(height * width / max_pixels)
        h = floor_by_factor(height / shrink, factor)
        w = floor_by_factor(width / shrink, factor)
    elif h * w < min_pixels:
        grow = math.sqrt(min_pixels / (height * width))
        h = ceil_by_factor(height * grow, factor)
        w = ceil_by_factor(width * grow, factor)
    return h, w
