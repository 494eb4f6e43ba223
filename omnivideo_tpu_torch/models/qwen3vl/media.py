"""Qwen-VL media preprocessing (port of omnivideo_tpu/utils/qwen_vl_media.py,
the role of the reference's `omnivideo/utils/qwen_vl_utils.py`).

`smart_resize` and `smart_nframes` are value-identical to the public
`qwen-vl-utils` package, because the VLM was trained on exactly these
target sizes and frame counts: snap both sides to the patch factor, then,
if the snapped area leaves the budget, rescale by the square root of the
area ratio, flooring to the factor when shrinking and ceiling when growing.
`fetch_video` reads a clip (utils/video.py), samples `smart_nframes` frames
and resizes them to the video pixel budget on `device` with
utils/video.py `resize_frames` (torch's antialiased bicubic in Pillow's two
passes, within 1 uint8 level of the Pillow resize the JAX package runs:
the card's machine may have no Pillow). `process_vision_info` collects a
chat's images (as [H, W, 3] uint8 arrays, smart-resized; read by
models/qwen3vl/preprocess.py `load_image`) and videos.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...utils.video import read_video_frames, resize_frames

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


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


def smart_nframes(ele: Dict, total_frames: int, video_fps: float) -> int:
    """How many frames to sample for VLM video input: an explicit `nframes`
    wins (rounded to the temporal-patch factor); otherwise the target fps
    becomes a frame count clamped to [min_frames, max_frames], all
    factor-aligned."""
    if "fps" in ele and "nframes" in ele:
        raise ValueError("give either `fps` or `nframes`, not both")
    if "nframes" in ele:
        n = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        lo = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR)
        hi = floor_by_factor(ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
                             FRAME_FACTOR)
        want = total_frames / video_fps * ele.get("fps", FPS)
        n = round_by_factor(min(max(want, lo), hi), FRAME_FACTOR)
    if not FRAME_FACTOR <= n <= total_frames:
        raise ValueError(f"sampled frame count {n} outside [{FRAME_FACTOR}, {total_frames}]")
    return int(n)


def resize_on(frames: np.ndarray, size: Tuple[int, int], device) -> np.ndarray:
    """[T, H, W, 3] uint8 → [T, h, w, 3] uint8 at size = (h, w), resized on
    `device` (utils/video.py `resize_frames`)."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(resolve_device(device))
    return resize_frames(x, size).cpu().numpy()


def fetch_video(ele: Dict, device="cuda") -> Tuple[np.ndarray, float]:
    """Read, sample and resize a video for VLM input: ([T, H, W, 3] uint8,
    sample fps). `ele["video"]` is any clip utils/video.py reads."""
    frames, video_fps = read_video_frames(ele["video"])
    total = len(frames)
    nframes = smart_nframes(ele, total, video_fps)
    idx = np.linspace(0, total - 1, nframes).round().astype(int)
    sel = frames[idx]
    h, w = sel.shape[1:3]
    min_pixels = ele.get("min_pixels", VIDEO_MIN_PIXELS)
    total_pixels = ele.get("total_pixels", VIDEO_TOTAL_PIXELS)
    max_pixels = max(min(VIDEO_MAX_PIXELS, int(total_pixels / nframes * FRAME_FACTOR)),
                     int(min_pixels * 1.05))
    rh, rw = smart_resize(h, w, factor=IMAGE_FACTOR, min_pixels=min_pixels,
                          max_pixels=max_pixels)
    if (rh, rw) != (h, w):
        sel = resize_on(sel, (rh, rw), device)
    return sel, nframes / max(total / video_fps, 1e-6)


def process_vision_info(messages: List[Dict], device="cuda"):
    """(images, videos) of chat messages, each list or None: an image
    element (`image` or `image_url`: an array, .npy/.npz or PNG path, a
    `file://` prefix dropped) becomes a smart-resized [H, W, 3] uint8 array,
    a video element `fetch_video`'s frames."""
    from .preprocess import load_image

    images, videos = [], []
    for msg in messages:
        content = msg.get("content", [])
        if isinstance(content, str):
            continue
        for ele in content:
            if "image" in ele or "image_url" in ele:
                src = ele.get("image", ele.get("image_url"))
                if isinstance(src, str) and src.startswith("file://"):
                    src = src[7:]
                images.append(load_image(src, factor=IMAGE_FACTOR,
                                         min_pixels=ele.get("min_pixels", MIN_PIXELS),
                                         max_pixels=ele.get("max_pixels", MAX_PIXELS),
                                         device=device)[0])
            elif "video" in ele:
                videos.append(fetch_video(ele, device)[0])
    return images or None, videos or None
