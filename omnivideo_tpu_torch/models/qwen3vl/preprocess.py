"""Qwen3-VL host preprocessing (port of
omnivideo_tpu/models/qwen3vl/preprocess.py).

`frames_to_patches` reproduces transformers' Qwen2VLImageProcessor pixel
math: CLIP-normalize, then split into [grid_t·grid_h·grid_w, C·tp·p·p]
flattened patches in the processor's merge-grouped traversal order.
`preprocess_video_timestamps` reads a clip, samples `nframes` frames
(`np.linspace(...).round()`), smart-resizes them to the pixel budget on
`device` (utils/video.py `resize_frames`: torch's antialiased bicubic where
the JAX package uses Pillow's) and returns the patches, the grid and the
per-temporal-group `<t seconds>` timestamps of HF's Qwen3VLProcessor.
`build_chat_ids` renders the Qwen3-VL chat template with its video
expansion through a tokenizer; `video_prompt_ids` lays out the same video
spans around given token ids. The image path (`load_image`,
`preprocess_image`, `build_vqa_ids`) waits for ROADMAP §1 item 4.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...configs.qwen3vl import SPECIAL_TOKEN_IDS, Qwen3VLConfig
from ...device import resolve_device
from ...utils.video import read_video_frames, resize_frames
from .media import round_by_factor, smart_resize

# CLIP normalization constants (Qwen2VLImageProcessor defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
VISION_END_TOKEN_ID = SPECIAL_TOKEN_IDS["<|vision_end|>"]


def frames_to_patches(
    frames: np.ndarray,  # [T, H, W, 3] uint8 (already smart-resized)
    patch_size: int,
    temporal_patch_size: int,
    merge_size: int,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Normalize + patchify frames → ([n_patches, C·tp·p·p] f32, (t, h, w) grid).

    Within each merge window the spatial patches are contiguous; windows scan
    row-major. A frame count that is not a multiple of tp repeats the last
    frame."""
    T, H, W, C = frames.shape
    p, tp, m = patch_size, temporal_patch_size, merge_size
    if H % (p * m) or W % (p * m):
        raise ValueError(f"frames {H}x{W} are not multiples of patch·merge = {p * m}")

    x = frames.astype(np.float32) / 255.0
    x = (x - CLIP_MEAN) / CLIP_STD
    x = x.transpose(0, 3, 1, 2)  # [T, C, H, W]
    if T % tp:
        x = np.concatenate([x, np.repeat(x[-1:], tp - T % tp, axis=0)], axis=0)
    T = x.shape[0]

    gt, gh, gw = T // tp, H // p, W // p
    x = x.reshape(gt, tp, C, gh // m, m, p, gw // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gt * gh * gw, C * tp * p * p), (gt, gh, gw)


def video_prompt_ids(
    prefix: Sequence[int],
    suffix: Sequence[int],
    grid: Tuple[int, int, int],
    cfg: Qwen3VLConfig,
    frame_prefixes: Optional[Sequence[Sequence[int]]] = None,
    vision_end_token_id: int = VISION_END_TOKEN_ID,
) -> np.ndarray:
    """[1, L] int64 ids: prefix | per temporal group: (frame prefix, e.g. the
    `<t seconds>` timestamp tokens) <vstart> <vpad>×(h·w/merge²) <vend> |
    suffix."""
    t, h, w = grid
    m = cfg.vision.spatial_merge_size
    ids = list(prefix)
    for i in range(t):
        if frame_prefixes is not None:
            ids += list(frame_prefixes[i])
        ids += [cfg.vision_start_token_id] + [cfg.video_token_id] * (h * w // (m * m))
        ids += [vision_end_token_id]
    ids += list(suffix)
    return np.asarray([ids], np.int64)


def preprocess_video_timestamps(
    path: str,
    patch_size: int = 16,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    nframes: int = 6,
    min_pixels: int = 4 * 28 * 28,
    max_pixels: int = 16384 * 28 * 28,
    device="cuda",
):
    """A clip file → (patches [n, C·tp·p·p] f32 numpy, grid (t, h, w),
    per-grid-frame timestamps in seconds). The timestamps are the sampled
    frame indices over fps, padded to a merge_size multiple and averaged
    over each merge group (HF Qwen3VLProcessor._calculate_timestamps)."""
    frames, video_fps = read_video_frames(path)
    total = len(frames)
    n = max(temporal_patch_size, min(round_by_factor(nframes, temporal_patch_size), total))
    idx = np.linspace(0, total - 1, n).round().astype(int)
    sel = frames[idx]
    H, W = sel.shape[1:3]
    size = smart_resize(H, W, factor=patch_size * merge_size, min_pixels=min_pixels,
                        max_pixels=max_pixels)
    if size != (H, W):
        sel = resize_frames(torch.from_numpy(sel).to(resolve_device(device)), size).cpu().numpy()
    patches, grid = frames_to_patches(sel, patch_size, temporal_patch_size, merge_size)
    ind = list(idx)
    if len(ind) % merge_size:
        ind.extend(ind[-1] for _ in range(merge_size - len(ind) % merge_size))
    ts = [i / video_fps for i in ind]
    ts = [(ts[i] + ts[i + merge_size - 1]) / 2 for i in range(0, len(ts), merge_size)]
    return patches, grid, ts[: grid[0]]


VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"
VIDEO_PAD = "<|video_pad|>"


def build_chat_ids(
    tokenizer,
    user_text: str,
    system_prompt: Optional[str] = None,
    grid: Optional[Tuple[int, int, int]] = None,
    timestamps: Optional[Sequence[float]] = None,
    merge_size: int = 2,
    is_video: bool = True,
) -> np.ndarray:
    """[1, L] int32 ids of `<system?> user(<video?> text) assistant`, with
    the processor's video expansion: per temporal grid frame,
    `<{t:.1f} seconds>` + vision_start + grid_h·grid_w/merge² pad tokens +
    vision_end. The vision tokens precede the user text, as in the chat
    template."""
    parts = []
    if system_prompt:
        parts.append(f"<|im_start|>system\n{system_prompt}<|im_end|>\n")
    vision = ""
    if grid is not None:
        gt, gh, gw = grid
        frame_seqlen = gh * gw // (merge_size ** 2)
        pad = VIDEO_PAD if is_video else IMAGE_PAD
        if is_video:
            ts = list(timestamps if timestamps is not None else [float(i) for i in range(gt)])
            for i in range(gt):
                vision += f"<{ts[i]:.1f} seconds>" + VISION_START + pad * frame_seqlen + VISION_END
        else:
            vision = VISION_START + pad * (gt * frame_seqlen) + VISION_END
    parts.append(f"<|im_start|>user\n{vision}{user_text}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    ids = tokenizer("".join(parts), add_special_tokens=False)["input_ids"]
    return np.asarray([ids], np.int32)


_IMAGE_PATH = "the image path of the Qwen3-VL engine waits for ROADMAP §1 item 4"


def load_image(*args, **kwargs):
    raise NotImplementedError(_IMAGE_PATH)


def preprocess_image(*args, **kwargs):
    raise NotImplementedError(_IMAGE_PATH)


def build_vqa_ids(*args, **kwargs):
    raise NotImplementedError(_IMAGE_PATH)
