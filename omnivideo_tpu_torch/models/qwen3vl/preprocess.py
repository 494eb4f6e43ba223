"""Qwen3-VL host preprocessing without a tokenizer (port of
omnivideo_tpu/models/qwen3vl/preprocess.py:20-50, pure numpy).

`frames_to_patches` reproduces transformers' Qwen2VLImageProcessor pixel
math: CLIP-normalize, then split into [grid_t·grid_h·grid_w, C·tp·p·p]
flattened patches in the processor's merge-grouped traversal order.
`video_prompt_ids` lays out token ids the way the chat template expands a
video: text, then per frame `<|vision_start|>`, grid_h·grid_w/merge²
`<|video_pad|>` and `<|vision_end|>`, then text. Video decoding and the
tokenizer-level `build_chat_ids` wait for `tokenizer.json`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ...configs.qwen3vl import Qwen3VLConfig

# CLIP normalization constants (Qwen2VLImageProcessor defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
VISION_END_TOKEN_ID = 151653  # <|vision_end|> of the Qwen3-VL vocabulary


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
