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
`preprocess_video` (the eval path, tools/eval_vlm.py) samples and resizes
through media.py `fetch_video` and re-aligns the frames to patch·merge
multiples with a second resize on `device`. `build_chat_ids` renders the
Qwen3-VL chat template with its video
expansion through a tokenizer; `video_prompt_ids` lays out the same video
spans around given token ids. The image path: `load_image` (a uint8
array, an `.npy`/`.npz`, or a PNG read by utils/png.py: the card's machine
has no Pillow) smart-resized on `device`, `preprocess_image` (grid (1, h,
w)) and `build_vqa_ids`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ...configs.qwen3vl import SPECIAL_TOKEN_IDS, Qwen3VLConfig
from ...utils.png import read_png
from ...utils.video import read_video_frames
from .media import fetch_video, resize_on, round_by_factor, smart_resize

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


def preprocess_video(path: str, patch_size: int = 16, temporal_patch_size: int = 2,
                     merge_size: int = 2, nframes: Optional[int] = None, device="cuda"):
    """A clip file → (patches [n, C·tp·p·p] f32 numpy, grid (t, h, w)):
    media.py `fetch_video` (its frame count and pixel budget, resized on
    `device`), then a second resize of the same kind down to this model's
    patch_size·merge_size multiples where fetch_video's 28-pixel grid does
    not fit them, as JAX's second Pillow resize."""
    ele = {"video": path}
    if nframes is not None:
        ele["nframes"] = nframes
    frames, _fps = fetch_video(ele, device)
    f = patch_size * merge_size
    H, W = frames.shape[1:3]
    if H % f or W % f:
        frames = resize_on(frames, ((H // f) * f or f, (W // f) * f or f), device)
    return frames_to_patches(frames, patch_size, temporal_patch_size, merge_size)


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
        sel = resize_on(sel, size, device)
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


def load_image(image, factor: int, min_pixels: int = 4 * 28 * 28,
               max_pixels: int = 16384 * 28 * 28, device="cuda") -> np.ndarray:
    """An image → smart-resized [1, H, W, 3] uint8 (JAX `load_image`).
    `image`: a [H, W, 3 or 4] uint8 array, or a path to an `.npy`, an `.npz`
    (its `image` array, else its first) or an 8-bit RGB/RGBA PNG
    (utils/png.py; anything else raises). Alpha is dropped, as Pillow's
    convert("RGB") drops it. The resize runs on `device` (utils/video.py
    `resize_frames`, within 1 uint8 level of Pillow's bicubic, JAX's)."""
    if isinstance(image, (str, Path)):
        path = Path(image)
        if path.suffix == ".npy":
            image = np.load(path)
        elif path.suffix == ".npz":
            with np.load(path) as z:
                image = z["image"] if "image" in z.files else z[z.files[0]]
        elif path.suffix.lower() == ".png":
            image = read_png(path)
        else:
            raise ValueError(f"{path}: images are read from .png, .npy or .npz (no Pillow)")
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"image must be [H, W, 3 or 4] uint8, got {image.shape} {image.dtype}")
    image = np.ascontiguousarray(image[..., :3])
    h, w = image.shape[:2]
    size = smart_resize(h, w, factor=factor, min_pixels=min_pixels, max_pixels=max_pixels)
    if size != (h, w):
        image = resize_on(image[None], size, device)[0]
    return image[None]


def preprocess_image(image, patch_size: int = 16, temporal_patch_size: int = 2,
                     merge_size: int = 2, min_pixels: int = 4 * 28 * 28,
                     max_pixels: int = 16384 * 28 * 28, device="cuda"):
    """An image (see `load_image`) → (patches [n, C·tp·p·p] f32 numpy, grid
    (1, h, w)): the one frame repeated to the temporal patch."""
    frames = load_image(image, factor=patch_size * merge_size, min_pixels=min_pixels,
                        max_pixels=max_pixels, device=device)
    return frames_to_patches(frames, patch_size, temporal_patch_size, merge_size)


def build_vqa_ids(tokenizer, question: str, n_vision_tokens: int = 0, is_video: bool = False,
                  system_prompt: Optional[str] = None) -> np.ndarray:
    """[1, L] int32 ids of `<system?> user(<vision> question) assistant`, the
    vision span n_vision_tokens = t·h·w / merge² pad tokens long."""
    pad = VIDEO_PAD if is_video else IMAGE_PAD
    parts = []
    if system_prompt:
        parts.append(f"<|im_start|>system\n{system_prompt}<|im_end|>\n")
    vision = f"{VISION_START}{pad * n_vision_tokens}{VISION_END}" if n_vision_tokens else ""
    parts.append(f"<|im_start|>user\n{vision}{question}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    ids = tokenizer("".join(parts), add_special_tokens=False)["input_ids"]
    return np.asarray([ids], np.int32)
