"""Qwen3-VL feature extraction without a tokenizer (the tokenizer-free parts
of omnivideo_tpu/models/qwen3vl/engine.py).

`extract_features` runs token ids (+ video patches and grid) through
`qwen3vl_forward` and returns the last-hidden-state conditioning features
with the system-prompt prefix dropped, under the dict keys of the JAX
engine's `extract_features` (engine.py:465-472). The features go to the x2x
pipeline's `generate(ar_vision_input=...)`. The text-level engine (chat
template, caption strings) waits for the checkpoint's `tokenizer.json`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .full_model import Qwen3VLModel, qwen3vl_forward


def extract_masked_hidden(hidden, mask) -> List[Any]:
    """Split the valid positions of each batch row (vllm_model.py:295-310 of
    the reference): hidden [B, L, D], mask [B, L]."""
    return [hidden[i][np.asarray(mask[i]).astype(bool)] for i in range(hidden.shape[0])]


def drop_system_prefix(valid, drop_idx: int):
    """Drop the `<|im_start|>system…<|im_start|>user\\n` prefix tokens, when
    any remain after them."""
    if drop_idx > 0 and valid.shape[0] > drop_idx:
        return valid[drop_idx:]
    return valid


def extract_features(
    model: Qwen3VLModel,
    input_ids: np.ndarray,
    pixel_patches=None,
    grid_thw: Optional[Tuple[int, int, int]] = None,
    drop_idx: int = 0,
    source_video_path: Optional[str] = None,
    edit_prompt: str = "",
) -> Dict[str, Any]:
    """ids [1, L] (+ patches, grid) → {"vlm_last_hidden_states": [L', D] f32
    tensor on the model's device, ...}. A single sample has no padding, so
    every position is valid before the prefix drop."""
    hidden = qwen3vl_forward(model, input_ids, pixel_patches, grid_thw)
    valid = drop_system_prefix(hidden[0].float(), drop_idx)
    return {
        "source_video_path": source_video_path,
        "edit_prompt": edit_prompt,
        "vlm_last_hidden_states": valid,
        "attention_mask": torch.ones(valid.shape[0], dtype=torch.int64),
        "hidden_dim": valid.shape[-1],
        "seq_len": valid.shape[0],
    }
