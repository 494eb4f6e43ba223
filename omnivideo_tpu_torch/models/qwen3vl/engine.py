"""Qwen3-VL conditioning stage: captions and hidden-state features (port of
omnivideo_tpu/models/qwen3vl/engine.py, its native "jax" backend).

Three passes per sample, as the reference's vllm_model.py: a source-video
caption, a target caption (the V2V edit-aware rewrite, or the T2V prompt
expansion) and the last-hidden-state features with the system-prompt prefix
dropped; `generate_caption_and_extract_features` runs all three. Inputs are
built natively (models/qwen3vl/preprocess.py: frame sampling, smart-resize on
the card, patchify, the chat template with per-frame `<t seconds>`), the
captions decode greedily with `qwen3vl_greedy_decode` (a KV cache per call:
the three passes have three prompt lengths) and the features come from
`qwen3vl_forward`.

`Qwen3VLEngine(VLMConfig(model_path=...))` loads an HF checkpoint dir:
config.json, tokenizer.json (`FastTokenizer`, which needs the `tokenizers`
package) and the safetensors shards streamed onto the card in the dtype
they are stored in, as the JAX engine keeps it (io/hf_reader.py).
`Qwen3VLEngine.from_model(model, cfg, tokenizer)` wraps a model already on
its device with any tokenizer of the FastTokenizer API.

Backends keep the JAX names: "jax" is the native path; "hf" (transformers'
own torch model) is not ported and raises, as does `fsdp` > 1 (the FSDP
slice) and the image branch (ROADMAP §1 item 4).

The pixel budgets are the JAX engine's: the caption passes resize to
480²…4·480² pixels, the feature pass to 480…1,920 pixels (so a 720p or
832x480 clip becomes 32x32 frames there, one merged token per temporal
frame), ROADMAP §3.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...configs import prompts as P
from ...device import resolve_device
from ...io.hf_reader import (FastTokenizer, checkpoint_dtype, iter_hf_safetensors,
                             load_hf_config, load_qwen3vl_hf, qwen3vl_config_from_hf)
from .full_model import Qwen3VLModel, qwen3vl_forward, qwen3vl_greedy_decode
from .preprocess import build_chat_ids, preprocess_video_timestamps

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


def compute_system_prompt_drop_idx(tokenizer, system_prompt: str) -> int:
    """Tokens of `<|im_start|>system\\n{sys}<|im_end|>\\n<|im_start|>user\\n`
    to drop from the extracted features (vllm_model.py:278-292)."""
    prefix = f"<|im_start|>system\n{system_prompt}<|im_end|>\n<|im_start|>user\n"
    return len(tokenizer(prefix, add_special_tokens=False)["input_ids"])


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
    tensor on the model's device, ...}, under the keys of the JAX engine's
    `extract_features`. A single sample has no padding, so every position
    is valid before the prefix drop."""
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


@dataclasses.dataclass
class VLMConfig:
    model_path: str = ""
    backend: str = "jax"  # "jax": the native path (the JAX engine's name); "hf" is not ported
    target_short_side: int = 480
    video_nframes: int = 6
    max_new_tokens: int = 512
    temperature: float = 0.0  # greedy, the reference's default
    fsdp: int = 1
    # vision-tower RoPE mix precision: the JAX engine's inference default
    # bf16; "float32" is the parity mode of HF's f32 rope
    vision_rope_dtype: str = "bfloat16"
    device: str = "cuda"


def _check_config(cfg: VLMConfig) -> None:
    if cfg.backend == "hf":
        raise NotImplementedError("VLM backend 'hf' (transformers' own torch model) is not "
                                  "ported; the port runs the native path, backend 'jax'")
    if cfg.backend != "jax":
        raise ValueError(f"unknown VLM backend {cfg.backend!r}")
    if cfg.fsdp > 1:
        raise NotImplementedError("VLM fsdp > 1 comes with the FSDP slice, ROADMAP §1")


def checkpoint_eos(model_path: str, cfg_dict: dict) -> Optional[int]:
    """config.json's text_config.eos_token_id, else generation_config.json's;
    the first entry when it is a list."""
    eos = cfg_dict.get("text_config", {}).get("eos_token_id")
    if eos is None:
        gc = Path(model_path) / "generation_config.json"
        if gc.exists():
            eos = json.loads(gc.read_text()).get("eos_token_id")
    if isinstance(eos, (list, tuple)):
        eos = eos[0]
    return eos


class Qwen3VLEngine:
    """Caption + feature engine over a Qwen3-VL model. `timings` holds the
    synchronized wall seconds of the last call of each public flow
    ("source_caption_s", "target_caption_s", "features_s")."""

    def __init__(self, cfg: VLMConfig):
        _check_config(cfg)
        dev = resolve_device(cfg.device)
        cfg_dict = load_hf_config(cfg.model_path)
        tokenizer = FastTokenizer(cfg.model_path)
        model = Qwen3VLModel(qwen3vl_config_from_hf(cfg_dict, cfg.vision_rope_dtype),
                             checkpoint_dtype(cfg.model_path), dev)
        load_qwen3vl_hf(model, iter_hf_safetensors(cfg.model_path, device=dev))
        self._setup(model, cfg, tokenizer, checkpoint_eos(cfg.model_path, cfg_dict))

    @classmethod
    def from_model(cls, model: Qwen3VLModel, cfg: VLMConfig, tokenizer,
                   eos_token_id: Optional[int] = None) -> "Qwen3VLEngine":
        """An engine over `model` (already on its device) and `tokenizer`
        (any object with the FastTokenizer API); eos defaults to the
        tokenizer's."""
        _check_config(cfg)
        engine = cls.__new__(cls)
        engine._setup(model, cfg, tokenizer, eos_token_id)
        return engine

    def _setup(self, model, cfg, tokenizer, eos) -> None:
        self.cfg, self.model, self.tokenizer = cfg, model, tokenizer
        self._eos = eos if eos is not None else tokenizer.eos_token_id
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def _timed(self, key: str):
        dev = self.model.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings[key] = time.perf_counter() - t0

    def _native_inputs(self, user_text: str, system_prompt: Optional[str],
                       video_path: Optional[str] = None, feature_extraction: bool = False):
        """(ids [1, L], patches on the model's device | None, grid | None):
        the native form of the HF processor's apply_chat_template."""
        vc = self.model.cfg.vision
        patches = grid = ts = None
        if video_path and os.path.exists(video_path):
            short = self.cfg.target_short_side
            # the reference's pixel budget of the feature pass: 480..1920 pixels
            min_px, max_px = (480, 1920) if feature_extraction else (short * short,
                                                                     short * short * 4)
            patches, grid, ts = preprocess_video_timestamps(
                video_path, patch_size=vc.patch_size, temporal_patch_size=vc.temporal_patch_size,
                merge_size=vc.spatial_merge_size, nframes=self.cfg.video_nframes,
                min_pixels=min_px, max_pixels=max_px, device=self.model.device)
            patches = torch.from_numpy(patches).to(self.model.device)
        ids = build_chat_ids(self.tokenizer, user_text, system_prompt=system_prompt, grid=grid,
                             timestamps=ts, merge_size=vc.spatial_merge_size, is_video=True)
        return ids, patches, grid

    def _generate_native(self, user_text: str, system_prompt: Optional[str],
                         video_path: Optional[str] = None) -> str:
        ids, patches, grid = self._native_inputs(user_text, system_prompt, video_path)
        toks = qwen3vl_greedy_decode(self.model, ids, patches, grid,
                                     max_new_tokens=self.cfg.max_new_tokens,
                                     eos_token_id=self._eos, temperature=self.cfg.temperature)
        toks = [int(t) for t in toks.tolist() if t != self._eos]
        return self.tokenizer.decode(toks, skip_special_tokens=True).strip()

    def _generate(self, messages) -> str:
        """Chat generation over the reference's message structure (system +
        user [video | text ...])."""
        system_prompt, user_text, video = None, "", None
        for msg in messages:
            content = msg.get("content", [])
            if isinstance(content, str):
                content = [{"type": "text", "text": content}]
            for ele in content:
                if msg.get("role") == "system" and ele.get("type") == "text":
                    system_prompt = ele["text"]
                elif ele.get("type") == "text":
                    user_text += ele["text"]
                elif ele.get("type") == "video":
                    video = ele.get("video")
                elif ele.get("type") == "image":
                    raise NotImplementedError(
                        "image inputs of the Qwen3-VL engine wait for ROADMAP §1 item 4")
        return self._generate_native(user_text, system_prompt, video)

    # -- public flows (vllm_model.py of the reference) -----------------------

    def generate_source_video_caption(
        self, video_path: str, system_prompt: str = P.SOURCE_CAPTION_SYSTEM_PROMPT
    ) -> str:
        """A detailed caption of the source video (vllm_model.py:110-203)."""
        if not video_path or not os.path.exists(video_path):
            return ""
        ask = "Please provide a detailed, fine-grained caption for this video."
        with self._timed("source_caption_s"):
            return self._generate_native(ask, system_prompt, video_path)

    def predict_target_video_caption(
        self, source_video_caption: str, edit_prompt: str,
        system_prompt: str = P.TARGET_CAPTION_SYSTEM_PROMPT,
    ) -> str:
        """The target caption: the V2V edit-aware rewrite, or the T2V prompt
        expansion without a source caption (vllm_model.py:206-271)."""
        if source_video_caption:
            user_text = (
                f"Source video: {source_video_caption}\n\nEdit: {edit_prompt}\n\n"
                "Now directly describe the edited video (do not mention what "
                "was changed, just describe the final video):"
            )
        else:
            user_text = ("Expand this short prompt into a detailed, descriptive video "
                         f"caption: {edit_prompt}")
        with self._timed("target_caption_s"):
            return self._generate_native(user_text, system_prompt)

    def extract_features(
        self, source_video_path: Optional[str], edit_prompt: str,
        system_prompt: str = P.FEATURE_EXTRACTION_SYSTEM_PROMPT,
    ) -> Dict[str, Any]:
        """Last-hidden-state features, system prefix dropped, [L', D] f32 on
        the model's device (vllm_model.py:313-413)."""
        with self._timed("features_s"):
            drop_idx = compute_system_prompt_drop_idx(self.tokenizer, system_prompt)
            ids, patches, grid = self._native_inputs(edit_prompt, system_prompt,
                                                     source_video_path, feature_extraction=True)
            return extract_features(self.model, ids, patches, grid, drop_idx,
                                    source_video_path, edit_prompt)

    def generate_caption_and_extract_features(
        self, source_video_path: Optional[str], edit_prompt: str,
        source_caption_system_prompt: str = P.SOURCE_CAPTION_SYSTEM_PROMPT,
        target_caption_system_prompt: str = P.TARGET_CAPTION_SYSTEM_PROMPT,
        feature_system_prompt: str = P.FEATURE_EXTRACTION_SYSTEM_PROMPT,
    ) -> Dict[str, Any]:
        """Source caption → target caption → features (vllm_model.py:416-466)."""
        source_caption = (self.generate_source_video_caption(source_video_path,
                                                             source_caption_system_prompt)
                          if source_video_path else "")
        target_caption = self.predict_target_video_caption(source_caption, edit_prompt,
                                                           target_caption_system_prompt)
        feats = self.extract_features(source_video_path, edit_prompt, feature_system_prompt)
        feats["source_caption"] = source_caption
        feats["target_caption"] = target_caption
        return feats
