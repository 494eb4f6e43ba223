"""HuggingFace checkpoint directories without HF model classes (port of
omnivideo_tpu/io/hf_reader.py, plus the config and weight mapping of
omnivideo_tpu/models/qwen3vl/{engine.py `jax_cfg_from_dict`, full_model.py
`qwen3vl_hf_to_params`}).

- `iter_hf_safetensors` / `load_hf_safetensors` read every `*.safetensors`
  shard of a dir (through `model.safetensors.index.json` when there is one)
  with io/safetensors.py, each tensor copied once to its device;
- `load_hf_config`, `qwen3_text_config_from_hf` and `qwen3vl_config_from_hf`
  turn `config.json` into the port's configs;
- `load_qwen3vl_hf` streams HF-named tensors into a `Qwen3VLModel`, one at
  a time, so loading needs the model's memory and one tensor more: the
  vision patch embedding's Conv3d weight flattened, the MoE experts stacked
  into the port's [E, D, M] / [E, M, D] tensors from either HF layout
  (per-expert `experts.<e>.{gate,up,down}_proj.weight`, or the fused
  `experts.gate_up_proj` [E, D, 2M] and `experts.down_proj` [E, M, D] of
  transformers' Qwen3-VL-MoE), and `lm_head` taken from the embedding when
  the checkpoint ties them (as the JAX conversion does);
- `FastTokenizer` reads `tokenizer.json` with the `tokenizers` package,
  imported when one is built.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from ..configs.qwen3vl import Qwen3TextConfig, Qwen3VLConfig, Qwen3VLVisionConfig
from ..models.qwen3vl.full_model import Qwen3VLModel
from .safetensors import DTYPES, iter_safetensors, read_header


def _shard_files(model_dir: str) -> List[Path]:
    d = Path(model_dir)
    index = d / "model.safetensors.index.json"
    if index.exists():
        files = sorted({d / f for f in json.loads(index.read_text())["weight_map"].values()})
    else:
        files = sorted(d.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    return files


def iter_hf_safetensors(model_dir: str, prefix_filter: Optional[str] = None, device="cuda"
                        ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor on `device`) over every shard of a checkpoint dir."""
    for f in _shard_files(model_dir):
        yield from iter_safetensors(f, device, prefix_filter)


def load_hf_safetensors(model_dir: str, prefix_filter: Optional[str] = None, device="cuda"
                        ) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint dir (names starting with `prefix_filter`,
    e.g. "model.language_model.", if given) on `device`."""
    return dict(iter_hf_safetensors(model_dir, prefix_filter, device))


def checkpoint_dtype(model_dir: str) -> torch.dtype:
    """The dtype a checkpoint stores its weights in: that of the text
    embedding (or of the first floating tensor) in the first shard's
    header."""
    entries, _, _ = read_header(_shard_files(model_dir)[0])
    floating = [e["dtype"] for e in entries.values() if DTYPES[e["dtype"]].is_floating_point]
    for name, e in entries.items():
        if name.endswith("embed_tokens.weight"):
            return DTYPES[e["dtype"]]
    if not floating:
        raise ValueError(f"{model_dir}: no floating tensors in its first shard")
    return DTYPES[floating[0]]


def load_hf_config(model_dir: str) -> dict:
    return json.loads((Path(model_dir) / "config.json").read_text())


def _text_config(tc: dict) -> Qwen3TextConfig:
    return Qwen3TextConfig(
        vocab_size=tc["vocab_size"],
        hidden_size=tc["hidden_size"],
        intermediate_size=tc.get("intermediate_size", 0),
        num_hidden_layers=tc["num_hidden_layers"],
        num_attention_heads=tc["num_attention_heads"],
        num_key_value_heads=tc["num_key_value_heads"],
        head_dim=tc.get("head_dim", tc["hidden_size"] // tc["num_attention_heads"]),
        rope_theta=tc.get("rope_theta", 1e6),
        rms_norm_eps=tc.get("rms_norm_eps", 1e-6),
        num_experts=tc.get("num_experts"),
        num_experts_per_tok=tc.get("num_experts_per_tok", 8),
        moe_intermediate_size=tc.get("moe_intermediate_size", 768),
        norm_topk_prob=tc.get("norm_topk_prob", True),
    )


def qwen3_text_config_from_hf(model_dir: str) -> Qwen3TextConfig:
    """A plain Qwen3/Qwen3-MoE config.json, or the text_config of a
    Qwen3-VL one, as the port's Qwen3TextConfig."""
    cfg = load_hf_config(model_dir)
    tc = cfg.get("text_config", cfg)
    return dataclasses.replace(_text_config(tc),
                               tie_word_embeddings=tc.get("tie_word_embeddings", False))


def qwen3vl_config_from_hf(d: dict, vision_rope_dtype: str = "float32") -> Qwen3VLConfig:
    """A Qwen3-VL checkpoint's config.json dict → Qwen3VLConfig (the JAX
    engine's `jax_cfg_from_dict`: lm_head is never tied, the vision tower's
    activation is the config default)."""
    tc, vc = d["text_config"], d["vision_config"]
    rope_scaling = tc.get("rope_scaling") or {}
    return Qwen3VLConfig(
        text=_text_config(tc),
        vision=Qwen3VLVisionConfig(
            hidden_size=vc["hidden_size"],
            intermediate_size=vc["intermediate_size"],
            depth=vc["depth"],
            num_heads=vc["num_heads"],
            in_channels=vc.get("in_channels", 3),
            patch_size=vc["patch_size"],
            temporal_patch_size=vc["temporal_patch_size"],
            spatial_merge_size=vc["spatial_merge_size"],
            out_hidden_size=vc["out_hidden_size"],
            num_position_embeddings=vc["num_position_embeddings"],
            deepstack_visual_indexes=tuple(vc["deepstack_visual_indexes"]),
            rope_dtype=vision_rope_dtype,
        ),
        mrope_section=tuple(rope_scaling.get("mrope_section", (24, 20, 20))),
        video_token_id=d.get("video_token_id", 151656),
        image_token_id=d.get("image_token_id", 151655),
        vision_start_token_id=d.get("vision_start_token_id", 151652),
    )


_EXPERT = r"(language_model\.layers\.\d+\.mlp\.)experts\.(\d+)\.(gate|up|down)_proj\.weight$"
_FUSED = r"(language_model\.layers\.\d+\.mlp\.)experts\.(gate_up|down)_proj$"


@torch.no_grad()
def load_qwen3vl_hf(model: Qwen3VLModel, items: Iterable[Tuple[str, torch.Tensor]]
                    ) -> Qwen3VLModel:
    """Copy HF Qwen3VLForConditionalGeneration-named tensors into `model`,
    casting to each parameter's dtype. Every parameter must be filled and
    every name used (KeyError otherwise)."""
    params = dict(model.named_parameters())
    filled = {name: 0 for name in params}

    def put(name: str, src: torch.Tensor, index=None) -> None:
        if name not in params:
            raise KeyError(f"checkpoint tensor for {name!r}, which the model does not have")
        dst = params[name] if index is None else params[name][index]
        if src.numel() != dst.numel():
            raise ValueError(f"{name}: {tuple(src.shape)} does not fit {tuple(dst.shape)}")
        dst.copy_(src.reshape(dst.shape))
        filled[name] += dst.numel()

    for key, src in items:
        if key.startswith("model."):
            key = key[len("model."):]
        if key == "visual.patch_embed.proj.weight":
            put("visual.patch_embed.weight", src.reshape(src.shape[0], -1))
        elif key == "visual.patch_embed.proj.bias":
            put("visual.patch_embed.bias", src)
        elif m := re.match(_EXPERT, key):
            put(f"{m[1]}experts_{m[3]}", src.T, int(m[2]))
        elif m := re.match(_FUSED, key):
            if m[2] == "down":
                put(f"{m[1]}experts_down", src)
            else:
                half = src.shape[-1] // 2
                put(f"{m[1]}experts_gate", src[..., :half])
                put(f"{m[1]}experts_up", src[..., half:])
        else:
            put(key, src)
    if "lm_head.weight" in params and not filled["lm_head.weight"]:
        put("lm_head.weight", params["language_model.embed_tokens.weight"])
    missing = sorted(n for n, p in params.items() if filled[n] != p.numel())
    if missing:
        raise KeyError(f"checkpoint leaves parameters unfilled: {missing[:8]}")
    return model


class FastTokenizer:
    """The tokenizer of a checkpoint dir's `tokenizer.json`, over the
    `tokenizers` package only (imported here, when one is built). The API
    the engine uses: __call__(text, add_special_tokens)["input_ids"],
    decode(ids, skip_special_tokens), eos_token_id (from
    tokenizer_config.json's eos_token)."""

    def __init__(self, model_dir: str):
        from tokenizers import Tokenizer

        d = Path(model_dir)
        self._tk = Tokenizer.from_file(str(d / "tokenizer.json"))
        self.eos_token_id = None
        tc = d / "tokenizer_config.json"
        if tc.exists():
            eos = json.loads(tc.read_text()).get("eos_token")
            if isinstance(eos, dict):
                eos = eos.get("content")
            if eos is not None:
                self.eos_token_id = self._tk.token_to_id(eos)

    def __call__(self, text: str, add_special_tokens: bool = True):
        return {"input_ids": self._tk.encode(text, add_special_tokens=add_special_tokens).ids}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tk.decode([int(i) for i in ids], skip_special_tokens=skip_special_tokens)

