"""Qwen3-VL configuration dataclasses (port of the configs in
omnivideo_tpu/models/qwen3vl/{text_model,vision_model,full_model}.py, whose
modules import jax).

Field names and defaults equal the JAX package's, so a config converts
with `dataclasses.asdict`. Dropped: the JAX dispatch knobs (`attn_impl`,
`moe_impl`, `attn_block_q`): the port always runs the flash kernel on CUDA
and its plain twin on the CPU, and the MoE as per-expert products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Qwen3TextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    # MoE (None → dense SwiGLU MLP)
    num_experts: Optional[int] = None
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = True


@dataclasses.dataclass(frozen=True)
class Qwen3VLVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    depth: int = 27
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 2048
    num_position_embeddings: int = 2304
    deepstack_visual_indexes: Tuple[int, ...] = (8, 16, 24)
    hidden_act: str = "gelu_pytorch_tanh"
    # dtype of the packed RoPE mix: "float32" is the parity mode (HF
    # computes the vision rope in f32); the JAX engine runs "bfloat16"
    # (VLMConfig.vision_rope_dtype)
    rope_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_grid_per_side(self) -> int:
        return int(self.num_position_embeddings**0.5)

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2


@dataclasses.dataclass(frozen=True)
class Qwen3VLConfig:
    text: Qwen3TextConfig
    vision: Qwen3VLVisionConfig
    mrope_section: Tuple[int, int, int] = (24, 20, 20)
    video_token_id: int = 151656
    image_token_id: int = 151655
    vision_start_token_id: int = 151652

    def replace(self, **kw) -> "Qwen3VLConfig":
        return dataclasses.replace(self, **kw)


# The chat and vision special tokens at their ids in the Qwen3-VL vocabulary
# (the checkpoints' tokenizer.json): the engine's prompts are built from them.
SPECIAL_TOKEN_IDS = {
    "<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
    "<|vision_start|>": 151652, "<|vision_end|>": 151653, "<|image_pad|>": 151655,
    "<|video_pad|>": 151656,
}


# Qwen3-VL-30B-A3B, the reference pipeline's VLM (omnivideo/vllm_model.py:30-31
# of the reference; the widths of bench.py:715-719): 48 MoE text layers of
# 128 experts (top-8), interleaved MRoPE (24, 20, 20), a 27-block vision
# tower of width 1152 with deepstack taps at blocks 8, 16 and 24. The vision
# rope runs in bf16, the JAX engine's default.
QWEN3_VL_30B_A3B = Qwen3VLConfig(
    text=Qwen3TextConfig(
        vocab_size=151936, hidden_size=2048, intermediate_size=6144,
        num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
        head_dim=128, num_experts=128, num_experts_per_tok=8,
        moe_intermediate_size=768, norm_topk_prob=True),
    vision=Qwen3VLVisionConfig(rope_dtype="bfloat16"),
    mrope_section=(24, 20, 20),
)
