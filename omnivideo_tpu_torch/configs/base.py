"""Model / pipeline configuration dataclasses (port of
omnivideo_tpu/configs/base.py, without its jax.numpy dtype helper).

Field names and defaults equal the JAX package's, so a config can be built
from the other by `dataclasses.asdict`. The ported variants are T2V-1.3B,
the dual-expert T2V-A14B, the single-expert T2V-14B and the image-to-video
I2V-14B.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    """Wan video-DiT backbone hyperparameters."""

    model_type: str = "t2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    window_size: Tuple[int, int] = (-1, -1)
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    rope_max_seq_len: int = 1024
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        assert self.dim % self.num_heads == 0
        return self.dim // self.num_heads

    def replace(self, **kw) -> "WanDiTConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Wan2.1 causal 3D VAE hyperparameters."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    vae_stride: Tuple[int, int, int] = (4, 8, 8)

    @property
    def temperal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))


@dataclasses.dataclass(frozen=True)
class T5Config:
    """umT5-XXL encoder hyperparameters (per-layer relative position
    embeddings: shared_pos False)."""

    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False
    rel_max_dist: int = 128
    text_len: int = 512


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end x2x pipeline configuration, with the checkpoint file names
    of the reference layout (pipelines/loading.py)."""

    name: str = "t2v-1.3B"
    dit: WanDiTConfig = WanDiTConfig()
    vae: VAEConfig = VAEConfig()
    t5: T5Config = T5Config()

    num_train_timesteps: int = 1000
    sample_fps: int = 16
    frame_num: int = 81
    sample_shift: float = 12.0
    sample_steps: int = 40
    boundary: float = 0.875
    sample_guide_scale: Tuple[float, float] = (3.0, 4.0)  # (low-noise, high-noise)
    dual_expert: bool = False

    use_visual_context_adapter: bool = True
    visual_context_adapter_patch_size: Tuple[int, int, int] = (1, 4, 4)
    condition_mode: str = "full"
    vlm_in_dim: int = 2048
    max_context_len: int = 6144

    param_dtype: str = "bfloat16"

    t5_checkpoint: str = "models_t5_umt5-xxl-enc-bf16.pth"
    t5_tokenizer: str = "google/umt5-xxl"
    vae_checkpoint: str = "Wan2.1_VAE.pth"
    low_noise_checkpoint: str = "low_noise_model"
    high_noise_checkpoint: str = "high_noise_model"

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


T2V_1_3B = PipelineConfig(
    name="t2v-1.3B",
    dit=WanDiTConfig(
        patch_size=(1, 2, 2),
        dim=1536,
        ffn_dim=8960,
        freq_dim=256,
        num_heads=12,
        num_layers=30,
        qk_norm=True,
        cross_attn_norm=True,
        eps=1e-6,
    ),
    dual_expert=False,
    max_context_len=6272,
)

# vanilla Wan2.1 14B: single expert, text-only conditioning
T2V_14B = PipelineConfig(
    name="t2v-14B",
    dit=WanDiTConfig(
        patch_size=(1, 2, 2),
        dim=5120,
        ffn_dim=13824,
        freq_dim=256,
        num_heads=40,
        num_layers=40,
        qk_norm=True,
        cross_attn_norm=True,
        eps=1e-6,
    ),
    dual_expert=False,
    max_context_len=512,
)

# vanilla Wan2.1 i2v 14B: the first frame's latents and mask concatenated on
# the input channels (in_dim 36 = 16 noise + 4 mask + 16 latents) and the
# CLIP tokens' split cross-attention
I2V_14B = PipelineConfig(
    name="i2v-14B",
    dit=WanDiTConfig(
        model_type="i2v",
        patch_size=(1, 2, 2),
        in_dim=36,
        dim=5120,
        ffn_dim=13824,
        freq_dim=256,
        num_heads=40,
        num_layers=40,
        qk_norm=True,
        cross_attn_norm=True,
        eps=1e-6,
    ),
    dual_expert=False,
    max_context_len=512,
)

# Omni-Video 2: high- and low-noise experts of the 14B width
T2V_A14B = PipelineConfig(
    name="t2v-A14B",
    dit=WanDiTConfig(
        patch_size=(1, 2, 2),
        dim=5120,
        ffn_dim=13824,
        freq_dim=256,
        num_heads=40,
        num_layers=40,
        qk_norm=True,
        cross_attn_norm=True,
        eps=1e-6,
    ),
    dual_expert=True,
    max_context_len=6144,
)
