"""Model / pipeline configuration dataclasses (port of
omnivideo_tpu/configs/base.py, without its jax.numpy dtype helper).

Field names and defaults equal the JAX package's, so a config can be built
from the other by `dataclasses.asdict`. Only the T2V-1.3B variant is on this
slice's path.
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
class PipelineConfig:
    """End-to-end x2x pipeline configuration (the fields the generate path
    reads; the umT5 checkpoint names wait for the text-encoder slice)."""

    name: str = "t2v-1.3B"
    dit: WanDiTConfig = WanDiTConfig()
    vae: VAEConfig = VAEConfig()

    num_train_timesteps: int = 1000
    sample_fps: int = 16
    frame_num: int = 81
    sample_shift: float = 12.0
    sample_steps: int = 40
    boundary: float = 0.875
    sample_guide_scale: Tuple[float, float] = (3.0, 4.0)
    dual_expert: bool = False

    use_visual_context_adapter: bool = True
    visual_context_adapter_patch_size: Tuple[int, int, int] = (1, 4, 4)
    condition_mode: str = "full"
    vlm_in_dim: int = 2048
    max_context_len: int = 6144

    param_dtype: str = "bfloat16"

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
