from .base import T2V_1_3B, PipelineConfig, VAEConfig, WanDiTConfig

__all__ = ["T2V_1_3B", "PipelineConfig", "VAEConfig", "WanDiTConfig"]
