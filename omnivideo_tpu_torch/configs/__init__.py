from .base import T2V_1_3B, T2V_14B, T2V_A14B, PipelineConfig, T5Config, VAEConfig, WanDiTConfig

# the x2x pipeline serves t2v and v2v-edit from the same configs
WAN_CONFIGS = {
    "t2v-A14B": T2V_A14B,
    "t2v-1.3B": T2V_1_3B,
    "v2v-A14B": T2V_A14B,
    "v2v-1.3B": T2V_1_3B,
    "t2v-14B": T2V_14B,
    "t2i-1.3B": T2V_1_3B,
}

SIZE_CONFIGS = {
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
}

__all__ = ["T2V_1_3B", "T2V_14B", "T2V_A14B", "PipelineConfig", "T5Config", "VAEConfig",
           "WanDiTConfig", "WAN_CONFIGS", "SIZE_CONFIGS"]
