from .base import (
    I2V_14B,
    T2V_1_3B,
    T2V_14B,
    T2V_A14B,
    PipelineConfig,
    T5Config,
    VAEConfig,
    WanDiTConfig,
)

# the x2x pipeline serves t2v and v2v-edit from the same configs; i2v-14B is
# pipelines/i2v.py's (the generate CLI has no i2v path, as in JAX)
WAN_CONFIGS = {
    "t2v-A14B": T2V_A14B,
    "t2v-1.3B": T2V_1_3B,
    "v2v-A14B": T2V_A14B,
    "v2v-1.3B": T2V_1_3B,
    "t2v-14B": T2V_14B,
    "i2v-14B": I2V_14B,
    "t2i-1.3B": T2V_1_3B,
}

SIZE_CONFIGS = {
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
}

MAX_AREA_CONFIGS = {
    "720*1280": 720 * 1280,
    "1280*720": 1280 * 720,
    "480*832": 480 * 832,
    "832*480": 832 * 480,
}

SUPPORTED_SIZES = {
    "t2v-A14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2v-1.3B": ("480*832", "832*480"),
    "v2v-A14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "v2v-1.3B": ("480*832", "832*480"),
    "t2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2i-1.3B": ("480*832", "832*480"),
}

__all__ = ["I2V_14B", "T2V_1_3B", "T2V_14B", "T2V_A14B", "PipelineConfig", "T5Config",
           "VAEConfig", "WanDiTConfig", "WAN_CONFIGS", "SIZE_CONFIGS", "MAX_AREA_CONFIGS",
           "SUPPORTED_SIZES"]
