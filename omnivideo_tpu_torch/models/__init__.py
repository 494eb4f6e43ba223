from .unified import (
    Companions,
    build_mixed_context,
    build_mixed_context_batch,
    init_unified_companions,
    null_ar_vision,
)
from .vae2_1 import Wan21VAE, init_vae, vae_decode
from .wan_dit import WanDiT

__all__ = ["Companions", "build_mixed_context", "build_mixed_context_batch",
           "init_unified_companions", "null_ar_vision",
           "Wan21VAE", "init_vae", "vae_decode", "WanDiT"]
