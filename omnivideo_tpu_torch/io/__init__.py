from .jax_bridge import (
    companions_from_state_dict,
    load_qwen3vl,
    load_unified,
    load_wan_state_dict,
    qwen3vl_params_to_state_dict,
    split_unified_state_dict,
    to_torch,
    unified_params_to_state_dict,
    vae_decoder_from_state_dict,
    wan_params_to_state_dict,
)

__all__ = ["companions_from_state_dict", "load_qwen3vl", "load_unified",
           "load_wan_state_dict", "qwen3vl_params_to_state_dict", "split_unified_state_dict",
           "to_torch", "unified_params_to_state_dict", "vae_decoder_from_state_dict",
           "wan_params_to_state_dict"]
