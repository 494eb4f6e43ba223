from .jax_bridge import (
    load_qwen3vl,
    load_t5,
    load_unified,
    load_wan_state_dict,
    pipeline_from_jax,
    qwen3vl_params_to_state_dict,
    t5_params_to_state_dict,
    to_torch,
    unified_params_to_state_dict,
    wan_params_to_state_dict,
)
from .torch_convert import (
    load_torch_file,
    split_unified_state_dict,
    unified_companions_to_params,
    unwrap_state_dict,
    wan_state_dict_to_params,
)

__all__ = ["load_qwen3vl", "load_t5", "load_torch_file", "load_unified", "load_wan_state_dict",
           "pipeline_from_jax", "qwen3vl_params_to_state_dict", "split_unified_state_dict",
           "t5_params_to_state_dict", "to_torch", "unified_companions_to_params",
           "unified_params_to_state_dict", "unwrap_state_dict", "wan_params_to_state_dict",
           "wan_state_dict_to_params"]
