"""A tiny seeded Qwen3-VL shared by the port's Qwen3-VL CPU tests: one
HF-named numpy state dict → the JAX package's params (qwen3vl_hf_to_params)
and the port's model (io/jax_bridge.py), so no `transformers` is needed.
The inputs follow tests/test_qwen3vl_full.py: per-frame video segments
between text."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnivideo_tpu.models.qwen3vl.full_model import Qwen3VLConfig as JConfig
from omnivideo_tpu.models.qwen3vl.full_model import qwen3vl_hf_to_params
from omnivideo_tpu.models.qwen3vl.text_model import Qwen3TextConfig as JText
from omnivideo_tpu.models.qwen3vl.vision_model import Qwen3VLVisionConfig as JVision
from omnivideo_tpu_torch.configs.qwen3vl import (
    Qwen3TextConfig,
    Qwen3VLConfig,
    Qwen3VLVisionConfig,
)
from omnivideo_tpu_torch.io.jax_bridge import load_qwen3vl, qwen3vl_params_to_state_dict
from omnivideo_tpu_torch.models.qwen3vl.full_model import Qwen3VLModel
from omnivideo_tpu_torch.models.qwen3vl.preprocess import video_prompt_ids

VSTART, VEND, VPAD = 150, 153, 152


def tiny_config(moe: bool = True, rope_dtype: str = "float32") -> Qwen3VLConfig:
    return Qwen3VLConfig(
        text=Qwen3TextConfig(
            vocab_size=160, hidden_size=48, intermediate_size=96, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
            num_experts=8 if moe else None, num_experts_per_tok=2, moe_intermediate_size=24),
        vision=Qwen3VLVisionConfig(
            hidden_size=32, intermediate_size=64, depth=3, num_heads=4, patch_size=4,
            temporal_patch_size=2, spatial_merge_size=2, out_hidden_size=48,
            num_position_embeddings=36, deepstack_visual_indexes=(0, 1), rope_dtype=rope_dtype),
        mrope_section=(2, 3, 3), video_token_id=VPAD, image_token_id=151,
        vision_start_token_id=VSTART)


def jax_config(cfg: Qwen3VLConfig, attn_impl: str = "dense", moe_impl: str = "ragged") -> JConfig:
    return JConfig(
        text=JText(**dataclasses.asdict(cfg.text), attn_impl=attn_impl, moe_impl=moe_impl),
        vision=JVision(**dataclasses.asdict(cfg.vision), attn_impl=attn_impl),
        mrope_section=cfg.mrope_section, video_token_id=cfg.video_token_id,
        image_token_id=cfg.image_token_id, vision_start_token_id=cfg.vision_start_token_id)


def hf_state_dict(cfg: Qwen3VLConfig, seed: int = 0):
    """Seeded HF Qwen3VLForConditionalGeneration-named numpy f32 arrays:
    weights ~ N(0, 1/fan_in), norm gains 1 ± 0.1, biases ± 0.1."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)

    def small(*shape, base=0.0):
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    sd = {}
    v, t = cfg.vision, cfg.text
    D, u = v.hidden_size, v.hidden_size * v.spatial_merge_size**2
    pv = "model.visual."
    sd[pv + "patch_embed.proj.weight"] = w(D, v.in_channels, v.temporal_patch_size,
                                           v.patch_size, v.patch_size) * 4.0
    sd[pv + "patch_embed.proj.bias"] = small(D)
    sd[pv + "pos_embed.weight"] = small(v.num_position_embeddings, D) * 5
    for i in range(v.depth):
        p = f"{pv}blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = small(D, base=1.0), small(D)
        for name, (o, i_) in (("attn.qkv", (3 * D, D)), ("attn.proj", (D, D)),
                              ("mlp.linear_fc1", (v.intermediate_size, D)),
                              ("mlp.linear_fc2", (D, v.intermediate_size))):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(o, i_), small(o)
    for pre, norm_dim in [("merger.", D)] + [(f"deepstack_merger_list.{j}.", u) for j in
                                             range(len(v.deepstack_visual_indexes))]:
        sd[pv + pre + "norm.weight"], sd[pv + pre + "norm.bias"] = small(norm_dim, base=1.0), small(norm_dim)
        sd[pv + pre + "linear_fc1.weight"], sd[pv + pre + "linear_fc1.bias"] = w(u, u), small(u)
        sd[pv + pre + "linear_fc2.weight"] = w(v.out_hidden_size, u)
        sd[pv + pre + "linear_fc2.bias"] = small(v.out_hidden_size)

    pt = "model.language_model."
    H, N, K, hd = t.hidden_size, t.num_attention_heads, t.num_key_value_heads, t.head_dim
    sd[pt + "embed_tokens.weight"] = rng.standard_normal((t.vocab_size, H)).astype(np.float32)
    sd[pt + "norm.weight"] = small(H, base=1.0)
    sd["lm_head.weight"] = w(t.vocab_size, H)
    for i in range(t.num_hidden_layers):
        p = f"{pt}layers.{i}."
        sd[p + "input_layernorm.weight"] = small(H, base=1.0)
        sd[p + "post_attention_layernorm.weight"] = small(H, base=1.0)
        sd[p + "self_attn.q_proj.weight"] = w(N * hd, H)
        sd[p + "self_attn.k_proj.weight"] = w(K * hd, H)
        sd[p + "self_attn.v_proj.weight"] = w(K * hd, H)
        sd[p + "self_attn.o_proj.weight"] = w(H, N * hd)
        sd[p + "self_attn.q_norm.weight"] = small(hd, base=1.0)
        sd[p + "self_attn.k_norm.weight"] = small(hd, base=1.0)
        if t.num_experts:
            M = t.moe_intermediate_size
            sd[p + "mlp.gate.weight"] = w(t.num_experts, H) * 4.0
            for e in range(t.num_experts):
                sd[p + f"mlp.experts.{e}.gate_proj.weight"] = w(M, H)
                sd[p + f"mlp.experts.{e}.up_proj.weight"] = w(M, H)
                sd[p + f"mlp.experts.{e}.down_proj.weight"] = w(H, M)
        else:
            M = t.intermediate_size
            sd[p + "mlp.gate_proj.weight"] = w(M, H)
            sd[p + "mlp.up_proj.weight"] = w(M, H)
            sd[p + "mlp.down_proj.weight"] = w(H, M)
    return sd


def build(cfg: Qwen3VLConfig, dtype=torch.float32, seed: int = 0, attn_impl: str = "dense"):
    """(JAX params, JAX config, port model on the CPU) with the same weights;
    at bf16 the JAX params are rounded first and the port loads the rounded
    values."""
    jcfg = jax_config(cfg, attn_impl)
    params = qwen3vl_hf_to_params(hf_state_dict(cfg, seed), jcfg)
    if dtype == torch.bfloat16:
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    model = Qwen3VLModel(cfg, dtype, device="cpu")
    load_qwen3vl(model, qwen3vl_params_to_state_dict(params))
    return params, jcfg, model


def video_inputs(cfg: Qwen3VLConfig, grid=(2, 4, 4), seed: int = 1):
    """(ids [1, L] int64, patches [t·h·w, C·tp·p·p] f32, grid)."""
    rng = np.random.default_rng(seed)
    ids = video_prompt_ids([5, 6, 7], [8, 9, 10, 11], grid, cfg, vision_end_token_id=VEND)
    patches = rng.standard_normal((int(np.prod(grid)), cfg.vision.patch_dim)).astype(np.float32)
    return ids, patches, grid


def scale_err(out, ref) -> float:
    """max |out − ref| / max |ref|."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())
