"""Weight bridge from the JAX package's param pytrees (nested dicts of
numpy arrays) into the port's modules; the parity tests use it. The
reference PyTorch state dicts (the golden fixtures' `sd::` keys, the
checkpoint files) map through `io/torch_convert.py`.

`wan_params_to_state_dict` turns a DiT pytree into reference-named arrays
(`_dense` kernels [in, out] become Linear weights [out, in], the stacked
`blocks` leaves [n_layers, ...] are split per layer); `load_wan_state_dict`
copies reference-named arrays into a WanDiT, reshaping where only the layout
differs (the Conv3d patch embedding, the modulation tables) and casting to
each parameter's dtype — the module already holds cast_wan_params' split
(modulation, norms and head f32; the rest the param dtype). Companion and
VAE params (encoder and decoder) keep the JAX dict layout and map as they
are (`to_torch`). `t5_params_to_state_dict` / `load_t5` carry the umT5
pytree (stacked `layers`), and `pipeline_from_jax` assembles an x2x pipeline
(one or two DiT trees, their companions, the VAE) from JAX pipeline parts. `unified_params_to_state_dict` / `load_unified` map the training tree
{'wan', 'companions'} (its params, gradients or updated params) to the
port's UnifiedParams names. `qwen3vl_params_to_state_dict` / `load_qwen3vl`
do the same for the Qwen3-VL param tree of `qwen3vl_hf_to_params` (scanned
`blocks`/`layers` stacks split per layer, `lm_head` and the deepstack
mergers carried).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from torch import nn

from ..configs.base import PipelineConfig
from ..device import resolve_device
from ..models.qwen3vl.full_model import Qwen3VLModel
from ..models.t5 import T5Encoder, t5_state_dict_to_params
from ..models.vae2_1 import Wan21VAE
from ..models.wan_dit import WanDiT
from ..pipelines.x2x import ExpertParams, OmniVideoX2XUnified
from .torch_convert import load_strict, unwrap_state_dict


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bf16
        a = a.astype(np.float32)
    return a


def to_torch(tree, device=None):
    """Nested dict of arrays → nested dict of tensors (owned copies)."""
    if isinstance(tree, Mapping):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(_np(tree).copy(), device=device)


def wan_params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """JAX DiT param pytree → reference-named arrays."""
    sd: Dict[str, np.ndarray] = {}

    def lin(name, p):
        sd[f"{name}.weight"] = _np(p["kernel"]).T
        sd[f"{name}.bias"] = _np(p["bias"])

    lin("patch_embedding", params["patch_embedding"])
    lin("text_embedding.0", params["text_embedding"]["fc1"])
    lin("text_embedding.2", params["text_embedding"]["fc2"])
    lin("time_embedding.0", params["time_embedding"]["fc1"])
    lin("time_embedding.2", params["time_embedding"]["fc2"])
    lin("time_projection.1", params["time_projection"])
    lin("head.head", params["head"]["head"])
    sd["head.modulation"] = _np(params["head"]["modulation"])
    blocks = params["blocks"]
    n_layers = _np(blocks["modulation"]).shape[0]
    for i in range(n_layers):
        p = f"blocks.{i}"
        sd[f"{p}.modulation"] = _np(blocks["modulation"])[i]
        for part in ("self_attn", "cross_attn"):
            a = blocks[part]
            for proj in ("q", "k", "v", "o"):
                sd[f"{p}.{part}.{proj}.weight"] = _np(a[proj]["kernel"])[i].T
                sd[f"{p}.{part}.{proj}.bias"] = _np(a[proj]["bias"])[i]
            sd[f"{p}.{part}.norm_q.weight"] = _np(a["norm_q"])[i]
            sd[f"{p}.{part}.norm_k.weight"] = _np(a["norm_k"])[i]
        sd[f"{p}.ffn.0.weight"] = _np(blocks["ffn"]["fc1"]["kernel"])[i].T
        sd[f"{p}.ffn.0.bias"] = _np(blocks["ffn"]["fc1"]["bias"])[i]
        sd[f"{p}.ffn.2.weight"] = _np(blocks["ffn"]["fc2"]["kernel"])[i].T
        sd[f"{p}.ffn.2.bias"] = _np(blocks["ffn"]["fc2"]["bias"])[i]
        if "norm3" in blocks:
            sd[f"{p}.norm3.weight"] = _np(blocks["norm3"]["scale"])[i]
            sd[f"{p}.norm3.bias"] = _np(blocks["norm3"]["bias"])[i]
    return sd


def load_wan_state_dict(model: WanDiT, sd: Mapping[str, Any]) -> WanDiT:
    """Copy a reference-named state dict into `model`; every parameter must
    be present and every key used."""
    return load_strict(model, unwrap_state_dict(sd))


def t5_params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """JAX umT5 pytree (`init_t5` / `t5_state_dict_to_params` layout:
    stacked `layers`, kernels [in, out]) → reference names."""
    sd = {"token_embedding.weight": _np(params["token_embedding"]),
          "norm.weight": _np(params["norm"])}
    lay = params["layers"]
    for i in range(_np(lay["norm1"]).shape[0]):
        p = f"blocks.{i}"
        sd[f"{p}.norm1.weight"] = _np(lay["norm1"])[i]
        sd[f"{p}.norm2.weight"] = _np(lay["norm2"])[i]
        for n in "qkvo":
            sd[f"{p}.attn.{n}.weight"] = _np(lay["attn"][n])[i].T
        sd[f"{p}.ffn.gate.0.weight"] = _np(lay["ffn"]["gate"])[i].T
        sd[f"{p}.ffn.fc1.weight"] = _np(lay["ffn"]["fc1"])[i].T
        sd[f"{p}.ffn.fc2.weight"] = _np(lay["ffn"]["fc2"])[i].T
        sd[f"{p}.pos_embedding.embedding.weight"] = _np(lay["pos_embedding"])[i]
    return sd


def load_t5(model: T5Encoder, params) -> T5Encoder:
    """Copy a JAX umT5 pytree into `model` (cast to its dtypes)."""
    return t5_state_dict_to_params(
        model, {k: torch.from_numpy(np.array(v)) for k, v in t5_params_to_state_dict(params).items()})


def pipeline_from_jax(config: PipelineConfig, low, high=None, vae_params=None, device="cuda",
                      **pipe_kwargs) -> OmniVideoX2XUnified:
    """An x2x pipeline from JAX pipeline parts: `low` / `high` expose `.wan`
    (a DiT pytree) and `.companions` (as the JAX ExpertParams); `high` None
    or the same object for a single expert; companions shared by the JAX
    experts stay shared; `vae_params` the JAX VAE dict (both halves)."""
    dev = resolve_device(device)
    dit_cfg = config.dit.replace(text_len=config.max_context_len)
    comps: Dict[int, Any] = {}

    def expert(e):
        dit = WanDiT(dit_cfg, dtype=config.torch_param_dtype, device=dev)
        load_wan_state_dict(dit, wan_params_to_state_dict(e.wan))
        cid = id(e.companions)
        if cid not in comps:
            comps[cid] = to_torch(e.companions, dev)
        return ExpertParams(wan=dit, companions=comps[cid])

    low_e = expert(low)
    high_e = low_e if high is None or high is low else expert(high)
    vae = None if vae_params is None else Wan21VAE.create(to_torch(vae_params, dev), config.vae)
    return OmniVideoX2XUnified(config, low_e, high_e, vae=vae, **pipe_kwargs)


def unified_params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """The JAX unified tree {'wan', 'companions'} (params, gradients or
    updated params) → the names of training.UnifiedParams: 'wan.' + the DiT's
    reference names, 'companions.' + the dotted dict path."""
    sd = {f"wan.{k}": v for k, v in wan_params_to_state_dict(params["wan"]).items()}

    def flat(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                flat(f"{prefix}.{k}", v)
            else:
                sd[f"{prefix}.{k}"] = _np(v)

    flat("companions", params["companions"])
    return sd


def load_unified(model: nn.Module, sd: Mapping[str, Any]) -> nn.Module:
    """Copy `unified_params_to_state_dict`'s arrays into a UnifiedParams;
    every parameter must be present and every key used."""
    return load_strict(model, sd)


def qwen3vl_params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """JAX Qwen3-VL param tree ({'vision', 'text'}, numpy or jax arrays) →
    the port's parameter names (HF names; Linear weights [out, in])."""
    sd: Dict[str, np.ndarray] = {}

    def lin(name, kernel, bias=None):
        sd[f"{name}.weight"] = _np(kernel).T
        if bias is not None:
            sd[f"{name}.bias"] = _np(bias)

    def norm(name, p):
        sd[f"{name}.weight"] = _np(p["weight"])
        sd[f"{name}.bias"] = _np(p["bias"])

    def merger(name, mp):
        norm(f"{name}.norm", mp["norm"])
        lin(f"{name}.linear_fc1", mp["fc1_w"], mp["fc1_b"])
        lin(f"{name}.linear_fc2", mp["fc2_w"], mp["fc2_b"])

    vis = params["vision"]
    lin("visual.patch_embed", vis["patch_embed"]["kernel"], vis["patch_embed"]["bias"])
    sd["visual.pos_embed.weight"] = _np(vis["pos_embed"])
    merger("visual.merger", vis["merger"])
    for j, mp in enumerate(vis["deepstack"]):
        merger(f"visual.deepstack_merger_list.{j}", mp)
    blocks = {k: (v if isinstance(v, Mapping) else _np(v)) for k, v in vis["blocks"].items()}
    for i in range(_np(blocks["qkv_w"]).shape[0]):
        p = f"visual.blocks.{i}"
        for n in ("norm1", "norm2"):
            norm(f"{p}.{n}", {k: _np(v)[i] for k, v in blocks[n].items()})
        lin(f"{p}.attn.qkv", blocks["qkv_w"][i], blocks["qkv_b"][i])
        lin(f"{p}.attn.proj", blocks["proj_w"][i], blocks["proj_b"][i])
        lin(f"{p}.mlp.linear_fc1", blocks["mlp_fc1_w"][i], blocks["mlp_fc1_b"][i])
        lin(f"{p}.mlp.linear_fc2", blocks["mlp_fc2_w"][i], blocks["mlp_fc2_b"][i])

    txt = params["text"]
    sd["language_model.embed_tokens.weight"] = _np(txt["embed"])
    sd["language_model.norm.weight"] = _np(txt["norm"])
    if "lm_head" in txt:
        lin("lm_head", txt["lm_head"])
    layers = txt["layers"]
    a, mlp = layers["attn"], layers["mlp"]
    for i in range(_np(layers["ln1"]).shape[0]):
        p = f"language_model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = _np(layers["ln1"])[i]
        sd[f"{p}.post_attention_layernorm.weight"] = _np(layers["ln2"])[i]
        for proj in ("q", "k", "v", "o"):
            lin(f"{p}.self_attn.{proj}_proj", _np(a[proj])[i])
        sd[f"{p}.self_attn.q_norm.weight"] = _np(a["q_norm"])[i]
        sd[f"{p}.self_attn.k_norm.weight"] = _np(a["k_norm"])[i]
        if "experts" in mlp:
            lin(f"{p}.mlp.gate", _np(mlp["gate"])[i])
            for part in ("gate", "up", "down"):
                sd[f"{p}.mlp.experts_{part}"] = _np(mlp["experts"][part])[i]
        else:
            for part in ("gate", "up", "down"):
                lin(f"{p}.mlp.{part}_proj", _np(mlp[part])[i])
    return sd


def load_qwen3vl(model: Qwen3VLModel, sd: Mapping[str, Any]) -> Qwen3VLModel:
    """Copy a port-named Qwen3-VL state dict (qwen3vl_params_to_state_dict)
    into `model`; every parameter must be present and every key used."""
    return load_strict(model, sd)
