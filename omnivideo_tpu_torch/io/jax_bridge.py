"""Weight bridge into the port's modules.

Two sources:
- the JAX package's param pytrees, given as nested dicts of numpy arrays
  (`wan_params_to_state_dict` turns a DiT pytree into reference-named
  arrays: `_dense` kernels [in, out] become Linear weights [out, in], the
  stacked `blocks` leaves [n_layers, ...] are split per layer);
- the reference PyTorch state dicts stored in the golden fixtures
  (`sd::` keys of tests/golden/*.npz).

`load_wan_state_dict` copies reference-named arrays into a WanDiT, reshaping
where only the layout differs (the Conv3d patch embedding, the modulation
tables) and casting to each parameter's dtype — the module already holds
cast_wan_params' split (modulation, norms and head f32; the rest the param
dtype). Companion and VAE params keep the JAX dict layout and map as they
are. `unified_params_to_state_dict` / `load_unified` map the training tree
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

from ..configs.base import VAEConfig
from ..models.qwen3vl.full_model import Qwen3VLModel
from ..models.vae2_1 import decoder_plan
from ..models.wan_dit import WanDiT


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


def unwrap_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip DDP/engine wrappers: 'module' / 'model' keys and prefixes."""
    for key in ("module", "model"):
        if key in sd and isinstance(sd[key], Mapping):
            sd = sd[key]
    out = {}
    for k, v in sd.items():
        for pref in ("module.", "model."):
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = v
    return out


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
    return _load_strict(model, unwrap_state_dict(sd))


@torch.no_grad()
def _load_strict(model: nn.Module, sd: Mapping[str, Any]) -> nn.Module:
    """Copy arrays into the parameters of the same names, reshaping where
    only the layout differs and casting to each parameter's dtype."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(sd))
    unexpected = sorted(set(sd) - set(params))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    for name, p in params.items():
        src = torch.from_numpy(np.array(_np(sd[name])))  # owned copy
        if src.numel() != p.numel():
            raise ValueError(f"{name}: {tuple(src.shape)} does not fit {tuple(p.shape)}")
        p.copy_(src.reshape(p.shape))
    return model


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
    return _load_strict(model, sd)


def split_unified_state_dict(sd: Mapping[str, Any]):
    """A unified checkpoint → (wan_sd, companion_sd)."""
    sd = unwrap_state_dict(sd)
    wan = {k[len("wan_model."):]: v for k, v in sd.items() if k.startswith("wan_model.")}
    comp = {k: v for k, v in sd.items() if not k.startswith("wan_model.")}
    return wan, comp


def companions_from_state_dict(sd: Mapping[str, Any], device=None):
    """vlm_norm / vlm_proj / visual_context_adapter from reference names,
    into the JAX dict layout (kernels [in, out])."""
    sd = unwrap_state_dict(sd)

    def lin(prefix):
        return {"kernel": _np(sd[f"{prefix}.weight"]).T, "bias": _np(sd[f"{prefix}.bias"])}

    out: Dict[str, Any] = {}
    if "vlm_norm.weight" in sd:
        out["vlm_norm"] = _np(sd["vlm_norm.weight"])
    if "vlm_proj.weight" in sd:
        out["vlm_proj"] = lin("vlm_proj")
    if "visual_context_adapter.patch_embedding.weight" in sd:
        w = _np(sd["visual_context_adapter.patch_embedding.weight"])
        out["visual_context_adapter"] = {
            "patch_embedding": {
                "kernel": w.reshape(w.shape[0], -1).T,
                "bias": _np(sd["visual_context_adapter.patch_embedding.bias"])},
            "projection": lin("visual_context_adapter.projection"),
        }
    return to_torch(out, device)


def vae_decoder_from_state_dict(sd: Mapping[str, Any], cfg: VAEConfig, device=None):
    """Reference Wan2.1 VAE state dict → the decoder params (+ conv2)."""
    g = lambda k: _np(sd[k])  # noqa: E731

    def conv(prefix):
        return {"weight": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    def res(prefix, has_shortcut):
        p = {"norm1": g(f"{prefix}.residual.0.gamma").reshape(-1),
             "conv1": conv(f"{prefix}.residual.2"),
             "norm2": g(f"{prefix}.residual.3.gamma").reshape(-1),
             "conv2": conv(f"{prefix}.residual.6")}
        if has_shortcut:
            p["shortcut"] = conv(f"{prefix}.shortcut")
        return p

    def attn(prefix):
        return {"norm": g(f"{prefix}.norm.gamma").reshape(-1),
                "qkv_w": g(f"{prefix}.to_qkv.weight"), "qkv_b": g(f"{prefix}.to_qkv.bias"),
                "proj_w": g(f"{prefix}.proj.weight"), "proj_b": g(f"{prefix}.proj.bias")}

    def resample(prefix, kind):
        c = conv(f"{prefix}.resample.1")
        p = {"conv_w": c["weight"], "conv_b": c["bias"]}
        if kind == "up3d":
            t = conv(f"{prefix}.time_conv")
            p["time_w"], p["time_b"] = t["weight"], t["bias"]
        return p

    dec = {
        "conv1": conv("decoder.conv1"),
        "mid0": res("decoder.middle.0", False),
        "mid_attn": attn("decoder.middle.1"),
        "mid1": res("decoder.middle.2", False),
        "head": {"norm": g("decoder.head.0.gamma").reshape(-1), "conv": conv("decoder.head.2")},
        "up": {},
    }
    for i, (kind, din, dout) in enumerate(decoder_plan(cfg)):
        pref = f"decoder.upsamples.{i}"
        dec["up"][f"u{i}"] = (res(pref, din != dout) if kind == "res"
                              else attn(pref) if kind == "attn" else resample(pref, kind))
    return to_torch({"decoder": dec, "conv2": conv("conv2")}, device)


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
    return _load_strict(model, sd)
