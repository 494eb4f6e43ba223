"""Weight bridge from the JAX package's param pytrees (nested dicts of
numpy arrays) into the port's modules; the parity tests use it. The
reference PyTorch state dicts (the golden fixtures' `sd::` keys, the
checkpoint files) map through `io/torch_convert.py`.

`wan_params_to_state_dict` turns a DiT pytree (the i2v `img_emb` and
`k_img`/`v_img`/`norm_k_img` too) into reference-named arrays
(`_dense` kernels [in, out] become Linear weights [out, in], the stacked
`blocks` leaves [n_layers, ...] are split per layer); `load_wan_state_dict`
copies reference-named arrays into a WanDiT, reshaping where only the layout
differs (the Conv3d patch embedding, the modulation tables) and casting to
each parameter's dtype — the module already holds cast_wan_params' split
(modulation, norms and head f32; the rest the param dtype). Companion and
VAE params (encoder and decoder) keep the JAX dict layout and map as they
are (`to_torch`; VAE 2.2's too). `clip_params_to_state_dict` gives the CLIP
vision tower's reference names, `xlm_params_from_jax` splits XLM-Roberta's
stacked layers. `t5_params_to_state_dict` / `load_t5` carry the umT5
pytree (stacked `layers`), and `pipeline_from_jax` assembles an x2x pipeline
(one or two DiT trees, their companions, the VAE) from JAX pipeline parts. `unified_params_to_state_dict` / `load_unified` map the training tree
{'wan', 'companions'} (its params, gradients or updated params) to the
port's UnifiedParams names. `qwen3vl_params_to_state_dict` / `load_qwen3vl`
do the same for the Qwen3-VL param tree of `qwen3vl_hf_to_params` (scanned
`blocks`/`layers` stacks split per layer, `lm_head` and the deepstack
mergers carried; with `shard=(rank, n)` the expert banks are that rank's
columns, parallel/expert_shard.py), `qwen3_params_to_state_dict` for the
text-only Qwen3 tree. LoRA adapters (training/lora.py) ride along in both layouts: a dense
site's stacked `lora_a/lora_b/lora_scale` leaves and the bare `{name}_lora_*`
siblings become each layer's `<linear>.lora_a/.lora_b/.lora_scale` (JAX's
orientation kept), and the loaders attach the adapters they name.
`streamed_state_from_jax` carries JAX's StreamedTrainState /
StreamedLoRAState (host numpy blocks, optax AdamW moments, the step) into
the port's streamed trainer states (training/streaming.py).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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
from ..ops.lora import has_lora
from ..parallel.expert_shard import SPLIT_DIMS, ExpertShard
from ..training.lora import set_adapter
from .torch_convert import load_strict, unwrap_state_dict

_ADAPTER_KEYS = ("lora_a", "lora_b", "lora_scale")


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bf16
        a = a.astype(np.float32)
    return a


def to_torch(tree, device=None):
    """Nested dicts and lists of arrays → the same of tensors (owned copies)."""
    if isinstance(tree, Mapping):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    return torch.as_tensor(_np(tree).copy(), device=device)


def wan_params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """JAX DiT param pytree → reference-named arrays."""
    sd: Dict[str, np.ndarray] = {}

    def lin(name, p):
        sd[f"{name}.weight"] = _np(p["kernel"]).T
        sd[f"{name}.bias"] = _np(p["bias"])
        for k in _ADAPTER_KEYS:
            if k in p:
                sd[f"{name}.{k}"] = _np(p[k])

    lin("patch_embedding", params["patch_embedding"])
    lin("text_embedding.0", params["text_embedding"]["fc1"])
    lin("text_embedding.2", params["text_embedding"]["fc2"])
    lin("time_embedding.0", params["time_embedding"]["fc1"])
    lin("time_embedding.2", params["time_embedding"]["fc2"])
    lin("time_projection.1", params["time_projection"])
    lin("head.head", params["head"]["head"])
    sd["head.modulation"] = _np(params["head"]["modulation"])
    if "img_emb" in params:  # i2v MLPProj: reference img_emb.proj.{0,1,3,4}
        ie = params["img_emb"]
        for i, ln in ((0, "ln1"), (4, "ln2")):
            sd[f"img_emb.proj.{i}.weight"] = _np(ie[ln]["scale"])
            sd[f"img_emb.proj.{i}.bias"] = _np(ie[ln]["bias"])
        lin("img_emb.proj.1", ie["fc1"])
        lin("img_emb.proj.3", ie["fc2"])
    blocks = params["blocks"]
    n_layers = _np(blocks["modulation"]).shape[0]

    def blin(name, site, i):
        sd[f"{name}.weight"] = _np(site["kernel"])[i].T
        sd[f"{name}.bias"] = _np(site["bias"])[i]
        for k in _ADAPTER_KEYS:  # LoRA (training/lora.py): stacked, JAX's orientation kept
            if k in site:
                sd[f"{name}.{k}"] = _np(site[k])[i]

    for i in range(n_layers):
        p = f"blocks.{i}"
        sd[f"{p}.modulation"] = _np(blocks["modulation"])[i]
        for part in ("self_attn", "cross_attn"):
            a = blocks[part]
            for proj in ("q", "k", "v", "o"):
                blin(f"{p}.{part}.{proj}", a[proj], i)
            sd[f"{p}.{part}.norm_q.weight"] = _np(a["norm_q"])[i]
            sd[f"{p}.{part}.norm_k.weight"] = _np(a["norm_k"])[i]
            if "k_img" in a:  # i2v cross-attention
                blin(f"{p}.{part}.k_img", a["k_img"], i)
                blin(f"{p}.{part}.v_img", a["v_img"], i)
                sd[f"{p}.{part}.norm_k_img.weight"] = _np(a["norm_k_img"])[i]
        blin(f"{p}.ffn.0", blocks["ffn"]["fc1"], i)
        blin(f"{p}.ffn.2", blocks["ffn"]["fc2"], i)
        if "norm3" in blocks:
            sd[f"{p}.norm3.weight"] = _np(blocks["norm3"]["scale"])[i]
            sd[f"{p}.norm3.bias"] = _np(blocks["norm3"]["bias"])[i]
    return sd


def with_adapters(model: nn.Module, sd: Mapping[str, Any]) -> nn.Module:
    """Give every Linear that `sd` names a LoRA adapter for (`<name>.lora_a`)
    an adapter of the right shapes to load into (training/lora.py)."""
    for key, a in sd.items():
        if key.endswith(".lora_a"):
            name = key[: -len(".lora_a")]
            lin = model.get_submodule(name)
            if not has_lora(lin):
                b = sd[f"{name}.lora_b"]
                set_adapter(lin, torch.zeros(tuple(a.shape)), torch.zeros(tuple(b.shape)),
                            torch.zeros(()))
    return model


def wan_state_dict_to_jax(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of `wan_params_to_state_dict`, flat: a WanDiT state dict →
    {"/"-joined JAX param path: array} with the blocks stacked over the
    layers, Linear weights as [in, out] kernels and the modulation tables in
    JAX's shapes (the JAX finetune CLI's `--lora_export` file)."""
    from ..training.trainer import jax_path

    layers: Dict[str, Dict[int, np.ndarray]] = {}
    out: Dict[str, np.ndarray] = {}
    for name, v in sd.items():
        a = _np(v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else v)
        path = jax_path(name)
        if path.endswith("/kernel"):
            a = a.T
        elif path.endswith("modulation"):
            a = a.reshape(a.shape[1:])  # [1, k, d] per layer → JAX's [k, d]
        parts = name.split(".")
        if parts[0] == "blocks":
            layers.setdefault(path, {})[int(parts[1])] = a
        else:
            out[path] = a
    for path, by_layer in layers.items():
        out[path] = np.stack([by_layer[i] for i in sorted(by_layer)])
    return out


def clip_params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """JAX CLIP vision pytree (`init_clip_vision` /
    `clip_vision_from_state_dict` layout: kernels [in, out], `blocks` a
    list) → the reference VisionTransformer's names, which
    models/clip_vision.py `clip_vision_from_state_dict` reads."""
    pe = params["patch_embedding"]
    kernel = _np(pe["kernel"])  # [3·p·p, dim]
    p = int(round((kernel.shape[0] // 3) ** 0.5))
    sd = {"patch_embedding.weight": kernel.T.reshape(kernel.shape[1], 3, p, p),
          "cls_embedding": _np(params["cls_embedding"]),
          "pos_embedding": _np(params["pos_embedding"])}
    if "bias" in pe:
        sd["patch_embedding.bias"] = _np(pe["bias"])
    for n in ("pre_norm", "post_norm"):
        if n in params:
            sd[f"{n}.weight"] = _np(params[n]["weight"])
            sd[f"{n}.bias"] = _np(params[n]["bias"])
    for i, b in enumerate(params["blocks"]):
        pre = f"transformer.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{pre}.{n}.weight"] = _np(b[n]["weight"])
            sd[f"{pre}.{n}.bias"] = _np(b[n]["bias"])
        for port, key in (("attn.to_qkv", "qkv"), ("attn.proj", "proj"), ("mlp.0", "mlp1"),
                          ("mlp.2", "mlp2")):
            sd[f"{pre}.{port}.weight"] = _np(b[f"{key}_w"]).T
            sd[f"{pre}.{port}.bias"] = _np(b[f"{key}_b"])
    return sd


def xlm_params_from_jax(params, device=None) -> Dict[str, Any]:
    """JAX XLM-Roberta pytree (stacked `blocks` leaves [n_layers, ...]) →
    models/xlm_roberta.py's params (a list of per-layer dicts), tensors on
    `device`."""
    out = {k: to_torch(v, device) for k, v in params.items() if k != "blocks"}
    blocks = to_torch(params["blocks"], device)
    n = next(iter(blocks["q"].values())).shape[0]

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, Mapping) else v[i] for k, v in tree.items()}

    out["blocks"] = [layer(blocks, i) for i in range(n)]
    return out


def load_wan_state_dict(model: WanDiT, sd: Mapping[str, Any]) -> WanDiT:
    """Copy a reference-named state dict into `model`; every parameter must
    be present and every key used (LoRA keys attach their adapters)."""
    sd = unwrap_state_dict(sd)
    return load_strict(with_adapters(model, sd), sd)


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
    every parameter must be present and every key used (LoRA keys attach
    their adapters)."""
    return load_strict(with_adapters(model, sd), sd)


def qwen3vl_params_to_state_dict(params, shard: Optional[Tuple[int, int]] = None
                                 ) -> Dict[str, np.ndarray]:
    """JAX Qwen3-VL param tree ({'vision', 'text'}, numpy or jax arrays) →
    the port's parameter names (HF names; Linear weights [out, in]); with
    `shard` = (rank, n), rank's columns of every expert bank, for a model
    built with `ExpertShard(rank, n)`."""
    sd: Dict[str, np.ndarray] = {}

    def lin(name, kernel, bias=None, tree=None, key=None, i=None):
        """A Linear; with `tree` and `key`, the bare LoRA siblings
        tree[key + '_lora_a' ...] (stacked: layer i) too."""
        sd[f"{name}.weight"] = _np(kernel).T
        if bias is not None:
            sd[f"{name}.bias"] = _np(bias)
        for k in _ADAPTER_KEYS:
            if tree is not None and f"{key}_{k}" in tree:
                sd[f"{name}.{k}"] = _np(tree[f"{key}_{k}"])[i]

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
        for port, key in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                          ("mlp.linear_fc1", "mlp_fc1"), ("mlp.linear_fc2", "mlp_fc2")):
            lin(f"{p}.{port}", blocks[f"{key}_w"][i], blocks[f"{key}_b"][i], blocks, f"{key}_w", i)
    _qwen3_text(params["text"], sd, lin, shard)
    return sd


def qwen3_params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """The text-only JAX Qwen3 tree ({'embed', 'layers', 'norm',
    'lm_head'}, JAX `hf_to_params`) → the names of text_model.Qwen3LM."""
    sd: Dict[str, np.ndarray] = {}

    def lin(name, kernel, bias=None, tree=None, key=None, i=None):
        sd[f"{name}.weight"] = _np(kernel).T
        for k in _ADAPTER_KEYS:
            if tree is not None and f"{key}_{k}" in tree:
                sd[f"{name}.{k}"] = _np(tree[f"{key}_{k}"])[i]

    _qwen3_text(params, sd, lin)
    return sd


def _qwen3_text(txt, sd: Dict[str, np.ndarray], lin,
                shard: Optional[Tuple[int, int]] = None) -> None:
    """The Qwen3 text tree into `sd` under the port's names (`lin` writes
    a Linear and its bare LoRA siblings); `shard` (rank, n) slices the
    expert banks."""
    es = ExpertShard(*shard) if shard is not None else None
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
            lin(f"{p}.self_attn.{proj}_proj", _np(a[proj])[i], None, a, proj, i)
        sd[f"{p}.self_attn.q_norm.weight"] = _np(a["q_norm"])[i]
        sd[f"{p}.self_attn.k_norm.weight"] = _np(a["k_norm"])[i]
        if "experts" in mlp:
            lin(f"{p}.mlp.gate", _np(mlp["gate"])[i])
            for part in ("gate", "up", "down"):
                bank = _np(mlp["experts"][part])[i]
                if es is not None:
                    dim = SPLIT_DIMS[f"experts_{part}"]
                    lo, hi = es.cols(bank.shape[dim])
                    bank = np.ascontiguousarray(bank[(slice(None),) * dim + (slice(lo, hi),)])
                sd[f"{p}.mlp.experts_{part}"] = bank
        else:
            for part in ("gate", "up", "down"):
                lin(f"{p}.mlp.{part}_proj", _np(mlp[part])[i], None, mlp, part, i)


def load_qwen3vl(model: Qwen3VLModel, sd: Mapping[str, Any]) -> Qwen3VLModel:
    """Copy a port-named Qwen3-VL state dict (qwen3vl_params_to_state_dict,
    or qwen3_params_to_state_dict into a text_model.Qwen3LM) into `model`;
    every parameter must be present and every key used (LoRA keys attach
    their adapters)."""
    return load_strict(with_adapters(model, sd), sd)


def qwen3_state_dict_to_params(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of `qwen3_params_to_state_dict`: text_model.Qwen3LM names
    → JAX's {'embed', 'layers', 'norm'[, 'lm_head']} numpy tree, layers
    stacked, kernels [in, out], bare LoRA siblings `{key}_lora_*` beside
    their weight."""
    sd = {k: _np(v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    out: Dict[str, Any] = {"embed": sd["language_model.embed_tokens.weight"],
                           "norm": sd["language_model.norm.weight"]}
    if "lm_head.weight" in sd:
        out["lm_head"] = sd["lm_head.weight"].T
    n = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("language_model.layers."))
    per: Dict[tuple, list] = {}

    def put(path, i, a):
        per.setdefault(path, [None] * n)[i] = a

    names = {"input_layernorm.weight": ("ln1",), "post_attention_layernorm.weight": ("ln2",),
             "self_attn.q_norm.weight": ("attn", "q_norm"),
             "self_attn.k_norm.weight": ("attn", "k_norm"),
             "mlp.gate.weight": ("mlp", "gate"), "mlp.experts_gate": ("mlp", "experts", "gate"),
             "mlp.experts_up": ("mlp", "experts", "up"),
             "mlp.experts_down": ("mlp", "experts", "down")}
    sites = {"self_attn.q_proj": ("attn", "q"), "self_attn.k_proj": ("attn", "k"),
             "self_attn.v_proj": ("attn", "v"), "self_attn.o_proj": ("attn", "o"),
             "mlp.gate_proj": ("mlp", "gate"), "mlp.up_proj": ("mlp", "up"),
             "mlp.down_proj": ("mlp", "down")}
    for k, a in sd.items():
        if not k.startswith("language_model.layers."):
            continue
        _, _, i, rest = k.split(".", 3)
        i = int(i)
        if rest in names:
            path = names[rest]
            put(path, i, a.T if rest == "mlp.gate.weight" else a)
            continue
        site, leaf = rest.rsplit(".", 1)
        d, key = sites[site]
        put((d, key if leaf == "weight" else f"{key}_{leaf}"), i, a.T if leaf == "weight" else a)
    layers: Dict[str, Any] = {}
    for path, arrs in per.items():
        node = layers
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack(arrs)
    out["layers"] = layers
    return out


def _core_maps(core: str, tree) -> Dict[str, tuple]:
    """{reference state-dict name: path in JAX's QueryTransformer tree} of
    one DM_Adapter / VisionHead tree (JAX `_transformer_from_sd`'s map)."""
    attn = {"in_proj_weight": "in_proj_w", "in_proj_bias": "in_proj_b",
            "out_proj.weight": "out_proj_w", "out_proj.bias": "out_proj_b"}
    ffn = {"linear1.weight": "w1", "linear1.bias": "b1", "linear2.weight": "w2",
           "linear2.bias": "b2"}
    m = {"decoder_query": ("decoder_query",), "fc.0.weight": ("fc", "fc1_w"),
         "fc.0.bias": ("fc", "fc1_b"), "fc.2.weight": ("fc", "fc2_w"),
         "fc.2.bias": ("fc", "fc2_b")}
    tr = tree["transformer"]
    for side, parts in (("encoder", ("self_attn",)), ("decoder", ("self_attn", "cross_attn"))):
        for i in range(len(tr[side])):
            p = f"{core}.{side}.layers.{i}"
            base = ("transformer", side, i)
            for part in parts:
                ref = "multihead_attn" if part == "cross_attn" else part
                for a, b in attn.items():
                    m[f"{p}.{ref}.{a}"] = base + (part, b)
            for a, b in ffn.items():
                m[f"{p}.{a}"] = base + ("ffn", b)
            for nm in ("norm1", "norm2") + (("norm3",) if side == "decoder" else ()):
                for leaf in ("weight", "bias"):
                    m[f"{p}.{nm}.{leaf}"] = base + (nm, leaf)
        for leaf in ("weight", "bias"):
            m[f"{core}.{side}.norm.{leaf}"] = ("transformer", f"{side}_norm", leaf)
    return m


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


_CHAIN_CORES = {"vision_head": "visionHeadAdapter", "adapter": "adapter"}


def chain_params_to_state_dict(chain) -> Dict[str, np.ndarray]:
    """JAX's alignment chain {'vision_head', 'adapter'} (models/adapters.py
    trees) → the names of training.align.AlignChain."""
    sd = {}
    for part, core in _CHAIN_CORES.items():
        for name, path in _core_maps(core, chain[part]).items():
            sd[f"{part}.{name}"] = _np(_get(chain[part], path))
    return sd


def chain_state_dict_to_params(sd: Mapping[str, Any], like) -> Dict[str, Any]:
    """The inverse of `chain_params_to_state_dict`, into a copy of the JAX
    tree `like` (its structure: the number of layers)."""
    def copy(t):
        if isinstance(t, Mapping):
            return {k: copy(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [copy(v) for v in t]
        return None

    out = copy(like)
    for part, core in _CHAIN_CORES.items():
        for name, path in _core_maps(core, like[part]).items():
            v = sd[f"{part}.{name}"]
            _set(out[part], path, _np(v.detach().float().cpu().numpy()
                                      if isinstance(v, torch.Tensor) else v))
    return out


def sft_params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """JAX's SFT tree {'lm'[, 'chain']} (params, grads or AdamW moments) →
    the names of training.sft.SFTParams: 'lm.' + the Qwen3LM names,
    'chain.' + the AlignChain names."""
    sd = {f"lm.{k}": v for k, v in qwen3_params_to_state_dict(params["lm"]).items()}
    if "chain" in params:
        sd.update({f"chain.{k}": v for k, v in chain_params_to_state_dict(params["chain"]).items()})
    return sd


def sft_state_dict_to_params(sd: Mapping[str, Any], chain_like=None) -> Dict[str, Any]:
    """The inverse of `sft_params_to_state_dict` (an SFTParams state dict,
    its grads or its moments) → JAX's numpy tree; `chain_like` gives the
    chain's structure when the state has one."""
    out = {"lm": qwen3_state_dict_to_params({k[3:]: v for k, v in sd.items()
                                             if k.startswith("lm.")})}
    chain = {k[6:]: v for k, v in sd.items() if k.startswith("chain.")}
    if chain:
        out["chain"] = chain_state_dict_to_params(chain, chain_like)
    return out


def adamw_state_from_jax(mu, nu, count: int, device=None) -> Dict[str, Any]:
    """optax's ScaleByAdamState (mu, nu: SFT trees; count) → the port's
    AdamW state (training/trainer.py `Optimizer`), on `device`."""
    return {"count": int(count),
            "mu": {k: torch.as_tensor(v.copy(), device=device)
                   for k, v in sft_params_to_state_dict(mu).items()},
            "nu": {k: torch.as_tensor(v.copy(), device=device)
                   for k, v in sft_params_to_state_dict(nu).items()}}


def adamw_state_to_jax(opt_state: Mapping[str, Any], chain_like=None):
    """The port's AdamW state → (mu, nu, count) in JAX's numpy SFT trees."""
    return (sft_state_dict_to_params(opt_state["mu"], chain_like),
            sft_state_dict_to_params(opt_state["nu"], chain_like), int(opt_state["count"]))



# --- the streamed trainers' states (training/streaming.py) ------------------

_BLOCK_LINEARS = {"ffn/fc1": "ffn.0", "ffn/fc2": "ffn.2"}


def _stack(trees):
    """Per-block dicts of arrays → one dict of [L, ...] arrays."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def _split_names(resident, block) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """A JAX DiT's non-block leaves and one block's (params, or optimizer
    moments of the same structure) → (the port's resident names, its
    block-relative names)."""
    sd = wan_params_to_state_dict({**resident, "blocks": _stack([block])})
    res = {k: v for k, v in sd.items() if not k.startswith("blocks.")}
    blk = {k[len("blocks.0."):]: v for k, v in sd.items() if k.startswith("blocks.0.")}
    return res, blk


def _linear_name(path: str) -> str:
    """A block-relative JAX adapter path ('self_attn/q', 'ffn/fc1') → the
    port's Linear name ('self_attn.q', 'ffn.0')."""
    return _BLOCK_LINEARS.get(path, path.replace("/", "."))


def _adam(opt_state):
    """optax adamw's ScaleByAdamState (mu, nu, count) inside a chain."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam(s)
            if found is not None:
                return found
    return None


@torch.no_grad()
def _copy_named(dst: Mapping[str, torch.Tensor], src: Mapping[str, Any]) -> None:
    for k, t in dst.items():
        t.copy_(torch.from_numpy(np.array(_np(src[k]))).reshape(t.shape))


def streamed_state_from_jax(trainer, jstate, device="cuda"):
    """A JAX StreamedTrainState or StreamedLoRAState (host numpy blocks,
    optax AdamW states) → the port trainer's state on `device`: the same
    parameters, adapters, moments and step. AdamW states only."""
    dev = resolve_device(device)
    full = {**dict(jstate.resident), "blocks": _stack(jstate.host_blocks)}
    bf16 = np.asarray(full["patch_embedding"]["kernel"]).dtype.name == "bfloat16"
    wan = WanDiT(trainer.dit_cfg, dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
    load_wan_state_dict(wan, wan_params_to_state_dict(full))
    if hasattr(jstate, "lora"):
        adapters = {f"blocks.{i}.{_linear_name(path)}": tuple(
            torch.from_numpy(np.array(_np(x))) for x in
            (site["lora_a"], site["lora_b"], sc[path]["lora_scale"]))
            for i, (ab, sc) in enumerate(zip(jstate.lora, jstate.lora_scales))
            for path, site in ab.items()}
        state = trainer.init_state(wan, adapters)
        adam = _adam(jstate.lora_opt)
        if adam is None:
            raise NotImplementedError("only AdamW states carry across")
        for moment in ("mu", "nu"):
            _copy_named(state.lora_opt[moment], {
                f"blocks.{i}.{_linear_name(path)}.{key}": site[key]
                for i, blk in enumerate(getattr(adam, moment)) for path, site in blk.items()
                for key in ("lora_a", "lora_b")})
        state.step = int(jstate.step)
        return state
    state = trainer.init_state(wan)
    if _adam(jstate.resident_opt) is None:
        raise NotImplementedError("only AdamW states carry across")
    packer = state.host_opts[0].packer
    for moment in ("mu", "nu"):
        res_m = getattr(_adam(jstate.resident_opt), moment)
        for i, jopt in enumerate(jstate.host_block_opts):
            res, blk = _split_names(res_m, getattr(_adam(jopt), moment))
            if i == 0:
                _copy_named(state.resident_opt[moment], res)
            _copy_named(trainer._opt_views(state.host_opts[i].data, packer)[moment], blk)
    state.step = int(jstate.step)
    return state
