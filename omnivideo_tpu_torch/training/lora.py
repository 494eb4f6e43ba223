"""LoRA adapters on the port's modules (port of omnivideo_tpu/training/lora.py).

An adapted projection is an `nn.Linear` that carries, beside its frozen
weight, the parameters `lora_a` [d_in, r] and `lora_b` [r, d_out] (JAX's
orientation, so an adapter file needs no transpose) and the buffer
`lora_scale` (alpha / r, 0-d f32). The models' projection helpers add the
delta `((x @ A) @ B) · scale` whenever `lora_a` is present: `dense`
(models/wan_dit.py: the DiT, its companions and the vision tower; A and B
cast to x's dtype, as JAX's `_dense`), `lin` (models/qwen3vl/text_model.py:
the Qwen3 text stack; A and B as they are, as JAX's `_lin`) and, under
tensor parallelism, `tp_dense` (parallel/tp.py). At injection B is zero, so
the forward is unchanged.

JAX keeps the adapters in two layouts, and the port's sites map onto both
by name, so `extract_lora`, `save_adapters_npz` and `apply_lora_state` read
and write JAX's form ({path: {key: array}}, block leaves stacked over the
layers as [L, d_in, r], [L, r, d_out] and [L]):
- dense sites (`inject_lora`, the Wan DiT): the site path is the JAX
  param path of the Linear ('blocks/self_attn/q', layer index dropped) and
  the keys are `lora_a`, `lora_b`, `lora_scale`;
- bare sibling keys (`inject_lora_bare`, the Qwen3 text stack and the
  vision tower): JAX names the tensor by its dict key ('q', 'gate',
  'qkv_w'), so the site path is its dict ('layers/attn', 'blocks';
  'text/...' and 'vision/...' inside a whole Qwen3-VL) and the keys are
  `q_lora_a` and so on. The MoE router (`gate` beside the experts) and the
  expert banks are never adapted, as in JAX.

Departure: `inject_lora` draws A ~ N(0, 1/d_in) from a torch.Generator,
not from jax.random, so the initial adapters differ from JAX's (B = 0
either way); the tests carry JAX's adapters across instead.

Training only the adapters: `LORA_FILTERS` as `TrainConfig.trainable_filters`
(the optimizer then holds state for the adapters alone) and `freeze_base`,
which stops the base weights' gradients (JAX computes and masks them).
`merge_lora` folds W + scale·A@B in f32, cast to W's dtype (JAX `_fold`).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..models.wan_dit import WanDiT
from ..ops.lora import has_lora

DEFAULT_TARGETS: Tuple[str, ...] = (
    "self_attn/q", "self_attn/k", "self_attn/v", "self_attn/o",
    "cross_attn/q", "cross_attn/k", "cross_attn/v", "cross_attn/o",
    "cross_attn/k_img", "cross_attn/v_img",
    "ffn/fc1", "ffn/fc2",
)
LORA_FILTERS: Tuple[str, ...] = ("lora_a", "lora_b")  # lora_scale is a frozen buffer
DEFAULT_BARE_NAMES: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")
VISION_BARE_NAMES: Tuple[str, ...] = ("qkv_w", "proj_w", "mlp_fc1_w", "mlp_fc2_w")

# the port's Linear (relative to a text layer / a vision block) → JAX's (dict, key)
_TEXT_BARE = {"self_attn.q_proj": ("attn", "q"), "self_attn.k_proj": ("attn", "k"),
              "self_attn.v_proj": ("attn", "v"), "self_attn.o_proj": ("attn", "o"),
              "mlp.gate_proj": ("mlp", "gate"), "mlp.up_proj": ("mlp", "up"),
              "mlp.down_proj": ("mlp", "down")}
_VISION_BARE = {"attn.qkv": "qkv_w", "attn.proj": "proj_w", "mlp.linear_fc1": "mlp_fc1_w",
                "mlp.linear_fc2": "mlp_fc2_w"}
_STACKED = r"^(?:(language_model|visual)\.)?(layers|blocks)\.(\d+)\.(.+)$"


class Site:
    """An adaptable Linear and where JAX keeps its adapter: the dict path,
    the key prefix ('' for a dense site, 'q_' for bare 'q'), the layer index
    of a stacked leaf (None: not stacked) and the bare name (None: dense)."""

    def __init__(self, name: str, lin: nn.Linear, path: str, prefix: str,
                 layer: Optional[int], bare: Optional[str]):
        self.name, self.lin, self.path, self.prefix = name, lin, path, prefix
        self.layer, self.bare = layer, bare

    def key(self, k: str) -> str:
        return self.prefix + k


def _dense_site(name: str, lin: nn.Linear) -> Site:
    from .trainer import jax_path

    m = re.match(_STACKED, name)
    path = jax_path(f"{name}.weight")[: -len("/kernel")]
    return Site(name, lin, path, "", int(m.group(3)) if m else None, None)


def _bare_site(root: nn.Module, name: str, lin: nn.Linear) -> Optional[Site]:
    m = re.match(_STACKED, name)
    if m is None:
        return None
    owner, kind, layer, rest = m.groups()
    if kind == "layers" and rest in _TEXT_BARE:
        sub, bare = _TEXT_BARE[rest]
        path = f"layers/{sub}"
    elif kind == "blocks" and rest in _VISION_BARE:
        bare, path = _VISION_BARE[rest], "blocks"
    else:
        return None
    if owner is not None and hasattr(root, "visual"):  # a whole Qwen3-VL: {'vision', 'text'}
        path = ("text/" if owner == "language_model" else "vision/") + path
    return Site(name, lin, path, bare + "_", int(layer), bare)


def sites(root: nn.Module) -> Iterator[Site]:
    """Every Linear of `root` in JAX's adapter layout: dense sites for a
    WanDiT, bare ones (text stack, vision blocks) otherwise."""
    for name, mod in root.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        site = _dense_site(name, mod) if isinstance(root, WanDiT) else _bare_site(root, name, mod)
        if site is not None:
            yield site


def set_adapter(lin: nn.Linear, a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> None:
    """Attach (or replace) lin's adapter: A [d_in, r], B [r, d_out], scale ()."""
    dev = lin.weight.device
    lin.lora_a = nn.Parameter(torch.as_tensor(a).to(dev).clone())
    lin.lora_b = nn.Parameter(torch.as_tensor(b).to(dev).clone())
    lin.register_buffer("lora_scale", torch.as_tensor(scale, dtype=torch.float32).to(dev).clone())


def remove_adapter(lin: nn.Linear) -> None:
    for k in ("lora_a", "lora_b"):
        del lin._parameters[k]
    del lin._buffers["lora_scale"]


def _draw(chosen, rank: int, alpha: Optional[float], generator, device=None) -> list:
    """(site, A, B, scale) per chosen site, in order: A ~ N(0, 1/d_in) f32
    drawn on `device` (default: the weight's), B = 0, scale alpha/r."""
    if rank < 1:
        raise ValueError(f"LoRA rank {rank} < 1")
    scale = (alpha if alpha is not None else float(rank)) / rank
    out = []
    for site in chosen:
        w = site.lin.weight
        dev = w.device if device is None else device
        d_out, d_in = w.shape
        a = torch.randn(d_in, rank, generator=generator, device=dev)
        out.append((site, a / math.sqrt(d_in), torch.zeros(rank, d_out, device=dev),
                    torch.tensor(scale)))
    return out


def _inject(chosen, rank: int, alpha: Optional[float], generator) -> int:
    for site, a, b, s in _draw(chosen, rank, alpha, generator):
        set_adapter(site.lin, a, b, s)
    return len(chosen)


def _dense_targets(dit: WanDiT, targets: Iterable[str]) -> list:
    targets = tuple(targets)
    chosen = [s for s in sites(dit) if any(t in s.path for t in targets)]
    if not chosen:
        raise ValueError(f"no dense sites matched targets {targets}")
    return chosen


def inject_lora(dit: WanDiT, rank: int, alpha: Optional[float] = None,
                targets: Iterable[str] = DEFAULT_TARGETS,
                generator: Optional[torch.Generator] = None) -> WanDiT:
    """Adapters at every dense site of `dit` whose JAX path contains one of
    `targets` (f32 A ~ N(0, 1/d_in) from `generator`, B = 0, scale alpha/r,
    alpha defaulting to r). In place; returns the module."""
    _inject(_dense_targets(dit, targets), rank, alpha, generator)
    return dit


def draw_lora(dit: WanDiT, rank: int, alpha: Optional[float] = None,
              targets: Iterable[str] = DEFAULT_TARGETS,
              generator: Optional[torch.Generator] = None) -> Dict[str, tuple]:
    """The adapters `inject_lora` would attach, with its draws, without
    attaching them: {Linear name: (A, B, scale)} on the model's resident
    device (a streamed DiT's blocks are meta: training/streaming.py keeps
    their adapters in the trainer's state)."""
    dev = dit.patch_embedding.weight.device
    return {site.name: (a, b, s.to(dev)) for site, a, b, s in
            _draw(_dense_targets(dit, targets), rank, alpha, generator, dev)}


def inject_lora_bare(model: nn.Module, rank: int, alpha: Optional[float] = None,
                     names: Iterable[str] = DEFAULT_BARE_NAMES,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """`inject_lora` over the bare layout: the text stack's projections
    named in `names` (JAX q k v o gate up down; the MoE router and experts
    never) or the vision blocks' (VISION_BARE_NAMES). In place."""
    names = tuple(names)
    chosen = [s for s in sites(model) if s.bare in names]
    if not chosen:
        raise ValueError(f"no bare sites matched names {names}")
    _inject(chosen, rank, alpha, generator)
    return model


def _fold(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """W + scale·(A @ B)ᵀ in f32, cast to W's dtype (JAX `_fold`)."""
    return (w.float() + ((a @ b) * scale).float().T).to(w.dtype)


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold every adapter into its weight and remove the adapters (the
    deployment export). In place."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear) and has_lora(mod):
            mod.weight.copy_(_fold(mod.weight, mod.lora_a, mod.lora_b, mod.lora_scale))
            remove_adapter(mod)
    return model


def strip_lora(model: nn.Module) -> nn.Module:
    """Remove the adapters without merging (the exact base). In place."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear) and has_lora(mod):
            remove_adapter(mod)
    return model


def _full_np(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def extract_lora(model: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """The adapter-only state in JAX's form {path: {key: array}}, stacked
    block leaves [L, ...] (a collective on sharded adapters)."""
    per: Dict[str, Dict[str, dict]] = {}
    for site in sites(model):
        if not has_lora(site.lin):
            continue
        keys = per.setdefault(site.path, {})
        for k in ("lora_a", "lora_b", "lora_scale"):
            keys.setdefault(site.key(k), {})[site.layer] = _full_np(getattr(site.lin, k))
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for path, keys in per.items():
        out[path] = {}
        for k, by_layer in keys.items():
            if None in by_layer:
                out[path][k] = by_layer[None]
            else:
                out[path][k] = np.stack([by_layer[i] for i in sorted(by_layer)])
    return out


def apply_lora_state(model: nn.Module, state: Dict[str, Dict[str, np.ndarray]]) -> nn.Module:
    """Graft an `extract_lora` / `load_adapters_npz` state onto the model
    (base or already adapted), at the sites it names. In place."""
    for site in sites(model):
        keys = state.get(site.path)
        if keys is None or site.key("lora_a") not in keys:
            continue
        a, b, s = (np.asarray(keys[site.key(k)]) for k in ("lora_a", "lora_b", "lora_scale"))
        if site.layer is not None:
            a, b, s = a[site.layer], b[site.layer], s[site.layer]
        d_out, d_in = site.lin.weight.shape
        if a.shape[0] != d_in or b.shape[1] != d_out:
            raise ValueError(f"adapter {site.path}::{site.key('lora_a')} is {a.shape} x "
                             f"{b.shape}, the Linear {site.name} is [{d_in} → {d_out}]")
        set_adapter(site.lin, torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)),
                    torch.from_numpy(np.array(s)))
    return model


def save_adapters_npz(model: nn.Module, path) -> int:
    """The adapter-only state as one .npz of `path::key` arrays (JAX's
    format; JAX's `load_adapters_npz` reads it). Returns the array count."""
    return write_adapters_npz(extract_lora(model), path)


def write_adapters_npz(state: Dict[str, Dict[str, np.ndarray]], path) -> int:
    """`save_adapters_npz` of an `extract_lora` state."""
    flat = {f"{p}::{k}": v for p, site in state.items() for k, v in site.items()}
    if not flat:
        raise ValueError("no adapters to save")
    np.savez(path, **flat)
    return len(flat)


@torch.no_grad()
def merge_lora_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`merge_lora` on a state dict (names '<linear>.weight', '.lora_a', ...):
    the adapters folded into the weights and dropped."""
    out = {k: v for k, v in sd.items() if not k.endswith(("lora_a", "lora_b", "lora_scale"))}
    for k in sd:
        if k.endswith(".lora_a"):
            site = k[: -len(".lora_a")]
            out[f"{site}.weight"] = _fold(sd[f"{site}.weight"], sd[k], sd[f"{site}.lora_b"],
                                          sd[f"{site}.lora_scale"])
    return out


def load_adapters_npz(path) -> Dict[str, Dict[str, np.ndarray]]:
    """A `save_adapters_npz` file (the port's or JAX's) as {path: {key: array}}."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for key in z.files:
            p, k = key.split("::")
            out.setdefault(p, {})[k] = z[key]
    return out


def count_lora_params(model: nn.Module) -> int:
    return sum(m.lora_a.numel() + m.lora_b.numel() for m in model.modules()
               if isinstance(m, nn.Linear) and has_lora(m))


def freeze_base(model: nn.Module) -> set:
    """Stop the gradients of every parameter but the adapters; returns the
    adapters' parameter names."""
    names = set()
    for n, p in model.named_parameters():
        p.requires_grad_(n.endswith(LORA_FILTERS))
        if p.requires_grad:
            names.add(n)
    return names


def lora_masked(tx, model: nn.Module, extra_filters: Iterable[str] = ()):
    """Restrict an optimizer (training/trainer.py `Optimizer`) to the
    adapters, plus any parameter whose JAX path contains one of
    `extra_filters` (JAX wraps an optax transformation the same way).
    Returns `tx`."""
    from .trainer import trainable_names

    tx.trainable = trainable_names(model, tuple(LORA_FILTERS) + tuple(extra_filters))
    return tx
