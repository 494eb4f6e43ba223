"""Reference PyTorch checkpoints → the port's modules (port of
omnivideo_tpu/io/torch_convert.py).

The reference's files are torch pickles (a fine-tuned unified expert's
`model.pt`, `Wan2.1_VAE.pth`, the umT5 `.pth`, `special_tokens.pkl`); the
port reads them with `torch.load(..., weights_only=True)` (`load_torch_file`)
and maps their names:
- `unwrap_state_dict` strips DDP/engine wrappers ('module' / 'model' keys
  and prefixes);
- `split_unified_state_dict` splits a unified expert into the WanModel
  (`wan_model.` prefix dropped) and its companions;
- `wan_state_dict_to_params` builds a WanDiT and copies the WanModel names
  into it (the Conv3d patch embedding and the modulation tables reshaped,
  every tensor cast to its parameter's dtype: modulation, norms and head
  f32, the rest the param dtype);
- `unified_companions_to_params` maps vlm_norm / vlm_proj /
  visual_context_adapter into the JAX dict layout (kernels [in, out]).
The VAE and umT5 names map in their modules (`models/vae2_1.py`,
`models/t5.py`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..configs.base import WanDiTConfig
from ..models.wan_dit import WanDiT


def load_torch_file(path: Union[str, Path]) -> Any:
    """A torch pickle of tensors and containers, read on the CPU without
    running pickled code."""
    return torch.load(str(path), map_location="cpu", weights_only=True)


def as_tensor(a) -> torch.Tensor:
    """A tensor, or a numpy array (ml_dtypes bf16 widened to f32), as a tensor
    that owns its memory."""
    if torch.is_tensor(a):
        return a.detach()
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


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


def split_unified_state_dict(sd: Mapping[str, Any]):
    """A unified checkpoint → (wan_sd, companion_sd)."""
    sd = unwrap_state_dict(sd)
    wan = {k[len("wan_model."):]: v for k, v in sd.items() if k.startswith("wan_model.")}
    comp = {k: v for k, v in sd.items() if not k.startswith("wan_model.")}
    return wan, comp


@torch.no_grad()
def load_strict(model: nn.Module,
                sd: Union[Mapping[str, Any], Iterable[Tuple[str, Any]]]) -> nn.Module:
    """Copy arrays into the parameters of the same names, reshaping where
    only the layout differs and casting to each parameter's dtype; every
    parameter must be filled and every name used. `sd` is a mapping, or
    (name, array) pairs that arrive one at a time (a safetensors file read
    tensor by tensor): each is copied as it comes, so loading holds the
    model and one tensor more."""
    params = dict(model.named_parameters())
    seen = set()
    for name, value in (sd.items() if isinstance(sd, Mapping) else sd):
        if name not in params:
            raise KeyError(f"state dict mismatch: unexpected {name!r}")
        src, p = as_tensor(value), params[name]
        if src.numel() != p.numel():
            raise ValueError(f"{name}: {tuple(src.shape)} does not fit {tuple(p.shape)}")
        p.copy_(src.reshape(p.shape))
        seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}")
    return model


def wan_state_dict_to_params(sd: Mapping[str, Any], cfg: WanDiTConfig,
                             dtype: torch.dtype = torch.bfloat16, device="cuda") -> WanDiT:
    """A reference WanModel state dict → a WanDiT of `cfg` on `device`."""
    return load_strict(WanDiT(cfg, dtype=dtype, device=device), unwrap_state_dict(sd))


def unified_companions_to_params(sd: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """vlm_norm / vlm_proj / visual_context_adapter from reference names into
    the JAX dict layout (kernels [in, out]), f32 tensors on `device`."""
    sd = unwrap_state_dict(sd)
    t = lambda k: as_tensor(sd[k]).float().to(device)  # noqa: E731

    def lin(prefix):
        return {"kernel": t(f"{prefix}.weight").T.contiguous(), "bias": t(f"{prefix}.bias")}

    out: Dict[str, Any] = {}
    if "vlm_norm.weight" in sd:
        out["vlm_norm"] = t("vlm_norm.weight")
    if "vlm_proj.weight" in sd:
        out["vlm_proj"] = lin("vlm_proj")
    if "visual_context_adapter.patch_embedding.weight" in sd:
        w = t("visual_context_adapter.patch_embedding.weight")
        out["visual_context_adapter"] = {
            "patch_embedding": {"kernel": w.reshape(w.shape[0], -1).T.contiguous(),
                                "bias": t("visual_context_adapter.patch_embedding.bias")},
            "projection": lin("visual_context_adapter.projection"),
        }
    return out
