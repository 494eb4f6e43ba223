"""Mixed-condition context assembly (port of omnivideo_tpu/models/unified.py).

RMS-norm + Linear projection of Qwen3-VL hidden states, the optional visual
context adapter over source-video latents, and the concatenation with
learned special-token sandwiches in the v2 order
[VLM][<ipl> aligned][<prp> text][<img> visual][<img> ref] or the v1 order
[<img> visual][<img> ref][<ipl> aligned][<prp> text], zero-padded or
truncated to max_context_len (`load_special_tokens_pkl` reads the tokens
of a reference checkpoint). Companion parameters keep the JAX dict layout:
a nested dict of tensors for inference, or `Companions`, the same tree as
trainable parameters, for training (`build_mixed_context_batch`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from ..configs.base import PipelineConfig
from ..ops.norms import rms_norm
from .visual_context_adapter import init_vca, kernel_dense, vca_apply


def init_unified_companions(cfg: PipelineConfig, device=None,
                            generator: Optional[torch.Generator] = None):
    """vlm_norm + vlm_proj (+ visual context adapter) params, f32."""
    params = {
        "vlm_norm": torch.ones(cfg.vlm_in_dim, device=device),
        "vlm_proj": {
            "kernel": torch.empty(cfg.vlm_in_dim, cfg.dit.text_dim, device=device)
            .normal_(0.0, cfg.vlm_in_dim**-0.5, generator=generator),
            "bias": torch.zeros(cfg.dit.text_dim, device=device),
        },
    }
    if cfg.use_visual_context_adapter:
        params["visual_context_adapter"] = init_vca(
            cfg.visual_context_adapter_patch_size, cfg.dit.in_dim, cfg.dit.dim,
            cfg.dit.text_dim, device=device, generator=generator)
    return params


class Companions(nn.Module):
    """A companion param tree (vlm_norm, vlm_proj, visual_context_adapter) as
    trainable parameters: sub-dicts become child modules, leaves parameters,
    so parameter names are the JAX paths with dots ("vlm_proj.kernel"). It
    reads like the dict: tree[k], k in tree, .get(k)."""

    def __init__(self, tree: Mapping[str, object]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(key, Companions(val))
            else:
                self.register_parameter(key, nn.Parameter(torch.as_tensor(val)))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def project_vlm_features(companions, ar_vision: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """vlm_norm → vlm_proj. ar_vision: [L, vlm_dim]."""
    return kernel_dense(companions["vlm_proj"], rms_norm(ar_vision, companions["vlm_norm"], eps))


def null_ar_vision(vlm_dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Null VLM embedding for CFG: zeros(2, vlm_dim) + 1e-6."""
    return torch.zeros(2, vlm_dim, dtype=dtype, device=device) + 1e-6


def _as2d(a: torch.Tensor) -> torch.Tensor:
    return a[None] if a.ndim == 1 else (a[0] if a.ndim == 3 else a)


def build_mixed_context(
    companions,
    cfg: PipelineConfig,
    context: Optional[torch.Tensor] = None,
    ar_vision: Optional[torch.Tensor] = None,
    visual_emb: Optional[torch.Tensor] = None,
    aligned_emb: Optional[torch.Tensor] = None,
    special_tokens: Optional[Dict[str, torch.Tensor]] = None,
    condition_mode: str = "full",
    ref_images: Optional[torch.Tensor] = None,
    order: str = "v2",
) -> torch.Tensor:
    """One sample's mixed context [max_context_len, text_dim] f32, from
    per-sample [L, D] inputs (context already in text_dim space)."""
    if condition_mode not in ("auto", "full", "text_only", "aligned_emb_with_text",
                              "aligned_emb_only", "visual_with_aligned_emb"):
        raise ValueError(f"unknown condition_mode {condition_mode!r}")
    if order not in ("v1", "v2"):
        raise ValueError(f"unknown token order {order!r}")
    td = cfg.dit.text_dim
    if condition_mode == "aligned_emb_only":
        context = ar_vision = visual_emb = None
    elif condition_mode == "aligned_emb_with_text":
        ar_vision = visual_emb = None
    elif condition_mode == "visual_with_aligned_emb":
        context = ar_vision = None

    vlm_item = None
    if ar_vision is not None and condition_mode != "text_only":
        vlm_item = project_vlm_features(companions, _as2d(ar_vision), cfg.dit.eps)
    vca = companions.get("visual_context_adapter")
    ps = cfg.visual_context_adapter_patch_size
    visual_item = None
    if visual_emb is not None and condition_mode != "text_only" and vca is not None:
        visual_item = vca_apply(vca, visual_emb, ps, cfg.dit.eps)[0]
    aligned_item = _as2d(aligned_emb) if aligned_emb is not None else None
    ref_item = None
    if ref_images is not None and vca is not None:
        ref_item = vca_apply(vca, ref_images, ps, cfg.dit.eps)[0]
    text_item = _as2d(context) if context is not None else None

    parts: List[torch.Tensor] = []
    if special_tokens is not None:
        st = {k: _as2d(v) for k, v in special_tokens.items()}

        def sandwich(start, item, end):
            if item is None:
                return
            if start in st and end in st:
                parts.extend([st[start], item, st[end]])
            else:
                parts.append(item)

        if order == "v1":
            sandwich("<img_st>", visual_item, "<img_ed>")
            sandwich("<img_st>", ref_item, "<img_ed>")
            sandwich("<ipl_st>", aligned_item, "<ipl_ed>")
            sandwich("<prp_st>", text_item, "<prp_ed>")
        else:
            if vlm_item is not None:
                parts.append(vlm_item)
            sandwich("<ipl_st>", aligned_item, "<ipl_ed>")
            sandwich("<prp_st>", text_item, "<prp_ed>")
            sandwich("<img_st>", visual_item, "<img_ed>")
            sandwich("<img_st>", ref_item, "<img_ed>")
    else:
        ordered = ((visual_item, ref_item, aligned_item, text_item) if order == "v1"
                   else (vlm_item, aligned_item, text_item, visual_item, ref_item))
        parts = [p for p in ordered if p is not None]

    if not parts:  # nothing to condition on: one zero token (callers move it)
        parts = [torch.zeros(1, td)]
    dev = parts[0].device
    mixed = torch.cat([p.to(device=dev, dtype=torch.float32) for p in parts], dim=0)
    L = cfg.max_context_len
    if mixed.shape[0] > L:
        mixed = mixed[:L]
    elif mixed.shape[0] < L:
        mixed = torch.cat([mixed, mixed.new_zeros(L - mixed.shape[0], td)])
    return mixed


def load_special_tokens_pkl(path: str, device=None) -> Dict[str, torch.Tensor]:
    """The reference's special_tokens.pkl (a torch pickle of tensors) → f32
    tensors on `device`, read without running pickled code."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, Mapping):
        raise ValueError(f"{path}: expected a dict of special-token tensors, got {type(obj)}")
    return {k: torch.as_tensor(v).float().to(device) for k, v in obj.items()}


def build_mixed_context_batch(
    companions,
    cfg: PipelineConfig,
    text_ctx: Optional[torch.Tensor] = None,
    vlm: Optional[torch.Tensor] = None,
    visual_emb: Optional[torch.Tensor] = None,
    special_tokens: Optional[Dict[str, torch.Tensor]] = None,
    aligned_emb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched mixed context for training, [B, max_context_len, text_dim] f32:
    [VLM][<ipl> aligned][<prp> text][<img> visual], each part batched
    (text_ctx [B, Lt, text_dim] zero-padded, vlm [B, Lv, vlm_dim], visual_emb
    [B, C, F, h, w] latents, aligned_emb [B, La, text_dim]), sandwiched by the
    special tokens where given, then zero-padded or truncated."""
    td = cfg.dit.text_dim
    B = next((a.shape[0] for a in (text_ctx, vlm, visual_emb, aligned_emb) if a is not None), None)
    if B is None:
        raise ValueError("build_mixed_context_batch: no conditioning input")

    def tok(name):
        t = special_tokens[name]
        t = t if t.ndim == 2 else t[None]
        return t[None].float().expand(B, t.shape[0], td)

    parts: List[torch.Tensor] = []
    if vlm is not None:
        h = rms_norm(vlm, companions["vlm_norm"], cfg.dit.eps)
        parts.append(kernel_dense(companions["vlm_proj"], h).float())
    if aligned_emb is not None:
        a = aligned_emb.float()
        if special_tokens is not None and "<ipl_st>" in special_tokens:
            parts.extend([tok("<ipl_st>"), a, tok("<ipl_ed>")])
        else:
            parts.append(a)
    if text_ctx is not None:
        if special_tokens is not None:
            parts.extend([tok("<prp_st>"), text_ctx.float(), tok("<prp_ed>")])
        else:
            parts.append(text_ctx.float())
    if visual_emb is not None and "visual_context_adapter" in companions:
        vis = vca_apply(companions["visual_context_adapter"], visual_emb,
                        cfg.visual_context_adapter_patch_size, cfg.dit.eps).float()
        if special_tokens is not None:
            parts.extend([tok("<img_st>"), vis, tok("<img_ed>")])
        else:
            parts.append(vis)
    mixed = torch.cat([p.to(parts[0].device) for p in parts], dim=1)
    L = cfg.max_context_len
    if mixed.shape[1] > L:
        return mixed[:, :L]
    return torch.nn.functional.pad(mixed, (0, 0, 0, L - mixed.shape[1]))
