"""CLIP vision tower (XLM-Roberta-CLIP ViT-H/14) for image-to-video (port of
omnivideo_tpu/models/clip_vision.py).

A pre-LN ViT: the patch embedding as a GEMM over (c, i, j) patches, a cls
token and learned positions, the pre-norm, blocks of LayerNorm → fused qkv →
attention → proj and LayerNorm → MLP (exact GELU); `use_31_block=True` (what
the i2v pipeline takes) returns the penultimate block's tokens [B, 257, 1280]
at 224 px. Attention is plain torch: einsum logits in f32, softmax, einsum,
as JAX computes it outside any kernel (head dim 80 has no flash row).

Parameters keep the reference VisionTransformer's names (patch_embedding,
cls_embedding, pos_embedding, pre_norm, transformer.i.{norm1, attn.to_qkv,
attn.proj, norm2, mlp.0, mlp.2}, post_norm), so a reference state dict
loads by name (`clip_vision_from_state_dict`; its `head` projection, which
the i2v path never reads, is left out). Matmuls promote their operands as
JAX's `@` does: f32 images through bf16 weights compute in f32.

`preprocess_image` needs no Pillow: the frame is resized on its device by
utils/video.py's antialiased bicubic in Pillow's two rounded passes (within
one uint8 level of Pillow's BICUBIC, ROADMAP §3), then scaled to [0, 1] and
normalized with CLIP_MEAN / CLIP_STD.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.norms import layer_norm
from ..utils.video import resize_frames
from .wan_dit import dense


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    num_heads: int = 16
    num_layers: int = 32
    pre_norm: bool = True
    norm_eps: float = 1e-5
    activation: str = "gelu"  # open_clip's ViT-H/14 uses exact GELU

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


# the reference CLIPModel's ImageNet-CLIP normalization
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class _LN(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))


class _Attn(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.to_qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = nn.Linear(dim, dim, dtype=dtype, device=device)


class _Block(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype, device):
        super().__init__()
        mid = int(cfg.dim * cfg.mlp_ratio)
        self.norm1 = _LN(cfg.dim, dtype, device)
        self.attn = _Attn(cfg.dim, dtype, device)
        self.norm2 = _LN(cfg.dim, dtype, device)
        self.mlp = nn.Sequential(nn.Linear(cfg.dim, mid, dtype=dtype, device=device), nn.GELU(),
                                 nn.Linear(mid, cfg.dim, dtype=dtype, device=device))


class CLIPVision(nn.Module):
    """The tower's parameters under the reference's names; the forward is
    `clip_vision_forward`."""

    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, p = cfg.dim, cfg.patch_size
        kw = dict(dtype=dtype, device=device)
        self.patch_embedding = nn.Conv2d(3, d, p, p, bias=not cfg.pre_norm, **kw)
        self.cls_embedding = nn.Parameter(torch.zeros(1, 1, d, **kw))
        self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.num_tokens, d, **kw))
        self.pre_norm = _LN(d, dtype, device) if cfg.pre_norm else None
        self.transformer = nn.ModuleList(_Block(cfg, dtype, device)
                                         for _ in range(cfg.num_layers))
        self.post_norm = _LN(d, dtype, device)

    def forward(self, images: torch.Tensor, use_31_block: bool = True) -> torch.Tensor:
        return clip_vision_forward(self, self.cfg, images, use_31_block)


def _ln(x: torch.Tensor, p: _LN, eps: float) -> torch.Tensor:
    return layer_norm(x, eps, scale=p.weight, bias=p.bias)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="none")


@torch.no_grad()
def clip_vision_forward(model: CLIPVision, cfg: CLIPVisionConfig, images: torch.Tensor,
                        use_31_block: bool = True) -> torch.Tensor:
    """images: [B, 3, H, W] normalized → [B, 1 + N, dim] tokens: the
    penultimate block's with use_31_block (no post-norm), else the last
    block's post-normed."""
    B, C, H, W = images.shape
    p = cfg.patch_size
    x = images.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(B, (H // p) * (W // p), C * p * p)
    pe = model.patch_embedding
    w = pe.weight.reshape(pe.weight.shape[0], -1)
    dt = torch.promote_types(x.dtype, w.dtype)
    x = F.linear(x.to(dt), w.to(dt))
    if pe.bias is not None:
        x = x + pe.bias.to(dt)
    cls = model.cls_embedding.to(x.dtype).expand(B, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + model.pos_embedding.to(x.dtype)
    if cfg.pre_norm:
        x = _ln(x, model.pre_norm, cfg.norm_eps)
    n_blocks = cfg.num_layers - 1 if use_31_block else cfg.num_layers
    N, hd = cfg.num_heads, cfg.dim // cfg.num_heads
    L = x.shape[1]
    for blk in model.transformer[:n_blocks]:
        qkv = dense(blk.attn.to_qkv, _ln(x, blk.norm1, cfg.norm_eps)).view(B, L, 3, N, hd)
        q, k, v = qkv.unbind(2)
        logits = torch.einsum("bind,bjnd->bnij", q.float(), k.float())
        probs = torch.softmax(logits * hd**-0.5, dim=-1).to(v.dtype)
        o = torch.einsum("bnij,bjnd->bind", probs.float(), v.float()).to(x.dtype)
        x = x + dense(blk.attn.proj, o.reshape(B, L, cfg.dim))
        h = _act(dense(blk.mlp[0], _ln(x, blk.norm2, cfg.norm_eps)), cfg.activation)
        x = x + dense(blk.mlp[2], h)
    if not use_31_block:
        x = _ln(x, model.post_norm, cfg.norm_eps)
    return x


@torch.no_grad()
def clip_vision_from_state_dict(sd: Mapping, cfg: CLIPVisionConfig, prefix: str = "",
                                dtype: torch.dtype = torch.float32, device="cuda") -> CLIPVision:
    """A reference VisionTransformer state dict (tensors or numpy arrays;
    names under `prefix`, e.g. "visual." in the open-clip file) → a
    CLIPVision of `cfg` on `device`. The `head` projection and any name
    outside the tower are not read; a missing post_norm keeps ones/zeros."""
    model = CLIPVision(cfg, dtype=dtype, device=device)
    for name, param in model.named_parameters():
        key = prefix + name
        if key not in sd:
            if name.startswith("post_norm."):
                continue
            raise KeyError(f"CLIP state dict lacks {key!r}")
        src = sd[key]
        src = src.detach() if torch.is_tensor(src) else torch.from_numpy(np.array(src, np.float32))
        if src.numel() != param.numel():
            raise ValueError(f"{key}: {tuple(src.shape)} does not fit {tuple(param.shape)}")
        param.copy_(src.reshape(param.shape))
    return model


@torch.no_grad()
def init_clip_vision(cfg: CLIPVisionConfig, dtype: torch.dtype = torch.float32, device="cuda",
                     generator: Optional[torch.Generator] = None,
                     scale: float = 0.02) -> CLIPVision:
    """Random weights (tests and smoke runs): normal·scale for the patch
    embedding, cls and positions and every Linear weight, zero biases,
    ones/zeros norms, drawn in f32 from `generator` on `device`."""
    model = CLIPVision(cfg, dtype=dtype, device=device)
    for param in model.parameters():
        if param.ndim >= 2:
            t = torch.empty(param.shape, dtype=torch.float32, device=param.device)
            param.copy_(t.normal_(0.0, scale, generator=generator))
    return model


def uint8_frame(img, device) -> torch.Tensor:
    """An [H, W, 3] frame (array or tensor) as uint8 on `device`; a float
    frame in [-1, 1] becomes ((x + 1)·127.5) truncated, as JAX casts it."""
    x = torch.as_tensor(img if torch.is_tensor(img) else np.asarray(img)).to(device)
    if x.dtype != torch.uint8:
        x = ((x.float().clamp(-1, 1) + 1) * 127.5).to(torch.uint8)
    return x


def preprocess_image(img, size: int = 224, device="cuda") -> torch.Tensor:
    """[H, W, 3] frame (`uint8_frame`'s) → [1, 3, size, size] f32 CLIP
    input on `device`: resized with Pillow's BICUBIC arithmetic on the
    device, /255, then (x − CLIP_MEAN) / CLIP_STD."""
    dev = resolve_device(device)
    x = resize_frames(uint8_frame(img, dev)[None], (size, size))[0].float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    return ((x - mean) / std).permute(2, 0, 1)[None].contiguous()
