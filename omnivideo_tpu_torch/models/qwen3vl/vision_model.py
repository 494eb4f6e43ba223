"""Qwen3-VL vision tower (port of omnivideo_tpu/models/qwen3vl/vision_model.py).

Encodes one image or video into LLM-space tokens (HF Qwen3VLVisionModel):

- patch embed: the stride == kernel Conv3d over (tp, p, p) pixel patches as
  one GEMM over the processor's flattened patches;
- learned absolute position embeddings bilinearly interpolated from the
  num_grid_per_side² table to the (h, w) grid (indices and weights planned
  on the host, f32), tiled over frames and reordered to merge-block order;
- 2-D rotary embeddings over (row, col) positions in merge-block order,
  tables in f64 numpy cast to f32, applied to the packed [L, N·hd] q/k in
  `rope_dtype` (bf16 through the engine, f32 the parity mode);
- pre-LN blocks: packed-qkv attention per temporal patch group (HF's
  cu_seqlens segments) through the flash kernel at head dim 72 with the
  guarded bounded softmax (`assume_normalized=True`, as the JAX tower), and
  a GELU-tanh MLP;
- the 2×2 patch merger to the LLM width, plus the deepstack mergers over
  the outputs of the tapped blocks.

Dtypes follow the JAX tower: each product runs in the promotion of its
operands' dtypes (`dense`), and the f32 interpolated position embedding is
added without a cast, so with bf16 weights the residual stream, the
products and the tower's outputs are f32. The one departure: q/k/v enter
attention in the weight dtype (bf16 on the card, the kernel's input type),
where the JAX tower hands its flash kernel the f32 values.
Parameter names follow the HF checkpoint's `model.visual.*` names; the patch
embedding is a Linear over the flattened Conv3d weight.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configs.qwen3vl import Qwen3VLVisionConfig
from ...ops.flash_attention import flash_attention
from ...ops.norms import layer_norm
from ..wan_dit import AffineNorm, dense
from .text_model import rotate_half

LN_EPS = 1e-6


@functools.lru_cache(maxsize=16)
def _pos_interp_plan(h: int, w: int, grid_side: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear interpolation (indices [4, h·w] int32, weights [4, h·w] f32)
    into the learned position table (HF fast_pos_embed_interpolate)."""
    h_idx = np.linspace(0, grid_side - 1, h)
    w_idx = np.linspace(0, grid_side - 1, w)
    hf_, wf_ = h_idx.astype(np.int32), w_idx.astype(np.int32)
    hc = np.clip(hf_ + 1, None, grid_side - 1)
    wc = np.clip(wf_ + 1, None, grid_side - 1)
    dh, dw = h_idx - hf_, w_idx - wf_
    idx = np.stack([
        (hf_[:, None] * grid_side + wf_[None]).ravel(),
        (hf_[:, None] * grid_side + wc[None]).ravel(),
        (hc[:, None] * grid_side + wf_[None]).ravel(),
        (hc[:, None] * grid_side + wc[None]).ravel(),
    ])
    wgt = np.stack([
        ((1 - dh)[:, None] * (1 - dw)[None]).ravel(),
        ((1 - dh)[:, None] * dw[None]).ravel(),
        (dh[:, None] * (1 - dw)[None]).ravel(),
        (dh[:, None] * dw[None]).ravel(),
    ])
    return idx.astype(np.int32), wgt.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _rope_table(t: int, h: int, w: int, head_dim: int, merge: int,
                theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin [t·h·w, head_dim] f32 over (row, col) positions in merge-block
    order, computed in f64."""
    dim = head_dim // 2  # rotary dim split between row and col
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    mh, mw = h // merge, w // merge
    ones = np.ones((mh, mw, merge, merge), np.int64)
    rows = ((np.arange(mh)[:, None, None, None] * merge
             + np.arange(merge)[None, None, :, None]) * ones).reshape(-1)
    cols = ((np.arange(mw)[None, :, None, None] * merge
             + np.arange(merge)[None, None, None, :]) * ones).reshape(-1)
    freqs = np.concatenate([rows[:, None] * inv[None], cols[:, None] * inv[None]], axis=1)
    freqs = np.tile(freqs, (t, 1))
    emb = np.concatenate([freqs, freqs], axis=1)  # [L, head_dim]
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def merge_order_pos_embed(pe: torch.Tensor, t: int, h: int, w: int, merge: int) -> torch.Tensor:
    """[h·w, D] → tiled over t frames, permuted to merge-block order [t·h·w, D]."""
    D = pe.shape[-1]
    pe = pe.repeat(t, 1).reshape(t, h // merge, merge, w // merge, merge, D)
    return pe.permute(0, 1, 3, 2, 4, 5).reshape(-1, D)


def rotate_half_packed(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """rotate_half of every head of a packed [L, N·hd] tensor (exact: each
    output is ± one input)."""
    L = x.shape[0]
    return rotate_half(x.view(L, num_heads, -1)).reshape(L, -1)


class VisionAttention(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = nn.Linear(dim, dim, dtype=dtype, device=device)


class VisionMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, device):
        super().__init__()
        self.linear_fc1 = nn.Linear(dim, hidden, dtype=dtype, device=device)
        self.linear_fc2 = nn.Linear(hidden, dim, dtype=dtype, device=device)


class VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen3VLVisionConfig, dtype, device):
        super().__init__()
        D = cfg.hidden_size
        self.norm1 = AffineNorm(D, device)
        self.norm2 = AffineNorm(D, device)
        self.attn = VisionAttention(D, dtype, device)
        self.mlp = VisionMLP(D, cfg.intermediate_size, dtype, device)


class PatchMerger(nn.Module):
    """LN (pre- or post-shuffle) → fc1 → GELU (exact) → fc2, over merge²
    neighbouring tokens."""

    def __init__(self, cfg: Qwen3VLVisionConfig, postshuffle: bool, dtype, device):
        super().__init__()
        D = cfg.hidden_size
        self.unit = cfg.spatial_merge_size**2 * D
        self.postshuffle = postshuffle
        self.norm = AffineNorm(self.unit if postshuffle else D, device)
        self.linear_fc1 = nn.Linear(self.unit, self.unit, dtype=dtype, device=device)
        self.linear_fc2 = nn.Linear(self.unit, cfg.out_hidden_size, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        if self.postshuffle:
            y = layer_norm(x.reshape(-1, self.unit), LN_EPS, n.weight, n.bias)
        else:
            y = layer_norm(x, LN_EPS, n.weight, n.bias).reshape(-1, self.unit)
        return dense(self.linear_fc2, F.gelu(dense(self.linear_fc1, y)))


class Qwen3VLVision(nn.Module):
    """The vision tower. `forward(patches, grid)` → (tokens [L/merge²,
    out_hidden], deepstack list of the same shape)."""

    def __init__(self, cfg: Qwen3VLVisionConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.patch_embed = nn.Linear(cfg.patch_dim, D, dtype=dtype, device=device)
        self.pos_embed = nn.Embedding(cfg.num_position_embeddings, D, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(VisionBlock(cfg, dtype, device) for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg, False, dtype, device)
        self.deepstack_merger_list = nn.ModuleList(
            PatchMerger(cfg, True, dtype, device) for _ in cfg.deepstack_visual_indexes)
        self._tables: Dict[Tuple[int, int, int], Tuple[torch.Tensor, ...]] = {}

    def _grid_tables(self, grid: Tuple[int, int, int]):
        """(pos-interp idx, weights, packed cos, packed sin) on the device,
        cached per grid."""
        if grid not in self._tables:
            cfg = self.cfg
            t, h, w = grid
            dev = self.patch_embed.weight.device
            idx, wgt = _pos_interp_plan(h, w, cfg.num_grid_per_side)
            cos, sin = _rope_table(t, h, w, cfg.head_dim, cfg.spatial_merge_size)
            rdt = getattr(torch, cfg.rope_dtype)
            packed = [torch.tensor(a, device=dev).to(rdt).repeat(1, cfg.num_heads)
                      for a in (cos, sin)]
            self._tables[grid] = (torch.tensor(idx, device=dev, dtype=torch.long),
                                  torch.tensor(wgt, device=dev), *packed)
        return self._tables[grid]

    def _block(self, blk: VisionBlock, x: torch.Tensor, cos_p, sin_p, t: int) -> torch.Tensor:
        cfg = self.cfg
        N, hd = cfg.num_heads, cfg.head_dim
        L = x.shape[0]
        rdt = cos_p.dtype
        adt = blk.attn.qkv.weight.dtype  # attention's input dtype
        hn = layer_norm(x, LN_EPS, blk.norm1.weight, blk.norm1.bias)
        qkv = dense(blk.attn.qkv, hn)  # [L, 3·N·hd]
        q2, k2, v2 = qkv[:, :N * hd], qkv[:, N * hd:2 * N * hd], qkv[:, 2 * N * hd:]
        q = (q2.to(rdt) * cos_p + rotate_half_packed(q2, N).to(rdt) * sin_p).to(x.dtype)
        k = (k2.to(rdt) * cos_p + rotate_half_packed(k2, N).to(rdt) * sin_p).to(x.dtype)
        # one attention segment per temporal patch group: t is the batch
        hw = L // t
        q, k, v = (a.to(adt).contiguous().view(t, hw, N, hd) for a in (q, k, v2))
        o = flash_attention(q, k, v, assume_normalized=True)
        x = x + dense(blk.attn.proj, o.reshape(L, N * hd).to(x.dtype))
        hn = layer_norm(x, LN_EPS, blk.norm2.weight, blk.norm2.bias)
        h = dense(blk.mlp.linear_fc1, hn)
        h = F.gelu(h, approximate="tanh" if cfg.hidden_act == "gelu_pytorch_tanh" else "none")
        return x + dense(blk.mlp.linear_fc2, h)

    @torch.profiler.record_function("qwen3vl.vision")
    def forward(self, patches: torch.Tensor, grid: Tuple[int, int, int]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """patches: [t·h·w, C·tp·p·p] in processor order; grid: (t, h, w).
        Runs under the profiler range "qwen3vl.vision"."""
        cfg = self.cfg
        grid = tuple(int(g) for g in grid)
        t, h, w = grid
        if patches.shape != (t * h * w, cfg.patch_dim):
            raise ValueError(f"patches {tuple(patches.shape)} do not fit grid {grid}")
        w_pe = self.patch_embed.weight
        idx, wgt, cos_p, sin_p = self._grid_tables(grid)
        x = dense(self.patch_embed, patches.to(w_pe.device))
        pe = torch.einsum("kl,kld->ld", wgt, self.pos_embed.weight[idx].float())
        x = x + merge_order_pos_embed(pe, t, h, w, cfg.spatial_merge_size)  # promotes to f32
        taps = {i: j for j, i in enumerate(cfg.deepstack_visual_indexes)}
        deepstack: List[torch.Tensor] = [None] * len(taps)
        for i, blk in enumerate(self.blocks):
            x = self._block(blk, x, cos_p, sin_p, t)
            if i in taps:
                deepstack[taps[i]] = self.deepstack_merger_list[taps[i]](x)
        return self.merger(x), deepstack
