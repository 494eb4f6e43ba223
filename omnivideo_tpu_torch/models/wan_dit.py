"""Wan video diffusion transformer (port of omnivideo_tpu/models/wan_dit.py).

Patchify as a GEMM over the conv-compatible (c, pt, ph, pw) order, the
sinusoidal time embedding, 6-way f32 AdaLN per block, self-attention with
qk-norm and 3D RoPE, cross-attention over the full zero-padded embedded
context (no mask: the reference passes context_lens=None), a GELU-tanh FFN,
the 2-way modulated head and unpatchify.

Parameter names follow the reference WanModel's state dict (text_embedding.0,
blocks.i.self_attn.q, ffn.2, head.modulation, ...), so a reference state
dict loads with one reshape (the Conv3d patch embedding); io/jax_bridge.py
loads the JAX package's param pytrees. Modulation tables, norms and the head
stay f32; every other weight has the param dtype (cast_wan_params' split).

The residual stream is stored at `residual_dtype` (f32 for parity, bf16 the
CLI default); residual adds and norms compute in f32 either way. The
attention prologue has two forms, chosen by `qk_impl` as in JAX:
- "kernel" (the generate default): with qk_norm, head_dim % 128 == 0 and
  N ≤ 128, the fused qk_prep kernel feeds the bounded inference flash
  kernel its row-norm bounds (inference only: neither kernel has a
  backward); other configs fall back to the unfused chain;
- "unfused" (training): rms_norm → apply_rope → `ops.attention.attention`,
  which under autograd is the differentiable `flash_attention_train`.
On the card the flash kernels take head dim 128; other head dims raise there.
The elementwise sandwich between the stages (residual add + layer norm +
AdaLN modulation) has two forms, chosen by `ew_impl` as JAX's `ew_impl`:
- "unfused" (the default, as JAX resolves "auto" off the TPU): the residual
  add, `layer_norm` and the modulation as separate tensor ops;
- "kernel": the fused_adaln kernel (`ops/fused_adaln.py`) at the block's
  three sandwich sites when e has one timestep, d % 128 == 0 and the
  residual is stored at f32 (3 launches per block), and at the head when e
  has one timestep and d % 128 == 0, whatever the residual dtype (f32 out).
`remat` recomputes each block in the backward (torch.utils.checkpoint), and
`carry_dtype` stores the inter-block carry, and with remat the saved block
inputs, at that dtype while the block computes from f32 (`wan_dit_apply`).
Left out: the i2v k_img/img_emb branch, sequence/tensor parallelism, LoRA.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import WanDiTConfig
from ..device import resolve_device
from ..ops.attention import attention
from ..ops.flash_attention import flash_attention
from ..ops.fused_adaln import fused_adaln
from ..ops.norms import layer_norm, rms_norm
from ..ops.qk_prep import qk_prep
from ..ops.rope import apply_rope, rope_3d_tables


def dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ Wᵀ, then + b in the product's dtype (two roundings, as the JAX
    `_dense`). Mixed dtypes promote as in JAX; `dtype` casts both first."""
    w = lin.weight
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)
    y = F.linear(x.to(dt), w.to(dt))
    return y + lin.bias.to(dt)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """cat([cos, sin]) sinusoid, f32. The frequencies 10000^(−j/half) are the
    correctly rounded f32 values (f64 power of the f32 exponent), which is
    what XLA's pow gives; torch's f32 pow is off by an ulp on a few."""
    half = dim // 2
    pos = position.float()
    expo = -torch.arange(half, dtype=torch.float32, device=pos.device) / half
    freqs = torch.pow(10000.0, expo.double()).float()
    sinusoid = pos[..., None] * freqs
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)


def patchify(x: torch.Tensor, patch_size: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, F, H, W] → [B, L, C·pt·ph·pw] in the Conv3d (c, i, j, k) order."""
    B, C, Fr, H, W = x.shape
    pt, ph, pw = patch_size
    f, h, w = Fr // pt, H // ph, W // pw
    x = x.reshape(B, C, f, pt, h, ph, w, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(B, f * h * w, C * pt * ph * pw)


def unpatchify(x: torch.Tensor, grid: Tuple[int, int, int],
               patch_size: Tuple[int, int, int], out_dim: int) -> torch.Tensor:
    """[B, L, pt·ph·pw·c] → [B, c, F, H, W]."""
    B = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch_size
    x = x[:, : f * h * w].reshape(B, f, h, w, pt, ph, pw, out_dim)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(B, out_dim, f * pt, h * ph, w * pw)


QK_IMPLS = ("kernel", "unfused")
EW_IMPLS = ("kernel", "unfused")


class WanAux(NamedTuple):
    """Per-call tensors shared by every block."""

    e0: torch.Tensor  # [B, T, 6, dim] f32 AdaLN input
    context: torch.Tensor  # [B, Lc, dim] embedded context (param dtype)
    rope_cos: torch.Tensor  # [Lr, head_dim//2] f32
    rope_sin: torch.Tensor
    kv_lens: Optional[torch.Tensor]  # [B] int32 valid self-attn length, or None


class Gain(nn.Module):
    """A norm's per-channel weight (the reference WanRMSNorm's `weight`)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))


class AffineNorm(nn.Module):
    """Affine layer-norm parameters (the reference norm3's weight/bias)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))


class WanAttention(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.o = nn.Linear(dim, dim, **kw)
        self.norm_q = Gain(dim, device)
        self.norm_k = Gain(dim, device)


class WanBlock(nn.Module):
    """One WanAttentionBlock (wan_block_apply). x: [B, L, dim]."""

    def __init__(self, cfg: WanDiTConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.modulation = nn.Parameter(torch.zeros(1, 6, d, dtype=torch.float32, device=device))
        self.self_attn = WanAttention(d, dtype, device)
        self.cross_attn = WanAttention(d, dtype, device)
        self.norm3 = AffineNorm(d, device) if cfg.cross_attn_norm else None
        self.ffn = nn.Sequential(
            nn.Linear(d, cfg.ffn_dim, dtype=dtype, device=device),
            nn.GELU(approximate="tanh"),
            nn.Linear(cfg.ffn_dim, d, dtype=dtype, device=device),
        )

    def _fused_attn(self, aux: WanAux, q_raw, gq, rope_q, k_raw, gk, rope_k, v, kv_lens):
        cfg = self.cfg
        N, hd = cfg.num_heads, cfg.head_dim
        rq = (aux.rope_cos, aux.rope_sin) if rope_q else (None, None)
        rk = (aux.rope_cos, aux.rope_sin) if rope_k else (None, None)
        q, qn = qk_prep(q_raw, gq, rq[0], rq[1], N, cfg.eps)
        k, kn = qk_prep(k_raw, gk, rk[0], rk[1], N, cfg.eps)
        v = v.view(v.shape[0], v.shape[1], N, hd)
        return flash_attention(q, k, v, kv_lens=kv_lens, assume_normalized=True,
                               qk_row_norms=(qn, kn))

    def forward(self, x: torch.Tensor, aux: WanAux, qk_impl: str = "kernel",
                ew_impl: str = "unfused") -> torch.Tensor:
        cfg = self.cfg
        B, L, d = x.shape
        N, hd = cfg.num_heads, cfg.head_dim
        pdtype = self.self_attn.q.weight.dtype
        if qk_impl not in QK_IMPLS:
            raise ValueError(f"qk_impl {qk_impl!r} not in {QK_IMPLS}")
        if ew_impl not in EW_IMPLS:
            raise ValueError(f"ew_impl {ew_impl!r} not in {EW_IMPLS}")
        fuse_qk = qk_impl == "kernel" and cfg.qk_norm and hd % 128 == 0 and N <= 128
        rdt = x.dtype
        e = self.modulation.float()[None] + aux.e0  # [B, T, 6, d]
        e1, e2, e3, e4, e5, e6 = (e[:, :, i] for i in range(6))
        # the fused sandwich needs one modulation row per sample and the
        # residual stored at f32 (JAX wan_block_apply's condition)
        fused = ew_impl == "kernel" and e.shape[1] == 1 and d % 128 == 0 and rdt == torch.float32

        # --- self attention
        if fused:
            _, y = fused_adaln(x, mod_scale=e2[:, 0], mod_shift=e1[:, 0], eps=cfg.eps,
                               out_dtype=pdtype)
        else:
            xn = layer_norm(x, cfg.eps, out_f32=True)
            y = (xn * (1.0 + e2) + e1).to(pdtype)
        sa = self.self_attn
        if fuse_qk:
            o = self._fused_attn(aux, dense(sa.q, y), sa.norm_q.weight, True,
                                 dense(sa.k, y), sa.norm_k.weight, True,
                                 dense(sa.v, y), aux.kv_lens)
        else:
            q = rms_norm(dense(sa.q, y), sa.norm_q.weight, cfg.eps).view(B, L, N, hd)
            k = rms_norm(dense(sa.k, y), sa.norm_k.weight, cfg.eps).view(B, L, N, hd)
            v = dense(sa.v, y).view(B, L, N, hd)
            q = apply_rope(q, aux.rope_cos, aux.rope_sin)
            k = apply_rope(k, aux.rope_cos, aux.rope_sin)
            o = attention(q, k, v, kv_lens=aux.kv_lens, assume_normalized=cfg.qk_norm)
        o = dense(sa.o, o.reshape(B, L, d))

        # --- cross attention over the full padded context
        if fused and self.norm3 is not None:
            x, xq = fused_adaln(x, o, e3[:, 0], self.norm3.weight, self.norm3.bias,
                                eps=cfg.eps, out_dtype=pdtype)
        else:
            x = (x.float() + o.float() * e3).to(rdt)
            if self.norm3 is not None:
                xn = layer_norm(x, cfg.eps, scale=self.norm3.weight, bias=self.norm3.bias)
            else:
                xn = x
            xq = xn.to(pdtype)
        ca = self.cross_attn
        ctx = aux.context
        Lc = ctx.shape[1]
        if fuse_qk:
            o = self._fused_attn(aux, dense(ca.q, xq), ca.norm_q.weight, False,
                                 dense(ca.k, ctx), ca.norm_k.weight, False,
                                 dense(ca.v, ctx), None)
        else:
            q = rms_norm(dense(ca.q, xq), ca.norm_q.weight, cfg.eps).view(B, L, N, hd)
            k = rms_norm(dense(ca.k, ctx), ca.norm_k.weight, cfg.eps).view(B, Lc, N, hd)
            v = dense(ca.v, ctx).view(B, Lc, N, hd)
            o = attention(q, k, v, kv_lens=None, assume_normalized=cfg.qk_norm)
        o = dense(ca.o, o.reshape(B, L, d))

        # --- ffn
        if fused:
            x, y = fused_adaln(x, o, mod_scale=e5[:, 0], mod_shift=e4[:, 0], eps=cfg.eps,
                               out_dtype=pdtype)
        else:
            x = (x.float() + o.float()).to(rdt)
            xn = layer_norm(x, cfg.eps, out_f32=True)
            y = (xn * (1.0 + e5) + e4).to(pdtype)
        y = dense(self.ffn[2], gelu_tanh(dense(self.ffn[0], y)))
        return (x.float() + y.float() * e6).to(rdt)


class WanHead(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device):
        super().__init__()
        d = cfg.dim
        out = int(np.prod(cfg.patch_size)) * cfg.out_dim
        self.head = nn.Linear(d, out, dtype=torch.float32, device=device)
        self.modulation = nn.Parameter(torch.zeros(1, 2, d, dtype=torch.float32, device=device))


class WanDiT(nn.Module):
    """The Wan DiT backbone (wan_dit_apply).

    Built with the JAX package's init distributions (Xavier linears,
    normal-0.02 embeddings, zero head) from an explicit torch.Generator; for
    real weights load a state dict through io/jax_bridge.py."""

    def __init__(self, cfg: WanDiTConfig, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.dim
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        in_patch = cfg.in_dim * int(np.prod(cfg.patch_size))
        self.patch_embedding = nn.Linear(in_patch, d, **kw)
        self.text_embedding = nn.Sequential(
            nn.Linear(cfg.text_dim, d, **kw), nn.GELU(approximate="tanh"),
            nn.Linear(d, d, **kw))
        self.time_embedding = nn.Sequential(
            nn.Linear(cfg.freq_dim, d, **kw), nn.SiLU(), nn.Linear(d, d, **kw))
        self.time_projection = nn.Sequential(nn.SiLU(), nn.Linear(d, 6 * d, **kw))
        self.blocks = nn.ModuleList(WanBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.head = WanHead(cfg, device)
        self._rope_cache = {}
        self.init_weights(generator)

    @property
    def param_dtype(self) -> torch.dtype:
        return self.patch_embedding.weight.dtype

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Xavier-uniform linears with zero bias, normal(0.02) text/time
        embeddings, normal/√d modulation tables, ones/zeros norms, zero head."""
        d = self.cfg.dim
        dev = self.patch_embedding.weight.device

        def draw(p: torch.Tensor, kind: str, scale: float = 1.0):
            t = torch.empty(p.shape, dtype=torch.float32, device=dev)
            if kind == "normal":
                t.normal_(0.0, scale, generator=generator)
            else:  # xavier uniform over [out, in]
                a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                t.uniform_(-a, a, generator=generator)
            p.copy_(t)

        normal_lins = {id(m) for m in (self.text_embedding[0], self.text_embedding[2],
                                       self.time_embedding[0], self.time_embedding[2])}
        for m in self.modules():
            if isinstance(m, nn.Linear):
                if m is self.head.head:
                    m.weight.zero_()
                elif id(m) in normal_lins:
                    draw(m.weight, "normal", 0.02)
                else:
                    draw(m.weight, "xavier")
                m.bias.zero_()
            elif isinstance(m, Gain):
                m.weight.fill_(1.0)
            elif isinstance(m, AffineNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for blk in self.blocks:
            draw(blk.modulation, "normal", d**-0.5)
        draw(self.head.modulation, "normal", d**-0.5)

    def rope_tables(self, grid: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """f32 cos/sin [F·H·W, head_dim//2] on the model's device, cached per grid."""
        if grid not in self._rope_cache:
            cfg = self.cfg
            cos, sin = rope_3d_tables(grid, cfg.head_dim, cfg.rope_max_seq_len, cfg.rope_theta)
            dev = self.patch_embedding.weight.device
            self._rope_cache[grid] = (torch.tensor(cos, device=dev), torch.tensor(sin, device=dev))
        return self._rope_cache[grid]

    def embed_context(self, context: torch.Tensor) -> torch.Tensor:
        """text_embedding MLP over the zero-padded context [B, Lc, text_dim]."""
        h = dense(self.text_embedding[0], context.to(self.param_dtype))
        return dense(self.text_embedding[2], gelu_tanh(h))

    def time_embeddings(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """e: [B, T, dim] f32; e0: [B, T, 6, dim] f32. t: [B] or [B, L]."""
        if t.ndim == 1:
            t = t[:, None]
        B, T = t.shape
        emb = sinusoidal_embedding_1d(self.cfg.freq_dim, t)
        f32 = torch.float32
        e = dense(self.time_embedding[2], F.silu(dense(self.time_embedding[0], emb, f32)), f32)
        e0 = dense(self.time_projection[1], F.silu(e), f32)
        return e, e0.view(B, T, 6, self.cfg.dim)

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        context: torch.Tensor,
        seq_len: Optional[int] = None,
        context_embedded: bool = False,
        residual_dtype: Optional[torch.dtype] = None,
        qk_impl: str = "kernel",
        remat: bool = False,
        carry_dtype: Optional[torch.dtype] = None,
        ew_impl: str = "unfused",
    ) -> torch.Tensor:
        """x: [B, C_in, F, H, W] noisy latents; t: [B] timesteps; context:
        [B, Lc, text_dim] (or [B, Lc, dim] if context_embedded), padded to
        the context budget. seq_len pads the video tokens (masked as KV).
        qk_impl: "kernel" or "unfused" (the training chain). ew_impl:
        "kernel" (the fused AdaLN sandwich) or "unfused". remat: recompute
        each block in the backward. carry_dtype: dtype of the inter-block
        carry (blocks compute from f32); exclusive with a non-f32
        residual_dtype. Returns the velocity [B, C_out, F, H, W] f32."""
        cfg = self.cfg
        B = x.shape[0]
        pt, ph, pw = cfg.patch_size
        grid = (x.shape[2] // pt, x.shape[3] // ph, x.shape[4] // pw)
        L_nat = grid[0] * grid[1] * grid[2]
        L = seq_len if seq_len is not None else L_nat
        if L < L_nat:
            raise ValueError(f"seq_len {L} < token count {L_nat}")
        pdtype = self.param_dtype
        h = dense(self.patch_embedding, patchify(x.to(pdtype), cfg.patch_size))
        kv_lens = None
        if L > L_nat:
            h = F.pad(h, (0, 0, 0, L - L_nat))
            kv_lens = torch.full((B,), L_nat, dtype=torch.int32, device=h.device)
        e, e0 = self.time_embeddings(t)
        if not context_embedded:
            context = self.embed_context(context)
        cos, sin = self.rope_tables(grid)
        aux = WanAux(e0=e0, context=context.to(pdtype), rope_cos=cos, rope_sin=sin,
                     kv_lens=kv_lens)
        bandwidth = residual_dtype is not None and residual_dtype != torch.float32
        if bandwidth and carry_dtype not in (None, residual_dtype):
            raise ValueError(f"carry_dtype {carry_dtype} with residual_dtype {residual_dtype}")
        cdt = carry_dtype if carry_dtype is not None and not bandwidth else torch.float32

        def block_fn(blk, xx):
            if bandwidth or cdt == torch.float32:
                return blk(xx, aux, qk_impl, ew_impl)
            return blk(xx.float(), aux, qk_impl, ew_impl).to(cdt)

        hf = h.to(residual_dtype if bandwidth else cdt)
        for blk in self.blocks:
            if remat:
                hf = checkpoint(block_fn, blk, hf, use_reentrant=False)
            else:
                hf = block_fn(blk, hf)
        return self._head(hf.float(), e, grid, ew_impl)

    def _head(self, hf: torch.Tensor, e: torch.Tensor, grid, ew_impl: str) -> torch.Tensor:
        """2-way modulation with e (not e0), f32, then unpatchify."""
        cfg = self.cfg
        eh = self.head.modulation.float()[None] + e[:, :, None]  # [B, T, 2, d]
        if ew_impl == "kernel" and eh.shape[1] == 1 and cfg.dim % 128 == 0:
            _, y = fused_adaln(hf, mod_scale=eh[:, 0, 1], mod_shift=eh[:, 0, 0], eps=cfg.eps,
                               out_dtype=torch.float32)
        else:
            xn = layer_norm(hf, cfg.eps, out_f32=True)
            y = xn * (1.0 + eh[:, :, 1]) + eh[:, :, 0]
        out = dense(self.head.head, y, torch.float32)
        return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)
