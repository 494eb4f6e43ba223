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
`sp` (an `SPConfig`) runs the forward sequence-parallel over a process
group: every rank embeds patches, time and context; each keeps only its
token shard of the padded sequence (and the RoPE rows at its global
positions) through the blocks; self-attention goes through Ulysses, the
ring or the hybrid of both (`parallel/`); cross-attention takes the rank's
q shard against the whole context with no communication; the head's output
shards are all-gathered, the pad dropped and the result unpatchified on
every rank (`SPConfig.gather`, differentiable: its backward hands each
rank its own slice of the grad, since every rank computes the same loss
from the gathered output). `SPConfig(mode="tp")` is tensor parallelism
instead: the sequence stays whole, the blocks' weights are the Megatron
split of parallel/sharding.py (`dense` runs them through
parallel/tp.py's `tp_dense`), q and k are RMS-normed over the whole dim
across the 'tensor' ranks, and each rank attends its N/tp heads. Under SP
and TP `qk_impl` and `ew_impl` are "unfused", as JAX forces.

The i2v variant (`cfg.model_type == "i2v"`): `forward(..., y, clip_fea)`
concatenates `y` (the first frame's mask and latents) to x on the channels
before patchify, and prepends `img_emb`'s projection of the CLIP tokens
(affine LayerNorm, Linear, exact GELU, Linear, affine LayerNorm; the
reference's `img_emb.proj.{0,1,3,4}`) to the embedded context. Each block's
cross-attention then takes the first IMG_TOKENS (257) context tokens as the
image, with their own `k_img`, `v_img` and `norm_k_img`: two attentions
over the text and over the image tokens, each without kv_lens and bounded
under qk_norm, summed in the attention's dtype before `o`. Under "kernel"
(outside autograd) q, the text keys and the image keys take the fused
qk_prep prologue and the two attentions run as one `flash_attention_pair`
launch on their row-norm bounds, where JAX's `"k_img" not in ca` guard
takes the unfused chain and two calls (ROADMAP §3); under "unfused", and
under grad, q and both keys go through the unfused rms_norm chain and two
`attention` calls, as in JAX. The i2v model has no tensor-parallel path
(`k_img`/`v_img` are not split).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import WanDiTConfig
from ..device import resolve_device
from ..ops.attention import attention
from ..ops.flash_attention import flash_attention, flash_attention_pair
from ..ops.fused_adaln import fused_adaln
from ..ops.lora import has_lora, lora_delta
from ..ops.norms import layer_norm, rms_norm
from ..ops.qk_prep import qk_prep
from ..ops.rope import apply_rope, rope_3d_tables
from ..parallel.ring import RING_IMPLS, hybrid_attention, ring_attention
from ..parallel.tp import TP_AXIS, tp_dense, tp_head_attention, tp_rms_norm
from ..parallel.ulysses import ulysses_attention


def dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ Wᵀ, then + b in the product's dtype (two roundings, as the JAX
    `_dense`). Mixed dtypes promote as in JAX; `dtype` casts both first. An
    adapted Linear adds its LoRA delta before the bias (ops/lora.py, A and
    B in x's dtype). A tensor-parallel weight (a DTensor) runs through
    `tp_dense`."""
    w = lin.weight
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)
    if isinstance(w, DTensor):
        return tp_dense(lin, x, dt)
    x = x.to(dt)
    y = F.linear(x, w.to(dt))
    if has_lora(lin):
        y = y + lora_delta(lin, x, y.dtype)
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


SP_MODES = ("ulysses", "ring", "hybrid", "tp")


class _GatherSeq(torch.autograd.Function):
    """all_gather along dim 1 in rank order; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.n = dist.get_rank(group), n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, 1)[ctx.rank], None


@dataclasses.dataclass(frozen=True)
class SPConfig:
    """Sequence parallelism of the DiT forward (JAX `SPConfig`).

    mesh: a `parallel.mesh.create_mesh` DeviceMesh. mode: "ulysses"
    (all-to-all head scatter over `seq_axis`), "ring" (K/V rotation over
    `seq_axis`, `ring_impl` "ppermute" or "pallas": JAX's two names, both
    running the ring-step kernel with each transfer posted before the
    launch), "hybrid" (Ulysses over `ulysses_axis` inside, the
    ring over `seq_axis` outside; rank (u, r) holds token shard u·n_seq +
    r) or "tp" (no token shards: heads over `tp_axis`, the weights split by
    parallel/sharding.py `shard_params`; sp_size 1)."""

    mesh: Any
    mode: str = "ulysses"
    seq_axis: str = "seq"
    ulysses_axis: str = "fsdp"
    ring_impl: str = "ppermute"
    tp_axis: str = TP_AXIS

    def __post_init__(self):
        if self.mode not in SP_MODES:
            raise ValueError(f"sp mode {self.mode!r} not in {SP_MODES}")
        if self.ring_impl not in RING_IMPLS:
            raise ValueError(f"ring_impl {self.ring_impl!r} not in {RING_IMPLS}")

    def _axes(self) -> Tuple[str, ...]:
        """Mesh axes the token shards span, outer first."""
        if self.mode == "tp":
            return ()
        return (self.ulysses_axis, self.seq_axis) if self.mode == "hybrid" else (self.seq_axis,)

    @property
    def tp_group(self):
        """The 'tensor' process group under mode "tp", else None."""
        return self.mesh.get_group(self.tp_axis) if self.mode == "tp" else None

    @property
    def sp_size(self) -> int:
        return math.prod(dist.get_world_size(self.mesh.get_group(a)) for a in self._axes())

    @property
    def shard_index(self) -> int:
        i = 0
        for a in self._axes():
            i = i * dist.get_world_size(self.mesh.get_group(a)) + self.mesh.get_local_rank(a)
        return i

    def attention(self, q, k, v, kv_lens, assume_normalized: bool) -> torch.Tensor:
        """Self-attention of this rank's token shards; kv_lens is global."""
        if self.mode == "tp":
            return tp_head_attention(q, k, v, kv_lens=kv_lens,
                                     assume_normalized=assume_normalized)
        seq = self.mesh.get_group(self.seq_axis)
        if self.mode == "ulysses":
            return ulysses_attention(q, k, v, seq, kv_lens=kv_lens,
                                     assume_normalized=assume_normalized)
        if self.mode == "ring":
            return ring_attention(q, k, v, seq, impl=self.ring_impl, kv_lens=kv_lens)
        return hybrid_attention(q, k, v, self.mesh.get_group(self.ulysses_axis), seq,
                                ring_impl=self.ring_impl, kv_lens=kv_lens)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L/n, ...] shards → [B, L, ...] in shard order, on every rank.
        Differentiable: the backward is this rank's slice of the grad (not a
        sum over the ranks: each computes the same loss from the output)."""
        for a in reversed(self._axes()):  # inner axis first
            x = _GatherSeq.apply(x, self.mesh.get_group(a))
        return x


class WanAux(NamedTuple):
    """Per-call tensors shared by every block."""

    e0: torch.Tensor  # [B, T, 6, dim] f32 AdaLN input
    context: torch.Tensor  # [B, Lc, dim] embedded context (param dtype)
    rope_cos: torch.Tensor  # [Lr, head_dim//2] f32 (under SP: this shard's rows)
    rope_sin: torch.Tensor
    kv_lens: Optional[torch.Tensor]  # [B] int32 valid self-attn length (global), or None
    sp: Optional[SPConfig] = None


class Prologue(NamedTuple):
    """WanDiT.prologue's result: the embedded tokens h [B, L, dim] (param
    dtype), e [B, T, dim] f32 for the head, the blocks' WanAux, the grid."""

    h: torch.Tensor
    e: torch.Tensor
    aux: WanAux
    grid: Tuple[int, int, int]


class Gain(nn.Module):
    """A norm's per-channel weight (the reference WanRMSNorm's `weight`)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))


class AffineNorm(nn.Module):
    """Affine layer-norm parameters (the reference norm3's weight/bias), f32
    unless `dtype` says otherwise."""

    def __init__(self, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))


IMG_TOKENS = 257  # CLIP ViT-H/14 tokens at 224 (cls + 16×16 patches) heading the i2v context
CLIP_DIM = 1280  # their width, img_emb's input


def _wants_grad(module: nn.Module, *inputs: torch.Tensor) -> bool:
    """Whether autograd records a call of `module` on `inputs`."""
    return torch.is_grad_enabled() and (any(t.requires_grad for t in inputs)
                                        or any(p.requires_grad for p in module.parameters()))


class WanAttention(nn.Module):
    """q/k/v/o projections and the q/k RMS gains; with `img` also the i2v
    cross-attention's image key/value projections and key gain."""

    def __init__(self, dim: int, dtype, device, img: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.o = nn.Linear(dim, dim, **kw)
        self.norm_q = Gain(dim, device)
        self.norm_k = Gain(dim, device)
        if img:
            self.k_img = nn.Linear(dim, dim, **kw)
            self.v_img = nn.Linear(dim, dim, **kw)
            self.norm_k_img = Gain(dim, device)


class MLPProj(nn.Module):
    """The i2v `img_emb`: CLIP tokens → the DiT's width. Its LayerNorms hold
    the param dtype (JAX's cast_wan_params keeps only names with "norm" f32,
    and these are `ln1`/`ln2` there)."""

    def __init__(self, in_dim: int, dim: int, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.proj = nn.Sequential(AffineNorm(in_dim, device, dtype), nn.Linear(in_dim, in_dim, **kw),
                                  nn.GELU(), nn.Linear(in_dim, dim, **kw),
                                  AffineNorm(dim, device, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.proj
        h = layer_norm(x, 1e-5, scale=p[0].weight, bias=p[0].bias)
        h = dense(p[3], F.gelu(dense(p[1], h), approximate="none"))
        return layer_norm(h, 1e-5, scale=p[4].weight, bias=p[4].bias)


class WanBlock(nn.Module):
    """One WanAttentionBlock (wan_block_apply). x: [B, L, dim]."""

    def __init__(self, cfg: WanDiTConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.modulation = nn.Parameter(torch.zeros(1, 6, d, dtype=torch.float32, device=device))
        self.self_attn = WanAttention(d, dtype, device)
        self.cross_attn = WanAttention(d, dtype, device, img=cfg.model_type == "i2v")
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

    def _fused_pair_attn(self, ca: WanAttention, xq: torch.Tensor,
                         ctx: torch.Tensor) -> torch.Tensor:
        """The i2v cross-attention in one launch: q, the text keys and the
        image keys through qk_prep (no RoPE), their row-norm bounds to
        `flash_attention_pair` over the text (context from IMG_TOKENS) and
        the image tokens (the first IMG_TOKENS)."""
        cfg = self.cfg
        N, hd = cfg.num_heads, cfg.head_dim
        txt, im = ctx[:, IMG_TOKENS:], ctx[:, :IMG_TOKENS]
        q, qn = qk_prep(dense(ca.q, xq), ca.norm_q.weight, None, None, N, cfg.eps)
        kt, knt = qk_prep(dense(ca.k, txt), ca.norm_k.weight, None, None, N, cfg.eps)
        ki, kni = qk_prep(dense(ca.k_img, im), ca.norm_k_img.weight, None, None, N, cfg.eps)
        vt = dense(ca.v, txt).view(txt.shape[0], txt.shape[1], N, hd)
        vi = dense(ca.v_img, im).view(im.shape[0], im.shape[1], N, hd)
        return flash_attention_pair(q, kt, vt, ki, vi, qk_row_norms=(qn, knt, kni))

    def _norm(self, x: torch.Tensor, gain: torch.Tensor, tp) -> torch.Tensor:
        """q/k RMS norm: over the local dim, or under TP (`tp`: the 'tensor'
        group) over the whole dim with the local slice of the gain."""
        if tp is None:
            return rms_norm(x, gain, self.cfg.eps)
        return tp_rms_norm(x, gain, self.cfg.eps, tp)

    def forward(self, x: torch.Tensor, aux: WanAux, qk_impl: str = "kernel",
                ew_impl: str = "unfused") -> torch.Tensor:
        cfg = self.cfg
        tp = aux.sp.tp_group if aux.sp is not None else None
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
            q = self._norm(dense(sa.q, y), sa.norm_q.weight, tp)
            n_loc = q.shape[-1] // hd  # N, or N/tp under TP
            q = q.view(B, L, n_loc, hd)
            k = self._norm(dense(sa.k, y), sa.norm_k.weight, tp).view(B, L, n_loc, hd)
            v = dense(sa.v, y).view(B, L, n_loc, hd)
            q = apply_rope(q, aux.rope_cos, aux.rope_sin)
            k = apply_rope(k, aux.rope_cos, aux.rope_sin)
            if aux.sp is None:
                o = attention(q, k, v, kv_lens=aux.kv_lens, assume_normalized=cfg.qk_norm)
            else:
                o = aux.sp.attention(q, k, v, aux.kv_lens, cfg.qk_norm)
        o = dense(sa.o, o.reshape(B, L, -1))

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
        img = hasattr(ca, "k_img")
        if fuse_qk and not img:
            o = self._fused_attn(aux, dense(ca.q, xq), ca.norm_q.weight, False,
                                 dense(ca.k, ctx), ca.norm_k.weight, False,
                                 dense(ca.v, ctx), None)
        elif fuse_qk and not _wants_grad(ca, xq, ctx):  # under grad: the two training calls
            o = self._fused_pair_attn(ca, xq, ctx)
        else:
            q = self._norm(dense(ca.q, xq), ca.norm_q.weight, tp)
            n_loc = q.shape[-1] // hd
            q = q.view(B, L, n_loc, hd)

            def over(c, k_lin, gain, v_lin):
                k = self._norm(dense(k_lin, c), gain, tp).view(B, c.shape[1], n_loc, hd)
                v = dense(v_lin, c).view(B, c.shape[1], n_loc, hd)
                return attention(q, k, v, kv_lens=None,
                                 assume_normalized=cfg.qk_norm).reshape(B, L, -1)

            if img:  # the image tokens head the context, with their own K/V
                o = (over(ctx[:, IMG_TOKENS:], ca.k, ca.norm_k.weight, ca.v)
                     + over(ctx[:, :IMG_TOKENS], ca.k_img, ca.norm_k_img.weight, ca.v_img))
            else:
                o = over(ctx, ca.k, ca.norm_k.weight, ca.v)
        o = dense(ca.o, o.reshape(B, L, -1))

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
                 device="cuda", generator: Optional[torch.Generator] = None,
                 blocks_device=None):
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
        if cfg.model_type == "i2v":
            self.img_emb = MLPProj(CLIP_DIM, d, dtype, device)
        bdev = device if blocks_device is None else torch.device(blocks_device)
        self.blocks = nn.ModuleList(WanBlock(cfg, dtype, bdev) for _ in range(cfg.num_layers))
        self.head = WanHead(cfg, device)
        self._rope_cache = {}
        # blocks kept off the card (pipelines/streaming.py): packed host blocks
        self.host_blocks = None
        if bdev.type != "meta":
            self.init_weights(generator)

    @property
    def param_dtype(self) -> torch.dtype:
        return self.patch_embedding.weight.dtype

    @property
    def streamed(self) -> bool:
        """Whether the blocks live on the host (`host_blocks`), not here."""
        return self.host_blocks is not None

    def resident_parameters(self):
        """(name, parameter) of everything but the blocks."""
        return [(n, p) for n, p in self.named_parameters() if not n.startswith("blocks.")]

    def init_plan(self):
        """The seeded init as (name, tensor, kind, scale) in draw order, kind
        "zero", "one", "normal" (std scale) or "xavier": Xavier-uniform
        linears with zero bias, normal(0.02) text/time embeddings,
        normal/√d modulation tables, ones/zeros norms, zero head. The i2v
        parameters (img_emb, k_img/v_img, norm_k_img), which JAX's
        init_wan_dit does not draw, follow the same rules."""
        d = self.cfg.dim
        normal_lins = {id(m) for m in (self.text_embedding[0], self.text_embedding[2],
                                       self.time_embedding[0], self.time_embedding[2])}
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                if m is self.head.head:
                    yield f"{name}.weight", m.weight, "zero", 0.0
                elif id(m) in normal_lins:
                    yield f"{name}.weight", m.weight, "normal", 0.02
                else:
                    yield f"{name}.weight", m.weight, "xavier", 0.0
                yield f"{name}.bias", m.bias, "zero", 0.0
            elif isinstance(m, Gain):
                yield f"{name}.weight", m.weight, "one", 0.0
            elif isinstance(m, AffineNorm):
                yield f"{name}.weight", m.weight, "one", 0.0
                yield f"{name}.bias", m.bias, "zero", 0.0
        for i, blk in enumerate(self.blocks):
            yield f"blocks.{i}.modulation", blk.modulation, "normal", d**-0.5
        yield "head.modulation", self.head.modulation, "normal", d**-0.5

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None, sink=None) -> None:
        """Run `init_plan` from `generator`. A draw is made in f32 on the
        model's device and cast into the parameter; with `sink`, every block
        value goes to sink(name, f32 value) instead (pipelines/streaming.py
        fills host blocks so, with the draws of the resident init)."""
        dev = self.patch_embedding.weight.device
        for name, p, kind, scale in self.init_plan():
            to_sink = sink is not None and name.startswith("blocks.")
            if kind in ("zero", "one") and not to_sink:
                p.fill_(0.0 if kind == "zero" else 1.0)
                continue
            t = torch.empty(p.shape, dtype=torch.float32, device=dev)
            if kind == "zero" or kind == "one":
                t.fill_(0.0 if kind == "zero" else 1.0)
            elif kind == "normal":
                t.normal_(0.0, scale, generator=generator)
            else:  # xavier uniform over [out, in]
                a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                t.uniform_(-a, a, generator=generator)
            if to_sink:
                sink(name, t)
            else:
                p.copy_(t)

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
        sp: Optional[SPConfig] = None,
        y: Optional[torch.Tensor] = None,
        clip_fea: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x: [B, C_in, F, H, W] noisy latents; t: [B] timesteps; context:
        [B, Lc, text_dim] (or [B, Lc, dim] if context_embedded), padded to
        the context budget. seq_len pads the video tokens (masked as KV).
        qk_impl: "kernel" or "unfused" (the training chain). ew_impl:
        "kernel" (the fused AdaLN sandwich) or "unfused". remat: recompute
        each block in the backward. carry_dtype: dtype of the inter-block
        carry (blocks compute from f32); exclusive with a non-f32
        residual_dtype. sp: run sequence-parallel (every rank passes the
        same inputs and gets the whole output; seq_len % sp_size == 0).
        i2v: y [B, C_y, F, H, W] is concatenated to x on the channels;
        clip_fea [B, 257, 1280] (the CLIP tower's tokens) is projected by
        img_emb and prepended to the embedded context.
        Returns the velocity [B, C_out, F, H, W] f32."""
        if self.streamed:
            raise ValueError("the blocks are on the host: run pipelines/streaming.py "
                             "wan_dit_stream_apply")
        if sp is not None:
            qk_impl = ew_impl = "unfused"
        pro = self.prologue(x, t, context, seq_len, context_embedded, sp, y, clip_fea)
        h, e, aux, grid = pro.h, pro.e, pro.aux, pro.grid
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
        return self._head(hf.float(), e, grid, ew_impl, sp)

    def prologue(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                 seq_len: Optional[int] = None, context_embedded: bool = False,
                 sp: Optional[SPConfig] = None, y: Optional[torch.Tensor] = None,
                 clip_fea: Optional[torch.Tensor] = None) -> "Prologue":
        """Everything before the blocks (patchify, patch_embedding, the pad,
        the time embeddings, embed_context, img_emb, the RoPE tables, under
        SP this rank's shard): the resident and the streamed forward
        (pipelines/streaming.py) both start here."""
        cfg = self.cfg
        if y is not None:
            x = torch.cat([x, y.to(x.dtype)], dim=1)
        if sp is not None and sp.mode == "tp" and cfg.model_type == "i2v":
            raise ValueError("the i2v model has no tensor-parallel path")
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
        if clip_fea is not None:
            context = torch.cat([self.img_emb(clip_fea).to(context.dtype), context], dim=1)
        cos, sin = self.rope_tables(grid)
        if sp is not None:
            n = sp.sp_size
            if L % n:
                raise ValueError(f"seq_len {L} not divisible by sp_size {n}; round it up")
            s0 = sp.shard_index * (L // n)
            s1 = s0 + L // n
            h = h[:, s0:s1].contiguous()
            if e0.shape[1] == L:  # per-token timesteps [B, L]: this shard's rows
                e, e0 = e[:, s0:s1], e0[:, s0:s1]
            elif e0.shape[1] != 1:
                raise ValueError(f"per-token t has {e0.shape[1]} tokens, not seq_len {L}")
            # rows past L_nat are cut, not padded: apply_rope lets them pass
            cos, sin = cos[s0:min(s1, L_nat)], sin[s0:min(s1, L_nat)]
        aux = WanAux(e0=e0, context=context.to(pdtype), rope_cos=cos, rope_sin=sin,
                     kv_lens=kv_lens, sp=sp)
        return Prologue(h, e, aux, grid)

    def _head(self, hf: torch.Tensor, e: torch.Tensor, grid, ew_impl: str,
              sp: Optional[SPConfig] = None) -> torch.Tensor:
        """2-way modulation with e (not e0), f32, (under SP the shards
        gathered,) then unpatchify."""
        cfg = self.cfg
        eh = self.head.modulation.float()[None] + e[:, :, None]  # [B, T, 2, d]
        if ew_impl == "kernel" and eh.shape[1] == 1 and cfg.dim % 128 == 0:
            _, y = fused_adaln(hf, mod_scale=eh[:, 0, 1], mod_shift=eh[:, 0, 0], eps=cfg.eps,
                               out_dtype=torch.float32)
        else:
            xn = layer_norm(hf, cfg.eps, out_f32=True)
            y = xn * (1.0 + eh[:, :, 1]) + eh[:, :, 0]
        out = dense(self.head.head, y, torch.float32)
        if sp is not None:
            out = sp.gather(out)
        return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)
