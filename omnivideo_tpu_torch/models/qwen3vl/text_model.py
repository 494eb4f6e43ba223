"""Qwen3 text decoder, dense and MoE: the language side of Qwen3-VL (port of
omnivideo_tpu/models/qwen3vl/text_model.py).

GQA attention with per-head q/k RMS-norm; SwiGLU MLP or a softmax-routed
top-k MoE (HF Qwen3MoeSparseMoeBlock semantics). `moe` sorts the
(token, slot) pairs by expert, runs each expert's three products on its
contiguous row segment with `torch.matmul`, and scatter-adds the weighted
outputs back: O(k·T·D·M) work, E/k× less than the dense mixture. The
segment bounds come to the host once per layer (one sync). `moe_dense`,
every expert on every token, stays as the exact oracle the tests use.

Parameter names follow the HF checkpoint's `model.language_model.*`; the
stacked expert weights keep the JAX layout ([E, D, M] for gate/up, [E, M, D]
for down), so each segment is `rows @ w[e]`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...configs.qwen3vl import Qwen3TextConfig
from ..wan_dit import Gain


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x·rsqrt(mean(x²)+eps)·w in f32, cast back to x.dtype (the JAX `_rms`;
    the weight multiplies before the cast, unlike the Wan norm)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


class Qwen3Attention(nn.Module):
    def __init__(self, cfg: Qwen3TextConfig, dtype, device):
        super().__init__()
        D, N, K, hd = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q_proj = nn.Linear(D, N * hd, **kw)
        self.k_proj = nn.Linear(D, K * hd, **kw)
        self.v_proj = nn.Linear(D, K * hd, **kw)
        self.o_proj = nn.Linear(N * hd, D, **kw)
        self.q_norm = Gain(hd, device)
        self.k_norm = Gain(hd, device)


class Qwen3MLP(nn.Module):
    """SwiGLU MLP (dense layers)."""

    def __init__(self, cfg: Qwen3TextConfig, dtype, device):
        super().__init__()
        D, M = cfg.hidden_size, cfg.intermediate_size
        kw = dict(bias=False, dtype=dtype, device=device)
        self.gate_proj = nn.Linear(D, M, **kw)
        self.up_proj = nn.Linear(D, M, **kw)
        self.down_proj = nn.Linear(M, D, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(F.silu(F.linear(x, self.gate_proj.weight)) * F.linear(x, self.up_proj.weight),
                        self.down_proj.weight)


class Qwen3MoE(nn.Module):
    """Router (`gate`, D → E) and the stacked expert weights."""

    def __init__(self, cfg: Qwen3TextConfig, dtype, device):
        super().__init__()
        D, E, M = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
        self.cfg = cfg
        self.gate = nn.Linear(D, E, bias=False, dtype=dtype, device=device)
        self.experts_gate = nn.Parameter(torch.empty(E, D, M, dtype=dtype, device=device))
        self.experts_up = nn.Parameter(torch.empty(E, D, M, dtype=dtype, device=device))
        self.experts_down = nn.Parameter(torch.empty(E, M, D, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe(self, x)


def router(mlp: Qwen3MoE, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 softmax over the logits (computed in the input dtype), top-k,
    optional renormalisation → (top weights, top experts, probs)."""
    cfg = mlp.cfg
    probs = torch.softmax(F.linear(xt, mlp.gate.weight).float(), dim=-1)
    topv, topi = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(-1, keepdim=True)
    return topv, topi, probs


@torch.profiler.record_function("qwen3vl.moe")
def moe(mlp: Qwen3MoE, x: torch.Tensor) -> torch.Tensor:
    """Grouped MoE over expert-contiguous row segments (profiler range
    "qwen3vl.moe"). x: [B, L, D]."""
    B, L, D = x.shape
    xt = x.reshape(B * L, D)
    k = mlp.cfg.num_experts_per_tok
    topv, topi, _ = router(mlp, xt)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # pairs grouped by expert
    tok_of = order // k
    counts = torch.bincount(flat_e, minlength=mlp.cfg.num_experts).tolist()  # host sync
    xs = xt[tok_of]
    o = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(counts):
        if n:
            seg = xs[start:start + n]
            h = F.silu(seg @ mlp.experts_gate[e]) * (seg @ mlp.experts_up[e])
            o[start:start + n] = h @ mlp.experts_down[e]
            start += n
    o = o * topv.reshape(-1)[order][:, None].to(o.dtype)
    y = torch.zeros_like(xt).index_add_(0, tok_of, o)
    return y.reshape(B, L, D)


def moe_dense(mlp: Qwen3MoE, x: torch.Tensor) -> torch.Tensor:
    """Exact all-experts oracle with a one-hot combine, O(E·T·D·M): the
    reference semantics the tests hold `moe` to."""
    B, L, D = x.shape
    xt = x.reshape(B * L, D)
    topv, topi, probs = router(mlp, xt)
    w = torch.zeros_like(probs).scatter(1, topi, topv)  # [T, E]
    g = torch.einsum("td,edm->etm", xt, mlp.experts_gate)
    u = torch.einsum("td,edm->etm", xt, mlp.experts_up)
    o = torch.einsum("etm,emd->etd", F.silu(g) * u, mlp.experts_down)
    return torch.einsum("te,etd->td", w.to(o.dtype), o).reshape(B, L, D)


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen3TextConfig, dtype, device):
        super().__init__()
        self.input_layernorm = Gain(cfg.hidden_size, device)
        self.post_attention_layernorm = Gain(cfg.hidden_size, device)
        self.self_attn = Qwen3Attention(cfg, dtype, device)
        self.mlp = (Qwen3MoE(cfg, dtype, device) if cfg.num_experts
                    else Qwen3MLP(cfg, dtype, device))


class Qwen3TextModel(nn.Module):
    """Embedding, decoder layers and the final norm (no head)."""

    def __init__(self, cfg: Qwen3TextConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                                         device=device)
        self.layers = nn.ModuleList(Qwen3DecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = Gain(cfg.hidden_size, device)


def qkv_rope(attn: Qwen3Attention, hn: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             cfg: Qwen3TextConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, L, N, hd], k/v [B, L, K, hd]: projections, q/k RMS-norm, and
    rotate-half RoPE in f32 with cos/sin [L or 1, hd] f32."""
    B, L, _ = hn.shape
    N, K, hd, eps = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.rms_norm_eps
    q = rms(F.linear(hn, attn.q_proj.weight).view(B, L, N, hd), attn.q_norm.weight, eps)
    k = rms(F.linear(hn, attn.k_proj.weight).view(B, L, K, hd), attn.k_norm.weight, eps)
    v = F.linear(hn, attn.v_proj.weight).view(B, L, K, hd)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    qf, kf = q.float(), k.float()
    q = (qf * c + rotate_half(qf) * s).to(hn.dtype)
    k = (kf * c + rotate_half(kf) * s).to(hn.dtype)
    return q, k, v


def mlp_block(layer: Qwen3DecoderLayer, x: torch.Tensor, eps: float) -> torch.Tensor:
    """x + MLP/MoE(RMS(x))."""
    return x + layer.mlp(rms(x, layer.post_attention_layernorm.weight, eps))


def cached_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Dense decode attention over the live cache rows: q [B, 1, N, hd];
    k_all/v_all [B, S, K, hd] f32, repeated to N heads and cast to q's dtype
    (lossless: the cache holds the bf16 values); f32 logits and softmax."""
    N, K, hd = q.shape[2], k_all.shape[2], q.shape[3]
    kr = k_all.repeat_interleave(N // K, dim=2).to(q.dtype)
    vr = v_all.repeat_interleave(N // K, dim=2).to(q.dtype)
    lo = torch.einsum("bind,bjnd->bnij", q.float(), kr.float()) * hd**-0.5
    pr = torch.softmax(lo, dim=-1).to(vr.dtype)
    o = torch.einsum("bnij,bjnd->bind", pr.float(), vr.float())
    return o.to(out_dtype).reshape(q.shape[0], q.shape[1], N * hd)


def lm_logits(model_head: Optional[nn.Linear], embed: nn.Embedding, hidden: torch.Tensor
              ) -> torch.Tensor:
    """hidden @ head in the hidden dtype, then f32 (head = embedding when
    tied)."""
    w = model_head.weight if model_head is not None else embed.weight
    return F.linear(hidden, w).float()
