"""Qwen3 text decoder, dense and MoE: the language side of Qwen3-VL (port of
omnivideo_tpu/models/qwen3vl/text_model.py).

GQA attention with per-head q/k RMS-norm; SwiGLU MLP or a softmax-routed
top-k MoE (HF Qwen3MoeSparseMoeBlock semantics). `moe` sorts the
(token, slot) pairs by expert, counts each expert's rows on the device, and
runs the three products as grouped matrix products over the whole expert
banks (`ops/gmm.py` `GroupedMatmul`: the kernel of row 9 on the card, its
plain twin on the CPU; under autograd its backward is row 9b and row 9
with the bank transposed), then puts the weighted outputs back: O(k·T·D·M)
work, E/k× less than the dense mixture, and nothing waits on the host.
Each token's k weighted outputs are summed in slot order, so a forward is
bitwise repeatable on the card. `moe_dense`, every expert on every token,
stays as the exact oracle the tests use. With an `ExpertShard`
(parallel/expert_shard.py, `generate --vlm_fsdp n`) a MoE holds M/n columns
of every bank: the routing is the same on every rank, the three products
run on the narrower banks, and the partial outputs are weighted and summed
in f32, all-reduced over the shard's group and cast once (`moe_partial`).

`qwen3_forward` and `qwen3_forward_sp` run in inference mode;
`qwen3_forward_trainable` and `qwen3_forward_sp_trainable` (the SFT step,
training/sft.py) run under the caller's grad mode. Under autograd (grad mode
on and a query that requires grad) the causal attention takes JAX's dense
path (JAX `attn_impl="dense"`): the causal flash kernel (row 2) is
forward-only, in JAX as here. The choice is made in the open on grad mode
(`_causal_attend`), as parallel/ring.py makes it for the ring, whose
trainable form the SP forward then runs. Every decoder layer runs through
its module's `forward`, so FSDP2 (parallel/sharding.py) gathers each layer
as one unit.

Parameter names follow the HF checkpoint's `model.language_model.*`; the
stacked expert weights keep the JAX layout ([E, D, M] for gate/up, [E, M, D]
for down), so each group's rows are `rows @ w[e]`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ...configs.qwen3vl import Qwen3TextConfig
from ...ops.gmm import GroupedMatmul
from ...ops.lora import has_lora, lora_delta
from ...parallel.expert_shard import ExpertShard
from ..wan_dit import Gain


def lin(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ Wᵀ of a bias-free projection, plus its LoRA delta when it is
    adapted (the JAX `_lin`: x, A and B promote, the delta cast to the
    product's dtype; ops/lora.py)."""
    y = F.linear(x, linear.weight)
    if has_lora(linear):
        y = y + lora_delta(linear, x, y.dtype, cast=False)
    return y


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
        return lin(self.down_proj, F.silu(lin(self.gate_proj, x)) * lin(self.up_proj, x))


class Qwen3MoE(nn.Module):
    """Router (`gate`, D → E) and the stacked expert weights; with `shard`,
    the rank's M / n columns of each bank."""

    def __init__(self, cfg: Qwen3TextConfig, dtype, device, shard: Optional[ExpertShard] = None):
        super().__init__()
        D, E = cfg.hidden_size, cfg.num_experts
        M = cfg.moe_intermediate_size // (shard.n if shard is not None else 1)
        self.cfg, self.shard = cfg, shard
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


def _expert_rows(mlp: Qwen3MoE, xt: torch.Tensor):
    """Route xt [T, D] and run the three grouped products over the
    expert-contiguous (token, slot) rows → (outputs [T·k, D] in sorted
    order, the sort, the top weights [T, k] f32, the top experts). The group
    sizes stay on the device: `scatter_add_` counts them, where
    `torch.bincount` on the card reads its input's max back to the host."""
    k = mlp.cfg.num_experts_per_tok
    topv, topi, _ = router(mlp, xt)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # pairs grouped by expert
    sizes = torch.zeros(mlp.cfg.num_experts, dtype=torch.int32, device=xt.device)
    sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    xs = xt.index_select(0, order // k)
    h = F.silu(GroupedMatmul.apply(xs, mlp.experts_gate, sizes)) * GroupedMatmul.apply(
        xs, mlp.experts_up, sizes)
    return GroupedMatmul.apply(h, mlp.experts_down, sizes), order, topv, topi


def _slot_sum(o: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """Sorted rows back to (token, slot) order, then each token's k outputs
    summed in slot order: deterministic, where an index_add_ on the card
    sums in whatever order its atomics land."""
    slots = torch.empty_like(o).index_copy_(0, order, o)
    return slots.view(-1, k, o.shape[-1]).sum(1)


def check_routing(topi: torch.Tensor, group) -> None:
    """Raise unless every rank of `group` chose the same experts (the
    element-wise min and max over the group equal this rank's choice)."""
    lo, hi = topi.clone(), topi.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not (torch.equal(lo, topi) and torch.equal(hi, topi)):
        raise RuntimeError("the MoE's routing differs across the ranks of its expert group")
    check_routing.calls += 1


check_routing.calls = 0


def moe_partial(mlp: Qwen3MoE, x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the MoE over x [B, L, D] → [B, L, D] f32: its
    columns' down products weighted by the router in f32 and summed over
    the k slots in slot order (the whole MoE for an unsharded model)."""
    B, L, D = x.shape
    o, order, topv, topi = _expert_rows(mlp, x.reshape(B * L, D))
    shard = mlp.shard
    if shard is not None and shard.check_routing and shard.group is not None:
        check_routing(topi, shard.group)
    o = o.float() * topv.reshape(-1)[order][:, None]
    return _slot_sum(o, order, mlp.cfg.num_experts_per_tok).reshape(B, L, D)


@torch.profiler.record_function("qwen3vl.moe")
def moe(mlp: Qwen3MoE, x: torch.Tensor) -> torch.Tensor:
    """Grouped MoE over expert-contiguous rows (profiler range
    "qwen3vl.moe"). x: [B, L, D]. Unsharded, the outputs are weighted and
    summed in x's dtype; with a shard, `moe_partial`'s f32 sum is
    all-reduced over the shard's group and cast once."""
    shard = mlp.shard
    if shard is not None:
        y = moe_partial(mlp, x)
        if shard.group is not None:
            dist.all_reduce(y, group=shard.group)
        return y.to(x.dtype)
    B, L, D = x.shape
    o, order, topv, _ = _expert_rows(mlp, x.reshape(B * L, D))
    o = o * topv.reshape(-1)[order][:, None].to(o.dtype)
    return _slot_sum(o, order, mlp.cfg.num_experts_per_tok).reshape(B, L, D)


def moe_dense(mlp: Qwen3MoE, x: torch.Tensor) -> torch.Tensor:
    """Exact all-experts oracle with a one-hot combine, O(E·T·D·M): the
    reference semantics the tests hold `moe` to. With a shard, over the
    rank's columns, combined in f32 and all-reduced as `moe` does."""
    B, L, D = x.shape
    xt = x.reshape(B * L, D)
    topv, topi, probs = router(mlp, xt)
    w = torch.zeros_like(probs).scatter(1, topi, topv)  # [T, E]
    g = torch.einsum("td,edm->etm", xt, mlp.experts_gate)
    u = torch.einsum("td,edm->etm", xt, mlp.experts_up)
    o = torch.einsum("etm,emd->etd", F.silu(g) * u, mlp.experts_down)
    if mlp.shard is None:
        return torch.einsum("te,etd->td", w.to(o.dtype), o).reshape(B, L, D)
    y = torch.einsum("te,etd->td", w, o.float())
    if mlp.shard.group is not None:
        dist.all_reduce(y, group=mlp.shard.group)
    return y.to(x.dtype).reshape(B, L, D)


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen3TextConfig, dtype, device,
                 shard: Optional[ExpertShard] = None):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = Gain(cfg.hidden_size, device)
        self.post_attention_layernorm = Gain(cfg.hidden_size, device)
        self.self_attn = Qwen3Attention(cfg, dtype, device)
        self.mlp = (Qwen3MoE(cfg, dtype, device, shard) if cfg.num_experts
                    else Qwen3MLP(cfg, dtype, device))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, attend,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """One causal layer over x [B, L, D]: `attend(q, k, v)` with K/V at
        the KV heads; `kv` (k, v) [B, S, K, hd] f32 receive the post-RoPE
        K/V in rows [0, L)."""
        cfg = self.cfg
        B, L, _ = x.shape
        attn = self.self_attn
        q, k, v = qkv_rope(attn, rms(x, self.input_layernorm.weight, cfg.rms_norm_eps), cos, sin,
                           cfg)
        if kv is not None:
            kv[0][:, :L] = k.float()
            kv[1][:, :L] = v.float()
        x = x + lin(attn.o_proj, attend(q, k, v).reshape(B, L, -1))
        return mlp_block(self, x, cfg.rms_norm_eps)


class Qwen3TextModel(nn.Module):
    """Embedding, decoder layers and the final norm (no head); `shard`
    splits the MoE banks."""

    def __init__(self, cfg: Qwen3TextConfig, dtype, device,
                 shard: Optional[ExpertShard] = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                                         device=device)
        self.layers = nn.ModuleList(Qwen3DecoderLayer(cfg, dtype, device, shard)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = Gain(cfg.hidden_size, device)


def qkv_rope(attn: Qwen3Attention, hn: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             cfg: Qwen3TextConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, L, N, hd], k/v [B, L, K, hd]: projections, q/k RMS-norm, and
    rotate-half RoPE in f32 with cos/sin [L or 1, hd] f32."""
    B, L, _ = hn.shape
    N, K, hd, eps = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.rms_norm_eps
    q = rms(lin(attn.q_proj, hn).view(B, L, N, hd), attn.q_norm.weight, eps)
    k = rms(lin(attn.k_proj, hn).view(B, L, K, hd), attn.k_norm.weight, eps)
    v = lin(attn.v_proj, hn).view(B, L, K, hd)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    qf, kf = q.float(), k.float()
    q = (qf * c + rotate_half(qf) * s).to(hn.dtype)
    k = (kf * c + rotate_half(kf) * s).to(hn.dtype)
    return q, k, v


def mlp_block(layer: Qwen3DecoderLayer, x: torch.Tensor, eps: float) -> torch.Tensor:
    """x + MLP/MoE(RMS(x))."""
    return x + layer.mlp(rms(x, layer.post_attention_layernorm.weight, eps))


def cached_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     out_dtype: torch.dtype, bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Dense attention (the decode's over the live cache rows): q [B, Lq,
    N, hd]; k_all/v_all [B, S, K, hd] (the decode's f32 cache), repeated to
    N heads and cast to q's dtype (lossless: the cache holds the bf16
    values); f32 logits plus `bias` ([B or 1, 1, Lq, S] f32, JAX's additive
    mask) and softmax."""
    N, K, hd = q.shape[2], k_all.shape[2], q.shape[3]
    kr = k_all.repeat_interleave(N // K, dim=2).to(q.dtype)
    vr = v_all.repeat_interleave(N // K, dim=2).to(q.dtype)
    lo = torch.einsum("bind,bjnd->bnij", q.float(), kr.float()) * hd**-0.5
    if bias is not None:
        lo = lo + bias
    pr = torch.softmax(lo, dim=-1).to(vr.dtype)
    o = torch.einsum("bnij,bjnd->bind", pr.float(), vr.float())
    return o.to(out_dtype).reshape(q.shape[0], q.shape[1], N * hd)


def lm_logits(model_head: Optional[nn.Linear], embed: nn.Embedding, hidden: torch.Tensor
              ) -> torch.Tensor:
    """hidden @ head in the hidden dtype, then f32 (head = embedding when
    tied)."""
    w = model_head.weight if model_head is not None else embed.weight
    return F.linear(hidden, w).float()


# --- the text-only Qwen3 (JAX qwen3_forward, qwen3_greedy_decode, qwen3_forward_sp)


class Qwen3LM(nn.Module):
    """The text-only Qwen3 causal LM (JAX's {'embed', 'layers', 'norm',
    'lm_head'} tree): `language_model` and `lm_head` (None when tied), the
    attribute names of `Qwen3VLModel`, so the functions below take either.
    Seeded normal(init_std) weights, unit gains."""

    def __init__(self, cfg: Qwen3TextConfig, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 init_std: float = 0.02):
        super().__init__()
        from ...device import resolve_device

        dev = resolve_device(device)
        self.language_model = Qwen3TextModel(cfg, dtype, dev)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype,
                                  device=dev))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, init_std, generator=generator)
                elif isinstance(m, Qwen3MoE):
                    for p in (m.experts_gate, m.experts_up, m.experts_down):
                        p.normal_(0.0, init_std, generator=generator)
                elif isinstance(m, Gain):
                    m.weight.fill_(1.0)


def rope_1d(pos: torch.Tensor, cfg: Qwen3TextConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX `_rope` tables for positions [L]: cos/sin [L, head_dim] f32
    (f32 p·inv with inv rounded from f64, halves repeated for rotate-half)."""
    hd = cfg.head_dim
    inv = torch.tensor(1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2) / hd)), dtype=torch.float32,
                       device=pos.device)
    ang = pos.float()[:, None] * inv[None]
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([c, c], -1), torch.cat([s, s], -1)


def _text_cfg(model: nn.Module) -> Qwen3TextConfig:
    return model.language_model.cfg


def _head(model: nn.Module, hidden: torch.Tensor) -> torch.Tensor:
    return lm_logits(model.lm_head, model.language_model.embed_tokens, hidden)


def _causal_layers(model: nn.Module, x: torch.Tensor, cos, sin, attend, cache=None):
    """The decoder layers over x [B, L, D] (each through its module's
    forward); `cache` (k, v) [layers, B, S, K, hd] f32 gets each layer's
    post-RoPE K/V in rows [0, L)."""
    for i, layer in enumerate(model.language_model.layers):
        x = layer(x, cos, sin, attend, None if cache is None else (cache[0][i], cache[1][i]))
    return x


def _flash_causal(q, k, v):
    from ...ops.flash_attention import flash_attention

    rep = q.shape[2] // k.shape[2]
    return flash_attention(q, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2),
                           causal=True)


def _mask_bias(L: int, attn_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """JAX's additive f32 bias [B or 1, 1, L, L]: −3.4e38 above the diagonal
    and, with `attn_mask` [B, L] (> 0: a real key), at padded keys."""
    big = torch.tensor(-3.4e38, dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    tri = torch.ones(L, L, dtype=torch.bool, device=device).tril()
    bias = torch.where(tri, zero, big)[None, None]
    if attn_mask is not None:
        bias = bias + torch.where(attn_mask.to(device)[:, None, None, :] > 0, zero, big)
    return bias


def _causal_attend(L: int, attn_mask: Optional[torch.Tensor], device):
    """attend(q, k, v) of the causal forward: the causal flash kernel (row 2
    on the card) when there is no mask and no autograd, else JAX's dense
    path with its additive bias (the mask's, or the causal triangle's)."""
    bias = None

    def attend(q, k, v):
        nonlocal bias
        if attn_mask is None and not (torch.is_grad_enabled() and q.requires_grad):
            return _flash_causal(q, k, v)
        if bias is None:
            bias = _mask_bias(L, attn_mask, device)
        return cached_attention(q, k, v, q.dtype, bias).view(q.shape)

    return attend


def qwen3_forward_trainable(model: nn.Module, ids: torch.Tensor,
                            attn_mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full causal forward (JAX `qwen3_forward`) under the caller's grad
    mode → (final-normed hidden [B, L, D], logits [B, L, V] f32). ids
    [B, L] on the model's device. `attn_mask` [B, L] (> 0: a real key)
    takes the dense path with JAX's additive bias (causal and key terms of
    −3.4e38 each); so does every forward under autograd (`_causal_attend`);
    otherwise the attention is the causal flash kernel."""
    cfg = _text_cfg(model)
    emb = model.language_model.embed_tokens
    ids = ids.to(emb.weight.device)
    L = ids.shape[1]
    cos, sin = rope_1d(torch.arange(L, device=ids.device), cfg)
    x = _causal_layers(model, emb(ids), cos, sin, _causal_attend(L, attn_mask, ids.device))
    hidden = rms(x, model.language_model.norm.weight, cfg.rms_norm_eps)
    return hidden, _head(model, hidden)


@torch.inference_mode()
def qwen3_forward(model: nn.Module, ids: torch.Tensor,
                  attn_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`qwen3_forward_trainable` in inference mode: with no mask the
    attention is pure causal, the flash kernel's causal mode (row 2) on the
    card."""
    return qwen3_forward_trainable(model, ids, attn_mask)


@torch.inference_mode()
def qwen3_greedy_decode(model: nn.Module, prompt_ids: torch.Tensor, max_new_tokens: int,
                        eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Greedy decoding (JAX `qwen3_greedy_decode`) → [1, max_new_tokens]
    int64, eos-padded after the stop. The prefill is the causal forward
    (row 2 on the card) writing post-RoPE K/V into an f32 cache; each step
    is one cached pass over the layers with dense attention over the live
    rows. The step whose token would never be returned is skipped."""
    cfg = _text_cfg(model)
    lm = model.language_model
    ids = prompt_ids.to(lm.embed_tokens.weight.device)
    B, Lp = ids.shape
    if B != 1:
        raise ValueError("qwen3_greedy_decode takes one sample")
    dev = ids.device
    shape = (cfg.num_hidden_layers, B, Lp + max_new_tokens, cfg.num_key_value_heads,
             cfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.float32, device=dev)
    vc = torch.zeros_like(kc)
    cos, sin = rope_1d(torch.arange(Lp, device=dev), cfg)
    x = _causal_layers(model, lm.embed_tokens(ids), cos, sin, _flash_causal, cache=(kc, vc))
    eps = cfg.rms_norm_eps
    tok = int(torch.argmax(_head(model, rms(x[:, -1:], lm.norm.weight, eps))[0, -1]))
    out = torch.full((1, max_new_tokens), eos_token_id if eos_token_id is not None else 0,
                     dtype=torch.int64)
    for i in range(max_new_tokens):
        out[0, i] = tok
        if i == max_new_tokens - 1 or (eos_token_id is not None and tok == eos_token_id):
            break
        length = Lp + i
        c1, s1 = rope_1d(torch.tensor([length], device=dev), cfg)
        h = lm.embed_tokens(torch.tensor([[tok]], device=dev))
        for j, layer in enumerate(lm.layers):
            attn = layer.self_attn
            q, k, v = qkv_rope(attn, rms(h, layer.input_layernorm.weight, eps), c1, s1, cfg)
            kc[j, :, length] = k[:, 0].float()
            vc[j, :, length] = v[:, 0].float()
            o = cached_attention(q, kc[j, :, :length + 1], vc[j, :, :length + 1], h.dtype)
            h = mlp_block(layer, h + lin(attn.o_proj, o), eps)
        tok = int(torch.argmax(_head(model, rms(h, lm.norm.weight, eps))[0, -1]))
    return out


def _gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather along dim 1 in rank order, differentiable (its backward
    hands this rank its slice)."""
    from ..wan_dit import _GatherSeq

    return _GatherSeq.apply(x, group)


@torch.inference_mode()
def qwen3_forward_sp(model: nn.Module, ids: torch.Tensor, mesh, seq_axis: str = "seq",
                     ulysses_axis: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`qwen3_forward_sp_trainable` in inference mode."""
    return qwen3_forward_sp_trainable(model, ids, mesh, seq_axis, ulysses_axis)


def qwen3_forward_sp_trainable(model: nn.Module, ids: torch.Tensor, mesh,
                               seq_axis: str = "seq", ulysses_axis: Optional[str] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The causal forward sequence-parallel (JAX `qwen3_forward_sp`) under
    the caller's grad mode: every
    rank passes the same ids [B, L]; tokens are sharded over `seq_axis`
    (the ring), or with `ulysses_axis` over ulysses × ring in JAX's
    ring-major order (rank (ring i, ulysses u) holds shard i·nu + u, so the
    Ulysses all-to-all leaves ring rank i one contiguous superblock). GQA
    K/V are expanded to every head before the ring, which runs the
    token-causal ring step in the model's dtype (row 8 on the card for
    bf16, the f32 step kernel for f32). Returns the global (hidden, logits),
    gathered on every rank. L % (n·nu) == 0. Under autograd the ring is the
    trainable one (rows 4 and 5 in the backward on the earlier shards, in
    the model's dtype;
    parallel/ring.py dispatches on grad mode) and the gathers hand each
    rank its slice's gradient; there is no mask, so padding must sit at
    the tail."""
    from ...parallel.ring import ring_attention
    from ...parallel.ulysses import _a2a_gather_heads, _a2a_scatter_heads

    cfg = _text_cfg(model)
    ring = mesh.get_group(seq_axis)
    n, i = mesh.size(mesh.mesh_dim_names.index(seq_axis)), mesh.get_local_rank(seq_axis)
    ug, nu, iu = None, 1, 0
    if ulysses_axis is not None:
        ug = mesh.get_group(ulysses_axis)
        nu = mesh.size(mesh.mesh_dim_names.index(ulysses_axis))
        iu = mesh.get_local_rank(ulysses_axis)
    emb = model.language_model.embed_tokens
    ids = ids.to(emb.weight.device)
    B, L = ids.shape
    if L % (n * nu):
        raise ValueError(f"L {L} not divisible by the {n * nu} token shards")
    if cfg.num_attention_heads % nu:
        raise ValueError(f"{cfg.num_attention_heads} heads over a Ulysses group of {nu}")
    Ll = L // (n * nu)
    start = (i * nu + iu) * Ll
    cos, sin = rope_1d(torch.arange(start, start + Ll, device=ids.device), cfg)

    def attend(q, k, v):
        rep = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        if ug is not None:
            q, k, v = (_a2a_scatter_heads(t, ug) for t in (q, k, v))
        # JAX's ring here keeps the model's dtype (no comm_dtype): an f32 LM's
        # attention stays f32 (the f32 step kernel), as its router needs
        o = ring_attention(q, k, v, ring, causal="token", operand_dtype=None)
        return _a2a_gather_heads(o, ug) if ug is not None else o

    x = _causal_layers(model, emb(ids[:, start:start + Ll]), cos, sin, attend)
    hidden = rms(x, model.language_model.norm.weight, cfg.rms_norm_eps)
    logits = _head(model, hidden)
    for grp in ([ug] if ug is not None else []) + [ring]:  # ulysses (inner) first
        hidden, logits = _gather_tokens(hidden, grp), _gather_tokens(logits, grp)
    return hidden, logits
