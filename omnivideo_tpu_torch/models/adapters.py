"""v1 adapters: DM_Adapter and VisionHead, learnable-query transformers
(port of omnivideo_tpu/models/adapters.py).

Both are an MLP bridge (Linear → exact GELU → Linear, keys `fc.0` and
`fc.2`), a learnable query tensor `decoder_query` [1, Q, d] and the core of
a torch `nn.Transformer` (batch_first, norm_first, ReLU FFN, packed-QKV
attention with 8 heads, final encoder and decoder norms, no masks) under
the reference's attribute name: `adapter` for the DM_Adapter,
`visionHeadAdapter` for the VisionHead. The modules carry the reference's
parameter names, so a reference state dict loads as it is.

The attention is written out (einsum, f32 logits, softmax), as JAX
`_mha` is; the port runs no library attention. LayerNorms compute in f32
and cast back (JAX `_ln`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

NUM_HEADS = 8  # torch nn.Transformer's default, as the reference builds it


class MultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention's parameters: packed `in_proj_weight`
    [3d, d] and `in_proj_bias`, `out_proj`."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d, device=device))
        self.out_proj = nn.Linear(d, d, device=device)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, num_heads: int) -> torch.Tensor:
        d = q_in.shape[-1]
        hd = d // num_heads
        wq, wk, wv = self.in_proj_weight.split(d)
        bq, bk, bv = self.in_proj_bias.split(d)
        B, Lq, Lk = q_in.shape[0], q_in.shape[1], kv_in.shape[1]
        q = F.linear(q_in, wq, bq).reshape(B, Lq, num_heads, hd)
        k = F.linear(kv_in, wk, bk).reshape(B, Lk, num_heads, hd)
        v = F.linear(kv_in, wv, bv).reshape(B, Lk, num_heads, hd)
        logits = torch.einsum("bind,bjnd->bnij", q.float(), k.float())
        probs = torch.softmax(logits * hd**-0.5, dim=-1).to(v.dtype)
        o = torch.einsum("bnij,bjnd->bind", probs.float(), v.float())
        return self.out_proj(o.to(q_in.dtype).reshape(B, Lq, d))


class LayerNorm(nn.Module):
    """LayerNorm (eps 1e-5) in f32, cast back to the input dtype."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        return (((xf - mu) * torch.rsqrt(var + 1e-5)) * self.weight + self.bias).to(x.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, ffn: int, device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d, device)
        self.linear1 = nn.Linear(d, ffn, device=device)
        self.linear2 = nn.Linear(ffn, d, device=device)
        self.norm1 = LayerNorm(d, device)
        self.norm2 = LayerNorm(d, device)

    def forward(self, x: torch.Tensor, num_heads: int) -> torch.Tensor:
        xn = self.norm1(x)
        x = x + self.self_attn(xn, xn, num_heads)
        return x + self.linear2(F.relu(self.linear1(self.norm2(x))))


class DecoderLayer(nn.Module):
    def __init__(self, d: int, ffn: int, device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d, device)
        self.multihead_attn = MultiheadAttention(d, device)
        self.linear1 = nn.Linear(d, ffn, device=device)
        self.linear2 = nn.Linear(ffn, d, device=device)
        self.norm1 = LayerNorm(d, device)
        self.norm2 = LayerNorm(d, device)
        self.norm3 = LayerNorm(d, device)

    def forward(self, t: torch.Tensor, mem: torch.Tensor, num_heads: int) -> torch.Tensor:
        tn = self.norm1(t)
        t = t + self.self_attn(tn, tn, num_heads)
        t = t + self.multihead_attn(self.norm2(t), mem, num_heads)
        return t + self.linear2(F.relu(self.linear1(self.norm3(t))))


class _Stack(nn.Module):
    def __init__(self, layers, d: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(d, device)


class TransformerCore(nn.Module):
    """torch nn.Transformer(norm_first=True) without masks: `encoder` and
    `decoder`, each with `layers` and a final `norm`."""

    def __init__(self, d: int, ffn: int, n_enc: int = 4, n_dec: int = 4, device=None):
        super().__init__()
        self.encoder = _Stack([EncoderLayer(d, ffn, device) for _ in range(n_enc)], d, device)
        self.decoder = _Stack([DecoderLayer(d, ffn, device) for _ in range(n_dec)], d, device)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                num_heads: int = NUM_HEADS) -> torch.Tensor:
        x = src
        for layer in self.encoder.layers:
            x = layer(x, num_heads)
        mem = self.encoder.norm(x)
        t = tgt
        for layer in self.decoder.layers:
            t = layer(t, mem, num_heads)
        return self.decoder.norm(t)


class QueryTransformer(nn.Module):
    """fc bridge → transformer whose decoder reads the learnable queries:
    [B, L, in_dim] → [B, Q, out_dim]. `core` names the transformer as the
    reference does ("adapter" or "visionHeadAdapter")."""

    def __init__(self, core: str, in_dim: int, hidden_dim: int, out_dim: int, num_queries: int,
                 num_layers: int = 4, ffn_mult: int = 4, num_heads: int = NUM_HEADS,
                 device=None):
        super().__init__()
        self.core, self.num_heads = core, num_heads
        self.fc = nn.Sequential(nn.Linear(in_dim, hidden_dim, device=device), nn.GELU(),
                                nn.Linear(hidden_dim, out_dim, device=device))
        self.decoder_query = nn.Parameter(torch.zeros(1, num_queries, out_dim, device=device))
        setattr(self, core, TransformerCore(out_dim, ffn_mult * out_dim, num_layers, num_layers,
                                            device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc(x)
        q = self.decoder_query.expand(x.shape[0], -1, -1)
        return getattr(self, self.core)(h, q, self.num_heads)


def _sd_shapes(sd: Dict[str, np.ndarray], core: str) -> dict:
    """The widths and depths a reference state dict implies."""
    hidden_dim, in_dim = np.shape(sd["fc.0.weight"])
    _, q, out_dim = np.shape(sd["decoder_query"])
    ffn = np.shape(sd[f"{core}.encoder.layers.0.linear1.weight"])[0]
    n = len({k.split(".")[3] for k in sd if k.startswith(f"{core}.encoder.layers.")})
    return dict(in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim, num_queries=q,
                num_layers=n, ffn_mult=ffn // out_dim)


def _from_state_dict(core: str, sd: Dict[str, np.ndarray], device) -> QueryTransformer:
    dev = resolve_device(device)
    model = QueryTransformer(core, **_sd_shapes(sd, core), device=dev)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()})
    return model


def dm_adapter_from_state_dict(sd: Dict[str, np.ndarray], device="cuda") -> QueryTransformer:
    """A reference DM_Adapter state dict (transformer under `adapter.`) → the
    module, widths read from the arrays."""
    return _from_state_dict("adapter", sd, device)


def vision_head_from_state_dict(sd: Dict[str, np.ndarray], device="cuda") -> QueryTransformer:
    """A reference VisionHead state dict (`visionHeadAdapter.`) → the module."""
    return _from_state_dict("visionHeadAdapter", sd, device)


def dm_adapter_apply(adapter: QueryTransformer, x: torch.Tensor) -> torch.Tensor:
    """DM_Adapter forward: [B, L, in_channels] → [B, Q, out] (JAX `dm_adapter_apply`)."""
    return adapter(x)


def vision_head_apply(head: QueryTransformer, vlm_last_hidden_state: torch.Tensor) -> torch.Tensor:
    """VisionHead forward (JAX `vision_head_apply`)."""
    return head(vlm_last_hidden_state)


def v1_aligned_embedding(vision_head: QueryTransformer, adapter: QueryTransformer,
                         vlm_last_hidden_state: torch.Tensor, is_video: bool = True
                         ) -> torch.Tensor:
    """The v1 conditioning chain: VLM hidden states → VisionHead [B, Q, d] →
    DM_Adapter per query token. Images use query 0 → [B, Qa, out]; videos
    run the adapter on each head query and concatenate → [B, Q·Qa, out]."""
    heads = vision_head(vlm_last_hidden_state)
    B, Q, D = heads.shape
    if not is_video:
        return adapter(heads[:, 0:1])
    per = adapter(heads.reshape(B * Q, 1, D))
    return per.reshape(B, Q * per.shape[1], per.shape[2])


# --- seeded init (from-scratch training, tests) ---------------------------

@torch.no_grad()
def _init(model: QueryTransformer, generator: Optional[torch.Generator]) -> QueryTransformer:
    """JAX's init distributions: weights and queries N(0, 0.05²), biases 0,
    LayerNorm gains 1 (drawn in module order from `generator`)."""
    def normal(p):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.05)

    normal(model.decoder_query)
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            normal(m.weight)
            m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            normal(m.in_proj_weight)
            m.in_proj_bias.zero_()
    return model


def init_vision_head(in_dim: int, hidden_dim: int, out_dim: int, num_queries: int = 4,
                     num_layers: int = 4, num_heads: int = NUM_HEADS, ffn_mult: int = 4,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> QueryTransformer:
    """Seeded VisionHead (the reference's shapes). The draws come from a
    torch.Generator, so they differ from JAX's; the tests carry JAX's
    weights across."""
    return _init(QueryTransformer("visionHeadAdapter", in_dim, hidden_dim, out_dim, num_queries,
                                  num_layers, ffn_mult, num_heads, resolve_device(device)),
                 generator)


def init_dm_adapter(in_dim: int, hidden_dim: int, out_dim: int, num_queries: int = 256,
                    num_layers: int = 4, num_heads: int = NUM_HEADS, ffn_mult: int = 4,
                    generator: Optional[torch.Generator] = None,
                    device="cuda") -> QueryTransformer:
    """Seeded DM_Adapter (the reference's shapes)."""
    return _init(QueryTransformer("adapter", in_dim, hidden_dim, out_dim, num_queries,
                                  num_layers, ffn_mult, num_heads, resolve_device(device)),
                 generator)
