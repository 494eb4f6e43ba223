"""XLM-Roberta text encoder, the CLIP text tower (port of
omnivideo_tpu/models/xlm_roberta.py).

Token, type and position embeddings with roberta position ids (pad_id +
cumsum(mask)·mask), post-norm blocks (attention, then an exact-GELU FFN,
each added and layer-normed), an additive finfo.min bias on pad keys; the
head (`xlm_roberta_with_head_apply`) mean-pools the non-pad tokens (the
denominator clamped at 1, so an all-pad row pools to zeros) and runs a
bias-free GELU MLP into CLIP's joint space. The i2v pipeline does not call
it: it completes the XLM-R CLIP pair for text-image scoring.

Parameters keep the JAX dict layout: Linear kernels [in, out], LayerNorms
{scale, bias}, `blocks` a list of per-layer dicts (JAX stacks them for its
scan; io/jax_bridge.py `xlm_params_from_jax` splits them). Attention is
plain torch, as JAX computes it outside any kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.norms import layer_norm

PAD_ID = 1


def _affine_ln(x, p, eps):
    return layer_norm(x, eps) * p["scale"] + p["bias"]


def _dense(p, x):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


@torch.no_grad()
def init_xlm_roberta(vocab_size: int = 250002, max_seq_len: int = 514, type_size: int = 1,
                     dim: int = 1024, num_heads: int = 16, num_layers: int = 24, out_dim: int = 0,
                     dtype: torch.dtype = torch.float32, device="cuda",
                     generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Random params at XLM-R large's shapes by default: normal·0.02
    embeddings and kernels, zero biases, ones/zeros norms (`num_heads` only
    names the layout the forward's caller passes)."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev).normal_(
            0.0, 0.02, generator=generator).to(dtype)

    def lin(d_in, d_out, bias=True):
        p = {"kernel": normal(d_in, d_out)}
        if bias:
            p["bias"] = torch.zeros(d_out, dtype=dtype, device=dev)
        return p

    def ln():
        return {"scale": torch.ones(dim, dtype=dtype, device=dev),
                "bias": torch.zeros(dim, dtype=dtype, device=dev)}

    params: Dict[str, Any] = {
        "token_embedding": normal(vocab_size, dim),
        "type_embedding": normal(type_size, dim),
        "pos_embedding": normal(max_seq_len, dim),
        "norm": ln(),
        "blocks": [{"q": lin(dim, dim), "k": lin(dim, dim), "v": lin(dim, dim),
                    "o": lin(dim, dim), "norm1": ln(), "norm2": ln(),
                    "ffn_in": lin(dim, 4 * dim), "ffn_out": lin(4 * dim, dim)}
                   for _ in range(num_layers)],
    }
    if out_dim:
        mid = (dim + out_dim) // 2
        params["head"] = {"fc1": lin(dim, mid, bias=False), "fc2": lin(mid, out_dim, bias=False)}
    return params


@torch.no_grad()
def xlm_roberta_apply(params: Mapping[str, Any], ids: torch.Tensor, num_heads: int = 16,
                      pad_id: int = PAD_ID, post_norm: bool = True,
                      eps: float = 1e-5) -> torch.Tensor:
    """ids [B, L] → hidden states [B, L, dim] f32 (on the params' device)."""
    ids = ids.to(params["token_embedding"].device).long()
    B, L = ids.shape
    mask = (ids != pad_id).long()
    pos = pad_id + torch.cumsum(mask, dim=1) * mask
    x = (params["token_embedding"][ids] + params["type_embedding"][torch.zeros_like(ids)]
         + params["pos_embedding"][pos]).float()
    if post_norm:
        x = _affine_ln(x, params["norm"], eps)
    neg = torch.finfo(torch.float32).min
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, neg)  # [B, 1, 1, L]
    d = x.shape[-1] // num_heads

    def heads(t):
        return t.view(B, L, num_heads, d).transpose(1, 2)

    for p in params["blocks"]:
        def mha(h):
            q, k, v = (heads(_dense(p[n], h)) for n in ("q", "k", "v"))
            logits = (q @ k.transpose(-1, -2)) / float(np.sqrt(d)) + bias
            a = torch.softmax(logits, dim=-1) @ v
            return _dense(p["o"], a.transpose(1, 2).reshape(B, L, -1))

        def ffn(h):
            return _dense(p["ffn_out"], F.gelu(_dense(p["ffn_in"], h), approximate="none"))

        if post_norm:
            x = _affine_ln(x + mha(x), p["norm1"], eps)
            x = _affine_ln(x + ffn(x), p["norm2"], eps)
        else:
            x = x + mha(_affine_ln(x, p["norm1"], eps))
            x = x + ffn(_affine_ln(x, p["norm2"], eps))
    if not post_norm:
        x = _affine_ln(x, params["norm"], eps)
    return x


@torch.no_grad()
def xlm_roberta_with_head_apply(params: Mapping[str, Any], ids: torch.Tensor,
                                num_heads: int = 16, pad_id: int = PAD_ID,
                                eps: float = 1e-5) -> torch.Tensor:
    """Masked mean-pool of the hidden states, then the GELU MLP head →
    [B, out_dim]."""
    x = xlm_roberta_apply(params, ids, num_heads=num_heads, pad_id=pad_id, eps=eps)
    m = (ids.to(x.device) != pad_id).to(x.dtype)[..., None]
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    h = F.gelu(_dense(params["head"]["fc1"], pooled), approximate="none")
    return _dense(params["head"]["fc2"], h)


def xlm_roberta_state_dict_to_params(sd: Mapping[str, Any], device="cuda") -> Dict[str, Any]:
    """A reference XLMRoberta(WithHead) state dict (tensors or numpy arrays)
    → the params dict, f32 tensors on `device` (CUDA unless the caller asks
    for the CPU)."""
    device = resolve_device(device)

    def t(k):
        v = sd[k]
        return (v.detach() if torch.is_tensor(v)
                else torch.from_numpy(np.array(v, np.float32))).float().to(device)

    def lin(prefix):
        p = {"kernel": t(f"{prefix}.weight").T.contiguous()}
        if f"{prefix}.bias" in sd:
            p["bias"] = t(f"{prefix}.bias")
        return p

    def ln(prefix):
        return {"scale": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")}

    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    params: Dict[str, Any] = {
        "token_embedding": t("token_embedding.weight"),
        "type_embedding": t("type_embedding.weight"),
        "pos_embedding": t("pos_embedding.weight"),
        "norm": ln("norm"),
        "blocks": [{"q": lin(f"blocks.{i}.attn.q"), "k": lin(f"blocks.{i}.attn.k"),
                    "v": lin(f"blocks.{i}.attn.v"), "o": lin(f"blocks.{i}.attn.o"),
                    "norm1": ln(f"blocks.{i}.norm1"), "norm2": ln(f"blocks.{i}.norm2"),
                    "ffn_in": lin(f"blocks.{i}.ffn.0"), "ffn_out": lin(f"blocks.{i}.ffn.2")}
                   for i in range(n_layers)],
    }
    if "head.0.weight" in sd:
        params["head"] = {"fc1": lin("head.0"), "fc2": lin("head.2")}
    return params
