"""Attention entry points (port of omnivideo_tpu/ops/attention.py).

`attention` is the dispatch of the unfused chain: the differentiable
`flash_attention_train` when grad mode is on and an input requires grad (the
custom VJP the JAX `attention(impl="pallas")` reaches under
`value_and_grad`), otherwise the inference `flash_attention` with its bounded
softmax. Each takes its kernel on CUDA and its plain twin on the CPU.

`attention_plain` is the einsum oracle (`attention_xla`): fixed shapes with
`kv_lens` masking (padded KV positions get −1e30 logits), natural-exp
softmax in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import NEG_INF, flash_attention, flash_attention_train


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    assume_normalized: bool = False,
) -> torch.Tensor:
    """q: [B, Lq, N, D]; k/v: [B, Lk, N, D]; kv_lens: [B] or None.
    assume_normalized (qk-normed q/k) lets the inference forward take the
    bounded softmax; the training forward is always max-tracked, as `_fa_fwd`
    drops the flag."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_train(q, k, v, kv_lens, softmax_scale)
    return flash_attention(q, k, v, kv_lens=kv_lens, softmax_scale=softmax_scale,
                           assume_normalized=assume_normalized)


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Einsum attention, f32 logits and softmax. q: [B, Lq, N, D]; k/v:
    [B, Lk, N, D]; kv_lens: [B] valid KV lengths or None."""
    D = q.shape[-1]
    Lk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    logits = torch.einsum("bind,bjnd->bnij", q.float(), k.float()) * torch.tensor(
        scale, dtype=torch.float32)
    if kv_lens is not None:
        mask = torch.arange(Lk, device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnij,bjnd->bind", probs.float(), v.float())
    return out.to(q.dtype)
