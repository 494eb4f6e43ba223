"""Einsum attention (port of omnivideo_tpu/ops/attention.py `attention_xla`).

Fixed shapes with `kv_lens` masking (padded KV positions get −1e30 logits),
no varlen packing, natural-exp softmax in f32. It is the CPU oracle the JAX
package's unfused path is held to, and the attention of the port's unfused
WanBlock branch, which runs on the CPU only: every config of the port takes
the fused qk_prep + flash path (`ops/flash_attention.py`) on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import NEG_INF


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
