"""Ulysses sequence-parallel attention (port of omnivideo_tpu/parallel/ulysses.py).

Each rank of the group holds a contiguous sequence shard [B, L/n, N, D]
(rank order). An all-to-all trades it for the whole sequence of N/n heads,
attention runs on that, and a second all-to-all trades back. The
all-to-alls are `dist.all_to_all_single` on the tensors where they lie (the
card under NCCL). Attention is the port's `ops.attention.attention`: on the
card the flash kernel (row 1), on the CPU its plain twin. The JAX package's
`comm_dtype` is left out: the DiT hands q/k/v in the param dtype already.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.attention import attention


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all over dim 0 (one slice per rank)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _a2a_scatter_heads(x: torch.Tensor, group=None) -> torch.Tensor:
    """[B, L/n, N, D] → [B, L, N/n, D], sequence in rank order."""
    n = dist.get_world_size(group)
    B, Ls, N, D = x.shape
    parts = x.reshape(B, Ls, n, N // n, D).permute(2, 0, 1, 3, 4)  # [n, B, Ls, N/n, D]
    return _a2a(parts, group).permute(1, 0, 2, 3, 4).reshape(B, n * Ls, N // n, D)


def _a2a_gather_heads(x: torch.Tensor, group=None) -> torch.Tensor:
    """[B, L, N/n, D] → [B, L/n, N, D], heads in rank order."""
    n = dist.get_world_size(group)
    B, L, Nn, D = x.shape
    parts = x.reshape(B, n, L // n, Nn, D).transpose(0, 1)  # [n, B, L/n, N/n, D]
    return _a2a(parts, group).permute(1, 2, 0, 3, 4).reshape(B, L // n, n * Nn, D)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    kv_lens: Optional[torch.Tensor] = None,
    assume_normalized: bool = False,
) -> torch.Tensor:
    """This rank's shards q: [B, Lq/n, N, D], k/v: [B, Lk/n, N, D] →
    its output shard [B, Lq/n, N, D]. kv_lens: [B] valid global KV lengths.
    Needs N % n == 0."""
    n = dist.get_world_size(group)
    N = q.shape[2]
    if N % n:
        raise ValueError(f"Ulysses needs num_heads % sp == 0: {N} heads over {n} ranks")
    q, k, v = (_a2a_scatter_heads(t, group) for t in (q, k, v))
    o = attention(q, k, v, kv_lens=kv_lens, assume_normalized=assume_normalized)
    return _a2a_gather_heads(o, group)
