"""Ring attention over a process group (port of omnivideo_tpu/parallel/ring.py).

Each rank holds its sequence shard; K/V rotate to rank + 1 of the group
(`dist.batch_isend_irecv`) while every rank merges attention for its own
queries online: `ops.ring_attention.ring_flash_attention_shard`, the step
kernel (row 8) on the card and its plain twin on the CPU, the transfer for
the next step posted before each launch. `impl` takes JAX's two names,
"ppermute" and "pallas", and both run that one path, so nothing on the
card runs a plain version. `hybrid_attention` is Ulysses over an inner
group and the ring over an outer one; with `kv_lens` the kernel takes each
shard's valid keys
(`step_lens_for(chunks=nu)`), where JAX falls back to its unfused ring.
`zigzag_ring_attention` and `stripe_ring_attention` take the whole sequence
on every rank, run the load-balanced causal layouts through the kernel and
return the whole output on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.ring_attention import ring_flash_attention_shard, stripe_order, zigzag_order
from .ulysses import _a2a_gather_heads, _a2a_scatter_heads

RING_IMPLS = ("ppermute", "pallas")


def _mode(causal) -> Optional[str]:
    """The kernel's mode for JAX's `causal` (False, True = "block", or a mode name)."""
    if isinstance(causal, bool):
        return "block" if causal else None
    return causal


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    causal=False,
    softmax_scale: Optional[float] = None,
    impl: str = "ppermute",
    kv_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """This rank's shards q: [B, Lq/n, N, D], k/v: [B, Lk/n, N, D] (rank
    order) → its output shard. kv_lens: [B] valid global KV lengths
    (contiguous end padding)."""
    if impl not in RING_IMPLS:
        raise ValueError(f"ring impl {impl!r} not in {RING_IMPLS}")
    return ring_flash_attention_shard(q, k, v, group, kv_lens=kv_lens, causal=_mode(causal),
                                      softmax_scale=softmax_scale)


def hybrid_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ulysses_group=None,
    ring_group=None,
    causal=False,
    ring_impl: str = "ppermute",
    kv_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2-D Ulysses × ring. This rank holds global shard u·nr + r of nu·nr
    (u its Ulysses rank, r its ring rank): [B, L/(nu·nr), N, D]. The Ulysses
    all-to-all leaves ring rank r the chunks u'·nr + r for every u', heads
    N/nu; the ring runs over those; the second all-to-all trades back."""
    if ring_impl not in RING_IMPLS:
        raise ValueError(f"ring impl {ring_impl!r} not in {RING_IMPLS}")
    nu = dist.get_world_size(ulysses_group)
    if q.shape[2] % nu:
        raise ValueError(f"hybrid needs num_heads % ulysses size == 0: {q.shape[2]} over {nu}")
    q2, k2, v2 = (_a2a_scatter_heads(t, ulysses_group) for t in (q, k, v))
    o = ring_flash_attention_shard(q2, k2, v2, ring_group, kv_lens=kv_lens, causal=_mode(causal),
                                   chunks=nu)
    return _a2a_gather_heads(o, ulysses_group)


def _layout_ring(q, k, v, group, order, causal, softmax_scale):
    n, my = dist.get_world_size(group), dist.get_rank(group)
    L = q.shape[1]
    Ls = L // n
    idx = order.to(q.device)[my * Ls:(my + 1) * Ls]
    out = ring_flash_attention_shard(*(t[:, idx].contiguous() for t in (q, k, v)), group,
                                     causal=causal, softmax_scale=softmax_scale)
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous(), group=group)
    full = torch.empty_like(q)
    full[:, order.to(q.device)] = torch.cat(parts, 1)
    return full


def zigzag_ring_attention(q, k, v, group=None, softmax_scale: Optional[float] = None):
    """Token-causal attention in the zigzag layout (shard r holds chunks
    (r, 2n−1−r), so every rank does the same causal work). q/k/v: the whole
    [B, L, N, D] on every rank, L % 2n == 0; returns the whole output in the
    original order on every rank."""
    n = dist.get_world_size(group)
    if q.shape[1] % (2 * n):
        raise ValueError(f"zigzag needs L % 2n == 0: {q.shape[1]}, n = {n}")
    return _layout_ring(q, k, v, group, zigzag_order(q.shape[1], n), "zigzag", softmax_scale)


def stripe_ring_attention(q, k, v, group=None, softmax_scale: Optional[float] = None):
    """Token-causal attention in the stripe layout (shard r holds positions
    r + j·n). As zigzag_ring_attention, with L % n == 0."""
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"stripe needs L % n == 0: {q.shape[1]}, n = {n}")
    return _layout_ring(q, k, v, group, stripe_order(q.shape[1], n), "stripe", softmax_scale)
