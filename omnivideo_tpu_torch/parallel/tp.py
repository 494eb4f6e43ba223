"""Tensor parallelism (port of omnivideo_tpu/parallel/tp.py, and of the
collectives GSPMD inserts for the Megatron split of parallel/sharding.py).

q/k/v and ffn.0 are column-parallel over the 'tensor' mesh axis (their
weights and biases DTensors sharded on the output features), o and ffn.2
row-parallel (weights sharded on the input features, bias replicated), the
RMS-norm gains of q and k sharded like q and k. `tp_dense` is the DiT's
`dense` on such a weight: a column-parallel product takes the replicated
input through `copy_to_tp` (identity; its backward sums the ranks' input
grads) and returns this rank's output columns, so the activations arrive
with the head axis sharded; a row-parallel product sums the ranks' partial
outputs with `reduce_from_tp` (its backward is the identity: every rank
then holds the same replicated activation and its whole grad) and adds the
bias. `tp_rms_norm` normalises column-sharded q/k over the whole dim: the
sum of squares is all-reduced over 'tensor' (backward: all-reduced too, as
each rank's columns use it) and the local slice of the gain applied.
`tp_head_attention` attends this rank's N/tp heads with no collective at
all (JAX `shard_map` over the head axis).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from ..ops.attention import attention
from ..ops.lora import has_lora, scaled

TP_AXIS = "tensor"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward sums the grad over `group`."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` forward; identity backward (replicated consumer)."""
    return _ReduceFromTP.apply(x, group)


def tp_split(w: DTensor):
    """("col" or "row", the 'tensor' process group) of a TP-sharded weight."""
    mesh = w.device_mesh
    i = mesh.mesh_dim_names.index(TP_AXIS)
    pl = w.placements[i]
    if not isinstance(pl, Shard) or pl.dim not in (0, 1):
        raise ValueError(f"not a Megatron-split weight: placements {w.placements}")
    return ("col" if pl.dim == 0 else "row"), mesh.get_group(TP_AXIS)


def _local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return t.to_local() if isinstance(t, DTensor) else t


def tp_dense(lin, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x @ Wᵀ + b for a column- or row-parallel nn.Linear, in `dt`, with its
    LoRA delta when it is adapted (the adapter split as parallel/sharding.py
    places it): on a column-parallel site A is replicated and B holds this
    rank's output columns, and x @ A passes `copy_to_tp` so A's grad sums
    the ranks' shares; on a row-parallel site A holds this rank's input
    rows, the partial x @ A is summed by `reduce_from_tp` (so B, replicated,
    gets the whole grad on every rank) and the delta joins the reduced
    product before the bias."""
    kind, group = tp_split(lin.weight)
    w, b = _local(lin.weight), _local(lin.bias)
    x = x.to(dt)
    xc = copy_to_tp(x, group) if kind == "col" else x
    y = F.linear(xc, w.to(dt))
    if kind == "row":
        y = reduce_from_tp(y, group)
    if has_lora(lin):
        y = y + _tp_lora_delta(lin, x, kind, group, y.dtype)
    return y + b.to(dt)


def _tp_lora_delta(lin, x: torch.Tensor, kind: str, group, out_dtype) -> torch.Tensor:
    a, bb, s = _local(lin.lora_a).to(x.dtype), _local(lin.lora_b).to(x.dtype), lin.lora_scale
    h = x @ a
    h = copy_to_tp(h, group) if kind == "col" else reduce_from_tp(h, group)
    return scaled(h @ bb, s, out_dtype)


def tp_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, group) -> torch.Tensor:
    """`ops.norms.rms_norm` of column-sharded x over the whole (tensor-size
    times local) dim; `weight` is the gain DTensor sharded like x."""
    xf = x.float()
    ss = _AllReduceSharded.apply(xf.square().sum(-1, keepdim=True), group)
    d = x.shape[-1] * dist.get_world_size(group)
    y = xf * torch.rsqrt(ss / d + eps)
    return y.to(x.dtype) * _local(weight).to(x.dtype)


def tp_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    assume_normalized: bool = False,
) -> torch.Tensor:
    """Attention over this rank's heads: q/k/v [B, L, N/tp, D] (self- or
    cross-attention) → [B, Lq, N/tp, D]; no communication."""
    return attention(q, k, v, kv_lens=kv_lens, softmax_scale=softmax_scale,
                     assume_normalized=assume_normalized)
