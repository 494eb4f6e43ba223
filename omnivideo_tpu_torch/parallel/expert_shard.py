"""The Qwen3-VL MoE's expert banks split over a group of cards (the VLM's
`--vlm_fsdp n`; JAX engine.py places its params with `params_shardings` on
a (1, n, 1) mesh because Qwen3-VL-30B-A3B's 62 GB exceed one TPU chip).

The plan (`shard_plan`): each rank of the group holds columns [r·M/n,
(r+1)·M/n) of every expert's intermediate width M, the slice JAX's
`_leaf_spec` gives gate and up: `experts_gate` and `experts_up` [E, D, M]
split on dim 2, `experts_down` [E, M, D] on dim 1 (its rows, the same
columns of the product). Every other parameter (embeddings, the head,
attention, routers, norms, the vision tower) is whole on every rank. So the
routing, the sort and the group sizes are the same on every rank, the
grouped products (`ops/gmm.py`, rows 9) run unchanged on narrower banks,
and each rank's down product is a partial sum over its columns: the MoE
(models/qwen3vl/text_model.py `moe`) weights it by the router in f32, sums
the k slots in slot order, all-reduces the f32 sum over the group and
casts once. Splitting E instead (expert parallelism) would need megablox's
`group_offset`, the other ranks' rows zeroed and load balancing.

`vlm_group(n)` cuts the default process group into world / n groups of
consecutive ranks (every rank calls `new_group` for each, as torch
requires) and returns this rank's `ExpertShard`; `check_split` is the
width rule; `shard_experts` slices a whole model's banks in place;
`placements` and `shard_bytes` read what a model holds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

WIDTH_MULTIPLE = 8  # ops/gmm.py: the kernels take bf16 widths of whole 16-byte chunks
SPLIT_DIMS = {"experts_gate": 2, "experts_up": 2, "experts_down": 1}  # dim of M in each bank


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """Rank `rank` of `n` holds columns `cols(M)` of every bank. `group`
    is the process group the MoE all-reduces over (None: no all-reduce,
    each rank's output is its partial sum; the in-process tests sum them).
    `check_routing`: every MoE call compares its top-k experts across the
    group (two all-reduces and a host read a layer) and raises on a
    difference."""

    rank: int
    n: int
    group: Optional[dist.ProcessGroup] = None
    check_routing: bool = False

    def cols(self, M: int) -> Tuple[int, int]:
        w = M // self.n
        return self.rank * w, (self.rank + 1) * w


def check_split(M: int, n: int) -> None:
    """Raise unless M splits into n slices the grouped-product kernels take."""
    if n < 1 or M % n or (M // n) % WIDTH_MULTIPLE:
        raise ValueError(f"--vlm_fsdp {n}: the experts' intermediate width {M} must split into "
                         f"{n} slices of a multiple of {WIDTH_MULTIPLE} columns (the grouped "
                         "products' width rule, ops/gmm.py)")


def vlm_group(n: int, check_routing: bool = False) -> ExpertShard:
    """This rank's shard of a VLM group of n consecutive ranks; the default
    process group is cut into world / n such groups."""
    if not dist.is_initialized():
        raise ValueError(f"--vlm_fsdp {n} needs an initialised process group of n or a "
                         f"multiple of n processes (torchrun --nproc_per_node {n}); this run has "
                         "none")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n:
        raise ValueError(f"--vlm_fsdp {n} does not divide the process group's {world} ranks")
    mine = None
    for first in range(0, world, n):
        g = dist.new_group(list(range(first, first + n)))
        if first <= rank < first + n:
            mine = g
    return ExpertShard(rank % n, n, mine, check_routing)


def expert_slice(t: torch.Tensor, dim: int, shard: Optional[ExpertShard]) -> torch.Tensor:
    """The shard's columns of a bank whose dim `dim` is the full width (a
    view; the tensor itself when there is no shard or it is already the
    slice)."""
    if shard is None or shard.n == 1:
        return t
    lo, hi = shard.cols(t.shape[dim])
    return t.narrow(dim, lo, hi - lo)


def shard_plan(model: nn.Module) -> Dict[str, Optional[int]]:
    """Parameter name → the dim split over the group, None for whole."""
    return {name: SPLIT_DIMS.get(name.rsplit(".", 1)[-1])
            for name, _ in model.named_parameters()}


@torch.no_grad()
def shard_experts(model: nn.Module, shard: Optional[ExpertShard]) -> nn.Module:
    """Give every MoE of `model` the shard: its banks become the rank's
    columns (copies, the full banks freed), or stay as they are where they
    already hold slices of that width or n is 1. `shard=None` drops the
    shard from MoEs whose banks are whole; a slice cannot be regrown."""
    for mod in model.modules():
        if not hasattr(mod, "experts_down"):
            continue
        M = mod.cfg.moe_intermediate_size
        for name, dim in SPLIT_DIMS.items():
            p = getattr(mod, name)
            if p.shape[dim] != M and (shard is None or p.shape[dim] != M // shard.n):
                raise ValueError(f"shard_experts: a bank of {p.shape[dim]} of {M} columns cannot "
                                 f"take {shard}")
            if p.shape[dim] == M and shard is not None and shard.n > 1:
                setattr(mod, name, nn.Parameter(expert_slice(p.data, dim, shard).clone(),
                                                requires_grad=p.requires_grad))
        mod.shard = shard
    return model


def placements(model: nn.Module) -> Dict[str, Optional[Tuple[int, int, int]]]:
    """Parameter name → (dim, first column, end column) of the slice this
    rank holds, None for a whole parameter."""
    out = {}
    for name, dim in shard_plan(model).items():
        out[name] = None
        if dim is not None:
            mod = model.get_submodule(name.rsplit(".", 1)[0])
            shard = getattr(mod, "shard", None)
            M = mod.cfg.moe_intermediate_size
            out[name] = (dim, *(shard.cols(M) if shard is not None else (0, M)))
    return out


def shard_bytes(model: nn.Module) -> Dict[str, int]:
    """{"replicated": bytes of whole parameters, "sharded": bytes of this
    rank's bank slices}."""
    out = {"replicated": 0, "sharded": 0}
    plan = shard_plan(model)
    for name, p in model.named_parameters():
        out["sharded" if plan[name] is not None else "replicated"] += p.numel() * p.element_size()
    return out
