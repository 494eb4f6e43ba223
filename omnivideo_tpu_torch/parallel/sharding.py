"""Parameter sharding rules (port of omnivideo_tpu/parallel/sharding.py).

JAX places each leaf with a NamedSharding and GSPMD inserts the
collectives; the port applies the same two rules with torch's own:

- FSDP over the 'fsdp' axis: FSDP2 (`fully_shard`) on every `WanBlock`, then
  on the root module, so each block's parameters are all-gathered for its
  forward (and again for its backward) and its grads reduce-scattered.
  Leaves under 1,024 elements stay replicated (FSDP2's `ignored_params`), as
  JAX `_leaf_spec` keeps them; the threshold applies per block leaf (JAX's
  leaves are stacked over the layers). FSDP2 gathers one dtype per unit, so
  in a bf16 model the f32 leaves (modulation tables, norms, the head: ~11
  rows of dim per block) stay replicated too. FSDP2 shards dim 0 where JAX
  prefers the last divisible dim: the layout differs, the numbers do not.
- The Megatron split over 'tensor' (JAX `_TP_COL` / `_TP_ROW` /
  `_TP_COL_BIAS`), applied first, with `parallelize_module`: q/k/v and
  ffn.0 column-parallel (weight and bias sharded on dim 0, the output
  features), o and ffn.2 row-parallel (weight on dim 1, bias replicated).
  The RMS-norm gains of q and k are sharded on dim 0 like q and k, where
  GSPMD would slice a replicated gain. A LoRA adapter follows its site:
  column-parallel, A [d_in, r] replicated and B [r, d_out] sharded on dim
  1; row-parallel, A sharded on dim 0 and B replicated. The DiT's `dense` reads these
  weights itself (parallel/tp.py `tp_dense`), so the module hooks
  `parallelize_module` installs never run. FSDP2 then shards the TP
  DTensors over 'fsdp' (2-D placements).

The SFT tree (training/sft.py `SFTParams`: the text-only Qwen3 and the
alignment chain) takes the FSDP rule alone: FSDP2 on every Qwen3 decoder
layer, then on the root, which holds the embedding, the final norm, the
head and the chain. JAX's TP rule (`_tp_leaf_spec`) splits only leaves
under "blocks", the DiT's, so over 'tensor' the LM and the chain stay whole
on every rank, as in JAX; the port adds no Megatron split of Qwen3.

`params_shardings(module, mesh)` is the plan, per parameter name:
{"fsdp": dim or None, "tensor": dim or None}; `shard_params` applies it and
`placements` reads what a sharded module holds. The root's parameters are
gathered by its forward hook: a `UnifiedParams` loss runs inside its
`forward`, and a DiT whose `embed_context` is called outside the forward
(generate) first calls `gathered`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

from ..ops.lora import has_lora
from .mesh import axis_size

FSDP_MIN_NUMEL = 1024
TP_COL = ("self_attn.q", "self_attn.k", "self_attn.v", "cross_attn.q", "cross_attn.k",
          "cross_attn.v", "ffn.0")
TP_ROW = ("self_attn.o", "cross_attn.o", "ffn.2")
TP_GAINS = ("self_attn.norm_q", "self_attn.norm_k", "cross_attn.norm_q", "cross_attn.norm_k")


def _dit(module: nn.Module) -> nn.Module:
    """The WanDiT inside `module` (itself, or a UnifiedParams' `wan`)."""
    return module.wan if hasattr(module, "wan") else module


def _is_sft(module: nn.Module) -> bool:
    """An SFT tree (training/sft.py SFTParams): its `lm` is a Qwen3."""
    return hasattr(module, "lm")


def _units(module: nn.Module):
    """The FSDP2 units below the root: the DiT's blocks, or the Qwen3's
    decoder layers."""
    if _is_sft(module):
        return list(module.lm.language_model.layers)
    return list(_dit(module).blocks)


def _tp_rule(local_name: str) -> Optional[int]:
    """Sharded dim of a block parameter under the Megatron split, or None.
    local_name is relative to the block, e.g. 'self_attn.q.weight'."""
    mod, _, leaf = local_name.rpartition(".")
    if mod in TP_COL:
        return {"lora_a": None, "lora_b": 1}.get(leaf, 0)
    if mod in TP_ROW:
        return {"weight": 1, "lora_a": 0}.get(leaf)
    if mod in TP_GAINS:
        return 0
    return None


def _replicated(module: nn.Module) -> set:
    """The leaves FSDP2 leaves whole: under FSDP_MIN_NUMEL elements, or not
    of the dtype that holds most of the module's elements."""
    by_dtype: Dict[torch.dtype, int] = {}
    for p in module.parameters():
        by_dtype[p.dtype] = by_dtype.get(p.dtype, 0) + p.numel()
    major = max(by_dtype, key=by_dtype.get)
    return {p for p in module.parameters() if p.numel() < FSDP_MIN_NUMEL or p.dtype != major}


def params_shardings(module: nn.Module, mesh: DeviceMesh) -> Dict[str, Dict[str, Optional[int]]]:
    """The plan: {parameter name: {"fsdp": dim or None, "tensor": dim or
    None}} for `module` (a WanDiT, a UnifiedParams or an SFTParams) on
    `mesh`."""
    fsdp, tp = axis_size(mesh, "fsdp"), axis_size(mesh, "tensor")
    if _is_sft(module):
        tp = 1  # JAX's TP rule splits the DiT's blocks only
    prefix = "wan." if hasattr(module, "wan") else ""
    whole = _replicated(module)
    plan = {}
    for name, p in module.named_parameters():
        t = None
        parts = name[len(prefix):].split(".")
        if tp > 1 and parts[0] == "blocks":
            t = _tp_rule(".".join(parts[2:]))
        f = 0 if fsdp > 1 and p not in whole else None
        plan[name] = {"fsdp": f, "tensor": t}
    return plan


def _check_tp(dit: nn.Module, tp: int) -> None:
    cfg = dit.cfg
    if cfg.num_heads % tp or cfg.ffn_dim % tp:
        raise ValueError(f"tensor parallelism needs num_heads ({cfg.num_heads}) and ffn_dim "
                         f"({cfg.ffn_dim}) divisible by tensor = {tp}")


def apply_tp(module: nn.Module, mesh: DeviceMesh) -> None:
    """The Megatron split of every block over mesh['tensor']."""
    dit = _dit(module)
    tp_mesh = mesh["tensor"]
    _check_tp(dit, tp_mesh.size())
    plan = {**{n: ColwiseParallel() for n in TP_COL}, **{n: RowwiseParallel() for n in TP_ROW}}
    for blk in dit.blocks:
        adapters = {}  # placed here: ColwiseParallel would shard every parameter on dim 0,
        for name in TP_COL + TP_ROW:  # and the scale stays a plain buffer
            lin = blk.get_submodule(name)
            if has_lora(lin):
                adapters[name] = (lin._parameters.pop("lora_a"), lin._parameters.pop("lora_b"),
                                  lin._buffers.pop("lora_scale"))
        parallelize_module(blk, tp_mesh, plan)
        for name in TP_GAINS:
            gain = blk.get_submodule(name)
            gain.weight = nn.Parameter(distribute_tensor(gain.weight.data, tp_mesh, [Shard(0)]))
        for name, (a, b, scale) in adapters.items():
            lin = blk.get_submodule(name)
            lin.register_buffer("lora_scale", scale)
            for leaf, t in (("lora_a", a), ("lora_b", b)):
                dim = _tp_rule(f"{name}.{leaf}")
                pl = [Replicate()] if dim is None else [Shard(dim)]
                lin.register_parameter(leaf, nn.Parameter(
                    distribute_tensor(t.data, tp_mesh, pl), requires_grad=t.requires_grad))


def shard_params(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard `module` (a WanDiT, a UnifiedParams or an SFTParams) in place:
    the Megatron split of the DiT over 'tensor' when it has more than one
    rank, then FSDP2 over 'fsdp' per block (per decoder layer) and at the
    root. Returns the module."""
    if axis_size(mesh, "tensor") > 1 and not _is_sft(module):
        apply_tp(module, mesh)
    fsdp_mesh = mesh["fsdp"]
    whole = _replicated(module)
    units = [fully_shard(blk, mesh=fsdp_mesh, ignored_params=whole) for blk in _units(module)]
    units.append(fully_shard(module, mesh=fsdp_mesh, ignored_params=whole))
    if fsdp_mesh.device_type == "cpu":  # gloo has neither AVG nor PREMUL_SUM
        for m in units:
            m.set_force_sum_reduction_for_comms(True)
    return module


def shard_dim(placement) -> Optional[int]:
    """The tensor dim a placement shards (Shard, and FSDP2's strided shard
    of a TP-sharded dim), or None (Replicate, Partial)."""
    return getattr(placement, "dim", None)


def placements(module: nn.Module) -> Dict[str, Dict[str, Optional[int]]]:
    """What a sharded module holds, in `params_shardings`' terms: per
    parameter the dim sharded over 'fsdp' and over 'tensor' (None: not)."""
    out = {}
    for name, p in module.named_parameters():
        rec = {"fsdp": None, "tensor": None}
        if isinstance(p, DTensor):
            for axis, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
                rec[axis] = shard_dim(pl)
        out[name] = rec
    return out


def fsdp_managed(p: torch.Tensor) -> bool:
    """Whether FSDP2 shards `p` (and so reduce-scatters its grad)."""
    return isinstance(p, DTensor) and "fsdp" in p.device_mesh.mesh_dim_names


class gathered:
    """Context manager: the root FSDP unit's own parameters all-gathered
    (for calls outside its forward, such as `WanDiT.embed_context`), and
    resharded on exit. A no-op for a module FSDP2 does not shard."""

    def __init__(self, module: nn.Module):
        self.module = module if isinstance(module, FSDPModule) else None

    def __enter__(self):
        if self.module is not None:
            self.module.unshard()
        return self

    def __exit__(self, *exc):
        if self.module is not None:
            self.module.reshard()
