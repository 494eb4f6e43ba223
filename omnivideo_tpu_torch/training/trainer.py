"""Flow-matching trainer (port of omnivideo_tpu/training/trainer.py).

The loss is mean_b(w_b · mean((v̂ − (ε − x))²)) with the Gaussian-bump
timestep weights, timesteps drawn uniform, logit-normal or "mode", CFG
condition dropout (per sample the text and VLM conditioning swap for zero
text + the 2-token null VLM, the visual context stays). The DiT runs the
unfused attention chain, so attention is the differentiable flash path
(kernels on the card), with per-block remat and an optional bf16 carry.

The optimizer reproduces optax's, not torch.optim's defaults:
clip_by_global_norm (g·max/‖g‖ only when ‖g‖ ≥ max; grad_clip = 0 disables
it) → adamw (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments, decoupled
decay lr·wd·p on every leaf) or adafactor (optax's defaults, grouped over
JAX's stacked leaves, then the lr-scaled decay lr·wd·p: `_AdafactorRule`;
torch.optim.Adafactor is another algorithm) with
warmup_cosine_decay_schedule(0, lr,
warmup = min(warmup_steps, total − 1), decay = max(total, warmup + 1))
evaluated at the update count before it increments (so with warmup ≥ 1 the
first update has lr 0); optax.masked freezing (only the trainable leaves
are clipped, moved and carry moments); optax.MultiSteps accumulation (the
running mean of k micro-batch grads applied on every k-th call, zero updates
between; the inner count advances only on apply). grad_norm is the global
norm of the grads of every parameter that requires one: all of them, as
JAX differentiates every param, unless the caller froze some
(`training/lora.py` `freeze_base`: under LoRA only the adapters get grads,
where JAX's grad_norm also counts the frozen base's). Parameters and
optimizer state update in place.

JAX's threefry draws cannot be reproduced in torch: the loss takes explicit
optional draws (tid, noise, drop), and the train step draws them from its
torch.Generator when they are absent.

On a mesh (`mesh`, parallel/mesh.py; JAX's `mesh` argument) every process
runs the step on its own rows, and the numbers are one process's:
- batch: the global batch splits over 'data' only (JAX `batch_sharding`);
  `batch` is this process's rows, and processes that share a data index
  hold the same rows. Draws are made for the global batch from the same
  generator on every process, then sliced, so 'seq' and 'tensor' ranks see
  the same t, noise and dropout.
- `sp` (models/wan_dit.py `SPConfig`) runs the DiT sequence-parallel
  (Ulysses, the ring or the hybrid; the token count padded to a multiple of
  the SP size unless `seq_len` is given) or tensor-parallel (mode "tp").
  Parameters are replicated, or sharded by parallel/sharding.py
  `shard_params` (FSDP2 over 'fsdp', the Megatron split over 'tensor').
- gradients (`reduce_gradients`): every process's grad is its own tokens'
  and rows' share. Over each axis that shards tokens ('seq', and 'fsdp'
  under the hybrid) they are summed; over 'data' averaged (each data index
  holds a mean over its rows); over 'fsdp' otherwise averaged (those ranks
  computed identical rows). FSDP2 reduce-scatters its parameters' grads
  over 'fsdp' with its default mean, or with divide factor 1 (a sum) when
  'fsdp' shards tokens; 'seq' and 'data', and the replicated leaves' 'fsdp',
  this module all-reduces itself. Over 'tensor' nothing is reduced: the
  Megatron split's collectives (parallel/tp.py) leave each rank its
  shards' whole grads and identical grads of the replicated leaves.
- grad_norm, clipping and the update read sharded (DTensor) grads and
  params through their local shards; the norm sums each shard's squares
  over the axes it is sharded on, so it is the global one, and adafactor
  reduces its leaf sums and its means along sharded dims the same way. The
  reported loss is averaged over 'data'.
Left for later (ROADMAP §1 item 6): the streamed trainers.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import FSDPModule
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import PipelineConfig
from ..device import resolve_device
from ..models.unified import (
    Companions,
    build_mixed_context_batch,
    init_unified_companions,
    null_ar_vision,
)
from ..models.wan_dit import SPConfig, WanDiT
from ..parallel.mesh import axis_size, batch_slice
from ..parallel.sharding import fsdp_managed, shard_dim
from ..schedulers.flow_match import FlowMatchScheduler

Draws = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]  # tid, noise, drop


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-6
    weight_decay: float = 0.01
    grad_clip: float = 0.1
    warmup_steps: int = 500
    total_steps: int = 10_000
    flow_shift: float = 3.0
    cfg_dropout: float = 0.2
    num_train_timesteps: int = 1000
    remat: bool = True
    grad_accum_steps: int = 1
    optimizer: str = "adamw"  # | "adafactor" (factored second moment, lr-scaled decay)
    carry_dtype: str = "float32"  # | "bfloat16": the inter-block carry / remat checkpoints
    timestep_sampling: str = "uniform"  # | "logit_normal" | "mode"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.29
    trainable_filters: tuple = ()  # substrings of JAX param paths; empty = all


@dataclasses.dataclass
class TrainState:
    params: nn.Module  # updated in place by the train step
    opt_state: Dict[str, Any]
    step: int = 0


class UnifiedParams(nn.Module):
    """The unified model's trainable tree: {'wan': WanDiT, 'companions'}."""

    def __init__(self, wan: WanDiT, companions: Companions):
        super().__init__()
        self.wan = wan
        self.companions = companions

    def forward(self, fn: Callable, *args, **kwargs):
        """fn(self, *args, **kwargs): the loss runs inside the module's
        forward, so FSDP2's root hooks gather the root's parameters."""
        return fn(self, *args, **kwargs)


def init_unified_params(cfg: PipelineConfig, seed: int = 0, device="cuda",
                        dtype: torch.dtype = torch.float32) -> UnifiedParams:
    """Seeded f32 master params (the JAX init's distributions; zero head)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    wan = WanDiT(cfg.dit.replace(text_len=cfg.max_context_len), dtype=dtype, device=device,
                 generator=gen)
    return UnifiedParams(wan, Companions(init_unified_companions(cfg, device=device,
                                                                 generator=gen)))


# --- parameter paths (the JAX pytree's, for trainable_filters) ------------

_RENAMES = (("text_embedding/0/", "text_embedding/fc1/"), ("text_embedding/2/", "text_embedding/fc2/"),
            ("time_embedding/0/", "time_embedding/fc1/"), ("time_embedding/2/", "time_embedding/fc2/"),
            ("time_projection/1/", "time_projection/"), ("ffn/0/", "ffn/fc1/"), ("ffn/2/", "ffn/fc2/"),
            ("img_emb/proj/0/", "img_emb/ln1/"), ("img_emb/proj/1/", "img_emb/fc1/"),
            ("img_emb/proj/3/", "img_emb/fc2/"), ("img_emb/proj/4/", "img_emb/ln2/"))


def jax_path(name: str) -> str:
    """A port parameter name → the "/"-joined path of the same leaf in the
    JAX param tree ({'wan', 'companions'} or a bare DiT tree), which is what
    trainable_filters match: 'wan.blocks.3.self_attn.q.weight' →
    'wan/blocks/self_attn/q/kernel' (the stacked layer axis has no key)."""
    if name.startswith("companions."):
        return name.replace(".", "/")
    prefix = ""
    if name.startswith("wan."):
        prefix, name = "wan/", name[len("wan."):]
    parts = name.split(".")
    if parts[0] == "blocks":
        del parts[1]
    path = "/".join(parts)
    for a, b in _RENAMES:
        path = path.replace(a, b)
    if path.endswith(("norm_q/weight", "norm_k/weight", "norm_k_img/weight")):
        path = path[: -len("/weight")]
    elif path.endswith(("norm3/weight", "ln1/weight", "ln2/weight")):
        path = path[: -len("weight")] + "scale"
    elif path.endswith("/weight"):
        path = path[: -len("weight")] + "kernel"
    return prefix + path


def trainable_names(model: nn.Module, filters: Iterable[str]) -> set:
    """Names of the parameters whose JAX path contains any filter (all when
    there is none)."""
    filters = tuple(filters)
    return {n for n, _ in model.named_parameters()
            if not filters or any(f in jax_path(n) for f in filters)}


# --- optimizer -----------------------------------------------------------

def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay), the warmup
    clamped for short runs as in JAX, rounded to f32."""
    warmup = min(tc.warmup_steps, max(tc.total_steps - 1, 0))
    return warmup_cosine_schedule(tc.learning_rate, warmup, max(tc.total_steps, warmup + 1))


def warmup_cosine_schedule(peak: float, warmup: int, decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps) at a
    count, rounded to f32: linear from 0 over `warmup` counts, then a cosine
    to 0 over the remaining decay_steps − warmup."""
    decay = decay_steps - warmup

    def sched(count: int) -> float:
        if count < warmup:
            return float(np.float32(-peak * (1.0 - count / warmup) + peak))
        c = min(count - warmup, decay)
        return float(np.float32(peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))))

    return sched


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: in-place writes reach it), else t."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) in f32 (optax.global_norm). A DTensor contributes its
    local shard's squares summed over the mesh dims it is sharded on."""
    tensors = [t for t in tensors if t is not None]
    if not any(isinstance(t, DTensor) for t in tensors):
        return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()
    by_groups: Dict[tuple, list] = {}
    for t in tensors:
        by_groups.setdefault(tuple(_sharded_groups(t)), []).append(
            _local(t).float().square().sum())
    total = []
    for groups, sq in by_groups.items():
        part = torch.stack(sq).sum()
        for g in groups:
            dist.all_reduce(part, group=g)
        total.append(part)
    return torch.stack(total).sum().sqrt()


class _AdamWRule:
    """optax.adamw (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments,
    decoupled decay lr·wd·p) on each trainable leaf."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tc: TrainConfig, sched: Callable[[int], float]):
        self.wd, self.sched = tc.weight_decay, sched

    def init(self, leaves) -> Dict[str, Any]:
        return {"mu": {n: torch.zeros_like(p) for n, p in leaves},
                "nu": {n: torch.zeros_like(p) for n, p in leaves}}

    def apply(self, leaves, g: Dict[str, torch.Tensor], state: Dict[str, Any], count: int) -> None:
        t = np.float32(count + 1)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        neg_lr = -self.sched(count)
        for n, p in leaves:
            mu, nu, p, gn = _local(state["mu"][n]), _local(state["nu"][n]), _local(p), g[n]
            mu.copy_((1 - self.b1) * gn + self.b1 * mu)
            nu.copy_((1 - self.b2) * gn.square() + self.b2 * nu)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps) + self.wd * p
            p.copy_(p + neg_lr * u)


def _shard_groups(t: torch.Tensor, dim: int) -> list:
    """The process groups over which tensor dim `dim` of `t` is sharded
    (none for a plain tensor or a replicated dim)."""
    if not isinstance(t, DTensor):
        return []
    return [t.device_mesh.get_group(i) for i, pl in enumerate(t.placements)
            if shard_dim(pl) == dim]


def _sharded_groups(t: torch.Tensor) -> list:
    """The process groups over which any dim of `t` is sharded."""
    if not isinstance(t, DTensor):
        return []
    return [t.device_mesh.get_group(i) for i, pl in enumerate(t.placements)
            if shard_dim(pl) is not None]


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    for grp in groups:
        dist.all_reduce(x, group=grp)
    return x


def _mean(x: torch.Tensor, dim: int, like: torch.Tensor, like_dim: int,
          keepdim: bool = False) -> torch.Tensor:
    """mean of the local x over `dim`, which is dim `like_dim` of `like`
    (a possibly sharded tensor): the local sums are all-reduced over the
    groups that shard it and divided by its global size."""
    groups = _shard_groups(like, like_dim)
    if not groups:
        return x.mean(dim, keepdim=keepdim)
    return _all_reduce(x.sum(dim, keepdim=keepdim), groups) / like.shape[like_dim]


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims` (min_dim_size_to_factor 128): the second
    largest and the largest axis, or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _drop_placement(pl, d: int):
    """A placement of a tensor with dim `d` removed (Replicate where `d` was
    the sharded dim)."""
    sd = shard_dim(pl)
    if sd is None or sd < d:
        return pl
    if sd == d:
        return Replicate()
    return Shard(sd - 1)


def _zeros_without(p: torch.Tensor, d: int) -> torch.Tensor:
    """f32 zeros of p's shape with dim `d` removed, sharded as p is on the
    other dims (a DTensor when p is one)."""
    loc = _local(p)
    z = torch.zeros(loc.shape[:d] + loc.shape[d + 1:], dtype=torch.float32, device=loc.device)
    if not isinstance(p, DTensor):
        return z
    shape = p.shape[:d] + p.shape[d + 1:]
    return DTensor.from_local(z, p.device_mesh, [_drop_placement(pl, d) for pl in p.placements],
                              run_check=False, shape=shape, stride=torch.empty(shape).stride())


class _AdafactorRule:
    """optax.adafactor(learning_rate=sched) with its defaults (factored
    second moment: min_dim_size_to_factor 128, decay_rate 0.8, offset 0,
    eps 1e-30; clip_by_block_rms(1.0); multiply_by_parameter_scale with
    min_scale 1e-3; no momentum), then JAX's `_lr_scaled_decay`
    (u − sched(count)·wd·p) when weight_decay is set.

    optax works on JAX's leaves, whose block leaves stack the layers ([L,
    d_in, d_out]); the port holds one parameter per layer as [d_out, d_in].
    Leaves are grouped by `jax_path` (which drops the layer index): the
    parameter RMS, the update's block RMS and the choice of factored dims
    are taken over the group, in JAX's orientation; the factored row and
    column statistics stay per layer (the layer axis is kept in JAX too).
    A sharded parameter (FSDP2, the Megatron split) has every sum over its
    elements and every mean along a sharded dim all-reduced over the
    groups that shard it, so the update is the single-process one."""

    decay_rate, eps, clip, min_scale = 0.8, 1e-30, 1.0, 1e-3

    def __init__(self, tc: TrainConfig, sched: Callable[[int], float]):
        self.wd, self.sched = tc.weight_decay, sched

    def _plan(self, leaves) -> Dict[str, list]:
        """{group path: [(name, param, dims)]}: dims is optax's (d1, d0) as
        the port parameter's axes (v_row drops d0, v_col d1), or None."""
        groups: Dict[str, list] = {}
        for n, p in leaves:
            groups.setdefault(jax_path(n), []).append((n, p))
        plan = {}
        for path, members in groups.items():
            p0 = members[0][1]
            transposed = path.endswith("/kernel") and p0.ndim == 2
            shape = tuple(reversed(p0.shape)) if transposed else tuple(p0.shape)
            stacked = re.search(r"(^|\.)(blocks|layers)\.\d+\.", members[0][0]) is not None
            if stacked:
                shape = (len(members),) + shape
            dims = _factored_dims(shape)
            if dims is not None and stacked:
                if 0 in dims:
                    raise NotImplementedError(
                        f"adafactor would factor {path} across its {len(members)} layers: "
                        "the port keeps its statistics per layer (ROADMAP §3, adafactor)")
                dims = tuple(d - 1 for d in dims)
            if dims is not None and transposed:
                dims = tuple(1 - d for d in dims)
            plan[path] = [(n, p, dims) for n, p in members]
        return plan

    def init(self, leaves) -> Dict[str, Any]:
        state: Dict[str, Any] = {"v": {}, "v_row": {}, "v_col": {}, "factored": {}}
        for members in self._plan(leaves).values():
            for n, p, dims in members:
                if dims is None:
                    state["v"][n] = torch.zeros_like(p)
                else:
                    d1, d0 = dims
                    state["v_row"][n] = _zeros_without(p, d0)
                    state["v_col"][n] = _zeros_without(p, d1)
                    state["factored"][n] = list(dims)
        return state

    def _scaled(self, n, p, g, dims, state, dr: float) -> torch.Tensor:
        """scale_by_factored_rms for one layer's leaf: the new statistics
        into `state`, the scaled update returned (local)."""
        one_m = float(np.float32(1.0) - np.float32(dr))
        g2 = g.square() + self.eps
        if dims is None:
            v = _local(state["v"][n])
            v.copy_(dr * v + one_m * g2)
            return g * v.pow(-0.5)
        d1, d0 = dims
        vr, vc = _local(state["v_row"][n]), _local(state["v_col"][n])
        vr.copy_(dr * vr + one_m * _mean(g2, d0, p, d0))
        vc.copy_(dr * vc + one_m * _mean(g2, d1, p, d1))
        red = d1 - 1 if d1 > d0 else d1  # d1's axis in v_row
        rcm = _mean(vr, red, p, d1, keepdim=True)
        return g * (vr / rcm).pow(-0.5).unsqueeze(d0) * vc.pow(-0.5).unsqueeze(d1)

    def apply(self, leaves, g: Dict[str, torch.Tensor], state: Dict[str, Any], count: int) -> None:
        t = np.float32(count + 1)
        dr = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        lr = self.sched(count)
        lr_wd = float(np.float32(lr) * np.float32(self.wd))
        for members in self._plan(leaves).values():
            groups = _sharded_groups(members[0][1])
            numel = sum(p.numel() for _, p, _ in members)
            us = [self._scaled(n, p, g[n], dims, state, dr) for n, p, dims in members]
            sums = torch.stack([torch.stack([u.square().sum() for u in us]).sum(),
                                torch.stack([_local(p).float().square().sum()
                                             for _, p, _ in members]).sum()])
            u_ms, p_ms = _all_reduce(sums, groups) / numel
            denom = torch.clamp_min(u_ms.sqrt() / self.clip, 1.0)
            p_rms = p_ms.sqrt()
            scale = torch.where(p_rms <= self.min_scale, self.min_scale, p_rms)
            for (n, p, _), u in zip(members, us):
                p = _local(p)
                u = -(((u / denom) * lr) * scale)
                if self.wd:
                    u = u - lr_wd * p
                p.copy_(p + u)


class _Clipped:
    """Gradients clipped on access, (g / norm) · clip per leaf, so the clip
    holds one scaled leaf at a time, not a scaled copy of every gradient."""

    def __init__(self, g: Dict[str, torch.Tensor], norm: torch.Tensor, clip: float):
        self.g, self.norm, self.clip = g, norm, clip

    def __getitem__(self, n: str) -> torch.Tensor:
        return (self.g[n] / self.norm) * self.clip


class Optimizer:
    """The port's `make_optimizer`: clip_by_global_norm → the inner rule
    (`tc.optimizer`: "adamw", or "adafactor" with the lr-scaled decay),
    masked to the trainable leaves, inside MultiSteps when
    grad_accum_steps > 1 (see the module docstring). The clip, the mask
    and the accumulation are shared; the count advances once per applied
    update and every schedule reads it before it increments. `sched`
    replaces `lr_schedule(tc)` (training/sft.py's unclamped warmup). `init`
    builds the state, `update` applies one call's grads to the parameters
    in place."""

    RULES = ("adamw", "adafactor")

    def __init__(self, tc: TrainConfig, trainable: Optional[set] = None,
                 sched: Optional[Callable[[int], float]] = None):
        if tc.optimizer not in self.RULES:
            raise ValueError(f"optimizer {tc.optimizer!r} not in {self.RULES}")
        self.tc = tc
        self.trainable = trainable
        self.sched = sched if sched is not None else lr_schedule(tc)
        self.rule = (_AdamWRule(tc, self.sched) if tc.optimizer == "adamw" else
                     _AdafactorRule(tc, self.sched))

    def _leaves(self, model: nn.Module):
        """The trainable leaves: in `trainable` (all when None) and not frozen."""
        return [(n, p) for n, p in model.named_parameters()
                if p.requires_grad and (self.trainable is None or n in self.trainable)]

    def init(self, model: nn.Module) -> Dict[str, Any]:
        leaves = self._leaves(model)
        state = {"count": 0, **self.rule.init(leaves)}
        if self.tc.grad_accum_steps > 1:
            state.update(mini_step=0, acc={n: torch.zeros_like(p) for n, p in leaves})
        return state

    @torch.no_grad()
    def update(self, model: nn.Module, grads: Dict[str, torch.Tensor],
               state: Dict[str, Any]) -> bool:
        """Apply grads (name → tensor, at least every trainable parameter).
        Returns whether the parameters moved (False between MultiSteps
        applies)."""
        leaves = self._leaves(model)
        g = {n: _local(grads[n]) for n, _ in leaves}
        k = self.tc.grad_accum_steps
        if k > 1:  # running mean acc + (g − acc)/(n + 1), applied on the k-th call
            n_acc = state["mini_step"]
            for n, _ in leaves:
                acc = _local(state["acc"][n])
                acc.copy_(acc + (g[n] - acc) / (n_acc + 1))
            if n_acc < k - 1:
                state["mini_step"] = n_acc + 1
                return False
            g = {n: _local(a) for n, a in state["acc"].items()}
            state["mini_step"] = 0
        if self.tc.grad_clip:
            norm = global_norm([state["acc"][n] if k > 1 else grads[n] for n, _ in leaves])
            if float(norm) >= self.tc.grad_clip:
                g = _Clipped(g, norm, self.tc.grad_clip)
        self.rule.apply(leaves, g, state, state["count"])
        state["count"] += 1
        if k > 1:
            for acc in state["acc"].values():
                _local(acc).zero_()
        return True


def make_optimizer(tc: TrainConfig, params: Optional[nn.Module] = None) -> Optimizer:
    """As JAX's: the freezing mask applies when params are given and
    trainable_filters is non-empty."""
    trainable = None
    if params is not None and tc.trainable_filters:
        trainable = trainable_names(params, tc.trainable_filters)
    return Optimizer(tc, trainable)


def init_train_state(params: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


# --- the loss and the train step ------------------------------------------

def sample_timestep_ids(gen: torch.Generator, B: int, tc: TrainConfig) -> torch.Tensor:
    """Timestep indices [B] int64 under tc.timestep_sampling, on gen's device."""
    T, dev = tc.num_train_timesteps, gen.device
    if tc.timestep_sampling == "logit_normal":
        u = torch.sigmoid(torch.randn(B, generator=gen, device=dev) * tc.logit_std
                          + tc.logit_mean)
    elif tc.timestep_sampling == "mode":
        u = torch.rand(B, generator=gen, device=dev)
        u = 1.0 - u - tc.mode_scale * (torch.cos(math.pi * u / 2) ** 2 - 1.0 + u)
    elif tc.timestep_sampling == "uniform":
        return torch.randint(0, T, (B,), generator=gen, device=dev)
    else:
        raise ValueError(f"unknown timestep_sampling {tc.timestep_sampling!r}")
    return (u * T).to(torch.int32).clamp(0, T - 1).long()


def sample_draws(gen: torch.Generator, latents_shape, tc: TrainConfig) -> Draws:
    """(tid [B], noise, drop [B] bool or None) from one generator."""
    B = latents_shape[0]
    tid = sample_timestep_ids(gen, B, tc)
    noise = torch.randn(latents_shape, generator=gen, device=gen.device)
    drop = None
    if tc.cfg_dropout > 0:
        drop = torch.rand(B, generator=gen, device=gen.device) < tc.cfg_dropout
    return tid, noise, drop


def _carry(tc: TrainConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if tc.carry_dtype == "bfloat16" else None


def _seq_len(cfg: PipelineConfig, latents_shape, sp: Optional[SPConfig],
             seq_len: Optional[int]) -> Optional[int]:
    """The DiT's token count: `seq_len`, else under SP the patch count
    rounded up to a multiple of the SP size, else None (unpadded)."""
    if seq_len is not None or sp is None:
        return seq_len
    _, _, F_, H, W = latents_shape
    pt, ph, pw = cfg.dit.patch_size
    n = sp.sp_size
    return -(-(F_ // pt) * (H // ph) * (W // pw) // n) * n


def _flow_loss(wan: WanDiT, cfg: PipelineConfig, tc: TrainConfig, flow: FlowMatchScheduler,
               latents: torch.Tensor, context: torch.Tensor, tid: torch.Tensor,
               noise: torch.Tensor, sp: Optional[SPConfig] = None,
               seq_len: Optional[int] = None) -> torch.Tensor:
    t = flow.timesteps[tid]
    noisy = flow.add_noise(latents, noise, t)
    target = flow.training_target(latents, noise, t)
    weights = flow.training_weight(t)
    # the unfused chain: its attention is the differentiable flash path
    v = wan(noisy.to(cfg.torch_param_dtype), t, context, qk_impl="unfused", remat=tc.remat,
            carry_dtype=_carry(tc), sp=sp, seq_len=_seq_len(cfg, latents.shape, sp, seq_len))
    per = (v - target).square().mean(dim=(1, 2, 3, 4))
    return (weights * per).mean()


def _flow_table(tc: TrainConfig, device) -> FlowMatchScheduler:
    return FlowMatchScheduler.create(num_inference_steps=tc.num_train_timesteps,
                                     num_train_timesteps=tc.num_train_timesteps,
                                     shift=tc.flow_shift, is_training=True, device=device)


def make_unified_loss(cfg: PipelineConfig, tc: TrainConfig,
                      special_tokens: Optional[Dict[str, torch.Tensor]] = None,
                      sp: Optional[SPConfig] = None, seq_len: Optional[int] = None):
    """loss_fn(params: UnifiedParams, batch, draws) → scalar loss.

    batch: {'latents': [B, C, F, h, w], 'context': [B, Lt, text_dim], 'vlm':
    [B, Lv, vlm_dim] (optional), 'visual_emb': [B, C, F, h, w] (optional),
    'aligned_emb': [B, La, text_dim] (optional)}, on the params' device.
    The loss runs inside `params`' forward (FSDP2's root hooks)."""
    flows: Dict[torch.device, FlowMatchScheduler] = {}

    def loss_fn(params: UnifiedParams, batch: Dict[str, torch.Tensor], draws: Draws):
        return params(body, batch, draws)

    def body(params: UnifiedParams, batch: Dict[str, torch.Tensor], draws: Draws):
        tid, noise, drop = draws
        latents = batch["latents"].float()
        dev = latents.device
        flow = flows.setdefault(dev, _flow_table(tc, dev))
        comp = params.companions
        vlm, visual, aligned = batch.get("vlm"), batch.get("visual_emb"), batch.get("aligned_emb")
        mixed = build_mixed_context_batch(comp, cfg, text_ctx=batch["context"], vlm=vlm,
                                          visual_emb=visual, special_tokens=special_tokens,
                                          aligned_emb=aligned)
        if tc.cfg_dropout > 0:
            vlm_null = None
            if vlm is not None:
                B, _, vd = vlm.shape
                vlm_null = null_ar_vision(vd, device=dev)[None].expand(B, 2, vd)
            mixed_u = build_mixed_context_batch(
                comp, cfg, text_ctx=torch.zeros_like(batch["context"]), vlm=vlm_null,
                visual_emb=visual, special_tokens=special_tokens, aligned_emb=aligned)
            mixed = torch.where(drop.to(dev)[:, None, None], mixed_u, mixed)
        return _flow_loss(params.wan, cfg, tc, flow, latents, mixed, tid.to(dev),
                          noise.to(dev), sp, seq_len)

    return loss_fn


_SUM_AXES = {"ulysses": ("seq",), "ring": ("seq",), "hybrid": ("fsdp", "seq"), "tp": ()}


def reduce_gradients(model: nn.Module, mesh, sp: Optional[SPConfig] = None,
                     summed: Optional[Tuple[str, ...]] = None) -> None:
    """Reduce every parameter's grad in place over the mesh (module
    docstring): a sum over the axes that shard tokens, a mean over 'data'
    and over 'fsdp' where it does not shard tokens; FSDP2 has reduced its
    parameters' grads over 'fsdp' already. Nothing over 'tensor'. `summed`
    names the summed axes in place of `sp`'s (training/sft.py sums over
    'data' too: its loss is already divided by the global target count)."""
    if summed is None:
        summed = _SUM_AXES[sp.mode] if sp is not None else ()
    params = [p for p in model.parameters() if p.grad is not None]
    scale = {id(p): 1 for p in params}
    for axis in ("fsdp", "seq", "data"):  # one axis after the other: same buffers
        n = axis_size(mesh, axis)
        if n == 1:
            continue
        todo = [p for p in params if not (axis == "fsdp" and fsdp_managed(p))]
        works = [dist.all_reduce(_local(p.grad), group=mesh.get_group(axis), async_op=True)
                 for p in todo]
        for w in works:
            w.wait()
        if axis not in summed:
            for p in todo:
                scale[id(p)] *= n
    for p in params:
        if scale[id(p)] > 1:
            _local(p.grad).div_(scale[id(p)])


def _set_fsdp_sum(model: nn.Module, sp: Optional[SPConfig]) -> None:
    """FSDP2 sums over 'fsdp' (divide factor 1) where 'fsdp' shards tokens."""
    if sp is not None and "fsdp" in _SUM_AXES[sp.mode]:
        for m in model.modules():
            if isinstance(m, FSDPModule):
                m.set_gradient_divide_factor(1.0)


def _slice_draws(draws: Draws, rows: Tuple[int, int], n_global: int) -> Draws:
    """This data index's rows of draws made for the global batch."""
    if draws[0].shape[0] != n_global:
        raise ValueError(f"draws for {draws[0].shape[0]} rows, the global batch has {n_global}")
    sl = slice(*rows)
    return tuple(None if d is None else d[sl] for d in draws)


def _make_step(loss_fn, tc: TrainConfig, tx: Optimizer, generator: Optional[torch.Generator],
               mesh=None, sp: Optional[SPConfig] = None):
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dp = axis_size(mesh, "data")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None):
        model = state.params
        _set_fsdp_sum(model, sp)
        dev = next(model.parameters()).device
        batch = {k: v.to(dev) for k, v in batch.items()}
        shape = batch["latents"].shape
        n_global = shape[0] * dp
        if draws is None:  # for the global batch, on every process alike
            draws = sample_draws(gen, (n_global,) + tuple(shape[1:]), tc)
        if dp > 1:
            draws = _slice_draws(draws, batch_slice(mesh, n_global), n_global)
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, draws)
        loss.backward()
        if mesh is not None:
            reduce_gradients(model, mesh, sp)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters() if p.requires_grad}
        gnorm = global_norm(grads.values())
        tx.update(model, grads, state.opt_state)
        model.zero_grad(set_to_none=True)
        state.step += 1
        loss = loss.detach()
        if dp > 1:
            dist.all_reduce(loss, group=mesh.get_group("data"))
            loss = loss / dp
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_unified_train_step(cfg: PipelineConfig, tc: TrainConfig, tx: Optimizer,
                            special_tokens: Optional[Dict[str, torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None, mesh=None,
                            sp: Optional[SPConfig] = None, seq_len: Optional[int] = None):
    """train_step(state, batch, draws=None) → (state, {'loss', 'grad_norm'})
    for the unified model (state.params: UnifiedParams). Without draws they
    come from `generator` (a CPU generator seeded 0 if None), advanced every
    call. On a `mesh` (module docstring) `batch` is this process's rows of
    the global batch and `draws`, when given, are the global batch's; `sp`
    runs the DiT sequence- or tensor-parallel, `seq_len` pads its tokens."""
    return _make_step(make_unified_loss(cfg, tc, special_tokens, sp, seq_len), tc, tx,
                      generator, mesh, sp)


def make_train_step(cfg: PipelineConfig, tc: TrainConfig, tx: Optimizer,
                    generator: Optional[torch.Generator] = None, mesh=None,
                    sp: Optional[SPConfig] = None, seq_len: Optional[int] = None):
    """The plain flow-matching step over the DiT alone (state.params: WanDiT).
    batch: {'latents', 'context' [B, Lc, text_dim], 'uncond_context'
    (optional, swapped in per sample by CFG dropout)}. mesh, sp, seq_len:
    as make_unified_train_step."""
    flows: Dict[torch.device, FlowMatchScheduler] = {}

    def loss_fn(wan: WanDiT, batch, draws: Draws):
        tid, noise, drop = draws
        latents = batch["latents"].float()
        dev = latents.device
        flow = flows.setdefault(dev, _flow_table(tc, dev))
        context = batch["context"]
        if tc.cfg_dropout > 0 and "uncond_context" in batch:
            context = torch.where(drop.to(dev)[:, None, None], batch["uncond_context"], context)
        return _flow_loss(wan, cfg, tc, flow, latents, context, tid.to(dev), noise.to(dev),
                          sp, seq_len)

    return _make_step(loss_fn, tc, tx, generator, mesh, sp)
