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
decay lr·wd·p on every leaf) with warmup_cosine_decay_schedule(0, lr,
warmup = min(warmup_steps, total − 1), decay = max(total, warmup + 1))
evaluated at the update count before it increments (so with warmup ≥ 1 the
first update has lr 0); optax.masked freezing (only the trainable leaves
are clipped, moved and carry moments); optax.MultiSteps accumulation (the
running mean of k micro-batch grads applied on every k-th call, zero updates
between; the inner count advances only on apply). grad_norm is the global
norm of ALL grads, as JAX differentiates every param. Parameters and
moments update in place.

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
- grad_norm, clipping and the AdamW update read sharded (DTensor) grads and
  params through their local shards; the norm sums each shard's squares
  over the axes it is sharded on, so it is the global one. The reported
  loss is averaged over 'data'.
Left for later (ROADMAP §1): adafactor and `_lr_scaled_decay`, LoRA, the
streamed trainers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import FSDPModule
from torch.distributed.tensor import DTensor

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
    optimizer: str = "adamw"  # "adafactor" is not ported
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
            ("time_projection/1/", "time_projection/"), ("ffn/0/", "ffn/fc1/"), ("ffn/2/", "ffn/fc2/"))


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
    if path.endswith(("norm_q/weight", "norm_k/weight")):
        path = path[: -len("/weight")]
    elif path.endswith("norm3/weight"):
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
    decay = max(tc.total_steps, warmup + 1) - warmup
    peak = tc.learning_rate

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
        groups = ()
        if isinstance(t, DTensor):
            groups = tuple(t.device_mesh.get_group(i) for i, pl in enumerate(t.placements)
                           if shard_dim(pl) is not None)
        by_groups.setdefault(groups, []).append(_local(t).float().square().sum())
    total = []
    for groups, sq in by_groups.items():
        part = torch.stack(sq).sum()
        for g in groups:
            dist.all_reduce(part, group=g)
        total.append(part)
    return torch.stack(total).sum().sqrt()


class AdamW:
    """The port's `make_optimizer`: clip → adamw, masked to the trainable
    leaves, inside MultiSteps when grad_accum_steps > 1 (see the module
    docstring). `init` builds the state, `update` applies one call's grads
    to the parameters in place."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tc: TrainConfig, trainable: Optional[set] = None):
        if tc.optimizer != "adamw":
            raise NotImplementedError(
                f"optimizer {tc.optimizer!r}: only adamw is ported (adafactor and "
                "_lr_scaled_decay: ROADMAP §1, training follow-ups)")
        self.tc = tc
        self.trainable = trainable
        self.sched = lr_schedule(tc)

    def _leaves(self, model: nn.Module):
        return [(n, p) for n, p in model.named_parameters()
                if self.trainable is None or n in self.trainable]

    def init(self, model: nn.Module) -> Dict[str, Any]:
        leaves = self._leaves(model)
        state = {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in leaves},
                 "nu": {n: torch.zeros_like(p) for n, p in leaves}}
        if self.tc.grad_accum_steps > 1:
            state.update(mini_step=0, acc={n: torch.zeros_like(p) for n, p in leaves})
        return state

    @torch.no_grad()
    def update(self, model: nn.Module, grads: Dict[str, torch.Tensor],
               state: Dict[str, Any]) -> bool:
        """Apply grads (name → tensor, every parameter). Returns whether the
        parameters moved (False between MultiSteps applies)."""
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
                g = {n: (t / norm) * self.tc.grad_clip for n, t in g.items()}
        count = state["count"]
        t = np.float32(count + 1)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        neg_lr = -self.sched(count)
        wd = self.tc.weight_decay
        for n, p in leaves:
            mu, nu, p = _local(state["mu"][n]), _local(state["nu"][n]), _local(p)
            mu.copy_((1 - self.b1) * g[n] + self.b1 * mu)
            nu.copy_((1 - self.b2) * g[n].square() + self.b2 * nu)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps) + wd * p
            p.copy_(p + neg_lr * u)
        state["count"] = count + 1
        if k > 1:
            for acc in state["acc"].values():
                _local(acc).zero_()
        return True


def make_optimizer(tc: TrainConfig, params: Optional[nn.Module] = None) -> AdamW:
    """As JAX's: the freezing mask applies when params are given and
    trainable_filters is non-empty."""
    trainable = None
    if params is not None and tc.trainable_filters:
        trainable = trainable_names(params, tc.trainable_filters)
    return AdamW(tc, trainable)


def init_train_state(params: nn.Module, tx: AdamW) -> TrainState:
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


def reduce_gradients(model: nn.Module, mesh, sp: Optional[SPConfig] = None) -> None:
    """Reduce every parameter's grad in place over the mesh (module
    docstring): a sum over the axes that shard tokens, a mean over 'data'
    and over 'fsdp' where it does not shard tokens; FSDP2 has reduced its
    parameters' grads over 'fsdp' already. Nothing over 'tensor'."""
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


def _make_step(loss_fn, tc: TrainConfig, tx: AdamW, generator: Optional[torch.Generator],
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
                 for n, p in model.named_parameters()}
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


def make_unified_train_step(cfg: PipelineConfig, tc: TrainConfig, tx: AdamW,
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


def make_train_step(cfg: PipelineConfig, tc: TrainConfig, tx: AdamW,
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
