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
torch.Generator when they are absent. Left for later (ROADMAP §1): adafactor
and `_lr_scaled_decay`, LoRA, the streamed trainers, the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import PipelineConfig
from ..device import resolve_device
from ..models.unified import (
    Companions,
    build_mixed_context_batch,
    init_unified_companions,
    null_ar_vision,
)
from ..models.wan_dit import WanDiT
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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) in f32 (optax.global_norm)."""
    sq = [t.float().square().sum() for t in tensors if t is not None]
    return torch.stack(sq).sum().sqrt()


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
        g = {n: grads[n] for n, _ in leaves}
        k = self.tc.grad_accum_steps
        if k > 1:  # running mean acc + (g − acc)/(n + 1), applied on the k-th call
            n_acc = state["mini_step"]
            for n, _ in leaves:
                acc = state["acc"][n]
                acc.copy_(acc + (g[n] - acc) / (n_acc + 1))
            if n_acc < k - 1:
                state["mini_step"] = n_acc + 1
                return False
            g = dict(state["acc"])
            state["mini_step"] = 0
        if self.tc.grad_clip:
            norm = global_norm(g.values())
            if float(norm) >= self.tc.grad_clip:
                g = {n: (t / norm) * self.tc.grad_clip for n, t in g.items()}
        count = state["count"]
        t = np.float32(count + 1)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        neg_lr = -self.sched(count)
        wd = self.tc.weight_decay
        for n, p in leaves:
            mu, nu = state["mu"][n], state["nu"][n]
            mu.copy_((1 - self.b1) * g[n] + self.b1 * mu)
            nu.copy_((1 - self.b2) * g[n].square() + self.b2 * nu)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps) + wd * p
            p.copy_(p + neg_lr * u)
        state["count"] = count + 1
        if k > 1:
            for acc in state["acc"].values():
                acc.zero_()
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


def _flow_loss(wan: WanDiT, cfg: PipelineConfig, tc: TrainConfig, flow: FlowMatchScheduler,
               latents: torch.Tensor, context: torch.Tensor, tid: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    t = flow.timesteps[tid]
    noisy = flow.add_noise(latents, noise, t)
    target = flow.training_target(latents, noise, t)
    weights = flow.training_weight(t)
    # the unfused chain: its attention is the differentiable flash path
    v = wan(noisy.to(cfg.torch_param_dtype), t, context, qk_impl="unfused", remat=tc.remat,
            carry_dtype=_carry(tc))
    per = (v - target).square().mean(dim=(1, 2, 3, 4))
    return (weights * per).mean()


def _flow_table(tc: TrainConfig, device) -> FlowMatchScheduler:
    return FlowMatchScheduler.create(num_inference_steps=tc.num_train_timesteps,
                                     num_train_timesteps=tc.num_train_timesteps,
                                     shift=tc.flow_shift, is_training=True, device=device)


def make_unified_loss(cfg: PipelineConfig, tc: TrainConfig,
                      special_tokens: Optional[Dict[str, torch.Tensor]] = None):
    """loss_fn(params: UnifiedParams, batch, draws) → scalar loss.

    batch: {'latents': [B, C, F, h, w], 'context': [B, Lt, text_dim], 'vlm':
    [B, Lv, vlm_dim] (optional), 'visual_emb': [B, C, F, h, w] (optional),
    'aligned_emb': [B, La, text_dim] (optional)}, on the params' device."""
    flows: Dict[torch.device, FlowMatchScheduler] = {}

    def loss_fn(params: UnifiedParams, batch: Dict[str, torch.Tensor], draws: Draws):
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
                          noise.to(dev))

    return loss_fn


def _make_step(loss_fn, tc: TrainConfig, tx: AdamW, generator: Optional[torch.Generator]):
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None):
        model = state.params
        dev = next(model.parameters()).device
        batch = {k: v.to(dev) for k, v in batch.items()}
        if draws is None:
            draws = sample_draws(gen, batch["latents"].shape, tc)
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, draws)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters()}
        gnorm = global_norm(grads.values())
        tx.update(model, grads, state.opt_state)
        model.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_unified_train_step(cfg: PipelineConfig, tc: TrainConfig, tx: AdamW,
                            special_tokens: Optional[Dict[str, torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None):
    """train_step(state, batch, draws=None) → (state, {'loss', 'grad_norm'})
    for the unified model (state.params: UnifiedParams). Without draws they
    come from `generator` (a CPU generator seeded 0 if None), advanced every
    call."""
    return _make_step(make_unified_loss(cfg, tc, special_tokens), tc, tx, generator)


def make_train_step(cfg: PipelineConfig, tc: TrainConfig, tx: AdamW,
                    generator: Optional[torch.Generator] = None):
    """The plain flow-matching step over the DiT alone (state.params: WanDiT).
    batch: {'latents', 'context' [B, Lc, text_dim], 'uncond_context'
    (optional, swapped in per sample by CFG dropout)}."""
    flows: Dict[torch.device, FlowMatchScheduler] = {}

    def loss_fn(wan: WanDiT, batch, draws: Draws):
        tid, noise, drop = draws
        latents = batch["latents"].float()
        dev = latents.device
        flow = flows.setdefault(dev, _flow_table(tc, dev))
        context = batch["context"]
        if tc.cfg_dropout > 0 and "uncond_context" in batch:
            context = torch.where(drop.to(dev)[:, None, None], batch["uncond_context"], context)
        return _flow_loss(wan, cfg, tc, flow, latents, context, tid.to(dev), noise.to(dev))

    return _make_step(loss_fn, tc, tx, generator)
