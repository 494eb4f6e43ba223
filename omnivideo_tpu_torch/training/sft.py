"""Supervised fine-tuning (SFT) of the AR/VLM stage's language model (port
of omnivideo_tpu/training/sft.py).

The loss is next-token cross-entropy over the Qwen3 text model
(models/qwen3vl/text_model.py `qwen3_forward_trainable`, or
`qwen3_forward_sp_trainable` over the mesh's 'seq' axis), labels in the HF convention (−100 positions are
masked out: prompt tokens, padding). The combined mode adds
`training/align.py::alignment_loss` on the VisionHead + DM_Adapter chain,
weighted by `align_weight`, so the LM and the chain train in one step.

The optimizer is JAX's `make_sft_optimizer`: clip_by_global_norm
(max_grad_norm) then adamw(weight_decay) on the port's `Optimizer`
(training/trainer.py), with optax.warmup_cosine_decay_schedule(0, lr,
warmup, max(total, warmup + 1)) evaluated at the count before it
increments and the warmup NOT clamped (the DiT trainer clamps it): with a
warmup of 1 or more the first update has lr 0 and leaves the parameters
where they were.

Under autograd `qwen3_forward_trainable` takes JAX's dense causal path
(row 2, the causal flash kernel, is forward-only, in JAX as here);
`sft_collate` always passes an `attn_mask`, which takes that path in JAX
too. Under `--sp` the forward is `qwen3_forward_sp_trainable`: the
trainable token-causal ring (for the f32 LM the f32 step kernel forward,
as JAX's ring keeps f32; rows 4 and 5 on f32 operands on the earlier
shards backward), no mask, so padding sits at the tail, where it is masked
out of the loss and cannot reach earlier positions.

On a mesh (parallel/mesh.py) every process passes the same global batch;
the step takes its data index's rows (`batch_slice`). The loss is divided
by the target count of the GLOBAL batch (all-reduced over 'data'), where
averaging per-rank means would weigh a rank by its rows rather than by its
targets; so the LM gradients are summed over 'data', and over 'seq' (each
rank's tokens' share). The alignment loss is a mean over rows that every
'seq' rank computes alike, so its term enters the backward divided by the
data and seq sizes, and the same sums make it the global mean. FSDP2
(parallel/sharding.py) averages over 'fsdp', whose ranks hold the same
rows; the LM and the chain stay whole over 'tensor', as JAX's TP rule
splits only the DiT's blocks. The reported numbers are the global batch's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.qwen3vl.text_model import qwen3_forward_sp_trainable, qwen3_forward_trainable
from ..parallel.mesh import axis_size, batch_slice
from .align import AlignChain, alignment_loss
from .trainer import (
    Optimizer,
    TrainConfig,
    TrainState,
    global_norm,
    reduce_gradients,
    warmup_cosine_schedule,
)

IGNORE_INDEX = -100  # the HF masking convention

SFTState = TrainState  # params: SFTParams, updated in place; opt_state; step


@dataclasses.dataclass(frozen=True)
class SFTConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    align_weight: float = 0.0  # > 0: add the vision-head/adapter alignment loss
    cosine_weight: float = 0.0  # the cosine term inside the alignment loss


class SFTParams(nn.Module):
    """JAX's SFT tree {'lm'[, 'chain']}: a text_model.Qwen3LM and an optional
    align.AlignChain. The loss runs inside `forward`, so FSDP2's root hooks
    gather the root's parameters."""

    def __init__(self, lm: nn.Module, chain: Optional[AlignChain] = None):
        super().__init__()
        self.lm = lm
        self.chain = chain

    def forward(self, fn: Callable, *args, **kwargs):
        return fn(self, *args, **kwargs)


def sft_schedule(tc: SFTConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1)),
    the warmup as given."""
    return warmup_cosine_schedule(tc.learning_rate, tc.warmup_steps,
                                  max(tc.total_steps, tc.warmup_steps + 1))


def make_sft_optimizer(tc: SFTConfig) -> Optimizer:
    """clip_by_global_norm(max_grad_norm) → adamw(sft_schedule, weight_decay)
    over every parameter that requires grad."""
    inner = TrainConfig(learning_rate=tc.learning_rate, weight_decay=tc.weight_decay,
                        grad_clip=tc.max_grad_norm, warmup_steps=tc.warmup_steps,
                        total_steps=tc.total_steps, optimizer="adamw")
    return Optimizer(inner, sched=sft_schedule(tc))


def lm_loss(lm: nn.Module, ids: torch.Tensor, labels: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None, sp_mesh=None, seq_axis: str = "seq",
            data_group=None):
    """Next-token cross-entropy with −100 masking → (masked sum over the
    targets / max(targets, 1), targets). ids/labels [B, L]; logits[t]
    predicts labels[t + 1]. sp_mesh: the forward sequence-parallel over
    `seq_axis` (the shift is taken on the gathered logits, so the loss is
    the single-process one). data_group: the targets are counted over this
    group's ranks too (the global batch's count)."""
    if sp_mesh is not None:
        _, logits = qwen3_forward_sp_trainable(lm, ids, sp_mesh, seq_axis)
    else:
        _, logits = qwen3_forward_trainable(lm, ids, attn_mask)
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].to(logits.device).long()
    mask = (targets != IGNORE_INDEX).float()
    nll = -torch.log_softmax(logits, -1).gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    n = mask.sum().detach()
    if data_group is not None:
        dist.all_reduce(n, group=data_group)
    n = n.clamp_min(1.0)
    return (nll * mask).sum() / n, n


def make_sft_step(tc: SFTConfig, tx: Optimizer, sp_mesh=None, mesh=None):
    """step(state, batch) → (state, metrics) for state.params an SFTParams.

    batch: {'ids', 'labels'} [B, L] (+ 'attn_mask'; + 'vlm' [B, Lv, D] and
    'target' [B, Q, d] when align_weight > 0), the global batch on every
    process. sp_mesh: the LM forward sequence-parallel over its 'seq' axis
    (and the mesh of the step). mesh: the (data, fsdp, seq, tensor) mesh
    (module docstring). metrics: 'loss', 'lm_loss', 'num_targets',
    'grad_norm' (+ 'align_loss'), the global batch's."""
    mesh = mesh if mesh is not None else sp_mesh
    dp, ns = axis_size(mesh, "data"), axis_size(mesh, "seq")
    data_group = mesh.get_group("data") if dp > 1 else None

    def body(params: SFTParams, batch: Dict[str, torch.Tensor]):
        lm_part, n = lm_loss(params.lm, batch["ids"], batch["labels"], batch.get("attn_mask"),
                             sp_mesh=sp_mesh, data_group=data_group)
        loss = lm_part
        parts = {"lm_loss": lm_part.detach(), "num_targets": n}
        if tc.align_weight > 0.0:
            al = alignment_loss(params.chain, {"vlm": batch["vlm"], "target": batch["target"]},
                                tc.cosine_weight)
            parts["align_loss"] = al.detach() / dp
            loss = loss + tc.align_weight * al / (dp * ns)
        return loss, parts

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.params
        dev = next(model.parameters()).device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if dp > 1:
            sl = slice(*batch_slice(mesh, batch["ids"].shape[0]))
            batch = {k: v[sl] for k, v in batch.items()}
        model.zero_grad(set_to_none=True)
        loss, parts = model(body, batch)
        loss.backward()
        if mesh is not None:
            reduce_gradients(model, mesh, summed=("seq", "data"))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters() if p.requires_grad}
        gnorm = global_norm(grads.values())
        tx.update(model, grads, state.opt_state)
        model.zero_grad(set_to_none=True)
        state.step += 1
        for k in ("lm_loss", "align_loss"):
            if k in parts and data_group is not None:
                dist.all_reduce(parts[k], group=data_group)
        total = parts["lm_loss"]
        if "align_loss" in parts:
            total = total + tc.align_weight * parts["align_loss"]
        return state, {"loss": total, "grad_norm": gnorm, **parts}

    return step


def init_sft_state(params: SFTParams, tx: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def build_sft_labels(ids: torch.Tensor, prompt_lens: torch.Tensor,
                     pad_id: Optional[int] = None) -> torch.Tensor:
    """Prompt positions (and, with pad_id, padding) masked to IGNORE_INDEX."""
    L = ids.shape[1]
    pos = torch.arange(L, device=ids.device)[None]
    labels = torch.where(pos < torch.as_tensor(prompt_lens, device=ids.device)[:, None],
                         torch.full_like(ids, IGNORE_INDEX), ids)
    if pad_id is not None:
        labels = torch.where(ids == pad_id, torch.full_like(ids, IGNORE_INDEX), labels)
    return labels


class SFTDataset:
    """A directory of per-sample .npz (or torch .pt/.pkl) files with `ids`
    and either `labels` or `prompt_len` [+ `vlm`, `target` for alignment]:
    the offline-tokenized form (tools/data_prepare/sft_tokenize.py writes
    it)."""

    def __init__(self, root: str):
        self.files = sorted(p for p in Path(root).iterdir()
                            if p.suffix in (".npz", ".pkl", ".pt"))
        if not self.files:
            raise FileNotFoundError(f"no samples under {root}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        p = self.files[i]
        if p.suffix == ".npz":
            return dict(np.load(p, allow_pickle=True))
        obj = torch.load(p, map_location="cpu", weights_only=False)
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in obj.items()}


def sft_collate(samples, seq_len: int, pad_id: int = 0) -> Dict[str, torch.Tensor]:
    """Pad ids to seq_len (int32). Labels come per sample (the conversation
    path's per-turn masks) or from a `prompt_len` prefix; padding is always
    masked, and `attn_mask` marks the real tokens."""
    B = len(samples)
    ids = np.full((B, seq_len), pad_id, np.int32)
    labels = np.full((B, seq_len), IGNORE_INDEX, np.int32)
    real_len = np.zeros((B,), np.int32)
    for i, s in enumerate(samples):
        a = np.asarray(s["ids"], np.int32).reshape(-1)[:seq_len]
        ids[i, :len(a)] = a
        real_len[i] = len(a)
        if "labels" in s:
            lab = np.asarray(s["labels"], np.int32).reshape(-1)[:seq_len]
            labels[i, :len(lab)] = lab
        else:
            plen = int(np.asarray(s["prompt_len"]).reshape(-1)[0])
            lab = a.copy()
            lab[:plen] = IGNORE_INDEX
            labels[i, :len(a)] = lab
    batch = {"ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels),
             "attn_mask": torch.from_numpy(
                 (np.arange(seq_len)[None] < real_len[:, None]).astype(np.int32))}
    if all("vlm" in s for s in samples):
        batch["vlm"] = torch.from_numpy(np.stack([np.asarray(s["vlm"], np.float32)
                                                  for s in samples]))
        batch["target"] = torch.from_numpy(np.stack([np.asarray(s["target"], np.float32)
                                                     for s in samples]))
    return batch


def sft_data_loader(ds, batch_size: int, seq_len: int, seed: int = 0, pad_id: int = 0,
                    group_by_length: bool = False, group_by_modality: bool = False,
                    world_size: int = 1):
    """Infinite batch iterator: a seeded numpy shuffle per pass, or the
    length-grouped order when the dataset exposes `lengths` /
    `modality_lengths` (training/conversation.py). The orders equal JAX's."""
    if group_by_length or group_by_modality:
        from .conversation import length_grouped_batches

        lengths = ds.modality_lengths if group_by_modality else ds.lengths
        for idx in length_grouped_batches(lengths, batch_size, world_size=world_size, seed=seed,
                                          by_modality=group_by_modality):
            yield sft_collate([ds[j] for j in idx], seq_len, pad_id)
        return
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ds))
    i = 0
    while True:
        if i + batch_size > len(order):
            order = rng.permutation(len(ds))
            i = 0
        yield sft_collate([ds[j] for j in order[i:i + batch_size]], seq_len, pad_id)
        i += batch_size


class MixtureDataset:
    """Weighted blend of SFT data sources: weight w > 1 repeats a source ~w
    times per pass, w < 1 takes a seeded w-fraction of it (numpy's RNG, as
    JAX). Exposes `lengths` / `modality_lengths` when every source does."""

    def __init__(self, sources, weights=None, seed: int = 0):
        if not sources:
            raise ValueError("empty mixture")
        weights = list(weights) if weights is not None else [1.0] * len(sources)
        if len(weights) != len(sources):
            raise ValueError(f"{len(weights)} weights for {len(sources)} sources")
        rng = np.random.default_rng(seed)
        self.sources = list(sources)
        self.index = []  # (source, sample)
        for si, (src, w) in enumerate(zip(self.sources, weights)):
            n = len(src)
            reps = int(w)
            frac = w - reps
            for _ in range(reps):
                self.index.extend((si, j) for j in range(n))
            if frac > 0:
                take = rng.choice(n, size=max(1, round(frac * n)), replace=False)
                self.index.extend((si, int(j)) for j in sorted(take))
        if not self.index:
            raise ValueError("mixture resolved to zero samples")

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i):
        si, j = self.index[i]
        return self.sources[si][j]

    def _gather(self, attr):
        per_src = [getattr(s, attr) for s in self.sources]
        return [per_src[si][j] for si, j in self.index]

    @property
    def lengths(self):
        return self._gather("lengths")

    @property
    def modality_lengths(self):
        return self._gather("modality_lengths")
