"""Vision-head / adapter alignment training (port of
omnivideo_tpu/training/align.py).

The VisionHead + DM_Adapter chain (models/adapters.py) learns to map VLM
hidden states onto the diffusion model's conditioning embeddings; the VLM
and the DiT stay frozen. Loss: MSE of the chain's output against the
target, plus an optional (1 − cosine) term per token. The step runs the
port's AdamW (training/trainer.py `Optimizer`, optax's arithmetic) on the
chain's parameters in place.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..models.adapters import QueryTransformer
from .trainer import Optimizer, TrainState, global_norm


class AlignChain(nn.Module):
    """JAX's {'vision_head', 'adapter'} tree."""

    def __init__(self, vision_head: QueryTransformer, adapter: QueryTransformer):
        super().__init__()
        self.vision_head = vision_head
        self.adapter = adapter

    def forward(self, vlm: torch.Tensor) -> torch.Tensor:
        return self.adapter(self.vision_head(vlm))


def alignment_loss(chain: AlignChain, batch: Dict[str, torch.Tensor],
                   cosine_weight: float = 0.0) -> torch.Tensor:
    """batch: {'vlm': [B, L, vlm_dim], 'target': [B, Q, out_dim]}: mean
    squared error of the chain's [B, Q, out_dim] against the target, plus
    cosine_weight · mean(1 − cos) over tokens."""
    out = chain(batch["vlm"])
    tgt = batch["target"].to(out.device)
    mse = (out - tgt).square().mean()
    if cosine_weight > 0:
        num = (out * tgt).sum(-1)
        den = torch.linalg.vector_norm(out, dim=-1) * torch.linalg.vector_norm(tgt, dim=-1) + 1e-6
        mse = mse + cosine_weight * (1.0 - num / den).mean()
    return mse


def make_align_step(tx: Optimizer, cosine_weight: float = 0.0):
    """step(state, batch) → (state, {'loss', 'grad_norm'}): one update of
    the chain (state.params) in place."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        chain = state.params
        chain.zero_grad(set_to_none=True)
        loss = alignment_loss(chain, batch, cosine_weight)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in chain.named_parameters() if p.requires_grad}
        gnorm = global_norm(grads.values())
        tx.update(chain, grads, state.opt_state)
        chain.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def init_align_state(chain: AlignChain, tx: Optimizer) -> TrainState:
    return TrainState(params=chain, opt_state=tx.init(chain), step=0)
