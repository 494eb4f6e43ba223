"""The LoRA delta of an adapted Linear (training/lora.py keeps the adapters).

An adapted `nn.Linear` carries the parameters `lora_a` [d_in, r] and
`lora_b` [r, d_out] and the buffer `lora_scale` (0-d f32). The projection
helpers (models/wan_dit.py `dense`, models/qwen3vl/text_model.py `lin`,
parallel/tp.py `tp_dense`) add `lora_delta` to their product.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor


def has_lora(lin: nn.Module) -> bool:
    return "lora_a" in lin._parameters


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def lora_delta(lin: nn.Module, x: torch.Tensor, out_dtype: torch.dtype,
               cast: bool = True) -> torch.Tensor:
    """((x @ A) @ B) · scale in the product's dtype promoted with the f32
    scale, cast to out_dtype. cast: A and B to x's dtype first (JAX
    `_dense`); else x, A and B promote (JAX `_lin`). Sharded adapters are
    used through their local shards (parallel/tp.py)."""
    a, b, s = _local(lin.lora_a), _local(lin.lora_b), lin.lora_scale
    if cast:
        a, b = a.to(x.dtype), b.to(x.dtype)
    else:
        dt = torch.promote_types(x.dtype, a.dtype)
        x, a, b = x.to(dt), a.to(dt), b.to(dt)
    return scaled((x @ a) @ b, s, out_dtype)


def scaled(d: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """d · scale, promoted with the f32 scale as JAX promotes, cast to out_dtype."""
    return (d.to(torch.promote_types(d.dtype, scale.dtype)) * scale).to(out_dtype)
