"""Weight-only int8 for streamed block parameters (port of
omnivideo_tpu/ops/quant.py).

A streamed block (pipelines/streaming.py) crosses the host link every
forward; storing its large matmul weights as int8 halves those bytes. The
scheme is JAX's: symmetric int8 per output channel on the 2-D bf16/f16
weights of at least `min_size` elements, everything else (biases, norm
gains, the f32 modulation tables) passed through. The port's `nn.Linear`
weight is [out, in] where JAX's kernel is [in, out], so JAX's "per output
column" is a row here: scale_j = max_i |W_ji| / 127 (1/127 for an all-zero
row), q_ji = clip(round(W_ji / scale_j), ±127). Dequantising (`q.float() *
scale`, cast to the source dtype) is a plain PyTorch pass before the
block's matmuls, which still run in bf16.

A quantised weight is a `Q8` (int8 payload, f32 scales, the source dtype
as a plain attribute in place of JAX's zero-size "dt" marker). A block is a
flat {name: tensor or Q8} dict; the same functions run on host and device
tensors, so the device-side quantiser of the streamed trainer's gradients
(JAX `quantize_block_jnp`) and the host-side dequantiser of its update
(JAX `dequantize_block_np`) are `quantize_block` and `dequantize_block` on
those devices.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch

QUANT_DTYPES = (torch.bfloat16, torch.float16)
MIN_SIZE = 4096


class Q8(NamedTuple):
    q8: torch.Tensor  # int8, the weight's shape
    scale: torch.Tensor  # f32 [out]
    dtype: torch.dtype  # the source dtype


Leaf = Union[torch.Tensor, Q8]


def quantize_leaf(w: torch.Tensor) -> Q8:
    """Symmetric per-output-channel int8 of a 2-D [out, in] weight."""
    a = w.float()
    amax = a.abs().amax(dim=1)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, one ulp off the host's (and JAX's numpy) true division
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(a / scale[:, None]), -127, 127).to(torch.int8)
    return Q8(q, scale, w.dtype)


def eligible(w: torch.Tensor, min_size: int = MIN_SIZE) -> bool:
    return w.ndim == 2 and w.numel() >= min_size and w.dtype in QUANT_DTYPES


def quantize_block(block: Dict[str, Leaf], min_size: int = MIN_SIZE) -> Dict[str, Leaf]:
    """Every eligible weight of a block as a Q8; the rest passed through."""
    return {n: quantize_leaf(w) if isinstance(w, torch.Tensor) and eligible(w, min_size) else w
            for n, w in block.items()}


def dequantize_leaf(leaf: Q8) -> torch.Tensor:
    return (leaf.q8.float() * leaf.scale[:, None]).to(leaf.dtype)


def dequantize_block(block: Dict[str, Leaf]) -> Dict[str, torch.Tensor]:
    """Q8 leaves back to dense weights in their source dtype."""
    return {n: dequantize_leaf(w) if isinstance(w, Q8) else w for n, w in block.items()}
