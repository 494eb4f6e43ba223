"""Inference flash attention with the bounded softmax.

Port of the inference forward of omnivideo_tpu/ops/pallas/flash_attention.py
(`flash_attention_infer` → `_flash_fwd_unpadded` → `_fa_kernel`). Logits
live in the exp2 domain with scale·log2(e) folded into q (rounded to the k
dtype). With `assume_normalized` (qk-normed q/k, as in the Wan DiT) the
softmax is bounded: each (b, h) subtracts ⌈max|q|·max|k|·scale·log2e⌉
instead of a running max, but only when 2·max(bound)+2 < 120, so exp2 can
never underflow a whole row; otherwise the max-tracked form runs. The bound
and that guard are computed on the device and handed to the kernel as
tensors: choosing the mode needs no host sync. `causal=True` is token
causality (col ≤ row), the Qwen3 text prefill.

`flash_attention` launches the CUDA kernel `csrc/flash_fwd.cu` for CUDA
tensors and takes `flash_attention_plain` only for CPU tensors. The kernel
has three instantiations, each with its own launch count in
`flash_attention.launches`: "flash_fwd" (head dim 128, the Wan DiT),
"flash_causal" (head dim 128, causal, the Qwen3 prefill) and "flash_d72"
(head dim 72, the Qwen3-VL vision tower). Any other head dim or mode raises
on CUDA. Bound and design: see the kernel source.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels

LOG2E = 1.4426950408889634
NEG_INF = -1e30
GUARD = 120.0  # largest safe 2·bound+2, in log2 units (f32 exp2 flushes below −126)
# (head dim, causal) → the kernel instantiation that serves it
KERNELS = {(128, False): "flash_fwd", (128, True): "flash_causal", (72, False): "flash_d72"}
PLAIN_LOGITS_BUDGET = 1 << 28  # f32 logits per q chunk of the plain version


def _qscale(scale: float) -> float:
    return float(np.float32(scale * LOG2E))


def softmax_bound(
    q: torch.Tensor,
    k: torch.Tensor,
    scale: float,
    qk_row_norms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mb [B, N] int32, safe [1] int32), both on the inputs' device.

    mb is the per-(b, h) Cauchy–Schwarz bound on the log2-domain logits;
    safe says whether the bounded softmax may run. qk_row_norms = (qn, kn)
    [B, N] f32 upper bounds from qk_prep skip the two reductions."""
    if qk_row_norms is not None:
        qn, kn = qk_row_norms
    else:
        qn = q.float().square().sum(-1).amax(dim=1).sqrt()
        kn = k.float().square().sum(-1).amax(dim=1).sqrt()
    bound_f = qn * kn * _qscale(scale)
    mb = torch.ceil(bound_f).to(torch.int32)
    safe = (2.0 * bound_f.amax() + 2.0 < GUARD).to(torch.int32).reshape(1)
    return mb, safe


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    mb: Optional[torch.Tensor] = None,
    safe: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math, chunked over q rows so the
    f32 logits stay within PLAIN_LOGITS_BUDGET elements (full [B, N, L, L]
    logits at L = 32,760 would be ~103 GB). Bounded when `safe` is set;
    `causal` masks col > row."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    c = _qscale(softmax_scale if softmax_scale is not None else D**-0.5)
    bounded = safe is not None and bool(safe.reshape(()).item())
    kf = k.float()
    cols = torch.arange(Lk, device=k.device)
    live = None
    if kv_lens is not None:
        live = cols[None, :] < kv_lens.to(k.device)[:, None]
        v = torch.where(live[:, :, None, None], v, torch.zeros_like(v))
    vf = v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    chunk = max(1, PLAIN_LOGITS_BUDGET // max(1, B * N * Lk))
    for i0 in range(0, Lq, chunk):
        qs = (q[:, i0:i0 + chunk].float() * c).to(k.dtype).float()
        s = torch.einsum("bind,bjnd->bnij", qs, kf)
        if live is not None:
            s = s.masked_fill(~live[:, None, None, :], NEG_INF)
        if causal:
            rows = torch.arange(i0, i0 + qs.shape[1], device=k.device)
            s = s.masked_fill(cols[None, :] > rows[:, None], NEG_INF)
        if bounded:
            p = torch.exp2(s - mb.float()[:, :, None, None])
        else:
            p = torch.exp2(s - s.amax(-1, keepdim=True))
        l = p.sum(-1)
        o = torch.einsum("bnij,bjnd->bind", p.to(v.dtype).float(), vf)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, i0:i0 + chunk] = (o / l.permute(0, 2, 1)[..., None]).to(q.dtype)
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    assume_normalized: bool = False,
    qk_row_norms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    causal: bool = False,
) -> torch.Tensor:
    """q: [B, Lq, N, D]; k/v: [B, Lk, N, D]; kv_lens: [B] int or None.
    Returns [B, Lq, N, D] in q.dtype. The CUDA kernel takes packed
    contiguous q/k/v."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    mb = safe = None
    if assume_normalized:
        mb, safe = softmax_bound(q, k, scale, qk_row_norms)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens, scale, mb, safe, causal)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    name = KERNELS.get((D, causal))
    if name is None:
        raise ValueError(f"no flash kernel for head_dim {D} with causal={causal} "
                         f"(kernels: {sorted(KERNELS)})")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash kernel takes bf16 q/k/v")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes packed contiguous [B, L, N, D] q/k/v")
    if k.shape != (B, Lk, N, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    out = torch.empty_like(q)
    if Lq == 0:
        return out
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    code = _kernels.library().flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr() if lens is not None else None,
        mb.data_ptr() if mb is not None else None,
        safe.data_ptr() if safe is not None else None,
        B, Lq, Lk, N, D, int(causal), _qscale(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(code, f"flash_attention ({name})")
    flash_attention.launches[name] += 1
    return out


flash_attention.launches = {name: 0 for name in KERNELS.values()}
