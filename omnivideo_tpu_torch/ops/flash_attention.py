"""Flash attention: the inference forward with the bounded softmax, and the
training forward and backward.

Port of omnivideo_tpu/ops/pallas/flash_attention.py. Inference
(`flash_attention_infer` → `_flash_fwd_unpadded` → `_fa_kernel`): logits
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
is the Hopper forward mainloop (`csrc/flash_fwd_hopper.cuh`) with one
epilogue policy per instantiation, each with its own launch count in
`flash_attention.launches`: "flash_fwd" (head dim 128, the Wan DiT),
"flash_causal" (head dim 128, causal, the Qwen3 prefill) and "flash_d72"
(head dim 72, the Qwen3-VL vision tower). Any other head dim or mode raises
on CUDA. Bound and design: see the kernel source. The CUDA kernel's output
has no autograd history, so on CUDA it raises when grad mode is on and an
input requires grad.

Training (the custom VJP `flash_attention` → `_fa_fwd` / `_fa_bwd`):
`flash_attention_train` is a torch.autograd.Function. Its forward runs the
max-tracked softmax and keeps the natural-log row logsumexp LSE [B, N, Lq]
f32 (`flash_fwd_lse`: kernel "flash_fwd_lse", row 3b of the port's table);
its backward takes delta = rowsum(dO·O) in f32 and recomputes p = exp(s −
LSE) from the unscaled q in two kernels (`flash_bwd`: "flash_bwd_dq" walks
KV for dq, "flash_bwd_dkv" walks q for dk and dv; rows 4 and 5), in
`csrc/flash_fwd.cu` and `csrc/flash_train.cu`. On CUDA q/k/v (and dO) enter
the kernels in bf16; o and the gradients come back in the caller's dtype,
accumulated in f32. On the CPU the plain twins `flash_fwd_lse_plain` and
`flash_bwd_plain` compute in the input dtype. Launch counts per kernel are in
`flash_attention_train.launches`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _kernels

LOG2E = 1.4426950408889634
NEG_INF = -1e30
LN2 = float(np.float32(1.0 / LOG2E))  # m (log2 units) → natural log, as JAX's f32 product
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
    _kernels.check_no_grad("flash_attention", q, k, v)
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
    lens = _lens_i32(kv_lens, q.device)
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


# ---------------------------------------------------------------------------
# training: forward with LSE, backward (dq; dk, dv)
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")


def _plain_chunk(B: int, N: int, Lk: int) -> int:
    return max(1, PLAIN_LOGITS_BUDGET // max(1, B * N * Lk))


def _live_cols(kv_lens: Optional[torch.Tensor], Lk: int, device) -> Optional[torch.Tensor]:
    """[B, 1, 1, Lk] bool mask of the keys each batch row sees, or None."""
    if kv_lens is None:
        return None
    cols = torch.arange(Lk, device=device)
    return (cols[None, :] < kv_lens.to(device)[:, None])[:, None, None, :]


def flash_fwd_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: (o [B, Lq, N, D] in q.dtype,
    LSE [B, N, Lq] f32). Max-tracked softmax in the exp2 domain with q·scale·
    log2e rounded to the k dtype; a row with no live key has o = 0 and LSE =
    −1e30·ln2 + ln(1e-30). Chunked over q rows like flash_attention_plain."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    c = _qscale(softmax_scale if softmax_scale is not None else D**-0.5)
    live = _live_cols(kv_lens, Lk, k.device)
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, N, Lq, dtype=torch.float32, device=q.device)
    chunk = _plain_chunk(B, N, Lk)
    for i0 in range(0, Lq, chunk):
        qs = (q[:, i0:i0 + chunk].float() * c).to(k.dtype).float()
        s = torch.einsum("bind,bjnd->bnij", qs, kf)
        if live is not None:
            s = s.masked_fill(~live, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        if live is not None:  # a row with no live key keeps l = 0
            p = p.masked_fill(~live, 0.0)
        l = p.sum(-1)
        o = torch.einsum("bnij,bjnd->bind", p.to(v.dtype).float(), vf)
        denom = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, i0:i0 + chunk] = (o / denom.permute(0, 2, 1)[..., None]).to(q.dtype)
        lse[:, :, i0:i0 + chunk] = m[..., 0] * LN2 + torch.log(l.clamp_min(1e-30))
    return out, lse


def flash_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO·O) in f32, [B, N, Lq] (`_fa_bwd`)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels: (dq, dk, dv) f32.
    s = (q·kᵀ)·scale from the unscaled q, p = exp(s − LSE), dp = dO·vᵀ,
    ds = p·(dp − delta)·scale; p is rounded to the dO dtype and ds to the q
    dtype before their products. Chunked over q rows."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    live = _live_cols(kv_lens, Lk, k.device)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    chunk = _plain_chunk(B, N, Lk)
    for i0 in range(0, Lq, chunk):
        sl = slice(i0, i0 + chunk)
        s = torch.einsum("bind,bjnd->bnij", qf[:, sl], kf) * scale
        p = torch.exp(s - lse[:, :, sl, None])
        if live is not None:
            p = p.masked_fill(~live, 0.0)
        dv += torch.einsum("bnij,bind->bjnd", p.to(do.dtype).float(), dof[:, sl])
        dp = torch.einsum("bind,bjnd->bnij", dof[:, sl], vf)
        ds = (p * (dp - delta[:, :, sl, None]) * scale).to(q.dtype).float()
        dq[:, sl] = torch.einsum("bnij,bjnd->bind", ds, kf)
        dk += torch.einsum("bnij,bind->bjnd", ds, qf[:, sl])
    return dq, dk, dv


def _check_train_operands(what: str, *tensors: torch.Tensor) -> None:
    D = tensors[0].shape[-1]
    if D != 128:
        raise ValueError(f"{what}: no kernel for head_dim {D} (the training kernels take 128)")
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the kernels take packed contiguous bf16 [B, L, N, D] operands")


def _lens_i32(kv_lens: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if kv_lens is None:
        return None
    return kv_lens.to(device=device, dtype=torch.int32).contiguous()


def flash_fwd_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward (row 3b): (o in q.dtype, LSE [B, N, Lq] f32). The
    CUDA kernel takes packed bf16 q/k/v at head dim 128."""
    B, Lq, N, D = q.shape
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, kv_lens, scale)
    if not q.is_cuda:
        raise ValueError(f"flash_fwd_lse: unsupported device {q.device}")
    _check_train_operands("flash_fwd_lse", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(B, N, Lq, dtype=torch.float32, device=q.device)
    if Lq == 0:
        return o, lse
    lens = _lens_i32(kv_lens, q.device)
    code = _kernels.library().flash_fwd_lse_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        lens.data_ptr() if lens is not None else None, B, Lq, k.shape[1], N, D,
        _qscale(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(code, "flash_fwd_lse")
    flash_attention_train.launches["flash_fwd_lse"] += 1
    return o, lse


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training backward (rows 4 and 5): (dq, dk, dv) f32 from the forward's
    LSE and delta = flash_delta(dO, o), both [B, N, Lq] f32."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, kv_lens, scale)
    if not q.is_cuda:
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    _check_train_operands("flash_bwd", q, k, v, do)
    if lse.shape != (B, N, Lq) or delta.shape != (B, N, Lq):
        raise ValueError(f"lse {tuple(lse.shape)} / delta {tuple(delta.shape)} != {(B, N, Lq)}")
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    if Lq == 0 or Lk == 0:
        return dq, dk.zero_(), dv.zero_()
    lens = _lens_i32(kv_lens, q.device)
    lens_ptr = lens.data_ptr() if lens is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _kernels.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    code = lib.flash_bwd_dq_launch(*ptrs, dq.data_ptr(), lens_ptr, B, Lq, Lk, N, D,
                                   float(scale), stream)
    _kernels.check(code, "flash_bwd_dq")
    flash_attention_train.launches["flash_bwd_dq"] += 1
    code = lib.flash_bwd_dkv_launch(*ptrs, dk.data_ptr(), dv.data_ptr(), lens_ptr, B, Lq, Lk,
                                    N, D, float(scale), stream)
    _kernels.check(code, "flash_bwd_dkv")
    flash_attention_train.launches["flash_bwd_dkv"] += 1
    return dq, dk, dv


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, scale):
        dtypes = (q.dtype, k.dtype, v.dtype)
        if q.is_cuda:  # the kernels read bf16 operands
            q, k, v = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
        o, lse = flash_fwd_lse(q, k, v, kv_lens, scale)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens)
        ctx.scale, ctx.dtypes = scale, dtypes
        return o.to(dtypes[0])

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, kv_lens = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, do, lse, flash_delta(do, o), kv_lens, ctx.scale)
        return (dq.to(ctx.dtypes[0]), dk.to(ctx.dtypes[1]), dv.to(ctx.dtypes[2]), None, None)


def flash_attention_train(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention (the training path). q: [B, Lq, N, D];
    k/v: [B, Lk, N, D]; kv_lens: [B] or None. Returns o in q.dtype."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    return _FlashTrain.apply(q, k, v, kv_lens, float(scale))


flash_attention_train.launches: Dict[str, int] = {name: 0 for name in TRAIN_KERNELS}
