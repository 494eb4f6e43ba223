"""Fused residual + LayerNorm + AdaLN modulation (port of
omnivideo_tpu/ops/fused_adaln.py and its Pallas kernel ops/pallas/adaln.py).

    x_new = x + o·gate              (optional residual branch, f32)
    y     = LN(x_new; eps) [·ln_scale + ln_bias] [·(1 + mod_scale) + mod_shift]

in one pass over the [B, L, d] residual stream: the sandwich between the
stages of the Wan DiT block and before its head. `fused_adaln` launches the
CUDA kernel `csrc/adaln.cu` for CUDA tensors (f32 x, d % 128 == 0, d up to
the kernel's register budget; anything else raises) and takes
`fused_adaln_plain`, which follows the JAX `_ref_impl` op for op (centred
variance, two roundings for each product-then-sum), only for CPU tensors.
Launches are counted in `fused_adaln.launches`. Bound and design: see the
kernel source.

Differentiable like the JAX `custom_vjp`: under autograd the forward runs
the kernel and the backward is the VJP of the plain formula, recomputed
from the saved inputs (`_FusedAdaLN`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels

Tensor = torch.Tensor


def _check_args(o, gate, ln_scale, ln_bias, mod_scale, mod_shift) -> None:
    if gate is not None and o is None:
        raise ValueError("fused_adaln: gate needs the residual branch o")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("fused_adaln: ln_scale and ln_bias come together")
    if (mod_scale is None) != (mod_shift is None):
        raise ValueError("fused_adaln: mod_scale and mod_shift come together")


def fused_adaln_plain(
    x: Tensor,
    o: Optional[Tensor] = None,
    gate: Optional[Tensor] = None,
    ln_scale: Optional[Tensor] = None,
    ln_bias: Optional[Tensor] = None,
    mod_scale: Optional[Tensor] = None,
    mod_shift: Optional[Tensor] = None,
    eps: float = 1e-6,
    out_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[Optional[Tensor], Tensor]:
    """Plain PyTorch version: the JAX `_ref_impl`, op for op."""
    _check_args(o, gate, ln_scale, ln_bias, mod_scale, mod_shift)
    xf = x.float()
    if o is not None:
        r = o.float()
        if gate is not None:
            r = r * gate.float()[:, None, :]
        xf = xf + r
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if ln_scale is not None:
        y = y * ln_scale.float() + ln_bias.float()
    if mod_scale is not None:
        y = y * (1.0 + mod_scale.float()[:, None, :]) + mod_shift.float()[:, None, :]
    return (xf if o is not None else None), y.to(out_dtype)


def _vec(t: Optional[Tensor], shape, dev) -> Optional[Tensor]:
    """A per-batch or per-channel vector as the kernel reads it: f32,
    contiguous, on x's device."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_adaln: vector of shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.to(device=dev, dtype=torch.float32).contiguous()


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _forward(x, o, gate, ln_scale, ln_bias, mod_scale, mod_shift, eps, out_dtype):
    if x.device.type == "cpu":
        return fused_adaln_plain(x, o, gate, ln_scale, ln_bias, mod_scale, mod_shift, eps,
                                 out_dtype)
    if not x.is_cuda:
        raise ValueError(f"fused_adaln: unsupported device {x.device}")
    _check_args(o, gate, ln_scale, ln_bias, mod_scale, mod_shift)
    B, L, d = x.shape
    lib = _kernels.library()
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fused_adaln kernel takes a contiguous f32 residual stream x")
    if d % 128 or d > lib.adaln_max_dim():
        raise ValueError(f"fused_adaln kernel needs d % 128 == 0 and d <= "
                         f"{lib.adaln_max_dim()} (d={d})")
    if o is not None and (o.shape != x.shape or o.dtype not in (torch.bfloat16, torch.float32)
                          or not o.is_contiguous() or o.device != x.device):
        raise ValueError("fused_adaln kernel takes o as a contiguous bf16 or f32 tensor "
                         "of x's shape on x's device")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_adaln kernel writes y in bf16 or f32, not {out_dtype}")
    dev = x.device
    gate, mod_scale, mod_shift = (_vec(t, (B, d), dev) for t in (gate, mod_scale, mod_shift))
    ln_scale, ln_bias = (_vec(t, (d,), dev) for t in (ln_scale, ln_bias))
    x_new = torch.empty_like(x) if o is not None else None
    y = torch.empty(B, L, d, dtype=out_dtype, device=dev)
    if B * L == 0:
        return x_new, y
    for t in (x, o, gate, ln_scale, ln_bias, mod_scale, mod_shift, x_new, y):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("fused_adaln kernel needs 16-byte aligned tensors")
    code = lib.adaln_launch(
        x.data_ptr(), _ptr(o), _ptr(gate), _ptr(ln_scale), _ptr(ln_bias), _ptr(mod_scale),
        _ptr(mod_shift), _ptr(x_new), y.data_ptr(), B * L, L, d,
        int(o is not None and o.dtype == torch.float32), int(out_dtype == torch.float32),
        float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(code, "fused_adaln")
    fused_adaln.launches += 1
    return x_new, y


class _FusedAdaLN(torch.autograd.Function):
    """Forward: the kernel (or the plain twin on the CPU). Backward: the VJP
    of the plain formula at the saved inputs, as the JAX custom_vjp."""

    @staticmethod
    def forward(ctx, x, o, gate, ln_scale, ln_bias, mod_scale, mod_shift, eps, out_dtype):
        ctx.save_for_backward(x, o, gate, ln_scale, ln_bias, mod_scale, mod_shift)
        ctx.eps, ctx.out_dtype, ctx.has_res = eps, out_dtype, o is not None
        x_new, y = _forward(x, o, gate, ln_scale, ln_bias, mod_scale, mod_shift, eps, out_dtype)
        return (x_new, y) if ctx.has_res else y

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:7]
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(saved, need)]
        with torch.enable_grad():
            x_new, y = fused_adaln_plain(*leaves, ctx.eps, ctx.out_dtype)
        outs = (x_new, y) if ctx.has_res else (y,)
        pairs = [(out, g) for out, g in zip(outs, grads) if g is not None]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad([p[0] for p in pairs], wrt, [p[1] for p in pairs],
                                       allow_unused=True) if pairs and wrt else ())
        res = [next(got) if t is not None and t.requires_grad else None for t in leaves]
        return (*res, None, None)


def fused_adaln(
    x: Tensor,
    o: Optional[Tensor] = None,
    gate: Optional[Tensor] = None,
    ln_scale: Optional[Tensor] = None,
    ln_bias: Optional[Tensor] = None,
    mod_scale: Optional[Tensor] = None,
    mod_shift: Optional[Tensor] = None,
    eps: float = 1e-6,
    out_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[Optional[Tensor], Tensor]:
    """x: [B, L, d] residual stream (f32 on the card); o: optional [B, L, d]
    branch output; gate: optional [B, d] (needs o); ln_scale/ln_bias:
    optional [d]; mod_scale/mod_shift: optional [B, d]. Returns (x_new f32
    or None when o is None, y in out_dtype)."""
    args = (x, o, gate, ln_scale, ln_bias, mod_scale, mod_shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        out = _FusedAdaLN.apply(*args, eps, out_dtype)
        return out if o is not None else (None, out)
    return _forward(*args, eps, out_dtype)


fused_adaln.launches = 0
