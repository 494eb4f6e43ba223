"""Grouped matrix products of the Qwen3 MoE: `gmm` (row 9) and `tgmm` (row 9b).

Port of JAX's megablox grouped GEMM as the JAX package calls it
(omnivideo_tpu/models/qwen3vl/text_model.py:129 `_grouped_matmul`,
moe_impl="megablox": megablox gmm.py:314 `gmm`, gmm.py:573 `tgmm`) and of
megablox's custom VJP (ops.py:22, `_gmm_bwd` at ops.py:63). Rows are
expert-contiguous: group e owns rows [off_e, off_e + group_sizes[e]) of the
lhs, off the exclusive scan of `group_sizes` (clamped to [0, m]).

- `gmm(lhs [m, k], rhs [E, k, n], group_sizes [E] int32)` → [m, n] in lhs's
  dtype: each group's rows times rhs[e] (with `transpose_rhs`, rhs
  [E, n, k] and rhs[e]ᵀ). Rows past the sum of the group sizes are zero,
  as `jax.lax.ragged_dot` gives them.
- `tgmm(lhs [m, k], rhs [m, n], group_sizes)` → [E, k, n]: out[e] =
  lhs[rows_e]ᵀ · rhs[rows_e], zero for an empty group. Megablox takes lhs
  already transposed ([k, m]); this takes the [m, k] rows as they are.
- `GroupedMatmul` (autograd): forward `gmm`; backward `gmm(dy, rhs,
  transpose_rhs=True)` for lhs and `tgmm(lhs, dy)` for rhs, as `_gmm_bwd`.

Products accumulate in f32 and round once to the operands' dtype: bf16 on
the tensor cores, f32 on them too as TF32 with a three-product hi/lo split
held to f32 (within 1e-5 of each row's max, as the plain twin's own f32
products in another order). On a CUDA tensor the wrappers make one launch
of a kernel of `csrc/gmm.cu` (bound and design there), which scans the group
sizes on the device, so nothing waits on the host; they raise for operands
the kernels do not take. `gmm_schedule` picks the kernel from the static
shape alone: bf16 at m <= DECODE_ROWS rows streams the banks with k split
over a cluster of blocks, bf16 at more rows runs the persistent wgmma
kernel, f32 the TF32 one. Only a CPU tensor goes to the plain twins
`gmm_plain` / `tgmm_plain` (per-group `torch.matmul`, which read the group
sizes on the host). Each wrapper counts its kernel launches (`gmm.launches`,
`tgmm.launches`). megablox's `group_offset` and `existing_out` serve experts
split over devices by E (a device's first group, and the other devices'
rows kept); the port splits the banks over cards by their width M instead
(parallel/expert_shard.py, `generate --vlm_fsdp`), so every card holds all
E groups of narrower banks and these calls run unchanged: neither is
needed, and neither is ported.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _kernels

MAX_GROUPS = 1024  # every block scans the group sizes in shared memory
_VEC = {torch.bfloat16: 8, torch.float32: 4}  # elements of a 16-byte chunk
DECODE_ROWS = 64  # at most this many rows: every group's rows fit one 64-row tile
SPLIT_BLOCKS_PER_SM = 3  # the split-k kernel's blocks resident on an SM (72 KiB each)
MAX_SPLITS = 8  # a cluster's portable size
_K_STEP = 64  # contraction per pipeline stage
_SPLIT_TILE_N = 128  # output columns of a split-k block


class Schedule(NamedTuple):
    """How one `gmm` call runs: `kind` "split_k" (bf16, m <= DECODE_ROWS),
    "wgmma" (bf16) or "tf32" (f32); `splits` the k splits of the split-k
    kernel (0 otherwise), each of `steps` k steps of 64; `blocks` its grid
    (0: the persistent kernels size theirs on the card, at most one an SM)."""

    kind: str
    splits: int
    steps: int
    blocks: int


@functools.lru_cache(maxsize=256)
def gmm_schedule(m: int, k: int, n: int, E: int, dtype: torch.dtype, sms: int) -> Schedule:
    """The kernel and grid of `gmm` at this static shape on a card with
    `sms` SMs: the few-row kernel takes at most min(E, m) groups × 128-column
    tiles × splits blocks, the most splits (<= MAX_SPLITS, <= the k steps)
    that keep them within one wave of SPLIT_BLOCKS_PER_SM blocks an SM; no
    value read from the card."""
    if dtype == torch.float32:
        return Schedule("tf32", 0, 0, 0)
    if m > DECODE_ROWS:
        return Schedule("wgmma", 0, 0, 0)
    k_steps = math.ceil(k / _K_STEP)
    tiles = min(E, m) * math.ceil(n / _SPLIT_TILE_N)
    splits = max(1, min(MAX_SPLITS, k_steps, SPLIT_BLOCKS_PER_SM * sms // tiles))
    steps = math.ceil(k_steps / splits)
    splits = math.ceil(k_steps / steps)  # no split without a step
    return Schedule("split_k", splits, steps, splits * tiles)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _row_ends(group_sizes: torch.Tensor, m: int) -> list:
    """Each group's end row, clamped to [0, m] (a host read: plain twins only)."""
    return torch.cumsum(group_sizes.clamp_min(0).long(), 0).clamp_max(m).tolist()


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
              transpose_rhs: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of `gmm`: one f32 matmul per group, rounded once."""
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = lhs.new_zeros(m, n)
    start = 0
    for e, end in enumerate(_row_ends(group_sizes, m)):
        if end > start:
            w = rhs[e].float()
            out[start:end] = (lhs[start:end].float() @ (w.T if transpose_rhs else w)).to(out.dtype)
        start = end
    return out


def tgmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of `tgmm`: one f32 matmul per group, rounded once."""
    m, k = lhs.shape
    out = lhs.new_zeros(group_sizes.shape[0], k, rhs.shape[1])
    start = 0
    for e, end in enumerate(_row_ends(group_sizes, m)):
        if end > start:
            out[e] = (lhs[start:end].float().T @ rhs[start:end].float()).to(out.dtype)
        start = end
    return out


def _check_shapes(what: str, lhs, rhs, group_sizes, rhs_dim: int) -> None:
    if lhs.dim() != 2 or rhs.dim() != rhs_dim or group_sizes.dim() != 1:
        raise ValueError(f"{what}: lhs must be 2-D, rhs {rhs_dim}-D and group_sizes 1-D, got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}, {tuple(group_sizes.shape)}")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"{what}: group_sizes must be int32, got {group_sizes.dtype}")


def _check_kernel_operands(what: str, lhs, rhs, group_sizes, widths) -> None:
    """Raise for CUDA operands the kernels do not take."""
    if not (lhs.is_cuda and rhs.device == lhs.device and group_sizes.device == lhs.device):
        raise ValueError(f"{what}: lhs, rhs and group_sizes must share one CUDA device, got "
                         f"{lhs.device}, {rhs.device}, {group_sizes.device}")
    if lhs.dtype not in _VEC or rhs.dtype != lhs.dtype:
        raise ValueError(f"{what}: the kernel takes bf16 or f32 operands of one dtype, got "
                         f"{lhs.dtype} and {rhs.dtype}")
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        raise RuntimeError(f"{what}: the kernel's output has no autograd history; train "
                           "through ops.gmm.GroupedMatmul")
    for t in (lhs, rhs, group_sizes):
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    for t in (lhs, rhs):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")
    vec = _VEC[lhs.dtype]
    if any(w % vec for w in widths):
        raise ValueError(f"{what}: widths {widths} must be multiples of {vec} for {lhs.dtype}")
    if not 1 <= group_sizes.shape[0] <= MAX_GROUPS:
        raise ValueError(f"{what}: 1 to {MAX_GROUPS} groups, got {group_sizes.shape[0]}")


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        transpose_rhs: bool = False) -> torch.Tensor:
    """lhs [m, k] × rhs [E, k, n] (transpose_rhs: [E, n, k]) over the groups
    → [m, n] in lhs's dtype; the kernel on CUDA, `gmm_plain` on the CPU."""
    _check_shapes("gmm", lhs, rhs, group_sizes, 3)
    m, k = lhs.shape
    E, rk, n = (rhs.shape[0], rhs.shape[2], rhs.shape[1]) if transpose_rhs else rhs.shape
    if rk != k or group_sizes.shape[0] != E:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} (transpose_rhs="
                         f"{transpose_rhs}) and {group_sizes.shape[0]} group sizes do not fit")
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes, transpose_rhs)
    _check_kernel_operands("gmm", lhs, rhs, group_sizes, (k, n))
    if m == 0 or n == 0 or k == 0:
        return torch.zeros(m, n, dtype=lhs.dtype, device=lhs.device)
    out = torch.empty(m, n, dtype=lhs.dtype, device=lhs.device)
    sms = _sm_count(lhs.device.index)
    sched = gmm_schedule(m, k, n, E, lhs.dtype, sms)
    code = _kernels.library().gmm_launch(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), m, k, n, E,
        int(transpose_rhs), int(lhs.dtype == torch.float32), sched.splits, sms,
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _kernels.check(code, "gmm")
    gmm.launches += 1
    return out


def tgmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Per group lhs[rows_e]ᵀ · rhs[rows_e] → [E, k, n] in lhs's dtype; the
    kernel on CUDA, `tgmm_plain` on the CPU."""
    _check_shapes("tgmm", lhs, rhs, group_sizes, 2)
    (m, k), n, E = lhs.shape, rhs.shape[1], group_sizes.shape[0]
    if rhs.shape[0] != m:
        raise ValueError(f"tgmm: lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} differ in rows")
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, rhs, group_sizes)
    _check_kernel_operands("tgmm", lhs, rhs, group_sizes, (k, n))
    if m == 0 or k == 0 or n == 0:
        return torch.zeros(E, k, n, dtype=lhs.dtype, device=lhs.device)
    out = torch.empty(E, k, n, dtype=lhs.dtype, device=lhs.device)
    code = _kernels.library().tgmm_launch(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), m, k, n, E,
        int(lhs.dtype == torch.float32), _sm_count(lhs.device.index),
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _kernels.check(code, "tgmm")
    tgmm.launches += 1
    return out


gmm.launches = 0
tgmm.launches = 0


class GroupedMatmul(torch.autograd.Function):
    """y = gmm(lhs, rhs, group_sizes) with megablox's VJP (ops.py:63
    `_gmm_bwd`): d lhs = gmm(dy, rhs, transpose_rhs=True), d rhs =
    tgmm(lhs, dy); each launched only where its input needs a gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dy = dy.to(lhs.dtype).contiguous()
        d_lhs = gmm(dy, rhs, group_sizes, transpose_rhs=True) if ctx.needs_input_grad[0] else None
        d_rhs = tgmm(lhs, dy, group_sizes) if ctx.needs_input_grad[1] else None
        return d_lhs, d_rhs, None
