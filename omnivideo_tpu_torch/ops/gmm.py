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
the kernels do not take. `gmm_schedule` picks the kernel, its column tile
and its stages from the static shape alone: bf16 at m <= DECODE_ROWS rows
streams the banks with k split over a cluster of blocks (no cluster where
one split covers k), bf16 at more rows runs the persistent wgmma kernel,
f32 the TF32 one. Only a CPU tensor goes to the plain twins
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

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _kernels

MAX_GROUPS = 1024  # the most group sizes a kernel block reads (and scans in shared memory)
_VEC = {torch.bfloat16: 8, torch.float32: 4}  # elements of a 16-byte chunk
DECODE_ROWS = 64  # at most this many rows: every group's rows fit one 64-row tile
MAX_SPLITS = 8  # a cluster's portable size
_K_STEP = 64  # contraction per pipeline stage
_BOX = 64 * 128  # a 64 x 64 bf16 TMA box
BLOCK_SMEM = 232448  # a block's dynamic shared memory on sm_90 (227 KiB)
SM_SMEM = 233472  # an SM's shared memory (228 KiB); each resident block also takes 1 KiB
_SPLIT_RESIDENT = 8  # the split-k blocks an SM holds at most for the stage count
WIDE_TILES = (256, 192, 128)  # column tiles of the many-row kernel, widest first
SPLIT_TILES = (128, 64)  # of the few-row kernel
SPLIT_LOAD_SLACK = 1.15  # split-k options within this of the lightest busiest SM are peers
CLUSTER_FILL = 0.8  # at most this share of the block slots as clusters; an H100 held 0.89-0.94
# of them (cudaOccupancyMaxActiveClusters, the split-k kernel's clusters of 2 to 8 blocks)


class Schedule(NamedTuple):
    """How one `gmm` call runs: `kind` "split_k" (bf16, m <= DECODE_ROWS),
    "wgmma" (bf16) or "tf32" (f32); `splits` the k splits of the split-k
    kernel (0 otherwise: a cluster of `splits` blocks sums a tile's splits
    where splits > 1, none where it is 1), each of `steps` k steps of 64;
    `blocks` its grid (0: the persistent kernels size theirs on the card, at
    most one an SM); `tile_n` the output columns of a block's tile; `stages`
    the k steps a block holds in shared memory at once."""

    kind: str
    splits: int
    steps: int
    blocks: int
    tile_n: int
    stages: int


def _wide_smem(tile_n: int, stages: int) -> int:
    """csrc/gmm.cu `wide::smem_bytes`: the stages (A's 128 rows and tile_n
    columns of the bank, 64 deep) and their two barriers, both consumers'
    64 x tile_n outputs staged, the two lists of MAX_GROUPS + 1 ints, 1 KiB
    of alignment."""
    stage = 2 * _BOX + tile_n // 64 * _BOX
    return stages * (stage + 16) + 2 * (tile_n // 64 * _BOX) + 8 * (MAX_GROUPS + 1) + 1024


def _split_smem(tile_n: int, stages: int, a_rows: int, splits: int) -> int:
    """csrc/gmm.cu `narrow_smem`: the stages (an A box of a_rows rows and
    tile_n columns of the bank, 64 deep) and their two barriers, the f32
    partial [a_rows, tile_n] where a cluster sums the splits, the group
    found, 1 KiB of alignment."""
    stage = 128 * (a_rows + tile_n)
    return stages * (stage + 16) + (4 * a_rows * tile_n if splits > 1 else 0) + 16 + 1024


def _wide_stages(tile_n: int) -> int:
    """The most stages of the many-row kernel that fit a block."""
    return max(s for s in range(2, 9) if _wide_smem(tile_n, s) <= BLOCK_SMEM)


def _wide_traffic(m: int, k: int, n: int, E: int, tile_n: int) -> float:
    """Bytes the many-row kernel moves from L2 into shared memory a byte it
    holds in flight: the rows once a column tile (CT·m·k) and each row
    slot's bank columns once (slots·k·CT·tile_n, slots ≈ m / 128 +
    min(E, m) / 2, a group's last slot half full on average), over its
    stages × stage bytes."""
    ct = math.ceil(n / tile_n)
    slots = m / 128 + min(E, m) / 2
    return (ct * m * k + slots * k * ct * tile_n) / (
        _wide_stages(tile_n) * (2 * _BOX + tile_n // 64 * _BOX))


def _split_resident(tile_n: int, stages: int, a_rows: int, splits: int) -> int:
    """Split-k blocks an SM holds at once: its shared memory over a block's
    (each also takes 1 KiB), at most the 3 the kernel's launch bounds keep
    registers for."""
    return min(3, SM_SMEM // (_split_smem(tile_n, stages, a_rows, splits) + 1024))


@functools.lru_cache(maxsize=256)
def gmm_schedule(m: int, k: int, n: int, E: int, dtype: torch.dtype, sms: int) -> Schedule:
    """The kernel, tile and grid of `gmm` at this static shape on a card
    with `sms` SMs, from the shape alone (nothing read from the card):

    - f32: the TF32 kernel (128 x 128 tiles, 3 stages).
    - bf16, m > DECODE_ROWS: the persistent wgmma kernel. Its column tile is
      one of WIDE_TILES with the fewest columns past n (at most one 64-column
      box at the widths the MoE takes), and of those the one that moves the
      fewest bytes from L2 a byte in flight (`_wide_traffic`: the kernel is
      bound by how much it keeps in flight, and a narrower tile reads the
      rows more often but holds more stages), the widest on a tie; its
      stages as many as fit a block beside the staged outputs.
    - bf16, m <= DECODE_ROWS (a weight stream): the split-k kernel. Its
      column tile is 64 where a 128-column tile would leave 64 or more
      columns past n, else 128; T = min(E, m) groups × ceil(n / tile)
      tiles. For S splits (<= MAX_SPLITS, <= the k steps KT, none empty:
      P = ceil(KT / S) steps each, S = ceil(KT / P)) of B = T·S blocks, a
      block's share of its SM's shared memory is the SM's over the
      ceil(B / sms) blocks it holds (at most _SPLIT_RESIDENT), and its
      stages are P where that share takes P, so every load of the block is
      in flight at once, else as many as it takes, at least 2 (fewer
      blocks then share the SM). The splits considered fit, and their
      clusters (S > 1) fit the card in one wave: B <= CLUSTER_FILL · sms ·
      `_split_resident`, since a cluster's blocks share one GPC and leave
      slots of it empty. Of these, the peers are those whose busiest SM
      streams at most SPLIT_LOAD_SLACK times the fewest k steps,
      ceil(B / sms)·P (with every load in flight, an SM's bytes set its
      stream time and a block's P steps its chain of products); the chosen
      one needs no cluster if a peer does not (a cluster's sum costs about
      a microsecond), then has the fewest steps a block, then the fewest
      blocks."""
    if dtype == torch.float32:
        return Schedule("tf32", 0, 0, 0, 128, 3)
    if m > DECODE_ROWS:
        least = min(-n % t for t in WIDE_TILES)
        tile = min((t for t in WIDE_TILES if -n % t == least),
                   key=lambda t: (_wide_traffic(m, k, n, E, t), -t))
        return Schedule("wgmma", 0, 0, 0, tile, _wide_stages(tile))
    tile = 64 if 0 < n % 128 <= 64 else 128
    k_steps = math.ceil(k / _K_STEP)
    tiles = min(E, m) * math.ceil(n / tile)
    a_rows = math.ceil(m / 8) * 8
    options = []
    for s in range(1, min(MAX_SPLITS, k_steps) + 1):
        steps = math.ceil(k_steps / s)
        splits = math.ceil(k_steps / steps)  # no split without a step
        blocks = splits * tiles
        per_sm = math.ceil(blocks / sms)
        share = min(SM_SMEM // min(per_sm, _SPLIT_RESIDENT) - 1024, BLOCK_SMEM)
        least = min(2, steps)  # one stage refills only after the next one's products
        fit = [p for p in range(least, steps + 1)
               if _split_smem(tile, p, a_rows, splits) <= share] or [least]
        if _split_smem(tile, fit[-1], a_rows, splits) > BLOCK_SMEM or (
                splits > 1 and blocks > CLUSTER_FILL * sms * _split_resident(
                    tile, fit[-1], a_rows, splits)):
            continue
        options.append((per_sm * steps, splits > 1, steps, blocks,
                        Schedule("split_k", splits, steps, blocks, tile, fit[-1])))
    lightest = min(o[0] for o in options)
    return min(o[1:] for o in options if o[0] <= SPLIT_LOAD_SLACK * lightest)[-1]


def resident_clusters(m: int, sched: Schedule) -> int:
    """How many clusters of the split-k schedule `sched` at m rows the
    current CUDA device holds at once (cudaOccupancyMaxActiveClusters): what
    CLUSTER_FILL assumes, for a check on the card."""
    if sched.kind != "split_k":
        raise ValueError(f"resident_clusters: {sched.kind} launches no clusters")
    most = ctypes.c_int(0)
    _kernels.check(_kernels.library().gmm_max_clusters(m, sched.tile_n, sched.splits,
                                                       sched.stages, ctypes.byref(most)),
                   "gmm_max_clusters")
    return most.value


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
        int(transpose_rhs), int(lhs.dtype == torch.float32), sched.splits, sched.tile_n,
        sched.stages, sms, torch.cuda.current_stream(lhs.device).cuda_stream)
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
