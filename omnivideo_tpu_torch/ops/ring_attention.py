"""Ring flash attention: one step kernel and the n-step loops around it.

Port of the forward of omnivideo_tpu/ops/pallas/ring_attention.py. A ring
step (`_step_kernel`, kernel row 8) attends this rank's q shard to the K/V
shard visiting on this step and merges the result into a carried online
softmax state. `ring_step` launches a CUDA kernel for CUDA tensors and
updates the carry in place: `csrc/ring_step.cu` (row 8, the tensor cores)
for bf16 q/k/v, `csrc/ring_step_f32.cu` (f32-accurate products, as the
Pallas kernel takes them: three TF32 tensor-core products of a hi/lo split)
for f32 q/k/v; for CPU tensors it returns the
plain twin `ring_step_plain`'s new carry. Its launches are counted in
`ring_step.launches` (bf16) and `ring_step.launches_f32`. On CUDA it raises
under grad mode with an input that requires grad: only
`ring_flash_attention_trainable` calls it there.

The carry, in the port's own terms: m and l are [B, N, Lq] f32 (no 128-lane
broadcast), acc is [B, Lq, N, D] f32, packed like q. m is kept in log2
units of the logits (s = bf16(q·scale·log2e)·k, exp2 domain, as the flash
kernels keep it); l and acc do not depend on the base. `ring_finish` gives
out = acc / max(l, 1e-30) and the natural-log LSE m·ln2 + ln max(l, 1e-30).
A masked key adds exactly 0 (its logit is −inf, the carry's m starts at
−1e30), so a row that sees no key at all ends with out = 0, as flash_fwd
gives; the Pallas kernel adds phantom mass there, which the first visible
key wipes, so the valid rows agree.

Visibility (`causal`): None (every key), "block" (whole shards from ranks
<= own), "token" (those, with the triangle inside the own shard), "stripe"
(round-robin token layout: col + (src > my) <= row) and "zigzag" (shard r
holds chunks (r, 2n−1−r); JAX spells it causal="token", zigzag=True).
`kv_lens` are [B] valid lengths of the global sequence with contiguous end
padding; each step masks the visiting shard by its own share,
`step_lens_for`, which also covers the interleaved layout the hybrid
Ulysses × ring mode leaves (`chunks`).

Two drivers. `ring_flash_attention_shard` runs on every rank of a process
group: K/V ride to rank + 1 by `dist.batch_isend_irecv`, n − 1 transfers
(JAX sends n times; its last send only brings the rank's own shard home).
The transfer for step s + 1 is posted before step s's launch into a second
K/V buffer and waited on after it. `ring_flash_attention_shards` computes
what n ranks compute, in one process, over a list of shards: one card (or
the CPU tests) can hold the kernel at the real per-rank shapes.

The backward (`ring_flash_attention_trainable`, a torch.autograd.Function;
JAX `ring_flash_attention_trainable`): the forward keeps the global LSE,
and the backward runs n steps of the flash backward kernels (`flash_bwd`,
rows 4 and 5, on bf16 or f32 operands as the forward took them) driven by
that LSE and delta = rowsum(dO·O). dq accumulates
here in f32; the visiting shard's dk/dv (f32) travel with its K/V and are
home after the n-th transfer. Each K/V transfer is posted before the step's
launch; each dk/dv transfer after it, and is waited on after the next
step's launch. "block" skips the steps whose shard is invisible; "token"
runs the own-shard step as the dense triangular backward in plain torch (as
JAX's `_dense_causal_bwd_step`), skips the later shards and runs the kernels
on the earlier ones. With `kv_lens` (non-causal only) each step's keys are
`step_lens_for` the visiting shard, and a query row at or past its batch
row's length gets LSE +1e9, so its p = exp(s − LSE) is 0: zero dq and no
dk/dv share, as JAX's padded rows. `ring_flash_backward_shards` is the
in-process twin of the backward, over lists of shards.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import _kernels
from .flash_attention import LN2, NEG_INF, PLAIN_LOGITS_BUDGET, _qscale, flash_bwd, flash_delta

CAUSAL_MODES = {None: 0, "block": 1, "token": 2, "stripe": 3, "zigzag": 4}
Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ring_carry(B: int, Lq: int, N: int, D: int, device) -> Carry:
    """The empty carry: m = −1e30, l = 0, acc = 0."""
    return (torch.full((B, N, Lq), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros(B, N, Lq, dtype=torch.float32, device=device),
            torch.zeros(B, Lq, N, D, dtype=torch.float32, device=device))


def ring_finish(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, dtype: torch.dtype,
                return_lse: bool = False):
    """out [B, Lq, N, D] in `dtype` (and the natural-log LSE [B, N, Lq])."""
    out = (acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(dtype)
    if return_lse:
        return out, m * LN2 + torch.log(l.clamp_min(1e-30))
    return out


def step_lens_for(kv_lens: torch.Tensor, src: int, Lk: int, n: int, chunks: int = 1) -> torch.Tensor:
    """Valid keys of the shard of ring rank `src`, [B] int32. The shard is
    `chunks` global chunks of Lk / chunks tokens, chunk u·n + src for u <
    chunks (1: the contiguous shard src; the hybrid mode: the Ulysses
    concat). The valid keys are a prefix of the shard: its chunks lie in
    increasing global order and the padding is contiguous at the end."""
    lens = kv_lens.to(torch.int32)
    Lc = Lk // chunks
    return sum((lens - (u * n + src) * Lc).clamp(0, Lc) for u in range(chunks)).to(torch.int32)


def _visible(causal: Optional[str], Lq: int, Lk: int, my: int, src: int, n: int, device):
    """True (every key), False (none) or a bool [Lq, Lk] mask."""
    if causal is None:
        return True
    if causal == "block":
        return src <= my
    if causal == "token" and src != my:
        return src < my
    rows = torch.arange(Lq, device=device)[:, None]
    cols = torch.arange(Lk, device=device)[None, :]
    if causal == "token":
        return cols <= rows
    if causal == "stripe":
        return cols + int(src > my) <= rows
    if causal == "zigzag":
        zz = Lq // 2
        q2, k2 = rows >= zz, cols >= zz
        qc = torch.where(q2, 2 * n - 1 - my, my)
        kc = torch.where(k2, 2 * n - 1 - src, src)
        tri = cols - k2 * zz <= rows - q2 * zz
        return (kc < qc) | ((kc == qc) & tri)
    raise ValueError(f"causal {causal!r} not in {tuple(CAUSAL_MODES)}")


def ring_step_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    acc: torch.Tensor,
    step_lens: Optional[torch.Tensor] = None,
    causal: Optional[str] = None,
    my: int = 0,
    src: int = 0,
    n: int = 1,
    softmax_scale: Optional[float] = None,
) -> Carry:
    """Plain version of the step kernel: returns the new (m, l, acc). Logits
    in the exp2 domain with q·scale·log2e rounded to the k dtype, p rounded
    to the v dtype before p·v, chunked over q rows."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    c = _qscale(softmax_scale if softmax_scale is not None else D**-0.5)
    vis = _visible(causal, Lq, Lk, my, src, n, q.device)
    if vis is False:
        return m, l, acc
    live = None
    if step_lens is not None:
        live = torch.arange(Lk, device=k.device)[None, :] < step_lens.to(k.device)[:, None]
    kf, vf = k.float(), v.float()
    m2, l2, acc2 = m.clone(), l.clone(), acc.clone()
    chunk = max(1, PLAIN_LOGITS_BUDGET // max(1, B * N * Lk))
    for i0 in range(0, Lq, chunk):
        sl = slice(i0, i0 + chunk)
        qs = (q[:, sl].float() * c).to(k.dtype).float()
        s = torch.einsum("bind,bjnd->bnij", qs, kf)
        if live is not None:
            s = s.masked_fill(~live[:, None, None, :], float("-inf"))
        if vis is not True:
            s = s.masked_fill(~vis[sl][None, None], float("-inf"))
        m_old = m[:, :, sl]
        m_new = torch.maximum(m_old, s.amax(-1))
        alpha = torch.exp2(m_old - m_new)
        p = torch.exp2(s - m_new[..., None])
        l2[:, :, sl] = l[:, :, sl] * alpha + p.sum(-1)
        pv = torch.einsum("bnij,bjnd->bind", p.to(v.dtype).float(), vf)
        acc2[:, sl] = acc[:, sl] * alpha.transpose(1, 2)[..., None] + pv
        m2[:, :, sl] = m_new
    return m2, l2, acc2


def ring_step(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    acc: torch.Tensor,
    step_lens: Optional[torch.Tensor] = None,
    causal: Optional[str] = None,
    my: int = 0,
    src: int = 0,
    n: int = 1,
    softmax_scale: Optional[float] = None,
) -> Carry:
    """One ring step. q: [B, Lq, N, D]; k/v: [B, Lk, N, D]; the carry as
    `ring_carry` makes it; step_lens: [B] valid keys of this K/V shard.
    CUDA: packed contiguous q/k/v at head dim 128, all bf16 (row 8; zigzag:
    Lq == Lk, Lq / 2 a multiple of 64) or all f32 (the f32 step kernel), the
    carry updated in place and returned."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    if causal not in CAUSAL_MODES:
        raise ValueError(f"causal {causal!r} not in {tuple(CAUSAL_MODES)}")
    if q.device.type == "cpu":
        return ring_step_plain(q, k, v, m, l, acc, step_lens, causal, my, src, n, scale)
    if not q.is_cuda:
        raise ValueError(f"ring_step: unsupported device {q.device}")
    _kernels.check_no_grad("ring_step", q, k, v)
    if D != 128:
        raise ValueError(f"ring_step: no kernel for head_dim {D} (the kernel takes 128)")
    f32 = q.dtype == torch.float32
    want = torch.float32 if f32 else torch.bfloat16
    if any(t.dtype != want or not t.is_contiguous() for t in (q, k, v)):
        raise ValueError("ring_step: the kernels take packed contiguous [B, L, N, D] q/k/v, "
                         "all bf16 or all f32")
    if k.shape != (B, Lk, N, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if (m.shape != (B, N, Lq) or l.shape != m.shape or acc.shape != q.shape
            or any(t.dtype != torch.float32 or not t.is_contiguous() for t in (m, l, acc))):
        raise ValueError("ring_step: the carry is contiguous f32 m, l [B, N, Lq] and acc [B, Lq, N, D]")
    zz = 0
    if causal == "zigzag":
        zz = Lq // 2
        if Lk != Lq or Lq % 2 or (zz % 64 and not f32):
            raise ValueError(f"ring_step zigzag: needs Lq == Lk with Lq / 2 a multiple of 64, got {Lq}, {Lk}")
    lens = None if step_lens is None else step_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if Lq and Lk:
        lib = _kernels.library()
        launch = lib.ring_step_f32_launch if f32 else lib.ring_step_launch
        code = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            lens.data_ptr() if lens is not None else None, B, Lq, Lk, N, D, CAUSAL_MODES[causal],
            my, src, n, zz, _qscale(scale), torch.cuda.current_stream(q.device).cuda_stream)
        if f32:
            _kernels.check(code, "ring_step_f32")
            ring_step.launches_f32 += 1
        else:
            _kernels.check(code, "ring_step")
            ring_step.launches += 1
    return m, l, acc


ring_step.launches = 0
ring_step.launches_f32 = 0


def ring_flash_attention_shards(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    kv_lens: Optional[torch.Tensor] = None,
    causal: Optional[str] = None,
    softmax_scale: Optional[float] = None,
    return_lse: bool = False,
    step: Callable[..., Carry] = ring_step,
) -> List:
    """What n ranks compute, in one process: shard r's queries against every
    shard in ring order (step 0 its own, step s shard (r − s) mod n). The
    rotation is indexing. Returns the n outputs (or (out, lse) pairs)."""
    n = len(qs)
    outs = []
    for r in range(n):
        B, Lq, N, D = qs[r].shape
        carry = ring_carry(B, Lq, N, D, qs[r].device)
        for s in range(n):
            src = (r - s) % n
            Lk = ks[src].shape[1]
            lens = None if kv_lens is None else step_lens_for(kv_lens, src, Lk, n)
            carry = step(qs[r], ks[src], vs[src], *carry, step_lens=lens, causal=causal, my=r,
                         src=src, n=n, softmax_scale=softmax_scale)
        outs.append(ring_finish(*carry, qs[r].dtype, return_lse))
    return outs


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def exchange(tensors: Sequence[torch.Tensor], group=None):
    """Post one rotation: each tensor to rank + 1 of `group`, a new buffer of
    the same shape from rank − 1. Returns (works, received buffers): wait
    on every work before reading a buffer."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    right, left = _peer(group, (my + 1) % n), _peer(group, (my - 1) % n)
    tensors = [t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, right, group) for t in tensors]
           + [dist.P2POp(dist.irecv, t, left, group) for t in recv])
    return dist.batch_isend_irecv(ops), recv


def ring_flash_attention_shard(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    kv_lens: Optional[torch.Tensor] = None,
    causal: Optional[str] = None,
    softmax_scale: Optional[float] = None,
    return_lse: bool = False,
    chunks: int = 1,
):
    """Ring attention on this rank's shards q: [B, Lq, N, D], k/v: [B, Lk,
    N, D] over the ranks of `group` (default: the world), in rank order.
    kv_lens: [B] valid global lengths (contiguous end padding; `chunks` as
    in `step_lens_for`). Returns out [B, Lq, N, D] (and the LSE [B, N, Lq])."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    B, Lq, N, D = q.shape
    kv = (k.contiguous(), v.contiguous())
    carry = ring_carry(B, Lq, N, D, q.device)
    for s in range(n):
        src = (my - s) % n
        lens = None if kv_lens is None else step_lens_for(kv_lens, src, k.shape[1], n, chunks)
        if s < n - 1:
            works, nxt = exchange(kv, group)
        carry = ring_step(q, *kv, *carry, step_lens=lens, causal=causal, my=my, src=src, n=n,
                          softmax_scale=softmax_scale)
        if s < n - 1:
            for w in works:
                w.wait()
            kv = tuple(nxt)
    return ring_finish(*carry, q.dtype, return_lse)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

TRAINABLE_CAUSAL = (None, "block", "token")
PAD_LSE = 1e9  # LSE of a padded query row: p = exp(s − 1e9) is 0


def _row_positions(Lq: int, my: int, n: int, chunks: int, device) -> torch.Tensor:
    """Global token position of each of this ring rank's Lq query rows: the
    shard is `chunks` global chunks, chunk u·n + my for u < chunks."""
    Lc = Lq // chunks
    i = torch.arange(Lq, device=device)
    return ((i // Lc) * n + my) * Lc + i % Lc


def padded_lse(lse: torch.Tensor, kv_lens: Optional[torch.Tensor], my: int, n: int,
               chunks: int = 1) -> torch.Tensor:
    """lse [B, N, Lq] with the rows at or past their batch row's kv_lens set
    to PAD_LSE (unchanged without kv_lens)."""
    if kv_lens is None:
        return lse
    pos = _row_positions(lse.shape[2], my, n, chunks, lse.device)
    pad = pos[None, :] >= kv_lens.to(lse.device)[:, None]  # [B, Lq]
    return lse.masked_fill(pad[:, None, :], PAD_LSE)


def dense_causal_bwd_step(q, k, v, do, lse, delta, scale: float):
    """The own-shard step of the token-causal ring backward in plain torch
    (JAX `_dense_causal_bwd_step`): p = exp(s − LSE) under the col <= row
    triangle, f32 throughout; chunked over q rows. Returns f32 (dq, dk, dv)."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    cols = torch.arange(Lk, device=q.device)
    chunk = max(1, PLAIN_LOGITS_BUDGET // max(1, B * N * Lk))
    for i0 in range(0, Lq, chunk):
        sl = slice(i0, i0 + chunk)
        rows = torch.arange(i0, min(i0 + chunk, Lq), device=q.device)
        s = torch.einsum("bind,bjnd->bnij", qf[:, sl], kf) * scale
        p = torch.exp(s - lse[:, :, sl, None]).masked_fill(cols[None, :] > rows[:, None], 0.0)
        dp = torch.einsum("bind,bjnd->bnij", dof[:, sl], vf)
        ds = p * (dp - delta[:, :, sl, None])
        dq[:, sl] = torch.einsum("bnij,bjnd->bind", ds, kf) * scale
        dk += torch.einsum("bnij,bind->bjnd", ds, qf[:, sl]) * scale
        dv += torch.einsum("bnij,bind->bjnd", p, dof[:, sl])
    return dq, dk, dv


def _bwd_step(q, k, v, do, lse, delta, lens, causal, my, src, scale, bwd):
    """One backward step's (dq, dk, dv) f32, or None when the shard is invisible."""
    if causal == "block" and src > my:
        return None
    if causal == "token":
        if src > my:
            return None
        if src == my:
            return dense_causal_bwd_step(q, k, v, do, lse, delta, scale)
    return bwd(q, k, v, do, lse, delta, lens, scale)


def _check_trainable(causal, kv_lens) -> None:
    if causal not in TRAINABLE_CAUSAL:
        raise ValueError(f"the ring backward takes causal in {TRAINABLE_CAUSAL}, got {causal!r} "
                         "(stripe and zigzag are forward-only, as in JAX)")
    if kv_lens is not None and causal is not None:
        raise ValueError("the ring backward takes kv_lens on the non-causal path only (as JAX)")


def ring_flash_backward_shards(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    outs: Sequence[torch.Tensor],
    lses: Sequence[torch.Tensor],
    dos: Sequence[torch.Tensor],
    kv_lens: Optional[torch.Tensor] = None,
    causal: Optional[str] = None,
    softmax_scale: Optional[float] = None,
    bwd: Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = flash_bwd,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """What n ranks' ring backward computes, in one process: shard r's
    queries against every shard in ring order, from the forward's outputs
    and global LSEs (`ring_flash_attention_shards(..., return_lse=True)`).
    Returns the n (dq, dk, dv) f32 triples; dk/dv sum every rank's share."""
    _check_trainable(causal, kv_lens)
    n = len(qs)
    D = qs[0].shape[-1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    for r in range(n):
        lse = padded_lse(lses[r], kv_lens, r, n)
        delta = flash_delta(dos[r], outs[r])
        for s in range(n):
            src = (r - s) % n
            lens = None if kv_lens is None else step_lens_for(kv_lens, src, ks[src].shape[1], n)
            g = _bwd_step(qs[r], ks[src], vs[src], dos[r], lse, delta, lens, causal, r, src,
                          scale, bwd)
            if g is not None:
                dqs[r] += g[0]
                dks[src] += g[1]
                dvs[src] += g[2]
    return list(zip(dqs, dks, dvs))


def ring_flash_backward_shard(q, k, v, out, lse, do, group=None, kv_lens=None, causal=None,
                              softmax_scale: Optional[float] = None, chunks: int = 1):
    """The ring backward on this rank: (dq, dk, dv) f32 for its shards, from
    the forward's out and global LSE [B, N, Lq] and the output grad do."""
    _check_trainable(causal, kv_lens)
    n, my = dist.get_world_size(group), dist.get_rank(group)
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    lse = padded_lse(lse, kv_lens, my, n, chunks).contiguous()
    delta = flash_delta(do, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = (k.contiguous(), v.contiguous())
    dkv = None  # the visiting shard's dk/dv accumulated by the ranks before this one
    pending = None  # (works, received, sent: kept alive) of the dk/dv transfer in flight
    for s in range(n):
        src = (my - s) % n
        lens = None if kv_lens is None else step_lens_for(kv_lens, src, k.shape[1], n, chunks)
        if s < n - 1:
            kv_works, kv_next = exchange(kv, group)
        g = _bwd_step(q, *kv, do, lse, delta, lens, causal, my, src, scale, flash_bwd)
        if pending is not None:
            for w in pending[0]:
                w.wait()
            dkv = pending[1]
        if g is None:  # an invisible shard: its dk/dv pass on unchanged
            mine = dkv if dkv is not None else [torch.zeros(kv[0].shape, dtype=torch.float32,
                                                            device=q.device)] * 2
        else:
            dq += g[0]
            mine = [g[1], g[2]] if dkv is None else [dkv[0] + g[1], dkv[1] + g[2]]
        if n == 1:  # the own shard's dk/dv are home already
            return dq, mine[0], mine[1]
        works, recv = exchange(mine, group)
        pending = (works, recv, mine)
        if s < n - 1:
            for w in kv_works:
                w.wait()
            kv = tuple(kv_next)
    for w in pending[0]:
        w.wait()
    dk, dv = pending[1]
    return dq, dk, dv


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, group, causal, scale, chunks, operand_dtype):
        dtypes = (q.dtype, k.dtype, v.dtype)
        if q.is_cuda:
            q, k, v = (t.to(operand_dtype or t.dtype).contiguous() for t in (q, k, v))
        out, lse = ring_flash_attention_shard(q, k, v, group, kv_lens=kv_lens, causal=causal,
                                              softmax_scale=scale, return_lse=True,
                                              chunks=chunks)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens)
        ctx.group, ctx.causal, ctx.scale, ctx.chunks, ctx.dtypes = (group, causal, scale, chunks,
                                                                     dtypes)
        return out.to(dtypes[0])

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        dq, dk, dv = ring_flash_backward_shard(q, k, v, out, lse, do, ctx.group, kv_lens,
                                               ctx.causal, ctx.scale, ctx.chunks)
        return (dq.to(ctx.dtypes[0]), dk.to(ctx.dtypes[1]), dv.to(ctx.dtypes[2]),
                None, None, None, None, None, None)


def ring_flash_attention_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    kv_lens: Optional[torch.Tensor] = None,
    causal: Optional[str] = None,
    softmax_scale: Optional[float] = None,
    chunks: int = 1,
    operand_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> torch.Tensor:
    """Differentiable ring attention on this rank's shards (arguments as
    `ring_flash_attention_shard`; causal None, "block" or "token", kv_lens
    only with None). On CUDA q/k/v enter the forward in `operand_dtype`
    (JAX's `comm_dtype`): bf16, row 8; None keeps their dtype, so f32 q/k/v
    take the f32 step kernel and stay f32 through the whole backward: the
    own-shard step in plain torch, the other shards through the f32 backward
    kernels (rows 4 and 5 on f32 operands, p and ds kept in f32), as JAX's
    backward takes them. The output and the gradients come back in the
    callers' dtypes."""
    _check_trainable(causal, kv_lens)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    return _RingFlash.apply(q, k, v, kv_lens, group, causal, float(scale), chunks, operand_dtype)


def zigzag_order(L: int, n: int) -> torch.Tensor:
    """Token order of the zigzag layout: shard r holds chunks (r, 2n−1−r) of
    L / 2n tokens."""
    Lc = L // (2 * n)
    chunks = [c for r in range(n) for c in (r, 2 * n - 1 - r)]
    return torch.cat([torch.arange(c * Lc, (c + 1) * Lc) for c in chunks])


def stripe_order(L: int, n: int) -> torch.Tensor:
    """Token order of the stripe layout: shard r holds positions r + j·n."""
    return torch.cat([torch.arange(r, L, n) for r in range(n)])
