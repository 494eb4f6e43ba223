"""Ring flash attention: one step kernel and the n-step loops around it.

Port of the forward of omnivideo_tpu/ops/pallas/ring_attention.py. A ring
step (`_step_kernel`, kernel row 8) attends this rank's q shard to the K/V
shard visiting on this step and merges the result into a carried online
softmax state. `ring_step` launches the CUDA kernel `csrc/ring_step.cu` for
CUDA tensors and updates the carry in place; for CPU tensors it returns the
plain twin `ring_step_plain`'s new carry. Its launches are counted in
`ring_step.launches`. On CUDA it raises under grad mode with an input that
requires grad: the ring backward is not ported.

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
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import _kernels
from .flash_attention import LN2, NEG_INF, PLAIN_LOGITS_BUDGET, _qscale

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
    CUDA: packed contiguous bf16 q/k/v at head dim 128 (zigzag: Lq == Lk,
    Lq / 2 a multiple of 64), the carry updated in place and returned."""
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
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() for t in (q, k, v)):
        raise ValueError("ring_step: the kernel takes packed contiguous bf16 [B, L, N, D] q/k/v")
    if k.shape != (B, Lk, N, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if (m.shape != (B, N, Lq) or l.shape != m.shape or acc.shape != q.shape
            or any(t.dtype != torch.float32 or not t.is_contiguous() for t in (m, l, acc))):
        raise ValueError("ring_step: the carry is contiguous f32 m, l [B, N, Lq] and acc [B, Lq, N, D]")
    zz = 0
    if causal == "zigzag":
        zz = Lq // 2
        if Lk != Lq or Lq % 2 or zz % 64:
            raise ValueError(f"ring_step zigzag: needs Lq == Lk with Lq / 2 a multiple of 64, got {Lq}, {Lk}")
    lens = None if step_lens is None else step_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if Lq and Lk:
        code = _kernels.library().ring_step_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            lens.data_ptr() if lens is not None else None, B, Lq, Lk, N, D, CAUSAL_MODES[causal],
            my, src, n, zz, _qscale(scale), torch.cuda.current_stream(q.device).cuda_stream)
        _kernels.check(code, "ring_step")
        ring_step.launches += 1
    return m, l, acc


ring_step.launches = 0


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


def zigzag_order(L: int, n: int) -> torch.Tensor:
    """Token order of the zigzag layout: shard r holds chunks (r, 2n−1−r) of
    L / 2n tokens."""
    Lc = L // (2 * n)
    chunks = [c for r in range(n) for c in (r, 2 * n - 1 - r)]
    return torch.cat([torch.arange(c * Lc, (c + 1) * Lc) for c in chunks])


def stripe_order(L: int, n: int) -> torch.Tensor:
    """Token order of the stripe layout: shard r holds positions r + j·n."""
    return torch.cat([torch.arange(r, L, n) for r in range(n)])
