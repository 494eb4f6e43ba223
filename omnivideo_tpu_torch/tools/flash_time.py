"""Time the flash-attention kernels (and the MoE's grouped products) of one
checkout at the main paths' shapes.

    PYTHONPATH=<checkout root> python3 omnivideo_tpu_torch/tools/flash_time.py \
        [--which fwd|bwd|bwd_f32|fwd_lse|ring|ring_f32|pair|gmm|all ...]

`omnivideo_tpu_torch` is imported from PYTHONPATH, not from this file's
checkout, so one copy of the script times two checkouts (a parent commit and
a change) on the same card in one sitting; run them as parent, change, change,
parent. Every kernel is called through the library's C entry points, whose
arguments every checkout shares, with its operands made once. `fwd` times
the inference forward (`flash_fwd_launch`, rows 1, 2 and 3a): bounded
self-attention [2, 32760, 12, 128] and cross-attention over 6,272 keys at
12 and 40 heads (T2V-1.3B, T2V-A14B), the Qwen3 prefill [1, 1481, 32, 128]
causal and max-tracked, a long prefill [1, 8192, 32, 128] (a grid that
fills the card), and the vision tower [3, 1560, 16, 72] bounded;
bf16, q/k with RMS 1, the softmax bound computed once beforehand. `bwd`
times the training backward (rows 4 and 5) at [1, 32760, 12, 128] against
32,760 keys (self) and 6,272 keys (cross), as the pair through `flash_bwd`
and as each kernel alone. `fwd_lse` times the training forward (row 3b)
through `flash_fwd_lse_launch` at the same two shapes; `ring` times one ring
step (row 8) through `ring_step_launch`, non-causal, on an empty carry that
the launches keep updating: the sp phase's step, q [2, 32760, 12, 128]
against 32,760 keys, and a 4-card run's per-rank step, 8,190 q rows against
8,190 keys. `ring_f32` times the f32 ring step through `ring_step_f32_launch`
at the Qwen3 SFT's `--sp` shapes (32 heads, f32 q/k/v, token-causal): the
world-1 step's own shard [2, 2048, 32, 128], and a 4-card run's per-rank
[2, 512, 32, 128] own shard and an earlier shard (every key visible); its
bound is three tf32 products of the visible pairs' FLOPs at 495 TFLOP/s.
`bwd_f32` times rows 4 and 5 on f32 operands through `flash_bwd_dq_f32_launch`
and `flash_bwd_dkv_f32_launch` at the f32 ring backward's earlier-shard
shapes (32 heads, every key visible): a 4-card SFT `--sp` run's per-rank
[2, 512, 32, 128], the in-process shards' [1, 512, 32, 128] and, for
information, an 8,192-token sequence's shards over 4 cards [1, 2048, 32,
128]; its bounds
are three tf32 products of 6·B·N·L²·D (dq) and 8·B·N·L²·D (dk/dv) FLOPs.
`pair` times the i2v split cross-attention at I2V-14B's q [2, 32760, 40,
128] over 512 text and 257 image keys (bounded, the bounds computed
beforehand): on every checkout the two row-1 launches it replaces
(`flash_fwd_launch` twice, `two_launches_ms`), the two wrapper calls and
their bf16 sum as the model ran them before the pair (the wrappers reduce q
and k for their bounds: `two_wrappers_ms`; with the row norms given:
`two_wrappers_norms_ms`), and, where the checkout has it, the pair kernel
(`flash_pair_launch`, `pair_ms`) and its wrapper with qk_prep's row norms
(`flash_attention_pair`, `pair_wrapper_ms`); the bound is 4·B·N·Lq·(Lt +
Li)·D FLOPs at 989 TFLOP/s against the bytes of q, o and the four K/V
tensors at 3.35 TB/s.
`gmm` times the MoE's grouped products (rows 9 and 9b) through the
`ops.gmm.gmm` / `tgmm` wrappers, whose signature every checkout since they
were added shares, at Qwen3-VL-30B-A3B's MoE (128 experts, top-8, 2,048 →
768 → 2,048) with a seeded skewed routing: the prefill's gate/up and down
(1,481 tokens, 11,848 rows, bf16), the decode's (8 rows), the SFT's f32
forward and input gradient (2,048 tokens, 16,384 rows; the bank transposed
for the gradient), tgmm in bf16 at the prefill's rows and in f32 at the
SFT's, and the prefill's and the decode's gate/up and down on the banks
split over 2 and 4 cards (`split2_*`, `split4_*`: 384 and 192 of the 768
columns, row 9s); each with its bound from the routed data (the experts
hit: bytes at 3.35 TB/s, or the FLOPs at 989 TFLOP/s bf16, or f32 as three
tf32 products at 495 TFLOP/s, with FFMA's 67 TFLOP/s bound beside it), the
kernel time a call from torch.profiler and the host's enqueue time a call
(the event time `ms` is the larger of the two), for bf16
`torch._grouped_mm`'s time on the same operands (a yardstick the port never
calls), and the schedule `ops.gmm.gmm_schedule` picks (with its column tile
and stages where the checkout's schedule has them).
Each case prints one JSON line with the device time per launch
(CUDA events) of `rounds` rounds of `reps` launches each, after one untimed
round, and the bound: the case's matmul FLOPs over the H100's 989 TFLOP/s.
`--cases` picks `fwd` cases by name. A `fwd` round holds at
least `reps` launches and at least ROUND_FLOP of work, so the small vision
and prefill cases launch some hundreds of times a round and their time is
the kernel's, not the launch overhead's. Needs one CUDA device; builds the
checkout's kernels on first use.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import subprocess
import time

import torch

from omnivideo_tpu_torch.ops import _kernels
from omnivideo_tpu_torch.ops import flash_attention as flash_mod

SEQ = 21 * 30 * 52  # 832x480x81 after the (1, 2, 2) patch
FWD_CASES = (  # (case, B, Lq, Lk, N, D, causal)
    ("self_bounded", 2, SEQ, SEQ, 12, 128, False),
    ("cross_bounded", 2, SEQ, 6272, 12, 128, False),
    ("cross_bounded_n40", 2, SEQ, 6272, 40, 128, False),
    ("causal_prefill", 1, 1481, 1481, 32, 128, True),
    ("causal_prefill_8k", 1, 8192, 8192, 32, 128, True),
    ("d72_bounded", 3, 1560, 1560, 16, 72, False),
)
BWD_CASES = (("bwd_self", SEQ), ("bwd_cross", 6272))
LSE_CASES = (("fwd_lse_self", SEQ), ("fwd_lse_cross", 6272))
RING_CASES = (("ring_sp1", SEQ), ("ring_sp4", SEQ // 4))  # (case, q rows = keys per step)
BWD_F32_CASES = (  # (case, B, L)
    ("bwd_f32_rank4", 2, 512),
    ("bwd_f32_in_process", 1, 512),
    ("bwd_f32_shard2048", 1, 2048),  # an 8,192-token SFT sequence over 4 cards, for information
)
RING_F32_CASES = (  # (case, q rows = keys, my, src, n), token-causal, 32 heads
    ("ring_f32_sft_world1", 2048, 0, 0, 1),
    ("ring_f32_rank4_own", 512, 1, 1, 4),
    ("ring_f32_rank4_earlier", 512, 2, 1, 4),
)
PAIR_CASES = (("i2v_cross_pair", 2, SEQ, 512, 257, 40),)  # (case, B, Lq, Lt, Li, N)
N, D = 12, 128
GMM_CASES = (  # (case, op, tokens, dtype, k, n, transpose_rhs)
    ("prefill_gate_up", "gmm", 1481, torch.bfloat16, 2048, 768, False),
    ("prefill_down", "gmm", 1481, torch.bfloat16, 768, 2048, False),
    ("decode_gate_up", "gmm", 1, torch.bfloat16, 2048, 768, False),
    ("decode_down", "gmm", 1, torch.bfloat16, 768, 2048, False),
    ("sft_forward_f32", "gmm", 2048, torch.float32, 2048, 768, False),
    ("sft_input_grad_f32", "gmm", 2048, torch.float32, 768, 2048, True),
    ("tgmm_prefill_bf16", "tgmm", 1481, torch.bfloat16, 2048, 768, False),
    ("tgmm_sft_f32", "tgmm", 2048, torch.float32, 2048, 768, False),
) + tuple(  # row 9s: rank 0's banks split over 2 and 4 cards (`--vlm_fsdp`), 768 / n columns
    (f"split{c}_{step}_{proj}", "gmm", tokens, torch.bfloat16,
     *((2048, 768 // c) if proj == "gate_up" else (768 // c, 2048)), False)
    for c in (2, 4) for step, tokens in (("prefill", 1481), ("decode", 1))
    for proj in ("gate_up", "down"))
EXPERTS, TOP_K = 128, 8
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # FFMA
BF16_FLOPS = 989e12  # the H100 SXM's dense bf16 tensor-core rate
TF32_FLOPS = 495e12  # dense tf32; the f32 ring step takes three tf32 products per product
ROUND_FLOP = 2e13  # least work per `fwd` round: ~20 ms at the bf16 rate


def _normed(B, L, gen, n=N, d=D):
    t = torch.randn(B, L, n, d, generator=gen, device="cuda")
    return (t * torch.rsqrt(t.square().mean(-1, keepdim=True))).to(torch.bfloat16)


def _time(fn, reps: int, rounds: int) -> list:
    for _ in range(reps):  # one untimed round: the clocks settle after the previous case
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / reps)
    return ms


def _forward(args, smi, gen) -> None:
    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    for name, B, Lq, Lk, n, d, causal in FWD_CASES:
        if args.cases and name not in args.cases:
            continue
        q, k = _normed(B, Lq, gen, n, d), _normed(B, Lk, gen, n, d)
        v = torch.randn(B, Lk, n, d, generator=gen, device="cuda").to(torch.bfloat16)
        o = torch.empty_like(q)
        mb, safe = (None, None) if causal else flash_mod.softmax_bound(q, k, d**-0.5)
        ptrs = [t.data_ptr() if t is not None else None for t in (q, k, v, o, None, mb, safe)]
        flop = 4 * B * n * d * (Lq * (Lq + 1) // 2 if causal else Lq * Lk)
        reps = max(args.reps, math.ceil(ROUND_FLOP / flop))
        ms = _time(lambda: _kernels.check(lib.flash_fwd_launch(
            *ptrs, B, Lq, Lk, n, d, int(causal), flash_mod._qscale(d**-0.5), stream),
            "flash_fwd_launch"), reps, args.rounds)
        print(json.dumps({"case": name, "q": [B, Lq, n, d], "Lk": Lk, "causal": causal,
                          "bounded": bool(safe.item()) if safe is not None else False,
                          "reps": reps, "ms": ms, "bound_ms": flop / BF16_FLOPS * 1e3,
                          "gflop": flop / 1e9, "package": flash_mod.__file__,
                          "nvidia_smi": smi}), flush=True)
        del q, k, v, o


def _backward(args, smi, gen) -> None:
    B, scale = 1, D**-0.5
    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    for name, Lk in BWD_CASES:
        q, k = _normed(B, SEQ, gen), _normed(B, Lk, gen)
        v, do = (torch.randn(B, L, N, D, generator=gen, device="cuda").to(torch.bfloat16)
                 for L in (Lk, SEQ))
        o, lse = flash_mod.flash_fwd_lse(q, k, v)
        delta = flash_mod.flash_delta(do, o)
        dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device="cuda") for t in (q, k, v))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr())
        tail = (None, B, SEQ, Lk, N, D, scale, stream)
        dq_ms = _time(lambda: _kernels.check(lib.flash_bwd_dq_launch(
            *ptrs, dq.data_ptr(), *tail), "flash_bwd_dq"), args.reps, args.rounds)
        dkv_ms = _time(lambda: _kernels.check(lib.flash_bwd_dkv_launch(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *tail), "flash_bwd_dkv"), args.reps, args.rounds)
        pair_ms = _time(lambda: flash_mod.flash_bwd(q, k, v, do, lse, delta),
                        args.reps, args.rounds)
        print(json.dumps({"case": name, "q": [B, SEQ, N, D], "Lk": Lk, "pair_ms": pair_ms,
                          "flash_bwd_dq_ms": dq_ms, "flash_bwd_dkv_ms": dkv_ms,
                          "package": flash_mod.__file__, "nvidia_smi": smi}), flush=True)
        del q, k, v, do, o, dq, dk, dv


def _bound(B, Lq, Lk) -> dict:
    flop = 4 * B * N * Lq * Lk * D
    return {"bound_ms": flop / BF16_FLOPS * 1e3, "gflop": flop / 1e9}


def _fwd_lse(args, smi, gen) -> None:
    B = 1
    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    qscale = flash_mod._qscale(D**-0.5)
    for name, Lk in LSE_CASES:
        q, k = _normed(B, SEQ, gen), _normed(B, Lk, gen)
        v = torch.randn(B, Lk, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        o = torch.empty_like(q)
        lse = torch.empty(B, N, SEQ, dtype=torch.float32, device="cuda")
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), None)
        ms = _time(lambda: _kernels.check(lib.flash_fwd_lse_launch(
            *ptrs, B, SEQ, Lk, N, D, qscale, stream), "flash_fwd_lse"), args.reps, args.rounds)
        print(json.dumps({"case": name, "q": [B, SEQ, N, D], "Lk": Lk, "flash_fwd_lse_ms": ms,
                          **_bound(B, SEQ, Lk), "package": flash_mod.__file__,
                          "nvidia_smi": smi}), flush=True)
        del q, k, v, o, lse


def _ring(args, smi, gen) -> None:
    B = 2
    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    qscale = flash_mod._qscale(D**-0.5)
    for name, L in RING_CASES:
        q, k = _normed(B, L, gen), _normed(B, L, gen)
        v = torch.randn(B, L, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        m = torch.full((B, N, L), -1e30, dtype=torch.float32, device="cuda")
        l = torch.zeros(B, N, L, dtype=torch.float32, device="cuda")
        acc = torch.zeros(B, L, N, D, dtype=torch.float32, device="cuda")
        ptrs = tuple(t.data_ptr() for t in (q, k, v, m, l, acc)) + (None,)
        ms = _time(lambda: _kernels.check(lib.ring_step_launch(
            *ptrs, B, L, L, N, D, 0, 0, 0, 1, 0, qscale, stream), "ring_step"),
            args.reps, args.rounds)
        print(json.dumps({"case": name, "q": [B, L, N, D], "Lk": L, "ring_step_ms": ms,
                          **_bound(B, L, L), "package": flash_mod.__file__,
                          "nvidia_smi": smi}), flush=True)
        del q, k, v, m, l, acc


def _ring_f32(args, smi, gen) -> None:
    B, n_heads = 2, 32
    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    qscale = flash_mod._qscale(D**-0.5)
    for name, L, my, src, n in RING_F32_CASES:
        q, k, v = (torch.randn(B, L, n_heads, D, generator=gen, device="cuda") for _ in range(3))
        m = torch.full((B, n_heads, L), -1e30, dtype=torch.float32, device="cuda")
        l = torch.zeros(B, n_heads, L, dtype=torch.float32, device="cuda")
        acc = torch.zeros(B, L, n_heads, D, dtype=torch.float32, device="cuda")
        ptrs = tuple(t.data_ptr() for t in (q, k, v, m, l, acc)) + (None,)
        ms = _time(lambda: _kernels.check(lib.ring_step_f32_launch(
            *ptrs, B, L, L, n_heads, D, 2, my, src, n, 0, qscale, stream), "ring_step_f32"),
            args.reps, args.rounds)
        flop = 4 * B * n_heads * D * (L * (L + 1) // 2 if my == src else L * L)
        print(json.dumps({"case": name, "q": [B, L, n_heads, D], "Lk": L, "my": my, "src": src,
                          "ring_step_f32_ms": ms, "bound_ms": 3 * flop / TF32_FLOPS * 1e3,
                          "gflop": flop / 1e9, "package": flash_mod.__file__,
                          "nvidia_smi": smi}), flush=True)
        del q, k, v, m, l, acc


def _backward_f32(args, smi, gen) -> None:
    n_heads, scale = 32, D**-0.5
    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    for name, B, L in BWD_F32_CASES:
        q, k, v, do = (torch.randn(B, L, n_heads, D, generator=gen, device="cuda")
                       for _ in range(4))
        lse = torch.randn(B, n_heads, L, generator=gen, device="cuda").abs() + math.log(L)
        delta = torch.randn(B, n_heads, L, generator=gen, device="cuda")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr())
        tail = (None, B, L, L, n_heads, D, scale, stream)
        dq_ms = _time(lambda: _kernels.check(lib.flash_bwd_dq_f32_launch(
            *ptrs, dq.data_ptr(), *tail), "flash_bwd_dq_f32"), args.reps, args.rounds)
        dkv_ms = _time(lambda: _kernels.check(lib.flash_bwd_dkv_f32_launch(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *tail), "flash_bwd_dkv_f32"),
            args.reps, args.rounds)
        flop = 2 * B * n_heads * L * L * D  # one product
        print(json.dumps({"case": name, "q": [B, L, n_heads, D], "Lk": L,
                          "flash_bwd_dq_f32_ms": dq_ms, "flash_bwd_dkv_f32_ms": dkv_ms,
                          "bound_ms": {"dq": 3 * 3 * flop / TF32_FLOPS * 1e3,
                                       "dkv": 3 * 4 * flop / TF32_FLOPS * 1e3},
                          "package": flash_mod.__file__, "nvidia_smi": smi}), flush=True)
        del q, k, v, do, lse, delta, dq, dk, dv


def _device_and_host(fn, reps: int) -> tuple:
    """(ms of kernel time a call, from torch.profiler's device time of every
    kernel the calls launch; µs of host time a call to enqueue them). Where
    the host takes longer than the card, the event time of `_time` is the
    host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return dev_us / reps / 1e3, host_us


def _routed_sizes(tokens: int, gen) -> torch.Tensor:
    """Group sizes of a seeded top-8 routing over 128 experts, skewed as a
    trained router's (some experts popular, some never hit)."""
    logits = torch.randn(tokens, EXPERTS, generator=gen, device="cuda")
    logits += 1.5 * torch.randn(EXPERTS, generator=gen, device="cuda")
    flat = torch.topk(logits, TOP_K, dim=-1).indices.reshape(-1)
    return torch.bincount(flat, minlength=EXPERTS).to(torch.int32)


def _pair(args, smi, gen) -> None:
    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    qscale = flash_mod._qscale(D**-0.5)
    fa = flash_mod.flash_attention
    for name, B, Lq, Lt, Li, n in PAIR_CASES:
        q, kt, ki = (_normed(B, L, gen, n) for L in (Lq, Lt, Li))
        vt, vi = (torch.randn(B, L, n, D, generator=gen, device="cuda").to(torch.bfloat16)
                  for L in (Lt, Li))
        norms = [t.float().square().sum(-1).amax(dim=1).sqrt() for t in (q, kt, ki)]
        (mbt, safet), (mbi, safei) = (flash_mod.softmax_bound(q, k, D**-0.5) for k in (kt, ki))
        ot, oi = torch.empty_like(q), torch.empty_like(q)

        def two():
            for k, v, o, mb, safe, L in ((kt, vt, ot, mbt, safet, Lt),
                                         (ki, vi, oi, mbi, safei, Li)):
                _kernels.check(lib.flash_fwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, mb.data_ptr(),
                    safe.data_ptr(), B, Lq, L, n, D, 0, qscale, stream), "flash_fwd_launch")

        rec = {"case": name, "q": [B, Lq, n, D], "Lt": Lt, "Li": Li,
               "bounded": [bool(safet.item()), bool(safei.item())],
               "two_launches_ms": _time(two, args.reps, args.rounds),
               "two_wrappers_ms": _time(lambda: fa(q, kt, vt, assume_normalized=True)
                                        + fa(q, ki, vi, assume_normalized=True),
                                        args.reps, args.rounds),
               "two_wrappers_norms_ms": _time(
                   lambda: fa(q, kt, vt, assume_normalized=True, qk_row_norms=norms[:2])
                   + fa(q, ki, vi, assume_normalized=True, qk_row_norms=norms[::2]),
                   args.reps, args.rounds)}
        if hasattr(lib, "flash_pair_launch"):
            o = torch.empty_like(q)
            mb, safe = flash_mod.pair_bound(q, kt, ki, D**-0.5, tuple(norms))
            ptrs = [t.data_ptr() for t in (q, kt, vt, ki, vi, o, mb[0], safe[0:1], mb[1],
                                           safe[1:2])]
            rec["pair_ms"] = _time(lambda: _kernels.check(lib.flash_pair_launch(
                *ptrs, B, Lq, Lt, Li, n, D, qscale, stream), "flash_pair_launch"),
                args.reps, args.rounds)
            rec["pair_wrapper_ms"] = _time(lambda: flash_mod.flash_attention_pair(
                q, kt, vt, ki, vi, qk_row_norms=tuple(norms)), args.reps, args.rounds)
        flop = 4 * B * n * Lq * (Lt + Li) * D
        nbytes = 2 * (2 * B * Lq * n * D + 2 * B * (Lt + Li) * n * D)
        rec.update(bound_ms=max(flop / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
                   bound_by="operations" if flop / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S
                   else "bytes", gflop=flop / 1e9, package=flash_mod.__file__, nvidia_smi=smi)
        print(json.dumps(rec), flush=True)
        del q, kt, ki, vt, vi, ot, oi


def _gmm(args, smi, gen) -> None:
    gmm_mod = importlib.import_module("omnivideo_tpu_torch.ops.gmm")  # the module, not `gmm`
    for name, op, tokens, dtype, k, n, trans in GMM_CASES:
        sizes = _routed_sizes(tokens, gen)
        m = tokens * TOP_K
        lhs = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        hit, esize = int((sizes > 0).sum()), lhs.element_size()
        if op == "gmm":
            rhs = (torch.randn(EXPERTS, *((n, k) if trans else (k, n)), generator=gen,
                               device="cuda") * 0.02).to(dtype)
            fn = lambda: gmm_mod.gmm(lhs, rhs, sizes, transpose_rhs=trans)  # noqa: E731
            nbytes = (hit * k * n + m * k + m * n) * esize
            lib_args = (lhs, rhs.transpose(1, 2) if trans else rhs)
        else:
            rhs = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
            fn = lambda: gmm_mod.tgmm(lhs, rhs, sizes)  # noqa: E731
            nbytes = (m * (k + n) + EXPERTS * k * n) * esize
            lib_args = (lhs.T, rhs)
        flop = 2.0 * m * k * n
        peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32_FLOPS / 3  # f32: 3 tf32 products
        reps = args.reps * (20 if tokens == 1 else 1)
        rec = {"case": name, "op": op, "dtype": str(dtype).split(".")[-1], "m": m, "k": k,
               "n": n, "experts_hit": hit, "transpose_rhs": trans,
               "ms": _time(fn, reps, args.rounds),
               **dict(zip(("kernel_ms", "host_us"), _device_and_host(fn, reps))),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S, flop / peak) * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flop / peak else "operations"}
        if dtype == torch.float32:
            rec["bound_ffma_ms"] = max(nbytes / HBM_BYTES_PER_S, flop / F32_FLOPS) * 1e3
        schedule = getattr(gmm_mod, "gmm_schedule", None)
        if op == "gmm" and schedule is not None:
            rec["schedule"] = schedule(m, k, n, EXPERTS, dtype, torch.cuda.get_device_properties(
                0).multi_processor_count)._asdict()
        grouped_mm = getattr(torch, "_grouped_mm", None)
        if dtype == torch.bfloat16 and grouped_mm is not None:
            offs = torch.cumsum(sizes, 0, dtype=torch.int32)
            rec["library_ms"] = _time(lambda: grouped_mm(*lib_args, offs=offs), reps, args.rounds)
        print(json.dumps({**rec, "package": gmm_mod.__file__, "nvidia_smi": smi}), flush=True)
        del lhs, rhs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--which", nargs="+",
                    choices=("fwd", "bwd", "bwd_f32", "fwd_lse", "ring", "ring_f32", "pair",
                             "gmm", "all"),
                    default=["fwd"])
    ap.add_argument("--cases", nargs="+", choices=[c[0] for c in FWD_CASES],
                    help="only these `fwd` cases (default: all)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if {"fwd", "all"} & set(args.which):
        _forward(args, smi, gen)
    if {"bwd", "all"} & set(args.which):
        _backward(args, smi, gen)
    if {"bwd_f32", "all"} & set(args.which):
        _backward_f32(args, smi, gen)
    if {"fwd_lse", "all"} & set(args.which):
        _fwd_lse(args, smi, gen)
    if {"ring", "all"} & set(args.which):
        _ring(args, smi, gen)
    if {"ring_f32", "all"} & set(args.which):
        _ring_f32(args, smi, gen)
    if {"pair", "all"} & set(args.which):
        _pair(args, smi, gen)
    if {"gmm", "all"} & set(args.which):
        _gmm(args, smi, gen)


if __name__ == "__main__":
    main()
