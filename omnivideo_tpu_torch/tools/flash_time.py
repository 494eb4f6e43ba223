"""Time the flash-attention kernels of one checkout at the main paths' shapes.

    PYTHONPATH=<checkout root> python3 omnivideo_tpu_torch/tools/flash_time.py \
        [--which fwd|bwd|fwd_lse|ring|all ...]

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
8,190 keys. Each case prints one JSON line with the device time per launch
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
import json
import math
import subprocess

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
N, D = 12, 128
BF16_FLOPS = 989e12  # the H100 SXM's dense bf16 tensor-core rate
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--which", nargs="+", choices=("fwd", "bwd", "fwd_lse", "ring", "all"),
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
    if {"fwd_lse", "all"} & set(args.which):
        _fwd_lse(args, smi, gen)
    if {"ring", "all"} & set(args.which):
        _ring(args, smi, gen)


if __name__ == "__main__":
    main()
