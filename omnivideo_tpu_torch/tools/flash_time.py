"""Time the flash-attention kernels of one checkout at the Wan DiT's shapes.

    PYTHONPATH=<checkout root> python3 omnivideo_tpu_torch/tools/flash_time.py [--which fwd|bwd|all]

`omnivideo_tpu_torch` is imported from PYTHONPATH, not from this file's
checkout, so one copy of the script times two checkouts (a parent commit and
a change) on the same card in one sitting; run them as parent, change, change,
parent. The forward cases are those of `chip_smoke.py`'s flash phase: bounded
self-attention [2, 32760, 12, 128] and cross-attention over 6,272 keys, bf16,
q/k with RMS 1. The backward cases are those of its flash_train phase: the
training backward (rows 4 and 5) at [1, 32760, 12, 128] against 32,760 keys
(self) and 6,272 keys (cross), timed as the pair through `flash_bwd` and as
each kernel alone through the library's C entry points (whose arguments every
checkout shares). Each case prints one JSON line with the device time per
launch (CUDA events) of `rounds` rounds of `reps` launches each. Needs one
CUDA device; builds the checkout's kernels on first use.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from omnivideo_tpu_torch.ops import _kernels
from omnivideo_tpu_torch.ops import flash_attention as flash_mod

SEQ = 21 * 30 * 52  # 832x480x81 after the (1, 2, 2) patch
CASES = (("self_bounded", SEQ), ("cross_bounded", 6272))
BWD_CASES = (("bwd_self", SEQ), ("bwd_cross", 6272))
N, D = 12, 128


def _normed(B, L, gen):
    t = torch.randn(B, L, N, D, generator=gen, device="cuda")
    return (t * torch.rsqrt(t.square().mean(-1, keepdim=True))).to(torch.bfloat16)


def _time(fn, reps: int, rounds: int) -> list:
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
    B = 2
    for name, Lk in CASES:
        q, k = _normed(B, SEQ, gen), _normed(B, Lk, gen)
        v = torch.randn(B, Lk, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        ms = _time(lambda: flash_mod.flash_attention(q, k, v, assume_normalized=True),
                   args.reps, args.rounds)
        print(json.dumps({"case": name, "q": [B, SEQ, N, D], "Lk": Lk, "ms": ms,
                          "package": flash_mod.__file__, "nvidia_smi": smi}), flush=True)
        del q, k, v


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--which", choices=("fwd", "bwd", "all"), default="fwd")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.which in ("fwd", "all"):
        _forward(args, smi, gen)
    if args.which in ("bwd", "all"):
        _backward(args, smi, gen)


if __name__ == "__main__":
    main()
