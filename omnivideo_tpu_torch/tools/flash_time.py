"""Time the flash-attention kernel of one checkout at the Wan DiT's shapes.

    PYTHONPATH=<checkout root> python3 omnivideo_tpu_torch/tools/flash_time.py

`omnivideo_tpu_torch` is imported from PYTHONPATH, not from this file's
checkout, so one copy of the script times two checkouts (a parent commit and
a change) on the same card in one sitting; run them as parent, change, change,
parent. The cases are those of `chip_smoke.py`'s flash phase: bounded self-
attention [2, 32760, 12, 128] and cross-attention over 6,272 keys, bf16,
q/k with RMS 1. Each case prints one JSON line with the device time per
launch (CUDA events) of `rounds` rounds of `reps` launches each. Needs one
CUDA device; builds the checkout's kernels on first use.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from omnivideo_tpu_torch.ops import flash_attention as flash_mod

SEQ = 21 * 30 * 52  # 832x480x81 after the (1, 2, 2) patch
CASES = (("self_bounded", SEQ), ("cross_bounded", 6272))


def _normed(B, L, N, D, gen):
    t = torch.randn(B, L, N, D, generator=gen, device="cuda")
    return (t * torch.rsqrt(t.square().mean(-1, keepdim=True))).to(torch.bfloat16)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, N, D = 2, 12, 128
    for name, Lk in CASES:
        q, k = _normed(B, SEQ, N, D, gen), _normed(B, Lk, N, D, gen)
        v = torch.randn(B, Lk, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        run = lambda: flash_mod.flash_attention(q, k, v, assume_normalized=True)  # noqa: E731
        run()
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.rounds):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                run()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / args.reps)
        print(json.dumps({"case": name, "q": [B, SEQ, N, D], "Lk": Lk, "ms": ms,
                          "package": flash_mod.__file__, "nvidia_smi": smi}), flush=True)
        del q, k, v


if __name__ == "__main__":
    main()
