"""Seconds per denoise step of the T2V-1.3B generate on the card, for
comparing two checkouts of the port in one call.

The seeded 1.3B pipeline (bf16 residual, the fused qk_prep + flash path)
runs `--steps` UniPC steps at 832x480x81 (CFG batch 2, 32,760 tokens) from a
seeded 77-token context, without the decode; each step's synchronized wall
time is `pipe.timings["step_s"]`. The first step is a warm-up and is left
out. Prints one JSON line: the package's path, each step's seconds, their
median. The package is whichever `omnivideo_tpu_torch` is first on the
path, so one script times any checkout whose pipeline has this API:

    PYTHONPATH=<checkout> python3 omnivideo_tpu_torch/tools/step_time.py --steps 8
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

import omnivideo_tpu_torch
from omnivideo_tpu_torch.configs.base import T2V_1_3B
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T2V_1_3B
    pipe = OmniVideoX2XUnified.random_init(cfg, seed=0, device="cuda", with_vae=False,
                                           residual_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():  # init zero-fills the head: make velocities non-zero
        pipe.low_noise.wan.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    ctx = torch.randn(77, cfg.dit.text_dim, generator=gen, device="cuda")
    pipe.generate(precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
                  size=(832, 480), frame_num=81, sampling_steps=args.steps, decode=False,
                  generator=gen)
    steps = [float(s) for s in pipe.timings["step_s"][1:]]
    rec = {"label": args.label, "package": omnivideo_tpu_torch.__file__,
           "card": torch.cuda.get_device_name(0), "step_s": steps,
           "median_step_s": statistics.median(steps)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
