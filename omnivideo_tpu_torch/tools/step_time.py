"""Seconds per denoise step of a generate on the card, for comparing two
checkouts of the port in one call.

`--task t2v-1.3B` (the default): the seeded 1.3B pipeline (bf16 residual,
the fused qk_prep + flash path) runs `--steps` UniPC steps at 832x480x81
(CFG batch 2, 32,760 tokens) from a seeded 77-token context, without the
decode. `--task i2v-14B`: the seeded I2V-14B `WanI2V` (the 16.4B i2v DiT in
bf16 with an f32 residual, qk_impl and ew_impl "kernel", the ViT-H/14 CLIP
in bf16, the Wan2.1 VAE) from a seeded 1280x720 first frame and seeded
512x4096 contexts, `--steps` UniPC steps at shift 5, CFG 5.0, 832x480x81,
without the decode. Each step's synchronized wall time is
`pipe.timings["step_s"]`; the first step is a warm-up and is left out.
Prints one JSON line: the task, the package's path, the card, each step's
seconds, their median. The package is whichever `omnivideo_tpu_torch` is
first on the path, so one script times any checkout whose pipeline has this
API:

    PYTHONPATH=<checkout> python3 omnivideo_tpu_torch/tools/step_time.py \
        [--task t2v-1.3B|i2v-14B] --steps 8
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

import omnivideo_tpu_torch
from omnivideo_tpu_torch.configs.base import I2V_14B, T2V_1_3B
from omnivideo_tpu_torch.models.clip_vision import CLIPVisionConfig, init_clip_vision
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE, init_vae
from omnivideo_tpu_torch.models.wan_dit import WanDiT
from omnivideo_tpu_torch.pipelines.i2v import WanI2V
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified

TASKS = ("t2v-1.3B", "i2v-14B")


def _t2v_steps(steps: int) -> list:
    cfg = T2V_1_3B
    pipe = OmniVideoX2XUnified.random_init(cfg, seed=0, device="cuda", with_vae=False,
                                           residual_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():  # init zero-fills the head: make velocities non-zero
        pipe.low_noise.wan.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    ctx = torch.randn(77, cfg.dit.text_dim, generator=gen, device="cuda")
    pipe.generate(precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
                  size=(832, 480), frame_num=81, sampling_steps=steps, decode=False,
                  generator=gen)
    return pipe.timings["step_s"]


def _i2v_steps(steps: int) -> list:
    cfg = I2V_14B
    gen = torch.Generator(device="cuda").manual_seed(15)
    wan = WanDiT(cfg.dit, dtype=torch.bfloat16, device="cuda", generator=gen)
    with torch.no_grad():  # init zero-fills the head: make velocities non-zero
        wan.head.head.weight.normal_(0.0, cfg.dit.dim**-0.5, generator=gen)
    clip_cfg = CLIPVisionConfig()
    clip = init_clip_vision(clip_cfg, dtype=torch.bfloat16, device="cuda", generator=gen)
    vae = Wan21VAE.create(init_vae(cfg.vae, device="cuda", generator=gen), cfg.vae)
    pipe = WanI2V(cfg, wan, vae, clip, clip_cfg, qk_impl="kernel", ew_impl="kernel")
    img = torch.randint(0, 256, (720, 1280, 3), generator=gen, device="cuda", dtype=torch.uint8)
    ctx, ctx_null = (torch.randn(512, cfg.dit.text_dim, generator=gen, device="cuda")
                     for _ in range(2))
    pipe.generate(img, precomputed_context=ctx, precomputed_context_null=ctx_null,
                  size=(832, 480), frame_num=81, shift=5.0, sampling_steps=steps,
                  guide_scale=5.0, decode=False, generator=gen)
    return pipe.timings["step_s"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=TASKS, default="t2v-1.3B")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    all_steps = (_t2v_steps if args.task == "t2v-1.3B" else _i2v_steps)(args.steps)
    steps = [float(s) for s in all_steps[1:]]
    rec = {"label": args.label, "task": args.task, "package": omnivideo_tpu_torch.__file__,
           "card": torch.cuda.get_device_name(0), "step_s": steps,
           "first_step_s": float(all_steps[0]), "median_step_s": statistics.median(steps)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
