"""Unified x2x generation CLI (port of tools/generate.py).

JSONL input: T2V rows {"sample_id", "prompt"} and V2V rows {"id",
"source_clip_path", "edit_prompt"} (samples/*.jsonl). A source clip is
`.npy` uint8 frames [T, H, W, 3] or `.npz` with "frames" (and "fps"), at the
output size; it is sampled to the frame count, scaled to [-1, 1] and goes
through the VAE encode as the visual condition. `--features_dir` reads
precomputed VLM features per sample (`sample_<id>.npz`: vlm_last_hidden_states,
aligned_emb, target_caption). Each video is written as uint8 frames
[T, H, W, 3] to `<output_dir>/<id>.npz` ("frames", "fps").

Every row is denoised first; then, for dual-expert models (A14B: 57 GB of
bf16 experts), the experts are freed before the VAE decodes the rows.

    python -m omnivideo_tpu_torch.tools.generate --task t2v-1.3B --tiny --random_weights \\
        --input samples/t2v_example.jsonl --output_dir outputs/gen --device cpu

`--sp_size N` denoises sequence-parallel over N processes, one card each
(`--sp_mode ulysses|ring`, `--ring_impl ppermute|pallas`: JAX's names,
both running the ring-step kernel), started by torchrun or by the
`--coordinator/--num_processes/--process_id` flags; every rank runs every
row and rank 0 writes the outputs:

    torchrun --nproc_per_node 4 -m omnivideo_tpu_torch.tools.generate --sp_size 4 \\
        --sp_mode ring --ring_impl pallas --task t2v-1.3B --random_weights \\
        --input samples/t2v_example.jsonl --output_dir outputs/gen

`--random_weights` runs seeded random params with a deterministic
pseudo-context per prompt (no checkpoint, no text encoder); `--tiny` shrinks
the model (head dim 128, the kernels' head dim) and the workload. Without
it, `--ckpt_dir` loads the reference layout (pipelines/loading.py), and the
prompts go through the umT5 encoder, which needs the tokenizer that is not
ported yet. The device defaults to cuda (kernels); `--device cpu` runs the
plain twins. Flags of the JAX CLI that the port does not run yet raise
NotImplementedError naming what they wait for.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from omnivideo_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.models.wan_dit import SPConfig
from omnivideo_tpu_torch.parallel.distributed import add_distributed_args, maybe_initialize_distributed
from omnivideo_tpu_torch.parallel.mesh import create_mesh
from omnivideo_tpu_torch.pipelines.loading import load_pipeline
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified

# flag → (value meaning "off", why it is not ported)
NOT_PORTED = {
    "tp_size": (1, "tensor parallelism comes with the FSDP/TP slice, ROADMAP §1"),
    "fsdp_size": (1, "parameter sharding comes with the FSDP/TP slice, ROADMAP §1"),
    "layer_stream": (False, "it comes with the streaming slice, ROADMAP §1"),
    "stream_quant": (None, "it comes with the streaming slice, ROADMAP §1"),
    "lora_adapters": (None, "it comes with LoRA, ROADMAP §1 training follow-ups"),
    "vlm_path": (None, "it waits for the Qwen3-VL engine and its tokenizer, ROADMAP §1"),
    "max_steps_per_call": (None, "a TPU dispatch-time workaround the card does not need"),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", default="t2v-1.3B", choices=sorted(WAN_CONFIGS))
    p.add_argument("--size", default=None,
                   help="W*H or a SIZE_CONFIGS key (default 832*480; --tiny: 64*32)")
    p.add_argument("--frame_num", type=int, default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--random_weights", action="store_true",
                   help="seeded random params (no checkpoint load)")
    p.add_argument("--tiny", action="store_true", help="shrink the model and the workload")
    p.add_argument("--input", required=True, help="JSONL input file")
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--sample_solver", default="unipc", choices=["unipc", "dpm++"])
    p.add_argument("--sample_steps", type=int, default=None)
    p.add_argument("--sample_shift", type=float, default=None)
    p.add_argument("--sample_guide_scale", type=float, default=None)
    p.add_argument("--base_seed", type=int, default=42)
    p.add_argument("--max_context_len", type=int, default=None)
    p.add_argument("--qk_impl", default="kernel", choices=["kernel", "unfused"],
                   help="kernel: the fused qk_prep + bounded flash prologue")
    p.add_argument("--ew_impl", default="unfused", choices=["kernel", "unfused"],
                   help="kernel: the fused residual + LayerNorm + AdaLN sandwich")
    p.add_argument("--residual_dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="DiT residual-stream storage dtype; float32 is the reference-parity "
                        "stream, where --ew_impl kernel fuses every sandwich")
    p.add_argument("--features_dir", default=None,
                   help="precomputed VLM feature .npz dir (sample_<id>.npz)")
    p.add_argument("--condition_mode", default="auto",
                   choices=["auto", "full", "text_only", "aligned_emb_with_text",
                            "aligned_emb_only", "visual_with_aligned_emb"])
    p.add_argument("--token_order", default="v2", choices=["v2", "v1"])
    p.add_argument("--fps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sp_size", type=int, default=1,
                   help="sequence-parallel degree: processes (cards) along 'seq'")
    p.add_argument("--sp_mode", default="ulysses", choices=["ulysses", "ring", "hybrid"])
    p.add_argument("--ring_impl", default="ppermute", choices=["ppermute", "pallas"],
                   help="JAX's two names; both run the ring-step kernel with each K/V "
                        "transfer posted before the launch")
    p.add_argument("--tp_size", type=int, default=1)
    p.add_argument("--fsdp_size", type=int, default=1)
    p.add_argument("--layer_stream", action="store_true")
    p.add_argument("--stream_quant", default=None, choices=[None, "int8"])
    p.add_argument("--lora_adapters", default=None)
    p.add_argument("--vlm_path", default=None)
    p.add_argument("--max_steps_per_call", type=int, default=None)
    add_distributed_args(p)
    args = p.parse_args(argv)
    for flag, (off, what) in NOT_PORTED.items():
        if getattr(args, flag) != off:
            raise NotImplementedError(f"--{flag} is not ported ({what})")
    if args.sp_mode == "hybrid":
        raise NotImplementedError("--sp_mode hybrid takes the 'fsdp' axis as its Ulysses axis, "
                                  "as the JAX CLI does, and --fsdp_size comes with the FSDP/TP "
                                  "slice (ROADMAP §1); the API runs it (SPConfig on a 2-D mesh)")
    if not args.random_weights and not args.ckpt_dir:
        p.error("--ckpt_dir is required without --random_weights")
    return args


def read_clip(path: str, frame_num: int, size, target_fps: float) -> torch.Tensor:
    """A source clip → [3, frame_num, H, W] f32 in [-1, 1]: every
    round(fps / target_fps)-th frame, the last one repeated to fill."""
    p = Path(path)
    if p.suffix == ".npz":
        data = np.load(p)
        frames, fps = data["frames"], float(data["fps"]) if "fps" in data else 16.0
    elif p.suffix == ".npy":
        frames, fps = np.load(p), 16.0
    else:
        raise NotImplementedError(f"{p}: only .npy / .npz uint8 frames are read; the video "
                                  "file readers (AVI, GIF, PIL) are not ported")
    W, H = size
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[1:] != (H, W, 3):
        raise ValueError(f"{p}: expected uint8 frames [T, {H}, {W}, 3], got "
                         f"{frames.dtype} {frames.shape} (resizing is not ported)")
    rate = max(1, int(round(fps / target_fps)))
    idx = np.arange(0, len(frames), rate)[:frame_num]
    idx = np.concatenate([idx, np.full(frame_num - len(idx), idx[-1])])
    return torch.from_numpy(frames[idx].astype(np.float32) / 127.5 - 1.0).permute(3, 0, 1, 2)


def _features(features_dir, sample_id):
    out = {}
    f = Path(features_dir) / f"sample_{sample_id}.npz" if features_dir else None
    if f is None or not f.exists():
        return out
    data = np.load(f, allow_pickle=False)
    for key, name in (("vlm_last_hidden_states", "ar_vision_input"), ("aligned_emb", "aligned_emb")):
        if key in data:
            v = np.asarray(data[key], np.float32)
            out[name] = torch.from_numpy(v[0] if v.ndim == 3 else v)
    if "target_caption" in data:
        out["target_caption"] = str(data["target_caption"])
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    sp = None
    if args.sp_size > 1:
        maybe_initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                     device=args.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != args.sp_size:
            raise ValueError(f"--sp_size {args.sp_size} needs {args.sp_size} processes, one per "
                             f"card (torchrun --nproc_per_node {args.sp_size}); this run has {world}")
        sp = SPConfig(create_mesh(sp=args.sp_size, device=args.device), args.sp_mode,
                      ring_impl=args.ring_impl)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    device = resolve_device(args.device)
    cfg = WAN_CONFIGS[args.task]
    if args.max_context_len:
        cfg = cfg.replace(max_context_len=args.max_context_len)
    if args.tiny:
        cfg = cfg.replace(
            dit=cfg.dit.replace(dim=256, ffn_dim=512, num_heads=2, num_layers=2, freq_dim=32,
                                text_dim=48),
            vae=cfg.vae.__class__(dim=8, z_dim=16, num_res_blocks=1), max_context_len=64)
        args.size = args.size or "64*32"
        args.frame_num = args.frame_num or 9
        args.sample_steps = args.sample_steps or 2
    args.size = args.size or "832*480"
    size = SIZE_CONFIGS.get(args.size) or tuple(int(v) for v in args.size.split("*"))
    frame_num = args.frame_num or cfg.frame_num
    steps = args.sample_steps or cfg.sample_steps
    shift = args.sample_shift or cfg.sample_shift
    guide = ((args.sample_guide_scale,) * 2 if args.sample_guide_scale
             else cfg.sample_guide_scale)
    impl = dict(qk_impl=args.qk_impl, ew_impl=args.ew_impl, residual_dtype=args.residual_dtype,
                sp=sp)
    if args.random_weights:
        pipe = OmniVideoX2XUnified.random_init(cfg, device=device, **impl)
    else:
        pipe = load_pipeline(cfg, args.ckpt_dir, dtype=cfg.torch_param_dtype, device=device,
                             **impl)
    out_dir = Path(args.output_dir)
    if rank0:
        out_dir.mkdir(parents=True, exist_ok=True)
    rows = [json.loads(line) for line in open(args.input) if line.strip()]

    # denoise every row, then (dual expert) free the experts, then decode
    done = []
    for idx, row in enumerate(rows):
        sample_id = Path(str(row.get("sample_id", row.get("id", idx)))).name
        prompt = row.get("prompt", row.get("edit_prompt", ""))
        feats = _features(args.features_dir, sample_id)
        if "target_caption" in feats:
            prompt = (feats.pop("target_caption") + " " + prompt).strip()
        visual_emb, encode_s = None, 0.0
        if "source_clip_path" in row and pipe.vae is not None:
            clip = read_clip(row["source_clip_path"], frame_num, size, cfg.sample_fps)
            t0 = time.perf_counter()
            lat_f = (frame_num - 1) // cfg.vae.vae_stride[0] + 1
            visual_emb = pipe.vae.encode(clip[None].to(device))[0][:, :lat_f]
            encode_s = time.perf_counter() - t0
        if args.random_weights:
            rng = np.random.default_rng(zlib.crc32(prompt.encode()))
            ctx = torch.from_numpy(rng.standard_normal((16, cfg.dit.text_dim)).astype(np.float32))
            text = dict(precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx))
        else:
            text = dict(input_prompt=prompt)
        gen = torch.Generator(device=device).manual_seed(args.base_seed + idx)
        latents = pipe.generate(visual_emb=visual_emb, condition_mode=args.condition_mode,
                                token_order=args.token_order, size=size, frame_num=frame_num,
                                shift=shift, sample_solver=args.sample_solver,
                                sampling_steps=steps, guide_scale=guide, decode=False,
                                generator=gen, **feats, **text)
        done.append((sample_id, latents.cpu(), dict(pipe.timings, encode_s=encode_s)))
        logging.info("sample %s denoised (%.2f s/step)", sample_id, pipe.timings["denoise_step_s"])
    if cfg.dual_expert:
        pipe.free_experts()
    for sample_id, latents, timings in done:
        frames = pipe.decode(latents, output_uint8=True).cpu().numpy()  # every rank decodes
        if not rank0:
            continue
        path = out_dir / f"{sample_id}.npz"
        np.savez(path, frames=frames, fps=args.fps or cfg.sample_fps)
        timings["decode_s"] = pipe.timings["decode_s"]
        logging.info("sample %s -> %s %s", sample_id, path, json.dumps(timings))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
