"""Unified x2x generation CLI (port of tools/generate.py).

JSONL input: T2V rows {"sample_id", "prompt"} and V2V rows {"id",
"source_clip_path", "edit_prompt"} (samples/*.jsonl). A source clip is any
file utils/video.py reads (`.mp4` through imageio, MJPEG `.avi`, `.gif`, a
PNG/JPG dir, `.npz` "frames" (+ "fps"), `.npy`) at any size: every
round(fps / 16)-th frame is taken, resized to cover the output size and
center-cropped on the card, scaled to [-1, 1], and goes through the VAE
encode as the visual condition. Each video is written with
`save_video(<output_dir>/<id>.mp4)` (`save_image(<id>.png)` for one frame),
whose extension says what this machine could write: `.mp4` with an imageio
encoder, else MJPEG `.avi` or `.gif` with Pillow, else `.npz` ("frames"
[T, H, W, 3] uint8, "fps"); the path written is logged.

`--vlm_path` runs the Qwen3-VL engine (models/qwen3vl/engine.py, backend
"jax": JAX's name for the native path) on an HF checkpoint dir: per row the
source caption, the target caption and the features; the prompt becomes
`target_caption + " " + prompt` and the features the VLM input of the DiT.
`--features_dir` reads precomputed features instead (`sample_<id>.npz`:
vlm_last_hidden_states, aligned_emb, target_caption). Without
`--random_weights`, `--ckpt_dir` loads the reference layout
(pipelines/loading.py) and the prompts go through the umT5 encoder with the
checkpoint's tokenizer (`google/umt5-xxl/`, read with the `tokenizers`
package).

Memory on one card: Qwen3-VL-30B-A3B is 62 GB of bf16 weights and the 1.3B
pipeline with umT5-XXL another ~15 GB, more than an 80 GB card holds through
a 32,760-token step. So the VLM stage runs for every row first, the engine
is freed, and only then is the pipeline built; every row is then denoised,
and for dual-expert models (A14B: 57 GB of bf16 experts) the experts are
freed before the VAE decodes the rows. Each row's result is the same as in
the JAX CLI's row-by-row order.

    python -m omnivideo_tpu_torch.tools.generate --task t2v-1.3B --tiny --random_weights \\
        --input samples/t2v_example.jsonl --output_dir outputs/gen --device cpu

`--sp_size N` denoises sequence-parallel over N processes, one card each
(`--sp_mode ulysses|ring|hybrid`, `--ring_impl ppermute|pallas`: JAX's
names, both running the ring-step kernel; the hybrid takes the 'fsdp' axis
as its Ulysses axis), `--fsdp_size` shards the experts' parameters (FSDP2:
each block all-gathered for its forward) and `--tp_size` splits their heads
and FFN columns (Megatron; without `--sp_size`), on a (1, fsdp, sp, tp)
mesh as JAX's CLI builds it. The processes are started by torchrun or by
the `--coordinator/--num_processes/--process_id` flags; every rank runs
every row and rank 0 writes the outputs:

    torchrun --nproc_per_node 4 -m omnivideo_tpu_torch.tools.generate --sp_size 4 \\
        --sp_mode ring --ring_impl pallas --task t2v-1.3B --random_weights \\
        --input samples/t2v_example.jsonl --output_dir outputs/gen

`--vlm_fsdp n` splits the Qwen3-VL MoE's expert banks over n processes,
one card each (models/qwen3vl/engine.py, parallel/expert_shard.py): each
rank reads its M / n columns of every bank and all the rest of the
checkpoint, and every rank of the group ends with the same captions and
features. Consecutive ranks form world / n such groups; the DiT stage then
runs as without the flag (or on the mesh of `--sp_size`/`--fsdp_size`/
`--tp_size`, which may share the processes):

    torchrun --nproc_per_node 4 -m omnivideo_tpu_torch.tools.generate --vlm_fsdp 4 \\
        --vlm_path <Qwen3-VL-30B-A3B dir> --task t2v-1.3B --ckpt_dir <dir> \\
        --input samples/input_list.jsonl --output_dir outputs/gen

`--lora_adapters <npz>` merges LoRA adapters (finetune
`--lora_adapter_export`, or a file JAX's CLI wrote) into every distinct
expert before any sharding, so the denoise runs plain weights.

`--layer_stream` runs one card with the experts' blocks in page-locked
host memory, streamed through a few device slots per step
(pipelines/streaming.py: T2V-A14B's 57 GB of experts on a card that then
holds a window of blocks), `--stream_quant int8` streams their large
weights as int8, `--stream_group N` copies and runs N blocks at a time;
both need `--layer_stream`, which needs one process:

    python -m omnivideo_tpu_torch.tools.generate --task t2v-A14B --random_weights \\
        --layer_stream --stream_quant int8 --input samples/t2v_example.jsonl

`--dp_rank/--dp_world_size` split the JSONL rows between independent runs
(row i goes to dp_rank i % dp_world_size), by default the mesh's data index
and size, so the ranks of one mesh never split rows. `--vae_dtype bfloat16`
runs the VAE decoder in bf16.

`--random_weights` runs seeded random params with a deterministic
pseudo-context per prompt (no checkpoint, no text encoder); `--tiny` shrinks
the model (head dim 128, the kernels' head dim), its umT5 (width 48, 2
layers, a 256-token vocabulary: a tiny checkpoint dir's) and the workload.
The device defaults to cuda (kernels); `--device cpu` runs the plain twins.
The JAX CLI's `--max_steps_per_call` (a TPU dispatch workaround) and
`--vlm_backend hf` raise NotImplementedError saying why.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from omnivideo_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
from omnivideo_tpu_torch.configs.base import T5Config
from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.io.hf_reader import load_hf_config, qwen3vl_config_from_hf
from omnivideo_tpu_torch.models.qwen3vl.engine import Qwen3VLEngine, VLMConfig, vlm_shard
from omnivideo_tpu_torch.models.wan_dit import SPConfig
from omnivideo_tpu_torch.parallel.distributed import add_distributed_args, maybe_initialize_distributed
from omnivideo_tpu_torch.parallel.mesh import axis_index, axis_size, create_mesh
from omnivideo_tpu_torch.pipelines.loading import load_pipeline, merge_adapters
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
from omnivideo_tpu_torch.training.lora import load_adapters_npz
from omnivideo_tpu_torch.utils.video import (
    read_video_frames,
    sample_and_transform_frames,
    save_image,
    save_video,
)

# flag → (value meaning "off", why it is not ported)
NOT_PORTED = {
    "max_steps_per_call": (None, "a TPU dispatch-time workaround the card does not need"),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # i2v-14B runs through pipelines/i2v.py, not this CLI (JAX's has no i2v path)
    p.add_argument("--task", default="t2v-1.3B",
                   choices=sorted(k for k, c in WAN_CONFIGS.items() if c.dit.model_type != "i2v"))
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
    p.add_argument("--layer_stream", action="store_true",
                   help="the experts' blocks in host memory, streamed through the card per "
                        "step (one process)")
    p.add_argument("--stream_quant", default=None, choices=[None, "int8"],
                   help="with --layer_stream: int8 weight-only streamed blocks")
    p.add_argument("--stream_group", type=int, default=1,
                   help="with --layer_stream: blocks per copy and launch unit")
    p.add_argument("--lora_adapters", default=None,
                   help="adapter .npz (finetune --lora_adapter_export, or JAX's): merged into "
                        "every expert's weights at load")
    p.add_argument("--vlm_path", default=None,
                   help="Qwen3-VL HF checkpoint dir: caption expansion + feature extraction")
    p.add_argument("--vlm_backend", default="jax", choices=["hf", "jax"],
                   help="jax: the native engine (JAX's name for it); hf is not ported")
    p.add_argument("--vlm_fsdp", type=int, default=1,
                   help="split the VLM's expert banks over this many processes, one card each "
                        "(consecutive ranks; the experts' width / n a multiple of 8)")
    p.add_argument("--max_steps_per_call", type=int, default=None)
    p.add_argument("--dp_rank", type=int, default=None,
                   help="this run's share of the rows: row i when i %% dp_world_size == "
                        "dp_rank (default: the mesh's data index, else 0)")
    p.add_argument("--dp_world_size", type=int, default=None,
                   help="runs the rows are split between (default: the mesh's data size, else 1)")
    p.add_argument("--vae_dtype", default=None, choices=[None, "float32", "bfloat16"],
                   help="the VAE decoder's dtype (default float32)")
    add_distributed_args(p)
    args = p.parse_args(argv)
    for flag, (off, what) in NOT_PORTED.items():
        if getattr(args, flag) != off:
            raise NotImplementedError(f"--{flag} is not ported ({what})")
    if args.vlm_backend == "hf":
        raise NotImplementedError("--vlm_backend hf is not ported (transformers' own torch "
                                  "model); --vlm_backend jax runs the native engine")
    if args.sp_size > 1 and args.sp_mode == "hybrid" and args.fsdp_size == 1:
        p.error("--sp_mode hybrid takes the 'fsdp' axis as its Ulysses axis: give --fsdp_size")
    if args.sp_size > 1 and args.tp_size > 1:
        p.error("--sp_size and --tp_size exclude each other (one SPConfig mode)")
    if args.stream_quant and not args.layer_stream:
        p.error("--stream_quant requires --layer_stream")
    if args.stream_group != 1 and not args.layer_stream:
        p.error("--stream_group requires --layer_stream")
    if args.stream_group < 1:
        p.error("--stream_group must be ≥ 1")
    if args.layer_stream and args.fsdp_size * args.sp_size * args.tp_size > 1:
        p.error("--layer_stream is the single-device path (no --sp_size/--fsdp_size/--tp_size)")
    if not args.random_weights and not args.ckpt_dir:
        p.error("--ckpt_dir is required without --random_weights")
    if args.vlm_fsdp < 1:
        p.error("--vlm_fsdp must be ≥ 1")
    if args.vlm_fsdp > 1 and not args.vlm_path:
        p.error("--vlm_fsdp splits the VLM of --vlm_path: give --vlm_path")
    return args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def read_clip(path: str, frame_num: int, size, target_fps: float, device="cuda",
              timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """A source clip file → [3, frame_num, H, W] f32 in [-1, 1] on `device`
    (size = (W, H)): every round(fps / target_fps)-th frame, the last one
    repeated to fill, resized to cover the size and center-cropped.
    `timings` gets "read_s" and "transform_s"."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    frames, fps = read_video_frames(path)
    t1 = time.perf_counter()
    clip = sample_and_transform_frames(frames, frame_num, size, fps, target_fps, dev)
    _sync(dev)
    if timings is not None:
        timings.update(read_s=t1 - t0, transform_s=time.perf_counter() - t1)
    return clip


def vlm_stage(args, rows: List[dict], ids: List[str], device: torch.device,
              shard=None) -> Dict[str, dict]:
    """The Qwen3-VL engine over every row (source caption, target caption,
    features), then freed: {id: {"ar_vision_input": [L, D] f32 on the host,
    "target_caption", "timings"}}. `shard`: this rank's split of the
    expert banks (`--vlm_fsdp`)."""
    engine = Qwen3VLEngine(VLMConfig(model_path=args.vlm_path, backend=args.vlm_backend,
                                     fsdp=args.vlm_fsdp, device=str(device)), shard=shard)
    out, feats = {}, None
    for sample_id, row in zip(ids, rows):
        engine.timings.clear()
        feats = engine.generate_caption_and_extract_features(
            row.get("source_clip_path"), row.get("prompt", row.get("edit_prompt", "")))
        out[sample_id] = {"ar_vision_input": feats["vlm_last_hidden_states"].cpu(),
                          "target_caption": feats["target_caption"],
                          "timings": dict(engine.timings)}
        logging.info("sample %s target caption: %.120s", sample_id, feats["target_caption"])
    del engine, feats
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


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


def run(args: argparse.Namespace) -> List[dict]:
    """Generate this run's rows of `args.input`; returns, per row, {"id",
    "path" (the file written, rank 0 only), "timings", "latents" (on the
    host)}."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    sp = mesh = shard = None
    n = args.fsdp_size * args.sp_size * args.tp_size
    joined = False  # whether this run started the process group (and so ends it)
    if (n > 1 or args.vlm_fsdp > 1) and not dist.is_initialized():
        joined = maybe_initialize_distributed(args.coordinator, args.num_processes,
                                              args.process_id, device=args.device)
    if args.vlm_fsdp > 1:  # every refusal before any weight is read
        text = qwen3vl_config_from_hf(load_hf_config(args.vlm_path)).text
        shard = vlm_shard(VLMConfig(fsdp=args.vlm_fsdp), text)
    if n > 1:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != n:
            raise ValueError(f"--fsdp_size {args.fsdp_size} --sp_size {args.sp_size} --tp_size "
                             f"{args.tp_size} needs {n} processes, one per card (torchrun "
                             f"--nproc_per_node {n}); this run has {world}")
        mesh = create_mesh(1, args.fsdp_size, args.sp_size, args.tp_size, device=args.device)
        if args.sp_size > 1:
            sp = SPConfig(mesh, args.sp_mode, ring_impl=args.ring_impl)
        elif args.tp_size > 1:
            sp = SPConfig(mesh, "tp")
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    dp_rank = args.dp_rank if args.dp_rank is not None else axis_index(mesh, "data")
    dp_world = args.dp_world_size if args.dp_world_size is not None else axis_size(mesh, "data")
    device = resolve_device(args.device)
    cfg = WAN_CONFIGS[args.task]
    if args.max_context_len:
        cfg = cfg.replace(max_context_len=args.max_context_len)
    if args.tiny:
        cfg = cfg.replace(
            dit=cfg.dit.replace(dim=256, ffn_dim=512, num_heads=2, num_layers=2, freq_dim=32,
                                text_dim=48),
            vae=cfg.vae.__class__(dim=8, z_dim=16, num_res_blocks=1),
            t5=T5Config(vocab_size=256, dim=48, dim_attn=48, dim_ffn=96, num_heads=4,
                        num_layers=2), max_context_len=64)
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
    rows = [json.loads(line) for line in Path(args.input).read_text().splitlines()
            if line.strip()]
    ids = [Path(str(row.get("sample_id", row.get("id", i)))).name for i, row in enumerate(rows)]
    # this run's rows, with their indices in the file (the seed is base_seed + index)
    mine = [i for i in range(len(rows)) if i % dp_world == dp_rank]
    rows, ids = [rows[i] for i in mine], [ids[i] for i in mine]
    vlm = vlm_stage(args, rows, ids, device, shard) if args.vlm_path else {}

    impl = dict(qk_impl=args.qk_impl, ew_impl=args.ew_impl, residual_dtype=args.residual_dtype,
                sp=sp)
    if args.layer_stream:
        impl.update(layer_stream=True, stream_quant=args.stream_quant,
                    stream_group=args.stream_group)
    dit_shard = mesh if args.fsdp_size > 1 or args.tp_size > 1 else None
    adapters = load_adapters_npz(args.lora_adapters) if args.lora_adapters else None
    if args.random_weights:
        pipe = OmniVideoX2XUnified.random_init(cfg, device=device, **impl)
        if adapters is not None:
            for expert in {id(e): e for e in (pipe.low_noise, pipe.high_noise)}.values():
                merge_adapters(expert.wan, adapters)
        if dit_shard is not None:
            pipe.shard(dit_shard)
    else:
        pipe = load_pipeline(cfg, args.ckpt_dir, dtype=cfg.torch_param_dtype, device=device,
                             mesh=dit_shard, adapters=adapters, **impl)
    if adapters is not None:
        logging.info("LoRA adapters merged from %s (%d sites)", args.lora_adapters,
                     len(adapters))
    out_dir = Path(args.output_dir)
    if rank0:
        out_dir.mkdir(parents=True, exist_ok=True)

    # denoise every row, then (dual expert) free the experts, then decode
    done = []
    for idx, sample_id, row in zip(mine, ids, rows):
        prompt = row.get("prompt", row.get("edit_prompt", ""))
        timings: Dict[str, float] = {}
        if sample_id in vlm:
            v = vlm[sample_id]
            feats = {"ar_vision_input": v["ar_vision_input"], "target_caption": v["target_caption"]}
            timings.update(v["timings"])
        else:
            feats = _features(args.features_dir, sample_id)
        if "target_caption" in feats:
            prompt = (feats.pop("target_caption") + " " + prompt).strip()
        visual_emb = None
        if "source_clip_path" in row and pipe.vae is not None:
            clip = read_clip(row["source_clip_path"], frame_num, size, cfg.sample_fps, device,
                             timings)
            t0 = time.perf_counter()
            lat_f = (frame_num - 1) // cfg.vae.vae_stride[0] + 1
            visual_emb = pipe.vae.encode(clip[None])[0][:, :lat_f]
            _sync(device)
            timings["encode_s"] = time.perf_counter() - t0
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
        timings.update(pipe.timings)
        done.append((sample_id, latents.cpu(), timings))
        logging.info("sample %s denoised (%.2f s/step)", sample_id, pipe.timings["denoise_step_s"])
    if cfg.dual_expert:
        pipe.free_experts()
    results = []
    for sample_id, latents, timings in done:
        frames = pipe.decode(latents, output_uint8=True,  # every rank decodes
                             vae_dtype=getattr(torch, args.vae_dtype or "float32"))
        timings["decode_s"] = pipe.timings["decode_s"]
        path = None
        if rank0:
            t0 = time.perf_counter()
            if frame_num == 1:
                path = save_image(str(out_dir / f"{sample_id}.png"), frames[0])
            else:
                path = save_video(str(out_dir / f"{sample_id}.mp4"), frames,
                                  fps=args.fps or cfg.sample_fps)
            timings["save_s"] = time.perf_counter() - t0
            logging.info("sample %s -> %s %s", sample_id, path, json.dumps(timings))
        results.append({"id": sample_id, "path": path, "timings": timings, "latents": latents})
    if joined:
        dist.destroy_process_group()
    return results


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
