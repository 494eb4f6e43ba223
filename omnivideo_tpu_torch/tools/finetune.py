"""Flow-matching fine-tuning CLI (port of tools/finetune.py).

Per-task datasets of precomputed features, a round-robin loop in which every
task takes one train step per step (its loss weighted in the log), the
unified train step (training/trainer.py: flow-matching loss, CFG dropout,
AdamW or `--optimizer adafactor` with warmup-cosine, clipping, freezing,
accumulation, per-block remat), checkpoints every `--save_interval` steps
and at the end, `--resume` from the latest (the data and the draws continue
where they stopped, so a resumed run takes the steps an uninterrupted one
would), metrics in `<output_dir>/metrics.jsonl`, and a checkpoint-and-exit
on SIGTERM or before `--walltime`. `--config run.yaml` sets flags from a
YAML file (flags typed on the command line win; utils/run_config.py), and
the merged flags are written to `<output_dir>/run_config.yaml`.

`--lora_rank r` trains LoRA adapters (training/lora.py) on the DiT's
`--lora_targets` (default: attention and FFN projections) with the base
frozen; `--lora_adapter_export` writes the adapters (generate
`--lora_adapters` reads them, as does JAX's), `--lora_export` the merged
DiT params under their JAX paths.

    python -m omnivideo_tpu_torch.tools.finetune --dummy_data --tiny --total_steps 3 --device cpu

The device defaults to cuda (kernels); `--device cpu` runs the plain twins.

`--dp/--fsdp/--sp/--tp` train on a (data, fsdp, seq, tensor) mesh of one
process per card, started by torchrun or by the
`--coordinator/--num_processes/--process_id` flags (NCCL on the card, gloo
with `--device cpu`):

    torchrun --nproc_per_node 4 -m omnivideo_tpu_torch.tools.finetune --dummy_data \
        --fsdp 2 --sp 2 --total_steps 3 --output_dir outputs/ft

`--batch_size` is the global batch: it splits over `--dp` (each data index
reads its own rows). `--fsdp` shards the parameters (FSDP2, parallel/
sharding.py), `--tp` splits heads and FFN columns (Megatron), `--sp` runs
Ulysses when the heads divide by it, else the ring (JAX's CLI has no mode
flag; its GSPMD sequence sharding gives the same values); `--sp` and `--tp`
exclude each other, as in JAX's SPConfig. The numbers are one process's
(training/trainer.py). Only rank 0 writes metrics, logs and the run config;
checkpoints hold the full state and resume under any mesh. `--task` takes
the text-to-video configs of `configs.WAN_CONFIGS`; a dual-expert task
(t2v-A14B) trains its low-noise expert, as the JAX CLI loads it. i2v-14B is
refused: the step feeds its DiT neither the first-frame latents `y` nor the
CLIP tokens `clip_fea` (JAX's finetune cannot train it either).

`--layer_stream` trains on one card with the DiT's blocks, their gradients
and their optimizer state in page-locked host memory, streamed through the
card (training/streaming.py; the plain flow-matching loss over the DiT and
one dataset, as JAX's CLI runs it); with `--lora_rank` only the frozen base
streams and the adapters train on the card. `--stream_quant int8` streams
int8 copies of the blocks (with `--lora_rank`, of the frozen base):

    python -m omnivideo_tpu_torch.tools.finetune --dummy_data --tiny --layer_stream \
        --lora_rank 4 --stream_quant int8 --total_steps 3 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

from omnivideo_tpu_torch.configs import WAN_CONFIGS
from omnivideo_tpu_torch.configs.base import PipelineConfig
from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.io.jax_bridge import wan_state_dict_to_jax
from omnivideo_tpu_torch.models.unified import Companions, init_unified_companions
from omnivideo_tpu_torch.models.wan_dit import SPConfig
from omnivideo_tpu_torch.parallel.distributed import (
    add_distributed_args,
    maybe_initialize_distributed,
)
from omnivideo_tpu_torch.parallel.mesh import axis_index, create_mesh
from omnivideo_tpu_torch.parallel.sharding import shard_params
from omnivideo_tpu_torch.pipelines.loading import load_expert
from omnivideo_tpu_torch.pipelines.streaming import random_streamed_dit
from omnivideo_tpu_torch.training.checkpoint import CheckpointManager
from omnivideo_tpu_torch.training.dataset import (
    OmniVideoDataset,
    PadSpec,
    PrefetchLoader,
    data_loader,
    make_dummy_dataset,
)
from omnivideo_tpu_torch.training.lora import (
    DEFAULT_TARGETS,
    LORA_FILTERS,
    count_lora_params,
    draw_lora,
    extract_lora,
    freeze_base,
    inject_lora,
    merge_lora_state_dict,
    write_adapters_npz,
)
from omnivideo_tpu_torch.training.streaming import StreamedLoRATrainer, StreamedTrainer
from omnivideo_tpu_torch.training.trainer import (
    TrainConfig,
    UnifiedParams,
    init_train_state,
    init_unified_params,
    make_optimizer,
    make_unified_train_step,
)
from omnivideo_tpu_torch.utils.observability import (
    MetricsLogger,
    PreemptionGuard,
    TimeoutGuard,
)
from omnivideo_tpu_torch.utils.run_config import apply_yaml_config, dump_run_config

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None,
                   help="YAML run config: flag names as keys; flags typed here win")
    p.add_argument("--task", default="t2v-1.3B", choices=sorted(WAN_CONFIGS))
    p.add_argument("--data_dirs", nargs="*", default=[],
                   help="task=path pairs, e.g. t2v=/data/t2v i2i=/data/i2i")
    p.add_argument("--task_weights", nargs="*", default=[], help="task=weight pairs")
    p.add_argument("--output_dir", default="outputs/finetune")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--total_steps", type=int, default=1000)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=3e-6)
    p.add_argument("--grad_clip", type=float, default=0.1)
    p.add_argument("--grad_accum_steps", type=int, default=1)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    p.add_argument("--carry_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--timestep_sampling", default="uniform",
                   choices=["uniform", "logit_normal", "mode"])
    p.add_argument("--logit_mean", type=float, default=0.0)
    p.add_argument("--logit_std", type=float, default=1.0)
    p.add_argument("--flow_shift", type=float, default=3.0)
    p.add_argument("--cfg_dropout", type=float, default=0.2)
    p.add_argument("--save_interval", type=int, default=500)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trainable", nargs="*", default=[],
                   help="JAX param-path substrings to train (empty = all); e.g. wan companions")
    p.add_argument("--lora_rank", type=int, default=0,
                   help="LoRA rank over the DiT's projections (0: full finetune); trains only "
                        "the adapters")
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="scale = alpha/rank (default: rank)")
    p.add_argument("--lora_targets", nargs="*", default=None,
                   help="dense-site path substrings to adapt (default: attention + ffn)")
    p.add_argument("--lora_export", default=None,
                   help="after training, the LoRA-merged DiT params (JAX paths) to this .npz")
    p.add_argument("--lora_adapter_export", default=None,
                   help="after training, the adapters alone to this .npz (generate "
                        "--lora_adapters reads it)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel degree ('data')")
    p.add_argument("--fsdp", type=int, default=1, help="parameter-sharding degree ('fsdp')")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel degree ('seq')")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel degree ('tensor')")
    p.add_argument("--ckpt_dir", default=None,
                   help="start from <ckpt_dir>/<low_noise_checkpoint>/model.pt (reference layout)")
    p.add_argument("--walltime", type=float, default=None,
                   help="seconds; stop and checkpoint before this walltime")
    p.add_argument("--layer_stream", action="store_true",
                   help="one card, the DiT's blocks (and their grads and optimizer state) in "
                        "host memory, streamed through it")
    p.add_argument("--stream_quant", default=None, choices=[None, "int8"],
                   help="with --layer_stream: int8 streamed blocks (LoRA: the frozen base)")
    p.add_argument("--dummy_data", action="store_true")
    p.add_argument("--with_aligned", action="store_true",
                   help="dummy data includes v1 aligned_emb features")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    add_distributed_args(p)
    args = apply_yaml_config(p.parse_args(argv), p, argv)
    if WAN_CONFIGS[args.task].dit.model_type == "i2v":
        p.error(f"--task {args.task}: an i2v model is not trained here; the step feeds its DiT "
                "neither the first-frame latents y nor the CLIP tokens clip_fea (JAX's finetune "
                "cannot train i2v either)")
    if args.stream_quant and not args.layer_stream:
        p.error("--stream_quant requires --layer_stream")
    if args.layer_stream:
        if args.dp * args.fsdp * args.sp * args.tp > 1:
            p.error("--layer_stream is the single-device path (no --dp/--fsdp/--sp/--tp)")
        if len(args.data_dirs) > 1:
            p.error("--layer_stream trains one dataset (the plain flow-matching loss)")
        if args.trainable:
            p.error("--layer_stream trains every DiT parameter, or with --lora_rank the "
                    "adapters; --trainable does not apply")
        if args.grad_accum_steps != 1:
            p.error("--layer_stream takes one micro-batch a step (--grad_accum_steps 1)")
    if args.sp > 1 and args.tp > 1:
        p.error("--sp and --tp exclude each other (one SPConfig mode)")
    if args.batch_size % args.dp:
        p.error(f"--batch_size {args.batch_size} (the global batch) must divide by --dp {args.dp}")
    return args


def setup_mesh(args: argparse.Namespace):
    """(mesh, SPConfig or None) of `--dp/--fsdp/--sp/--tp`, or (None, None)
    for one process. Joins the process group first unless one is running."""
    n = args.dp * args.fsdp * args.sp * args.tp
    if n == 1:
        return None, None
    if not dist.is_initialized():
        maybe_initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                     device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"--dp {args.dp} --fsdp {args.fsdp} --sp {args.sp} --tp {args.tp} needs "
                         f"{n} processes, one per card (torchrun --nproc_per_node {n}); this run "
                         f"has {world}")
    mesh = create_mesh(args.dp, args.fsdp, args.sp, args.tp, device=args.device)
    sp = None
    if args.sp > 1:
        heads = task_config(args).dit.num_heads
        sp = SPConfig(mesh, "ulysses" if heads % args.sp == 0 else "ring")
    elif args.tp > 1:
        sp = SPConfig(mesh, "tp")
    return mesh, sp


def task_config(args: argparse.Namespace) -> PipelineConfig:
    cfg = WAN_CONFIGS[args.task]
    if args.tiny:
        cfg = cfg.replace(
            dit=cfg.dit.replace(dim=64, ffn_dim=128, num_heads=4, num_layers=2, freq_dim=32,
                                text_dim=48),
            max_context_len=64, vlm_in_dim=16)
    return cfg


def initial_params(cfg: PipelineConfig, args: argparse.Namespace, device) -> UnifiedParams:
    """The f32 master params a run starts from: the low-noise expert of
    `--ckpt_dir` (companions the checkpoint lacks are initialised from the
    seed, as the JAX CLI does), else the seeded init."""
    if args.ckpt_dir is None:
        return init_unified_params(cfg, seed=args.seed, device=device)
    expert = load_expert(cfg, args.ckpt_dir, cfg.low_noise_checkpoint, torch.float32, device)
    companions = expert.companions or init_unified_companions(
        cfg, device=device, generator=torch.Generator(device=device).manual_seed(args.seed))
    return UnifiedParams(expert.wan, Companions(companions))


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh, sp = setup_mesh(args)
    rank0 = mesh is None or dist.get_rank() == 0
    logging.basicConfig(level=logging.INFO if rank0 else logging.WARNING,
                        format="%(asctime)s %(message)s")
    device = resolve_device(args.device)
    out = Path(args.output_dir)
    if rank0:
        dump_run_config(args, out)  # provenance: what this run ran with
    cfg = task_config(args)

    tc = TrainConfig(
        learning_rate=args.lr, grad_clip=args.grad_clip, warmup_steps=args.warmup_steps,
        total_steps=args.total_steps, flow_shift=args.flow_shift,
        cfg_dropout=args.cfg_dropout, trainable_filters=tuple(args.trainable),
        grad_accum_steps=args.grad_accum_steps, optimizer=args.optimizer,
        carry_dtype=args.carry_dtype, timestep_sampling=args.timestep_sampling,
        logit_mean=args.logit_mean, logit_std=args.logit_std)

    # ---- data: per-task loaders, round-robin --------------------------------
    pad = PadSpec(text_len=min(64, cfg.max_context_len) if args.tiny else 512,
                  vlm_len=16 if args.tiny else 512,
                  latent_frames=3 if args.tiny else 21,
                  aligned_len=8 if args.tiny else 256)
    tasks = {}
    if args.dummy_data:
        root = out / "dummy_data"
        if rank0:
            make_dummy_dataset(root, n=8, text_len=8, vlm_len=6,
                               latent_shape=(cfg.dit.in_dim, 3, 8, 8),
                               text_dim=cfg.dit.text_dim, vlm_dim=cfg.vlm_in_dim,
                               with_aligned=args.with_aligned)
        if mesh is not None:
            dist.barrier()
        tasks["t2v"] = (OmniVideoDataset(str(root)), 1.0)
    else:
        weights = dict(w.split("=") for w in args.task_weights)
        for spec in args.data_dirs:
            name, path = spec.split("=")
            tasks[name] = (OmniVideoDataset(path), float(weights.get(name, 1.0)))
    if not tasks:
        raise SystemExit("no datasets configured (--dummy_data or --data_dirs)")

    if args.layer_stream:
        return _main_streamed(args, cfg, tc, tasks, pad, device, out)

    # ---- params, optimizer, step ---------------------------------------------
    params = initial_params(cfg, args, device)
    if args.lora_rank > 0:
        targets = tuple(args.lora_targets) if args.lora_targets else DEFAULT_TARGETS
        inject_lora(params.wan, args.lora_rank, alpha=args.lora_alpha, targets=targets,
                    generator=torch.Generator(device=device).manual_seed(args.seed + 7))
        tc = dataclasses.replace(tc, trainable_filters=LORA_FILTERS)
        logging.info("LoRA rank %d over %s: %d adapter params trainable", args.lora_rank,
                     ",".join(targets), count_lora_params(params.wan))
    if mesh is not None and (args.fsdp > 1 or args.tp > 1):
        shard_params(params, mesh)
    if args.lora_rank > 0:
        freeze_base(params)  # after sharding, which makes new parameters
    tx = make_optimizer(tc, params)
    state = init_train_state(params, tx)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    train_step = make_unified_train_step(cfg, tc, tx, generator=gen, mesh=mesh, sp=sp)

    ckpt = CheckpointManager(str(out / "checkpoints"))
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        logging.info("resumed from step %d", state.step)

    # each data index reads its own rows of the global batch; a resumed run
    # skips the batches its steps took (one per task per step)
    loaders = {name: PrefetchLoader(data_loader(ds, args.batch_size // args.dp, pad,
                                                seed=args.seed,
                                                host_id=axis_index(mesh, "data"),
                                                num_hosts=args.dp,
                                                start=state.step // len(tasks)))
               for name, (ds, _) in tasks.items()}
    task_w = {name: w for name, (_, w) in tasks.items()}
    metrics = MetricsLogger(str(out)) if rank0 else None
    preempt = PreemptionGuard()
    timeout = TimeoutGuard(args.walltime)

    def should_stop() -> bool:  # every process stops at the same step
        stop = preempt.should_stop() or timeout.should_stop()
        if mesh is None:
            return stop
        flag = torch.tensor([int(stop)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    step = state.step
    t0 = time.time()
    while step < args.total_steps:
        if should_stop():
            ckpt.save(step, state, {"step": step, "preempted": True})
            logging.warning("preemption/walltime stop at step %d (checkpointed)", step)
            return 0
        losses = {}
        for name, loader in loaders.items():
            batch = {k: torch.from_numpy(v) for k, v in next(loader).items()}
            gen.manual_seed(args.seed + 1 + state.step)  # the step's draws, resumed or not
            state, m = train_step(state, batch)
            losses[name] = float(m["loss"]) * task_w[name]
        step = state.step
        if rank0 and (step % args.log_interval == 0 or step == args.total_steps):
            metrics.log(step, **{f"loss/{k}": v for k, v in losses.items()})
            logging.info("step %d (%.1fs) %s", step, time.time() - t0, losses)
        if step % args.save_interval == 0 or step == args.total_steps:
            ckpt.save(step, state, {"step": step})
            logging.info("saved checkpoint at step %d", step)
    if rank0:
        metrics.close()
    if args.lora_rank > 0:
        export_lora(args, params.wan, rank0)
    logging.info("done at step %d", step)
    return 0


def streamed_dit(cfg: PipelineConfig, args: argparse.Namespace, device):
    """The f32 master DiT of a --layer_stream run with its blocks in host
    memory: the low-noise expert of `--ckpt_dir` (read straight to host),
    else the seeded init's DiT (init_unified_params' draws)."""
    if args.ckpt_dir is not None:
        return load_expert(cfg, args.ckpt_dir, cfg.low_noise_checkpoint, torch.float32, device,
                           layer_stream=True).wan
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return random_streamed_dit(cfg.dit.replace(text_len=cfg.max_context_len), torch.float32,
                               device, gen)


def _main_streamed(args, cfg, tc, tasks, pad, device, out: Path) -> int:
    """The --layer_stream loop: one dataset, the streamed trainer's step
    (training/streaming.py), checkpoints, resume and the LoRA exports."""
    (name, (ds, _)), = tasks.items()
    wan = streamed_dit(cfg, args, device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    if args.lora_rank > 0:
        targets = tuple(args.lora_targets) if args.lora_targets else DEFAULT_TARGETS
        adapters = draw_lora(wan, args.lora_rank, alpha=args.lora_alpha, targets=targets,
                             generator=torch.Generator(device=device).manual_seed(args.seed + 7))
        trainer = StreamedLoRATrainer(cfg, tc, device=device, base_quant=args.stream_quant,
                                      generator=gen)
        state = trainer.init_state(wan, adapters)
        logging.info("streamed LoRA rank %d over %s: %d adapter params trainable",
                     args.lora_rank, ",".join(targets),
                     sum(v.numel() for v in state.lora.values()))
    else:
        trainer = StreamedTrainer(cfg, tc, device=device, stream_quant=args.stream_quant,
                                  generator=gen)
        state = trainer.init_state(wan)
    ckpt = CheckpointManager(str(out / "checkpoints"))
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        logging.info("resumed from step %d", state.step)
    loader = PrefetchLoader(data_loader(ds, args.batch_size, pad, seed=args.seed,
                                        start=state.step))
    metrics = MetricsLogger(str(out))
    preempt, timeout = PreemptionGuard(), TimeoutGuard(args.walltime)
    t0 = time.time()
    while state.step < args.total_steps:
        if preempt.should_stop() or timeout.should_stop():
            ckpt.save(state.step, state, {"step": state.step, "preempted": True})
            logging.warning("preemption/walltime stop at step %d (checkpointed)", state.step)
            return 0
        batch = {k: torch.from_numpy(v) for k, v in next(loader).items()}
        gen.manual_seed(args.seed + 1 + state.step)  # the step's draws, resumed or not
        state, m = trainer.train_step(state, batch)
        step = state.step
        if step % args.log_interval == 0 or step == args.total_steps:
            metrics.log(step, **{f"loss/{name}": float(m["loss"])})
            logging.info("step %d (%.1fs) loss %.6f grad_norm %.6f", step, time.time() - t0,
                         float(m["loss"]), float(m["grad_norm"]))
        if step % args.save_interval == 0 or step == args.total_steps:
            ckpt.save(step, state, {"step": step})
            logging.info("saved checkpoint at step %d", step)
    metrics.close()
    if args.lora_rank > 0 and args.lora_adapter_export:
        Path(args.lora_adapter_export).parent.mkdir(parents=True, exist_ok=True)
        n = write_adapters_npz(trainer.export_adapters(state), args.lora_adapter_export)
        logging.info("LoRA adapters exported to %s (%d arrays)", args.lora_adapter_export, n)
    if args.lora_rank > 0 and args.lora_export:
        flat = wan_state_dict_to_jax(merge_lora_state_dict(trainer.export_params(state)))
        Path(args.lora_export).parent.mkdir(parents=True, exist_ok=True)
        np.savez(args.lora_export, **flat)
        logging.info("LoRA-merged wan params exported to %s (%d arrays)", args.lora_export,
                     len(flat))
    logging.info("done at step %d", state.step)
    return 0


def export_lora(args: argparse.Namespace, wan, rank0: bool) -> None:
    """--lora_adapter_export: the adapters alone (JAX's `save_adapters_npz`
    format); --lora_export: the merged DiT params under their JAX paths
    (the JAX CLI's file). Every process joins the gathers; rank 0 writes."""
    if args.lora_adapter_export:
        state = extract_lora(wan)
        if rank0:
            Path(args.lora_adapter_export).parent.mkdir(parents=True, exist_ok=True)
            n = write_adapters_npz(state, args.lora_adapter_export)
            logging.info("LoRA adapters exported to %s (%d arrays)", args.lora_adapter_export, n)
    if args.lora_export:
        sd = get_model_state_dict(wan, options=StateDictOptions(full_state_dict=True,
                                                                cpu_offload=True))
        if rank0:
            flat = wan_state_dict_to_jax(merge_lora_state_dict(sd))
            Path(args.lora_export).parent.mkdir(parents=True, exist_ok=True)
            np.savez(args.lora_export, **flat)
            logging.info("LoRA-merged wan params exported to %s (%d arrays)", args.lora_export,
                         len(flat))


if __name__ == "__main__":
    raise SystemExit(main())
