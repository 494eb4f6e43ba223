"""Single-card flow-matching fine-tuning CLI (port of tools/finetune.py).

Per-task datasets of precomputed features, a round-robin loop in which every
task takes one train step per step (its loss weighted in the log), the
unified train step (training/trainer.py: flow-matching loss, CFG dropout,
AdamW with warmup-cosine, clipping, freezing, accumulation, per-block
remat), checkpoints every `--save_interval` steps and at the end,
`--resume` from the latest, metrics in `<output_dir>/metrics.jsonl`, and a
checkpoint-and-exit on SIGTERM or before `--walltime`.

    python -m omnivideo_tpu_torch.tools.finetune --dummy_data --tiny --total_steps 3 --device cpu

The device defaults to cuda (kernels); `--device cpu` runs the plain twins.
Flags of the JAX CLI that this port does not run yet raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import torch

from omnivideo_tpu_torch.configs.base import T2V_1_3B, PipelineConfig
from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.models.unified import Companions, init_unified_companions
from omnivideo_tpu_torch.pipelines.loading import load_expert
from omnivideo_tpu_torch.training.checkpoint import CheckpointManager
from omnivideo_tpu_torch.training.dataset import (
    OmniVideoDataset,
    PadSpec,
    PrefetchLoader,
    data_loader,
    make_dummy_dataset,
)
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

CONFIGS = {"t2v-1.3B": T2V_1_3B}
# flag → (value meaning "off", the ROADMAP §1 item that brings it)
NOT_PORTED = {
    "config": (None, "§1 item 3: the YAML run config (utils/run_config.py)"),
    "lora_rank": (0, "§1 item 3: LoRA (training/lora.py)"),
    "lora_alpha": (None, "§1 item 3: LoRA (training/lora.py)"),
    "lora_targets": (None, "§1 item 3: LoRA (training/lora.py)"),
    "lora_export": (None, "§1 item 3: LoRA (training/lora.py)"),
    "lora_adapter_export": (None, "§1 item 3: LoRA (training/lora.py)"),
    "layer_stream": (False, "§1 item 6: the streamed trainers (training/streaming.py)"),
    "stream_quant": (None, "§1 item 6: the streamed trainers with ops/quant.py"),
    "optimizer": ("adamw", "§1 item 3: adafactor and _lr_scaled_decay"),
    "dp": (1, "§1 item 2: training under SP, FSDP2 and TP"),
    "fsdp": (1, "§1 item 2: training under SP, FSDP2 and TP"),
    "sp": (1, "§1 item 2: training under SP (the ring backward from rows 4 and 5)"),
    "tp": (1, "§1 item 2: training under SP, FSDP2 and TP"),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None, help="YAML training config (not ported)")
    p.add_argument("--task", default="t2v-1.3B", choices=sorted(CONFIGS))
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
    p.add_argument("--lora_rank", type=int, default=0)
    p.add_argument("--lora_alpha", type=float, default=None)
    p.add_argument("--lora_targets", nargs="*", default=None)
    p.add_argument("--lora_export", default=None)
    p.add_argument("--lora_adapter_export", default=None)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--ckpt_dir", default=None,
                   help="start from <ckpt_dir>/<low_noise_checkpoint>/model.pt (reference layout)")
    p.add_argument("--walltime", type=float, default=None,
                   help="seconds; stop and checkpoint before this walltime")
    p.add_argument("--layer_stream", action="store_true")
    p.add_argument("--stream_quant", default=None, choices=[None, "int8"])
    p.add_argument("--dummy_data", action="store_true")
    p.add_argument("--with_aligned", action="store_true",
                   help="dummy data includes v1 aligned_emb features")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for flag, (off, item) in NOT_PORTED.items():
        if getattr(args, flag) != off:
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP {item})")
    return args


def task_config(args: argparse.Namespace) -> PipelineConfig:
    cfg = CONFIGS[args.task]
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
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "run_config.json").write_text(json.dumps(vars(args), indent=1, sort_keys=True))
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
        root = make_dummy_dataset(out / "dummy_data", n=8, text_len=8, vlm_len=6,
                                  latent_shape=(cfg.dit.in_dim, 3, 8, 8),
                                  text_dim=cfg.dit.text_dim, vlm_dim=cfg.vlm_in_dim,
                                  with_aligned=args.with_aligned)
        tasks["t2v"] = (OmniVideoDataset(str(root)), 1.0)
    else:
        weights = dict(w.split("=") for w in args.task_weights)
        for spec in args.data_dirs:
            name, path = spec.split("=")
            tasks[name] = (OmniVideoDataset(path), float(weights.get(name, 1.0)))
    if not tasks:
        raise SystemExit("no datasets configured (--dummy_data or --data_dirs)")

    # ---- params, optimizer, step ---------------------------------------------
    params = initial_params(cfg, args, device)
    tx = make_optimizer(tc, params)
    state = init_train_state(params, tx)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    train_step = make_unified_train_step(cfg, tc, tx, generator=gen)

    ckpt = CheckpointManager(str(out / "checkpoints"))
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        logging.info("resumed from step %d", state.step)

    loaders = {name: PrefetchLoader(data_loader(ds, args.batch_size, pad, seed=args.seed))
               for name, (ds, _) in tasks.items()}
    task_w = {name: w for name, (_, w) in tasks.items()}
    metrics = MetricsLogger(str(out))
    preempt = PreemptionGuard()
    timeout = TimeoutGuard(args.walltime)

    step = state.step
    t0 = time.time()
    while step < args.total_steps:
        if preempt.should_stop() or timeout.should_stop():
            ckpt.save(step, state, {"step": step, "preempted": True})
            logging.warning("preemption/walltime stop at step %d (checkpointed)", step)
            return 0
        losses = {}
        for name, loader in loaders.items():
            batch = {k: torch.from_numpy(v) for k, v in next(loader).items()}
            state, m = train_step(state, batch)
            losses[name] = float(m["loss"]) * task_w[name]
        step = state.step
        if step % args.log_interval == 0 or step == args.total_steps:
            metrics.log(step, **{f"loss/{k}": v for k, v in losses.items()})
            logging.info("step %d (%.1fs) %s", step, time.time() - t0, losses)
        if step % args.save_interval == 0 or step == args.total_steps:
            ckpt.save(step, state, {"step": step})
            logging.info("saved checkpoint at step %d", step)
    metrics.close()
    logging.info("done at step %d", step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
