"""Supervised fine-tuning CLI of the VLM's language model (port of
tools/sft_vlm.py): the LM loss, plus the vision-head/adapter alignment loss
with `--align_weight` (training/sft.py, training/align.py).

Data: `--data_dir`, a directory of per-sample .npz files with `ids` and
`labels` or `prompt_len` (tools/data_prepare/sft_tokenize.py writes it);
`--conversations`, chat transcripts in JSON/JSONL tokenized on the fly
through `--tokenizer_path`'s tokenizer.json (io/hf_reader.py
`FastTokenizer`; ChatML unless the tokenizer brings a template), several
files mixed by `--mixture_weights`, ordered by `--group_by_length` /
`--group_by_modality_length`; or `--dummy_data`, a seeded batch per step.
The model: `--model_path`, an HF Qwen3 (or Qwen3-VL: its text stack) dir
read in f32 as JAX reads it, else the `--tiny` config, seeded. `--lora_rank`
trains bare LoRA adapters on the LM's q/k/v/o and dense MLP projections
(training/lora.py; the base frozen, the alignment chain still trained).
Checkpoints go to `<output_dir>/checkpoints` every `--save_interval` steps
and at the end; a run resumes from the latest one there, its data and
draws continuing where they stopped (JAX's CLI restarts its loader), so 2 +
2 steps equal 4. Metrics: `<output_dir>/metrics.jsonl`; the merged flags:
`<output_dir>/run_config.yaml` (`--config run.yaml` sets flags from a
YAML file, flags typed here win).

    python -m omnivideo_tpu_torch.tools.sft_vlm --dummy_data --tiny --total_steps 4 --device cpu

The device defaults to cuda; `--device cpu` runs the plain twins (JAX's
`--platform`). `--dp/--fsdp/--sp/--tp` train on a (data, fsdp, seq,
tensor) mesh of one process per card (torchrun, or the
`--coordinator/--num_processes/--process_id` flags; NCCL on the card, gloo
with `--device cpu`). `--batch_size` is the global batch, split over
`--dp`; `--fsdp` shards the LM per decoder layer (FSDP2); `--sp` runs the
LM forward sequence-parallel (the token-causal ring: the batch's padding
sits at its tail, and `--seq_len` must divide by `--sp`); `--tp` leaves
the LM whole on every rank, as JAX's TP rule does for the Qwen3 tree.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from omnivideo_tpu_torch.configs.qwen3vl import Qwen3TextConfig
from omnivideo_tpu_torch.device import resolve_device
from omnivideo_tpu_torch.models.adapters import init_dm_adapter, init_vision_head
from omnivideo_tpu_torch.models.qwen3vl.text_model import Qwen3LM
from omnivideo_tpu_torch.parallel.distributed import (
    add_distributed_args,
    maybe_initialize_distributed,
)
from omnivideo_tpu_torch.parallel.mesh import create_mesh
from omnivideo_tpu_torch.parallel.sharding import shard_params
from omnivideo_tpu_torch.training.align import AlignChain
from omnivideo_tpu_torch.training.checkpoint import CheckpointManager
from omnivideo_tpu_torch.training.lora import count_lora_params, freeze_base, inject_lora_bare
from omnivideo_tpu_torch.training.sft import (
    MixtureDataset,
    SFTConfig,
    SFTDataset,
    SFTParams,
    build_sft_labels,
    init_sft_state,
    make_sft_optimizer,
    make_sft_step,
    sft_data_loader,
)
from omnivideo_tpu_torch.utils.run_config import apply_yaml_config, dump_run_config

log = logging.getLogger("sft_vlm")

DUMMY_VLM_LEN, CHAIN_QUERIES, CHAIN_OUT = 8, 4, 32  # the tiny alignment chain's batch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None,
                   help="YAML run config: flag names as keys; flags typed here win")
    p.add_argument("--model_path", default=None, help="HF Qwen3 checkpoint dir")
    p.add_argument("--data_dir", default=None, help="per-sample .npz SFT files")
    p.add_argument("--conversations", nargs="*", default=None,
                   help="conversation JSON/JSONL files (per-turn loss masks); several form a "
                        "weighted mixture (--mixture_weights)")
    p.add_argument("--mixture_weights", nargs="*", type=float, default=None,
                   help="per-source sampling ratios (>1 repeats, <1 subsamples; default 1.0)")
    p.add_argument("--tokenizer_path", default=None,
                   help="tokenizer dir for --conversations (default: --model_path)")
    p.add_argument("--group_by_length", action="store_true",
                   help="length-grouped batch ordering")
    p.add_argument("--group_by_modality_length", action="store_true",
                   help="length-grouped, multimodal and text-only batches kept apart")
    p.add_argument("--output_dir", default="outputs/sft_vlm")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--total_steps", type=int, default=1000)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--lora_rank", type=int, default=0,
                   help="LoRA rank over the LM's q/k/v/o and dense MLP projections (0: full "
                        "finetune); trains only the adapters (and the chain)")
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="scale = alpha/rank (default: rank)")
    p.add_argument("--align_weight", type=float, default=0.0,
                   help=">0 trains the vision-head/adapter chain too")
    p.add_argument("--cosine_weight", type=float, default=0.0)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--save_interval", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", type=int, default=1, help="data-parallel degree ('data')")
    p.add_argument("--fsdp", type=int, default=1, help="parameter-sharding degree ('fsdp')")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel degree ('tensor')")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree ('seq': the token-causal ring)")
    p.add_argument("--dummy_data", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    add_distributed_args(p)
    args = apply_yaml_config(p.parse_args(argv), p, argv)
    if args.batch_size % args.dp:
        p.error(f"--batch_size {args.batch_size} (the global batch) must divide by --dp {args.dp}")
    if args.conversations and not (args.tokenizer_path or args.model_path):
        p.error("--conversations needs --tokenizer_path or --model_path")
    return args


def tiny_config() -> Qwen3TextConfig:
    """JAX's `_tiny_cfg`, the config of every run without --model_path."""
    return Qwen3TextConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                           head_dim=16)


def tiny_chain(hidden: int, generator: torch.Generator, device) -> AlignChain:
    """JAX's tiny alignment chain: VisionHead hidden → 32 → 24 and DM_Adapter
    24 → 32 → 32, 4 queries, 1 + 1 layers each."""
    return AlignChain(
        init_vision_head(hidden, 32, 24, CHAIN_QUERIES, 1, generator=generator, device=device),
        init_dm_adapter(24, 32, CHAIN_OUT, CHAIN_QUERIES, 1, generator=generator, device=device))


def build_lm(args, device):
    """(config, f32 Qwen3LM): the --model_path checkpoint, else the tiny
    config with seeded N(0, 0.05²) weights (JAX's `_random_lm_params`
    distribution, torch's draws)."""
    if args.model_path:
        from omnivideo_tpu_torch.io.hf_reader import (
            iter_hf_safetensors,
            load_qwen3_hf,
            qwen3_text_config_from_hf,
        )

        cfg = qwen3_text_config_from_hf(args.model_path)
        lm = Qwen3LM(cfg, torch.float32, device)
        load_qwen3_hf(lm, iter_hf_safetensors(args.model_path, device=device))
        log.info("loaded HF checkpoint %s", args.model_path)
        return cfg, lm
    cfg = tiny_config()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, Qwen3LM(cfg, torch.float32, device, gen, init_std=0.05)


def dummy_batch(cfg: Qwen3TextConfig, args, step: int) -> Dict[str, torch.Tensor]:
    """The step's seeded batch (numpy, seeded by (seed + 1, step)): ids
    [B, min(seq_len, 32)], the first third masked as prompt; with
    --align_weight VLM features [B, 8, hidden] and targets [B, 4, 32]."""
    rng = np.random.default_rng((args.seed + 1, step))
    B, L = args.batch_size, min(args.seq_len, 32)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32))
    batch = {"ids": ids, "labels": build_sft_labels(ids, torch.full((B,), L // 3))}
    if args.align_weight > 0:
        batch["vlm"] = torch.from_numpy(
            rng.standard_normal((B, DUMMY_VLM_LEN, cfg.hidden_size)).astype(np.float32))
        batch["target"] = torch.from_numpy(
            (0.1 * rng.standard_normal((B, CHAIN_QUERIES, CHAIN_OUT))).astype(np.float32))
    return batch


def setup_mesh(args):
    """The (data, fsdp, seq, tensor) mesh of --dp/--fsdp/--sp/--tp, or None
    for one process (joining the process group first unless one runs)."""
    n = args.dp * args.fsdp * args.sp * args.tp
    if n == 1:
        return None
    if not dist.is_initialized():
        maybe_initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                     device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"--dp {args.dp} --fsdp {args.fsdp} --sp {args.sp} --tp {args.tp} needs "
                         f"{n} processes, one per card; this run has {world}")
    return create_mesh(args.dp, args.fsdp, args.sp, args.tp, device=args.device)


def make_loader(args, start: int):
    """The batch iterator of --conversations / --data_dir (None with neither),
    advanced past the `start` batches a resumed run has taken."""
    if args.conversations:
        from omnivideo_tpu_torch.io.hf_reader import FastTokenizer
        from omnivideo_tpu_torch.training.conversation import ConversationDataset

        tok = FastTokenizer(args.tokenizer_path or args.model_path)
        srcs = [ConversationDataset(p, tok) for p in args.conversations]
        ds = (srcs[0] if len(srcs) == 1 and not args.mixture_weights
              else MixtureDataset(srcs, args.mixture_weights, seed=args.seed))
        loader = sft_data_loader(ds, args.batch_size, args.seq_len, seed=args.seed,
                                 group_by_length=args.group_by_length,
                                 group_by_modality=args.group_by_modality_length,
                                 world_size=max(args.dp, 1))
    elif args.data_dir:
        loader = sft_data_loader(SFTDataset(args.data_dir), args.batch_size, args.seq_len,
                                 seed=args.seed)
    else:
        return None
    for _ in range(start):
        next(loader)
    return loader


def run(args) -> List[dict]:
    """The training loop; returns the metrics records it wrote."""
    mesh = setup_mesh(args)
    rank0 = mesh is None or dist.get_rank() == 0
    device = resolve_device(args.device)
    out = Path(args.output_dir)
    if rank0:
        dump_run_config(args, out)  # provenance: what this run ran with
    cfg, lm = build_lm(args, device)
    chain = None
    if args.align_weight > 0:
        chain = tiny_chain(cfg.hidden_size,
                           torch.Generator(device=device).manual_seed(args.seed + 99), device)
    params = SFTParams(lm, chain)
    if args.lora_rank > 0:
        inject_lora_bare(lm, args.lora_rank, alpha=args.lora_alpha,
                         generator=torch.Generator(device=device).manual_seed(args.seed + 7))
    if mesh is not None and args.fsdp > 1:
        shard_params(params, mesh)
    if args.lora_rank > 0:
        freeze_base(lm)  # after sharding, which makes new parameters; the chain trains on
        log.info("LoRA rank %d over the LM's q/k/v/o + dense MLP: %d adapter params trainable",
                 args.lora_rank, count_lora_params(lm))
    tc = SFTConfig(learning_rate=args.lr, max_grad_norm=args.grad_clip,
                   warmup_steps=args.warmup_steps, total_steps=args.total_steps,
                   align_weight=args.align_weight, cosine_weight=args.cosine_weight)
    tx = make_sft_optimizer(tc)
    state = init_sft_state(params, tx)
    step = make_sft_step(tc, tx, sp_mesh=mesh if args.sp > 1 else None, mesh=mesh)

    ckpt = CheckpointManager(str(out / "checkpoints"))
    if ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        log.info("resumed from step %d", state.step)
    loader = make_loader(args, state.step)
    records = []
    metrics_f = (out / "metrics.jsonl").open("a") if rank0 else None
    loss = float("nan")
    for i in range(state.step, args.total_steps):
        batch = next(loader) if loader is not None else dummy_batch(cfg, args, i)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        if i % args.log_interval == 0 or i == args.total_steps - 1:
            rec = {"step": i, "loss": loss, "lm_loss": float(m["lm_loss"]),
                   "grad_norm": float(m["grad_norm"]), "num_targets": float(m["num_targets"]),
                   "sec": round(time.perf_counter() - t0, 4)}
            if "align_loss" in m:
                rec["align_loss"] = float(m["align_loss"])
            records.append(rec)
            if rank0:
                log.info("%s", rec)
                metrics_f.write(json.dumps(rec) + "\n")
                metrics_f.flush()
        if args.save_interval and (i + 1) % args.save_interval == 0:
            ckpt.save(i + 1, state)
            log.info("saved checkpoint at step %d", i + 1)
    ckpt.save(state.step, state)
    if metrics_f is not None:
        metrics_f.close()
    log.info("done: %d steps, final loss %.4f", args.total_steps, loss)
    return records


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
