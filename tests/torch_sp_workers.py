"""Process-group workers for the port's sequence-parallel tests (CPU, gloo).

`spawn(fn, world, tmp)` starts `world` processes with
`torch.multiprocessing`, joins them into one gloo group through
`file://<tmp>/pg` (so parallel test workers never share a port), and runs
`fn(rank, tmp, *args)` in each. Inputs and outputs travel as .npz files in
`tmp`. This module imports torch and the port only, so the ranks start
without JAX.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=world, rank=rank)
    try:
        fn(rank, tmp, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, tmp, *args, world: int = WORLD) -> None:
    mp.spawn(_entry, args=(fn, world, str(tmp), args), nprocs=world)


def load(tmp, name):
    with np.load(Path(tmp) / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


def _save(tmp, name, **arrays):
    np.savez(Path(tmp) / f"{name}.npz", **arrays)


def _shard(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    Ls = x.shape[1] // n
    return x[:, i * Ls:(i + 1) * Ls]


def attention_worker(rank, tmp):
    """Ulysses, ring (both impls) and hybrid on this rank's shards of
    inputs.npz (q, k, v [B, L, N, D], lens [B]), with and without kv_lens;
    writes att_<rank>.npz with each output shard."""
    from omnivideo_tpu_torch.parallel.mesh import create_mesh
    from omnivideo_tpu_torch.parallel.ring import (
        hybrid_attention,
        ring_attention,
        stripe_ring_attention,
        zigzag_ring_attention,
    )
    from omnivideo_tpu_torch.parallel.ulysses import ulysses_attention

    data = load(tmp, "inputs")
    q, k, v = (torch.from_numpy(data[n]) for n in "qkv")
    lens = torch.from_numpy(data["lens"])
    flat = create_mesh(sp=WORLD)
    grid = create_mesh(fsdp=2, sp=2)
    seq = flat.get_group("seq")
    out = {}
    for tag, kv in (("", None), ("_lens", lens)):
        qs, ks, vs = (_shard(t, rank, WORLD) for t in (q, k, v))
        out["ulysses" + tag] = ulysses_attention(qs, ks, vs, seq, kv_lens=kv)
        for impl in ("ppermute", "pallas"):
            out[f"ring_{impl}{tag}"] = ring_attention(qs, ks, vs, seq, impl=impl, kv_lens=kv)
        i = grid.get_local_rank("fsdp") * 2 + grid.get_local_rank("seq")
        qh, kh, vh = (_shard(t, i, WORLD) for t in (q, k, v))
        for impl in ("ppermute", "pallas"):
            out[f"hybrid_{impl}{tag}"] = hybrid_attention(
                qh, kh, vh, grid.get_group("fsdp"), grid.get_group("seq"), ring_impl=impl,
                kv_lens=kv)
    out["hybrid_shard"] = np.array(i)
    for impl in ("ppermute", "pallas"):  # token-causal over contiguous shards
        out[f"causal_{impl}"] = ring_attention(*(_shard(t, rank, WORLD) for t in (q, k, v)), seq,
                                               causal="token", impl=impl)
    out["zigzag_whole"] = zigzag_ring_attention(q, k, v, seq)  # the whole output, every rank
    out["stripe_whole"] = stripe_ring_attention(q, k, v, seq)
    _save(tmp, f"att_{rank}", **{n: np.asarray(t) for n, t in out.items()})


def dit_worker(rank, tmp, cfg_kw):
    """The SP DiT forward (sd.npz weights, f32) for every mode on the
    natural (x) and padded (xp, seq_len 48) inputs of inputs.npz; writes
    dit_<rank>.npz."""
    from omnivideo_tpu_torch.configs.base import WanDiTConfig
    from omnivideo_tpu_torch.io.jax_bridge import load_wan_state_dict
    from omnivideo_tpu_torch.models.wan_dit import SPConfig, WanDiT
    from omnivideo_tpu_torch.parallel.mesh import create_mesh

    model = load_wan_state_dict(WanDiT(WanDiTConfig(**cfg_kw), torch.float32, device="cpu"),
                                load(tmp, "sd"))
    data = {n: torch.from_numpy(a) for n, a in load(tmp, "inputs").items()}
    flat, grid = create_mesh(sp=WORLD), create_mesh(fsdp=2, sp=2)
    modes = {"ulysses": SPConfig(flat, "ulysses"),
             "ring_ppermute": SPConfig(flat, "ring"),
             "ring_pallas": SPConfig(flat, "ring", ring_impl="pallas"),
             "hybrid_ppermute": SPConfig(grid, "hybrid"),
             "hybrid_pallas": SPConfig(grid, "hybrid", ring_impl="pallas")}
    out = {}
    with torch.inference_mode():
        for name, sp in modes.items():
            out[name] = model(data["x"], data["t"], data["ctx"], sp=sp)
            out[name + "_padded"] = model(data["xp"], data["t"], data["ctx"], seq_len=48, sp=sp)
        for name in ("ulysses", "ring_pallas"):  # per-token timesteps [B, L]
            sp = modes[name]
            out[name + "_tokens"] = model(data["x"], data["tl"], data["ctx"], sp=sp)
            out[name + "_tokens_padded"] = model(data["xp"], data["tlp"], data["ctx"], seq_len=48,
                                                 sp=sp)
    _save(tmp, f"dit_{rank}", **{n: t.numpy() for n, t in out.items()})


def tiny_pipe(pipe_kw, sp=None):
    """The tiny pipeline from seed 0 (f32, CPU), its zero-init DiT head
    filled from seed 9 so the velocities are not zero."""
    from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
    from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified

    cfg = PipelineConfig(dit=WanDiTConfig(**pipe_kw["dit"]), vae=VAEConfig(**pipe_kw["vae"]),
                         **pipe_kw["pipe"])
    pipe = OmniVideoX2XUnified.random_init(cfg, seed=0, with_vae=False, device="cpu", sp=sp)
    with torch.no_grad():
        pipe.low_noise.wan.head.head.weight.normal_(0.0, 0.05,
                                                    generator=torch.Generator().manual_seed(9))
    return pipe


def generate_worker(rank, tmp, pipe_kw, gen_kw):
    """A tiny SP generate (ring, fused-step impl), seeded and unseeded; the
    pipeline is made from the same seed on every rank. Writes gen_<rank>.npz."""
    from omnivideo_tpu_torch.models.wan_dit import SPConfig
    from omnivideo_tpu_torch.parallel.mesh import create_mesh

    pipe = tiny_pipe(pipe_kw, SPConfig(create_mesh(sp=WORLD), "ring", ring_impl="pallas"))
    ctx = torch.from_numpy(load(tmp, "inputs")["ctx"][0, :5])
    kw = dict(precomputed_context=ctx, precomputed_context_null=torch.zeros_like(ctx),
              decode=False, **gen_kw)
    seeded = pipe.generate(generator=torch.Generator().manual_seed(7), **kw)
    unseeded = pipe.generate(**kw)
    _save(tmp, f"gen_{rank}", seeded=seeded.numpy(), unseeded=unseeded.numpy())


def sp_dit_worker(rank, tmp, cfg_kw, pipe_kw, gen_kw):
    """dit_worker, then generate_worker, in one process group."""
    dit_worker(rank, tmp, cfg_kw)
    generate_worker(rank, tmp, pipe_kw, gen_kw)


def cli_worker(rank, tmp, argv):
    """The generate CLI on the group this rank already joined (`--sp_size`
    equals the world); rank 0 writes the outputs. Pillow and imageio are
    hidden, so `save_video` writes the exact frames as `.npz`."""
    from omnivideo_tpu_torch.tools import generate

    sys.modules.update(PIL=None, imageio=None)
    generate.main(list(argv))


def _grad_case(fn, q, k, v, w):
    """fn on fresh leaves q/k/v; (out, dq, dk, dv) of sum(fn(q, k, v)·w)."""
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    (out * w).sum().backward()
    return [out.detach(), q.grad, k.grad, v.grad]


def attention_grad_worker(rank, tmp):
    """Gradients through Ulysses, the ring (non-causal, block, token, and
    kv_lens whose last shard is all padding) and the hybrid on this rank's
    shards of grad_inputs.npz (q, k, v, w [B, L, N, D], lens [B]); the
    output grad is w. Writes grad_<rank>.npz: out, dq, dk, dv per case."""
    from omnivideo_tpu_torch.parallel.mesh import create_mesh
    from omnivideo_tpu_torch.parallel.ring import hybrid_attention, ring_attention
    from omnivideo_tpu_torch.parallel.ulysses import ulysses_attention

    data = load(tmp, "grad_inputs")
    q, k, v, w = (torch.from_numpy(data[n]) for n in ("q", "k", "v", "w"))
    lens = torch.from_numpy(data["lens"])
    flat = create_mesh(sp=WORLD)
    grid = create_mesh(fsdp=2, sp=2)
    seq = flat.get_group("seq")
    sh = [_shard(t, rank, WORLD) for t in (q, k, v, w)]
    i = grid.get_local_rank("fsdp") * 2 + grid.get_local_rank("seq")
    hy = [_shard(t, i, WORLD) for t in (q, k, v, w)]
    cases = {
        "ulysses": (lambda a, b, c: ulysses_attention(a, b, c, seq), sh),
        "ulysses_lens": (lambda a, b, c: ulysses_attention(a, b, c, seq, kv_lens=lens), sh),
        "ring": (lambda a, b, c: ring_attention(a, b, c, seq), sh),
        "ring_block": (lambda a, b, c: ring_attention(a, b, c, seq, causal="block"), sh),
        "ring_token": (lambda a, b, c: ring_attention(a, b, c, seq, causal="token",
                                                      impl="pallas"), sh),
        "ring_lens": (lambda a, b, c: ring_attention(a, b, c, seq, kv_lens=lens), sh),
        "hybrid": (lambda a, b, c: hybrid_attention(a, b, c, grid.get_group("fsdp"),
                                                    grid.get_group("seq")), hy),
        "hybrid_lens": (lambda a, b, c: hybrid_attention(
            a, b, c, grid.get_group("fsdp"), grid.get_group("seq"), ring_impl="pallas",
            kv_lens=lens), hy),
    }
    out = {"hybrid_shard": np.array(i)}
    for name, (fn, (qs, ks, vs, ws)) in cases.items():
        for tag, t in zip(("out", "dq", "dk", "dv"), _grad_case(fn, qs, ks, vs, ws)):
            out[f"{name}_{tag}"] = t.numpy()
    _save(tmp, f"grad_{rank}", **out)


def dit_grad_worker(rank, tmp, cfg_kw):
    """The SP DiT's parameter grads (Ulysses, ring, hybrid) of sum(v·w),
    summed over the ranks as the trainer reduces them, beside the same
    model's single-process grads on this rank. Writes dgrad_<rank>.npz."""
    from omnivideo_tpu_torch.configs.base import WanDiTConfig
    from omnivideo_tpu_torch.io.jax_bridge import load_wan_state_dict
    from omnivideo_tpu_torch.models.wan_dit import SPConfig, WanDiT
    from omnivideo_tpu_torch.parallel.mesh import create_mesh

    model = load_wan_state_dict(WanDiT(WanDiTConfig(**cfg_kw), torch.float32, device="cpu"),
                                load(tmp, "sd"))
    data = {n: torch.from_numpy(a) for n, a in load(tmp, "inputs").items()}
    flat, grid = create_mesh(sp=WORLD), create_mesh(fsdp=2, sp=2)
    modes = {"ulysses": SPConfig(flat, "ulysses"), "ring": SPConfig(flat, "ring"),
             "hybrid": SPConfig(grid, "hybrid")}
    out = {}

    def grads(sp):
        model.zero_grad()
        v = model(data["xp"], data["t"], data["ctx"], seq_len=48, qk_impl="unfused", sp=sp)
        (v * data["w"]).sum().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    for n, g in grads(None).items():
        out["single/" + n] = g.numpy()
    for name, sp in modes.items():
        for n, g in grads(sp).items():
            dist.all_reduce(g)  # every rank holds a token shard: the sum
            out[f"{name}/{n}"] = g.numpy()
    _save(tmp, f"dgrad_{rank}", **out)


def _full(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().float().numpy().copy()


def _train_mesh(mesh_kw, cfg, tc, sd, batch, draws, steps, seq_len=None, ckpt=None,
                resume=None, lora=False):
    """`steps` unified train steps on a mesh (None: one process); returns
    per step {"loss", "grad_norm", "grads" {name: full}, "params" {name:
    full}}. ckpt=(dir, step): save after that step; resume=dir: start from
    its latest step. The LoRA adapters `sd` names are attached; lora: train
    them alone (the base frozen after sharding, as the finetune CLI)."""
    from omnivideo_tpu_torch.io.jax_bridge import with_adapters
    from omnivideo_tpu_torch.models.wan_dit import SPConfig
    from omnivideo_tpu_torch.parallel.mesh import batch_slice, create_mesh
    from omnivideo_tpu_torch.parallel.sharding import shard_params
    from omnivideo_tpu_torch.training import trainer
    from omnivideo_tpu_torch.training.checkpoint import CheckpointManager
    from omnivideo_tpu_torch.training.lora import freeze_base

    mesh, sp = None, None
    if mesh_kw is not None:
        mode = mesh_kw.pop("mode", None)
        mesh = create_mesh(**mesh_kw)
        if mode is not None:
            sp = SPConfig(mesh, mode)
    model = trainer.init_unified_params(cfg, device="cpu")
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    with_adapters(model, tensors).load_state_dict(tensors)
    if mesh_kw is not None and (mesh_kw.get("fsdp", 1) > 1 or mesh_kw.get("tp", 1) > 1):
        shard_params(model, mesh)
    if lora:
        freeze_base(model)
    tx = trainer.make_optimizer(tc, model)
    state = trainer.init_train_state(model, tx)
    if resume is not None:
        state = CheckpointManager(resume).restore(state)
    step = trainer.make_unified_train_step(cfg, tc, tx, mesh=mesh, sp=sp, seq_len=seq_len)
    rows = slice(*batch_slice(mesh, batch["latents"].shape[0]))
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    seen = {}
    update = tx.update

    def spy(model_, grads, opt_state):
        seen["grads"] = {n: _full(g) for n, g in grads.items()}
        return update(model_, grads, opt_state)

    tx.update = spy
    recs = []
    for s in range(state.step, steps):
        d = tuple(None if a is None else torch.from_numpy(a[s]) for a in draws)
        state, m = step(state, local, d)
        recs.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "grads": seen["grads"],
                     "params": {n: _full(p) for n, p in state.params.named_parameters()}})
        if ckpt is not None and s + 1 == ckpt[1]:
            CheckpointManager(ckpt[0]).save(s + 1, state, {"step": s + 1})
    return recs


TRAIN_MESHES = {  # name → create_mesh kwargs (+ the SPConfig mode), and a seq_len
    "dp2_fsdp2": (dict(dp=2, fsdp=2), None),
    "fsdp2_sp2_ulysses": (dict(fsdp=2, sp=2, mode="ulysses"), None),
    "sp4_ring_padded": (dict(sp=4, mode="ring"), 52),
    "fsdp2_sp2_hybrid": (dict(fsdp=2, sp=2, mode="hybrid"), None),
    "tp2_fsdp2": (dict(fsdp=2, tp=2, mode="tp"), None),
    "tp4": (dict(tp=4, mode="tp"), None),
}


def parallel_train_worker(rank, tmp, cfg_kw, tc_kw, steps):
    """Every mesh of TRAIN_MESHES for `steps` steps from train_inputs.npz
    (the port state dict "sd/<name>", the global batch "batch/<key>", the
    draws per step "tid", "noise", "drop"); then the checkpoint round trips:
    fsdp2×sp2 Ulysses saves after step 2 of 3, and the same mesh, dp2×tp2
    and (rank 0) one process resume from it; sp4 resumes the one-process
    checkpoint `ckpt_one`. Rank 0 writes ptrain.npz."""
    from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
    from omnivideo_tpu_torch.training import trainer

    data = load(tmp, "train_inputs")
    sd = {k[3:]: v for k, v in data.items() if k.startswith("sd/")}
    batch = {k[6:]: v for k, v in data.items() if k.startswith("batch/")}
    draws = (data["tid"], data["noise"], data["drop"])
    cfg = PipelineConfig(dit=WanDiTConfig(**cfg_kw["dit"]), vae=VAEConfig(z_dim=4),
                         **cfg_kw["pipe"])
    tc = trainer.TrainConfig(**tc_kw)
    out = {}

    def keep(name, recs):
        for s, r in enumerate(recs):
            out[f"{name}/{s}/loss"] = np.array(r["loss"])
            out[f"{name}/{s}/grad_norm"] = np.array(r["grad_norm"])
            for n, g in r["grads"].items():
                out[f"{name}/{s}/grad/{n}"] = g
            for n, p in r["params"].items():
                out[f"{name}/{s}/param/{n}"] = p

    for name, (mesh_kw, seq_len) in TRAIN_MESHES.items():
        keep(name, _train_mesh(dict(mesh_kw), cfg, tc, sd, batch, draws, steps, seq_len))
    ck = str(Path(tmp) / "ckpt")
    writer = _train_mesh(dict(fsdp=2, sp=2, mode="ulysses"), cfg, tc, sd, batch, draws, steps,
                         ckpt=(ck, 2))
    out["ckpt/writer"] = np.array([r["loss"] for r in writer])
    dist.barrier()
    same = _train_mesh(dict(fsdp=2, sp=2, mode="ulysses"), cfg, tc, sd, batch, draws, steps,
                       resume=ck)
    out["ckpt/same_mesh"] = np.array([r["loss"] for r in same])
    out["ckpt/same_mesh_params_equal"] = np.array(all(
        np.array_equal(p, same[-1]["params"][n]) for n, p in writer[-1]["params"].items()))
    recs = _train_mesh(dict(dp=2, tp=2, mode="tp"), cfg, tc, sd, batch, draws, steps, resume=ck)
    out["ckpt/dp2_tp2"] = np.array([r["loss"] for r in recs])
    # a checkpoint the one-process run wrote (tests/test_torch_parallel_train.py), under sp 4
    recs = _train_mesh(dict(sp=4, mode="ring"), cfg, tc, sd, batch, draws, steps,
                       resume=str(Path(tmp) / "ckpt_one"))
    out["ckpt/one_to_sp4"] = np.array([r["loss"] for r in recs])
    if rank == 0:
        recs = _train_mesh(None, cfg, tc, sd, batch, draws, steps, resume=ck)
        out["ckpt/one"] = np.array([r["loss"] for r in recs])
        _save(tmp, "ptrain", **out)


def parallel_train_all_worker(rank, tmp, cfg_kw, tc_kw, steps, argv):
    """shardings_worker, parallel_train_worker, then the finetune CLI
    (`argv`) on the group this rank already joined."""
    from omnivideo_tpu_torch.tools import finetune

    shardings_worker(rank, tmp, cfg_kw)
    parallel_train_worker(rank, tmp, cfg_kw, tc_kw, steps)
    finetune.main(list(argv))


def sp_train_worker(rank, tmp, cfg_kw):
    """attention_grad_worker, then dit_grad_worker."""
    attention_grad_worker(rank, tmp)
    dit_grad_worker(rank, tmp, cfg_kw)


def shardings_worker(rank, tmp, cfg_kw):
    """params_shardings' plan and the placements shard_params leaves on a
    tp2×fsdp2 mesh; rank 0 writes shardings.json."""
    import json

    from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
    from omnivideo_tpu_torch.parallel.mesh import create_mesh
    from omnivideo_tpu_torch.parallel.sharding import params_shardings, placements, shard_params
    from omnivideo_tpu_torch.training import trainer

    cfg = PipelineConfig(dit=WanDiTConfig(**cfg_kw["dit"]), vae=VAEConfig(z_dim=4),
                         **cfg_kw["pipe"])
    mesh = create_mesh(fsdp=2, tp=2)
    model = trainer.init_unified_params(cfg, device="cpu")
    big = sum(p.numel() >= 1024 for p in model.parameters())
    plan = params_shardings(model, mesh)
    held = placements(shard_params(model, mesh))
    if rank == 0:
        (Path(tmp) / "shardings.json").write_text(json.dumps(
            {"plan": plan, "placements": held, "numel_at_least_1024": int(big)}))


def cli_runs_worker(rank, tmp, runs):
    """The generate CLI once per (name, argv) of `runs` on the group this
    rank already joined; rank 0 writes cli_latents.npz ({name/row id:
    latents}). Pillow and imageio are hidden, as cli_worker does."""
    from omnivideo_tpu_torch.tools import generate

    sys.modules.update(PIL=None, imageio=None)
    out = {}
    for name, argv in runs:
        for r in generate.run(generate.parse_args(list(argv))):
            out[f"{name}/{r['id']}"] = r["latents"].numpy()
    if rank == 0:
        _save(tmp, "cli_latents", **out)


LORA_MESHES = {  # name → create_mesh kwargs (+ the SPConfig mode)
    "dp2_fsdp2": dict(dp=2, fsdp=2),
    "dp2_tp2": dict(dp=2, tp=2, mode="tp"),
    "tp2_fsdp2": dict(fsdp=2, tp=2, mode="tp"),
}
QWEN_MESHES = {  # name → (create_mesh kwargs, the Ulysses axis)
    "ring4": (dict(sp=4), None),
    "ring2": (dict(dp=2, sp=2), None),
    "ring2_ulysses2": (dict(fsdp=2, sp=2), "fsdp"),
}


def lora_mesh_worker(rank, tmp, cases, steps):
    """From lora_inputs.npz: each (name, cfg_kw, tc_kw, lora) of `cases`
    (its state dict "<name>/sd/...", batch "batch/...", draws "tid",
    "noise", "drop") on every mesh of LORA_MESHES for `steps` steps; then
    the last case saved under tp2×fsdp2 after step 1 and resumed under
    dp2×fsdp2 and (rank 0) in one process; then qwen3_forward_sp of the
    text-only Qwen3 ("qwen/sd/...", "qwen/ids", config "qwen/cfg") on
    QWEN_MESHES. Rank 0 writes lora_mesh.npz."""
    from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
    from omnivideo_tpu_torch.configs.qwen3vl import Qwen3TextConfig
    from omnivideo_tpu_torch.io.jax_bridge import load_qwen3vl
    from omnivideo_tpu_torch.models.qwen3vl.text_model import Qwen3LM, qwen3_forward_sp
    from omnivideo_tpu_torch.parallel.mesh import create_mesh
    from omnivideo_tpu_torch.training import trainer

    data = load(tmp, "lora_inputs")
    batch = {k[6:]: v for k, v in data.items() if k.startswith("batch/")}
    draws = (data["tid"], data["noise"], data["drop"])
    out = {}

    def keep(name, recs):
        for s, r in enumerate(recs):
            out[f"{name}/{s}/loss"] = np.array(r["loss"])
            for n, p in r["params"].items():
                out[f"{name}/{s}/param/{n}"] = p

    for name, cfg_kw, tc_kw, lora in cases:
        sd = {k[len(name) + 4:]: v for k, v in data.items() if k.startswith(f"{name}/sd/")}
        cfg = PipelineConfig(dit=WanDiTConfig(**cfg_kw["dit"]), vae=VAEConfig(z_dim=4),
                             **cfg_kw["pipe"])
        tc = trainer.TrainConfig(**tc_kw)
        for mname, mesh_kw in LORA_MESHES.items():
            keep(f"{name}/{mname}", _train_mesh(dict(mesh_kw), cfg, tc, sd, batch, draws, steps,
                                                lora=lora))
    ck = str(Path(tmp) / "ckpt")
    _train_mesh(dict(LORA_MESHES["tp2_fsdp2"]), cfg, tc, sd, batch, draws, 1, ckpt=(ck, 1),
                lora=lora)
    dist.barrier()
    keep(f"{name}/resumed_dp2_fsdp2", _train_mesh(dict(LORA_MESHES["dp2_fsdp2"]), cfg, tc, sd,
                                                   batch, draws, steps, resume=ck, lora=lora))
    if rank == 0:
        keep(f"{name}/resumed_one", _train_mesh(None, cfg, tc, sd, batch, draws, steps,
                                                resume=ck, lora=lora))

    qcfg = Qwen3TextConfig(**json.loads(str(data["qwen/cfg"])))
    model = Qwen3LM(qcfg, torch.float32, device="cpu")
    load_qwen3vl(model, {k[8:]: torch.from_numpy(v) for k, v in data.items()
                         if k.startswith("qwen/sd/")})
    ids = torch.from_numpy(data["qwen/ids"])
    for qname, (mesh_kw, ulysses) in QWEN_MESHES.items():
        hidden, logits = qwen3_forward_sp(model, ids, create_mesh(**mesh_kw),
                                          ulysses_axis=ulysses)
        out[f"qwen/{qname}/hidden"], out[f"qwen/{qname}/logits"] = hidden.numpy(), logits.numpy()
    if rank == 0:
        _save(tmp, "lora_mesh", **out)


SFT_MESHES = {  # name → create_mesh kwargs: 4 ranks, each CLI axis at 2 (sp at 4 too)
    "dp2_fsdp2": dict(dp=2, fsdp=2),
    "dp2_sp2": dict(dp=2, sp=2),
    "fsdp2_tp2": dict(fsdp=2, tp=2),
    "sp4": dict(sp=4),
}


def sft_build(sd, cfg_json, chain):
    """The port's SFTParams on the CPU from a flat state dict (training/sft.py
    names) and a Qwen3TextConfig as JSON; `chain`: the tiny chain's widths."""
    from omnivideo_tpu_torch.configs.qwen3vl import Qwen3TextConfig
    from omnivideo_tpu_torch.io.jax_bridge import load_qwen3vl
    from omnivideo_tpu_torch.models.adapters import init_dm_adapter, init_vision_head
    from omnivideo_tpu_torch.models.qwen3vl.text_model import Qwen3LM
    from omnivideo_tpu_torch.training.align import AlignChain
    from omnivideo_tpu_torch.training.sft import SFTParams

    cfg = Qwen3TextConfig(**json.loads(cfg_json))
    lm = load_qwen3vl(Qwen3LM(cfg, torch.float32, device="cpu"),
                      {k[3:]: torch.from_numpy(v) for k, v in sd.items() if k.startswith("lm.")})
    ch = None
    if chain:
        ch = AlignChain(init_vision_head(cfg.hidden_size, 32, 24, 4, 1, device="cpu"),
                        init_dm_adapter(24, 32, 32, 4, 1, device="cpu"))
        ch.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in sd.items()
                            if k.startswith("chain.")})
    return SFTParams(lm, ch)


def sft_steps(mesh_kw, sd, cfg_json, tc_kw, batch, steps, lora_rank=0):
    """`steps` SFT steps of the port on `mesh_kw` (None: one process) from
    `sd`; per step {'loss', 'lm_loss', 'num_targets', 'grad_norm'[,
    'align_loss'], 'grads': {name: the reduced gradient, whole}}."""
    from torch.distributed.tensor import DTensor

    from omnivideo_tpu_torch.parallel.mesh import create_mesh
    from omnivideo_tpu_torch.parallel.sharding import shard_params
    from omnivideo_tpu_torch.training import sft
    from omnivideo_tpu_torch.training.lora import freeze_base, inject_lora_bare

    model = sft_build(sd, cfg_json, tc_kw.get("align_weight", 0) > 0)
    if lora_rank:
        inject_lora_bare(model.lm, lora_rank, generator=torch.Generator().manual_seed(1))
    mesh = create_mesh(**mesh_kw) if mesh_kw else None
    if mesh is not None and mesh_kw.get("fsdp", 1) > 1:
        shard_params(model, mesh)
    if lora_rank:
        freeze_base(model.lm)
    tc = sft.SFTConfig(**tc_kw)
    tx = sft.make_sft_optimizer(tc)
    state = sft.init_sft_state(model, tx)
    step = sft.make_sft_step(tc, tx, sp_mesh=mesh if mesh_kw and mesh_kw.get("sp", 1) > 1
                             else None, mesh=mesh)
    update, seen = tx.update, {}

    def spy(model_, grads, opt_state):
        seen.update({n: (g.full_tensor() if isinstance(g, DTensor) else g).detach().clone().numpy()
                     for n, g in grads.items()})
        return update(model_, grads, opt_state)

    tx.update = spy
    recs = []
    for _ in range(steps):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        recs.append({**{k: float(v) for k, v in m.items()}, "grads": dict(seen)})
    return recs


def sft_mesh_worker(rank, tmp, tc_kw, steps, cli_runs):
    """From sft_inputs.npz ("sd/...", "batch/...", "cfg"): the SFT step on
    every mesh of SFT_MESHES for `steps` steps (full finetune), then LoRA on
    dp2×fsdp2, then the sft_vlm CLI once per argv of `cli_runs` (tmp paths
    filled in). Rank 0 writes sft_mesh.npz."""
    from omnivideo_tpu_torch.tools import sft_vlm

    data = load(tmp, "sft_inputs")
    sd = {k[3:]: v for k, v in data.items() if k.startswith("sd/")}
    batch = {k[6:]: v for k, v in data.items() if k.startswith("batch/")}
    out = {}

    def keep(name, recs):
        for s, r in enumerate(recs):
            for k, v in r.items():
                if k == "grads":
                    out.update({f"{name}/{s}/grad/{n}": g for n, g in v.items()})
                else:
                    out[f"{name}/{s}/{k}"] = np.array(v)

    for name, mesh_kw in SFT_MESHES.items():
        keep(name, sft_steps(mesh_kw, sd, str(data["cfg"]), tc_kw, batch, steps))
    keep("lora_dp2_fsdp2", sft_steps(SFT_MESHES["dp2_fsdp2"], sd, str(data["cfg"]), tc_kw, batch,
                                     steps, lora_rank=4))
    for name, argv in cli_runs:
        sft_vlm.run(sft_vlm.parse_args([a.replace("{tmp}", str(tmp)) for a in argv]))
        dist.barrier()
    if rank == 0:
        _save(tmp, "sft_mesh", **out)
