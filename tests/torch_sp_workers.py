"""Process-group workers for the port's sequence-parallel tests (CPU, gloo).

`spawn(fn, world, tmp)` starts `world` processes with
`torch.multiprocessing`, joins them into one gloo group through
`file://<tmp>/pg` (so parallel test workers never share a port), and runs
`fn(rank, tmp, *args)` in each. Inputs and outputs travel as .npz files in
`tmp`. This module imports torch and the port only, so the ranks start
without JAX.
"""

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
