"""The port's mesh train step over 4 real gloo ranks (tests/torch_sp_workers.py)
against JAX `make_unified_train_step` with no mesh, as
tests/test_torch_train.py::test_unified_train_step_matches_jax holds the
one-process step: the `--tiny` config (4 heads, dim 64, 2 layers), JAX's
params with a seeded head, its batch (2 rows) and its draws, 3 steps.

Meshes: dp2×fsdp2 (FSDP2), fsdp2×sp2 Ulysses, sp4 ring with seq_len padded
48 → 52, fsdp2×sp2 hybrid (Ulysses over 'fsdp'), tp2×fsdp2 and tp4 (the
Megatron split, 2-D with FSDP2). Remat is on in the port (it re-runs the
collectives in the backward) and off in JAX (it changes no value).
Tolerance: loss and grad_norm within 1e-4 relative; each grad leaf within
1e-4 of its largest magnitude; each updated param leaf within 1e-4 of
max(its largest magnitude, 1e-2) (tests/test_torch_train.py's floor). The
one-process test holds 1e-5; sharded sums reorder f32 adds.

Also: `params_shardings`' rules and the placements `shard_params` leaves
(tp2×fsdp2); a checkpoint written under fsdp2×sp2 after step 2 of 3 and
resumed under the same mesh (bit for bit), in one process and under
dp2×tp2, and one written in one process resumed under sp 4 (the third
loss within 1e-4);
the finetune CLI under `--fsdp 2 --sp 2` for 3 steps (rank 0's
metrics.jsonl within 1e-4 of the one-process run's). One spawn runs all.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_train_tiny as tiny
from omnivideo_tpu.training import trainer as jax_trainer
from omnivideo_tpu_torch.tools import finetune
from omnivideo_tpu_torch.training import trainer
from omnivideo_tpu_torch.training.checkpoint import CheckpointManager
from torch_sp_workers import TRAIN_MESHES, load, parallel_train_all_worker, spawn

STEPS = 3
TOL = 1e-4
KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, cfg_dropout=0.5)
CLI = ["--dummy_data", "--tiny", "--device", "cpu", "--log_interval", "1", "--total_steps", "3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ptrain")
    jtc = jax_trainer.TrainConfig(**KW, remat=False)
    params = tiny.jax_params()
    tx = optax.chain(tiny.grad_capture(), jax_trainer.make_optimizer(jtc, params))
    state = jax_trainer.init_train_state(params, tx)
    step = jax.jit(jax_trainer.make_unified_train_step(tiny.JCFG, jtc, tx, attn_impl="xla"))
    b = tiny.batch()
    ref, draws = [], []
    for s in range(STEPS):
        key, d = tiny.jax_draws(s, jtc)
        draws.append(d)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        ref.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "grads": tiny.to_port_names(state.opt_state[0]["g"]),
                    "params": tiny.to_port_names(state.params)})
    sd = {f"sd/{k}": v.detach().numpy() for k, v in tiny.port_params(params).state_dict().items()}
    np.savez(tmp / "train_inputs.npz", **sd, **{f"batch/{k}": v for k, v in b.items()},
             tid=np.stack([d[0].numpy() for d in draws]),
             noise=np.stack([d[1].numpy() for d in draws]),
             drop=np.stack([d[2].numpy() for d in draws]))
    cfg_kw = {"dit": tiny.DIT, "pipe": tiny.PIPE}
    tc_kw = dict(KW, remat=True)
    # a one-process checkpoint after step 2, for the workers to resume under sp 4
    ptc = trainer.TrainConfig(**tc_kw)
    model = tiny.port_params(params)
    ptx = trainer.make_optimizer(ptc, model)
    state = trainer.init_train_state(model, ptx)
    pstep = trainer.make_unified_train_step(tiny.CFG, ptc, ptx)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    for d in draws[:2]:
        state, _ = pstep(state, tb, d)
    CheckpointManager(str(tmp / "ckpt_one")).save(2, state, {"step": 2})
    argv = CLI + ["--fsdp", "2", "--sp", "2", "--output_dir", str(tmp / "ft_mesh")]
    spawn(parallel_train_all_worker, tmp, cfg_kw, tc_kw, STEPS, argv)
    return tmp, ref, load(tmp, "ptrain")


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_mesh_train_step_matches_jax(run, mesh):
    _, ref, got = run
    for s, r in enumerate(ref):
        pre = f"{mesh}/{s}/"
        assert abs(float(got[pre + "loss"]) / r["loss"] - 1) < TOL, (s, got[pre + "loss"], r)
        assert abs(float(got[pre + "grad_norm"]) / r["grad_norm"] - 1) < TOL, s
        grads = {n: torch.from_numpy(got[pre + "grad/" + n]) for n in r["grads"]}
        worst = tiny.worst_rel(grads, r["grads"])
        assert worst[0] < TOL, (s, worst)
        params = {n: torch.from_numpy(got[pre + "param/" + n]) for n in r["params"]}
        worst = tiny.worst_rel(params, r["params"], floor=1e-2)
        assert worst[0] < TOL, (s, worst)


def test_params_shardings_rules(run):
    """tp2×fsdp2: q/k/v/ffn.0 column-split (dim 0) and o/ffn.2 row-split
    (dim 1) over 'tensor', o's bias replicated, the q/k norm gains split
    like q/k; leaves under 1,024 elements replicated over 'fsdp', the rest
    sharded on dim 0; and shard_params leaves exactly the plan."""
    tmp, *_ = run
    rec = json.loads((tmp / "shardings.json").read_text())
    plan, held = rec["plan"], rec["placements"]
    assert plan == held
    blk = "wan.blocks.1."
    assert plan[blk + "self_attn.q.weight"] == {"fsdp": 0, "tensor": 0}  # [64, 64]: 4,096
    assert plan[blk + "ffn.0.weight"] == {"fsdp": 0, "tensor": 0}
    assert plan[blk + "ffn.0.bias"] == {"fsdp": None, "tensor": 0}  # 128 elements
    assert plan[blk + "ffn.2.weight"] == {"fsdp": 0, "tensor": 1}
    assert plan[blk + "cross_attn.o.weight"] == {"fsdp": 0, "tensor": 1}
    assert plan[blk + "cross_attn.o.bias"] == {"fsdp": None, "tensor": None}
    assert plan[blk + "self_attn.norm_k.weight"] == {"fsdp": None, "tensor": 0}
    assert plan[blk + "modulation"] == {"fsdp": None, "tensor": None}  # [1, 6, 64]: 384
    assert plan["wan.patch_embedding.weight"] == {"fsdp": 0, "tensor": None}  # [64, 16]
    assert plan["wan.head.modulation"] == {"fsdp": None, "tensor": None}
    big = [n for n, p in plan.items() if p["fsdp"] is not None]
    assert len(big) == rec["numel_at_least_1024"]


def test_checkpoint_resumes_across_meshes(run):
    """Written under fsdp2×sp2 after step 2: resumed under the same mesh
    the third step is bit for bit the uninterrupted run's; resumed in one
    process and under dp2×tp2 its loss is within 1e-4. Written in one
    process after step 2 and resumed under sp 4, likewise."""
    _, ref, got = run
    writer = got["ckpt/writer"]
    assert len(writer) == STEPS and abs(writer[-1] / ref[-1]["loss"] - 1) < TOL
    assert got["ckpt/same_mesh"].tolist() == writer[-1:].tolist()
    assert bool(got["ckpt/same_mesh_params_equal"])
    for name in ("ckpt/one", "ckpt/dp2_tp2", "ckpt/one_to_sp4"):
        assert got[name].shape == (1,), name
        assert abs(got[name][0] / writer[-1] - 1) < TOL, (name, got[name], writer)


def test_finetune_cli_fsdp_sp_matches_one_process(run, tmp_path):
    tmp, *_ = run
    assert finetune.main(CLI + ["--output_dir", str(tmp_path / "one")]) == 0
    rows = [[json.loads(s) for s in (d / "metrics.jsonl").read_text().splitlines()]
            for d in (tmp / "ft_mesh", tmp_path / "one")]
    assert [r["step"] for r in rows[0]] == [r["step"] for r in rows[1]] == [1, 2, 3]
    for a, b in zip(*rows):
        assert abs(a["loss/t2v"] / b["loss/t2v"] - 1) < TOL, (a, b)


def test_finetune_cli_takes_every_task():
    """--task takes every WAN_CONFIGS key; t2v-A14B trains its low-noise expert."""
    args = finetune.parse_args(["--dummy_data", "--tiny", "--task", "t2v-A14B"])
    cfg = finetune.task_config(args)
    assert cfg.dual_expert and cfg.low_noise_checkpoint == "low_noise_model"
    assert dataclasses.asdict(cfg.dit)["num_layers"] == 2
    with pytest.raises(SystemExit):
        finetune.parse_args(["--dummy_data", "--sp", "2", "--tp", "2"])
    with pytest.raises(SystemExit):
        finetune.parse_args(["--dummy_data", "--dp", "2", "--batch_size", "3"])
