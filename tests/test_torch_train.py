"""The port's unified training step against JAX `make_unified_train_step`
(attn_impl="xla"), and the pieces around it: remat and the bf16 carry, the
dataset copy, checkpoint resume and the finetune CLI. CPU, the `--tiny`
config, f32 master params, the JAX draws passed in (torch cannot reproduce
threefry), the DiT head filled with seeded normals, warmup 1 (the first
update has lr 0, the second moves every param), CFG dropout dropping one of
two samples.

Tolerances (f32): loss and grad_norm within 1e-5 relative; each gradient
leaf within 1e-5 of its largest magnitude (measured ≤ 3.4e-6: summation
order and the exp2- vs exp-domain softmax); each updated param leaf within
1e-5 of max(its largest magnitude, 1e-2), the floor because zero-initialised
biases hold only O(lr) values after one update, where the gradient's last-
ulp differences move Adam's normalised step by ~1e-5 of lr (measured 1.9e-8
absolute).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_tiny as tiny
from omnivideo_tpu.configs.base import T2V_1_3B as JAX_T2V_1_3B
from omnivideo_tpu.models.wan_dit import wan_dit_apply
from omnivideo_tpu.pipelines.loading import load_expert as jax_load_expert
from omnivideo_tpu.training import dataset as jax_dataset
from omnivideo_tpu.training import trainer as jax_trainer
from omnivideo_tpu_torch.io.jax_bridge import wan_params_to_state_dict
from omnivideo_tpu_torch.tools import finetune
from omnivideo_tpu_torch.training import dataset, trainer
from omnivideo_tpu_torch.training.checkpoint import CheckpointManager

TOL = 1e-5
# remat off: it changes no value (test_remat_and_bf16_carry) and triples JAX's compile
KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, cfg_dropout=0.5, remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_unified_train_step_matches_jax():
    import optax

    jtc, tc = jax_trainer.TrainConfig(**KW), trainer.TrainConfig(**KW)
    params = tiny.jax_params()
    tx = optax.chain(tiny.grad_capture(), jax_trainer.make_optimizer(jtc, params))
    state = jax_trainer.init_train_state(params, tx)
    step = jax.jit(jax_trainer.make_unified_train_step(tiny.JCFG, jtc, tx, attn_impl="xla"))

    model = tiny.port_params(params)
    ptx = trainer.make_optimizer(tc, model)
    pstate = trainer.init_train_state(model, ptx)
    pstep = trainer.make_unified_train_step(tiny.CFG, tc, ptx)
    loss_fn = trainer.make_unified_loss(tiny.CFG, tc)
    b = tiny.batch()
    tb = {k: torch.tensor(v) for k, v in b.items()}
    for s in range(3):
        key, draws = tiny.jax_draws(s, jtc)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        model.zero_grad()
        loss_fn(model, tb, draws).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        pstate, pm = pstep(pstate, tb, draws)
        assert abs(float(pm["loss"]) / float(m["loss"]) - 1) < TOL
        assert abs(float(pm["grad_norm"]) / float(m["grad_norm"]) - 1) < TOL
        worst = tiny.worst_rel(grads, tiny.to_port_names(state.opt_state[0]["g"]))
        assert worst[0] < TOL, (s, worst)
        worst = tiny.worst_rel(dict(model.named_parameters()), tiny.to_port_names(state.params),
                               floor=1e-2)
        assert worst[0] < TOL, (s, worst)
    assert pstate.step == 3 and pstate.opt_state["count"] == 3


def test_jax_paths_name_the_same_leaves():
    """trainable_filters match the JAX tree's "/"-joined paths: jax_path maps
    every port parameter onto the JAX leaf holding the same values."""
    params = tiny.jax_params()
    model = tiny.port_params(params)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    seen = set()
    for name, p in model.named_parameters():
        path = trainer.jax_path(name)
        leaf = flat[path]
        if name.startswith("wan.blocks."):
            leaf = leaf[int(name.split(".")[2])]
        got = p.detach().numpy()
        if name.startswith("wan.") and path.endswith("kernel"):  # Linear [out, in]
            got = got.T
        np.testing.assert_array_equal(got.reshape(leaf.shape), leaf)
        seen.add(path)
    assert seen == set(flat)
    assert trainer.jax_path("wan.blocks.3.norm3.weight") == "wan/blocks/norm3/scale"


def test_remat_and_bf16_carry():
    """remat recomputes each block without changing a bit of the gradients;
    the bf16 carry matches JAX's carry_dtype=bf16 forward (1e-5 of scale: the
    carry rounds at the same points in both)."""
    params = tiny.jax_params()
    b = tiny.batch(1)
    t = np.array([900.0, 30.0], np.float32)
    ref = np.asarray(wan_dit_apply(params["wan"], tiny.JCFG.dit, jnp.asarray(b["latents"]),
                                   jnp.asarray(t), jnp.asarray(b["context"]), attn_impl="xla",
                                   carry_dtype=jnp.bfloat16))
    wan = tiny.port_params(params).wan
    args = (torch.tensor(b["latents"]), torch.tensor(t), torch.tensor(b["context"]))
    with torch.no_grad():
        out = wan(*args, qk_impl="unfused", carry_dtype=torch.bfloat16).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < TOL
    grads = []
    for remat in (False, True):
        wan.zero_grad()
        wan(*args, qk_impl="unfused", remat=remat).square().mean().backward()
        grads.append([p.grad.clone() for p in wan.parameters()])
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_dataset_copy_matches_jax(tmp_path):
    """The port's dataset module is a copy: the same files, batches and host
    sharding as the JAX loader's."""
    root = dataset.make_dummy_dataset(tmp_path / "d", n=6, text_len=5, vlm_len=4,
                                      latent_shape=(4, 2, 4, 4), text_dim=8, vlm_dim=6,
                                      with_aligned=True)
    pad = dataset.PadSpec(text_len=7, vlm_len=3, latent_frames=3, aligned_len=10)
    jpad = jax_dataset.PadSpec(**vars(pad))
    for host in (0, 1):
        ours = dataset.PrefetchLoader(dataset.data_loader(
            dataset.OmniVideoDataset(str(root)), 2, pad, seed=3, host_id=host, num_hosts=2,
            epochs=2))
        ref = jax_dataset.data_loader(jax_dataset.OmniVideoDataset(str(root)), 2, jpad, seed=3,
                                      host_id=host, num_hosts=2, epochs=2)
        n = 0
        for a, r in zip(ours, ref, strict=True):
            assert a.keys() == r.keys() == {"context", "vlm", "aligned_emb", "latents",
                                            "visual_emb"}
            for k in a:
                np.testing.assert_array_equal(a[k], r[k])
            n += 1
        assert n == 2


def test_checkpoint_resume_is_exact(tmp_path):
    """Two steps, save, restore into fresh params, a third step: the same
    params and moments as three uninterrupted steps."""
    tc = trainer.TrainConfig(**KW)
    b = {k: torch.tensor(v) for k, v in tiny.batch(2).items()}

    def run(n, state=None):
        if state is None:
            model = tiny.port_params(tiny.jax_params())
            state = trainer.init_train_state(model, trainer.make_optimizer(tc, model))
        tx = trainer.make_optimizer(tc, state.params)
        step = trainer.make_unified_train_step(tiny.CFG, tc, tx)
        for s in range(state.step, n):
            state, _ = step(state, b, tiny.jax_draws(s, jax_trainer.TrainConfig(**KW))[1])
        return state

    full = run(3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (1, 2):
        mgr.save(s, run(s), {"step": s})
    mgr.save(2, run(2), {"step": 2})  # overwriting a step keeps one copy
    assert mgr.steps() == [1, 2] and mgr.latest_step() == 2
    fresh = tiny.port_params(tiny.jax_params(seed=9))
    state = mgr.restore(trainer.init_train_state(fresh, trainer.make_optimizer(tc, fresh)))
    assert state.step == 2
    resumed = run(3, state)
    for (n, p), q in zip(full.params.named_parameters(), resumed.params.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    for n, mu in full.opt_state["mu"].items():
        torch.testing.assert_close(mu, resumed.opt_state["mu"][n], rtol=0, atol=0)
    assert json.loads((tmp_path / "ckpt" / "2" / "meta.json").read_text()) == {"step": 2}


def test_finetune_cli(tmp_path):
    out = tmp_path / "ft"
    base = ["--dummy_data", "--tiny", "--device", "cpu", "--output_dir", str(out),
            "--log_interval", "1", "--save_interval", "2"]
    assert finetune.main(base + ["--total_steps", "3"]) == 0
    lines = [json.loads(s) for s in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(np.isfinite(r["loss/t2v"]) for r in lines)
    assert CheckpointManager(str(out / "checkpoints")).steps() == [2, 3]
    assert finetune.main(base + ["--total_steps", "4", "--resume"]) == 0
    lines = [json.loads(s) for s in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    with pytest.raises(SystemExit):  # the int8 stream is the streamed trainers' option
        finetune.main(base + ["--stream_quant", "int8"])


@pytest.mark.parametrize("extra", [[], ["--lora_rank", "4", "--stream_quant", "int8"]])
def test_finetune_cli_layer_stream(tmp_path, monkeypatch, extra):
    """--layer_stream (the streamed trainers, training/streaming.py): a run
    preempted after 2 of 3 steps (checkpointed) and resumed takes the
    losses of 3 uninterrupted steps; LoRA with an int8 base exports its
    adapters in JAX's format."""
    base = ["--dummy_data", "--tiny", "--device", "cpu", "--layer_stream", "--log_interval", "1",
            "--total_steps", "3", "--warmup_steps", "0", "--lr", "1e-3"] + extra

    def losses(out):
        return [json.loads(s)["loss/t2v"] for s in (out / "metrics.jsonl").read_text().splitlines()]

    full, part = tmp_path / "full", tmp_path / "part"
    assert finetune.main(base + ["--output_dir", str(full)]) == 0
    polls = iter([False, False, True])  # a SIGTERM seen before the third step
    monkeypatch.setattr(finetune.PreemptionGuard, "should_stop", lambda self: next(polls))
    assert finetune.main(base + ["--output_dir", str(part)]) == 0
    assert CheckpointManager(str(part / "checkpoints")).latest_step() == 2
    monkeypatch.undo()
    assert finetune.main(base + ["--output_dir", str(part), "--resume"]) == 0
    assert losses(part) == losses(full) and len(losses(full)) == 3
    assert all(np.isfinite(v) for v in losses(full))
    if extra:
        ad = tmp_path / "ad.npz"
        assert finetune.main(base + ["--total_steps", "1", "--output_dir", str(tmp_path / "x"),
                                     "--lora_adapter_export", str(ad)]) == 0
        with np.load(ad) as z:
            assert z["blocks/self_attn/q::lora_a"].shape == (2, 64, 4)


def _write_tiny_checkpoint(root, cfg, with_companions, seed=11):
    """<root>/low_noise_model/model.pt in the reference layout (a unified
    state dict: `wan_model.*` and, optionally, the companions under their
    torch names), every value a seeded normal."""
    rng = np.random.default_rng(seed)
    wan = trainer.init_unified_params(cfg, seed=0, device="cpu").wan
    sd = {f"wan_model.{k}": torch.tensor(rng.standard_normal(v.shape).astype(np.float32) * 0.05)
          for k, v in wan.state_dict().items()}
    if with_companions:
        v, d = cfg.vlm_in_dim, cfg.dit.text_dim
        sd["vlm_norm.weight"] = torch.tensor(1.0 + 0.1 * rng.standard_normal(v).astype(np.float32))
        sd["vlm_proj.weight"] = torch.tensor(rng.standard_normal((d, v)).astype(np.float32) * 0.1)
        sd["vlm_proj.bias"] = torch.tensor(rng.standard_normal(d).astype(np.float32) * 0.1)
    sub = root / cfg.low_noise_checkpoint
    sub.mkdir(parents=True)
    torch.save(sd, sub / "model.pt")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach().numpy() if torch.is_tensor(v) else v, np.float32)
    return out


@pytest.mark.parametrize("with_companions", [True, False])
def test_finetune_cli_ckpt_dir(tmp_path, with_companions):
    """--ckpt_dir starts from the low-noise expert, as the JAX CLI's
    load_expert(cfg, ckpt_dir, cfg.low_noise_checkpoint, f32): the same
    arrays, exactly; companions the file lacks come from the seed. Then two
    steps with a finite loss."""
    ckpt, out = tmp_path / "ckpt", tmp_path / "ft"
    args = finetune.parse_args(["--dummy_data", "--tiny", "--device", "cpu", "--ckpt_dir",
                                str(ckpt), "--output_dir", str(out), "--log_interval", "1"])
    cfg = finetune.task_config(args)
    _write_tiny_checkpoint(ckpt, cfg, with_companions)
    params = finetune.initial_params(cfg, args, torch.device("cpu"))
    jcfg = JAX_T2V_1_3B.replace(dit=JAX_T2V_1_3B.dit.replace(num_layers=cfg.dit.num_layers))
    expert = jax_load_expert(jcfg, str(ckpt), cfg.low_noise_checkpoint, jnp.float32)
    ref = wan_params_to_state_dict(jax.tree_util.tree_map(np.asarray, expert.wan))
    got = {k: v.detach().numpy() for k, v in params.wan.named_parameters()}
    assert set(ref) == set(got)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(ref[k], np.float32).reshape(got[k].shape),
                                      err_msg=k)
    companions = {k: v.detach().numpy() for k, v in params.companions.named_parameters()}
    if with_companions:
        jc = _flat(jax.tree_util.tree_map(np.asarray, expert.companions))
        assert set(jc) == set(companions)
        for k in jc:
            np.testing.assert_array_equal(companions[k], jc[k], err_msg=k)
    else:
        assert not expert.companions
        seeded = trainer.init_unified_companions(
            cfg, device="cpu", generator=torch.Generator().manual_seed(args.seed))
        ref_c = _flat(seeded)
        assert set(ref_c) == set(companions)
        for k in ref_c:
            np.testing.assert_array_equal(companions[k], ref_c[k], err_msg=k)
    argv = ["--dummy_data", "--tiny", "--device", "cpu", "--ckpt_dir", str(ckpt),
            "--output_dir", str(out), "--log_interval", "1", "--total_steps", "2"]
    assert finetune.main(argv) == 0
    lines = [json.loads(s) for s in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss/t2v"]) for r in lines)
