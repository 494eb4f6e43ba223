"""The port's SFT (training/sft.py) against JAX's on the CPU, on the JAX CLI's
`--tiny` Qwen3 and alignment chain with the weights carried across
(tests/torch_sft_tiny.py).

Tolerances: `lm_loss` within 1e-5 relative; over 3 steps of
`make_sft_step` (AdamW, warmup 1: the first update has lr 0 and leaves
every parameter bit-equal) the loss, lm/align losses and grad_norm within
1e-5 relative, the Adam moments within 1e-4 of their leaf's largest and
every parameter within 1e-5 of max(its leaf's largest, 1e-2) wherever the
JAX gradient was not rounding noise (`adam_checked`); collate, labels,
masks and loader orders equal JAX's exactly; the forward under autograd
(dense causal) within 1e-5 of scale of the inference one (the causal flash
kernel's plain twin), the MoE's gradients within 1e-5 of scale of the
all-experts oracle's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnivideo_tpu.training import sft as jsft
from omnivideo_tpu_torch.io import jax_bridge as jb
from omnivideo_tpu_torch.models.qwen3vl import text_model as ptext
from omnivideo_tpu_torch.training import sft as psft
from omnivideo_tpu_torch.training.lora import freeze_base, inject_lora_bare
from torch_qwen3vl_tiny import tiny_config
from torch_sft_tiny import SEQ, adam_checked, jax_setup, port_model, rel, samples

STEPS = 3
TOL = 1e-5
MOMENT_TOL = 1e-4  # the moments are the gradients' running sums: f32 products in other orders


def _batches(seed=0):
    s = samples(seed, n=2)
    return jsft.sft_collate(s, SEQ), psft.sft_collate(s, SEQ)


def test_lm_loss_matches_jax():
    jcfg, params = jax_setup(chain=False)
    model = port_model(jcfg, params)
    jbatch, pbatch = _batches()
    for mask in (True, False):
        kw = {"attn_mask": jbatch["attn_mask"]} if mask else {}
        ref, n_ref = jsft.lm_loss(jax.tree_util.tree_map(jnp.asarray, params["lm"]), jcfg,
                                  jbatch["ids"], jbatch["labels"], **kw)
        got, n = psft.lm_loss(model.lm, pbatch["ids"], pbatch["labels"],
                              pbatch["attn_mask"] if mask else None)
        assert abs(float(got.detach()) / float(ref) - 1) < TOL
        assert float(n) == float(n_ref)


def _jax_grads(opt_states):
    """Each step's clipped gradient from the Adam moments: (mu_t − b1 mu_{t−1}) / (1 − b1)."""
    mus = [jb.sft_params_to_state_dict(jax.tree_util.tree_map(np.asarray, s[1][0].mu))
           for s in opt_states]
    prev = {k: np.zeros_like(v) for k, v in mus[0].items()}
    out = []
    for mu in mus:
        out.append({k: (mu[k] - 0.9 * prev[k]) / 0.1 for k in mu})
        prev = mu
    return out


@pytest.mark.parametrize("align", [0.0, 1.0], ids=["lm_only", "combined"])
def test_sft_steps_match_jax(align):
    jcfg, params = jax_setup(chain=align > 0)
    tc = jsft.SFTConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, align_weight=align,
                        cosine_weight=0.5 if align else 0.0)
    tx = jsft.make_sft_optimizer(tc)
    state = jsft.init_sft_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax.jit(jsft.make_sft_step(jcfg, tc, tx))
    model = port_model(jcfg, params)
    ptc = psft.SFTConfig(**dataclasses.asdict(tc))
    ptx = psft.make_sft_optimizer(ptc)
    pstate = psft.init_sft_state(model, ptx)
    pstep = psft.make_sft_step(ptc, ptx)
    jbatch, pbatch = _batches()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt_states = []
    for s in range(STEPS):
        state, m = step(state, jbatch)
        pstate, pm = pstep(pstate, pbatch)
        assert set(pm) == set(m), (set(pm), set(m))
        for k in m:
            assert abs(float(pm[k]) / float(m[k]) - 1) < TOL, (s, k, float(pm[k]), float(m[k]))
        opt_states.append(state.opt_state)
        grads = _jax_grads(opt_states)
        ref = jb.sft_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
        got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        assert set(got) == set(ref)
        covered = 0.0
        for k in ref:
            if s == 0:  # lr 0 at count 0: nothing moves
                np.testing.assert_array_equal(got[k], start[k].numpy(), err_msg=k)
            err, share = adam_checked(got[k], ref[k], [g[k] for g in grads])
            assert err < TOL, (s, k, err)
            covered += share * ref[k].size
        assert covered > 0.5 * sum(v.size for v in ref.values()), covered
    mu, nu, count = jb.adamw_state_to_jax(
        pstate.opt_state, params.get("chain"))
    adam = state.opt_state[1][0]
    assert count == int(adam.count) == STEPS
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        got, want = jb.sft_params_to_state_dict(got), jb.sft_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, want))
        for k in want:
            assert rel(got[k], want[k]) < MOMENT_TOL, k


def test_adamw_state_carried_from_jax():
    """JAX's params and AdamW state after 2 steps carried into the port: its
    third step equals JAX's third step."""
    jcfg, params = jax_setup(chain=True)
    tc = jsft.SFTConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, align_weight=1.0)
    tx = jsft.make_sft_optimizer(tc)
    state = jsft.init_sft_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax.jit(jsft.make_sft_step(jcfg, tc, tx))
    jbatch, pbatch = _batches()
    for _ in range(2):
        state, _ = step(state, jbatch)
    mid = jax.tree_util.tree_map(np.asarray, state.params)
    adam = jax.tree_util.tree_map(np.asarray, state.opt_state[1][0])
    model = port_model(jcfg, mid)
    ptc = psft.SFTConfig(**dataclasses.asdict(tc))
    ptx = psft.make_sft_optimizer(ptc)
    pstate = psft.init_sft_state(model, ptx)
    pstate.opt_state = jb.adamw_state_from_jax(adam.mu, adam.nu, int(adam.count))
    prev_mu = jb.sft_params_to_state_dict(adam.mu)
    state, m = step(state, jbatch)
    pstate, pm = psft.make_sft_step(ptc, ptx)(pstate, pbatch)
    assert abs(float(pm["loss"]) / float(m["loss"]) - 1) < TOL
    ref = jb.sft_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    new_mu = jb.sft_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                 state.opt_state[1][0].mu))
    for k, v in model.state_dict().items():
        g = (new_mu[k] - 0.9 * prev_mu[k]) / 0.1
        err, _ = adam_checked(v.detach().numpy(), ref[k], [g])
        assert err < TOL, (k, err)


def test_schedule_matches_optax():
    for warmup, total in ((100, 1000), (1, 10), (0, 5), (100, 4), (3, 3)):
        tc = psft.SFTConfig(learning_rate=2e-5, warmup_steps=warmup, total_steps=total)
        ref = optax.warmup_cosine_decay_schedule(0.0, 2e-5, warmup, max(total, warmup + 1))
        sched = psft.sft_schedule(tc)
        for count in (0, 1, 2, warmup - 1, warmup, warmup + 1, total - 1, total, total + 5):
            if count >= 0:
                assert abs(sched(count) - float(ref(count))) <= 1e-6 * 2e-5, (warmup, total,
                                                                                count)


def test_build_sft_labels_matches_jax():
    ids = np.random.default_rng(1).integers(0, 9, (3, 11)).astype(np.int32)
    plens = np.array([0, 4, 11])
    for pad in (None, 0):
        ref = np.asarray(jsft.build_sft_labels(jnp.asarray(ids), jnp.asarray(plens), pad))
        got = psft.build_sft_labels(torch.from_numpy(ids), torch.from_numpy(plens), pad)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_collate_and_dataset_match_jax(tmp_path):
    s = samples(2, n=3)
    s[1] = {"ids": s[1]["ids"], "labels": np.where(np.arange(len(s[1]["ids"])) % 3,
                                                   s[1]["ids"], -100).astype(np.int32)}
    for seq in (SEQ, 10):  # padded, and cut
        ref = jsft.sft_collate(s, seq, pad_id=5)
        got = psft.sft_collate(s, seq, pad_id=5)
        assert set(got) == {"ids", "labels", "attn_mask"}
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    full = samples(3, n=3)
    for i, x in enumerate(full):
        np.savez(tmp_path / f"sample_{i}.npz", **x)
    ds, jds = psft.SFTDataset(str(tmp_path)), jsft.SFTDataset(str(tmp_path))
    assert len(ds) == len(jds) == 3
    ref, got = jsft.sft_collate([jds[i] for i in range(3)], SEQ), psft.sft_collate(
        [ds[i] for i in range(3)], SEQ)
    assert set(got) == set(ref) == {"ids", "labels", "attn_mask", "vlm", "target"}
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


class _Lengths(list):
    """A dataset of `n` tiny samples exposing lengths / modality_lengths."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        super().__init__({"ids": np.arange(2 + i % 5, dtype=np.int32) + i, "prompt_len": 1}
                         for i in range(n))
        self.lengths = rng.integers(1, 50, n).tolist()
        self.modality_lengths = [l if i % 3 else -l for i, l in enumerate(self.lengths)]


@pytest.mark.parametrize("mode", ["plain", "length", "modality"])
def test_loader_orders_match_jax(mode):
    ds = _Lengths(23, 4)
    kw = dict(group_by_length=mode == "length", group_by_modality=mode == "modality",
              world_size=2)
    ref = jsft.sft_data_loader(ds, 3, 8, seed=7, **kw)
    got = psft.sft_data_loader(ds, 3, 8, seed=7, **kw)
    for _ in range(20):  # past one pass: the reshuffle too
        np.testing.assert_array_equal(next(got)["ids"].numpy(), np.asarray(next(ref)["ids"]))


def test_mixture_matches_jax():
    a, b = _Lengths(7, 1), _Lengths(10, 2)
    for weights in (None, [2.0, 0.5], [0.3, 1.7]):
        ref = jsft.MixtureDataset([a, b], weights, seed=3)
        got = psft.MixtureDataset([a, b], weights, seed=3)
        assert got.index == ref.index
        assert got.lengths == ref.lengths and got.modality_lengths == ref.modality_lengths
    ref = jsft.sft_data_loader(jsft.MixtureDataset([a, b], [2.0, 0.5]), 4, 8,
                               group_by_modality=True)
    got = psft.sft_data_loader(psft.MixtureDataset([a, b], [2.0, 0.5]), 4, 8,
                               group_by_modality=True)
    for _ in range(8):
        np.testing.assert_array_equal(next(got)["ids"].numpy(), np.asarray(next(ref)["ids"]))


def test_bare_lora_sft_moves_only_adapters():
    """The port of tests/test_lora.py's case: bare adapters on the tiny
    Qwen3, the base frozen; two steps move the adapters and nothing else."""
    jcfg, params = jax_setup(chain=False)
    model = port_model(jcfg, params)
    inject_lora_bare(model.lm, rank=4, generator=torch.Generator().manual_seed(1))
    freeze_base(model.lm)
    tc = psft.SFTConfig(learning_rate=1e-3, max_grad_norm=1.0, warmup_steps=1, total_steps=10)
    tx = psft.make_sft_optimizer(tc)
    state = psft.init_sft_state(model, tx)
    step = psft.make_sft_step(tc, tx)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12)))
    batch = {"ids": ids, "labels": psft.build_sft_labels(ids, torch.tensor([2, 3]))}
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for _ in range(2):
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
    changed = unchanged = 0
    for k, v in model.state_dict().items():
        same = torch.equal(v, before[k])
        if k.endswith(("lora_a", "lora_b")):
            changed += 0 if same else 1
        else:
            assert same, f"frozen leaf moved: {k}"
            unchanged += 1
    assert changed > 0 and unchanged > 0
    assert set(state.opt_state["mu"]) == {k for k in before if k.endswith(("lora_a", "lora_b"))}


def test_forward_dispatch_on_grad_mode():
    """Under autograd the causal forward takes the dense path; without, the
    causal flash twin: the two agree, and the gradients flow."""
    jcfg, params = jax_setup(chain=False)
    model = port_model(jcfg, params)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 13)))
    _, inf = ptext.qwen3_forward(model.lm, ids)
    with torch.no_grad():
        _, nograd = ptext.qwen3_forward_trainable(model.lm, ids)
    _, train = ptext.qwen3_forward_trainable(model.lm, ids)
    assert rel(nograd.numpy(), inf.numpy()) == 0  # both the flash twin
    assert train.requires_grad and not inf.requires_grad
    assert rel(train.detach().numpy(), inf.numpy()) < TOL
    train.sum().backward()
    assert all(p.grad is not None for p in model.lm.parameters())


def test_moe_gradients_match_dense_oracle():
    """The grouped MoE (its expert banks unbound once) under autograd: the
    input's and every bank's gradient against moe_dense's."""
    cfg = tiny_config(moe=True).text
    lm = ptext.Qwen3LM(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    mlp = lm.language_model.layers[0].mlp
    x0 = torch.randn(2, 7, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    out = {}
    for name, fn in (("grouped", ptext.moe), ("dense", ptext.moe_dense)):
        mlp.zero_grad()
        x = x0.clone().requires_grad_(True)
        y = fn(mlp, x)
        (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
        out[name] = [y.detach(), x.grad] + [p.grad.clone() for p in mlp.parameters()]
    for got, want in zip(out["grouped"], out["dense"]):
        assert rel(got.numpy(), want.numpy()) < TOL

