"""The port's optimizer semantics against optax, through the train step:
freezing (`trainable_filters`, optax.masked) inside gradient accumulation
(grad_accum_steps = 2, optax.MultiSteps), against JAX's
`make_unified_train_step` with the JAX draws passed in; and the
warmup-cosine schedule against optax's. Same tiny setup and tolerances as
tests/test_torch_train.py; frozen params must not move at all."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_train_tiny as tiny
from omnivideo_tpu.training import trainer as jax_trainer
from omnivideo_tpu_torch.training import trainer

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_freezing_with_grad_accumulation_matches_jax():
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, cfg_dropout=0.5,
              remat=False, grad_accum_steps=2, trainable_filters=("companions", "cross_attn"))
    jtc, tc = jax_trainer.TrainConfig(**kw), trainer.TrainConfig(**kw)
    params = tiny.jax_params()
    tx = jax_trainer.make_optimizer(jtc, params)
    state = jax_trainer.init_train_state(params, tx)
    step = jax.jit(jax_trainer.make_unified_train_step(tiny.JCFG, jtc, tx, attn_impl="xla"))

    model = tiny.port_params(params)
    ptx = trainer.make_optimizer(tc, model)
    pstate = trainer.init_train_state(model, ptx)
    pstep = trainer.make_unified_train_step(tiny.CFG, tc, ptx)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainable = trainer.trainable_names(model, tc.trainable_filters)
    assert any(n.startswith("companions.") for n in trainable)
    assert any(".cross_attn." in n for n in trainable)
    assert not any(".self_attn." in n or ".ffn." in n for n in trainable)
    b = tiny.batch(3)
    for s in range(4):  # two micro-batches per update: applies after calls 2 and 4
        key, draws = tiny.jax_draws(s, jtc, one_drop=False)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        pstate, pm = pstep(pstate, {k: torch.tensor(v) for k, v in b.items()}, draws)
        assert abs(float(pm["loss"]) / float(m["loss"]) - 1) < TOL
        assert abs(float(pm["grad_norm"]) / float(m["grad_norm"]) - 1) < TOL
        now = dict(model.named_parameters())
        worst = tiny.worst_rel(now, tiny.to_port_names(state.params), floor=1e-2)
        assert worst[0] < TOL, (s, worst)
        moved = {n for n in now if not torch.equal(now[n], start[n])}
        assert moved <= trainable
        assert bool(moved) == (s >= 1), (s, len(moved))
        assert pstate.opt_state["count"] == (s + 1) // 2
    assert set(pstate.opt_state["mu"]) == trainable


@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 10), (4, 10), (500, 3), (7, 7)])
def test_lr_schedule_matches_optax(warmup, total):
    """warmup clamped to total − 1, decay max(total, warmup + 1), evaluated
    at the pre-increment count. optax evaluates the cosine in f32, the port
    in f64 rounded once: within 1e-6 relative (a few f32 ulps)."""
    tc = trainer.TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    w = min(warmup, max(total - 1, 0))
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, w, max(total, w + 1))
    sched = trainer.lr_schedule(tc)
    for count in range(total + 3):
        np.testing.assert_allclose(sched(count), float(ref(jnp.int32(count))), rtol=1e-6,
                                   atol=1e-12)
