"""The port's plain flow-matching step over the DiT alone (`make_train_step`:
a text context, CFG dropout swapping in `uncond_context` per sample) against
JAX `make_train_step` (attn_impl="xla"), 2 steps from the same params, batch
and JAX draws. Tolerances as in tests/test_torch_train.py (f32: 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_tiny as tiny
from omnivideo_tpu.training import trainer as jax_trainer
from omnivideo_tpu_torch.io.jax_bridge import wan_params_to_state_dict
from omnivideo_tpu_torch.training import trainer

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_plain_train_step_matches_jax():
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, cfg_dropout=0.5, remat=False)
    jtc, tc = jax_trainer.TrainConfig(**kw), trainer.TrainConfig(**kw)
    params = tiny.jax_params()["wan"]
    tx = jax_trainer.make_optimizer(jtc)
    state = jax_trainer.init_train_state(params, tx)
    step = jax.jit(jax_trainer.make_train_step(tiny.JCFG, jtc, tx, attn_impl="xla"))

    wan = tiny.port_params(tiny.jax_params()).wan
    ptx = trainer.make_optimizer(tc)
    pstate = trainer.init_train_state(wan, ptx)
    pstep = trainer.make_train_step(tiny.CFG, tc, ptx)
    b = tiny.batch(5)
    rng = np.random.default_rng(6)
    batch = {"latents": b["latents"], "context": b["context"],
             "uncond_context": rng.standard_normal(b["context"].shape).astype(np.float32)}
    for s in range(2):
        key, draws = tiny.jax_draws(s, jtc)
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        pstate, pm = pstep(pstate, {k: torch.tensor(v) for k, v in batch.items()}, draws)
        assert abs(float(pm["loss"]) / float(m["loss"]) - 1) < TOL
        assert abs(float(pm["grad_norm"]) / float(m["grad_norm"]) - 1) < TOL
        ref = {k: torch.tensor(v) for k, v in
               wan_params_to_state_dict(tiny.np_tree(state.params)).items()}
        worst = tiny.worst_rel(dict(wan.named_parameters()), ref, floor=1e-2)
        assert worst[0] < TOL, (s, worst)
