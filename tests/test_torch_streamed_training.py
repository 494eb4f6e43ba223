"""The port's streamed trainers (omnivideo_tpu_torch/training/streaming.py)
on the CPU, against the port's resident `make_train_step` and against JAX's
`StreamedTrainer` / `StreamedLoRATrainer` from the same weights, batch and
draws (JAX's, passed in: torch cannot reproduce threefry).

Tolerances are JAX's own (tests/test_streamed_training.py): loss 1e-5 and
grad_norm 1e-4 relative; parameters rtol 2e-4 / atol 1e-7 after one step
(adapters after two: 2e-4 of each leaf's scale, `assert_leaf_close`), 3e-3 / 1e-5 after three adafactor steps (its
factored statistics amplify f32 summation-order differences). Against the
port's resident step the adafactor parameters are held to 2e-4 as well:
the resident rule takes adafactor's parameter and update RMS over each JAX
leaf, which stacks the layers, the streamed one per block, as JAX's
streamed trainer does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.training import streaming as jstream
from omnivideo_tpu_torch.io.jax_bridge import streamed_state_from_jax
from omnivideo_tpu_torch.pipelines.streaming import host_block_targets
from omnivideo_tpu_torch.training.checkpoint import CheckpointManager
from omnivideo_tpu_torch.training.lora import LORA_FILTERS
from omnivideo_tpu_torch.training.streaming import StreamedLoRATrainer, StreamedTrainer
from torch_stream_tiny import (CFG, JCFG, assert_close, configs, draws, jax_batch, jax_named,
                               jax_params, port_dit, port_named, resident_run)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("opt,offload", [("adamw", False), ("adamw", True), ("adafactor", False),
                                         ("adafactor", True)])
def test_streamed_step_matches_resident_and_jax(opt, offload):
    jtc, tc = configs(optimizer=opt)
    params = jax_params()
    jb, b = jax_batch()
    key, d = draws(3, jtc)
    jst = jstream.StreamedTrainer(JCFG, jtc, attn_impl="xla", act_offload=offload)
    js, jm = jst.train_step(jst.init_state(params), jb, key)
    st = StreamedTrainer(CFG, tc, act_offload=offload, device="cpu")
    s, m = st.train_step(st.init_state(port_dit(params)), b, d)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got = port_named(s)
    assert_close(got, jax_named(js), 2e-4, 1e-7)
    (rm,), rp = resident_run(tc, params, b, [d])
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
    assert_close(got, {k: v.numpy() for k, v in rp.items()}, 2e-4, 1e-7)


def test_streamed_clip_engages_globally():
    """A clip threshold below the norm: the factor comes from the global
    norm over every block and resident leaf (a per-block clip would not
    match)."""
    jtc, tc = configs(grad_clip=1e-3)
    params = jax_params()
    jb, b = jax_batch()
    key, d = draws(3, jtc)
    st = StreamedTrainer(CFG, tc, act_offload=False, device="cpu")
    s, m = st.train_step(st.init_state(port_dit(params)), b, d)
    assert float(m["grad_norm"]) > tc.grad_clip
    jst = jstream.StreamedTrainer(JCFG, jtc, attn_impl="xla", act_offload=False)
    js, _ = jst.train_step(jst.init_state(params), jb, key)
    assert_close(port_named(s), jax_named(js), 2e-4, 1e-7)
    _, rp = resident_run(tc, params, b, [d])
    assert_close(port_named(s), {k: v.numpy() for k, v in rp.items()}, 2e-4, 1e-7)


def test_streamed_fused_update_no_clip():
    """grad_clip=0 updates each block in pass A (no pass B): the no-clip
    step of JAX's fused trainer and of the port's resident step."""
    jtc, tc = configs(grad_clip=0.0, optimizer="adafactor")
    params = jax_params()
    jb, b = jax_batch()
    key, d = draws(3, jtc)
    st = StreamedTrainer(CFG, tc, act_offload=True, device="cpu")
    s, m = st.train_step(st.init_state(port_dit(params)), b, d)
    jst = jstream.StreamedTrainer(JCFG, jtc, attn_impl="xla", act_offload=True)
    js, jm = jst.train_step(jst.init_state(params), jb, key)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_close(port_named(s), jax_named(js), 2e-4, 1e-7)
    _, rp = resident_run(tc, params, b, [d])
    assert_close(port_named(s), {k: v.numpy() for k, v in rp.items()}, 2e-4, 1e-7)


def test_streamed_multi_step_with_cfg_dropout():
    """Three adafactor steps with CFG dropout and weight decay: the count,
    the schedule and the swapped context stay in step with JAX."""
    jtc, tc = configs(cfg_dropout=0.5, warmup_steps=1, optimizer="adafactor",
                      weight_decay=0.01)
    params = jax_params()
    jb, b = jax_batch(uncond=True)
    jst = jstream.StreamedTrainer(JCFG, jtc, attn_impl="xla", act_offload=True)
    st = StreamedTrainer(CFG, tc, act_offload=True, device="cpu")
    js, s = jst.init_state(params), st.init_state(port_dit(params))
    dropped = 0
    for k in range(3):
        key, d = draws(100 + k, jtc)
        dropped += int(d[2].sum())
        js, jm = jst.train_step(js, jb, key)
        s, m = st.train_step(s, b, d)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert 0 < dropped < 6 and s.step == 3
    assert_close(port_named(s), jax_named(js), 3e-3, 1e-5)


def test_streamed_q8_plumbing_exact_when_nothing_quantizes():
    """stream_quant="int8" with f32 masters (no leaf is eligible): the q8
    path (its streams, the gradient fetch and the host-CPU update) gives
    the exact step."""
    _, tc = configs(grad_clip=0.5)
    params = jax_params()
    _, b = jax_batch()
    d = draws(3, configs()[0])[1]
    ref = StreamedTrainer(CFG, tc, act_offload=False, device="cpu")
    q8 = StreamedTrainer(CFG, tc, act_offload=False, device="cpu", stream_quant="int8")
    s_ref, m_ref = ref.train_step(ref.init_state(port_dit(params)), b, d)
    s_q8, m_q8 = q8.train_step(q8.init_state(port_dit(params)), b, d)
    assert float(m_ref["loss"]) == float(m_q8["loss"])
    got, want = port_named(s_q8), port_named(s_ref)
    assert_close(got, {k: v.numpy() for k, v in want.items()}, 1e-6, 1e-7)


def test_streamed_q8_step_close_to_exact_bf16():
    """bf16 masters: the q8 diet's grads are taken at the int8 weights and
    cross as int8, yet its update points the exact one's way (cosine >
    0.98) and its loss is within 2%."""
    _, tc = configs(grad_clip=0.5)
    params = jax_params(jnp.bfloat16)
    _, b = jax_batch()
    d = draws(3, configs()[0])[1]
    bf16 = dataclasses.replace(CFG, param_dtype="bfloat16")
    ref = StreamedTrainer(bf16, tc, act_offload=False, device="cpu")
    q8 = StreamedTrainer(bf16, tc, act_offload=False, device="cpu", stream_quant="int8")
    s_ref = ref.init_state(port_dit(params, torch.bfloat16))
    p0 = {k: v.float().clone() for k, v in host_block_targets(s_ref.resident).items()}
    s_ref, m_ref = ref.train_step(s_ref, b, d)
    s_q8, m_q8 = q8.train_step(q8.init_state(port_dit(params, torch.bfloat16)), b, d)
    assert abs(float(m_ref["loss"]) - float(m_q8["loss"])) <= 0.02 * abs(float(m_ref["loss"]))
    ur, uq = (torch.cat([(v.float() - p0[k]).ravel()
                         for k, v in host_block_targets(st.resident).items()])
              for st in (s_ref, s_q8))
    assert float(ur.norm()) > 0
    assert float(ur @ uq / (ur.norm() * uq.norm())) > 0.98


@pytest.mark.parametrize("lora", [False, True])
def test_checkpoint_resume_equals_uninterrupted(tmp_path, lora):
    """Two steps, save, restore into a fresh state, a third step: the same
    parameters (adapters) as three uninterrupted steps."""
    jtc, tc = configs(trainable_filters=LORA_FILTERS if lora else ())
    params = jax_params(lora_rank=4 if lora else 0)
    _, b = jax_batch()
    make = (lambda: StreamedLoRATrainer(CFG, tc, device="cpu")) if lora else (
        lambda: StreamedTrainer(CFG, tc, device="cpu"))

    def run(n, tr=None, state=None):
        tr = tr or make()
        state = state or tr.init_state(port_dit(params))
        for k in range(state.step, n):
            state, _ = tr.train_step(state, b, draws(100 + k, jtc)[1])
        return state

    full = run(3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, run(2), {"step": 2})
    tr = make()
    fresh = tr.init_state(port_dit(jax_params(lora_rank=4 if lora else 0)))
    state = mgr.restore(fresh)
    assert state.step == 2
    resumed = run(3, tr, state)
    if lora:
        for k, v in full.lora.items():
            assert torch.equal(v, resumed.lora[k]), k
    else:
        a, r = port_named(full), port_named(resumed)
        for k in a:
            assert torch.equal(a[k], r[k]), k


@pytest.mark.parametrize("lora", [False, True])
def test_state_from_jax_continues_jax(lora):
    """A JAX streamed state after one step (AdamW), carried into the port by
    io/jax_bridge.py `streamed_state_from_jax`: the second step of both
    packages from there agrees."""
    jtc, tc = configs(trainable_filters=LORA_FILTERS if lora else ())
    params = jax_params(lora_rank=4 if lora else 0)
    jb, b = jax_batch()
    jst = (jstream.StreamedLoRATrainer(JCFG, jtc, attn_impl="xla") if lora else
           jstream.StreamedTrainer(JCFG, jtc, attn_impl="xla"))
    js, _ = jst.train_step(jst.init_state(params), jb, draws(100, jtc)[0])
    st = StreamedLoRATrainer(CFG, tc, device="cpu") if lora else StreamedTrainer(CFG, tc,
                                                                                  device="cpu")
    s = streamed_state_from_jax(st, js, device="cpu")
    assert s.step == 1
    key, d = draws(101, jtc)
    js, jm = jst.train_step(js, jb, key)
    s, m = st.train_step(s, b, d)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    if not lora:
        assert_close(port_named(s), jax_named(js), 2e-4, 1e-7)
