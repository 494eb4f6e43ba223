"""The port's adafactor (training/trainer.py `_AdafactorRule` inside
`Optimizer`) against JAX's `make_optimizer(optimizer="adafactor")`
(optax.adafactor with its defaults, then `_lr_scaled_decay`) on the CPU.

A tiny unified tree wide enough that its block kernels are factored (both
per-layer dims ≥ 128: JAX's leaves are [L, 128, 128] and [L, 128, 256]),
the same seeded grads each step through both optimizers, warm-up then
cosine, weight decay 0.01, the global-norm clip at 1.0. Tolerance: every
parameter within 1e-6 of its scale after 5 steps, and the 5 steps'
movement within 1e-4 of its own scale (f32; the row/column means and the
block RMS sum in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.unified import init_unified_companions
from omnivideo_tpu.models.wan_dit import init_wan_dit
from omnivideo_tpu.training import lora as jlora
from omnivideo_tpu.training import trainer as jtrainer
from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import load_unified, unified_params_to_state_dict
from omnivideo_tpu_torch.training import trainer

DIT = dict(in_dim=4, dim=128, ffn_dim=256, freq_dim=32, text_dim=48, out_dim=4, num_heads=2,
           num_layers=2)
PIPE = dict(vlm_in_dim=16, max_context_len=64)
JCFG = JaxPipelineConfig(dit=JaxDiTConfig(**DIT), vae=JaxVAEConfig(z_dim=4), **PIPE)
CFG = PipelineConfig(dit=WanDiTConfig(**DIT), vae=VAEConfig(z_dim=4), **PIPE)
STEPS = 5
TOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_params(lora_rank: int = 0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    wan = init_wan_dit(k1, JCFG.dit.replace(text_len=JCFG.max_context_len), dtype=jnp.float32)
    if lora_rank:
        wan = jlora.inject_lora(wan, k3, lora_rank)
        wan = jax.tree_util.tree_map_with_path(  # B = 0 would keep A's grads at 0
            lambda p, a: a + 0.01 if "lora_b" in jax.tree_util.keystr(p) else a, wan)
    return {"wan": wan, "companions": init_unified_companions(k2, JCFG)}


def seeded_grads(params, step: int):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.01 * rng.standard_normal(a.shape), jnp.float32), params)


def port_model(params, lora_rank: int = 0):
    model = trainer.init_unified_params(CFG, device="cpu")
    if lora_rank:
        from omnivideo_tpu_torch.training.lora import inject_lora

        inject_lora(model.wan, lora_rank)
    return load_unified(model, unified_params_to_state_dict(_np(params)))


def port_names(tree, model):
    """A JAX tree (params, grads) under the port's names and shapes."""
    shapes = {n: p.shape for n, p in model.named_parameters()}
    return {k: torch.tensor(v).reshape(shapes[k])
            for k, v in unified_params_to_state_dict(_np(tree)).items() if k in shapes}


def run_both(tc_kw, lora_rank: int = 0, trainable_filters=()):
    params = jax_params(lora_rank)
    model = port_model(params, lora_rank)
    jtc = jtrainer.TrainConfig(optimizer="adafactor", trainable_filters=trainable_filters, **tc_kw)
    ptc = trainer.TrainConfig(optimizer="adafactor", trainable_filters=trainable_filters, **tc_kw)
    tx = jtrainer.make_optimizer(jtc, params)
    jstate = tx.init(params)
    update = jax.jit(tx.update)
    ptx = trainer.make_optimizer(ptc, model)
    pstate = ptx.init(model)
    p0 = port_names(params, model)
    for s in range(STEPS):
        g = seeded_grads(params, s)
        up, jstate = update(g, jstate, params)
        params = optax.apply_updates(params, up)
        ptx.update(model, port_names(g, model), pstate)
    return port_names(params, model), dict(model.named_parameters()), p0, pstate


def _check(ref, got, p0, names=None):
    worst_p = worst_u = 0.0
    for n, r in ref.items():
        if names is not None and n not in names:
            continue
        q = got[n].detach()
        worst_p = max(worst_p, float((q - r).abs().max() / r.abs().max().clamp_min(1e-30)))
        move = r - p0[n]
        if float(move.abs().max()) > 0:
            worst_u = max(worst_u, float(((q - p0[n]) - move).abs().max() / move.abs().max()))
    assert worst_p <= TOL, worst_p
    assert worst_u <= 1e-4, worst_u


def test_adafactor_matches_optax():
    ref, got, p0, state = run_both(dict(learning_rate=1e-3, weight_decay=0.01, grad_clip=1.0,
                                        warmup_steps=2, total_steps=8))
    fac = state["factored"]
    assert "wan.blocks.0.self_attn.q.weight" in fac and "wan.blocks.1.ffn.0.weight" in fac
    assert "wan.blocks.0.self_attn.q.bias" in state["v"]  # [L, d]: not factored in JAX
    assert state["count"] == STEPS
    _check(ref, got, p0)


def test_adafactor_decay_is_lr_scaled():
    """A near-zero grad: the update is the lr-scaled decay lr·wd·p, not
    optax's own (unscaled) weight_decay_rate (JAX test_training.py's
    test_adafactor_weight_decay_is_lr_scaled), and it equals JAX's."""
    params = jax_params()
    model = port_model(params)
    kw = dict(learning_rate=3e-4, weight_decay=0.01, warmup_steps=0, total_steps=100,
              grad_clip=1e9, optimizer="adafactor")
    tx = jtrainer.make_optimizer(jtrainer.TrainConfig(**kw), params)
    g = jax.tree_util.tree_map(lambda a: jnp.full(a.shape, 1e-30, jnp.float32), params)
    up, _ = jax.jit(tx.update)(g, tx.init(params), params)
    ref = port_names(optax.apply_updates(params, up), model)
    p0 = port_names(params, model)
    ptx = trainer.make_optimizer(trainer.TrainConfig(**kw), model)
    ptx.update(model, port_names(g, model), ptx.init(model))
    got = dict(model.named_parameters())
    w = "wan.blocks.0.self_attn.q.weight"
    per_step = float((got[w].detach() - p0[w]).abs().mean())
    assert 1e-7 < per_step < 5e-5, per_step
    _check(ref, got, p0)


def test_adafactor_with_trainable_filters():
    ref, got, p0, state = run_both(dict(learning_rate=1e-3, weight_decay=0.01, grad_clip=1.0,
                                        warmup_steps=1, total_steps=8),
                                   trainable_filters=("cross_attn", "companions"))
    moved = {n for n, p in got.items() if not torch.equal(p.detach(), p0[n])}
    assert moved and all(".cross_attn." in n or n.startswith("companions.") for n in moved)
    assert set(state["v"]) | set(state["v_row"]) <= set(trainer.trainable_names(
        port_model(jax_params()), ("cross_attn", "companions")))
    _check(ref, got, p0)


def test_adafactor_with_lora():
    """LoRA's adapters ([L, 128, 4] leaves, not factored) under adafactor,
    the base frozen by LORA_FILTERS."""
    from omnivideo_tpu_torch.training.lora import LORA_FILTERS

    ref, got, p0, state = run_both(dict(learning_rate=1e-3, weight_decay=0.01, grad_clip=1.0,
                                        warmup_steps=1, total_steps=8), lora_rank=4,
                                   trainable_filters=LORA_FILTERS)
    assert set(state["v"]) == {n for n in got if n.endswith(("lora_a", "lora_b"))}
    for n, p in got.items():
        if not n.endswith(("lora_a", "lora_b")):
            assert torch.equal(p.detach(), p0[n]), n
    _check(ref, got, p0)


def test_adafactor_rejects_unknown_optimizer():
    with pytest.raises(ValueError, match="sgd"):
        trainer.make_optimizer(trainer.TrainConfig(optimizer="sgd"))
