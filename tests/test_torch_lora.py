"""The port's LoRA (training/lora.py) against JAX's on the CPU: the dense
layout on the tiny DiT (inject, strip, merge, extract/apply, the adapter
.npz both ways, the LoRA train step) and the bare layout on the tiny
Qwen3-VL text stack and vision tower (tests/torch_qwen3vl_tiny.py).

Tolerances (f32): B = 0 and strip bit-equal; merged against adapter
forward within 2e-5 (rtol and atol, JAX test_lora.py's); port against JAX
on the same carried adapters within test_torch_wan_dit.py's 1e-5 of scale;
the LoRA step's loss within 1e-5 relative and its updated adapters within
1e-5 of max(their largest magnitude, 1e-2) (test_torch_train.py's floor);
Qwen3 logits within 1e-5 of scale, greedy tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_tiny as tiny
from omnivideo_tpu.models.qwen3vl import text_model as jtext
from omnivideo_tpu.models.qwen3vl.vision_model import vision_forward
from omnivideo_tpu.models.wan_dit import wan_dit_apply
from omnivideo_tpu.training import lora as jlora
from omnivideo_tpu.training import trainer as jax_trainer
from omnivideo_tpu_torch.io.jax_bridge import (
    load_qwen3vl,
    load_wan_state_dict,
    qwen3vl_params_to_state_dict,
    wan_params_to_state_dict,
)
from omnivideo_tpu_torch.models.qwen3vl import text_model as ptext
from omnivideo_tpu_torch.models.qwen3vl.full_model import Qwen3VLModel
from omnivideo_tpu_torch.models.wan_dit import WanDiT
from omnivideo_tpu_torch.training import lora, trainer
from torch_qwen3vl_tiny import build, scale_err, tiny_config

TOL = 1e-5
MERGE_TOL = 2e-5


def _bump(tree, by):
    """B += by at every adapter (both layouts)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a + by if jax.tree_util.keystr(p).endswith(("lora_b']", "_lora_b']"))
        else a, tree)


def _port_dit(wan_params):
    dit = WanDiT(tiny.JCFG.dit.replace(text_len=tiny.JCFG.max_context_len), torch.float32,
                 device="cpu")
    return load_wan_state_dict(dit, wan_params_to_state_dict(tiny.np_tree(wan_params)))


def _dit_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, tiny.JCFG.max_context_len, 48)).astype(np.float32)
    return x, np.array([500.0], np.float32), ctx


def _port_fwd(dit, seed=0, qk_impl="unfused"):
    x, t, ctx = (torch.tensor(a) for a in _dit_inputs(seed))
    with torch.no_grad():
        return dit(x, t, ctx, qk_impl=qk_impl).numpy()


def _jax_fwd(wan, seed=0):
    x, t, ctx = (jnp.asarray(a) for a in _dit_inputs(seed))
    cfg = tiny.JCFG.dit.replace(text_len=tiny.JCFG.max_context_len)
    return np.asarray(wan_dit_apply(wan, cfg, x, t, ctx, attn_impl="xla"))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_inject_strip_merge_extract_dense():
    dit = _port_dit(tiny.jax_params()["wan"])
    base_sd = {k: v.clone() for k, v in dit.state_dict().items()}
    y0 = _port_fwd(dit)
    lora.inject_lora(dit, 4, generator=torch.Generator().manual_seed(1))
    assert lora.count_lora_params(dit) > 0
    adapted = {s.path for s in lora.sites(dit) if lora.has_lora(s.lin)}
    assert adapted == {"blocks/self_attn/q", "blocks/self_attn/k", "blocks/self_attn/v",
                       "blocks/self_attn/o", "blocks/cross_attn/q", "blocks/cross_attn/k",
                       "blocks/cross_attn/v", "blocks/cross_attn/o", "blocks/ffn/fc1",
                       "blocks/ffn/fc2"}
    np.testing.assert_array_equal(_port_fwd(dit), y0)  # B = 0
    with torch.no_grad():
        for m in dit.modules():
            if lora.has_lora(m):
                m.lora_b += 0.02
    y_ad = _port_fwd(dit)
    assert not np.allclose(y_ad, y0)
    state = lora.extract_lora(dit)
    assert state["blocks/self_attn/q"]["lora_a"].shape == (2, 64, 4)
    assert state["blocks/ffn/fc1"]["lora_b"].shape == (2, 4, 128)
    np.testing.assert_array_equal(state["blocks/ffn/fc2"]["lora_scale"], [1.0, 1.0])
    regraft = lora.apply_lora_state(lora.strip_lora(_port_dit(tiny.jax_params()["wan"])), state)
    np.testing.assert_array_equal(_port_fwd(regraft), y_ad)
    lora.merge_lora(dit)
    assert not any("lora" in k for k in dit.state_dict())
    np.testing.assert_allclose(_port_fwd(dit), y_ad, rtol=MERGE_TOL, atol=MERGE_TOL)
    stripped = lora.strip_lora(_port_dit(tiny.jax_params()["wan"]))
    for k, v in stripped.state_dict().items():
        torch.testing.assert_close(v, base_sd[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no dense sites"):
        lora.inject_lora(_port_dit(tiny.jax_params()["wan"]), 2, targets=("no/such/site",))


@pytest.mark.parametrize("qk_impl", ["unfused", "kernel"])
def test_dense_adapters_match_jax(qk_impl):
    """JAX's injected adapters (B perturbed) carried by the bridge: the
    port's forward, unfused and on the fused prologue path, equals JAX's."""
    wan = _bump(jlora.inject_lora(tiny.jax_params()["wan"], jax.random.PRNGKey(1), 4,
                                  alpha=8.0), 0.02)
    dit = _port_dit(wan)
    assert float(dit.blocks[1].ffn[2].lora_scale) == 2.0
    assert _rel(_port_fwd(dit, qk_impl=qk_impl), _jax_fwd(wan)) < TOL
    merged = _port_dit(jlora.merge_lora(wan))
    ours = _port_dit(wan)
    lora.merge_lora(ours)
    for k, v in merged.state_dict().items():
        torch.testing.assert_close(ours.state_dict()[k], v, rtol=1e-6, atol=1e-7)


def test_adapter_npz_both_ways(tmp_path):
    wan = _bump(jlora.inject_lora(tiny.jax_params()["wan"], jax.random.PRNGKey(1), 4), 0.01)
    jlora.save_adapters_npz(wan, str(tmp_path / "jax.npz"))
    dit = lora.apply_lora_state(_port_dit(jlora.strip_lora(wan)),
                                lora.load_adapters_npz(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(_port_fwd(dit), _port_fwd(_port_dit(wan)))
    n = lora.save_adapters_npz(dit, tmp_path / "port.npz")
    assert n == jlora.save_adapters_npz(wan, str(tmp_path / "again.npz"))
    back = jlora.load_adapters_npz(str(tmp_path / "port.npz"))
    ref = jlora.extract_lora(wan)
    assert set(back) == set(ref)
    for p, keys in ref.items():
        assert set(back[p]) == set(keys)
        for k, v in keys.items():
            np.testing.assert_array_equal(np.asarray(back[p][k]), np.asarray(v))
    regraft = jlora.apply_lora_state(jlora.strip_lora(wan), back)
    np.testing.assert_array_equal(_jax_fwd(regraft), _jax_fwd(wan))


def test_lora_train_step_matches_jax():
    """JAX test_lora.py's LoRA step (LORA_FILTERS, adapters only): the port
    with the base frozen (`freeze_base`) takes the same steps."""
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20, cfg_dropout=0.5, grad_clip=1.0,
              remat=False, trainable_filters=jlora.LORA_FILTERS)
    jtc, tc = jax_trainer.TrainConfig(**kw), trainer.TrainConfig(**kw)
    params = tiny.jax_params()
    params["wan"] = _bump(jlora.inject_lora(params["wan"], jax.random.PRNGKey(3), 4), 0.01)
    tx = jax_trainer.make_optimizer(jtc, params)
    state = jax_trainer.init_train_state(params, tx)
    step = jax.jit(jax_trainer.make_unified_train_step(tiny.JCFG, jtc, tx, attn_impl="xla"))

    model = tiny.port_params(params)
    base = {n: p.detach().clone() for n, p in model.named_parameters()}
    trained = lora.freeze_base(model)
    ptx = trainer.make_optimizer(tc, model)
    assert ptx.trainable == trained
    pstate = trainer.init_train_state(model, ptx)
    assert set(pstate.opt_state["mu"]) == trained
    pstep = trainer.make_unified_train_step(tiny.CFG, tc, ptx)
    b = tiny.batch()
    tb = {k: torch.tensor(v) for k, v in b.items()}
    for s in range(2):
        key, draws = tiny.jax_draws(s, jtc)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        pstate, pm = pstep(pstate, tb, draws)
        assert abs(float(pm["loss"]) / float(m["loss"]) - 1) < TOL, s
    ref = tiny.to_port_names(state.params)
    worst = tiny.worst_rel({n: p for n, p in model.named_parameters() if n in trained},
                           {n: ref[n] for n in trained}, floor=1e-2)
    assert worst[0] < TOL, worst
    for n, p in model.named_parameters():
        if n in trained:
            assert n.endswith(("lora_a", "lora_b"))
        else:
            torch.testing.assert_close(p.detach(), base[n], rtol=0, atol=0, msg=n)
    assert any(not torch.equal(p.detach(), base[n]) for n, p in model.named_parameters()
               if n.endswith("lora_b"))


# --- the bare layout: the Qwen3 text stack and the vision tower -----------

@pytest.fixture(scope="module")
def qwen():
    cfg = tiny_config(moe=False)
    params, jcfg, model = build(cfg)
    ids = np.random.default_rng(3).integers(0, cfg.text.vocab_size, (2, 12))
    return cfg, params, jcfg, model, ids


def _port_qwen(cfg, params):
    model = Qwen3VLModel(cfg, torch.float32, device="cpu")
    return load_qwen3vl(model, qwen3vl_params_to_state_dict(params))


def test_bare_text_forward_decode_merge(qwen):
    cfg, params, jcfg, base, ids = qwen
    _, logits0 = ptext.qwen3_forward(base, torch.tensor(ids))
    model = _port_qwen(cfg, params)
    lora.inject_lora_bare(model, 4, generator=torch.Generator().manual_seed(1))
    names = {s.bare for s in lora.sites(model) if lora.has_lora(s.lin)}
    assert names == {"q", "k", "v", "o", "gate", "up", "down"}
    assert not any("norm" in n and "lora" in n for n, _ in model.named_parameters())
    assert not any(lora.has_lora(m) for m in model.visual.modules())
    _, logits1 = ptext.qwen3_forward(model, torch.tensor(ids))
    torch.testing.assert_close(logits1, logits0, rtol=0, atol=0)
    toks0 = ptext.qwen3_greedy_decode(base, torch.tensor(ids[:1, :6]), 4)
    toks1 = ptext.qwen3_greedy_decode(model, torch.tensor(ids[:1, :6]), 4)
    torch.testing.assert_close(toks1, toks0, rtol=0, atol=0)

    jp = _bump(jlora.inject_lora_bare(params, jax.random.PRNGKey(1), 4), 0.02)
    model = _port_qwen(cfg, jp)
    _, ref = jtext.qwen3_forward(jp["text"], jcfg.text, jnp.asarray(ids))
    _, got = ptext.qwen3_forward(model, torch.tensor(ids))
    assert scale_err(got.numpy(), np.asarray(ref)) < TOL
    assert not np.allclose(got.numpy(), logits0.numpy())
    ref_toks = jtext.qwen3_greedy_decode(jp["text"], jcfg.text, jnp.asarray(ids[:1, :6]), 4)
    np.testing.assert_array_equal(
        ptext.qwen3_greedy_decode(model, torch.tensor(ids[:1, :6]), 4).numpy(),
        np.asarray(ref_toks))
    lora.merge_lora(model)
    _, merged = ptext.qwen3_forward(model, torch.tensor(ids))
    np.testing.assert_allclose(merged.numpy(), got.numpy(), rtol=MERGE_TOL, atol=MERGE_TOL)
    # the whole tree's adapters carry both ways by path
    state = lora.extract_lora(_port_qwen(cfg, jp))
    assert set(state) == {"text/layers/attn", "text/layers/mlp"}
    np.testing.assert_array_equal(state["text/layers/attn"]["q_lora_a"],
                                  np.asarray(jp["text"]["layers"]["attn"]["q_lora_a"]))


def test_bare_router_and_experts_never_adapted():
    cfg = tiny_config(moe=True)
    params, _, model = build(cfg)
    lora.inject_lora_bare(model, 2)
    adapted = {s.name for s in lora.sites(model) if lora.has_lora(s.lin)}
    assert adapted and not any(".mlp." in n for n in adapted)
    jp = jlora.inject_lora_bare(params, jax.random.PRNGKey(0), 2)
    assert "gate_lora_a" not in jp["text"]["layers"]["mlp"]
    assert set(lora.extract_lora(model)) == set(jlora.extract_lora(jp))


def test_bare_vision_tower(qwen):
    cfg, params, jcfg, model, _ = qwen
    rng = np.random.default_rng(5)
    grid = (2, 4, 4)
    pixels = (0.1 * rng.standard_normal((32, cfg.vision.patch_dim))).astype(np.float32)
    with torch.no_grad():
        y0, _ = model.visual(torch.tensor(pixels), grid)
    vm = _port_qwen(cfg, params)
    lora.inject_lora_bare(vm.visual, 2, names=lora.VISION_BARE_NAMES)
    with torch.no_grad():
        y1, _ = vm.visual(torch.tensor(pixels), grid)
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    jv = _bump(jlora.inject_lora_bare(params["vision"], jax.random.PRNGKey(1), 2,
                                      names=jlora.VISION_BARE_NAMES), 0.02)
    jp = dict(params, vision=jv)
    vm = _port_qwen(cfg, jp)
    assert {s.path for s in lora.sites(vm) if lora.has_lora(s.lin)} == {"vision/blocks"}
    ref, _ = vision_forward(jv, jcfg.vision, jnp.asarray(pixels), grid)
    with torch.no_grad():
        got, _ = vm.visual(torch.tensor(pixels), grid)
        assert scale_err(got.numpy(), np.asarray(ref)) < TOL
        lora.merge_lora(vm)
        merged, _ = vm.visual(torch.tensor(pixels), grid)
    np.testing.assert_allclose(merged.numpy(), got.numpy(), rtol=MERGE_TOL, atol=MERGE_TOL)


def test_lora_masked_trains_adapters_and_extras(qwen):
    cfg, params, _, _, _ = qwen
    model = lora.inject_lora_bare(_port_qwen(cfg, params), 2)
    tx = lora.lora_masked(trainer.make_optimizer(trainer.TrainConfig()), model,
                          extra_filters=("lm_head",))
    assert tx.trainable and all(n.endswith(("lora_a", "lora_b")) or n.startswith("lm_head")
                                for n in tx.trainable)
    assert "lm_head.weight" in tx.trainable
