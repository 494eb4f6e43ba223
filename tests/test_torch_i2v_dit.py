"""The port's i2v DiT (y on the input channels, the CLIP tokens through
img_emb, the split cross-attention with its own image K/V) on the CPU:

- against the reference golden `i2v_tiny.npz` (its `sd::` weights through the
  port's converter), rtol/atol 3e-4 as the JAX package's own test;
- against JAX `wan_dit_apply(y=, clip_fea=)` at head dim 128 on a seeded
  reference-layout state dict (JAX reads it with its converter, the port gets
  JAX's params back through io/jax_bridge.py), f32 outputs within 1e-5 of
  their scale (attention sums in another order);
- with `qk_impl="kernel"`: the self-attention and the split
  cross-attention take the fused prologue (qk_prep on the self-attention's q
  and k, then on the cross-attention's q, text keys and image keys: five a
  block), the cross-attention as one `flash_attention_pair` call a block
  (where JAX's `"k_img" not in ca` guard takes the unfused chain and two
  calls), and the output still matches JAX;
- the JAX-path names of the i2v parameters (`wan_state_dict_to_jax`);
- the task configs (`I2V_14B` among them) and the size tables, field for
  field against JAX's.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnivideo_tpu.configs as jax_configs
import omnivideo_tpu_torch.configs as port_configs
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.io.torch_convert import to_jnp
from omnivideo_tpu.io.torch_convert import wan_state_dict_to_params as jax_from_sd
from omnivideo_tpu.models.wan_dit import wan_dit_apply
from omnivideo_tpu_torch.configs.base import WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import (
    load_wan_state_dict,
    wan_params_to_state_dict,
    wan_state_dict_to_jax,
)
from omnivideo_tpu_torch.io.torch_convert import wan_state_dict_to_params
from omnivideo_tpu_torch.models import wan_dit as port_dit
from omnivideo_tpu_torch.models.wan_dit import IMG_TOKENS, WanDiT
from torch_i2v_tiny import seeded_wan_sd

GOLDEN = Path(__file__).parent / "golden" / "i2v_tiny.npz"
TINY = dict(model_type="i2v", patch_size=(1, 2, 2), text_len=16, in_dim=12, dim=64, ffn_dim=128,
            freq_dim=32, text_dim=48, out_dim=4, num_heads=4, num_layers=2)
D128 = dict(model_type="i2v", patch_size=(1, 2, 2), text_len=16, in_dim=12, dim=256,
            ffn_dim=256, freq_dim=32, text_dim=48, out_dim=4, num_heads=2, num_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_i2v_dit_matches_reference_golden():
    g = np.load(GOLDEN)
    sd = {k[len("sd::"):]: g[k] for k in g.files if k.startswith("sd::")}
    model = wan_state_dict_to_params(sd, WanDiTConfig(**TINY), dtype=torch.float32, device="cpu")
    assert hasattr(model, "img_emb") and hasattr(model.blocks[0].cross_attn, "k_img")
    ctx = np.zeros((1, 16, 48), np.float32)
    ctx[0, : len(g["ctx"])] = g["ctx"]
    with torch.no_grad():
        out = model(torch.tensor(g["x"]), torch.tensor(g["t"]), torch.tensor(ctx), seq_len=48,
                    y=torch.tensor(g["y"]), clip_fea=torch.tensor(g["clip_fea"]))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=3e-4, atol=3e-4)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 3, 8, 8)).astype(np.float32)
    y = rng.standard_normal((2, 8, 3, 8, 8)).astype(np.float32)
    t = np.array([900.0, 250.0], np.float32)
    ctx = np.zeros((2, 16, 48), np.float32)
    ctx[:, :11] = rng.standard_normal((2, 11, 48))
    clip = rng.standard_normal((2, IMG_TOKENS, 1280)).astype(np.float32)
    return x, y, t, ctx, clip


def _pair():
    cfg = WanDiTConfig(**D128)
    jparams = to_jnp(jax_from_sd(seeded_wan_sd(cfg, 0), cfg.num_layers), dtype=jnp.float32)
    model = WanDiT(cfg, dtype=torch.float32, device="cpu")
    load_wan_state_dict(model, wan_params_to_state_dict(_np_tree(jparams)))
    return cfg, jparams, model


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_out(cfg, jparams, inputs):
    x, y, t, ctx, clip = inputs
    return np.asarray(wan_dit_apply(jparams, JaxDiTConfig(**D128), jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(ctx), seq_len=48, y=jnp.asarray(y),
                                    clip_fea=jnp.asarray(clip), attn_impl="xla"))


@pytest.mark.parametrize("qk_impl", ["unfused", "kernel"])
def test_i2v_dit_matches_jax(qk_impl, monkeypatch):
    cfg, jparams, model = _pair()
    inputs = _inputs(1)
    calls, pairs = [], []
    real, real_pair = port_dit.qk_prep, port_dit.flash_attention_pair
    monkeypatch.setattr(port_dit, "qk_prep", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(port_dit, "flash_attention_pair",
                        lambda *a, **k: pairs.append(1) or real_pair(*a, **k))
    x, y, t, ctx, clip = (torch.tensor(a) for a in inputs)
    with torch.no_grad():
        out = model(x, t, ctx, seq_len=48, y=y, clip_fea=clip, qk_impl=qk_impl).numpy()
    ref = _jax_out(cfg, jparams, inputs)
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel
    # the fused prologue: self-attention's q and k, the cross-attention's q,
    # text and image keys; one pair call a block for the cross-attention
    kernel = qk_impl == "kernel"
    assert len(calls) == (5 * cfg.num_layers if kernel else 0)
    assert len(pairs) == (cfg.num_layers if kernel else 0)


def test_i2v_params_round_trip_to_jax_names():
    cfg, jparams, model = _pair()
    flat = wan_state_dict_to_jax(model.state_dict())
    want = _flat_np(jparams)
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k].reshape(v.shape), v, err_msg=k)


@pytest.mark.parametrize("task", sorted(jax_configs.WAN_CONFIGS))
def test_task_config_matches_jax(task):
    """Every field the port keeps equals JAX's (the port has no `t5_dtype`:
    its umT5 takes its dtype from the caller)."""
    port = dataclasses.asdict(port_configs.WAN_CONFIGS[task])
    ref = dataclasses.asdict(jax_configs.WAN_CONFIGS[task])
    assert set(port) <= set(ref)
    assert port == {k: ref[k] for k in port}


def test_size_tables_match_jax():
    assert set(port_configs.WAN_CONFIGS) == set(jax_configs.WAN_CONFIGS)
    assert port_configs.SIZE_CONFIGS == jax_configs.SIZE_CONFIGS
    assert port_configs.MAX_AREA_CONFIGS == jax_configs.MAX_AREA_CONFIGS
    assert port_configs.SUPPORTED_SIZES == jax_configs.SUPPORTED_SIZES
