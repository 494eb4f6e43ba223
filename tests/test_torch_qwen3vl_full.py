"""The port's full Qwen3-VL (vision tower + MoE text decoder) against the
JAX package on the CPU, from one seeded HF-named state dict: 3-D position
ids and interleaved-MRoPE tables (bit-exact), the multimodal feature forward
(≤ 1e-5 of scale at f32 through the JAX Pallas flash kernels in interpret
mode, ≤ 2e-2 at bf16, where bf16 rounds at other points), and the
tokenizer-free feature extraction with the system-prefix drop. Greedy
decoding: tests/test_torch_qwen3vl_decode.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_qwen3vl_tiny import build, scale_err, tiny_config, video_inputs

from omnivideo_tpu.models.qwen3vl import engine as jengine
from omnivideo_tpu.models.qwen3vl import full_model as jfull
from omnivideo_tpu_torch.configs.qwen3vl import QWEN3_VL_30B_A3B
from omnivideo_tpu_torch.models.qwen3vl import engine, full_model
from omnivideo_tpu_torch.models.qwen3vl.preprocess import video_prompt_ids


@pytest.fixture(scope="module")
def f32():
    cfg = tiny_config()
    params, jcfg, model = build(cfg, attn_impl="flash_interpret")
    return cfg, params, jcfg, model


def test_rope_index_and_mrope_tables_bit_exact(f32):
    cfg, _, jcfg, _ = f32
    for grid in ((2, 4, 4), (3, 4, 6), (1, 2, 2)):
        ids, _, _ = video_inputs(cfg, grid)
        g = np.array([list(grid)])
        pos = full_model.get_rope_index(ids, g, cfg)
        np.testing.assert_array_equal(pos, jfull.get_rope_index(ids, g, jcfg))
        for a, b in zip(full_model.mrope_cos_sin(pos, cfg), jfull._mrope_cos_sin(pos, jcfg)):
            np.testing.assert_array_equal(a, b)
    text = np.arange(9)[None]
    np.testing.assert_array_equal(full_model.get_rope_index(text, None, cfg),
                                  jfull.get_rope_index(text, None, jcfg))


def test_mrope_tables_of_the_30b_preset():
    """(24, 20, 20) interleaved over head dim 128, at positions as large as
    the 1.5k-token prompt gives."""
    cfg = QWEN3_VL_30B_A3B
    ids = video_prompt_ids(list(range(31)), list(range(256)), (3, 30, 52), cfg)
    pos = full_model.get_rope_index(ids, np.array([[3, 30, 52]]), cfg)
    assert pos.shape == (3, ids.shape[1]) and ids.shape[1] == 31 + 3 * 392 + 256
    jcfg = jfull.Qwen3VLConfig(text=jfull.Qwen3TextConfig(), vision=jfull.Qwen3VLVisionConfig())
    np.testing.assert_array_equal(pos, jfull.get_rope_index(ids, np.array([[3, 30, 52]]), jcfg))
    for a, b in zip(full_model.mrope_cos_sin(pos, cfg), jfull._mrope_cos_sin(pos, jcfg)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("final_norm", [False, True])
def test_forward_matches_jax_f32(f32, final_norm):
    cfg, params, jcfg, model = f32
    ids, patches, grid = video_inputs(cfg)
    ref = jfull.qwen3vl_forward(params, jcfg, ids, jnp.asarray(patches), grid,
                                final_norm=final_norm)
    out = full_model.qwen3vl_forward(model, ids, patches, grid, final_norm=final_norm)
    assert out.shape == (1, ids.shape[1], cfg.text.hidden_size)
    assert scale_err(out.numpy(), np.asarray(ref)) <= 1e-5


def test_text_only_forward_matches_jax(f32):
    cfg, params, jcfg, model = f32
    ids = np.array([[5, 6, 7, 8, 9, 10, 3]])
    ref = jfull.qwen3vl_forward(params, jcfg, ids)
    assert scale_err(full_model.qwen3vl_forward(model, ids).numpy(), np.asarray(ref)) <= 1e-5


def test_forward_matches_jax_bf16_and_dense_mlp():
    """bf16 weights, f32 patches (vision rope in bf16, as the engine runs it),
    and a dense-MLP text decoder at f32. At bf16 every token is routed to
    all experts: with top-k < E, bf16 router near-ties flip the chosen
    experts between the frameworks (the f32 tests hold the top-k routing)."""
    cfg = tiny_config(rope_dtype="bfloat16")
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, num_experts_per_tok=cfg.text.num_experts))
    params, jcfg, model = build(cfg, dtype=torch.bfloat16, attn_impl="flash_interpret")
    ids, patches, grid = video_inputs(cfg, seed=2)
    ref = jfull.qwen3vl_forward(params, jcfg, ids, jnp.asarray(patches), grid)
    out = full_model.qwen3vl_forward(model, ids, patches, grid)
    assert out.dtype == torch.bfloat16
    assert scale_err(out.float().numpy(), np.asarray(ref, np.float32)) <= 2e-2

    cfg = tiny_config(moe=False)
    params, jcfg, model = build(cfg, seed=3)
    ref = jfull.qwen3vl_forward(params, jcfg, ids, jnp.asarray(patches), grid)
    out = full_model.qwen3vl_forward(model, ids, patches, grid)
    assert scale_err(out.numpy(), np.asarray(ref)) <= 1e-5


def test_extract_features_drops_the_system_prefix(f32):
    cfg, params, jcfg, model = f32
    ids, patches, grid = video_inputs(cfg)
    feats = engine.extract_features(model, ids, patches, grid, drop_idx=3, edit_prompt="e")
    keys = {"source_video_path", "edit_prompt", "vlm_last_hidden_states", "attention_mask",
            "hidden_dim", "seq_len"}
    assert set(feats) == keys
    h = feats["vlm_last_hidden_states"]
    L = ids.shape[1]
    assert h.shape == (L - 3, cfg.text.hidden_size) and h.dtype == torch.float32
    assert feats["seq_len"] == L - 3 and feats["hidden_dim"] == cfg.text.hidden_size
    assert feats["attention_mask"].tolist() == [1] * (L - 3)
    ref = np.asarray(jfull.qwen3vl_forward(params, jcfg, ids, jnp.asarray(patches), grid))[0]
    assert scale_err(h.numpy(), ref[3:]) <= 1e-5
    assert engine.drop_system_prefix(h[:2], 3).shape[0] == 2  # nothing left to keep: no drop


def test_extract_masked_hidden_matches_jax():
    rng = np.random.default_rng(8)
    hidden = rng.standard_normal((2, 5, 3)).astype(np.float32)
    mask = np.array([[1, 1, 0, 1, 0], [0, 1, 1, 1, 1]])
    for a, b in zip(engine.extract_masked_hidden(torch.tensor(hidden), mask),
                    jengine.extract_masked_hidden(hidden, mask)):
        np.testing.assert_array_equal(a.numpy(), b)
