"""The port's Qwen3-VL caption decoding (KV-cache greedy decode and top-p
sampling) against the JAX package on the CPU, from the seeded tiny model of
tests/torch_qwen3vl_tiny.py: token-exact at f32, eos padding as the JAX
scan emits it, and each token equal to the argmax of the full forward over
the prompt and the tokens before it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_qwen3vl_tiny import build, tiny_config, video_inputs

from omnivideo_tpu.models.qwen3vl import full_model as jfull
from omnivideo_tpu_torch.models.qwen3vl import full_model


@pytest.fixture(scope="module")
def f32():
    cfg = tiny_config()
    params, jcfg, model = build(cfg, attn_impl="flash_interpret")
    return cfg, params, jcfg, model


def test_greedy_decode_token_exact_f32(f32):
    cfg, params, jcfg, model = f32
    ids, patches, grid = video_inputs(cfg, seed=3)
    ref = jfull.qwen3vl_greedy_decode(params, jcfg, ids, jnp.asarray(patches), grid,
                                      max_new_tokens=8)
    out = full_model.qwen3vl_greedy_decode(model, ids, patches, grid, max_new_tokens=8)
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, np.asarray(ref))
    # eos: the JAX scan emits eos after the first eos token; the port stops
    # computing there
    ref = np.asarray(ref)
    eos = int(ref[2])
    stop = list(ref).index(eos)
    timings = {}
    out_eos = full_model.qwen3vl_greedy_decode(model, ids, patches, grid, max_new_tokens=8,
                                               eos_token_id=eos, timings=timings)
    np.testing.assert_array_equal(out_eos[:stop + 1], ref[:stop + 1])
    assert (out_eos[stop:] == eos).all()
    assert timings["decode_steps"] == stop and set(timings) >= {"vision_s", "prefill_s", "decode_s"}


def test_decode_matches_teacher_forced_forward(f32):
    """Each decoded token is the argmax of the full forward over the prompt
    and the tokens before it (decode positions continue the text positions)."""
    cfg, _, _, model = f32
    ids, patches, grid = video_inputs(cfg, seed=4)
    toks = full_model.qwen3vl_greedy_decode(model, ids, patches, grid, max_new_tokens=5)
    ext = np.concatenate([ids, toks[None, :-1]], axis=1)
    assert cfg.video_token_id not in toks[:-1]  # the extension stays text
    h = full_model.qwen3vl_forward(model, ext, patches, grid, final_norm=True)
    with torch.inference_mode():
        logits = torch.nn.functional.linear(h[0, ids.shape[1] - 1:], model.lm_head.weight)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), toks)


def test_sample_token_top_p():
    logits = torch.tensor([0.0, 3.0, 2.9, -1.0, 1.0])
    assert full_model.sample_token(logits, 0.0, 0.9) == 1
    gen = torch.Generator().manual_seed(0)
    assert {full_model.sample_token(logits, 1.0, 1e-3, gen) for _ in range(20)} == {1}
    picks = {full_model.sample_token(logits, 1.0, 0.7, gen) for _ in range(200)}
    assert picks == {1, 2}  # the nucleus reaching 0.7 holds the two top logits
