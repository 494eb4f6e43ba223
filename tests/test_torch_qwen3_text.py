"""The port's text-only Qwen3 (models/qwen3vl/text_model.py `Qwen3LM`,
`qwen3_forward`, `qwen3_greedy_decode`) against JAX's on the CPU, on the
tiny Qwen3-VL's text stack (tests/torch_qwen3vl_tiny.py), dense and MoE,
carried by `qwen3_params_to_state_dict`.

Tolerances: hidden states and logits within 1e-5 of scale at f32 (the
causal forward through the flash kernel's plain twin, the masked one
through the dense path with JAX's additive bias); greedy tokens equal,
eos padding included; at bf16 logits within 2e-2 of scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.models.qwen3vl import text_model as jtext
from omnivideo_tpu_torch.io.jax_bridge import load_qwen3vl, qwen3_params_to_state_dict
from omnivideo_tpu_torch.models.qwen3vl import text_model as ptext
from torch_qwen3vl_tiny import build, scale_err, tiny_config

TOL = 1e-5


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "moe"])
def lm(request):
    cfg = tiny_config(moe=request.param)
    params, jcfg, _ = build(cfg)
    model = load_qwen3vl(ptext.Qwen3LM(cfg.text, torch.float32, device="cpu"),
                         qwen3_params_to_state_dict(params["text"]))
    ids = np.random.default_rng(3).integers(0, cfg.text.vocab_size, (2, 19))
    return params["text"], jcfg.text, model, ids


def test_forward_matches_jax(lm):
    jp, jcfg, model, ids = lm
    h_ref, l_ref = jtext.qwen3_forward(jp, jcfg, jnp.asarray(ids))
    h, logits = ptext.qwen3_forward(model, torch.tensor(ids))
    assert logits.shape == (2, 19, jcfg.vocab_size)
    assert scale_err(h.numpy(), np.asarray(h_ref)) < TOL
    assert scale_err(logits.numpy(), np.asarray(l_ref)) < TOL


def test_masked_forward_matches_jax(lm):
    jp, jcfg, model, ids = lm
    mask = np.ones(ids.shape, np.int32)
    mask[1, 12:] = 0  # right padding on the second row
    _, l_ref = jtext.qwen3_forward(jp, jcfg, jnp.asarray(ids), attn_mask=jnp.asarray(mask))
    _, logits = ptext.qwen3_forward(model, torch.tensor(ids), attn_mask=torch.tensor(mask))
    assert scale_err(logits.numpy(), np.asarray(l_ref)) < TOL
    _, causal = ptext.qwen3_forward(model, torch.tensor(ids))
    assert scale_err(logits[0].numpy(), causal[0].numpy()) < TOL  # an all-ones row: causal


@pytest.mark.parametrize("eos", [None, "second"])
def test_greedy_decode_matches_jax(lm, eos):
    jp, jcfg, model, ids = lm
    prompt = ids[:1, :7]
    free = np.asarray(jtext.qwen3_greedy_decode(jp, jcfg, jnp.asarray(prompt), 6))
    eos_id = None if eos is None else int(free[0, 1])
    ref = np.asarray(jtext.qwen3_greedy_decode(jp, jcfg, jnp.asarray(prompt), 6, eos_id))
    got = ptext.qwen3_greedy_decode(model, torch.tensor(prompt), 6, eos_id)
    np.testing.assert_array_equal(got.numpy(), ref)
    if eos is not None:
        assert (got[0, 1:] == eos_id).all()


def test_bf16_forward_close_to_jax():
    cfg = tiny_config(moe=False)
    params, jcfg, _ = build(cfg, dtype=torch.bfloat16)
    model = load_qwen3vl(ptext.Qwen3LM(cfg.text, torch.bfloat16, device="cpu"),
                         qwen3_params_to_state_dict(params["text"]))
    ids = np.random.default_rng(4).integers(0, cfg.text.vocab_size, (1, 23))
    _, l_ref = jtext.qwen3_forward(params["text"], jcfg.text, jnp.asarray(ids))
    _, logits = ptext.qwen3_forward(model, torch.tensor(ids))
    assert scale_err(logits.float().numpy(), np.asarray(l_ref, np.float32)) < 2e-2


def test_seeded_model_and_rope_tables():
    cfg = tiny_config(moe=False).text
    a = ptext.Qwen3LM(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    b = ptext.Qwen3LM(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    pos = torch.arange(5)
    cos, sin = ptext.rope_1d(pos, cfg)
    x = jnp.ones((1, 5, 1, cfg.head_dim), jnp.float32)
    ref = np.asarray(jtext._rope(x, jnp.arange(5)[None], cfg.rope_theta))[0, :, 0]
    half = cfg.head_dim // 2
    # the rotation of an all-ones row: [c − s, c + s] per half
    got = np.concatenate([cos[:, :half] - sin[:, :half], cos[:, half:] + sin[:, half:]], -1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
