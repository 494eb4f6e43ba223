"""The port's Qwen3 MoE block against the JAX package on the CPU: the
grouped `moe` (per-expert products over expert-contiguous segments) against
the JAX `_moe` (ragged_dot) and against the dense all-experts oracle, the
router, and the RMS norm.

Tolerances: 1e-5 of scale at f32 (same math, other summation orders); at
bf16, 2e-2 of scale (the products round to bf16 at points that differ
between the frameworks, and the scatter-add sums each token's k weighted
expert outputs in bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_qwen3vl_tiny import build, scale_err, tiny_config

from omnivideo_tpu.models.qwen3vl import text_model as jtext
from omnivideo_tpu_torch.models.qwen3vl import text_model as ptext


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def moe_setup(request):
    dtype = getattr(torch, request.param)
    cfg = tiny_config()
    params, jcfg, model = build(cfg, dtype=dtype)
    lp = jax.tree_util.tree_map(lambda a: a[1], params["text"]["layers"])
    x = np.random.default_rng(4).standard_normal((2, 37, cfg.text.hidden_size)).astype(np.float32)
    return dtype, jcfg, lp["mlp"], model.language_model.layers[1].mlp, x


def _jx(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def test_moe_matches_jax_ragged(moe_setup):
    dtype, jcfg, jp, mlp, x = moe_setup
    ref = np.asarray(jtext._moe(jp, _jx(x, dtype), jcfg.text), np.float32)
    with torch.inference_mode():
        out = ptext.moe(mlp, torch.tensor(x).to(dtype))
    assert out.dtype == dtype and out.shape == x.shape
    assert scale_err(out.float().numpy(), ref) <= (1e-5 if dtype == torch.float32 else 2e-2)


def test_moe_matches_dense_oracle(moe_setup):
    dtype, jcfg, jp, mlp, x = moe_setup
    with torch.inference_mode():
        xt = torch.tensor(x).to(dtype)
        out, oracle = ptext.moe(mlp, xt), ptext.moe_dense(mlp, xt)
    ref = np.asarray(jtext._moe_dense(jp, _jx(x, dtype), jcfg.text), np.float32)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert scale_err(out.float().numpy(), oracle.float().numpy()) <= tol
    assert scale_err(oracle.float().numpy(), ref) <= tol


def test_router_matches_jax():
    """Exact top-k sets and weights at f32."""
    cfg = tiny_config()
    params, jcfg, model = build(cfg)
    jp = jax.tree_util.tree_map(lambda a: a[2], params["text"]["layers"])["mlp"]
    mlp = model.language_model.layers[2].mlp
    xt = np.random.default_rng(7).standard_normal((41, cfg.text.hidden_size)).astype(np.float32)
    topv, topi, probs = jtext._router(jp, jnp.asarray(xt), jcfg.text)
    with torch.inference_mode():
        pv, pi, pp = ptext.router(mlp, torch.tensor(xt))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(topi))
    np.testing.assert_allclose(pv.numpy(), np.asarray(topv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(probs), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pv.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_moe_skips_empty_experts():
    """Tokens routed to a subset of the experts: the empty segments are
    skipped and the result still equals the dense oracle."""
    cfg = tiny_config()
    _, _, model = build(cfg)
    mlp = model.language_model.layers[0].mlp
    x = torch.tensor(np.random.default_rng(5).standard_normal((1, 2, cfg.text.hidden_size)),
                     dtype=torch.float32)
    with torch.inference_mode():
        _, topi, _ = ptext.router(mlp, x.reshape(-1, x.shape[-1]))
        assert len(set(topi.flatten().tolist())) < cfg.text.num_experts
        torch.testing.assert_close(ptext.moe(mlp, x), ptext.moe_dense(mlp, x),
                                   rtol=1e-5, atol=1e-6)


def test_rms_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jtext._rms(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-6), np.float32)
        out = ptext.rms(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt), 1e-6)
        assert out.dtype == tdt
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-6 if tdt == torch.float32
                                   else 2**-7, atol=1e-6)
