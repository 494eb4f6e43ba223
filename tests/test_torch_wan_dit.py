"""Wan DiT of the port against the JAX `wan_dit_apply` and the reference
golden fixture, on the CPU with seeded numpy inputs.

Tolerances: the f32 forwards agree to 1e-5 relative (to the output's
scale): only sum order and transcendental ulps differ. bf16 weights and
residuals round at the same points in both packages but may flip single bf16
roundings; those flips propagate through the blocks, so the bf16 forwards
are held to 2e-2 of the output's scale. The golden fixture keeps the JAX
package's own tolerance (2e-4) for the reference torch implementation.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.wan_dit import init_wan_dit, wan_dit_apply
from omnivideo_tpu_torch.configs.base import WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import load_wan_state_dict, wan_params_to_state_dict
from omnivideo_tpu_torch.models.wan_dit import (
    WanDiT,
    patchify,
    sinusoidal_embedding_1d,
    unpatchify,
)

GOLDEN = Path(__file__).parent / "golden" / "wan_dit_tiny.npz"
GOLDEN_CFG = dict(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=64, ffn_dim=128,
                  freq_dim=32, text_dim=48, out_dim=4, num_heads=4, num_layers=2)
# dim 256 with 2 heads: head_dim 128, so the fused qk_prep + flash path runs
FUSED_CFG = dict(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=256, ffn_dim=512,
                 freq_dim=32, text_dim=48, out_dim=4, num_heads=2, num_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _port(cfg_kw, dtype, sd):
    model = WanDiT(WanDiTConfig(**cfg_kw), dtype=dtype, device="cpu")
    return load_wan_state_dict(model, sd)


def _inputs(seed, text_len=16, text_dim=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 3, 8, 8)).astype(np.float32)
    t = np.array([937.0, 41.0], np.float32)
    ctx = np.zeros((2, text_len, text_dim), np.float32)
    ctx[0, :11] = rng.standard_normal((11, text_dim))
    ctx[1, :6] = rng.standard_normal((6, text_dim))
    return x, t, ctx


@pytest.fixture(scope="module")
def fused_params():
    """JAX init at dim 256 with a non-zero head (init zero-fills it)."""
    cfg = JaxDiTConfig(**FUSED_CFG)
    out = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        p = init_wan_dit(jax.random.PRNGKey(0), cfg, dtype=dt)
        rng = np.random.default_rng(1)
        p["head"]["head"]["kernel"] = jnp.asarray(
            0.1 * rng.standard_normal(p["head"]["head"]["kernel"].shape), jnp.float32)
        out[name] = p
    return out


def _rel(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("param_dtype,residual,qk_impl", [
    ("float32", None, "pallas_interpret"),
    ("float32", None, "xla"),
    ("bfloat16", None, "pallas_interpret"),
    ("bfloat16", "bfloat16", "pallas_interpret"),
])
def test_forward_matches_jax(fused_params, param_dtype, residual, qk_impl):
    """Port (fused path, plain twins on the CPU) vs wan_dit_apply through the
    Pallas kernels in interpret mode, or through the unfused XLA chain."""
    p = fused_params[param_dtype]
    x, t, ctx = _inputs(2)
    ref = np.asarray(wan_dit_apply(
        p, JaxDiTConfig(**FUSED_CFG), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        attn_impl="pallas_interpret" if qk_impl != "xla" else "xla", qk_impl=qk_impl,
        residual_dtype=None if residual is None else jnp.bfloat16))
    model = _port(FUSED_CFG, getattr(torch, param_dtype), wan_params_to_state_dict(_np_tree(p)))
    with torch.inference_mode():
        out = model(torch.tensor(x), torch.tensor(t), torch.tensor(ctx),
                    residual_dtype=None if residual is None else torch.bfloat16).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    tol = 1e-5 if param_dtype == "float32" else 2e-2
    assert _rel(out, ref) < tol, _rel(out, ref)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _golden_sd(golden):
    return {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")}


def _golden_ctx(golden):
    ctx = np.zeros((2, 16, 48), np.float32)
    ctx[0, : len(golden["ctx0"])] = golden["ctx0"]
    ctx[1, : len(golden["ctx1"])] = golden["ctx1"]
    return ctx


@pytest.mark.parametrize("seq_len,key", [(None, "out"), (100, "out_padded")])
def test_golden_forward_parity(golden, seq_len, key):
    """Reference state dict → port (unfused path: head_dim 16) → the
    reference torch implementation's output."""
    model = _port(GOLDEN_CFG, torch.float32, _golden_sd(golden))
    with torch.inference_mode():
        out = model(torch.tensor(golden["x"]), torch.tensor(golden["t"]),
                    torch.tensor(_golden_ctx(golden)), seq_len=seq_len).numpy()
    np.testing.assert_allclose(out, golden[key], rtol=2e-4, atol=2e-4)


def test_unfused_path_is_cpu_only(monkeypatch):
    """Off the CPU the unfused chain (head_dim 16 here) runs only through the
    flash kernels, which take head dim 128: the block raises there, in
    inference and under autograd, rather than fall back to a plain version.
    A meta-device block that reports itself as CUDA stands in for the card."""
    from omnivideo_tpu_torch.models.wan_dit import WanAux, WanBlock

    block = WanBlock(WanDiTConfig(**GOLDEN_CFG), torch.float32, "meta")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    meta = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    aux = WanAux(e0=meta(1, 1, 6, 64), context=meta(1, 4, 64), rope_cos=meta(8, 8),
                 rope_sin=meta(8, 8), kv_lens=None)
    x = meta(1, 8, 64)
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim 16"):
        block(x, aux, "unfused")
    with pytest.raises(ValueError, match="head_dim 16"):
        block(x.requires_grad_(), aux)  # the fused path does not take head_dim 16 either


def test_residual_bf16_close_to_f32(golden):
    model = _port(GOLDEN_CFG, torch.float32, _golden_sd(golden))
    args = (torch.tensor(golden["x"]), torch.tensor(golden["t"]),
            torch.tensor(_golden_ctx(golden)))
    with torch.inference_mode():
        y0 = model(*args).numpy()
        y1 = model(*args, residual_dtype=torch.bfloat16).numpy()
    d = np.abs(y1 - y0)
    assert d.mean() / (np.abs(y0).mean() + 1e-6) < 3e-2


def test_sinusoid_patchify_match_jax():
    from omnivideo_tpu.models import wan_dit as jw

    pos = np.array([0.0, 1.0, 41.0, 999.0], np.float32)
    np.testing.assert_allclose(sinusoidal_embedding_1d(256, torch.tensor(pos)).numpy(),
                               np.asarray(jw.sinusoidal_embedding_1d(256, jnp.asarray(pos))),
                               rtol=0, atol=2e-7)
    x = np.random.default_rng(4).standard_normal((2, 3, 4, 6, 8)).astype(np.float32)
    tok = patchify(torch.tensor(x), (1, 2, 2))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jw.patchify(jnp.asarray(x), (1, 2, 2))))
    back = unpatchify(torch.tensor(np.asarray(tok)).reshape(2, -1, 4, 3).permute(0, 1, 3, 2)
                      .reshape(2, 48, 12), (4, 3, 4), (1, 2, 2), 3)
    assert back.shape == (2, 3, 4, 6, 8)
    np.testing.assert_array_equal(
        unpatchify(tok, (4, 3, 4), (1, 2, 2), 3).numpy(),
        np.asarray(jw.unpatchify(jnp.asarray(tok.numpy()), (4, 3, 4), (1, 2, 2), 3)))
