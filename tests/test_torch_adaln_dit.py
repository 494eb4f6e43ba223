"""The Wan DiT's `ew_impl="kernel"` path (the fused AdaLN sandwich) against
the JAX package's `ew_impl="pallas"` on the CPU, with seeded numpy inputs:
the port runs the kernel's plain twin, JAX its Pallas kernel in interpret
mode (monkeypatched from the test, as tests/test_fused_adaln.py does).

Tolerances: f32 within 1e-5 of the output's scale (sum order and
transcendental ulps); with the bf16 residual stream single bf16 roundings
can flip and propagate, 2e-2 of scale, as tests/test_torch_wan_dit.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.wan_dit import init_wan_dit, wan_dit_apply
from omnivideo_tpu_torch.configs.base import WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import load_wan_state_dict, wan_params_to_state_dict
from omnivideo_tpu_torch.models import wan_dit as port_dit
from omnivideo_tpu_torch.ops.fused_adaln import fused_adaln

jax_fa = importlib.import_module("omnivideo_tpu.ops.fused_adaln")

DIT = dict(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=256, ffn_dim=512, freq_dim=32,
           text_dim=48, out_dim=4, num_heads=2, num_layers=2)


@pytest.fixture(scope="module")
def dit_params():
    p = init_wan_dit(jax.random.PRNGKey(0), JaxDiTConfig(**DIT), dtype=jnp.float32)
    p["head"]["head"]["kernel"] = jnp.asarray(
        0.1 * np.random.default_rng(1).standard_normal(p["head"]["head"]["kernel"].shape),
        jnp.float32)
    return p


def _dit_inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 3, 8, 8)).astype(np.float32)
    t = np.array([937.0, 41.0], np.float32)
    ctx = rng.standard_normal((2, 16, 48)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("residual,calls", [(None, 7), ("bfloat16", 1)])
def test_dit_forward_kernel_path_matches_jax(monkeypatch, dit_params, residual, calls):
    """WanDiT(ew_impl="kernel") vs wan_dit_apply(ew_impl="pallas") with the
    Pallas kernel in interpret mode (monkeypatched from the test, as
    tests/test_fused_adaln.py does). With the f32 residual every sandwich
    fuses (3 per block + the head); with the bf16 residual only the head."""
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)
    x, t, ctx = _dit_inputs()
    rdt = None if residual is None else jnp.bfloat16
    ref = np.asarray(wan_dit_apply(dit_params, JaxDiTConfig(**DIT), jnp.asarray(x),
                                   jnp.asarray(t), jnp.asarray(ctx), attn_impl="xla",
                                   qk_impl="xla", ew_impl="pallas", residual_dtype=rdt))
    model = port_dit.WanDiT(WanDiTConfig(**DIT), dtype=torch.float32, device="cpu")
    load_wan_state_dict(model, wan_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, dit_params)))
    seen = []
    monkeypatch.setattr(port_dit, "fused_adaln",
                        lambda *a, **k: seen.append(1) or fused_adaln(*a, **k))
    with torch.inference_mode():
        out = model(torch.tensor(x), torch.tensor(t), torch.tensor(ctx), qk_impl="unfused",
                    ew_impl="kernel",
                    residual_dtype=None if residual is None else torch.bfloat16).numpy()
    assert len(seen) == calls
    tol = 1e-5 if residual is None else 2e-2
    assert np.abs(out - ref).max() / np.abs(ref).max() < tol


def test_block_kernel_path_matches_jax(monkeypatch, dit_params):
    """One block with the fused sandwich vs JAX's wan_block_apply with the
    interpret-mode kernel: wiring of the e chunks, gate and norm3."""
    from omnivideo_tpu.models import wan_dit as jw

    monkeypatch.setattr(jax_fa, "_INTERPRET", True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    e0 = rng.standard_normal((2, 1, 6, 256)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 256)).astype(np.float32)
    cos, sin = jw.rope_3d_tables((2, 3, 4), 128, 64, 10000.0)
    bp = jax.tree_util.tree_map(lambda a: a[0], dit_params["blocks"])
    aux = jw.WanAuxInputs(e0=jnp.asarray(e0), context=jnp.asarray(ctx), rope_cos=cos,
                          rope_sin=sin, kv_lens=None)
    ref = np.asarray(jw.wan_block_apply(bp, jnp.asarray(x), aux, JaxDiTConfig(**DIT),
                                        attn_impl="xla", ew_impl="pallas"))
    model = port_dit.WanDiT(WanDiTConfig(**DIT), dtype=torch.float32, device="cpu")
    load_wan_state_dict(model, wan_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, dit_params)))
    taux = port_dit.WanAux(e0=torch.tensor(e0), context=torch.tensor(ctx),
                           rope_cos=torch.tensor(np.asarray(cos)),
                           rope_sin=torch.tensor(np.asarray(sin)), kv_lens=None)
    with torch.inference_mode():
        out = model.blocks[0](torch.tensor(x), taux, "unfused", "kernel").numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
