"""A tiny dual-expert generate of the port in the A14B parity mode (f32
residual stream, the fused AdaLN path `ew_impl="kernel"`) against the JAX
pipeline with `ew_impl="pallas"` (its Pallas kernel in interpret mode), on
the CPU, for both solvers. The same weights (JAX random init with non-zero
heads, bridged by `pipeline_from_jax`), the same noise (JAX's draw for the
seed), the same VAE (the port's seeded params as numpy, the JAX layout).
With the A14B shift of 12, 3 steps run at t = 999, 959, 856: two
high-noise steps and one low-noise step.

f32 weights: latents within 1e-5 of their scale (sum order and
transcendental ulps), the decoded video within 1e-4 (the VAE convolutions
sum in another order), as tests/test_torch_x2x.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.vae2_1 import Wan21VAE as JaxVAE
from omnivideo_tpu.pipelines.x2x import OmniVideoX2XUnified as JaxPipe
from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import pipeline_from_jax
from omnivideo_tpu_torch.models import wan_dit as port_dit
from omnivideo_tpu_torch.models.vae2_1 import init_vae

jax_fa = importlib.import_module("omnivideo_tpu.ops.fused_adaln")

DIT = dict(patch_size=(1, 2, 2), in_dim=4, dim=256, ffn_dim=512, freq_dim=32, text_dim=48,
           out_dim=4, num_heads=2, num_layers=2)
PIPE = dict(name="tiny-a14b", vlm_in_dim=24, max_context_len=32, dual_expert=True,
            param_dtype="float32")
SEED = 5
GEN = dict(size=(64, 48), frame_num=9, sampling_steps=3, shift=12.0, guide_scale=(3.0, 4.0))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipes():
    jcfg = JaxPipelineConfig(dit=JaxDiTConfig(**DIT), vae=JaxVAEConfig(dim=8, z_dim=4), **PIPE)
    jpipe = JaxPipe.random_init(jcfg, seed=0, with_vae=False, attn_impl="xla", qk_impl="xla",
                                ew_impl="pallas")
    for expert, seed in ((jpipe.low_noise, 1), (jpipe.high_noise, 2)):
        head = expert.wan["head"]["head"]
        head["kernel"] = jnp.asarray(
            0.1 * np.random.default_rng(seed).standard_normal(head["kernel"].shape), jnp.float32)
    cfg = PipelineConfig(dit=WanDiTConfig(**DIT), vae=VAEConfig(dim=8, z_dim=4), **PIPE)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    vae = jax.tree_util.tree_map(lambda a: a.numpy(), init_vae(
        cfg.vae, device="cpu", generator=torch.Generator().manual_seed(0)))
    jpipe.vae = JaxVAE.create(jax.tree_util.tree_map(jnp.asarray, vae), jcfg.vae)
    low = type("E", (), dict(wan=np_tree(jpipe.low_noise.wan),
                             companions=np_tree(jpipe.low_noise.companions)))
    high = type("E", (), dict(wan=np_tree(jpipe.high_noise.wan), companions=low.companions))
    tpipe = pipeline_from_jax(cfg, low, high, vae_params=vae, device="cpu", ew_impl="kernel")
    return jpipe, tpipe


@pytest.mark.parametrize("solver", ["unipc", "dpm++"])
def test_dual_expert_generate_matches_jax(monkeypatch, pipes, solver):
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)
    jpipe, tpipe = pipes
    assert tpipe.high_noise is not tpipe.low_noise
    assert tpipe.high_noise.companions is tpipe.low_noise.companions
    ctx = np.random.default_rng(3).standard_normal((10, 48)).astype(np.float32)
    shape = tpipe._latent_shape(GEN["size"], GEN["frame_num"])
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED), shape, jnp.float32))[None]
    j_lat = np.asarray(jpipe.generate(precomputed_context=jnp.asarray(ctx),
                                      precomputed_context_null=jnp.zeros((10, 48)), seed=SEED,
                                      sample_solver=solver, decode=False, **GEN))
    calls = {"low": 0, "high": 0, "adaln": 0}
    for name in ("low", "high"):
        getattr(tpipe, f"{name}_noise").wan.register_forward_hook(
            lambda *a, n=name: calls.__setitem__(n, calls[n] + 1))
    real = port_dit.fused_adaln
    monkeypatch.setattr(port_dit, "fused_adaln", lambda *a, **k: calls.__setitem__(
        "adaln", calls["adaln"] + 1) or real(*a, **k))
    t_lat = tpipe.generate(precomputed_context=torch.tensor(ctx),
                           precomputed_context_null=torch.zeros(10, 48),
                           noise=torch.tensor(noise), sample_solver=solver, decode=False,
                           **GEN).numpy()
    assert calls == {"high": 2, "low": 1, "adaln": 3 * (3 * DIT["num_layers"] + 1)}
    assert t_lat.shape == j_lat.shape == (1, 4, 3, 6, 8)
    assert np.abs(t_lat - j_lat).max() / np.abs(j_lat).max() < 1e-5
    assert float(np.abs(t_lat - noise).max()) > 0.1
    if solver == "unipc":
        j_vid = np.asarray(jpipe.vae.decode(jnp.asarray(j_lat)))[0]
        t_vid = tpipe.decode(torch.tensor(t_lat)).numpy()
        assert t_vid.shape == j_vid.shape == (3, 9, 48, 64)
        np.testing.assert_allclose(t_vid, j_vid, rtol=1e-4, atol=1e-4)
