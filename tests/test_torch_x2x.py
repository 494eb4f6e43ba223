"""End-to-end generate() of the port against the JAX pipeline on the CPU:
the same weights (JAX random init with a non-zero DiT head, bridged into the
port; the port's seeded VAE decoder, handed to JAX), the same noise (drawn as the JAX pipeline draws it, handed to the
port), decode through the VAE.

f32 weights: the latents agree to 1e-5 of their scale and the decoded video
to 1e-4 (VAE convolutions sum in another order). With bf16 weights and the
bf16 residual stream single bf16 roundings can flip and compound over the
steps: latents within 2e-2 of their scale.
"""

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
from omnivideo_tpu_torch.io.jax_bridge import (
    load_wan_state_dict,
    to_torch,
    wan_params_to_state_dict,
)
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE, init_vae
from omnivideo_tpu_torch.models.wan_dit import WanDiT
from omnivideo_tpu_torch.pipelines.x2x import ExpertParams, OmniVideoX2XUnified

DIT = dict(patch_size=(1, 2, 2), in_dim=4, dim=256, ffn_dim=512, freq_dim=32, text_dim=48,
           out_dim=4, num_heads=2, num_layers=2)
VAE = dict(dim=8, z_dim=4)
PIPE = dict(name="tiny", vlm_in_dim=24, max_context_len=32)
SEED = 7
GEN = dict(size=(64, 48), frame_num=9, sampling_steps=3, guide_scale=5.0, shift=5.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _pipes(param_dtype, residual_dtype):
    jcfg = JaxPipelineConfig(dit=JaxDiTConfig(**DIT), vae=JaxVAEConfig(**VAE),
                             param_dtype=param_dtype, **PIPE)
    # the VAE decoder params come from the port's seeded init: the JAX
    # init_vae also draws the encoder, eagerly, which alone takes ~30 s here
    jpipe = JaxPipe.random_init(jcfg, seed=0, with_vae=False, qk_impl="pallas_interpret",
                                attn_impl="pallas_interpret", residual_dtype=residual_dtype)
    head = jpipe.low_noise.wan["head"]["head"]
    head["kernel"] = jnp.asarray(
        0.1 * np.random.default_rng(1).standard_normal(head["kernel"].shape), jnp.float32)

    cfg = PipelineConfig(dit=WanDiTConfig(**DIT), vae=VAEConfig(**VAE), param_dtype=param_dtype,
                         **PIPE)
    vae_params = init_vae(cfg.vae, device="cpu", generator=torch.Generator().manual_seed(0))
    jpipe.vae = JaxVAE.create(jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), vae_params),
                              jcfg.vae)
    dit = WanDiT(cfg.dit.replace(text_len=cfg.max_context_len), dtype=cfg.torch_param_dtype,
                 device="cpu")
    load_wan_state_dict(dit, wan_params_to_state_dict(_np_tree(jpipe.low_noise.wan)))
    low = ExpertParams(wan=dit, companions=to_torch(_np_tree(jpipe.low_noise.companions)))
    vae = Wan21VAE.create(vae_params, cfg.vae)
    tpipe = OmniVideoX2XUnified(cfg, low, vae=vae, residual_dtype=residual_dtype)
    return jpipe, tpipe


def _inputs(tpipe):
    rng = np.random.default_rng(3)
    ctx = rng.standard_normal((10, 48)).astype(np.float32)
    shape = tpipe._latent_shape(GEN["size"], GEN["frame_num"])
    # the JAX pipeline's own noise for this seed (x2x.py: jax.random.normal)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED), shape, jnp.float32))[None]
    return ctx, noise


@pytest.mark.parametrize("param_dtype,residual_dtype", [("float32", None),
                                                        ("bfloat16", "bfloat16")])
def test_generate_matches_jax(param_dtype, residual_dtype):
    jpipe, tpipe = _pipes(param_dtype, residual_dtype)
    ctx, noise = _inputs(tpipe)
    kw = dict(precomputed_context_null=None, seed=SEED, **GEN)
    j_lat = np.asarray(jpipe.generate(precomputed_context=jnp.asarray(ctx), decode=False, **kw))
    t_lat = tpipe.generate(precomputed_context=torch.tensor(ctx), noise=torch.tensor(noise),
                           decode=False, **GEN).numpy()
    assert t_lat.shape == j_lat.shape == (1, 4, 3, 6, 8)
    rel = np.abs(t_lat - j_lat).max() / np.abs(j_lat).max()
    assert rel < (1e-5 if param_dtype == "float32" else 2e-2), rel
    assert float(np.abs(t_lat - noise).max()) > 0.1  # the head moved the latents
    if param_dtype == "float32":
        j_vid = np.asarray(jpipe.generate(precomputed_context=jnp.asarray(ctx), **kw))
        t_vid = tpipe.generate(precomputed_context=torch.tensor(ctx),
                               noise=torch.tensor(noise), **GEN).numpy()
        assert t_vid.shape == j_vid.shape == (3, 9, 48, 64)
        np.testing.assert_allclose(t_vid, j_vid, rtol=1e-4, atol=1e-4)


def test_uint8_frames_and_timings():
    _, tpipe = _pipes("float32", None)
    ctx, noise = _inputs(tpipe)
    video = tpipe.generate(precomputed_context=torch.tensor(ctx), noise=torch.tensor(noise), **GEN)
    frames = tpipe.generate(precomputed_context=torch.tensor(ctx), noise=torch.tensor(noise),
                            output_uint8=True, **GEN)
    assert frames.dtype == torch.uint8 and frames.shape == (9, 48, 64, 3)
    from omnivideo_tpu.utils.video import _to_uint8

    np.testing.assert_array_equal(frames.numpy(), _to_uint8(video.numpy()))
    assert set(tpipe.timings) == {"denoise_s", "denoise_step_s", "step_s", "decode_s"}
    assert len(tpipe.timings["step_s"]) == GEN["sampling_steps"]  # each step, synchronized


def test_dual_expert_split_uses_high_noise_expert_first():
    """t ≥ 0.875·T runs the high-noise expert; a zero-head low expert keeps
    the latents moving only in the high-noise steps."""
    _, tpipe = _pipes("float32", None)
    ctx, noise = _inputs(tpipe)
    cfg = tpipe.config.replace(dual_expert=True)
    low = ExpertParams(WanDiT(cfg.dit.replace(text_len=cfg.max_context_len),
                              dtype=torch.float32, device="cpu"),
                       tpipe.low_noise.companions)
    dual = OmniVideoX2XUnified(cfg, low, high_noise=tpipe.low_noise, vae=tpipe.vae)
    single = OmniVideoX2XUnified(tpipe.config, tpipe.low_noise, vae=tpipe.vae)
    kw = dict(precomputed_context=torch.tensor(ctx), noise=torch.tensor(noise), decode=False,
              **dict(GEN, sampling_steps=4))
    a, b = dual.generate(**kw), single.generate(**kw)
    assert not torch.allclose(a, b)
