"""The whole `WanI2V.generate` of the port against JAX's `WanI2V.generate`
on the CPU, at a tiny size, from the same weights and JAX's noise:

- an i2v DiT of 2 layers at head dim 128 (a seeded reference-layout state
  dict, read by both converters), JAX's CLIP `init_clip_vision` at width 1280
  (img_emb's input) with 2 layers and 257 tokens (image 32, patch 2: the
  split cross-attention's image/text boundary falls where it does at full
  size), the port's seeded Wan2.1 VAE (encoder and decoder) handed to JAX;
- a square uint8 first frame already at `size` = CLIP's image size, so that
  neither the CLIP resize nor the first-frame resize runs in either package
  (Pillow's there, the device bicubic here): the comparison holds the
  pipelines, not the resamplers (tests/test_torch_clip.py holds those);
- f32: latents (decode=False) within 1e-5 of their scale, the decoded video
  within 1e-4; the noise is JAX's `jax.random.normal` draw for the seed,
  handed to the port; the mask against JAX's `build_i2v_mask`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.io.torch_convert import to_jnp
from omnivideo_tpu.io.torch_convert import wan_state_dict_to_params as jax_from_sd
from omnivideo_tpu.models import clip_vision as jclip
from omnivideo_tpu.models.vae2_1 import Wan21VAE as JaxVAE
from omnivideo_tpu.pipelines import i2v as ji2v
from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import clip_params_to_state_dict
from omnivideo_tpu_torch.io.torch_convert import wan_state_dict_to_params
from omnivideo_tpu_torch.models.clip_vision import CLIPVisionConfig, clip_vision_from_state_dict
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE, init_vae
from omnivideo_tpu_torch.pipelines.i2v import WanI2V, build_i2v_mask
from torch_i2v_tiny import seeded_wan_sd

DIT = dict(model_type="i2v", patch_size=(1, 2, 2), text_len=16, in_dim=12, dim=256, ffn_dim=256,
           freq_dim=32, text_dim=48, out_dim=4, num_heads=2, num_layers=2)
VAE = dict(dim=8, z_dim=4)
CLIP = dict(image_size=32, patch_size=2, dim=1280, mlp_ratio=1.0, num_heads=16, num_layers=2)
SEED = 9
GEN = dict(size=(32, 32), frame_num=9, sampling_steps=3, guide_scale=5.0, shift=5.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipes():
    cfg = PipelineConfig(name="tiny-i2v", dit=WanDiTConfig(**DIT), vae=VAEConfig(**VAE),
                         param_dtype="float32")
    jcfg = JaxPipelineConfig(name="tiny-i2v", dit=JaxDiTConfig(**DIT), vae=JaxVAEConfig(**VAE),
                             param_dtype="float32")
    sd = seeded_wan_sd(cfg.dit, 0)
    vae_params = init_vae(cfg.vae, device="cpu", generator=torch.Generator().manual_seed(0))
    jclip_cfg = jclip.CLIPVisionConfig(**CLIP)
    jclip_params = jclip.init_clip_vision(jax.random.PRNGKey(3), jclip_cfg)
    jpipe = ji2v.WanI2V(
        jcfg, to_jnp(jax_from_sd(sd, cfg.dit.num_layers), dtype=jnp.float32),
        JaxVAE.create(jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), vae_params),
                      jcfg.vae),
        jclip_params, jclip_cfg, attn_impl="xla")
    clip_cfg = CLIPVisionConfig(**CLIP)
    clip = clip_vision_from_state_dict(
        clip_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jclip_params)), clip_cfg,
        device="cpu")
    tpipe = WanI2V(cfg, wan_state_dict_to_params(sd, cfg.dit, torch.float32, "cpu"),
                   Wan21VAE.create(vae_params, cfg.vae), clip, clip_cfg)
    return jpipe, tpipe


def _inputs():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    ctx = rng.standard_normal((10, 48)).astype(np.float32)
    ctx_null = rng.standard_normal((6, 48)).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED), (1, 4, 3, 4, 4), jnp.float32))
    return img, ctx, ctx_null, noise


def test_mask_matches_jax():
    np.testing.assert_array_equal(build_i2v_mask(9, 4, 6).numpy(),
                                  np.asarray(ji2v.build_i2v_mask(9, 4, 6)))


def test_generate_matches_jax(pipes):
    jpipe, tpipe = pipes
    img, ctx, ctx_null, noise = _inputs()
    kw = dict(precomputed_context=ctx, precomputed_context_null=ctx_null)
    j_lat = np.asarray(jpipe.generate(img, **{k: jnp.asarray(v) for k, v in kw.items()},
                                      seed=SEED, decode=False, **GEN))
    t_lat = tpipe.generate(img, **{k: torch.tensor(v) for k, v in kw.items()},
                           noise=torch.tensor(noise), decode=False, **GEN).numpy()
    assert t_lat.shape == j_lat.shape == (1, 4, 3, 4, 4)
    assert np.abs(t_lat - j_lat).max() / np.abs(j_lat).max() < 1e-5
    assert float(np.abs(t_lat - noise).max()) > 0.1  # the model moved the latents
    j_vid = jpipe.vae.decode(jnp.asarray(j_lat))[0]
    t_vid = tpipe.decode(torch.tensor(t_lat))
    assert t_vid.shape == (3, 9, 32, 32)
    np.testing.assert_allclose(t_vid.numpy(), np.asarray(j_vid), rtol=1e-4, atol=1e-4)
    assert set(tpipe.timings) == {"clip_s", "vae_encode_s", "denoise_s", "denoise_step_s",
                                  "step_s", "decode_s"}


def test_uint8_frames_and_generator_noise(pipes):
    _, tpipe = pipes
    img, ctx, _, _ = _inputs()
    kw = dict(precomputed_context=torch.tensor(ctx), **dict(GEN, sampling_steps=2))
    a = tpipe.generate(img, generator=torch.Generator().manual_seed(1), decode=False, **kw)
    b = tpipe.generate(img, seed=1, decode=False, **kw)
    assert torch.equal(a, b)  # seed → the same draw as a generator seeded with it
    frames = tpipe.generate(img, seed=1, output_uint8=True, **kw)
    assert frames.dtype == torch.uint8 and frames.shape == (9, 32, 32, 3)
