"""Wan2.1 VAE encode and decode of the port against the reference golden
`vae_tiny.npz` (z from x, rec from z_in) and the JAX `vae_encode` /
`vae_decode`, on the CPU, f32.

Tolerance 1e-4 absolute on [-1, 1] frames and on latents: the golden tests
of the JAX package use the same for the reference implementation; against
JAX the convolutions sum in another order (oneDNN vs XLA) over up to 27·C
taps."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.models.vae2_1 import Wan21VAE as JaxVAE
from omnivideo_tpu_torch.configs.base import VAEConfig
from omnivideo_tpu_torch.models.vae2_1 import (
    Wan21VAE,
    init_vae,
    vae_decode,
    vae_encode,
    vae_state_dict_to_params,
)

GOLDEN = Path(__file__).parent / "golden" / "vae_tiny.npz"
TINY = dict(dim=8, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=2, attn_scales=(),
            temperal_downsample=(False, True, True))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _golden_params(golden):
    sd = {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")}
    return vae_state_dict_to_params(sd, VAEConfig(**TINY))


def test_decode_matches_golden(golden):
    rec = vae_decode(_golden_params(golden), VAEConfig(**TINY), torch.tensor(golden["z_in"]))
    assert rec.shape == golden["rec"].shape
    np.testing.assert_allclose(rec.numpy(), golden["rec"], rtol=1e-4, atol=1e-4)


def test_encode_matches_golden(golden):
    z = vae_encode(_golden_params(golden), VAEConfig(**TINY), torch.tensor(golden["x"]))
    assert z.shape == golden["z"].shape
    np.testing.assert_allclose(z.numpy(), golden["z"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("frames,attn_scales", [(9, (1.0,)), (5, ())])
def test_encode_matches_jax(frames, attn_scales):
    """Seeded params (with non-zero attention projections) through both
    encoders, with the Wan2.1 latent scaling."""
    kw = dict(TINY, attn_scales=attn_scales)
    tparams = init_vae(VAEConfig(**kw), device="cpu",
                       generator=torch.Generator().manual_seed(frames))
    _shift_attn_proj(tparams)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tparams)
    x = np.random.default_rng(frames).uniform(-1, 1, (1, 3, frames, 16, 24)).astype(np.float32)
    ref = np.asarray(JaxVAE.create(jparams, JaxVAEConfig(**kw)).encode(jnp.asarray(x)))
    out = Wan21VAE.create(tparams, VAEConfig(**kw)).encode(torch.tensor(x)).numpy()
    assert out.shape == ref.shape == (1, 4, 1 + (frames - 1) // 4, 2, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="4n\\+1"):
        vae_encode(tparams, VAEConfig(**kw), torch.zeros(1, 3, frames + 1, 16, 24))


@pytest.mark.parametrize("t_lat,attn_scales", [(3, (0.5,)), (2, ())])
def test_decode_matches_jax(t_lat, attn_scales):
    """Seeded params (with non-zero attention projections) through both
    decoders, with the Wan2.1 latent scaling."""
    kw = dict(TINY, attn_scales=attn_scales)
    tparams = init_vae(VAEConfig(**kw), device="cpu",
                       generator=torch.Generator().manual_seed(t_lat))
    _shift_attn_proj(tparams)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tparams)
    z = np.random.default_rng(t_lat).standard_normal((1, 4, t_lat, 2, 3)).astype(np.float32)
    ref = np.asarray(JaxVAE.create(jparams, JaxVAEConfig(**kw)).decode(jnp.asarray(z)))
    out = Wan21VAE.create(tparams, VAEConfig(**kw)).decode(torch.tensor(z)).numpy()
    assert out.shape == ref.shape == (1, 3, 1 + 4 * (t_lat - 1), 16, 24)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def _shift_attn_proj(tree):
    for key, val in tree.items():
        if isinstance(val, dict):
            _shift_attn_proj(val)
        elif key == "proj_w":
            val.add_(0.02)


def test_random_init_decodes_in_range():
    cfg = VAEConfig(**TINY)
    params = init_vae(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    out = vae_decode(params, cfg, torch.randn(1, 4, 2, 2, 2))
    assert out.shape == (1, 3, 5, 16, 16)
    assert float(out.abs().max()) <= 1.0 and bool(torch.isfinite(out).all())


def test_bf16_encode_and_decode_match_jax():
    """dtype=bf16 (JAX `vae_dtype`), seeded params, against JAX's bf16
    encode and decode. Both encoders convolve in bf16: latents within 1e-2
    of their scale (bf16 roundings after every layer, in another order;
    measured 2.4e-3). Both decoders round z to bf16 and un-normalize it to
    f32 (the f32 scale promotes it), so they convolve in f32: frames within
    1e-4 absolute, the f32 tolerance (measured 4.8e-6), and within 3e-2 of
    the f32 decode (measured 9.3e-3: z's rounding)."""
    kw = dict(TINY, attn_scales=(0.5,))
    tparams = init_vae(VAEConfig(**kw), device="cpu", generator=torch.Generator().manual_seed(4))
    _shift_attn_proj(tparams)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tparams)
    jvae, tvae = JaxVAE.create(jparams, JaxVAEConfig(**kw)), Wan21VAE.create(tparams,
                                                                              VAEConfig(**kw))
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (1, 3, 5, 16, 24)).astype(np.float32)
    ref = np.asarray(jvae.encode(jnp.asarray(x), dtype=jnp.bfloat16))
    out = tvae.encode(torch.tensor(x), torch.bfloat16).numpy()
    f32 = tvae.encode(torch.tensor(x)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    scale = np.abs(f32).max()
    assert np.abs(out - ref).max() / scale < 1e-2
    assert 0 < np.abs(out - f32).max() / scale < 2e-2  # the bf16 path ran
    z = rng.standard_normal((1, 4, 2, 2, 3)).astype(np.float32)
    ref = np.asarray(jvae.decode(jnp.asarray(z), dtype=jnp.bfloat16))
    out = tvae.decode(torch.tensor(z), torch.bfloat16).numpy()
    f32 = tvae.decode(torch.tensor(z)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert 0 < np.abs(out - f32).max() < 3e-2
