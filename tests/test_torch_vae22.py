"""The port's Wan2.2 VAE on the CPU: the pixel patchify round trip; encode
and decode against the reference golden `vae22_tiny.npz` (rtol/atol 1e-4,
as the JAX package's test); encode and decode against JAX
`vae22_encode`/`vae22_decode` on the golden's weights at a second shape that
streams five chunks each way (17 frames at 48×32), f32, within 1e-5 of
their scale (convolutions sum in another order); the reference layout's
names and shapes (`vae22_reference_shapes`) against the golden's state dict;
the Wan22VAE wrapper's latent statistics against JAX's."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.io.torch_convert import to_jnp
from omnivideo_tpu.models import vae2_2 as jvae
from omnivideo_tpu_torch.models.vae2_2 import (
    WAN22_LATENT_MEAN,
    VAE22Config,
    Wan22VAE,
    patchify_pixels,
    unpatchify_pixels,
    vae22_decode,
    vae22_encode,
    vae22_reference_shapes,
    vae22_state_dict_to_params,
)

GOLDEN = Path(__file__).parent / "golden" / "vae22_tiny.npz"
TINY = dict(dim=8, dec_dim=12, z_dim=6, dim_mult=(1, 2, 4, 4), num_res_blocks=2,
            temperal_downsample=(False, True, True))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def sd(golden):
    return {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")}


def test_patchify_roundtrip():
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, 3, 5, 8, 8)), dtype=torch.float32)
    y = patchify_pixels(x, 2)
    assert y.shape == (1, 12, 5, 4, 4)
    assert torch.equal(unpatchify_pixels(y, 2), x)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jvae.patchify_pixels(jnp.asarray(x.numpy()), 2)))


def test_reference_shapes_match_the_golden_state_dict(sd):
    shapes = vae22_reference_shapes(VAE22Config(**TINY))
    assert shapes == {k: tuple(v.shape) for k, v in sd.items()}


def test_encode22_matches_golden(golden, sd):
    cfg = VAE22Config(**TINY)
    z = vae22_encode(vae22_state_dict_to_params(sd, cfg, device="cpu"), cfg,
                     torch.tensor(golden["x"]))
    assert z.shape == golden["z"].shape
    np.testing.assert_allclose(z.numpy(), golden["z"], rtol=1e-4, atol=1e-4)


def test_decode22_matches_golden(golden, sd):
    cfg = VAE22Config(**TINY)
    rec = vae22_decode(vae22_state_dict_to_params(sd, cfg, device="cpu"), cfg,
                       torch.tensor(golden["z_in"]))
    assert rec.shape == golden["rec"].shape
    np.testing.assert_allclose(rec.numpy(), golden["rec"], rtol=1e-4, atol=1e-4)


def test_encode_decode_match_jax_over_more_chunks(sd):
    cfg, jcfg = VAE22Config(**TINY), jvae.VAE22Config(**TINY)
    jparams = to_jnp(jvae.vae22_state_dict_to_params(sd, jcfg))
    jv = jvae.Wan22VAE.create(jparams, jcfg)
    tv = Wan22VAE.create(vae22_state_dict_to_params(sd, cfg, device="cpu"), cfg)
    np.testing.assert_array_equal(tv.mean.numpy(), WAN22_LATENT_MEAN[:6])
    np.testing.assert_array_equal(tv.inv_std.numpy(), np.asarray(jv.inv_std))
    x = np.random.default_rng(5).uniform(-1, 1, (1, 3, 17, 48, 32)).astype(np.float32)
    z_ref = np.asarray(jv.encode(jnp.asarray(x)))
    z = tv.encode(torch.tensor(x)).numpy()
    assert z.shape == z_ref.shape == (1, 6, 5, 3, 2)
    assert np.abs(z - z_ref).max() / np.abs(z_ref).max() < 1e-5
    rec_ref = np.asarray(jv.decode(jnp.asarray(z_ref)))
    rec = tv.decode(torch.tensor(z_ref)).numpy()
    assert rec.shape == rec_ref.shape == (1, 3, 17, 48, 32)
    assert np.abs(rec - rec_ref).max() / np.abs(rec_ref).max() < 1e-5
