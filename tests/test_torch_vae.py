"""Wan2.1 VAE decode of the port against the reference golden `vae_tiny.npz`
(rec) and the JAX `vae_decode`, on the CPU, f32.

Tolerance 1e-4 absolute on [-1, 1] frames: the golden test of the JAX
package uses the same for the reference implementation; against JAX the
convolutions sum in another order (oneDNN vs XLA) over up to 27·C taps."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.models.vae2_1 import Wan21VAE as JaxVAE
from omnivideo_tpu_torch.configs.base import VAEConfig
from omnivideo_tpu_torch.io.jax_bridge import vae_decoder_from_state_dict
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE, init_vae, vae_decode

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


def test_decode_matches_golden(golden):
    sd = {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")}
    params = vae_decoder_from_state_dict(sd, VAEConfig(**TINY))
    rec = vae_decode(params, VAEConfig(**TINY), torch.tensor(golden["z_in"]))
    assert rec.shape == golden["rec"].shape
    np.testing.assert_allclose(rec.numpy(), golden["rec"], rtol=1e-4, atol=1e-4)


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
