"""The port's XLM-Roberta (the CLIP text tower) on the CPU: hidden states and
the pooled head output against the reference golden `xlm_tiny.npz`
(rtol 2e-4, atol 2e-5, as the JAX package's test); pad invariance (extra
pad tokens change neither; 1e-5 / 1e-6); both against JAX
`xlm_roberta_apply` / `xlm_roberta_with_head_apply` on JAX's
`init_xlm_roberta` params carried across (`xlm_params_from_jax`), f32,
within 1e-5 of their scale, with a pad tail and an all-pad row; the
port's own init at XLM-R large's layout, cut to 2 layers."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.models import xlm_roberta as jxlm
from omnivideo_tpu_torch.io.jax_bridge import xlm_params_from_jax
from omnivideo_tpu_torch.models.xlm_roberta import (
    PAD_ID,
    init_xlm_roberta,
    xlm_roberta_apply,
    xlm_roberta_state_dict_to_params,
    xlm_roberta_with_head_apply,
)

GOLDEN = Path(__file__).parent / "golden" / "xlm_tiny.npz"


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def params(golden):
    return xlm_roberta_state_dict_to_params(
        {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")},
        device="cpu")


def test_hidden_matches_golden(golden, params):
    out = xlm_roberta_apply(params, torch.tensor(golden["ids"]), num_heads=4)
    np.testing.assert_allclose(out.numpy(), golden["hidden"], rtol=2e-4, atol=2e-5)


def test_pooled_head_matches_golden(golden, params):
    out = xlm_roberta_with_head_apply(params, torch.tensor(golden["ids"]), num_heads=4)
    np.testing.assert_allclose(out.numpy(), golden["pooled"], rtol=2e-4, atol=2e-5)


def test_pad_invariance(golden, params):
    ids = torch.tensor(golden["ids"])
    longer = torch.cat([ids, torch.full((2, 4), PAD_ID, dtype=ids.dtype)], dim=1)
    out = xlm_roberta_with_head_apply(params, ids, num_heads=4)
    out_l = xlm_roberta_with_head_apply(params, longer, num_heads=4)
    np.testing.assert_allclose(out.numpy(), out_l.numpy(), rtol=1e-5, atol=1e-6)
    h, h_l = (xlm_roberta_apply(params, t, num_heads=4) for t in (ids, longer))
    live = (ids != PAD_ID).numpy()
    np.testing.assert_allclose(h.numpy()[live], h_l[:, :10].numpy()[live], rtol=1e-5, atol=1e-6)


def test_matches_jax_on_carried_params():
    jp = jxlm.init_xlm_roberta(jax.random.PRNGKey(4), vocab_size=40, max_seq_len=24, dim=32,
                               num_heads=4, num_layers=2, out_dim=8)
    rng = np.random.default_rng(6)
    jp = jax.tree_util.tree_map(  # non-trivial norms and biases
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), jp)
    ids = rng.integers(3, 40, (3, 12))
    ids[0, 8:] = PAD_ID
    ids[2, :] = PAD_ID
    p = xlm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for jf, tf in ((jxlm.xlm_roberta_apply, xlm_roberta_apply),
                   (jxlm.xlm_roberta_with_head_apply, xlm_roberta_with_head_apply)):
        ref = np.asarray(jf(jp, jnp.asarray(ids, jnp.int32), num_heads=4))
        out = tf(p, torch.tensor(ids), num_heads=4).numpy()
        assert out.shape == ref.shape and np.isfinite(out).all()
        assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


def test_init_large_layout():
    p = init_xlm_roberta(num_layers=2, out_dim=16, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert p["token_embedding"].shape == (250002, 1024) and p["pos_embedding"].shape == (514, 1024)
    assert p["blocks"][0]["ffn_in"]["kernel"].shape == (1024, 4096)
    ids = torch.tensor([[0, 17, 9, 2, PAD_ID]])
    assert xlm_roberta_with_head_apply(p, ids).shape == (1, 16)
