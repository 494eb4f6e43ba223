"""umT5 encoder of the port against the reference golden `t5_tiny.npz` and
the JAX `t5_encode`, on the CPU.

Tolerances: the golden keeps the JAX package's own 2e-4 (the reference
torch implementation); against JAX at f32 the same ops in the same order,
1e-5 of the output's scale (sum order inside the matmuls). With bf16
weights the two frameworks round the elementwise chains at other points,
and the flips compound over the layers: the port's bf16 output is held to
the JAX f32 output as closely as the JAX bf16 output is, within a factor
1.5.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import T5Config as JaxT5Config
from omnivideo_tpu.io.torch_convert import to_jnp
from omnivideo_tpu.models.t5 import rel_position_buckets as jax_buckets
from omnivideo_tpu.models.t5 import init_t5 as jax_init_t5
from omnivideo_tpu.models.t5 import t5_encode, t5_state_dict_to_params as jax_sd_to_params
from omnivideo_tpu_torch.configs.base import T5Config
from omnivideo_tpu_torch.io.jax_bridge import load_t5
from omnivideo_tpu_torch.models.t5 import (
    T5Encoder,
    T5EncoderModel,
    init_t5,
    rel_position_buckets,
    t5_state_dict_to_params,
)

GOLDEN = Path(__file__).parent / "golden" / "t5_tiny.npz"
TINY = dict(vocab_size=100, dim=32, dim_attn=32, dim_ffn=64, num_heads=4, num_layers=3,
            num_buckets=8, shared_pos=False, text_len=16)


def _encoder(sd, dtype=torch.float32):
    return t5_state_dict_to_params(T5Encoder(T5Config(**TINY), dtype, device="cpu"), sd)


def test_golden_parity():
    g = np.load(GOLDEN)
    sd = {k[len("sd::"):]: g[k] for k in g.files if k.startswith("sd::")}
    out = _encoder(sd)(torch.tensor(g["ids"]), torch.tensor(g["mask"]))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=2e-4, atol=2e-4)


def _seeded_sd(seed=0):
    """Reference-named weights (the JAX init's distributions, non-unit norms)."""
    rng = np.random.default_rng(seed)
    c = T5Config(**TINY)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = {"token_embedding.weight": f(c.vocab_size, c.dim), "norm.weight": 1 + 0.1 * f(c.dim)}
    for i in range(c.num_layers):
        p = f"blocks.{i}"
        sd[f"{p}.norm1.weight"] = 1 + 0.1 * f(c.dim)
        sd[f"{p}.norm2.weight"] = 1 + 0.1 * f(c.dim)
        for n in "qkv":
            sd[f"{p}.attn.{n}.weight"] = f(c.dim_attn, c.dim) * c.dim**-0.5
        sd[f"{p}.attn.o.weight"] = f(c.dim, c.dim_attn) * c.dim_attn**-0.5
        sd[f"{p}.ffn.gate.0.weight"] = f(c.dim_ffn, c.dim) * c.dim**-0.5
        sd[f"{p}.ffn.fc1.weight"] = f(c.dim_ffn, c.dim) * c.dim**-0.5
        sd[f"{p}.ffn.fc2.weight"] = f(c.dim, c.dim_ffn) * c.dim_ffn**-0.5
        sd[f"{p}.pos_embedding.embedding.weight"] = f(c.num_buckets, c.num_heads)
    return sd


def _jax_encode(sd, dtype, ids, mask):
    params = to_jnp(jax_sd_to_params(sd, JaxT5Config(**TINY)), dtype=dtype)
    params["norm"] = params["norm"].astype(jnp.float32)
    for k in ("norm1", "norm2"):
        params["layers"][k] = params["layers"][k].astype(jnp.float32)
    return np.asarray(t5_encode(params, JaxT5Config(**TINY), jnp.asarray(ids), jnp.asarray(mask)),
                      np.float32)


def test_matches_jax_t5_encode():
    sd = _seeded_sd()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, TINY["vocab_size"], (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 9:] = 0
    ref32 = _jax_encode(sd, jnp.float32, ids, mask)
    ref16 = _jax_encode(sd, jnp.bfloat16, ids, mask)
    scale = np.abs(ref32).max()
    out = {}
    for dt in ("float32", "bfloat16"):
        o = _encoder(sd, getattr(torch, dt))(torch.tensor(ids), torch.tensor(mask))
        assert o.dtype == torch.float32 and o.shape == (2, 16, 32)
        out[dt] = o.numpy()
    assert np.abs(out["float32"] - ref32).max() / scale < 1e-5
    jax_gap = np.abs(ref16 - ref32).max() / scale
    assert np.abs(out["bfloat16"] - ref32).max() / scale <= 1.5 * jax_gap


def test_jax_init_bridges_into_port():
    """The JAX init_t5 pytree (stacked layers, kernels [in, out]) carried into
    the port by load_t5 encodes as JAX does (f32)."""
    import jax

    params = jax_init_t5(jax.random.PRNGKey(0), JaxT5Config(**TINY), dtype=jnp.float32)
    ids = np.random.default_rng(2).integers(0, TINY["vocab_size"], (1, 16))
    mask = np.ones((1, 16), np.int64)
    ref = np.asarray(t5_encode(params, JaxT5Config(**TINY), jnp.asarray(ids), jnp.asarray(mask)))
    enc = load_t5(T5Encoder(T5Config(**TINY), torch.float32, device="cpu"),
                  jax.tree_util.tree_map(np.asarray, params))
    out = enc(torch.tensor(ids), torch.tensor(mask)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


def test_buckets_equal_jax():
    for lq, lk, nb, md in ((16, 16, 8, 16), (512, 512, 32, 128), (7, 11, 32, 128)):
        np.testing.assert_array_equal(rel_position_buckets(lq, lk, nb, md),
                                      jax_buckets(lq, lk, nb, md))


def test_encoder_model_strips_to_mask_lengths():
    enc = init_t5(T5Config(**TINY), dtype=torch.float32, device="cpu", seed=3)
    ids = torch.arange(32).reshape(2, 16) % TINY["vocab_size"]
    mask = torch.ones(2, 16, dtype=torch.int64)
    mask[0, 5:] = 0
    out = T5EncoderModel(enc).encode_ids(ids, mask)
    assert [tuple(o.shape) for o in out] == [(5, 32), (16, 32)]
    full = enc(ids, mask)
    torch.testing.assert_close(out[0], full[0, :5])
    # masked keys do not reach the live tokens
    mask2 = mask.clone()
    ids2 = ids.clone()
    ids2[0, 5:] = 0
    torch.testing.assert_close(enc(ids2, mask2)[0, :5], full[0, :5])
    with pytest.raises(RuntimeError, match="tokenizer"):  # none attached
        T5EncoderModel(enc)(["a prompt"])
