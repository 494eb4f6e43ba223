"""Port ops (omnivideo_tpu_torch.ops: norms, rope, attention) against the JAX
package on the same seeded numpy inputs, on the CPU.

Tolerances: f32 paths 1e-5 relative (sum order and transcendental ulps
differ between XLA and PyTorch); bf16 outputs within one bf16 ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops.attention import attention_xla
from omnivideo_tpu.ops import norms as jnorms
from omnivideo_tpu.ops import rope as jrope
from omnivideo_tpu_torch.ops.attention import attention_plain
from omnivideo_tpu_torch.ops import norms as tnorms
from omnivideo_tpu_torch.ops import rope as trope


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_close(a, b):
    """|a − b| ≤ one bf16 ulp of max(|a|, |b|) elementwise."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32) * 2
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = jnorms.rms_norm(jx, jnp.asarray(w), 1e-6)
    out = tnorms.rms_norm(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(w), 1e-6)
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), _f32(ref), rtol=1e-5, atol=1e-6)
    else:
        _bf16_close(out.float().numpy(), _f32(ref))


@pytest.mark.parametrize("affine,out_f32", [(False, True), (True, False)])
def test_layer_norm_matches_jax(affine, out_f32):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) + 0.5
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32) if affine else None
    b = (0.1 * rng.standard_normal(64)).astype(np.float32) if affine else None
    ref = jnorms.layer_norm(jnp.asarray(x), 1e-6, None if s is None else jnp.asarray(s),
                            None if b is None else jnp.asarray(b), out_f32=out_f32)
    out = tnorms.layer_norm(torch.tensor(x), 1e-6, None if s is None else torch.tensor(s),
                            None if b is None else torch.tensor(b), out_f32=out_f32)
    np.testing.assert_allclose(out.numpy(), _f32(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grid,hd", [((3, 10, 10), 128), ((21, 30, 52), 128), ((2, 4, 6), 16)])
def test_rope_tables_equal_jax(grid, hd):
    jc, js = jrope.rope_3d_tables(grid, hd, 1024, 10000.0)
    tc, ts = trope.rope_3d_tables(grid, hd, 1024, 10000.0)
    assert tc.dtype == np.float32
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(ts, np.asarray(js))


@pytest.mark.parametrize("dtype,L", [("float32", 300), ("bfloat16", 300), ("float32", 340)])
def test_apply_rope_matches_jax(dtype, L):
    """L=340 > the 300-row table: the tail passes through unrotated."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, L, 2, 128)).astype(np.float32)
    cos, sin = trope.rope_3d_tables((3, 10, 10), 128)
    ref = jrope.apply_rope(jnp.asarray(x, dtype), jnp.asarray(cos), jnp.asarray(sin))
    out = trope.apply_rope(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(cos),
                           torch.tensor(sin))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), _f32(ref), rtol=1e-5, atol=1e-6)
    else:
        _bf16_close(out.float().numpy(), _f32(ref))
    if L > 300:
        np.testing.assert_array_equal(out[:, 300:].float().numpy(), x[:, 300:])


def test_pair_swap_is_the_signed_permutation():
    x = torch.arange(8.0).reshape(1, 8)
    np.testing.assert_array_equal(trope.pair_swap(x).numpy(),
                                  np.array([[-1, 0, -3, 2, -5, 4, -7, 6]], np.float32))
    P = jrope._swap_sign_perm(8)
    np.testing.assert_array_equal(trope.pair_swap(x).numpy(), x.numpy() @ P)


@pytest.mark.parametrize("kv_lens", [None, [9, 4]])
def test_attention_plain_matches_xla(kv_lens):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    lens = None if kv_lens is None else np.array(kv_lens, np.int32)
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        None if lens is None else jnp.asarray(lens))
    out = attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          None if lens is None else torch.tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
