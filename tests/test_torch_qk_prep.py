"""qk_prep of the port (its plain twin, on the CPU) against the JAX Pallas
kernel in interpret mode. The CUDA kernel is held to the plain twin on the
card in tests/test_torch_cuda.py.

y is bf16: held within one bf16 ulp (the f32 math before the cast differs
only in sum order and rsqrt ulps, which can flip a rounding). The row-norm
bound rn is f32: 1e-5 relative, and it must bound every actual row norm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops.pallas.qk_prep import qk_prep as jax_qk_prep
from omnivideo_tpu_torch.ops.qk_prep import qk_prep
from omnivideo_tpu_torch.ops.rope import rope_3d_tables


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, L, N, hd, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, N * hd)) * 3).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(N * hd)).astype(np.float32)
    return x, g


def _assert_within_bf16_ulp(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()


@pytest.mark.parametrize("case", ["rope", "norm_only", "past_table"])
def test_qk_prep_matches_jax(case):
    B, N, hd = 2, 2, 128
    L = 340 if case == "past_table" else 300
    x, g = _inputs(B, L, N, hd, seed=len(case))
    cos, sin = rope_3d_tables((3, 10, 10), hd) if case != "norm_only" else (None, None)
    jy, jrn = jax_qk_prep(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), cos, sin, N, 1e-6,
                          block_rows=128, interpret=True)
    ty, trn = qk_prep(torch.tensor(x).bfloat16(), torch.tensor(g),
                      None if cos is None else torch.tensor(cos),
                      None if sin is None else torch.tensor(sin), N, 1e-6)
    assert ty.shape == (B, L, N, hd) and ty.dtype == torch.bfloat16
    _assert_within_bf16_ulp(ty.float().numpy(), np.asarray(jnp.asarray(jy, jnp.float32)))
    np.testing.assert_allclose(trn.numpy(), np.asarray(jrn), rtol=1e-5)
    actual = np.linalg.norm(ty.float().numpy(), axis=-1).max(axis=1)
    assert (trn.numpy() >= actual).all()


def test_qk_prep_f32_is_rms_norm_then_rope():
    """At f32 the op order collapses to the unfused chain exactly."""
    from omnivideo_tpu_torch.ops.norms import rms_norm
    from omnivideo_tpu_torch.ops.rope import apply_rope

    x, g = _inputs(1, 300, 2, 128, seed=7)
    cos, sin = (torch.tensor(t) for t in rope_3d_tables((3, 10, 10), 128))
    y, _ = qk_prep(torch.tensor(x), torch.tensor(g), cos, sin, 2, 1e-6)
    ref = apply_rope(rms_norm(torch.tensor(x), torch.tensor(g), 1e-6).view(1, 300, 2, 128),
                     cos, sin)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
