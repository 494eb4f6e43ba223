"""The port's weight-only int8 (omnivideo_tpu_torch/ops/quant.py) against
JAX's (omnivideo_tpu/ops/quant.py) on the same numpy arrays, on the CPU.

JAX's kernels are [in, out] and quantise per output column; the port's
Linear weights are [out, in], so each test hands the port the transpose
and holds its int8 payload and f32 scales bit for bit to JAX's transposed.
The error bound is JAX's own (tests/test_streaming.py): per weight, half a
quantisation step (column amax / 254) plus the bf16 rounding of the
dequantised product."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops import quant as jq
from omnivideo_tpu_torch.ops import quant

BF16 = ml_dtypes.bfloat16


def _torch(a: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes bf16 included) → a tensor of the same values and dtype."""
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _payload_bytes(block) -> int:
    """Bytes of a (possibly partly) quantised block's tensors (JAX's quantized_bytes)."""
    return sum(t.numel() * t.element_size() for w in block.values()
               for t in ((w.q8, w.scale) if isinstance(w, quant.Q8) else (w,)))


def _weights(seed=0, shape=(128, 96), dtype=BF16, zero_col=True):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.04).astype(np.float32)
    if zero_col:
        a[:, 5] = 0.0  # an all-zero output channel: scale 1/127
    a[3, 7] = 0.5  # one outlier sets its column's scale
    return a.astype(dtype)


@pytest.mark.parametrize("dtype", [BF16, np.float16])
def test_payload_and_scales_equal_jax(dtype):
    w = _weights(dtype=dtype)  # JAX layout [in, out]
    ref = jq.quantize_leaf(w)
    got = quant.quantize_leaf(_torch(w.T.copy()))
    np.testing.assert_array_equal(got.q8.numpy(), ref["q8"].T)
    np.testing.assert_array_equal(got.scale.numpy(), ref["scale"])
    assert got.scale[5] == np.float32(1.0) / np.float32(127.0)
    assert got.dtype == (torch.bfloat16 if dtype == BF16 else torch.float16)


def test_block_rules_equal_jax():
    """Only 2-D bf16/f16 leaves of ≥ min_size quantise; f32 and small
    leaves pass through; the device-side quantiser (JAX quantize_block_jnp)
    and the host dequantiser (JAX dequantize_block_np) agree with the
    port's one function each (the device-side scales to an f32 ulp)."""
    w, small = _weights(1), _weights(2, (32, 16))
    gain = np.linspace(0.5, 1.5, 96, dtype=np.float32)
    f32w = _weights(3, dtype=np.float32)
    jblock = {"w": w, "small": small, "gain": gain, "f32w": f32w}
    port = {"w": _torch(w.T.copy()), "small": _torch(small.T.copy()), "gain": _torch(gain),
            "f32w": _torch(f32w.T.copy())}
    jhost = jq.quantize_block(jblock, min_size=1024)
    jdev = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda b: jq.quantize_block_jnp(b, min_size=1024))(
            jax.tree_util.tree_map(jnp.asarray, jblock)))
    got = quant.quantize_block(port, min_size=1024)
    assert isinstance(got["w"], quant.Q8)
    assert got["small"] is port["small"] and got["gain"] is port["gain"]
    assert got["f32w"] is port["f32w"]
    np.testing.assert_array_equal(got["w"].q8.numpy(), jhost["w"]["q8"].T)
    np.testing.assert_array_equal(got["w"].scale.numpy(), jhost["w"]["scale"])
    # under jit XLA divides by 127 as a product with its reciprocal: one f32 ulp apart
    np.testing.assert_array_equal(got["w"].q8.numpy(), jdev["w"]["q8"].T)
    np.testing.assert_allclose(got["w"].scale.numpy(), jdev["w"]["scale"], rtol=2.0**-23, atol=0)
    back = quant.dequantize_block(got)
    ref_back = np.asarray(jq.dequantize_block_np(jhost)["w"]).astype(np.float32)
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].float().numpy(), ref_back.T)
    assert _payload_bytes(got) == jq.quantized_bytes(jhost)  # the same payload bytes


def test_error_bound():
    w = _weights(4, zero_col=False)
    got = quant.dequantize_leaf(quant.quantize_leaf(_torch(w.T.copy()))).float().numpy()
    ref = w.astype(np.float32).T
    amax = np.abs(ref).max(axis=1, keepdims=True)
    bound = amax / 254.0 + np.abs(ref) * 2.0**-8
    assert (np.abs(got - ref) <= bound + 1e-9).all()
    assert np.abs(got - ref).max() > 0  # quantisation engaged


def test_round_trips_the_source_dtype():
    block = {"f16": _torch(_weights(5, (64, 64), np.float16)),
             "bf16": _torch(_weights(6, (64, 64)))}
    back = quant.dequantize_block(quant.quantize_block(block, min_size=1024))
    assert back["f16"].dtype == torch.float16 and back["bf16"].dtype == torch.bfloat16
    jback = jax.jit(jq.dequantize_block)(jq.quantize_block(
        {"f16": _weights(5, (64, 64), np.float16), "bf16": _weights(6, (64, 64))},
        min_size=1024))
    assert jback["f16"].dtype == jnp.float16 and jback["bf16"].dtype == jnp.bfloat16


def test_payload_halves_the_bytes():
    block = {"w": _torch(_weights(7, (256, 512)))}
    q = quant.quantize_block(block)
    assert _payload_bytes(q) <= 0.51 * _payload_bytes(block)
