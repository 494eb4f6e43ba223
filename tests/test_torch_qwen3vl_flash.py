"""The two flash modes the Qwen3-VL stage adds, the port's plain twin on the
CPU against the JAX Pallas `flash_attention_infer` in interpret mode:

- causal at head dim 128 (the Qwen3 text prefill; the JAX packed path),
  block_q = block_k = 128 at L = 300 so the diagonal straddles tiles;
- head dim 72 (the vision tower; the JAX head-major path, D % 128 ≠ 0) in
  both softmax modes and with kv_lens.

The CUDA kernels are held to the same plain twin on the card in
tests/test_torch_cuda.py. Inputs are bf16; the tolerance is 4 bf16 ulps of
each output row's largest reference magnitude (p is rounded to bf16 before
p·v at points that differ with the tiling). Per row, not over the whole
output: under the causal mask row 0 is a raw v row while later rows average
many keys and are far smaller, so a limit taken from the global maximum
would not see an error confined to later rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops.pallas.flash_attention import flash_attention_infer
from omnivideo_tpu_torch.ops import flash_attention as fa
from omnivideo_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    softmax_bound,
)

ULPS = 4.0


def _assert_close_ulps(out, ref):
    """|out − ref| within ULPS bf16 ulps of each [.., D] row's max |ref|."""
    row_max = np.maximum(np.abs(ref).max(-1, keepdims=True), 2.0**-126)
    limit = ULPS * 2.0 ** (np.floor(np.log2(row_max)) - 7)
    ulps = np.abs(out - ref) / limit * ULPS
    assert (ulps <= ULPS).all(), f"{ulps.max()} row ulps at row {np.unravel_index(ulps.argmax(), ulps.shape)}"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, L, N, D, seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def normed():
        t = rng.standard_normal((B, L, N, D)).astype(np.float32)
        return t / np.sqrt((t**2).mean(-1, keepdims=True)) * scale

    return normed(), normed(), rng.standard_normal((B, L, N, D)).astype(np.float32)


def _jax(q, k, v, lens, normalized=False, causal=False):
    out = flash_attention_infer(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32),
        assume_normalized=normalized, causal=causal, block_q=128, block_k=128, interpret=True)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _port(q, k, v, lens, normalized=False, causal=False):
    t = lambda a: torch.tensor(a).bfloat16()  # noqa: E731
    out = flash_attention(t(q), t(k), t(v), causal=causal, assume_normalized=normalized,
                          kv_lens=None if lens is None else torch.tensor(lens, dtype=torch.int32))
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("lens", [None, [211, 0]])
def test_causal_d128_matches_jax(lens):
    """Token-causal prefill (max-tracked, as the text prefill runs it)."""
    q, k, v = _qkv(2, 300, 2, 128, seed=3)
    out = _port(q, k, v, lens, causal=True)
    _assert_close_ulps(out, _jax(q, k, v, lens, causal=True))
    assert not np.allclose(out, _port(q, k, v, lens), atol=1e-2)  # the mask matters
    if lens is not None:
        assert (out[1] == 0).all()


@pytest.mark.parametrize("case", ["bounded", "guard_fails", "max_tracked", "kv_lens"])
def test_d72_matches_jax(case):
    """Head dim 72, the vision tower's per-temporal-group attention."""
    B, L, N, D = 3, 200, 2, 72
    q, k, v = _qkv(B, L, N, D, seed=len(case), scale=4.0 if case == "guard_fails" else 1.0)
    lens = [200, 97, 0] if case == "kv_lens" else None
    normalized = case != "max_tracked"
    _, safe = softmax_bound(torch.tensor(q).bfloat16(), torch.tensor(k).bfloat16(), D**-0.5)
    assert bool(safe) == (case != "guard_fails")
    out = _port(q, k, v, lens, normalized)
    _assert_close_ulps(out, _jax(q, k, v, lens, normalized))
    if lens is not None:
        assert (out[2] == 0).all()


def test_causal_plain_chunking_is_exact(monkeypatch):
    """The q-row chunks of the plain version carry the absolute row index
    into the causal mask."""
    q, k, v = (torch.tensor(a).bfloat16() for a in _qkv(1, 90, 2, 128, seed=9))
    full = flash_attention_plain(q, k, v, causal=True)
    monkeypatch.setattr(fa, "PLAIN_LOGITS_BUDGET", 2 * 90 * 7)  # 7-row chunks
    chunked = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(chunked, full, rtol=0, atol=0)
    # row 0 attends to key 0 only
    torch.testing.assert_close(full[0, 0], v[0, 0], rtol=0, atol=0)


def test_strided_v_matches_contiguous():
    """The plain version reads strided views (a column slice of a packed
    qkv) as it reads packed ones; the CUDA kernel takes packed operands
    only and raises otherwise (tests/test_torch_cuda.py)."""
    B, L, N, D = 2, 50, 2, 72
    q, k, v = (torch.tensor(a).bfloat16() for a in _qkv(B, L, N, D, seed=4))
    qkv = torch.cat([t.reshape(B, L, N * D) for t in (q, k, v)], dim=-1)
    vs = qkv[..., 2 * N * D:].unflatten(-1, (N, D))
    assert not vs.is_contiguous()
    torch.testing.assert_close(flash_attention(q, k, vs, assume_normalized=True),
                               flash_attention(q, k, v, assume_normalized=True), rtol=0, atol=0)

