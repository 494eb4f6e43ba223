"""Flash attention of the port (its plain twin on the CPU) against the JAX
Pallas `flash_attention_infer` in interpret mode, in both softmax modes. The
CUDA kernel is held to the plain twin on the card in tests/test_torch_cuda.py.

Inputs are bf16. Tolerance: 4 bf16 ulps of the reference's largest output
magnitude, because p is rounded to bf16 before p·v in both packages, at
points that differ with the mode and the tiling. Each output is a mean over
Lk keys (|o| ~ sqrt(e/Lk)), so the limit scales with the outputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops.pallas.flash_attention import flash_attention_infer
from omnivideo_tpu_torch.ops.flash_attention import (
    GUARD,
    flash_attention,
    flash_attention_plain,
    softmax_bound,
)

ULPS = 4.0


def _assert_close_ulps(out, ref):
    """max |out − ref| ≤ ULPS bf16 ulps of max |ref| (numpy f32 arrays)."""
    ref_max = np.abs(ref).max()
    limit = ULPS * 2.0 ** (np.floor(np.log2(max(ref_max, 2.0**-126))) - 7)
    err = np.abs(out - ref).max()
    assert err <= limit, f"max |out − ref| {err} > {limit} (max |ref| {ref_max})"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, Lq, Lk, N, D, seed, scale=1.0):
    """qk-normed-like q/k rows (RMS `scale`), normal v."""
    rng = np.random.default_rng(seed)

    def normed(L):
        t = rng.standard_normal((B, L, N, D)).astype(np.float32)
        return t / np.sqrt((t**2).mean(-1, keepdims=True)) * scale

    v = rng.standard_normal((B, Lk, N, D)).astype(np.float32)
    return normed(Lq), normed(Lk), v


def _jax(q, k, v, lens, normalized):
    out = flash_attention_infer(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32),
        assume_normalized=normalized, block_q=128, block_k=128, interpret=True)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _port(q, k, v, lens, normalized):
    t = lambda a: torch.tensor(a).bfloat16()  # noqa: E731
    out = flash_attention(t(q), t(k), t(v),
                          kv_lens=None if lens is None else torch.tensor(lens, dtype=torch.int32),
                          assume_normalized=normalized)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("case", ["bounded", "guard_fails", "max_tracked", "kv_lens"])
def test_flash_plain_matches_jax(case):
    B, N, D = 2, 2, 128
    Lq, Lk = (200, 300) if case != "kv_lens" else (150, 260)
    scale = 4.0 if case == "guard_fails" else 1.0
    q, k, v = _qkv(B, Lq, Lk, N, D, seed=len(case), scale=scale)
    lens = [173, 0] if case == "kv_lens" else None
    normalized = case != "max_tracked"
    _, safe = softmax_bound(torch.tensor(q).bfloat16(), torch.tensor(k).bfloat16(), D**-0.5)
    assert bool(safe) == (case != "guard_fails")
    ref = _jax(q, k, v, lens, normalized)
    out = _port(q, k, v, lens, normalized)
    _assert_close_ulps(out, ref)
    if case == "kv_lens":
        assert (out[1] == 0).all()  # fully masked batch row → 0


def test_softmax_bound_matches_jax_guard():
    """mb = ⌈qn·kn·scale·log2e⌉ and the 2·bound+2 < 120 guard, on device
    tensors (no host sync); row norms from qk_prep skip the reductions."""
    q, k, _ = _qkv(2, 40, 50, 3, 128, seed=5)
    tq, tk = torch.tensor(q), torch.tensor(k)
    mb, safe = softmax_bound(tq, tk, 128**-0.5)
    qn = np.sqrt((q**2).sum(-1)).max(1)
    kn = np.sqrt((k**2).sum(-1)).max(1)
    bound = qn * kn * np.float32(128**-0.5 * 1.4426950408889634)
    np.testing.assert_array_equal(mb.numpy(), np.ceil(bound).astype(np.int32))
    assert mb.dtype == torch.int32 and safe.shape == (1,)
    assert bool(safe) == bool(2 * bound.max() + 2 < GUARD)
    mb2, _ = softmax_bound(tq, tk, 128**-0.5, qk_row_norms=(torch.tensor(qn), torch.tensor(kn)))
    np.testing.assert_array_equal(mb2.numpy(), mb.numpy())


def test_plain_modes_agree_and_chunking_is_exact(monkeypatch):
    """Bounded and max-tracked softmax agree up to the bf16 rounding of p;
    the q-row chunking of the plain version changes nothing."""
    from omnivideo_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.tensor(a).bfloat16() for a in _qkv(1, 70, 90, 2, 128, seed=9))
    mb, safe = softmax_bound(q, k, 128**-0.5)
    full = flash_attention_plain(q, k, v, None, None, mb, safe)
    tracked = flash_attention_plain(q, k, v)
    _assert_close_ulps(full.float().numpy(), tracked.float().numpy())
    monkeypatch.setattr(fa, "PLAIN_LOGITS_BUDGET", 2 * 90 * 7)  # 7-row chunks
    chunked = flash_attention_plain(q, k, v, None, None, mb, safe)
    torch.testing.assert_close(chunked, full, rtol=0, atol=0)
