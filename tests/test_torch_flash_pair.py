"""The pair attention of the port (`flash_attention_pair`: the i2v split
cross-attention over text and image keys in one call), its plain twin on the
CPU, against the JAX package's two Pallas `flash_attention_infer` calls
(interpret mode, bounded softmax) and their bf16 sum, as JAX
`_cross_attn_unfused` takes them. The CUDA kernel is held to the plain twin
on the card in tests/test_torch_cuda.py.

Inputs are bf16, made from a numpy seed. Tolerance: each context's output is
within 4 bf16 ulps of its largest magnitude (p is rounded to bf16 before p·v
in both packages, at points that differ with the tiling), so the sum is held
to 4 ulps of each context's max plus one ulp of the sum's max (its own
rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops.pallas.flash_attention import flash_attention_infer
from omnivideo_tpu_torch.ops.flash_attention import (
    PAIR_KERNEL,
    flash_attention,
    flash_attention_pair,
    flash_attention_pair_plain,
    pair_bound,
    softmax_bound,
)
from omnivideo_tpu_torch.ops.qk_prep import qk_prep

ULPS = 4.0
B, N, D = 2, 2, 128


def _ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(x, 2.0**-126))) - 7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(Lq, Lt, Li, seed, img_scale=1.0):
    """q and both key sets qk-normed-like (RMS 1; the image keys `img_scale`),
    normal v; bf16-representable f32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def normed(L, scale=1.0):
        t = rng.standard_normal((B, L, N, D)).astype(np.float32)
        return t / np.sqrt((t**2).mean(-1, keepdims=True)) * scale

    arrs = (normed(Lq), normed(Lt), rng.standard_normal((B, Lt, N, D)).astype(np.float32),
            normed(Li, img_scale), rng.standard_normal((B, Li, N, D)).astype(np.float32))
    return tuple(torch.tensor(a).bfloat16() for a in arrs)


def _jax(q, k, v):
    out = flash_attention_infer(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                                assume_normalized=True, block_q=128, block_k=128, interpret=True)
    return out


def _jax_pair(q, kt, vt, ki, vi):
    """(the bf16 sum, the text output, the image output) as f32 numpy."""
    ot, oi = _jax(q, kt, vt), _jax(q, ki, vi)
    return tuple(np.asarray(jnp.asarray(o, jnp.float32)) for o in (ot + oi, ot, oi))


def _assert_pair_close(out, ref, ref_t, ref_i):
    limit = (ULPS * (_ulp(np.abs(ref_t).max()) + _ulp(np.abs(ref_i).max()))
             + _ulp(np.abs(ref).max()))
    err = np.abs(out - ref).max()
    assert err <= limit, f"max |out − ref| {err} > {limit}"


@pytest.mark.parametrize("Lq,Lt,Li", [
    (48, 16, 1),     # one image key: a narrow tile alone
    (48, 64, 63),    # under one 128-key tile each
    (200, 512, 257),  # I2V-14B's key counts: four text tiles, two image tiles and one key
    (200, 16, 63),
    (48, 512, 1),
])
def test_pair_plain_matches_jax(Lq, Lt, Li):
    q, kt, vt, ki, vi = _inputs(Lq, Lt, Li, seed=Lq + Lt + Li)
    out = flash_attention_pair(q, kt, vt, ki, vi)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _assert_pair_close(out.float().numpy(), *_jax_pair(q, kt, vt, ki, vi))


def test_pair_one_guard_fails():
    """Image keys at RMS 4: that context's guard fails and it runs
    max-tracked, the text context stays bounded; both as JAX chooses."""
    q, kt, vt, ki, vi = _inputs(48, 64, 257, seed=3, img_scale=4.0)
    _, safe = pair_bound(q, kt, ki, D**-0.5)
    assert safe.tolist() == [1, 0]
    out = flash_attention_pair(q, kt, vt, ki, vi)
    _assert_pair_close(out.float().numpy(), *_jax_pair(q, kt, vt, ki, vi))


def test_pair_bound_is_softmax_bound_per_context():
    q, kt, _, ki, _ = _inputs(40, 30, 20, seed=4, img_scale=4.0)
    mb, safe = pair_bound(q, kt, ki, D**-0.5)
    assert mb.dtype == safe.dtype == torch.int32 and mb.shape == (2, B, N)
    for c, k in enumerate((kt, ki)):
        m1, s1 = softmax_bound(q, k, D**-0.5)
        assert torch.equal(mb[c], m1) and torch.equal(safe[c:c + 1], s1)


def test_pair_is_the_two_calls_summed():
    """The plain twin is two row-1 plain calls (their own bounds) and one
    rounding of their f32 sum: bit for bit."""
    q, kt, vt, ki, vi = _inputs(70, 40, 257, seed=6)
    mb, safe = pair_bound(q, kt, ki, D**-0.5)
    a = flash_attention(q, kt, vt, assume_normalized=True)
    b = flash_attention(q, ki, vi, assume_normalized=True)
    assert torch.equal(flash_attention_pair_plain(q, kt, vt, ki, vi, None, mb, safe),
                       (a.float() + b.float()).bfloat16())


def test_pair_on_qk_prep_row_norms():
    """The bounds from qk_prep's row norms (inflated by 1 + 2⁻⁷) against the
    exact reductions: the same output within the tolerance."""
    rng = np.random.default_rng(8)
    d = N * D
    x, xt, xi = (torch.tensor(rng.standard_normal((B, L, d)).astype(np.float32) * 3).bfloat16()
                 for L in (60, 512, 257))
    g = torch.tensor(1.0 + 0.1 * rng.standard_normal(d).astype(np.float32))
    (q, qn), (kt, knt), (ki, kni) = (qk_prep(t, g, None, None, N, 1e-6) for t in (x, xt, xi))
    vt, vi = (torch.tensor(rng.standard_normal((B, L, N, D)).astype(np.float32)).bfloat16()
              for L in (512, 257))
    mb_n, _ = pair_bound(q, kt, ki, D**-0.5, (qn, knt, kni))
    mb_x, _ = pair_bound(q, kt, ki, D**-0.5)
    assert (mb_n >= mb_x).all()
    out = flash_attention_pair(q, kt, vt, ki, vi, qk_row_norms=(qn, knt, kni))
    _assert_pair_close(out.float().numpy(), *_jax_pair(q, kt, vt, ki, vi))


def test_pair_registered_op_on_cpu():
    """`omnivideo::flash_attention_pair` on CPU tensors is the plain twin (no
    launch counted); under autograd the wrapper runs the twin outside the op
    and the gradient flows."""
    q, kt, vt, ki, vi = _inputs(33, 20, 5, seed=9)
    mb, safe = pair_bound(q, kt, ki, D**-0.5)
    n0 = flash_attention.launches[PAIR_KERNEL]
    got = torch.ops.omnivideo.flash_attention_pair(q, kt, vt, ki, vi, mb, safe, D**-0.5)
    assert torch.equal(got, flash_attention_pair_plain(q, kt, vt, ki, vi, D**-0.5, mb, safe))
    assert flash_attention.launches[PAIR_KERNEL] == n0
    qg = q.float().requires_grad_()
    flash_attention_pair(qg, kt.float(), vt.float(), ki.float(), vi.float()).sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
