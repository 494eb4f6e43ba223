"""The port's training flash attention (its plain twins on the CPU) against
the JAX Pallas `flash_attention` custom VJP in interpret mode
(block_q = block_k = 128, as `attention(impl="pallas_interpret")` runs it):
the forward's o and natural-log LSE (`_flash_fwd_impl(return_residuals=True)`)
and dq/dk/dv under `jax.vjp`, at f32 with L not a multiple of 128 and a
kv_lens row of 0. The CUDA kernels are held to these plain twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, f32: o and the gradients within 1e-5 of each tensor's largest
magnitude (the online softmax of the Pallas kernel rescales block by block,
the plain twin takes the whole row: only summation order differs); LSE
within 1e-5 absolute where a row has keys (|LSE| ~ ln Lk ≈ 5), and equal to
1e-6 relative for rows with none (both −1e30·ln2 + ln 1e-30).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops.pallas.flash_attention import _flash_fwd_impl
from omnivideo_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from omnivideo_tpu_torch.ops.attention import attention, attention_plain
from omnivideo_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_train,
    flash_fwd_lse,
)
from omnivideo_tpu_torch.ops.qk_prep import qk_prep

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Lq, Lk, N, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, Lq, N, D), (B, Lk, N, D), (B, Lk, N, D), (B, Lq, N, D)))
    return q, k, v, g


def _rel(out, ref):
    return float(np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(ref).max())


CASES = {
    "self_kv_lens": (2, 200, 200, [137, 0]),  # ragged tiles, one batch row without keys
    "cross": (2, 200, 77, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_train_matches_pallas_vjp(case):
    B, Lq, Lk, lens = CASES[case]
    N, D = 2, 128
    q, k, v, g = _inputs(B, Lq, Lk, N, D, seed=Lq + Lk)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_out, res = _flash_fwd_impl(jq, jk, jv, jl, None, 128, 128, interpret=True,
                                 return_residuals=True)
    j_lse = np.asarray(res[0])
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jl, None, 128, 128, True), jq, jk, jv)
    j_grads = vjp(jnp.asarray(g))

    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o, lse = flash_fwd_lse(tq.detach(), tk.detach(), tv.detach(), tl)
    assert lse.shape == (B, N, Lq) and lse.dtype == torch.float32
    assert _rel(o.numpy(), j_out) < TOL
    live = np.ones(B, bool) if lens is None else np.asarray(lens) > 0
    np.testing.assert_allclose(lse.numpy()[live], j_lse[live], rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy()[~live], j_lse[~live], rtol=1e-6)

    out = flash_attention_train(tq, tk, tv, tl)
    assert _rel(out.detach().numpy(), j_out) < TOL
    out.backward(torch.tensor(g))
    for name, t, ref in zip("qkv", (tq, tk, tv), j_grads):
        assert _rel(t.grad.numpy(), ref) < TOL, (name, _rel(t.grad.numpy(), ref))
    if lens is not None:  # no keys: zero dq; keys past kv_len: zero dk, dv
        assert float(tq.grad[1].abs().max()) == 0.0
        for t in (tk, tv):
            assert float(t.grad[0, lens[0]:].abs().max()) == 0.0
            assert float(t.grad[1].abs().max()) == 0.0


def test_flash_train_grads_match_einsum_autograd():
    """The hand-written backward against torch autograd through the einsum
    oracle (attention_plain), f32, with ragged kv_lens."""
    q, k, v, g = _inputs(2, 70, 90, 3, 128, seed=4)
    lens = torch.tensor([90, 31])
    grads = []
    for fn in (flash_attention_train, attention_plain):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        fn(*ts, lens).backward(torch.tensor(g))
        grads.append([t.grad.numpy() for t in ts])
    for a, b in zip(*grads):
        assert _rel(a, b) < TOL


def test_attention_dispatch():
    """Grad mode with an input that requires grad → the training forward
    (max-tracked, differentiable); otherwise the inference forward."""
    q, k, v, _ = _inputs(1, 40, 40, 2, 128, seed=1)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    n0 = dict(flash_attention_train.launches)
    with torch.no_grad():
        ref = flash_attention(tq, tk, tv)
        torch.testing.assert_close(attention(tq, tk, tv), ref, rtol=0, atol=0)
    out = attention(tq.requires_grad_(), tk, tv)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), ref, rtol=1e-6, atol=1e-6)
    assert flash_attention_train.launches == n0  # CPU: plain twins, no launches


def test_kernel_wrappers_refuse_grad_off_the_cpu():
    """The inference flash kernel and qk_prep have no backward: off the CPU,
    with grad mode on and an input that requires grad, they raise instead of
    returning an output without autograd history (shown on the meta device,
    which reaches the same guard as CUDA)."""
    q = torch.empty(1, 64, 2, 128, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q, q)
    x = torch.empty(1, 64, 256, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        qk_prep(x, torch.ones(256, device="meta"), None, None, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)  # past the guard: no kernel for the meta device
