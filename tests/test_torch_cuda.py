"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor omnivideo_tpu, so on a GPU
machine without JAX it runs on its own, skipping the JAX-bound conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: flash outputs within 4 bf16 ulps of each output row's largest
plain magnitude (p is rounded to bf16 before p·v at points that differ with
the mode; each output is a mean over the keys a row sees, so |o| shrinks
like sqrt(e/keys): under the causal mask row 0 is a raw v row while row r
is ~sqrt(e/(r+1)), so the limit is taken per row, never from the global
maximum, and an error confined to later KV tiles shows). qk_prep outputs
≤ 4 bf16 ulps of each RoPE pair's magnitude and < 0.1% of elements differing
at all (the f32 rs differs in its last bits with the summation order, which
can flip the bf16 roundings before the rotation); its row-norm bound 1e-4
relative. The training kernels: o as above, the natural-log LSE within
1e-4 absolute (f32 sums in another order), dq/dk/dv within 1e-2 of their
own norm per (batch row, head) (p and ds are rounded to bf16 before their
products in both versions, at values that differ in the last f32 bits), and
the autograd function's directional derivatives within 2e-2 of central
finite differences of an f64 einsum attention (the kernels' bf16 operands).
fused_adaln: x_new bit for bit (the kernel rounds each product and sum as
PyTorch does), y within 1 bf16 ulp of each row's max |y_plain| (bf16 out) or
1e-5 of it (f32 out): the row mean and variance sum in another order.
"""

import numpy as np
import pytest
import torch

from omnivideo_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_train,
    flash_bwd,
    flash_bwd_plain,
    flash_delta,
    flash_fwd_lse,
    flash_fwd_lse_plain,
    softmax_bound,
)
from omnivideo_tpu_torch.ops.fused_adaln import fused_adaln, fused_adaln_plain
from omnivideo_tpu_torch.ops.qk_prep import qk_prep, qk_prep_plain
from omnivideo_tpu_torch.ops.rope import rope_3d_tables

pytestmark = pytest.mark.cuda

FLASH_ULPS = 4.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0**-126))) - 7)


def _row_ulps(out, ref):
    """|out − ref| in bf16 ulps of each [.., D] row's max |ref|."""
    row_max = ref.float().abs().amax(-1, keepdim=True)
    return (out.float() - ref.float()).abs() / _bf16_ulp(row_max)


def _assert_flash_close(out, ref):
    ulps = _row_ulps(out, ref)
    worst = float(ulps.max())
    assert worst <= FLASH_ULPS, f"{worst} row ulps > {FLASH_ULPS} at {divmod(int(ulps.argmax()), ulps.shape[-1])}"


def _pair_ulps(y, ref):
    """|y − ref| in bf16 ulps of each RoPE pair's magnitude."""
    r = ref.float().unflatten(-1, (-1, 2)).square().sum(-1).sqrt().repeat_interleave(2, -1)
    return (y.float() - ref.float()).abs() / _bf16_ulp(r)


@pytest.mark.parametrize("L,rope", [(4096, True), (1000, False), (5000, True)])
def test_qk_prep_kernel_matches_plain(cuda, L, rope):
    """L=5000 runs past the 4320-row RoPE table: the tail is unrotated."""
    B, N, hd = 2, 12, 128
    gen = torch.Generator(device=cuda).manual_seed(L)
    x = (torch.randn(B, L, N * hd, generator=gen, device=cuda) * 3).bfloat16()
    g = 1.0 + 0.1 * torch.randn(N * hd, generator=gen, device=cuda)
    cos, sin = (torch.tensor(t, device=cuda) for t in rope_3d_tables((4, 30, 36), hd))
    c, s = (cos, sin) if rope else (None, None)
    n0 = qk_prep.launches
    y, rn = qk_prep(x, g, c, s, N, 1e-6)
    assert qk_prep.launches == n0 + 1
    assert y.shape == (B, L, N, hd) and y.dtype == torch.bfloat16
    yp, rnp = qk_prep_plain(x, g, c, s, N, 1e-6)
    assert float(_pair_ulps(y, yp).max()) <= 4.0
    assert float((y != yp).float().mean()) < 1e-3
    torch.testing.assert_close(rn, rnp, rtol=1e-4, atol=0)


def test_qk_prep_kernel_rejects_f32(cuda):
    x = torch.zeros(1, 8, 256, device=cuda)
    with pytest.raises(ValueError):
        qk_prep(x, torch.ones(256, device=cuda), None, None, 2)


def _qkv(B, Lq, Lk, N, D, seed, scale, device):
    rng = np.random.default_rng(seed)

    def normed(L):
        t = rng.standard_normal((B, L, N, D)).astype(np.float32)
        return t / np.sqrt((t**2).mean(-1, keepdims=True)) * scale

    v = rng.standard_normal((B, Lk, N, D)).astype(np.float32)
    return (torch.tensor(a, device=device).bfloat16() for a in (normed(Lq), normed(Lk), v))


@pytest.mark.parametrize("Lq,Lk,scale,lens", [
    (1000, 1000, 1.0, None),       # bounded self-attention, ragged tiles
    (1000, 512, 1.0, None),        # bounded cross-attention
    (512, 700, 4.0, None),         # guard fails: max-tracked
    (300, 700, 1.0, [433, 0]),     # kv_lens, one fully masked row
])
def test_flash_kernel_matches_plain(cuda, Lq, Lk, scale, lens):
    B, N, D = 2, 12, 128
    q, k, v = _qkv(B, Lq, Lk, N, D, Lq + Lk, scale, cuda)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    mb, safe = softmax_bound(q, k, D**-0.5)
    assert bool(safe) == (scale == 1.0)
    n0 = flash_attention.launches["flash_fwd"]
    out = flash_attention(q, k, v, kv_lens=kv, assume_normalized=True)
    tracked = flash_attention(q, k, v, kv_lens=kv, assume_normalized=False)
    assert flash_attention.launches["flash_fwd"] == n0 + 2
    ref = flash_attention_plain(q, k, v, kv, None, mb, safe)
    _assert_flash_close(out, ref)
    _assert_flash_close(tracked, ref)
    _assert_flash_close(tracked, out)
    if lens is not None:
        assert (out[1] == 0).all() and (tracked[1] == 0).all()


@pytest.mark.parametrize("L,lens", [(300, None), (1000, None), (700, [433, 0])])
def test_flash_causal_kernel_matches_plain(cuda, L, lens):
    """Causal prefill at head dim 128: ragged diagonal tiles, kv_lens with a
    fully masked batch row, max-tracked softmax (as the text prefill runs)."""
    B, N, D = 2, 8, 128
    q, k, v = _qkv(B, L, L, N, D, L, 1.0, cuda)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0 = dict(flash_attention.launches)
    out = flash_attention(q, k, v, kv_lens=kv, causal=True)
    assert flash_attention.launches["flash_causal"] == n0["flash_causal"] + 1
    assert flash_attention.launches["flash_fwd"] == n0["flash_fwd"]
    _assert_flash_close(out, flash_attention_plain(q, k, v, kv, None, causal=True))
    if lens is not None:
        assert (out[1] == 0).all()


@pytest.mark.parametrize("scale,lens", [
    (1.0, None),           # bounded
    (4.0, None),           # guard fails: max-tracked
    (1.0, [999, 0, 517]),  # kv_lens, one fully masked row
])
def test_flash_d72_kernel_matches_plain(cuda, scale, lens):
    """Head dim 72 (the vision tower), both softmax modes, read in place."""
    B, L, N, D = 3, 1000, 16, 72
    q, k, v = _qkv(B, L, L, N, D, 72 + L, scale, cuda)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    mb, safe = softmax_bound(q, k, D**-0.5)
    assert bool(safe) == (scale == 1.0)
    n0 = flash_attention.launches["flash_d72"]
    out = flash_attention(q, k, v, kv_lens=kv, assume_normalized=True)
    tracked = flash_attention(q, k, v, kv_lens=kv)
    assert flash_attention.launches["flash_d72"] == n0 + 2
    ref = flash_attention_plain(q, k, v, kv, None, mb, safe)
    _assert_flash_close(out, ref)
    _assert_flash_close(tracked, ref)
    if lens is not None:
        assert (out[1] == 0).all() and (tracked[1] == 0).all()


@pytest.mark.parametrize("D,causal", [(64, False), (72, True), (96, False)])
def test_flash_kernel_rejects_other_head_dims(cuda, D, causal):
    q = torch.zeros(1, 8, 2, D, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, causal=causal)


def test_flash_kernel_rejects_strided_operands(cuda):
    """The kernel reads packed [B, L, N·D] rows: a column slice of a packed
    qkv must be made contiguous first (the vision tower does so)."""
    B, L, N, D = 1, 64, 2, 72
    qkv = torch.zeros(B, L, 3 * N * D, device=cuda, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * N * D:(i + 1) * N * D].unflatten(-1, (N, D)) for i in range(3))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


TRAIN_CASES = [
    (2, 1000, 1000, None),      # self-attention, ragged tiles
    (2, 1000, 300, None),       # cross-attention
    (2, 300, 700, [433, 0]),    # kv_lens, one batch row without keys
]


def _grad_rel(g, ref):
    """‖g − ref‖ / ‖ref‖ per (batch row, head) of [B, L, N, D] gradients."""
    num = (g.float() - ref.float()).square().sum(dim=(1, 3)).sqrt()
    return num / ref.float().square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)


@pytest.mark.parametrize("B,Lq,Lk,lens", TRAIN_CASES)
def test_flash_train_kernels_match_plain(cuda, B, Lq, Lk, lens):
    N, D = 4, 128
    q, k, v = _qkv(B, Lq, Lk, N, D, Lq + 3 * Lk, 1.0, cuda)
    do = torch.randn(B, Lq, N, D, generator=torch.Generator(cuda).manual_seed(Lq),
                     device=cuda).bfloat16()
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0 = dict(flash_attention_train.launches)
    o, lse = flash_fwd_lse(q, k, v, kv)
    op, lsep = flash_fwd_lse_plain(q, k, v, kv)
    _assert_flash_close(o, op)
    live = [b for b in range(B) if lens is None or lens[b] > 0]
    torch.testing.assert_close(lse[live], lsep[live], rtol=0, atol=1e-4)
    assert (lse[[b for b in range(B) if b not in live]] < -1e29).all()  # no keys
    delta = flash_delta(do, op)
    grads = flash_bwd(q, k, v, do, lsep, delta, kv)
    ref = flash_bwd_plain(q, k, v, do, lsep, delta, kv)
    assert {k_: flash_attention_train.launches[k_] - n0[k_] for k_ in n0} == {
        "flash_fwd_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for g, r in zip(grads, ref):
        assert g.dtype == torch.float32
        worst = float(_grad_rel(g[live], r[live]).max())
        assert worst < 1e-2, worst
    if lens is not None:
        assert (o[1] == 0).all() and (grads[0][1] == 0).all()
        for g in grads[1:]:
            assert (g[0, lens[0]:] == 0).all() and (g[1] == 0).all()


def test_flash_train_autograd_finite_difference(cuda):
    """f32 caller: q/k/v enter the kernels in bf16, the gradients come back
    in f32; each directional derivative of sum(o·g) against central
    differences of an f64 einsum softmax attention."""
    B, Lq, Lk, N, D = 1, 96, 80, 2, 128
    gen = torch.Generator(cuda).manual_seed(7)
    q, k, v, g = (torch.randn(B, L, N, D, generator=gen, device=cuda)
                  for L in (Lq, Lk, Lk, Lq))
    lens = torch.tensor([61], device=cuda)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_train(*ts, lens)
    assert out.dtype == torch.float32
    out.backward(g)
    for i, t in enumerate(ts):
        assert t.grad.dtype == torch.float32
        direction = torch.randn(t.shape, generator=gen, device=cuda)

        def f(eps):
            args = [x.double() for x in (q, k, v)]
            args[i] = args[i] + eps * direction.double()
            s_ = torch.einsum("bind,bjnd->bnij", args[0], args[1]) * D**-0.5
            s_ = s_.masked_fill(torch.arange(Lk, device=cuda) >= lens[:, None, None, None], -1e30)
            o_ = torch.einsum("bnij,bjnd->bind", s_.softmax(-1), args[2])
            return float((o_ * g.double()).sum())

        fd = (f(1e-3) - f(-1e-3)) / 2e-3
        an = float((t.grad.double() * direction.double()).sum())
        assert abs(an - fd) <= 2e-2 * abs(fd), ("qkv"[i], an, fd)


def test_flash_train_kernels_reject_other_head_dims(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64"):
        flash_fwd_lse(q, q, q)
    with pytest.raises(ValueError, match="head_dim 64"):
        flash_bwd(q, q, q, q, torch.zeros(1, 2, 8, device=cuda), torch.zeros(1, 2, 8, device=cuda))


def test_inference_kernels_refuse_grad(cuda):
    """The inference flash kernel and qk_prep have no backward: with grad
    mode on they raise for an input that requires grad."""
    q = torch.zeros(1, 8, 2, 128, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 8, 256, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        qk_prep(x, torch.ones(256, device=cuda), None, None, 2)
    with torch.no_grad():
        assert flash_attention(q, q, q).grad_fn is None


@pytest.mark.parametrize("d,out", [(5120, "bfloat16"), (1536, "float32"), (256, "bfloat16")])
@pytest.mark.parametrize("subset", [(0, 0, 0, 1), (1, 1, 1, 0), (1, 0, 0, 1), (0, 0, 0, 0),
                                    (1, 1, 1, 1)])
def test_fused_adaln_kernel_matches_plain(cuda, d, out, subset):
    """Every sandwich of the DiT (mod only, gated residual + norm3 affine,
    residual + mod, the head's f32-out mod) and the bare and full subsets,
    over 37 rows per batch row (ragged against any row tiling)."""
    r, g, a, m = subset
    B, L = 2, 37
    gen = torch.Generator(device=cuda).manual_seed(d + sum(subset))
    f = lambda *shape: torch.randn(*shape, generator=gen, device=cuda)  # noqa: E731
    odt = getattr(torch, out)
    args = (2.0 + 3.0 * f(B, L, d), f(B, L, d).to(odt) if r else None, f(B, d) if g else None,
            1.0 + 0.1 * f(d) if a else None, 0.1 * f(d) if a else None,
            f(B, d) if m else None, f(B, d) if m else None)
    n0 = fused_adaln.launches
    x_new, y = fused_adaln(*args, eps=1e-6, out_dtype=odt)
    assert fused_adaln.launches == n0 + 1 and y.dtype == odt
    x_ref, y_ref = fused_adaln_plain(*args, eps=1e-6, out_dtype=odt)
    if r:
        assert torch.equal(x_new, x_ref)
    else:
        assert x_new is None
    row_max = y_ref.float().abs().amax(-1, keepdim=True)
    err = (y.float() - y_ref.float()).abs()
    limit = _bf16_ulp(row_max) if out == "bfloat16" else 1e-5 * row_max
    assert bool((err <= limit).all()), float((err / limit).max())


def test_fused_adaln_kernel_backward_and_rejects(cuda):
    """Under autograd the kernel runs forward and the plain formula's VJP
    backward; shapes the kernel does not take raise."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 16, 256, generator=gen, device=cuda, requires_grad=True)
    ms = torch.randn(2, 256, generator=gen, device=cuda, requires_grad=True)
    mb = torch.randn(2, 256, generator=gen, device=cuda)
    n0 = fused_adaln.launches
    _, y = fused_adaln(x, mod_scale=ms, mod_shift=mb, out_dtype=torch.float32)
    assert fused_adaln.launches == n0 + 1
    y.square().sum().backward()
    xr, msr = x.detach().clone().requires_grad_(), ms.detach().clone().requires_grad_()
    _, yr = fused_adaln_plain(xr, mod_scale=msr, mod_shift=mb, out_dtype=torch.float32)
    yr.square().sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ms.grad, msr.grad, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        fused_adaln(torch.zeros(1, 4, 200, device=cuda))  # d % 128
    with pytest.raises(ValueError):
        fused_adaln(torch.zeros(1, 4, 256, device=cuda).bfloat16())  # x must be f32
