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
ring_step: the finished output within 4 bf16 ulps of each row's max, as
flash; the carried m within 1e-4 (log2 units) and l within 1e-4 relative of
the plain twin's (f32 sums in another order). Where K/V rows past kv_len
(or a ring step's step_lens) hold NaN, the forward kernels' outputs are
finite and held to the plain twin on the same inputs with those rows zeroed.
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
from omnivideo_tpu_torch.ops.ring_attention import (
    ring_carry,
    ring_finish,
    ring_flash_attention_shards,
    ring_step,
    ring_step_plain,
    stripe_order,
    zigzag_order,
)
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


@pytest.mark.parametrize("B,L,N,lens,bounded,nan_tail", [
    (2, 300, 8, None, False, False),
    (2, 1000, 8, None, False, False),
    (2, 700, 8, [433, 0], False, False),
    (1, 1481, 32, None, False, False),        # the Qwen3-VL prefill's shape
    (2, 1481, 8, [1481, 700], False, False),  # kv_len below L
    (2, 1481, 8, [433, 0], False, False),     # and a fully masked batch row
    (2, 1481, 8, [1481, 700], True, False),   # bounded (assume_normalized)
    (2, 1481, 8, [1481, 700], False, True),   # NaN in K and V past kv_len
    (1, 4096, 8, None, False, False),
])
def test_flash_causal_kernel_matches_plain(cuda, B, L, N, lens, bounded, nan_tail):
    """Causal prefill at head dim 128 on the Hopper mainloop: ragged diagonal
    tiles (L % 128 ≠ 0), kv_lens below L with a fully masked batch row, the
    max-tracked softmax the text prefill runs and the bounded one, NaN in the
    K/V rows past kv_len (finite output, equal to the plain twin's on the
    same rows zeroed)."""
    D = 128
    q, k, v = _qkv(B, L, L, N, D, L, 1.0, cuda)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    mb = safe = None
    if bounded:
        mb, safe = softmax_bound(q, k, D**-0.5)
        assert bool(safe)
    kk, vv = (_nan_past(k, lens), _nan_past(v, lens)) if nan_tail else (k, v)
    n0 = dict(flash_attention.launches)
    out = flash_attention(q, kk, vv, kv_lens=kv, assume_normalized=bounded, causal=True)
    assert flash_attention.launches["flash_causal"] == n0["flash_causal"] + 1
    assert flash_attention.launches["flash_fwd"] == n0["flash_fwd"]
    assert torch.isfinite(out).all()
    _assert_flash_close(out, flash_attention_plain(q, k, v, kv, None, mb, safe, causal=True))
    if lens is not None and 0 in lens:
        assert (out[lens.index(0)] == 0).all()


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


INFER_EDGE_CASES = [
    (2, 1000, 1000, None),      # Lq, Lk not multiples of 64
    (2, 130, 40, None),         # Lk under one 64-key half tile
    (1, 40, 300, None),         # Lq under one warpgroup's 64 rows
    (2, 1050, 700, None),       # Lq % 128 = 26: the last block's second warpgroup has no rows
    (2, 200, 200, None),        # a 128-key tile whose second half is ragged
    (3, 260, 400, [150, 0, 65]),  # kv_len inside a first half, none, one key past a half
]


@pytest.mark.parametrize("D", [128, 72])
@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("B,Lq,Lk,lens", INFER_EDGE_CASES)
def test_flash_infer_kernel_edge_tilings(cuda, D, scale, B, Lq, Lk, lens):
    """Rows 1 (D = 128) and 3a (D = 72) on the Hopper mainloop, bounded
    (scale 1) and max-tracked (scale 4: the guard fails), at tilings the
    main paths do not reach: every output row within 4 bf16 ulps of the
    plain twin's, and a batch row without keys all zeros."""
    N = 3
    q, k, v = _qkv(B, Lq, Lk, N, D, Lq + Lk + D, scale, cuda)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    mb, safe = softmax_bound(q, k, D**-0.5)
    assert bool(safe) == (scale == 1.0)
    name = "flash_fwd" if D == 128 else "flash_d72"
    n0 = flash_attention.launches[name]
    out = flash_attention(q, k, v, kv_lens=kv, assume_normalized=True)
    assert flash_attention.launches[name] == n0 + 1
    _assert_flash_close(out, flash_attention_plain(q, k, v, kv, None, mb, safe))
    for b, n in enumerate(lens or []):
        if n == 0:
            assert (out[b] == 0).all()


@pytest.mark.parametrize("D", [128, 72])
@pytest.mark.parametrize("bounded", [True, False])
def test_flash_infer_kernel_ignores_rows_past_kv_len(cuda, D, bounded):
    """K and V rows past kv_len hold NaN: the output is finite and equals
    the plain twin's (a masked key adds exactly 0, not 0·NaN). The bound
    comes from the rows before kv_len, as qk_prep's row norms give it."""
    B, Lq, Lk, N, lens = 3, 300, 700, 2, [433, 0, 700 - 64 - 3]
    q, k, v = _qkv(B, Lq, Lk, N, D, 37 + D, 1.0, cuda)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    norms = tuple(t.float().square().sum(-1).amax(dim=1).sqrt() for t in (q, k))
    mb, safe = softmax_bound(q, k, D**-0.5, norms)
    assert bool(safe)
    kn, vn = _nan_past(k, lens), _nan_past(v, lens)
    if bounded:
        out = flash_attention(q, kn, vn, kv_lens=kv, assume_normalized=True, qk_row_norms=norms)
        ref = flash_attention_plain(q, kn, vn, kv, None, mb, safe)
    else:
        out = flash_attention(q, kn, vn, kv_lens=kv)
        ref = flash_attention_plain(q, kn, vn, kv)
    assert torch.isfinite(out).all() and torch.isfinite(ref).all()
    _assert_flash_close(out, ref)
    assert (out[1] == 0).all()


def test_flash_infer_kernel_40_heads(cuda):
    """Row 1 at T2V-A14B's 40 heads: the tensor maps take their strides
    from N; bounded self-attention and its max-tracked twin."""
    B, L, N, D = 2, 777, 40, 128
    q, k, v = _qkv(B, L, L, N, D, 40, 1.0, cuda)
    mb, safe = softmax_bound(q, k, D**-0.5)
    ref = flash_attention_plain(q, k, v, None, None, mb, safe)
    _assert_flash_close(flash_attention(q, k, v, assume_normalized=True), ref)
    _assert_flash_close(flash_attention(q, k, v), ref)


@pytest.mark.parametrize("D", [128, 72])
def test_flash_infer_kernel_deterministic(cuda, D):
    """Each output row is written by one warpgroup, with no atomics: two
    launches give the same bits, in both softmax modes."""
    q, k, v = _qkv(2, 700, 900, 4, D, 19, 1.0, cuda)
    kv = torch.tensor([900, 333], dtype=torch.int32, device=cuda)
    for normalized in (True, False):
        o1 = flash_attention(q, k, v, kv_lens=kv, assume_normalized=normalized)
        o2 = flash_attention(q, k, v, kv_lens=kv, assume_normalized=normalized)
        assert torch.equal(o1, o2)


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
    (1, 40, 50, None),          # Lq and Lk under one 64-row tile
    (1, 300, 50, None),         # Lk under one tile, several q tiles
    (2, 200, 200, None),        # a 128-row KV block whose second half is ragged
    (1, 260, 400, [150]),       # kv_len ends inside the first half of a 128-row block
    (2, 1000, 260, [0, 200]),   # the first batch row without keys
    (2, 1050, 700, None),       # Lq % 128 = 26: the last block's second warpgroup has no rows
    (1, 6272, 6272, [6000]),    # several pipelined KV tiles, kv_len inside the last one
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
        for b in range(B):
            if lens[b] == 0:
                assert (o[b] == 0).all() and (grads[0][b] == 0).all()
            for g in grads[1:]:
                assert (g[b, lens[b]:] == 0).all()


def _train_operands(B, Lq, Lk, N, lens, device):
    q, k, v = _qkv(B, Lq, Lk, N, 128, Lq + 3 * Lk + N, 1.0, device)
    do = torch.randn(B, Lq, N, 128, generator=torch.Generator(device).manual_seed(Lq + N),
                     device=device).bfloat16()
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=device)
    _, lse = flash_fwd_lse_plain(q, k, v, kv)
    delta = flash_delta(do, flash_fwd_lse_plain(q, k, v, kv)[0])
    return q, k, v, do, lse, delta, kv


def _nan_past(t, lens):
    """A copy of [B, L, ...] `t` with the rows past lens[b] set to NaN."""
    t = t.clone()
    for b, n in enumerate(lens):
        t[b, n:] = float("nan")
    return t


def test_flash_fwd_lse_kernel_ignores_rows_past_kv_len(cuda):
    """K and V rows past kv_len hold NaN: the kernel's o and LSE are finite
    and equal the plain twin's on the same inputs with those rows zeroed (a
    masked key adds exactly 0, not 0·NaN)."""
    B, Lq, Lk, N, lens = 3, 300, 700, 2, [433, 64, 700]
    q, k, v = _qkv(B, Lq, Lk, N, 128, 31, 1.0, cuda)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    o, lse = flash_fwd_lse(q, _nan_past(k, lens), _nan_past(v, lens), kv)
    op, lsep = flash_fwd_lse_plain(q, _nan_past(k, lens).nan_to_num(0.0),
                                   _nan_past(v, lens).nan_to_num(0.0), kv)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _assert_flash_close(o, op)
    torch.testing.assert_close(lse, lsep, rtol=0, atol=1e-4)


@pytest.mark.parametrize("N", [3, 1])
def test_flash_fwd_lse_kernel_other_head_counts(cuda, N):
    """The forward's tensor maps take their strides from N, as the
    backward's do."""
    B, Lq, Lk, lens = 2, 330, 470, [470, 129]
    q, k, v = _qkv(B, Lq, Lk, N, 128, 40 + N, 1.0, cuda)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    o, lse = flash_fwd_lse(q, k, v, kv)
    op, lsep = flash_fwd_lse_plain(q, k, v, kv)
    _assert_flash_close(o, op)
    torch.testing.assert_close(lse, lsep, rtol=0, atol=1e-4)


def test_flash_fwd_lse_kernel_deterministic(cuda):
    """Each output row is written by one warpgroup, with no atomics: two
    launches give the same bits."""
    q, k, v = _qkv(2, 700, 900, 4, 128, 17, 1.0, cuda)
    kv = torch.tensor([900, 333], dtype=torch.int32, device=cuda)
    o1, lse1 = flash_fwd_lse(q, k, v, kv)
    o2, lse2 = flash_fwd_lse(q, k, v, kv)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_flash_bwd_kernels_deterministic(cuda):
    """Each output element is written by one block, with no atomics: two
    launches give the same bits."""
    args = _train_operands(2, 700, 900, 4, [900, 333], cuda)
    first = flash_bwd(*args)
    second = flash_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [3, 1])
def test_flash_bwd_kernels_other_head_counts(cuda, N):
    """N heads of 128 make a row stride of N·256 bytes: the tensor maps take
    their strides from N (3 heads: 768 bytes, not the 3,072 of 12 heads)."""
    B, Lq, Lk, lens = 2, 330, 470, [470, 129]
    q, k, v, do, lse, delta, kv = _train_operands(B, Lq, Lk, N, lens, cuda)
    grads = flash_bwd(q, k, v, do, lse, delta, kv)
    ref = flash_bwd_plain(q, k, v, do, lse, delta, kv)
    for g, r in zip(grads, ref):
        worst = float(_grad_rel(g, r).max())
        assert worst < 1e-2, (N, worst)
    for g in grads[1:]:
        assert (g[1, lens[1]:] == 0).all()


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


RING_CASES = [  # (causal, shard length, kv_lens)
    (None, 200, None),          # ragged tiles
    (None, 200, [730, 0]),      # last shard ends in pad keys; a batch row with none
    (None, 256, [520, 1024]),   # shards 2 and 3 all padding for batch row 0
    ("block", 200, None),
    ("token", 200, None),
    ("stripe", 200, None),
    ("zigzag", 256, None),
    (None, 150, None),          # Lq % 128 = 22: the last block's second warpgroup has no rows
    ("zigzag", 384, None),      # zz = 192, zz % 128 = 64: a block straddles the chunk boundary
    ("zigzag", 128, None),      # zz = 64: every block straddles it
    ("token", 320, None),       # the two halves of a block meet the diagonal in different tiles
    ("stripe", 320, None),      # as token, shifted by one for src > my
    ("block", 256, [900, 1024]),   # a causal mode with padded keys
]


def _ring_layout(q, k, v, causal, n, Ls, device):
    """n shards of q/k/v in the token order of the causal layout."""
    order = {"zigzag": zigzag_order, "stripe": stripe_order}.get(causal)
    if order is not None:
        idx = order(n * Ls, n).to(device)
        q, k, v = (t[:, idx].contiguous() for t in (q, k, v))
    return [[s_.contiguous() for s_ in t.chunk(n, 1)] for t in (q, k, v)]


@pytest.mark.parametrize("causal,Ls,lens", RING_CASES)
def test_ring_step_kernel_matches_plain(cuda, causal, Ls, lens):
    """Four in-process shards: every step after the first meets a carry
    that is not empty; the layouts of the causal modes as their callers
    make them."""
    n, B, N, D = 4, 2, 2, 128
    q, k, v = _qkv(B, n * Ls, n * Ls, N, D, Ls, 1.0, cuda)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    shards = _ring_layout(q, k, v, causal, n, Ls, cuda)
    n0 = ring_step.launches
    outs = ring_flash_attention_shards(*shards, kv_lens=kv, causal=causal, return_lse=True)
    assert ring_step.launches - n0 == n * n
    refs = ring_flash_attention_shards(*shards, kv_lens=kv, causal=causal, return_lse=True,
                                       step=ring_step_plain)
    for (o, lse), (o_p, lse_p) in zip(outs, refs):
        _assert_flash_close(o, o_p)
        seen = lse_p > -1e29
        torch.testing.assert_close(lse[seen], lse_p[seen], rtol=0, atol=1e-4)
    if lens is not None and 0 in lens:
        assert all((o[lens.index(0)] == 0).all() for o, _ in outs)


def test_ring_step_kernel_ignores_keys_past_step_lens(cuda):
    """K and V tokens past kv_len hold NaN (the padded tail of the last
    shards): the outputs are finite and equal the plain twin's on the same
    inputs with those tokens zeroed."""
    n, B, N, Ls, lens = 4, 2, 2, 200, [730, 333]
    q, k, v = _qkv(B, n * Ls, n * Ls, N, 128, 23, 1.0, cuda)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kn, vn = _nan_past(k, lens), _nan_past(v, lens)
    shards = _ring_layout(q, kn, vn, None, n, Ls, cuda)
    zeroed = _ring_layout(q, kn.nan_to_num(0.0), vn.nan_to_num(0.0), None, n, Ls, cuda)
    outs = ring_flash_attention_shards(*shards, kv_lens=kv)
    refs = ring_flash_attention_shards(*zeroed, kv_lens=kv, step=ring_step_plain)
    for o, o_p in zip(outs, refs):
        assert torch.isfinite(o).all()
        _assert_flash_close(o, o_p)


@pytest.mark.parametrize("N,causal", [(3, None), (1, "token"), (3, "zigzag")])
def test_ring_step_kernel_other_head_counts(cuda, N, causal):
    """N = 1 and 3 heads pin the tensor maps' strides."""
    n, B, Ls = 4, 2, 256
    q, k, v = _qkv(B, n * Ls, n * Ls, N, 128, 50 + N, 1.0, cuda)
    shards = _ring_layout(q, k, v, causal, n, Ls, cuda)
    outs = ring_flash_attention_shards(*shards, causal=causal)
    refs = ring_flash_attention_shards(*shards, causal=causal, step=ring_step_plain)
    for o, o_p in zip(outs, refs):
        _assert_flash_close(o, o_p)


def test_ring_step_kernel_deterministic(cuda):
    """Two launches on the same carry give the same bits."""
    B, L, N, D = 2, 300, 2, 128
    q, k, v = _qkv(B, L, L, N, D, 13, 1.0, cuda)
    lens = torch.tensor([300, 170], dtype=torch.int32, device=cuda)
    start = ring_step_plain(q, k, v, *ring_carry(B, L, N, D, cuda))
    runs = []
    for _ in range(2):
        carry = [t.clone() for t in start]
        ring_step(q, k, v, *carry, step_lens=lens, causal="stripe", my=2, src=1, n=4)
        runs.append(carry)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_ring_step_kernel_carry_in_place(cuda):
    """One step on a carry that arrives non-empty: m, l and acc updated in
    place, as the plain twin returns them."""
    B, L, N, D = 1, 300, 2, 128
    q, k, v = _qkv(B, L, L, N, D, 11, 1.0, cuda)
    k2, v2 = list(_qkv(B, L, L, N, D, 12, 1.0, cuda))[1:]
    carry = ring_step_plain(q, k, v, *ring_carry(B, L, N, D, cuda))
    m, l, acc = (t.clone() for t in carry)
    out = ring_step(q, k2, v2, m, l, acc, causal="stripe", my=1, src=2, n=4)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(out, (m, l, acc)))
    m_p, l_p, acc_p = ring_step_plain(q, k2, v2, *carry, causal="stripe", my=1, src=2, n=4)
    torch.testing.assert_close(m, m_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=0)
    _assert_flash_close(ring_finish(m, l, acc, torch.bfloat16),
                        ring_finish(m_p, l_p, acc_p, torch.bfloat16))


def test_ring_step_kernel_refuses_grad_and_bad_operands(cuda):
    B, L, N, D = 1, 64, 2, 128
    carry = ring_carry(B, L, N, D, cuda)
    q = torch.zeros(B, L, N, D, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ring_step(q, q, q, *carry)
    with torch.no_grad():
        with pytest.raises(ValueError, match="head_dim 64"):
            x = torch.zeros(B, L, N, 64, device=cuda, dtype=torch.bfloat16)
            ring_step(x, x, x, *ring_carry(B, L, N, 64, cuda))
        with pytest.raises(ValueError, match="bf16"):
            ring_step(q.float(), q.float(), q.float(), *carry)
        with pytest.raises(ValueError, match="zigzag"):
            x = torch.zeros(B, 96, N, D, device=cuda, dtype=torch.bfloat16)
            ring_step(x, x, x, *ring_carry(B, 96, N, D, cuda), causal="zigzag", n=2)
