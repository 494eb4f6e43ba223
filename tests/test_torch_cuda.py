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
maximum, and an error confined to later KV tiles shows); the pair kernel
(the i2v cross-attention over text and image keys, summed) the same against
its plain twin, and three reruns bit-equal. qk_prep outputs
≤ 4 bf16 ulps of each RoPE pair's magnitude and < 0.1% of elements differing
at all (the f32 rs differs in its last bits with the summation order, which
can flip the bf16 roundings before the rotation); its row-norm bound 1e-4
relative. The training kernels: o as above, the natural-log LSE within
1e-4 absolute (f32 sums in another order), dq/dk/dv within 1e-2 of their
own norm per (batch row, head) (p and ds are rounded to bf16 before their
products in both versions, at values that differ in the last f32 bits), and
the autograd function's directional derivatives within 2e-2 of central
finite differences of an f64 einsum attention (the kernels' bf16 operands).
The backward kernels on f32 operands (rows 4 and 5 in f32): dq/dk/dv within
1e-5 of their norm per (batch row, head) of the plain twin's on the same
inputs with TF32 off (f32-accurate products, tests/test_torch_flash_bwd_f32_
split.py, summed in other orders), and the f32 ring backward within 1e-4
of the dense f32 causal backward (its forward's LSE comes from the f32 step
kernel).
fused_adaln: x_new bit for bit (the kernel rounds each product and sum as
PyTorch does), y within 1 bf16 ulp of each row's max |y_plain| (bf16 out) or
1e-5 of it (f32 out): the row mean and variance sum in another order.
The registered `omnivideo::` ops (the calls a torch.export program holds)
are held to the plain twins by the same rules, and an exported DiT's
program to the eager forward bit for bit, with the same launches.
ring_step: the finished output within 4 bf16 ulps of each row's max, as
flash (the f32 step kernel: 1e-5 of it, and the LSE within 1e-5); the carried m within 1e-4 (log2 units) and l within 1e-4 relative of
the plain twin's (f32 sums in another order); the ring backward's dq/dk/dv
as the training kernels'. Where K/V rows past kv_len
(or a ring step's step_lens) hold NaN, the forward kernels' outputs are
finite and held to the plain twin on the same inputs with those rows zeroed.
gmm and tgmm (the MoE's grouped products): bf16 within 4 bf16 ulps of each
output row's (tgmm: each group's block's) max |plain|, f32 within 1e-5 of
it (f32 products summed in another order; the bf16 tensor cores add their
products in an order of their own before the f32 accumulator); rows past
the group sum exactly zero; the inference MoE runs with no host sync.
"""

import numpy as np
import pytest
import torch

from omnivideo_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_pair,
    flash_attention_pair_plain,
    flash_attention_plain,
    flash_attention_train,
    flash_bwd,
    flash_bwd_plain,
    flash_delta,
    flash_fwd_lse,
    flash_fwd_lse_plain,
    pair_bound,
    softmax_bound,
)
from omnivideo_tpu_torch.ops.fused_adaln import fused_adaln, fused_adaln_plain
from omnivideo_tpu_torch.ops.gmm import (
    GroupedMatmul,
    gmm,
    gmm_plain,
    gmm_schedule,
    resident_clusters,
    tgmm,
    tgmm_plain,
)
from omnivideo_tpu_torch.ops.qk_prep import qk_prep, qk_prep_plain
from omnivideo_tpu_torch.ops.ring_attention import (
    ring_carry,
    ring_finish,
    ring_flash_attention_shards,
    ring_flash_backward_shards,
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


def _pair_inputs(Lq, Lt, Li, N, seed, device, scales=(1.0, 1.0)):
    """q, k_txt, v_txt, k_img, v_img in bf16: q and the keys RMS 1 (the keys
    of context c at RMS scales[c]), normal v."""
    rng = np.random.default_rng(seed)

    def normed(L, scale=1.0):
        t = rng.standard_normal((2, L, N, 128)).astype(np.float32)
        return t / np.sqrt((t**2).mean(-1, keepdims=True)) * scale

    arrs = (normed(Lq), normed(Lt, scales[0]), rng.standard_normal((2, Lt, N, 128)),
            normed(Li, scales[1]), rng.standard_normal((2, Li, N, 128)))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device).bfloat16() for a in arrs)


PAIR_CASES = [  # (Lq, Lt, Li, N): every tiling of a context's keys the kernel has
    (1, 1, 1, 2),          # one q row, a narrow tile alone in each context
    (63, 128, 64, 2),      # one full tile each, the image tile masked past 64
    (200, 512, 257, 2),    # I2V-14B's key counts: a 1-key narrow tail
    (200, 513, 65, 40),    # a narrow text tail; the image's one tile masked past 65
    (8190, 512, 257, 40),  # a quarter of I2V-14B's q rows at its heads
    (63, 1, 129, 40),      # a full image tile and a 1-key tail
    (200, 128, 63, 2),
]


@pytest.mark.parametrize("Lq,Lt,Li,N", PAIR_CASES)
def test_flash_pair_kernel_matches_plain(cuda, Lq, Lt, Li, N):
    """The i2v split cross-attention in one launch (csrc/flash_pair.cu)
    against its plain twin (two row-1 plain calls and the bf16 sum): every
    output row within 4 bf16 ulps of its max; one launch, no row-1 launch."""
    q, kt, vt, ki, vi = _pair_inputs(Lq, Lt, Li, N, Lq + Lt + Li + N, cuda)
    mb, safe = pair_bound(q, kt, ki, 128**-0.5)
    assert safe.tolist() == [1, 1]
    n0 = dict(flash_attention.launches)
    out = flash_attention_pair(q, kt, vt, ki, vi)
    assert flash_attention.launches["flash_pair"] == n0["flash_pair"] + 1
    assert flash_attention.launches["flash_fwd"] == n0["flash_fwd"]
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    _assert_flash_close(out, flash_attention_pair_plain(q, kt, vt, ki, vi, None, mb, safe))


@pytest.mark.parametrize("flip", [0, 1])
def test_flash_pair_kernel_one_guard_flipped(cuda, flip):
    """One context's keys at RMS 4: its guard fails and it runs max-tracked
    while the other stays bounded."""
    scales = (4.0, 1.0) if flip == 0 else (1.0, 4.0)
    q, kt, vt, ki, vi = _pair_inputs(700, 512, 257, 8, 17 + flip, cuda, scales)
    mb, safe = pair_bound(q, kt, ki, 128**-0.5)
    assert safe.tolist() == [int(flip == 1), int(flip == 0)]
    out = flash_attention_pair(q, kt, vt, ki, vi)
    _assert_flash_close(out, flash_attention_pair_plain(q, kt, vt, ki, vi, None, mb, safe))


def test_flash_pair_kernel_reruns_bit_equal(cuda):
    """Three reruns give the same bits (a stage or staging race would not)."""
    q, kt, vt, ki, vi = _pair_inputs(8190, 512, 257, 40, 5, cuda)
    outs = [flash_attention_pair(q, kt, vt, ki, vi) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_flash_pair_kernel_refuses(cuda):
    """Raises under grad, on f32 operands and at head dim 64: no fallback."""
    q, kt, vt, ki, vi = _pair_inputs(64, 16, 16, 2, 1, cuda)
    with pytest.raises(RuntimeError, match="grad"):
        flash_attention_pair(q.requires_grad_(), kt, vt, ki, vi)
    q = q.detach()
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_pair(q.float(), kt.float(), vt.float(), ki.float(), vi.float())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_pair(*(t[..., :64].contiguous() for t in (q, kt, vt, ki, vi)))


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


@pytest.mark.parametrize("Lk", [257, 512])
def test_flash_infer_kernel_i2v_cross_attention(cuda, Lk):
    """Row 1 at the i2v split cross-attention's key counts, bounded, no
    kv_lens: the 257 CLIP tokens (4 key tiles of 64 and a 1-key tail) and
    the 512 text tokens, 40 heads; the max-tracked twin too."""
    B, Lq, N, D = 2, 3000, 40, 128
    q, k, v = _qkv(B, Lq, Lk, N, D, Lk, 1.0, cuda)
    mb, safe = softmax_bound(q, k, D**-0.5)
    assert bool(safe)
    ref = flash_attention_plain(q, k, v, None, None, mb, safe)
    _assert_flash_close(flash_attention(q, k, v, assume_normalized=True), ref)
    _assert_flash_close(flash_attention(q, k, v), ref)


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
        "flash_fwd_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_bwd_dq_f32": 0,
        "flash_bwd_dkv_f32": 0}
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


@pytest.mark.parametrize("causal,Ls,lens", RING_CASES)
def test_ring_step_f32_kernel_matches_plain(cuda, causal, Ls, lens):
    """The f32 step kernel (f32 q/k/v) over the same four shards: the output
    within 1e-5 of each row's max |plain| and the LSE within 1e-5 (f32
    products on both sides, summed in other orders)."""
    n, B, N, D = 4, 2, 2, 128
    q, k, v = (t.float() for t in _qkv(B, n * Ls, n * Ls, N, D, Ls, 1.0, cuda))
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    shards = _ring_layout(q, k, v, causal, n, Ls, cuda)
    n0, b0 = ring_step.launches_f32, ring_step.launches
    outs = ring_flash_attention_shards(*shards, kv_lens=kv, causal=causal, return_lse=True)
    assert (ring_step.launches_f32 - n0, ring_step.launches - b0) == (n * n, 0)
    refs = ring_flash_attention_shards(*shards, kv_lens=kv, causal=causal, return_lse=True,
                                       step=ring_step_plain)
    for (o, lse), (o_p, lse_p) in zip(outs, refs):
        scale = o_p.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        assert float(((o - o_p).abs() / scale).max()) <= 1e-5
        seen = lse_p > -1e29
        torch.testing.assert_close(lse[seen], lse_p[seen], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_step_kernel_ignores_keys_past_step_lens(cuda, dtype):
    """K and V tokens past kv_len hold NaN (the padded tail of the last
    shards): the outputs are finite and equal the plain twin's on the same
    inputs with those tokens zeroed (bf16 operands: row 8; f32: the f32 step
    kernel, held as in test_ring_step_f32_kernel_matches_plain)."""
    n, B, N, Ls, lens = 4, 2, 2, 200, [730, 333]
    q, k, v = (t.to(dtype) for t in _qkv(B, n * Ls, n * Ls, N, 128, 23, 1.0, cuda))
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kn, vn = _nan_past(k, lens), _nan_past(v, lens)
    shards = _ring_layout(q, kn, vn, None, n, Ls, cuda)
    zeroed = _ring_layout(q, kn.nan_to_num(0.0), vn.nan_to_num(0.0), None, n, Ls, cuda)
    outs = ring_flash_attention_shards(*shards, kv_lens=kv)
    refs = ring_flash_attention_shards(*zeroed, kv_lens=kv, step=ring_step_plain)
    for o, o_p in zip(outs, refs):
        assert torch.isfinite(o).all()
        if dtype == torch.bfloat16:
            _assert_flash_close(o, o_p)
        else:
            scale = o_p.abs().amax(-1, keepdim=True).clamp_min(1e-30)
            assert float(((o - o_p).abs() / scale).max()) <= 1e-5


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
        with pytest.raises(ValueError, match="all bf16 or all f32"):  # f32 has its own kernel
            ring_step(q.half(), q.half(), q.half(), *carry)
        with pytest.raises(ValueError, match="all bf16 or all f32"):
            ring_step(q.float(), q.detach(), q.detach(), *carry)
        with pytest.raises(ValueError, match="zigzag"):
            x = torch.zeros(B, 96, N, D, device=cuda, dtype=torch.bfloat16)
            ring_step(x, x, x, *ring_carry(B, 96, N, D, cuda), causal="zigzag", n=2)


RING_BWD_CASES = [  # (causal, shard length, kv_lens)
    (None, 200, None),
    (None, 200, [730, 0]),     # the last shard ends in pad keys; a batch row with none
    (None, 256, [520, 1024]),  # shards 2 and 3 all padding for batch row 0: step_lens 0
    ("block", 200, None),
    ("token", 200, None),
]


@pytest.mark.parametrize("causal,Ls,lens", RING_BWD_CASES)
def test_ring_backward_kernels_match_plain(cuda, causal, Ls, lens):
    """The ring backward over four in-process shards (rows 4 and 5 per
    visible step, the token mode's own-shard step in plain torch) against
    the same loop with flash_bwd_plain, from the ring forward's outputs
    and global LSEs; a padded query row gets no gradient."""
    n, B, N, D = 4, 2, 2, 128
    q, k, v = _qkv(B, n * Ls, n * Ls, N, D, Ls + 1, 1.0, cuda)
    do = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(Ls))
    do = do.bfloat16()
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    qs, ks, vs, dos = ([s_.contiguous() for s_ in t.chunk(n, 1)] for t in (q, k, v, do))
    fwd = ring_flash_attention_shards(qs, ks, vs, kv_lens=kv, causal=causal, return_lse=True)
    outs, lses = [f[0] for f in fwd], [f[1] for f in fwd]
    n0 = dict(flash_attention_train.launches)
    got = ring_flash_backward_shards(qs, ks, vs, outs, lses, dos, kv, causal)
    steps = {None: n * n, "block": n * (n + 1) // 2, "token": n * (n - 1) // 2}[causal]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert flash_attention_train.launches[name] - n0[name] == steps
    ref = ring_flash_backward_shards(qs, ks, vs, outs, lses, dos, kv, causal,
                                     bwd=flash_bwd_plain)
    for i in range(3):
        g, r = (torch.cat([x[i] for x in t], 1) for t in (got, ref))
        assert torch.isfinite(g).all()
        live = [b for b in range(B) if r[b].abs().max() > 0]
        assert float(_grad_rel(g[live], r[live]).max()) < 1e-2
        for b in set(range(B)) - set(live):
            assert (g[b] == 0).all()
    if lens is not None:  # padded query rows: no dq
        dq = torch.cat([x[0] for x in got], 1)
        for b, n_b in enumerate(lens):
            assert (dq[b, n_b:] == 0).all()


BWD_F32_TOL = 1e-5  # of each gradient's norm per (batch row, head)
BWD_F32_CASES = [  # (B, Lq, Lk, N, kv_lens)
    (2, 512, 512, 32, None),      # the 4-card SFT --sp step's earlier shards, every key visible
    (2, 300, 700, 12, [433, 0]),  # kv_lens, an all-padding batch row
    (1, 1000, 260, 40, [150]),    # 40 heads; kv_len inside the first 64-row block
    (2, 45, 37, 12, None),        # Lq and Lk under one tile
    (1, 200, 24, 12, None),       # one streamed key tile of 24: dq's first tile is its last
    (1, 130, 300, 32, None),      # 2 live rows in the last stationary block: dq's swap on padding
]


@pytest.fixture
def no_tf32():
    """The plain twins' f32 products in full f32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _f32_train_operands(B, Lq, Lk, N, lens, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    q, do = (torch.randn(B, Lq, N, 128, generator=gen, device=device) for _ in range(2))
    k, v = (torch.randn(B, Lk, N, 128, generator=gen, device=device) for _ in range(2))
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=device)
    o, lse = flash_fwd_lse_plain(q, k, v, kv)
    return q, k, v, do, lse, flash_delta(do, o), kv


@pytest.mark.parametrize("B,Lq,Lk,N,lens", BWD_F32_CASES)
def test_flash_bwd_f32_kernels_match_plain(cuda, no_tf32, B, Lq, Lk, N, lens):
    """f32 q/k/v/dO launch the f32 kernels, never the bf16 ones; their dq,
    dk and dv hold the plain twin's f32 gradients, zero rows past kv_len and
    for a batch row without keys, and a rerun gives the same bits."""
    args = _f32_train_operands(B, Lq, Lk, N, lens, cuda, Lq + Lk + N)
    n0 = dict(flash_attention_train.launches)
    grads = flash_bwd(*args)
    assert {k_: flash_attention_train.launches[k_] - n0[k_] for k_ in n0} == {
        "flash_fwd_lse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_dq_f32": 1,
        "flash_bwd_dkv_f32": 1}
    ref = flash_bwd_plain(*args)
    live = [b for b in range(B) if lens is None or lens[b] > 0]
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        worst = float(_grad_rel(g[live], r[live]).max())
        assert worst <= BWD_F32_TOL, (name, worst)
    for b in range(B):
        if lens is not None:
            if lens[b] == 0:
                assert (grads[0][b] == 0).all()
            for g in grads[1:]:
                assert (g[b, lens[b]:] == 0).all()
    again = flash_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_flash_bwd_refuses_mixed_dtypes(cuda):
    f32 = torch.zeros(1, 64, 2, 128, device=cuda)
    bf16, f16 = f32.bfloat16(), f32.half()
    lse = torch.zeros(1, 2, 64, device=cuda)
    for ops in ((f32, bf16, f32, f32), (bf16, bf16, bf16, f32), (f16, f16, f16, f16)):
        with pytest.raises(ValueError, match="one dtype"):
            flash_bwd(*ops, lse, lse)


def test_ring_backward_f32_stays_f32(cuda, no_tf32):
    """The token-causal ring backward over four in-process f32 shards of an
    SFT batch's attention ([1, 2048, 32, 128], shards of 512): the earlier
    shards' steps launch the f32 kernels (6 of each) and no bf16 backward
    kernel; the gradients hold the same loop with flash_bwd_plain at the f32
    limit and the dense f32 causal backward of the whole sequence within
    1e-4 of their norm per (batch row, head)."""
    n, (B, L, N, D) = 4, (1, 2048, 32, 128)
    gen = torch.Generator(cuda).manual_seed(22)
    q, k, v, do = (torch.randn(B, L, N, D, generator=gen, device=cuda) for _ in range(4))
    qs, ks, vs, dos = ([s_.contiguous() for s_ in t.chunk(n, 1)] for t in (q, k, v, do))
    fwd = ring_flash_attention_shards(qs, ks, vs, causal="token", return_lse=True)
    outs, lses = [f[0] for f in fwd], [f[1] for f in fwd]
    n0 = dict(flash_attention_train.launches)
    got = ring_flash_backward_shards(qs, ks, vs, outs, lses, dos, None, "token")
    steps = n * (n - 1) // 2
    assert {k_: flash_attention_train.launches[k_] - n0[k_] for k_ in n0} == {
        "flash_fwd_lse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_dq_f32": steps,
        "flash_bwd_dkv_f32": steps}
    ref = ring_flash_backward_shards(qs, ks, vs, outs, lses, dos, None, "token",
                                     bwd=flash_bwd_plain)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    s_ = torch.einsum("bind,bjnd->bnij", leaves[0], leaves[1]) * D**-0.5
    s_ = s_.masked_fill(torch.ones(L, L, dtype=torch.bool, device=cuda).triu(1), float("-inf"))
    torch.einsum("bnij,bjnd->bind", torch.softmax(s_, -1), leaves[2]).backward(do)
    for i, name in enumerate(("dq", "dk", "dv")):
        g, r = (torch.cat([x[i] for x in t], 1) for t in (got, ref))
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert float(_grad_rel(g, r).max()) <= BWD_F32_TOL, name
        assert float(_grad_rel(g, leaves[i].grad).max()) <= 1e-4, name


def _tiny_streamed_dit(cuda, dtype=torch.bfloat16):
    """A 3-block DiT at head dim 128 (the kernels'), heads non-zero, with
    bf16 weights (qk_prep's kernel takes bf16 only)."""
    from omnivideo_tpu_torch.configs.base import WanDiTConfig
    from omnivideo_tpu_torch.models.wan_dit import WanDiT

    cfg = WanDiTConfig(patch_size=(1, 2, 2), in_dim=4, dim=256, ffn_dim=512, freq_dim=32,
                       text_dim=48, out_dim=4, num_heads=2, num_layers=3, text_len=16)
    g = torch.Generator(cuda).manual_seed(0)
    wan = WanDiT(cfg, dtype=dtype, device=cuda, generator=g)
    with torch.no_grad():
        wan.head.head.weight.normal_(0.0, 0.05, generator=g)
    x = torch.randn(2, 4, 4, 16, 16, generator=g, device=cuda)
    t = torch.tensor([500.0, 500.0], device=cuda)
    ctx = torch.randn(2, 16, 48, generator=g, device=cuda)
    return wan, (x, t, ctx)


@pytest.mark.parametrize("window,group,ew", [(1, 1, "unfused"), (2, 1, "kernel"),
                                             (1, 2, "kernel")])
def test_streamed_forward_equals_resident_on_the_card(cuda, window, group, ew):
    """Blocks streamed from page-locked host buffers through a ring of
    `window` slots on the copy stream (window 1: every copy waits for the
    previous block's compute, the slot-reuse race detector) give the
    resident forward bit for bit, through the same kernels, with f32
    residual so the fused AdaLN runs at ew "kernel"."""
    from omnivideo_tpu_torch.pipelines import streaming

    wan, (x, t, ctx) = _tiny_streamed_dit(cuda)
    with torch.inference_mode():
        ref = wan(x, t, ctx, ew_impl=ew, residual_dtype=torch.float32)
    wan, host = streaming.split_host_params(wan)
    assert all(b.data.is_pinned() for b in host)
    ex = streaming.BlockStreamingExecutor(wan.cfg, host, window=window, group=group,
                                          ew_impl=ew, device=cuda)
    ex.timing = True
    n0 = qk_prep.launches
    with torch.inference_mode():
        out = streaming.wan_dit_stream_apply(wan, ex, x, t, ctx, residual_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert qk_prep.launches - n0 == 4 * 3
    (stats,) = ex.stats
    assert stats["copies"] == -(-3 // group) and 0.0 <= stats["hidden_share"] <= 1.0


def test_streamed_int8_quantises_on_the_card_as_on_the_host(cuda):
    """The int8 copies made on the card (the executor's) equal the host
    quantiser's on the same blocks."""
    from omnivideo_tpu_torch.ops.quant import Q8, quantize_block
    from omnivideo_tpu_torch.pipelines import streaming

    wan, _ = _tiny_streamed_dit(cuda)
    wan, host = streaming.split_host_params(wan)
    ex = streaming.BlockStreamingExecutor(wan.cfg, host, quant="int8", device=cuda)
    want = quantize_block(host[0].block())
    for k, v in ex.host_blocks[0].block().items():
        if isinstance(v, Q8):
            assert torch.equal(v.q8, want[k].q8) and torch.equal(v.scale, want[k].scale), k
        else:
            assert torch.equal(v, want[k]), k


def test_streamed_pageable_host_block_raises(cuda):
    """A host block in pageable memory would make each non-blocking copy
    synchronous: the executor refuses it, and so does a load into a slot."""
    from omnivideo_tpu_torch.pipelines import streaming

    wan, _ = _tiny_streamed_dit(cuda)
    block = streaming.block_tensors(wan.blocks[0])
    pageable = streaming.BlockPacker(block).pack(block, pin=False)
    with pytest.raises(RuntimeError, match="page-locked"):
        streaming.BlockStreamingExecutor(wan.cfg, [pageable] * 3, device=cuda)
    ring = streaming.DeviceRing(pageable.nbytes, 1, cuda)
    with pytest.raises(RuntimeError, match="page-locked"):
        ring.load(0, [(pageable.data, 0)])


def test_registered_ops_launch_the_kernels(cuda):
    """The `omnivideo::` ops called directly, as a torch.export program calls
    them, launch the hand-written kernels (one count each) and agree with
    the plain twins as the wrappers do; their fake implementations give the
    kernels' output shapes and dtypes."""
    import omnivideo_tpu_torch.ops  # noqa: F401
    from torch._subclasses.fake_tensor import FakeTensorMode

    ops = torch.ops.omnivideo
    q, k, v = _qkv(2, 300, 517, 2, 128, 5, 4.0, cuda)
    mb, safe = softmax_bound(q, k, 128**-0.5)
    n0 = flash_attention.launches["flash_fwd"]
    o = ops.flash_attention(q, k, v, None, mb, safe, 128**-0.5, False)
    assert flash_attention.launches["flash_fwd"] == n0 + 1
    _assert_flash_close(o, flash_attention_plain(q, k, v, None, 128**-0.5, mb, safe))

    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(2, 700, 256, generator=gen, device=cuda) * 3).bfloat16()
    g = 1.0 + 0.1 * torch.randn(256, generator=gen, device=cuda)
    cos, sin = (torch.tensor(t, device=cuda) for t in rope_3d_tables((5, 10, 14), 128))
    n0 = qk_prep.launches
    y, rn = ops.qk_prep(x, g, cos, sin, 2, 1e-6)
    assert qk_prep.launches == n0 + 1
    yp, rnp = qk_prep_plain(x, g, cos, sin, 2, 1e-6)
    assert float(_pair_ulps(y, yp).max()) <= 4.0
    torch.testing.assert_close(rn, rnp, rtol=1e-4, atol=0)

    xs = 2.0 + torch.randn(2, 37, 256, generator=gen, device=cuda)
    o2 = torch.randn(2, 37, 256, generator=gen, device=cuda).bfloat16()
    m = torch.randn(2, 256, generator=gen, device=cuda)
    n0 = fused_adaln.launches
    x_new, y2 = ops.fused_adaln(xs, o2, m, None, None, m, m, 1e-6, torch.bfloat16)
    assert fused_adaln.launches == n0 + 1
    x_ref, y_ref = fused_adaln_plain(xs, o2, m, None, None, m, m, 1e-6, torch.bfloat16)
    assert torch.equal(x_new, x_ref)
    assert bool(((y2.float() - y_ref.float()).abs()
                 <= _bf16_ulp(y_ref.float().abs().amax(-1, keepdim=True))).all())

    with FakeTensorMode() as mode:
        fq, fk, fv, fx, fxs, fo = (mode.from_tensor(t) for t in (q, k, v, x, xs, o2))
        fmb, fsafe, fg, fm = (mode.from_tensor(t) for t in (mb, safe, g, m))
        assert ops.flash_attention(fq, fk, fv, None, fmb, fsafe, 0.1, False).shape == q.shape
        fy, frn = ops.qk_prep(fx, fg, None, None, 2, 1e-6)
        assert (fy.shape, frn.shape, frn.dtype) == ((2, 700, 2, 128), (2, 2), torch.float32)
        fxn, fy2 = ops.fused_adaln(fxs, fo, fm, None, None, fm, fm, 1e-6, torch.float32)
        assert fxn.shape == xs.shape and fy2.dtype == torch.float32


@pytest.mark.parametrize("residual", ["bfloat16", "float32"])
def test_exported_dit_on_the_card_equals_eager(cuda, residual, tmp_path):
    """tools/export_aot.py on a 2-layer head-dim-128 DiT on the card: the
    loaded program launches the same kernels as the eager forward (qk_prep,
    flash_fwd; fused_adaln with the f32 residual) and gives its output bit
    for bit."""
    from omnivideo_tpu_torch.configs.base import WanDiTConfig
    from omnivideo_tpu_torch.models.wan_dit import WanDiT
    from omnivideo_tpu_torch.tools import export_aot

    cfg = WanDiTConfig(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=256, ffn_dim=512,
                       freq_dim=32, text_dim=48, out_dim=4, num_heads=2, num_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(3)
    dit = WanDiT(cfg, dtype=torch.bfloat16, device=cuda, generator=gen)
    with torch.no_grad():
        dit.head.head.weight.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(2, 4, 3, 16, 16, generator=gen, device=cuda).bfloat16()
    t = torch.tensor([937.0, 41.0], device=cuda)
    ctx = torch.randn(2, 16, 48, generator=gen, device=cuda).bfloat16()
    rdt = getattr(torch, residual)
    prog = export_aot.export_denoise(dit, x, t, ctx, rdt)
    export_aot.save_program(prog, tmp_path / "dit.pt2")
    loaded = torch.export.load(str(tmp_path / "dit.pt2")).module()

    def counts():
        return (qk_prep.launches, flash_attention.launches["flash_fwd"], fused_adaln.launches)

    with torch.no_grad():
        c0 = counts()
        got = loaded(export_aot.dit_params(dit), x, t, ctx)
        c1 = counts()
        want = dit(x, t, ctx, residual_dtype=rdt, qk_impl="kernel",
                   ew_impl=export_aot.ew_impl_for(rdt))
        c2 = counts()
    prog_n = tuple(b - a for a, b in zip(c0, c1))
    assert prog_n == tuple(b - a for a, b in zip(c1, c2))
    assert prog_n == (8, 4, 7 if residual == "float32" else 0)
    assert torch.equal(got, want)


GMM_F32_TOL = 1e-5
GMM_BF16_ULPS = 4.0
GMM_CASES = {  # (m, group sizes)
    "routed": (300, [40, 0, 97, 1, 0, 62, 100, 0]),      # empty experts, boundaries mid-tile
    "one_expert_all_rows": (200, [0, 0, 200, 0]),
    "m_not_a_tile_multiple": (131, [64, 67]),
    "sum_below_m": (290, [30, 0, 100, 5]),               # rows 135.. are zero
    "decode": (8, [1, 0, 1, 1, 1, 0, 1, 1, 1, 1]),
    "all_empty": (40, [0, 0, 0]),
}


def _gmm_err(out, ref, dtype):
    """max |out − ref| over each row's max |ref|: f32 relative, bf16 in ulps."""
    if dtype == torch.bfloat16:
        return float(_row_ulps(out, ref).max()) if out.numel() else 0.0
    rmax = ref.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((out.float() - ref.float()).abs() / rmax).max()) if out.numel() else 0.0


def _gmm_ok(out, ref, dtype):
    return _gmm_err(out, ref, dtype) <= (GMM_BF16_ULPS if dtype == torch.bfloat16
                                         else GMM_F32_TOL)


GMM_WIDTHS = [(264, 200)] + [(k, n) for k in (192, 384) for n in (96, 192, 384)]  # (k, n):
# 264 x 200 neither a multiple of the 64-deep steps nor of any column tile; the others the
# `--vlm_fsdp` split widths (768 / 8, / 4, / 2) that pick the 192- and 128-column tiles of
# the many-row kernel and the 64- and 128-column tiles, unsplit k, of the few-row one


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(GMM_CASES))
@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("k,n", GMM_WIDTHS)
def test_gmm_kernel_matches_plain(cuda, dtype, case, transpose_rhs, k, n):
    m, sizes = GMM_CASES[case]
    E = len(sizes)
    gen = torch.Generator(device=cuda).manual_seed(m)
    lhs = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    rhs = torch.randn(*((E, n, k) if transpose_rhs else (E, k, n)), generator=gen,
                      device=cuda).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    n0 = gmm.launches
    out = gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    torch.cuda.synchronize()
    assert gmm.launches == n0 + 1 and out.shape == (m, n) and out.dtype == dtype
    ref = gmm_plain(lhs, rhs, gs, transpose_rhs)
    total = min(sum(sizes), m)
    assert torch.count_nonzero(out[total:]) == 0
    assert _gmm_ok(out[:total], ref[:total], dtype), _gmm_err(out[:total], ref[:total], dtype)
    again = gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    assert torch.equal(again, out)  # no atomics: bit for bit


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_tgmm_kernel_matches_plain(cuda, dtype, case):
    m, sizes = GMM_CASES[case]
    E, k, n = len(sizes), 264, 200
    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    lhs = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    rhs = torch.randn(m, n, generator=gen, device=cuda).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    n0 = tgmm.launches
    out = tgmm(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert tgmm.launches == n0 + 1 and out.shape == (E, k, n) and out.dtype == dtype
    ref = tgmm_plain(lhs, rhs, gs)
    for e, size in enumerate(sizes):
        if size and sum(sizes[:e]) < m:
            assert _gmm_ok(out[e].reshape(1, -1), ref[e].reshape(1, -1), dtype), e
        else:
            assert torch.count_nonzero(out[e]) == 0, e


def test_grouped_matmul_backward_on_the_card(cuda):
    """GroupedMatmul's backward launches gmm (the bank transposed) and tgmm,
    and gives the plain twins' gradients (f32, as the SFT's banks)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    sizes = [50, 0, 77, 129]
    lhs = torch.randn(256, 64, generator=gen, device=cuda, requires_grad=True)
    rhs = torch.randn(4, 64, 96, generator=gen, device=cuda, requires_grad=True)
    w = torch.randn(256, 96, generator=gen, device=cuda)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    g0, t0 = gmm.launches, tgmm.launches
    (GroupedMatmul.apply(lhs, rhs, gs) * w).sum().backward()
    assert (gmm.launches - g0, tgmm.launches - t0) == (2, 1)
    ref_l = gmm_plain(w, rhs.detach(), gs, transpose_rhs=True)
    ref_r = tgmm_plain(lhs.detach(), w, gs)
    assert _gmm_ok(lhs.grad, ref_l, torch.float32)
    for e in range(4):
        if sizes[e]:
            assert _gmm_ok(rhs.grad[e].reshape(1, -1), ref_r[e].reshape(1, -1), torch.float32)


def _gmm_matches_plain(cuda, m, sizes, k, n, dtype, transpose_rhs, kind, seed, tail=0.0):
    """gmm on the card against gmm_plain: `kind` is the schedule the wrapper
    picks, the rows of the groups within the limit, the rows past the group
    sum exactly zero (they hold `tail` in lhs: NaN must not reach a group's
    row), the same bits on a second call."""
    E = len(sizes)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    lhs = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    total = min(sum(sizes), m)
    lhs[total:] = tail
    rhs = torch.randn(*((E, n, k) if transpose_rhs else (E, k, n)), generator=gen,
                      device=cuda).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    sched = gmm_schedule(m, k, n, E, dtype, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert sched.kind == kind
    n0 = gmm.launches
    out = gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    torch.cuda.synchronize()
    assert gmm.launches == n0 + 1 and out.shape == (m, n) and out.dtype == dtype
    ref = gmm_plain(lhs, rhs, gs, transpose_rhs)
    assert torch.count_nonzero(out[total:]) == 0
    assert torch.isfinite(out).all()
    assert _gmm_ok(out[:total], ref[:total], dtype), _gmm_err(out[:total], ref[:total], dtype)
    assert torch.equal(gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs), out)


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_gmm_few_rows_split_k(cuda, m, transpose_rhs):
    """The decode's schedule (bf16, m <= 64): one-row groups among empty ones
    at Qwen3-VL-30B-A3B's widths, k split over a cluster; and a call whose
    group sizes sum below m."""
    sizes = [1, 0] * m
    _gmm_matches_plain(cuda, m, sizes, 2048, 768, torch.bfloat16, transpose_rhs, "split_k", m)
    _gmm_matches_plain(cuda, m, sizes, 768, 2048, torch.bfloat16, transpose_rhs, "split_k", m + 1)
    if m > 1:
        short = [1, 0] * (m - 1) + [0, 0]
        _gmm_matches_plain(cuda, m, short, 2048, 768, torch.bfloat16, transpose_rhs, "split_k",
                           m + 2, tail=float("nan"))


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gmm_many_rows_boundaries(cuda, dtype, transpose_rhs):
    """A group boundary inside a 128-row tile (37 rows, then 400: four tiles
    from row 37), an empty group, a group larger than several tiles, and
    rows past the sum holding NaN."""
    kind = "wgmma" if dtype == torch.bfloat16 else "tf32"
    _gmm_matches_plain(cuda, 760, [37, 400, 0, 263], 2048, 768, dtype, transpose_rhs, kind, 3,
                       tail=float("nan"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,kind", [(8, "split_k"), (300, "wgmma")])
def test_gmm_widths_not_tile_multiples(cuda, dtype, m, kind):
    """k and n multiples of 8 but not of the 64-deep panel or the 128/256-
    wide tiles."""
    kind = kind if dtype == torch.bfloat16 else "tf32"
    sizes = [3, 0, 2, 3] if m == 8 else [100, 0, 150, 50]
    for k, n in ((72, 40), (136, 264)):
        for transpose_rhs in (False, True):
            _gmm_matches_plain(cuda, m, sizes, k, n, dtype, transpose_rhs, kind, k + n)


@pytest.mark.parametrize("m", [8, 3000])
def test_gmm_one_and_1024_groups(cuda, m):
    """E = 1 (every row one expert's) and E = 1024 (the most the scan takes,
    most of them empty)."""
    gen = np.random.default_rng(m)
    many = [0] * 1024
    for e in gen.choice(1024, size=min(m, 200), replace=False):
        many[e] = m // min(m, 200)
    kind = "split_k" if m <= 64 else "wgmma"
    for transpose_rhs in (False, True):
        _gmm_matches_plain(cuda, m, [m], 256, 128, torch.bfloat16, transpose_rhs, kind, 1)
        _gmm_matches_plain(cuda, m, many, 128, 64, torch.bfloat16, transpose_rhs, kind, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tgmm_neighbour_rows_do_not_leak(cuda, dtype):
    """tgmm where each group's neighbours hold rows 1000x larger and the rows
    past the group sum hold NaN: a group's block sums its own rows only (a
    neighbour's row in a 64-row step would miss the limit by far), an empty
    group's block is zero, and E = 1 and 1024 run too."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    sizes = [37, 0, 130, 1, 64, 70, 5]
    m, k, n = 400, 264, 200
    lhs = torch.randn(m, k, generator=gen, device=cuda)
    rhs = torch.randn(m, n, generator=gen, device=cuda)
    start = 0
    for e, size in enumerate(sizes):
        if e % 2:
            lhs[start:start + size] *= 1000
            rhs[start:start + size] *= 1000
        start += size
    lhs[start:] = float("nan")
    rhs[start:] = float("nan")
    lhs, rhs = lhs.to(dtype), rhs.to(dtype)
    for gs_list in (sizes, [start], [0] * 1000 + sizes + [0] * 17):
        gs = torch.tensor(gs_list, dtype=torch.int32, device=cuda)
        out = tgmm(lhs, rhs, gs)
        torch.cuda.synchronize()
        ref = tgmm_plain(lhs, rhs, gs)
        for e, size in enumerate(gs_list):
            if size:
                assert _gmm_ok(out[e].reshape(1, -1), ref[e].reshape(1, -1), dtype), (e, _gmm_err(
                    out[e].reshape(1, -1), ref[e].reshape(1, -1), dtype))
            else:
                assert torch.count_nonzero(out[e]) == 0, e
        assert torch.equal(tgmm(lhs, rhs, gs), out)


def test_gmm_kernels_refuse_bad_operands(cuda):
    gs = torch.tensor([4, 4], dtype=torch.int32, device=cuda)
    lhs = torch.zeros(8, 16, device=cuda, dtype=torch.bfloat16)
    rhs = torch.zeros(2, 16, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        gmm(lhs.half(), rhs.half(), gs)
    with pytest.raises(ValueError, match="one dtype"):
        gmm(lhs, rhs.float(), gs)
    with pytest.raises(ValueError, match="contiguous"):
        gmm(lhs, rhs.transpose(1, 2).contiguous().transpose(1, 2), gs)
    with pytest.raises(ValueError, match="multiples"):
        gmm(torch.zeros(8, 12, device=cuda, dtype=torch.bfloat16),
            torch.zeros(2, 12, 8, device=cuda, dtype=torch.bfloat16), gs)
    with pytest.raises(ValueError, match="CUDA device"):
        gmm(lhs, rhs, gs.cpu())
    with pytest.raises(ValueError, match="aligned"):
        gmm(torch.zeros(8 * 16 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(8, 16), rhs, gs)
    with pytest.raises(RuntimeError, match="GroupedMatmul"):
        gmm(lhs.float().requires_grad_(True), rhs.float(), gs)


def test_moe_runs_without_a_host_sync(cuda):
    """The inference MoE on the card (routing, group sizes, three gmm
    launches, the slot sum) under set_sync_debug_mode("error"): any op that
    waits on the host raises."""
    from omnivideo_tpu_torch.configs.qwen3vl import Qwen3TextConfig
    from omnivideo_tpu_torch.models.qwen3vl import text_model as vlm_text

    cfg = Qwen3TextConfig(vocab_size=64, hidden_size=256, num_hidden_layers=1,
                          num_attention_heads=2, num_key_value_heads=1, num_experts=16,
                          num_experts_per_tok=4, moe_intermediate_size=128)
    lm = vlm_text.Qwen3LM(cfg, torch.bfloat16, cuda, torch.Generator(device=cuda).manual_seed(0))
    mlp = lm.language_model.layers[0].mlp
    x = torch.randn(1, 300, 256, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    x = x.bfloat16()
    with torch.inference_mode():
        ref = vlm_text.moe_dense(mlp, x).float()
        vlm_text.moe(mlp, x)  # builds the kernels outside the check
        torch.cuda.synchronize()
        n0 = gmm.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = vlm_text.moe(mlp, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert gmm.launches == n0 + 3
        rel = float((y.float() - ref).abs().max() / ref.abs().max())
    assert rel <= 2e-2, rel  # bf16 products, the k outputs summed in bf16 (chip_smoke MOE_TOL)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("m,kind", [(8, "split_k"), (11848, "wgmma")])
def test_gmm_at_the_split_expert_widths(cuda, shards, m, kind):
    """Row 9 at the widths of Qwen3-VL-30B-A3B's banks split over 2 and 4
    cards (`--vlm_fsdp`): gate/up [128, 2048, 768/n] and down [128, 768/n,
    2048] (n = 384 or 192: the wide kernel's 192-column tiles; k = 384 or
    192: the split-k kernel's 6 or 3 64-deep steps in one split), at a
    decode step's 8 rows and the prefill's 11,848 (1,481 tokens, top-8),
    the group sizes of a seeded skewed routing."""
    E, D, w = 128, 2048, 768 // shards
    rng = np.random.default_rng(m + shards)
    p = rng.dirichlet(np.full(E, 0.3))
    sizes = rng.multinomial(m, p).tolist()
    _gmm_matches_plain(cuda, m, sizes, D, w, torch.bfloat16, False, kind, 21 + shards)
    _gmm_matches_plain(cuda, m, sizes, w, D, torch.bfloat16, False, kind, 22 + shards)


@pytest.mark.parametrize("k,n", [(2048, 768), (2048, 384), (2048, 192), (2048, 64), (768, 2048)])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_gmm_split_k_clusters_fit_one_wave(cuda, m, k, n):
    """The split-k schedule keeps its clusters to what the card holds at once
    (CLUSTER_FILL's margin against cudaOccupancyMaxActiveClusters)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sched = gmm_schedule(m, k, n, 128, torch.bfloat16, sms)
    if sched.splits > 1:
        assert sched.blocks // sched.splits <= resident_clusters(m, sched), sched


def test_sharded_moe_launches_row_9_on_the_card(cuda):
    """A MoE split over two in-process shards (no group: each gives its f32
    partial sum) launches gmm three times a shard; the partials add up to
    the whole MoE's all-experts oracle (MOE_TOL, as the unsharded MoE)."""
    from omnivideo_tpu_torch.configs.qwen3vl import Qwen3TextConfig
    from omnivideo_tpu_torch.models.qwen3vl import text_model as vlm_text
    from omnivideo_tpu_torch.parallel.expert_shard import ExpertShard, shard_experts

    cfg = Qwen3TextConfig(vocab_size=64, hidden_size=256, num_hidden_layers=1,
                          num_attention_heads=2, num_key_value_heads=1, num_experts=16,
                          num_experts_per_tok=4, moe_intermediate_size=128)
    x = torch.randn(1, 300, 256, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)).bfloat16()
    parts = []
    with torch.inference_mode():
        for r in range(2):
            lm = vlm_text.Qwen3LM(cfg, torch.bfloat16, cuda,
                                  torch.Generator(device=cuda).manual_seed(0))
            if r == 0:
                ref = vlm_text.moe_dense(lm.language_model.layers[0].mlp, x).float()
            shard_experts(lm, ExpertShard(r, 2))
            mlp = lm.language_model.layers[0].mlp
            assert mlp.experts_gate.shape == (16, 256, 64) and mlp.experts_down.shape == (16, 64, 256)
            n0 = gmm.launches
            parts.append(vlm_text.moe_partial(mlp, x))
            torch.cuda.synchronize()
            assert gmm.launches == n0 + 3
    rel = float(((parts[0] + parts[1]) - ref).abs().max() / ref.abs().max())
    assert rel <= 2e-2, rel
