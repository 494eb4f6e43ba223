"""The f32 flash backward kernels' arithmetic, emulated on the CPU.

`csrc/flash_train_f32.cu` (rows 4 and 5 on f32 operands) takes f32-accurate
products on the TF32 tensor cores by the three-product split of
`ring_step_f32.cu`: x = hi + lo with hi = tf32(x) and lo = tf32(x − hi),
both rounded to nearest, and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi. Here
the kernels' arithmetic runs in torch: the split on int32 views; the tile
order (dq walks 32-key tiles, dk/dv 32-row q tiles); each product's k8 steps
with the tensor cores' accumulator, whose sum is rounded toward zero at every
step; p = exp2(s·scale·log2e − LSE·log2e) and ds = p·(dp − delta)·scale in
f32, split before their products and taken over the tile in the transposed
panels' permuted order; and each tile's product folded into the f32 gradient
by a rounded add. The result is held to `flash_bwd_plain` on the same f32
inputs within 1e-5 of each gradient's norm per (batch row, head), with and
without kv_lens, the card's limit; one TF32 pass per product misses it, and
so does a gradient carried through the accumulator over an SFT batch's
2,048 q rows instead of folded per tile. The index maps the kernels rely on
are checked against the 128-byte swizzle as wgmma reads it: the K-major
tiles, the transposed panels, and the accumulator entries that become the
gradient products' A fragments. `flash_bwd_plain` on f32 is held in turn to
JAX's `flash_bwd_core` in interpret mode on the same inputs. Inputs are
seeded numpy normals at [2, 256, 2, 128].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops.pallas.flash_attention import flash_bwd_core
from omnivideo_tpu_torch.ops.flash_attention import (
    LOG2E,
    flash_bwd_plain,
    flash_delta,
    flash_fwd_lse_plain,
)

TOL = 1e-5  # of each gradient's norm per (batch row, head): chip_smoke's BWD_F32_TOL
TILE = 32  # keys (dq) or q rows (dk/dv) per tile
ROWS = 64  # stationary rows per block
B, L, N, D = 2, 256, 2, 128
SCALE = D**-0.5
KV_LENS = {"none": None, "ragged": [200, 37], "empty_row": [256, 0]}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest tf32 (ties away from zero), held in an f32:
    the kernel's tf32_round."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def key_at(pos: int) -> int:
    """The key (or q row) a transposed panel holds at position `pos` of a
    32-row tile: position t of each group of 8 holds 2t, t + 4 holds 2t + 1."""
    g, u = divmod(pos, 8)
    return 8 * g + 2 * (u % 4) + u // 4


def key_pos(key: int) -> int:
    """hopper_common.cuh tf32_key_pos."""
    return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2)


PERM = [key_at(p) for p in range(TILE)]


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 values rounded to f32 toward zero (kept as f64)."""
    y = x.float()
    y = torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)
    return y.double()


def tc_product(terms, acc=None) -> torch.Tensor:
    """Σ a·b over the terms, as wgmma accumulates: each k8 step's 8 products
    and the accumulator summed exactly, then rounded toward zero. a [..., M, K]
    and b [..., K, N] hold f32 (tf32) values; returns f64 holding f32."""
    for a, b in terms:
        a, b = a.double(), b.double()
        if acc is None:
            acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float64)
        for k8 in range(0, a.shape[-1], 8):
            acc = _toward_zero(acc + a[..., k8:k8 + 8] @ b[..., k8:k8 + 8, :])
    return acc


def mm3(a, b, products):
    """The split product a·b (a [..., M, K], b [..., K, N] f32): a_lo·b_hi +
    a_hi·b_lo + a_hi·b_hi, or one TF32 pass a_hi·b_hi."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    if products == 1:
        return [(a_hi, b_hi)]
    return [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]


def _pad_rows(t: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows r0..r0 + TILE − 1 of [H, R, D] t, rows at or past n as zeros (staging)."""
    out = torch.zeros(t.shape[0], TILE, t.shape[2], dtype=t.dtype)
    m = max(0, min(TILE, n - r0))
    out[:, :m] = t[:, r0:r0 + m]
    return out


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def emulated_bwd(q, k, v, do, lse, delta, kv_lens=None, products=3, fold=True):
    """(dq, dk, dv) f32 as the two kernels compute them. `fold` False carries
    each gradient through the accumulator over all tiles instead."""
    Bq, Lq, Nh, Dh = q.shape
    Lk = k.shape[1]
    sl2 = _f32(np.float32(SCALE) * np.float32(LOG2E))
    scale = _f32(np.float32(SCALE))
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    heads = lambda t, b: t[b].transpose(0, 1).contiguous()  # noqa: E731  [N, L, D]
    for b in range(Bq):
        n = Lk if kv_lens is None else max(0, min(kv_lens[b], Lk))
        qb, dob, kb, vb = heads(q, b), heads(do, b), heads(k, b), heads(v, b)
        lse2 = _f32(lse[b] * _f32(LOG2E))  # [N, Lq]
        dl = delta[b]
        # dq: the block's q rows against 32-key tiles up to kv_len
        acc = torch.zeros(Nh, Lq, Dh, dtype=torch.float64)
        for kv0 in range(0, n, TILE):
            kt, vt = _pad_rows(kb, kv0, n), _pad_rows(vb, kv0, n)
            s = tc_product(mm3(qb, kt.transpose(1, 2), products)).float()
            dp = tc_product(mm3(dob, vt.transpose(1, 2), products)).float()
            col = kv0 + torch.arange(TILE)
            arg = (s.double() * sl2.double() - lse2[..., None].double()).float()  # fmaf
            p = torch.where(col < n, torch.exp2(arg), torch.zeros(()))
            ds = p * (dp - dl[..., None]) * scale
            terms = mm3(ds[..., PERM], kt[:, PERM], products)
            if fold:
                acc = (acc + tc_product(terms)).float().double()
            else:
                acc = tc_product(terms, acc)
        dq[b] = acc.float().transpose(0, 1)
        # dk/dv: the block's KV rows against 32-row q tiles
        live = torch.arange(Lk) < n
        kb, vb = kb * live[:, None], vb * live[:, None]  # staging zeroes rows past kv_len
        acc_k = torch.zeros(Nh, Lk, Dh, dtype=torch.float64)
        acc_v = torch.zeros(Nh, Lk, Dh, dtype=torch.float64)
        for q0 in range(0, Lq, TILE):
            qt, dot = _pad_rows(qb, q0, Lq), _pad_rows(dob, q0, Lq)
            st = tc_product(mm3(kb, qt.transpose(1, 2), products)).float()
            dpt = tc_product(mm3(vb, dot.transpose(1, 2), products)).float()
            col = q0 + torch.arange(TILE)
            ok = live[:, None] & (col < Lq)[None, :]
            colc = col.clamp(max=Lq - 1)
            arg = (st.double() * sl2.double() - lse2[:, colc][:, None, :].double()).float()
            p = torch.where(ok, torch.exp2(arg), torch.zeros(()))
            dlt = torch.where(ok, dl[:, colc][:, None, :], torch.zeros(()))
            dst = p * (dpt - dlt) * scale
            terms_v = mm3(p[..., PERM], dot[:, PERM], products)
            terms_k = mm3(dst[..., PERM], qt[:, PERM], products)
            if fold:
                acc_v = (acc_v + tc_product(terms_v)).float().double()
                acc_k = (acc_k + tc_product(terms_k)).float().double()
            else:
                acc_v, acc_k = tc_product(terms_v, acc_v), tc_product(terms_k, acc_k)
        dk[b], dv[b] = acc_k.float().transpose(0, 1), acc_v.float().transpose(0, 1)
    return dq, dk, dv


def _grad_rel(g, ref):
    """‖g − ref‖ / ‖ref‖ per (batch row, head) of [B, L, N, D] gradients."""
    num = (g.double() - ref.double()).square().sum(dim=(1, 3)).sqrt()
    return num / ref.double().square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)


def _inputs(seed: int, kv_lens=None, Lq=L, Lk=L):
    rng = np.random.default_rng(seed)
    q, do = (torch.tensor(rng.standard_normal((B, Lq, N, D)).astype(np.float32)) for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, Lk, N, D)).astype(np.float32)) for _ in range(2))
    lens = None if kv_lens is None else torch.tensor(kv_lens, dtype=torch.int32)
    o, lse = flash_fwd_lse_plain(q, k, v, lens, SCALE)
    return q, k, v, do, lse, flash_delta(do, o), lens


def _errors(case: str, seed: int = 7, **kw):
    q, k, v, do, lse, delta, lens = _inputs(seed, KV_LENS[case])
    got = emulated_bwd(q, k, v, do, lse, delta, KV_LENS[case], **kw)
    ref = flash_bwd_plain(q, k, v, do, lse, delta, lens, SCALE)
    return {name: float(_grad_rel(g, r).max()) for name, g, r in zip(("dq", "dk", "dv"), got, ref)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(KV_LENS))
def test_three_products_hold_f32(case):
    err = _errors(case)
    assert max(err.values()) <= TOL, err


@pytest.mark.parametrize("case", ["none", "ragged"])
def test_one_tf32_pass_misses_f32(case):
    """One TF32 product per matmul (~2^-11 per operand) is far off."""
    err = _errors(case, products=1)
    assert min(err.values()) > 20 * TOL, err


def test_zero_rows_past_kv_len_and_without_keys():
    """dk/dv rows past kv_len and the dq of a batch row without keys are
    exactly zero in the emulation, as the kernels write them."""
    q, k, v, do, lse, delta, lens = _inputs(3, KV_LENS["empty_row"])
    dq, dk, dv = emulated_bwd(q, k, v, do, lse, delta, KV_LENS["empty_row"])
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
    q, k, v, do, lse, delta, lens = _inputs(3, KV_LENS["ragged"])
    _, dk, dv = emulated_bwd(q, k, v, do, lse, delta, KV_LENS["ragged"])
    for b, n in enumerate(KV_LENS["ragged"]):
        assert (dk[b, n:] == 0).all() and (dv[b, n:] == 0).all()


def test_accumulator_rounding_needs_the_per_tile_fold():
    """dv = pᵀ·dO over an SFT batch's 2,048 q rows (one batch row and head,
    64 KV rows): carried through the tensor cores' accumulator over all 64
    tiles (3 × 4 k8 steps each, every step rounded toward zero) it drifts
    past the limit; each tile's product from zero, added by a rounded add,
    stays within it. p is taken exactly here: the point is the accumulation."""
    rng = np.random.default_rng(5)
    Lq, Lk = 2048, ROWS
    q, k, do = (torch.tensor(rng.standard_normal((n_, D)).astype(np.float32))
                for n_ in (Lq, Lk, Lq))
    s = k.double() @ q.double().T * SCALE  # sᵀ [Lk, Lq]
    pt = torch.exp(s - torch.logsumexp(s, 0, keepdim=True)).float()  # each q row's softmax
    exact = pt.double() @ do.double()
    carried = torch.zeros(Lk, D, dtype=torch.float64)
    folded = torch.zeros(Lk, D, dtype=torch.float64)
    for q0 in range(0, Lq, TILE):
        terms = mm3(pt[:, q0:q0 + TILE], do[q0:q0 + TILE], 3)
        carried = tc_product(terms, carried)
        folded = (folded + tc_product(terms)).float().double()
    norm = exact.norm()
    drift, fold = float((carried - exact).norm() / norm), float((folded - exact).norm() / norm)
    assert drift > TOL >= fold, (drift, fold)


# --- index maps ---------------------------------------------------------------

def kmajor_off(R: int, r: int, c: int) -> int:
    """flash_train_f32.cu kmajor_off: (row r, 16-byte chunk c) of an R-row tile."""
    return (c >> 3) * (R * 128) + r * 128 + ((((c & 7) ^ r) & 7) << 4)


def swz128(r: int, c: int) -> int:
    """hopper_common.cuh swz128: (row r, f32 column c < 32) of a swizzled panel."""
    return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2)


def wgmma_reads(buf: np.ndarray, start: int, panel: int, rows: int, K: int) -> np.ndarray:
    """The [rows, K] K-major tf32 operand wgmma reads from `buf` (f32 words)
    through descriptors whose start is `start` + (kk / 4)·panel + (kk % 4)·32
    bytes for k8 step kk, SBO 1024 bytes and the 128-byte swizzle: row r,
    element j of a step sits at start + (r / 8)·1024 + (r % 8)·128 + 4j, with
    address bits 4-6 XORed with bits 7-9 (the base is 1024-byte aligned)."""
    out = np.empty((rows, K), dtype=buf.dtype)
    for r in range(rows):
        for kx in range(K):
            kk, j = divmod(kx, 8)
            a = start + (kk >> 2) * panel + (kk & 3) * 32 + (r // 8) * 1024 + (r % 8) * 128 + 4 * j
            out[r, kx] = buf[(a ^ (((a >> 7) & 7) << 4)) // 4]
    return out


@pytest.mark.parametrize("R", [ROWS, TILE])
def test_kmajor_tiles_are_what_wgmma_reads(R):
    """A staged [R, 128] K-major tile (the s, dp, sᵀ, dpᵀ operands) read back
    through the descriptors gemm_abt steps: every element where it belongs."""
    tile = np.random.default_rng(R).standard_normal((R, D)).astype(np.float32)
    buf = np.full(R * D, np.nan, dtype=np.float32)
    for r in range(R):
        for c in range(D // 4):
            o = kmajor_off(R, r, c) // 4
            buf[o:o + 4] = tile[r, 4 * c:4 * c + 4]
    assert np.array_equal(wgmma_reads(buf, 0, R * 128, R, D), tile)


def test_transposed_panels_are_what_wgmma_reads():
    """A 32-row tile staged transposed (kᵀ in dq, qᵀ and dOᵀ in dk/dv) read
    back as the gradient products' B operand, quarter qt of the 128 columns
    at a time: position p of column d holds the tile's row key_at(p)."""
    tile = np.random.default_rng(1).standard_normal((TILE, D)).astype(np.float32)
    buf = np.full(TILE * D, np.nan, dtype=np.float32)
    for key in range(TILE):
        for d in range(D):
            buf[swz128(d, key_pos(key)) // 4] = tile[key, d]
    for qt in range(4):
        got = wgmma_reads(buf, qt * 32 * 128, 0, 32, TILE)  # [32 columns of d, 32 positions]
        want = tile[PERM][:, 32 * qt:32 * qt + 32].T
        assert np.array_equal(got, want)


def test_key_permutation_is_a_bijection():
    assert sorted(PERM) == list(range(TILE))
    assert all(key_pos(key_at(p)) == p for p in range(TILE))


def test_accumulator_entries_are_the_gradient_fragments():
    """For every lane and k8 step of a gradient product: the 64 x 32
    accumulator entry tf32_frags puts in A slot e (i = 4kk + 2(e & 1) + (e >> 1))
    sits in the slot's row, and its column (key or q row) is the one the
    transposed panel holds at the slot's k index. Accumulator entry i of lane
    λ: row 16w + λ/4 + 8((i >> 1) & 1), column 8(i / 4) + 2(λ % 4) + (i & 1);
    tf32 A (64 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)."""
    for lane in range(32):
        g, t = divmod(lane, 4)
        for kk in range(TILE // 8):
            for e in range(4):
                i = 4 * kk + ((e & 1) << 1) + (e >> 1)
                acc_row, acc_col = g + 8 * ((i >> 1) & 1), 8 * (i // 4) + 2 * t + (i & 1)
                a_row, a_k = g + 8 * (e & 1), t + 4 * (e >> 1)
                assert acc_row == a_row
                assert key_at(8 * kk + a_k) == acc_col


# --- the plain twin against JAX ----------------------------------------------

@pytest.mark.parametrize("case", ["none", "ragged"])
def test_plain_f32_matches_jax_flash_bwd_core(case):
    """flash_bwd_plain on f32 against JAX's flash_bwd_core (the Pallas dq and
    dk/dv kernels, interpret mode, f32 operands: p and ds stay f32 there) on
    the same inputs, the global LSE and delta lane-broadcast as the ring's
    backward passes them: within 1e-5 of each gradient's norm per (batch
    row, head)."""
    q, k, v, do, lse, delta, lens = _inputs(11, KV_LENS[case])
    to_t = lambda t: jnp.asarray(t.transpose(1, 2).reshape(B * N, t.shape[1], D).numpy())  # noqa: E731
    lse_b = jnp.broadcast_to(jnp.asarray(lse.reshape(B * N, L).numpy())[..., None], (B * N, L, 128))
    delta_b = jnp.broadcast_to(jnp.asarray(delta.reshape(B * N, L).numpy())[..., None],
                               (B * N, L, 128))
    kv = np.full(B, L) if lens is None else lens.numpy()
    kv_bn = jnp.asarray(np.repeat(kv, N).astype(np.int32))
    got = flash_bwd_core(to_t(q), to_t(k), to_t(v), to_t(do), lse_b, delta_b, kv_bn,
                         scale=SCALE, block_q=128, block_k=128, interpret=True)
    ref = flash_bwd_plain(q, k, v, do, lse, delta, lens, SCALE)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g = torch.tensor(np.asarray(g)).reshape(B, N, L, D).transpose(1, 2)
        assert float(_grad_rel(g, r).max()) <= TOL, name
