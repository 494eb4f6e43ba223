"""The f32 flash backward kernels' arithmetic, emulated on the CPU.

`csrc/flash_train_f32.cu` (rows 4 and 5 on f32 operands) takes f32-accurate
products on the TF32 tensor cores by the three-product split of
`ring_step_f32.cu`: x = hi + lo with hi = tf32(x) and lo = tf32(x − hi),
both rounded to nearest, and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi. Here
the kernels' arithmetic runs in torch: the split on int32 views; the tile
order (dq walks 32-key tiles, dk/dv 32-row q tiles); each product's k8 steps
with the tensor cores' accumulator, whose sum is rounded toward zero at every
step; p = exp2(s·scale·log2e − LSE·log2e) and ds = p·(dp − delta)·scale in
f32, split before their products; each tile's product folded into the f32
gradient by a rounded add; and the data flow between the two consumer
warpgroups: the gradients folded transposed (Gᵀ += Xᵀ·Yᵀ), dq's two half-D
folds from one shared ds, dk/dv's pᵀ handed from one consumer to the other
as hi + lo (the one-warpgroup form, ds as A and the tile transposed as B,
beside it). The result is held to `flash_bwd_plain` on the same f32 inputs
within 1e-5 of each gradient's norm per (batch row, head), with and without
kv_lens, the card's limit; one TF32 pass per product misses it, and so does
a gradient carried through the accumulator over an SFT batch's 2,048 q rows
instead of folded per tile; the fold's order (two-buffer quarters, quarters
in turn, all columns at once) leaves the bits. The index maps the kernels
rely on are checked against the 128-byte swizzle as wgmma reads it: the
K-major tiles, the streamed tile split in place by the producer warps, the
stationary tile split into A fragments and its lo tile, the streamed tile
read transposed into A fragments, the accumulator written as a B panel, the
consumers' swap slots and transposed stores, and (the one-warpgroup form)
the transposed panels and the accumulator entries that become A fragments.
`flash_bwd_plain` on f32 is held in turn to JAX's `flash_bwd_core` in
interpret mode on the same inputs. Inputs are seeded numpy normals at
[2, 256, 2, 128].
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


def fold_two_buffers(acc, x, bt, products):
    """acc [..., M, C] (f64 holding f32) += x·bt to f32 accuracy (x [..., M,
    K], bt [..., K, C]), 32 columns (a quarter) at a time in the kernels'
    order: quarter c + 1's product, from zero, goes into the other of two
    buffers before quarter c's rounded add, which reads the buffer quarter c
    left."""
    cols = torch.arange(acc.shape[-1])
    quarters = [cols[i:i + 32] for i in range(0, len(cols), 32)]
    buf = [None, None]
    for c in range(len(quarters) + 1):
        if c < len(quarters):
            buf[c % 2] = (c, tc_product(mm3(x, bt[..., quarters[c]], products)))
        if c > 0:
            qc, pv = buf[(c - 1) % 2]
            assert qc == c - 1, "a buffer was reissued before its add"
            sl = quarters[c - 1]
            acc[..., sl] = (acc[..., sl] + pv).float().double()
    return acc


def fold_tile(acc, x, bt, products):
    """acc [..., M, C] (f64 holding f32) += x·bt to f32 accuracy, the
    kernels' fold: the tile's product from zero over all C columns at once
    (m64n64k8 steps), added by a rounded add."""
    return (acc + tc_product(mm3(x, bt, products))).float().double()


def emulated_bwd(q, k, v, do, lse, delta, kv_lens=None, products=3, fold=True, flow="ws"):
    """(dq, dk, dv) f32 as the two kernels compute them. `fold` False carries
    each gradient through the accumulator over all tiles instead. `flow`
    "ws" is the warp-specialised kernels' data flow: each gradient folded
    transposed, Gᵀ (D x rows) += Xᵀ·Yᵀ with A = Xᵀ the split streamed tile
    read transposed (kᵀ; dOᵀ, qᵀ) and B = ds or pᵀ, dsᵀ split into a K-major
    panel, two blocks of 64 D rows, each tile's product from zero
    (`fold_tile`); in dq one warpgroup forms p
    from s and the other dp, they swap them and both form the same ds, each
    folding its 64 D rows; in dk/dv one forms pᵀ, writes it split and folds
    dvᵀ, the other reads it back as hi + lo, forms dsᵀ and folds dkᵀ. "one"
    is the one-warpgroup form: ds (p, dsᵀ) as the A fragments, the tile
    transposed as B, all 128 columns at once."""
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
            if flow == "ws":  # p (warpgroup Q) and dp (O) swapped; each forms ds
                ds_q = p * (dp.clone() - dl[..., None]) * scale
                ds_o = p.clone() * (dp - dl[..., None]) * scale
                assert torch.equal(ds_q, ds_o)
                for half, ds in enumerate((ds_q, ds_o)):  # dqᵀ += kᵀ·dsᵀ, 64 D rows each
                    dr = slice(64 * half, 64 * half + 64)
                    acc[..., dr] = fold_tile(
                        acc[..., dr].transpose(1, 2), kt[..., dr].transpose(1, 2),
                        ds.transpose(1, 2), products).transpose(1, 2)
                continue
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
            if flow == "ws":  # V writes pᵀ split; K reads it back as hi + lo, forms dsᵀ
                p_hi, p_lo = split(p)
                dst = (p_hi + p_lo) * (dpt - dlt) * scale
                for dr in (slice(0, 64), slice(64, 128)):  # dvᵀ += dOᵀ·p, dkᵀ += qᵀ·ds
                    acc_v[..., dr] = fold_tile(
                        acc_v[..., dr].transpose(1, 2), dot[..., dr].transpose(1, 2),
                        p.transpose(1, 2), products).transpose(1, 2)
                    acc_k[..., dr] = fold_tile(
                        acc_k[..., dr].transpose(1, 2), qt[..., dr].transpose(1, 2),
                        dst.transpose(1, 2), products).transpose(1, 2)
                continue
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


@pytest.mark.parametrize("flow", ["one", "ws"])
@pytest.mark.parametrize("case", sorted(KV_LENS))
def test_three_products_hold_f32(case, flow):
    err = _errors(case, flow=flow)
    assert max(err.values()) <= TOL, err


@pytest.mark.parametrize("flow", ["one", "ws"])
@pytest.mark.parametrize("case", ["none", "ragged"])
def test_one_tf32_pass_misses_f32(case, flow):
    """One TF32 product per matmul (~2^-11 per operand) is far off."""
    err = _errors(case, products=1, flow=flow)
    assert min(err.values()) > 20 * TOL, err


@pytest.mark.parametrize("case", ["none", "ragged"])
def test_warp_specialised_flow_matches_one_warpgroup(case):
    """The two warpgroups' data flow (dq's half-D folds from one shared ds,
    dk/dv's pᵀ handed over as hi + lo, every fold transposed) against the
    one-warpgroup form: the same
    products, the same per-tile folds, each gradient within 1e-6 of its norm
    per (batch row, head). They differ in the order of the three terms
    within a fold (A and B swap roles) and in K's p = hi + lo (2^-22 of p)."""
    q, k, v, do, lse, delta, _ = _inputs(13, KV_LENS[case])
    ws = emulated_bwd(q, k, v, do, lse, delta, KV_LENS[case], flow="ws")
    one = emulated_bwd(q, k, v, do, lse, delta, KV_LENS[case], flow="one")
    for g, r in zip(ws, one):
        assert float(_grad_rel(g, r).max()) <= 1e-6


@pytest.mark.parametrize("flow", ["one", "ws"])
def test_zero_rows_past_kv_len_and_without_keys(flow):
    """dk/dv rows past kv_len and the dq of a batch row without keys are
    exactly zero in the emulation, as the kernels write them."""
    q, k, v, do, lse, delta, lens = _inputs(3, KV_LENS["empty_row"])
    dq, dk, dv = emulated_bwd(q, k, v, do, lse, delta, KV_LENS["empty_row"], flow=flow)
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
    q, k, v, do, lse, delta, lens = _inputs(3, KV_LENS["ragged"])
    _, dk, dv = emulated_bwd(q, k, v, do, lse, delta, KV_LENS["ragged"], flow=flow)
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


def staging_visits(who: str) -> list:
    """The (row, 16-byte chunk) pairs of a 32-row streamed tile that its
    staging threads visit: "block" the one-warpgroup form's transposed
    staging (all 128 threads, a lane a row, warp w the chunks w, w + 4, ...),
    "producer" split_rows (producer warps 1-3, a lane a row, warp w − 1 the
    chunks w − 1, w + 2, ...)."""
    warps = 4 if who == "block" else 3
    return [(lane, c) for w in range(warps) for lane in range(TILE)
            for c in range(w, D // 4, warps)]


def test_transposed_panels_are_what_wgmma_reads():
    """A 32-row tile staged transposed (kᵀ in dq, qᵀ and dOᵀ in dk/dv, the
    one-warpgroup form's B operand of the gradient products) by the staging
    threads' visits (each (row, chunk) once, a warp's stores to one panel row
    on 32 banks) read back as that B operand, quarter qt of the 128 columns
    at a time: position p of column d holds the tile's row key_at(p)."""
    tile = np.random.default_rng(1).standard_normal((TILE, D)).astype(np.float32)
    buf = np.full(TILE * D, np.nan, dtype=np.float32)
    visits = staging_visits("block")
    assert sorted(visits) == [(r, c) for r in range(TILE) for c in range(D // 4)]
    for key, c in visits:
        for d in range(4 * c, 4 * c + 4):
            buf[swz128(d, key_pos(key)) // 4] = tile[key, d]
    for c in range(D // 4):  # one warp's store: element e of chunk c, lanes 0..31
        for e in range(4):
            banks = {(swz128(4 * c + e, key_pos(lane)) // 4) % 32 for lane in range(TILE)}
            assert len(banks) == 32
    for qt in range(4):
        got = wgmma_reads(buf, qt * 32 * 128, 0, 32, TILE)  # [32 columns of d, 32 positions]
        want = tile[PERM][:, 32 * qt:32 * qt + 32].T
        assert np.array_equal(got, want)


def test_key_permutation_is_a_bijection():
    assert sorted(PERM) == list(range(TILE))
    assert all(key_pos(key_at(p)) == p for p in range(TILE))


def test_accumulator_entries_are_the_gradient_fragments():
    """For every lane and k8 step of a gradient product in the one-warpgroup
    form (and of ring_step_f32.cu's P·V): the 64 x 32 accumulator entry put
    in A slot e (i = 4kk + 2(e & 1) + (e >> 1))
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


def test_in_place_split_of_the_streamed_tile():
    """split_rows: TMA's raw rows of a 32-row tile (rows past n as zeros, the
    keys past kv_len) split in place, hi over the raw rows and lo beside it,
    by the producer warps' visits: both tiles read back through the
    descriptors as the tile's tf32 hi and lo."""
    rng = np.random.default_rng(2)
    tile = rng.standard_normal((TILE, D)).astype(np.float32)
    n = 21
    hi_slot = np.full(TILE * D, np.nan, dtype=np.float32)
    lo_slot = np.full(TILE * D, np.nan, dtype=np.float32)
    for r in range(TILE):  # TMA's write
        for c in range(D // 4):
            o = kmajor_off(TILE, r, c) // 4
            hi_slot[o:o + 4] = tile[r, 4 * c:4 * c + 4]
    for r, c in staging_visits("producer"):
        o = kmajor_off(TILE, r, c) // 4
        x = torch.tensor(hi_slot[o:o + 4] if r < n else np.zeros(4, np.float32))
        h, l_ = split(x)
        hi_slot[o:o + 4], lo_slot[o:o + 4] = h.numpy(), l_.numpy()
    want_hi, want_lo = split(torch.tensor(tile) * (torch.arange(TILE) < n)[:, None])
    assert np.array_equal(wgmma_reads(hi_slot, 0, TILE * 128, TILE, D), want_hi.numpy())
    assert np.array_equal(wgmma_reads(lo_slot, 0, TILE * 128, TILE, D), want_lo.numpy())


def test_stationary_split_is_the_a_fragments_and_the_lo_tile():
    """split_stationary: each consumer thread's share of the 64-row
    stationary tile (rows past n as zeros): hi into the A fragments of the
    16 k8 steps (a[kk][e]: row 16w + g + 8(e & 1), column 8kk + t + 4(e >> 1),
    the tf32 register layout), lo back in place. Every element is taken
    once; the fragments assemble to the tile's hi and the tile reads back
    through the descriptors as its lo."""
    rng = np.random.default_rng(4)
    tile = rng.standard_normal((ROWS, D)).astype(np.float32)
    n = 50
    buf = np.full(ROWS * D, np.nan, dtype=np.float32)
    for r in range(ROWS):
        for c in range(D // 4):
            o = kmajor_off(ROWS, r, c) // 4
            buf[o:o + 4] = tile[r, 4 * c:4 * c + 4]
    a_hi = np.full((ROWS, D), np.nan, dtype=np.float32)
    taken = set()
    for w in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            r0 = 16 * w + g
            for kk in range(16):
                for e in range(4):
                    r, c = r0 + 8 * (e & 1), 8 * (kk & 3) + t + 4 * (e >> 1)
                    o = ((kk >> 2) * ROWS * 128 + swz128(r, c)) // 4
                    h, l_ = split(torch.tensor([buf[o] if r < n else 0.0], dtype=torch.float32))
                    a_hi[r, 8 * kk + (c - 8 * (kk & 3))] = h.item()  # row r, k index of step kk
                    buf[o] = l_.item()
                    taken.add((r, 8 * kk + (c - 8 * (kk & 3))))
    assert len(taken) == ROWS * D
    want_hi, want_lo = split(torch.tensor(tile) * (torch.arange(ROWS) < n)[:, None])
    assert np.array_equal(a_hi, want_hi.numpy())
    assert np.array_equal(wgmma_reads(buf, 0, ROWS * 128, ROWS, D), want_lo.numpy())


def test_swap_slots_pair_the_same_entries():
    """The consumers' swap of p and dp (dq) or pᵀ (dk/dv): entry i of thread t
    at word i·128 + t of a 64 x 32 buffer, the same (row, column) of the
    tile in both warpgroups; every word written once, and a warp's 32 words
    for one entry on 32 banks."""
    slots = {}
    for t in range(128):
        w, lane = divmod(t, 32)
        for i in range(16):
            at = (16 * w + lane // 4 + 8 * ((i >> 1) & 1), 8 * (i // 4) + 2 * (lane % 4) + (i & 1))
            slots[i * 128 + t] = at
    assert sorted(slots) == list(range(ROWS * TILE))
    assert len(set(slots.values())) == ROWS * TILE
    for i in range(16):
        for w in range(4):
            assert len({(i * 128 + 32 * w + lane) % 32 for lane in range(32)}) == 32


def test_transposed_fragments_are_the_a_operand():
    """frags_t: the A fragments of a fold over a split 32-row streamed tile X
    (K-major, as split_rows leaves it) read transposed, A = Xᵀ: slot e of k8
    step kk of a thread with rows d0, d0 + 8 (d0 = 64·block + 16w + g) is
    X[8kk + t + 4(e >> 1)][d0 + 8(e & 1)], at panel d0 / 32, swz128(row,
    column % 32). Every element of each 64-row block of Xᵀ is taken once."""
    tile = np.random.default_rng(6).standard_normal((TILE, D)).astype(np.float32)
    buf = np.full(TILE * D, np.nan, dtype=np.float32)
    for r in range(TILE):
        for c in range(D // 4):
            o = kmajor_off(TILE, r, c) // 4
            buf[o:o + 4] = tile[r, 4 * c:4 * c + 4]
    for block in range(2):
        at = np.full((64, TILE), np.nan, dtype=np.float32)  # Xᵀ rows 64·block..
        for w in range(4):
            for lane in range(32):
                g, t = divmod(lane, 4)
                d0 = 64 * block + 16 * w + g
                for kk in range(4):
                    for e in range(4):
                        row, col = 8 * kk + t + 4 * (e >> 1), d0 + 8 * (e & 1)
                        word = ((d0 >> 5) * TILE * 128 + swz128(row, col & 31)) // 4
                        assert np.isnan(at[col - 64 * block, row])
                        at[col - 64 * block, row] = buf[word]  # A[m = d][k = tile row]
        assert np.array_equal(at, tile[:, 64 * block:64 * block + 64].T)


def test_accumulator_panel_is_the_b_operand():
    """put_split / the dq swap: entry i of a 64 x 32 accumulator (row r0 +
    8((i >> 1) & 1), column 8(i / 4) + 2t + (i & 1)) written at entry_off =
    swz128(row, column) of a K-major 64 x 32 panel, read back through the
    descriptors a fold steps, quarter c (32 rows) from c·4 KiB: B[n][k] is
    the accumulator's row 32c + n, column k."""
    acc = np.random.default_rng(8).standard_normal((ROWS, TILE)).astype(np.float32)
    buf = np.full(ROWS * TILE, np.nan, dtype=np.float32)
    for w in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            r0 = 16 * w + g
            for i in range(16):
                row, col = r0 + 8 * ((i >> 1) & 1), 8 * (i // 4) + 2 * t + (i & 1)
                o = swz128(row, col) // 4
                assert np.isnan(buf[o])
                buf[o] = acc[row, col]
    for c in range(2):
        assert np.array_equal(wgmma_reads(buf, c * 32 * 128, 0, 32, TILE), acc[32 * c:32 * c + 32])


def test_transposed_accumulators_store_each_gradient_element_once():
    """store_t: the fold's accumulators of Gᵀ (entry 16c + i: column d0 +
    8((i >> 1) & 1) of G, row 32c + 8(i / 4) + 2t + (i & 1)) written as G's
    rows; dq's two consumers (d0 = 64·cw + 16w + g) and a dk/dv consumer's two
    blocks (d0 = 64·block + 16w + g) each cover the block's 64 x 128
    gradient once."""
    cells = []
    for half in range(2):  # a dq consumer, or a dk/dv consumer's block
        for t_ in range(128):
            w, lane = divmod(t_, 32)
            d0 = 64 * half + 16 * w + lane // 4
            for i in range(32):
                row = 32 * (i // 16) + 8 * ((i % 16) // 4) + 2 * (lane % 4) + (i & 1)
                cells.append((row, d0 + 8 * ((i >> 1) & 1)))
    assert sorted(cells) == [(r, c) for r in range(ROWS) for c in range(D)]


@pytest.mark.parametrize("quarters", [2, 4])
def test_fold_order_leaves_the_bits(quarters):
    """A fold in quarters of 32 columns issued through two buffers (quarter
    c + 1 before quarter c's rounded add; the timed two-buffer variant),
    the quarters one after the other, and the kept fold over all the columns
    at once (m64n64k8) give the same bits: each column takes the same
    products and the same add."""
    rng = np.random.default_rng(quarters)
    x = torch.tensor(rng.standard_normal((ROWS, TILE)).astype(np.float32))
    bt = torch.tensor(rng.standard_normal((TILE, 32 * quarters)).astype(np.float32))
    acc0 = torch.tensor(rng.standard_normal((ROWS, 32 * quarters))).float().double()
    got = fold_two_buffers(acc0.clone(), x, bt, 3)
    want = acc0.clone()
    for c in range(quarters):
        sl = slice(32 * c, 32 * c + 32)
        want[:, sl] = (want[:, sl] + tc_product(mm3(x, bt[:, sl], 3))).float().double()
    assert torch.equal(got, want)
    assert torch.equal(fold_tile(acc0.clone(), x, bt, 3), want)


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
