"""The f32 ring step kernel's arithmetic, emulated on the CPU.

`csrc/ring_step_f32.cu` takes f32-accurate products on the TF32 tensor cores
by a three-product split: x = hi + lo with hi = tf32(x) and lo = tf32(x − hi),
both rounded to nearest (ties away from zero) by bit arithmetic on the f32,
and a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi summed in f32. Here the same
arithmetic runs in torch on int32 views: q split after the pre-scaling, K
and V split, the online softmax over 32-key tiles, P split the same way and
P·V taken over the keys in the kernel's permuted order. It is held to
`ring_step_plain` on the same f32 inputs within 1e-5 of each output row's max
and the LSE within 1e-5, the card's tolerance (RING_F32_TOL), while one TF32
pass misses that limit by orders of magnitude: the record of why three
products are needed. With logits scaled ×8 the f32 plain twin itself is
~1.7e-5 off the exact step's LSE (|s| reaches ~55 in log2 units, where an
f32 ulp is 3.8e-6), so there both are held to an f64 step: the split no
further from it than twice the plain twin's own distance. Truncation (the
raw TMA tile as hi) holds the limit as well; the kernel rounds, so that no
operand depends on how the tensor cores read an f32's low 13 bits.

The tensor cores round their f32 accumulator toward zero at each k8 step.
An emulation of that shows why the kernel adds each tile's P·V to O by a
rounded FMA instead of carrying O through the accumulator: over 1,024 keys
the carried O drifts past the limit, the folded one stays at f32's level.

The register layouts the kernel relies on are checked too: the S
accumulator entries a thread holds become the P·V A fragment through the
kernel's index map, and the Vᵀ panels' key permutation pairs each p with
its own key's V row. Inputs are seeded numpy normals at [2, 256, 2, 128].
"""

import numpy as np
import pytest
import torch

from omnivideo_tpu_torch.ops.flash_attention import _qscale
from omnivideo_tpu_torch.ops.ring_attention import _visible, ring_carry, ring_finish, ring_step_plain

TOL = 1e-5  # of each output row's max |plain|, and |LSE − LSE_plain|: chip_smoke's RING_F32_TOL
KEYS = 32  # keys per K/V tile
B, L, N, D = 2, 256, 2, 128


def tf32(x: torch.Tensor, form: str) -> torch.Tensor:
    """x as a tf32 value held in an f32: rounded to nearest, ties away from
    zero ("round", the kernel's tf32_round), or truncated ("trunc")."""
    i = x.contiguous().view(torch.int32)
    if form == "round":
        i = i + 0x1000
    return (i & -8192).view(torch.float32)


def split(x: torch.Tensor, form: str):
    hi = tf32(x, form)
    return hi, tf32(x - hi, form)


def key_at(pos: int) -> int:
    """The key a Vᵀ panel holds at position `pos` of a 32-key tile: position
    t of each group of 8 holds key 2t, position t + 4 key 2t + 1."""
    g, u = divmod(pos, 8)
    return 8 * g + 2 * (u % 4) + u // 4


def pos_of(key: int) -> int:
    """The kernel's prep_stage formula: (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2)."""
    return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2)


PERM = [key_at(p) for p in range(KEYS)]


def emulated_step(q, k, v, m, l, acc, step_lens=None, causal=None, my=0, src=0, n=1,
                  softmax_scale=None, form="round", products=3):
    """One ring step as the kernel computes it (products 3), or with one tf32
    product per matmul (products 1). Returns the new (m, l, acc)."""
    Lq, Lk = q.shape[1], k.shape[1]
    c = _qscale(softmax_scale if softmax_scale is not None else D**-0.5)
    q_hi, q_lo = split(q * c, form)
    k_hi, k_lo = split(k, form)
    vis = _visible(causal, Lq, Lk, my, src, n, q.device)
    live = torch.ones(B, Lk, dtype=torch.bool)
    if step_lens is not None:
        live = torch.arange(Lk)[None, :] < step_lens[:, None]
    v_hi, v_lo = split(torch.where(live[..., None, None], v, 0.0), form)
    m, l, acc = (t.clone() for t in (m, l, acc))

    def mm(eq, a_hi, a_lo, b_hi, b_lo):
        if products == 1:
            return torch.einsum(eq, a_hi, b_hi)
        return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
                + torch.einsum(eq, a_hi, b_hi))

    for kv0 in range(0, Lk, KEYS):
        sl = slice(kv0, kv0 + KEYS)
        s = mm("bind,bjnd->bnij", q_hi, q_lo, k_hi[:, sl], k_lo[:, sl])
        mask = ~live[:, None, None, sl]
        if vis is False:
            mask = mask | True
        elif vis is not True:
            mask = mask | ~vis[None, None, :, sl]
        s = s.masked_fill(mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p_hi, p_lo = split(p, form)
        perm = [kv0 + j for j in PERM]  # the Vᵀ panels' key order, P's fragments in step
        pv = mm("bnij,bjnd->bind", p_hi[..., PERM], p_lo[..., PERM], v_hi[:, perm], v_lo[:, perm])
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    return m, l, acc


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((B, L, N, D)).astype(np.float32)) for _ in range(5)]


def _carried(q, k0, v0):
    """A carry that is not empty: the plain step over other keys first."""
    return ring_step_plain(q, k0, v0, *ring_carry(B, L, N, D, "cpu"))


CASES = {  # name: ring_step keywords
    "none": dict(my=0, src=1, n=4),
    "token": dict(causal="token", my=1, src=1, n=4),
    "stripe": dict(causal="stripe", my=1, src=2, n=4),
    "zigzag": dict(causal="zigzag", my=1, src=2, n=4),  # only the second chunk's rows see keys
    "step_lens": dict(step_lens=torch.tensor([200, 37], dtype=torch.int32), my=0, src=3, n=4),
}


def step_f64(q, k, v, m, l, acc, step_lens=None, causal=None, my=0, src=0, n=1,
             softmax_scale=None):
    """The exact step: q·scale·log2e rounded to f32 as both versions take it,
    everything after it in f64."""
    Lq, Lk = q.shape[1], k.shape[1]
    c = _qscale(softmax_scale if softmax_scale is not None else D**-0.5)
    s = torch.einsum("bind,bjnd->bnij", (q * c).double(), k.double())
    vis = _visible(causal, Lq, Lk, my, src, n, q.device)
    if step_lens is not None:
        s = s.masked_fill(~(torch.arange(Lk)[None, :] < step_lens[:, None])[:, None, None],
                          float("-inf"))
    if vis is not True:
        s = s.masked_fill(~torch.as_tensor(vis)[None, None], float("-inf"))
    m, l, acc = m.double(), l.double(), acc.double()
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(s - m_new[..., None])
    return (m_new, l * alpha + p.sum(-1),
            acc * alpha.transpose(1, 2)[..., None] + torch.einsum("bnij,bjnd->bind", p, v.double()))


def _errors(case: str, seed: int, against: str = "plain", **kw):
    """{version: (worst |o − o_ref| / row max, worst |LSE − LSE_ref|)} of one
    step, against the f32 plain twin or the exact f64 step."""
    q, k, v, k0, v0 = _inputs(seed)
    carry = _carried(q, k0, v0)
    args = {**CASES[case], **kw}
    form, products = args.pop("form", "round"), args.pop("products", 3)
    runs = {"split": emulated_step(q, k, v, *carry, form=form, products=products, **args),
            "plain": ring_step_plain(q, k, v, *carry, **args)}
    ref = step_f64(q, k, v, *carry, **args) if against == "f64" else runs.pop("plain")
    o_r, lse_r = ring_finish(*ref, ref[2].dtype, return_lse=True)
    scale = o_r.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    out = {}
    for name, run in runs.items():
        o, lse = ring_finish(*run, torch.float32, return_lse=True)
        out[name] = (float(((o.double() - o_r).abs() / scale).max()),
                     float((lse.double() - lse_r).abs().max()))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_products_hold_f32(case):
    rel, lse = _errors(case, 7)["split"]
    assert rel <= TOL and lse <= TOL, (rel, lse)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("logit_scale", [1.0, 8.0])
def test_three_products_as_close_to_exact_as_f32(case, logit_scale):
    """The margin: against the exact step the split is no further than twice
    the f32 plain twin's own distance, at the card's logits and ×8."""
    err = _errors(case, 7, against="f64", softmax_scale=logit_scale * D**-0.5)
    (rel, lse), (rel_p, lse_p) = err["split"], err["plain"]
    assert rel <= 2 * rel_p and lse <= 2 * lse_p, err


@pytest.mark.parametrize("case", ["none", "token"])
def test_truncated_hi_also_holds_f32(case):
    """hi as the raw tile (the tensor cores read 19 bits): within the limit too."""
    rel, lse = _errors(case, 11, form="trunc")["split"]
    assert rel <= TOL and lse <= TOL, (rel, lse)


@pytest.mark.parametrize("case", ["none", "token"])
def test_one_tf32_pass_misses_f32(case):
    """One TF32 product per matmul (~2^-11 per operand) is ~1e-3 off."""
    rel, _ = _errors(case, 7, products=1)["split"]
    assert rel > 20 * TOL, rel


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 values rounded to f32 toward zero (kept as f64)."""
    y = x.float()
    y = torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)
    return y.double()


def test_accumulator_rounding_needs_the_per_tile_fold():
    """P·V over 1,024 keys (one head, 256 rows, every key visible) with the
    tensor cores' accumulator emulated: the 8 products of a k8 step and the
    accumulator summed exactly, then rounded toward zero. O carried through
    the accumulator over all 32 tiles (12 steps each) drifts past the limit;
    each tile's product from zero, added to O by a rounded FMA, stays within
    it. The logits are taken exactly here: the point is the accumulation."""
    rng = np.random.default_rng(3)
    Lq, Lk = 256, 1024
    q, k, v = (torch.tensor(rng.standard_normal((L_, D)).astype(np.float32))
               for L_ in (Lq, Lk, Lk))
    s = (q * _qscale(D**-0.5)).double() @ k.double().T
    exact = torch.exp2(s - s.amax(-1, keepdim=True)) @ v.double()
    v_hi, v_lo = (t.double() for t in split(v, "round"))
    carried = torch.zeros(Lq, D, dtype=torch.float64)
    folded = torch.zeros(Lq, D, dtype=torch.float64)
    m = torch.full((Lq,), -1e30, dtype=torch.float64)
    for kv0 in range(0, Lk, KEYS):
        st = s[:, kv0:kv0 + KEYS]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp2(m - m_new).float().double()[:, None]
        p_hi, p_lo = (t.double() for t in split(torch.exp2(st - m_new[:, None]).float(), "round"))
        carried = (carried * alpha).float().double()
        tile = torch.zeros(Lq, D, dtype=torch.float64)
        for a, b in ((p_lo, v_hi), (p_hi, v_lo), (p_hi, v_hi)):
            for k8 in range(0, KEYS, 8):
                step = a[:, k8:k8 + 8] @ b[kv0 + k8:kv0 + k8 + 8]
                carried = _toward_zero(carried + step)
                tile = _toward_zero(tile + step)
        folded = (folded * alpha + tile).float().double()
        m = m_new
    exact = exact * torch.exp2(s.amax(-1, keepdim=True) - m[:, None])
    scale = exact.abs().amax(-1, keepdim=True)
    drift = float(((carried - exact).abs() / scale).max())
    fold = float(((folded - exact).abs() / scale).max())
    assert drift > TOL >= fold, (drift, fold)


def test_key_permutation_is_a_bijection():
    assert sorted(PERM) == list(range(KEYS))
    assert all(pos_of(key_at(p)) == p for p in range(KEYS))


def test_s_accumulator_feeds_the_pv_fragment():
    """For every lane and k8 step of P·V: the S entry the kernel puts in A
    slot e (i = 4kk + 2(e & 1) + (e >> 1)) sits in the A slot's row, and its
    key is the one the Vᵀ panel holds at the slot's k index. S (64 x 32, f32
    accumulator): entry i of lane λ is row 16w + λ/4 + 8((i >> 1) & 1),
    column 8(i / 4) + 2(λ % 4) + (i & 1). tf32 A (64 x 8): a0 (g, t), a1
    (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)."""
    for lane in range(32):
        g, t = divmod(lane, 4)
        for kk in range(KEYS // 8):
            for e in range(4):
                i = 4 * kk + ((e & 1) << 1) + (e >> 1)
                s_row, s_key = g + 8 * ((i >> 1) & 1), 8 * (i // 4) + 2 * t + (i & 1)
                a_row, a_k = g + 8 * (e & 1), t + 4 * (e >> 1)
                assert s_row == a_row
                assert key_at(8 * kk + a_k) == s_key
