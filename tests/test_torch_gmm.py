"""The port's grouped matrix products (ops/gmm.py: `gmm`, row 9; `tgmm`, row
9b; `GroupedMatmul`, megablox's VJP) against the JAX package's, on the CPU.

The JAX references: `jax.lax.ragged_dot` (the JAX MoE's default path) at any
row count, and megablox's own kernels (`gmm`, `gmm(transpose_rhs=True)`,
`tgmm`, which the JAX MoE reaches with moe_impl="megablox") run in
interpret mode at an 8-row tile, where the row count is a multiple of 8 and
the group sizes sum to it (megablox raises otherwise, and leaves the rows
past the sum unwritten). Inputs are made from a numpy seed.

Tolerances, of each output row's (tgmm: each group's block's) largest
|reference|: f32 within 1e-5 (the same f32 products summed in another
order); bf16 within 1 bf16 ulp (both round an f32 sum once, and the sums may
differ in their last f32 bits). Rows past the group sum are exactly zero.
The MoE's gradients (GroupedMatmul's backward through `moe`) within 1e-4 of
scale of `jax.grad` of the JAX `_moe` (ragged) at f32: the router's softmax
and SwiGLU carry the products' rounding through two more layers.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_qwen3vl_tiny import build, scale_err, tiny_config

from omnivideo_tpu.models.qwen3vl import text_model as jtext
from omnivideo_tpu_torch.models.qwen3vl import text_model as ptext
from omnivideo_tpu_torch.ops.gmm import (
    BLOCK_SMEM,
    CLUSTER_FILL,
    DECODE_ROWS,
    MAX_SPLITS,
    SM_SMEM,
    SPLIT_LOAD_SLACK,
    SPLIT_TILES,
    WIDE_TILES,
    GroupedMatmul,
    _split_smem,
    _wide_smem,
    _wide_traffic,
    gmm,
    gmm_plain,
    gmm_schedule,
    resident_clusters,
    tgmm,
    tgmm_plain,
)
from omnivideo_tpu_torch.parallel.expert_shard import check_split

mb = importlib.import_module("jax.experimental.pallas.ops.tpu.megablox.gmm")

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32_TOL = 1e-5


def _draw(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of `dtype` (bf16:
    rounded once, by torch, and handed to JAX as those values)."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy(), jdt)


def _row_err(out: np.ndarray, ref: np.ndarray, dtype: str) -> float:
    """max |out − ref| over each row's largest |ref|, in the dtype's unit:
    f32 relative, bf16 in ulps (2^-7 of the row max's power of two)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    rmax = np.abs(ref).max(-1, keepdims=True)
    if dtype == "float32":
        return float((np.abs(out - ref) / np.maximum(rmax, 1e-30)).max())
    ulp = np.exp2(np.floor(np.log2(np.maximum(rmax, 2.0**-126))) - 7)
    return float((np.abs(out - ref) / ulp).max())


def _ok(err: float, dtype: str) -> bool:
    return err <= (F32_TOL if dtype == "float32" else 1.0)


# (m, group sizes): a ragged row count with an empty expert, one expert with
# every row, an expert boundary inside every 8-row tile, and sums below m
RAGGED = {
    "ragged_empty_expert": (74, [9, 0, 30, 13, 0, 22]),
    "one_expert_all_rows": (37, [0, 0, 37, 0]),
    "sum_below_m": (45, [7, 0, 20, 5]),
    "all_empty": (12, [0, 0, 0]),
}
EVEN = {  # m a multiple of 8 and the sizes summing to m: megablox's domain
    "eight_groups": (80, [13, 0, 27, 4, 9, 0, 16, 11]),
    "one_expert_all_rows": (40, [0, 40, 0, 0]),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(RAGGED) + [f"even_{c}" for c in EVEN])
def test_gmm_plain_matches_ragged_dot(case, dtype):
    m, sizes = RAGGED[case] if case in RAGGED else EVEN[case[5:]]
    E, k, n = len(sizes), 48, 24
    lhs, jl = _pair(_draw(1, m, k), dtype)
    rhs, jr = _pair(_draw(2, E, k, n), dtype)
    gs = torch.tensor(sizes, dtype=torch.int32)
    out = gmm_plain(lhs, rhs, gs)
    ref = np.asarray(jax.lax.ragged_dot(jl, jr, jnp.asarray(sizes, jnp.int32)), np.float32)
    total = sum(sizes)
    assert out.dtype == lhs.dtype and out.shape == (m, n)
    assert not np.any(ref[total:])
    assert torch.count_nonzero(out[total:]) == 0  # rows past the group sum
    if total:
        assert _ok(_row_err(out[:total].float().numpy(), ref[:total], dtype), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(EVEN))
@pytest.mark.parametrize("op", ["gmm", "gmm_transpose_rhs", "tgmm"])
def test_plain_twins_match_megablox(op, case, dtype):
    """Megablox's own Pallas kernels in interpret mode, tiling (8, k, n)."""
    m, sizes = EVEN[case]
    E, k, n = len(sizes), 48, 24
    gs_t, gs_j = torch.tensor(sizes, dtype=torch.int32), jnp.asarray(sizes, jnp.int32)
    jdt = DTYPES[dtype][1]
    lhs, jl = _pair(_draw(3, m, k), dtype)
    if op == "tgmm":
        rhs, jr = _pair(_draw(4, m, n), dtype)
        out = tgmm_plain(lhs, rhs, gs_t).float().numpy()
        ref = np.asarray(mb.tgmm(jl.T, jr, gs_j, jdt, (8, k, n), interpret=True), np.float32)
        assert out.shape == (E, k, n)
        for e in range(E):  # each group's block to its own max; an empty group is zero
            if sizes[e]:
                assert _ok(_row_err(out[e].reshape(1, -1), ref[e].reshape(1, -1), dtype), dtype)
            else:
                assert not np.any(out[e]) and not np.any(ref[e])
        return
    t = op == "gmm_transpose_rhs"
    rhs, jr = _pair(_draw(5, *((E, n, k) if t else (E, k, n))), dtype)
    out = gmm_plain(lhs, rhs, gs_t, transpose_rhs=t).float().numpy()
    ref = np.asarray(mb.gmm(jl, jr, gs_j, jdt, (8, k, n), transpose_rhs=t, interpret=True),
                     np.float32)
    assert _ok(_row_err(out, ref, dtype), dtype)


@pytest.mark.parametrize("case", list(RAGGED) + ["even_eight_groups"])
def test_grouped_matmul_gradients_match_jax(case):
    """GroupedMatmul's backward (gmm with the bank transposed, tgmm) against
    jax.grad of ragged_dot, f32; rows past the group sum get zero gradient."""
    m, sizes = RAGGED[case] if case in RAGGED else EVEN[case[5:]]
    E, k, n = len(sizes), 48, 24
    lhs_np, rhs_np, w_np = _draw(6, m, k), _draw(7, E, k, n), _draw(8, m, n)
    gs = jnp.asarray(sizes, jnp.int32)
    jl, jr = jax.grad(lambda a, b: jnp.sum(jax.lax.ragged_dot(a, b, gs) * w_np), (0, 1))(
        jnp.asarray(lhs_np), jnp.asarray(rhs_np))
    lhs = torch.from_numpy(lhs_np).requires_grad_(True)
    rhs = torch.from_numpy(rhs_np).requires_grad_(True)
    (GroupedMatmul.apply(lhs, rhs, torch.tensor(sizes, dtype=torch.int32))
     * torch.from_numpy(w_np)).sum().backward()
    assert torch.count_nonzero(lhs.grad[sum(sizes):]) == 0
    for got, ref in ((lhs.grad, jl), (rhs.grad, jr)):
        ref = np.asarray(ref)
        if np.any(ref):
            assert scale_err(got.numpy(), ref) <= F32_TOL
        else:
            assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("needs", [(True, False), (False, True)])
def test_grouped_matmul_backward_skips_unneeded_products(monkeypatch, needs):
    """Only the gradients that are asked for are computed: a frozen bank
    (LoRA) runs no tgmm, a leaf input runs no transposed gmm."""
    mod = importlib.import_module("omnivideo_tpu_torch.ops.gmm")
    calls = []
    monkeypatch.setattr(mod, "gmm_plain", lambda *a, **kw: calls.append("gmm") or gmm_plain(*a, **kw))
    monkeypatch.setattr(mod, "tgmm_plain", lambda *a: calls.append("tgmm") or tgmm_plain(*a))
    lhs = torch.from_numpy(_draw(9, 16, 8)).requires_grad_(needs[0])
    rhs = torch.from_numpy(_draw(10, 2, 8, 4)).requires_grad_(needs[1])
    GroupedMatmul.apply(lhs, rhs, torch.tensor([10, 6], dtype=torch.int32)).sum().backward()
    assert calls == ["gmm", "gmm" if needs[0] else "tgmm"]


def test_moe_gradients_match_jax_moe():
    """The port's `moe` under autograd (three GroupedMatmuls) against
    jax.grad of the JAX `_moe` (ragged) and of the port's `moe_dense`: the
    input's and each expert bank's gradient, f32."""
    cfg = tiny_config()
    params, jcfg, model = build(cfg)
    jp = jax.tree_util.tree_map(lambda a: a[1], params["text"]["layers"])["mlp"]
    mlp = model.language_model.layers[1].mlp
    x_np = _draw(11, 2, 29, cfg.text.hidden_size)
    w_np = _draw(12, 2, 29, cfg.text.hidden_size)

    def jloss(x, experts):
        return jnp.sum(jtext._moe({**jp, "experts": experts}, x, jcfg.text) * w_np)

    jx, je = jax.grad(jloss, (0, 1))(jnp.asarray(x_np), jp["experts"])
    grads = {}
    for name, fn in (("grouped", ptext.moe), ("dense", ptext.moe_dense)):
        mlp.zero_grad()
        x = torch.from_numpy(x_np).requires_grad_(True)
        (fn(mlp, x) * torch.from_numpy(w_np)).sum().backward()
        grads[name] = {"x": x.grad, "gate": mlp.experts_gate.grad.clone(),
                       "up": mlp.experts_up.grad.clone(), "down": mlp.experts_down.grad.clone()}
    ref = {"x": jx, **{k: je[k] for k in ("gate", "up", "down")}}
    for key, want in ref.items():
        assert scale_err(grads["grouped"][key].numpy(), np.asarray(want)) <= 1e-4, key
        assert scale_err(grads["grouped"][key].numpy(), grads["dense"][key].numpy()) <= 1e-4, key


def test_moe_runs_three_grouped_products_without_host_reads(monkeypatch):
    """`moe` runs gate, up and down as three grouped products over the whole
    banks, with the group sizes counted on the device (an int32 tensor, never
    a host list)."""
    cfg = tiny_config()
    _, _, model = build(cfg)
    mlp = model.language_model.layers[0].mlp
    seen = []

    class Spy:
        @staticmethod
        def apply(lhs, rhs, sizes):
            seen.append((rhs.data_ptr(), sizes.dtype, int(sizes.sum())))
            return GroupedMatmul.apply(lhs, rhs, sizes)

    monkeypatch.setattr(ptext, "GroupedMatmul", Spy)
    x = torch.from_numpy(_draw(13, 1, 11, cfg.text.hidden_size))
    with torch.inference_mode():
        ptext.moe(mlp, x)
    k = cfg.text.num_experts_per_tok
    assert seen == [(p.data_ptr(), torch.int32, 11 * k)
                    for p in (mlp.experts_gate, mlp.experts_up, mlp.experts_down)]


@pytest.mark.parametrize("op", ["gmm", "tgmm"])
def test_wrappers_take_the_plain_twin_only_on_the_cpu(op):
    """A tensor on any device but the CPU goes to the kernel's checks, never
    to the plain twin: on the meta device they refuse it."""
    lhs = torch.empty(16, 8, device="meta")
    gs = torch.tensor([8, 8], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        if op == "gmm":
            gmm(lhs, torch.empty(2, 8, 4, device="meta"), gs)
        else:
            tgmm(lhs, torch.empty(16, 4, device="meta"), gs)


def test_wrappers_check_shapes():
    lhs = torch.zeros(6, 8)
    with pytest.raises(ValueError, match="int32"):
        gmm(lhs, torch.zeros(2, 8, 4), torch.tensor([3, 3]))
    with pytest.raises(ValueError, match="do not fit"):
        gmm(lhs, torch.zeros(2, 8, 4), torch.tensor([3, 3], dtype=torch.int32),
            transpose_rhs=True)
    with pytest.raises(ValueError, match="rows"):
        tgmm(lhs, torch.zeros(5, 4), torch.tensor([3, 3], dtype=torch.int32))


H100_SMS = 132


def _split_option(m, k, n, E, tile, splits):
    """The split-k schedule at `splits` (made non-empty as gmm_schedule makes
    them): (k steps the busiest SM streams, a cluster needed, steps a block,
    blocks, stages), or None where a block takes no two stages (one where P
    is 1) or the card would not hold its clusters in one wave."""
    k_steps = -(-k // 64)
    steps = -(-k_steps // splits)
    splits = -(-k_steps // steps)
    blocks = splits * min(E, m) * -(-n // tile)
    per_sm = -(-blocks // H100_SMS)
    a_rows = -(-m // 8) * 8
    share = min(SM_SMEM // min(per_sm, 8) - 1024, BLOCK_SMEM)
    least = min(2, steps)
    stages = max((p for p in range(least, steps + 1)
                  if _split_smem(tile, p, a_rows, splits) <= share), default=least)
    smem = _split_smem(tile, stages, a_rows, splits)
    held = min(3, SM_SMEM // (smem + 1024))  # blocks an SM holds
    if smem > BLOCK_SMEM or (splits > 1 and blocks > CLUSTER_FILL * H100_SMS * held):
        return None
    return per_sm * steps, splits > 1, steps, blocks, stages


def _check_split_schedule(m, k, n, E):
    """The split-k schedule's rule (gmm_schedule's docstring): its tile
    leaves fewer than 64 columns past n; its splits within a cluster's
    portable size and the k steps, none of them empty; among the split
    counts that fit and whose clusters the card holds in one wave, its
    busiest SM within SPLIT_LOAD_SLACK of the lightest, and no such peer
    needs no cluster where it does, nor has fewer steps a block (or as few
    in fewer blocks); its stages every step of a block where the block's
    share of its SM's shared memory holds them, else as many as it holds,
    at least two."""
    sched = gmm_schedule(m, k, n, E, torch.bfloat16, H100_SMS)
    k_steps = -(-k // 64)
    assert sched.kind == "split_k" and sched.tile_n in SPLIT_TILES
    assert -n % sched.tile_n < 64
    assert 1 <= sched.splits <= min(MAX_SPLITS, k_steps)
    assert sched.steps * sched.splits >= k_steps > sched.steps * (sched.splits - 1)
    tiles = min(E, m) * -(-n // sched.tile_n)
    assert sched.blocks == sched.splits * tiles
    options = [o for s in range(1, min(MAX_SPLITS, k_steps) + 1)
               if (o := _split_option(m, k, n, E, sched.tile_n, s)) is not None]
    chosen = _split_option(m, k, n, E, sched.tile_n, sched.splits)
    lightest = min(o[0] for o in options)
    assert chosen is not None and chosen[0] <= SPLIT_LOAD_SLACK * lightest
    assert chosen[4] == sched.stages and min(2, sched.steps) <= sched.stages <= sched.steps
    for o in options:
        if o[0] <= SPLIT_LOAD_SLACK * lightest:
            assert o[1:4] >= chosen[1:4]
    return sched


@pytest.mark.parametrize("m,k,n,E", [(1, 2048, 768, 128), (8, 2048, 768, 128),
                                     (8, 768, 2048, 128), (64, 2048, 768, 128),
                                     (64, 768, 2048, 128), (8, 264, 200, 10), (3, 72, 40, 4),
                                     (8, 128, 64, 1024)])
def test_gmm_schedule_splits_k_at_few_rows(m, k, n, E):
    """bf16 at m <= DECODE_ROWS: the split-k kernel under its rule."""
    _check_split_schedule(m, k, n, E)


def test_gmm_schedule_at_the_decode():
    """The Qwen3-VL-30B-A3B decode (8 rows, top-8 of 128 experts) on 132 SMs:
    gate/up splits its 32 k steps 6 ways over 288 blocks (clusters of 6,
    which the card holds at once; 8 ways over 384 blocks would not fit one
    wave), 4 of each block's 6 steps in flight; down runs its 12 steps
    unsplit, no cluster, 128 blocks of 12 stages (one an SM)."""
    assert tuple(gmm_schedule(8, 2048, 768, 128, torch.bfloat16, H100_SMS)) == (
        "split_k", 6, 6, 288, 128, 4)
    assert tuple(gmm_schedule(8, 768, 2048, 128, torch.bfloat16, H100_SMS)) == (
        "split_k", 1, 12, 128, 128, 12)


def test_gmm_schedule_at_the_prefill():
    """Qwen3-VL-30B-A3B's prefill (11,848 rows) at 768 columns: gate/up
    takes 192-column tiles (four stages in flight against the 256-column
    tile's three), down (n = 2,048) 256-column tiles."""
    assert tuple(gmm_schedule(11848, 2048, 768, 128, torch.bfloat16, H100_SMS)) == (
        "wgmma", 0, 0, 0, 192, 4)
    assert tuple(gmm_schedule(11848, 768, 2048, 128, torch.bfloat16, H100_SMS)) == (
        "wgmma", 0, 0, 0, 256, 3)


def test_resident_clusters_only_for_split_k():
    """Only the split-k schedule launches clusters; asking for the others'
    is refused before anything reaches a card."""
    for m, dtype in ((11848, torch.bfloat16), (8, torch.float32)):
        with pytest.raises(ValueError, match="no clusters"):
            resident_clusters(m, gmm_schedule(m, 2048, 768, 128, dtype, H100_SMS))


VLM_FSDP_CARDS = (1, 2, 3, 4, 6, 8, 12)  # every n that check_split takes for 768 columns


@pytest.mark.parametrize("m", [11848, 8])
@pytest.mark.parametrize("proj", ["gate_up", "down"])
@pytest.mark.parametrize("cards", VLM_FSDP_CARDS)
def test_gmm_schedule_at_the_split_widths(cards, proj, m):
    """Qwen3-VL-30B-A3B's banks split over `--vlm_fsdp` cards (768 / n
    columns; gate/up [128, 2048, w], down [128, w, 2048]) at the prefill's
    11,848 rows and a decode step's 8: the tile computes at most one 64-
    column box past n (the many-row kernel: of WIDE_TILES with the fewest
    columns past n, the one with the least L2 traffic a byte in flight,
    the widest on a tie, as many stages as fit beside the staged outputs);
    the split-k schedule under its rule."""
    check_split(768, cards)
    w = 768 // cards
    k, n = (2048, w) if proj == "gate_up" else (w, 2048)
    if m <= DECODE_ROWS:
        _check_split_schedule(m, k, n, 128)
        return
    sched = gmm_schedule(m, k, n, 128, torch.bfloat16, H100_SMS)
    assert sched.kind == "wgmma" and sched.tile_n in WIDE_TILES
    assert -n % sched.tile_n <= 64
    least = [t for t in WIDE_TILES if -n % t == min(-n % u for u in WIDE_TILES)]
    assert sched.tile_n == min(least, key=lambda t: (_wide_traffic(m, k, n, 128, t), -t))
    assert _wide_smem(sched.tile_n, sched.stages) <= BLOCK_SMEM
    assert _wide_smem(sched.tile_n, sched.stages + 1) > BLOCK_SMEM


def test_gmm_schedule_at_the_split_widths_picks():
    """The picks at 2 and 4 cards: the prefill's gate/up at n = 384 and 192
    takes 192-column tiles (none past n) with 4 stages; down (n = 2048)
    256-column tiles; the decode's gate/up 8 splits of 4 steps over 192
    blocks, every step in flight (64-column tiles at n = 192); its down (k =
    384, 192) one split, no cluster, 128 blocks."""
    bf = torch.bfloat16
    assert tuple(gmm_schedule(11848, 2048, 384, 128, bf, H100_SMS)) == (
        "wgmma", 0, 0, 0, 192, 4)
    assert tuple(gmm_schedule(11848, 2048, 192, 128, bf, H100_SMS)) == (
        "wgmma", 0, 0, 0, 192, 4)
    assert gmm_schedule(11848, 384, 2048, 128, bf, H100_SMS).tile_n == 256
    assert tuple(gmm_schedule(8, 2048, 384, 128, bf, H100_SMS)) == ("split_k", 8, 4, 192, 128, 4)
    assert tuple(gmm_schedule(8, 2048, 192, 128, bf, H100_SMS)) == ("split_k", 8, 4, 192, 64, 4)
    assert tuple(gmm_schedule(8, 384, 2048, 128, bf, H100_SMS)) == ("split_k", 1, 6, 128, 128, 6)
    assert tuple(gmm_schedule(8, 192, 2048, 128, bf, H100_SMS)) == ("split_k", 1, 3, 128, 128, 3)


@pytest.mark.parametrize("m", [DECODE_ROWS + 1, 11848])
def test_gmm_schedule_many_rows_and_f32(m):
    """Past DECODE_ROWS bf16 runs the persistent wgmma kernel; f32 runs the
    TF32 kernel at any m; neither depends on anything but the static shape."""
    assert gmm_schedule(m, 2048, 768, 128, torch.bfloat16, H100_SMS).kind == "wgmma"
    for rows in (1, m):
        assert gmm_schedule(rows, 2048, 768, 128, torch.float32, H100_SMS).kind == "tf32"
