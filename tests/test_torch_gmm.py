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
    DECODE_ROWS,
    MAX_SPLITS,
    SPLIT_BLOCKS_PER_SM,
    GroupedMatmul,
    gmm,
    gmm_plain,
    gmm_schedule,
    tgmm,
    tgmm_plain,
)

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


@pytest.mark.parametrize("m,k,n,E", [(1, 2048, 768, 128), (8, 2048, 768, 128),
                                     (8, 768, 2048, 128), (64, 2048, 768, 128),
                                     (8, 264, 200, 10), (3, 72, 40, 4), (8, 128, 64, 1024)])
def test_gmm_schedule_splits_k_at_few_rows(m, k, n, E):
    """bf16 at m <= DECODE_ROWS: the split-k kernel, its splits within a
    cluster's portable size and the k steps, none of them empty, and its
    blocks within one wave of SPLIT_BLOCKS_PER_SM an SM unless one split
    alone is more."""
    sched = gmm_schedule(m, k, n, E, torch.bfloat16, H100_SMS)
    k_steps = -(-k // 64)
    tiles = min(E, m) * -(-n // 128)
    assert sched.kind == "split_k"
    assert 1 <= sched.splits <= min(MAX_SPLITS, k_steps)
    assert sched.steps * sched.splits >= k_steps > sched.steps * (sched.splits - 1)
    assert sched.blocks == sched.splits * tiles
    assert sched.blocks <= max(tiles, SPLIT_BLOCKS_PER_SM * H100_SMS)


def test_gmm_schedule_at_the_decode():
    """The Qwen3-VL-30B-A3B decode (8 rows, top-8 of 128 experts) on 132 SMs:
    gate/up splits its 32 k steps 8 ways, down its 12 three ways; both fill
    384 of the 396 block slots."""
    assert tuple(gmm_schedule(8, 2048, 768, 128, torch.bfloat16, H100_SMS)) == (
        "split_k", 8, 4, 384)
    assert tuple(gmm_schedule(8, 768, 2048, 128, torch.bfloat16, H100_SMS)) == (
        "split_k", 3, 4, 384)


@pytest.mark.parametrize("m", [DECODE_ROWS + 1, 11848])
def test_gmm_schedule_many_rows_and_f32(m):
    """Past DECODE_ROWS bf16 runs the persistent wgmma kernel; f32 runs the
    TF32 kernel at any m; neither depends on anything but the static shape."""
    assert gmm_schedule(m, 2048, 768, 128, torch.bfloat16, H100_SMS).kind == "wgmma"
    for rows in (1, m):
        assert gmm_schedule(rows, 2048, 768, 128, torch.float32, H100_SMS).kind == "tf32"
