"""Gradients through the port's sequence-parallel attention and DiT over 4
real gloo ranks (tests/torch_sp_workers.py), against JAX.

Attention: q/k/v gradients of sum(attn(q, k, v)·w) through
`ulysses_attention` (sp 4, with and without kv_lens), `ring_attention`
(sp 4: non-causal, "block" and "token" causality, and kv_lens whose batch
row 0 ends its last shard in all padding) and `hybrid_attention` (Ulysses 2
× ring 2, with and without kv_lens). The reference is the dense `jax.grad`
of einsum attention that tests/test_ring_pallas.py holds JAX's trainable
ring to (`ring_flash_attention_trainable` under the Mosaic interpreter
would cost more than the ~30 s this file may take). Where the ring carries
kv_lens, a query row past its batch row's length gets no gradient (the
JAX trainable ring's padded rows): the reference's output grad is zero on
those rows. Tolerance rtol 5e-4, atol 5e-5, as tests/test_parallel.py holds
JAX's Ulysses.

DiT: the tiny SP DiT's parameter grads of sum(v·w) (Ulysses, ring, hybrid;
seq_len padded 45 → 48), summed over the ranks as the trainer reduces
them, against JAX's `jax.grad` of the unsharded `wan_dit_apply`: within
1e-4 of each leaf's largest magnitude (f32 sums in another order). The
gathered output's backward hands each rank its own slice of the grad; a
reduce-scatter sum there would make every grad 4-fold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.wan_dit import init_wan_dit, wan_dit_apply
from omnivideo_tpu.ops.attention import attention_xla
from omnivideo_tpu_torch.io.jax_bridge import wan_params_to_state_dict
from torch_sp_workers import WORLD, load, spawn, sp_train_worker

B, L, N, D = 2, 64, 4, 16
LENS = np.array([48, 60], np.int32)  # row 0: the last of 4 shards is all padding
TOL = dict(rtol=5e-4, atol=5e-5)
DIT = dict(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=64, ffn_dim=128, freq_dim=32,
           text_dim=48, out_dim=4, num_heads=4, num_layers=2)
DIT_TOL = 1e-4
# case → (causal, kv_lens, the padded query rows get no gradient)
CASES = {"ulysses": (None, False, False), "ulysses_lens": (None, True, False),
         "ring": (None, False, False), "ring_block": ("block", False, False),
         "ring_token": ("token", False, False), "ring_lens": (None, True, True),
         "hybrid": (None, False, False), "hybrid_lens": (None, True, True)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_train")
    rng = np.random.default_rng(0)
    q, k, v, w = (rng.standard_normal((B, L, N, D)).astype(np.float32) for _ in range(4))
    np.savez(tmp / "grad_inputs.npz", q=q, k=k, v=v, w=w, lens=LENS)
    params = init_wan_dit(jax.random.PRNGKey(0), JaxDiTConfig(**DIT), dtype=jnp.float32)
    head = params["head"]["head"]
    head["kernel"] = jax.random.normal(jax.random.PRNGKey(9), head["kernel"].shape) * 0.05
    np.savez(tmp / "sd.npz", **wan_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                              params)))
    dit_in = dict(xp=rng.standard_normal((1, 4, 5, 6, 6)).astype(np.float32),
                  t=np.array([500.0], np.float32),
                  ctx=rng.standard_normal((1, 16, 48)).astype(np.float32),
                  w=rng.standard_normal((1, 4, 5, 6, 6)).astype(np.float32))
    np.savez(tmp / "inputs.npz", **dit_in)
    spawn(sp_train_worker, tmp, DIT)
    att = [load(tmp, f"grad_{r}") for r in range(WORLD)]
    dgrad = [load(tmp, f"dgrad_{r}") for r in range(WORLD)]
    return (q, k, v, w), att, params, dit_in, dgrad


def _dense_grads(q, k, v, w, causal, with_lens, row_grads_cut):
    """(out, dq, dk, dv) of sum(attention·w), dense, by jax.grad."""
    lens = jnp.asarray(LENS) if with_lens else None
    if row_grads_cut:
        w = w * (np.arange(L)[None, :, None, None] < LENS[:, None, None, None])

    def fwd(q, k, v):
        if causal is None:
            return attention_xla(q, k, v, kv_lens=lens)
        s = jnp.einsum("bind,bjnd->bnij", q, k) / np.sqrt(D)
        rows, cols = np.arange(L)[:, None], np.arange(L)[None, :]
        vis = cols <= rows if causal == "token" else cols // (L // WORLD) <= rows // (L // WORLD)
        s = jnp.where(vis[None, None], s, -1e30)
        return jnp.einsum("bnij,bjnd->bind", jax.nn.softmax(s, axis=-1), v)

    args = [jnp.asarray(t) for t in (q, k, v)]
    out = fwd(*args)
    grads = jax.grad(lambda *a: jnp.sum(fwd(*a) * w), argnums=(0, 1, 2))(*args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(CASES))
def test_sp_attention_grads_match_jax(run, case):
    (q, k, v, w), att, *_ = run
    order = range(WORLD)
    if case.startswith("hybrid"):  # rank → its global shard index
        order = np.argsort([int(r["hybrid_shard"]) for r in att])
    ref = _dense_grads(q, k, v, w, *CASES[case])
    for tag, r in zip(("out", "dq", "dk", "dv"), ref):
        got = np.concatenate([att[i][f"{case}_{tag}"] for i in order], axis=1)
        np.testing.assert_allclose(got, r, **TOL, err_msg=f"{case} {tag}")


_JAX_DIT = {}


def _jax_dit_grads(params, dit_in):
    if not _JAX_DIT:
        def loss(p):
            out = wan_dit_apply(p, JaxDiTConfig(**DIT), jnp.asarray(dit_in["xp"]),
                                jnp.asarray(dit_in["t"]), jnp.asarray(dit_in["ctx"]),
                                attn_impl="xla", seq_len=48)
            return jnp.sum(out * dit_in["w"])

        g = jax.grad(loss)(params)
        _JAX_DIT.update(wan_params_to_state_dict(jax.tree_util.tree_map(np.asarray, g)))
    return _JAX_DIT


@pytest.mark.parametrize("mode", ["single", "ulysses", "ring", "hybrid"])
def test_sp_dit_grads_match_jax(run, mode):
    *_, params, dit_in, dgrad = run
    ref = _jax_dit_grads(params, dit_in)
    for r in range(1, WORLD):  # the reduced grads are the same on every rank
        for n in ref:
            np.testing.assert_array_equal(dgrad[r][f"{mode}/{n}"], dgrad[0][f"{mode}/{n}"])
    worst = 0.0
    for n, g in ref.items():
        got = dgrad[0][f"{mode}/{n}"]
        g = np.asarray(g, np.float32).reshape(got.shape)
        scale = max(float(np.abs(g).max()), 1e-30)
        worst = max(worst, float(np.abs(got - g).max()) / scale)
        assert worst < DIT_TOL, (mode, n, worst)
    assert float(np.abs(ref["blocks.0.self_attn.q.weight"]).max()) > 1e-3  # grads reach the blocks
