"""The port's Ulysses, ring and hybrid attention over 4 real gloo ranks,
against the port's single-process `attention_plain` and the JAX package's
`ulysses_attention` / `ring_attention` / `hybrid_attention` on its virtual
CPU mesh, from the same numpy inputs; and the process-group bring-up's
flag and environment resolution (`init_process_group` mocked).

One spawn runs every case (tests/torch_sp_workers.py); each rank returns
its output shard. Tolerance: f32 throughout, 1e-5 absolute and relative:
the forms differ only in summation order and exp vs exp2.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from omnivideo_tpu.ops.attention import attention_xla
from omnivideo_tpu.parallel.mesh import create_mesh as jax_mesh
from omnivideo_tpu.parallel.ring import hybrid_attention as jax_hybrid
from omnivideo_tpu.parallel.ring import ring_attention as jax_ring
from omnivideo_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from omnivideo_tpu_torch.ops.attention import attention_plain
from omnivideo_tpu_torch.parallel import distributed as port_dist
from omnivideo_tpu_torch.parallel.distributed import (
    add_distributed_args,
    maybe_initialize_distributed,
)
from omnivideo_tpu_torch.parallel.mesh import create_mesh
from torch_sp_workers import WORLD, attention_worker, load, spawn

B, L, N, D = 2, 64, 4, 16
LENS = np.array([50, 64], np.int32)  # batch row 0: the last shard ends in 14 pad keys
TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("ulysses", "ring_ppermute", "ring_pallas", "hybrid_ppermute", "hybrid_pallas")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, L, N, D)).astype(np.float32) for _ in range(3))
    np.savez(tmp / "inputs.npz", q=q, k=k, v=v, lens=LENS)
    spawn(attention_worker, tmp)
    ranks = [load(tmp, f"att_{r}") for r in range(WORLD)]
    out = {}
    for name in ranks[0]:
        if name == "hybrid_shard":
            continue
        if name.endswith("_whole"):  # every rank returns the whole output
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[name], ranks[0][name])
            out[name] = ranks[0][name]
            continue
        order = range(WORLD)
        if name.startswith("hybrid"):  # rank → its global shard index
            order = np.argsort([int(r["hybrid_shard"]) for r in ranks])
        out[name] = np.concatenate([ranks[i][name] for i in order], axis=1)
    return (q, k, v), out


_JAX = {}


def _jax_ref(family, with_lens, q, k, v):
    key = (family, with_lens)
    if key not in _JAX:
        lens = jnp.asarray(LENS) if with_lens else None
        q, k, v = (jnp.asarray(t) for t in (q, k, v))
        if family == "ulysses":
            out = jax_ulysses(q, k, v, jax_mesh(sp=WORLD), impl="xla", kv_lens=lens)
        elif family == "ring":
            out = jax_ring(q, k, v, jax_mesh(sp=WORLD), kv_lens=lens)
        else:
            out = jax_hybrid(q, k, v, jax_mesh(fsdp=2, sp=2), ulysses_axis="fsdp",
                             ring_axis="seq", kv_lens=lens)
        _JAX[key] = np.asarray(out)
    return _JAX[key]


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "kv_lens"])
@pytest.mark.parametrize("mode", MODES)
def test_sp_attention_matches_plain_and_jax(shards, mode, with_lens):
    (q, k, v), out = shards
    got = out[mode + ("_lens" if with_lens else "")]
    lens = torch.from_numpy(LENS) if with_lens else None
    plain = attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), kv_lens=lens).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    np.testing.assert_allclose(got, _jax_ref(mode.split("_")[0], with_lens, q, k, v), **TOL)
    if not with_lens:
        np.testing.assert_allclose(plain, np.asarray(attention_xla(*map(jnp.asarray, (q, k, v)))),
                                   **TOL)


@pytest.mark.parametrize("name", ["causal_ppermute", "causal_pallas", "zigzag_whole",
                                  "stripe_whole"])
def test_token_causal_rings_match_dense_causal_attention(shards, name):
    """Token-causal ring over contiguous shards (under both `impl` names),
    and the load-balanced zigzag and stripe layouts, against dense
    causal attention in the original order (the JAX kernels' own holds are
    in tests/test_torch_ring.py)."""
    (q, k, v), out = shards
    s = np.einsum("bind,bjnd->bnij", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(D)
    s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bnij,bjnd->bind", p / p.sum(-1, keepdims=True), v.astype(np.float64))
    np.testing.assert_allclose(out[name], ref, **TOL)


# --- bring-up: flags and torchrun's environment -----------------------------

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture()
def mock_init(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(("init", backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(port_dist, "resolve_device", lambda d: torch.device(d))
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    return calls


def test_single_process_is_noop(mock_init):
    assert maybe_initialize_distributed() is False
    assert mock_init == []


def test_flags_on_the_cpu_take_gloo(mock_init):
    assert maybe_initialize_distributed("10.0.0.1:1234", 4, 2, device="cpu") is True
    assert mock_init == [("init", "gloo", {"init_method": "tcp://10.0.0.1:1234",
                                           "world_size": 4, "rank": 2})]


def test_torchrun_env_on_the_card_takes_nccl_after_its_card(mock_init, monkeypatch):
    for var, val in zip(ENV, ("head", "29500", "8", "5", "1")):
        monkeypatch.setenv(var, val)
    assert maybe_initialize_distributed() is True
    assert mock_init == [("set_device", 1),
                         ("init", "nccl", {"init_method": "tcp://head:29500",
                                           "world_size": 8, "rank": 5})]


def test_flags_override_env(mock_init, monkeypatch):
    for var, val in zip(ENV, ("env-host", "1", "8", "5", "1")):
        monkeypatch.setenv(var, val)
    maybe_initialize_distributed("flag-host:2", 2, 1, device="cpu")
    assert mock_init[0][2] == {"init_method": "tcp://flag-host:2", "world_size": 2, "rank": 1}


def test_coordinator_without_counts_raises(mock_init):
    with pytest.raises(ValueError, match="process count"):
        maybe_initialize_distributed("h:1", device="cpu")


def test_argparse_flags():
    p = argparse.ArgumentParser()
    add_distributed_args(p)
    args = p.parse_args(["--coordinator", "h:1", "--num_processes", "2", "--process_id", "1"])
    assert (args.coordinator, args.num_processes, args.process_id) == ("h:1", 2, 1)
    assert p.parse_args([]).coordinator is None


def test_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="no process group"):
        create_mesh(sp=4)
