"""The port's ring step (`ring_step_plain`, the CUDA kernel's plain twin),
driven over n = 4 in-process shards by `ring_flash_attention_shards`,
against the JAX package's fused Pallas ring kernel in interpret mode on the
virtual CPU mesh: non-causal (`ring_attention(impl="pallas")`), block- and
token-causal (`ring_flash_attention_shard`), the zigzag and stripe layouts,
and kv_lens padding where one shard is entirely padding (valid rows only;
JAX's kernel leaves phantom mass in rows that see no key, the port zeros
them). Sizes of tests/test_ring_pallas.py. f32 throughout; tolerance 2e-5
absolute and relative: the port keeps its logits in the exp2 domain with
scale·log2e folded into q, JAX in natural units.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from omnivideo_tpu.ops.pallas.ring_attention import ring_flash_attention_shard as jax_shard
from omnivideo_tpu.parallel.ring import ring_attention as jax_ring
from omnivideo_tpu.parallel.ring import stripe_ring_attention, zigzag_ring_attention
from omnivideo_tpu_torch.ops.ring_attention import (
    ring_carry,
    ring_finish,
    ring_flash_attention_shards,
    ring_step,
    ring_step_plain,
    step_lens_for,
    stripe_order,
    zigzag_order,
)

B, L, N, D, NDEV = 1, 512, 2, 128, 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B=B, L=L):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, N, D)).astype(np.float32) for _ in range(3)]


def _mesh():
    return Mesh(np.array(jax.devices()[:NDEV]), ("seq",))


def _port(q, k, v, causal=None, kv_lens=None, order=None):
    """The port over NDEV shards of q/k/v laid out in `order`, returned in
    the original order."""
    t = [torch.from_numpy(a) for a in (q, k, v)]
    if order is not None:
        t = [a[:, order] for a in t]
    outs = ring_flash_attention_shards(*(list(a.chunk(NDEV, 1)) for a in t), causal=causal,
                                       kv_lens=kv_lens)
    out = torch.cat(outs, 1)
    if order is not None:
        out = out[:, torch.argsort(order)]
    return out.numpy()


def _jax_shard(q, k, v, **kw):
    fn = shard_map(functools.partial(jax_shard, axis_name="seq", interpret=True, block_q=128,
                                     block_k=128, **kw),
                   mesh=_mesh(), in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
                   check_vma=False)
    return np.asarray(fn(*map(jnp.asarray, (q, k, v))))


def test_full_matches_jax_pallas_ring():
    q, k, v = _qkv(0)
    ref = np.asarray(jax_ring(*map(jnp.asarray, (q, k, v)), _mesh(), axis="seq", impl="pallas",
                              interpret=True))
    np.testing.assert_allclose(_port(q, k, v), ref, **TOL)


@pytest.mark.parametrize("causal", ["block", "token"])
def test_causal_shards_match_jax_kernel(causal):
    q, k, v = _qkv(1)
    np.testing.assert_allclose(_port(q, k, v, causal=causal), _jax_shard(q, k, v, causal=causal),
                               **TOL)


def test_zigzag_matches_jax():
    q, k, v = _qkv(2, L=1024)
    ref = np.asarray(zigzag_ring_attention(*map(jnp.asarray, (q, k, v)), _mesh(), axis="seq",
                                           block_q=128, block_k=128, interpret=True))
    np.testing.assert_allclose(_port(q, k, v, "zigzag", order=zigzag_order(1024, NDEV)), ref,
                               **TOL)


def test_stripe_matches_jax():
    q, k, v = _qkv(3)
    ref = np.asarray(stripe_ring_attention(*map(jnp.asarray, (q, k, v)), _mesh(), axis="seq",
                                           block_q=128, block_k=128, interpret=True))
    np.testing.assert_allclose(_port(q, k, v, "stripe", order=stripe_order(L, NDEV)), ref, **TOL)


def test_padded_with_an_empty_shard_matches_jax_valid_rows():
    """kv_lens 300 of 512: shard 2 ends in 84 pad keys, shard 3 is all
    padding (its step adds nothing); batch row 1 has no padding."""
    q, k, v = _qkv(4, B=2)
    lens = np.array([300, 512], np.int32)
    ref = np.asarray(jax_ring(*map(jnp.asarray, (q, k, v)), _mesh(), axis="seq", impl="pallas",
                              interpret=True, kv_lens=jnp.asarray(lens)))
    out = _port(q, k, v, kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(out[0, :300], ref[0, :300], **TOL)
    np.testing.assert_allclose(out[1], ref[1], **TOL)
    assert [int(step_lens_for(torch.tensor([300]), s, 128, NDEV)) for s in range(NDEV)] == [
        128, 128, 44, 0]


def test_rows_with_no_key_are_zero_and_lse_is_natural_log():
    """A row that sees no key in any step ends at out = 0, m = −1e30, l = 0;
    the LSE of a full row is the natural-log logsumexp of its logits."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, L=64))
    carry = ring_carry(B, 64, N, D, "cpu")
    m, l, acc = ring_step(q, k, v, *carry, step_lens=torch.tensor([0]))
    out = ring_finish(m, l, acc, q.dtype)
    assert float(out.abs().max()) == 0.0 and float(l.max()) == 0.0
    assert torch.equal(m, torch.full_like(m, -1e30))
    m, l, acc = ring_step_plain(q, k, v, *carry)
    _, lse = ring_finish(m, l, acc, q.dtype, return_lse=True)
    s = torch.einsum("bind,bjnd->bnij", q.double(), k.double()) * D**-0.5
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-5, atol=1e-5)
