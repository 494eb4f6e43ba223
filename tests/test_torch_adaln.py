"""The port's fused residual + LayerNorm + AdaLN (`ops/fused_adaln.py`)
against the JAX package on the CPU, with seeded numpy inputs. On the CPU
the port runs the kernel's plain twin; the JAX side runs its Pallas kernel
in interpret mode.

Tolerances: f32 outputs within 1e-6 of each row's largest |reference| (the
row mean and variance sum in another order); bf16 outputs within 1 bf16 ulp
of that row maximum (those sums can flip one rounding); x_new within 1e-6
relative; gradients within 1e-5 of each gradient's scale (the same formula
differentiated by both frameworks).
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.ops.pallas.adaln import fused_adaln_pallas
from omnivideo_tpu_torch.ops.fused_adaln import fused_adaln, fused_adaln_plain

jax_fa = importlib.import_module("omnivideo_tpu.ops.fused_adaln")

B, L, D = 2, 37, 256  # 37 rows: a ragged last block of 8
EPS = 1e-6
# every argument subset the kernel takes: (residual, gate, affine, modulation)
SUBSETS = [(r, g, a, m) for r, g, a, m in itertools.product((0, 1), repeat=4) if r or not g]


def _inputs(subset, o_dtype, seed=0):
    rng = np.random.default_rng(seed)
    r, g, a, m = subset
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = 2.0 + 3.0 * f(B, L, D)
    o = f(B, L, D).astype(o_dtype) if r else None
    return (x, o, f(B, D) if g else None,
            1.0 + 0.1 * f(D) if a else None, 0.1 * f(D) if a else None,
            f(B, D) if m else None, f(B, D) if m else None)


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0**-126))) - 7)


def _to_jax(a):
    return None if a is None else jnp.asarray(a)


def _to_torch(a):
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("subset", SUBSETS, ids=lambda s: "res%d_gate%d_affine%d_mod%d" % s)
def test_matches_pallas_interpret(subset, out):
    """The port's fused_adaln vs the Pallas kernel (interpret mode, 8-row
    blocks) for every argument subset; o is in the output's dtype, as the
    DiT passes it."""
    o_dtype = jnp.bfloat16 if out == "bfloat16" else np.float32
    args = _inputs(subset, o_dtype)
    jx_new, jy = fused_adaln_pallas(*map(_to_jax, args), eps=EPS, out_dtype=getattr(jnp, out),
                                    block_rows=8, interpret=True)
    x_new, y = fused_adaln(*map(_to_torch, args), eps=EPS, out_dtype=getattr(torch, out))
    jy = np.asarray(jy, np.float32)
    row_max = np.abs(jy).max(-1, keepdims=True)
    err = np.abs(y.float().numpy() - jy)
    if out == "float32":
        assert y.dtype == torch.float32 and (err / row_max).max() <= 1e-6
    else:
        assert y.dtype == torch.bfloat16 and (err / _bf16_ulp(row_max)).max() <= 1.0
    if subset[0]:
        ref = np.asarray(jx_new)
        np.testing.assert_allclose(x_new.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    else:
        assert x_new is None and jx_new is None


@pytest.mark.parametrize("subset", [(1, 1, 1, 1), (1, 0, 0, 1), (0, 0, 0, 1)],
                         ids=["all", "res_mod", "mod"])
def test_gradient_matches_jax_vjp(subset):
    """The autograd function's backward (the plain formula's VJP) vs jax.vjp
    of the JAX fused_adaln (its custom_vjp), at f32."""
    args = _inputs(subset, np.float32, seed=1)
    rng = np.random.default_rng(2)
    ct_y = rng.standard_normal((B, L, D)).astype(np.float32)
    ct_x = rng.standard_normal((B, L, D)).astype(np.float32)
    present = [i for i, a in enumerate(args) if a is not None]

    def jfn(*xs):
        full = list(args)
        for i, v in zip(present, xs):
            full[i] = v
        return jax_fa.fused_adaln(*full, EPS, jnp.float32, "xla")

    (jxn, jy), vjp = jax.vjp(jfn, *[jnp.asarray(args[i]) for i in present])
    jgrads = vjp((jnp.asarray(ct_x) if subset[0] else None, jnp.asarray(ct_y)))
    leaves = [None if a is None else torch.tensor(a, requires_grad=True) for a in args]
    x_new, y = fused_adaln(*leaves, eps=EPS, out_dtype=torch.float32)
    loss = (y * torch.tensor(ct_y)).sum()
    if subset[0]:
        loss = loss + (x_new * torch.tensor(ct_x)).sum()
    loss.backward()
    for i, jg in zip(present, jgrads):
        ref = np.asarray(jg)
        got = leaves[i].grad.numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), i


def test_plain_twin_keeps_centred_variance():
    """var = mean((x − mean)²): a row with a large offset keeps its
    normalisation (E[x²] − mean² would cancel to noise in f32)."""
    x = torch.tensor(1e4 + np.random.default_rng(3).standard_normal((1, 4, 256)),
                     dtype=torch.float32)
    _, y = fused_adaln_plain(x, out_dtype=torch.float32)
    xc = x.double() - x.double().mean(-1, keepdim=True)
    ref = xc / xc.square().mean(-1, keepdim=True).add(EPS).sqrt()
    assert float((y.double() - ref).abs().max()) < 1e-3


def test_argument_rules():
    x = torch.zeros(1, 2, 128)
    v = torch.zeros(1, 128)
    with pytest.raises(ValueError, match="gate needs"):
        fused_adaln(x, gate=v)
    with pytest.raises(ValueError, match="ln_scale and ln_bias"):
        fused_adaln(x, ln_scale=torch.ones(128))
    with pytest.raises(ValueError, match="mod_scale and mod_shift"):
        fused_adaln(x, mod_scale=v)
