"""FlowUniPC of the port against the JAX package: the host tables are equal
(f64 schedule and integer-truncated timesteps exactly; the f32 coefficient
tables bit for bit), and a step on the same tensors agrees to f32 rounding
(1e-6 relative: the same products and sums in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.schedulers.unipc import FlowUniPC as JaxUniPC
from omnivideo_tpu_torch.schedulers.unipc import COEFF_FIELDS, FlowUniPC


@pytest.mark.parametrize("steps,shift,order", [(2, 5.0, 2), (10, 5.0, 2), (50, 12.0, 2),
                                               (7, 3.0, 3)])
def test_tables_equal_jax(steps, shift, order):
    j = JaxUniPC.create(steps, shift=shift, solver_order=order)
    t = FlowUniPC.create(steps, shift=shift, solver_order=order)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert (t.timesteps == np.trunc(t.timesteps)).all()
    for name in COEFF_FIELDS:
        np.testing.assert_array_equal(t.coeffs[name].astype(np.float32),
                                      np.asarray(getattr(j.coeffs, name)), err_msg=name)


def test_steps_match_jax():
    rng = np.random.default_rng(0)
    shape = (1, 4, 3, 6, 6)
    j = JaxUniPC.create(6, shift=5.0)
    t = FlowUniPC.create(6, shift=5.0)
    x = rng.standard_normal(shape).astype(np.float32)
    js, ts = j.init_state(jnp.asarray(x)), t.init_state(torch.tensor(x))
    for i in range(6):
        v = rng.standard_normal(shape).astype(np.float32)
        js = j.step(js, jnp.asarray(v), i)
        ts = t.step(ts, torch.tensor(v), i)
        for name in ("x", "m1", "last_x"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} step {i}")


def test_exact_velocity_reconstructs_x0():
    """With the exact flow velocity v = (x − x0)/σ the solver lands on x0."""
    rng = np.random.default_rng(1)
    x0 = torch.tensor(rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32))
    eps = torch.tensor(rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32))
    s = FlowUniPC.create(20, shift=5.0)
    sig0 = s.sigmas[0]
    st = s.init_state((1 - sig0) * x0 + sig0 * eps)
    for i in range(len(s)):
        st = s.step(st, (st.x - x0) / float(s.sigmas[i]), i)
    assert float((st.x - x0).abs().max()) < 1e-4
