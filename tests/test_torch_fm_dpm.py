"""FlowDPMSolver of the port against the JAX package: the host tables are
equal (f64 schedule, integer-truncated timesteps, the f32 coefficient
tables bit for bit), and steps on the same tensors agree to f32 rounding
(1e-6 relative: the same products and sums in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.schedulers.fm_dpm import FlowDPMSolver as JaxDPM
from omnivideo_tpu.schedulers.fm_dpm import get_sampling_sigmas as jax_sigmas
from omnivideo_tpu_torch.schedulers.fm_dpm import (
    COEFF_FIELDS,
    FlowDPMSolver,
    get_sampling_sigmas,
)


@pytest.mark.parametrize("steps,shift,order,solver_type,from_sigmas", [
    (3, 12.0, 2, "midpoint", True), (10, 5.0, 2, "midpoint", True),
    (50, 5.0, 2, "midpoint", False), (8, 3.0, 3, "midpoint", True),
    (20, 5.0, 3, "midpoint", False), (6, 5.0, 2, "heun", True), (4, 5.0, 1, "midpoint", False)])
def test_tables_equal_jax(steps, shift, order, solver_type, from_sigmas):
    kw = dict(solver_order=order, solver_type=solver_type)
    if from_sigmas:
        np.testing.assert_array_equal(get_sampling_sigmas(steps, shift), jax_sigmas(steps, shift))
        j = JaxDPM.create(sigmas=jax_sigmas(steps, shift), **kw)
        t = FlowDPMSolver.create(sigmas=get_sampling_sigmas(steps, shift), **kw)
    else:
        j = JaxDPM.create(steps, shift=shift, **kw)
        t = FlowDPMSolver.create(steps, shift=shift, **kw)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    for name in COEFF_FIELDS:
        np.testing.assert_array_equal(t.coeffs[name].astype(np.float32),
                                      np.asarray(getattr(j.coeffs, name)), err_msg=name)


@pytest.mark.parametrize("order", [2, 3])
def test_steps_match_jax(order):
    rng = np.random.default_rng(order)
    shape = (1, 4, 3, 6, 6)
    j = JaxDPM.create(sigmas=jax_sigmas(7, 5.0), solver_order=order)
    t = FlowDPMSolver.create(sigmas=get_sampling_sigmas(7, 5.0), solver_order=order)
    x = rng.standard_normal(shape).astype(np.float32)
    js, ts = j.init_state(jnp.asarray(x)), t.init_state(torch.tensor(x))
    for i in range(len(t)):
        v = rng.standard_normal(shape).astype(np.float32)
        js = j.step(js, jnp.asarray(v), i)
        ts = t.step(ts, torch.tensor(v), i)
        for name in ("x", "m1", "m2"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} step {i}")


def test_exact_velocity_reconstructs_x0():
    """With the exact flow velocity v = (x − x0)/σ the solver lands on x0."""
    rng = np.random.default_rng(1)
    x0 = torch.tensor(rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32))
    eps = torch.tensor(rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32))
    s = FlowDPMSolver.create(sigmas=get_sampling_sigmas(20, 5.0))
    sig0 = s.sigmas[0]
    st = s.init_state((1 - sig0) * x0 + sig0 * eps)
    for i in range(len(s)):
        st = s.step(st, (st.x - x0) / float(s.sigmas[i]), i)
    assert float((st.x - x0).abs().max()) < 1e-4
