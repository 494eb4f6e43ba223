"""The port's flow-matching training schedule against the JAX
FlowMatchScheduler: the f32 sigma, timestep and loss-weight tables are the
same f64 numpy tables rounded once, so they agree bit for bit; the index
lookup, noising, target and weights agree bit for bit too (the same f32
operations in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.schedulers.flow_match import FlowMatchScheduler as JaxFlow
from omnivideo_tpu_torch.schedulers.flow_match import FlowMatchScheduler


@pytest.mark.parametrize("steps,shift,kw", [
    (1000, 3.0, {}),
    (50, 5.0, {"extra_one_step": True}),
    (40, 1.0, {"inverse_timesteps": True, "reverse_sigmas": True}),
])
def test_tables_bit_exact(steps, shift, kw):
    ref = JaxFlow.create(num_inference_steps=steps, shift=shift, is_training=True, **kw)
    out = FlowMatchScheduler.create(num_inference_steps=steps, shift=shift, is_training=True,
                                    **kw)
    for name in ("sigmas", "timesteps", "training_weights"):
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert FlowMatchScheduler.create(10).training_weights is None


def test_training_helpers_bit_exact():
    ref = JaxFlow.create(num_inference_steps=1000, shift=3.0, is_training=True)
    flow = FlowMatchScheduler.create(num_inference_steps=1000, shift=3.0, is_training=True)
    rng = np.random.default_rng(0)
    tid = np.array([0, 1, 499, 999, 731], np.int64)
    t = np.asarray(ref.timesteps)[tid]
    # off-table timesteps too: the argmin picks the nearest entry, the first on ties
    t_off = np.concatenate([t, np.float32([999.7, 0.0, 500.5, 2000.0])])
    np.testing.assert_array_equal(flow.timestep_id(torch.tensor(t_off)).numpy(),
                                  np.asarray(ref._timestep_id(jnp.asarray(t_off))))
    x = rng.standard_normal((5, 4, 3, 8, 8)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    tt = flow.timesteps[torch.tensor(tid)]
    np.testing.assert_array_equal(tt.numpy(), t)
    np.testing.assert_array_equal(
        flow.add_noise(torch.tensor(x), torch.tensor(eps), tt).numpy(),
        np.asarray(ref.add_noise(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))))
    np.testing.assert_array_equal(
        flow.training_target(torch.tensor(x), torch.tensor(eps)).numpy(),
        np.asarray(ref.training_target(jnp.asarray(x), jnp.asarray(eps))))
    np.testing.assert_array_equal(flow.training_weight(tt).numpy(),
                                  np.asarray(ref.training_weight(jnp.asarray(t))))
    with pytest.raises(ValueError, match="is_training"):
        FlowMatchScheduler.create(10).training_weight(tt)
