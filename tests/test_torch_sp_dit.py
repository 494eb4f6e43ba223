"""The port's sequence-parallel Wan DiT forward and generate over 4 real
gloo ranks, against the JAX package's `wan_dit_apply(sp=...)` on its virtual
CPU mesh and against the port's own single-process forward.

The tiny config of tests/test_parallel.py (dim 64, 4 heads, 2 layers, f32),
with JAX's init and a non-zero head carried across by
`wan_params_to_state_dict`. Modes: Ulysses (sp 4), the ring with either
impl (sp 4), and the hybrid (Ulysses 2 × ring 2) with either impl; each on
the natural sequence (L = 64) and on a padded one (L_nat = 45 → 48, the
last shard ends in 3 pad tokens). Tolerance rtol 5e-4, atol 5e-5, JAX's own
limits for its SP forward. The tiny SP generate (ring, fused-step impl) is
held to the single-process generate at rtol 2e-3, atol 2e-4, as
tests/test_parallel.py holds JAX's; its unseeded run must give every rank
the same latents (rank 0's seed, broadcast). One spawn runs everything.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.wan_dit import SPConfig as JaxSPConfig
from omnivideo_tpu.models.wan_dit import init_wan_dit, wan_dit_apply
from omnivideo_tpu.parallel.mesh import create_mesh as jax_mesh
from omnivideo_tpu_torch.configs.base import WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import load_wan_state_dict, wan_params_to_state_dict
from omnivideo_tpu_torch.models.wan_dit import WanDiT
from torch_sp_workers import WORLD, load, sp_dit_worker, spawn, tiny_pipe

CFG = dict(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=64, ffn_dim=128, freq_dim=32,
           text_dim=48, out_dim=4, num_heads=4, num_layers=2)
PIPE = dict(dit=dict(patch_size=(1, 2, 2), in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                     freq_dim=32, text_dim=48, num_heads=4, num_layers=2),
            vae=dict(dim=8, z_dim=8), pipe=dict(name="tiny-sp", max_context_len=32,
                                                dual_expert=False, vlm_in_dim=16,
                                                param_dtype="float32"))
GEN = dict(size=(64, 32), frame_num=9, sampling_steps=3, guide_scale=3.0)
MODES = ("ulysses", "ring_ppermute", "ring_pallas", "hybrid_ppermute", "hybrid_pallas")
TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_dit")
    params = init_wan_dit(jax.random.PRNGKey(0), JaxDiTConfig(**CFG), dtype=jnp.float32)
    head = params["head"]["head"]
    head["kernel"] = jax.random.normal(jax.random.PRNGKey(9), head["kernel"].shape) * 0.05
    sd = wan_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(1)
    inputs = dict(x=rng.standard_normal((1, 4, 4, 8, 8)).astype(np.float32),
                  xp=rng.standard_normal((1, 4, 5, 6, 6)).astype(np.float32),
                  t=np.array([500.0], np.float32),
                  tl=rng.uniform(0.0, 1000.0, (1, 64)).astype(np.float32),
                  tlp=rng.uniform(0.0, 1000.0, (1, 48)).astype(np.float32),
                  ctx=rng.standard_normal((1, 16, 48)).astype(np.float32))
    np.savez(tmp / "sd.npz", **sd)
    np.savez(tmp / "inputs.npz", **inputs)
    spawn(sp_dit_worker, tmp, CFG, PIPE, GEN)
    return params, sd, inputs, [load(tmp, f"dit_{r}") for r in range(WORLD)], \
        [load(tmp, f"gen_{r}") for r in range(WORLD)]


_JAX = {}


def _jax_sp(params, inputs, family, padded, t="t"):
    key = (family, padded, t)
    if key not in _JAX:
        mesh = jax_mesh(fsdp=2, sp=2) if family == "hybrid" else jax_mesh(sp=WORLD)
        x = inputs["xp" if padded else "x"]
        _JAX[key] = np.asarray(wan_dit_apply(
            params, JaxDiTConfig(**CFG), jnp.asarray(x), jnp.asarray(inputs[t]),
            jnp.asarray(inputs["ctx"]), attn_impl="xla", seq_len=48 if padded else None,
            sp=JaxSPConfig(mesh=mesh, mode=family)))
    return _JAX[key]


@pytest.mark.parametrize("padded", [False, True], ids=["L64", "L45_padded_48"])
@pytest.mark.parametrize("mode", MODES)
def test_sp_forward_matches_jax_and_single_process(run, mode, padded):
    params, sd, inputs, dit, _ = run
    name = mode + ("_padded" if padded else "")
    outs = [r[name] for r in dit]
    for r in range(1, WORLD):  # every rank gets the whole velocity
        np.testing.assert_array_equal(outs[r], outs[0])
    model = load_wan_state_dict(WanDiT(WanDiTConfig(**CFG), torch.float32, device="cpu"), sd)
    x = inputs["xp" if padded else "x"]
    with torch.inference_mode():
        single = model(*(torch.from_numpy(a) for a in (x, inputs["t"], inputs["ctx"]))).numpy()
    assert outs[0].shape == single.shape == x.shape
    np.testing.assert_allclose(outs[0], single, **TOL)
    np.testing.assert_allclose(outs[0], _jax_sp(params, inputs, mode.split("_")[0], padded), **TOL)


@pytest.mark.parametrize("padded", [False, True], ids=["L64", "L45_padded_48"])
@pytest.mark.parametrize("mode", ["ulysses", "ring_pallas"])
def test_sp_forward_per_token_timesteps(run, mode, padded):
    """t of shape [B, L] (one timestep per token): each rank takes its
    shard's rows of the time embeddings, as JAX's global-view SP forward
    does; held to the port's single-process forward with the same t and to
    JAX's SP forward."""
    params, sd, inputs, dit, _ = run
    name = mode + "_tokens" + ("_padded" if padded else "")
    outs = [r[name] for r in dit]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(outs[r], outs[0])
    model = load_wan_state_dict(WanDiT(WanDiTConfig(**CFG), torch.float32, device="cpu"), sd)
    x, t = inputs["xp" if padded else "x"], inputs["tlp" if padded else "tl"]
    with torch.inference_mode():
        single = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(inputs["ctx"]),
                       seq_len=48 if padded else None).numpy()
        uniform = model(*(torch.from_numpy(a) for a in (x, inputs["t"], inputs["ctx"]))).numpy()
    assert outs[0].shape == single.shape == x.shape
    assert np.abs(single - uniform).max() > 1e-3  # the per-token t reaches the output
    np.testing.assert_allclose(outs[0], single, **TOL)
    jax_out = _jax_sp(params, inputs, mode.split("_")[0], padded, "tlp" if padded else "tl")
    np.testing.assert_allclose(outs[0], jax_out, **TOL)


def test_sp_generate_matches_single_process(run):
    *_, gen = run
    ctx = torch.from_numpy(run[2]["ctx"][0, :5])
    ref = tiny_pipe(PIPE).generate(precomputed_context=ctx,
                                   precomputed_context_null=torch.zeros_like(ctx), decode=False,
                                   generator=torch.Generator().manual_seed(7), **GEN).numpy()
    assert float(np.abs(ref).max()) > 0.1
    for r in range(WORLD):
        np.testing.assert_allclose(gen[r]["seeded"], ref, rtol=2e-3, atol=2e-4)
        np.testing.assert_array_equal(gen[r]["unseeded"], gen[0]["unseeded"])
