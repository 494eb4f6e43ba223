"""The port's v1 adapters (models/adapters.py) and alignment training
(training/align.py) on the CPU: the DM_Adapter and the VisionHead against
the reference's golden output (tests/golden/adapter_tiny.npz, 2e-4 as
tests/test_adapters.py) and against JAX's apply on the same state dict
(1e-5 of scale), `v1_aligned_embedding` against JAX's (1e-5 of scale),
`alignment_loss` (1e-5 relative) and one align step with the SFT optimizer
against JAX's `make_align_step` (the loss 1e-5 relative, the chain's
parameters within 1e-5 of max(their leaf's largest, 1e-2) where JAX's
gradient is not rounding noise; the k-bias gradients are exactly zero)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.models import adapters as jad
from omnivideo_tpu.training import align as jalign
from omnivideo_tpu.training import sft as jsft
from omnivideo_tpu_torch.io import jax_bridge as jb
from omnivideo_tpu_torch.models import adapters as pad
from omnivideo_tpu_torch.training import align as palign
from omnivideo_tpu_torch.training import sft as psft
from torch_sft_tiny import OUT, Q, adam_checked, jax_setup, port_model, rel

GOLDEN = Path(__file__).parent / "golden" / "adapter_tiny.npz"


def _golden():
    g = np.load(GOLDEN)
    return g, {k[len("sd::"):]: g[k] for k in g.files if k.startswith("sd::")}


@pytest.mark.parametrize("kind", ["dm_adapter", "vision_head"])
def test_golden_parity(kind):
    g, sd = _golden()
    if kind == "vision_head":
        sd = {k.replace("adapter.", "visionHeadAdapter."): v for k, v in sd.items()}
        model = pad.vision_head_from_state_dict(sd, device="cpu")
        ref = jad.vision_head_apply(jad.vision_head_from_state_dict(sd), jnp.asarray(g["x"]))
    else:
        model = pad.dm_adapter_from_state_dict(sd, device="cpu")
        ref = jad.dm_adapter_apply(jad.dm_adapter_from_state_dict(sd), jnp.asarray(g["x"]))
    with torch.no_grad():
        out = model(torch.from_numpy(g["x"])).numpy()
    assert out.shape == g["out"].shape
    np.testing.assert_allclose(out, g["out"], rtol=2e-4, atol=2e-4)
    assert rel(out, np.asarray(ref)) < 1e-5
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("is_video", [False, True])
def test_v1_aligned_embedding_matches_jax(is_video):
    _, sd = _golden()
    sd2 = dict(sd)
    w = np.asarray(sd["fc.0.weight"])
    sd2["fc.0.weight"] = np.concatenate([w, w[:, :8]], axis=1)  # the bridge takes 32 inputs
    vh_sd = {k.replace("adapter.", "visionHeadAdapter."): v for k, v in sd.items()}
    vlm = np.random.default_rng(0).standard_normal((2, 10, 24)).astype(np.float32)
    ref = jad.v1_aligned_embedding(jad.vision_head_from_state_dict(vh_sd),
                                   jad.dm_adapter_from_state_dict(sd2), jnp.asarray(vlm),
                                   is_video=is_video)
    with torch.no_grad():
        got = pad.v1_aligned_embedding(pad.vision_head_from_state_dict(vh_sd, device="cpu"),
                                       pad.dm_adapter_from_state_dict(sd2, device="cpu"),
                                       torch.from_numpy(vlm), is_video=is_video)
    assert got.shape == ((2, 64, 32) if is_video else (2, 8, 32))
    assert rel(got.numpy(), np.asarray(ref)) < 1e-5


def _chain_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"vlm": rng.standard_normal((2, 8, 64)).astype(np.float32),
            "target": (0.1 * rng.standard_normal((2, Q, OUT))).astype(np.float32)}


@pytest.mark.parametrize("cosine", [0.0, 0.5])
def test_alignment_loss_and_step_match_jax(cosine):
    jcfg, params = jax_setup(chain=True)
    chain = port_model(jcfg, params).chain
    batch = _chain_batch()
    jchain = jax.tree_util.tree_map(jnp.asarray, params["chain"])
    ref = jalign.alignment_loss(jchain, {k: jnp.asarray(v) for k, v in batch.items()}, cosine)
    got = palign.alignment_loss(chain, {k: torch.from_numpy(v) for k, v in batch.items()}, cosine)
    assert abs(float(got.detach()) / float(ref) - 1) < 1e-5

    tc = jsft.SFTConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    tx = jsft.make_sft_optimizer(tc)
    state = jalign.init_align_state(jchain, tx)
    state, m = jax.jit(jalign.make_align_step(tx, cosine))(state,
                                                           {k: jnp.asarray(v)
                                                            for k, v in batch.items()})
    ptx = psft.make_sft_optimizer(psft.SFTConfig(learning_rate=1e-3, warmup_steps=0,
                                                 total_steps=10))
    pstate = palign.init_align_state(chain, ptx)
    pstate, pm = palign.make_align_step(ptx, cosine)(pstate, {k: torch.from_numpy(v)
                                                              for k, v in batch.items()})
    assert abs(float(pm["loss"]) / float(m["loss"]) - 1) < 1e-5
    want = jb.chain_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    g = jb.chain_params_to_state_dict(jax.tree_util.tree_map(
        lambda a: np.asarray(a) / 0.1, state.opt_state[1][0].mu))  # step 1: mu = 0.1·g
    for k, v in chain.state_dict().items():
        err, _ = adam_checked(v.numpy(), want[k], [g[k]])
        assert err < 1e-5, (k, err)
    assert pstate.step == 1 and pstate.opt_state["count"] == 1


def test_seeded_init_shapes():
    gen = torch.Generator().manual_seed(0)
    vh = pad.init_vision_head(64, 32, 24, num_queries=4, num_layers=1, generator=gen, device="cpu")
    ad = pad.init_dm_adapter(24, 32, 32, num_queries=4, num_layers=1, generator=gen, device="cpu")
    jvh = jad.init_vision_head(jax.random.PRNGKey(0), 64, 32, 24, num_queries=4, num_layers=1)
    jadp = jad.init_dm_adapter(jax.random.PRNGKey(1), 24, 32, 32, num_queries=4, num_layers=1)
    sd = palign.AlignChain(vh, ad).state_dict()
    ref = jb.chain_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                               {"vision_head": jvh,
                                                                "adapter": jadp}))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: v.shape for k, v in ref.items()}
    assert float(sd["vision_head.decoder_query"].std()) == pytest.approx(0.05, rel=0.5)
    assert bool((sd["adapter.adapter.encoder.norm.weight"] == 1).all())
