"""Mixed-context assembly of the port (build_mixed_context, the visual
context adapter, VLM projection) against the JAX package and the reference
golden `unified_tiny.npz`, on the CPU.

All f32: 1e-5 relative, except the golden forward, which keeps the JAX
package's own tolerance (3e-4) for the reference torch implementation."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.io.torch_convert import split_unified_state_dict as jax_split
from omnivideo_tpu.io.torch_convert import to_jnp, unified_companions_to_params
from omnivideo_tpu.models.unified import build_mixed_context as jax_build
from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import (
    companions_from_state_dict,
    load_wan_state_dict,
    split_unified_state_dict,
)
from omnivideo_tpu_torch.models.unified import build_mixed_context, null_ar_vision
from omnivideo_tpu_torch.models.wan_dit import WanDiT

GOLDEN = Path(__file__).parent / "golden" / "unified_tiny.npz"
DIT = dict(patch_size=(1, 2, 2), text_len=512, in_dim=4, dim=64, ffn_dim=128, freq_dim=32,
           text_dim=48, out_dim=4, num_heads=4, num_layers=2)
PIPE = dict(name="tiny", vlm_in_dim=24, use_visual_context_adapter=True,
            visual_context_adapter_patch_size=(1, 4, 4), max_context_len=40)
CFG = PipelineConfig(dit=WanDiTConfig(**DIT), vae=VAEConfig(z_dim=4), **PIPE)
JCFG = JaxPipelineConfig(dit=JaxDiTConfig(**DIT), vae=JaxVAEConfig(z_dim=4), **PIPE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def companions(golden):
    sd = {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")}
    _, comp = split_unified_state_dict(sd)
    _, jcomp = jax_split(sd)
    return companions_from_state_dict(comp), to_jnp(unified_companions_to_params(jcomp))


def _special(golden, seed=None):
    if seed is None:
        return {k[len("st::"):]: golden[k] for k in golden.files if k.startswith("st::")}
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((1, 48)).astype(np.float32)
            for k in ("<img_st>", "<img_ed>", "<ipl_st>", "<ipl_ed>", "<prp_st>", "<prp_ed>")}


@pytest.mark.parametrize("order,mode,with_special,aligned", [
    ("v2", "full", True, False),
    ("v2", "full", False, True),
    ("v2", "text_only", True, False),
    ("v1", "full", True, True),
    ("v1", "aligned_emb_with_text", True, True),
    ("v2", "aligned_emb_only", False, True),
    ("v2", "visual_with_aligned_emb", True, True),
])
def test_mixed_context_matches_jax(golden, companions, order, mode, with_special, aligned):
    tcomp, jcomp = companions
    rng = np.random.default_rng(len(order + mode))
    ctx, arv, vis = golden["ctx"], golden["ar_vision"], golden["visual_emb"]
    ali = rng.standard_normal((4, 48)).astype(np.float32) if aligned else None
    ref_img = rng.standard_normal((4, 1, 8, 8)).astype(np.float32) if order == "v1" else None
    st = _special(golden, seed=3) if with_special else None
    ref = jax_build(jcomp, JCFG, context=jnp.asarray(ctx), ar_vision=jnp.asarray(arv),
                    visual_emb=jnp.asarray(vis),
                    aligned_emb=None if ali is None else jnp.asarray(ali),
                    special_tokens=None if st is None else {k: jnp.asarray(v) for k, v in st.items()},
                    condition_mode=mode,
                    ref_images=None if ref_img is None else jnp.asarray(ref_img), order=order)
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    out = build_mixed_context(tcomp, CFG, context=t(ctx), ar_vision=t(arv), visual_emb=t(vis),
                              aligned_emb=t(ali),
                              special_tokens=None if st is None else {k: t(v) for k, v in st.items()},
                              condition_mode=mode, ref_images=t(ref_img), order=order)
    assert out.shape == (40, 48) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_golden_unified_forward(golden, companions):
    """Reference unified state dict → port companions + DiT → reference out."""
    tcomp, _ = companions
    sd = {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")}
    wan_sd, _ = split_unified_state_dict(sd)
    mixed = build_mixed_context(
        tcomp, CFG, context=torch.tensor(golden["ctx"]),
        ar_vision=torch.tensor(golden["ar_vision"]),
        visual_emb=torch.tensor(golden["visual_emb"]),
        special_tokens={k: torch.tensor(v) for k, v in _special(golden).items()})
    model = load_wan_state_dict(
        WanDiT(CFG.dit.replace(text_len=40), dtype=torch.float32, device="cpu"), wan_sd)
    with torch.inference_mode():
        out = model(torch.tensor(golden["x"]), torch.tensor(golden["t"]), mixed[None],
                    seq_len=3 * 4 * 4).numpy()
    np.testing.assert_allclose(out, golden["out"], rtol=3e-4, atol=3e-4)


def test_null_ar_vision_and_truncation(companions):
    tcomp, _ = companions
    n = null_ar_vision(24)
    np.testing.assert_allclose(n.numpy(), np.full((2, 24), 1e-6, np.float32), rtol=1e-6)
    long_ctx = torch.randn(55, 48)
    out = build_mixed_context(tcomp, CFG, context=long_ctx)
    torch.testing.assert_close(out, long_ctx[:40], rtol=0, atol=0)
    empty = build_mixed_context(tcomp, CFG)
    assert empty.shape == (40, 48) and float(empty.abs().max()) == 0.0


def test_vca_matches_jax(companions):
    from omnivideo_tpu.models.visual_context_adapter import vca_apply as jax_vca
    from omnivideo_tpu_torch.models.visual_context_adapter import vca_apply

    tcomp, jcomp = companions
    x = np.random.default_rng(5).standard_normal((2, 4, 3, 8, 8)).astype(np.float32)
    ref = jax_vca(jcomp["visual_context_adapter"], jnp.asarray(x), (1, 4, 4), 1e-6)
    out = vca_apply(tcomp["visual_context_adapter"], torch.tensor(x), (1, 4, 4), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert jax.tree_util.tree_structure(jcomp) is not None


@pytest.mark.parametrize("with_special,aligned,truncate", [
    (True, True, False), (False, True, False), (True, False, True)])
def test_mixed_context_batch_matches_jax(companions, with_special, aligned, truncate):
    """The training assembly, batched, against build_mixed_context_batch; the
    companions as trainable parameters (Companions) read like the dict."""
    from omnivideo_tpu.models.unified import build_mixed_context_batch as jax_batch
    from omnivideo_tpu_torch.models.unified import Companions, build_mixed_context_batch

    tcomp, jcomp = companions
    rng = np.random.default_rng(11)
    B = 2
    ctx = rng.standard_normal((B, 7, 48)).astype(np.float32)
    vlm = rng.standard_normal((B, 5, 24)).astype(np.float32)
    vis = rng.standard_normal((B, 4, 3, 8, 8)).astype(np.float32)
    ali = rng.standard_normal((B, 4, 48)).astype(np.float32) if aligned else None
    st = _special(None, seed=4) if with_special else None
    jcfg = JCFG.replace(max_context_len=20) if truncate else JCFG
    cfg = CFG.replace(max_context_len=20) if truncate else CFG
    ref = jax_batch(jcomp, jcfg, text_ctx=jnp.asarray(ctx), vlm=jnp.asarray(vlm),
                    visual_emb=jnp.asarray(vis),
                    special_tokens=None if st is None else {k: jnp.asarray(v) for k, v in st.items()},
                    aligned_emb=None if ali is None else jnp.asarray(ali))
    params = Companions(tcomp)
    assert {n for n, _ in params.named_parameters()} >= {"vlm_norm", "vlm_proj.kernel",
                                                         "visual_context_adapter.projection.bias"}
    out = build_mixed_context_batch(
        params, cfg, text_ctx=torch.tensor(ctx), vlm=torch.tensor(vlm),
        visual_emb=torch.tensor(vis),
        special_tokens=None if st is None else {k: torch.tensor(v) for k, v in st.items()},
        aligned_emb=None if ali is None else torch.tensor(ali))
    assert out.shape == (B, cfg.max_context_len, 48) and out.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
