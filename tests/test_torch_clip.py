"""The port's CLIP vision tower on the CPU:

- `clip_vision_forward(use_31_block=True)` against the reference golden
  `clip_tiny.npz` (rtol/atol 3e-4, as the JAX package's test), and the full
  stack (post-normed) and the penultimate block against JAX
  `clip_vision_forward` on JAX's `init_clip_vision` params carried across
  (`clip_params_to_state_dict`), f32, within 1e-5 of their scale;
- `preprocess_image` without Pillow: before the normalisation, within one
  uint8 level of Pillow's BICUBIC resize (downscale, upscale, and the size it
  already has), and the normalisation bit for bit that of JAX
  `preprocess_image` where the resized pixels agree.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omnivideo_tpu.models import clip_vision as jclip
from omnivideo_tpu_torch.io.jax_bridge import clip_params_to_state_dict
from omnivideo_tpu_torch.models.clip_vision import (
    CLIP_MEAN,
    CLIP_STD,
    CLIPVisionConfig,
    clip_vision_forward,
    clip_vision_from_state_dict,
    init_clip_vision,
    preprocess_image,
)

GOLDEN = Path(__file__).parent / "golden" / "clip_tiny.npz"
TINY = dict(image_size=32, patch_size=8, dim=64, mlp_ratio=4.0, num_heads=4, num_layers=3,
            pre_norm=True, activation="gelu")


def test_clip_use_31_block_matches_reference_golden():
    g = np.load(GOLDEN)
    sd = {k[len("sd::"):]: g[k] for k in g.files if k.startswith("sd::")}
    cfg = CLIPVisionConfig(**TINY)
    model = clip_vision_from_state_dict(sd, cfg, device="cpu")
    out = clip_vision_forward(model, cfg, torch.tensor(g["x"]), use_31_block=True)
    assert out.shape == (2, 17, 64)
    np.testing.assert_allclose(out.numpy(), g["out31"], rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("use_31_block", [True, False])
def test_clip_matches_jax_on_carried_params(use_31_block):
    kw = dict(TINY, image_size=28, patch_size=7, num_heads=4, activation="quick_gelu")
    jcfg = jclip.CLIPVisionConfig(**kw)
    params = jclip.init_clip_vision(jax.random.PRNGKey(2), jcfg, scale=0.1)
    rng = np.random.default_rng(3)
    # non-trivial norms and biases, which the init leaves at ones and zeros
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    x = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    ref = np.asarray(jclip.clip_vision_forward(params, jcfg, jnp.asarray(x), use_31_block))
    cfg = CLIPVisionConfig(**kw)
    model = clip_vision_from_state_dict(
        clip_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)), cfg, device="cpu")
    out = clip_vision_forward(model, cfg, torch.tensor(x), use_31_block).numpy()
    assert out.shape == ref.shape == (2, 17, 64)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


def test_init_clip_vision_shapes():
    cfg = CLIPVisionConfig(**TINY)
    model = init_clip_vision(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    out = model(torch.zeros(1, 3, 32, 32))
    assert out.shape == (1, cfg.num_tokens, 64) and bool(torch.isfinite(out).all())
    assert float(model.pos_embedding.detach().std()) > 0.01 and model.patch_embedding.bias is None


@pytest.mark.parametrize("shape,size", [((40, 60, 3), 32), ((180, 320, 3), 224),
                                        ((100, 80, 3), 224), ((224, 224, 3), 224)])
def test_preprocess_within_one_level_of_pillow(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    x = preprocess_image(img, size, device="cpu").numpy()
    assert x.shape == (1, 3, size, size)
    pixels = np.rint((x[0].transpose(1, 2, 0) * CLIP_STD + CLIP_MEAN) * 255.0)
    pil = np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC), np.float32)
    assert np.abs(pixels - pil).max() <= 1.0
    ref = jclip.preprocess_image(img, size)
    same = (pixels == pil).transpose(2, 0, 1)[None]
    np.testing.assert_array_equal(x[same], ref[same])
