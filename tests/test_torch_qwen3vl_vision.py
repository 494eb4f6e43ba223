"""The port's Qwen3-VL vision tower and preprocessing against the JAX
package, on the CPU, from one seeded HF-named state dict (no transformers).

Both towers take f32 patches, as the engines pass them. Tolerances: tokens
and deepstack features within 1e-5 of their scale at f32 (the two compute
the same f32 math in other summation orders), whichever attention the JAX
tower runs (its Pallas flash kernel in interpret mode, or dense softmax).
The bf16 rope mode and the bf16-weight tower within 1e-3 of scale: both
towers promote the stream to f32 at the position-embedding add, and the
port rounds q/k/v to bf16 at attention's input where the JAX flash reads
f32 (measured ≤ 1.8e-4; a bf16 residual stream, as HF keeps, reads 6e-3 to
9e-3 here). Host-side plans and media helpers are bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_qwen3vl_tiny import build, scale_err, tiny_config

from omnivideo_tpu.models.qwen3vl import preprocess as jpre
from omnivideo_tpu.models.qwen3vl import vision_model as jvis
from omnivideo_tpu.utils import qwen_vl_media as jmedia
from omnivideo_tpu_torch.models.qwen3vl import media, preprocess
from omnivideo_tpu_torch.models.qwen3vl import vision_model as pvis

GRID = (2, 4, 6)


def _patches(cfg, grid=GRID, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((int(np.prod(grid)), cfg.vision.patch_dim)).astype(np.float32)


def _run(params, jcfg, model, patches):
    ref_tok, ref_ds = jvis.vision_forward(params["vision"], jcfg.vision, jnp.asarray(patches), GRID)
    with torch.inference_mode():
        tok, ds = model.visual(torch.tensor(patches), GRID)
    assert tok.dtype == torch.float32 and ref_tok.dtype == jnp.float32  # the stream promotes
    assert len(ds) == len(ref_ds)
    return [(t.float().numpy(), np.asarray(r, np.float32))
            for t, r in zip([tok, *ds], [ref_tok, *ref_ds])]


@pytest.mark.parametrize("attn_impl", ["flash_interpret", "dense"])
def test_vision_tower_matches_jax_f32(attn_impl):
    cfg = tiny_config()
    params, jcfg, model = build(cfg, attn_impl=attn_impl)
    for out, ref in _run(params, jcfg, model, _patches(cfg)):
        assert out.shape == ref.shape == (np.prod(GRID) // 4, cfg.vision.out_hidden_size)
        assert scale_err(out, ref) <= 1e-5


@pytest.mark.parametrize("dtype,rope", [(torch.float32, "bfloat16"), (torch.bfloat16, "bfloat16"),
                                        (torch.bfloat16, "float32")])
def test_vision_tower_bf16_modes_match_jax(dtype, rope):
    cfg = tiny_config(rope_dtype=rope)
    params, jcfg, model = build(cfg, dtype=dtype, attn_impl="flash_interpret")
    for out, ref in _run(params, jcfg, model, _patches(cfg)):
        assert scale_err(out, ref) <= 1e-3


def test_host_plans_match_jax():
    for h, w, side in ((4, 6, 6), (30, 52, 48), (7, 3, 6)):
        for a, b in zip(pvis._pos_interp_plan(h, w, side), jvis._pos_interp_plan(h, w, side)):
            np.testing.assert_array_equal(a, b)
    for args in ((2, 4, 6, 8, 2), (3, 30, 52, 72, 2)):
        for a, b in zip(pvis._rope_table(*args), jvis._rope_table(*args)):
            np.testing.assert_array_equal(a, b)


def test_rotate_half_packed_matches_the_jax_permutation():
    """x @ kron(I_N, P) of the JAX tower is rotate_half per head, exactly."""
    N, hd = 3, 8
    x = np.random.default_rng(0).standard_normal((5, N * hd)).astype(np.float32)
    perm = np.kron(np.eye(N, dtype=np.float32), jvis._rotate_half_perm(hd))
    np.testing.assert_array_equal(pvis.rotate_half_packed(torch.tensor(x), N).numpy(), x @ perm)


def test_smart_resize_matches_jax():
    sizes = [(480, 832), (720, 1280), (1080, 1920), (100, 7000), (28, 28), (33, 4000)]
    budgets = [(480 * 480, 4 * 480 * 480), (480, 1920), (jmedia.MIN_PIXELS, jmedia.MAX_PIXELS)]
    for h, w in sizes:
        for lo, hi in budgets:
            for factor in (28, 32):
                assert media.smart_resize(h, w, factor, lo, hi) == jmedia.smart_resize(
                    h, w, factor, lo, hi)
    assert media.smart_resize(480, 832, 32, 480 * 480, 4 * 480 * 480) == (480, 832)
    with pytest.raises(ValueError):
        media.smart_resize(10, 4000)


@pytest.mark.parametrize("T", [6, 5])
def test_frames_to_patches_matches_jax(T):
    """Six 832x480 frames give the captioning grid (3, 30, 52); an odd frame
    count repeats the last frame."""
    frames = np.random.default_rng(T).integers(0, 256, (T, 64, 96, 3), dtype=np.uint8)
    out, grid = preprocess.frames_to_patches(frames, 16, 2, 2)
    ref, ref_grid = jpre.frames_to_patches(frames, 16, 2, 2)
    assert grid == ref_grid == (3, 4, 6)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(preprocess.CLIP_MEAN, jpre.CLIP_MEAN)
    np.testing.assert_array_equal(preprocess.CLIP_STD, jpre.CLIP_STD)
    full = np.zeros((6, 480, 832, 3), np.uint8)
    assert preprocess.frames_to_patches(full, 16, 2, 2)[1] == (3, 30, 52)
