"""The port's v1 API (omnivideo_tpu_torch/pipelines/generator.py
`OmniVideoGenerator`) from a tiny bundle on the CPU, against the JAX
package's `OmniVideoGenerator` on the same files.

The bundle: the reference x2x checkpoint dir of tests/torch_io_tiny.py at
the generate CLI's --tiny widths (bf16 experts, VAE, umT5 with its
tokenizer), the v1 nested `special_tokens/tokens.pkl`, an
`unconditioned_context/context.pkl` and a tiny Qwen3-VL `ar_model/`. Both
generators read the same special tokens and unconditioned context; their
`video_to_video` (the clip sampled, resized and VAE-encoded, the engine's
captions and features, the DiT on the JAX noise of the seed) writes frames
within 5e-2 of full scale of each other, the tiny checkpoint CLI's limit
(tests/test_torch_generate_cli.py: bf16 weights and residual).
`text_to_video` prepends the engine's target caption, and `text_to_image`
is one frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_io_tiny import (tiny_cli_config, write_qwen3vl_hf_dir, write_tiny_checkpoint,
                           write_umt5_tokenizer_dir)

from omnivideo_tpu.pipelines.generator import OmniVideoGenerator as JaxGenerator
from omnivideo_tpu_torch.pipelines.generator import OmniVideoGenerator
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified

SIZE, FRAMES, SEED = (64, 32), 9, 3
SPECIALS = ("<prp_st>", "<prp_ed>", "<img_st>", "<img_ed>")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundle")
    cfg, jcfg = tiny_cli_config()
    ckpt = write_tiny_checkpoint(root / "ckpt", cfg, write_umt5_tokenizer_dir(root / "umt5"))
    g = torch.Generator().manual_seed(9)
    (ckpt / "special_tokens").mkdir()
    torch.save({k: torch.randn(1, cfg.dit.text_dim, generator=g) for k in SPECIALS},
               ckpt / "special_tokens" / "tokens.pkl")
    (ckpt / "unconditioned_context").mkdir()
    torch.save({"uncond_context": torch.randn(5, cfg.dit.text_dim, generator=g)},
               ckpt / "unconditioned_context" / "context.pkl")
    write_qwen3vl_hf_dir(ckpt / "ar_model", hidden_size=cfg.vlm_in_dim, patch_size=16,
                         transformers=False)
    clip = np.random.default_rng(1).integers(0, 256, (20, 40, 72, 3), dtype=np.uint8)
    np.savez(root / "clip.npz", frames=clip, fps=32)
    return cfg, jcfg, ckpt, root / "clip.npz"


@pytest.fixture(scope="module")
def generators(bundle):
    cfg, jcfg, ckpt, _ = bundle
    port = OmniVideoGenerator(str(ckpt), config=cfg, device="cpu")
    jax_gen = JaxGenerator(str(ckpt), config=jcfg)
    for vlm_cfg in (port.vlm.cfg, jax_gen.vlm.cfg):  # short captions keep the decode cheap
        vlm_cfg.max_new_tokens = 4
    return port, jax_gen


def test_bundle_pieces_equal_jax(generators):
    port, jax_gen = generators
    assert set(port.pipe.special_tokens) == set(jax_gen.pipe.special_tokens) == set(SPECIALS)
    for k in SPECIALS:
        np.testing.assert_array_equal(port.pipe.special_tokens[k].numpy(),
                                      np.asarray(jax_gen.pipe.special_tokens[k]))
    np.testing.assert_array_equal(port.unconditioned_context.numpy(),
                                  np.asarray(jax_gen.unconditioned_context))
    assert port.pipe.text_encoder is not None and port.vlm is not None


def _jax_noise(monkeypatch):
    """The port's generate on the noise JAX draws for the seed."""
    real = OmniVideoX2XUnified.generate

    def with_noise(self, **kw):
        seed = kw.pop("generator").initial_seed()
        shape = self._latent_shape(kw["size"], kw["frame_num"])
        kw["noise"] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jnp.float32))[None])
        return real(self, **kw)

    monkeypatch.setattr(OmniVideoX2XUnified, "generate", with_noise)


def test_video_to_video_matches_jax(bundle, generators, monkeypatch):
    cfg, jcfg, _, clip = bundle
    port, jax_gen = generators
    kw = dict(size=SIZE, frame_num=FRAMES, sampling_steps=2, shift=cfg.sample_shift,
              guide_scale=cfg.sample_guide_scale, seed=SEED, output_uint8=True)
    ref = np.asarray(jax_gen.video_to_video(str(clip), "replace the dog.", **kw))
    _jax_noise(monkeypatch)
    got = port.video_to_video(str(clip), "replace the dog.", **kw).numpy()
    assert got.shape == ref.shape == (FRAMES, SIZE[1], SIZE[0], 3)
    err = np.abs(got.astype(np.float32) - ref) / 255.0
    assert err.max() < 5e-2, err.max()


def test_text_to_video_and_image(generators, monkeypatch):
    port, _ = generators
    seen = []
    real = OmniVideoX2XUnified.generate

    def spy(self, **kw):
        seen.append((kw["input_prompt"], tuple(kw["ar_vision_input"].shape),
                     kw["generator"].initial_seed()))
        return real(self, **kw)

    monkeypatch.setattr(OmniVideoX2XUnified, "generate", spy)
    caption = port.vlm.predict_target_video_caption("", "a red fox")
    v = port.text_to_video("a red fox", size=SIZE, frame_num=5, sampling_steps=1, seed=SEED)
    img = port.text_to_image("a red fox", size=SIZE, sampling_steps=1, seed=SEED)
    assert tuple(v.shape) == (3, 5, SIZE[1], SIZE[0]) and tuple(img.shape) == (3, 1, SIZE[1],
                                                                             SIZE[0])
    assert seen[0][0] == (caption + " a red fox").strip() and seen[0][2] == SEED
    assert seen[0][1][1] == port.config.vlm_in_dim
