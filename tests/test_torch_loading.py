"""The port's checkpoint loader (`pipelines/loading.py`) on the reference
bundle `tests/golden/bundle_tiny/` against the JAX `load_pipeline`, the
bundle's expert rewritten in the diffusers layout (sharded f32 safetensors
and companion `.bin` files) against the JAX `load_expert`, and the
dual-expert boundary split, on the CPU.

The bundle was written by the reference torch implementation: both unified
experts (the 'module' and 'model' wrappings), the Wan2.1 VAE, a bf16 umT5
`.pth` and `special_tokens.pkl`. Loaded params equal JAX's exactly (the same
arrays); the umT5 encodings agree to 1e-5 of scale, and a 4-step generate
that crosses the expert boundary to 1e-5 (latents) and 1e-4 (video, the VAE
convolutions sum in another order), as tests/test_torch_x2x.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import T5Config as JaxT5Config
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.t5 import t5_encode
from omnivideo_tpu.pipelines.loading import load_expert as jax_load_expert
from omnivideo_tpu.pipelines.loading import load_pipeline as jax_load_pipeline
from omnivideo_tpu_torch.configs.base import PipelineConfig, T5Config, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import wan_params_to_state_dict
from omnivideo_tpu_torch.io.torch_convert import load_torch_file, split_unified_state_dict
from omnivideo_tpu_torch.pipelines.loading import COMPANIONS, load_expert, load_pipeline
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
from omnivideo_tpu_torch.schedulers.unipc import FlowUniPC

BUNDLE = Path(__file__).parent / "golden" / "bundle_tiny"
DIT = dict(patch_size=(1, 2, 2), text_len=512, in_dim=4, dim=64, ffn_dim=128, freq_dim=32,
           text_dim=48, out_dim=4, num_heads=4, num_layers=2)
VAE = dict(dim=8, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=2,
           temperal_downsample=(False, True, True))
T5 = dict(vocab_size=64, dim=48, dim_attn=48, dim_ffn=96, num_heads=4, num_layers=2,
          num_buckets=8, text_len=16)
PIPE = dict(name="tiny-ckpt", vlm_in_dim=24, max_context_len=40, dual_expert=True, boundary=0.9,
            param_dtype="float32")
GEN = dict(size=(16, 16), frame_num=5, sampling_steps=4, guide_scale=(3.0, 4.0))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    jcfg = JaxPipelineConfig(dit=JaxDiTConfig(**DIT), vae=JaxVAEConfig(**VAE),
                             t5=JaxT5Config(**T5), **PIPE)
    cfg = PipelineConfig(dit=WanDiTConfig(**DIT), vae=VAEConfig(**VAE), t5=T5Config(**T5), **PIPE)
    return jcfg, cfg


@pytest.fixture(scope="module")
def pipes():
    jcfg, cfg = _cfgs()
    jpipe = jax_load_pipeline(jcfg, str(BUNDLE), dtype=jnp.float32, attn_impl="xla")
    tpipe = load_pipeline(cfg, str(BUNDLE), dtype=torch.float32, device="cpu")
    return jpipe, tpipe


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.numpy() if torch.is_tensor(v) else v, np.float32)
    return out


def _assert_expert_equal(j_exp, t_exp):
    ref = wan_params_to_state_dict(_np(j_exp.wan))
    got = {k: v.detach().numpy() for k, v in t_exp.wan.named_parameters()}
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k].reshape(got[k].shape), err_msg=k)
    jc, tc = _flat(_np(j_exp.companions)), _flat(t_exp.companions)
    assert set(jc) == set(tc) and jc
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)


def test_loaded_params_equal_jax(pipes):
    jpipe, tpipe = pipes
    assert tpipe.high_noise is not tpipe.low_noise
    for j_exp, t_exp in ((jpipe.low_noise, tpipe.low_noise), (jpipe.high_noise, tpipe.high_noise)):
        _assert_expert_equal(j_exp, t_exp)
    jv, tv = _flat(_np(jpipe.vae.params)), _flat(tpipe.vae.params)
    assert set(jv) == set(tv) and all(np.array_equal(tv[k], jv[k]) for k in jv)
    assert set(tpipe.special_tokens) == set(jpipe.special_tokens)
    for k, v in jpipe.special_tokens.items():
        np.testing.assert_array_equal(tpipe.special_tokens[k].numpy(), np.asarray(v))


def test_loaded_t5_encodes_as_jax(pipes):
    jpipe, tpipe = pipes
    ids = np.arange(12)[None] % T5["vocab_size"]
    mask = np.ones((1, 12), np.int64)
    mask[0, 9:] = 0
    ref = np.asarray(t5_encode(jpipe.text_encoder.params, jpipe.config.t5, jnp.asarray(ids),
                               jnp.asarray(mask)))
    out = tpipe.text_encoder.encoder(torch.tensor(ids), torch.tensor(mask)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    (stripped,) = tpipe.text_encoder.encode_ids(torch.tensor(ids), torch.tensor(mask))
    assert stripped.shape == (9, 48)


def test_bundle_generate_matches_jax(pipes):
    """Both experts run (boundary 0.9 over 4 steps), with a (low, high)
    guide-scale pair, through the loaded VAE."""
    jpipe, tpipe = pipes
    ctx = (0.1 * np.random.default_rng(0).standard_normal((10, 48))).astype(np.float32)
    shape = tpipe._latent_shape(GEN["size"], GEN["frame_num"])
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))[None]
    jkw = dict(precomputed_context=jnp.asarray(ctx), precomputed_context_null=jnp.zeros((10, 48)),
               seed=0, **GEN)
    tkw = dict(precomputed_context=torch.tensor(ctx), precomputed_context_null=torch.zeros(10, 48),
               noise=torch.tensor(noise), **GEN)
    n_high = int((FlowUniPC.create(4, shift=5.0).timesteps >= 900).sum())
    assert 0 < n_high < 4
    j_lat = np.asarray(jpipe.generate(decode=False, **jkw))
    t_lat = tpipe.generate(decode=False, **tkw).numpy()
    assert np.abs(t_lat - j_lat).max() / np.abs(j_lat).max() < 1e-5
    j_vid = np.asarray(jpipe.generate(**jkw))
    t_vid = tpipe.generate(**tkw).numpy()
    assert t_vid.shape == j_vid.shape == (3, 5, 16, 16)
    np.testing.assert_allclose(t_vid, j_vid, rtol=1e-4, atol=1e-4)


def test_dual_expert_boundary_split():
    """t ≥ boundary·T runs the high-noise expert, the rest the low-noise one:
    the step counts per expert follow the schedule, swapping the experts
    changes the result, and a (low, high) guide pair is accepted."""
    _, cfg = _cfgs()
    cfg = cfg.replace(boundary=0.5)
    pipe = OmniVideoX2XUnified.random_init(cfg, seed=0, with_vae=False, device="cpu")
    calls = {}
    for name, seed in (("low", 1), ("high", 2)):
        dit = getattr(pipe, f"{name}_noise").wan
        with torch.no_grad():
            dit.head.head.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(seed))
        dit.register_forward_hook(lambda *a, n=name: calls.__setitem__(n, calls.get(n, 0) + 1))
    n_high = int((FlowUniPC.create(6, shift=5.0).timesteps >= 500).sum())
    assert 0 < n_high < 6
    ctx = torch.randn(8, 48, generator=torch.Generator().manual_seed(3))
    kw = dict(precomputed_context=ctx, precomputed_context_null=ctx * 0, size=(32, 32),
              frame_num=1, sampling_steps=6, decode=False,
              noise=torch.randn(1, 4, 1, 4, 4, generator=torch.Generator().manual_seed(11)))
    lat = pipe.generate(**kw)
    assert calls == {"high": n_high, "low": 6 - n_high}
    pipe.low_noise, pipe.high_noise = pipe.high_noise, pipe.low_noise
    assert float((lat - pipe.generate(**kw)).abs().max()) > 1e-6
    assert bool(torch.isfinite(pipe.generate(**dict(kw, guide_scale=(3.0, 4.0)))).all())


@pytest.mark.parametrize("flat", [False, True])
def test_diffusers_layout_loads_as_jax(tmp_path, flat):
    """The bundle's low-noise expert as `wan_model/` (or the subfolder
    itself) holding two f32 safetensors shards, plus the three companion
    `.bin` files (their keys with and without the companion's prefix):
    the same params as JAX's load_expert, and as the model.pt it came from."""
    from safetensors.torch import save_file

    wan, comp = split_unified_state_dict(load_torch_file(BUNDLE / "low_noise_model" / "model.pt"))
    sub = tmp_path / "low_noise_model"
    wan_dir = sub if flat else sub / "wan_model"
    wan_dir.mkdir(parents=True)
    names = sorted(wan)
    for i, part in enumerate((names[::2], names[1::2])):
        save_file({k: wan[k].float().contiguous() for k in part},
                  str(wan_dir / f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    (wan_dir / "config.json").write_text("{}")
    for j, name in enumerate(COMPANIONS):
        part = {k: v for k, v in comp.items() if k.startswith(name + ".")}
        assert part, name
        if j % 2:
            part = {k[len(name) + 1:]: v for k, v in part.items()}
        torch.save(part, sub / f"{name}_pytorch_model.bin")
    jcfg, cfg = _cfgs()
    got = load_expert(cfg, str(tmp_path), "low_noise_model", torch.float32, device="cpu")
    _assert_expert_equal(jax_load_expert(jcfg, str(tmp_path), "low_noise_model", jnp.float32),
                         got)
    pt = load_expert(cfg, str(BUNDLE), "low_noise_model", torch.float32, device="cpu")
    for (k, a), (_, b) in zip(got.wan.named_parameters(), pt.wan.named_parameters()):
        assert torch.equal(a, b), k


def test_diffusers_layout_raises(tmp_path):
    """A diffusers-layout subfolder without weights (config.json only)
    raises, naming the formats it looked for."""
    (tmp_path / "low_noise_model").mkdir()
    (tmp_path / "low_noise_model" / "config.json").write_text("{}")
    _, cfg = _cfgs()
    with pytest.raises(FileNotFoundError, match="safetensors"):
        load_expert(cfg, str(tmp_path), "low_noise_model", device="cpu")
