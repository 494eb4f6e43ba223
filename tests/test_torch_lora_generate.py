"""The generate CLI with `--lora_adapters` against the JAX package's
pipeline with the same adapters merged into every expert, as JAX's CLI
merges them; CPU, the CLI's `--tiny` config from a tiny checkpoint dir.

The finetune CLI's `--tiny` DiT (dim 64, as JAX's) is narrower than the
generate CLI's (dim 256, head dim 128 for the kernels), so this reads an
adapter file that JAX's `save_adapters_npz` wrote for the generate
checkpoint's DiT. Its frames agree with JAX's within 5e-2 of the uint8
range (test_torch_generate_cli.py's limit; bf16 weights), with JAX's
noise."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_io_tiny import tiny_cli_config, write_tiny_checkpoint, write_umt5_tokenizer_dir

from omnivideo_tpu.pipelines.loading import load_pipeline as jax_load_pipeline
from omnivideo_tpu.training import lora as jlora
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
from omnivideo_tpu_torch.tools import generate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_generate_lora_adapters_matches_jax(tmp_path, monkeypatch):
    cfg, jcfg = tiny_cli_config()
    ckpt = write_tiny_checkpoint(tmp_path / "ckpt", cfg, write_umt5_tokenizer_dir(tmp_path / "t"))
    rows = [{"sample_id": "t2v_0", "prompt": "A red fox in the snow."}]
    (tmp_path / "in.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    pipe = jax_load_pipeline(jcfg, str(ckpt), residual_dtype="bfloat16")
    wan = jlora.inject_lora(pipe.low_noise.wan, jax.random.PRNGKey(5), 4)
    wan = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 if jax.tree_util.keystr(p).endswith("lora_b']") else x, wan)
    jlora.save_adapters_npz(wan, str(tmp_path / "ad.npz"))

    generate_fn = OmniVideoX2XUnified.generate

    def jax_noise(self, **kw):  # the JAX CLI's noise: normal(PRNGKey(base_seed + row))
        seed = kw.pop("generator").initial_seed()
        shape = self._latent_shape(kw["size"], kw["frame_num"])
        kw["noise"] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jnp.float32))[None])
        return generate_fn(self, **kw)

    frames, save_fn = {}, generate.save_video

    def capture(path, video, **kw):
        frames[str(path).rsplit(".", 1)[0]] = torch.as_tensor(video).numpy()
        return save_fn(path, video, **kw)

    monkeypatch.setattr(OmniVideoX2XUnified, "generate", jax_noise)
    monkeypatch.setattr(generate, "save_video", capture)
    argv = ["--task", "t2v-1.3B", "--tiny", "--ckpt_dir", str(ckpt), "--input",
            str(tmp_path / "in.jsonl"), "--device", "cpu"]
    plain = generate.run(generate.parse_args(argv + ["--output_dir", str(tmp_path / "o0")]))
    res = generate.run(generate.parse_args(argv + ["--output_dir", str(tmp_path / "o1"),
                                                   "--lora_adapters", str(tmp_path / "ad.npz")]))
    assert not torch.allclose(res[0]["latents"], plain[0]["latents"])
    got = frames[res[0]["path"].rsplit(".", 1)[0]]

    adapters = jlora.load_adapters_npz(str(tmp_path / "ad.npz"))
    experts = {id(pipe.low_noise): pipe.low_noise, id(pipe.high_noise): pipe.high_noise}
    for expert in experts.values():
        expert.wan = jlora.merge_lora(jlora.apply_lora_state(expert.wan, adapters))
    ref = np.asarray(pipe.generate(
        input_prompt=rows[0]["prompt"], size=(64, 32), frame_num=9, shift=jcfg.sample_shift,
        sampling_steps=2, guide_scale=jcfg.sample_guide_scale, seed=42, output_uint8=True))
    assert got.shape == ref.shape == (9, 32, 64, 3)
    err = np.abs(got.astype(np.float32) - ref) / 255.0
    assert err.max() < 5e-2, err.max()
