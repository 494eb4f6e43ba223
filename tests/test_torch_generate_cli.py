"""The port's generate CLI (`python -m omnivideo_tpu_torch.tools.generate`)
on the CPU: `--tiny --random_weights` T2V and V2V rows (a `.npy` source clip
through the VAE encode, VLM features from `--features_dir`), the
dual-expert A14B path (denoise, free the experts, decode) with both solvers,
the clip reader, the flags that are not ported, and a run from a tiny
checkpoint dir (diffusers-layout expert, VAE, umT5 and its tokenizer) with
prompt strings, an MJPEG `.avi` clip of another size and `--vlm_path` on a
tiny Qwen3-VL HF dir, whose frames, before the lossy writer, agree with the
JAX package's pipeline and engine run the way the JAX CLI runs them on the
same files, within 5e-2 of the uint8 range (the tiny generate's limit in
chip_smoke.py; bf16 weights), with the same noise."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_io_tiny import (tiny_cli_config, write_qwen3vl_hf_dir, write_tiny_checkpoint,
                           write_umt5_tokenizer_dir)

from omnivideo_tpu.models.qwen3vl import engine as jax_engine
from omnivideo_tpu.pipelines.loading import load_pipeline as jax_load_pipeline
from omnivideo_tpu.utils import avi as jax_avi
from omnivideo_tpu.utils import video as jax_video
from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
from omnivideo_tpu_torch.tools import generate
from omnivideo_tpu_torch.utils.video import read_video_frames


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(tmp_path):
    clip = np.random.default_rng(0).integers(0, 256, (12, 32, 64, 3), dtype=np.uint8)
    np.save(tmp_path / "clip.npy", clip)
    feats = tmp_path / "feats"
    feats.mkdir()
    np.savez(feats / "sample_edit_0.npz",
             vlm_last_hidden_states=np.ones((1, 5, 2048), np.float32),
             target_caption=np.array("a gray rabbit"))
    rows = [{"sample_id": "t2v_0", "prompt": "A red fox in the snow."},
            {"id": "edit_0", "source_clip_path": str(tmp_path / "clip.npy"),
             "edit_prompt": "Replace the dog with a rabbit."}]
    (tmp_path / "in.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return ["--input", str(tmp_path / "in.jsonl"), "--features_dir", str(feats),
            "--random_weights", "--tiny", "--device", "cpu"]


@pytest.mark.parametrize("task,solver,extra", [
    ("t2v-1.3B", "unipc", []),
    ("t2v-A14B", "dpm++", ["--residual_dtype", "float32", "--ew_impl", "kernel",
                           "--sample_steps", "3"]),
])
def test_cli_writes_uint8_frames(tmp_path, task, solver, extra):
    args = _inputs(tmp_path)
    out = tmp_path / "out"
    assert generate.main(args + ["--task", task, "--sample_solver", solver,
                                 "--output_dir", str(out)] + extra) == 0
    for name in ("t2v_0", "edit_0"):
        # no mp4 encoder here: save_video wrote MJPEG AVI
        frames, fps = read_video_frames(str(out / f"{name}.avi"))
        assert frames.shape == (9, 32, 64, 3) and frames.dtype == np.uint8
        assert fps == 16.0 and frames.std() > 0


def test_read_clip_samples_and_pads(tmp_path):
    """Every round(fps/16)-th frame, the last repeated; a clip of another
    size is resized to cover the output and center-cropped; AVI is read."""
    frames = np.arange(5, dtype=np.uint8)[:, None, None, None] * np.ones((5, 2, 4, 3), np.uint8)
    np.savez(tmp_path / "c.npz", frames=frames, fps=32)
    timings = {}
    clip = generate.read_clip(str(tmp_path / "c.npz"), 5, (4, 2), 16.0, "cpu", timings)
    assert clip.shape == (3, 5, 2, 4) and set(timings) == {"read_s", "transform_s"}
    np.testing.assert_allclose(clip[0, :, 0, 0].numpy(),
                               np.array([0, 2, 4, 4, 4], np.float32) / 127.5 - 1.0, atol=2.0**-23)
    clip = generate.read_clip(str(tmp_path / "c.npz"), 5, (8, 2), 16.0, "cpu")
    assert clip.shape == (3, 5, 2, 8)
    np.testing.assert_allclose(clip[0, :, 0, 0].numpy(),
                               np.array([0, 2, 4, 4, 4], np.float32) / 127.5 - 1.0, atol=2.0**-23)
    jax_avi.write_mjpeg_avi(str(tmp_path / "c.avi"), np.repeat(frames, 4, axis=1), fps=16)
    assert generate.read_clip(str(tmp_path / "c.avi"), 3, (4, 8), 16.0, "cpu").shape == (3, 3, 8,
                                                                                         4)


@pytest.mark.parametrize("flag", [["--vlm_fsdp", "2"], ["--max_steps_per_call", "3"],
                                  ["--vlm_backend", "hf"]])
def test_unported_flags_raise(tmp_path, flag, monkeypatch):
    """The flags the port does not run raise NotImplementedError; `--vlm_fsdp
    2` runs, and without a process group it is refused before any weight is
    read (the dir holds Qwen3-VL-30B-A3B's config.json alone)."""
    if flag[0] != "--vlm_fsdp":
        with pytest.raises(NotImplementedError, match="not ported"):
            generate.parse_args(["--input", "x.jsonl", "--random_weights"] + flag)
        return
    from omnivideo_tpu_torch.configs.qwen3vl import QWEN3_VL_30B_A3B
    from torch_io_tiny import hf_config_dict

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    (tmp_path / "config.json").write_text(json.dumps(hf_config_dict(QWEN3_VL_30B_A3B)))
    with pytest.raises(ValueError, match="needs an initialised process group"):
        generate.main(["--input", "x.jsonl", "--random_weights", "--device", "cpu",
                       "--vlm_path", str(tmp_path), "--output_dir", str(tmp_path)] + flag)


@pytest.mark.parametrize("flag", [["--stream_quant", "int8"], ["--stream_group", "2"],
                                  ["--layer_stream", "--sp_size", "2"]])
def test_stream_flags_are_checked(flag):
    """--stream_quant and --stream_group need --layer_stream, which is the
    single-device path."""
    with pytest.raises(SystemExit):
        generate.parse_args(["--input", "x.jsonl", "--random_weights"] + flag)


def test_cli_layer_stream_equals_resident(tmp_path):
    """--layer_stream (the expert's blocks read straight into host buffers
    from the checkpoint dir, streamed per step) gives the resident run's
    latents bit for bit, with --stream_group 2 too; --stream_quant int8 (the
    tiny model's bf16 weights of ≥ 4096 elements quantise) within 5e-2 of
    their scale, the tiny generate's limit, and not equal."""
    cfg, _ = tiny_cli_config()
    ckpt = write_tiny_checkpoint(tmp_path / "ckpt", cfg, write_umt5_tokenizer_dir(tmp_path / "t5"))
    (tmp_path / "in.jsonl").write_text(json.dumps({"sample_id": "t2v_0",
                                                   "prompt": "a red fox in the snow."}) + "\n")
    base = ["--task", "t2v-1.3B", "--tiny", "--ckpt_dir", str(ckpt), "--input",
            str(tmp_path / "in.jsonl"), "--device", "cpu"]

    def latents(name, *extra):
        (r,) = generate.run(generate.parse_args(base + ["--output_dir", str(tmp_path / name),
                                                        *extra]))
        assert len(r["timings"]["step_s"]) == 2
        return r["latents"]

    ref = latents("resident")
    assert torch.equal(latents("stream", "--layer_stream", "--stream_group", "2"), ref)
    q8 = latents("q8", "--layer_stream", "--stream_quant", "int8")
    assert 0 < float((q8 - ref).abs().max()) <= 5e-2 * float(ref.abs().max())


def test_cli_from_checkpoint_dir_matches_jax(tmp_path, monkeypatch):
    root = tmp_path
    cfg, jcfg = tiny_cli_config()
    ckpt = write_tiny_checkpoint(root / "ckpt", cfg, write_umt5_tokenizer_dir(root / "umt5"))
    vlm = write_qwen3vl_hf_dir(root / "vlm", hidden_size=cfg.vlm_in_dim, patch_size=16,
                               transformers=False)
    clip = np.random.default_rng(1).integers(0, 256, (20, 40, 72, 3), dtype=np.uint8)
    jax_avi.write_mjpeg_avi(str(root / "clip.avi"), clip, fps=32)
    rows = [{"id": "edit_0", "source_clip_path": str(root / "clip.avi"),
             "edit_prompt": "replace the dog with a gray rabbit."}]
    (root / "in.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")

    seeds, frames = [], {}
    generate_fn, save_fn = OmniVideoX2XUnified.generate, generate.save_video

    def jax_noise(self, **kw):  # the JAX CLI's noise: normal(PRNGKey(base_seed + row))
        seed = kw.pop("generator").initial_seed()
        seeds.append(seed)
        shape = self._latent_shape(kw["size"], kw["frame_num"])
        kw["noise"] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jnp.float32))[None])
        return generate_fn(self, **kw)

    def capture(path, video, **kw):
        frames[path.rsplit("/", 1)[1].split(".")[0]] = torch.as_tensor(video).numpy()
        return save_fn(path, video, **kw)

    monkeypatch.setattr(OmniVideoX2XUnified, "generate", jax_noise)
    monkeypatch.setattr(generate, "save_video", capture)
    results = generate.run(generate.parse_args([
        "--task", "t2v-1.3B", "--tiny", "--ckpt_dir", str(ckpt), "--vlm_path", str(vlm),
        "--input", str(root / "in.jsonl"), "--output_dir", str(root / "out"), "--device",
        "cpu"]))
    assert [r["id"] for r in results] == ["edit_0"] and seeds == [42]
    for r in results:
        written, fps = read_video_frames(r["path"])
        assert r["path"].endswith(".avi") and written.shape == (9, 32, 64, 3) and fps == 16.0
        assert {"source_caption_s", "features_s", "denoise_step_s", "decode_s",
                "save_s"} <= set(r["timings"])
    assert {"read_s", "transform_s", "encode_s"} <= set(results[0]["timings"])

    # the JAX CLI's steps on the same files
    eng = jax_engine.Qwen3VLEngine(jax_engine.VLMConfig(model_path=str(vlm), backend="jax"))
    pipe = jax_load_pipeline(jcfg, str(ckpt), residual_dtype="bfloat16")
    for idx, row in enumerate(rows):
        prompt = row.get("prompt", row.get("edit_prompt"))
        feats = eng.generate_caption_and_extract_features(row.get("source_clip_path"), prompt)
        visual_emb = None
        if "source_clip_path" in row:
            src, src_fps = jax_video.read_video_frames(row["source_clip_path"])
            c = jax_video.sample_and_transform_frames(src, 9, (64, 32), src_fps, jcfg.sample_fps)
            visual_emb = pipe.vae.encode(jnp.asarray(c)[None])[0][:, :3]
        ref = np.asarray(pipe.generate(
            input_prompt=(feats["target_caption"] + " " + prompt).strip(),
            ar_vision_input=jnp.asarray(feats["vlm_last_hidden_states"]),
            visual_emb=visual_emb, size=(64, 32), frame_num=9, shift=jcfg.sample_shift,
            sampling_steps=2, guide_scale=jcfg.sample_guide_scale, seed=42 + idx,
            output_uint8=True))
        got = frames[row.get("id", row.get("sample_id"))]
        assert got.shape == ref.shape == (9, 32, 64, 3)
        err = np.abs(got.astype(np.float32) - ref) / 255.0
        assert err.max() < 5e-2, (row, err.max())
