"""The port's generate CLI (`python -m omnivideo_tpu_torch.tools.generate`)
on the CPU: `--tiny --random_weights` T2V and V2V rows (a `.npy` source clip
through the VAE encode, VLM features from `--features_dir`), the
dual-expert A14B path (denoise, free the experts, decode) with both solvers,
and the flags that are not ported."""

import json

import numpy as np
import pytest
import torch

from omnivideo_tpu_torch.tools import generate


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
        data = np.load(out / f"{name}.npz")
        frames = data["frames"]
        assert frames.shape == (9, 32, 64, 3) and frames.dtype == np.uint8
        assert int(data["fps"]) == 16 and frames.std() > 0


def test_read_clip_samples_and_pads(tmp_path):
    frames = np.arange(5, dtype=np.uint8)[:, None, None, None] * np.ones((5, 2, 4, 3), np.uint8)
    np.savez(tmp_path / "c.npz", frames=frames, fps=32)
    clip = generate.read_clip(str(tmp_path / "c.npz"), 5, (4, 2), 16.0)
    assert clip.shape == (3, 5, 2, 4)
    np.testing.assert_array_equal(clip[0, :, 0, 0].numpy(),
                                  np.array([0, 2, 4, 4, 4], np.float32) / 127.5 - 1.0)
    with pytest.raises(ValueError, match="resizing"):
        generate.read_clip(str(tmp_path / "c.npz"), 5, (8, 2), 16.0)
    with pytest.raises(NotImplementedError, match="npy"):
        generate.read_clip(str(tmp_path / "c.avi"), 5, (4, 2), 16.0)


@pytest.mark.parametrize("flag", [["--sp_size", "2"], ["--layer_stream"],
                                  ["--max_steps_per_call", "3"], ["--vlm_path", "x"]])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        generate.parse_args(["--input", "x.jsonl", "--random_weights"] + flag)
