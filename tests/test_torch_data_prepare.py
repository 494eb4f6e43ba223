"""The port's offline data tools (omnivideo_tpu_torch/tools/data_prepare/)
against JAX's (tools/data_prepare/, run in-process) on the CPU, and the
port's finetune dataset reading what they write:

- sft_tokenize on the tiny tokenizer.json (transformers' fast tokenizer
  over the same file on the JAX side): the same files with the same keys,
  ids and labels, read back by training/sft.py `SFTDataset`;
- vae_feature_extract with --random_weights on a clip already at the target
  size (one frame at 32x16): the same files and keys (`latent_feature_tgt`,
  `latent_feature`, `prompt`), latents of JAX's shapes; with JAX's seeded
  VAE carried into the port (io/jax_bridge.py `to_torch`), the latents
  within 1e-4 of their scale;
- ar_feature_extract with the native engine on the tiny Qwen3-VL dir (both
  engines' captions cut to 4 new tokens at a 16-pixel short side, defaults
  the CLIs do not expose) adds
  `vlm_last_hidden_states`, `source_caption` and `target_caption` as JAX's
  does, features of JAX's shape within 1e-2 of scale (both engines at the
  default bf16 vision-rope mix, which rounds at other points);
- training/dataset.py `OmniVideoDataset` and `collate` read the result
  into latents, visual_emb and vlm.
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omnivideo_tpu_torch.io.jax_bridge import to_torch
from omnivideo_tpu_torch.models.vae2_1 import Wan21VAE
from omnivideo_tpu_torch.configs import WAN_CONFIGS
from omnivideo_tpu_torch.tools.data_prepare import ar_feature_extract, sft_tokenize
from omnivideo_tpu_torch.tools.data_prepare import vae_feature_extract
from omnivideo_tpu_torch.training.dataset import OmniVideoDataset, PadSpec, collate
from omnivideo_tpu_torch.training.sft import SFTDataset, sft_collate
from torch_io_tiny import write_qwen3vl_hf_dir, write_qwen3vl_tokenizer
from torch_sft_tiny import conversations, hf_tokenizer

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool(name, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / "data_prepare" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    mod.main()


def _files(d):
    return sorted(p.name for p in Path(d).iterdir())


def test_sft_tokenize_matches_jax(tmp_path, monkeypatch):
    tok = write_qwen3vl_tokenizer(tmp_path / "tok")
    data = tmp_path / "conv.jsonl"
    data.write_text("\n".join(json.dumps(r) for r in conversations(5, seed=7)))
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda path: hf_tokenizer(Path(path)))
    _jax_tool("sft_tokenize", ["--input", str(data), "--tokenizer", str(tok), "--output_dir",
                               str(tmp_path / "jax"), "--max_len", "40"], monkeypatch)
    assert sft_tokenize.main(["--input", str(data), "--tokenizer", str(tok), "--output_dir",
                              str(tmp_path / "port"), "--max_len", "40"]) == 0
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and 0 < len(names) <= 5
    for n in names:
        with np.load(tmp_path / "jax" / n) as a, np.load(tmp_path / "port" / n) as b:
            assert sorted(a.files) == sorted(b.files) == ["ids", "labels"]
            for k in a.files:
                np.testing.assert_array_equal(b[k], a[k])
    ds = SFTDataset(str(tmp_path / "port"))
    batch = sft_collate([ds[i] for i in range(len(ds))], 40)
    assert (batch["labels"] != -100).sum() > 0


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """JAX's and the port's stage-1 then stage-2 directories from one
    manifest (two rows, one with a source video)."""
    tmp = tmp_path_factory.mktemp("features")
    rng = np.random.default_rng(1)
    for name in ("a", "b"):
        np.savez(tmp / f"{name}.npz", frames=rng.integers(0, 256, (2, 16, 32, 3), np.uint8),
                 fps=16)
    rows = [{"id": "x", "video": str(tmp / "a.npz"), "caption": "tok1 tok2"},
            {"id": "y", "video": str(tmp / "b.npz"), "source_video": str(tmp / "a.npz"),
             "caption": "tok3 yes"}]
    (tmp / "m.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    return tmp


def test_vae_feature_extract_matches_jax(features, monkeypatch):
    tmp = features
    common = ["--manifest", str(tmp / "m.jsonl"), "--size", "32*16", "--frame_num", "1",
              "--random_weights"]
    _jax_tool("vae_feature_extract", common + ["--output_dir", str(tmp / "jax"), "--platform",
                                               "cpu"], monkeypatch)
    args = vae_feature_extract.parse_args(common + ["--output_dir", str(tmp / "port"),
                                                    "--device", "cpu"])
    vae_feature_extract.run(args)
    assert _files(tmp / "jax") == _files(tmp / "port") == ["sample_x.npz", "sample_y.npz"]
    for n in _files(tmp / "jax"):
        with np.load(tmp / "jax" / n) as a, np.load(tmp / "port" / n) as b:
            assert sorted(a.files) == sorted(b.files) == ["latent_feature", "latent_feature_tgt",
                                                          "prompt"]
            assert str(a["prompt"]) == str(b["prompt"])
            for k in ("latent_feature", "latent_feature_tgt"):
                assert a[k].shape == b[k].shape == (16, 1, 2, 4)
    # JAX's seeded VAE in the port: the same latents
    import jax

    from omnivideo_tpu.models.vae2_1 import init_vae as jinit

    cfg = WAN_CONFIGS["t2v-1.3B"]
    vae = Wan21VAE.create(to_torch(jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(0), cfg.vae))), cfg.vae)
    args.output_dir = str(tmp / "carried")
    vae_feature_extract.run(args, vae=vae)
    for n in _files(tmp / "jax"):
        with np.load(tmp / "jax" / n) as a, np.load(tmp / "carried" / n) as b:
            for k in ("latent_feature", "latent_feature_tgt"):
                assert np.abs(b[k] - a[k]).max() / np.abs(a[k]).max() < 1e-4, (n, k)


def test_ar_feature_extract_matches_jax_and_dataset_reads(features, monkeypatch):
    tmp = features
    vlm = write_qwen3vl_hf_dir(tmp / "vlm", transformers=False)
    import shutil

    for side in ("jax", "port"):
        shutil.copytree(tmp / "carried" if side == "port" else tmp / "jax", tmp / f"ar_{side}")
    (tmp / "m2.jsonl").write_text((tmp / "m.jsonl").read_text() + "\n"
                                  + json.dumps({"id": "z", "caption": "no file"}))
    argv = ["--manifest", str(tmp / "m2.jsonl"), "--vlm_path", str(vlm), "--backend", "jax"]
    from omnivideo_tpu.models.qwen3vl import engine as jengine
    from omnivideo_tpu_torch.models.qwen3vl import engine as pengine

    for mod in (jengine, pengine):
        monkeypatch.setattr(mod, "VLMConfig", functools.partial(
            mod.VLMConfig, max_new_tokens=4, target_short_side=16))
    _jax_tool("ar_feature_extract", argv + ["--features_dir", str(tmp / "ar_jax")], monkeypatch)
    written = ar_feature_extract.run(ar_feature_extract.parse_args(
        argv + ["--features_dir", str(tmp / "ar_port"), "--device", "cpu"]))
    assert [p.name for p in written] == ["sample_x.npz", "sample_y.npz"]
    for n in ("sample_x.npz", "sample_y.npz"):
        with (np.load(tmp / "ar_jax" / n, allow_pickle=True) as a,
              np.load(tmp / "ar_port" / n, allow_pickle=True) as b):
            assert sorted(a.files) == sorted(b.files)
            assert {"vlm_last_hidden_states", "source_caption", "target_caption"} <= set(b.files)
            h, r = b["vlm_last_hidden_states"], a["vlm_last_hidden_states"]
            assert h.shape == r.shape and h.dtype == np.float32
            assert np.abs(h - r).max() / np.abs(r).max() < 1e-2
    ds = OmniVideoDataset(str(tmp / "ar_port"))
    batch = collate([ds[0], ds[1]], PadSpec(text_len=8, vlm_len=64, latent_frames=1))
    assert batch["latents"].shape == batch["visual_emb"].shape == (2, 16, 1, 2, 4)
    assert batch["vlm"].shape == (2, 64, 48)
    assert "context" not in batch  # --random_weights writes no text_emb, as JAX's
    torch.testing.assert_close(torch.from_numpy(batch["latents"][0]),
                               torch.from_numpy(np.load(tmp / "carried" / "sample_x.npz")
                                                ["latent_feature_tgt"]))
