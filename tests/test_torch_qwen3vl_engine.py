"""The port's Qwen3-VL engine and its host side against the JAX package on
the CPU:

- the HF → port loader (io/hf_reader.py `load_qwen3vl_hf`) gives the same
  parameters, bit for bit, as the tests/torch_qwen3vl_tiny.py route (HF
  dict → JAX params → io/jax_bridge.py), from per-expert and from fused
  MoE names, and from a sharded safetensors dir with its config.json;
- `build_chat_ids` and `compute_system_prompt_drop_idx` equal JAX's;
- `preprocess_video_timestamps` gives JAX's grid and timestamps, and
  patches equal where no resize is needed and within one uint8 level
  (1/255 over the smallest CLIP std) after a resize;
- the engine over a tiny HF checkpoint dir (transformers `save_pretrained`,
  a `tokenizers` tokenizer with the ChatML and vision specials) and the
  JAX engine (`VLMConfig(backend="jax")`) give the same captions, token
  for token, on a clip already at its target sizes, and features within
  1e-5 of scale (f32 weights and the vision rope's f32 parity mode, the
  tolerance of tests/test_torch_qwen3vl_full.py; the bf16 rope mix rounds
  at other points in the two packages, tests/test_torch_qwen3vl_vision.py).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from torch_io_tiny import hf_config_dict, qwen3vl_tiny_config, write_qwen3vl_hf_dir
from torch_qwen3vl_tiny import build, hf_state_dict, tiny_config

from omnivideo_tpu.io.hf_reader import FastTokenizer as JaxFastTokenizer
from omnivideo_tpu.io.hf_reader import qwen3_text_config_from_hf as jax_text_config
from omnivideo_tpu.models.qwen3vl import engine as jengine
from omnivideo_tpu.models.qwen3vl import preprocess as jpre
from omnivideo_tpu_torch.io.hf_reader import (FastTokenizer, iter_hf_safetensors,
                                              load_hf_config, load_qwen3vl_hf,
                                              qwen3_text_config_from_hf, qwen3vl_config_from_hf)
from omnivideo_tpu_torch.io.safetensors import read_header
from omnivideo_tpu_torch.models.qwen3vl import engine, preprocess
from omnivideo_tpu_torch.models.qwen3vl.full_model import Qwen3VLModel

CLIP_STD_MIN = 0.26130258


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = write_qwen3vl_hf_dir(tmp_path_factory.mktemp("qwen3vl_hf"))
    rng = np.random.default_rng(2)
    np.savez(d / "clip.npz", frames=rng.integers(0, 256, (8, 24, 32, 3), dtype=np.uint8), fps=4)
    np.savez(d / "clip_big.npz", frames=rng.integers(0, 256, (7, 45, 70, 3), dtype=np.uint8),
             fps=5)
    return d


def _params(model):
    return {k: v.detach() for k, v in model.named_parameters()}


def _fused(sd, cfg):
    """The per-expert HF names → transformers' Qwen3-VL-MoE fused layout."""
    out = {k: v for k, v in sd.items() if ".mlp.experts." not in k}
    for i in range(cfg.text.num_hidden_layers):
        p = f"model.language_model.layers.{i}.mlp.experts"
        e = range(cfg.text.num_experts)
        out[f"{p}.gate_up_proj"] = np.stack([np.concatenate(
            [sd[f"{p}.{j}.gate_proj.weight"].T, sd[f"{p}.{j}.up_proj.weight"].T], -1) for j in e])
        out[f"{p}.down_proj"] = np.stack([sd[f"{p}.{j}.down_proj.weight"].T for j in e])
    return out


@pytest.mark.parametrize("layout", ["per_expert", "fused", "sharded_dir"])
def test_hf_loader_equals_the_jax_route(tmp_path, layout):
    cfg = tiny_config()
    _, _, ref = build(cfg)
    sd = hf_state_dict(cfg)
    if layout == "fused":
        sd = _fused(sd, cfg)
    if layout == "sharded_dir":
        names = sorted(sd)
        shards = {"a.safetensors": names[::2], "b.safetensors": names[1::2]}
        for f, keys in shards.items():
            save_file({k: sd[k] for k in keys}, str(tmp_path / f))
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: f for f, keys in shards.items() for k in keys}}))
        d = hf_config_dict(cfg)
        got_cfg = qwen3vl_config_from_hf(d)
        assert got_cfg == cfg
        jcfg = jengine.Qwen3VLEngine.jax_cfg_from_dict(d)
        assert dataclasses.asdict(jcfg.text).items() >= dataclasses.asdict(cfg.text).items()
        items = iter_hf_safetensors(str(tmp_path), device="cpu")
    else:
        items = ((k, torch.from_numpy(v)) for k, v in sd.items())
    model = load_qwen3vl_hf(Qwen3VLModel(cfg, torch.float32, device="cpu"), items)
    got, want = _params(model), _params(ref)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_hand_written_dir_has_transformers_layout(hf_dir, tmp_path):
    """The checkpoint dir the CLI test writes without transformers' model
    classes has the tensor names, shapes and config fields that
    transformers' save_pretrained writes."""
    mine = write_qwen3vl_hf_dir(tmp_path / "by_hand", transformers=False)
    heads = [read_header(d / "model.safetensors")[0] for d in (mine, hf_dir)]
    assert {k: e["shape"] for k, e in heads[0].items()} == {k: e["shape"]
                                                           for k, e in heads[1].items()}
    cfgs = [qwen3vl_config_from_hf(load_hf_config(str(d))) for d in (mine, hf_dir)]
    want = qwen3vl_tiny_config()
    assert cfgs[0] == cfgs[1] == want.replace(
        vision=dataclasses.replace(want.vision, rope_dtype="float32"))
    for d in (mine, hf_dir):
        text = dataclasses.asdict(qwen3_text_config_from_hf(str(d)))
        assert text.items() <= dataclasses.asdict(jax_text_config(str(d))).items()
        assert text == dataclasses.asdict(want.text)


def test_hf_loader_rejects_mismatches():
    cfg = tiny_config()
    sd = {k: torch.from_numpy(v) for k, v in hf_state_dict(cfg).items()}
    model = Qwen3VLModel(cfg, torch.float32, device="cpu")
    with pytest.raises(KeyError, match="unfilled"):
        load_qwen3vl_hf(model, ((k, v) for k, v in sd.items() if "pos_embed" not in k))
    with pytest.raises(KeyError, match="does not have"):
        load_qwen3vl_hf(model, list(sd.items()) + [("model.visual.extra", torch.ones(1))])


@pytest.mark.parametrize("grid,ts,system", [
    (None, None, None), ((2, 4, 4), [0.25, 1.5], "sys tok3"), ((3, 2, 4), None, "yes no"),
])
def test_chat_ids_and_drop_idx_equal_jax(hf_dir, grid, ts, system):
    ours, theirs = FastTokenizer(str(hf_dir)), JaxFastTokenizer(str(hf_dir))
    assert ours.eos_token_id == theirs.eos_token_id == 155
    got = preprocess.build_chat_ids(ours, "tok1 tok2 yes", system, grid, ts)
    ref = jpre.build_chat_ids(theirs, "tok1 tok2 yes", system, grid, ts)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    for sp in ("tok5 tok6", "", "a long system prompt"):
        assert (engine.compute_system_prompt_drop_idx(ours, sp)
                == jengine.compute_system_prompt_drop_idx(theirs, sp))
    assert ours.decode(got[0].tolist()) == theirs.decode(ref[0].tolist())


@pytest.mark.parametrize("clip,budget,resized", [
    ("clip.npz", (16 * 16, 4 * 16 * 16), False),  # 24x32 inside the caption budget
    ("clip.npz", (480, 1920), False),  # and inside the feature pass's
    ("clip_big.npz", (16 * 16, 4 * 16 * 16), True),
    ("clip_big.npz", (480, 1920), True),
])
def test_preprocess_video_timestamps_equal_jax(hf_dir, clip, budget, resized):
    kw = dict(patch_size=4, temporal_patch_size=2, merge_size=2, nframes=4,
              min_pixels=budget[0], max_pixels=budget[1])
    patches, grid, ts = preprocess.preprocess_video_timestamps(str(hf_dir / clip), device="cpu",
                                                               **kw)
    ref_p, ref_grid, ref_ts = jpre.preprocess_video_timestamps(str(hf_dir / clip), **kw)
    assert grid == ref_grid and ts == ref_ts and patches.shape == ref_p.shape
    err = np.abs(patches - ref_p).max()
    if resized:
        assert err <= 1 / (255 * CLIP_STD_MIN) + 1e-5
    else:
        assert err == 0


@pytest.fixture(scope="module")
def engines(hf_dir):
    kw = dict(model_path=str(hf_dir), backend="jax", max_new_tokens=6, video_nframes=4,
              target_short_side=16, vision_rope_dtype="float32")
    ours = engine.Qwen3VLEngine(engine.VLMConfig(device="cpu", **kw))
    theirs = jengine.Qwen3VLEngine(jengine.VLMConfig(**kw))
    return ours, theirs


def test_engine_matches_jax_engine(hf_dir, engines):
    ours, theirs = engines
    clip = str(hf_dir / "clip.npz")
    got = ours.generate_caption_and_extract_features(clip, "tok1 tok2 yes")
    ref = theirs.generate_caption_and_extract_features(clip, "tok1 tok2 yes")
    assert got["source_caption"] == ref["source_caption"] and got["source_caption"]
    assert got["target_caption"] == ref["target_caption"]
    h, r = got["vlm_last_hidden_states"].numpy(), np.asarray(ref["vlm_last_hidden_states"])
    assert h.shape == r.shape and h.shape[1] == 48
    assert np.abs(h - r).max() / np.abs(r).max() < 1e-5
    assert got["seq_len"] == ref["seq_len"] and got["hidden_dim"] == ref["hidden_dim"]
    assert ours.model.language_model.embed_tokens.weight.dtype == torch.float32  # the file's
    assert set(ours.timings) == {"source_caption_s", "target_caption_s", "features_s"}
    # text only (no clip): the T2V prompt expansion and text features
    assert (ours.predict_target_video_caption("", "tok9 no")
            == theirs.predict_target_video_caption("", "tok9 no"))
    assert ours.generate_source_video_caption(str(hf_dir / "missing.npz")) == ""


def test_from_model_and_unported_options(engines):
    ours, _ = engines
    other = engine.Qwen3VLEngine.from_model(ours.model, engine.VLMConfig(max_new_tokens=6,
                                                                         video_nframes=4),
                                            ours.tokenizer)
    assert other._eos == 155
    assert (other.predict_target_video_caption("", "tok9 no")
            == ours.predict_target_video_caption("", "tok9 no"))
    for cfg, err in ((engine.VLMConfig(backend="hf"), NotImplementedError),
                     (engine.VLMConfig(fsdp=2), NotImplementedError),
                     (engine.VLMConfig(backend="vllm"), ValueError)):
        with pytest.raises(err):
            engine.Qwen3VLEngine.from_model(ours.model, cfg, ours.tokenizer)
    with pytest.raises(NotImplementedError, match="item 4"):
        ours._generate([{"role": "user", "content": [{"type": "image", "image": "x.png"}]}])
    with pytest.raises(NotImplementedError, match="item 4"):
        preprocess.preprocess_image("x.png")
