"""The Qwen3-VL engine with its expert banks split over gloo ranks (generate
`--vlm_fsdp n`, parallel/expert_shard.py) on the CPU, against the JAX
package's sharded run and the port's unsharded one. The tiny MoE of
tests/torch_qwen3vl_tiny.py takes an expert width of 96, which 2, 3 and 4
split into multiples of 8 (the kernels' width rule, checked on the CPU
too).

1. The MoE of layer 0 on 2 and 4 ranks against JAX `_moe` with its params
   placed by `params_shardings` on a (1, n, 1) CPU mesh (JAX engine.py's
   placement), f32: within 1e-5 of scale, and within 1e-5 of the sharded
   `moe_dense`.
2. The tiny Qwen3-VL sharded over 2 ranks, each rank's shard made by the
   bridge from JAX params: f32 features within 1e-5 of scale of JAX
   `qwen3vl_forward` over sharded params and greedy tokens equal to JAX
   `qwen3vl_greedy_decode`'s; bf16 (every token routed to all experts, so a
   bf16 router near-tie cannot swap experts between the runs) within 5e-2
   of scale of the port's unsharded run; the routing checked across the
   ranks at every MoE call (a routing made to differ raises on every
   rank), and the features bit-equal across them.
3. `Qwen3VLEngine(VLMConfig(fsdp=2, device="cpu"))` on a tiny checkpoint
   dir of transformers' fused `gate_up_proj` layout: each rank holds half
   the expert bytes and all the rest, the same caption and features on
   both ranks, and within 1e-5 of scale of the fsdp=1 engine (f32).
4. The generate CLI under gloo (`--tiny --random_weights`, the dir as
   `--vlm_path`, f32 residual): `--vlm_fsdp 2` gives the `--vlm_fsdp 1`
   captions, VLM features within 1e-5 of scale and latents within 1e-4 of
   scale (the sharded mesh CLI runs' limit in test_torch_sp_cli.py);
   `--vlm_fsdp 3` at world 2 raises, saying that 3 does not divide 2. The
   refusals without a process group and of a width the kernels cannot
   split are in test_torch_generate_cli.py and test_torch_sp_cli.py.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from torch_io_tiny import hf_config_dict, write_qwen3vl_tokenizer
from torch_qwen3vl_tiny import build, hf_state_dict, scale_err, tiny_config, video_inputs
from torch_shard_workers import model_worker, world2_worker
from torch_sp_workers import _save, load, spawn

from omnivideo_tpu.models.qwen3vl import full_model as jfull
from omnivideo_tpu.models.qwen3vl import text_model as jtext
from omnivideo_tpu.parallel.mesh import create_mesh
from omnivideo_tpu.parallel.sharding import params_shardings
from omnivideo_tpu_torch.io.jax_bridge import qwen3vl_params_to_state_dict
from omnivideo_tpu_torch.models.qwen3vl import full_model
from omnivideo_tpu_torch.models.qwen3vl.engine import Qwen3VLEngine, VLMConfig
from omnivideo_tpu_torch.parallel.expert_shard import shard_bytes
from omnivideo_tpu_torch.tools import generate

M = 96  # the experts' width: 48, 32 and 24 columns a rank at n = 2, 3, 4
TOL_F32 = 1e-5
TOL_BF16 = 5e-2
TOL_LATENTS = 1e-4
CLI_ARGS = ["--task", "t2v-1.3B", "--tiny", "--random_weights", "--device", "cpu",
            "--residual_dtype", "float32"]


def _config(k=None, hidden=48):
    cfg = tiny_config()
    text = dataclasses.replace(cfg.text, moe_intermediate_size=M, hidden_size=hidden,
                               num_experts_per_tok=k or cfg.text.num_experts_per_tok)
    return dataclasses.replace(cfg, text=text,
                               vision=dataclasses.replace(cfg.vision, out_hidden_size=hidden))


def _placed(params, n):
    mesh = create_mesh(1, n, 1)
    return jax.tree_util.tree_map(jax.device_put, params, params_shardings(params, mesh))


def _fused(sd, cfg):
    """Per-expert HF names → transformers' fused `gate_up_proj` [E, D, 2M]
    and `down_proj` [E, M, D], C-contiguous (safetensors writes an array's
    memory as it lies)."""
    out = {k: v for k, v in sd.items() if ".mlp.experts." not in k}
    for i in range(cfg.text.num_hidden_layers):
        p = f"model.language_model.layers.{i}.mlp.experts"
        e = range(cfg.text.num_experts)
        out[f"{p}.gate_up_proj"] = np.ascontiguousarray(np.stack([np.concatenate(
            [sd[f"{p}.{j}.gate_proj.weight"].T, sd[f"{p}.{j}.up_proj.weight"].T], -1) for j in e]))
        out[f"{p}.down_proj"] = np.ascontiguousarray(
            np.stack([sd[f"{p}.{j}.down_proj.weight"].T for j in e]))
    return out


def _vlm_dir(d):
    """A tiny f32 Qwen3-VL MoE checkpoint in the fused layout at the tiny
    DiT's VLM width (2,048), with its tokenizer."""
    cfg = _config(hidden=2048)
    d.mkdir(parents=True, exist_ok=True)
    save_file(_fused(hf_state_dict(cfg), cfg), str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(hf_config_dict(cfg)))
    write_qwen3vl_tokenizer(d)
    return d


def _inputs(tmp, cfg):
    ids, patches, grid = video_inputs(cfg)
    x = np.random.default_rng(5).standard_normal((1, 7, cfg.text.hidden_size)).astype(np.float32)
    _save(tmp, "inputs", ids=ids, patches=patches, grid=np.array(grid), x=x)
    return ids, patches, grid, x


def _shards(tmp, tag, params, n):
    for r in range(n):
        _save(tmp, f"sd_{tag}_{r}", **qwen3vl_params_to_state_dict(params, shard=(r, n)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    t = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(t)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of 2 ranks: the f32 and bf16 models (tests 1, 2), the
    engine and the CLI (tests 3, 4)."""
    tmp = tmp_path_factory.mktemp("shard2")
    f32, bf16 = _config(), _config(k=8)
    p32, _, _ = build(f32)
    pbf, _, _ = build(bf16, torch.bfloat16)
    _inputs(tmp, f32)
    _shards(tmp, "f32", p32, 2)
    _shards(tmp, "bf16", pbf, 2)
    vlm = _vlm_dir(tmp / "vlm")
    rows = tmp / "in.jsonl"
    rows.write_text(json.dumps({"sample_id": "a", "prompt": "tok3 tok4"}) + "\n")
    argv = CLI_ARGS + ["--input", str(rows), "--vlm_path", str(vlm)]
    spawn(world2_worker, tmp, [("f32", f32, torch.float32, True),
                               ("bf16", bf16, torch.bfloat16, False)], str(vlm),
          argv + ["--output_dir", str(tmp / "out2")], world=2)
    return tmp, argv


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard4")
    cfg = _config()
    params, _, _ = build(cfg)
    _inputs(tmp, cfg)
    _shards(tmp, "f32", params, 4)
    spawn(model_worker, tmp, [("f32", cfg, torch.float32, False)], world=4)
    return tmp


@pytest.mark.parametrize("n", [2, 4])
def test_moe_matches_jax_sharded(request, n):
    tmp = request.getfixturevalue("world2")[0] if n == 2 else request.getfixturevalue("world4")
    cfg = _config()
    params, jcfg, _ = build(cfg)
    layer0 = jax.tree_util.tree_map(lambda a: a[0], params["text"]["layers"]["mlp"])
    x = load(tmp, "inputs")["x"]
    ref = np.asarray(jtext._moe(_placed(layer0, n), jnp.asarray(x), jcfg.text))
    outs = [load(tmp, f"f32_{r}") for r in range(n)]
    for r, out in enumerate(outs):
        assert out["bank"].tolist() == [2, r * M // n, (r + 1) * M // n]
        assert scale_err(out["moe"], ref) <= TOL_F32, r
        assert scale_err(out["moe"], out["moe_dense"]) <= TOL_F32, r
        np.testing.assert_array_equal(out["moe"], outs[0]["moe"])
        np.testing.assert_array_equal(out["features"], outs[0]["features"])
        layers = cfg.text.num_hidden_layers  # the MoE call, a forward, (n = 2) 6 tokens' passes
        assert int(out["routing_checks"]) == 1 + layers + (6 * layers if n == 2 else 0)
        assert "routing differs across the ranks" in str(out["routing_error"])


def test_sharded_model_matches_jax_f32(world2):
    tmp, _ = world2
    cfg = _config()
    params, jcfg, _ = build(cfg)
    ids, patches, grid = (load(tmp, "inputs")[k] for k in ("ids", "patches", "grid"))
    grid = tuple(int(g) for g in grid)
    placed = _placed(params, 2)
    feats = jfull.qwen3vl_forward(placed, jcfg, ids, jnp.asarray(patches), grid)
    toks = jfull.qwen3vl_greedy_decode(placed, jcfg, ids, jnp.asarray(patches), grid,
                                       max_new_tokens=6)
    for r in range(2):
        out = load(tmp, f"f32_{r}")
        assert scale_err(out["features"], np.asarray(feats)) <= TOL_F32, r
        np.testing.assert_array_equal(out["tokens"], np.asarray(toks))


def test_sharded_model_bf16_matches_unsharded(world2):
    tmp, _ = world2
    cfg = _config(k=8)
    _, _, model = build(cfg, torch.bfloat16)
    inp = load(tmp, "inputs")
    ref = full_model.qwen3vl_forward(model, inp["ids"], inp["patches"],
                                     tuple(int(g) for g in inp["grid"])).float().numpy()
    outs = [load(tmp, f"bf16_{r}") for r in range(2)]
    for out in outs:
        assert scale_err(out["features"], ref) <= TOL_BF16
        np.testing.assert_array_equal(out["features"], outs[0]["features"])
        whole = shard_bytes(model)
        assert out["bytes"].tolist() == [whole["replicated"], whole["sharded"] // 2]


def test_engine_fsdp2_from_a_fused_dir(world2):
    tmp, _ = world2
    ref = Qwen3VLEngine(VLMConfig(model_path=str(tmp / "vlm"), device="cpu", max_new_tokens=4))
    whole = shard_bytes(ref.model)
    caption = ref.predict_target_video_caption("", "tok9 no")
    feats = ref.extract_features(None, "tok5 tok6 tok7")["vlm_last_hidden_states"].numpy()
    outs = [load(tmp, f"engine_cli_{r}") for r in range(2)]
    for out in outs:
        assert out["bytes"].tolist() == [whole["replicated"], whole["sharded"] // 2]
        assert str(out["caption"]) == caption
        assert scale_err(out["features"], feats) <= TOL_F32
        np.testing.assert_array_equal(out["features"], outs[0]["features"])


def test_cli_vlm_fsdp2_matches_fsdp1(world2, monkeypatch):
    tmp, argv = world2
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    stage, feats = generate.vlm_stage, {}

    def spy(*args, **kw):
        got = stage(*args, **kw)
        feats.update(got)
        return got

    monkeypatch.setattr(generate, "vlm_stage", spy)
    (ref,) = generate.run(generate.parse_args(argv + ["--output_dir", str(tmp / "out1")]))
    for r in range(2):
        out = load(tmp, f"engine_cli_{r}")
        assert str(out["caption/a"]) == feats["a"]["target_caption"]
        assert scale_err(out["vlm/a"], feats["a"]["ar_vision_input"].numpy()) <= TOL_F32
        assert scale_err(out["latents/a"], ref["latents"].numpy()) <= TOL_LATENTS
        assert "--vlm_fsdp 3 does not divide the process group's 2 ranks" in str(
            out["fsdp3_error"])
    assert sorted(p.name for p in (tmp / "out2").iterdir()) == ["a.npz"]  # rank 0 alone writes


@pytest.mark.parametrize("layout", ["per_expert", "fused"])
@pytest.mark.parametrize("via", ["reader_take", "whole_tensors"])
def test_loader_reads_a_ranks_columns(tmp_path, layout, via):
    """Rank 1 of 2 loaded from HF names, in the per-expert or the fused
    layout, either with the reader taking only its columns from a
    safetensors dir (`expert_take`) or from whole tensors sliced by the
    loader: every parameter bit-equal to the bridge's shard of the same
    JAX params."""
    from omnivideo_tpu_torch.io.hf_reader import expert_take, iter_hf_safetensors, load_qwen3vl_hf
    from omnivideo_tpu_torch.parallel.expert_shard import ExpertShard

    cfg = _config()
    params, _, _ = build(cfg)
    sd = hf_state_dict(cfg)
    if layout == "fused":
        sd = _fused(sd, cfg)
    shard = ExpertShard(1, 2)
    if via == "reader_take":
        save_file(sd, str(tmp_path / "model.safetensors"))
        items = iter_hf_safetensors(str(tmp_path), device="cpu", take=expert_take(shard))
    else:
        items = ((k, torch.from_numpy(v)) for k, v in sd.items())
    model = load_qwen3vl_hf(full_model.Qwen3VLModel(cfg, torch.float32, device="cpu",
                                                    shard=shard), items)
    want = qwen3vl_params_to_state_dict(params, shard=(1, 2))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].detach(), torch.tensor(v).reshape(got[k].shape)), k
    assert got["language_model.layers.0.mlp.experts_down"].shape == (8, M // 2, 48)
