"""The port's sft_vlm CLI (omnivideo_tpu_torch/tools/sft_vlm.py) on the CPU:
--dummy_data --tiny runs and writes metrics.jsonl, run_config.yaml and
checkpoints; a run resumed after 2 steps takes steps 3 and 4 as an
uninterrupted run of 4 does (losses and final parameters bit-equal: the
same ops on the same CPU); --config YAML sets flags and flags typed win;
--lora_rank moves only the adapters and the chain; --conversations with
--model_path (an HF text-only Qwen3 dir and its tokenizer.json, built
here) takes the first batch JAX's pipeline takes: the step-0 lm_loss
within 1e-5 relative of JAX's lm_loss on the same weights (`hf_to_params`)
and data (its ConversationDataset and loader)."""

import json

import jax.numpy as jnp
import numpy as np
import torch

from omnivideo_tpu.models.qwen3vl.text_model import Qwen3TextConfig as JText
from omnivideo_tpu.models.qwen3vl.text_model import hf_to_params
from omnivideo_tpu.training import conversation as jconv
from omnivideo_tpu.training import sft as jsft
from omnivideo_tpu_torch.tools import sft_vlm
from torch_sft_tiny import conversations, hf_tokenizer, write_qwen3_text_dir

TINY = ["--dummy_data", "--tiny", "--device", "cpu", "--warmup_steps", "1", "--lr", "1e-3",
        "--log_interval", "1", "--batch_size", "2"]


def _cli(out, *extra):
    return sft_vlm.run(sft_vlm.parse_args(TINY + ["--output_dir", str(out), *extra]))


def _final(out):
    ck = sorted((out / "checkpoints").iterdir(), key=lambda p: int(p.name))[-1]
    return torch.load(ck / "state.pt", weights_only=True)


def test_dummy_tiny_runs_and_writes(tmp_path):
    recs = _cli(tmp_path, "--total_steps", "4", "--align_weight", "1")
    lines = [json.loads(s) for s in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2, 3] and lines == recs
    assert all(np.isfinite(r["loss"]) and "align_loss" in r for r in lines)
    assert abs(lines[0]["loss"] - lines[0]["lm_loss"] - lines[0]["align_loss"]) < 1e-5
    assert (tmp_path / "run_config.yaml").exists()
    state = _final(tmp_path)
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    assert any(k.startswith("chain.") for k in state["params"])


def test_resume_equals_uninterrupted(tmp_path):
    whole = _cli(tmp_path / "whole", "--total_steps", "4", "--align_weight", "1")
    _cli(tmp_path / "split", "--total_steps", "2", "--align_weight", "1")
    rest = _cli(tmp_path / "split", "--total_steps", "4", "--align_weight", "1")
    assert [r["step"] for r in rest] == [2, 3]
    assert [r["loss"] for r in rest] == [r["loss"] for r in whole[2:]]
    a, b = _final(tmp_path / "whole"), _final(tmp_path / "split")
    for k, v in a["params"].items():
        torch.testing.assert_close(b["params"][k], v, rtol=0, atol=0, msg=k)


def test_config_yaml_and_typed_flags(tmp_path):
    cfg = tmp_path / "run.yaml"
    cfg.write_text("total_steps: 3\nlora_rank: 4\nalign_weight: 0.5\nseed: 3\n")
    args = sft_vlm.parse_args(TINY + ["--config", str(cfg), "--seed", "5",
                                      "--output_dir", str(tmp_path / "o")])
    assert (args.total_steps, args.lora_rank, args.align_weight, args.seed) == (3, 4, 0.5, 5)
    recs = sft_vlm.run(args)
    assert len(recs) == 3
    written = (tmp_path / "o" / "run_config.yaml").read_text()
    assert "lora_rank: 4" in written and "seed: 5" in written


def test_lora_moves_only_adapters_and_chain(tmp_path):
    args = sft_vlm.parse_args(TINY + ["--total_steps", "3", "--lora_rank", "4",
                                      "--align_weight", "1", "--output_dir", str(tmp_path)])
    _, lm0 = sft_vlm.build_lm(args, torch.device("cpu"))
    sft_vlm.run(args)
    params = _final(tmp_path)["params"]
    base = {f"lm.{k}": v for k, v in lm0.state_dict().items()}
    for k, v in params.items():
        if k in base:
            torch.testing.assert_close(v, base[k], rtol=0, atol=0, msg=k)
    moved = [k for k in params if k.endswith("lora_b") and params[k].abs().max() > 0]
    assert moved
    assert any(k.startswith("chain.") for k in params)


def test_conversations_first_step_matches_jax(tmp_path):
    d = write_qwen3_text_dir(tmp_path / "qwen3")
    path = tmp_path / "conv.json"
    path.write_text(json.dumps(conversations(6, seed=4)))
    recs = sft_vlm.run(sft_vlm.parse_args([
        "--model_path", str(d), "--conversations", str(path), "--device", "cpu",
        "--total_steps", "1", "--batch_size", "2", "--seq_len", "48", "--group_by_length",
        "--output_dir", str(tmp_path / "o"), "--seed", "2"]))
    conf = json.loads((d / "config.json").read_text())
    jcfg = JText(**{k: conf[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                                         "num_hidden_layers", "num_attention_heads",
                                         "num_key_value_heads", "head_dim", "rope_theta",
                                         "rms_norm_eps")}, attn_impl="dense")
    from safetensors.numpy import load_file

    params = hf_to_params(load_file(str(d / "model.safetensors")), jcfg)
    ds = jconv.ConversationDataset(str(path), hf_tokenizer(d))
    batch = next(jsft.sft_data_loader(ds, 2, 48, seed=2, group_by_length=True))
    ref, n = jsft.lm_loss(params, jcfg, batch["ids"], batch["labels"], batch["attn_mask"])
    assert recs[0]["num_targets"] == float(n) > 0
    assert abs(recs[0]["lm_loss"] / float(ref) - 1) < 1e-5
