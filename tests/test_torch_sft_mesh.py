"""The port's SFT step over 4 real gloo ranks (tests/torch_sp_workers.py
`sft_mesh_worker`, one spawn) against the same step in one process, on the
JAX CLI's `--tiny` Qwen3 and chain carried from JAX (the one-process step
is held to JAX's in tests/test_torch_sft.py) with the combined loss.

Meshes: dp2×fsdp2, dp2×sp2 (the token-causal ring over padded rows), fsdp2
× tp2 (the LM whole over 'tensor') and sp4; each --dp mesh splits a global
batch of 4 rows whose target counts differ, so the loss must be divided by
the global count. 2 steps each: the loss, lm_loss, align_loss and
grad_norm within 2e-3 relative, num_targets equal, and every step-1 leaf
gradient within 1e-2 of its norm. LoRA (rank 4, the base frozen) on
dp2×fsdp2 against LoRA in one process the same way. Then the sft_vlm CLI
under --fsdp 2 --sp 2 and --dp 2 --tp 2, and under --fsdp 2 --sp 2 stopped
after one step and resumed from the full checkpoint: its metrics equal the
one-process CLI's within 2e-3."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from omnivideo_tpu_torch.io import jax_bridge as jb
from omnivideo_tpu_torch.tools import sft_vlm
from omnivideo_tpu_torch.training.sft import sft_collate
from torch_sft_tiny import SEQ, jax_setup, port_config, samples
from torch_sp_workers import SFT_MESHES, load, sft_mesh_worker, sft_steps, spawn

STEPS = 2
LOSS_TOL, GRAD_TOL = 2e-3, 1e-2
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, align_weight=1.0,
          cosine_weight=0.5)
CLI = ["--dummy_data", "--tiny", "--device", "cpu", "--total_steps", "2", "--warmup_steps", "1",
       "--lr", "1e-3", "--batch_size", "2", "--seq_len", "16", "--align_weight", "1",
       "--log_interval", "1"]
CLI_RUNS = [("fsdp2_sp2", CLI + ["--fsdp", "2", "--sp", "2", "--output_dir", "{tmp}/cli_fsdp2_sp2"]),
            ("dp2_tp2", CLI + ["--dp", "2", "--tp", "2", "--output_dir", "{tmp}/cli_dp2_tp2"])]
# stopped after step 1 under --fsdp 2 --sp 2, then resumed from its checkpoint to step 2
CLI_RUNS += [("resume_fsdp2_sp2", CLI + ["--fsdp", "2", "--sp", "2", "--output_dir",
                                         "{tmp}/cli_resume_fsdp2_sp2"] + extra)
             for extra in (["--total_steps", "1"], [])]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sft_mesh")
    jcfg, params = jax_setup(chain=True)
    sd = jb.sft_params_to_state_dict(params)
    batch = {k: v.numpy() for k, v in sft_collate(samples(5, n=4), SEQ).items()}
    counts = (batch["labels"][:, 1:] != -100).sum(1)
    assert counts[:2].sum() != counts[2:].sum()  # the two data ranks' target counts differ
    cfg_json = json.dumps(dataclasses.asdict(port_config(jcfg)))
    np.savez(tmp / "sft_inputs.npz", **{f"sd/{k}": v for k, v in sd.items()},
             **{f"batch/{k}": v for k, v in batch.items()}, cfg=np.array(cfg_json))
    spawn(sft_mesh_worker, tmp, TC, STEPS, CLI_RUNS)
    ref = sft_steps(None, sd, cfg_json, TC, batch, STEPS)
    lora = sft_steps(None, sd, cfg_json, TC, batch, STEPS, lora_rank=4)
    one = sft_vlm.run(sft_vlm.parse_args(CLI + ["--output_dir", str(tmp / "cli_one")]))
    return tmp, load(tmp, "sft_mesh"), {"full": ref, "lora": lora}, one


def _check(out, name, ref):
    for s, r in enumerate(ref):
        for k in ("loss", "lm_loss", "align_loss", "grad_norm"):
            got = float(out[f"{name}/{s}/{k}"])
            assert abs(got / r[k] - 1) < LOSS_TOL, (name, s, k, got, r[k])
        assert float(out[f"{name}/{s}/num_targets"]) == r["num_targets"]
    for n, want in ref[0]["grads"].items():
        got = out[f"{name}/0/grad/{n}"].reshape(want.shape)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < GRAD_TOL, (name, n, err)


@pytest.mark.parametrize("mesh", list(SFT_MESHES))
def test_mesh_step_matches_one_process(run, mesh):
    _, out, ref, _ = run
    _check(out, mesh, ref["full"])


def test_lora_mesh_step_matches_one_process(run):
    _, out, ref, _ = run
    _check(out, "lora_dp2_fsdp2", ref["lora"])
    assert all(n.endswith(("lora_a", "lora_b")) or n.startswith("chain.")
               for n in ref["lora"][0]["grads"])


@pytest.mark.parametrize("name", list(dict.fromkeys(c[0] for c in CLI_RUNS)))
def test_cli_under_mesh_matches_one_process(run, name):
    tmp, _, _, one = run
    recs = [json.loads(line) for line in (tmp / f"cli_{name}" / "metrics.jsonl").read_text()
            .splitlines()]
    assert len(recs) == len(one) == 2
    for got, want in zip(recs, one):
        for k in ("loss", "lm_loss", "align_loss", "grad_norm"):
            assert abs(got[k] / want[k] - 1) < LOSS_TOL, (name, k, got[k], want[k])
    assert (tmp / f"cli_{name}" / "checkpoints" / "2" / "state.pt").exists()
