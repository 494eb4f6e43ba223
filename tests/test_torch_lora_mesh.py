"""LoRA, adafactor and the text-only Qwen3's sequence-parallel forward over 4
real gloo ranks (tests/torch_sp_workers.py `lora_mesh_worker`, one spawn),
held to the same code in one process (and the Qwen3 forward to JAX's).

- LoRA (AdamW, the base frozen) on the `--tiny` DiT with JAX's adapters
  (B perturbed), and adafactor (every parameter, adapters included) on a
  DiT wide enough that its block kernels are factored (dim 128, FFN 256),
  each on dp2×fsdp2 (FSDP2), dp2×tp2 (the Megatron split, adapters placed
  with their sites) and tp2×fsdp2, 2 steps: the loss within 1e-5 relative
  of the one-process step; the frozen base bit-equal to where it started;
  each adafactor parameter within 1e-6 of max(its largest magnitude,
  1e-2) (test_torch_train.py's floor: zero-initialised biases hold O(lr)
  values).
- The adafactor run saved under tp2×fsdp2 after step 1 (its factored
  statistics DTensors) and resumed under dp2×fsdp2 and in one process:
  step 2 as above.
- qwen3_forward_sp with bare adapters (B perturbed) over the ring of 4, a
  ring of 2 (beside a data axis) and ring 2 × Ulysses 2: hidden states and
  logits within 1e-5 of scale of the one-process qwen3_forward, which is
  itself within 1e-5 of JAX's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_tiny as tiny
from omnivideo_tpu.configs.base import PipelineConfig as JaxPipelineConfig
from omnivideo_tpu.configs.base import VAEConfig as JaxVAEConfig
from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig
from omnivideo_tpu.models.qwen3vl import text_model as jtext
from omnivideo_tpu.models.unified import init_unified_companions
from omnivideo_tpu.models.wan_dit import init_wan_dit
from omnivideo_tpu.training import lora as jlora
from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
from omnivideo_tpu_torch.io.jax_bridge import (
    load_qwen3vl,
    load_unified,
    qwen3_params_to_state_dict,
    unified_params_to_state_dict,
)
from omnivideo_tpu_torch.models.qwen3vl.text_model import Qwen3LM, qwen3_forward
from omnivideo_tpu_torch.training import trainer
from omnivideo_tpu_torch.training.lora import LORA_FILTERS
from torch_qwen3vl_tiny import build, scale_err, tiny_config
from torch_sp_workers import LORA_MESHES, QWEN_MESHES, _train_mesh, load, lora_mesh_worker, spawn

STEPS = 2
KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, cfg_dropout=0.5)
WIDE = dict(tiny.DIT, dim=128, ffn_dim=256, num_heads=2)
CASES = [("lora_adamw", {"dit": tiny.DIT, "pipe": tiny.PIPE},
          dict(KW, trainable_filters=LORA_FILTERS), True),
         ("adafactor", {"dit": WIDE, "pipe": tiny.PIPE}, dict(KW, optimizer="adafactor"), False)]


def _bump(tree):
    """B += 0.02·N(0, 1), seeded: a uniform B would hand A the channel sum of
    its site's output grad, which the LayerNorms downstream of an ungated
    residual (cross_attn.o) make zero up to rounding."""
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
        if jax.tree_util.keystr(p).endswith("lora_b']") else a, tree)


def _case_params(dit_kw):
    """JAX unified params at `dit_kw` (a seeded head) with injected adapters."""
    jcfg = JaxPipelineConfig(dit=JaxDiTConfig(**dit_kw), vae=JaxVAEConfig(z_dim=4), **tiny.PIPE)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    wan = init_wan_dit(k1, jcfg.dit.replace(text_len=jcfg.max_context_len), dtype=jnp.float32)
    head = wan["head"]["head"]
    head["kernel"] = jnp.asarray(
        0.1 * np.random.default_rng(1).standard_normal(head["kernel"].shape), jnp.float32)
    wan = _bump(jlora.inject_lora(wan, k3, 4))
    params = {"wan": wan, "companions": init_unified_companions(k2, jcfg)}
    cfg = PipelineConfig(dit=WanDiTConfig(**dit_kw), vae=VAEConfig(z_dim=4), **tiny.PIPE)
    model = load_unified(trainer.init_unified_params(cfg, device="cpu"),
                         unified_params_to_state_dict(tiny.np_tree(params)))
    return cfg, {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lora_mesh")
    draws = [tiny.jax_draws(s, trainer.TrainConfig(**KW))[1] for s in range(STEPS)]
    inputs, ref = {}, {}
    b = tiny.batch()
    for name, cfg_kw, tc_kw, lora in CASES:
        cfg, sd = _case_params(cfg_kw["dit"])
        inputs.update({f"{name}/sd/{k}": v for k, v in sd.items()})
        stacked = (np.stack([d[0].numpy() for d in draws]),
                   np.stack([d[1].numpy() for d in draws]),
                   np.stack([d[2].numpy() for d in draws]))
        ref[name] = (sd, _train_mesh(None, cfg, trainer.TrainConfig(**tc_kw), sd, b, stacked,
                                     STEPS, lora=lora))
    qcfg = tiny_config(moe=False)
    params, jcfg, _ = build(qcfg)
    jtext_params = _bump(jlora.inject_lora_bare(params["text"], jax.random.PRNGKey(1), 4))
    qsd = qwen3_params_to_state_dict(jtext_params)
    ids = np.random.default_rng(3).integers(0, qcfg.text.vocab_size, (2, 32))
    inputs.update({f"qwen/sd/{k}": v for k, v in qsd.items()})
    np.savez(tmp / "lora_inputs.npz", **inputs, **{f"batch/{k}": v for k, v in b.items()},
             tid=stacked[0], noise=stacked[1], drop=stacked[2],
             **{"qwen/ids": ids, "qwen/cfg": np.array(json.dumps(
                 dataclasses.asdict(qcfg.text)))})
    spawn(lora_mesh_worker, tmp, CASES, STEPS)
    model = load_qwen3vl(Qwen3LM(qcfg.text, torch.float32, device="cpu"), qsd)
    qref = [t.numpy() for t in qwen3_forward(model, torch.tensor(ids))]
    jref = np.asarray(jtext.qwen3_forward(jtext_params, jcfg.text, jnp.asarray(ids))[1])
    return load(tmp, "lora_mesh"), ref, qref, jref


def _rel(got, want, floor=0.0):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-30))


@pytest.mark.parametrize("mesh", list(LORA_MESHES))
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_step_matches_one_process(run, case, mesh):
    out, ref, _, _ = run
    sd, one = ref[case]
    lora = dict((c[0], c[3]) for c in CASES)[case]
    for s in range(STEPS):
        loss = float(out[f"{case}/{mesh}/{s}/loss"])
        assert abs(loss / one[s]["loss"] - 1) < 1e-5, (s, loss, one[s]["loss"])
        for n, want in one[s]["params"].items():
            got = out[f"{case}/{mesh}/{s}/param/{n}"]
            if lora and not n.endswith(("lora_a", "lora_b")):
                np.testing.assert_array_equal(got, sd[n].reshape(got.shape), err_msg=n)
            elif not lora:
                assert _rel(got, want, 1e-2) < 1e-6, (s, n, _rel(got, want, 1e-2))
    moved = [n for n in one[-1]["params"] if n.endswith("lora_b")
             and not np.array_equal(out[f"{case}/{mesh}/{STEPS - 1}/param/{n}"],
                                    sd[n].reshape(one[-1]["params"][n].shape))]
    assert moved


@pytest.mark.parametrize("where", ["resumed_dp2_fsdp2", "resumed_one"])
def test_adafactor_checkpoint_across_meshes(run, where):
    out, ref, _, _ = run
    _, one = ref["adafactor"]
    assert abs(float(out[f"adafactor/{where}/0/loss"]) / one[1]["loss"] - 1) < 1e-5
    for n, want in one[1]["params"].items():
        got = out[f"adafactor/{where}/0/param/{n}"]
        assert _rel(got, want, 1e-2) < 1e-6, (n, _rel(got, want, 1e-2))


@pytest.mark.parametrize("mesh", list(QWEN_MESHES))
def test_qwen3_forward_sp_matches_one_process(run, mesh):
    out, _, (hidden, logits), jref = run
    assert scale_err(logits, jref) < 1e-5
    assert scale_err(out[f"qwen/{mesh}/logits"], logits) < 1e-5
    assert scale_err(out[f"qwen/{mesh}/hidden"], hidden) < 1e-5
