"""The finetune CLI with `--config run.yaml` (LoRA rank, adafactor), its
resume, its provenance file and its two LoRA exports, on the CPU at the
`--tiny` config, from a tiny reference checkpoint. A run of 2 steps
resumed to 4 equals 4 uninterrupted steps bit for bit (the loader and the
draws continue where the run stopped)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch_io_tiny import tiny_cli_config, write_tiny_checkpoint, write_umt5_tokenizer_dir

from omnivideo_tpu.models.wan_dit import init_wan_dit
from omnivideo_tpu.training import lora as jlora
from omnivideo_tpu.utils import run_config as jax_rc
from omnivideo_tpu_torch.tools import finetune


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(out, step):
    return torch.load(out / "checkpoints" / str(step) / "state.pt", weights_only=True)


def test_finetune_config_lora_adafactor_resume(tmp_path):
    """From a tiny reference checkpoint (the seeded init zero-fills the
    head, which would give the adapters no gradient)."""
    fcfg = finetune.task_config(finetune.parse_args(["--tiny"]))
    cli = tiny_cli_config()[0]
    ckpt = write_tiny_checkpoint(tmp_path / "ckpt", fcfg.replace(vae=cli.vae, t5=cli.t5),
                                 write_umt5_tokenizer_dir(tmp_path / "t"))
    yml = tmp_path / "run.yaml"
    yml.write_text(f"lora_rank: 4\nlora_alpha: 8.0\noptimizer: adafactor\ntotal_steps: 2\n"
                   f"lr: 1.0e-3\nwarmup_steps: 1\nsave_interval: 2\nlog_interval: 1\n"
                   f"ckpt_dir: '{ckpt}'\n")
    base = ["--dummy_data", "--tiny", "--device", "cpu", "--config", str(yml)]
    a, b = tmp_path / "a", tmp_path / "b"
    argv_a = base + ["--total_steps", "4", "--output_dir", str(a), "--lora_adapter_export",
                     str(a / "ad.npz"), "--lora_export", str(a / "merged.npz")]
    assert finetune.main(argv_a) == 0
    assert finetune.main(base + ["--output_dir", str(b)]) == 0
    assert _state(b, 2)["step"] == 2
    assert finetune.main(base + ["--total_steps", "4", "--resume", "--output_dir", str(b)]) == 0
    sa, sb = _state(a, 4), _state(b, 4)
    assert sa["step"] == sb["step"] == 4 and sa["opt_state"]["count"] == 4
    for n, v in sa["params"].items():
        torch.testing.assert_close(sb["params"][n], v, rtol=0, atol=0, msg=n)
    for k in ("v", "v_row", "v_col"):
        assert set(sa["opt_state"][k]) == set(sb["opt_state"][k])
        for n, v in sa["opt_state"][k].items():
            torch.testing.assert_close(sb["opt_state"][k][n], v, rtol=0, atol=0, msg=n)
    assert all(n.endswith(("lora_a", "lora_b")) for n in sa["opt_state"]["v"])

    # the base stayed where the seeded init put it; the adapters moved
    args = finetune.parse_args(argv_a)
    init = finetune.initial_params(finetune.task_config(args), args, "cpu").state_dict()
    for n, v in init.items():
        torch.testing.assert_close(sa["params"][n], v, rtol=0, atol=0, msg=n)
    assert float(sa["params"]["wan.blocks.0.ffn.2.lora_b"].abs().max()) > 0
    assert float(sa["params"]["wan.blocks.0.ffn.2.lora_scale"]) == 2.0

    # provenance: the merged flags as YAML, JAX's file for the same namespace
    assert (args.lora_rank, args.optimizer, args.total_steps) == (4, "adafactor", 4)
    text = (a / "run_config.yaml").read_text()
    assert yaml.safe_load(text) == vars(args)
    assert yaml.safe_load(text) == yaml.safe_load(
        jax_rc.dump_run_config(args, tmp_path / "jax").read_text())

    # the exports: JAX's adapter format and JAX's merged-param paths
    ad = jlora.load_adapters_npz(str(a / "ad.npz"))
    assert ad["blocks/self_attn/q"]["lora_a"].shape == (2, 64, 4)
    np.testing.assert_array_equal(np.asarray(ad["blocks/ffn/fc2"]["lora_b"][0]),
                                  sa["params"]["wan.blocks.0.ffn.2.lora_b"].numpy())
    cfg = finetune.task_config(args)
    jdit = init_wan_dit(jax.random.PRNGKey(0), _jax_dit(cfg), dtype=jnp.float32)
    ref = {"/".join(str(k.key) for k in p): leaf.shape
           for p, leaf in jax.tree_util.tree_leaves_with_path(jdit)}
    with np.load(a / "merged.npz") as z:
        assert {k: z[k].shape for k in z.files} == ref
        w = sa["params"]["wan.blocks.1.self_attn.q.weight"]
        delta = (sa["params"]["wan.blocks.1.self_attn.q.lora_a"]
                 @ sa["params"]["wan.blocks.1.self_attn.q.lora_b"]) * 2.0
        np.testing.assert_allclose(z["blocks/self_attn/q/kernel"][1], (w.T + delta).numpy(),
                                   rtol=1e-6, atol=1e-7)


def _jax_dit(cfg):
    from omnivideo_tpu.configs.base import WanDiTConfig as JaxDiTConfig

    d = cfg.dit
    return JaxDiTConfig(in_dim=d.in_dim, dim=d.dim, ffn_dim=d.ffn_dim, freq_dim=d.freq_dim,
                        text_dim=d.text_dim, out_dim=d.out_dim, num_heads=d.num_heads,
                        num_layers=d.num_layers, text_len=cfg.max_context_len)
