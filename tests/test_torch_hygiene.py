"""Import and device hygiene of the port (omnivideo_tpu_torch).

- importing it and running a tiny CPU forward loads neither jax nor
  omnivideo_tpu;
- no module of it imports them, calls a library attention or
  torch.compile (AST scan);
- its entry points default to CUDA and raise without a CUDA device unless
  the caller asks for the CPU;
- every CUDA source and header is in the kernel build's digest.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parents[1] / "omnivideo_tpu_torch"
FORBIDDEN_MODULES = ("jax", "jaxlib", "omnivideo_tpu")
FORBIDDEN_CALLS = ("scaled_dot_product_attention", "compile", "flash_attn",
                   "cudnn_attention", "_scaled_dot_product_flash_attention",
                   "_scaled_dot_product_cudnn_attention", "load_inline")


def test_import_and_forward_load_no_jax():
    code = (
        "import sys, torch\n"
        "from omnivideo_tpu_torch.configs.base import WanDiTConfig\n"
        "from omnivideo_tpu_torch.models.wan_dit import WanDiT\n"
        "cfg = WanDiTConfig(in_dim=4, dim=256, ffn_dim=256, freq_dim=32, text_dim=32,"
        " out_dim=4, num_heads=2, num_layers=1)\n"
        "m = WanDiT(cfg, dtype=torch.float32, device='cpu')\n"
        "with torch.inference_mode():\n"
        "    y = m(torch.zeros(1, 4, 1, 4, 4), torch.tensor([5.0]), torch.zeros(1, 3, 32))\n"
        "assert y.shape == (1, 4, 1, 4, 4)\n"
        "import numpy as np\n"
        "from omnivideo_tpu_torch.configs.qwen3vl import Qwen3TextConfig, Qwen3VLConfig,"
        " Qwen3VLVisionConfig\n"
        "from omnivideo_tpu_torch.models.qwen3vl.full_model import Qwen3VLModel,"
        " qwen3vl_greedy_decode\n"
        "vcfg = Qwen3VLConfig(text=Qwen3TextConfig(vocab_size=32, hidden_size=32,"
        " num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1, head_dim=16,"
        " num_experts=4, num_experts_per_tok=2, moe_intermediate_size=8),"
        " vision=Qwen3VLVisionConfig(depth=0))\n"
        "vlm = Qwen3VLModel(vcfg, torch.float32, device='cpu')\n"
        "assert qwen3vl_greedy_decode(vlm, np.array([[1, 2, 3]]), max_new_tokens=2).shape == (2,)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'omnivideo_tpu')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


def _py_files():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import_or_library_attention(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert alias.name.split(".")[0] not in FORBIDDEN_MODULES, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert (node.module or "").split(".")[0] not in FORBIDDEN_MODULES, node.module
        elif isinstance(node, ast.Attribute):
            assert node.attr not in FORBIDDEN_CALLS, f"{path}: .{node.attr}"
        elif isinstance(node, ast.Name):
            assert node.id not in FORBIDDEN_CALLS, f"{path}: {node.id}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from omnivideo_tpu_torch.configs.base import (
        PipelineConfig,
        T5Config,
        VAEConfig,
        WanDiTConfig,
    )
    from omnivideo_tpu_torch.configs.qwen3vl import QWEN3_VL_30B_A3B
    from omnivideo_tpu_torch.device import resolve_device
    from omnivideo_tpu_torch.io.jax_bridge import pipeline_from_jax
    from omnivideo_tpu_torch.io.torch_convert import wan_state_dict_to_params
    from omnivideo_tpu_torch.models.qwen3vl.full_model import Qwen3VLModel
    from omnivideo_tpu_torch.models.t5 import T5Encoder, init_t5
    from omnivideo_tpu_torch.models.vae2_1 import init_vae
    from omnivideo_tpu_torch.models.wan_dit import WanDiT
    from omnivideo_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from omnivideo_tpu_torch.pipelines.loading import load_expert, load_pipeline
    from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
    from omnivideo_tpu_torch.tools import finetune, generate
    from omnivideo_tpu_torch.training.trainer import init_unified_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dit = WanDiTConfig(in_dim=4, dim=256, ffn_dim=256, freq_dim=32, text_dim=32,
                       out_dim=4, num_heads=2, num_layers=1)
    cfg = PipelineConfig(dit=dit, vae=VAEConfig(dim=8, z_dim=4), vlm_in_dim=8,
                         max_context_len=8)
    for build in (lambda: WanDiT(dit), lambda: init_vae(cfg.vae),
                  lambda: OmniVideoX2XUnified.random_init(cfg),
                  lambda: resolve_device(None), lambda: resolve_device("cuda:0"),
                  lambda: Qwen3VLModel(QWEN3_VL_30B_A3B),
                  lambda: Qwen3VLModel.random_init(QWEN3_VL_30B_A3B),
                  lambda: init_unified_params(cfg),
                  lambda: finetune.main(["--dummy_data", "--tiny", "--total_steps", "1"]),
                  lambda: T5Encoder(T5Config()), lambda: init_t5(T5Config()),
                  lambda: wan_state_dict_to_params({}, dit),
                  lambda: load_expert(cfg, "missing_dir", "low_noise_model"),
                  lambda: load_pipeline(cfg, "missing_dir"),
                  lambda: pipeline_from_jax(cfg, None),
                  lambda: generate.main(["--input", "x.jsonl", "--random_weights", "--tiny"]),
                  lambda: maybe_initialize_distributed("localhost:1", 2, 0),
                  lambda: generate.main(["--input", "x.jsonl", "--random_weights", "--tiny",
                                         "--sp_size", "2", "--coordinator", "localhost:1",
                                         "--num_processes", "2", "--process_id", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert resolve_device("cpu") == torch.device("cpu")
    pipe = OmniVideoX2XUnified.random_init(cfg, device="cpu")
    assert pipe.device == torch.device("cpu")


def test_every_csrc_file_is_in_the_build_digest():
    """The build is cached by a digest of SOURCES and HEADERS: a file under
    csrc/ missing from both would not trigger a rebuild when edited."""
    from omnivideo_tpu_torch.ops import _kernels

    listed = set(_kernels.SOURCES) | set(_kernels.HEADERS)
    on_disk = {p.name for p in (PKG / "csrc").iterdir() if p.is_file()}
    assert on_disk == listed, (sorted(on_disk - listed), sorted(listed - on_disk))
    assert all(name.endswith(".cu") for name in _kernels.SOURCES)
