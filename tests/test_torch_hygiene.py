"""Import and device hygiene of the port (omnivideo_tpu_torch).

- importing it and running a tiny CPU forward loads neither jax nor
  omnivideo_tpu;
- no module of it imports them, calls a library attention, torch's grouped
  GEMM (`_grouped_mm`) or torch.compile (AST scan);
- importing the host side of the main path (the generate CLI, the Qwen3-VL
  engine, the loader, the readers and the video IO) and of the SFT and
  data-prepare tools (the sft_vlm CLI, the conversation data, the PNG
  reader, sft_tokenize, vae_ and ar_feature_extract) and of the i2v slice
  (pipelines/i2v.py, models/clip_vision.py, models/vae2_2.py,
  models/xlm_roberta.py) and of the streaming slice (pipelines/streaming.py,
  training/streaming.py, ops/quant.py, the finetune CLI) loads none of
  tokenizers, transformers, safetensors, PIL or imageio, which the card's
  machine may lack: they are imported inside the functions that need them;
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
                   "_scaled_dot_product_cudnn_attention", "load_inline", "_grouped_mm")


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


def test_host_modules_import_no_optional_packages():
    optional = ("tokenizers", "transformers", "safetensors", "PIL", "imageio")
    code = (
        "import sys\n"
        "import omnivideo_tpu_torch.tools.generate, omnivideo_tpu_torch.models.qwen3vl.engine\n"
        "import omnivideo_tpu_torch.pipelines.loading, omnivideo_tpu_torch.utils.video\n"
        "import omnivideo_tpu_torch.io.hf_reader, omnivideo_tpu_torch.io.safetensors\n"
        "import omnivideo_tpu_torch.models.t5, omnivideo_tpu_torch.utils.spm_convert\n"
        "import omnivideo_tpu_torch.models.qwen3vl.preprocess, omnivideo_tpu_torch.utils.avi\n"
        "import omnivideo_tpu_torch.tools.sft_vlm, omnivideo_tpu_torch.training.conversation\n"
        "import omnivideo_tpu_torch.tools.data_prepare.sft_tokenize, omnivideo_tpu_torch.utils.png\n"
        "import omnivideo_tpu_torch.tools.data_prepare.vae_feature_extract\n"
        "import omnivideo_tpu_torch.tools.data_prepare.ar_feature_extract\n"
        "import omnivideo_tpu_torch.pipelines.i2v, omnivideo_tpu_torch.models.clip_vision\n"
        "import omnivideo_tpu_torch.models.vae2_2, omnivideo_tpu_torch.models.xlm_roberta\n"
        "import omnivideo_tpu_torch.pipelines.streaming, omnivideo_tpu_torch.training.streaming\n"
        "import omnivideo_tpu_torch.ops.quant, omnivideo_tpu_torch.tools.finetune\n"
        f"bad = [k for k in sys.modules if k.split('.')[0] in {optional + FORBIDDEN_MODULES!r}]\n"
        "print('BAD', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout, res.stdout


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
    from omnivideo_tpu_torch.models.clip_vision import (
        CLIPVision,
        CLIPVisionConfig,
        clip_vision_from_state_dict,
        init_clip_vision,
        preprocess_image,
    )
    from omnivideo_tpu_torch.models.qwen3vl.full_model import Qwen3VLModel
    from omnivideo_tpu_torch.models.vae2_2 import VAE22Config, vae22_state_dict_to_params
    from omnivideo_tpu_torch.models.xlm_roberta import (
        init_xlm_roberta,
        xlm_roberta_state_dict_to_params,
    )
    from omnivideo_tpu_torch.models.t5 import T5Encoder, init_t5
    from omnivideo_tpu_torch.models.vae2_1 import init_vae
    from omnivideo_tpu_torch.models.wan_dit import WanDiT
    from omnivideo_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from omnivideo_tpu_torch.pipelines.loading import load_expert, load_pipeline
    from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
    from omnivideo_tpu_torch.tools import finetune, generate, sft_vlm
    from omnivideo_tpu_torch.tools.data_prepare import ar_feature_extract, vae_feature_extract
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
                  lambda: sft_vlm.main(["--dummy_data", "--tiny", "--total_steps", "1"]),
                  lambda: vae_feature_extract.main(["--manifest", "m.jsonl", "--output_dir", "o",
                                                    "--random_weights"]),
                  lambda: ar_feature_extract.main(["--features_dir", "f", "--manifest", "m.jsonl",
                                                   "--vlm_path", "v"]),
                  lambda: T5Encoder(T5Config()), lambda: init_t5(T5Config()),
                  lambda: CLIPVision(CLIPVisionConfig()),
                  lambda: init_clip_vision(CLIPVisionConfig(num_layers=1)),
                  lambda: clip_vision_from_state_dict({}, CLIPVisionConfig()),
                  lambda: preprocess_image(torch.zeros(8, 8, 3, dtype=torch.uint8)),
                  lambda: init_xlm_roberta(num_layers=1),
                  lambda: xlm_roberta_state_dict_to_params({}),
                  lambda: vae22_state_dict_to_params({}, VAE22Config()),
                  lambda: WanDiT(dit.replace(model_type="i2v", in_dim=12)),
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


def test_streaming_entry_points_raise_without_cuda(monkeypatch):
    """The streamed executor, trainers, random init and CLI modes default to
    the card like every entry point (and pin host memory only there)."""
    from omnivideo_tpu_torch.configs.base import PipelineConfig, VAEConfig, WanDiTConfig
    from omnivideo_tpu_torch.pipelines import streaming
    from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified
    from omnivideo_tpu_torch.tools import finetune, generate
    from omnivideo_tpu_torch.training.streaming import StreamedLoRATrainer, StreamedTrainer
    from omnivideo_tpu_torch.training.trainer import TrainConfig

    dit = WanDiTConfig(in_dim=4, dim=256, ffn_dim=256, freq_dim=32, text_dim=32, out_dim=4,
                       num_heads=2, num_layers=2)
    cfg = PipelineConfig(dit=dit, vae=VAEConfig(dim=8, z_dim=4), vlm_in_dim=8, max_context_len=8)
    _, blocks = streaming.split_host_params(streaming.random_streamed_dit(dit, device="cpu"))
    assert not blocks[0].data.is_pinned()  # no card: plain host memory
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: streaming.BlockStreamingExecutor(dit, blocks),
                  lambda: streaming.random_streamed_dit(dit),
                  lambda: OmniVideoX2XUnified.random_init(cfg, layer_stream=True),
                  lambda: StreamedTrainer(cfg, TrainConfig()),
                  lambda: StreamedLoRATrainer(cfg, TrainConfig()),
                  lambda: finetune.main(["--dummy_data", "--tiny", "--total_steps", "1",
                                         "--layer_stream"]),
                  lambda: generate.main(["--input", "x.jsonl", "--random_weights", "--tiny",
                                         "--layer_stream"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_serving_export_eval_modules_import_no_optional_packages():
    """The serving, export and evaluation side (the server, the exporter,
    the eval harnesses, the v1 generator, the rest of utils and
    schedulers) imports none of the optional packages, nor jax or
    omnivideo_tpu."""
    optional = ("tokenizers", "transformers", "safetensors", "PIL", "imageio", "dashscope")
    code = (
        "import sys\n"
        "import omnivideo_tpu_torch.tools.serve, omnivideo_tpu_torch.tools.export_aot\n"
        "import omnivideo_tpu_torch.tools.eval_vlm, omnivideo_tpu_torch.tools.eval_videos\n"
        "import omnivideo_tpu_torch.tools.export_tokenizer, omnivideo_tpu_torch.tools.step_time\n"
        "import omnivideo_tpu_torch.pipelines.generator, omnivideo_tpu_torch.eval\n"
        "import omnivideo_tpu_torch.utils.prompt_extend, omnivideo_tpu_torch.utils.chaos\n"
        "import omnivideo_tpu_torch.utils.metrics, omnivideo_tpu_torch.utils.misc\n"
        "import omnivideo_tpu_torch.schedulers.ddim, omnivideo_tpu_torch.schedulers.continuous_ode\n"
        "import omnivideo_tpu_torch.models.qwen3vl.media\n"
        f"bad = [k for k in sys.modules if k.split('.')[0] in {optional + FORBIDDEN_MODULES!r}]\n"
        "print('BAD', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_serving_export_eval_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """serve, export_aot, eval_vlm, eval_videos, the v1 generator, the Qwen
    prompt expander and masks_like default to the card and raise without
    one unless the caller asks for the CPU."""
    from omnivideo_tpu_torch.pipelines.generator import OmniVideoGenerator
    from omnivideo_tpu_torch.tools import eval_videos, eval_vlm, export_aot, serve
    from omnivideo_tpu_torch.utils.misc import masks_like
    from omnivideo_tpu_torch.utils.prompt_extend import QwenPromptExpander

    (tmp_path / "q.jsonl").write_text("")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: serve.main(["--random_weights", "--tiny", "--output_dir",
                                      str(tmp_path / "s")]),
                  lambda: export_aot.main(["--tiny", "--out", str(tmp_path / "x.pt2")]),
                  lambda: eval_vlm.main(["--model_path", str(tmp_path), "--questions",
                                         str(tmp_path / "q.jsonl")]),
                  lambda: eval_videos.main(["--generated", str(tmp_path)]),
                  lambda: OmniVideoGenerator(str(tmp_path)),
                  lambda: QwenPromptExpander(model_name=str(tmp_path)),
                  lambda: masks_like((1, 2, 3, 4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert masks_like((1, 2, 3, 4), device="cpu").shape == (1, 2, 3, 4)


def test_every_csrc_file_is_in_the_build_digest():
    """The build is cached by a digest of SOURCES and HEADERS: a file under
    csrc/ missing from both would not trigger a rebuild when edited."""
    from omnivideo_tpu_torch.ops import _kernels

    listed = set(_kernels.SOURCES) | set(_kernels.HEADERS)
    on_disk = {p.name for p in (PKG / "csrc").iterdir() if p.is_file()}
    assert on_disk == listed, (sorted(on_disk - listed), sorted(listed - on_disk))
    assert all(name.endswith(".cu") for name in _kernels.SOURCES)
