"""Tiny checkpoint dirs for the port's host-side tests, built in a tmp dir
(nothing is downloaded): a umT5 sentencepiece model and its tokenizer.json
dir, a Qwen3-VL HF checkpoint dir (transformers `save_pretrained` and an
in-memory `tokenizers` tokenizer with the ChatML and vision specials, as
tests/test_vlm_eval.py builds one), and the seeded pieces of a reference
x2x checkpoint dir at the generate CLI's `--tiny` widths."""

import json
from pathlib import Path

import numpy as np
import torch

UMT5_WORDS = ["▁hello", "▁world", "▁a", "▁red", "▁fox", "▁in", "▁the", "▁snow", "▁gray",
              "▁rabbit", "▁dog", "▁with", "▁replace", "hello", "world", "▁", "h", "e", "l",
              "o", "w", "r", "d", "a", "t", "s", "n", "x", "f", "i", "g", "b", "k", "."]


def write_spiece(d: Path) -> Path:
    """`spiece.model` alone: a unigram ModelProto (<pad>=0, </s>=1, <unk>=2,
    then the pieces above), built with transformers' bundled protobuf
    schema, as tests/test_tokenizer_export.py does."""
    from transformers.convert_slow_tokenizer import import_protobuf

    m = import_protobuf().ModelProto()

    def add(piece, score, ptype=1):  # 1 NORMAL, 2 UNKNOWN, 3 CONTROL
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, ptype

    add("<pad>", 0.0, 3)
    add("</s>", 0.0, 3)
    add("<unk>", 0.0, 2)
    for i, w in enumerate(UMT5_WORDS):
        add(w, -float(i + 1))
    m.trainer_spec.model_type = 1  # UNIGRAM
    m.trainer_spec.unk_id = 2
    m.trainer_spec.vocab_size = len(m.pieces)
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    d.mkdir(parents=True, exist_ok=True)
    (d / "spiece.model").write_bytes(m.SerializeToString())
    return d


def write_umt5_tokenizer_dir(d: Path) -> Path:
    """tokenizer.json + tokenizer_config.json + special_tokens_map.json of
    a T5TokenizerFast over the converted sentencepiece model: the layout
    transformers' AutoTokenizer loads."""
    from transformers import T5TokenizerFast

    from omnivideo_tpu.utils.spm_convert import convert_spiece_to_fast

    src = write_spiece(d.parent / (d.name + "_sp"))
    fast = convert_spiece_to_fast(src / "spiece.model", src / "tokenizer.json")
    tok = T5TokenizerFast(tokenizer_file=str(fast), unk_token="<unk>", eos_token="</s>",
                          pad_token="<pad>", extra_ids=0)
    tok.save_pretrained(str(d))
    return d


def qwen3vl_tiny_config(hidden_size: int = 48, patch_size: int = 4):
    """The port's config of the tiny Qwen3-VL checkpoints below: 2 dense text
    layers, 2 vision blocks, merge 2, vocab 160, the vision specials at
    150-153. `patch_size` 16 is the real one: the engine's default pixel
    budgets (480² pixels and up for captions) then give ~900 patches a
    frame."""
    from omnivideo_tpu_torch.configs.qwen3vl import (Qwen3TextConfig, Qwen3VLConfig,
                                                     Qwen3VLVisionConfig)

    return Qwen3VLConfig(
        text=Qwen3TextConfig(vocab_size=160, hidden_size=hidden_size, intermediate_size=96,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             head_dim=16, rope_theta=10000.0),
        vision=Qwen3VLVisionConfig(hidden_size=32, intermediate_size=64, depth=2, num_heads=4,
                                   patch_size=patch_size, temporal_patch_size=2,
                                   spatial_merge_size=2, out_hidden_size=hidden_size,
                                   num_position_embeddings=36, deepstack_visual_indexes=(0,)),
        mrope_section=(2, 3, 3), video_token_id=152, image_token_id=151,
        vision_start_token_id=150)


def hf_config_dict(cfg) -> dict:
    """config.json of a Qwen3-VL checkpoint of `cfg` (the fields the
    readers use, under transformers' names)."""
    import dataclasses

    t, v = dataclasses.asdict(cfg.text), dataclasses.asdict(cfg.vision)
    t["rope_scaling"] = {"rope_type": "default", "mrope_section": list(cfg.mrope_section),
                         "mrope_interleaved": True}
    t["tie_word_embeddings"] = False
    for k in ("rope_dtype", "hidden_act"):
        v.pop(k)
    v["deepstack_visual_indexes"] = list(v["deepstack_visual_indexes"])
    if t["num_experts"] is None:
        for k in ("num_experts", "num_experts_per_tok", "moe_intermediate_size",
                  "norm_topk_prob"):
            t.pop(k)
    return {"text_config": t, "vision_config": v, "video_token_id": cfg.video_token_id,
            "image_token_id": cfg.image_token_id,
            "vision_start_token_id": cfg.vision_start_token_id, "vision_end_token_id": 153}


def write_qwen3vl_tokenizer(d: Path) -> Path:
    """tokenizer.json (a `tokenizers` WordLevel over whitespace: the words
    tok0..tok148, "user", "assistant", "yes", "no", and the Qwen specials
    at 150-155, special and split out) and tokenizer_config.json (eos
    <|im_end|>)."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers

    vocab = {f"tok{i}": i for i in range(149)}
    vocab.update({"user": 149, "<|vision_start|>": 150, "<|image_pad|>": 151,
                  "<|video_pad|>": 152, "<|vision_end|>": 153,
                  "<|im_start|>": 154, "<|im_end|>": 155,
                  "yes": 156, "no": 157, "<unk>": 158, "assistant": 159})
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in (
        "<unk>", "<|vision_start|>", "<|vision_end|>", "<|image_pad|>", "<|video_pad|>",
        "<|im_start|>", "<|im_end|>")])
    d.mkdir(parents=True, exist_ok=True)
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<|im_end|>",
                                                        "unk_token": "<unk>"}))
    return d


def write_qwen3vl_hf_dir(d: Path, hidden_size: int = 48, patch_size: int = 4, seed: int = 0,
                         transformers: bool = True) -> Path:
    """A random Qwen3-VL checkpoint dir of `qwen3vl_tiny_config` in f32
    safetensors with the tokenizer above. `transformers`: the model is
    transformers' Qwen3VLForConditionalGeneration written by
    `save_pretrained` (weights ~ N(0, 1/fan_in), so activations stay O(1)
    and the greedy choices apart); else config.json and the seeded HF-named
    weights of tests/torch_qwen3vl_tiny.py are written directly, without
    importing transformers' model classes (which take seconds)."""
    cfg = qwen3vl_tiny_config(hidden_size, patch_size)
    if transformers:
        from transformers.models.qwen3_vl.configuration_qwen3_vl import (
            Qwen3VLConfig as HFConfig)
        from transformers.models.qwen3_vl.modeling_qwen3_vl import (
            Qwen3VLForConditionalGeneration)

        torch.manual_seed(seed)
        model = Qwen3VLForConditionalGeneration(HFConfig(**hf_config_dict(cfg))).eval().float()
        with torch.no_grad():
            g = torch.Generator().manual_seed(seed)
            for name, p in model.named_parameters():
                if p.ndim >= 2 and "embed" not in name:
                    p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
        model.save_pretrained(d)
    else:
        from safetensors.numpy import save_file
        from torch_qwen3vl_tiny import hf_state_dict

        d.mkdir(parents=True, exist_ok=True)
        save_file(hf_state_dict(cfg, seed), str(d / "model.safetensors"))
        (d / "config.json").write_text(json.dumps(hf_config_dict(cfg)))
    write_qwen3vl_tokenizer(d)
    return d


def tiny_cli_config():
    """The port CLI's `--tiny` t2v-1.3B config and the JAX package's twin
    of it (the same fields)."""
    from omnivideo_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
    from omnivideo_tpu.configs.base import T5Config as JaxT5Config
    from omnivideo_tpu_torch.configs import WAN_CONFIGS
    from omnivideo_tpu_torch.configs.base import T5Config

    t5 = dict(vocab_size=256, dim=48, dim_attn=48, dim_ffn=96, num_heads=4, num_layers=2)
    out = []
    for cfgs, t5_cls in ((WAN_CONFIGS, T5Config), (JAX_CONFIGS, JaxT5Config)):
        cfg = cfgs["t2v-1.3B"]
        out.append(cfg.replace(
            dit=cfg.dit.replace(dim=256, ffn_dim=512, num_heads=2, num_layers=2, freq_dim=32,
                                text_dim=48),
            vae=cfg.vae.__class__(dim=8, z_dim=16, num_res_blocks=1), t5=t5_cls(**t5),
            max_context_len=64))
    return tuple(out)


def vae_reference_state_dict(params, cfg) -> dict:
    """The reference Wan2.1 VAE names of the port's VAE params (the inverse
    of `vae_state_dict_to_params`, found by running it on key spies)."""
    from omnivideo_tpu_torch.models.vae2_1 import vae_state_dict_to_params

    keys = {}

    class Spy(dict):
        def __getitem__(self, k):
            return np.array([keys.setdefault(k, len(keys))], np.float32)

    spies = vae_state_dict_to_params(Spy(), cfg)
    names = {i: k for k, i in keys.items()}
    out = {}

    def walk(spy, real):
        for k, v in spy.items():
            if isinstance(v, dict):
                walk(v, real[k])
            else:
                out[names[int(v.reshape(-1)[0])]] = real[k].detach().clone()

    walk(spies, params)
    return out


def write_tiny_checkpoint(root: Path, cfg, tokenizer_dir: Path, seed: int = 0) -> Path:
    """A reference x2x checkpoint dir at `cfg` (the port's tiny CLI config):
    the low-noise expert in the diffusers layout (f32 safetensors, so the
    JAX package's `safetensors.numpy` reads it too, and the three companion
    `.bin` files), Wan2.1_VAE.pth, the umT5 `.pth` and the tokenizer as
    google/umt5-xxl/. Every weight is a seeded normal."""
    import shutil

    from safetensors.torch import save_file

    from omnivideo_tpu_torch.models.t5 import init_t5
    from omnivideo_tpu_torch.models.vae2_1 import init_vae
    from omnivideo_tpu_torch.pipelines.x2x import OmniVideoX2XUnified

    pipe = OmniVideoX2XUnified.random_init(cfg, seed=seed, with_vae=False, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    wan = {k: (torch.randn(v.shape, generator=g) * 0.05).float().contiguous()
           for k, v in pipe.low_noise.wan.state_dict().items()}
    sub = root / cfg.low_noise_checkpoint / "wan_model"
    sub.mkdir(parents=True)
    save_file(wan, str(sub / "diffusion_pytorch_model.safetensors"))
    comp = pipe.low_noise.companions
    lin = lambda p: {"weight": p["kernel"].T.contiguous(), "bias": p["bias"]}  # noqa: E731
    adapter = comp["visual_context_adapter"]
    files = {"vlm_norm": {"weight": comp["vlm_norm"]},
             "vlm_proj": lin(comp["vlm_proj"]),
             "visual_context_adapter": {
                 **{f"patch_embedding.{k}": v for k, v in lin(adapter["patch_embedding"]).items()},
                 **{f"projection.{k}": v for k, v in lin(adapter["projection"]).items()}}}
    for name, sd in files.items():
        torch.save({k: (v + 0.05 * torch.randn(v.shape, generator=g)).contiguous()
                    for k, v in sd.items()}, root / cfg.low_noise_checkpoint
                   / f"{name}_pytorch_model.bin")
    vae = init_vae(cfg.vae, device="cpu", generator=torch.Generator().manual_seed(seed + 2))
    torch.save(vae_reference_state_dict(vae, cfg.vae), root / cfg.vae_checkpoint)
    t5 = init_t5(cfg.t5, dtype=torch.float32, device="cpu", seed=seed + 3)
    torch.save(t5.state_dict(), root / cfg.t5_checkpoint)
    shutil.copytree(tokenizer_dir, root / cfg.t5_tokenizer)
    return root

