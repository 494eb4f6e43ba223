"""Shared tiny setup of the port's SFT tests: the JAX CLI's `--tiny` Qwen3
(tools/sft_vlm.py `_tiny_cfg`: vocab 128, hidden 64, 2 layers, 4 heads of
16, 2 KV heads) with its seeded params, the CLI's tiny alignment chain
(vision head 64 → 32 → 24, 4 queries, 1 + 1 layers; adapter 24 → 32 → 32),
a seeded batch whose rows hold unequal target counts, and the port's
SFTParams carrying the same weights (io/jax_bridge.py)."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from omnivideo_tpu.models import adapters as jad
from omnivideo_tpu_torch.configs.qwen3vl import Qwen3TextConfig
from omnivideo_tpu_torch.io import jax_bridge as jb
from omnivideo_tpu_torch.models import adapters as pad
from omnivideo_tpu_torch.models.qwen3vl.text_model import Qwen3LM
from omnivideo_tpu_torch.training.align import AlignChain
from omnivideo_tpu_torch.training.sft import SFTParams

ROOT = Path(__file__).resolve().parents[1]
SEQ = 16
VLM_LEN, Q, OUT = 8, 4, 32


def jax_cli():
    """The JAX CLI module (tools/sft_vlm.py, a script: loaded from its file)."""
    spec = importlib.util.spec_from_file_location("jax_sft_vlm", ROOT / "tools" / "sft_vlm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_setup(chain: bool = True, seed: int = 0):
    """(JAX text config, numpy params {'lm'[, 'chain']}) as the JAX CLI's
    `--tiny` run builds them."""
    cli = jax_cli()
    jcfg = cli._tiny_cfg()
    key = jax.random.PRNGKey(seed)
    params = {"lm": cli._random_lm_params(key, jcfg)}
    if chain:
        k1, k2 = jax.random.split(jax.random.fold_in(key, 99))
        params["chain"] = {
            "vision_head": jad.init_vision_head(k1, in_dim=jcfg.hidden_size, hidden_dim=32,
                                                out_dim=24, num_queries=Q, num_layers=1),
            "adapter": jad.init_dm_adapter(k2, in_dim=24, hidden_dim=32, out_dim=OUT,
                                           num_queries=Q, num_layers=1)}
    return jcfg, np_tree(params)


def port_config(jcfg) -> Qwen3TextConfig:
    return Qwen3TextConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(Qwen3TextConfig)})


def port_model(jcfg, params) -> SFTParams:
    """SFTParams on the CPU holding `params` (f32)."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jb.sft_params_to_state_dict(params).items()}
    lm = jb.load_qwen3vl(Qwen3LM(port_config(jcfg), torch.float32, device="cpu"),
                         {k[3:]: v for k, v in sd.items() if k.startswith("lm.")})
    chain = None
    if "chain" in params:
        chain = AlignChain(pad.init_vision_head(jcfg.hidden_size, 32, 24, Q, 1, device="cpu"),
                           pad.init_dm_adapter(24, 32, OUT, Q, 1, device="cpu"))
        chain.load_state_dict({k[6:]: v for k, v in sd.items() if k.startswith("chain.")})
    return SFTParams(lm, chain)


def samples(seed: int = 0, n: int = 4, vocab: int = 128, hidden: int = 64):
    """n samples of 9..SEQ tokens with prompt lengths 2..6 and alignment
    inputs: the rows' target counts differ."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(9, SEQ + 1))
        out.append({"ids": rng.integers(0, vocab, length).astype(np.int32),
                    "prompt_len": np.array(2 + i % 5),
                    "vlm": rng.standard_normal((VLM_LEN, hidden)).astype(np.float32),
                    "target": (0.1 * rng.standard_normal((Q, OUT))).astype(np.float32)})
    return out


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def adam_checked(p, p_ref, g_refs, floor: float = 1e-2):
    """max |p − p_ref| over max(|p_ref|, floor) at the elements whose JAX
    gradient was, at every step so far, at least 1e-3 of its leaf's largest
    (elsewhere AdamW's g/(|g| + eps) turns the gradients' f32 rounding into
    the update: the attention's key bias has an exactly zero gradient, which
    both packages round to noise). Returns (that error, the share of
    elements it covers)."""
    keep = np.ones(np.shape(p_ref), bool)
    for g in g_refs:
        keep &= np.abs(g) >= 1e-3 * np.abs(g).max()
    if not keep.any():
        return 0.0, 0.0
    err = np.abs(np.asarray(p) - p_ref)[keep].max() / max(np.abs(p_ref).max(), floor)
    return float(err), float(keep.mean())


def write_qwen3_text_dir(d: Path) -> Path:
    """An HF text-only Qwen3 dir (config.json, model.safetensors with
    `model.*` and `lm_head` names, f32) of tests/torch_qwen3vl_tiny.py's
    dense text stack (vocab 160, hidden 48), with the tiny WordLevel
    tokenizer of tests/torch_io_tiny.py (ChatML specials, no template)."""
    import json

    from safetensors.numpy import save_file

    from torch_io_tiny import write_qwen3vl_tokenizer
    from torch_qwen3vl_tiny import hf_state_dict, tiny_config

    cfg = tiny_config(moe=False)
    sd = {("model." + k[len("model.language_model."):] if k.startswith("model.language_model.")
           else k): v for k, v in hf_state_dict(cfg).items() if not k.startswith("model.visual.")}
    d.mkdir(parents=True, exist_ok=True)
    save_file(sd, str(d / "model.safetensors"))
    t = cfg.text
    (d / "config.json").write_text(json.dumps({
        "model_type": "qwen3", "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size, "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads, "head_dim": t.head_dim,
        "rope_theta": t.rope_theta, "rms_norm_eps": t.rms_norm_eps,
        "tie_word_embeddings": False}))
    write_qwen3vl_tokenizer(d)
    return d


def hf_tokenizer(d: Path):
    """transformers' fast tokenizer over the dir's tokenizer.json (the JAX
    side's tokenizer; its chat_template from tokenizer_config.json)."""
    import json

    from transformers import PreTrainedTokenizerFast

    conf = json.loads((d / "tokenizer_config.json").read_text())
    return PreTrainedTokenizerFast(tokenizer_file=str(d / "tokenizer.json"),
                                   chat_template=conf.get("chat_template"),
                                   eos_token=conf.get("eos_token"), unk_token=conf.get("unk_token"))


def conversations(n: int = 6, seed: int = 0):
    """Seeded chat records over the tiny tokenizer's words: a system turn on
    some, one to three user/assistant exchanges, media on some."""
    rng = np.random.default_rng(seed)

    def words(k):
        return " ".join(f"tok{int(i)}" for i in rng.integers(0, 149, k))

    recs = []
    for i in range(n):
        conv = [{"from": "system", "value": words(3)}] if i % 3 == 0 else []
        for _ in range(1 + i % 3):
            conv += [{"from": "human", "value": words(int(rng.integers(2, 6)))},
                     {"from": "gpt", "value": words(int(rng.integers(1, 5)))}]
        rec = {"conversations": conv}
        if i % 2:
            rec["image" if i % 4 == 1 else "video"] = f"media_{i}.png"
        recs.append(rec)
    return recs
