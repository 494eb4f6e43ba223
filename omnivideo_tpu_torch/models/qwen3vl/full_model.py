"""Full Qwen3-VL multimodal forward and greedy decoding (port of
omnivideo_tpu/models/qwen3vl/full_model.py).

- visual tokens spliced into the text embedding stream at `<|video_pad|>` /
  `<|image_pad|>` positions;
- interleaved MRoPE: 3-D (t, h, w) position ids (host numpy, HF
  get_rope_index for one sample), frequency lanes interleaved [T H W T H W …]
  per mrope_section, cos/sin in f64 → f32;
- "deepstack": the tower's intermediate features added at the visual
  positions after each of the first K text layers;
- prefill through the causal flash kernel (GQA by repeating K/V, as the JAX
  package does); the decode steps attend densely over an f32 KV cache,
  with positions advancing uniformly on (t, h, w), where interleaved MRoPE
  degenerates to 1-D RoPE computed from f32 p·inv.

`qwen3vl_forward` returns the PRE-final-norm hidden state by default: HF
Qwen3VL's `hidden_states[-1]`, which the reference extracts as the
conditioning features. `qwen3vl_greedy_decode` stops computing once the eos
token was emitted (the rest is eos padding, as the JAX scan emits) and skips
the forward whose token would never be returned.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configs.qwen3vl import Qwen3VLConfig
from ...device import resolve_device
from ...ops.flash_attention import flash_attention
from ..wan_dit import AffineNorm, Gain
from .text_model import (Qwen3MoE, Qwen3TextModel, cached_attention, lm_logits, mlp_block,
                         qkv_rope, rms)
from .vision_model import Qwen3VLVision

INIT_STD = 0.02  # HF initializer_range of the Qwen3-VL configs


class Qwen3VLModel(nn.Module):
    """Vision tower + text decoder + lm_head (HF Qwen3VLForConditionalGeneration
    layout). Built from a seed with normal(0.02) weights, unit norm gains
    and zero biases, directly on `device` in `dtype` (no host copy of the
    weights is made); real weights load through io/jax_bridge.py."""

    def __init__(self, cfg: Qwen3VLConfig, dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        meta = torch.device("meta")  # allocate once, on `dev`, below
        self.visual = Qwen3VLVision(cfg.vision, dtype, meta)
        self.language_model = Qwen3TextModel(cfg.text, dtype, meta)
        self.lm_head = (None if cfg.text.tie_word_embeddings else
                        nn.Linear(cfg.text.hidden_size, cfg.text.vocab_size, bias=False,
                                  dtype=dtype, device=meta))
        self.to_empty(device=dev)
        self.init_weights(generator)

    @classmethod
    def random_init(cls, cfg: Qwen3VLConfig, seed: int = 0, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> "Qwen3VLModel":
        dev = resolve_device(device)
        return cls(cfg, dtype, dev, torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.language_model.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, INIT_STD, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, Qwen3MoE):
                for p in (m.experts_gate, m.experts_up, m.experts_down):
                    p.normal_(0.0, INIT_STD, generator=generator)
            elif isinstance(m, Gain):
                m.weight.fill_(1.0)
            elif isinstance(m, AffineNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class _StageClock:
    """Synchronized wall seconds per stage into `timings` (a no-op when the
    caller passes none, so the default path never synchronizes)."""

    def __init__(self, timings: Optional[Dict[str, float]], device: torch.device):
        self.timings, self.device = timings, device
        self.t = self._now()

    def _now(self) -> float:
        if self.timings is None:
            return 0.0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, key: str) -> None:
        if self.timings is not None:
            t = self._now()
            self.timings[key] = t - self.t
            self.t = t


def get_rope_index(input_ids: np.ndarray, grid_thw: Optional[np.ndarray],
                   cfg: Qwen3VLConfig, is_video: bool = True) -> np.ndarray:
    """position_ids [3, L] for one sample (HF Qwen3VLModel.get_rope_index).
    Video grids are split per frame with t = 1: the time rides on the
    timestamp text tokens."""
    ids = np.asarray(input_ids).reshape(-1)
    L = len(ids)
    if grid_thw is None:
        return np.broadcast_to(np.arange(L), (3, L)).copy()
    grids = np.asarray(grid_thw)
    if is_video:
        grids = np.repeat(grids, grids[:, 0], axis=0).copy()
        grids[:, 0] = 1
    m = cfg.vision.spatial_merge_size
    tok = cfg.video_token_id if is_video else cfg.image_token_id

    pos: List[np.ndarray] = []
    st = 0
    toks = ids.tolist()
    for g in grids:
        try:
            ed = toks.index(tok, st)
        except ValueError:
            break
        t, h, w = int(g[0]), int(g[1]) // m, int(g[2]) // m
        text_len = ed - st
        st_idx = pos[-1].max() + 1 if pos else 0
        pos.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
        t_i = np.repeat(np.arange(t), h * w)
        h_i = np.tile(np.repeat(np.arange(h), w), t)
        w_i = np.tile(np.arange(w), t * h)
        st_idx = pos[-1].max() + 1 if pos and pos[-1].size else st_idx
        pos.append(np.stack([t_i, h_i, w_i]) + st_idx)
        st = ed + t * h * w
    if st < L:
        st_idx = pos[-1].max() + 1 if pos else 0
        rest = L - st
        pos.append(np.broadcast_to(np.arange(rest), (3, rest)) + st_idx)
    return np.concatenate(pos, axis=1)


def mrope_cos_sin(position_ids: np.ndarray, cfg: Qwen3VLConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Interleaved-MRoPE cos/sin [L, head_dim] f32, computed in f64 (HF
    apply_interleaved_mrope)."""
    hd = cfg.text.head_dim
    inv = 1.0 / (cfg.text.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    freqs3 = position_ids[:, :, None].astype(np.float64) * inv[None, None]  # [3, L, hd/2]
    out = freqs3[0].copy()
    for dim, offset in enumerate((1, 2), start=1):
        idx = slice(offset, cfg.mrope_section[dim] * 3, 3)
        out[:, idx] = freqs3[dim][:, idx]
    emb = np.concatenate([out, out], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _embed_multimodal(model: Qwen3VLModel, ids: np.ndarray, pixel_patches, grid_thw):
    """(x [1, L, D], visual positions or None, deepstack list, position ids)
    for a video prompt (the port has no image preprocessing yet)."""
    cfg = model.cfg
    dev = model.device
    x = model.language_model.embed_tokens(torch.as_tensor(ids, device=dev))
    if pixel_patches is None:
        return x, None, [], get_rope_index(ids, None, cfg)
    tokens, deepstack = model.visual(torch.as_tensor(pixel_patches), grid_thw)
    vis = np.nonzero(ids[0] == cfg.video_token_id)[0]
    if len(vis) != tokens.shape[0]:
        raise ValueError(f"{len(vis)} placeholder tokens vs {tokens.shape[0]} visual tokens")
    vis_t = torch.as_tensor(vis, device=dev)
    x[0, vis_t] = tokens.to(x.dtype)
    pos = get_rope_index(ids, np.array([list(grid_thw)]), cfg)
    return x, vis_t, deepstack, pos


def _prefill(model: Qwen3VLModel, ids: np.ndarray, pixel_patches, grid_thw,
             cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             timings: Optional[Dict[str, float]] = None):
    """The multimodal causal forward over all layers → (pre-norm hidden
    [1, L, D], position ids). With `cache` = (k, v) [layers, 1, S, K, hd]
    f32, the post-RoPE K/V of every layer are written to rows [0, L).
    `timings` gets "vision_s" (embedding, tower, splice) and "prefill_s"
    (the text layers)."""
    tcfg = model.cfg.text
    eps = tcfg.rms_norm_eps
    rep = tcfg.num_attention_heads // tcfg.num_key_value_heads
    clock = _StageClock(timings, model.device)
    x, vis, deepstack, pos = _embed_multimodal(model, ids, pixel_patches, grid_thw)
    clock("vision_s")
    B, L, D = x.shape
    cos, sin = (torch.as_tensor(a, device=x.device) for a in mrope_cos_sin(pos, model.cfg))
    for i, layer in enumerate(model.language_model.layers):
        attn = layer.self_attn
        q, k, v = qkv_rope(attn, rms(x, layer.input_layernorm.weight, eps), cos, sin, tcfg)
        if cache is not None:
            cache[0][i, :, :L] = k.float()
            cache[1][i, :, :L] = v.float()
        o = flash_attention(q, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2),
                            causal=True)
        x = x + F.linear(o.reshape(B, L, -1), attn.o_proj.weight)
        x = mlp_block(layer, x, eps)
        if vis is not None and i < len(deepstack):
            x[0, vis] = x[0, vis] + deepstack[i].to(x.dtype)
    clock("prefill_s")
    return x, pos


@torch.inference_mode()
def qwen3vl_forward(
    model: Qwen3VLModel,
    input_ids: np.ndarray,
    pixel_patches=None,
    grid_thw: Optional[Tuple[int, int, int]] = None,
    final_norm: bool = False,
) -> torch.Tensor:
    """Multimodal forward → hidden state [1, L, D] (pre-final-norm unless
    final_norm). input_ids: [1, L] with the `<|video_pad|>` spans already
    expanded to the grid's token counts; pixel_patches: [num_patches,
    C·tp·p·p]."""
    ids = np.asarray(input_ids)
    x, _ = _prefill(model, ids, pixel_patches, grid_thw)
    if final_norm:
        x = rms(x, model.language_model.norm.weight, model.cfg.text.rms_norm_eps)
    return x


def sample_token(logits: torch.Tensor, temperature: float, top_p: float,
                 generator: Optional[torch.Generator] = None) -> int:
    """Greedy (temperature ≤ 0) or top-p nucleus sampling over logits [V]:
    keep the smallest prefix of the sorted logits whose cumulative
    probability reaches top_p, sample from those with `generator`."""
    if temperature <= 0:
        return int(torch.argmax(logits))
    logits = logits.float() / temperature
    sorted_logits = torch.sort(logits, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, -1), -1)
    cutoff_idx = min(int((cum < top_p).sum()), logits.shape[-1] - 1)
    filtered = torch.where(logits >= sorted_logits[cutoff_idx], logits,
                           torch.full_like(logits, -1e30))
    return int(torch.multinomial(torch.softmax(filtered, -1), 1, generator=generator))


@torch.inference_mode()
def qwen3vl_greedy_decode(
    model: Qwen3VLModel,
    input_ids: np.ndarray,
    pixel_patches=None,
    grid_thw: Optional[Tuple[int, int, int]] = None,
    max_new_tokens: int = 128,
    eos_token_id: Optional[int] = None,
    temperature: float = 0.0,
    top_p: float = 0.9,
    generator: Optional[torch.Generator] = None,
    timings: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Caption decoding with a KV cache → [max_new_tokens] int64 (eos-padded
    after the stop). Prefill is the multimodal forward caching post-RoPE K/V
    in f32; each decode step is one cached pass over the layers. `timings`,
    when given, receives synchronized "vision_s", "prefill_s", "decode_s"
    (first token included) and "decode_steps"."""
    cfg = model.cfg
    tcfg = cfg.text
    eps, hd = tcfg.rms_norm_eps, tcfg.head_dim
    lm = model.language_model
    ids = np.asarray(input_ids)
    B, Lp = ids.shape
    if B != 1:
        raise ValueError("qwen3vl_greedy_decode takes one sample")
    dev = model.device
    shape = (tcfg.num_hidden_layers, B, Lp + max_new_tokens, tcfg.num_key_value_heads, hd)
    kc = torch.zeros(shape, dtype=torch.float32, device=dev)
    vc = torch.zeros_like(kc)
    x, pos = _prefill(model, ids, pixel_patches, grid_thw, cache=(kc, vc), timings=timings)
    clock = _StageClock(timings, dev)
    logits = lm_logits(model.lm_head, lm.embed_tokens, rms(x[:, -1:], lm.norm.weight, eps))
    tok = sample_token(logits[0, -1], temperature, top_p, generator)

    start_pos = int(pos.max()) + 1  # decode positions advance uniformly on (t, h, w)
    inv = torch.tensor(1.0 / (tcfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd)),
                       dtype=torch.float32, device=dev)
    out = np.full(max_new_tokens, eos_token_id if eos_token_id is not None else 0, np.int64)
    steps = 0
    for i in range(max_new_tokens):
        out[i] = tok
        if i == max_new_tokens - 1 or (eos_token_id is not None and tok == eos_token_id):
            break
        steps += 1
        length = Lp + i
        ang = torch.tensor(float(start_pos + i), dtype=torch.float32, device=dev) * inv
        c1, s1 = torch.cat([ang.cos(), ang.cos()])[None], torch.cat([ang.sin(), ang.sin()])[None]
        h = lm.embed_tokens(torch.tensor([[tok]], device=dev))
        for j, layer in enumerate(lm.layers):
            attn = layer.self_attn
            q, k, v = qkv_rope(attn, rms(h, layer.input_layernorm.weight, eps), c1, s1, tcfg)
            kc[j, :, length] = k[:, 0].float()
            vc[j, :, length] = v[:, 0].float()
            o = cached_attention(q, kc[j, :, :length + 1], vc[j, :, :length + 1], h.dtype)
            h = mlp_block(layer, h + F.linear(o, attn.o_proj.weight), eps)
        logits = lm_logits(model.lm_head, lm.embed_tokens, rms(h, lm.norm.weight, eps))
        tok = sample_token(logits[0, -1], temperature, top_p, generator)
    clock("decode_s")
    if timings is not None:
        timings["decode_steps"] = steps
    return out

