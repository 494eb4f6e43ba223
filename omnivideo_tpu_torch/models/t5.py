"""umT5-XXL text encoder (port of omnivideo_tpu/models/t5.py).

The reference T5 encoder: relative-position-bucket attention with no q·k
scaling, a per-layer bidirectional relative embedding (umT5: shared_pos
False), the gated tanh-GELU FFN fc1(x)·gelu(gate(x)), RMS norms, encoder
only. The dtype rules are the JAX package's: the norm computes its rsqrt in
f32 and scales in the input dtype (`t5_norm`), the matmuls run in the
parameter dtype, the attention logits and softmax in f32 with the
-3.4e38 mask bias, and the final norm (f32 weight) returns f32.

Attention is plain einsum matmuls + softmax, as the JAX module's is: there
is no Pallas kernel on this module. Parameter names are the reference
state dict's (`blocks.{i}.attn.q.weight`, `blocks.{i}.ffn.gate.0.weight`,
`blocks.{i}.pos_embedding.embedding.weight`, ...), so a reference `.pth`
loads with `t5_state_dict_to_params`. `HuggingfaceTokenizer` makes
fixed-length ids and masks from strings (the reference's umT5 tokenizer
wrapper); `T5EncoderModel` encodes strings through it, or ids and masks.
"""

from __future__ import annotations

import functools
import json
import math
import re
from pathlib import Path
from typing import List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import T5Config
from ..device import resolve_device

MASK_BIAS = -3.4e38


@functools.lru_cache(maxsize=8)
def rel_position_buckets(lq: int, lk: int, num_buckets: int = 32, max_dist: int = 128,
                         bidirectional: bool = True) -> np.ndarray:
    """Bucket index matrix [lq, lk] int32."""
    rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    if bidirectional:
        nb = num_buckets // 2
        out = (rel > 0).astype(np.int64) * nb
        rel = np.abs(rel)
    else:
        nb = num_buckets
        out = np.zeros_like(rel)
        rel = -np.minimum(rel, 0)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (np.log(rel / max_exact + 1e-20) / math.log(max_dist / max_exact)
                             * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    out = out + np.where(rel < max_exact, rel, large)
    return out.astype(np.int32)


def t5_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) with the rsqrt cast to x's dtype, cast to
    w's dtype when w is half precision, then w · y (promoting)."""
    r = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps).to(x.dtype)
    y = x * r
    if w.dtype in (torch.float16, torch.bfloat16):
        y = y.to(w.dtype)
    return w * y


class _Weight(nn.Module):
    """A module holding only `weight` (the reference's norms and embeddings)."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.k = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.v = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.o = nn.Linear(cfg.dim_attn, cfg.dim, **kw)


class T5FeedForward(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.gate = nn.Sequential(nn.Linear(cfg.dim, cfg.dim_ffn, **kw))
        self.fc1 = nn.Linear(cfg.dim, cfg.dim_ffn, **kw)
        self.fc2 = nn.Linear(cfg.dim_ffn, cfg.dim, **kw)


class T5RelativeEmbedding(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        self.embedding = _Weight((cfg.num_buckets, cfg.num_heads), dtype, device)


class T5Layer(nn.Module):
    """One T5SelfAttention block. x: [B, L, dim]."""

    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _Weight((cfg.dim,), torch.float32, device)
        self.attn = T5Attention(cfg, dtype, device)
        self.norm2 = _Weight((cfg.dim,), torch.float32, device)
        self.ffn = T5FeedForward(cfg, dtype, device)
        self.pos_embedding = T5RelativeEmbedding(cfg, dtype, device)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor,
                buckets: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        N = self.cfg.num_heads
        hd = self.cfg.dim_attn // N
        a = self.attn
        pdtype = a.q.weight.dtype
        pos_bias = self.pos_embedding.embedding.weight[buckets].float().permute(2, 0, 1)[None]

        # self-attention without scaling; logits and softmax in f32
        h = t5_norm(x, self.norm1.weight).to(pdtype)
        q = F.linear(h, a.q.weight).view(B, L, N, hd)
        k = F.linear(h, a.k.weight).view(B, L, N, hd)
        v = F.linear(h, a.v.weight).view(B, L, N, hd)
        logits = torch.einsum("binc,bjnc->bnij", q.float(), k.float()) + pos_bias + mask_bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bnij,bjnc->binc", probs.float(), v.float()).to(pdtype)
        x = x + F.linear(o.reshape(B, L, N * hd), a.o.weight)

        # gated FFN: fc1(x) · gelu_tanh(gate(x))
        f = self.ffn
        h = t5_norm(x, self.norm2.weight).to(pdtype)
        y = F.linear(h, f.fc1.weight) * F.gelu(F.linear(h, f.gate[0].weight), approximate="tanh")
        return x + F.linear(y, f.fc2.weight)


class T5Encoder(nn.Module):
    """The umT5 encoder (t5_encode). Built with the JAX package's init
    distributions from an explicit torch.Generator, on the device (meta
    construction, then one allocation); norms f32, the rest `dtype`."""

    def __init__(self, cfg: T5Config, dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        meta = torch.device("meta")
        self.cfg = cfg
        self.token_embedding = _Weight((cfg.vocab_size, cfg.dim), dtype, meta)
        self.blocks = nn.ModuleList(T5Layer(cfg, dtype, meta) for _ in range(cfg.num_layers))
        self.norm = _Weight((cfg.dim,), torch.float32, meta)
        self.to_empty(device=dev)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 1) token embedding; q ~ (d·da)^-½, k, v, gate, fc1 ~ d^-½,
        o ~ (N·da)^-½, fc2 ~ dff^-½, relative embeddings ~ (2·nb·N)^-½;
        ones for the norms."""
        c = self.cfg
        d, da, df, N = c.dim, c.dim_attn, c.dim_ffn, c.num_heads

        def draw(p: torch.Tensor, std: float):
            t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            p.copy_(t.normal_(0.0, std, generator=generator))

        draw(self.token_embedding.weight, 1.0)
        for blk in self.blocks:
            blk.norm1.weight.fill_(1.0)
            blk.norm2.weight.fill_(1.0)
            draw(blk.attn.q.weight, (d * da) ** -0.5)
            draw(blk.attn.k.weight, d**-0.5)
            draw(blk.attn.v.weight, d**-0.5)
            draw(blk.attn.o.weight, (N * da) ** -0.5)
            draw(blk.ffn.gate[0].weight, d**-0.5)
            draw(blk.ffn.fc1.weight, d**-0.5)
            draw(blk.ffn.fc2.weight, df**-0.5)
            draw(blk.pos_embedding.embedding.weight, (2 * c.num_buckets * N) ** -0.5)
        self.norm.weight.fill_(1.0)

    @torch.inference_mode()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids, mask: [B, L] → [B, L, dim] f32."""
        dev = self.norm.weight.device
        ids, mask = ids.to(dev), mask.to(dev)
        L = ids.shape[1]
        buckets = torch.from_numpy(
            rel_position_buckets(L, L, self.cfg.num_buckets, self.cfg.rel_max_dist)).to(dev).long()
        mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, MASK_BIAS).float()
        x = self.token_embedding.weight[ids.long()]
        for blk in self.blocks:
            x = blk(x, mask_bias, buckets)
        return t5_norm(x, self.norm.weight)


def t5_state_dict_to_params(model: T5Encoder, sd: Mapping[str, object]) -> T5Encoder:
    """Copy a reference T5 encoder state dict (numpy arrays or tensors) into
    `model`, casting to each parameter's dtype; every parameter must be
    present and every key used."""
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return model


def init_t5(cfg: T5Config, dtype: torch.dtype = torch.bfloat16, device="cuda",
            seed: int = 0) -> T5Encoder:
    """A seeded random encoder on `device` (the JAX init's distributions)."""
    dev = resolve_device(device)
    return T5Encoder(cfg, dtype, dev, torch.Generator(device=dev).manual_seed(seed))


def _special_token(d: Path, key: str, default: str) -> str:
    """A special token's string from tokenizer_config.json or
    special_tokens_map.json (a string or {"content": ...})."""
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        f = d / name
        if f.exists():
            tok = json.loads(f.read_text()).get(key)
            if isinstance(tok, dict):
                tok = tok.get("content")
            if tok:
                return tok
    return default


class HuggingfaceTokenizer:
    """The umT5 tokenizer wrapper (reference modules/tokenizers.py:36-81, JAX
    models/t5.py `HuggingfaceTokenizer`): whitespace cleaning, then ids and
    attention mask padded to `seq_len` and truncated to it with the `</s>`
    of the post-processor kept, as transformers' `padding="max_length",
    truncation=True, add_special_tokens=True` gives them.

    Reads `tokenizer.json` with the `tokenizers` package (imported when one
    is built). A dir with only `spiece.model` is converted first
    (utils/spm_convert.py, which needs `transformers`)."""

    def __init__(self, name: Union[str, Path], seq_len: int = 512):
        from tokenizers import Tokenizer

        d = Path(name)
        fast = d / "tokenizer.json"
        if not fast.exists():
            from ..utils.spm_convert import ensure_fast_tokenizer

            fast = ensure_fast_tokenizer(d)
            if fast is None:
                raise FileNotFoundError(f"{d}: neither tokenizer.json nor spiece.model")
        self.tokenizer = Tokenizer.from_file(str(fast))
        pad = _special_token(d, "pad_token", "<pad>")
        pad_id = self.tokenizer.token_to_id(pad)
        if pad_id is None:
            raise ValueError(f"{d}: the pad token {pad!r} is not in the vocabulary")
        self.tokenizer.enable_truncation(max_length=seq_len)
        self.tokenizer.enable_padding(length=seq_len, pad_id=pad_id, pad_token=pad)
        self.seq_len = seq_len

    def __call__(self, texts: List[str], return_mask: bool = True):
        """texts → ids [B, seq_len] int64 (and the mask [B, seq_len] int64),
        each text's whitespace runs cleaned to one space first."""
        enc = self.tokenizer.encode_batch([re.sub(r"\s+", " ", t).strip() for t in texts],
                                          add_special_tokens=True)
        ids = torch.tensor([e.ids for e in enc], dtype=torch.int64)
        mask = torch.tensor([e.attention_mask for e in enc], dtype=torch.int64)
        return (ids, mask) if return_mask else ids


class T5EncoderModel:
    """Tokenize and encode; returns per-text [len_i, dim] f32 tensors
    stripped to the true lengths (the mask's sums), reference t5.py:505-512."""

    def __init__(self, encoder: T5Encoder, tokenizer: Optional[HuggingfaceTokenizer] = None,
                 tokenizer_path: Optional[str] = None):
        self.encoder = encoder
        self.cfg = encoder.cfg
        if tokenizer is None and tokenizer_path:
            tokenizer = HuggingfaceTokenizer(tokenizer_path, seq_len=self.cfg.text_len)
        self.tokenizer = tokenizer

    def encode_ids(self, ids: torch.Tensor, mask: torch.Tensor) -> List[torch.Tensor]:
        ctx = self.encoder(ids, mask)
        lens = mask.sum(dim=1).tolist()
        return [ctx[i, : int(n)] for i, n in enumerate(lens)]

    def __call__(self, texts: List[str]) -> List[torch.Tensor]:
        if self.tokenizer is None:
            raise RuntimeError("T5EncoderModel has no tokenizer (the checkpoint dir has no "
                               "google/umt5-xxl/); encode token ids with encode_ids(ids, mask)")
        ids, mask = self.tokenizer(texts)
        return self.encode_ids(ids, mask)
