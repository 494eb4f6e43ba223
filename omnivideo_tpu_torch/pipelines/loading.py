"""Pipeline checkpoint loading from the reference's on-disk layout (port of
omnivideo_tpu/pipelines/loading.py):

    ckpt_dir/
      high_noise_model/model.pt        # fine-tuned unified expert, or the
      low_noise_model/model.pt         #   diffusers layout (below)
      special_tokens.pkl
      models_t5_umt5-xxl-enc-bf16.pth
      Wan2.1_VAE.pth
      google/umt5-xxl/                 # tokenizer files

The pickles are read with `torch.load(..., weights_only=True)`; the names
map through io/torch_convert.py (experts and companions), models/vae2_1.py
and models/t5.py. An expert subfolder without model.pt is the diffusers
layout: the WanModel weights in `wan_model/` (or the subfolder itself) as
`*.safetensors`, streamed tensor by tensor onto the device
(io/safetensors.py, so the expert is never held twice), or as
`.bin/.pth/.pt` pickles; the companions in
`{vlm_norm,vlm_proj,visual_context_adapter}_pytorch_model.bin`. The umT5
encoder gets the tokenizer of `google/umt5-xxl/` when the dir has one.
"""

from __future__ import annotations

import itertools
import logging
from pathlib import Path

import torch

from ..configs.base import PipelineConfig
from ..device import resolve_device
from ..io.safetensors import iter_safetensors
from ..io.torch_convert import (
    load_strict,
    load_torch_file,
    split_unified_state_dict,
    unified_companions_to_params,
    wan_state_dict_to_params,
)
from ..models.t5 import T5Encoder, T5EncoderModel, t5_state_dict_to_params
from ..models.unified import load_special_tokens_pkl
from ..models.vae2_1 import Wan21VAE, vae_state_dict_to_params
from ..models.wan_dit import WanDiT
from .x2x import ExpertParams, OmniVideoX2XUnified

COMPANIONS = ("vlm_norm", "vlm_proj", "visual_context_adapter")

log = logging.getLogger(__name__)


def load_expert(cfg: PipelineConfig, ckpt_dir: str, subfolder: str,
                dtype: torch.dtype = torch.bfloat16, device="cuda") -> ExpertParams:
    """One expert on `device`: `<ckpt_dir>/<subfolder>/model.pt` (a unified
    state dict: `wan_model.*` + companions), else the diffusers layout."""
    dev = resolve_device(device)
    sub = Path(ckpt_dir) / subfolder
    dit_cfg = cfg.dit.replace(text_len=cfg.max_context_len)
    pt = sub / "model.pt"
    if pt.exists():
        wan_sd, comp_sd = split_unified_state_dict(load_torch_file(pt))
        wan = wan_state_dict_to_params(wan_sd, dit_cfg, dtype=dtype, device=dev)
        return ExpertParams(wan=wan, companions=unified_companions_to_params(comp_sd, dev))
    wan_dir = sub / "wan_model" if (sub / "wan_model").exists() else sub
    st = sorted(wan_dir.glob("*.safetensors"))
    if st:
        items = itertools.chain.from_iterable(iter_safetensors(f, dev) for f in st)
        wan = load_strict(WanDiT(dit_cfg, dtype=dtype, device=dev), items)
    else:
        wan = wan_state_dict_to_params(_load_pickled_weights(wan_dir), dit_cfg, dtype=dtype,
                                       device=dev)
    companions = {}
    for name in COMPANIONS:
        f = sub / f"{name}_pytorch_model.bin"
        if f.exists():
            sd = {k if k.startswith(name) else f"{name}.{k}": v
                  for k, v in load_torch_file(f).items()}
            companions.update(unified_companions_to_params(sd, dev))
    return ExpertParams(wan=wan, companions=companions)


def _load_pickled_weights(folder: Path) -> dict:
    files = [f for ext in ("bin", "pth", "pt") for f in sorted(folder.glob(f"*.{ext}"))]
    if not files:
        raise FileNotFoundError(f"no weights found in {folder} (*.safetensors, *.bin, *.pth, *.pt)")
    sd = {}
    for f in files:
        sd.update(load_torch_file(f))
    return sd


def load_pipeline(cfg: PipelineConfig, ckpt_dir: str, dtype: torch.dtype = torch.bfloat16,
                  device="cuda", **pipe_kwargs) -> OmniVideoX2XUnified:
    """The x2x pipeline from a reference checkpoint dir, on `device`: the
    low-noise expert (and the high-noise one for dual-expert configs), the
    VAE, the umT5 encoder as `text_encoder` (with the tokenizer of
    `<ckpt_dir>/<cfg.t5_tokenizer>` where that dir exists) and the special
    tokens, each where its file exists.
    `pipe_kwargs` go to OmniVideoX2XUnified (qk_impl, ew_impl,
    residual_dtype)."""
    dev = resolve_device(device)
    root = Path(ckpt_dir)
    low = load_expert(cfg, ckpt_dir, cfg.low_noise_checkpoint, dtype, dev)
    high = load_expert(cfg, ckpt_dir, cfg.high_noise_checkpoint, dtype, dev) \
        if cfg.dual_expert else low

    vae = None
    path = root / cfg.vae_checkpoint
    if path.exists():
        vae = Wan21VAE.create(vae_state_dict_to_params(load_torch_file(path), cfg.vae, dev),
                              cfg.vae)
    else:
        log.warning("VAE checkpoint %s missing", path)

    text_encoder = None
    path = root / cfg.t5_checkpoint
    if path.exists():
        enc = T5Encoder(cfg.t5, dtype=dtype, device=dev)
        tok = root / cfg.t5_tokenizer
        text_encoder = T5EncoderModel(t5_state_dict_to_params(enc, load_torch_file(path)),
                                      tokenizer_path=str(tok) if tok.exists() else None)
    else:
        log.warning("T5 checkpoint %s missing; text encoding disabled", path)

    special = None
    path = root / "special_tokens.pkl"
    if path.exists():
        special = load_special_tokens_pkl(str(path), dev)
        log.info("loaded special tokens: %s", list(special))

    return OmniVideoX2XUnified(cfg, low, high, vae=vae, special_tokens=special,
                               text_encoder=text_encoder, **pipe_kwargs)
