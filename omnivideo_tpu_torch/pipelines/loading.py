"""Pipeline checkpoint loading from the reference's on-disk layout (port of
omnivideo_tpu/pipelines/loading.py):

    ckpt_dir/
      high_noise_model/model.pt        # fine-tuned unified expert
      low_noise_model/model.pt
      special_tokens.pkl
      models_t5_umt5-xxl-enc-bf16.pth
      Wan2.1_VAE.pth
      google/umt5-xxl/                 # tokenizer files

The files are torch pickles read with `torch.load(..., weights_only=True)`;
the names map through io/torch_convert.py (experts and companions),
models/vae2_1.py and models/t5.py. The diffusers layout of an expert
(a subfolder with config.json and safetensors weights) is not read yet: it
raises, naming the layout.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from ..configs.base import PipelineConfig
from ..device import resolve_device
from ..io.torch_convert import (
    load_torch_file,
    split_unified_state_dict,
    unified_companions_to_params,
    wan_state_dict_to_params,
)
from ..models.t5 import T5Encoder, T5EncoderModel, t5_state_dict_to_params
from ..models.unified import load_special_tokens_pkl
from ..models.vae2_1 import Wan21VAE, vae_state_dict_to_params
from .x2x import ExpertParams, OmniVideoX2XUnified

log = logging.getLogger(__name__)


def load_expert(cfg: PipelineConfig, ckpt_dir: str, subfolder: str,
                dtype: torch.dtype = torch.bfloat16, device="cuda") -> ExpertParams:
    """One expert from `<ckpt_dir>/<subfolder>/model.pt` (a unified state
    dict: `wan_model.*` + companions), on `device`."""
    dev = resolve_device(device)
    sub = Path(ckpt_dir) / subfolder
    pt = sub / "model.pt"
    if not pt.exists():
        raise NotImplementedError(
            f"{sub}: no model.pt; the diffusers layout (config.json + safetensors weights) "
            "is not read by the port yet")
    wan_sd, comp_sd = split_unified_state_dict(load_torch_file(pt))
    dit_cfg = cfg.dit.replace(text_len=cfg.max_context_len)
    wan = wan_state_dict_to_params(wan_sd, dit_cfg, dtype=dtype, device=dev)
    return ExpertParams(wan=wan, companions=unified_companions_to_params(comp_sd, dev))


def load_pipeline(cfg: PipelineConfig, ckpt_dir: str, dtype: torch.dtype = torch.bfloat16,
                  device="cuda", **pipe_kwargs) -> OmniVideoX2XUnified:
    """The x2x pipeline from a reference checkpoint dir, on `device`: the
    low-noise expert (and the high-noise one for dual-expert configs), the
    VAE, the umT5 encoder as `text_encoder` (ids only until the tokenizer
    is ported) and the special tokens, each where its file exists.
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
        text_encoder = T5EncoderModel(t5_state_dict_to_params(enc, load_torch_file(path)))
    else:
        log.warning("T5 checkpoint %s missing; text encoding disabled", path)

    special = None
    path = root / "special_tokens.pkl"
    if path.exists():
        special = load_special_tokens_pkl(str(path), dev)
        log.info("loaded special tokens: %s", list(special))

    return OmniVideoX2XUnified(cfg, low, high, vae=vae, special_tokens=special,
                               text_encoder=text_encoder, **pipe_kwargs)
