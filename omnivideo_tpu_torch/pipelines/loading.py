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

With `layer_stream` an expert's block tensors are read into page-locked
host buffers (pipelines/streaming.py: safetensors straight into them, a
pickle's tensors copied in) and only the rest goes to the device, so an
expert larger than the card never has to fit on it.
"""

from __future__ import annotations

import itertools
import logging
from pathlib import Path

import numpy as np
import torch

from ..configs.base import PipelineConfig
from ..device import resolve_device
from ..io.safetensors import iter_safetensors
from ..io.torch_convert import (
    load_strict,
    load_torch_file,
    split_unified_state_dict,
    unified_companions_to_params,
    unwrap_state_dict,
)
from ..models.t5 import T5Encoder, T5EncoderModel, t5_state_dict_to_params
from ..models.unified import load_special_tokens_pkl
from ..models.vae2_1 import Wan21VAE, vae_state_dict_to_params
from ..models.wan_dit import WanDiT
from ..parallel.sharding import shard_params
from .streaming import empty_host_blocks, host_block_targets
from .x2x import ExpertParams, OmniVideoX2XUnified

COMPANIONS = ("vlm_norm", "vlm_proj", "visual_context_adapter")

log = logging.getLogger(__name__)


def load_expert(cfg: PipelineConfig, ckpt_dir: str, subfolder: str,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                layer_stream: bool = False) -> ExpertParams:
    """One expert on `device`: `<ckpt_dir>/<subfolder>/model.pt` (a unified
    state dict: `wan_model.*` + companions), else the diffusers layout.
    layer_stream: the DiT's blocks in host buffers (module docstring)."""
    dev = resolve_device(device)
    sub = Path(ckpt_dir) / subfolder
    dit_cfg = cfg.dit.replace(text_len=cfg.max_context_len)
    host = None
    if layer_stream:
        wan = WanDiT(dit_cfg, dtype=dtype, device=dev, blocks_device="meta")
        wan.host_blocks = empty_host_blocks(wan)
        host = host_block_targets(wan)
    else:
        wan = WanDiT(dit_cfg, dtype=dtype, device=dev)
    pt = sub / "model.pt"
    if pt.exists():
        wan_sd, comp_sd = split_unified_state_dict(load_torch_file(pt))
        load_strict(wan, unwrap_state_dict(wan_sd), host)
        return ExpertParams(wan=wan, companions=unified_companions_to_params(comp_sd, dev))
    wan_dir = sub / "wan_model" if (sub / "wan_model").exists() else sub
    st = sorted(wan_dir.glob("*.safetensors"))
    if st:
        into = host.get if host is not None else None
        items = itertools.chain.from_iterable(
            iter_safetensors(f, "cpu" if layer_stream else dev, into=into) for f in st)
        load_strict(wan, items, host)
    else:
        load_strict(wan, unwrap_state_dict(_load_pickled_weights(wan_dir)), host)
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


@torch.no_grad()
def merge_adapters(wan, adapters) -> None:
    """Graft LoRA adapters ({path: {key: array}}, training/lora.py
    `load_adapters_npz`) onto a DiT and fold them into its weights; a
    streamed DiT's block weights are folded in their host buffers."""
    from ..training.lora import _fold, apply_lora_state, merge_lora, sites

    if not wan.streamed:
        merge_lora(apply_lora_state(wan, adapters))
        return
    host = host_block_targets(wan)
    for site in sites(wan):
        keys = adapters.get(site.path)
        if keys is None or "lora_a" not in keys:
            continue
        a, b, s = (torch.from_numpy(np.array(keys[k])) for k in ("lora_a", "lora_b", "lora_scale"))
        w = site.lin.weight
        if site.layer is not None:
            a, b, s, w = a[site.layer], b[site.layer], s[site.layer], host[f"{site.name}.weight"]
        w.copy_(_fold(w, a.to(w.device), b.to(w.device), s.to(w.device)))


def load_pipeline(cfg: PipelineConfig, ckpt_dir: str, dtype: torch.dtype = torch.bfloat16,
                  device="cuda", mesh=None, adapters=None, **pipe_kwargs) -> OmniVideoX2XUnified:
    """The x2x pipeline from a reference checkpoint dir, on `device`: the
    low-noise expert (and the high-noise one for dual-expert configs), the
    VAE, the umT5 encoder as `text_encoder` (with the tokenizer of
    `<ckpt_dir>/<cfg.t5_tokenizer>` where that dir exists) and the special
    tokens, each where its file exists.
    `pipe_kwargs` go to OmniVideoX2XUnified (qk_impl, ew_impl,
    residual_dtype, sp, layer_stream, stream_quant, stream_group); with
    layer_stream the experts load streamed. `adapters` (LoRA, {path: {key: array}}) are merged
    into each expert as it is loaded (JAX's generate merges them into both).
    With a `mesh` each expert's DiT is then sharded (parallel/sharding.py
    `shard_params`) before the next one is read (JAX
    `load_pipeline(mesh=...)`)."""
    dev = resolve_device(device)
    root = Path(ckpt_dir)

    def expert(subfolder):
        e = load_expert(cfg, ckpt_dir, subfolder, dtype, dev,
                        layer_stream=bool(pipe_kwargs.get("layer_stream")))
        if adapters is not None:
            merge_adapters(e.wan, adapters)
        if mesh is not None:
            shard_params(e.wan, mesh)
        return e

    low = expert(cfg.low_noise_checkpoint)
    high = expert(cfg.high_noise_checkpoint) if cfg.dual_expert else low

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
