"""Shared set-up of the i2v parity tests: a seeded reference-layout state
dict of an i2v WanDiT, which JAX's converter and the port both read (JAX's
init_wan_dit draws no i2v parameters)."""

import numpy as np
import torch

from omnivideo_tpu_torch.configs.base import WanDiTConfig
from omnivideo_tpu_torch.models.wan_dit import WanDiT


def seeded_wan_sd(cfg: WanDiTConfig, seed: int):
    """Reference-named f32 arrays of an i2v WanDiT's shapes: linears
    N(0, 1/fan_in), gains and norms near 1, biases N(0, 0.02²), modulation
    tables N(0, 1/dim)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              WanDiT(cfg, dtype=torch.float32, device="cpu").state_dict().items()}
    sd = {}
    for k, shp in shapes.items():
        if k.endswith("modulation"):
            a = rng.standard_normal(shp) / np.sqrt(cfg.dim)
        elif len(shp) == 1 and ("norm" in k or ".proj.0." in k or ".proj.4." in k):
            a = (1.0 if k.endswith("weight") else 0.0) + 0.1 * rng.standard_normal(shp)
        elif len(shp) == 1:
            a = 0.02 * rng.standard_normal(shp)
        else:
            a = rng.standard_normal(shp) / np.sqrt(np.prod(shp[1:]))
        sd[k] = a.astype(np.float32)
    sd["patch_embedding.weight"] = sd["patch_embedding.weight"].reshape(
        cfg.dim, cfg.in_dim, *cfg.patch_size)
    return sd
