"""Wan2.1 causal 3D VAE, encode and decode (port of
omnivideo_tpu/models/vae2_1.py).

Streaming encode in 1+4k-frame chunks (the first chunk one frame, then four
frames per latent frame) and streaming decode, one latent frame per step,
with an explicit cache per causal conv (its last k_t−1 input frames; zeros
before the first chunk, which equals the reference's left zero-pad). The
first chunk skips the temporal down- and up-convs: the encoder's stride-2
time conv starts on the second chunk with the first chunk's last frame
carried, and the decoder's carried cache is zeros. Runs eagerly under
inference mode, chunk by chunk: the JAX package jits the decode whole only
because the eager form ran out of TPU memory.

Parameters keep the JAX dict layout; conv weights are OIDHW/OIHW, already
PyTorch's layout, so a reference state dict maps by name
(`vae_state_dict_to_params`). Convolutions compute in f32 with cuDNN's TF32
turned off for the call (cuDNN defaults to TF32, which keeps ~3 decimal
digits).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import VAEConfig
from ..device import resolve_device

CACHE_T = 2  # frames carried per k_t=3 causal conv

WAN21_LATENT_MEAN = np.array(
    [-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
     0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921],
    dtype=np.float32)
WAN21_LATENT_STD = np.array(
    [2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
     3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160],
    dtype=np.float32)


def encoder_plan(cfg: VAEConfig) -> List[Tuple[str, int, int]]:
    """Ordered (kind, in_dim, out_dim) of encoder.downsamples."""
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    plan: List[Tuple[str, int, int]] = []
    scale = 1.0
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            plan.append(("res", din, dout))
            if scale in cfg.attn_scales:
                plan.append(("attn", dout, dout))
            din = dout
        if i != len(cfg.dim_mult) - 1:
            plan.append(("down3d" if cfg.temperal_downsample[i] else "down2d", dout, dout))
            scale /= 2.0
    return plan


def decoder_plan(cfg: VAEConfig) -> List[Tuple[str, int, int]]:
    """Ordered (kind, in_dim, out_dim) of decoder.upsamples."""
    mult = tuple(cfg.dim_mult)
    dims = [cfg.dim * u for u in (mult[-1],) + tuple(reversed(mult))]
    plan: List[Tuple[str, int, int]] = []
    scale = 1.0 / 2 ** (len(mult) - 2)
    ups = cfg.temperal_upsample
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (1, 2, 3):
            din = din // 2  # the previous upsample halved the channels
        for _ in range(cfg.num_res_blocks + 1):
            plan.append(("res", din, dout))
            if scale in cfg.attn_scales:
                plan.append(("attn", dout, dout))
            din = dout
        if i != len(mult) - 1:
            plan.append(("up3d" if ups[i] else "up2d", dout, dout // 2))
            scale *= 2.0
    return plan


def _conv3d(x, w, b, stride=(1, 1, 1), spatial_pad=(0, 0)):
    return F.conv3d(x, w.to(x.dtype), b.to(x.dtype), stride, (0,) + tuple(spatial_pad))


def _conv2d(x, w, b, padding=1):
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), 1, padding)


def causal_conv3d(p, x, cache):
    """CausalConv3d streaming step → (y, new_cache). `cache` holds the last
    k_t−1 input frames of earlier chunks (None: zeros). k_t == 1 convs carry
    no cache."""
    w, b = p["weight"], p["bias"]
    kt, kh, kw = w.shape[2], w.shape[3], w.shape[4]
    if kt == 1:
        return _conv3d(x, w, b, spatial_pad=(kh // 2, kw // 2)), None
    if cache is None:
        cache = x.new_zeros(x.shape[:2] + (kt - 1,) + x.shape[3:])
    xin = torch.cat([cache, x], dim=2)
    return _conv3d(xin, w, b, spatial_pad=(kh // 2, kw // 2)), xin[:, :, -(kt - 1):]


def vae_rms_norm(x, gamma):
    """Channel RMS norm: F.normalize over C · √C · gamma, in f32."""
    xf = x.float()
    l2 = xf.square().sum(dim=1, keepdim=True).sqrt()
    y = xf / l2.clamp_min(1e-12) * math.sqrt(x.shape[1])
    g = gamma.float().reshape((1, -1) + (1,) * (x.ndim - 2))
    return (y * g).to(x.dtype)


def res_block(p, x, cache):
    cache = cache or {}
    h = causal_conv3d(p["shortcut"], x, None)[0] if "shortcut" in p else x
    y = F.silu(vae_rms_norm(x, p["norm1"]))
    y, c1 = causal_conv3d(p["conv1"], y, cache.get("c1"))
    y = F.silu(vae_rms_norm(y, p["norm2"]))
    y, c2 = causal_conv3d(p["conv2"], y, cache.get("c2"))
    return y + h, {"c1": c1, "c2": c2}


def _spatial(fn, x):
    B, C, T, H, W = x.shape
    y = fn(x.transpose(1, 2).reshape(B * T, C, H, W))
    return y.reshape(B, T, *y.shape[1:]).transpose(1, 2)


def attention_block(p, x):
    """Single-head per-frame spatial attention, f32 logits and softmax."""
    B, C, T, H, W = x.shape
    y = vae_rms_norm(x, p["norm"]).transpose(1, 2).reshape(B * T, C, H, W)
    qkv = _conv2d(y, p["qkv_w"], p["qkv_b"], padding=0)
    qkv = qkv.reshape(B * T, 3 * C, H * W).transpose(1, 2)
    q, k, v = qkv.chunk(3, dim=-1)
    logits = torch.einsum("bic,bjc->bij", q.float(), k.float())
    probs = torch.softmax(logits * C**-0.5, dim=-1).to(v.dtype)
    o = torch.einsum("bij,bjc->bic", probs.float(), v.float()).to(x.dtype)
    o = _conv2d(o.transpose(1, 2).reshape(B * T, C, H, W), p["proj_w"], p["proj_b"], padding=0)
    return x + o.reshape(B, T, C, H, W).transpose(1, 2)


def downsample(p, x, cache, kind: str, first: bool):
    """down2d / down3d: zero-pad right and bottom by one, a 3×3 stride-2
    conv; then for down3d a stride-2 temporal conv over [carried frame, x]
    (skipped on the first chunk, whose last frame is carried)."""

    def down2x(y):
        return F.conv2d(F.pad(y, (0, 1, 0, 1)), p["conv_w"].to(y.dtype), p["conv_b"].to(y.dtype),
                        stride=2)

    x = _spatial(down2x, x)
    if kind == "down2d":
        return x, cache
    if first:
        return x, x[:, :, -1:]
    xin = torch.cat([cache, x], dim=2)
    return _conv3d(xin, p["time_w"], p["time_b"], stride=(2, 1, 1)), x[:, :, -1:]


def upsample(p, x, cache, kind: str, first: bool):
    """up2d / up3d: optional temporal ×2 (skipped on the first chunk), then
    nearest ×2 in space and a 3×3 conv to C//2."""
    if kind == "up3d" and not first:
        B, C, T, H, W = x.shape
        xin = torch.cat([cache, x], dim=2)
        y = _conv3d(xin, p["time_w"], p["time_b"])  # valid temporal conv → 2C
        y = y.reshape(B, 2, C, T, H, W)
        x = torch.stack([y[:, 0], y[:, 1]], dim=3).reshape(B, C, 2 * T, H, W)
        new_cache = xin[:, :, -CACHE_T:]
    elif kind == "up3d":
        # chunk 0's frames never enter the time conv: the carry is zeros
        new_cache = x.new_zeros(x.shape[:2] + (CACHE_T,) + x.shape[3:])
    else:
        new_cache = cache

    def up2x(y):
        y = F.interpolate(y, scale_factor=2.0, mode="nearest")
        return _conv2d(y, p["conv_w"], p["conv_b"])

    return _spatial(up2x, x), new_cache


def encoder_chunk(params, cfg: VAEConfig, x, cache: Dict[str, Any], first: bool):
    """One streaming encoder step over a 1- or 4-frame pixel chunk →
    (2·z_dim channels of one latent frame, cache)."""
    enc = params["encoder"]
    new: Dict[str, Any] = {}
    x, new["conv1"] = causal_conv3d(enc["conv1"], x, cache.get("conv1"))
    for i, (kind, _, _) in enumerate(encoder_plan(cfg)):
        key = f"d{i}"
        p = enc["down"][key]
        if kind == "res":
            x, new[key] = res_block(p, x, cache.get(key))
        elif kind == "attn":
            x = attention_block(p, x)
        else:
            x, new[key] = downsample(p, x, cache.get(key), kind, first)
    x, new["mid0"] = res_block(enc["mid0"], x, cache.get("mid0"))
    x = attention_block(enc["mid_attn"], x)
    x, new["mid1"] = res_block(enc["mid1"], x, cache.get("mid1"))
    y = F.silu(vae_rms_norm(x, enc["head"]["norm"]))
    x, new["head"] = causal_conv3d(enc["head"]["conv"], y, cache.get("head"))
    return x, new


def decoder_chunk(params, cfg: VAEConfig, z, cache: Dict[str, Any], first: bool):
    """One streaming decoder step over a single latent frame → (frames, cache)."""
    dec = params["decoder"]
    new: Dict[str, Any] = {}
    x, new["conv1"] = causal_conv3d(dec["conv1"], z, cache.get("conv1"))
    x, new["mid0"] = res_block(dec["mid0"], x, cache.get("mid0"))
    x = attention_block(dec["mid_attn"], x)
    x, new["mid1"] = res_block(dec["mid1"], x, cache.get("mid1"))
    for i, (kind, _, _) in enumerate(decoder_plan(cfg)):
        key = f"u{i}"
        p = dec["up"][key]
        if kind == "res":
            x, new[key] = res_block(p, x, cache.get(key))
        elif kind == "attn":
            x = attention_block(p, x)
        else:
            x, new[key] = upsample(p, x, cache.get(key), kind, first)
    y = F.silu(vae_rms_norm(x, dec["head"]["norm"]))
    x, new["head"] = causal_conv3d(dec["head"]["conv"], y, cache.get("head"))
    return x, new


@torch.inference_mode()
def vae_encode(params, cfg: VAEConfig, videos: torch.Tensor,
               scale: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Video [B, 3, T, H, W] in [-1, 1], T = 1+4k → the latent mean
    [B, z, 1+k, H/8, W/8] f32, normalized with (mean, 1/std) `scale`."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        x = videos.float()
        T = x.shape[2]
        if (T - 1) % 4:
            raise ValueError(f"vae_encode: frame count {T} is not 4n+1")
        cache: Dict[str, Any] = {}
        zs = []
        for i, a in enumerate([0] + list(range(1, T, 4))):
            z, cache = encoder_chunk(params, cfg, x[:, :, a:a + (1 if i == 0 else 4)], cache,
                                     first=i == 0)
            zs.append(z)
        del cache
        out, _ = causal_conv3d(params["conv1"], torch.cat(zs, dim=2), None)
        mu = out[:, : cfg.z_dim]
        if scale is not None:
            mean, inv_std = scale
            mu = (mu - mean.reshape(1, -1, 1, 1, 1)) * inv_std.reshape(1, -1, 1, 1, 1)
        return mu.float()


@torch.inference_mode()
def vae_decode(params, cfg: VAEConfig, z: torch.Tensor,
               scale: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Latents [B, z, t, h, w] → video [B, 3, 1+4(t−1), 8h, 8w] f32 in [-1, 1]."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        z = z.float()
        if scale is not None:
            mean, inv_std = scale
            z = z / inv_std.reshape(1, -1, 1, 1, 1) + mean.reshape(1, -1, 1, 1, 1)
        x, _ = causal_conv3d(params["conv2"], z, None)
        B, _, T, h, w = x.shape
        t_up = 2 ** sum(bool(u) for u in cfg.temperal_upsample)
        s_up = 2 ** (len(cfg.dim_mult) - 1)
        out = torch.empty(B, 3, 1 + t_up * (T - 1), h * s_up, w * s_up,
                          dtype=torch.float32, device=z.device)
        cache: Dict[str, Any] = {}
        pos = 0
        for i in range(T):
            y, cache = decoder_chunk(params, cfg, x[:, :, i:i + 1], cache, first=i == 0)
            n = y.shape[2]
            out[:, :, pos:pos + n] = y.float().clamp(-1.0, 1.0)
            pos += n
        if pos != out.shape[2]:
            raise RuntimeError(f"decoder produced {pos} frames, expected {out.shape[2]}")
        return out


def init_vae(cfg: VAEConfig, device="cuda", generator: Optional[torch.Generator] = None):
    """Random params (normal·0.05 convs, zero biases, unit norms, zero
    attention projections), f32, on `device`: the decoder's draws first,
    then the encoder's."""
    device = resolve_device(device)

    def conv(cin, cout, k):
        return {"weight": torch.empty((cout, cin) + k, device=device)
                .normal_(0.0, 0.05, generator=generator),
                "bias": torch.zeros(cout, device=device)}

    def res_p(din, dout):
        p = {"norm1": torch.ones(din, device=device), "conv1": conv(din, dout, (3, 3, 3)),
             "norm2": torch.ones(dout, device=device), "conv2": conv(dout, dout, (3, 3, 3))}
        if din != dout:
            p["shortcut"] = conv(din, dout, (1, 1, 1))
        return p

    def attn_p(d):
        return {"norm": torch.ones(d, device=device),
                "qkv_w": torch.empty(3 * d, d, 1, 1, device=device)
                .normal_(0.0, 0.05, generator=generator),
                "qkv_b": torch.zeros(3 * d, device=device),
                "proj_w": torch.zeros(d, d, 1, 1, device=device),
                "proj_b": torch.zeros(d, device=device)}

    def up_p(kind, d, dout):
        c = conv(d, dout, (3, 3))
        p = {"conv_w": c["weight"], "conv_b": c["bias"]}
        if kind == "up3d":
            t = conv(d, 2 * d, (3, 1, 1))
            p["time_w"], p["time_b"] = t["weight"], t["bias"]
        return p

    d_top = cfg.dim * cfg.dim_mult[-1]
    dec = {
        "conv1": conv(cfg.z_dim, d_top, (3, 3, 3)),
        "mid0": res_p(d_top, d_top),
        "mid_attn": attn_p(d_top),
        "mid1": res_p(d_top, d_top),
        "head": {"norm": torch.ones(cfg.dim, device=device),
                 "conv": conv(cfg.dim, 3, (3, 3, 3))},
        "up": {},
    }
    for i, (kind, din, dout) in enumerate(decoder_plan(cfg)):
        dec["up"][f"u{i}"] = (res_p(din, dout) if kind == "res"
                              else attn_p(dout) if kind == "attn"
                              else up_p(kind, din, dout))
    conv2 = conv(cfg.z_dim, cfg.z_dim, (1, 1, 1))

    def down_p(kind, d):
        c = conv(d, d, (3, 3))
        p = {"conv_w": c["weight"], "conv_b": c["bias"]}
        if kind == "down3d":
            t = conv(d, d, (3, 1, 1))
            p["time_w"], p["time_b"] = t["weight"], t["bias"]
        return p

    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    enc = {"conv1": conv(3, dims[0], (3, 3, 3)), "down": {}}
    for i, (kind, din, dout) in enumerate(encoder_plan(cfg)):
        enc["down"][f"d{i}"] = (res_p(din, dout) if kind == "res"
                                else attn_p(dout) if kind == "attn" else down_p(kind, dout))
    enc["mid0"], enc["mid_attn"], enc["mid1"] = res_p(d_top, d_top), attn_p(d_top), res_p(d_top, d_top)
    enc["head"] = {"norm": torch.ones(d_top, device=device),
                   "conv": conv(d_top, 2 * cfg.z_dim, (3, 3, 3))}
    return {"encoder": enc, "decoder": dec, "conv1": conv(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1)),
            "conv2": conv2}


def vae_state_dict_to_params(sd, cfg: VAEConfig, device=None) -> Dict[str, Any]:
    """A reference Wan2.1 VAE state dict (numpy arrays or tensors) → the
    encoder and decoder params, f32 tensors on `device`."""

    def g(k):
        return torch.as_tensor(np.asarray(sd[k], np.float32) if not torch.is_tensor(sd[k])
                               else sd[k]).float().to(device)

    def conv(prefix):
        return {"weight": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    def res(prefix, has_shortcut):
        p = {"norm1": g(f"{prefix}.residual.0.gamma").reshape(-1),
             "conv1": conv(f"{prefix}.residual.2"),
             "norm2": g(f"{prefix}.residual.3.gamma").reshape(-1),
             "conv2": conv(f"{prefix}.residual.6")}
        if has_shortcut:
            p["shortcut"] = conv(f"{prefix}.shortcut")
        return p

    def attn(prefix):
        return {"norm": g(f"{prefix}.norm.gamma").reshape(-1),
                "qkv_w": g(f"{prefix}.to_qkv.weight"), "qkv_b": g(f"{prefix}.to_qkv.bias"),
                "proj_w": g(f"{prefix}.proj.weight"), "proj_b": g(f"{prefix}.proj.bias")}

    def resample(prefix, kind):
        c = conv(f"{prefix}.resample.1")
        p = {"conv_w": c["weight"], "conv_b": c["bias"]}
        if kind in ("down3d", "up3d"):
            t = conv(f"{prefix}.time_conv")
            p["time_w"], p["time_b"] = t["weight"], t["bias"]
        return p

    def half(name, plan, key):
        out = {"conv1": conv(f"{name}.conv1"), "mid0": res(f"{name}.middle.0", False),
               "mid_attn": attn(f"{name}.middle.1"), "mid1": res(f"{name}.middle.2", False),
               "head": {"norm": g(f"{name}.head.0.gamma").reshape(-1),
                        "conv": conv(f"{name}.head.2")}}
        sub = "downsamples" if name == "encoder" else "upsamples"
        out[key] = {}
        for i, (kind, din, dout) in enumerate(plan):
            pref = f"{name}.{sub}.{i}"
            out[key][f"{key[0]}{i}"] = (res(pref, din != dout) if kind == "res"
                                        else attn(pref) if kind == "attn" else resample(pref, kind))
        return out

    return {"encoder": half("encoder", encoder_plan(cfg), "down"),
            "decoder": half("decoder", decoder_plan(cfg), "up"),
            "conv1": conv("conv1"), "conv2": conv("conv2")}


@dataclasses.dataclass(frozen=True)
class Wan21VAE:
    """VAE params + the latent channel statistics (mean, 1/std)."""

    params: Any
    cfg: VAEConfig
    mean: torch.Tensor
    inv_std: torch.Tensor

    @staticmethod
    def create(params, cfg: VAEConfig) -> "Wan21VAE":
        dev = params["conv2"]["weight"].device
        return Wan21VAE(
            params=params, cfg=cfg,
            mean=torch.tensor(WAN21_LATENT_MEAN[: cfg.z_dim], device=dev),
            inv_std=torch.tensor(1.0 / WAN21_LATENT_STD[: cfg.z_dim], device=dev))

    def encode(self, videos: torch.Tensor) -> torch.Tensor:
        return vae_encode(self.params, self.cfg, videos, (self.mean, self.inv_std))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return vae_decode(self.params, self.cfg, z, (self.mean, self.inv_std))
