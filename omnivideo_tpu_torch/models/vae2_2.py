"""Wan2.2 causal 3D VAE, z_dim 48, encode and decode (port of
omnivideo_tpu/models/vae2_2.py).

The pixels are patchified 2×2 onto the channels before the encoder and
unpatchified after the decoder; the encoder (width `dim`) and the decoder
(width `dec_dim`) are residual down / up stages whose shortcuts are the
parameter-free AvgDown3D (front-padded temporal and spatial average pooling
over channel groups) and DupUp3D (channel → space duplication, whose first
chunk drops its leading duplicated frames); the latents are normalized with
the 48-channel statistics.

Built on models/vae2_1.py's primitives (`causal_conv3d`, `vae_rms_norm`,
`res_block`, `attention_block`, and its `downsample` / `upsample`, whose
convolutions take their channel counts from the weights: the 2.2 upsample
keeps the channel count). Streaming as in the 2.1 port: the encoder takes
the first frame, then 4 frames a chunk, the decoder one latent frame a
step, each causal conv carrying its last k_t−1 input frames (None: zeros);
the shortcuts carry nothing. Runs eagerly under inference mode with cuDNN's
TF32 off, like the 2.1 port. Parameters keep the JAX dict layout
(`vae22_state_dict_to_params` maps a reference state dict; OIDHW weights
are already PyTorch's layout); `vae22_reference_shapes` lists that state
dict's names and shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .vae2_1 import attention_block, causal_conv3d, downsample, res_block, upsample, vae_rms_norm

# 48-channel latent statistics
WAN22_LATENT_MEAN = np.array([
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
], dtype=np.float32)
WAN22_LATENT_STD = np.array([
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class VAE22Config:
    dim: int = 160  # encoder width
    dec_dim: int = 256  # decoder width
    z_dim: int = 48
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    patch_size: int = 2
    # temporal 4×, spatial 16× (the 2×2 patchify and three 2× down stages)
    vae_stride: Tuple[int, int, int] = (4, 16, 16)

    @property
    def temperal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))


def patchify_pixels(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, F, H, W] → [B, C·p·p, F, H/p, W/p] ('b c f (h q) (w r) -> b
    (c r q) f h w')."""
    if p == 1:
        return x
    B, C, Fr, H, W = x.shape
    x = x.reshape(B, C, Fr, H // p, p, W // p, p).permute(0, 1, 6, 4, 2, 3, 5)
    return x.reshape(B, C * p * p, Fr, H // p, W // p)


def unpatchify_pixels(x: torch.Tensor, p: int) -> torch.Tensor:
    """The inverse of `patchify_pixels`."""
    if p == 1:
        return x
    B, CP, Fr, H, W = x.shape
    x = x.reshape(B, CP // (p * p), p, p, Fr, H, W).permute(0, 1, 4, 5, 3, 6, 2)
    return x.reshape(B, CP // (p * p), Fr, H * p, W * p)


def avg_down3d(x: torch.Tensor, out_channels: int, factor_t: int, factor_s: int) -> torch.Tensor:
    """Front-padded (zeros) temporal and spatial average pooling, the
    (c, t, h, w) blocks grouped onto `out_channels`."""
    pad_t = (-x.shape[2]) % factor_t
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
    B, C, T, H, W = x.shape
    ft, fs = factor_t, factor_s
    x = x.reshape(B, C, T // ft, ft, H // fs, fs, W // fs, fs).permute(0, 1, 3, 5, 7, 2, 4, 6)
    x = x.reshape(B, out_channels, C * ft * fs * fs // out_channels, T // ft, H // fs, W // fs)
    return x.mean(dim=2)


def dup_up3d(x: torch.Tensor, out_channels: int, factor_t: int, factor_s: int,
             first_chunk: bool) -> torch.Tensor:
    """repeat_interleave channel → (t, h, w) duplication; the first chunk
    drops its first factor_t − 1 frames."""
    B, C, T, H, W = x.shape
    x = x.repeat_interleave(out_channels * factor_t * factor_s * factor_s // C, dim=1)
    x = x.reshape(B, out_channels, factor_t, factor_s, factor_s, T, H, W)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(B, out_channels, T * factor_t, H * factor_s, W * factor_s)
    return x[:, :, factor_t - 1:] if first_chunk else x


def _resample22(p, x, cache, kind: str, first: bool):
    """The 2.2 resample: the 2.1 port's down/up steps (the up conv keeps the
    channel count, as its weights say)."""
    if kind.startswith("down"):
        return downsample(p, x, cache, kind, first)
    return upsample(p, x, cache, kind, first)


def _enc_levels(cfg: VAE22Config) -> List[Tuple[int, int, bool, bool]]:
    """(in, out, temporal down, down) per encoder stage."""
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    return [(din, dout, bool(cfg.temperal_downsample[i]) if i < len(cfg.temperal_downsample)
             else False, i != len(cfg.dim_mult) - 1)
            for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:]))]


def _dec_levels(cfg: VAE22Config) -> List[Tuple[int, int, bool, bool]]:
    """(in, out, temporal up, up) per decoder stage."""
    mult = tuple(cfg.dim_mult)
    dims = [cfg.dec_dim * u for u in (mult[-1],) + tuple(reversed(mult))]
    ups = cfg.temperal_upsample
    return [(din, dout, bool(ups[i]) if i < len(ups) else False, i != len(mult) - 1)
            for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:]))]


def _down_block(p, cfg, x, cache, t_down: bool, down: bool, first: bool):
    """Down_ResidualBlock: cached residual blocks and resample + the
    stateless AvgDown3D shortcut of the block's input."""
    cache = cache or [None] * (cfg.num_res_blocks + 1)
    new = []
    h = x
    for j in range(cfg.num_res_blocks):
        h, c = res_block(p["res"][j], h, cache[j])
        new.append(c)
    if down:
        h, c = _resample22(p["resample"], h, cache[cfg.num_res_blocks],
                           "down3d" if t_down else "down2d", first)
        new.append(c)
    sc = avg_down3d(x, h.shape[1], 2 if t_down else 1, 2 if down else 1)
    return h + sc, new


def _up_block(p, cfg, x, cache, t_up: bool, up: bool, first: bool):
    """Up_ResidualBlock: cached residual blocks and resample + the
    DupUp3D shortcut of the block's input (only where it upsamples)."""
    cache = cache or [None] * (cfg.num_res_blocks + 2)
    new = []
    h = x
    for j in range(cfg.num_res_blocks + 1):
        h, c = res_block(p["res"][j], h, cache[j])
        new.append(c)
    if up:
        h, c = _resample22(p["resample"], h, cache[cfg.num_res_blocks + 1],
                           "up3d" if t_up else "up2d", first)
        new.append(c)
        h = h + dup_up3d(x, h.shape[1], 2 if t_up else 1, 2, first_chunk=first)
    return h, new


def encoder_chunk22(params, cfg: VAE22Config, x, cache: Dict[str, Any], first: bool):
    """One streaming encoder step over a 1- or 4-frame patchified chunk →
    (2·z_dim channels of one latent frame, cache)."""
    enc = params["encoder"]
    new: Dict[str, Any] = {}
    x, new["conv1"] = causal_conv3d(enc["conv1"], x, cache.get("conv1"))
    for i, (_, _, t_down, down) in enumerate(_enc_levels(cfg)):
        x, new[f"d{i}"] = _down_block(enc["down"][f"d{i}"], cfg, x, cache.get(f"d{i}"),
                                      t_down, down, first)
    x, new["mid0"] = res_block(enc["mid0"], x, cache.get("mid0"))
    x = attention_block(enc["mid_attn"], x)
    x, new["mid1"] = res_block(enc["mid1"], x, cache.get("mid1"))
    y = F.silu(vae_rms_norm(x, enc["head"]["norm"]))
    y, new["head"] = causal_conv3d(enc["head"]["conv"], y, cache.get("head"))
    return y, new


def decoder_chunk22(params, cfg: VAE22Config, z, cache: Dict[str, Any], first: bool):
    """One streaming decoder step over a single latent frame → (patchified
    frames, cache)."""
    dec = params["decoder"]
    new: Dict[str, Any] = {}
    x, new["conv1"] = causal_conv3d(dec["conv1"], z, cache.get("conv1"))
    x, new["mid0"] = res_block(dec["mid0"], x, cache.get("mid0"))
    x = attention_block(dec["mid_attn"], x)
    x, new["mid1"] = res_block(dec["mid1"], x, cache.get("mid1"))
    for i, (_, _, t_up, up) in enumerate(_dec_levels(cfg)):
        x, new[f"u{i}"] = _up_block(dec["up"][f"u{i}"], cfg, x, cache.get(f"u{i}"), t_up, up,
                                    first)
    y = F.silu(vae_rms_norm(x, dec["head"]["norm"]))
    y, new["head"] = causal_conv3d(dec["head"]["conv"], y, cache.get("head"))
    return y, new


def _no_tf32():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                      allow_tf32=False)


@torch.inference_mode()
def vae22_encode(params, cfg: VAE22Config, videos: torch.Tensor, scale=None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Video [B, 3, T, H, W] in [-1, 1], T = 1+4k → the latent mean
    [B, z, 1+k, H/16, W/16] f32, normalized with (mean, 1/std) `scale`; the
    convolutions run in `dtype`."""
    with _no_tf32():
        x = patchify_pixels(videos.to(dtype), cfg.patch_size)
        T = x.shape[2]
        if (T - 1) % 4:
            raise ValueError(f"vae22_encode: frame count {T} is not 4n+1")
        cache: Dict[str, Any] = {}
        zs = []
        for i, a in enumerate([0] + list(range(1, T, 4))):
            z, cache = encoder_chunk22(params, cfg, x[:, :, a:a + (1 if i == 0 else 4)], cache,
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
def vae22_decode(params, cfg: VAE22Config, z: torch.Tensor, scale=None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Latents [B, z, t, h, w] → video [B, 3, 1+4(t−1), 16h, 16w] f32
    clamped to [-1, 1]. z is rounded to `dtype`, then un-normalized by the
    f32 `scale` (which promotes it to f32, in torch as in JAX)."""
    with _no_tf32():
        z = z.to(dtype)
        if scale is not None:
            mean, inv_std = scale
            z = z / inv_std.reshape(1, -1, 1, 1, 1) + mean.reshape(1, -1, 1, 1, 1)
        x, _ = causal_conv3d(params["conv2"], z, None)
        cache: Dict[str, Any] = {}
        ys = []
        for i in range(x.shape[2]):
            y, cache = decoder_chunk22(params, cfg, x[:, :, i:i + 1], cache, first=i == 0)
            ys.append(y.float())
        del cache
        out = unpatchify_pixels(torch.cat(ys, dim=2), cfg.patch_size)
        return out.clamp(-1.0, 1.0)


def vae22_reference_shapes(cfg: VAE22Config) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of a reference Wan2.2 VAE state dict of `cfg`, the
    names `vae22_state_dict_to_params` reads (seeded smoke runs draw one)."""
    sh: Dict[str, Tuple[int, ...]] = {}
    c_in = 3 * cfg.patch_size**2

    def conv(name, cin, cout, k):
        sh[f"{name}.weight"] = (cout, cin) + k
        sh[f"{name}.bias"] = (cout,)

    def res(name, din, dout):
        sh[f"{name}.residual.0.gamma"] = (din, 1, 1, 1)
        conv(f"{name}.residual.2", din, dout, (3, 3, 3))
        sh[f"{name}.residual.3.gamma"] = (dout, 1, 1, 1)
        conv(f"{name}.residual.6", dout, dout, (3, 3, 3))
        if din != dout:
            conv(f"{name}.shortcut", din, dout, (1, 1, 1))

    def attn(name, d):
        sh[f"{name}.norm.gamma"] = (d, 1, 1)
        conv(f"{name}.to_qkv", d, 3 * d, (1, 1))
        conv(f"{name}.proj", d, d, (1, 1))

    def middle(half, d):
        res(f"{half}.middle.0", d, d)
        attn(f"{half}.middle.1", d)
        res(f"{half}.middle.2", d, d)

    levels = _enc_levels(cfg)
    conv("encoder.conv1", c_in, cfg.dim, (3, 3, 3))
    for i, (din, dout, t_down, down) in enumerate(levels):
        pref = f"encoder.downsamples.{i}.downsamples"
        for j in range(cfg.num_res_blocks):
            res(f"{pref}.{j}", din if j == 0 else dout, dout)
        if down:
            conv(f"{pref}.{cfg.num_res_blocks}.resample.1", dout, dout, (3, 3))
            if t_down:
                conv(f"{pref}.{cfg.num_res_blocks}.time_conv", dout, dout, (3, 1, 1))
    d_enc = levels[-1][1]
    middle("encoder", d_enc)
    sh["encoder.head.0.gamma"] = (d_enc, 1, 1, 1)
    conv("encoder.head.2", d_enc, 2 * cfg.z_dim, (3, 3, 3))
    conv("conv1", 2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1))
    conv("conv2", cfg.z_dim, cfg.z_dim, (1, 1, 1))
    dlev = _dec_levels(cfg)
    conv("decoder.conv1", cfg.z_dim, dlev[0][0], (3, 3, 3))
    middle("decoder", dlev[0][0])
    for i, (din, dout, t_up, up) in enumerate(dlev):
        pref = f"decoder.upsamples.{i}.upsamples"
        for j in range(cfg.num_res_blocks + 1):
            res(f"{pref}.{j}", din if j == 0 else dout, dout)
        if up:
            conv(f"{pref}.{cfg.num_res_blocks + 1}.resample.1", dout, dout, (3, 3))
            if t_up:
                conv(f"{pref}.{cfg.num_res_blocks + 1}.time_conv", dout, 2 * dout, (3, 1, 1))
    sh["decoder.head.0.gamma"] = (dlev[-1][1], 1, 1, 1)
    conv("decoder.head.2", dlev[-1][1], c_in, (3, 3, 3))
    return sh


def vae22_state_dict_to_params(sd, cfg: VAE22Config, device="cuda") -> Dict[str, Any]:
    """A reference Wan2.2 VAE state dict (tensors or numpy arrays) → the
    encoder and decoder params in the JAX dict layout, f32 tensors on
    `device` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)

    def g(k):
        v = sd[k]
        return (v.detach() if torch.is_tensor(v)
                else torch.from_numpy(np.array(v, np.float32))).float().to(device)

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

    def resample(prefix, has_time):
        c = conv(f"{prefix}.resample.1")
        p = {"conv_w": c["weight"], "conv_b": c["bias"]}
        if has_time:
            t = conv(f"{prefix}.time_conv")
            p["time_w"], p["time_b"] = t["weight"], t["bias"]
        return p

    def half(name):
        return {"conv1": conv(f"{name}.conv1"), "mid0": res(f"{name}.middle.0", False),
                "mid_attn": attn(f"{name}.middle.1"), "mid1": res(f"{name}.middle.2", False),
                "head": {"norm": g(f"{name}.head.0.gamma").reshape(-1),
                         "conv": conv(f"{name}.head.2")}}

    enc, dec = half("encoder"), half("decoder")
    enc["down"], dec["up"] = {}, {}
    for i, (din, dout, t_down, down) in enumerate(_enc_levels(cfg)):
        pref = f"encoder.downsamples.{i}.downsamples"
        blk: Dict[str, Any] = {"res": [res(f"{pref}.{j}", j == 0 and din != dout)
                                       for j in range(cfg.num_res_blocks)]}
        if down:
            blk["resample"] = resample(f"{pref}.{cfg.num_res_blocks}", t_down)
        enc["down"][f"d{i}"] = blk
    for i, (din, dout, t_up, up) in enumerate(_dec_levels(cfg)):
        pref = f"decoder.upsamples.{i}.upsamples"
        blk = {"res": [res(f"{pref}.{j}", j == 0 and din != dout)
                       for j in range(cfg.num_res_blocks + 1)]}
        if up:
            blk["resample"] = resample(f"{pref}.{cfg.num_res_blocks + 1}", t_up)
        dec["up"][f"u{i}"] = blk
    return {"encoder": enc, "decoder": dec, "conv1": conv("conv1"), "conv2": conv("conv2")}


@dataclasses.dataclass(frozen=True)
class Wan22VAE:
    """VAE 2.2 params + the 48-channel statistics (mean, 1/std)."""

    params: Any
    cfg: VAE22Config
    mean: torch.Tensor
    inv_std: torch.Tensor

    @staticmethod
    def create(params, cfg: VAE22Config) -> "Wan22VAE":
        dev = params["conv2"]["weight"].device
        return Wan22VAE(params=params, cfg=cfg,
                        mean=torch.tensor(WAN22_LATENT_MEAN[: cfg.z_dim], device=dev),
                        inv_std=torch.tensor(1.0 / WAN22_LATENT_STD[: cfg.z_dim], device=dev))

    def encode(self, videos: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return vae22_encode(self.params, self.cfg, videos, (self.mean, self.inv_std), dtype)

    def decode(self, z: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return vae22_decode(self.params, self.cfg, z, (self.mean, self.inv_std), dtype)
