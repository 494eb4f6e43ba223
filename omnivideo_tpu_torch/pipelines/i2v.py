"""Image-to-video pipeline, vanilla Wan i2v (port of
omnivideo_tpu/pipelines/i2v.py).

The first frame gives two conditions: its CLIP tokens (the tower's
penultimate block, `models/clip_vision.py`), which the i2v DiT projects and
prepends to the text context, and `y = [mask; latents]`: the frame resized
to the output size with 80 zero frames after it, encoded by the Wan2.1 VAE,
beside a mask that is 1 on the first frame (repeated 4× and grouped to the
latent frames). The DiT takes y on its input channels. CFG runs as batch 2
in the order [cond, null], v = v_u + g·(v_c − v_u), and FlowUniPC steps the
latents; the VAE decodes them.

Both resizes (CLIP's 224 px and the first frame's output size) run on the
card by utils/video.py's two-pass antialiased bicubic, where JAX calls
Pillow's BICUBIC (within one uint8 level of it; ROADMAP §3). The noise is
drawn from an explicit torch.Generator (seeded from `seed`), or handed in
as `noise`: the parity tests pass the JAX package's draw, which torch cannot
reproduce. `qk_impl`, `ew_impl` and `residual_dtype` choose the DiT's fused
kernels as in the x2x pipeline. There is no sequence parallelism, as JAX's
i2v has none. Stage wall times land in `timings` (seconds, synchronized):
clip_s, vae_encode_s, denoise_s, denoise_step_s, step_s (each step's,
utils/observability.py `StepTimes`), decode_s.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import PipelineConfig
from ..configs.prompts import SAMPLE_NEG_PROMPT_EN
from ..models.clip_vision import (
    CLIPVision,
    CLIPVisionConfig,
    clip_vision_forward,
    preprocess_image,
    uint8_frame,
)
from ..models.vae2_1 import Wan21VAE
from ..models.wan_dit import WanDiT
from ..schedulers.unipc import FlowUniPC
from ..utils.observability import StepTimes
from ..utils.video import resize_frames
from .x2x import video_to_uint8_frames


def build_i2v_mask(frame_num: int, lat_h: int, lat_w: int, device=None) -> torch.Tensor:
    """The first-frame mask [4, F_lat, h, w]: 1 on frame 0 (repeated 4×),
    0 after it, grouped 4 frames to a latent frame."""
    msk = torch.zeros(1, frame_num, lat_h, lat_w, device=device)
    msk[:, 0] = 1.0
    msk = torch.cat([msk[:, :1].repeat(1, 4, 1, 1), msk[:, 1:]], dim=1)
    msk = msk.view(1, msk.shape[1] // 4, 4, lat_h, lat_w)
    return msk.transpose(1, 2)[0]


class WanI2V:
    """Single-expert i2v pipeline over an i2v WanDiT (`cfg.model_type ==
    "i2v"`), its Wan2.1 VAE and the CLIP vision tower."""

    def __init__(
        self,
        config: PipelineConfig,
        wan: WanDiT,
        vae: Wan21VAE,
        clip: CLIPVision,
        clip_cfg: CLIPVisionConfig = CLIPVisionConfig(),
        text_encoder: Optional[Callable[[List[str]], List[torch.Tensor]]] = None,
        qk_impl: str = "kernel",
        ew_impl: str = "unfused",
        residual_dtype: Optional[str] = None,
    ):
        if wan.cfg.model_type != "i2v":
            raise ValueError(f"WanI2V needs an i2v DiT, got model_type {wan.cfg.model_type!r}")
        self.config = config
        self.wan = wan
        self.vae = vae
        self.clip = clip
        self.clip_cfg = clip_cfg
        self.text_encoder = text_encoder
        self.qk_impl = qk_impl
        self.ew_impl = ew_impl
        self.residual_dtype = (None if residual_dtype in (None, "float32", "f32")
                               else getattr(torch, residual_dtype))
        self.device = wan.patch_embedding.weight.device
        self.timings: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free_model(self) -> None:
        """Drop the DiT and the CLIP tower and return their memory to the
        device (denoise, free, decode: the VAE decode need not share the
        card with 16.4B parameters)."""
        self.wan = self.clip = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def generate(
        self,
        img,
        input_prompt: str = "",
        precomputed_context: Optional[torch.Tensor] = None,
        precomputed_context_null: Optional[torch.Tensor] = None,
        size: Tuple[int, int] = (832, 480),
        frame_num: int = 81,
        shift: float = 5.0,
        sampling_steps: int = 40,
        guide_scale: float = 5.0,
        seed: int = -1,
        decode: bool = True,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        output_uint8: bool = False,
    ):
        """img: [H, W, 3] first frame (uint8, or float in [-1, 1]); size:
        (width, height). Returns the video [3, frame_num, H, W] f32 in
        [-1, 1], [frame_num, H, W, 3] uint8 frames with output_uint8, or the
        latents [1, z, F_lat, h, w] with decode=False. The text context is
        `precomputed_context` [L, text_dim] or `input_prompt` through the
        text encoder; the negative is `precomputed_context_null`, else the
        reference's negative prompt through the encoder, else zeros."""
        if self.wan is None:
            raise ValueError("the model was freed (free_model)")
        cfg, dev, dit_cfg = self.config, self.device, self.wan.cfg
        vs = cfg.vae.vae_stride
        lat_f = (frame_num - 1) // vs[0] + 1
        lat_h, lat_w = size[1] // vs[1], size[0] // vs[2]
        _, ph, pw = dit_cfg.patch_size
        seq_len = math.ceil(lat_h * lat_w / (ph * pw) * lat_f)
        pdtype = self.wan.param_dtype
        frame = uint8_frame(img, dev)

        # CLIP tokens of the first frame
        self._sync()
        t0 = time.perf_counter()
        clip_in = preprocess_image(frame, self.clip_cfg.image_size, device=dev)
        clip_fea = clip_vision_forward(self.clip, self.clip_cfg, clip_in)
        self._sync()
        self.timings["clip_s"] = time.perf_counter() - t0

        # y = [mask; VAE([first frame, 80 zero frames])]
        t0 = time.perf_counter()
        first = resize_frames(frame[None], (size[1], size[0]))[0].float() / 127.5 - 1.0
        video = torch.zeros(1, 3, frame_num, size[1], size[0], device=dev)
        video[0, :, 0] = first.permute(2, 0, 1)
        y_lat = self.vae.encode(video)[0][:, :lat_f]
        del video
        y = torch.cat([build_i2v_mask(frame_num, lat_h, lat_w, dev), y_lat])[None]
        self._sync()
        self.timings["vae_encode_s"] = time.perf_counter() - t0

        if precomputed_context is not None:
            context = precomputed_context.to(dev)
        elif self.text_encoder is not None:
            context = self.text_encoder([input_prompt])[0].to(dev)
        else:
            raise ValueError("no text encoder attached; pass precomputed_context")
        if precomputed_context_null is not None:
            context_null = precomputed_context_null.to(dev)
        elif self.text_encoder is not None:
            context_null = self.text_encoder([SAMPLE_NEG_PROMPT_EN])[0].to(dev)
        else:
            context_null = torch.zeros(1, dit_cfg.text_dim, device=dev)

        def pad_ctx(c: torch.Tensor) -> torch.Tensor:
            n = dit_cfg.text_len
            return torch.nn.functional.pad(c, (0, 0, 0, max(0, n - c.shape[0])))[:n]

        ctx2 = torch.stack([pad_ctx(context), pad_ctx(context_null)])
        solver = FlowUniPC.create(sampling_steps, shift=shift,
                                  num_train_timesteps=cfg.num_train_timesteps)
        shape = (1, cfg.vae.z_dim, lat_f, lat_h, lat_w)
        if noise is None:
            if generator is None:
                seed = seed if seed >= 0 else int(np.random.randint(0, 2**31 - 1))
                generator = torch.Generator(device=dev).manual_seed(seed)
            noise = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
        state = solver.init_state(noise.to(dev))

        self._sync()
        clock = StepTimes(dev)
        ctx_emb2 = self.wan.embed_context(ctx2.to(pdtype))
        y2 = torch.cat([y, y]).to(pdtype)
        clip2 = torch.cat([clip_fea, clip_fea]).to(pdtype)
        for i in range(len(solver)):
            x2 = torch.cat([state.x, state.x]).to(pdtype)
            t2 = torch.full((2,), float(solver.coeffs["timestep"][i]), device=dev)
            v2 = self.wan(x2, t2, ctx_emb2, seq_len=seq_len, context_embedded=True,
                          residual_dtype=self.residual_dtype, qk_impl=self.qk_impl,
                          ew_impl=self.ew_impl, y=y2, clip_fea=clip2)
            v = v2[1:] + guide_scale * (v2[0:1] - v2[1:])
            state = solver.step(state, v, i)
            clock.lap()
        if not bool(torch.isfinite(state.x).all()):
            raise FloatingPointError("non-finite latents after the denoise steps")
        self.timings.update(clock.timings())
        if not decode:
            return state.x
        return self.decode(state.x, output_uint8)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor, output_uint8: bool = False) -> torch.Tensor:
        """VAE-decode [1, z, F, h, w] latents → [3, T, H, W] f32 in [-1, 1],
        or [T, H, W, 3] uint8 frames; its wall time lands in
        `timings["decode_s"]`."""
        self._sync()
        t0 = time.perf_counter()
        video = self.vae.decode(latents.to(self.device))[0]
        if not bool(torch.isfinite(video).all()):
            raise FloatingPointError("non-finite video from the VAE decode")
        out = video_to_uint8_frames(video) if output_uint8 else video
        self._sync()
        self.timings["decode_s"] = time.perf_counter() - t0
        return out
