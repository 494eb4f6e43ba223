"""Unified x2x generation pipeline, T2V / V2V (port of
omnivideo_tpu/pipelines/x2x.py).

CFG runs as batch 2 in the order [cond, null], v = v_u + g·(v_c − v_u); the
mixed context is assembled and text-embedded once per expert segment; the
dual-expert boundary (t ≥ 0.875·T selects the high-noise expert) is a
static step split resolved on the host, kept even for single-expert models,
with a (low, high) guide-scale pair; FlowUniPC or FlowDPM (`sample_solver`
"unipc" / "dpm++") steps the latents. The text context comes from
`precomputed_context` or from the attached `text_encoder` (a callable
texts → [L, text_dim] tensors, e.g. models/t5.py once the umT5 tokenizer is
in the repo), which also encodes the negative prompt. `qk_impl` and
`ew_impl` pick the DiT's fused kernels as in JAX; `residual_dtype` None is
the f32 parity stream. The noise is drawn from an explicit torch.Generator,
or handed in as `noise` (the parity tests pass the JAX package's noise,
which torch cannot reproduce from a seed).

The experts and the VAE decode need not be resident together: an A14B run
calls `generate(decode=False)`, `free_experts()` (57 GB of bf16 experts),
then `decode(latents)`.

`sp` (models/wan_dit.py `SPConfig`) denoises sequence-parallel: every rank
of the mesh runs `generate` with the same inputs, the token count is
rounded up to a multiple of the SP size, each DiT forward keeps one token
shard per rank and gathers the velocity, and every rank steps the same
solver on the same latents. An unseeded SP run (no `noise`, no `generator`)
draws its seed on rank 0 and broadcasts it, so every rank draws the same
noise. The decode runs on every rank; callers use rank 0's result.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import PipelineConfig
from ..configs.prompts import SAMPLE_NEG_PROMPT_EN
from ..device import resolve_device
from ..models.unified import build_mixed_context, init_unified_companions, null_ar_vision
from ..models.vae2_1 import Wan21VAE, init_vae
from ..models.wan_dit import SPConfig, WanDiT
from ..schedulers.fm_dpm import FlowDPMSolver, get_sampling_sigmas
from ..schedulers.unipc import FlowUniPC

log = logging.getLogger(__name__)


def video_to_uint8_frames(video: torch.Tensor) -> torch.Tensor:
    """[C, T, H, W] f32 in [-1, 1] → [T, H, W, C] uint8 on the same device:
    clip → (x+1)·127.5 + 0.5 → truncating cast."""
    x = video.float().clamp(-1.0, 1.0)
    return ((x + 1.0) * 127.5 + 0.5).to(torch.uint8).permute(1, 2, 3, 0)


@dataclasses.dataclass
class ExpertParams:
    wan: WanDiT
    companions: Any  # vlm_norm / vlm_proj / visual_context_adapter (dict layout)


class OmniVideoX2XUnified:
    """Unified x2x pipeline. `low_noise` and `high_noise` may be the same
    object for single-expert models."""

    def __init__(
        self,
        config: PipelineConfig,
        low_noise: ExpertParams,
        high_noise: Optional[ExpertParams] = None,
        vae: Optional[Wan21VAE] = None,
        special_tokens: Optional[Dict[str, torch.Tensor]] = None,
        text_encoder: Optional[Callable[[List[str]], List[torch.Tensor]]] = None,
        qk_impl: str = "kernel",
        ew_impl: str = "unfused",
        residual_dtype: Optional[str] = None,
        sp: Optional[SPConfig] = None,
    ):
        self.config = config
        self.sp = sp
        self.low_noise = low_noise
        self.high_noise = high_noise or low_noise
        self.vae = vae
        self.special_tokens = special_tokens
        self.text_encoder = text_encoder
        self.qk_impl = qk_impl
        self.ew_impl = ew_impl
        # "bfloat16" stores the [B, L, dim] residual stream at bf16 (adds and
        # norms still compute f32); None/"float32" keeps the f32 parity stream
        self.residual_dtype = (None if residual_dtype in (None, "float32", "f32")
                               else getattr(torch, residual_dtype))
        self.device = low_noise.wan.patch_embedding.weight.device
        self.num_train_timesteps = config.num_train_timesteps
        self.boundary = config.boundary
        self.timings: Dict[str, float] = {}

    @classmethod
    def random_init(
        cls,
        config: PipelineConfig,
        seed: int = 0,
        with_vae: bool = True,
        device="cuda",
        **pipe_kwargs,
    ) -> "OmniVideoX2XUnified":
        """Random-weight pipeline from a seed (smoke tests, benchmarks)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dit_cfg = config.dit.replace(text_len=config.max_context_len)
        low = ExpertParams(
            wan=WanDiT(dit_cfg, dtype=config.torch_param_dtype, device=device, generator=gen),
            companions=init_unified_companions(config, device=device, generator=gen))
        high = low
        if config.dual_expert:
            high = ExpertParams(
                wan=WanDiT(dit_cfg, dtype=config.torch_param_dtype, device=device,
                           generator=gen),
                companions=low.companions)
        vae = None
        if with_vae:
            vae = Wan21VAE.create(init_vae(config.vae, device=device, generator=gen), config.vae)
        return cls(config, low, high, vae=vae, **pipe_kwargs)

    def _latent_shape(self, size, frame_num):
        vs = self.config.vae.vae_stride
        return (self.config.vae.z_dim, (frame_num - 1) // vs[0] + 1,
                size[1] // vs[1], size[0] // vs[2])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _encode_text(self, text: str) -> torch.Tensor:
        if self.text_encoder is None:
            raise ValueError("no text encoder attached; pass precomputed_context or attach "
                             "one (text_encoder=)")
        return self.text_encoder([text])[0]

    def _make_solver(self, sample_solver: str, sampling_steps: int, shift: float):
        if sample_solver == "unipc":
            return FlowUniPC.create(sampling_steps, shift=shift,
                                    num_train_timesteps=self.num_train_timesteps)
        if sample_solver == "dpm++":
            return FlowDPMSolver.create(sigmas=get_sampling_sigmas(sampling_steps, shift),
                                        num_train_timesteps=self.num_train_timesteps)
        raise NotImplementedError(f"unsupported solver {sample_solver}")

    def free_experts(self) -> None:
        """Drop both experts and return their memory to the device (the
        A14B order: denoise, free, decode)."""
        self.low_noise = self.high_noise = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.inference_mode()
    def generate(
        self,
        input_prompt: str = "",
        precomputed_context: Optional[torch.Tensor] = None,
        precomputed_context_null: Optional[torch.Tensor] = None,
        ar_vision_input: Optional[torch.Tensor] = None,
        visual_emb: Optional[torch.Tensor] = None,
        aligned_emb: Optional[torch.Tensor] = None,
        ref_images: Optional[torch.Tensor] = None,
        token_order: str = "v2",
        size: Tuple[int, int] = (1280, 720),
        frame_num: int = 81,
        shift: float = 5.0,
        sample_solver: str = "unipc",
        sampling_steps: int = 50,
        guide_scale=5.0,
        n_prompt: str = "",
        condition_mode: str = "auto",
        decode: bool = True,
        output_uint8: bool = False,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Generate a video. The text context is `precomputed_context`
        [L, text_dim], or `input_prompt` through the text encoder; the
        negative is `precomputed_context_null`, or `n_prompt` (default: the
        reference's negative prompt) through the text encoder, or zeros.
        Returns the decoded video [3, frame_num, H, W] f32 in [-1, 1], or
        [frame_num, H, W, 3] uint8 frames with output_uint8, or the latents
        [1, C, F, h, w] with decode=False. Stage wall times land in
        `self.timings` (seconds, synchronized)."""
        if self.low_noise is None:
            raise ValueError("the experts were freed (free_experts)")
        cfg = self.config
        dev = self.device
        target_shape = self._latent_shape(size, frame_num)
        _, ph, pw = cfg.dit.patch_size
        sp_size = self.sp.sp_size if self.sp is not None else 1
        seq_len = math.ceil(target_shape[2] * target_shape[3] / (ph * pw) * target_shape[1]
                            / sp_size) * sp_size
        solver = self._make_solver(sample_solver, sampling_steps, shift)

        ar_vision_input, visual_emb, aligned_emb, ref_images = (
            None if t is None else t.to(dev)
            for t in (ar_vision_input, visual_emb, aligned_emb, ref_images))
        context = (precomputed_context if precomputed_context is not None
                   else self._encode_text(input_prompt)).to(dev)
        if precomputed_context_null is not None:
            context_null = precomputed_context_null.to(dev)
        elif self.text_encoder is not None:
            context_null = self._encode_text(n_prompt or SAMPLE_NEG_PROMPT_EN).to(dev)
        else:
            log.warning("no negative context available; using zeros")
            context_null = torch.zeros(1, cfg.dit.text_dim, device=dev)
        ar_null = None
        if ar_vision_input is not None and condition_mode != "text_only":
            ar_null = null_ar_vision(ar_vision_input.shape[-1], device=dev)

        def mixed(ctx, arv, companions):
            return build_mixed_context(
                companions, cfg, context=ctx, ar_vision=arv, visual_emb=visual_emb,
                aligned_emb=aligned_emb, ref_images=ref_images,
                special_tokens=self.special_tokens,
                condition_mode="full" if condition_mode == "auto" else condition_mode,
                order=token_order).to(dev)

        if noise is None and generator is None and self.sp is not None:
            # every rank must draw the same noise: rank 0's seed, broadcast
            seed = torch.randint(0, 2**31 - 1, (1,), device=dev)
            dist.broadcast(seed, src=0)
            generator = torch.Generator(device=dev).manual_seed(int(seed.item()))
        if noise is None:
            noise = torch.randn((1,) + target_shape, generator=generator,
                                device=dev, dtype=torch.float32)
        elif tuple(noise.shape) != (1,) + target_shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != {(1,) + target_shape}")
        state = solver.init_state(noise.to(dev))

        boundary_t = self.boundary * self.num_train_timesteps
        n_high = int(np.sum(solver.timesteps >= boundary_t)) if cfg.dual_expert else 0
        S = len(solver)
        if isinstance(guide_scale, (tuple, list)):
            g_low, g_high = float(guide_scale[0]), float(guide_scale[1])
        else:
            g_low = g_high = float(guide_scale)
        segments = []
        if n_high > 0:
            segments.append((self.high_noise, 0, n_high, g_high))
        if n_high < S:
            segments.append((self.low_noise, n_high, S, g_low))

        self._sync()
        t_den = time.perf_counter()
        for expert, a, b, g in segments:
            dit = expert.wan
            pdtype = dit.param_dtype
            mixed2 = torch.stack([mixed(context, ar_vision_input, expert.companions),
                                  mixed(context_null, ar_null, expert.companions)])
            ctx_emb2 = dit.embed_context(mixed2.to(pdtype))
            for i in range(a, b):
                x2 = torch.cat([state.x, state.x]).to(pdtype)
                t2 = torch.full((2,), float(solver.coeffs["timestep"][i]), device=dev)
                v2 = dit(x2, t2, ctx_emb2, seq_len=seq_len, context_embedded=True,
                         residual_dtype=self.residual_dtype, qk_impl=self.qk_impl,
                         ew_impl=self.ew_impl, sp=self.sp)
                v = v2[1:] + g * (v2[0:1] - v2[1:])
                state = solver.step(state, v, i)
            if not bool(torch.isfinite(state.x).all()):
                raise FloatingPointError(f"non-finite latents after denoise steps [{a}:{b})")
        self._sync()
        self.timings["denoise_s"] = time.perf_counter() - t_den
        self.timings["denoise_step_s"] = self.timings["denoise_s"] / max(1, S)

        latents = state.x
        if not decode:
            return latents
        return self.decode(latents, output_uint8)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor, output_uint8: bool = False) -> torch.Tensor:
        """VAE-decode [1, C, F, h, w] latents → [3, T, H, W] f32 in [-1, 1],
        or [T, H, W, 3] uint8 frames; its wall time lands in
        `timings["decode_s"]`."""
        if self.vae is None:
            raise ValueError("no VAE attached")
        self._sync()
        t_dec = time.perf_counter()
        video = self.vae.decode(latents.to(self.device))[0]
        if not bool(torch.isfinite(video).all()):
            raise FloatingPointError("non-finite video from the VAE decode")
        out = video_to_uint8_frames(video) if output_uint8 else video
        self._sync()
        self.timings["decode_s"] = time.perf_counter() - t_dec
        return out
