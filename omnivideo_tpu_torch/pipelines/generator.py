"""High-level multi-task generator, the v1 API surface (port of
omnivideo_tpu/pipelines/generator.py; the reference's
`OmniVideoGenerator` of `previous_version/Omni-Video1/nets/omni/
omni_video_generator.py`).

One object over a checkpoint bundle: the x2x pipeline of
pipelines/loading.py `load_pipeline` (the experts, the VAE, umT5 with its
tokenizer, the special tokens), the v1 special-token location, an optional
unconditioned context and an optional Qwen3-VL engine (captions and
features), with the task methods `text_to_video`, `text_to_image` and
`video_to_video`. Layout (the v1 one, a superset of the flat v2 layout):

    omni_ckpts/
      low_noise_model/...  (high_noise_model/...)   # DiT expert(s)
      special_tokens/tokens.pkl  or  special_tokens.pkl
      unconditioned_context/context.pkl  or  unconditioned_context.pkl
      ar_model/...                                  # Qwen3-VL HF dir (optional)
      models_t5_umt5-xxl-enc-bf16.pth, Wan2.1_VAE.pth, google/umt5-xxl/

The pickles are read with `torch.load(map_location="cpu",
weights_only=True)`. A task method's `seed` becomes the torch.Generator
of the noise on the pipeline's device; other keywords go to `generate`.
Everything runs on `device` (default cuda).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import torch

from ..configs import WAN_CONFIGS
from ..configs.base import PipelineConfig
from ..device import resolve_device

log = logging.getLogger(__name__)


class OmniVideoGenerator:
    def __init__(
        self,
        models_dir: str,
        task: str = "t2v-1.3B",
        config: Optional[PipelineConfig] = None,
        vlm_backend: str = "jax",
        device="cuda",
    ):
        from ..models.unified import load_special_tokens_pkl
        from .loading import load_pipeline

        self.device = resolve_device(device)
        self.models_dir = Path(models_dir)
        self.config = config or WAN_CONFIGS[task]
        self.pipe = load_pipeline(self.config, str(self.models_dir), device=self.device)

        # the v1 nested special-token location
        if self.pipe.special_tokens is None:
            alt = self.models_dir / "special_tokens" / "tokens.pkl"
            if alt.exists():
                self.pipe.special_tokens = load_special_tokens_pkl(str(alt), self.device)

        self.unconditioned_context = None
        for cand in (self.models_dir / "unconditioned_context" / "context.pkl",
                     self.models_dir / "unconditioned_context.pkl"):
            if cand.exists():
                obj = torch.load(cand, map_location="cpu", weights_only=True)
                if isinstance(obj, dict) and "uncond_context" in obj:
                    obj = obj["uncond_context"]
                self.unconditioned_context = torch.as_tensor(obj).float().to(self.device)
                break

        self.vlm = None
        ar_dir = self.models_dir / "ar_model"
        if ar_dir.exists():
            from ..models.qwen3vl.engine import Qwen3VLEngine, VLMConfig

            try:
                self.vlm = Qwen3VLEngine(VLMConfig(model_path=str(ar_dir), backend=vlm_backend,
                                                   device=str(self.device)))
            except (OSError, RuntimeError, ValueError, KeyError, ImportError) as e:
                log.warning("AR model unavailable (%s); text-only conditioning", e)

    def _generate(self, seed: Optional[int] = None, **kw):
        if seed is not None and seed >= 0:
            kw["generator"] = torch.Generator(device=self.pipe.device).manual_seed(int(seed))
        return self.pipe.generate(**kw)

    # -- task methods ---------------------------------------------------------

    def text_to_video(self, prompt: str, **kw):
        ar = None
        if self.vlm is not None:
            feats = self.vlm.generate_caption_and_extract_features(None, prompt)
            prompt = (feats["target_caption"] + " " + prompt).strip()
            ar = feats["vlm_last_hidden_states"]
        return self._generate(input_prompt=prompt, ar_vision_input=ar, **kw)

    def text_to_image(self, prompt: str, **kw):
        kw.setdefault("frame_num", 1)
        return self.text_to_video(prompt, **kw)

    def video_to_video(self, source_clip_path: str, edit_prompt: str, size=(832, 480),
                       frame_num: int = 41, **kw):
        from ..utils.video import read_video_frames, sample_and_transform_frames

        frames, fps = read_video_frames(source_clip_path)
        clip = sample_and_transform_frames(frames, frame_num, size, fps, self.config.sample_fps,
                                           device=self.pipe.device)
        with torch.inference_mode():
            visual_emb = self.pipe.vae.encode(clip[None])[0]
        lat_f = (frame_num - 1) // self.config.vae.vae_stride[0] + 1
        visual_emb = visual_emb[:, :lat_f]

        ar = None
        prompt = edit_prompt
        if self.vlm is not None:
            feats = self.vlm.generate_caption_and_extract_features(source_clip_path,
                                                                   edit_prompt)
            prompt = (feats["target_caption"] + " " + edit_prompt).strip()
            ar = feats["vlm_last_hidden_states"]
        return self._generate(input_prompt=prompt, ar_vision_input=ar, visual_emb=visual_emb,
                              size=size, frame_num=frame_num, **kw)
