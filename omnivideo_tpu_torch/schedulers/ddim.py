"""Enhanced DDIM scheduler with an optional zero-terminal-SNR rescale (port
of omnivideo_tpu/schedulers/ddim.py; the reference's
`omnivideo/modules/schedulers/ddim.py` EnhancedDDIMScheduler).

Scaled-linear (or linear) betas built in f64 and rounded to f32 tables,
timesteps aligned to 999…0, epsilon / v-prediction denoise weights
computed in f32 on the sample's device. Stateless: `set_timesteps`
returns a new scheduler. No x2x caller uses it (the pipeline takes UniPC
and DPM++, as JAX's)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EnhancedDDIMScheduler:
    alphas_cumprod: torch.Tensor  # [T] f32
    timesteps: torch.Tensor  # [S] f32
    num_train_timesteps: int
    prediction_type: str = "epsilon"

    @staticmethod
    def create(
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "epsilon",
        rescale_zero_terminal_snr: bool = False,
        num_inference_steps: int = 10,
        denoising_strength: float = 1.0,
    ) -> "EnhancedDDIMScheduler":
        if beta_schedule == "scaled_linear":
            betas = np.square(
                np.linspace(np.sqrt(beta_start), np.sqrt(beta_end), num_train_timesteps))
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps)
        else:
            raise NotImplementedError(beta_schedule)
        acp = np.cumprod(1.0 - betas)
        if rescale_zero_terminal_snr:
            # shift and scale sqrt(ᾱ) so the terminal SNR is zero
            s = np.sqrt(acp)
            s0, sT = s[0], s[-1]
            s = (s - sT) * (s0 / (s0 - sT))
            acp = np.square(s)
        ts = _timesteps(num_train_timesteps, num_inference_steps, denoising_strength)
        return EnhancedDDIMScheduler(
            alphas_cumprod=torch.tensor(acp, dtype=torch.float32),
            timesteps=torch.tensor(ts, dtype=torch.float32),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
        )

    def set_timesteps(self, num_inference_steps, denoising_strength=1.0):
        ts = _timesteps(self.num_train_timesteps, num_inference_steps, denoising_strength)
        return dataclasses.replace(self, timesteps=torch.tensor(ts, dtype=torch.float32))

    def _acp(self, timestep, like: torch.Tensor) -> torch.Tensor:
        return self.alphas_cumprod[int(float(timestep))].to(like.device)

    def _denoise(self, model_output, sample, a_t, a_prev):
        if self.prediction_type == "epsilon":
            w_e = torch.sqrt(1 - a_prev) - torch.sqrt(a_prev * (1 - a_t) / a_t)
            w_x = torch.sqrt(a_prev / a_t)
        elif self.prediction_type == "v_prediction":
            w_e = -torch.sqrt(a_prev * (1 - a_t)) + torch.sqrt(a_t * (1 - a_prev))
            w_x = torch.sqrt(a_t * a_prev) + torch.sqrt((1 - a_t) * (1 - a_prev))
        else:
            raise NotImplementedError(self.prediction_type)
        return sample * w_x + model_output * w_e

    def step(self, model_output, timestep, sample, to_final: bool = False):
        t = float(timestep)
        a_t = self._acp(t, sample)
        tid = int(torch.argmin((self.timesteps - t).abs()))
        S = self.timesteps.shape[0]
        if to_final or tid + 1 >= S:
            a_prev = torch.ones((), dtype=torch.float32, device=sample.device)
        else:
            a_prev = self._acp(self.timesteps[tid + 1], sample)
        return self._denoise(model_output, sample, a_t, a_prev)

    def return_to_timestep(self, timestep, sample, sample_stabilized):
        a_t = self._acp(timestep, sample)
        return (sample - torch.sqrt(a_t) * sample_stabilized) / torch.sqrt(1 - a_t)

    def add_noise(self, original_samples, noise, timestep):
        a_t = self._acp(timestep, original_samples)
        return torch.sqrt(a_t) * original_samples + torch.sqrt(1 - a_t) * noise

    def training_target(self, sample, noise, timestep):
        if self.prediction_type == "epsilon":
            return noise
        a_t = self._acp(timestep, sample)
        return torch.sqrt(a_t) * noise - torch.sqrt(1 - a_t) * sample

    def training_weight(self, timestep):
        return torch.tensor(1.0, dtype=torch.float32)


def _timesteps(num_train, num_steps, strength):
    """999…0-aligned timesteps."""
    max_t = max(round(num_train * strength) - 1, 0)
    n = min(num_steps, max_t + 1)
    if n == 1:
        return np.array([max_t], np.float64)
    step = max_t / (n - 1)
    return np.array([round(max_t - i * step) for i in range(n)], np.float64)
