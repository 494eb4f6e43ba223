"""EDM-style continuous ODE scheduler (port of
omnivideo_tpu/schedulers/continuous_ode.py; the reference's
`omnivideo/modules/schedulers/continuous_ode.py` ContinuousODEScheduler).

Karras rho-spaced sigmas (built in f64, rounded to f32), timestep =
0.25·log σ, a preconditioned Euler step in f32 on the sample's device. No
x2x caller uses it (the pipeline takes UniPC and DPM++, as JAX's)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ContinuousODEScheduler:
    sigmas: torch.Tensor  # [S] f32
    timesteps: torch.Tensor  # [S] f32
    sigma_max: float = 700.0
    sigma_min: float = 0.002
    rho: float = 7.0

    @staticmethod
    def create(
        num_inference_steps: int = 100,
        sigma_max: float = 700.0,
        sigma_min: float = 0.002,
        rho: float = 7.0,
        denoising_strength: float = 1.0,
    ) -> "ContinuousODEScheduler":
        ramp = np.linspace(1 - denoising_strength, 1, num_inference_steps)
        min_r = sigma_min ** (1 / rho)
        max_r = sigma_max ** (1 / rho)
        sig = (max_r + ramp * (min_r - max_r)) ** rho
        return ContinuousODEScheduler(
            sigmas=torch.tensor(sig, dtype=torch.float32),
            timesteps=torch.tensor(np.log(sig) * 0.25, dtype=torch.float32),
            sigma_max=sigma_max, sigma_min=sigma_min, rho=rho)

    def _tid(self, timestep) -> int:
        t = torch.tensor(float(timestep), dtype=torch.float32)
        return int(torch.argmin((self.timesteps - t).abs()))

    def _sigma(self, i: int, like: torch.Tensor) -> torch.Tensor:
        return self.sigmas[i].to(like.device)

    def step(self, model_output, timestep, sample, to_final: bool = False):
        tid = self._tid(timestep)
        sigma = self._sigma(tid, sample)
        s2p1 = torch.sqrt(sigma * sigma + 1)
        sample = sample * s2p1
        est = -sigma / s2p1 * model_output + sample / (sigma * sigma + 1)
        if to_final or tid + 1 >= self.sigmas.shape[0]:
            return est
        sigma_n = self._sigma(tid + 1, sample)
        deriv = (sample - est) / sigma
        return (sample + deriv * (sigma_n - sigma)) / torch.sqrt(sigma_n * sigma_n + 1)

    def add_noise(self, original_samples, noise, timestep):
        sigma = self._sigma(self._tid(timestep), original_samples)
        return (original_samples + noise * sigma) / torch.sqrt(sigma * sigma + 1)

    def training_target(self, sample, noise, timestep):
        sigma = self._sigma(self._tid(timestep), sample)
        s2p1 = torch.sqrt(sigma * sigma + 1)
        return (-s2p1 / sigma + 1 / s2p1 / sigma) * sample + noise / s2p1

    def training_weight(self, timestep):
        sigma = self.sigmas[self._tid(timestep)]
        return torch.sqrt(1 + sigma * sigma) / sigma
