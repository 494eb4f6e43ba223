"""Flow-matching training schedule (port of
omnivideo_tpu/schedulers/flow_match.py, its training half).

The shifted linspace sigma table σ' = s·σ / (1 + (s − 1)·σ), the timesteps
σ'·T and the Gaussian-bump loss weights are built on the host in float64
numpy and rounded to float32, as the JAX package builds them. A timestep maps
back to its table index by argmin |timesteps − t| (first index on ties).
Noising is x_t = (1 − σ)·x + σ·ε, the velocity target is ε − x. The Euler
inference step is not on a ported path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def shifted_sigmas(
    num_steps: int,
    shift: float,
    sigma_max: float = 1.0,
    sigma_min: float = 0.003 / 1.002,
    extra_one_step: bool = False,
    inverse_timesteps: bool = False,
    reverse_sigmas: bool = False,
    denoising_strength: float = 1.0,
) -> np.ndarray:
    """The float64 sigma table."""
    sigma_start = sigma_min + (sigma_max - sigma_min) * denoising_strength
    if extra_one_step:
        sigmas = np.linspace(sigma_start, sigma_min, num_steps + 1)[:-1]
    else:
        sigmas = np.linspace(sigma_start, sigma_min, num_steps)
    if inverse_timesteps:
        sigmas = sigmas[::-1].copy()
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    if reverse_sigmas:
        sigmas = 1 - sigmas
    return sigmas.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class FlowMatchScheduler:
    sigmas: torch.Tensor  # [S] f32
    timesteps: torch.Tensor  # [S] f32 (= sigmas · num_train_timesteps, from f64)
    num_train_timesteps: int
    training_weights: Optional[torch.Tensor] = None  # [S] f32

    @staticmethod
    def create(
        num_inference_steps: int = 100,
        num_train_timesteps: int = 1000,
        shift: float = 3.0,
        is_training: bool = False,
        device=None,
        **table_kw,
    ) -> "FlowMatchScheduler":
        """table_kw: the remaining `shifted_sigmas` arguments."""
        sig = shifted_sigmas(num_inference_steps, shift, **table_kw)
        ts = sig * num_train_timesteps
        weights = None
        if is_training:  # Gaussian bump over timesteps
            y = np.exp(-2 * ((ts - num_inference_steps / 2) / num_inference_steps) ** 2)
            y_shifted = y - y.min()
            weights = y_shifted * (num_inference_steps / y_shifted.sum())
            weights = torch.tensor(weights, dtype=torch.float32, device=device)
        return FlowMatchScheduler(
            sigmas=torch.tensor(sig, dtype=torch.float32, device=device),
            timesteps=torch.tensor(ts, dtype=torch.float32, device=device),
            num_train_timesteps=num_train_timesteps,
            training_weights=weights,
        )

    def timestep_id(self, timestep: torch.Tensor) -> torch.Tensor:
        """Nearest table index per timestep ([B] or scalar → [B])."""
        t = torch.atleast_1d(torch.as_tensor(timestep, dtype=torch.float32,
                                             device=self.timesteps.device))
        return torch.argmin((self.timesteps[None, :] - t[:, None]).abs(), dim=-1)

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timestep: torch.Tensor) -> torch.Tensor:
        """x_t = (1 − σ)·x + σ·ε, σ looked up per sample."""
        sigma = self.sigmas[self.timestep_id(timestep)].to(original_samples.dtype)
        sigma = sigma.reshape((-1,) + (1,) * (original_samples.ndim - 1))
        return (1 - sigma) * original_samples + sigma * noise

    @staticmethod
    def training_target(sample: torch.Tensor, noise: torch.Tensor,
                        timestep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Velocity target v = ε − x."""
        return noise - sample

    def training_weight(self, timestep: torch.Tensor) -> torch.Tensor:
        if self.training_weights is None:
            raise ValueError("create(is_training=True) builds the weights")
        return self.training_weights[self.timestep_id(timestep)]
