"""Flow-matching DPM-Solver++ multistep solver (port of
omnivideo_tpu/schedulers/fm_dpm.py): algorithm 'dpmsolver++', midpoint (or
heun) second order, third order, lower-order warmup and final steps, final
sigma 0, plus `get_sampling_sigmas`, the CLI's shifted linspace schedule.

As in the UniPC port, every schedule-dependent scalar is computed on the
host in float64 and folded into per-step coefficients rounded to float32; on
the device a step is

    x0_i    = x_i − σ_i · v_i
    (m3, m2, m1) ← (m2, m1, x0_i)
    x_{i+1} = pX·x_i + pM1·m1 + pM2·m2 + pM3·m3
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

COEFF_FIELDS = ("sigma", "timestep", "pX", "pM1", "pM2", "pM3")


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """Shifted linspace sigmas, float64."""
    sigma = np.linspace(1, 0, sampling_steps + 1, dtype=np.float64)[:sampling_steps]
    return shift * sigma / (1 + (shift - 1) * sigma)


class DPMState(NamedTuple):
    """Solver state, float32 tensors of the latent shape."""

    x: torch.Tensor
    m1: torch.Tensor  # most recent x0 prediction
    m2: torch.Tensor
    m3: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlowDPMSolver:
    """Schedule + coefficient tables. `coeffs[name]` is a float64 array [S]
    holding float32-rounded values (the JAX package's f32 tables)."""

    sigmas: np.ndarray  # [S+1] float64, terminal 0 appended
    timesteps: np.ndarray  # [S] float64, integer-valued
    coeffs: dict
    num_train_timesteps: int
    solver_order: int

    @staticmethod
    def create(
        num_inference_steps: Optional[int] = None,
        shift: float = 1.0,
        num_train_timesteps: int = 1000,
        solver_order: int = 2,
        solver_type: str = "midpoint",
        lower_order_final: bool = True,
        sigmas: Optional[np.ndarray] = None,
    ) -> "FlowDPMSolver":
        N = num_train_timesteps
        if sigmas is None:
            if num_inference_steps is None:
                raise ValueError("pass num_inference_steps or sigmas")
            sigmas = np.linspace(1.0 - 1.0 / N, 0.0, num_inference_steps + 1,
                                 dtype=np.float64)[:-1]
            sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        else:
            sigmas = np.asarray(sigmas, dtype=np.float64)
        S = len(sigmas)
        timesteps = np.trunc(sigmas * N)
        sig = np.concatenate([sigmas, [0.0]])
        with np.errstate(divide="ignore"):
            lam = np.log(1.0 - sig) - np.log(sig)

        c = {k: np.zeros(S) for k in COEFF_FIELDS[2:]}
        lower_order_nums = 0
        for i in range(S):
            # the final sigma is 0, so the last step is always first order
            low_second = i == S - 2 and lower_order_final and S < 15
            if solver_order == 1 or lower_order_nums < 1 or i == S - 1:
                order = 1
            elif solver_order == 2 or lower_order_nums < 2 or low_second:
                order = 2
            else:
                order = 3
            lower_order_nums = min(lower_order_nums + 1, solver_order)

            alpha_t = 1.0 - sig[i + 1]
            h = lam[i + 1] - lam[i]
            em1 = np.expm1(-h)
            c["pX"][i] = sig[i + 1] / sig[i]
            if order == 1:
                c["pM1"][i] = -alpha_t * em1
            elif order == 2:
                r0 = (lam[i] - lam[i - 1]) / h
                if solver_type == "midpoint":
                    c["pM1"][i] = -alpha_t * em1 * (1.0 + 0.5 / r0)
                    c["pM2"][i] = alpha_t * em1 * 0.5 / r0
                elif solver_type == "heun":
                    c1 = alpha_t * (em1 / h + 1.0)
                    c["pM1"][i] = -alpha_t * em1 + c1 / r0
                    c["pM2"][i] = -c1 / r0
                else:
                    raise NotImplementedError(solver_type)
            else:
                r0 = (lam[i] - lam[i - 1]) / h
                r1 = (lam[i - 1] - lam[i - 2]) / h
                cD1 = alpha_t * (em1 / h + 1.0)
                cD2 = -alpha_t * ((em1 + h) / h**2 - 0.5)
                w = r0 / (r0 + r1)
                a0, a1, a2 = (1 + w) / r0, -(1 + w) / r0 - w / r1, w / r1
                b0 = 1.0 / (r0 * (r0 + r1))
                b1 = -(1.0 / r0 + 1.0 / r1) / (r0 + r1)
                b2 = 1.0 / (r1 * (r0 + r1))
                c["pM1"][i] = -alpha_t * em1 + cD1 * a0 + cD2 * b0
                c["pM2"][i] = cD1 * a1 + cD2 * b1
                c["pM3"][i] = cD1 * a2 + cD2 * b2

        c["sigma"], c["timestep"] = sigmas, timesteps
        coeffs = {k: c[k].astype(np.float32).astype(np.float64) for k in COEFF_FIELDS}
        return FlowDPMSolver(sigmas=sig, timesteps=timesteps, coeffs=coeffs,
                             num_train_timesteps=N, solver_order=solver_order)

    def __len__(self) -> int:
        return len(self.timesteps)

    def init_state(self, latents: torch.Tensor) -> DPMState:
        x = latents.float()
        z = torch.zeros_like(x)
        return DPMState(x=x, m1=z, m2=z, m3=z)

    def step(self, state: DPMState, velocity: torch.Tensor, i: int) -> DPMState:
        """One multistep update at step i (f32 products, as the JAX step)."""
        c = {k: float(v[i]) for k, v in self.coeffs.items()}
        x0 = state.x - c["sigma"] * velocity.float()
        m1, m2, m3 = x0, state.m1, state.m2
        x_next = c["pX"] * state.x + c["pM1"] * m1 + c["pM2"] * m2 + c["pM3"] * m3
        return DPMState(x=x_next, m1=m1, m2=m2, m3=m3)
