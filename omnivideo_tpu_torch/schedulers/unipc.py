"""Flow-matching UniPC multistep solver (port of
omnivideo_tpu/schedulers/unipc.py).

Every UniPC quantity that depends only on the sigma schedule (lambdas, h,
the rk ratios, the B(h) series, the solved rho weights of the UniC corrector
and UniP predictor) is computed on the host in float64 and folded into
per-step scalar coefficients, rounded to float32. On the device a step is the
five-tensor linear recurrence

    x0_i    = x_i − σ_i · v_i
    x_corr  = cS·x_i + cX·x_{i-1}^c + cM1·m1 + cM2·m2 + cM3·m3 + cT·x0_i
    (m3, m2, m1) ← (m2, m1, x0_i)
    x_{i+1} = pX·x_corr + pM1·m1 + pM2·m2 + pM3·m3

run by a Python loop (predict_x0, bh2, lower_order_final, final sigma 0,
flow prediction). Timesteps are σ·1000 truncated to integers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

COEFF_FIELDS = ("sigma", "timestep", "cS", "cX", "cM1", "cM2", "cM3", "cT",
                "pX", "pM1", "pM2", "pM3")


def _lam(sig: np.ndarray) -> np.ndarray:
    """λ(σ) = log α − log σ with α = 1 − σ."""
    with np.errstate(divide="ignore"):
        return np.log(1.0 - sig) - np.log(sig)


def _bh_series(hh: float, order: int, solver_type: str):
    """The b-vector of the B(h) linear system."""
    h_phi_1 = np.expm1(hh)
    if solver_type == "bh1":
        B_h = hh
    elif solver_type == "bh2":
        B_h = np.expm1(hh)
    else:
        raise NotImplementedError(solver_type)
    h_phi_k = h_phi_1 / hh - 1.0
    b = []
    factorial_i = 1.0
    for i in range(1, order + 1):
        b.append(h_phi_k * factorial_i / B_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return np.asarray(b), h_phi_1, B_h


class UniPCState(NamedTuple):
    """Solver state, all float32 tensors of the latent shape."""

    x: torch.Tensor  # current sample
    m1: torch.Tensor  # most recent x0 prediction
    m2: torch.Tensor
    m3: torch.Tensor
    last_x: torch.Tensor  # sample before the last predictor


@dataclasses.dataclass(frozen=True)
class FlowUniPC:
    """Schedule + coefficient tables. `coeffs[name]` is a float64 array [S]
    holding float32-rounded values (the JAX package's f32 tables)."""

    sigmas: np.ndarray  # [S+1] float64, terminal 0 appended
    timesteps: np.ndarray  # [S] float64, integer-valued
    coeffs: dict
    num_train_timesteps: int
    solver_order: int

    @staticmethod
    def create(
        num_inference_steps: int,
        shift: float = 1.0,
        num_train_timesteps: int = 1000,
        solver_order: int = 2,
        solver_type: str = "bh2",
        lower_order_final: bool = True,
        disable_corrector: Sequence[int] = (),
        sigmas: Optional[np.ndarray] = None,
    ) -> "FlowUniPC":
        S = num_inference_steps
        N = num_train_timesteps
        if sigmas is None:
            sigmas = np.linspace(1.0 - 1.0 / N, 0.0, S + 1, dtype=np.float64)[:-1]
            sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        else:
            sigmas = np.asarray(sigmas, dtype=np.float64)
            if sigmas.shape != (S,):
                raise ValueError(f"sigmas shape {sigmas.shape} != ({S},)")
        timesteps = np.trunc(sigmas * N)
        sig = np.concatenate([sigmas, [0.0]])
        lam = _lam(sig)

        ar = np.arange(S)
        this_order = (np.minimum(np.minimum(solver_order, S - ar), ar + 1)
                      if lower_order_final else np.minimum(solver_order, ar + 1))
        disabled = set(disable_corrector)
        use_corr = np.array([i > 0 and (i - 1) not in disabled for i in range(S)])

        c = {k: np.zeros(S) for k in COEFF_FIELDS[2:]}
        for i in range(S):
            # corrector (UniC) at step i
            if not use_corr[i]:
                c["cS"][i] = 1.0
            else:
                order = int(this_order[i - 1])
                h = lam[i] - lam[i - 1]
                alpha_t = 1.0 - sig[i]
                b, h_phi_1, B_h = _bh_series(-h, order, solver_type)
                rks = np.asarray([(lam[i - (k + 1)] - lam[i - 1]) / h
                                  for k in range(1, order)] + [1.0])
                if order == 1:
                    rhos = np.array([0.5])
                else:
                    rhos = np.linalg.solve(np.vander(rks, order, increasing=True).T, b)
                c["cX"][i] = sig[i] / sig[i - 1]
                c["cM1"][i] = -alpha_t * h_phi_1
                if order >= 2:
                    c["cM2"][i] += -alpha_t * B_h * rhos[0] / rks[0]
                    c["cM1"][i] += alpha_t * B_h * rhos[0] / rks[0]
                if order >= 3:
                    c["cM3"][i] += -alpha_t * B_h * rhos[1] / rks[1]
                    c["cM1"][i] += alpha_t * B_h * rhos[1] / rks[1]
                c["cT"][i] = -alpha_t * B_h * rhos[-1]
                c["cM1"][i] += alpha_t * B_h * rhos[-1]

            # predictor (UniP) at step i
            order = int(this_order[i])
            h = lam[i + 1] - lam[i]
            alpha_t = 1.0 - sig[i + 1]
            b, h_phi_1, B_h = _bh_series(-h, order, solver_type)
            rks = np.asarray([(lam[i - k] - lam[i]) / h for k in range(1, order)] + [1.0])
            if order == 2:
                rhos = np.array([0.5])
            elif order > 2:
                R = np.vander(rks, order, increasing=True).T
                rhos = np.linalg.solve(R[:-1, :-1], b[:-1])
            else:
                rhos = np.zeros(0)
            c["pX"][i] = sig[i + 1] / sig[i]
            c["pM1"][i] = -alpha_t * h_phi_1
            if order >= 2:
                c["pM2"][i] += -alpha_t * B_h * rhos[0] / rks[0]
                c["pM1"][i] += alpha_t * B_h * rhos[0] / rks[0]
            if order >= 3:
                c["pM3"][i] += -alpha_t * B_h * rhos[1] / rks[1]
                c["pM1"][i] += alpha_t * B_h * rhos[1] / rks[1]

        c["sigma"], c["timestep"] = sigmas, timesteps
        coeffs = {k: c[k].astype(np.float32).astype(np.float64) for k in COEFF_FIELDS}
        return FlowUniPC(sigmas=sig, timesteps=timesteps, coeffs=coeffs,
                         num_train_timesteps=N, solver_order=solver_order)

    def __len__(self) -> int:
        return len(self.timesteps)

    def init_state(self, latents: torch.Tensor) -> UniPCState:
        x = latents.float()
        z = torch.zeros_like(x)
        return UniPCState(x=x, m1=z, m2=z, m3=z, last_x=z)

    def step(self, state: UniPCState, velocity: torch.Tensor, i: int) -> UniPCState:
        """One corrector + predictor update at step i. The coefficients are
        Python floats holding f32 values, so each product rounds as the JAX
        f32 recurrence does."""
        c = {k: float(v[i]) for k, v in self.coeffs.items()}
        v = velocity.float()
        x0 = state.x - c["sigma"] * v
        x_corr = (c["cS"] * state.x + c["cX"] * state.last_x + c["cM1"] * state.m1
                  + c["cM2"] * state.m2 + c["cM3"] * state.m3 + c["cT"] * x0)
        m1, m2, m3 = x0, state.m1, state.m2
        x_next = c["pX"] * x_corr + c["pM1"] * m1 + c["pM2"] * m2 + c["pM3"] * m3
        return UniPCState(x=x_next, m1=m1, m2=m2, m3=m3, last_x=x_corr)
