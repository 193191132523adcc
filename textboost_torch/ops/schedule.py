"""DDPM noise schedule tables (counterpart of textboost_tpu/ops/schedule.py).

Only what sampling needs: the float32 `betas` / `alphas_cumprod` tables,
computed in float64 and cast to float32 exactly as the JAX package does, so
that sampler coefficients derived from them are bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPSILON = "epsilon"
V_PREDICTION = "v_prediction"


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """float32 CPU tables of shape [num_train_timesteps]."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = EPSILON,
    ) -> "NoiseSchedule":
        """Defaults match Stable Diffusion 1.x/2.x training schedules."""
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = (
                np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
                ** 2
            )
        elif beta_schedule == "squaredcos_cap_v2":
            steps = np.arange(num_train_timesteps + 1, dtype=np.float64) / num_train_timesteps

            def acos2(t):
                return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

            betas = np.clip(1.0 - acos2(steps[1:]) / acos2(steps[:-1]), 0.0, 0.999)
        else:
            raise ValueError(f"Unknown beta schedule: {beta_schedule}")
        alphas_cumprod = np.cumprod(1.0 - betas)
        return cls(
            betas=torch.from_numpy(betas.astype(np.float32)),
            alphas_cumprod=torch.from_numpy(alphas_cumprod.astype(np.float32)),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
        )
