"""DDPM noise schedule (counterpart of textboost_tpu/ops/schedule.py).

The float32 `betas` / `alphas_cumprod` tables are computed in float64 and
cast to float32 exactly as the JAX package does, so that sampler
coefficients derived from them are bit-identical; the training queries
(add_noise, velocity, snr, training_target, pred_original_sample) repeat
the JAX package's float32 arithmetic.  The tables are made on the CPU;
the first query on another device copies `alphas_cumprod` there once and
keeps the copy, so that a step neither copies from the host nor waits for
a copy (and can run inside a CUDA graph, train/graph.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
    # alphas_cumprod on each other device it was queried on, by device.
    device_tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

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

    # -- schedule queries --------------------------------------------------
    def alphas_on(self, device: torch.device) -> torch.Tensor:
        """`alphas_cumprod` on `device` (a tensor's device: with its index),
        copied there at the first call and kept."""
        if device.type == "cpu":
            return self.alphas_cumprod
        table = self.device_tables.get(device)
        if table is None:
            table = self.device_tables[device] = self.alphas_cumprod.to(device)
        return table

    def _alphas(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.alphas_on(timesteps.device)[timesteps]

    def _gather_sqrt(self, timesteps: torch.Tensor, ndim: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sqrt_alpha_prod, sqrt_one_minus_alpha_prod) broadcastable against
        a sample with `ndim` dims, batch-leading."""
        ac = self._alphas(timesteps)
        shape = (-1,) + (1,) * (ndim - 1)
        return torch.sqrt(ac).reshape(shape), torch.sqrt(1.0 - ac).reshape(shape)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(ac_t) x0 + sqrt(1 - ac_t) eps."""
        sqrt_ac, sqrt_1mac = self._gather_sqrt(timesteps, sample.dim())
        return sqrt_ac * sample + sqrt_1mac * noise

    def velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
        """v-prediction target: sqrt(ac_t) eps - sqrt(1 - ac_t) x0."""
        sqrt_ac, sqrt_1mac = self._gather_sqrt(timesteps, sample.dim())
        return sqrt_ac * noise - sqrt_1mac * sample

    def snr(self, timesteps: torch.Tensor) -> torch.Tensor:
        """Signal-to-noise ratio ac_t / (1 - ac_t) (diffusers compute_snr)."""
        ac = self._alphas(timesteps)
        return ac / (1.0 - ac)

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        timesteps: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == EPSILON:
            return noise
        if self.prediction_type == V_PREDICTION:
            return self.velocity(sample, noise, timesteps)
        raise ValueError(f"Unknown prediction type {self.prediction_type}")

    def pred_original_sample(self, model_output: torch.Tensor, sample: torch.Tensor,
                             timesteps: torch.Tensor) -> torch.Tensor:
        """Recover x0-hat from the model output at x_t."""
        sqrt_ac, sqrt_1mac = self._gather_sqrt(timesteps, sample.dim())
        if self.prediction_type == EPSILON:
            return (sample - sqrt_1mac * model_output) / sqrt_ac
        if self.prediction_type == V_PREDICTION:
            return sqrt_ac * sample - sqrt_1mac * model_output
        raise ValueError(f"Unknown prediction type {self.prediction_type}")


def snr_timestep_weights(schedule: NoiseSchedule) -> torch.Tensor:
    """SNR-weighted timestep sampling distribution (reference semantics,
    train_textboost.py:991-997): w_t = -log SNR(t) + max_t log SNR(t),
    p_t = w_t / sum(w_t), float32 [num_train_timesteps]."""
    logsnr = torch.log(schedule.snr(torch.arange(schedule.num_train_timesteps)))
    w = -logsnr + logsnr.max()
    return w / w.sum()


def sample_timesteps(
    generator: torch.Generator,
    schedule: NoiseSchedule,
    batch_size: int,
    weighted: bool = False,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Per-example timesteps [batch_size] (int64), uniform by default (the
    reference's reachable default, train_textboost.py:406-411), else drawn
    from `snr_timestep_weights`.  Draws come from `generator`, on its
    device; JAX's threefry draws cannot be reproduced."""
    device = device or generator.device
    if weighted:
        p = snr_timestep_weights(schedule).to(device)
        return torch.multinomial(p, batch_size, replacement=True, generator=generator)
    return torch.randint(0, schedule.num_train_timesteps, (batch_size,), generator=generator,
                         device=device)
