"""DPM-Solver++ (2M) sampling (counterpart of textboost_tpu/samplers/solvers.py).

Every per-step coefficient is precomputed on the host in numpy from the
schedule's float32 `alphas_cumprod`, with the JAX package's arithmetic, so
the coefficients are bit-identical; the trajectory is a Python loop over
`model_fn(x, t_batch) -> model_output` calls.  Classifier-free guidance
lives in the pipeline.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.schedule import EPSILON, V_PREDICTION, NoiseSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_timesteps(num_train_timesteps: int, num_steps: int) -> np.ndarray:
    """Descending inference timesteps, "linspace" spacing (DPM-Solver's
    default; the "leading" spacing of DDIM/PNDM comes with those samplers)."""
    return (
        np.linspace(0, num_train_timesteps - 1, num_steps + 1)
        .round()[::-1][:-1]
        .astype(np.int64)
    )


def _alpha_sigma(schedule: NoiseSchedule, ts: np.ndarray):
    ac = schedule.alphas_cumprod.numpy()[ts]
    return np.sqrt(ac), np.sqrt(1.0 - ac)


def _predict_x0(schedule: NoiseSchedule, model_out: torch.Tensor, x: torch.Tensor,
                alpha_t: float, sigma_t: float) -> torch.Tensor:
    if schedule.prediction_type == EPSILON:
        return (x - sigma_t * model_out) / alpha_t
    if schedule.prediction_type == V_PREDICTION:
        return alpha_t * x - sigma_t * model_out
    raise ValueError(schedule.prediction_type)


class DPMCoeffs(NamedTuple):
    timesteps: np.ndarray  # [N] int32
    alpha: np.ndarray  # [N] float32 state alpha at each step input
    sigma: np.ndarray  # [N]
    c_x: np.ndarray  # [N] coefficient on x
    c_d0: np.ndarray  # [N] coefficient on D0 (= x0 estimate)
    c_d1: np.ndarray  # [N] coefficient on D1 (multistep correction)
    inv_r0: np.ndarray  # [N] 1/r0 = h_i / h_{i-1}
    use_second: np.ndarray  # [N] bool: apply the 2nd-order correction


def _dpm_coeffs(schedule: NoiseSchedule, num_steps: int) -> DPMCoeffs:
    ts = make_timesteps(schedule.num_train_timesteps, num_steps)
    alpha, sigma = _alpha_sigma(schedule, ts)
    lam = np.log(alpha) - np.log(sigma)

    c_x = np.zeros(num_steps)
    c_d0 = np.zeros(num_steps)
    c_d1 = np.zeros(num_steps)
    inv_r0 = np.zeros(num_steps)
    use_second = np.zeros(num_steps, dtype=bool)

    h_prev = None
    for i in range(num_steps):
        if i == num_steps - 1:
            # Terminal boundary (t -> 0): alpha=1, sigma=0, h -> inf, so the
            # first-order update degenerates to x = x0.
            c_x[i], c_d0[i], c_d1[i] = 0.0, 1.0, 0.0
        else:
            h = lam[i + 1] - lam[i]
            phi = np.expm1(-h)
            c_x[i] = sigma[i + 1] / sigma[i]
            c_d0[i] = -alpha[i + 1] * phi
            if i > 0:
                # 2M midpoint correction: D1 = (x0 - x0_prev) / r0.
                c_d1[i] = -0.5 * alpha[i + 1] * phi
                inv_r0[i] = h / h_prev
                use_second[i] = True
            h_prev = h

    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return DPMCoeffs(
        timesteps=ts.astype(np.int32), alpha=f32(alpha), sigma=f32(sigma),
        c_x=f32(c_x), c_d0=f32(c_d0), c_d1=f32(c_d1), inv_r0=f32(inv_r0),
        use_second=use_second,
    )


def dpm_solver_sample(
    model_fn: ModelFn,
    schedule: NoiseSchedule,
    latents: torch.Tensor,
    num_steps: int,
) -> torch.Tensor:
    """DPM-Solver++ (2M), data prediction, lower-order final step; fp32."""
    co = _dpm_coeffs(schedule, num_steps)
    x = latents.float()
    x0_prev = torch.zeros_like(x)
    for i in range(num_steps):
        t_batch = torch.full((x.shape[0],), int(co.timesteps[i]), dtype=torch.int32,
                             device=x.device)
        out = model_fn(x, t_batch).float()
        x0 = _predict_x0(schedule, out, x, float(co.alpha[i]), float(co.sigma[i]))
        d1 = (x0 - x0_prev) * float(co.inv_r0[i])
        w = float(co.c_d1[i] * np.float32(1.0 if co.use_second[i] else 0.0))
        x = float(co.c_x[i]) * x + float(co.c_d0[i]) * x0 + w * d1
        x0_prev = x0
    return x
