"""Diffusion samplers: DPM-Solver++ (2M), DDIM, DDPM and PNDM (counterpart
of textboost_tpu/samplers/solvers.py, with its registry of the reference's
scheduler class names).

Every per-step coefficient is precomputed on the host in numpy from the
schedule's float32 `alphas_cumprod`, with the JAX package's arithmetic, so
the coefficients are bit-identical; the trajectory is a Python loop over
`model_fn(x, t_batch) -> model_output` calls in fp32.  Classifier-free
guidance lives in the pipeline.  A trajectory's Python structure and
coefficients are fixed by (sampler, steps) and it reads no value back from
the device, so a CUDA graph can hold it whole (train/graph.py); DDPM's
noise is drawn before the loop (`ddpm_noises`), outside such a graph.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.schedule import EPSILON, V_PREDICTION, NoiseSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_timesteps(num_train_timesteps: int, num_steps: int,
                   spacing: str = "linspace") -> np.ndarray:
    """Descending inference timesteps: "linspace" is DPM-Solver's default,
    "leading" (with SD's steps_offset=1) DDIM's and PNDM's."""
    if spacing == "linspace":
        return (
            np.linspace(0, num_train_timesteps - 1, num_steps + 1)
            .round()[::-1][:-1]
            .astype(np.int64)
        )
    if spacing == "leading":
        ratio = num_train_timesteps // num_steps
        return (np.arange(0, num_steps) * ratio).round()[::-1].astype(np.int64) + 1
    raise ValueError(f"Unknown timestep spacing: {spacing}")


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


def _predict_eps(schedule: NoiseSchedule, model_out: torch.Tensor, x: torch.Tensor,
                 alpha_t: float, sigma_t: float) -> torch.Tensor:
    if schedule.prediction_type == EPSILON:
        return model_out
    if schedule.prediction_type == V_PREDICTION:
        return sigma_t * x + alpha_t * model_out
    raise ValueError(schedule.prediction_type)


def _t_batch(x: torch.Tensor, t) -> torch.Tensor:
    return torch.full((x.shape[0],), int(t), dtype=torch.int32, device=x.device)


def _f32(a) -> List[float]:
    """Per-step coefficients as the float32 values the JAX scan carries."""
    return [float(v) for v in np.asarray(a, dtype=np.float32)]


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
        out = model_fn(x, _t_batch(x, co.timesteps[i])).float()
        x0 = _predict_x0(schedule, out, x, float(co.alpha[i]), float(co.sigma[i]))
        d1 = (x0 - x0_prev) * float(co.inv_r0[i])
        w = float(co.c_d1[i] * np.float32(1.0 if co.use_second[i] else 0.0))
        x = float(co.c_x[i]) * x + float(co.c_d0[i]) * x0 + w * d1
        x0_prev = x0
    return x


def ddim_sample(
    model_fn: ModelFn,
    schedule: NoiseSchedule,
    latents: torch.Tensor,
    num_steps: int,
) -> torch.Tensor:
    """DDIM, eta 0, on the "leading" grid; the last step goes to alpha 1,
    sigma 0 (the state after it is x0)."""
    ts = make_timesteps(schedule.num_train_timesteps, num_steps, "leading")
    alpha, sigma = _alpha_sigma(schedule, ts)
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    sigma_next = np.concatenate([sigma[1:], [0.0]])
    x = latents.float()
    for t, a, s, a_next, s_next in zip(ts, _f32(alpha), _f32(sigma), _f32(alpha_next),
                                       _f32(sigma_next)):
        out = model_fn(x, _t_batch(x, t)).float()
        x0 = _predict_x0(schedule, out, x, a, s)
        eps = _predict_eps(schedule, out, x, a, s)
        x = a_next * x0 + s_next * eps
    return x


def ddpm_noises(shape, num_steps: int, device) -> torch.Tensor:
    """DDPM's default noise, [num_steps, *shape] fp32: one draw a step, in
    the order `ddpm_sample` takes them, from a torch.Generator on `device`
    seeded with 0 (the counterpart of the JAX package's fixed PRNGKey(0))."""
    generator = torch.Generator(device).manual_seed(0)
    return torch.stack([torch.randn(tuple(shape), generator=generator, device=device,
                                    dtype=torch.float32) for _ in range(num_steps)])


def predrawn_noises(sample, shape, num_steps: int, device) -> Optional[torch.Tensor]:
    """The noise `sample` draws, made before its trajectory (`ddpm_noises`
    for DDPM), or None for a sampler that draws none."""
    return ddpm_noises(shape, num_steps, device) if sample is ddpm_sample else None


def ddpm_sample(
    model_fn: ModelFn,
    schedule: NoiseSchedule,
    latents: torch.Tensor,
    num_steps: int,
    noises: Optional[Sequence] = None,
) -> torch.Tensor:
    """DDPM ancestral sampling on the "leading" grid: the posterior
    q(x_{t-1} | x_t, x0) with its std clipped at 1e-20 and 0 at the last
    step.  The noise of step i is `noises[i]` when given (the JAX package's
    threefry draws cannot be made by torch), else `ddpm_noises` on the
    latents' device, drawn before the loop."""
    ts = make_timesteps(schedule.num_train_timesteps, num_steps, "leading")
    ac = schedule.alphas_cumprod.numpy()[ts]
    ac_prev = np.concatenate([ac[1:], [1.0]])
    beta_t = 1.0 - ac / ac_prev
    alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
    c_x0 = np.sqrt(ac_prev) * beta_t / (1.0 - ac)
    c_xt = np.sqrt(1.0 - beta_t) * (1.0 - ac_prev) / (1.0 - ac)
    var = np.clip(beta_t * (1.0 - ac_prev) / (1.0 - ac), 1e-20, None)
    std = np.sqrt(var)
    std[-1] = 0.0
    x = latents.float()
    if noises is None:
        noises = ddpm_noises(x.shape, num_steps, x.device)
    for i, (t, a, s, cx0, cxt, noise_std) in enumerate(zip(
            ts, _f32(alpha), _f32(sigma), _f32(c_x0), _f32(c_xt), _f32(std))):
        out = model_fn(x, _t_batch(x, t)).float()
        x0 = _predict_x0(schedule, out, x, a, s)
        noise = torch.as_tensor(noises[i], dtype=torch.float32, device=x.device)
        x = cx0 * x0 + cxt * x + noise_std * noise
    return x


class PNDMCoeffs(NamedTuple):
    timesteps: np.ndarray  # [n] model-call timesteps (num_steps + 1 when num_steps > 1)
    sample_c: np.ndarray  # [n] coefficient on the sample
    eps_c: np.ndarray  # [n] coefficient on the combined eps
    alpha: np.ndarray  # [n] sqrt(alphas_cumprod) at the step's effective timestep
    sigma: np.ndarray  # [n]
    weights: np.ndarray  # [n, 4] on (this output, the 3-slot history)
    use_stored: np.ndarray  # [n] bool: step from the stored original sample
    append: np.ndarray  # [n] bool: push this output onto the history
    store: np.ndarray  # [n] bool: keep this step's input sample


def _pndm_coeffs(schedule: NoiseSchedule, num_steps: int) -> PNDMCoeffs:
    """The JAX package's PNDM plan (skip_prk_steps, steps_offset=1,
    set_alpha_to_one=False), in its float64 arithmetic."""
    n_train = schedule.num_train_timesteps
    ratio = n_train // num_steps
    ts_asc = np.arange(num_steps, dtype=np.int64) * ratio + 1  # steps_offset=1
    if num_steps > 1:
        seq = np.concatenate([ts_asc[:-1], ts_asc[-2:-1], ts_asc[-1:]])[::-1]
    else:
        seq = ts_asc[::-1]
    n_total = len(seq)
    ac = np.asarray(schedule.alphas_cumprod.numpy(), np.float64)
    final_ac = ac[0]  # set_alpha_to_one=False

    samp_c, coef_e = np.zeros(n_total), np.zeros(n_total)
    a_eff, s_eff = np.zeros(n_total), np.zeros(n_total)
    w = np.zeros((n_total, 4))
    use_cur = np.zeros(n_total, dtype=bool)
    do_append = np.zeros(n_total, dtype=bool)
    do_store = np.zeros(n_total, dtype=bool)
    do_store[0] = True  # the original sample, for the warm-up corrector
    n_hist = 0
    for i, t in enumerate(seq):
        if i == 1 and num_steps > 1:
            # The Heun warm-up: the second grid point again, averaged with
            # the first prediction, from the ORIGINAL sample.
            t_eff, t_prev = t + ratio, int(t)
            w[i, :2] = 0.5
            use_cur[i] = True
        else:
            t_eff, t_prev = int(t), int(t) - ratio
            do_append[i] = True
            n_hist += 1
            if n_hist == 1:
                w[i, 0] = 1.0
            elif n_hist == 2:
                w[i, :2] = (3.0 / 2.0, -1.0 / 2.0)
            elif n_hist == 3:
                w[i, :3] = (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0)
            else:
                w[i] = (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0)
        ap_t = ac[t_eff]
        ap_prev = ac[t_prev] if t_prev >= 0 else final_ac
        samp_c[i] = np.sqrt(ap_prev / ap_t)
        denom = ap_t * np.sqrt(1.0 - ap_prev) + np.sqrt(ap_t * (1.0 - ap_t) * ap_prev)
        coef_e[i] = (ap_prev - ap_t) / denom
        a_eff[i] = np.sqrt(ap_t)
        s_eff[i] = np.sqrt(1.0 - ap_t)
    return PNDMCoeffs(seq, samp_c, coef_e, a_eff, s_eff, w, use_cur, do_append, do_store)


def pndm_sample(
    model_fn: ModelFn,
    schedule: NoiseSchedule,
    latents: torch.Tensor,
    num_steps: int,
) -> torch.Tensor:
    """PNDM with the SD pipelines' configuration: pure PLMS after one Heun
    warm-up correction (num_steps + 1 model calls when num_steps > 1), the
    eps history a 3-slot shift register, and under v-prediction the v -> eps
    conversion after the multistep combination, at the step's effective
    timestep, where the reference scheduler makes it."""
    co = _pndm_coeffs(schedule, num_steps)
    is_v = schedule.prediction_type == V_PREDICTION
    w = np.asarray(co.weights, np.float32)
    x = latents.float()
    cur = h1 = h2 = h3 = torch.zeros_like(x)
    for i, (t, sc, ce, a_t, s_t) in enumerate(zip(
            co.timesteps, _f32(co.sample_c), _f32(co.eps_c), _f32(co.alpha), _f32(co.sigma))):
        e = model_fn(x, _t_batch(x, t)).float()
        wi = [float(v) for v in w[i]]
        et = wi[0] * e + wi[1] * h1 + wi[2] * h2 + wi[3] * h3
        sample = cur if co.use_stored[i] else x
        if is_v:
            et = a_t * et + s_t * sample
        x_next = sc * sample - ce * et
        if co.store[i]:
            cur = x
        if co.append[i]:
            h1, h2, h3 = e, h1, h2
        x = x_next
    return x


SAMPLERS = {
    "dpm++2m": dpm_solver_sample,
    "ddim": ddim_sample,
    "ddpm": ddpm_sample,
    "pndm": pndm_sample,
    # The reference's scheduler class names (--validation_scheduler).
    "DPMSolverMultistepScheduler": dpm_solver_sample,
    "DDIMScheduler": ddim_sample,
    "DDPMScheduler": ddpm_sample,
    "PNDMScheduler": pndm_sample,
}


def get_sampler(name: str):
    if name not in SAMPLERS:
        raise ValueError(f"Unknown sampler '{name}'. Available: {sorted(SAMPLERS)}")
    return SAMPLERS[name]
