"""Text-to-image sampling, written out for the reference, in float32:
prompt encoding with TextBoost's null patch, DPM-Solver++(2M) (data
prediction, the lower-order final step, timesteps spaced by linspace) over
the classifier-free-guided UNet, the VAE decode, and the images as uint8.

The solver's coefficients come from the float32 schedule table with float64
arithmetic on the host (Lu et al. 2022, multistep second order), and are
rounded to float32 once.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import null_patch
from .train import alphas_cumprod


def dpm_coefficients(num_steps: int, n_train: int = 1000):
    """Per step: timestep, alpha, sigma and the update's coefficients on x,
    on the data estimate and on its difference from the last one."""
    ts = np.linspace(0, n_train - 1, num_steps + 1).round()[::-1][:-1].astype(np.int64)
    ac = alphas_cumprod(n_train).numpy()[ts].astype(np.float64)
    alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
    lam = np.log(alpha) - np.log(sigma)
    steps, h_prev = [], None
    for i in range(num_steps):
        if i == num_steps - 1:  # the final step goes to the data estimate
            c_x, c_d0, c_d1 = 0.0, 1.0, 0.0
            inv_r0 = 0.0
        else:
            h = lam[i + 1] - lam[i]
            phi = np.expm1(-h)
            c_x, c_d0 = sigma[i + 1] / sigma[i], -alpha[i + 1] * phi
            c_d1, inv_r0 = (-0.5 * alpha[i + 1] * phi, h / h_prev) if i > 0 else (0.0, 0.0)
            h_prev = h
        f = lambda v: float(np.float32(v))  # noqa: E731
        steps.append((int(ts[i]), f(alpha[i]), f(sigma[i]), f(c_x), f(c_d0), f(c_d1), f(inv_r0)))
    return steps


@torch.no_grad()
def sample(te, unet, vae, ids, neg_ids, null, latents, *, table, eos_id: int,
           vae_scaling: float, steps: int = 25, guidance: float = 7.5) -> np.ndarray:
    """uint8 [B, H, W, 3] images of the prompts' ids from `latents` [B, 4, h, w]."""
    hidden = null_patch(te(ids, table=table), ids, null, eos_id)
    neg = null_patch(te(neg_ids, table=table), neg_ids, null, eos_id)
    ctx = torch.cat([neg, hidden])
    x = latents.float()
    x0_prev = torch.zeros_like(x)
    for t, alpha, sigma, c_x, c_d0, c_d1, inv_r0 in dpm_coefficients(steps):
        tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        uncond, cond = unet(torch.cat([x, x]), torch.cat([tt, tt]), ctx).chunk(2)
        eps = uncond + guidance * (cond - uncond)
        x0 = (x - sigma * eps) / alpha
        x = c_x * x + c_d0 * x0 + c_d1 * (x0 - x0_prev) * inv_r0
        x0_prev = x0
    images = torch.cat([vae.decode(x[i:i + 2] / vae_scaling) for i in range(0, len(x), 2)])
    if not bool(torch.isfinite(images).all()):
        raise FloatingPointError("the reference's images hold non-finite values")
    images = images.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
    return ((images + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
