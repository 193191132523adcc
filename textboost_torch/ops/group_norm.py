"""GroupNorm(+SiLU) forward: the CUDA kernel's wrapper and its plain version.

The kernel (`csrc/group_norm_fwd.cu`) replaces the Pallas TPU kernel
`textboost_tpu/ops/group_norm.py::_fwd_kernel`.  The layout is
NCHW-contiguous ([B, C, *spatial]): each (sample, group) is one contiguous
span.  Statistics are fp32 from one pass with the variance clamped at 0;
gamma/beta are fp32; SiLU runs in fp32 before the cast to x's dtype.
Returns (y, mean, rstd) with mean/rstd fp32 [B, G].

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `launches` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

SOURCE = "group_norm_fwd.cu"
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

launches = 0


def group_norm_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float,
    silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: one-pass fp32 statistics over [B, G, (C/G)*spatial],
    affine and optional SiLU in fp32, cast to x's dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1)
    var = ((xf * xf).mean(dim=-1) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    bcast = (1, c) + (1,) * (x.dim() - 2)
    y = y * gamma.float().reshape(bcast) + beta.float().reshape(bcast)
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype), mean, rstd


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"group norm takes fp32/fp16/bf16 x, got {x.dtype}")
    if x.dim() < 3:
        raise ValueError(f"expected x [B, C, *spatial], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("group norm kernel takes an NCHW-contiguous x")
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"C={c} is not divisible by G={num_groups}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{c}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x[0].numel() // num_groups >= 2**31:
        raise ValueError("a (sample, group) span exceeds 2^31 elements")


def group_norm_forward(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    *,
    eps: float = 1e-5,
    silu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm over x [B, C, *spatial] -> (y, mean, rstd)."""
    grads = torch.is_grad_enabled() and (
        x.requires_grad or gamma.requires_grad or beta.requires_grad
    )
    if x.device.type == "cpu":
        return group_norm_reference(x, gamma, beta, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group norm runs on cuda or cpu, not {x.device}")
    if grads:
        raise NotImplementedError(
            "group norm backward is not ported yet; run frozen models under "
            "torch.no_grad()/inference_mode()"
        )
    _check(x, gamma, beta, num_groups)
    b, c = x.shape[:2]
    hw = x[0, 0].numel()
    y = torch.empty_like(x)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    lib = _build.load(SOURCE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tb_group_norm_fwd(
            DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            b, c, num_groups, hw, float(eps), int(bool(silu)), stream,
        )
    _build.check(rc, "group_norm_fwd")
    global launches
    launches += 1
    return y, mean, rstd
