"""GroupNorm(+SiLU): the CUDA kernels' wrappers, their plain versions, and
the autograd Function that joins them.

Forward: `csrc/group_norm_fwd.cu` replaces the Pallas TPU kernel
`textboost_tpu/ops/group_norm.py::_fwd_kernel`.  Backward (input gradient
only): `csrc/group_norm_bwd.cu` replaces `_bwd_kernel` (`_run_bwd` and the
VJP `_fused_gn_bwd`).  The layout is NCHW-contiguous ([B, C, *spatial]):
each (sample, group) is one contiguous span.  Statistics are fp32 from one
pass with the variance clamped at 0; gamma/beta are fp32; SiLU runs in fp32
before the cast to x's dtype.  The forward returns (y, mean, rstd) with
mean/rstd fp32 [B, G], which the backward takes.

`group_norm` is the differentiable entry: with frozen gamma/beta it runs
the kernels through `GroupNormFunction` (gamma and beta get no gradient,
the JAX package's frozen-affine contract, group_norm.py:12-15); when gamma
or beta requires grad it takes the plain math under autograd, as the JAX
dispatch does.  It never does so because a kernel failed.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel or
raises.  `launches` and `bwd_launches` count kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

SOURCE = "group_norm_fwd.cu"
BWD_SOURCE = "group_norm_bwd.cu"
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

launches = 0
bwd_launches = 0


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
        raise RuntimeError(
            "group_norm_forward keeps no autograd graph on CUDA; call group_norm() "
            "(the differentiable entry) or run under torch.no_grad()"
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


def group_norm_backward_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    eps: float,
    silu: bool,
) -> torch.Tensor:
    """Plain version of the input gradient, written out in fp32 from the
    forward's mean/rstd (eps is carried by rstd):
    dz = dy * s * (1 + z * (1 - s)) through the SiLU (s = sigmoid(z),
    z = x_hat * gamma + beta), dxh = dz * gamma,
    dx = rstd * (dxh - mean_g(dxh) - x_hat * mean_g(dxh * x_hat)),
    cast to dy's dtype."""
    del eps
    b, c = x.shape[:2]
    bcast = (1, c) + (1,) * (x.dim() - 2)
    xh = ((x.float().reshape(b, num_groups, -1) - mean[..., None])
          * rstd[..., None]).reshape(x.shape)
    g = gamma.float().reshape(bcast)
    dz = dy.float()
    if silu:
        z = xh * g + beta.float().reshape(bcast)
        s = torch.sigmoid(z)
        dz = dz * s * (1.0 + z * (1.0 - s))
    dxh = dz * g

    def group_mean(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, num_groups, -1).mean(dim=-1, keepdim=True)

    dx = rstd[..., None] * (dxh.reshape(b, num_groups, -1) - group_mean(dxh)
                            - xh.reshape(b, num_groups, -1) * group_mean(dxh * xh))
    return dx.reshape(x.shape).to(dy.dtype)


def group_norm_backward(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    eps: float,
    silu: bool,
) -> torch.Tensor:
    """Input gradient dx of GroupNorm(+SiLU) at x, from the forward's fp32
    mean/rstd [B, G] and the output gradient dy (x's shape and dtype)."""
    if x.device.type == "cpu":
        return group_norm_backward_reference(x, gamma, beta, mean, rstd, dy, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group norm runs on cuda or cpu, not {x.device}")
    _check(x, gamma, beta, num_groups)
    b = x.shape[0]
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous {x.dtype} {tuple(x.shape)}, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (b, num_groups) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {num_groups}]")
    hw = x[0, 0].numel()
    dx = torch.empty_like(x)
    lib = _build.load(BWD_SOURCE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tb_group_norm_bwd(
            DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            b, x.shape[1], num_groups, hw, int(bool(silu)), stream,
        )
    _build.check(rc, "group_norm_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx


class GroupNormFunction(torch.autograd.Function):
    """y = GroupNorm(+SiLU)(x) through the kernels; the backward gives dx
    only (gamma and beta are frozen)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, silu):
        y, mean, rstd = group_norm_forward(x, gamma, beta, num_groups, eps=eps, silu=silu)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.args = (num_groups, eps, silu)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx = group_norm_backward(x, gamma, beta, mean, rstd, dy.contiguous(), *ctx.args)
        return dx, None, None, None, None, None


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    *,
    eps: float = 1e-5,
    silu: bool = False,
) -> torch.Tensor:
    """Differentiable GroupNorm(+SiLU) over x [B, C, *spatial]."""
    if not torch.is_grad_enabled():
        return group_norm_forward(x, gamma, beta, num_groups, eps=eps, silu=silu)[0]
    if gamma.requires_grad or beta.requires_grad:
        return group_norm_reference(x, gamma, beta, num_groups, eps, silu)[0]
    if x.requires_grad:
        return GroupNormFunction.apply(x, gamma, beta, num_groups, eps, silu)
    return group_norm_forward(x, gamma, beta, num_groups, eps=eps, silu=silu)[0]
