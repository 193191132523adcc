"""Shared building blocks for the UNet and VAE (NCHW, diffusers key names).

Counterparts of textboost_tpu/models/layers.py.  The numerics follow the JAX
package: UNet downsampling pads symmetrically and the VAE's asymmetrically
(0, 1); Transformer2D and VAE GroupNorms use eps 1e-6 and the UNet resnets
1e-5; LayerNorm eps is 1e-5; GEGLU uses the exact gelu.

Each GroupNorm and attention layer carries an `impl`: "auto" takes the CUDA
kernels (forward, and backward under autograd) where the dispatch rule
sends the call (the plain versions on the CPU), "math" forces plain torch
and its autograd.  `set_impl(model, impl)` sets it for a whole model.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.group_norm import group_norm, group_norm_reference


class GroupNorm(nn.Module):
    """GroupNorm over NCHW channels with fp32 statistics and an optional
    fused SiLU.  Its weight and bias stay fp32 when the module is cast to
    another dtype, as the JAX package keeps them fp32 params."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.impl = "auto"
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for p in (self.weight, self.bias):
            if p.dtype != torch.float32:
                p.data = p.data.float()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "math":
            return group_norm_reference(
                x, self.weight, self.bias, self.num_groups, self.eps, self.silu
            )[0]
        return group_norm(x, self.weight, self.bias, self.num_groups, eps=self.eps,
                          silu=self.silu)


class LoRALinear(nn.Linear):
    """nn.Linear with an optional low-rank adapter branch."""

    def __init__(self, in_features: int, out_features: int, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.lora_rank = lora_rank
        if lora_rank > 0:
            alpha = lora_alpha if lora_alpha is not None else lora_rank
            self.lora_scale = alpha / lora_rank
            self.lora_A = nn.Linear(in_features, lora_rank, bias=False)
            self.lora_B = nn.Linear(lora_rank, out_features, bias=False)

    def _apply(self, fn, recurse=True):
        """Casts and moves the module, but keeps fp32 adapter weights fp32."""
        kept = ([(lin.weight, lin.weight.data) for lin in (self.lora_A, self.lora_B)]
                if self.lora_rank > 0 else [])
        super()._apply(fn, recurse)
        for param, before in kept:
            if before.dtype == torch.float32 and param.dtype != torch.float32:
                param.data = before.to(param.device)
        return self

    def forward(self, x: torch.Tensor, use_lora: bool = True) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_rank > 0 and use_lora:
            a = self.lora_A.weight.to(x.dtype)
            b = self.lora_B.weight.to(x.dtype)
            y = y + F.linear(F.linear(x, a), b) * self.lora_scale
        return y


def set_impl(model: nn.Module, impl: str) -> None:
    """impl "auto" (kernels where the rule sends a call) or "math" (plain
    torch) for every GroupNorm and attention layer of `model`."""
    if impl not in ("auto", "math"):
        raise ValueError(f"impl {impl!r} not in ('auto', 'math')")
    for mod in model.modules():
        if hasattr(mod, "impl"):
            mod.impl = impl


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv3x3 -> (+time) -> GN -> SiLU -> conv3x3 -> +skip."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps, silu=True)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps, silu=True)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv: symmetric padding 1 in the UNet, an explicit
    (0, 1) x (0, 1) pad in the VAE encoder (`asym_pad`)."""

    def __init__(self, channels: int, asym_pad: bool):
        super().__init__()
        self.asym_pad = asym_pad
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if asym_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asym_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """diffusers layout: net.0 = GEGLU, net.1 = (dropout), net.2 = proj."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for mod in self.net:
            x = mod(x)
        return x


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None.
    `kv_lora_rank` > 0 puts LoRA adapters on to_k/to_v (the UNet's
    `--unet_params_to_train crossattn_kv`, on the cross-attentions only)."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 kv_lora_rank: int = 0):
        super().__init__()
        context_dim = context_dim or dim
        self.heads = heads
        self.impl = "auto"
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = LoRALinear(context_dim, dim, kv_lora_rank, bias=False)
        self.to_v = LoRALinear(context_dim, dim, kv_lora_rank, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, n, c = x.shape

        def split(t):
            return t.view(b, t.shape[1], self.heads, c // self.heads)

        out = multi_head_attention(
            split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)), impl=self.impl
        )
        return self.to_out[0](out.reshape(b, n, c))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, kv_lora_rank: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, context_dim, kv_lora_rank)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> N blocks -> proj_out -> +residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, depth: int = 1,
                 use_linear_projection: bool = False, groups: int = 32,
                 kv_lora_rank: int = 0):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, channels)
            self.proj_out = nn.Linear(channels, channels)
        else:
            self.proj_in = nn.Conv2d(channels, channels, 1)
            self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim, kv_lora_rank)
             for _ in range(depth)]
        )

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear_projection:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            x = blk(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return x.contiguous() + residual


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions (VAE mid block)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.impl = "auto"
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = multi_head_attention(
            self.to_q(t)[:, :, None], self.to_k(t)[:, :, None], self.to_v(t)[:, :, None],
            impl=self.impl,
        )[:, :, 0]
        out = self.to_out[0](out)
        return residual + out.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding in fp32 (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
