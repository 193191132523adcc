"""AutoencoderKL: the frozen VAE of the SD family.

Counterpart of textboost_tpu/models/vae.py, NCHW with diffusers'
AutoencoderKL state-dict keys.  Sampling only needs `decode`; the encoder is
kept so that the state dict is whole.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .configs import VAEConfig
from .layers import Downsample, GroupNorm, ResnetBlock, Upsample, VAEAttention


class _Block(nn.Module):
    """Container for one level's resnets / resamplers."""


def _mid_block(c: int, groups: int) -> nn.Module:
    mid = _Block()
    mid.resnets = nn.ModuleList([
        ResnetBlock(c, c, None, groups, eps=1e-6),
        ResnetBlock(c, c, None, groups, eps=1e-6),
    ])
    mid.attentions = nn.ModuleList([VAEAttention(c, groups)])
    return mid


def _run_mid(mid: nn.Module, x: torch.Tensor) -> torch.Tensor:
    x = mid.resnets[0](x)
    x = mid.attentions[0](x)
    return mid.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        c_in = chans[0]
        for level, c_out in enumerate(chans):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock(c_in, c_out, None, g, eps=1e-6))
                c_in = c_out
            if level != len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(c_out, asym_pad=True)])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], eps=1e-6, silu=True)
        self.conv_out = nn.Conv2d(chans[-1], cfg.latent_channels * 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[-1], 3, padding=1)
        self.mid_block = _mid_block(chans[-1], g)
        self.up_blocks = nn.ModuleList()
        c_in = chans[-1]
        for up_idx, level in enumerate(reversed(range(len(chans)))):
            c_out = chans[level]
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(c_in, c_out, None, g, eps=1e-6))
                c_in = c_out
            if up_idx != len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(c_out)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, chans[0], eps=1e-6, silu=True)
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(config.latent_channels * 2, config.latent_channels * 2, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def encode_moments(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels [B,3,H,W] in [-1,1] -> (mean, logvar) of the latent posterior."""
        moments = self.quant_conv(self.encoder(pixels.to(self.quant_conv.weight.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (already divided by scaling_factor) -> pixels in [-1,1]."""
        return self.decoder(self.post_quant_conv(latents.to(self.post_quant_conv.weight.dtype)))
