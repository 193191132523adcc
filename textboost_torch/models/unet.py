"""UNet2DCondition: the frozen denoiser of the SD family.

Counterpart of textboost_tpu/models/unet.py, NCHW with diffusers'
UNet2DConditionModel state-dict keys.  `cross_lora_rank` > 0 puts LoRA
adapters on every cross-attention's to_k/to_v (`--unet_params_to_train
crossattn_kv`).  With `gradient_checkpointing` set, every ResnetBlock and
Transformer2D runs under `torch.utils.checkpoint` while autograd records
(flax `nn.remat` around the same blocks in the JAX package): their
activations are recomputed in the backward instead of kept.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .configs import UNetConfig
from .layers import Downsample, GroupNorm, ResnetBlock, Transformer2D, Upsample, timestep_embedding


class TimestepEmbedding(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, out_channels)
        self.linear_2 = nn.Linear(out_channels, out_channels)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t)))


class _Block(nn.Module):
    """Container for one level's resnets / attentions / resamplers."""


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig, cross_lora_rank: int = 0):
        super().__init__()
        self.config = cfg = config
        self.cross_lora_rank = cross_lora_rank
        self.gradient_checkpointing = False
        chans = cfg.block_out_channels
        ch0 = chans[0]
        temb_dim = ch0 * 4
        groups = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb_dim)

        def make_attn(level: int, c: int) -> Transformer2D:
            return Transformer2D(
                c, cfg.num_attention_heads[level], cfg.cross_attention_dim,
                depth=cfg.transformer_layers_per_block,
                use_linear_projection=cfg.use_linear_projection, groups=groups,
                kv_lora_rank=cross_lora_rank,
            )

        skip_chans = [ch0]
        self.down_blocks = nn.ModuleList()
        c_in = ch0
        for level, c_out in enumerate(chans):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if cfg.cross_attention_levels[level]:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock(c_in, c_out, temb_dim, groups))
                if cfg.cross_attention_levels[level]:
                    blk.attentions.append(make_attn(level, c_out))
                skip_chans.append(c_out)
                c_in = c_out
            if level != len(chans) - 1:
                # downsample_padding=1 (symmetric) in every published SD UNet.
                blk.downsamplers = nn.ModuleList([Downsample(c_out, asym_pad=False)])
                skip_chans.append(c_out)
            self.down_blocks.append(blk)

        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([
            ResnetBlock(chans[-1], chans[-1], temb_dim, groups),
            ResnetBlock(chans[-1], chans[-1], temb_dim, groups),
        ])
        self.mid_block.attentions = nn.ModuleList([make_attn(len(chans) - 1, chans[-1])])

        self.up_blocks = nn.ModuleList()
        c_in = chans[-1]
        for up_idx, level in enumerate(reversed(range(len(chans)))):
            c_out = chans[level]
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if cfg.cross_attention_levels[level]:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(c_in + skip_chans.pop(), c_out, temb_dim, groups))
                if cfg.cross_attention_levels[level]:
                    blk.attentions.append(make_attn(level, c_out))
                c_in = c_out
            if up_idx != len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(c_out)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(groups, ch0, eps=1e-5, silu=True)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def _block(self, block: nn.Module, *args) -> torch.Tensor:
        if self.gradient_checkpointing and torch.is_grad_enabled():
            # No block draws random numbers: no RNG state to keep.
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(
        self,
        sample: torch.Tensor,  # [B, C_in, H, W] noisy latents
        timesteps: torch.Tensor,  # [B] int
        encoder_hidden_states: torch.Tensor,  # [B, T, cross_dim]
    ) -> torch.Tensor:
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        temb = timestep_embedding(
            timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift
        ).to(dtype)
        temb = self.time_embedding(temb)
        ctx = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype))

        skips = [x]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = self._block(res, x, temb)
                if attns is not None:
                    x = self._block(attns[j], x, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = self._block(self.mid_block.resnets[0], x, temb)
        x = self._block(self.mid_block.attentions[0], x, ctx)
        x = self._block(self.mid_block.resnets[1], x, temb)

        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = self._block(res, torch.cat([x, skips.pop()], dim=1), temb)
                if attns is not None:
                    x = self._block(attns[j], x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        return self.conv_out(self.conv_norm_out(x))
