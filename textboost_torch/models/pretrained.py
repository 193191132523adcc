"""Model bundles: the three modules of a model family, seeded and placed.

Counterpart of textboost_tpu/models/pretrained.py for presets.  No
pretrained SD weights are available offline, so a preset is filled with a
seeded random init that follows the JAX package's flax initializers:
lecun-normal (truncated) Dense/Conv kernels with zero biases in the UNet and
VAE, normal(0.02) kernels and embeddings in CLIP, LoRA A ~ N(0, 1/r) and
B = 0, ones/zeros norms.  The random numbers come from one
`torch.Generator` per component (seeds seed, seed+1, seed+2), drawn on the
target device.  Loading a local diffusers snapshot is later work.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Union

import torch
from torch import nn

from ..device import resolve_device
from .clip import CLIPTextModel, LoRALinear
from .configs import ModelSpec, get_spec
from .layers import GroupNorm
from .unet import UNet2DCondition
from .vae import AutoencoderKL

# std of a standard normal truncated to [-2, 2]; flax's truncated_normal
# divides by it so that the kept samples have the requested stddev.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class ModelBundle:
    spec: ModelSpec
    text_encoder: CLIPTextModel
    unet: UNet2DCondition
    vae: AutoencoderKL


def build_models(spec: ModelSpec, *, lora_rank: int = 0,
                 device: Union[str, torch.device] = "meta"):
    """Uninitialised (text_encoder, unet, vae) of `spec` on `device`
    ("meta" allocates nothing)."""
    with torch.device(device):
        return (
            CLIPTextModel(spec.text_encoder, lora_rank=lora_rank),
            UNet2DCondition(spec.unet),
            AutoencoderKL(spec.vae),
        )


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    fan_in = w.shape[1] * (w[0, 0].numel() if w.dim() > 2 else 1)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator, *, clip: bool) -> None:
    """Seeded init following the flax initializers (see module docstring)."""
    adapters = {
        id(m) for mod in model.modules()
        if isinstance(mod, LoRALinear) and mod.lora_rank > 0
        for m in (mod.lora_A, mod.lora_B)
    }
    for mod in model.modules():
        if id(mod) in adapters:
            continue  # filled with their LoRALinear below
        if isinstance(mod, (nn.LayerNorm, GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            if clip:
                mod.weight.normal_(0.0, 0.02, generator=gen)
            else:
                _lecun_normal_(mod.weight, gen)
            if mod.bias is not None:
                mod.bias.zero_()
            if isinstance(mod, LoRALinear) and mod.lora_rank > 0:
                mod.lora_A.weight.normal_(0.0, 1.0 / mod.lora_rank, generator=gen)
                mod.lora_B.weight.zero_()


def load_models(
    model_name_or_path: Optional[str] = None,
    *,
    preset: Optional[str] = None,
    lora_rank: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    vae_dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> ModelBundle:
    """Preset name -> ModelBundle of frozen-ready modules in eval mode, on
    `device`, cast to `dtype` (the VAE to `vae_dtype` when given; GroupNorm
    affines and LoRA adapters stay fp32)."""
    if model_name_or_path and os.path.isdir(model_name_or_path):
        raise NotImplementedError(
            f"{model_name_or_path}: loading a local diffusers snapshot is not "
            "ported yet (ROADMAP.md, queue A: diffusers-snapshot loader)"
        )
    dev = resolve_device(device)
    spec = get_spec(preset or model_name_or_path or "sd15")
    modules = build_models(spec, lora_rank=lora_rank, device="meta")
    out = []
    for i, mod in enumerate(modules):
        mod = mod.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        init_weights(mod, gen, clip=i == 0)
        out.append(mod.to(vae_dtype if i == 2 and vae_dtype else dtype).eval())
    return ModelBundle(spec, *out)
