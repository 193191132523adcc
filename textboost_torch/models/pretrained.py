"""Model bundles: the three modules of a model family, loaded or seeded, and placed.

Counterpart of textboost_tpu/models/pretrained.py.  A local diffusers
snapshot dir (`model_index.json` layout) loads through
`convert.read_snapshot`, its family taken from the text encoder's width
unless a preset names it.  A preset is filled with a seeded random init that
follows the JAX package's flax initializers: lecun-normal (truncated)
Dense/Conv kernels with zero biases in the UNet and VAE, normal(0.02)
kernels and embeddings in CLIP, LoRA A ~ N(0, 1/r) and B = 0, ones/zeros
norms.  The random numbers come from one `torch.Generator` per component
(seeds seed, seed+1, seed+2), drawn on the target device; the UNet's
cross-attention LoRA, when asked for, draws from its own (seed+7, the JAX
trainer's key for it), after the base weights, so that the frozen UNet is
the same with and without it.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Union

import torch
from torch import nn

from ..device import resolve_device
from ..lora.partition import lora_parameters
from .clip import CLIPTextModel
from .configs import ModelSpec, get_spec
from .convert import read_snapshot, snapshot_family
from .layers import GroupNorm, LoRALinear
from .unet import UNet2DCondition
from .vae import AutoencoderKL

PARTS = ("text_encoder", "unet", "vae")
UNET_LORA_SEED_OFFSET = 7

# std of a standard normal truncated to [-2, 2]; flax's truncated_normal
# divides by it so that the kept samples have the requested stddev.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class ModelBundle:
    spec: ModelSpec
    text_encoder: CLIPTextModel
    unet: UNet2DCondition
    vae: AutoencoderKL


def build_models(spec: ModelSpec, *, lora_rank: int = 0, unet_lora_rank: int = 0,
                 device: Union[str, torch.device] = "meta"):
    """Uninitialised (text_encoder, unet, vae) of `spec` on `device`
    ("meta" allocates nothing)."""
    with torch.device(device):
        return (
            CLIPTextModel(spec.text_encoder, lora_rank=lora_rank),
            UNet2DCondition(spec.unet, cross_lora_rank=unet_lora_rank),
            AutoencoderKL(spec.vae),
        )


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    fan_in = w.shape[1] * (w[0, 0].numel() if w.dim() > 2 else 1)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


def _lora_modules(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, LoRALinear) and m.lora_rank > 0]


@torch.no_grad()
def init_lora_(model: nn.Module, gen: torch.Generator) -> None:
    """LoRA A ~ N(0, 1/r), B = 0 for every adapter of `model`."""
    for mod in _lora_modules(model):
        mod.lora_A.weight.normal_(0.0, 1.0 / mod.lora_rank, generator=gen)
        mod.lora_B.weight.zero_()


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator, *, clip: bool,
                 lora: bool = True) -> None:
    """Seeded init following the flax initializers (see module docstring);
    the LoRA adapters are drawn in line after their base weight, or left to
    `init_lora_` when `lora` is False."""
    adapters = {id(m) for mod in _lora_modules(model) for m in (mod.lora_A, mod.lora_B)}
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
            if lora and isinstance(mod, LoRALinear) and mod.lora_rank > 0:
                init_lora_(mod, gen)


def _load_part(name: str, mod: nn.Module, state_dict) -> None:
    """Copy a snapshot part into `mod`: every key of each side must be on
    the other, but for the LoRA adapters (`lora_parameters`), which no
    snapshot holds."""
    adapters = {id(p) for p in lora_parameters(mod)}
    lora = {key for key, p in mod.named_parameters() if id(p) in adapters}
    missing, unexpected = mod.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if k not in lora]
    if missing or unexpected:
        raise KeyError(f"the snapshot's {name} does not fit the port's: missing {missing[:5]} "
                       f"({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)})")


def load_models(
    model_name_or_path: Optional[str] = None,
    *,
    preset: Optional[str] = None,
    lora_rank: int = 0,
    unet_lora_rank: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    vae_dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> ModelBundle:
    """Diffusers snapshot dir or preset name -> ModelBundle of frozen-ready
    modules in eval mode, on `device`, cast to `dtype` (the VAE to
    `vae_dtype` when given; GroupNorm affines and LoRA adapters stay fp32).
    `preset` names the family of a snapshot in place of the inferred one."""
    dev = resolve_device(device)
    snapshot = None
    if model_name_or_path and os.path.isdir(model_name_or_path):
        if os.path.isfile(os.path.join(model_name_or_path, "spec.json")):
            raise NotImplementedError(
                f"{model_name_or_path}: a textboost_tpu native snapshot (spec.json + msgpack) "
                "needs flax and msgpack, which the card's machine does not have; load a "
                "diffusers snapshot (model_index.json layout) instead")
        if not os.path.isfile(os.path.join(model_name_or_path, "model_index.json")):
            raise FileNotFoundError(f"{model_name_or_path} holds no model_index.json: not a "
                                    "diffusers snapshot")
        snapshot = read_snapshot(model_name_or_path)
        spec = get_spec(preset or snapshot_family(model_name_or_path))
    else:
        spec = get_spec(preset or model_name_or_path or "sd15")
    modules = build_models(spec, lora_rank=lora_rank, unet_lora_rank=unet_lora_rank,
                           device="meta")
    out = []
    for i, (name, mod) in enumerate(zip(PARTS, modules)):
        mod_dtype = vae_dtype if name == "vae" and vae_dtype else dtype
        mod = mod.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        if snapshot is None:
            init_weights(mod, gen, clip=name == "text_encoder", lora=name == "text_encoder")
            mod = mod.to(mod_dtype)
        else:
            mod = mod.to(mod_dtype)  # the copy casts each tensor once, as stored
            _load_part(name, mod, snapshot.pop(name))
            if name == "text_encoder":
                init_lora_(mod, gen)
        if name == "unet":
            init_lora_(mod, torch.Generator(device=dev).manual_seed(seed + UNET_LORA_SEED_OFFSET))
        out.append(mod.eval())
    return ModelBundle(spec, *out)
