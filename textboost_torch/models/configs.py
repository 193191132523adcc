"""Model configurations for the Stable Diffusion 1.x / 2.x families.

A copy of textboost_tpu/models/configs.py (the port imports nothing from the
JAX package).  Numbers mirror the published SD component configs; the `tiny`
preset gives small random-init models for tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    bos_token_id: int = 49406


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # Per-resolution cross-attention presence: SD uses cross-attn in the
    # first three down blocks (and mirrored up blocks) plus the mid block.
    cross_attention_levels: Tuple[bool, ...] = (True, True, True, False)
    cross_attention_dim: int = 768
    # Per-level number of attention heads (diffusers' attention_head_dim for
    # SD1.x is actually the head *count*; SD2.x lists per-level counts).
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    transformer_layers_per_block: int = 1
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A complete SD model family: text encoder + UNet + VAE + schedule."""

    name: str
    text_encoder: CLIPTextConfig
    unet: UNetConfig
    vae: VAEConfig
    scheduler: SchedulerConfig
    resolution: int = 512
    # HF repo id the weights convert from (informational; zero-egress envs
    # must point --pretrained_model_name_or_path at a local snapshot).
    hf_repo: Optional[str] = None


_SD1X_TEXT = CLIPTextConfig()
_SD2X_TEXT = CLIPTextConfig(
    hidden_size=1024,
    intermediate_size=4096,
    num_hidden_layers=23,
    num_attention_heads=16,
    hidden_act="gelu",
)

_SD1X_UNET = UNetConfig()
_SD2X_UNET = UNetConfig(
    cross_attention_dim=1024,
    num_attention_heads=(5, 10, 20, 20),
    use_linear_projection=True,
)

_VAE = VAEConfig()


SPECS = {
    "sd14": ModelSpec(
        name="sd14",
        text_encoder=_SD1X_TEXT,
        unet=_SD1X_UNET,
        vae=_VAE,
        scheduler=SchedulerConfig(),
        hf_repo="CompVis/stable-diffusion-v1-4",
    ),
    "sd15": ModelSpec(
        name="sd15",
        text_encoder=_SD1X_TEXT,
        unet=_SD1X_UNET,
        vae=_VAE,
        scheduler=SchedulerConfig(),
        hf_repo="runwayml/stable-diffusion-v1-5",
    ),
    "sd21base": ModelSpec(
        name="sd21base",
        text_encoder=_SD2X_TEXT,
        unet=_SD2X_UNET,
        vae=_VAE,
        scheduler=SchedulerConfig(),
        hf_repo="stabilityai/stable-diffusion-2-1-base",
    ),
    "sd21": ModelSpec(
        name="sd21",
        text_encoder=_SD2X_TEXT,
        unet=dataclasses.replace(_SD2X_UNET, sample_size=96),
        vae=_VAE,
        scheduler=SchedulerConfig(prediction_type="v_prediction"),
        resolution=768,
        hf_repo="stabilityai/stable-diffusion-2-1",
    ),
    # Tiny random-init family for tests / offline smoke runs.
    "tiny": ModelSpec(
        name="tiny",
        text_encoder=CLIPTextConfig(
            vocab_size=49408,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
        ),
        unet=UNetConfig(
            sample_size=16,
            block_out_channels=(32, 64, 64, 64),
            layers_per_block=1,
            cross_attention_dim=64,
            num_attention_heads=(2, 2, 2, 2),
        ),
        vae=VAEConfig(
            block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8
        ),
        scheduler=SchedulerConfig(),
        resolution=128,
    ),
}

# Model alias table of the inference CLI.
ALIASES = {
    "sd1.4": "sd14",
    "sd1.5": "sd15",
    "sd2.1": "sd21",
    "sd2.1-base": "sd21base",
    "CompVis/stable-diffusion-v1-4": "sd14",
    "runwayml/stable-diffusion-v1-5": "sd15",
    "stabilityai/stable-diffusion-2-1": "sd21",
    "stabilityai/stable-diffusion-2-1-base": "sd21base",
}


def get_spec(name: str) -> ModelSpec:
    key = ALIASES.get(name, name)
    if key not in SPECS:
        raise ValueError(f"Unknown model spec '{name}'. Available: {sorted(SPECS)}")
    return SPECS[key]
