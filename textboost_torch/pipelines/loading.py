"""Load a trained TextBoost model directory into a sampling pipeline.

Counterpart of textboost_tpu/pipelines/loading.py: base model (a preset
name or a local diffusers snapshot dir) + PEFT text-encoder adapter + the
UNet's cross-attention adapter `unet/` where the run trained one +
textual-inversion token bins, with the TextBoost null-embedding patch
active.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Union

import numpy as np
import torch

from ..data.tokenizer import load_tokenizer
from ..device import resolve_device
from ..lora.peft_io import (
    adapter_rank,
    import_lora_adapter,
    import_token_embeddings,
    import_unet_lora_adapter,
)
from ..models.pretrained import load_models
from ..models.textboost import load_null_embedding_asset
from .text_to_image import TextToImagePipeline


def _natural_sorted_bins(model_path: str):
    """*.bin paths in natural (numeric-aware) order, so that multi-vector
    tokens load in index order (x_10.bin after x_2.bin)."""

    def key(name: str):
        return [int(part) if part.isdigit() else part for part in re.split(r"(\d+)", name)]

    return [
        os.path.join(model_path, f)
        for f in sorted((f for f in os.listdir(model_path) if f.endswith(".bin")), key=key)
    ]


def load_textboost_pipeline(
    model_path: str,
    base_model: str = "sd21base",
    *,
    checkpoint: Optional[int] = None,
    lora_rank: int = 4,
    dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
    use_null_embedding: bool = True,
    null_embedding_path: Optional[str] = None,
) -> TextToImagePipeline:
    """Load `model_path` (optionally its `checkpoint-N`) over `base_model`
    (a preset name or a diffusers snapshot dir)."""
    dev = resolve_device(device)
    model_path = model_path.rstrip("/")
    if checkpoint is not None:
        model_path = os.path.join(model_path, f"checkpoint-{checkpoint}")
    unet_dir = os.path.join(model_path, "unet")
    has_unet_adapter = os.path.isfile(os.path.join(unet_dir, "adapter_model.safetensors"))

    bundle = load_models(base_model, lora_rank=lora_rank,
                         unet_lora_rank=adapter_rank(unet_dir) if has_unet_adapter else 0,
                         dtype=dtype, device=dev)
    spec, text_encoder = bundle.spec, bundle.text_encoder
    text_encoder.requires_grad_(False)
    tokenizer = load_tokenizer(base_model)

    # Null embedding: the frozen, LoRA-less encoder on the empty prompt, on
    # the base vocabulary (before any token or adapter is loaded).
    null_embedding = None
    if null_embedding_path:
        null_embedding = load_null_embedding_asset(
            null_embedding_path,
            (spec.text_encoder.max_position_embeddings, spec.text_encoder.hidden_size),
        )
    elif use_null_embedding:
        ids = np.asarray(
            tokenizer("", padding="max_length", max_length=77, return_tensors="np")["input_ids"],
            np.int64,
        )
        with torch.inference_mode():
            hidden, _ = text_encoder(torch.from_numpy(ids).to(dev), use_lora=False)
        null_embedding = hidden[0].float().cpu().numpy()

    # Learned token embeddings ({token}.bin files) grow the vocabulary.
    learned = import_token_embeddings(_natural_sorted_bins(model_path))
    if learned:
        emb = text_encoder.token_embedding.weight.detach().float().cpu().numpy()
        rows = []
        for token, vec in learned.items():
            tokenizer.add_tokens(token)
            rows.append((tokenizer.convert_tokens_to_ids(token), vec))
        grown = np.zeros((len(tokenizer), emb.shape[1]), np.float32)
        grown[: emb.shape[0]] = emb
        for tid, vec in rows:
            grown[tid] = vec
        text_encoder.set_token_embedding(torch.from_numpy(grown))

    adapter_dir = os.path.join(model_path, "text_encoder")
    if os.path.isfile(os.path.join(adapter_dir, "adapter_model.safetensors")):
        import_lora_adapter(text_encoder, adapter_dir)
        print("Loaded text encoder LoRA weights")
    if has_unet_adapter:
        import_unet_lora_adapter(bundle.unet, unet_dir)
        print("Loaded UNet cross-attention LoRA weights")

    return TextToImagePipeline(
        spec, tokenizer, text_encoder, bundle.unet, bundle.vae,
        null_embedding=null_embedding, fixed_special=use_null_embedding, device=dev,
    )
