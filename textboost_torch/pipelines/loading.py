"""Load a trained TextBoost model directory into a sampling pipeline.

Counterpart of textboost_tpu/pipelines/loading.py: base model (a preset
name or a local diffusers snapshot dir) + PEFT text-encoder adapter + the
UNet's cross-attention adapter `unet/` where the run trained one +
textual-inversion token bins, with the TextBoost null-embedding patch
active.  `reuse=` keeps a previous pipeline's base weights resident across
instances of one base model (the eval's sweep over 30 instances); where the
next instance has the same geometry (as many added rows, the same LoRA
shapes: the JAX package's condition for keeping its compiled sampler), its
rows and adapters are copied into the same tensors, so that the
pipeline's sampler graphs (`pipe.graphs`, which the eval sets) keep
serving.  A preset base comes from models/pretrained.py's memo (the JAX
package's `_BASE_CACHE` kept the bundle and its null embedding; here the
memo keeps the bundle, and the null embedding is one forward of its
pristine encoder on the empty prompt).
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
from ..models.layers import LoRALinear
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


def added_rows(model_path: str, checkpoint: Optional[int] = None) -> int:
    """The token rows an instance adds to the vocabulary (its {token}.bin
    files' tokens): instances that add as many share the reused pipeline's
    table, and its sampler graphs (`reuse=`)."""
    if checkpoint is not None:
        model_path = os.path.join(model_path.rstrip("/"), f"checkpoint-{checkpoint}")
    return len(import_token_embeddings(_natural_sorted_bins(model_path)))


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
    reuse: Optional[TextToImagePipeline] = None,
) -> TextToImagePipeline:
    """Load `model_path` (optionally its `checkpoint-N`) over `base_model`
    (a preset name or a diffusers snapshot dir).

    `reuse`: a pipeline returned by an earlier call.  When it was loaded
    with the same base model, ranks (text encoder and UNet adapter), dtype,
    device and null-embedding setting, its base UNet, VAE and text encoder
    stay resident: only this instance's added token rows, text-encoder LoRA
    and UNet LoRA are rebound, in place where the geometry matches (its
    sampler graphs kept), and the same pipeline object is returned.
    Anything else loads anew."""
    dev = resolve_device(device)
    model_path = model_path.rstrip("/")
    if checkpoint is not None:
        model_path = os.path.join(model_path, f"checkpoint-{checkpoint}")
    unet_dir = os.path.join(model_path, "unet")
    has_unet_adapter = os.path.isfile(os.path.join(unet_dir, "adapter_model.safetensors"))
    unet_lora_rank = adapter_rank(unet_dir) if has_unet_adapter else 0
    key = (base_model, lora_rank, unet_lora_rank, dtype, dev, use_null_embedding,
           null_embedding_path)
    tokenizer = load_tokenizer(base_model)
    if reuse is not None and getattr(reuse, "reuse_key", None) == key:
        with torch.no_grad():  # the previous instance's adapters add nothing until replaced
            for mod in reuse.text_encoder.modules():
                if isinstance(mod, LoRALinear) and mod.lora_rank > 0:
                    mod.lora_B.weight.zero_()
        reuse.tokenizer = tokenizer
        if not _bind_instance(reuse, model_path, has_unet_adapter, unet_dir):
            reuse.release_graphs()  # captured over the previous instance's table
        return reuse
    if reuse is not None:
        reuse.release_graphs()

    bundle = load_models(base_model, lora_rank=lora_rank, unet_lora_rank=unet_lora_rank,
                         dtype=dtype, device=dev)
    spec, text_encoder = bundle.spec, bundle.text_encoder
    text_encoder.requires_grad_(False)

    # Null embedding: the frozen, LoRA-less encoder on the empty prompt, on
    # the base vocabulary (before any token or adapter is loaded): the memo's
    # pristine encoder where the bundle came from it.
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
        encoder = text_encoder if bundle.frozen_text_encoder is None else bundle.frozen_text_encoder
        with torch.inference_mode():
            hidden, _ = encoder(torch.from_numpy(ids).to(dev), use_lora=False)
        null_embedding = hidden[0].float().cpu().numpy()

    pipeline = TextToImagePipeline(
        spec, tokenizer, text_encoder, bundle.unet, bundle.vae,
        null_embedding=null_embedding, fixed_special=use_null_embedding, device=dev,
    )
    pipeline.reuse_key = key
    pipeline.base_vocab = text_encoder.token_embedding.weight.shape[0]
    _bind_instance(pipeline, model_path, has_unet_adapter, unet_dir)
    return pipeline


def _bind_instance(pipeline: TextToImagePipeline, model_path: str, has_unet_adapter: bool,
                   unet_dir: str) -> bool:
    """Bind one instance's learned token rows ({token}.bin files, which grow
    the vocabulary), text-encoder LoRA and UNet LoRA onto the pipeline's
    base modules: the adapters in place, the rows into the current table
    in place where the grown vocabulary has its size (else a new table).
    Returns whether every tensor kept its address."""
    text_encoder, tokenizer = pipeline.text_encoder, pipeline.tokenizer
    learned = import_token_embeddings(_natural_sorted_bins(model_path))
    # The base rows and the learned ones, in the table's dtype, where it lies
    # (the rows cast as on the host).
    emb = text_encoder.token_embedding.weight.detach()
    rows = []
    for token, vec in learned.items():
        tokenizer.add_tokens(token)
        rows.append((tokenizer.convert_tokens_to_ids(token), vec))
    grown = emb.new_zeros((len(tokenizer), emb.shape[1]))
    grown[: pipeline.base_vocab] = emb[: pipeline.base_vocab]
    for tid, vec in rows:
        grown[tid] = torch.from_numpy(vec)
    kept = text_encoder.fill_token_embedding(grown)
    if not kept:
        text_encoder.set_token_embedding(grown)

    adapter_dir = os.path.join(model_path, "text_encoder")
    if os.path.isfile(os.path.join(adapter_dir, "adapter_model.safetensors")):
        import_lora_adapter(text_encoder, adapter_dir)
        print("Loaded text encoder LoRA weights")
    if has_unet_adapter:
        import_unet_lora_adapter(pipeline.unet, unet_dir)
        print("Loaded UNet cross-attention LoRA weights")
    return kept
