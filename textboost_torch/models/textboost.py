"""TextBoost text-encoder semantics: null-embedding and fixed-BOS patching.

Counterpart of textboost_tpu/models/textboost.py: after the CLIP forward,
rows whose second token is EOS (the empty prompt) have their whole output
replaced by a cached frozen-encoder null embedding, and in fixed-special
mode position 0 (the BOS output) of every row is pinned to
null_embedding[0].
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def load_null_embedding_asset(
    path: str, expected_shape: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Load a cached embedding asset: a fp32 [77, hidden] torch tensor
    (null_emb_*.pt / start_emb_*.pt)."""
    tensor = torch.load(path, map_location="cpu", weights_only=True)
    arr = np.asarray(tensor.float().numpy(), np.float32)
    if expected_shape is not None and tuple(arr.shape) != tuple(expected_shape):
        raise ValueError(
            f"embedding asset {path} has shape {arr.shape}, "
            f"expected {tuple(expected_shape)} for this model family"
        )
    return arr


def apply_null_embedding_patch(
    hidden: torch.Tensor,  # [B, T, H] last hidden state
    input_ids: torch.Tensor,  # [B, T]
    null_embedding: Optional[torch.Tensor],  # [T, H] or None
    eos_token_id: int = 49407,
    fixed_special: bool = True,
) -> torch.Tensor:
    if null_embedding is None:
        return hidden
    null_embedding = null_embedding.to(device=hidden.device, dtype=hidden.dtype)
    is_null = (input_ids[:, 1] == eos_token_id)[:, None, None]
    hidden = torch.where(is_null, null_embedding[None], hidden)
    if fixed_special:
        bos = null_embedding[0].expand(hidden.shape[0], 1, hidden.shape[2])
        hidden = torch.cat([bos, hidden[:, 1:]], dim=1)
    return hidden
