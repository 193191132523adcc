"""Token surgery: placeholder-token injection + embedding-matrix growth.

A copy of textboost_tpu/tokens/surgery.py, which imports no JAX (the port
imports nothing from the JAX package).  Counterpart of the reference's
`add_token` / `add_augmentation_tokens` (textboost/utils.py:117-214):
host-side numpy ops on the tokenizer and the embedding matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Reference augmentation-token banks (utils.py:177-200).  Initializers
# "ktn"/"pll"/"ucd" are the rare tokens from Custom Diffusion.
OBJECT_AUGMENTATIONS = {
    "<grayscale>": "grayscale",
    "<zoom-in>": "zoom in",
    "<zoom-out>": "far away",
    "<collage>": "photo collage",
    "<crop>": "crop",
    "<hflip>": "ktn",
    "<left>": "pll",
    "<right>": "ucd",
}
STYLE_AUGMENTATIONS = {"<hflip>": "ktn"}


@dataclasses.dataclass
class TokenSurgeryResult:
    embedding: np.ndarray  # grown [vocab + added, hidden] matrix
    placeholder_tokens: List[str]
    placeholder_token_ids: List[int]


def expand_placeholder(placeholder_token: str, num_vectors: int) -> List[str]:
    """Multi-vector expansion: "<x>" -> ["<x_0>", "<x_1>", ...]
    (utils.py:131-141)."""
    if num_vectors <= 1:
        return [placeholder_token]
    if placeholder_token.endswith(">"):
        return [f"{placeholder_token[:-1]}_{i}>" for i in range(num_vectors)]
    return [placeholder_token] + [
        f"{placeholder_token}_{i}" for i in range(1, num_vectors)
    ]


def plan_token_addition(
    tokenizer, placeholder_token: str, initializer_token: str
) -> Tuple[List[str], List[int], List[int]]:
    """Tokenizer-side half of add_token: registers the placeholder tokens
    and returns (placeholder_tokens, placeholder_ids, initializer_ids)
    WITHOUT touching the embedding matrix.  Lets the trainer grow the
    matrix on-device in one op instead of round-tripping the ~150 MB
    matrix over the host<->device link (utils.py:117-166 semantics)."""
    initializer_ids = tokenizer.encode(initializer_token, add_special_tokens=False)
    num_vectors = len(initializer_ids)
    placeholder_tokens = expand_placeholder(placeholder_token, num_vectors)

    num_added = tokenizer.add_tokens(placeholder_tokens)
    if num_added != num_vectors:
        raise ValueError(
            f"The tokenizer already contains the token {placeholder_token}. "
            "Please pass a different placeholder_token."
        )
    placeholder_ids = tokenizer.convert_tokens_to_ids(placeholder_tokens)
    return placeholder_tokens, list(placeholder_ids), list(initializer_ids)


def add_token(
    embedding: np.ndarray,
    tokenizer,
    placeholder_token: str,
    initializer_token: str,
) -> TokenSurgeryResult:
    """Add placeholder token(s) initialized from the initializer's embeddings.

    One placeholder per initializer sub-token; new embedding rows are copies
    of the initializer-token rows (utils.py:117-166).
    """
    placeholder_tokens, placeholder_ids, initializer_ids = plan_token_addition(
        tokenizer, placeholder_token, initializer_token
    )
    new_vocab = len(tokenizer)
    hidden = embedding.shape[1]
    grown = np.zeros((new_vocab, hidden), dtype=embedding.dtype)
    grown[: embedding.shape[0]] = embedding
    for pid, iid in zip(placeholder_ids, initializer_ids):
        grown[pid] = embedding[iid]
    return TokenSurgeryResult(grown, placeholder_tokens, placeholder_ids)


def add_augmentation_tokens(
    embedding: np.ndarray,
    tokenizer,
    aug_type: str = "object",
) -> Tuple[np.ndarray, List[int], Dict[str, int], Dict[str, str]]:
    """Install the augmentation-token bank (utils.py:169-214).

    Returns (embedding, aug_token_ids, aug_token_dict, caption_map) where
    caption_map maps the base placeholder ("<zoom-in>") to the caption
    fragment made of the actual placeholders ("<zoom-in_0> <zoom-in_1>"),
    so augmentation captions stay correct for any tokenizer's sub-token
    split (the reference hardcodes the CLIP-BPE splits in
    paired_augmentation.py).
    """
    if aug_type not in ("object", "style"):
        raise ValueError(
            f"aug_type must be either 'object' or 'style', but is {aug_type}"
        )
    bank = OBJECT_AUGMENTATIONS if aug_type == "object" else STYLE_AUGMENTATIONS

    aug_token_ids: List[int] = []
    aug_token_dict: Dict[str, int] = {}
    caption_map: Dict[str, str] = {}
    for placeholder, initializer in bank.items():
        result = add_token(embedding, tokenizer, placeholder, initializer)
        embedding = result.embedding
        aug_token_ids += result.placeholder_token_ids
        for tok, tid in zip(result.placeholder_tokens, result.placeholder_token_ids):
            aug_token_dict[tok] = tid
        caption_map[placeholder] = " ".join(result.placeholder_tokens)
    return embedding, aug_token_ids, aug_token_dict, caption_map


def concept_tokens_for_prompt(placeholder_tokens: Sequence[str]) -> str:
    """Multi-vector identifier as used in prompts: '<x_0> <x_1> ...'."""
    return " ".join(placeholder_tokens)


def embedding_norm_stats(
    embedding: np.ndarray, first_added_id: int
) -> Tuple[float, float]:
    """(max_norm, mean_norm) over pre-training embedding rows.

    Reference scans rows [0, min(added_ids)-2) for the max (excluding the
    BOS/EOS rows just before the added block) and takes the mean over the
    full matrix (train_textboost.py:1003-1021).
    """
    norms = np.linalg.norm(embedding, axis=-1)
    max_norm = float(norms[: max(first_added_id - 2, 1)].max())
    mean_norm = float(norms.mean())
    return max_norm, mean_norm
