"""Trainable parameters, gradient surgery and the optimizer of a TextBoost run.

Counterpart of textboost_tpu/lora/partition.py, over the port's modules
instead of param trees.  Two groups train: the token embedding (at
`emb_learning_rate`) and the LoRA adapters (at `learning_rate`): the text
encoder's, and with `--unet_params_to_train crossattn_kv` the UNet's
cross-attention to_k/to_v adapters too (the JAX package labels both
`lora`, `param_labels` :29-42, and trains `split_lora`'s half of the UNet
beside the text encoder, :168-190); everything else is frozen
(train_textboost.py:829-854).
The surgery of the reference's step (:1109-1150) works on `.grad` and the
weights in place: original-vocab rows get no gradient, the `--mixing` mask
splits lora_B between object and style, the encoder-only clip runs once on
the accumulated gradients, original rows are pinned after the AdamW step,
and added rows are renormalised; of these only the mixing mask, which the
JAX package applies to every lora_b, reaches the UNet's adapters.

optax's `adamw` and torch's `AdamW` give the same update (decoupled decay,
the same bias correction), but torch decays every row of the embedding,
zero-gradient rows included; `pin_original_rows` restores the original
vocabulary exactly after each step, as the JAX step zeroes their updates
(textboost_tpu/train/step.py:239-246, PARITY deviation 4).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch
from torch import nn

from ..models.clip import CLIPTextModel
from ..models.layers import LoRALinear

EMB_LABEL = "embedding"
LORA_LABEL = "lora"
FROZEN_LABEL = "frozen"


def param_labels(text_encoder: CLIPTextModel) -> Dict[str, str]:
    """{parameter name: embedding | lora | frozen} (the JAX label tree)."""

    def label(name: str) -> str:
        if name.endswith("token_embedding.weight"):
            return EMB_LABEL
        if ".lora_A." in name or ".lora_B." in name:
            return LORA_LABEL
        return FROZEN_LABEL

    return {name: label(name) for name, _ in text_encoder.named_parameters()}


def lora_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The A and B weights of every LoRA adapter of `model` (the text
    encoder's q/k/v, or the UNet's cross-attention to_k/to_v)."""
    return [mod.weight for m in model.modules() if isinstance(m, LoRALinear)
            and m.lora_rank > 0 for mod in (m.lora_A, m.lora_B)]


def set_trainable(text_encoder: CLIPTextModel,
                  unet: Optional[nn.Module] = None) -> List[nn.Parameter]:
    """requires_grad on the token embedding and the LoRA adapters only (the
    UNet's adapters too when `unet` is given; the rest of it stays frozen);
    returns the trainable parameters."""
    labels = param_labels(text_encoder)
    params = []
    for name, p in text_encoder.named_parameters():
        p.requires_grad_(labels[name] != FROZEN_LABEL)
        if p.requires_grad:
            params.append(p)
    if unet is not None:
        unet.requires_grad_(False)
        for p in lora_parameters(unet):
            params.append(p.requires_grad_(True))
    return params


def count_params(params: Iterable[torch.Tensor]) -> int:
    return sum(p.numel() for p in params)


@torch.no_grad()
def zero_original_vocab_rows(embedding_grad: torch.Tensor, first_added_id: int) -> None:
    """Only added-token rows learn (train_textboost.py:1109-1117)."""
    embedding_grad[:first_added_id] = 0.0


@torch.no_grad()
def apply_mixing_mask(model: nn.Module, augment_ops: str = "object") -> None:
    """Partition lora_B capacity between object and style
    (train_textboost.py:1119-1126) in every adapter of `model`.  torch
    lora_B.weight is [out, r], so the mask runs over dim 0: object zeroes
    the odd output rows' gradients, style the even ones."""
    start = 1 if augment_ops == "object" else 0
    for m in model.modules():
        if isinstance(m, LoRALinear) and m.lora_rank > 0 and m.lora_B.weight.grad is not None:
            m.lora_B.weight.grad[start::2] = 0.0


@torch.no_grad()
def encoder_grad_norm(params: Iterable[nn.Parameter]) -> torch.Tensor:
    """Global L2 norm of the gradients of `params` (the encoder's LoRA
    adapters: not the embedding), fp32."""
    sq = [p.grad.float().square().sum() for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


@torch.no_grad()
def clip_encoder_grads(params: List[nn.Parameter], max_norm: float) -> torch.Tensor:
    """Clip-by-global-norm of the encoder (LoRA) gradients only, with the
    JAX package's scale min(1, max_norm / max(norm, 1e-12)); returns the
    norm before clipping."""
    gnorm = encoder_grad_norm(params)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(scale.to(p.grad.dtype))
    return gnorm


@torch.no_grad()
def pin_original_rows(embedding: torch.Tensor, original_rows: torch.Tensor) -> None:
    """Restore rows [0, len(original_rows)) of the embedding exactly."""
    embedding[: original_rows.shape[0]] = original_rows


@torch.no_grad()
def renorm_added_embeddings(embedding: torch.Tensor, first_added_id: int,
                            target_norm: torch.Tensor) -> None:
    """Rescale added-token rows to norm <= target (the mean pre-training
    norm), train_textboost.py:1138-1150."""
    added = embedding[first_added_id:]
    norms = torch.linalg.vector_norm(added, dim=-1, keepdim=True)
    added.mul_(torch.minimum(target_norm, norms) / torch.clamp(norms, min=1e-12))


@torch.no_grad()
def added_embedding_norm(embedding: torch.Tensor, first_added_id: int) -> torch.Tensor:
    """Mean norm of the added-token rows (logged as added_embedding_norm)."""
    return torch.linalg.vector_norm(embedding[first_added_id:].float(), dim=-1).mean()


def make_optimizer(
    text_encoder: CLIPTextModel,
    learning_rate: float,
    emb_learning_rate: float,
    *,
    unet: Optional[nn.Module] = None,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 1e-2,
    eps: float = 1e-8,
) -> torch.optim.AdamW:
    """AdamW with two groups: the token embedding at emb_learning_rate and
    the LoRA adapters at learning_rate, the UNet's after the text encoder's
    when `unet` is given (train_textboost.py:829-854).
    Accumulation and the encoder-only clip are the train step's
    (train/step.py), applied before `step()` as optax's MultiSteps and
    chain do."""
    groups = [
        {"params": [text_encoder.token_embedding.weight], "lr": emb_learning_rate},
        {"params": lora_parameters(text_encoder)
                   + (lora_parameters(unet) if unet is not None else []), "lr": learning_rate},
    ]
    return torch.optim.AdamW(groups, betas=(beta1, beta2), eps=eps, weight_decay=weight_decay)


def lr_lambda(name: str, warmup_steps: int, total_steps: int):
    """Multiplier of the base learning rate after `count` updates, for the
    four schedules of `--lr_scheduler` (the optax schedules of
    textboost_tpu/lora/partition.py::lr_schedule)."""

    def ramp(count: int) -> float:  # optax.linear_schedule(0, 1, warmup_steps)
        return min(count, warmup_steps) / warmup_steps if warmup_steps > 0 else 0.0

    if name == "constant":
        return lambda count: 1.0
    if name == "constant_with_warmup":
        return lambda count: ramp(count) if count < warmup_steps else 1.0
    if name == "linear":
        decay = max(total_steps - warmup_steps, 1)
        return lambda count: (ramp(count) if count < warmup_steps
                              else 1.0 - min(count - warmup_steps, decay) / decay)
    if name == "cosine":
        decay = total_steps - warmup_steps
        if decay <= 0:  # optax refuses it too
            raise ValueError(f"the cosine schedule needs total steps ({total_steps}) > "
                             f"warmup steps ({warmup_steps})")

        def cosine(count: int) -> float:
            if count < warmup_steps:
                return ramp(count)
            t = min(count - warmup_steps, decay) / decay
            return 0.5 * (1.0 + math.cos(math.pi * t))

        return cosine
    raise ValueError(f"Unknown lr scheduler: {name}")


def lr_schedule(optimizer: torch.optim.Optimizer, name: str, warmup_steps: int,
                total_steps: int) -> torch.optim.lr_scheduler.LambdaLR:
    """The schedule as a LambdaLR over every group (stepped once per update)."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lr_lambda(name, warmup_steps, total_steps))
