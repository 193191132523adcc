"""CLIP text encoder with LoRA on q/k/v (transformers CLIPTextModel keys).

Counterpart of textboost_tpu/models/clip.py.  The port brings its own
encoder so that it needs no transformers package.  LoRA follows PEFT's
"gaussian" init: y = x W^T + b + (alpha/r) * B(A(x)), A ~ N(0, 1/r), B = 0;
the adapter weights sit beside the base weights as `lora_A.weight`
[r, in] and `lora_B.weight` [out, r].  Causal attention takes the plain
math path (77 tokens).  Returns (last_hidden_state, pooled output at the
first EOS).

Trainable precision follows the JAX package, which keeps every param fp32
and casts it to the compute dtype at use (models/clip.py:56-71,187): the
LoRA weights stay fp32 when the module is cast to another dtype, and they
and the token embedding (fp32 once training grows it) are cast to the
compute dtype, that of the position embedding, where they are used.  AdamW
at the usual learning rates would lose most of its updates on bf16 weights.

The attention, the MLP and the model (its token embedding) carry a `tp`
(parallel/tensor.py): None computes them whole; a `TensorParallel` group,
set by `shard_` on the frozen encoder, runs this rank's heads, its fc1
columns and its vocabulary rows, with the collectives at the boundaries.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..parallel.tensor import copy_to_tp, reduce_from_tp, row_parallel_linear
from .configs import CLIPTextConfig
from .layers import LoRALinear

ACT = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": lambda x: F.gelu(x),
}


def pad_attention_mask(input_ids: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """Bool [B, L] key-padding mask from the ids: True through the first EOS
    (the tokenizer's attention_mask), as
    textboost_tpu/models/clip.py::pad_attention_mask computes it."""
    eos_pos = (input_ids == eos_token_id).int().argmax(dim=-1)
    return torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :] <= eos_pos[:, None]


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, lora_rank: int, lora_alpha: Optional[float],
                 causal: bool = True):
        super().__init__()
        dim = cfg.hidden_size
        self.heads = cfg.num_attention_heads  # this rank's heads when sharded
        self.causal = causal
        self.tp = None
        # LoRA targets q/k/v only; out_proj stays dense.
        self.q_proj = LoRALinear(dim, dim, lora_rank, lora_alpha)
        self.k_proj = LoRALinear(dim, dim, lora_rank, lora_alpha)
        self.v_proj = LoRALinear(dim, dim, lora_rank, lora_alpha)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, use_lora: bool = True,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to_tp(x, self.tp)
        b, n, _ = x.shape

        def split(t):
            return t.view(b, n, self.heads, t.shape[2] // self.heads)

        out = multi_head_attention(
            split(self.q_proj(x, use_lora)),
            split(self.k_proj(x, use_lora)),
            split(self.v_proj(x, use_lora)),
            causal=self.causal,
            # Key-padding mask [B, L] -> [B, 1, 1, L], with the causal one.
            mask=None if attention_mask is None else attention_mask[:, None, None, :],
        ).reshape(b, n, -1)
        if self.tp is None:
            return self.out_proj(out)
        return row_parallel_linear(self.out_proj, out, self.tp)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = ACT[cfg.hidden_act]
        self.tp = None
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.fc2(self.act(self.fc1(x)))
        return row_parallel_linear(self.fc2, self.act(self.fc1(copy_to_tp(x, self.tp))), self.tp)


class CLIPEncoderLayer(nn.Module):
    """One pre-LN transformer layer; causal in the text tower, not in the
    vision tower (eval/clip_scorer.py), which shares it."""

    def __init__(self, cfg: CLIPTextConfig, lora_rank: int, lora_alpha: Optional[float],
                 causal: bool = True):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, lora_rank, lora_alpha, causal)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, use_lora: bool = True,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), use_lora, attention_mask)
        return x + self.mlp(self.layer_norm2(x))


class _Container(nn.Module):
    """Holds submodules under transformers' key names."""


class CLIPTextModel(nn.Module):
    """CLIP text transformer returning (last_hidden_state, pooled_output).

    `vocab_size_override` sizes the token embedding for a vocabulary grown
    by added placeholder tokens; `set_token_embedding` replaces it later."""

    def __init__(self, config: CLIPTextConfig, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None,
                 vocab_size_override: Optional[int] = None):
        super().__init__()
        self.config = cfg = config
        self.lora_rank = lora_rank
        self.tp = None  # with a group: the embedding holds rows [vocab_start, +its rows)
        self.vocab_start = 0
        vocab = vocab_size_override or cfg.vocab_size
        tm = self.text_model = _Container()
        tm.embeddings = _Container()
        tm.embeddings.token_embedding = nn.Embedding(vocab, cfg.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        tm.encoder = _Container()
        tm.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg, lora_rank, lora_alpha) for _ in range(cfg.num_hidden_layers)]
        )
        tm.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    @property
    def token_embedding(self) -> nn.Embedding:
        return self.text_model.embeddings.token_embedding

    def set_token_embedding(self, weight: torch.Tensor, dtype: Optional[torch.dtype] = None) -> None:
        """Replace the token-embedding table (e.g. a grown vocabulary), on
        the current device, in `dtype` (default: the current dtype)."""
        old = self.token_embedding.weight
        emb = nn.Embedding(weight.shape[0], weight.shape[1], device=old.device,
                           dtype=dtype or old.dtype)
        with torch.no_grad():
            emb.weight.copy_(weight)
        emb.weight.requires_grad_(old.requires_grad)
        self.text_model.embeddings.token_embedding = emb

    @torch.no_grad()
    def fill_token_embedding(self, weight: torch.Tensor) -> bool:
        """Copy `weight` into the token-embedding table in place, in the
        table's dtype, when the shapes match: the table keeps its address, so
        a CUDA graph captured over it stays valid.  Returns False, changing
        nothing, when they do not (`set_token_embedding` then)."""
        table = self.token_embedding.weight
        if tuple(weight.shape) != tuple(table.shape):
            return False
        table.copy_(weight)
        return True

    def _embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        emb = self.token_embedding
        if self.tp is None:
            return emb(input_ids)
        # The rows this rank holds; every other id looks up zeros, and the
        # sum over the group holds each id's row once.
        local = input_ids - self.vocab_start
        inside = (local >= 0) & (local < emb.weight.shape[0])
        rows = emb(torch.where(inside, local, torch.zeros_like(local)))
        return reduce_from_tp(torch.where(inside[..., None], rows, torch.zeros_like(rows)),
                              self.tp)

    def forward(self, input_ids: torch.Tensor, use_lora: bool = True,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`attention_mask` [B, L] bool, True keeps a key (`pad_attention_mask`)."""
        tm = self.text_model
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        dtype = tm.embeddings.position_embedding.weight.dtype  # the compute dtype
        hidden = (self._embed_tokens(input_ids).to(dtype)
                  + tm.embeddings.position_embedding(pos))
        for layer in tm.encoder.layers:
            hidden = layer(hidden, use_lora, attention_mask)
        hidden = tm.final_layer_norm(hidden)
        eos_pos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eos_pos]
        return hidden, pooled
