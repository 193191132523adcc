"""CLIP text encoder with LoRA on q/k/v (transformers CLIPTextModel keys).

Counterpart of textboost_tpu/models/clip.py.  The port brings its own
encoder so that it needs no transformers package.  LoRA follows PEFT's
"gaussian" init: y = x W^T + b + (alpha/r) * B(A(x)), A ~ N(0, 1/r), B = 0;
the adapter weights sit beside the base weights as `lora_A.weight`
[r, in] and `lora_B.weight` [out, r].  Causal attention takes the plain
math path (77 tokens).  Returns (last_hidden_state, pooled output at the
first EOS).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from .configs import CLIPTextConfig

ACT = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": lambda x: F.gelu(x),
}


class LoRALinear(nn.Linear):
    """nn.Linear with an optional low-rank adapter branch."""

    def __init__(self, in_features: int, out_features: int, lora_rank: int = 0,
                 lora_alpha: Optional[float] = None, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.lora_rank = lora_rank
        if lora_rank > 0:
            alpha = lora_alpha if lora_alpha is not None else lora_rank
            self.lora_scale = alpha / lora_rank
            self.lora_A = nn.Linear(in_features, lora_rank, bias=False)
            self.lora_B = nn.Linear(lora_rank, out_features, bias=False)

    def forward(self, x: torch.Tensor, use_lora: bool = True) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_rank > 0 and use_lora:
            y = y + self.lora_B(self.lora_A(x)) * self.lora_scale
        return y


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, lora_rank: int, lora_alpha: Optional[float]):
        super().__init__()
        dim = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        # LoRA targets q/k/v only; out_proj stays dense.
        self.q_proj = LoRALinear(dim, dim, lora_rank, lora_alpha)
        self.k_proj = LoRALinear(dim, dim, lora_rank, lora_alpha)
        self.v_proj = LoRALinear(dim, dim, lora_rank, lora_alpha)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, use_lora: bool = True) -> torch.Tensor:
        b, n, c = x.shape

        def split(t):
            return t.view(b, n, self.heads, c // self.heads)

        out = multi_head_attention(
            split(self.q_proj(x, use_lora)),
            split(self.k_proj(x, use_lora)),
            split(self.v_proj(x, use_lora)),
            causal=True,
        )
        return self.out_proj(out.reshape(b, n, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = ACT[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, lora_rank: int, lora_alpha: Optional[float]):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, lora_rank, lora_alpha)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, use_lora: bool = True) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), use_lora)
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

    def set_token_embedding(self, weight: torch.Tensor) -> None:
        """Replace the token-embedding table (e.g. a grown vocabulary),
        keeping the current dtype and device."""
        old = self.token_embedding.weight
        emb = nn.Embedding(weight.shape[0], weight.shape[1], device=old.device, dtype=old.dtype)
        with torch.no_grad():
            emb.weight.copy_(weight)
        emb.weight.requires_grad_(old.requires_grad)
        self.text_model.embeddings.token_embedding = emb

    def forward(self, input_ids: torch.Tensor,
                use_lora: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        tm = self.text_model
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        hidden = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)
        for layer in tm.encoder.layers:
            hidden = layer(hidden, use_lora)
        hidden = tm.final_layer_norm(hidden)
        eos_pos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eos_pos]
        return hidden, pooled
