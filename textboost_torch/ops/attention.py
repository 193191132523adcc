"""Multi-head attention dispatch: plain torch math or the flash kernel.

Counterpart of textboost_tpu/ops/attention.py.  All attention in the port
(UNet self/cross attention, VAE mid-block, CLIP) goes through
`multi_head_attention` over [batch, seq, heads, head_dim].  The "auto" rule
is the JAX package's (attention.py:80-99, cross-attention off): the flash
kernel serves large unmasked self-attention in half precision on the GPU;
everything else takes the math path, which mirrors `_xla_attention`
(fp32 logits and softmax, probabilities cast to v's dtype) and trains by
plain autograd.  "flash" (the training CLI's `--attention_impl flash`) sends
the kernels exactly the calls the JAX wrapper sends its Pallas kernels,
`supports_flash(n, m, d)` in any of fp32/fp16/bf16, cross-attention over
77 text keys included; a call outside that envelope takes the math path
with its mask and causal flag kept.  (The JAX package's "flash" drops them:
ROADMAP.md C11.)  A flash call with a gradient goes through the forward and
backward kernels (`flash_attention`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, supports_flash

IMPLS = ("auto", "math", "flash")


def use_flash(device_type: str, n: int, m: int, d: int, dtype: torch.dtype,
              masked: bool, causal: bool) -> bool:
    """The "auto" rule: True where the flash kernel serves the call."""
    return (
        device_type == "cuda"
        and not masked
        and not causal
        and n >= 1024
        and m == n
        and dtype in (torch.bfloat16, torch.float16)
        and supports_flash(n, m, d)
    )


def math_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """q [B,N,H,D], k/v [B,M,H,D]; mask broadcastable to [B,H,N,M], True keeps."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Scaled dot-product attention over [B, N, H, D]; returns q's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
    n, m, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = d**-0.5
    if causal:
        if n != m:
            raise ValueError("causal attention requires equal query/key lengths")
        tri = torch.ones((n, m), dtype=torch.bool, device=q.device).tril()[None, None]
        mask = tri if mask is None else torch.logical_and(mask, tri)
    if impl == "auto":
        flash = use_flash(q.device.type, n, m, d, q.dtype, mask is not None, causal)
    else:  # the mask holds the causal triangle by now
        flash = impl == "flash" and mask is None and supports_flash(n, m, d)
    if flash:
        return flash_attention(q, k, v, scale=scale)
    return math_attention(q, k, v, mask, scale).to(q.dtype)
