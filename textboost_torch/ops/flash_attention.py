"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

The kernel (`csrc/flash_attention_fwd.cu`) replaces the Pallas TPU kernel
`textboost_tpu/ops/flash_attention.py::_fwd_kernel`.  It reads q/k/v in the
[B, N, H, D] layout through their strides and returns (o, lse): o in the
input dtype, lse fp32 [B, H, N] (natural log), kept for the backward kernel
of a later slice.  Keys at or past `kv_len` are masked inside the kernel.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `launches` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "flash_attention_fwd.cu"
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 512

launches = 0


def supports_flash(n_q: int, n_kv: int, d: int) -> bool:
    """The JAX package's envelope (textboost_tpu/ops/flash_attention.py:246),
    kept so that the dispatch rule sends the same shapes to the kernel."""
    return n_q % 128 == 0 and n_q >= 256 and d <= MAX_HEAD_DIM


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: fp32 softmax(q k^T * scale) v over the first `kv_len`
    keys, cast to q's dtype; lse fp32 [B, H, N]."""
    m = k.shape[1] if kv_len is None else kv_len
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k[:, :m].float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhnm,bmhd->bnhd", p, v[:, :m].float())
    return o.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int) -> None:
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes fp32/fp16/bf16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,N,H,D] and k, v [B,M,H,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if not 0 < kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside (0, {k.shape[1]}]")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim (stride 1)")
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over q [B, N, H, D], k/v [B, M, H, D] -> (o, lse)."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward is not ported yet; run frozen models "
            "under torch.no_grad()/inference_mode()"
        )
    _check(q, k, v, kv_len)
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = _build.load(SOURCE)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tb_flash_attention_fwd(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, n, kv_len, h, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), stream,
        )
    _build.check(rc, "flash_attention_fwd")
    global launches
    launches += 1
    return o, lse
