"""Flash attention: the CUDA kernels' wrappers, their plain versions, and
the autograd Function that joins them.

Forward: `csrc/flash_attention_fwd.cu` replaces the Pallas TPU kernel
`textboost_tpu/ops/flash_attention.py::_fwd_kernel`.  It reads q/k/v in the
[B, N, H, D] layout through their strides and returns (o, lse): o in the
input dtype, lse fp32 [B, H, N] (natural log).  Backward:
`csrc/flash_attention_bwd.cu` replaces `_bwd_fused_kernel` (`_bwd`): from
q, k, v, o, lse and dO it returns (dq, dk, dv) in the input dtype, with P
rebuilt from lse, in two kernels without atomics, so two calls on the same
inputs give the same bits.  Keys at or past `kv_len` are masked inside both
kernels (and get zero gradients); K and V are never padded in memory, so a
cross-attention over 77 text keys reads its 77 rows as they are.

The kernels are written for Hopper (`csrc/hopper.cuh` holds what they
share).  The forward serves bf16/fp16 whose head dim, strides and base
addresses are whole 16-byte chunks with wgmma from a ring of K/V tiles that
a producer warpgroup fills by TMA ("wgmma" for D <= 128, "wgmma_wide" up to
512); fp32, other head dims and unaligned views take its register-tile
variant on the CUDA cores ("cuda_cores", `csrc/flash_tiles.cuh`).  The C
entry point owns that rule and reports its choice; `variant_counts`
records which variant served each launch.

The backward has three variants: "wgmma" for bf16/fp16 whose D <= 128 is a
whole number of 16-byte chunks, "mma" (mma.sync on the tensor cores) for
the other bf16/fp16 calls of the JAX kernel's envelope (128 < D <= 512,
D % 8 != 0, views TMA cannot read, all read in place), and "cuda_cores"
(register tiles) for fp32.  The C entry point owns this rule too: the
wrapper asks it (`tb_flash_attention_bwd_wgmma_form`) whether the wgmma
variant serves the dtype and head dim, and then copies only a view that
variant cannot read.  `bwd_variant_counts` records which served each
launch.

`flash_attention` is the differentiable entry: with a gradient it runs the
kernels through `FlashAttentionFunction`.  Both kernels take what the JAX
kernels take (any dtype of the three, D <= 512); a wider head raises (it
never switches to plain math).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel or
raises.  `launches` and `bwd_launches` count kernel launches.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 512

# The variants, by the code the C entry points report.
VARIANTS = ("cuda_cores", "wgmma", "wgmma_wide")
BWD_VARIANTS = ("cuda_cores", "wgmma", "mma")

launches = 0
bwd_launches = 0
# Launches by the variant that served them.
variant_counts: "collections.Counter[str]" = collections.Counter()
bwd_variant_counts: "collections.Counter[str]" = collections.Counter()


def _chunk_aligned(t: torch.Tensor) -> bool:
    """Whether TMA can read t in place: contiguous head dim, strides in whole
    16-byte chunks, 16-byte aligned base."""
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


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
    keys, cast to q's dtype; lse fp32 [B, H, N].  fp64 inputs are computed
    in fp64 (a reference for the kernels' fp32 form)."""
    m = k.shape[1] if kv_len is None else kv_len
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bnhd,bmhd->bhnm", q.to(acc), k[:, :m].to(acc)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhnm,bmhd->bnhd", p, v[:, :m].to(acc))
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
        raise RuntimeError(
            "flash_attention_forward keeps no autograd graph on CUDA; call "
            "flash_attention() (the differentiable entry) or run under torch.no_grad()"
        )
    _check(q, k, v, kv_len)
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = _build.load(SOURCE)
    variant = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tb_flash_attention_fwd(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, n, kv_len, h, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), stream, ctypes.byref(variant),
        )
    _build.check(rc, "flash_attention_fwd")
    global launches
    launches += 1
    variant_counts[VARIANTS[variant.value]] += 1
    return o, lse


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version in fp32, P rebuilt from lse: P = exp(q k^T * scale -
    lse), dV = P^T dO, dS = P * (dO V^T - rowsum(o * dO)), dK = scale *
    dS^T q, dQ = scale * dS k.  Rows of dk/dv at or past kv_len are zero.
    Returns (dq, dk, dv) in the dtypes of q, k, v.  fp64 inputs are
    computed in fp64 (a reference for the kernel's fp32 form)."""
    m = k.shape[1] if kv_len is None else kv_len
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(acc), k[:, :m].to(acc), v[:, :m].to(acc)
    dof = do.to(acc)
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale - lse.to(acc)[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    delta = (o.to(acc) * dof).sum(-1).transpose(1, 2)  # [B, H, N]
    ds = p * (torch.einsum("bnhd,bmhd->bhnm", dof, vf) - delta[..., None])
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    pad = (0, 0, 0, 0, 0, k.shape[1] - m)  # zero rows for the masked keys
    return (dq.to(q.dtype), torch.nn.functional.pad(dk, pad).to(k.dtype),
            torch.nn.functional.pad(dv, pad).to(v.dtype))


def check_backward_envelope(q: torch.Tensor) -> None:
    """Raise NotImplementedError for a gradient the backward kernel does not
    serve: what the JAX kernel refuses too, a head dim past 512."""
    d = q.shape[-1]
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash attention backward takes D <= {MAX_HEAD_DIM} (the JAX kernel's "
            f"envelope), got D={d}"
        )


def _kernel_ready(t: torch.Tensor, wgmma: bool = True) -> torch.Tensor:
    """t itself when the backward kernel can read it in place, else a
    contiguous copy.  The mma and CUDA-core variants read any strides over
    a contiguous head dim; where the wgmma variant serves the dtype and head
    dim (`wgmma`, as the C entry point reports it), a view whose strides
    are not whole 16-byte chunks or whose base is off a 16-byte boundary is
    copied (a clone: `contiguous()` would hand back a
    dense view whose base is off a boundary as it is)."""
    ok = _chunk_aligned(t) if wgmma else t.stride(-1) == 1
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    scale: float,
    kv_len: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of attention over q [B, N, H, D], k/v
    [B, M, H, D] from the forward's o and lse and the output gradient do.
    `out` (CUDA only), if given, holds (dq, dk, dv) tensors of those shapes
    and q's dtype (any strides over a contiguous head dim) that the kernels
    write into and that are returned."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        if out is not None:
            raise ValueError("out= is for the CUDA kernels; the plain version returns new tensors")
        return flash_attention_backward_reference(q, k, v, o, lse, do, scale, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    check_backward_envelope(q)
    _check(q, k, v, kv_len)
    b, n, h, d = q.shape
    m = k.shape[1]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (b, h, n):
        raise ValueError(f"lse must be fp32 [{b}, {h}, {n}], got {lse.dtype} {tuple(lse.shape)}")
    lib = _build.load(BWD_SOURCE)
    wgmma = bool(lib.tb_flash_attention_bwd_wgmma_form(DTYPE_CODES[q.dtype], d))
    q, k, v, o, do = (_kernel_ready(t, wgmma) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    if out is None:
        dq = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
        dk = torch.empty((b, m, h, d), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
    else:
        dq, dk, dv = out
        for name, t, shape in (("dq", dq, q.shape), ("dk", dk, k.shape), ("dv", dv, k.shape)):
            if (t.shape != shape or t.dtype != q.dtype or t.device != q.device
                    or t.stride(-1) != 1):
                raise ValueError(f"out {name} must be {q.dtype} {tuple(shape)} with a "
                                 f"contiguous head dim, got {t.dtype} {tuple(t.shape)}")
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    variant = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tb_flash_attention_bwd(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, n, m, kv_len, h, d,
            *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]),
            float(scale), stream, ctypes.byref(variant),
        )
    _build.check(rc, "flash_attention_bwd")
    global bwd_launches
    bwd_launches += 1
    bwd_variant_counts[BWD_VARIANTS[variant.value]] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """o = attention(q, k, v) through the forward kernel; the backward kernel
    gives dq, dk, dv from the saved q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len):
        o, lse = flash_attention_forward(q, k, v, scale=scale, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.kv_len = scale, kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, scale=ctx.scale,
                                              kv_len=ctx.kv_len)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable attention over q [B, N, H, D], k/v [B, M, H, D] -> o."""
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention_forward(q, k, v, scale=scale, kv_len=kv_len)[0]
    if q.device.type == "cuda":
        check_backward_envelope(q)
    return FlashAttentionFunction.apply(q, k, v, scale, kv_len)
