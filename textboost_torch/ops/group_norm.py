"""GroupNorm(+SiLU): the CUDA kernels' wrappers, their plain versions, and
the autograd Function that joins them.

Forward: `csrc/group_norm_fwd.cu` replaces the Pallas TPU kernel
`textboost_tpu/ops/group_norm.py::_fwd_kernel`.  Backward (input gradient
only): `csrc/group_norm_bwd.cu` replaces `_bwd_kernel` (`_run_bwd` and the
VJP `_fused_gn_bwd`).  The layout is NCHW-contiguous ([B, C, *spatial]):
each (sample, group) is one contiguous span.  Statistics are fp32 from one
pass with the variance clamped at 0; gamma/beta are fp32; SiLU runs in fp32
before the cast to x's dtype.  The forward returns (y, mean, rstd) with
mean/rstd fp32 [B, G], which the backward takes.

`group_norm` is the differentiable entry: with frozen gamma/beta it runs
the kernels through `GroupNormFunction` (gamma and beta get no gradient,
the JAX package's frozen-affine contract, group_norm.py:12-15); when gamma
or beta requires grad it takes the plain math under autograd, as the JAX
dispatch does.  It never does so because a kernel failed.

Both kernels cover each span with one thread-block cluster and read it
from device memory once (`csrc/group_norm.cuh`); `plan_group_norm` chooses
the cluster, and the wrappers pass its fields to the C entry points, which
check them.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel or
raises.  `launches` and `bwd_launches` count kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from . import _build

SOURCE = "group_norm_fwd.cu"
BWD_SOURCE = "group_norm_bwd.cu"
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# Limits of csrc/group_norm.cuh (gn::kSmemBytes, kMaxCluster, kMaxThreads,
# kPieceBytes).
SMEM_BYTES = 231424  # dynamic shared memory per CTA: 227 KB less 1 KB
MAX_CLUSTER = 16
MAX_THREADS = 512
PIECE_BYTES = 16384  # one bulk copy
REGS = (1, 2, 4)  # gn::kRegs: 16-byte vectors a thread holds in registers, per tensor
REG_VECTORS = 4  # at most this many 16-byte vectors of data a thread holds in registers
# A span is split over more CTAs while a CTA would hold more than
# CTA_TARGET_BYTES of it (two such CTAs share an SM); and, down to
# MIN_CTA_BYTES a CTA, while the launch would have fewer than MIN_CTAS
# CTAs (about two per SM).
CTA_TARGET_BYTES = 80 * 1024
MIN_CTA_BYTES = 8 * 1024
MIN_CTAS = 256

launches = 0
bwd_launches = 0
_max_cluster: Dict[str, int] = {}


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """How a kernel covers one (sample, group) span of `span` elements: a
    thread-block cluster of `cluster` CTAs of `threads` threads.  CTA r takes
    the elements [r*chunk, min((r+1)*chunk, span)).  With `regs` > 0 each
    thread holds `regs` 16-byte vectors of the chunk (of each of its
    `tensors` inputs) in registers; else the CTA holds the first `resident`
    elements in `smem_bytes` of shared memory, and the rest, if any, is
    streamed: read for the sums and read again for the output.  `vector`:
    16-byte loads, bulk copies and stores (HW * elem_bytes % 16 == 0 and
    16-byte aligned tensors; the C side checks both), else element by
    element."""

    span: int
    elem_bytes: int
    tensors: int  # 1: x (forward); 2: x and dy (backward)
    cluster: int
    chunk: int
    resident: int
    threads: int
    smem_bytes: int
    vector: bool
    regs: int = 0

    @property
    def streamed(self) -> bool:
        return self.resident < self.chunk

    def chunks(self) -> List[Tuple[int, int]]:
        """(first element, length) of each rank's chunk of the span."""
        return [(r * self.chunk, min(self.chunk, self.span - r * self.chunk))
                for r in range(self.cluster)]

    def bulk_copies(self, rank: int) -> List[Tuple[int, int]]:
        """(byte offset in the span, bytes) of the copies of one tensor
        that CTA `rank` issues (none in registers or without `vector`)."""
        if self.regs or not self.vector:
            return []
        start, n = self.chunks()[rank]
        total = min(self.resident, n) * self.elem_bytes
        return [(start * self.elem_bytes + off, min(PIECE_BYTES, total - off))
                for off in range(0, total, PIECE_BYTES)]

    def launch_args(self) -> Tuple[int, int, int, int, int, int, int]:
        return (self.cluster, self.chunk, self.resident, self.threads, self.smem_bytes,
                self.regs, int(self.vector))

    def reread_bytes(self, batch: int, groups: int) -> int:
        """Bytes of x (and dy) that one launch reads a second time by design:
        each CTA's streamed remainder (0 for a resident span).  Arithmetic of
        the plan, not a measurement."""
        reread = sum(max(0, n - self.resident) for _, n in self.chunks())
        return batch * groups * self.tensors * reread * self.elem_bytes


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def split_span(span: int, elem_bytes: int, tensors: int, vector: bool,
               cluster: int, registers: bool = True) -> GroupNormPlan:
    """The plan that splits a span over `cluster` CTAs: equal chunks, a
    multiple of the 16-byte vector when `vector` (the last chunk takes
    what is left), held in registers where a 16-bit chunk fits in
    REG_VECTORS vectors a thread (small chunks: no copy, no shared
    memory) unless not `registers`, else in shared memory as far as it
    fits."""
    vec = 16 // elem_bytes if vector else 1
    chunk = _round_up(-(-span // cluster), vec)
    if chunk * (cluster - 1) >= span:
        raise ValueError(f"a span of {span} elements leaves a CTA empty over {cluster} CTAs")
    plan = functools.partial(GroupNormPlan, span=span, elem_bytes=elem_bytes, tensors=tensors,
                             cluster=cluster, chunk=chunk, vector=vector)
    vectors = -(-chunk // vec)
    if registers and vector and elem_bytes == 2:
        for regs in REGS:
            if regs * tensors <= REG_VECTORS and vectors <= regs * MAX_THREADS:
                return plan(resident=chunk, threads=_round_up(-(-vectors // regs), 32),
                            smem_bytes=0, regs=regs)
    resident = min(chunk, (SMEM_BYTES // tensors // 16 * 16) // elem_bytes // vec * vec)
    return plan(resident=resident,
                threads=min(MAX_THREADS, max(128, 1 << max(0, (vectors - 1).bit_length()))),
                smem_bytes=_round_up(resident * elem_bytes, 16) * tensors)


@functools.lru_cache(maxsize=None)
def plan_group_norm(batch: int, channels: int, groups: int, hw: int, dtype: torch.dtype,
                    backward: bool, max_cluster: int, aligned: bool = True) -> GroupNormPlan:
    """The launch plan of the forward (or, `backward`, the input-gradient)
    kernel over x [batch, channels, hw] in `dtype`, with clusters of at most
    `max_cluster` CTAs (what the card admits: `max_cluster_of`); `aligned`:
    every tensor the kernel reads or writes starts on 16 bytes.  Cached: the
    wrappers ask for it at every launch."""
    elem = torch.empty((), dtype=dtype).element_size()
    span = channels // groups * hw
    tensors = 2 if backward else 1
    span_bytes = span * elem * tensors
    cluster = 1
    while cluster < min(max_cluster, MAX_CLUSTER) and (
            span_bytes > cluster * CTA_TARGET_BYTES
            or (batch * groups * cluster < MIN_CTAS
                and span_bytes >= 2 * cluster * MIN_CTA_BYTES)):
        cluster *= 2
    return split_span(span, elem, tensors, aligned and hw * elem % 16 == 0, cluster)


def active_clusters(source: str, cluster: int, threads: int, smem_bytes: int) -> int:
    """How many clusters of `cluster` CTAs of `source`'s kernel, each with
    `threads` threads and `smem_bytes` of shared memory, the card holds at
    once (0: it cannot schedule one)."""
    out = ctypes.c_int(0)
    name = source.rsplit(".", 1)[0]
    fn = getattr(_build.load(source), f"tb_{name}_active_clusters")
    _build.check(fn(cluster, threads, smem_bytes, ctypes.byref(out)), f"{name} cluster query")
    return out.value


def max_cluster_of(source: str) -> int:
    """The largest cluster size (16, 8, ...) at which the card can schedule
    `source`'s kernel with the plan's largest CTA; asked of the card once
    per process.  Raises if it can schedule none."""
    k = _max_cluster.get(source)
    if k is None:
        k = MAX_CLUSTER
        while k >= 1 and active_clusters(source, k, MAX_THREADS, SMEM_BYTES) < 1:
            k //= 2
        if k < 1:
            raise RuntimeError(f"the card can schedule no cluster of {source}'s kernel")
        _max_cluster[source] = k
    return k


def group_norm_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float,
    silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: one-pass fp32 statistics over [B, G, (C/G)*spatial],
    affine and optional SiLU in fp32, cast to x's dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1)
    var = ((xf * xf).mean(dim=-1) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    bcast = (1, c) + (1,) * (x.dim() - 2)
    y = y * gamma.float().reshape(bcast) + beta.float().reshape(bcast)
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype), mean, rstd


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"group norm takes fp32/fp16/bf16 x, got {x.dtype}")
    if x.dim() < 3:
        raise ValueError(f"expected x [B, C, *spatial], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("group norm kernel takes an NCHW-contiguous x")
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"C={c} is not divisible by G={num_groups}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{c}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x[0].numel() // num_groups >= 2**31:
        raise ValueError("a (sample, group) span exceeds 2^31 elements")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def group_norm_forward(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    *,
    eps: float = 1e-5,
    silu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm over x [B, C, *spatial] -> (y, mean, rstd)."""
    grads = torch.is_grad_enabled() and (
        x.requires_grad or gamma.requires_grad or beta.requires_grad
    )
    if x.device.type == "cpu":
        return group_norm_reference(x, gamma, beta, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group norm runs on cuda or cpu, not {x.device}")
    if grads:
        raise RuntimeError(
            "group_norm_forward keeps no autograd graph on CUDA; call group_norm() "
            "(the differentiable entry) or run under torch.no_grad()"
        )
    _check(x, gamma, beta, num_groups)
    b, c = x.shape[:2]
    hw = x[0, 0].numel()
    y = torch.empty_like(x)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    lib = _build.load(SOURCE)
    with torch.cuda.device(x.device):
        plan = plan_group_norm(b, c, num_groups, hw, x.dtype, False, max_cluster_of(SOURCE),
                               aligned=_aligned(x, y))
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tb_group_norm_fwd(
            DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            b, c, num_groups, hw, float(eps), int(bool(silu)), *plan.launch_args(), stream,
        )
    _build.check(rc, "group_norm_fwd")
    global launches
    launches += 1
    return y, mean, rstd


def group_norm_backward_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    eps: float,
    silu: bool,
) -> torch.Tensor:
    """Plain version of the input gradient, written out in fp32 from the
    forward's mean/rstd (eps is carried by rstd):
    dz = dy * s * (1 + z * (1 - s)) through the SiLU (s = sigmoid(z),
    z = x_hat * gamma + beta), dxh = dz * gamma,
    dx = rstd * (dxh - mean_g(dxh) - x_hat * mean_g(dxh * x_hat)),
    cast to dy's dtype."""
    del eps
    b, c = x.shape[:2]
    bcast = (1, c) + (1,) * (x.dim() - 2)
    xh = ((x.float().reshape(b, num_groups, -1) - mean[..., None])
          * rstd[..., None]).reshape(x.shape)
    g = gamma.float().reshape(bcast)
    dz = dy.float()
    if silu:
        z = xh * g + beta.float().reshape(bcast)
        s = torch.sigmoid(z)
        dz = dz * s * (1.0 + z * (1.0 - s))
    dxh = dz * g

    def group_mean(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, num_groups, -1).mean(dim=-1, keepdim=True)

    dx = rstd[..., None] * (dxh.reshape(b, num_groups, -1) - group_mean(dxh)
                            - xh.reshape(b, num_groups, -1) * group_mean(dxh * xh))
    return dx.reshape(x.shape).to(dy.dtype)


def group_norm_backward(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    eps: float,
    silu: bool,
) -> torch.Tensor:
    """Input gradient dx of GroupNorm(+SiLU) at x, from the forward's fp32
    mean/rstd [B, G] and the output gradient dy (x's shape and dtype)."""
    if x.device.type == "cpu":
        return group_norm_backward_reference(x, gamma, beta, mean, rstd, dy, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group norm runs on cuda or cpu, not {x.device}")
    _check(x, gamma, beta, num_groups)
    b = x.shape[0]
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous {x.dtype} {tuple(x.shape)}, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (b, num_groups) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {num_groups}]")
    hw = x[0, 0].numel()
    dx = torch.empty_like(x)
    lib = _build.load(BWD_SOURCE)
    with torch.cuda.device(x.device):
        plan = plan_group_norm(b, x.shape[1], num_groups, hw, x.dtype, True,
                               max_cluster_of(BWD_SOURCE), aligned=_aligned(x, dy, dx))
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tb_group_norm_bwd(
            DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            b, x.shape[1], num_groups, hw, int(bool(silu)), *plan.launch_args(), stream,
        )
    _build.check(rc, "group_norm_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx


class GroupNormFunction(torch.autograd.Function):
    """y = GroupNorm(+SiLU)(x) through the kernels; the backward gives dx
    only (gamma and beta are frozen)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, silu):
        y, mean, rstd = group_norm_forward(x, gamma, beta, num_groups, eps=eps, silu=silu)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.args = (num_groups, eps, silu)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx = group_norm_backward(x, gamma, beta, mean, rstd, dy.contiguous(), *ctx.args)
        return dx, None, None, None, None, None


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    *,
    eps: float = 1e-5,
    silu: bool = False,
) -> torch.Tensor:
    """Differentiable GroupNorm(+SiLU) over x [B, C, *spatial]."""
    if not torch.is_grad_enabled():
        return group_norm_forward(x, gamma, beta, num_groups, eps=eps, silu=silu)[0]
    if gamma.requires_grad or beta.requires_grad:
        return group_norm_reference(x, gamma, beta, num_groups, eps, silu)[0]
    if x.requires_grad:
        return GroupNormFunction.apply(x, gamma, beta, num_groups, eps, silu)
    return group_norm_forward(x, gamma, beta, num_groups, eps=eps, silu=silu)[0]
