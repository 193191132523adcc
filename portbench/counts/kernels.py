"""The least time one call of each kernel could take on an H100 SXM: the
larger of its operations over the peak rate and its bytes over the memory
bandwidth (NVIDIA's data sheet, dense rates).  Each input is counted read
once and each output written once.

  flash forward, q [B, N, H, D], k/v [B, M, H, D]: reads q, k, v, writes o
    and the fp32 log-sum-exp [B, H, N]; two products of 2 B H N M D
    operations (q k^T, p v).
  flash backward: reads q, k, v, o, dO and the log-sum-exp, writes dq, dk,
    dv; five products (q k^T again, dO v^T, dS k, dS^T q, p^T dO).
  GroupNorm forward over x [B, C, ...]: reads x, gamma, beta, writes y and
    the fp32 mean and rstd [B, G]; about 8 fp32 operations an element.
  GroupNorm backward: reads x, dy, gamma, beta, mean, rstd, writes dx;
    about 20 fp32 operations an element.
The matrix products of 16-bit flash calls run on the tensor cores (989
TFLOP/s); fp32 ones, and GroupNorm's arithmetic, on the CUDA cores (67
TFLOP/s)."""
from __future__ import annotations

import math

PEAK_16BIT = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
GROUPS = 32


def _size(dtype: str) -> int:
    return 4 if dtype.endswith("float32") else 2


def flash_floor_s(b, n, h, d, m, dtype: str, backward: bool) -> float:
    size = _size(dtype)
    q_el, kv_el = b * n * h * d, b * m * h * d
    if backward:
        nbytes = size * (4 * q_el + 4 * kv_el) + 4 * b * h * n
        products = 5
    else:
        nbytes = size * (2 * q_el + 2 * kv_el) + 4 * b * h * n
        products = 2
    ops = products * 2 * b * h * n * m * d
    peak = PEAK_FP32 if size == 4 else PEAK_16BIT
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def group_norm_floor_s(shape, dtype: str, backward: bool, groups: int = GROUPS) -> float:
    b, c = shape[:2]
    numel = math.prod(shape)
    size = _size(dtype)
    stats = 2 * b * groups * 4
    nbytes = (3 if backward else 2) * numel * size + 2 * c * 4 + stats
    ops = (20 if backward else 8) * numel
    return max(ops / PEAK_FP32, nbytes / HBM_BYTES_PER_S)


def floor_s(wrapper: str, key) -> float:
    """The floor of one call recorded under `wrapper` with `key` (program.
    KernelCalls' keys)."""
    if wrapper.startswith("flash"):
        b, n, h, d, m, dtype = key
        return flash_floor_s(b, n, h, d, m, dtype, wrapper == "flash_bwd")
    shape, dtype = key
    return group_norm_floor_s(shape, dtype, wrapper == "gn_bwd")
