// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel textboost_tpu/ops/flash_attention.py::
// _bwd_fused_kernel (launched through _bwd, flash_attention.py:175-218,
// pallas_call at :190).  From q, k, v, the forward's o and lse (natural log,
// fp32) and dO it computes, with P rebuilt from lse instead of stored:
//
//   P = exp(q k^T * scale - lse)        (keys at or past kv_len masked to 0)
//   dV = P^T dO
//   dP = dO V^T,  delta = rowsum(o * dO)   (fp32)
//   dS = P * (dP - delta)
//   dK = scale * dS^T q,   dQ = scale * dS k
//
// Layout: q/o/dO [B, N, H, D] and k/v [B, M, H, D], read in place through
// their strides (head dim contiguous); dq, dk, dv are written contiguous in
// the input dtype, rows of dk/dv at or past kv_len as zeros.
//
// Design: the deterministic two-kernel split.  The TPU kernel runs its grid
// in order on one core, so one fused program per KV block can add into a dq
// output revisited across the "arbitrary" grid axis (5 matmuls per tile
// pair).  On Hopper the CTAs run at once and in no order: that carry does
// not exist, and a fused kernel would need fp32 atomicAdd into dq, whose sum
// order (and so its bits) changes from run to run.  Here:
//   1. flash_bwd_dq_kernel, one CTA of 4 warps per (batch*head, 64 query
//      rows): computes delta for its rows (written to an fp32 [B, H, N]
//      scratch), then streams 64-key K/V tiles and accumulates dQ in fp32
//      registers (S, dP, dQ: 3 matmuls per tile pair), cast once at the end;
//   2. flash_bwd_dkdv_kernel, one CTA of 4 warps per (batch*head, 64 keys),
//      16 keys per warp: streams Q/dO tiles and accumulates dK and dV in
//      fp32 registers (S^T, dP^T, dV, dK: 4 matmuls per tile pair).
// 7 matmuls per tile pair against the fused design's 5, with no atomics and
// bit-identical results from run to run.  All products are mma.sync
// m16n8k16 with fp32 accumulation; P and dS are rounded to the input dtype
// as the A operand of the next product (as FlashAttention-2 does), taken
// straight from the score accumulators.  D is zero-padded to a multiple of
// 16 in shared memory only.
//
// Envelope: bf16/fp16, D <= 128, D and every stride a multiple of 8, 16-byte
// aligned pointers (the wrapper makes contiguous copies of views that are
// not).  That covers every self-attention the "auto" rule sends with a
// gradient (sd15 d = 40, 80; sd21 d = 64).  fp32, D > 128 (the VAE's d = 512,
// which trains no gradient) and D % 8 != 0 are refused: ROADMAP.md queue B.
//
// Bound on the card.  At sd15's shapes (N = M = 4096, D = 40 or 80) the least
// work is 5 products of 2*N*M*D operations per (batch, head), i.e.
// 10*B*H*N^2*D, against 8*N*D elements moved (q, k, v, o, dO in; dq, dk, dv
// out): far above the H100's ~295 operations per byte, so the tensor cores
// bound it.  The split
// does 7 products (1.4x the bound's operations), and mma.sync reaches only a
// part of the rate that wgmma does; what is left to reach the bound: wgmma,
// TMA and a pipelined tile ring (later work).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 64;  // query rows per dQ CTA, 16 per warp
constexpr int kBK = 64;  // keys per dK/dV CTA (16 per warp) and per dQ tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 0-7, 8-15,
// 16-23 and 24-31 give the row addresses of matrices 0-3.  From a row-major
// [row][d] tile this yields the B fragments (k = row, n = d) of two 8-column
// tiles.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  // d += a (16x16, row) * b (16x8, col), fp32 accumulate.
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &v, 4);
    return r;
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &v, 4);
    return r;
  }
  static __device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
};

// Element strides (batch, sequence, head) of the five inputs.
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3];
};

// Stage `rows` rows of a [seq][D] slice (row stride `rs`) into a [rows][QS]
// tile, zero past `valid` rows and past D (16-byte chunks).
template <typename T, int PCH, int QS>
__device__ __forceinline__ void stage(T* dst, const T* src, long long rs, int row0, int rows,
                                      int valid, int dch) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = threadIdx.x; idx < rows * PCH; idx += kThreads) {
    const int r = idx / PCH;
    const int c = idx - r * PCH;
    const int n = row0 + r;
    const uint4 val = (n < valid && c < dch)
                          ? *reinterpret_cast<const uint4*>(src + (long long)n * rs + c * 8)
                          : zero;
    *reinterpret_cast<uint4*>(dst + r * QS + c * 8) = val;
  }
}

// A fragments (16 rows from `row0`, the padded head dim) of a [rows][QS] tile.
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A a0:(g, 2t..2t+1) a1:(g+8, 2t..) a2:(g, 2t+8..) a3:(g+8, 2t+8..)
//   B b0:(k=2t..2t+1, n=g) b1:(k=2t+8.., n=g)
//   C c0,c1:(g, 2t..2t+1) c2,c3:(g+8, 2t..2t+1)
template <typename T, int KD, int QS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KD][4], const T* tile, int row0) {
  const int lane = threadIdx.x & 31;
  const T* p = tile + (row0 + (lane >> 2)) * QS + (lane & 3) * 2;
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
    a[ks][0] = ld32(p + ks * 16);
    a[ks][1] = ld32(p + 8 * QS + ks * 16);
    a[ks][2] = ld32(p + ks * 16 + 8);
    a[ks][3] = ld32(p + 8 * QS + ks * 16 + 8);
  }
}

// c[nt] = A * (rows nt*8.. of `tile`)^T over the padded head dim: the scores
// of the warp's 16 rows against NT*8 rows of the tile.
template <typename T, int KD, int QS, int NT>
__device__ __forceinline__ void rows_dot(float (&c)[NT][4], const uint32_t (&a)[KD][4],
                                         const T* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    const T* r = tile + (nt * 8 + (lane >> 2)) * QS + (lane & 3) * 2;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) Mma<T>::run(c[nt], a[ks], ld32(r + ks * 16), ld32(r + ks * 16 + 8));
  }
}

// acc += X * tile, X [16 x NT*8] from the score accumulators `x` (rounded to
// T), tile [NT*8 rows][padded D] row-major in shared memory.
template <typename T, int ND, int QS, int NT>
__device__ __forceinline__ void acc_times_tile(float (&acc)[ND][4], const float (&x)[NT][4],
                                               const T* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    const uint32_t xa[4] = {
        Mma<T>::pack(x[2 * t][0], x[2 * t][1]), Mma<T>::pack(x[2 * t][2], x[2 * t][3]),
        Mma<T>::pack(x[2 * t + 1][0], x[2 * t + 1][1]),
        Mma<T>::pack(x[2 * t + 1][2], x[2 * t + 1][3])};
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, tile + (t * 16 + (lane & 15)) * QS + (nd + (lane >> 4)) * 8);
      Mma<T>::run(acc[nd], xa, bt[0], bt[1]);
      Mma<T>::run(acc[nd + 1], xa, bt[2], bt[3]);
    }
  }
}

// Write rows row0 + g and row0 + g + 8 of acc * mul as T into a contiguous
// [rows][H][D] output.
template <typename T, int ND>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[ND][4], float mul, int b,
                                           int h, int H, int D, int rows, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = row0 + (lane >> 2) + 8 * i;
    if (n >= rows) continue;
    T* orow = out + (((long long)b * rows + n) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = nd * 8 + (lane & 3) * 2;
      if (d < D)
        *reinterpret_cast<uint32_t*>(orow + d) =
            Mma<T>::pack(acc[nd][2 * i] * mul, acc[nd][2 * i + 1] * mul);
    }
  }
}

template <int KD>
__host__ __device__ constexpr int tile_stride() {
  return KD * 16 + 8;  // +8: conflict-free 32-bit and ldmatrix fragment loads
}

// ---------------------------------------------------------------------------
// 1. delta and dQ, one CTA per (batch*head, 64 query rows).
// ---------------------------------------------------------------------------
template <typename T, int KD>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(float) * 2 * kBQ + sizeof(T) * (size_t)(2 * kBQ + 2 * kBK) * tile_stride<KD>();
}

template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int N, int kv_len, int H, int D, Strides st,
                    float scale) {
  constexpr int DP = KD * 16;
  constexpr int PCH = DP / 8;
  constexpr int ND = DP / 8;
  constexpr int QS = tile_stride<KD>();

  extern __shared__ float4 smem4[];
  float* sL = reinterpret_cast<float*>(smem4);  // [64] lse * log2(e)
  float* sD = sL + kBQ;                         // [64] delta
  T* sQ = reinterpret_cast<T*>(sD + kBQ);       // [64][QS]
  T* sG = sQ + kBQ * QS;                        // [64][QS] dO
  T* sK = sG + kBQ * QS;                        // [64][QS]
  T* sV = sK + kBK * QS;                        // [64][QS]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int dch = D / 8;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* ob = o + b * st.o[0] + h * st.o[2];
  const T* gb = dout + b * st.g[0] + h * st.g[2];

  stage<T, PCH, QS>(sQ, qb, st.q[1], q0, kBQ, N, dch);
  stage<T, PCH, QS>(sG, gb, st.g[1], q0, kBQ, N, dch);
  __syncthreads();

  // delta = rowsum(o * dO) in fp32: warp w takes rows 16w..16w+15.
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int n = q0 + r;
    float part = 0.f;
    if (n < N) {
      const T* orow = ob + (long long)n * st.o[1];
      for (int d = lane; d < D; d += 32)
        part = fmaf(Mma<T>::to_float(orow[d]), Mma<T>::to_float(sG[r * QS + d]), part);
    }
    part = warp_sum(part);
    if (lane == 0) {
      sD[r] = part;
      sL[r] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
      if (n < N) delta[(long long)bh * N + n] = part;
    }
  }
  __syncthreads();

  uint32_t qa[KD][4], ga[KD][4];
  load_a<T, KD, QS>(qa, sQ, warp * 16);
  load_a<T, KD, QS>(ga, sG, warp * 16);
  const int g = lane >> 2;
  const float l2[2] = {sL[warp * 16 + g], sL[warp * 16 + g + 8]};
  const float dl[2] = {sD[warp * 16 + g], sD[warp * 16 + g + 8]};
  const float scale_log2 = scale * kLog2e;

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    stage<T, PCH, QS>(sK, kb, st.k[1], k0, kBK, kv_len, dch);
    stage<T, PCH, QS>(sV, vb, st.v[1], k0, kBK, kv_len, dch);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_dot<T, KD, QS, 8>(s, qa, sK);   // S = Q K^T
    rows_dot<T, KD, QS, 8>(dp, ga, sV);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + (lane & 3) * 2 + (e & 1);
        const int i = e >> 1;
        const float p = key < kv_len ? exp2f(s[nt][e] * scale_log2 - l2[i]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[i]);  // dS
      }
    }
    acc_times_tile<T, ND, QS, 8>(acc, s, sK);  // dQ += dS K
  }
  store_rows<T, ND>(dq, acc, scale, b, h, H, D, N, q0 + warp * 16);
}

// ---------------------------------------------------------------------------
// 2. dK and dV, one CTA per (batch*head, 64 keys).
// ---------------------------------------------------------------------------
template <int KD>
__host__ __device__ constexpr int dkdv_q_tile() {
  return KD <= 5 ? 64 : 32;  // fewer score registers where the accumulators are wide
}

template <typename T, int KD>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * 2 * dkdv_q_tile<KD>() +
         sizeof(T) * (size_t)(2 * kBK + 2 * dkdv_q_tile<KD>()) * tile_stride<KD>();
}

template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int N, int M, int kv_len, int H, int D, Strides st, float scale) {
  constexpr int DP = KD * 16;
  constexpr int PCH = DP / 8;
  constexpr int ND = DP / 8;
  constexpr int QS = tile_stride<KD>();
  constexpr int QT = dkdv_q_tile<KD>();
  constexpr int NT = QT / 8;

  extern __shared__ float4 smem4[];
  float* sL = reinterpret_cast<float*>(smem4);  // [QT] lse * log2(e)
  float* sD = sL + QT;                          // [QT] delta
  T* sK = reinterpret_cast<T*>(sD + QT);        // [64][QS]
  T* sV = sK + kBK * QS;                        // [64][QS]
  T* sQ = sV + kBK * QS;                        // [QT][QS]
  T* sG = sQ + QT * QS;                         // [QT][QS] dO

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kb0 = blockIdx.x * kBK;
  const int dch = D / 8;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* gb = dout + b * st.g[0] + h * st.g[2];

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    dka[nd][0] = dka[nd][1] = dka[nd][2] = dka[nd][3] = 0.f;
    dva[nd][0] = dva[nd][1] = dva[nd][2] = dva[nd][3] = 0.f;
  }

  if (kb0 < kv_len) {  // uniform over the CTA: a block wholly past kv_len writes zeros
    stage<T, PCH, QS>(sK, kb, st.k[1], kb0, kBK, kv_len, dch);
    stage<T, PCH, QS>(sV, vb, st.v[1], kb0, kBK, kv_len, dch);
    __syncthreads();
    uint32_t ka[KD][4], va[KD][4];
    load_a<T, KD, QS>(ka, sK, warp * 16);
    load_a<T, KD, QS>(va, sV, warp * 16);
    const float scale_log2 = scale * kLog2e;
    const int key0 = kb0 + warp * 16 + (lane >> 2);  // this thread's rows: key0, key0 + 8
    const bool kvalid[2] = {key0 < kv_len, key0 + 8 < kv_len};

    for (int q0 = 0; q0 < N; q0 += QT) {
      __syncthreads();  // the previous tile is consumed
      stage<T, PCH, QS>(sQ, qb, st.q[1], q0, QT, N, dch);
      stage<T, PCH, QS>(sG, gb, st.g[1], q0, QT, N, dch);
      for (int r = threadIdx.x; r < QT; r += kThreads) {
        const int n = q0 + r;
        sL[r] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
        sD[r] = n < N ? delta[(long long)bh * N + n] : 0.f;
      }
      __syncthreads();

      float pt[NT][4], dst[NT][4];
      rows_dot<T, KD, QS, NT>(pt, ka, sQ);   // S^T = K Q^T
      rows_dot<T, KD, QS, NT>(dst, va, sG);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + (lane & 3) * 2 + (e & 1);
          const bool ok = kvalid[e >> 1] && q0 + col < N;
          const float p = ok ? exp2f(pt[nt][e] * scale_log2 - sL[col]) : 0.f;
          pt[nt][e] = p;                         // P^T
          dst[nt][e] = p * (dst[nt][e] - sD[col]);  // dS^T
        }
      }
      acc_times_tile<T, ND, QS, NT>(dva, pt, sG);   // dV += P^T dO
      acc_times_tile<T, ND, QS, NT>(dka, dst, sQ);  // dK += dS^T Q
    }
  }
  store_rows<T, ND>(dk, dka, scale, b, h, H, D, M, kb0 + warp * 16);
  store_rows<T, ND>(dv, dva, 1.f, b, h, H, D, M, kb0 + warp * 16);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int KD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int N,
                   int M, int kv_len, int H, int D, const Strides& st, float scale,
                   cudaStream_t stream) {
  auto dq_kernel = flash_bwd_dq_kernel<T, KD>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, KD>;
  const size_t dq_smem = dq_smem_bytes<T, KD>();
  const size_t dkdv_smem = dkdv_smem_bytes<T, KD>();
  cudaError_t err = allow_smem(dq_kernel, dq_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv_kernel, dkdv_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((N + kBQ - 1) / kBQ, B * H), kThreads, dq_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), N,
      kv_len, H, D, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((M + kBK - 1) / kBK, B * H), kThreads, dkdv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, M,
      kv_len, H, D, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_kd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int N, int M, int kv_len, int H, int D,
                        const Strides& st, float scale, cudaStream_t s) {
  const int kd = (D + 15) / 16;
#define TB_LAUNCH(KD) \
  launch<T, KD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, N, M, kv_len, H, D, st, scale, s)
  if (kd <= 2) return TB_LAUNCH(2);
  if (kd <= 3) return TB_LAUNCH(3);
  if (kd <= 4) return TB_LAUNCH(4);
  if (kd <= 5) return TB_LAUNCH(5);
  if (kd <= 6) return TB_LAUNCH(6);
  return TB_LAUNCH(8);
#undef TB_LAUNCH
}

}  // namespace

// dtype: 1 float16, 2 bfloat16.  q, o, dout [B, N, H, D] and k, v [B, M, H, D]
// with element strides (batch, sequence, head) and a contiguous head dim;
// lse fp32 [B, H, N] from the forward; delta an fp32 [B, H, N] scratch the
// call fills; dq [B, N, H, D] and dk, dv [B, M, H, D] contiguous outputs.
// Keys at or past kv_len (<= M) are masked and get zero gradients.
// Returns the first launch error (0 on success).
extern "C" int tb_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, int B, int N,
                                      int M, int kv_len, int H, int D, long long q_sb,
                                      long long q_sn, long long q_sh, long long k_sb,
                                      long long k_sm, long long k_sh, long long v_sb,
                                      long long v_sm, long long v_sh, long long o_sb,
                                      long long o_sn, long long o_sh, long long g_sb,
                                      long long g_sn, long long g_sh, float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || D > 128 || D % 8 != 0 ||
      kv_len <= 0 || kv_len > M || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st = {{q_sb, q_sn, q_sh}, {k_sb, k_sm, k_sh}, {v_sb, v_sm, v_sh},
                      {o_sb, o_sn, o_sh}, {g_sb, g_sn, g_sh}};
  const void* ptrs[5] = {q, k, v, o, dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  const long long strides[15] = {q_sb, q_sn, q_sh, k_sb, k_sm, k_sh, v_sb, v_sm,
                                 v_sh, o_sb, o_sn, o_sh, g_sb, g_sn, g_sh};
  for (long long x : strides)
    if (x % 8) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return (int)dispatch_kd<__half>(q, k, v, o, dout, l, dl, dq, dk, dv, B, N, M, kv_len, H, D,
                                      st, scale, s);
    case 2:
      return (int)dispatch_kd<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, N, M,
                                             kv_len, H, D, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
