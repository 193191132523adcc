// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel textboost_tpu/ops/flash_attention.py::_fwd_kernel
// (launched through _fwd, pallas_call at flash_attention.py:85): non-causal
// softmax(q k^T * scale) v with an online softmax streamed over K/V tiles,
// fp32 accumulation, output in the input dtype, and the per-row logsumexp
// (natural log) kept for the backward pass.
//
// Layout: q [B, N, H, D], k/v [B, M, H, D] read in place through their strides
// (the head dim must be contiguous), so the transpose and pad copies the TPU
// wrapper makes (flash_attention.py:301-308) are gone.  o is written
// contiguous [B, N, H, D]; lse is fp32 [B, H, N].  Keys at or past M and head
// columns at or past D are masked here: nothing is padded in device memory.
//
// Bound on the card.  At the sd15 shapes (N = M = 4096, D = 40 or 80) the
// work is 4*N*M*D operations per (batch, head) against 2*(N+2M)*D bytes, far
// above the H100's ~295 operations per byte: the kernel is bound by
// operations, i.e. by the tensor cores.
//
// Two variants share the entry point.
//
// Tensor cores (bf16/fp16, D <= 512, D and the strides multiples of 8): one
// CTA of 4 warps per (batch*head, 64 query rows), 16 rows per warp, in the
// FlashAttention-2 arrangement with mma.sync m16n8k16 (fp32 accumulate).
// Each warp keeps its q fragments, running max/sum and the fp32 output
// accumulator in registers; 64-key K and V tiles are staged in shared memory
// with 16-byte loads (V's fragments read back transposed by ldmatrix), and
// the tile's probabilities go from the score accumulator straight into the A
// operand of P.V (rounded to the input dtype, as FlashAttention does).  D is zero-padded to a multiple of
// 16 in shared memory only.  For 128 < D <= 512 (the VAE mid block's single
// d=512 head, which no warp's registers can accumulate alone) a wide form
// has the 4 warps share 16 query rows and split D: partial scores are summed
// through shared memory and each warp accumulates a quarter of the output.
// What is left to reach the bound: wgmma, TMA and a pipelined K/V ring
// (later work).
//
// CUDA cores (fp32, D not a multiple of 8, unaligned views; none at sd15's
// bf16 shapes): 4 warps per (batch*head, BQ query rows), each warp owning
// RW rows.  K and V are staged 32 keys at a time (the TPU kernel holds the
// whole [M, D] K/V in VMEM, which at D = 512 no CTA can): lane j owns key j
// in the score pass and reads q rows as shared-memory broadcasts; in the P.V
// pass lane l owns head columns l, l+32, ... .  At D = 512 the tiles need
// ~167 KB of shared memory, set with cudaFuncSetAttribute.  Its only callers
// are explicit ones: impl="flash" (multi_head_attention, or
// flash_attention_forward directly) on fp32 tensors, on a head dim that is
// not a multiple of 8, or on views whose strides are not; that is the JAX
// kernel's envelope (fp32/fp16/bf16, any D <= 512), which the wrapper keeps.
// Neither main path reaches it: the "auto" rule admits bf16/fp16 only, and
// every head dim of the shipped configs is a multiple of 8.  The backward
// kernel (flash_attention_bwd.cu) does not cover this envelope: with a
// gradient, fp32 and D % 8 != 0 raise (ROADMAP.md queue B).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;  // keys per tile: one per lane in the score pass
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows per warp: fewer where the accumulator is wide, to stay in registers.
template <int NC> struct RowsPerWarp { static constexpr int value = NC <= 4 ? 8 : 4; };

// Shared-memory row stride (floats) for q/k tiles: D rounded up to a multiple
// of 4, then to an odd number of float4s so that 8 lanes reading 8 different
// key rows with 16-byte loads hit 8 different bank groups.
__host__ __device__ inline int qk_stride(int d) {
  int d4 = (d + 3) / 4;
  if ((d4 & 1) == 0) d4 += 1;
  return d4 * 4;
}

template <int NC>
__host__ __device__ inline size_t smem_bytes(int ds) {
  constexpr int RW = RowsPerWarp<NC>::value;
  constexpr int BQ = kWarps * RW;
  return sizeof(float) *
         (size_t)(BQ * ds + kBK * ds + kBK * NC * 32 + kWarps * kBK * RW);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int N, int M, int H, int D,
                 int DS, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                 long long k_sm, long long k_sh, long long v_sb, long long v_sm,
                 long long v_sh, float scale_log2) {
  constexpr int RW = RowsPerWarp<NC>::value;
  constexpr int BQ = kWarps * RW;
  constexpr int DV = NC * 32;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][DS], pre-scaled by scale*log2(e)
  float* sK = sQ + BQ * DS;                      // [kBK][DS]
  float* sV = sK + kBK * DS;                     // [kBK][DV]
  float* sP = sV + kBK * DV;                     // [kWarps][kBK][RW]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < BQ * DS; idx += kThreads) {
    const int r = idx / DS;
    const int d = idx - r * DS;
    const int n = q0 + r;
    float x = 0.f;
    if (n < N && d < D) x = to_float<T>(qb[(long long)n * q_sn + d]) * scale_log2;
    sQ[idx] = x;
  }

  float m_run[RW], l_run[RW], acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const float4* qrow = reinterpret_cast<const float4*>(sQ + warp * RW * DS);
  const float4* krow = reinterpret_cast<const float4*>(sK + lane * DS);
  const int ds4 = DS / 4;
  float* pw = sP + warp * kBK * RW;

  for (int k0 = 0; k0 < M; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    for (int idx = tid; idx < kBK * DS; idx += kThreads) {
      const int j = idx / DS;
      const int d = idx - j * DS;
      const int m = k0 + j;
      sK[idx] = (m < M && d < D) ? to_float<T>(kb[(long long)m * k_sm + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * DV; idx += kThreads) {
      const int j = idx / DV;
      const int d = idx - j * DV;
      const int m = k0 + j;
      sV[idx] = (m < M && d < D) ? to_float<T>(vb[(long long)m * v_sm + d]) : 0.f;
    }
    __syncthreads();

    // Scores, in log2 units: lane owns key k0 + lane.
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    for (int d4 = 0; d4 < ds4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qq = qrow[r * ds4 + d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // Online softmax.  Key k0 (lane 0) is always valid, so m_new is finite.
    const bool valid = k0 + lane < M;
    float p[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float sr = valid ? s[r] : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(sr));
      p[r] = exp2f(sr - m_new);
      const float alpha = exp2f(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p[r]);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int r4 = 0; r4 < RW / 4; ++r4) {
      reinterpret_cast<float4*>(pw + lane * RW)[r4] =
          make_float4(p[4 * r4], p[4 * r4 + 1], p[4 * r4 + 2], p[4 * r4 + 3]);
    }
    __syncwarp();

    // acc += P . V: lane owns head columns lane + 32*c.
    const int jn = min(kBK, M - k0);
    for (int j = 0; j < jn; ++j) {
      float pj[RW];
#pragma unroll
      for (int r4 = 0; r4 < RW / 4; ++r4) {
        const float4 t = reinterpret_cast<const float4*>(pw + j * RW)[r4];
        pj[4 * r4] = t.x;
        pj[4 * r4 + 1] = t.y;
        pj[4 * r4 + 2] = t.z;
        pj[4 * r4 + 3] = t.w;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[j * DV + c * 32 + lane];
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int n = q0 + warp * RW + r;
    if (n >= N) continue;
    const float inv = 1.f / l_run[r];
    T* orow = o + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < D) orow[d] = from_float<T>(acc[r][c] * inv);
    }
    if (lane == 0) lse[(long long)bh * N + n] = (m_run[r] + log2f(l_run[r])) * kLn2;
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int N, int M, int H, int D, const long long* qs, const long long* ks,
                   const long long* vs, float scale, cudaStream_t stream) {
  constexpr int RW = RowsPerWarp<NC>::value;
  constexpr int BQ = kWarps * RW;
  const int ds = qk_stride(D);
  const size_t smem = smem_bytes<NC>(ds);
  auto kernel = flash_fwd_kernel<T, NC>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, M, H, D, ds, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_nc(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int N, int M, int H, int D, const long long* qs,
                        const long long* ks, const long long* vs, float scale,
                        cudaStream_t stream) {
  const int nc = (D + 31) / 32;
  if (nc <= 1) return launch<T, 1>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (nc <= 2) return launch<T, 2>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (nc <= 3) return launch<T, 3>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (nc <= 4) return launch<T, 4>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (nc <= 8) return launch<T, 8>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (nc <= 16) return launch<T, 16>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// Tensor-core variant.
// ---------------------------------------------------------------------------
constexpr int kMmaBQ = 64;  // query rows per CTA, 16 per warp
constexpr int kMmaBK = 64;  // keys per tile

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 0-7, 8-15,
// 16-23 and 24-31 give the row addresses of matrices 0-3.  From row-major
// V [key][d] this yields the B fragments of P.V for two 8-column tiles.
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
};

template <int KD>
__host__ __device__ constexpr size_t mma_smem_elems() {
  // q, k and v tiles [64][16*KD + 8]; the +8 padding makes the fragment
  // loads (32-bit and ldmatrix) bank-conflict free.
  return (size_t)(kMmaBQ + 2 * kMmaBK) * (KD * 16 + 8);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A a0:(g, 2t..2t+1) a1:(g+8, 2t..) a2:(g, 2t+8..) a3:(g+8, 2t+8..)
//   B b0:(k=2t..2t+1, n=g) b1:(k=2t+8.., n=g)
//   C c0,c1:(g, 2t..2t+1) c2,c3:(g+8, 2t..2t+1)
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int N, int M, int H, int D,
                     long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                     long long k_sm, long long k_sh, long long v_sb, long long v_sm,
                     long long v_sh, float scale_log2) {
  constexpr int DP = KD * 16;  // head dim padded to the mma's k
  constexpr int PCH = DP / 8;  // 16-byte chunks per padded row
  constexpr int ND = DP / 8;   // 8-column tiles of the output
  constexpr int QS = DP + 8;   // row stride of the q, k and v tiles

  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sK = sQ + kMmaBQ * QS;
  T* sV = sK + kMmaBK * QS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kMmaBQ;
  const int dch = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < kMmaBQ * PCH; idx += kThreads) {
    const int r = idx / PCH;
    const int c = idx - r * PCH;
    const int n = q0 + r;
    const uint4 val = (n < N && c < dch)
                          ? *reinterpret_cast<const uint4*>(qb + (long long)n * q_sn + c * 8)
                          : zero;
    *reinterpret_cast<uint4*>(sQ + r * QS + c * 8) = val;
  }
  __syncthreads();
  uint32_t qa[KD][4];
  {
    const T* qw = sQ + (warp * 16 + g) * QS + tq * 2;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      qa[ks][0] = ld32(qw + ks * 16);
      qa[ks][1] = ld32(qw + 8 * QS + ks * 16);
      qa[ks][2] = ld32(qw + ks * 16 + 8);
      qa[ks][3] = ld32(qw + 8 * QS + ks * 16 + 8);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < M; k0 += kMmaBK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kMmaBK * PCH; idx += kThreads) {
      const int r = idx / PCH;
      const int c = idx - r * PCH;
      const int m = k0 + r;
      uint4 kv = zero, vv = zero;
      if (m < M && c < dch) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)m * k_sm + c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)m * v_sm + c * 8);
      }
      *reinterpret_cast<uint4*>(sK + r * QS + c * 8) = kv;
      *reinterpret_cast<uint4*>(sV + r * QS + c * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* kr = sK + (nt * 8 + g) * QS + tq * 2;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        Mma<T>::run(s[nt], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }

    // Online softmax in log2 units; rows g (i = 0) and g + 8 (i = 1).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tq * 2 + (e & 1);
        const float x = key < M ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);  // finite: key k0 is valid
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        lsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + lsum[i];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // acc += P V, P taken from the score accumulator 16 keys at a time.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * t][0], s[2 * t][1]), Mma<T>::pack(s[2 * t][2], s[2 * t][3]),
          Mma<T>::pack(s[2 * t + 1][0], s[2 * t + 1][1]),
          Mma<T>::pack(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV + (t * 16 + (lane & 15)) * QS + (nd + (lane >> 4)) * 8);
        Mma<T>::run(acc[nd], pa, bv[0], bv[1]);
        Mma<T>::run(acc[nd + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + warp * 16 + g + 8 * i;
    if (n >= N) continue;
    const float inv = 1.f / l_run[i];
    T* orow = o + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = nd * 8 + tq * 2;
      if (d < D)
        *reinterpret_cast<uint32_t*>(orow + d) =
            Mma<T>::pack(acc[nd][2 * i] * inv, acc[nd][2 * i + 1] * inv);
    }
    if (tq == 0) lse[(long long)bh * N + n] = (m_run[i] + log2f(l_run[i])) * kLn2;
  }
}

template <typename T, int KD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int N, int M, int H, int D, const long long* qs, const long long* ks,
                       const long long* vs, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(T) * mma_smem_elems<KD>();
  auto kernel = flash_fwd_mma_kernel<T, KD>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((N + kMmaBQ - 1) / kMmaBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, M, H, D, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale * kLog2e);
  return cudaGetLastError();
}


// Wide tensor-core variant (128 < D <= 512, i.e. the VAE mid block's single
// head): the 4 warps share 16 query rows and split the head dim.  Each warp
// computes the scores over its quarter of D, the partials are summed through
// shared memory in a fixed order (so every warp holds identical scores and
// softmax state), and each warp accumulates its quarter of the output.
constexpr int kWideBQ = 16;

template <int DP>
__host__ __device__ constexpr size_t wide_smem_bytes(size_t elem) {
  return elem * (size_t)(kWideBQ + 2 * kMmaBK) * (DP + 8) + sizeof(float) * kWarps * 32 * 32;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int N, int M, int H, int D, long long q_sb, long long q_sn,
                          long long q_sh, long long k_sb, long long k_sm, long long k_sh,
                          long long v_sb, long long v_sm, long long v_sh, float scale_log2) {
  constexpr int PCH = DP / 8;
  constexpr int QS = DP + 8;
  constexpr int DW = DP / kWarps;  // head columns per warp
  constexpr int KDW = DW / 16;     // k-steps of a warp's score slice
  constexpr int NDW = DW / 8;      // output column tiles per warp

  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);               // [16][QS]
  T* sK = sQ + kWideBQ * QS;                          // [64][QS]
  T* sV = sK + kMmaBK * QS;                           // [64][QS]
  float* sS = reinterpret_cast<float*>(sV + kMmaBK * QS);  // [warp][32 values][32 lanes]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kWideBQ;
  const int dch = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < kWideBQ * PCH; idx += kThreads) {
    const int r = idx / PCH;
    const int c = idx - r * PCH;
    const int n = q0 + r;
    const uint4 val = (n < N && c < dch)
                          ? *reinterpret_cast<const uint4*>(qb + (long long)n * q_sn + c * 8)
                          : zero;
    *reinterpret_cast<uint4*>(sQ + r * QS + c * 8) = val;
  }
  __syncthreads();
  uint32_t qa[KDW][4];
  {
    const T* qw = sQ + g * QS + warp * DW + tq * 2;
#pragma unroll
    for (int ks = 0; ks < KDW; ++ks) {
      qa[ks][0] = ld32(qw + ks * 16);
      qa[ks][1] = ld32(qw + 8 * QS + ks * 16);
      qa[ks][2] = ld32(qw + ks * 16 + 8);
      qa[ks][3] = ld32(qw + 8 * QS + ks * 16 + 8);
    }
  }

  float acc[NDW][4];
#pragma unroll
  for (int nd = 0; nd < NDW; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < M; k0 += kMmaBK) {
    __syncthreads();  // the previous tile (and its partial scores) is consumed
    for (int idx = tid; idx < kMmaBK * PCH; idx += kThreads) {
      const int r = idx / PCH;
      const int c = idx - r * PCH;
      const int m = k0 + r;
      uint4 kv = zero, vv = zero;
      if (m < M && c < dch) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)m * k_sm + c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)m * v_sm + c * 8);
      }
      *reinterpret_cast<uint4*>(sK + r * QS + c * 8) = kv;
      *reinterpret_cast<uint4*>(sV + r * QS + c * 8) = vv;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* kr = sK + (nt * 8 + g) * QS + warp * DW + tq * 2;
#pragma unroll
      for (int ks = 0; ks < KDW; ++ks)
        Mma<T>::run(s[nt], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) sS[(warp * 32 + nt * 4 + e) * 32 + lane] = s[nt][e];
    }
    __syncthreads();

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) x += sS[(w * 32 + nt * 4 + e) * 32 + lane];
        const int key = k0 + nt * 8 + tq * 2 + (e & 1);
        x = key < M ? x * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        lsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + lsum[i];
#pragma unroll
    for (int nd = 0; nd < NDW; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * t][0], s[2 * t][1]), Mma<T>::pack(s[2 * t][2], s[2 * t][3]),
          Mma<T>::pack(s[2 * t + 1][0], s[2 * t + 1][1]),
          Mma<T>::pack(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int nd = 0; nd < NDW; nd += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV + (t * 16 + (lane & 15)) * QS + warp * DW +
                                  (nd + (lane >> 4)) * 8);
        Mma<T>::run(acc[nd], pa, bv[0], bv[1]);
        Mma<T>::run(acc[nd + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + g + 8 * i;
    if (n >= N) continue;
    const float inv = 1.f / l_run[i];
    T* orow = o + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < NDW; ++nd) {
      const int d = warp * DW + nd * 8 + tq * 2;
      if (d < D)
        *reinterpret_cast<uint32_t*>(orow + d) =
            Mma<T>::pack(acc[nd][2 * i] * inv, acc[nd][2 * i + 1] * inv);
    }
    if (warp == 0 && tq == 0) lse[(long long)bh * N + n] = (m_run[i] + log2f(l_run[i])) * kLn2;
  }
}

template <typename T, int DP>
cudaError_t launch_mma_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int N, int M, int H, int D, const long long* qs,
                            const long long* ks, const long long* vs, float scale,
                            cudaStream_t stream) {
  const size_t smem = wide_smem_bytes<DP>(sizeof(T));
  auto kernel = flash_fwd_mma_wide_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kWideBQ - 1) / kWideBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, M, H, D, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale * kLog2e);
  return cudaGetLastError();
}

// The tensor-core variants take 16-byte loads of whole 8-element chunks.
bool mma_eligible(const void* q, const void* k, const void* v, int D, const long long* qs,
                  const long long* ks, const long long* vs) {
  if (D > 512 || D % 8 != 0) return false;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return false;
  for (int i = 0; i < 3; ++i)
    if (qs[i] % 8 || ks[i] % 8 || vs[i] % 8) return false;
  return true;
}

template <typename T>
cudaError_t dispatch_kd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int N, int M, int H, int D, const long long* qs,
                        const long long* ks, const long long* vs, float scale,
                        cudaStream_t stream) {
  if (D > 256) return launch_mma_wide<T, 512>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (D > 128) return launch_mma_wide<T, 256>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  const int kd = (D + 15) / 16;
  if (kd <= 2) return launch_mma<T, 2>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (kd <= 3) return launch_mma<T, 3>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (kd <= 4) return launch_mma<T, 4>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (kd <= 5) return launch_mma<T, 5>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  if (kd <= 6) return launch_mma<T, 6>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
  return launch_mma<T, 8>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  Strides are in elements:
// (batch, sequence, head) for each of q, k, v; the head dim has stride 1.
// Returns the launch's cudaError_t (0 on success).
extern "C" int tb_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int N, int M, int H, int D,
                                      long long q_sb, long long q_sn, long long q_sh,
                                      long long k_sb, long long k_sm, long long k_sh,
                                      long long v_sb, long long v_sm, long long v_sh,
                                      float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || D > 512 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_sn, q_sh};
  const long long ks[3] = {k_sb, k_sm, k_sh};
  const long long vs[3] = {v_sb, v_sm, v_sh};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_nc<float>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
    case 1:
      if (mma_eligible(q, k, v, D, qs, ks, vs))
        return (int)dispatch_kd<__half>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
      return (int)dispatch_nc<__half>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
    case 2:
      if (mma_eligible(q, k, v, D, qs, ks, vs))
        return (int)dispatch_kd<__nv_bfloat16>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
      return (int)dispatch_nc<__nv_bfloat16>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
