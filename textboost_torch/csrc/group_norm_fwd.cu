// GroupNorm (+ optional SiLU) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel textboost_tpu/ops/group_norm.py::_fwd_kernel
// (launched through _run_fwd, pallas_call at group_norm.py:133): per-sample,
// per-group statistics in fp32 from one pass (E[x], E[x^2]), then
// (x - mean) * rstd * gamma + beta, an optional SiLU in fp32, and the cast
// back to the tensor's dtype.  Mean and rstd are written fp32 [B, G] for the
// backward pass.
//
// Layout: x is NCHW-contiguous, viewed as [B, C, HW].  Each (sample, group)
// is then one contiguous span of (C/G)*HW elements, so the TPU kernel's
// [C, G] group-assignment matmuls are not needed.  The variance is clamped
// at 0 (as the XLA path at textboost_tpu/models/layers.py:71 does); the
// unclamped Pallas variance can go negative by rounding.  There is no slab
// limit: the TPU kernel had to fit a sample in VMEM (rows*C*4 <= 6 MB);
// here every UNet and VAE slab, up to the decoder's 128 x 512 x 512, is one
// span per CTA streamed through registers.
//
// Bound on the card: bytes.  The least traffic is one read of x and one write
// of y (a few operations per element).  This simple version reads x twice
// (statistics, then normalize), so it moves 1.5x the bound's bytes at best;
// the second read often hits L2 for the UNet's small spans.
//
// Design: one CTA of 1024 threads per (sample, group), 16-byte vector loads
// and stores where the span allows, a warp-shuffle + shared-memory block
// reduction for the two sums.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

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

// 16 bytes of T, loaded and stored as one vector.
template <typename T> struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;  // every thread holds the total
}

template <bool SILU>
__device__ __forceinline__ float normalize(float x, float mean, float rstd, float g, float b) {
  float y = (x - mean) * rstd * g + b;
  if (SILU) y = y / (1.f + __expf(-y));
  return y;
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int C, int G,
                      int HW, float eps) {
  __shared__ float red[32];
  const int bg = blockIdx.x;
  const int b = bg / G;
  const int g = bg - b * G;
  const int cg = C / G;
  const int span = cg * HW;
  const long long base = ((long long)b * C + (long long)g * cg) * HW;
  const T* xs = x + base;
  T* ys = y + base;
  constexpr int kV = Vec<T>::kN;
  // HW % kV == 0 keeps every vector inside one channel and, with the
  // allocator's 256-byte alignment, every span 16-byte aligned.
  const bool vec = (HW % kV == 0) && ((reinterpret_cast<uintptr_t>(xs) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(ys) & 15) == 0);

  float s1 = 0.f, s2 = 0.f;
  if (vec) {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xs);
    for (int i = threadIdx.x; i < span / kV; i += kThreads) {
      const Vec<T> t = xv[i];
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float f = to_float<T>(t.v[e]);
        s1 += f;
        s2 = fmaf(f, f, s2);
      }
    }
  } else {
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const float f = to_float<T>(xs[i]);
      s1 += f;
      s2 = fmaf(f, f, s2);
    }
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const float inv_n = 1.f / (float)span;
  const float mean = s1 * inv_n;
  const float var = fmaxf(s2 * inv_n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (threadIdx.x == 0) {
    mean_out[bg] = mean;
    rstd_out[bg] = rstd;
  }

  const float* gam = gamma + g * cg;
  const float* bet = beta + g * cg;
  if (vec) {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xs);
    Vec<T>* yv = reinterpret_cast<Vec<T>*>(ys);
    for (int i = threadIdx.x; i < span / kV; i += kThreads) {
      const int c = (i * kV) / HW;
      const float ga = gam[c];
      const float be = bet[c];
      const Vec<T> t = xv[i];
      Vec<T> out;
#pragma unroll
      for (int e = 0; e < kV; ++e)
        out.v[e] = from_float<T>(normalize<SILU>(to_float<T>(t.v[e]), mean, rstd, ga, be));
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const int c = i / HW;
      ys[i] = from_float<T>(normalize<SILU>(to_float<T>(xs[i]), mean, rstd, gam[c], bet[c]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta, void* y, float* mean,
                   float* rstd, int B, int C, int G, int HW, float eps, int silu,
                   cudaStream_t stream) {
  const dim3 grid(B * G);
  if (silu) {
    group_norm_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), mean, rstd, C, G, HW, eps);
  } else {
    group_norm_fwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), mean, rstd, C, G, HW, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  x and y are [B, C, HW]
// contiguous; gamma/beta fp32 [C]; mean/rstd fp32 [B, G].  The caller checks
// that (C / G) * HW fits in an int.  Returns the launch's cudaError_t.
extern "C" int tb_group_norm_fwd(int dtype, const void* x, const void* gamma, const void* beta,
                                 void* y, void* mean, void* rstd, int B, int C, int G, int HW,
                                 float eps, int silu, void* stream) {
  if (B <= 0 || C <= 0 || G <= 0 || HW <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, ga, be, y, mu, rs, B, C, G, HW, eps, silu, s);
    case 1: return (int)launch<__half>(x, ga, be, y, mu, rs, B, C, G, HW, eps, silu, s);
    case 2: return (int)launch<__nv_bfloat16>(x, ga, be, y, mu, rs, B, C, G, HW, eps, silu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
