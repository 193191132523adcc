// GroupNorm (+ optional SiLU) input-gradient backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel textboost_tpu/ops/group_norm.py::_bwd_kernel
// (launched through _run_bwd, pallas_call at group_norm.py:162, for the VJP
// _fused_gn_bwd at :193-197).  Given x, the forward's fp32 mean/rstd [B, G],
// gamma/beta and dy, it writes dx only (gamma and beta are frozen: the
// dispatch in models/layers.py takes the plain path when they need grads):
//
//   x_hat = (x - mean) * rstd
//   dz    = dy * s * (1 + z * (1 - s)),  z = x_hat*gamma + beta, s = sigmoid(z)
//           (dz = dy without the SiLU)
//   dxh   = dz * gamma
//   dx    = rstd * (dxh - mean_g(dxh) - x_hat * mean_g(dxh * x_hat))
//
// in fp32, with dx cast to x's dtype.  mean_g is the mean over the
// (sample, group) span of (C/G)*HW elements.
//
// Layout: x, dy and dx are NCHW-contiguous, viewed as [B, C, HW], so each
// (sample, group) is one contiguous span (the TPU kernel's [C, G]
// group-assignment matmuls are not needed).
//
// Bound on the card: bytes.  The least traffic is one read of x and dy and
// one write of dx (about 20 operations per element, far below the card's
// ~295 operations per byte).  dx needs the two group sums before any
// element can be written, so this simple version reads x and dy twice: one
// pass for the sums, one to write dx (1.67x the bound's bytes at worst; the
// second pass often hits L2: at the UNet's level 0 a span of x and of dy is
// 10 x 64 x 64 bf16 = 80 KB each, and the L2 holds 50 MB).
//
// Design: as the forward, one CTA of 1024 threads per (sample, group),
// 16-byte vector loads and stores where the span allows, a warp-shuffle +
// shared-memory block reduction for the two sums.

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

// (x_hat, dxh) of one element.
template <bool SILU>
__device__ __forceinline__ void grad_xhat(float x, float dy, float mean, float rstd, float g,
                                          float b, float& xh, float& dxh) {
  xh = (x - mean) * rstd;
  if (SILU) {
    const float z = xh * g + b;
    const float s = 1.f / (1.f + __expf(-z));
    dy = dy * s * (1.f + z * (1.f - s));
  }
  dxh = dy * g;
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const float* __restrict__ mean_in,
                      const float* __restrict__ rstd_in, const T* __restrict__ dy,
                      T* __restrict__ dx, int C, int G, int HW) {
  __shared__ float red[32];
  const int bg = blockIdx.x;
  const int b = bg / G;
  const int g = bg - b * G;
  const int cg = C / G;
  const int span = cg * HW;
  const long long base = ((long long)b * C + (long long)g * cg) * HW;
  const T* xs = x + base;
  const T* dys = dy + base;
  T* dxs = dx + base;
  const float mean = mean_in[bg];
  const float rstd = rstd_in[bg];
  const float* gam = gamma + g * cg;
  const float* bet = beta + g * cg;
  constexpr int kV = Vec<T>::kN;
  // HW % kV == 0 keeps every vector inside one channel.
  const bool vec = (HW % kV == 0) &&
                   (((reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(dys) |
                      reinterpret_cast<uintptr_t>(dxs)) & 15) == 0);

  // Pass 1: the two group sums.
  float s1 = 0.f, s2 = 0.f;
  if (vec) {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xs);
    const Vec<T>* dyv = reinterpret_cast<const Vec<T>*>(dys);
    for (int i = threadIdx.x; i < span / kV; i += kThreads) {
      const int c = (i * kV) / HW;
      const float ga = gam[c], be = bet[c];
      const Vec<T> tx = xv[i];
      const Vec<T> td = dyv[i];
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        float xh, dxh;
        grad_xhat<SILU>(to_float<T>(tx.v[e]), to_float<T>(td.v[e]), mean, rstd, ga, be, xh, dxh);
        s1 += dxh;
        s2 = fmaf(dxh, xh, s2);
      }
    }
  } else {
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const int c = i / HW;
      float xh, dxh;
      grad_xhat<SILU>(to_float<T>(xs[i]), to_float<T>(dys[i]), mean, rstd, gam[c], bet[c], xh,
                      dxh);
      s1 += dxh;
      s2 = fmaf(dxh, xh, s2);
    }
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const float inv_n = 1.f / (float)span;
  const float m1 = s1 * inv_n;  // mean_g(dxh)
  const float m2 = s2 * inv_n;  // mean_g(dxh * x_hat)

  // Pass 2: dx.
  if (vec) {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xs);
    const Vec<T>* dyv = reinterpret_cast<const Vec<T>*>(dys);
    Vec<T>* dxv = reinterpret_cast<Vec<T>*>(dxs);
    for (int i = threadIdx.x; i < span / kV; i += kThreads) {
      const int c = (i * kV) / HW;
      const float ga = gam[c], be = bet[c];
      const Vec<T> tx = xv[i];
      const Vec<T> td = dyv[i];
      Vec<T> out;
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        float xh, dxh;
        grad_xhat<SILU>(to_float<T>(tx.v[e]), to_float<T>(td.v[e]), mean, rstd, ga, be, xh, dxh);
        out.v[e] = from_float<T>(rstd * (dxh - m1 - xh * m2));
      }
      dxv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const int c = i / HW;
      float xh, dxh;
      grad_xhat<SILU>(to_float<T>(xs[i]), to_float<T>(dys[i]), mean, rstd, gam[c], bet[c], xh,
                      dxh);
      dxs[i] = from_float<T>(rstd * (dxh - m1 - xh * m2));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta, const float* mean,
                   const float* rstd, const void* dy, void* dx, int B, int C, int G, int HW,
                   int silu, cudaStream_t stream) {
  const dim3 grid(B * G);
  if (silu) {
    group_norm_bwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, mean, rstd, static_cast<const T*>(dy),
        static_cast<T*>(dx), C, G, HW);
  } else {
    group_norm_bwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, mean, rstd, static_cast<const T*>(dy),
        static_cast<T*>(dx), C, G, HW);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  x, dy and dx are [B, C, HW]
// contiguous in one dtype; gamma/beta fp32 [C]; mean/rstd fp32 [B, G] from
// the forward.  The caller checks that (C / G) * HW fits in an int.
// Returns the launch's cudaError_t.
extern "C" int tb_group_norm_bwd(int dtype, const void* x, const void* gamma, const void* beta,
                                 const void* mean, const void* rstd, const void* dy, void* dx,
                                 int B, int C, int G, int HW, int silu, void* stream) {
  if (B <= 0 || C <= 0 || G <= 0 || HW <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, ga, be, mu, rs, dy, dx, B, C, G, HW, silu, s);
    case 1: return (int)launch<__half>(x, ga, be, mu, rs, dy, dx, B, C, G, HW, silu, s);
    case 2: return (int)launch<__nv_bfloat16>(x, ga, be, mu, rs, dy, dx, B, C, G, HW, silu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
