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
// Bound on the card: bytes (about 20 operations per element).  dx needs the
// two group sums before any element can be written; the cluster design of
// group_norm.cuh keeps each CTA's chunk of x and dy in shared memory between
// the sums and the output, so a resident span reads x and dy once and
// writes dx once: the bound's bytes.  x_hat and dxh are computed twice (for
// the sums, then for dx), which costs operations, not bytes.

#include "group_norm.cuh"

namespace {

using gn::Plan;

template <bool SILU> struct BwdOp {
  static constexpr int kTensors = 2;
  static constexpr bool kStatsUseChannel = true;
  float mean, rstd;
  float m1 = 0.f, m2 = 0.f;  // mean_g(dxh), mean_g(dxh * x_hat)

  // (x_hat, dxh) of one element.
  __device__ __forceinline__ void grad(float x, float dy, float ga, float be, float& xh,
                                       float& dxh) const {
    xh = (x - mean) * rstd;
    if (SILU) {
      const float z = xh * ga + be;
      const float s = gn::fast_sigmoid(z);
      dy = dy * s * (1.f + z * (1.f - s));
    }
    dxh = dy * ga;
  }
  __device__ __forceinline__ void sums(float x, float dy, float ga, float be, float& s1,
                                       float& s2) const {
    float xh, dxh;
    grad(x, dy, ga, be, xh, dxh);
    s1 += dxh;
    s2 = fmaf(dxh, xh, s2);
  }
  __device__ __forceinline__ void finish(float t1, float t2, float inv_n, int, bool) {
    m1 = t1 * inv_n;
    m2 = t2 * inv_n;
  }
  __device__ __forceinline__ float out(float x, float dy, float ga, float be) const {
    float xh, dxh;
    grad(x, dy, ga, be, xh, dxh);
    return rstd * (dxh - m1 - xh * m2);
  }
};

template <typename T, bool SILU, int V>
__global__ void __launch_bounds__(gn::kMaxThreads)
group_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const float* __restrict__ mean_in,
                      const float* __restrict__ rstd_in, const T* __restrict__ dy,
                      T* __restrict__ dx, int C, int G, int HW, Plan plan) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ gn::Scratch sh;
  const int bg = blockIdx.x / plan.cluster;
  BwdOp<SILU> op{mean_in[bg], rstd_in[bg]};
  gn::span_body<V, T>(op, x, dy, dx, gamma, beta, C, G, HW, plan, smem, sh);
}

template <typename T, bool SILU, int V>
cudaError_t launch_variant(const void* x, const float* gamma, const float* beta,
                           const float* mean, const float* rstd, const void* dy, void* dx, int B,
                           int C, int G, int HW, const Plan& plan, cudaStream_t stream) {
  constexpr auto kernel = group_norm_bwd_kernel<T, SILU, V>;
  cudaError_t err = gn::prepare<kernel>();
  if (err != cudaSuccess) return err;
  // 16-byte vectors need 16-byte aligned tensors (check_plan has the rest).
  if (plan.vector && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                       reinterpret_cast<uintptr_t>(dx)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gn::cluster_config(cfg, attr, B * G * plan.cluster, plan.cluster, plan.threads, plan.smem,
                     stream);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), gamma, beta, mean, rstd,
                           static_cast<const T*>(dy), static_cast<T*>(dx), C, G, HW, plan);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The variant the plan names: its chunk in registers (16-bit types) or in
// shared memory.
template <typename T, bool SILU>
cudaError_t launch(const void* x, const float* gamma, const float* beta, const float* mean,
                   const float* rstd, const void* dy, void* dx, int B, int C, int G, int HW,
                   const Plan& plan, cudaStream_t stream) {
#define TB_GN_VARIANT(V) \
  launch_variant<T, SILU, V>(x, gamma, beta, mean, rstd, dy, dx, B, C, G, HW, plan, stream)
  if constexpr (sizeof(T) == 2) {
    switch (plan.regs) {
      case 1: return TB_GN_VARIANT(1);
      case 2: return TB_GN_VARIANT(2);
      case 4: return TB_GN_VARIANT(4);
      default: break;
    }
  }
  return TB_GN_VARIANT(0);
#undef TB_GN_VARIANT
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  x, dy and dx are [B, C, HW]
// contiguous in one dtype; gamma/beta fp32 [C]; mean/rstd fp32 [B, G] from
// the forward.  The plan's fields come from
// ops/group_norm.py::plan_group_norm(..., backward=True); an inconsistent
// plan returns cudaErrorInvalidValue.  Returns the launch's cudaError_t.
extern "C" int tb_group_norm_bwd(int dtype, const void* x, const void* gamma, const void* beta,
                                 const void* mean, const void* rstd, const void* dy, void* dx,
                                 int B, int C, int G, int HW, int silu, int cluster, int chunk,
                                 int resident, int threads, int smem, int regs, int vector,
                                 void* stream) {
  const Plan plan{cluster, chunk, resident, threads, smem, regs, vector};
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  const cudaError_t ok = gn::check_plan(plan, B, C, G, HW, elem, 2);
  if (ok != cudaSuccess) return (int)ok;
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TB_GN_BWD(T)                                                                          \
  return (int)(silu ? launch<T, true>(x, ga, be, mu, rs, dy, dx, B, C, G, HW, plan, s)        \
                    : launch<T, false>(x, ga, be, mu, rs, dy, dx, B, C, G, HW, plan, s))
  switch (dtype) {
    case 0: TB_GN_BWD(float);
    case 1: TB_GN_BWD(__half);
    default: TB_GN_BWD(__nv_bfloat16);
  }
#undef TB_GN_BWD
}

// How many clusters of `cluster` CTAs (`threads` threads, `smem` bytes of
// dynamic shared memory each) of the backward kernel the card holds at once,
// in *out (0: it cannot schedule one).
extern "C" int tb_group_norm_bwd_active_clusters(int cluster, int threads, int smem, int* out) {
  return (int)gn::active_clusters<group_norm_bwd_kernel<__nv_bfloat16, true, 0>>(cluster, threads,
                                                                             smem, out);
}
