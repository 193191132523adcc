// GroupNorm (+ optional SiLU) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel textboost_tpu/ops/group_norm.py::_fwd_kernel
// (launched through _run_fwd, pallas_call at group_norm.py:133): per-sample,
// per-group statistics in fp32 from one pass (E[x], E[x^2]), then
// (x - mean) * rstd * gamma + beta, an optional SiLU in fp32, and the cast
// back to the tensor's dtype.  Mean and rstd are written fp32 [B, G] for the
// backward pass.  The variance is clamped at 0 (as the XLA path at
// textboost_tpu/models/layers.py:71 does); the unclamped Pallas variance can
// go negative by rounding.
//
// Layout: x is NCHW-contiguous, viewed as [B, C, HW], so each (sample,
// group) is one contiguous span and the TPU kernel's [C, G] group-assignment
// matmuls are not needed.  The TPU kernel had to fit a sample in VMEM
// (rows*C*4 <= 6 MB); here a span of any size is split over a thread-block
// cluster (group_norm.cuh says how).
//
// Bound on the card: bytes (about 8 operations per element against the
// card's ~20 fp32 operations per byte).  The least traffic is one read of x
// and one write of y; a resident span moves exactly that, a streamed one
// (larger than its cluster's shared memory) re-reads its remainder.

#include "group_norm.cuh"

namespace {

using gn::Plan;

template <bool SILU> struct FwdOp {
  static constexpr int kTensors = 1;
  static constexpr bool kStatsUseChannel = false;
  float* mean_out;
  float* rstd_out;
  float eps;
  float mean = 0.f, rstd = 0.f;

  __device__ __forceinline__ void sums(float x, float, float, float, float& s1, float& s2) const {
    s1 += x;
    s2 = fmaf(x, x, s2);
  }
  __device__ __forceinline__ void finish(float t1, float t2, float inv_n, int bg, bool write) {
    mean = t1 * inv_n;
    const float var = fmaxf(t2 * inv_n - mean * mean, 0.f);
    rstd = rsqrtf(var + eps);
    if (write) {
      mean_out[bg] = mean;
      rstd_out[bg] = rstd;
    }
  }
  __device__ __forceinline__ float out(float x, float, float ga, float be) const {
    const float a = rstd * ga;  // the same for the whole vector: computed once
    const float y = fmaf(x, a, fmaf(-mean, a, be));
    return SILU ? y * gn::fast_sigmoid(y) : y;
  }
};

template <typename T, bool SILU, int V>
__global__ void __launch_bounds__(gn::kMaxThreads)
group_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int C, int G,
                      int HW, float eps, Plan plan) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ gn::Scratch sh;
  FwdOp<SILU> op{mean_out, rstd_out, eps};
  gn::span_body<V, T>(op, x, static_cast<const T*>(nullptr), y, gamma, beta, C, G, HW, plan,
                      smem, sh);
}

template <typename T, bool SILU, int V>
cudaError_t launch_variant(const void* x, const float* gamma, const float* beta, void* y,
                           float* mean, float* rstd, int B, int C, int G, int HW, float eps,
                           const Plan& plan, cudaStream_t stream) {
  constexpr auto kernel = group_norm_fwd_kernel<T, SILU, V>;
  cudaError_t err = gn::prepare<kernel>();
  if (err != cudaSuccess) return err;
  // 16-byte vectors need 16-byte aligned tensors (check_plan has the rest).
  if (plan.vector &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  gn::cluster_config(cfg, attr, B * G * plan.cluster, plan.cluster, plan.threads, plan.smem,
                     stream);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), gamma, beta, static_cast<T*>(y),
                           mean, rstd, C, G, HW, eps, plan);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The variant the plan names: its chunk in registers (16-bit types) or in
// shared memory.
template <typename T, bool SILU>
cudaError_t launch(const void* x, const float* gamma, const float* beta, void* y, float* mean,
                   float* rstd, int B, int C, int G, int HW, float eps, const Plan& plan,
                   cudaStream_t stream) {
#define TB_GN_VARIANT(V) \
  launch_variant<T, SILU, V>(x, gamma, beta, y, mean, rstd, B, C, G, HW, eps, plan, stream)
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

// dtype: 0 float32, 1 float16, 2 bfloat16.  x and y are [B, C, HW]
// contiguous; gamma/beta fp32 [C]; mean/rstd fp32 [B, G].  The plan's
// fields (cluster, chunk, resident, threads, smem, regs, vector) come from
// ops/group_norm.py::plan_group_norm; an inconsistent plan returns
// cudaErrorInvalidValue.  Returns the launch's cudaError_t.
extern "C" int tb_group_norm_fwd(int dtype, const void* x, const void* gamma, const void* beta,
                                 void* y, void* mean, void* rstd, int B, int C, int G, int HW,
                                 float eps, int silu, int cluster, int chunk, int resident,
                                 int threads, int smem, int regs, int vector, void* stream) {
  const Plan plan{cluster, chunk, resident, threads, smem, regs, vector};
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  const cudaError_t ok = gn::check_plan(plan, B, C, G, HW, elem, 1);
  if (ok != cudaSuccess) return (int)ok;
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TB_GN_FWD(T)                                                                          \
  return (int)(silu ? launch<T, true>(x, ga, be, y, mu, rs, B, C, G, HW, eps, plan, s)        \
                    : launch<T, false>(x, ga, be, y, mu, rs, B, C, G, HW, eps, plan, s))
  switch (dtype) {
    case 0: TB_GN_FWD(float);
    case 1: TB_GN_FWD(__half);
    default: TB_GN_FWD(__nv_bfloat16);
  }
#undef TB_GN_FWD
}

// How many clusters of `cluster` CTAs (`threads` threads, `smem` bytes of
// dynamic shared memory each) of the forward kernel the card holds at once,
// in *out (0: it cannot schedule one).
extern "C" int tb_group_norm_fwd_active_clusters(int cluster, int threads, int smem, int* out) {
  return (int)gn::active_clusters<group_norm_fwd_kernel<__nv_bfloat16, true, 0>>(cluster, threads,
                                                                             smem, out);
}
