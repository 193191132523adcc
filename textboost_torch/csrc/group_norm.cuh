// The GroupNorm kernels' common body: one (sample, group) span per
// thread-block cluster, each CTA's chunk read from device memory once.
//
// x (and dy) are NCHW-contiguous, viewed as [B, C, HW], so each (sample,
// group) is one contiguous span of (C/G)*HW elements.  The launch plan
// (ops/group_norm.py::plan_group_norm, checked here by check_plan) splits a
// span over a cluster of `cluster` CTAs (1-16): CTA `rank` takes the
// elements [rank*chunk, min((rank+1)*chunk, span)).  Of its chunk, the first
// `resident` elements (all of them unless the span is streamed) are copied
// into shared memory once; the rest is read from device memory for the sums
// and read again for the output.
//
//   1. Copy.  With 16-byte vectors (Plan::vector: HW * sizeof(T) % 16 == 0
//      and 16-byte aligned pointers, both checked at launch) one thread
//      issues 1-D bulk copies (cp.async.bulk) of kPieceBytes each, one
//      mbarrier per piece, so the sums of a piece start as soon as it
//      lands; the streamed remainder is summed from device memory
//      meanwhile.  A small 16-bit chunk (Plan::regs > 0: at most a
//      few vectors a thread) skips shared memory: each thread loads its
//      vectors into registers and keeps them there until the output.
//      Without vectors every thread loads element by element.
//   2. Sums.  Each CTA reduces its chunk in fp32 (the Op says what it sums:
//      x and x^2 forward, dxh and dxh*x_hat backward): per thread in a fixed
//      order, then warp shuffles, then the warps in order.  After a cluster
//      barrier, warp 0 of every CTA reads the `cluster` partials through
//      distributed shared memory in rank order, so every CTA holds the same
//      totals and the result does not change from run to run.
//   3. Output.  Each CTA writes its part of y (or dx) from shared memory,
//      16 bytes a store, and re-reads only its streamed remainder.  The
//      second cluster barrier is split: each CTA arrives once it has read
//      the others' partials and waits just before it exits, so no CTA
//      leaves while another may still read its shared memory.
//
// Bytes moved, by design (no run counts the card's memory traffic): one
// read of x (and dy) and one write of y (or dx) for a resident span (in
// shared memory or registers), the bound's bytes; a streamed span re-reads
// its remainder.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"

namespace gn {

using hopper::mbar_arrive_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int kMaxCluster = 16;       // 16 needs cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int kMaxThreads = 512;
constexpr int kPieceBytes = 16384;    // one bulk copy, one mbarrier
constexpr int kSmemBytes = 231424;    // dynamic shared memory a CTA may ask for (227 KB less 1 KB)
constexpr int kMaxPieces = (kSmemBytes + kPieceBytes - 1) / kPieceBytes;
constexpr int kRegs[] = {1, 2, 4};  // the register-resident variants (Plan::regs)

using hopper::from_float;
using hopper::to_float;

// 16 bytes of T, loaded and stored as one vector.
template <typename T> struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// sigmoid(z) with the special-function unit's exponential and reciprocal
// (2 ulp; 0 where 1 + e^-z overflows, which is sigmoid's limit there).
// Moving the reciprocal to Newton steps on the fp32 pipe was slower on an
// H100: the fp32 pipe, not the special-function unit, is the busier one.
__device__ __forceinline__ float fast_sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

// The launch plan, as ops/group_norm.py::GroupNormPlan gives it.
struct Plan {
  int cluster;   // CTAs per span, one cluster
  int chunk;     // elements per CTA (the last CTA takes what is left)
  int resident;  // elements per CTA and tensor held in shared memory
  int threads;
  int smem;      // dynamic shared memory bytes
  int regs;      // 16-byte vectors per thread and tensor held in registers (0: shared memory)
  int vector;    // 1: 16-byte loads, bulk copies and stores; 0: element by element
};

// Byte offset of the second tensor (dy) in dynamic shared memory.
__host__ __device__ __forceinline__ int second_tensor_offset(int resident, int elem_bytes) {
  return (resident * elem_bytes + 15) / 16 * 16;
}

// cudaSuccess if `p` is one that plan_group_norm could give for this shape.
inline cudaError_t check_plan(const Plan& p, int B, int C, int G, int HW, int elem_bytes,
                              int tensors) {
  if (B <= 0 || C <= 0 || G <= 0 || HW <= 0 || C % G != 0) return cudaErrorInvalidValue;
  const long long span = (long long)(C / G) * HW;
  const int vec = 16 / elem_bytes;
  if (p.vector != 0 && p.vector != 1) return cudaErrorInvalidValue;
  if (p.vector && (long long)HW * elem_bytes % 16 != 0) return cudaErrorInvalidValue;
  if (span >= (1ll << 31) || (long long)B * G * p.cluster >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.chunk <= 0) return cudaErrorInvalidValue;
  // The chunks tile the span: every CTA has at least one element.
  if ((long long)p.chunk * (p.cluster - 1) >= span || (long long)p.chunk * p.cluster < span)
    return cudaErrorInvalidValue;
  if (p.vector && (p.chunk % vec != 0 || p.resident % vec != 0)) return cudaErrorInvalidValue;
  if (p.resident < 0 || p.resident > p.chunk) return cudaErrorInvalidValue;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32 != 0)
    return cudaErrorInvalidValue;
  if (p.smem < 0 || p.smem > kSmemBytes) return cudaErrorInvalidValue;
  if (p.regs != 0) {
    // The whole chunk in registers: 16-bit vectors, kRegs[] of them a thread.
    if (elem_bytes != 2 || !p.vector || p.resident != p.chunk ||
        (long long)p.regs * p.threads * vec < p.chunk)
      return cudaErrorInvalidValue;
    for (int r : kRegs)
      if (r == p.regs) return cudaSuccess;
    return cudaErrorInvalidValue;
  }
  if (p.smem < (long long)second_tensor_offset(p.resident, elem_bytes) * tensors)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// ---- clusters -----------------------------------------------------------------
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float2 at `p` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ float2 load_from_rank(const float2* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, reported to `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the body -----------------------------------------------------------------
// x (and dy) of one 16-byte vector.
template <typename T> struct Pair {
  Vec<T> x, d;
};

// use(i, load(i)) for i in [begin, end) in steps of blockDim.x.
template <class Load, class Use>
__device__ __forceinline__ void strided(int begin, int end, Load load, Use use) {
  for (int i = begin + (int)threadIdx.x; i < end; i += blockDim.x) use(i, load(i));
}

// Shared state of one CTA beside the dynamic shared memory.
struct Scratch {
  uint64_t bars[kMaxPieces];
  float2 warp_sums[kMaxThreads / 32];
  float2 partial;  // this CTA's sums, read by the whole cluster
  float2 total;    // the span's sums
};

// What an Op provides (see group_norm_fwd.cu and group_norm_bwd.cu):
//   kTensors            1 (x) or 2 (x, dy)
//   kStatsUseChannel    whether sums() reads gamma/beta
//   sums(x, d, ga, be, s1, s2)      adds one element to the two sums
//   finish(t1, t2, inv_n, bg, w)    turns the span's totals into constants
//                                   (and, if w, writes what the span returns)
//   out(x, d, ga, be) -> float      one output element
template <int V, typename T, class Op>
__device__ __forceinline__ void span_body(Op& op, const T* __restrict__ x,
                                          const T* __restrict__ dy, T* __restrict__ out,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta, int C, int G, int HW,
                                          const Plan& p, uint8_t* smem, Scratch& sh) {
  constexpr int kV = Vec<T>::kN;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rank = blockIdx.x % p.cluster;
  const int bg = blockIdx.x / p.cluster;
  const int b = bg / G;
  const int g = bg - b * G;
  const int cg = C / G;
  const int span = cg * HW;
  const int start = rank * p.chunk;             // first element of this CTA's chunk
  const int len = min(p.chunk, span - start);   // > 0 (check_plan)
  const int res = min(p.resident, len);         // elements held in shared memory
  const long long base = ((long long)b * C + (long long)g * cg) * HW + start;
  const T* xs = x + base;
  const T* ds = Op::kTensors == 2 ? dy + base : nullptr;
  T* os = out + base;
  T* sx = reinterpret_cast<T*>(smem);
  T* sd = reinterpret_cast<T*>(smem + second_tensor_offset(p.resident, sizeof(T)));
  const float* gam = gamma + g * cg;
  const float* bet = beta + g * cg;
  // One 16-byte vector of x (and dy), from device or shared memory.
  auto from_global = [&](int i) {
    Pair<T> v;
    v.x = reinterpret_cast<const Vec<T>*>(xs)[i];
    if constexpr (Op::kTensors == 2) v.d = reinterpret_cast<const Vec<T>*>(ds)[i];
    return v;
  };
  auto from_shared = [&](int i) {
    Pair<T> v;
    v.x = reinterpret_cast<const Vec<T>*>(sx)[i];
    if constexpr (Op::kTensors == 2) v.d = reinterpret_cast<const Vec<T>*>(sd)[i];
    return v;
  };

  // 1-2. Copy and sum ---------------------------------------------------------
  // V > 0: thread t holds the chunk's vectors t, t + nthreads, ... in registers.
  Pair<T> held[V > 0 ? V : 1];
  float s1 = 0.f, s2 = 0.f;
  auto add = [&](const T* xe, const T* de, int n, int first) {
    float ga = 0.f, be = 0.f;
    if constexpr (Op::kStatsUseChannel) {
      const int c = (start + first) / HW;
      ga = gam[c];
      be = bet[c];
    }
#pragma unroll
    for (int e = 0; e < n; ++e)
      op.sums(to_float<T>(xe[e]), Op::kTensors == 2 ? to_float<T>(de[e]) : 0.f, ga, be, s1, s2);
  };
  if constexpr (V > 0) {
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (tid + u * nthreads < len / kV) held[u] = from_global(tid + u * nthreads);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int i = tid + u * nthreads;
      if (i < len / kV) add(held[u].x.v, held[u].d.v, kV, i * kV);
    }
  } else if (p.vector) {
    const int bytes = res * (int)sizeof(T);
    const int pieces = (bytes + kPieceBytes - 1) / kPieceBytes;
    if (tid == 0) {
      for (int i = 0; i < pieces; ++i) mbar_init(&sh.bars[i], 1);
      mbar_fence_init();
      for (int i = 0; i < pieces; ++i) {
        const int off = i * kPieceBytes;
        const int n = min(kPieceBytes, bytes - off);
        mbar_arrive_expect_tx(&sh.bars[i], (uint32_t)(n * Op::kTensors));
        bulk_load(smem + off, reinterpret_cast<const uint8_t*>(xs) + off, n, &sh.bars[i]);
        if constexpr (Op::kTensors == 2)
          bulk_load(reinterpret_cast<uint8_t*>(sd) + off,
                    reinterpret_cast<const uint8_t*>(ds) + off, n, &sh.bars[i]);
      }
    }
    __syncthreads();  // the barriers are initialised before anyone waits on them
    auto add_vec = [&](int i, const Pair<T>& v) { add(v.x.v, v.d.v, kV, i * kV); };
    // The streamed remainder, from device memory, while the copies land.
    strided(res / kV, len / kV, from_global, add_vec);
    constexpr int kPieceVecs = kPieceBytes / 16;
    for (int i = 0; i < pieces; ++i) {
      mbar_wait(&sh.bars[i], 0);
      strided(i * kPieceVecs, min((i + 1) * kPieceVecs, res / kV), from_shared,
                           add_vec);
    }
  } else {
    for (int i = tid; i < len; i += nthreads) {
      T a = xs[i], d = a;
      if constexpr (Op::kTensors == 2) d = ds[i];
      if (i < res) {
        sx[i] = a;
        if constexpr (Op::kTensors == 2) sd[i] = d;
      }
      add(&a, &d, 1, i);
    }
  }

  // The CTA's sums: warps in order, into sh.partial.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) sh.warp_sums[warp] = make_float2(s1, s2);
  __syncthreads();
  if (tid == 0) {
    float2 t = make_float2(0.f, 0.f);
    for (int w = 0; w < nthreads / 32; ++w) {
      t.x += sh.warp_sums[w].x;
      t.y += sh.warp_sums[w].y;
    }
    sh.partial = t;
  }
  cluster_arrive();  // every CTA's partial is written ...
  cluster_wait();    // ... and visible to the whole cluster
  if (warp == 0) {
    const float2 mine =
        lane < p.cluster ? load_from_rank(&sh.partial, lane) : make_float2(0.f, 0.f);
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < p.cluster; ++r) {  // rank order, the same in every CTA
      t1 += __shfl_sync(0xffffffffu, mine.x, r);
      t2 += __shfl_sync(0xffffffffu, mine.y, r);
    }
    if (lane == 0) sh.total = make_float2(t1, t2);
  }
  __syncthreads();
  cluster_arrive();  // done with the other CTAs' shared memory (waited for at exit)
  op.finish(sh.total.x, sh.total.y, 1.f / (float)span, bg, rank == 0 && tid == 0);

  // 3. Output ---------------------------------------------------------------------
  auto write = [&](int i, const Pair<T>& v) {
    const int c = (start + i * kV) / HW;  // HW % kV == 0: one channel per vector
    const float ga = gam[c], be = bet[c];
    Vec<T> o;
#pragma unroll
    for (int e = 0; e < kV; ++e)
      o.v[e] = from_float<T>(op.out(to_float<T>(v.x.v[e]),
                                    Op::kTensors == 2 ? to_float<T>(v.d.v[e]) : 0.f, ga, be));
    reinterpret_cast<Vec<T>*>(os)[i] = o;
  };
  if constexpr (V > 0) {
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (tid + u * nthreads < len / kV) write(tid + u * nthreads, held[u]);
  } else if (p.vector) {
    strided(0, len / kV, [&](int i) { return i < res / kV ? from_shared(i) : from_global(i); },
            write);
  } else {
    for (int i = tid; i < len; i += nthreads) {
      const T a = i < res ? sx[i] : xs[i];
      float d = 0.f;
      if constexpr (Op::kTensors == 2) d = to_float<T>(i < res ? sd[i] : ds[i]);
      const int c = (start + i) / HW;
      os[i] = from_float<T>(op.out(to_float<T>(a), d, gam[c], bet[c]));
    }
  }
  cluster_wait();
}

// ---- launch -----------------------------------------------------------------------
// Raises the kernel's shared-memory limit and allows 16-CTA clusters, once
// per kernel and device.
template <auto kernel> cudaError_t prepare() {
  static uint32_t done = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

inline void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int grid,
                           int cluster, int threads, int smem, cudaStream_t stream) {
  cfg = {};
  attr = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one CTA: an implicit cluster of one
}

// How many clusters of `cluster` CTAs of `kernel`, each with `threads`
// threads and `smem` bytes of dynamic shared memory, the card can hold at
// once, in *out (0: such a cluster cannot be scheduled).
template <auto kernel>
cudaError_t active_clusters(int cluster, int threads, int smem, int* out) {
  *out = 0;
  cudaError_t err = prepare<kernel>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, cluster, cluster, threads, smem, nullptr);
  cfg.numAttrs = 1;  // the query needs the cluster's size, one CTA too
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace gn
