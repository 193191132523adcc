// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel textboost_tpu/ops/flash_attention.py:42
// _fwd_kernel (launched through _fwd, pallas_call at flash_attention.py:85): non-causal
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
// work is 4*N*M*D tensor-core operations per (batch, head) against 2*(N+2M)*D
// bytes, far above the H100's ~295 operations per byte, so memory does not
// bound it.  At D = 40 the tensor cores do not either: the softmax takes one
// ex2 per score, an SM retires 16 of them a clock, and N*M exponentials per
// (batch, head) take longer than the two products.  At D = 512 (the VAE's
// single head) the tensor cores bound it.
//
// Three variants share the entry point (hopper.cuh holds the shared pieces).
//
// wgmma, D <= 128 (bf16/fp16; D, the strides and the bases in whole 16-byte
// chunks).  One CTA per (batch*head, 128 query rows): a producer warpgroup
// whose one thread keeps a three-stage ring of 128-key K and V tiles filled by
// TMA (cp.async.bulk.tensor through tensor maps built per call over
// [B, S, H, D], 128-byte swizzle, one mbarrier pair per stage), and two
// consumer warpgroups of 64 query rows each.  A consumer computes S = Q K^T
// with wgmma m64n128k16, K from shared memory and Q from shared memory or,
// where D <= 64 leaves the registers, from fragments loaded once (the head
// dim padded to a multiple of 16 by the TMA unit's zero fill: 48 at D = 40), runs the online
// softmax on the accumulator in log2 units, and feeds P, rounded to the
// input dtype, from the same registers as the A operand of O += P V, whose B
// operand is V's row-major tile read MN-major with n = the head dim itself
// (40 and 80 pad nothing).  setmaxnreg moves registers from the producer to
// the consumers.  Two things keep the tensor cores busy under the softmax,
// which at D = 40 is the longer part: within a warpgroup S of tile j and P.V
// of tile j - 1 are started together and the softmax of tile j runs while
// P.V finishes; and the two warpgroups take turns at starting (hopper.cuh,
// turn_wait / turn_pass), so that one's wgmma run under the other's
// exponentials.  TMA rather than cp.async: the zero fill pads D and masks
// the ragged sequence ends for free, the swizzled layout is the one wgmma
// reads, and no thread spends registers on addresses.
//
// wgmma wide, 128 < D <= 512: see flash_fwd_wgmma_wide_kernel.
//
// CUDA cores (fp32, D not a multiple of 8, unaligned views; none at sd15's
// bf16 shapes): register tiles (flash_tiles.cuh), see flash_fwd_cc_kernel.
// One CTA of 256 threads per (batch*head, 64 query rows); K and V streamed
// 64 keys at a time by cp.async (the TPU kernel holds the whole [M, D] K/V in
// VMEM, which at D = 512 no CTA can), two stages where the head dim fits one
// tile and two CTAs still fit an SM, else D in chunks; each thread a 4 x 4
// block of S and 4 x 4 W4 of O, every shared-memory float4 feeding 4 to 16
// FMAs.  fp32 arithmetic throughout (no TF32), exp2f, the online softmax in
// log2 units with row maxima and sums reduced across the 16 threads sharing
// a row, the fp32 lse kept for the backward.  Bound: the two products on the
// CUDA cores at 67 TFLOP/s (fp32 inputs); the kernel reaches about a third
// of that (PERF.md), the rest going to what a 64 x 64 tile costs besides
// its FMAs.  Its only callers are explicit ones: impl="flash"
// (multi_head_attention, or flash_attention_forward directly) on fp32
// tensors, on a head dim that is not a multiple of 8, or on views whose
// strides are not; that is the JAX kernel's envelope (fp32/fp16/bf16, any
// D <= 512), which the wrapper keeps.  The "auto" rule admits bf16/fp16
// only, and every head dim of the shipped configs is a multiple of 8, so only
// `--attention_impl flash` in fp32 reaches it on a main path.  The backward
// kernel (flash_attention_bwd.cu) covers the same envelope.

#include "flash_tiles.cuh"

#include <math.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// The CUDA-core variant: register tiles (flash_tiles.cuh).
// ---------------------------------------------------------------------------
// One CTA of 256 threads per (batch*head, 64 query rows), K and V streamed
// 64 keys at a time.  S = Q K^T from Q's and K's rows (the whole head dim
// at once where it fits, with the next K/V tile's cp.async under this
// tile's products where two stages fit; else D in chunks); the online
// softmax on the thread's 4 x 4 block of S in log2 units, each row's maximum
// and sum reduced over the 16 threads of its thread-grid row (shuffles in a
// half warp), the rows' rescale factors through shared memory to the
// accumulator's tasks; P transposed into shared memory; O += P V with V's
// rows, each task's 4 rows x 4 W4 columns of O in registers.  Registers
// are capped so that three CTAs share an SM at W4 = 1 (D <= 64; 8% faster
// at sd15's level 0 than two) and two at W4 = 2.
template <typename T, int W4>
__global__ void __launch_bounds__(tiles::kThreads, W4 == 1 ? 3 : W4 == 2 ? 2 : 1)
flash_fwd_cc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse, int N, int M, int H, int D,
                    int G, int dc, int ld, int stages, long long q_sb, long long q_sn,
                    long long q_sh, long long k_sb, long long k_sm, long long k_sh,
                    long long v_sb, long long v_sm, long long v_sh, float scale_log2) {
  using namespace tiles;
  const int bw = 4 * W4 * G;                      // O's columns, >= D
  const bool one = dc >= D;                       // the whole head dim in one chunk
  const int ldv = one ? ld : bw;                  // V's rows
  const int v_floats = kTile * ldv + (one ? bw : 0);  // slack: reads past D
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [64][ld], Q's rows (a chunk of them)
  float* sK = sQ + kTile * ld;                   // [stages][64][ld]
  float* sV = sK + stages * kTile * ld;          // [stages][v_floats]
  float* sP = sV + stages * v_floats;            // [64][kLd], P transposed
  float* sA = sP + kTile * kLd;                  // [64], the rows' rescale factors, then 1 / l

  const int tx = tile_tx();
  const int ty = tile_ty();
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int ntiles = (M + kTile - 1) / kTile;
  const int cols = (dc + 3) / 4 * 4;  // staged columns of a chunk: zero to a whole float4
  const int rg = threadIdx.x / G;     // the accumulator task's row group (if < 16)

  auto load = [&](int j, int buf) {  // K and V of tile j (one chunk)
    stage(sK + buf * kTile * ld, ld, kb, k_sm, j * kTile, M, 0, cols, D);
    stage(sV + buf * v_floats, ld, vb, v_sm, j * kTile, M, 0, cols, D);
  };
  if (one) {
    stage(sQ, ld, qb, q_sn, q0, N, 0, cols, D);
    load(0, 0);
    hopper::cp_async_commit();
  }
  float m_run[4], l_run[4], acc[4][4 * W4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  zero<W4>(acc);

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    const int buf = stages == 2 ? (j & 1) : 0;
    float s[4][4] = {};
    if (one) {
      hopper::cp_async_wait<0>();
      __syncthreads();  // tile j is in; every thread is done with tile j - 1
      if (stages == 2 && j + 1 < ntiles) {
        load(j + 1, (j + 1) & 1);
        hopper::cp_async_commit();
      }
      dot_rows(s, sQ, ld, sK + buf * kTile * ld, ld, cols / 4);
    } else {
      for (int d0 = 0; d0 < D; d0 += dc) {
        const int c = min(dc, (D - d0 + 3) / 4 * 4);
        __syncthreads();  // the chunk tiles (and the last tile's sV, sP, sA) are consumed
        stage(sQ, ld, qb, q_sn, q0, N, d0, c, D);
        stage(sK, ld, kb, k_sm, k0, M, d0, c, D);
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
        __syncthreads();
        dot_rows(s, sQ, ld, sK, ld, c / 4);
      }
      stage(sV, bw, vb, v_sm, k0, M, 0, bw, D);
      hopper::cp_async_commit();
    }

    // Online softmax.  Key k0 (tx 0, q 0) is valid, so every row's maximum is finite.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = k0 + tx + 16 * c < M ? s[r][c] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = exp2f(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
      if (tx == 0) sA[4 * ty + r] = alpha;
    }
    store_pt(sP, s);
    if (!one) hopper::cp_async_wait<0>();
    __syncthreads();
    if (rg < 16) {
      const float4 alpha = reinterpret_cast<const float4*>(sA)[rg];
      const float al[4] = {alpha.x, alpha.y, alpha.z, alpha.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4 * W4; ++c) acc[r][c] *= al[r];
    }
    tile_acc<W4>(acc, sP, sV + buf * v_floats, ldv, G);
    if (one && stages == 1) {
      __syncthreads();
      if (j + 1 < ntiles) {
        load(j + 1, 0);
        hopper::cp_async_commit();
      }
    }
  }

  __syncthreads();  // every task has read the last rescale factors
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = q0 + 4 * ty + r;
    if (tx == 0) {
      sA[4 * ty + r] = 1.f / l_run[r];
      if (n < N) lse[(long long)bh * N + n] = (m_run[r] + log2f(l_run[r])) * kLn2;
    }
  }
  __syncthreads();
  if (rg < 16) {
    const float4 inv = reinterpret_cast<const float4*>(sA)[rg];
    const float mul[4] = {inv.x, inv.y, inv.z, inv.w};
    store_acc<T, W4>(o + ((long long)b * N * H + h) * D, (long long)H * D, acc, mul, q0, N, 0,
                     D, G);
  }
}

template <typename T, int W4>
cudaError_t launch_cc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int N, int M, int H, int D, const long long* qs, const long long* ks,
                      const long long* vs, float scale, cudaStream_t stream) {
  using namespace tiles;
  const int G = acc_groups(D, W4);
  const int bw = 4 * W4 * G;
  const Plan plan = pick_plan(D, 256, [&](int dc, int ld, int stages) {
    const bool one = dc >= D;
    return (long long)kTile * ld * (1 + stages) +
           (one ? (long long)stages * (kTile * ld + bw) : (long long)kTile * bw) +
           kTile * kLd + kTile;
  });
  if (plan.dc == 0) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_cc_kernel<T, W4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, plan.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, M, H, D, G, plan.dc, plan.ld, plan.stages, qs[0], qs[1], qs[2],
      ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale * kLog2e);
  return cudaGetLastError();
}

// Float4 columns an accumulator task holds: the least of the instantiated
// counts with which 16 row groups x G column groups cover D in 256 tasks.
template <typename T>
cudaError_t dispatch_cc(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int N, int M, int H, int D, const long long* qs,
                        const long long* ks, const long long* vs, float scale,
                        cudaStream_t stream) {
#define TB_LAUNCH(W4) launch_cc<T, W4>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream)
  const int w4 = ((D + 3) / 4 + 15) / 16;
  if (w4 <= 1) return TB_LAUNCH(1);
  if (w4 <= 2) return TB_LAUNCH(2);
  if (w4 <= 3) return TB_LAUNCH(3);
  if (w4 <= 4) return TB_LAUNCH(4);
  if (w4 <= 6) return TB_LAUNCH(6);
  if (w4 <= 8) return TB_LAUNCH(8);
  return cudaErrorInvalidValue;
#undef TB_LAUNCH
}

// ---------------------------------------------------------------------------
// wgmma variants.
// ---------------------------------------------------------------------------
using namespace hopper;

constexpr int kBQ = 128;                      // query rows per CTA, 64 per consumer warpgroup
constexpr int kTileKeys = 128;                // keys per K/V stage
constexpr int kStages = 3;

// DN: the width of P.V's accumulator (the head dim rounded up to one of the
// instantiated widths); the k extent of Q.K^T is DN rounded up to 16.
template <int DN> struct FwdTile {
  static constexpr int KP = (DN + 15) / 16 * 16;
  static constexpr int NSUB = DN > 64 ? 2 : 1;
  static constexpr int Q_BYTES = NSUB * kBQ * kRowBytes;
  static constexpr int KV_BYTES = NSUB * kTileKeys * kRowBytes;  // one of K, V per stage
  static constexpr int SMEM = 1024 + Q_BYTES + kStages * 2 * KV_BYTES + 64;
};

template <typename T, int DN>
__global__ void __launch_bounds__(kCtaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, T* __restrict__ o,
                       float* __restrict__ lse, int N, int kv_len, int H, int D,
                       float scale_log2) {
  using Tile = FwdTile<DN>;
  constexpr int NSUB = Tile::NSUB;
  constexpr int KSTEPS = Tile::KP / 16;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sK = sQ + Tile::Q_BYTES;
  uint8_t* sV = sK + kStages * Tile::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * Tile::KV_BYTES);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (kv_len + kTileKeys - 1) / kTileKeys;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < kWgThreads) {
    // Producer warpgroup: one thread keeps the K/V ring full.
    reg_dealloc<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(bar_q, Tile::Q_BYTES);
      tma_load_tile<NSUB>(sQ, kBQ, &map_q, h, q0, b, bar_q);
      for (int j = 0; j < ntiles; ++j) {
        const int stage = j % kStages;
        const uint32_t phase = (j / kStages) & 1;
        mbar_wait(empty + stage, phase ^ 1);
        mbar_arrive_expect_tx(full + stage, 2 * Tile::KV_BYTES);
        tma_load_tile<NSUB>(sK + stage * Tile::KV_BYTES, kTileKeys, &map_k, h, j * kTileKeys, b,
                            full + stage);
        tma_load_tile<NSUB>(sV + stage * Tile::KV_BYTES, kTileKeys, &map_v, h, j * kTileKeys, b,
                            full + stage);
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = tid / kWgThreads - 1;  // 0, 1: query rows 64 wg .. 64 wg + 63
    const int t = tid % kWgThreads;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * kRowBytes;

    float acc[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float s[kTileKeys / 2];             // the tile's scores, then its probabilities
    uint32_t pa[kTileKeys / 16][4];     // P of the previous tile as A fragments
    float alpha[2];

    // Q's fragments stay in registers where the accumulator leaves room, so
    // that the score product reads only K from shared memory.
    constexpr bool kQInRegs = DN <= 64;
    uint32_t qa[kQInRegs ? KSTEPS : 1][4];
    // S = Q K^T of the tile in `stage`: 64 rows x 128 keys (asynchronous).
    auto start_qk = [&](int stage) {
      const uint32_t k_addr = smem_u32(sK) + stage * Tile::KV_BYTES;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t off = (ks & 3) * 32;
        const uint64_t kd = desc_k_major(k_addr + (ks >> 2) * kTileKeys * kRowBytes + off);
        if constexpr (kQInRegs)
          WgmmaRS<kTileKeys>::template run<T, 0>(s, qa[ks], kd, ks > 0);
        else
          WgmmaSS<kTileKeys>::template run<T, 0>(
              s, desc_k_major(q_addr + (ks >> 2) * kBQ * kRowBytes + off), kd, ks > 0);
      }
      wgmma_commit();
    };
    // acc += P V with the tile in `stage`, P from `pa` (asynchronous).
    auto start_pv = [&](int stage) {
      const uint32_t v_addr = smem_u32(sV) + stage * Tile::KV_BYTES;
#pragma unroll
      for (int ks = 0; ks < kTileKeys / 16; ++ks)
        WgmmaRS<DN>::template run<T, 1>(
            acc, pa[ks], desc_mn_major(v_addr + ks * 16 * kRowBytes, kTileKeys * kRowBytes), 1);
      wgmma_commit();
    };
    // Online softmax of tile j in log2 units, rows g (e = 0) and g + 8
    // (e = 1): s becomes P, m_run and l_run move on, alpha is what the
    // accumulator must be scaled by.  Touches neither acc nor pa.
    auto softmax = [&](int j) {
      if (j == ntiles - 1 && kv_len - j * kTileKeys < kTileKeys) {
        const int left = kv_len - j * kTileKeys;  // >= 1: the tile's first key is valid
#pragma unroll
        for (int i = 0; i < kTileKeys / 2; ++i)
          if ((i >> 2) * 8 + tq * 2 + (i & 1) >= left) s[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kTileKeys / 2; i += 4) {
        mx[0] = fmaxf(mx[0], fmaxf(s[i], s[i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[i + 2], s[i + 3]));
      }
      float neg_m[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float m_new = fmaxf(m_run[e], mx[e] * scale_log2);  // finite
        alpha[e] = fast_exp2(m_run[e] - m_new);
        m_run[e] = m_new;
        neg_m[e] = -m_new;
      }
#pragma unroll
      for (int i = 0; i < kTileKeys / 2; ++i) {
        const int e = (i >> 1) & 1;
        s[i] = fast_exp2(fmaf(s[i], scale_log2, neg_m[e]));
        lsum[e] += s[i];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l_run[e] = l_run[e] * alpha[e] + lsum[e];
    };
    // Scale the accumulator and turn s into the next P.V's A fragments.
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int ks = 0; ks < kTileKeys / 16; ++ks) acc_to_a<T>(pa[ks], s, ks);
    };

    // Software pipeline over the tiles: S of tile j and P.V of tile j - 1
    // are in flight together, and the softmax of tile j runs under P.V.
    turn_init(wg);
    mbar_wait(bar_q, 0);
    if constexpr (kQInRegs)
      load_a_fragments<KSTEPS>(qa, sQ, kBQ * kRowBytes, wg * 64 + warp * 16);
    mbar_wait(full, 0);
    turn_wait(wg);
    wgmma_fence();
    start_qk(0);
    turn_pass(wg);
    wgmma_wait<0>();
    pin(s);
    softmax(0);
    rescale_and_pack();
    for (int j = 1; j < ntiles; ++j) {
      const int stage = j % kStages;
      const int prev = (j - 1) % kStages;
      mbar_wait(full + stage, (j / kStages) & 1);
      pin(pa);
      pin(acc);
      turn_wait(wg);
      wgmma_fence();
      start_qk(stage);
      start_pv(prev);
      turn_pass(wg);
      wgmma_wait<1>();  // S is there
      pin(s);
      softmax(j);
      wgmma_wait<0>();  // P.V is done
      pin(acc);
      if (lane == 0) mbar_arrive(empty + prev);
      rescale_and_pack();
    }
    {
      const int last = (ntiles - 1) % kStages;
      pin(pa);
      pin(acc);
      turn_wait(wg);
      wgmma_fence();
      start_pv(last);
      turn_pass(wg);
      wgmma_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(empty + last);
    }

#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 1);
      l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 2);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = q0 + wg * 64 + warp * 16 + g + 8 * e;
      if (n >= N) continue;
      const float inv = 1.f / l_run[e];
      T* orow = o + (((long long)b * N + n) * H + h) * D;
#pragma unroll
      for (int jn = 0; jn < DN / 8; ++jn) {
        const int d = jn * 8 + tq * 2;
        if (d < D)
          *reinterpret_cast<uint32_t*>(orow + d) =
              pack2<T>(acc[4 * jn + 2 * e] * inv, acc[4 * jn + 2 * e + 1] * inv);
      }
      if (tq == 0) lse[(long long)bh * N + n] = (m_run[e] + log2f(l_run[e])) * kLn2;
    }
  }
}

template <typename T, int DN>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int N, int M, int H, int D, const long long* qs, const long long* ks,
                         const long long* vs, float scale, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_tensor_map(&mq, bf16, q, B, N, H, D, qs[0], qs[1], qs[2], kBQ);
  if (err != cudaSuccess) return err;
  err = make_tensor_map(&mk, bf16, k, B, M, H, D, ks[0], ks[1], ks[2], kTileKeys);
  if (err != cudaSuccess) return err;
  err = make_tensor_map(&mv, bf16, v, B, M, H, D, vs[0], vs[1], vs[2], kTileKeys);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma_kernel<T, DN>;
  constexpr int smem = FwdTile<DN>::SMEM;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kCtaThreads, smem, stream>>>(mq, mk, mv, static_cast<T*>(o), lse, N, M, H, D,
                                               scale * kLog2e);
  return cudaGetLastError();
}

// Wide form, 128 < D <= 512 (the VAE mid block's single d = 512 head).  One
// CTA owns 64 query rows; its two consumer warpgroups each own half of the
// output's head dim (64 x DP/2 fp32 in registers).  For each 64-key tile
// warpgroup w computes the scores of keys 32 w .. 32 w + 31 over the whole
// head dim, the two exchange their row maxima through shared memory, and
// each writes its half of P (rounded to T) into one shared [64][64] tile;
// both then accumulate P . V over their half of V's columns.  K and V have
// one buffer each, with barriers of their own, so the next K tile loads
// under P . V and the next V tile under Q . K^T.
constexpr int kWideRows = 64;
constexpr int kWideKeys = 64;

template <int DP> struct WideTile {
  static constexpr int NSUB = DP / kSubCols;
  static constexpr int TILE_BYTES = NSUB * kWideRows * kRowBytes;  // each of Q, K, V
  static constexpr int P_BYTES = kWideRows * kRowBytes;
  static constexpr int SMEM = 1024 + 3 * TILE_BYTES + P_BYTES + 2 * kWideRows * 4 + 64;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kCtaThreads, 1)
flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, T* __restrict__ o,
                            float* __restrict__ lse, int N, int kv_len, int H, int D,
                            float scale_log2) {
  using Tile = WideTile<DP>;
  constexpr int NSUB = Tile::NSUB;
  constexpr int DH = DP / 2;  // output columns per consumer warpgroup
  constexpr int SUB_BYTES = kWideRows * kRowBytes;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sK = sQ + Tile::TILE_BYTES;
  uint8_t* sV = sK + Tile::TILE_BYTES;
  uint8_t* sP = sV + Tile::TILE_BYTES;
  float* sX = reinterpret_cast<float*>(sP + Tile::P_BYTES);  // [2][64] row maxima / sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + 2 * kWideRows);
  uint64_t* bar_q = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = bars + 2;
  uint64_t* v_full = bars + 3;
  uint64_t* v_empty = bars + 4;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kWideRows;
  const int ntiles = (kv_len + kWideKeys - 1) / kWideKeys;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, kConsumerWarps);
    mbar_init(v_empty, kConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < kWgThreads) {
    reg_dealloc<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(bar_q, Tile::TILE_BYTES);
      tma_load_tile<NSUB>(sQ, kWideRows, &map_q, h, q0, b, bar_q);
      for (int j = 0; j < ntiles; ++j) {
        const uint32_t phase = j & 1;
        mbar_wait(k_empty, phase ^ 1);
        mbar_arrive_expect_tx(k_full, Tile::TILE_BYTES);
        tma_load_tile<NSUB>(sK, kWideKeys, &map_k, h, j * kWideKeys, b, k_full);
        mbar_wait(v_empty, phase ^ 1);
        mbar_arrive_expect_tx(v_full, Tile::TILE_BYTES);
        tma_load_tile<NSUB>(sV, kWideKeys, &map_v, h, j * kWideKeys, b, v_full);
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = tid / kWgThreads - 1;  // keys 32 wg .. of a tile; output columns DH wg ..
    const int t = tid % kWgThreads;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8
    const uint32_t q_addr = smem_u32(sQ);
    const uint32_t k_addr = smem_u32(sK) + wg * 32 * kRowBytes;
    const uint32_t v_addr = smem_u32(sV) + wg * (NSUB / 2) * SUB_BYTES;
    const uint32_t p_addr = smem_u32(sP);

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int j = 0; j < ntiles; ++j) {
      const uint32_t phase = j & 1;
      mbar_wait(k_full, phase);
      float s[16];  // 64 rows x this warpgroup's 32 keys
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t off = (ks >> 2) * SUB_BYTES + (ks & 3) * 32;
        WgmmaSS<32>::template run<T, 0>(s, desc_k_major(q_addr + off), desc_k_major(k_addr + off),
                                        ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(k_empty);

      const int left = kv_len - j * kWideKeys - wg * 32;  // valid keys of this half; may be <= 0
      if (left < 32) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if ((i >> 2) * 8 + tq * 2 + (i & 1) >= left) s[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        mx[0] = fmaxf(mx[0], fmaxf(s[i], s[i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[i + 2], s[i + 3]));
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        if (tq == 0) sX[wg * kWideRows + row0 + 8 * e] = mx[e];
      }
      // Both halves' maxima are written; the previous tile's P is consumed.
      named_barrier_sync(1, 2 * kWgThreads);
      float alpha[2], neg_m[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float other = sX[(1 - wg) * kWideRows + row0 + 8 * e];
        const float m_new = fmaxf(m_run[e], fmaxf(mx[e], other) * scale_log2);  // finite
        alpha[e] = fast_exp2(m_run[e] - m_new);
        m_run[e] = m_new;
        neg_m[e] = -m_new;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int e = (i >> 1) & 1;
        s[i] = fast_exp2(fmaf(s[i], scale_log2, neg_m[e]));
        lsum[e] += s[i];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l_run[e] = l_run[e] * alpha[e] + lsum[e];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<uint32_t*>(
              sP + swizzled_offset(row0 + 8 * e, wg * 32 + jn * 8 + tq * 2)) =
              pack2<T>(s[4 * jn + 2 * e], s[4 * jn + 2 * e + 1]);
      }
      fence_proxy_async();
      // P is whole; the maxima are consumed.
      named_barrier_sync(2, 2 * kWgThreads);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      mbar_wait(v_full, phase);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWideKeys / 16; ++ks)
        WgmmaSS<DH>::template run<T, 1>(
            acc, desc_k_major(p_addr + ks * 32),
            desc_mn_major(v_addr + ks * 16 * kRowBytes, SUB_BYTES), 1);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(v_empty);
    }

#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 1);
      l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 2);
    }
    named_barrier_sync(1, 2 * kWgThreads);  // the last tile's maxima are consumed
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (tq == 0) sX[wg * kWideRows + row0 + 8 * e] = l_run[e];
    named_barrier_sync(2, 2 * kWgThreads);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = q0 + row0 + 8 * e;
      if (n >= N) continue;
      const float l = l_run[e] + sX[(1 - wg) * kWideRows + row0 + 8 * e];
      const float inv = 1.f / l;
      T* orow = o + (((long long)b * N + n) * H + h) * D + wg * DH;
#pragma unroll
      for (int jn = 0; jn < DH / 8; ++jn) {
        const int d = jn * 8 + tq * 2;
        if (wg * DH + d < D)
          *reinterpret_cast<uint32_t*>(orow + d) =
              pack2<T>(acc[4 * jn + 2 * e] * inv, acc[4 * jn + 2 * e + 1] * inv);
      }
      if (wg == 0 && tq == 0) lse[(long long)bh * N + n] = (m_run[e] + log2f(l)) * kLn2;
    }
  }
}

template <typename T, int DP>
cudaError_t launch_wgmma_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int N, int M, int H, int D, const long long* qs,
                              const long long* ks, const long long* vs, float scale,
                              cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_tensor_map(&mq, bf16, q, B, N, H, D, qs[0], qs[1], qs[2], kWideRows);
  if (err != cudaSuccess) return err;
  err = make_tensor_map(&mk, bf16, k, B, M, H, D, ks[0], ks[1], ks[2], kWideKeys);
  if (err != cudaSuccess) return err;
  err = make_tensor_map(&mv, bf16, v, B, M, H, D, vs[0], vs[1], vs[2], kWideKeys);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma_wide_kernel<T, DP>;
  constexpr int smem = WideTile<DP>::SMEM;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kWideRows - 1) / kWideRows, B * H);
  kernel<<<grid, kCtaThreads, smem, stream>>>(mq, mk, mv, static_cast<T*>(o), lse, N, M, H, D,
                                               scale * kLog2e);
  return cudaGetLastError();
}

// The wgmma variants load through TMA: whole 16-byte chunks of the head dim,
// 16-byte aligned bases, strides in whole chunks.
bool wgmma_eligible(const void* q, const void* k, const void* v, int D, const long long* qs,
                    const long long* ks, const long long* vs) {
  if (D > 512 || D % 8 != 0) return false;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return false;
  for (int i = 0; i < 3; ++i)
    if (qs[i] % 8 || ks[i] % 8 || vs[i] % 8) return false;
  return true;
}

enum Variant { kCudaCores = 0, kWgmma = 1, kWgmmaWide = 2 };

template <typename T>
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int N, int M, int H, int D, const long long* qs,
                           const long long* ks, const long long* vs, float scale,
                           cudaStream_t stream) {
#define TB_ARGS q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, scale, stream
  if (D > 256) return launch_wgmma_wide<T, 512>(TB_ARGS);
  if (D > 128) return launch_wgmma_wide<T, 256>(TB_ARGS);
  if (D <= 16) return launch_wgmma<T, 16>(TB_ARGS);
  if (D <= 32) return launch_wgmma<T, 32>(TB_ARGS);
  if (D <= 40) return launch_wgmma<T, 40>(TB_ARGS);
  if (D <= 64) return launch_wgmma<T, 64>(TB_ARGS);
  if (D <= 80) return launch_wgmma<T, 80>(TB_ARGS);
  return launch_wgmma<T, 128>(TB_ARGS);
#undef TB_ARGS
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  Strides are in elements:
// (batch, sequence, head) for each of q, k, v; the head dim has stride 1.
// M is the number of keys attended to (kv_len).  Writes to *variant which
// kernel serves the call: 0 CUDA cores, 1 wgmma (D <= 128), 2 wgmma wide
// (128 < D <= 512).  Returns the launch's cudaError_t (0 on success).
extern "C" int tb_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int N, int M, int H, int D,
                                      long long q_sb, long long q_sn, long long q_sh,
                                      long long k_sb, long long k_sm, long long k_sh,
                                      long long v_sb, long long v_sm, long long v_sh,
                                      float scale, void* stream, int* variant) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || D > 512 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_sn, q_sh};
  const long long ks[3] = {k_sb, k_sm, k_sh};
  const long long vs[3] = {v_sb, v_sm, v_sh};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wgmma = dtype != 0 && wgmma_eligible(q, k, v, D, qs, ks, vs);
  *variant = !wgmma ? kCudaCores : D > 128 ? kWgmmaWide : kWgmma;
  switch (dtype) {
    case 0: return (int)dispatch_cc<float>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
    case 1:
      if (wgmma) return (int)dispatch_wgmma<__half>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
      return (int)dispatch_cc<__half>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
    case 2:
      if (wgmma)
        return (int)dispatch_wgmma<__nv_bfloat16>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
      return (int)dispatch_cc<__nv_bfloat16>(q, k, v, o, l, B, N, M, H, D, qs, ks, vs, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
