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
// their strides (head dim contiguous); dq, dk, dv are written through their
// strides in the input dtype, rows of dk/dv at or past kv_len as zeros, and
// no row at or past N (dq) or M (dk, dv).  K and V are never padded in
// device memory: keys past kv_len read as zeros (TMA zero fill, or the
// CUDA-core staging) and are masked.
//
// Design: the deterministic two-kernel split.  The TPU kernel runs its grid
// in order on one core, so one fused program per KV block can add into a dq
// output revisited across the "arbitrary" grid axis (5 matmuls per tile
// pair).  On Hopper the CTAs run at once and in no order: that carry does
// not exist, and a fused kernel would need fp32 atomicAdd into dq, whose sum
// order (and so its bits) changes from run to run.  Here:
//   1. flash_bwd_dq_kernel, one CTA per (batch*head, 128 query rows):
//      computes delta for its rows (written to an fp32 [B, H, N] scratch),
//      then streams 64-key K/V tiles and accumulates dQ in fp32 registers
//      (S, dP, dQ: 3 matmuls per tile pair), cast once at the end;
//   2. flash_bwd_dkdv_kernel, one CTA per (batch*head, 128 keys): streams
//      64-row Q/dO tiles (with their lse and delta) and accumulates dK and dV
//      in fp32 registers (S^T, dP^T, dV, dK: 4 matmuls per tile pair).
// 7 matmuls per tile pair against the fused design's 5, with no atomics and
// bit-identical results from run to run.
//
// Both kernels are built from hopper.cuh's pieces, like the forward: a
// producer warpgroup keeps a three-stage ring of streamed tiles filled by TMA
// (tensor maps over [B, S, H, D], 128-byte swizzle, zero fill past D and
// past the sequence end, an mbarrier pair per stage), and two consumer
// warpgroups of 64 rows (dQ) or 64 keys (dK/dV) each run every product
// with wgmma, fp32 accumulation.  The score-shaped products read both
// operands from shared memory (m64n64k16).  P and dS never leave registers:
// rounded to the input dtype, the score accumulators are the A operands of
// the next products, whose B operands are the streamed row-major tiles read
// MN-major with n = the head dim.  That is why the dK/dV kernel computes the
// transposed scores S^T = K Q^T and dP^T = V dO^T: its CTA's keys are the
// wgmma rows, so P^T and dS^T come out as A operands of dV += P^T dO and
// dK += dS^T Q; lse and delta, per query row, are per accumulator column
// there and are staged in shared memory beside each Q/dO tile.  The five
// (dQ kernel: three) products of a tile pair are started behind one wait, the
// accumulating ones of tile j together with the score-shaped ones of tile
// j + 1, and the two warpgroups take turns at starting (hopper.cuh, turn_wait
// / turn_pass), so that one's wgmma run under the other's exponentials.  At
// D = 128 the dK/dV kernel's two 64 x 128 accumulators beside two 64 x 64
// score tiles exceed the registers (ptxas spills 320 bytes and serialises
// the wgmma there); no shipped config trains at that head dim.
//
// Envelope: the JAX backward's (fp32/fp16/bf16, any D <= 512, any KV
// length), in two variants the C entry point chooses between and reports:
//   wgmma (above): bf16/fp16, D <= 128, D and every stride a multiple of 8,
//   16-byte aligned pointers (the wrapper asks tb_flash_attention_bwd_wgmma_form
//   and copies a view of such a tensor that is not).  It serves every self- and cross-attention of the shipped
//   configs at D = 40, 64 and 80, the 77 text keys included.
//   CUDA cores (cc:: below): fp32 at any D, 128 < D <= 512 (sd15's 160-wide
//   heads at 16x16 latents, the VAE's 512), D % 8 != 0, and views whose
//   strides or bases TMA cannot read, in place.  The same split: one CTA per
//   (batch*head, 16-32 query rows) for delta + dQ with K/V streamed 32 keys
//   at a time through shared memory, one CTA per (batch*head, 8-32 keys)
//   for dK/dV with Q/dO streamed 32 rows at a time; scores with one key (or
//   query row) per lane and the other operand as shared-memory broadcasts,
//   the accumulating products with head columns l, l + 32, ... per lane;
//   fp32 arithmetic and accumulators, exp2f; D in chunks of 32 columns up to
//   512 (shared memory up to ~196 KB a CTA at D = 512, set with
//   cudaFuncSetAttribute).  No atomics in either variant: the same bits from
//   run to run.
//
// Bound on the card.  At sd15's shapes (N = M = 4096, D = 40 or 80) the least
// work is 5 products of 2*N*M*D operations per (batch, head), i.e.
// 10*B*H*N^2*D, against 8*N*D elements moved (q, k, v, o, dO in; dq, dk, dv
// out): far above the H100's ~295 operations per byte, so operations bound
// it: the five products at the tensor cores' rate and, at D = 40, almost as
// much again the N*M exponentials per (batch, head) at 16 ex2 a clock on
// each SM.  The split does 7 products and computes every exponential twice
// (once in each kernel); that is the price of results without atomics.  In
// fp32 the products run on the CUDA cores (67 TFLOP/s, not the tensor cores'
// 989), which bound the CUDA-core variant; at M = 77 (cross-attention over
// the text) in a 16-bit type the bytes of q, o, dO and dq bound it.  The
// CUDA-core variant
// reads every operand from shared memory once per multiply-add pair, so it
// runs well below that bound (PERF.md); a wgmma form for wide heads is later
// work.

#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int kOwnRows = 128;  // query rows per dQ CTA, keys per dK/dV CTA: 64 per warpgroup
constexpr int kTileRows = 64;  // streamed keys per dQ tile, query rows per dK/dV tile
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

// Element strides (batch, sequence, head) of the five inputs and the three
// outputs; the head dim has stride 1.
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

// DN: the accumulators' width (the head dim rounded up to one of the
// instantiated widths); the k extent of the score products is DN rounded up
// to 16.  OWN: the CTA's resident tiles (two of them), STREAM: one stage.
template <int DN> struct BwdTile {
  static constexpr int KP = (DN + 15) / 16 * 16;
  static constexpr int NSUB = DN > 64 ? 2 : 1;
  static constexpr int OWN_BYTES = NSUB * kOwnRows * kRowBytes;
  static constexpr int STREAM_BYTES = NSUB * kTileRows * kRowBytes;
  static constexpr int SMEM =
      1024 + 2 * OWN_BYTES + kStages * 2 * STREAM_BYTES + 2 * kOwnRows * 4 + 64;
};

// acc[64 x 64] = A[64 rows x KP] * B[64 rows x KP]^T, both K-major tiles whose
// sub-tiles are `a_sub` / `b_sub` bytes apart.
template <typename T, int KSTEPS>
__device__ __forceinline__ void rows_dot(float (&acc)[32], uint32_t a_addr, uint32_t a_sub,
                                         uint32_t b_addr, uint32_t b_sub) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const uint32_t off = (ks & 3) * 32;
    WgmmaSS<kTileRows>::template run<T, 0>(acc, desc_k_major(a_addr + (ks >> 2) * a_sub + off),
                                           desc_k_major(b_addr + (ks >> 2) * b_sub + off), ks > 0);
  }
}

// The same with A from the fragments `a` (load_a_fragments).
template <typename T, int KSTEPS>
__device__ __forceinline__ void rows_dot(float (&acc)[32], const uint32_t (&a)[KSTEPS][4],
                                         uint32_t b_addr, uint32_t b_sub) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    WgmmaRS<kTileRows>::template run<T, 0>(
        acc, a[ks], desc_k_major(b_addr + (ks >> 2) * b_sub + (ks & 3) * 32), ks > 0);
}

// Whether a warpgroup keeps the fragments of its two resident tiles in
// registers (2 * KSTEPS * 4 of them) instead of having every wgmma read
// them from shared memory: where the accumulators leave room.
template <int DN> struct ResidentInRegisters {
  static constexpr bool value = DN <= 64;
};

// acc[64 x DN] += X[64 x 64] * tile[64 rows x DN], X from the fragments `xa`.
template <typename T, int DN>
__device__ __forceinline__ void acc_times_tile(float (&acc)[DN / 2],
                                               const uint32_t (&xa)[kTileRows / 16][4],
                                               uint32_t tile_addr) {
#pragma unroll
  for (int ks = 0; ks < kTileRows / 16; ++ks)
    WgmmaRS<DN>::template run<T, 1>(
        acc, xa[ks], desc_mn_major(tile_addr + ks * 16 * kRowBytes, kTileRows * kRowBytes), 1);
}

// Rows row0 + g and row0 + g + 8 of acc * mul as T into an output [B, rows,
// H, D] with element strides `os` (batch, sequence, head); no row at or past
// `rows` is written.
template <typename T, int DN>
__device__ __forceinline__ void store_rows(T* out, const long long (&os)[3],
                                           const float (&acc)[DN / 2], float mul, int b, int h,
                                           int D, int rows, int row0, int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = row0 + (lane >> 2) + 8 * e;
    if (n >= rows) continue;
    T* orow = out + b * os[0] + n * os[1] + h * os[2];
#pragma unroll
    for (int jn = 0; jn < DN / 8; ++jn) {
      const int d = jn * 8 + (lane & 3) * 2;
      if (d < D)
        *reinterpret_cast<uint32_t*>(orow + d) =
            pack2<T>(acc[4 * jn + 2 * e] * mul, acc[4 * jn + 2 * e + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. delta and dQ, one CTA per (batch*head, 128 query rows).
// ---------------------------------------------------------------------------
template <typename T, int DN>
__global__ void __launch_bounds__(kCtaThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int N, int kv_len, int H,
                    int D, const Strides st, float scale) {
  using Tile = BwdTile<DN>;
  constexpr int NSUB = Tile::NSUB;
  constexpr int KSTEPS = Tile::KP / 16;
  constexpr uint32_t OWN_SUB = kOwnRows * kRowBytes;
  constexpr uint32_t STREAM_SUB = kTileRows * kRowBytes;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sG = sQ + Tile::OWN_BYTES;  // dO
  uint8_t* sK = sG + Tile::OWN_BYTES;
  uint8_t* sV = sK + kStages * Tile::STREAM_BYTES;
  float* sL = reinterpret_cast<float*>(sV + kStages * Tile::STREAM_BYTES);  // lse * log2(e)
  float* sD = sL + kOwnRows;                                                // delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + kOwnRows);
  uint64_t* bar_own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kOwnRows;
  const int ntiles = (kv_len + kTileRows - 1) / kTileRows;

  if (tid == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < kWgThreads) {
    reg_dealloc<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(bar_own, 2 * Tile::OWN_BYTES);
      tma_load_tile<NSUB>(sQ, kOwnRows, &map_q, h, q0, b, bar_own);
      tma_load_tile<NSUB>(sG, kOwnRows, &map_g, h, q0, b, bar_own);
      for (int j = 0; j < ntiles; ++j) {
        const int stage = j % kStages;
        const uint32_t phase = (j / kStages) & 1;
        mbar_wait(empty + stage, phase ^ 1);
        mbar_arrive_expect_tx(full + stage, 2 * Tile::STREAM_BYTES);
        tma_load_tile<NSUB>(sK + stage * Tile::STREAM_BYTES, kTileRows, &map_k, h,
                            j * kTileRows, b, full + stage);
        tma_load_tile<NSUB>(sV + stage * Tile::STREAM_BYTES, kTileRows, &map_v, h,
                            j * kTileRows, b, full + stage);
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = tid / kWgThreads - 1;
    const int t = tid % kWgThreads;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;

    // delta = rowsum(o * dO) in fp32, two threads per row, from device memory.
    {
      const int r = wg * 64 + (t >> 1);
      const int n = q0 + r;
      float part = 0.f;
      if (n < N) {
        const T* orow = o + b * st.o[0] + n * st.o[1] + h * st.o[2];
        const T* grow = dout + b * st.g[0] + n * st.g[1] + h * st.g[2];
        for (int c = t & 1; c < D / 8; c += 2) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
          const uint4 gv = *reinterpret_cast<const uint4*>(grow + c * 8);
          const T* oe = reinterpret_cast<const T*>(&ov);
          const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
          for (int i = 0; i < 8; ++i) part = fmaf(to_float(oe[i]), to_float(ge[i]), part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if ((t & 1) == 0) {
        sD[r] = part;
        sL[r] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
        if (n < N) delta[(long long)bh * N + n] = part;
      }
    }
    named_barrier_sync(1 + wg, kWgThreads);
    const int row0 = wg * 64 + warp * 16 + g;
    const float l2[2] = {sL[row0], sL[row0 + 8]};
    const float dl[2] = {sD[row0], sD[row0 + 8]};
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * kRowBytes;
    const uint32_t g_addr = smem_u32(sG) + wg * 64 * kRowBytes;

    float acc[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;

    // The five products of a tile pair go out behind one wait: dQ += dS K of
    // tile j is in flight together with S and dP of tile j + 1.
    float s[32], dp[32];
    uint32_t dsa[kTileRows / 16][4];
    constexpr bool kInRegs = ResidentInRegisters<DN>::value;
    uint32_t qa[kInRegs ? KSTEPS : 1][4], ga[kInRegs ? KSTEPS : 1][4];
    auto start_scores = [&](int stage) {
      const uint32_t k_addr = smem_u32(sK) + stage * Tile::STREAM_BYTES;
      const uint32_t v_addr = smem_u32(sV) + stage * Tile::STREAM_BYTES;
      if constexpr (kInRegs) {
        rows_dot<T, KSTEPS>(s, qa, k_addr, STREAM_SUB);   // S = Q K^T
        rows_dot<T, KSTEPS>(dp, ga, v_addr, STREAM_SUB);  // dP = dO V^T
      } else {
        rows_dot<T, KSTEPS>(s, q_addr, OWN_SUB, k_addr, STREAM_SUB);
        rows_dot<T, KSTEPS>(dp, g_addr, OWN_SUB, v_addr, STREAM_SUB);
      }
      wgmma_commit();
    };
    turn_init(wg);
    mbar_wait(bar_own, 0);
    if constexpr (kInRegs) {
      load_a_fragments<KSTEPS>(qa, sQ, OWN_SUB, wg * 64 + warp * 16);
      load_a_fragments<KSTEPS>(ga, sG, OWN_SUB, wg * 64 + warp * 16);
    }
    mbar_wait(full, 0);
    turn_wait(wg);
    wgmma_fence();
    start_scores(0);
    turn_pass(wg);
    wgmma_wait<0>();
    for (int j = 0; j < ntiles; ++j) {
      const int stage = j % kStages;
      pin(s);
      pin(dp);
      const int left = kv_len - j * kTileRows;  // valid keys of this tile
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i >> 1) & 1;
        const int col = (i >> 2) * 8 + tq * 2 + (i & 1);
        const float p = col < left ? fast_exp2(fmaf(s[i], scale_log2, -l2[e])) : 0.f;
        s[i] = p * (dp[i] - dl[e]);  // dS
      }
#pragma unroll
      for (int ks = 0; ks < kTileRows / 16; ++ks) acc_to_a<T>(dsa[ks], s, ks);
      if (j + 1 < ntiles) mbar_wait(full + (j + 1) % kStages, ((j + 1) / kStages) & 1);
      pin(dsa);
      pin(acc);
      pin(s);
      pin(dp);
      turn_wait(wg);
      wgmma_fence();
      acc_times_tile<T, DN>(acc, dsa, smem_u32(sK) + stage * Tile::STREAM_BYTES);  // dQ += dS K
      wgmma_commit();
      if (j + 1 < ntiles) start_scores((j + 1) % kStages);
      turn_pass(wg);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + stage);
    }
    pin(acc);
    store_rows<T, DN>(dq, st.dq, acc, scale, b, h, D, N, q0 + wg * 64 + warp * 16, lane);
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV, one CTA per (batch*head, 128 keys).
// ---------------------------------------------------------------------------
template <int DN> struct DkdvSmem {
  // K, V resident; per stage Q, dO and their lse / delta.
  static constexpr int SMEM = 1024 + 2 * BwdTile<DN>::OWN_BYTES +
                              kStages * 2 * BwdTile<DN>::STREAM_BYTES +
                              kStages * 2 * kTileRows * 4 + 64;
};

template <typename T, int DN>
__global__ void __launch_bounds__(kCtaThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_g, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int N, int M, int kv_len, int H, int D, const Strides st, float scale) {
  using Tile = BwdTile<DN>;
  constexpr int NSUB = Tile::NSUB;
  constexpr int KSTEPS = Tile::KP / 16;
  constexpr uint32_t OWN_SUB = kOwnRows * kRowBytes;
  constexpr uint32_t STREAM_SUB = kTileRows * kRowBytes;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_1024(smem_raw);
  uint8_t* sV = sK + Tile::OWN_BYTES;
  uint8_t* sQ = sV + Tile::OWN_BYTES;
  uint8_t* sG = sQ + kStages * Tile::STREAM_BYTES;  // dO
  float* sL = reinterpret_cast<float*>(sG + kStages * Tile::STREAM_BYTES);  // [stage][64]
  float* sD = sL + kStages * kTileRows;                                     // [stage][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + kStages * kTileRows);
  uint64_t* bar_own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kb0 = blockIdx.x * kOwnRows;
  const int ntiles = kb0 < kv_len ? (N + kTileRows - 1) / kTileRows : 0;  // uniform over the CTA

  if (tid == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA thread's expect_tx and the warp's lse / delta
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < kWgThreads) {
    reg_dealloc<40>();
    if (tid < 32 && ntiles > 0) {
      if (tid == 0) {
        mbar_arrive_expect_tx(bar_own, 2 * Tile::OWN_BYTES);
        tma_load_tile<NSUB>(sK, kOwnRows, &map_k, h, kb0, b, bar_own);
        tma_load_tile<NSUB>(sV, kOwnRows, &map_v, h, kb0, b, bar_own);
      }
      // lse and delta of a tile's rows, two per lane, fetched one tile ahead
      // so that their latency hides under the wait for a free stage.
      float nl[kTileRows / 32], nd[kTileRows / 32];
      auto fetch = [&](int j) {
#pragma unroll
        for (int i = 0; i < kTileRows / 32; ++i) {
          const int n = j * kTileRows + tid + 32 * i;
          nl[i] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
          nd[i] = n < N ? delta[(long long)bh * N + n] : 0.f;
        }
      };
      fetch(0);
      for (int j = 0; j < ntiles; ++j) {
        const int stage = j % kStages;
        const uint32_t phase = (j / kStages) & 1;
        const int q0 = j * kTileRows;
        mbar_wait(empty + stage, phase ^ 1);
        if (tid == 0) {
          mbar_arrive_expect_tx(full + stage, 2 * Tile::STREAM_BYTES);
          tma_load_tile<NSUB>(sQ + stage * Tile::STREAM_BYTES, kTileRows, &map_q, h, q0, b,
                              full + stage);
          tma_load_tile<NSUB>(sG + stage * Tile::STREAM_BYTES, kTileRows, &map_g, h, q0, b,
                              full + stage);
        }
#pragma unroll
        for (int i = 0; i < kTileRows / 32; ++i) {
          sL[stage * kTileRows + tid + 32 * i] = nl[i];
          sD[stage * kTileRows + tid + 32 * i] = nd[i];
        }
        mbar_arrive(full + stage);
        fetch(j + 1);  // rows past N read as 0
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = tid / kWgThreads - 1;
    const int t = tid % kWgThreads;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int key0 = kb0 + wg * 64 + warp * 16 + g;  // this thread's rows: key0, key0 + 8
    const bool kvalid[2] = {key0 < kv_len, key0 + 8 < kv_len};
    const float scale_log2 = scale * kLog2e;
    const uint32_t k_addr = smem_u32(sK) + wg * 64 * kRowBytes;
    const uint32_t v_addr = smem_u32(sV) + wg * 64 * kRowBytes;

    float dka[DN / 2], dva[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dka[i] = dva[i] = 0.f;

    // As in the dQ kernel: dV += P^T dO and dK += dS^T Q of tile j are in
    // flight together with S^T and dP^T of tile j + 1.
    float pt[32], dst[32];
    uint32_t pa[kTileRows / 16][4], dsa[kTileRows / 16][4];
    constexpr bool kInRegs = ResidentInRegisters<DN>::value;
    uint32_t ka[kInRegs ? KSTEPS : 1][4], va[kInRegs ? KSTEPS : 1][4];
    auto start_scores = [&](int stage) {
      const uint32_t q_addr = smem_u32(sQ) + stage * Tile::STREAM_BYTES;
      const uint32_t g_addr = smem_u32(sG) + stage * Tile::STREAM_BYTES;
      if constexpr (kInRegs) {
        rows_dot<T, KSTEPS>(pt, ka, q_addr, STREAM_SUB);   // S^T = K Q^T
        rows_dot<T, KSTEPS>(dst, va, g_addr, STREAM_SUB);  // dP^T = V dO^T
      } else {
        rows_dot<T, KSTEPS>(pt, k_addr, OWN_SUB, q_addr, STREAM_SUB);
        rows_dot<T, KSTEPS>(dst, v_addr, OWN_SUB, g_addr, STREAM_SUB);
      }
      wgmma_commit();
    };
    turn_init(wg);
    if (ntiles > 0) {
      mbar_wait(bar_own, 0);
      if constexpr (kInRegs) {
        load_a_fragments<KSTEPS>(ka, sK, OWN_SUB, wg * 64 + warp * 16);
        load_a_fragments<KSTEPS>(va, sV, OWN_SUB, wg * 64 + warp * 16);
      }
      mbar_wait(full, 0);
      turn_wait(wg);
      wgmma_fence();
      start_scores(0);
      turn_pass(wg);
      wgmma_wait<0>();
    }
    for (int j = 0; j < ntiles; ++j) {
      const int stage = j % kStages;
      const float* tl = sL + stage * kTileRows;
      const float* td = sD + stage * kTileRows;
      pin(pt);
      pin(dst);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 l2 = *reinterpret_cast<const float2*>(tl + jn * 8 + tq * 2);
        const float2 dl = *reinterpret_cast<const float2*>(td + jn * 8 + tq * 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jn + 2 * e;
          const float p0 = kvalid[e] ? fast_exp2(fmaf(pt[i], scale_log2, -l2.x)) : 0.f;
          const float p1 = kvalid[e] ? fast_exp2(fmaf(pt[i + 1], scale_log2, -l2.y)) : 0.f;
          pt[i] = p0;                           // P^T
          pt[i + 1] = p1;
          dst[i] = p0 * (dst[i] - dl.x);        // dS^T
          dst[i + 1] = p1 * (dst[i + 1] - dl.y);
        }
      }
#pragma unroll
      for (int ks = 0; ks < kTileRows / 16; ++ks) {
        acc_to_a<T>(pa[ks], pt, ks);
        acc_to_a<T>(dsa[ks], dst, ks);
      }
      if (j + 1 < ntiles) mbar_wait(full + (j + 1) % kStages, ((j + 1) / kStages) & 1);
      pin(pa);
      pin(dsa);
      pin(dva);
      pin(dka);
      pin(pt);
      pin(dst);
      turn_wait(wg);
      wgmma_fence();
      acc_times_tile<T, DN>(dva, pa, smem_u32(sG) + stage * Tile::STREAM_BYTES);   // dV += P^T dO
      acc_times_tile<T, DN>(dka, dsa, smem_u32(sQ) + stage * Tile::STREAM_BYTES);  // dK += dS^T Q
      wgmma_commit();
      if (j + 1 < ntiles) start_scores((j + 1) % kStages);
      turn_pass(wg);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + stage);
    }
    pin(dka);
    pin(dva);
    const int row0 = kb0 + wg * 64 + warp * 16;
    store_rows<T, DN>(dk, st.dk, dka, scale, b, h, D, M, row0, lane);
    store_rows<T, DN>(dv, st.dv, dva, 1.f, b, h, D, M, row0, lane);
  }
}

template <typename T, int DN>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int N,
                   int M, int kv_len, int H, int D, const Strides& st, float scale,
                   cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  // Maps by (tensor, rows per box): the resident tiles take 128 rows, the
  // streamed ones 64.  K and V show kv_len rows, so the rest read as zeros.
  CUtensorMap q_own, g_own, k_str, v_str, k_own, v_own, q_str, g_str;
  struct {
    CUtensorMap* map;
    const void* base;
    int seq;
    const long long* s;
    int rows;
  } maps[8] = {{&q_own, q, N, st.q, kOwnRows},       {&g_own, dout, N, st.g, kOwnRows},
               {&k_str, k, kv_len, st.k, kTileRows}, {&v_str, v, kv_len, st.v, kTileRows},
               {&k_own, k, kv_len, st.k, kOwnRows},  {&v_own, v, kv_len, st.v, kOwnRows},
               {&q_str, q, N, st.q, kTileRows},      {&g_str, dout, N, st.g, kTileRows}};
  for (auto& m : maps) {
    cudaError_t err =
        make_tensor_map(m.map, bf16, m.base, B, m.seq, H, D, m.s[0], m.s[1], m.s[2], m.rows);
    if (err != cudaSuccess) return err;
  }
  auto dq_kernel = flash_bwd_dq_kernel<T, DN>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DN>;
  constexpr int dq_smem = BwdTile<DN>::SMEM;
  constexpr int dkdv_smem = DkdvSmem<DN>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((N + kOwnRows - 1) / kOwnRows, B * H), kCtaThreads, dq_smem, stream>>>(
      q_own, g_own, k_str, v_str, static_cast<const T*>(o), static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dq), N, kv_len, H, D, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((M + kOwnRows - 1) / kOwnRows, B * H), kCtaThreads, dkdv_smem, stream>>>(
      k_own, v_own, q_str, g_str, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, M,
      kv_len, H, D, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq, void* dk,
                           void* dv, int B, int N, int M, int kv_len, int H, int D,
                           const Strides& st, float scale, cudaStream_t s) {
#define TB_LAUNCH(DN) \
  launch_wgmma<T, DN>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, N, M, kv_len, H, D, st, scale, s)
  if (D <= 16) return TB_LAUNCH(16);
  if (D <= 32) return TB_LAUNCH(32);
  if (D <= 40) return TB_LAUNCH(40);
  if (D <= 64) return TB_LAUNCH(64);
  if (D <= 80) return TB_LAUNCH(80);
  return TB_LAUNCH(128);
#undef TB_LAUNCH
}

// The variant rule, here alone (the wrapper asks tb_flash_attention_bwd_wgmma_form).
// The wgmma variant's types and head dims: 16-bit, D <= 128 in whole 16-byte
// chunks.
bool wgmma_form(int dtype, int D) { return dtype != 0 && D <= 128 && D % 8 == 0; }

// It reads through TMA and stores 32-bit pairs, so it also needs every base
// 16-byte aligned and every stride a whole number of 16-byte chunks.
bool wgmma_eligible(int dtype, int D, const void* const (&ptrs)[8], const Strides& st) {
  if (!wgmma_form(dtype, D)) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  const long long* x = &st.q[0];
  for (int i = 0; i < 24; ++i)
    if (x[i] % 8) return false;
  return true;
}

// ---------------------------------------------------------------------------
// 3. The CUDA-core variant: fp32, 128 < D <= 512, D % 8 != 0, views TMA
//    cannot read.  The same split (delta + dQ, then dK/dV), fp32 arithmetic.
// ---------------------------------------------------------------------------
namespace cc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 32;  // streamed keys (dQ) or query rows (dK/dV) per tile: one per lane

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Query rows per warp in the dQ kernel and keys per warp in the dK/dV
// kernel (NC: head columns per lane, in 32s): fewer where the accumulators
// are wide, so that they stay in registers (dK/dV holds two).
template <int NC> struct DqRows { static constexpr int value = NC <= 4 ? 8 : 4; };
template <int NC> struct DkdvRows { static constexpr int value = NC <= 4 ? 8 : NC <= 8 ? 4 : 2; };

template <int NC> inline size_t dq_smem(int ds) {
  constexpr int BQ = kWarps * DqRows<NC>::value;
  return sizeof(float) * (size_t)(2 * BQ * ds + 2 * kBT * ds + kWarps * kBT * DqRows<NC>::value);
}

template <int NC> inline size_t dkdv_smem(int ds) {
  constexpr int RK = DkdvRows<NC>::value;
  constexpr int BK = kWarps * RK;
  return sizeof(float) * (size_t)(2 * BK * ds + 2 * kBT * ds + 2 * kBT + 2 * kWarps * kBT * RK);
}

// rows x DS floats from rows [r0, r0 + rows) of a [S, D] slice (row stride
// `sn` elements), zero past `valid` rows and past D, times `mul`.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long sn, int r0, int rows,
                                      int valid, int D, int DS, float mul) {
  for (int idx = threadIdx.x; idx < rows * DS; idx += kThreads) {
    const int r = idx / DS;
    const int d = idx - r * DS;
    const int n = r0 + r;
    dst[idx] = (n < valid && d < D) ? to_float(src[n * sn + d]) * mul : 0.f;
  }
}

// 1. delta and dQ, one CTA per (batch*head, BQ query rows), warp w owning
// rows w*RW ..; K and V streamed 32 keys at a time.  Scores: lane j owns key
// j and reads the warp's q and dO rows as shared-memory broadcasts.  dQ +=
// dS K: lane l owns head columns l, l + 32, ...; dS goes through the warp's
// slice of shared memory.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int N, int kv_len, int H, int D, int DS,
          const Strides st, float scale) {
  constexpr int RW = DqRows<NC>::value;
  constexpr int BQ = kWarps * RW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][DS], q * scale * log2(e)
  float* sG = sQ + BQ * DS;                      // [BQ][DS], dO
  float* sK = sG + BQ * DS;                      // [kBT][DS]
  float* sV = sK + kBT * DS;                     // [kBT][DS]
  float* sS = sV + kBT * DS;                     // [kWarps][kBT][RW], dS by key

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const float scale_log2 = scale * kLog2e;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* ob = o + b * st.o[0] + h * st.o[2];
  const T* gb = g + b * st.g[0] + h * st.g[2];

  stage(sQ, qb, st.q[1], q0, BQ, N, D, DS, scale_log2);
  stage(sG, gb, st.g[1], q0, BQ, N, D, DS, 1.f);

  // delta = rowsum(o * dO) and lse (log2 units) of the warp's rows, on every lane.
  float dl[RW], l2[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int n = q0 + warp * RW + r;
    float part = 0.f;
    if (n < N)
      for (int d = lane; d < D; d += 32)
        part = fmaf(to_float(ob[n * st.o[1] + d]), to_float(gb[n * st.g[1] + d]), part);
    dl[r] = warp_sum(part);
    l2[r] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
    if (lane == 0 && n < N) delta[(long long)bh * N + n] = dl[r];
  }

  float acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int ds4 = DS / 4;
  const int d4n = (D + 3) / 4;  // float4s that hold the head dim
  const float4* qrow = reinterpret_cast<const float4*>(sQ + warp * RW * DS);
  const float4* grow = reinterpret_cast<const float4*>(sG + warp * RW * DS);
  const float4* krow = reinterpret_cast<const float4*>(sK + lane * DS);
  const float4* vrow = reinterpret_cast<const float4*>(sV + lane * DS);
  float* sw = sS + warp * kBT * RW;

  for (int k0 = 0; k0 < kv_len; k0 += kBT) {
    __syncthreads();  // the previous tile is consumed (and sQ, sG are written)
    stage(sK, kb, st.k[1], k0, kBT, kv_len, D, DS, 1.f);
    stage(sV, vb, st.v[1], k0, kBT, kv_len, D, DS, 1.f);
    __syncthreads();

    float s[RW], dp[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = dp[r] = 0.f;
    for (int d4 = 0; d4 < d4n; ++d4) {
      const float4 kk = krow[d4];
      const float4 vv = vrow[d4];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        s[r] = dot4(qrow[r * ds4 + d4], kk, s[r]);
        dp[r] = dot4(grow[r * ds4 + d4], vv, dp[r]);
      }
    }
    const bool valid = k0 + lane < kv_len;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float p = valid ? exp2f(s[r] - l2[r]) : 0.f;
      s[r] = p * (dp[r] - dl[r]);  // dS
    }
#pragma unroll
    for (int r4 = 0; r4 < RW / 4; ++r4)
      reinterpret_cast<float4*>(sw + lane * RW)[r4] =
          make_float4(s[4 * r4], s[4 * r4 + 1], s[4 * r4 + 2], s[4 * r4 + 3]);
    __syncwarp();

    const int jn = min(kBT, kv_len - k0);
    for (int j = 0; j < jn; ++j) {
      float dsj[RW];
#pragma unroll
      for (int r4 = 0; r4 < RW / 4; ++r4) {
        const float4 t = reinterpret_cast<const float4*>(sw + j * RW)[r4];
        dsj[4 * r4] = t.x;
        dsj[4 * r4 + 1] = t.y;
        dsj[4 * r4 + 2] = t.z;
        dsj[4 * r4 + 3] = t.w;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = c * 32 + lane;
        const float kk = d < D ? sK[j * DS + d] : 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[r][c] = fmaf(dsj[r], kk, acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int n = q0 + warp * RW + r;
    if (n >= N) continue;
    T* out = dq + b * st.dq[0] + n * st.dq[1] + h * st.dq[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < D) out[d] = from_float<T>(acc[r][c] * scale);
    }
  }
}

// 2. dK and dV, one CTA per (batch*head, BK keys), warp w owning keys
// w*RK ..; Q and dO streamed 32 rows at a time with their lse and delta.
// Transposed scores: lane i owns query row i and reads the warp's K and V
// rows as broadcasts.  dV += P^T dO and dK += dS^T Q: lane l owns head
// columns l, l + 32, ....  Keys at or past kv_len get P = 0, so their rows
// are written as zeros; no row at or past M is written.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int N, int M,
            int kv_len, int H, int D, int DS, const Strides st, float scale) {
  constexpr int RK = DkdvRows<NC>::value;
  constexpr int BK = kWarps * RK;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [BK][DS], k * scale * log2(e)
  float* sV = sK + BK * DS;                      // [BK][DS]
  float* sQ = sV + BK * DS;                      // [kBT][DS]
  float* sG = sQ + kBT * DS;                     // [kBT][DS], dO
  float* sL = sG + kBT * DS;                     // [kBT], lse in log2 units
  float* sD = sL + kBT;                          // [kBT], delta
  float* sP = sD + kBT;                          // [kWarps][kBT][RK], P^T by query row
  float* sS = sP + kWarps * kBT * RK;            // [kWarps][kBT][RK], dS^T by query row

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kb0 = blockIdx.x * BK;
  const float scale_log2 = scale * kLog2e;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* gb = g + b * st.g[0] + h * st.g[2];

  stage(sK, kb, st.k[1], kb0, BK, kv_len, D, DS, scale_log2);
  stage(sV, vb, st.v[1], kb0, BK, kv_len, D, DS, 1.f);

  float dka[RK][NC], dva[RK][NC];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[r][c] = dva[r][c] = 0.f;

  bool kvalid[RK];
#pragma unroll
  for (int r = 0; r < RK; ++r) kvalid[r] = kb0 + warp * RK + r < kv_len;
  const int ds4 = DS / 4;
  const int d4n = (D + 3) / 4;
  const float4* krow = reinterpret_cast<const float4*>(sK + warp * RK * DS);
  const float4* vrow = reinterpret_cast<const float4*>(sV + warp * RK * DS);
  const float4* qrow = reinterpret_cast<const float4*>(sQ + lane * DS);
  const float4* grow = reinterpret_cast<const float4*>(sG + lane * DS);
  float* pw = sP + warp * kBT * RK;
  float* sw = sS + warp * kBT * RK;

  const int n_end = kb0 < kv_len ? N : 0;  // a CTA of masked keys only writes zeros
  for (int n0 = 0; n0 < n_end; n0 += kBT) {
    __syncthreads();  // the previous tile is consumed (and sK, sV are written)
    stage(sQ, qb, st.q[1], n0, kBT, N, D, DS, 1.f);
    stage(sG, gb, st.g[1], n0, kBT, N, D, DS, 1.f);
    if (threadIdx.x < kBT) {
      const int n = n0 + threadIdx.x;
      sL[threadIdx.x] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
      sD[threadIdx.x] = n < N ? delta[(long long)bh * N + n] : 0.f;
    }
    __syncthreads();

    float s[RK], dp[RK];
#pragma unroll
    for (int r = 0; r < RK; ++r) s[r] = dp[r] = 0.f;
    for (int d4 = 0; d4 < d4n; ++d4) {
      const float4 qq = qrow[d4];
      const float4 gg = grow[d4];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        s[r] = dot4(krow[r * ds4 + d4], qq, s[r]);
        dp[r] = dot4(vrow[r * ds4 + d4], gg, dp[r]);
      }
    }
    const bool rvalid = n0 + lane < N;
    const float l2 = sL[lane];
    const float dl = sD[lane];
#pragma unroll
    for (int r = 0; r < RK; ++r) {
      const float p = rvalid && kvalid[r] ? exp2f(s[r] - l2) : 0.f;
      pw[lane * RK + r] = p;
      sw[lane * RK + r] = p * (dp[r] - dl);
    }
    __syncwarp();

    const int in = min(kBT, N - n0);
    for (int i = 0; i < in; ++i) {
      float pi[RK], dsi[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        pi[r] = pw[i * RK + r];
        dsi[r] = sw[i * RK + r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = c * 32 + lane;
        const float gg = d < D ? sG[i * DS + d] : 0.f;
        const float qq = d < D ? sQ[i * DS + d] : 0.f;
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          dva[r][c] = fmaf(pi[r], gg, dva[r][c]);
          dka[r][c] = fmaf(dsi[r], qq, dka[r][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int m = kb0 + warp * RK + r;
    if (m >= M) continue;
    T* ko = dk + b * st.dk[0] + m * st.dk[1] + h * st.dk[2];
    T* vo = dv + b * st.dv[0] + m * st.dv[1] + h * st.dv[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < D) {
        ko[d] = from_float<T>(dka[r][c] * scale);
        vo[d] = from_float<T>(dva[r][c]);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int N,
                   int M, int kv_len, int H, int D, const Strides& st, float scale,
                   cudaStream_t stream) {
  const int ds = smem_row_stride(D);
  const size_t smem_dq = dq_smem<NC>(ds);
  const size_t smem_dkdv = dkdv_smem<NC>(ds);
  auto kdq = dq_kernel<T, NC>;
  auto kdkdv = dkdv_kernel<T, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  constexpr int BQ = kWarps * DqRows<NC>::value;
  constexpr int BK = kWarps * DkdvRows<NC>::value;
  kdq<<<dim3((N + BQ - 1) / BQ, B * H), kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), N,
      kv_len, H, D, ds, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkdv<<<dim3((M + BK - 1) / BK, B * H), kThreads, smem_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, M,
      kv_len, H, D, ds, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int B, int N, int M, int kv_len, int H, int D, const Strides& st,
                     float scale, cudaStream_t s) {
#define TB_LAUNCH(NC) \
  launch<T, NC>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, N, M, kv_len, H, D, st, scale, s)
  const int nc = (D + 31) / 32;
  if (nc <= 1) return TB_LAUNCH(1);
  if (nc <= 2) return TB_LAUNCH(2);
  if (nc <= 3) return TB_LAUNCH(3);
  if (nc <= 4) return TB_LAUNCH(4);
  if (nc <= 5) return TB_LAUNCH(5);
  if (nc <= 8) return TB_LAUNCH(8);
  if (nc <= 16) return TB_LAUNCH(16);
  return cudaErrorInvalidValue;
#undef TB_LAUNCH
}

}  // namespace cc

enum Variant { kCudaCores = 0, kWgmma = 1 };

}  // namespace

// 1 where the wgmma variant serves `dtype` (0 float32, 1 float16, 2
// bfloat16) at head dim D once every view is 16-byte aligned in whole
// 16-byte chunks, else 0.  The wrapper copies such a view that is not,
// rather than let the call fall to the CUDA cores.
extern "C" int tb_flash_attention_bwd_wgmma_form(int dtype, int D) {
  return wgmma_form(dtype, D) ? 1 : 0;
}

// dtype: 0 float32, 1 float16, 2 bfloat16.  q, o, dout [B, N, H, D] and k, v
// [B, M, H, D] with element strides (batch, sequence, head) and a contiguous
// head dim; lse fp32 [B, H, N] from the forward; delta an fp32 [B, H, N]
// scratch the call fills; dq [B, N, H, D] and dk, dv [B, M, H, D] outputs
// written through their strides (head dim contiguous).  Keys at or past
// kv_len (<= M) are masked and their rows of dk and dv written as zeros; no
// row at or past N (dq) or M (dk, dv) is written.  Writes to *variant which
// kernels serve the call: 0 CUDA cores, 1 wgmma.  Returns the first launch
// error (0 on success).
extern "C" int tb_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int N, int M, int kv_len,
    int H, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sm,
    long long k_sh, long long v_sb, long long v_sm, long long v_sh, long long o_sb,
    long long o_sn, long long o_sh, long long g_sb, long long g_sn, long long g_sh,
    long long dq_sb, long long dq_sn, long long dq_sh, long long dk_sb, long long dk_sm,
    long long dk_sh, long long dv_sb, long long dv_sm, long long dv_sh, float scale,
    void* stream, int* variant) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || D > 512 || kv_len <= 0 ||
      kv_len > M || B * H > 65535 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const Strides st = {{q_sb, q_sn, q_sh},    {k_sb, k_sm, k_sh},    {v_sb, v_sm, v_sh},
                      {o_sb, o_sn, o_sh},    {g_sb, g_sn, g_sh},    {dq_sb, dq_sn, dq_sh},
                      {dk_sb, dk_sm, dk_sh}, {dv_sb, dv_sm, dv_sh}};
  const void* const ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wgmma = wgmma_eligible(dtype, D, ptrs, st);
  *variant = wgmma ? kWgmma : kCudaCores;
#define TB_ARGS q, k, v, o, dout, l, dl, dq, dk, dv, B, N, M, kv_len, H, D, st, scale, s
  switch (dtype) {
    case 0: return (int)cc::dispatch<float>(TB_ARGS);
    case 1: return (int)(wgmma ? dispatch_wgmma<__half>(TB_ARGS) : cc::dispatch<__half>(TB_ARGS));
    default:
      return (int)(wgmma ? dispatch_wgmma<__nv_bfloat16>(TB_ARGS)
                         : cc::dispatch<__nv_bfloat16>(TB_ARGS));
  }
#undef TB_ARGS
}
