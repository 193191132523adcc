// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel textboost_tpu/ops/flash_attention.py:119
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
// length), in three variants the C entry point chooses between and reports:
//   wgmma (above): bf16/fp16, D <= 128, D and every stride a multiple of 8,
//   16-byte aligned pointers (the wrapper asks
//   tb_flash_attention_bwd_wgmma_form and copies a view of such a tensor
//   that is not).  It serves every self- and cross-attention of the shipped
//   configs at D = 40, 64 and 80, the 77 text keys included.
//   mma (mma:: below): the other bf16/fp16 calls: 128 < D <= 512 (sd15's
//   160-wide heads at 16x16 latents under --attention_impl flash, the VAE's
//   512), D % 8 != 0, and views whose strides or bases TMA cannot read, read
//   in place.  It exists beside the wgmma form because that form's design
//   does not stretch there: its tiles come by TMA (whole 16-byte chunks,
//   aligned bases) and its dK/dV warpgroups hold two 64 x D fp32
//   accumulators, which past D = 128 exceed the registers.  Here the same
//   split runs on mma.sync.m16n8k16 with fp32 accumulators: CTAs of 4 warps,
//   each warp owning 16 query rows (delta + dQ) or 16 keys (dK/dV); threads
//   stage the resident tile (64 rows) and a two-stage ring of 32-row streamed
//   tiles into shared memory by 16-byte cp.async where the view allows it,
//   element loads otherwise, zero-padding D to a multiple of 16 and zeroing
//   keys past kv_len (nothing is padded in device memory); ldmatrix loads
//   the fragments; S and dP (or S^T, dP^T) over the whole head dim stay in
//   registers and become, rounded to the input dtype, the A fragments of the
//   accumulating products, as in the wgmma form.  The register budget sets
//   the column split: one 16 x DN fp32 accumulator is DN / 2 registers a
//   thread, so dQ's CTA holds up to 256 columns and dK/dV's (two of them) up
//   to 128; a wider head dim is split over the grid's z, each CTA
//   recomputing its scores over the whole head dim (dP needs all of it).
//   At D = 160, dQ is one block of 160 and dK/dV two of 80; at D = 512, two
//   of 256 and four of 128.
//   CUDA cores (cc:: below): fp32 at any D.  The same split on register tiles
//   (flash_tiles.cuh): CTAs of 256 threads, 64 query rows (delta + dQ) or 64
//   keys (dK/dV) a CTA, the other side streamed 64 rows at a time (two
//   stages of 16-byte cp.async where the head dim fits one tile and two
//   CTAs still fit an SM; else D in chunks of 64, 32 or 16); each thread a
//   4 x 4 block of the score tiles and 4 x 4 W4 of the accumulators, every
//   shared-memory float4 feeding 4 to 16 FMAs; fp32 arithmetic and
//   accumulators, no TF32, exp2f.  dK/dV hold two accumulators, so past
//   D = 256 their columns are split over the grid's z as in mma.
//   No atomics in any variant: the same bits from run to run.
//
// Bound on the card.  At sd15's shapes (N = M = 4096, D = 40 or 80) the least
// work is 5 products of 2*N*M*D operations per (batch, head), i.e.
// 10*B*H*N^2*D, against 8*N*D elements moved (q, k, v, o, dO in; dq, dk, dv
// out): far above the H100's ~295 operations per byte, so operations bound
// it: the five products at the tensor cores' rate and, at D = 40, almost as
// much again the N*M exponentials per (batch, head) at 16 ex2 a clock on
// each SM.  The split does 7 products and computes every exponential twice
// (once in each kernel); that is the price of results without atomics.  The
// mma variant's tensor-core work is bound the same way (its column split
// adds score products at D > 128); at M = 77 in a 16-bit type the bytes of
// q, o, dO and dq bound it.  In fp32 the products run on the CUDA cores at
// 67 TFLOP/s, which bound the CUDA-core variant; the register tiles reach
// about a third of that rate (PERF.md), held back by what a 64 x 64 tile
// costs besides its FMAs (staging, exponentials, barriers) and by register
// pressure (two CTAs an SM up to D = 64 in dK/dV).

#include "flash_tiles.cuh"

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

using tiles::kMaxSmem;

// ---------------------------------------------------------------------------
// 3. The mma variant: bf16/fp16 calls the wgmma variant does not take
//    (128 < D <= 512, D % 8 != 0, views TMA cannot read).  The same split,
//    on the tensor cores through mma.sync.m16n8k16, fp32 accumulators.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int kThreads = 128;  // 4 warps
constexpr int kOwn = 64;       // query rows (dQ) or keys (dK/dV) per CTA: 16 per warp
constexpr int kStream = 32;    // streamed keys (dQ) or query rows (dK/dV) per tile

// Row stride (elements) of a [rows][W] 16-bit tile that ldmatrix reads: an
// odd number of 16-byte chunks, so that 8 rows fall on 8 bank groups.
inline int row_ld(int W) { return (W / 8) % 2 == 0 ? W + 8 : W + 16; }

__device__ __forceinline__ bool aligned16(const void* p, long long sn) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && sn % 8 == 0;
}

// dst[r][c] (row stride ld) = src row r0 + r, column c, for r < rows and
// c < W (a multiple of 8): zero past `valid` rows and past D.  16-byte
// cp.async where `vec` (base and row stride in whole chunks) and the chunk
// lies inside D; element loads otherwise.  The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, int W, const T* src, long long sn, int r0,
                                      int rows, int valid, int D, bool vec) {
  const int chunks = W / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const int n = r0 + r;
    T* d = dst + r * ld + c;
    if (vec && n < valid && c + 8 <= D) {
      cp_async16(d, src + n * sn + c);
    } else {
      __align__(16) T e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = (n < valid && c + i < D) ? src[n * sn + c + i] : from_float<T>(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(e);
    }
  }
}

// The A fragments of the next product from a warp's 16 x 32 score
// accumulator x[n-tile][4]: k step kk covers n-tiles 2 kk and 2 kk + 1.
template <typename T>
__device__ __forceinline__ void scores_to_a(uint32_t (&a)[2][4], const float (&x)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// s (+)= A B^T and t (+)= A2 B2^T for a warp's 16 rows against 32 streamed
// rows, k over `kp` steps of 16 columns: A, A2 from the row-major tiles at
// the shared addresses a, a2 (the warp's first row, lane's ldmatrix row),
// B, B2 likewise at b, b2; row strides `ld` elements.
template <typename T>
__device__ __forceinline__ void score_pair(float (&s)[4][4], float (&t)[4][4], uint32_t a,
                                           uint32_t a2, uint32_t b, uint32_t b2, int ld, int kp) {
  for (int ks = 0; ks < kp; ++ks) {
    uint32_t fa[4], fa2[4];
    ldsm_x4(fa, a + ks * 32);
    ldsm_x4(fa2, a2 + ks * 32);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t fb[4], fb2[4];
      ldsm_x4(fb, b + (p * 16 * ld + ks * 16) * 2);
      ldsm_x4(fb2, b2 + (p * 16 * ld + ks * 16) * 2);
      mma16816<T>(s[2 * p], fa, fb[0], fb[1]);
      mma16816<T>(s[2 * p + 1], fa, fb[2], fb[3]);
      mma16816<T>(t[2 * p], fa2, fb2[0], fb2[1]);
      mma16816<T>(t[2 * p + 1], fa2, fb2[2], fb2[3]);
    }
  }
}

// acc[16 x DN] += X[16 x 32] * tile[32 rows x DN columns from c0]: X from the
// fragments `xa`, the tile read transposed by ldmatrix from address `b` (its
// row 0, column c0, lane's ldmatrix row and column).
template <typename T, int DN>
__device__ __forceinline__ void acc_times_tile(float (&acc)[DN / 8][4], const uint32_t (&xa)[2][4],
                                               uint32_t b, int ld) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int p = 0; p < DN / 16; ++p) {
      uint32_t fb[4];
      ldsm_x4_t(fb, b + (kk * 16 * ld + p * 16) * 2);
      mma16816<T>(acc[2 * p], xa[kk], fb[0], fb[1]);
      mma16816<T>(acc[2 * p + 1], xa[kk], fb[2], fb[3]);
    }
}

// Rows row0 + g and row0 + g + 8 of acc * mul into `out` (rows `rs` elements
// apart), columns c0 + 8 nt + 2 tq (+1) below D; no row at or past `rows`.
template <typename T, int DN>
__device__ __forceinline__ void store_rows16(T* out, long long rs, const float (&acc)[DN / 8][4],
                                             float mul, int row0, int rows, int c0, int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = row0 + (lane >> 2) + 8 * e;
    if (n >= rows) continue;
#pragma unroll
    for (int nt = 0; nt < DN / 8; ++nt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int d = c0 + nt * 8 + (lane & 3) * 2 + x;
        if (d < D) out[n * rs + d] = from_float<T>(acc[nt][2 * e + x] * mul);
      }
  }
}

// 1. delta and dQ, one CTA per (batch*head, 64 query rows, DN columns of
// dQ): Q and dO resident, K and V streamed 32 keys at a time (two stages
// where shared memory allows).  Each warp owns 16 query rows: S and dP
// (16 x 32) by mma over the whole head dim, P and dS in registers, dS the
// A fragments of dQ += dS K over the CTA's DN columns.
template <typename T, int DN>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int N, int kv_len, int H, int D, int W,
          int ld, int stages, const Strides st, float scale) {
  extern __shared__ uint4 smem16[];
  T* sQ = reinterpret_cast<T*>(smem16);  // [64][ld]
  T* sG = sQ + kOwn * ld;                 // [64][ld], dO
  T* sK = sG + kOwn * ld;                 // [stages][32][ld]
  T* sV = sK + stages * kStream * ld;     // [stages][32][ld]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kOwn;
  const int c0 = blockIdx.z * DN;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* ob = o + b * st.o[0] + h * st.o[2];
  const T* gb = g + b * st.g[0] + h * st.g[2];
  const bool vk = aligned16(kb, st.k[1]);
  const bool vv = aligned16(vb, st.v[1]);
  const int ntiles = (kv_len + kStream - 1) / kStream;
  const int kp = (D + 15) / 16;

  stage(sQ, ld, W, qb, st.q[1], q0, kOwn, N, D, aligned16(qb, st.q[1]));
  stage(sG, ld, W, gb, st.g[1], q0, kOwn, N, D, aligned16(gb, st.g[1]));
  auto load = [&](int j, int buf) {
    stage(sK + buf * kStream * ld, ld, W, kb, st.k[1], j * kStream, kStream, kv_len, D, vk);
    stage(sV + buf * kStream * ld, ld, W, vb, st.v[1], j * kStream, kStream, kv_len, D, vv);
  };
  load(0, 0);
  cp_async_commit();

  // delta = rowsum(o * dO) in fp32, two lanes a row; lse in log2 units.
  float dl[2], l2[2];
  {
    const int n = q0 + warp * 16 + (lane >> 1);
    float part = 0.f;
    if (n < N)
      for (int d = lane & 1; d < D; d += 2)
        part = fmaf(to_float(ob[n * st.o[1] + d]), to_float(gb[n * st.g[1] + d]), part);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (blockIdx.z == 0 && (lane & 1) == 0 && n < N) delta[(long long)bh * N + n] = part;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = (lane >> 2) + 8 * e;
      dl[e] = __shfl_sync(0xffffffffu, part, 2 * r);
      const int m = q0 + warp * 16 + r;
      l2[e] = m < N ? lse[(long long)bh * N + m] * kLog2e : 0.f;
    }
  }
  const float scale_log2 = scale * kLog2e;

  float acc[DN / 8][4];
#pragma unroll
  for (int i = 0; i < DN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int arow = (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  const int brow = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  const int trow = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 + (lane >> 4) * 8;
  for (int j = 0; j < ntiles; ++j) {
    const int buf = stages == 2 ? (j & 1) : 0;
    if (stages == 2 && j + 1 < ntiles) {
      load(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tK = sK + buf * kStream * ld;
    const T* tV = sV + buf * kStream * ld;
    float s[4][4] = {}, dp[4][4] = {};
    score_pair<T>(s, dp, smem_u32(sQ + arow), smem_u32(sG + arow), smem_u32(tK + brow),
                  smem_u32(tV + brow), ld, kp);
    const int left = kv_len - j * kStream;  // valid keys of this tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = i >> 1;
        const float p = nt * 8 + tq * 2 + (i & 1) < left
                            ? fast_exp2(fmaf(s[nt][i], scale_log2, -l2[e])) : 0.f;
        s[nt][i] = p * (dp[nt][i] - dl[e]);  // dS
      }
    uint32_t dsa[2][4];
    scores_to_a<T>(dsa, s);
    acc_times_tile<T, DN>(acc, dsa, smem_u32(tK + trow), ld);  // dQ += dS K
    __syncthreads();
    if (stages == 1 && j + 1 < ntiles) {
      load(j + 1, 0);
      cp_async_commit();
    }
  }
  store_rows16<T, DN>(dq + b * st.dq[0] + h * st.dq[2], st.dq[1], acc, scale,
                      q0 + warp * 16, N, c0, D);
}

// 2. dK and dV, one CTA per (batch*head, 64 keys, DN columns of dK and dV):
// K and V resident, Q and dO streamed 32 rows at a time with their lse and
// delta.  Each warp owns 16 keys: the transposed scores S^T, dP^T (16 x 32)
// over the whole head dim, P^T and dS^T in registers as the A fragments of
// dV += P^T dO and dK += dS^T Q over the CTA's DN columns.  Keys at or past
// kv_len get P = 0, so their rows are written as zeros.
template <typename T, int DN>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int N, int M,
            int kv_len, int H, int D, int W, int ld, int stages, const Strides st, float scale) {
  extern __shared__ uint4 smem16[];
  T* sK = reinterpret_cast<T*>(smem16);       // [64][ld]
  T* sV = sK + kOwn * ld;                      // [64][ld]
  T* sQ = sV + kOwn * ld;                      // [stages][32][ld]
  T* sG = sQ + stages * kStream * ld;          // [stages][32][ld], dO
  float* sL = reinterpret_cast<float*>(sG + stages * kStream * ld);  // [stages][32], log2 units
  float* sD = sL + stages * kStream;                                  // [stages][32], delta

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kb0 = blockIdx.x * kOwn;
  const int c0 = blockIdx.z * DN;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* gb = g + b * st.g[0] + h * st.g[2];

  float dka[DN / 8][4], dva[DN / 8][4];
#pragma unroll
  for (int i = 0; i < DN / 8; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) dka[i][x] = dva[i][x] = 0.f;

  if (kb0 < kv_len) {  // uniform over the CTA: a CTA of masked keys only writes zeros
    const bool vq = aligned16(qb, st.q[1]);
    const bool vg = aligned16(gb, st.g[1]);
    const int ntiles = (N + kStream - 1) / kStream;
    const int kp = (D + 15) / 16;
    stage(sK, ld, W, kb, st.k[1], kb0, kOwn, kv_len, D, aligned16(kb, st.k[1]));
    stage(sV, ld, W, vb, st.v[1], kb0, kOwn, kv_len, D, aligned16(vb, st.v[1]));
    auto load = [&](int j, int buf) {
      stage(sQ + buf * kStream * ld, ld, W, qb, st.q[1], j * kStream, kStream, N, D, vq);
      stage(sG + buf * kStream * ld, ld, W, gb, st.g[1], j * kStream, kStream, N, D, vg);
      if (threadIdx.x < kStream) {
        const int n = j * kStream + threadIdx.x;
        sL[buf * kStream + threadIdx.x] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
        sD[buf * kStream + threadIdx.x] = n < N ? delta[(long long)bh * N + n] : 0.f;
      }
    };
    load(0, 0);
    cp_async_commit();
    const float scale_log2 = scale * kLog2e;
    bool kvalid[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) kvalid[e] = kb0 + warp * 16 + (lane >> 2) + 8 * e < kv_len;
    const int arow = (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    const int brow = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
    const int trow = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 + (lane >> 4) * 8;
    for (int j = 0; j < ntiles; ++j) {
      const int buf = stages == 2 ? (j & 1) : 0;
      if (stages == 2 && j + 1 < ntiles) {
        load(j + 1, (j + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* tQ = sQ + buf * kStream * ld;
      const T* tG = sG + buf * kStream * ld;
      const float* tL = sL + buf * kStream;
      const float* tD = sD + buf * kStream;
      float pt[4][4] = {}, dpt[4][4] = {};
      score_pair<T>(pt, dpt, smem_u32(sK + arow), smem_u32(sV + arow), smem_u32(tQ + brow),
                    smem_u32(tG + brow), ld, kp);
      const int left = N - j * kStream;  // valid query rows of this tile
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nt * 8 + tq * 2 + (i & 1);
          const float p = kvalid[i >> 1] && col < left
                              ? fast_exp2(fmaf(pt[nt][i], scale_log2, -tL[col])) : 0.f;
          pt[nt][i] = p;                        // P^T
          dpt[nt][i] = p * (dpt[nt][i] - tD[col]);  // dS^T
        }
      uint32_t pa[2][4], dsa[2][4];
      scores_to_a<T>(pa, pt);
      scores_to_a<T>(dsa, dpt);
      acc_times_tile<T, DN>(dva, pa, smem_u32(tG + trow), ld);   // dV += P^T dO
      acc_times_tile<T, DN>(dka, dsa, smem_u32(tQ + trow), ld);  // dK += dS^T Q
      __syncthreads();
      if (stages == 1 && j + 1 < ntiles) {
        load(j + 1, 0);
        cp_async_commit();
      }
    }
  }
  const int row0 = kb0 + warp * 16;
  store_rows16<T, DN>(dk + b * st.dk[0] + h * st.dk[2], st.dk[1], dka, scale, row0, M, c0, D);
  store_rows16<T, DN>(dv + b * st.dv[0] + h * st.dv[2], st.dv[1], dva, 1.f, row0, M, c0, D);
}

// The accumulators' width a CTA takes: the least of the instantiated widths
// that holds `cols`.
inline int pick_width(int cols) {
  for (int w : {32, 64, 80, 96, 128, 160, 256})
    if (w >= cols) return w;
  return 0;
}

// Bytes of shared memory of the two kernels at row stride ld and `stages`.
inline size_t dq_smem(int ld, int stages) {
  return 2 * (size_t)ld * (2 * kOwn + 2 * stages * kStream);
}
inline size_t dkdv_smem(int ld, int stages) {
  return dq_smem(ld, stages) + 4 * (size_t)stages * 2 * kStream;
}

template <typename T, int DN>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, int B, int N,
                      int kv_len, int H, int D, int W, int blocks, const Strides& st, float scale,
                      cudaStream_t stream) {
  const int ld = row_ld(W);
  const int stages = dq_smem(ld, 2) <= (size_t)kMaxSmem ? 2 : 1;
  const size_t smem = dq_smem(ld, stages);
  auto kernel = dq_kernel<T, DN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + kOwn - 1) / kOwn, B * H, blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), N,
      kv_len, H, D, W, ld, stages, st, scale);
  return cudaGetLastError();
}

template <typename T, int DN>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int B, int N,
                        int M, int kv_len, int H, int D, int W, int blocks, const Strides& st,
                        float scale, cudaStream_t stream) {
  const int ld = row_ld(W);
  const int stages = dkdv_smem(ld, 2) <= (size_t)kMaxSmem ? 2 : 1;
  const size_t smem = dkdv_smem(ld, stages);
  auto kernel = dkdv_kernel<T, DN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((M + kOwn - 1) / kOwn, B * H, blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, M,
      kv_len, H, D, W, ld, stages, st, scale);
  return cudaGetLastError();
}

// Column blocks: dQ's accumulator holds up to 256 columns a CTA (one
// accumulator), dK/dV's up to 128 (two of them, beside the score tiles);
// a wider head dim is split over the grid's z, each CTA recomputing the
// scores over the whole head dim (dP needs all of it).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int B, int N, int M, int kv_len, int H, int D, const Strides& st,
                     float scale, cudaStream_t s) {
  const int dp = (D + 15) / 16 * 16;
  int blocks_q = (dp + 255) / 256;
  const int wq = pick_width((dp + blocks_q - 1) / blocks_q);
  blocks_q = (dp + wq - 1) / wq;
  int blocks_k = (dp + 127) / 128;
  const int wk = pick_width((dp + blocks_k - 1) / blocks_k);
  blocks_k = (dp + wk - 1) / wk;
  const int Wq = blocks_q * wq > dp ? blocks_q * wq : dp;
  const int Wk = blocks_k * wk > dp ? blocks_k * wk : dp;
  cudaError_t err = cudaErrorInvalidValue;
#define TB_DQ(DN)                                                                           \
  case DN:                                                                                  \
    err = launch_dq<T, DN>(q, k, v, o, dout, lse, delta, dq, B, N, kv_len, H, D, Wq,       \
                           blocks_q, st, scale, s);                                         \
    break;
  switch (wq) { TB_DQ(32) TB_DQ(64) TB_DQ(80) TB_DQ(96) TB_DQ(128) TB_DQ(160) TB_DQ(256) }
#undef TB_DQ
  if (err != cudaSuccess) return err;
  err = cudaErrorInvalidValue;
#define TB_DKDV(DN)                                                                         \
  case DN:                                                                                  \
    err = launch_dkdv<T, DN>(q, k, v, dout, lse, delta, dk, dv, B, N, M, kv_len, H, D, Wk,  \
                             blocks_k, st, scale, s);                                       \
    break;
  switch (wk) { TB_DKDV(32) TB_DKDV(64) TB_DKDV(80) TB_DKDV(96) TB_DKDV(128) }
#undef TB_DKDV
  return err;
}

}  // namespace mma

// ---------------------------------------------------------------------------
// 4. The CUDA-core variant: fp32 at any D <= 512.  The same split, on
//    register tiles (flash_tiles.cuh), fp32 arithmetic and accumulators.
// ---------------------------------------------------------------------------
namespace cc {

using namespace tiles;


// 1. delta and dQ, one CTA of 256 threads per (batch*head, 64 query rows):
// K and V streamed 64 keys at a time.  S and dP from the rows of Q, dO, K
// and V (the whole head dim at once where it fits, Q and dO staged once and
// the next K/V tile's cp.async under this tile's products where two stages
// fit; else D in chunks), P and dS on the thread's 4 x 4 blocks, dS
// transposed into shared memory, dQ += dS K with K's rows, each task's 4
// rows x 4 W4 columns of dQ in registers (4 W4 G >= D).
template <int W4>
__global__ void __launch_bounds__(kThreads, W4 <= 2 ? 2 : 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ o, const float* __restrict__ g, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq, int N, int kv_len, int H, int D,
          int G, int dc, int ld, int stages, const Strides st, float scale) {
  const int bw = 4 * W4 * G;  // dQ's columns, >= D
  const bool one = dc >= D;
  const int k_floats = kTile * ld + (one ? bw : 0);  // slack: dQ's reads past D
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [64][ld], Q's rows (a chunk of them)
  float* sG = sQ + kTile * ld;                   // [64][ld], dO's rows
  float* sK = sG + kTile * ld;                   // [stages][k_floats]
  float* sV = sK + stages * k_floats;            // [stages][64][ld]
  float* sKr = sV + stages * kTile * ld;         // [64][bw], K's rows (chunked only)
  float* sS = sKr + (one ? 0 : kTile * bw);      // [64][kLd], dS transposed
  float* sL = sS + kTile * kLd;                  // [64], lse in log2 units
  float* sD = sL + kTile;                        // [64], delta

  const int tx = tile_tx();
  const int ty = tile_ty();
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const float scale_log2 = scale * kLog2e;
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  const float* ob = o + b * st.o[0] + h * st.o[2];
  const float* gb = g + b * st.g[0] + h * st.g[2];
  const int ntiles = (kv_len + kTile - 1) / kTile;
  const int cols = (dc + 3) / 4 * 4;

  auto load = [&](int j, int buf) {  // K and V of tile j (one chunk)
    stage(sK + buf * k_floats, ld, kb, st.k[1], j * kTile, kv_len, 0, cols, D);
    stage(sV + buf * kTile * ld, ld, vb, st.v[1], j * kTile, kv_len, 0, cols, D);
  };
  if (one) {
    stage(sQ, ld, qb, st.q[1], q0, N, 0, cols, D);
    stage(sG, ld, gb, st.g[1], q0, N, 0, cols, D);
    load(0, 0);
    hopper::cp_async_commit();
  }
  // delta = rowsum(o * dO) and lse of the CTA's rows, four threads a row.
  {
    const int r = threadIdx.x >> 2;
    const int n = q0 + r;
    float part = 0.f;
    if (n < N)
      for (int d = threadIdx.x & 3; d < D; d += 4)
        part = fmaf(ob[n * st.o[1] + d], gb[n * st.g[1] + d], part);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if ((threadIdx.x & 3) == 0) {
      sD[r] = part;
      sL[r] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
      if (n < N) delta[(long long)bh * N + n] = part;
    }
  }

  float acc[4][4 * W4];
  zero<W4>(acc);
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    const int buf = stages == 2 ? (j & 1) : 0;
    float s[4][4] = {}, dp[4][4] = {};
    if (one) {
      hopper::cp_async_wait<0>();
      __syncthreads();  // tile j is in; every thread is done with tile j - 1
      if (stages == 2 && j + 1 < ntiles) {
        load(j + 1, (j + 1) & 1);
        hopper::cp_async_commit();
      }
      dot_rows(s, sQ, ld, sK + buf * k_floats, ld, cols / 4);     // S = Q K^T
      dot_rows(dp, sG, ld, sV + buf * kTile * ld, ld, cols / 4);  // dP = dO V^T
    } else {
      for (int d0 = 0; d0 < D; d0 += dc) {
        const int c = min(dc, (D - d0 + 3) / 4 * 4);
        __syncthreads();  // the chunk tiles (and the last tile's sKr, sS) are consumed
        stage(sQ, ld, qb, st.q[1], q0, N, d0, c, D);
        stage(sG, ld, gb, st.g[1], q0, N, d0, c, D);
        stage(sK, ld, kb, st.k[1], k0, kv_len, d0, c, D);
        stage(sV, ld, vb, st.v[1], k0, kv_len, d0, c, D);
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
        __syncthreads();
        dot_rows(s, sQ, ld, sK, ld, c / 4);
        dot_rows(dp, sG, ld, sV, ld, c / 4);
      }
      stage(sKr, bw, kb, st.k[1], k0, kv_len, 0, bw, D);
      hopper::cp_async_commit();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = k0 + tx + 16 * c < kv_len
                            ? exp2f(fmaf(s[r][c], scale_log2, -sL[4 * ty + r])) : 0.f;
        s[r][c] = p * (dp[r][c] - sD[4 * ty + r]);  // dS
      }
    store_pt(sS, s);
    if (!one) hopper::cp_async_wait<0>();
    __syncthreads();
    tile_acc<W4>(acc, sS, one ? sK + buf * k_floats : sKr, one ? ld : bw, G);  // dQ += dS K
    if (one && stages == 1) {
      __syncthreads();
      if (j + 1 < ntiles) {
        load(j + 1, 0);
        hopper::cp_async_commit();
      }
    }
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_acc<float, W4>(dq + b * st.dq[0] + h * st.dq[2], st.dq[1], acc, mul, q0, N, 0, D, G);
}

// 2. dK and dV, one CTA of 256 threads per (batch*head, 64 keys, 4 W4 G
// columns of dK and dV): Q and dO streamed 64 rows at a time with their lse
// and delta.  The transposed scores S^T = K Q^T and dP^T = V dO^T from the
// rows (as in the dQ kernel: K and V staged once and the next Q/dO tile
// under this tile's products where the head dim fits), P^T and dS^T
// transposed into shared memory, dV += P^T dO and dK += dS^T Q with Q's
// and dO's rows.  Keys at or past kv_len get P = 0, so their rows are
// written as zeros.
template <int W4>
__global__ void __launch_bounds__(kThreads, W4 <= 1 ? 2 : 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ g, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int N,
            int M, int kv_len, int H, int D, int G, int dc, int ld, int stages, const Strides st,
            float scale) {
  const int bw = 4 * W4 * G;  // columns of dK and dV a CTA holds
  const bool one = dc >= D;
  const int r_floats = kTile * ld + (one ? bw : 0);  // slack: reads past D
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [64][ld], K's rows (a chunk of them)
  float* sV = sK + kTile * ld;                   // [64][ld]
  float* sQ = sV + kTile * ld;                   // [stages][r_floats]
  float* sG = sQ + stages * r_floats;            // [stages][r_floats], dO
  float* sQr = sG + stages * r_floats;           // [64][bw], Q's rows (chunked only)
  float* sGr = sQr + (one ? 0 : kTile * bw);     // [64][bw], dO's rows (chunked only)
  float* sP = sGr + (one ? 0 : kTile * bw);      // [64][kLd], P[query][key]
  float* sS = sP + kTile * kLd;                  // [64][kLd], dS[query][key]
  float* sL = sS + kTile * kLd;                  // [stages][64], lse in log2 units
  float* sD = sL + stages * kTile;               // [stages][64], delta

  const int tx = tile_tx();
  const int ty = tile_ty();
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kb0 = blockIdx.x * kTile;
  const int c0 = blockIdx.z * bw;
  const float scale_log2 = scale * kLog2e;
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  const float* gb = g + b * st.g[0] + h * st.g[2];
  const int ntiles = (N + kTile - 1) / kTile;
  const int cols = (dc + 3) / 4 * 4;

  float dka[4][4 * W4], dva[4][4 * W4];
  zero<W4>(dka);
  zero<W4>(dva);
  if (kb0 < kv_len) {  // uniform over the CTA: a CTA of masked keys only writes zeros
    auto stats = [&](int n0, int buf) {  // lse and delta of the rows from n0
      if (threadIdx.x < kTile) {
        const int n = n0 + threadIdx.x;
        sL[buf * kTile + threadIdx.x] = n < N ? lse[(long long)bh * N + n] * kLog2e : 0.f;
        sD[buf * kTile + threadIdx.x] = n < N ? delta[(long long)bh * N + n] : 0.f;
      }
    };
    auto load = [&](int j, int buf) {  // Q, dO, lse and delta of tile j (one chunk)
      stage(sQ + buf * r_floats, ld, qb, st.q[1], j * kTile, N, 0, cols, D);
      stage(sG + buf * r_floats, ld, gb, st.g[1], j * kTile, N, 0, cols, D);
      stats(j * kTile, buf);
    };
    if (one) {
      stage(sK, ld, kb, st.k[1], kb0, kv_len, 0, cols, D);
      stage(sV, ld, vb, st.v[1], kb0, kv_len, 0, cols, D);
      load(0, 0);
      hopper::cp_async_commit();
    }
    bool kvalid[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) kvalid[r] = kb0 + 4 * ty + r < kv_len;
    for (int j = 0; j < ntiles; ++j) {
      const int n0 = j * kTile;
      const int buf = stages == 2 ? (j & 1) : 0;
      float s[4][4] = {}, dp[4][4] = {};
      if (one) {
        hopper::cp_async_wait<0>();
        __syncthreads();  // tile j is in; every thread is done with tile j - 1
        if (stages == 2 && j + 1 < ntiles) {
          load(j + 1, (j + 1) & 1);
          hopper::cp_async_commit();
        }
        dot_rows(s, sK, ld, sQ + buf * r_floats, ld, cols / 4);   // S^T = K Q^T
        dot_rows(dp, sV, ld, sG + buf * r_floats, ld, cols / 4);  // dP^T = V dO^T
      } else {
        for (int d0 = 0; d0 < D; d0 += dc) {
          const int c = min(dc, (D - d0 + 3) / 4 * 4);
          __syncthreads();  // the chunk tiles (and the last tile's row tiles) are consumed
          stage(sK, ld, kb, st.k[1], kb0, kv_len, d0, c, D);
          stage(sV, ld, vb, st.v[1], kb0, kv_len, d0, c, D);
          stage(sQ, ld, qb, st.q[1], n0, N, d0, c, D);
          stage(sG, ld, gb, st.g[1], n0, N, d0, c, D);
          hopper::cp_async_commit();
          hopper::cp_async_wait<0>();
          __syncthreads();
          dot_rows(s, sK, ld, sQ, ld, c / 4);
          dot_rows(dp, sV, ld, sG, ld, c / 4);
        }
        stage(sQr, bw, qb, st.q[1], n0, N, c0, bw, D);
        stage(sGr, bw, gb, st.g[1], n0, N, c0, bw, D);
        stats(n0, 0);
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
        __syncthreads();
      }
      const float* tL = sL + buf * kTile;
      const float* tD = sD + buf * kTile;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = tx + 16 * c;
          const float p = kvalid[r] && n0 + i < N
                              ? exp2f(fmaf(s[r][c], scale_log2, -tL[i])) : 0.f;
          s[r][c] = p;                        // P^T
          dp[r][c] = p * (dp[r][c] - tD[i]);  // dS^T
        }
      store_pt(sP, s);
      store_pt(sS, dp);
      __syncthreads();
      const int ldr = one ? ld : bw;
      tile_acc<W4>(dva, sP, one ? sG + buf * r_floats : sGr, ldr, G);  // dV += P^T dO
      tile_acc<W4>(dka, sS, one ? sQ + buf * r_floats : sQr, ldr, G);  // dK += dS^T Q
      if (one && stages == 1) {
        __syncthreads();
        if (j + 1 < ntiles) {
          load(j + 1, 0);
          hopper::cp_async_commit();
        }
      }
    }
  }
  const float mul_k[4] = {scale, scale, scale, scale};
  const float mul_v[4] = {1.f, 1.f, 1.f, 1.f};
  store_acc<float, W4>(dk + b * st.dk[0] + h * st.dk[2], st.dk[1], dka, mul_k, kb0, M, c0, D, G);
  store_acc<float, W4>(dv + b * st.dv[0] + h * st.dv[2], st.dv[1], dva, mul_v, kb0, M, c0, D, G);
}

template <int W4>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* o,
                      const float* dout, const float* lse, float* delta, float* dq, int B, int N,
                      int kv_len, int H, int D, const Strides& st, float scale,
                      cudaStream_t stream) {
  const int G = acc_groups(D, W4);
  const int bw = 4 * W4 * G;
  const Plan plan = pick_plan(D, 256, [&](int dc, int ld, int stages) {
    const bool one = dc >= D;
    return (long long)kTile * ld * (2 + 2 * stages) + (one ? stages * bw : kTile * bw) +
           kTile * kLd + 2 * kTile;
  });
  if (plan.dc == 0) return cudaErrorInvalidValue;
  auto kernel = dq_kernel<W4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + kTile - 1) / kTile, B * H), kThreads, plan.bytes, stream>>>(
      q, k, v, o, dout, lse, delta, dq, N, kv_len, H, D, G, plan.dc, plan.ld, plan.stages, st,
      scale);
  return cudaGetLastError();
}

template <int W4>
cudaError_t launch_dkdv(const float* q, const float* k, const float* v, const float* dout,
                        const float* lse, const float* delta, float* dk, float* dv, int B, int N,
                        int M, int kv_len, int H, int D, int cols, const Strides& st,
                        float scale, cudaStream_t stream) {
  const int G = acc_groups(cols, W4);
  const int bw = 4 * W4 * G;
  const int blocks = (D + bw - 1) / bw;
  // One chunk only where one column block covers D (the tiles then feed the
  // accumulating products from column 0).
  const Plan plan = pick_plan(D, blocks == 1 ? 256 : 0, [&](int dc, int ld, int stages) {
    const bool one = dc >= D;
    return (long long)kTile * ld * (2 + 2 * stages) + (one ? 2 * stages * bw : 2 * kTile * bw) +
           2 * kTile * kLd + 2 * stages * kTile;
  });
  if (plan.dc == 0) return cudaErrorInvalidValue;
  auto kernel = dkdv_kernel<W4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((M + kTile - 1) / kTile, B * H, blocks), kThreads, plan.bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, N, M, kv_len, H, D, G, plan.dc, plan.ld, plan.stages,
      st, scale);
  return cudaGetLastError();
}

// The accumulators' tasks (flash_tiles.cuh): dQ's CTA holds the whole head
// dim (W4 float4 columns a task, 16 row groups x G column groups <= 256
// tasks); dK/dV's, with two accumulators, at most 256 columns, a wider head
// dim split over the grid's z with the scores recomputed in each column
// block.
cudaError_t dispatch(const void* q_, const void* k_, const void* v_, const void* o_,
                     const void* dout_, const float* lse, float* delta, void* dq_, void* dk_,
                     void* dv_, int B, int N, int M, int kv_len, int H, int D, const Strides& st,
                     float scale, cudaStream_t s) {
  const float* q = static_cast<const float*>(q_);
  const float* k = static_cast<const float*>(k_);
  const float* v = static_cast<const float*>(v_);
  const float* o = static_cast<const float*>(o_);
  const float* dout = static_cast<const float*>(dout_);
  float* dq = static_cast<float*>(dq_);
  float* dk = static_cast<float*>(dk_);
  float* dv = static_cast<float*>(dv_);
#define TB_DQ(W4) launch_dq<W4>(q, k, v, o, dout, lse, delta, dq, B, N, kv_len, H, D, st, scale, s)
  const int wq = ((D + 3) / 4 + 15) / 16;
  cudaError_t err = wq <= 1   ? TB_DQ(1)
                    : wq <= 2 ? TB_DQ(2)
                    : wq <= 3 ? TB_DQ(3)
                    : wq <= 4 ? TB_DQ(4)
                    : wq <= 6 ? TB_DQ(6)
                    : wq <= 8 ? TB_DQ(8)
                              : cudaErrorInvalidValue;
#undef TB_DQ
  if (err != cudaSuccess) return err;
  const int blocks = (D + 255) / 256;
  const int cols = (D + blocks - 1) / blocks;  // a column block's share of D
  const int wk = ((cols + 3) / 4 + 15) / 16;
#define TB_DKDV(W4) \
  launch_dkdv<W4>(q, k, v, dout, lse, delta, dk, dv, B, N, M, kv_len, H, D, cols, st, scale, s)
  return wk <= 1 ? TB_DKDV(1) : wk <= 2 ? TB_DKDV(2) : wk <= 3 ? TB_DKDV(3) : TB_DKDV(4);
#undef TB_DKDV
}

}  // namespace cc

enum Variant { kCudaCores = 0, kWgmma = 1, kMma = 2 };

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
// kernels serve the call: 0 CUDA cores, 1 wgmma, 2 mma.  Returns the first launch
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
  *variant = dtype == 0 ? kCudaCores : wgmma ? kWgmma : kMma;
#define TB_ARGS q, k, v, o, dout, l, dl, dq, dk, dv, B, N, M, kv_len, H, D, st, scale, s
  switch (dtype) {
    case 0: return (int)cc::dispatch(TB_ARGS);
    case 1: return (int)(wgmma ? dispatch_wgmma<__half>(TB_ARGS) : mma::dispatch<__half>(TB_ARGS));
    default:
      return (int)(wgmma ? dispatch_wgmma<__nv_bfloat16>(TB_ARGS)
                         : mma::dispatch<__nv_bfloat16>(TB_ARGS));
  }
#undef TB_ARGS
}
