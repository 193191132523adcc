// Register tiles of the flash kernels' fp32 forms on the CUDA cores: the
// pieces that the forward's and the backward's "cuda_cores" variants share
// (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Every product of those kernels is an SGEMM-shaped product of 64 x 64 tiles
// (or 64-row accumulators) held in shared memory as fp32, computed by a CTA
// of 256 threads laid out 16 x 16 (tx = thread % 16, ty = thread / 16), each
// thread holding a 4 x 4 block of the score tile and 4 x 4 W4 of the
// accumulator in registers.
//
// Score products (S = A B^T, reduced over the head dim) read both operands
// as their rows lie in device memory, [row][d], staged by cp.async: thread
// (ty, tx) owns rows 4 ty + r of A and rows tx + 16 q of B (r, q < 4), and
// one step of 4 columns is 8 float4 reads feeding 64 FMAs.  The A reads are
// broadcasts (one address for the 16 threads of a thread-grid row); the B
// rows are 16 consecutive rows whose stride is an odd number of float4s
// (`row_ld`), so no two of 8 neighbouring threads share a bank.
//
// The probabilities then go to shared memory transposed (`store_pt`: P^T,
// a float4 of 4 rows per column, again conflict-free), and the accumulating
// products (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q) read them as
// k-major A operands beside the value-side tile as it lies ([k][d]): one k
// step is one float4 of P and W4 float4s of the tile, feeding 16 W4 FMAs
// (`tile_acc`, whose tasks cover the head dim in 4-column groups).  Where D
// fits one tile, the tile that fed a score product (K, Q or dO) feeds the
// accumulating product too; its reads run past the end of a row into
// columns at or past D, whose sums are never stored, so the layouts leave
// 4 W4 G floats of slack after such a tile.
//
// Arithmetic and accumulators are fp32 throughout (no TF32).
#pragma once

#include "hopper.cuh"

#include <initializer_list>

namespace tiles {

using hopper::from_float;
using hopper::smem_u32;
using hopper::to_float;

constexpr int kThreads = 256;     // 16 x 16
constexpr int kTile = 64;         // rows and columns of every score tile
constexpr int kLd = kTile + 4;    // row stride (floats) of a transposed P tile
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA may have (227 KB)
constexpr int kHalfSmem = 115712; // ... and each of two CTAs on one SM

// Thread (ty, tx) of the 16 x 16 grid: a warp holds 2 rows of 16 threads,
// so that the forward's row reductions stay in a half warp.
__device__ __forceinline__ int tile_tx() { return threadIdx.x & 15; }
__device__ __forceinline__ int tile_ty() { return threadIdx.x >> 4; }

// Row stride (floats) of a [rows][cols] tile read as float4 rows: cols
// rounded up to a multiple of 4, then to an odd number of float4s.
__host__ __device__ inline int row_ld(int cols) {
  int c4 = (cols + 3) / 4;
  if ((c4 & 1) == 0) c4 += 1;
  return 4 * c4;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// dst[r][c] (row stride ld) = src row r0 + r, column c0 + c, for r < 64 and
// c < cols; zero past `valid` rows and past D.  fp32 goes by cp.async (the
// caller commits and waits), a 16-bit type by loads converted to fp32.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, long long sn, int r0,
                                      int valid, int c0, int cols, int D) {
  if constexpr (std::is_same<T, float>::value) {
    // 16-byte copies where the rows lie in whole 16-byte chunks (cols and ld
    // are multiples of 4); a chunk that crosses D goes by element loads.
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (sn & 3) == 0 && (c0 & 3) == 0) {
      const int c4n = cols / 4;
      for (int idx = threadIdx.x; idx < kTile * c4n; idx += kThreads) {
        const int r = idx / c4n;
        const int c = 4 * (idx - r * c4n);
        const int n = r0 + r;
        const int d = c0 + c;
        float* p = dst + r * ld + c;
        if (n < valid && d + 4 <= D) {
          hopper::cp_async16(p, src + n * sn + d);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = n < valid && d + e < D ? src[n * sn + d + e] : 0.f;
        }
      }
      return;
    }
  }
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kTile; r += kThreads / 32) {  // a warp a row
    const int n = r0 + r;
    for (int c = lane; c < cols; c += 32) {
      const int d = c0 + c;
      float* p = dst + r * ld + c;
      if (n < valid && d < D) {
        if constexpr (std::is_same<T, float>::value)
          cp_async4(p, src + n * sn + d);
        else
          *p = to_float(src[n * sn + d]);
      } else {
        *p = 0.f;
      }
    }
  }
}

// s[r][q] += sum_{d < 4 d4n} a[4 ty + r][d] * b[tx + 16 q][d] (row strides
// lda, ldb floats; columns past the head dim are zero).
__device__ __forceinline__ void dot_rows(float (&s)[4][4], const float* a, int lda,
                                         const float* b, int ldb, int d4n) {
  const float4* pa = reinterpret_cast<const float4*>(a + 4 * tile_ty() * lda);
  const float4* pb = reinterpret_cast<const float4*>(b + tile_tx() * ldb);
  const int sa = lda / 4;
  const int sb = 4 * ldb;  // 16 rows, in float4s
#pragma unroll 1
  for (int d4 = 0; d4 < d4n; ++d4) {
    float4 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = pa[r * sa + d4];
#pragma unroll
    for (int q = 0; q < 4; ++q) y[q] = pb[q * sb + d4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[r][q] = fmaf(x[r].x, y[q].x, s[r][q]);
        s[r][q] = fmaf(x[r].y, y[q].y, s[r][q]);
        s[r][q] = fmaf(x[r].z, y[q].z, s[r][q]);
        s[r][q] = fmaf(x[r].w, y[q].w, s[r][q]);
      }
  }
}

// The thread's 4 x 4 block x of a score tile (rows 4 ty + r, columns
// tx + 16 q) into dst transposed: dst[tx + 16 q][4 ty + r], row stride kLd.
__device__ __forceinline__ void store_pt(float* dst, const float (&x)[4][4]) {
  const int tx = tile_tx();
  const int ty = tile_ty();
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float4*>(dst + (tx + 16 * q) * kLd + 4 * ty) =
        make_float4(x[0][q], x[1][q], x[2][q], x[3][q]);
}

// The accumulating products' tasks: task t < 16 G (thread t) owns rows
// 4 (t / G) + r of the 64-row accumulator and, of its W4 G float4 columns,
// those numbered t % G + G i (i < W4): columns 4 (t % G + G i) + c.  With G
// the least number of groups that covers the head dim, a thread past 16 G
// has no task and its warp skips the product, so a head dim of 40 costs 40
// columns' FMAs, not 64.  Neighbouring tasks read neighbouring float4s.
__host__ __device__ inline int acc_groups(int cols, int w4) { return ((cols + 3) / 4 + w4 - 1) / w4; }

// acc[r][4 i + c] += sum_{k < 64} p[k][4 (t / G) + r] * m[k][4 (t % G + G i) + c]:
// p [64][64] with row stride kLd (from store_pt), m [64][>= 4 W4 G] with row
// stride ldm (a multiple of 4).
template <int W4>
__device__ __forceinline__ void tile_acc(float (&acc)[4][4 * W4], const float* p,
                                         const float* m, int ldm, int G) {
  const int t = threadIdx.x;
  if (t >= 16 * G) return;
  const int rg = t / G;
  const float4* pp = reinterpret_cast<const float4*>(p) + rg;
  const float4* pm = reinterpret_cast<const float4*>(m) + (t - rg * G);
  constexpr int kStepP = kLd / 4;
  const int step_m = ldm / 4;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 a = pp[k * kStepP];
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < W4; ++i) {
      const float4 b = pm[k * step_m + G * i];
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][4 * i + c] = fmaf(av[r], bv[c], acc[r][4 * i + c]);
    }
  }
}

template <int W4> __device__ __forceinline__ void zero(float (&acc)[4][4 * W4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4 * W4; ++c) acc[r][c] = 0.f;
}

// The task's rows row0 + 4 (t / G) + r (< rows) of acc * mul[r] into `out`
// (rows `rs` elements apart), columns c0 + 4 (t % G + G i) + c (< D).
template <typename T, int W4>
__device__ __forceinline__ void store_acc(T* out, long long rs, const float (&acc)[4][4 * W4],
                                          const float (&mul)[4], int row0, int rows, int c0,
                                          int D, int G) {
  const int t = threadIdx.x;
  if (t >= 16 * G) return;
  const int rg = t / G;
  const int cg = t - rg * G;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = row0 + 4 * rg + r;
    if (n >= rows) continue;
#pragma unroll
    for (int i = 0; i < W4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = c0 + 4 * (cg + G * i) + c;
        if (d < D) out[n * rs + d] = from_float<T>(acc[r][4 * i + c] * mul[r]);
      }
  }
}

// How a kernel lays out its tiles, chosen on the host.  `dc`: the head-dim
// chunk of the score products (D itself, "one chunk", where the whole head
// dim fits; then the score tiles stay and feed the accumulating product
// too); `ld`: the score tiles' row stride; `stages`: 2 where the streamed
// tiles are double-buffered (cp.async of tile j + 1 under the products of
// tile j), else 1.
struct Plan {
  int dc, ld, stages;
  size_t bytes;
};

// The first plan that fits, best first: one chunk, two stages, two CTAs an
// SM; one chunk, one stage, two CTAs; the same with one CTA an SM; then
// chunks of 64, 32, 16 columns with one stage.  `floats(dc, ld, stages)`
// gives a plan's shared memory in floats; one chunk only where D <= max_one.
template <typename F>
inline Plan pick_plan(int D, int max_one, F floats) {
  if (D <= max_one) {
    const int ld = row_ld(D);
    for (long long limit : {(long long)kHalfSmem, (long long)kMaxSmem})
      for (int stages : {2, 1}) {
        const size_t b = 4 * (size_t)floats(D, ld, stages);
        if (b <= (size_t)limit) return {D, ld, stages, b};
      }
  }
  for (int dc : {64, 32, 16}) {
    if (dc >= D) continue;
    const int ld = row_ld(dc);
    const size_t b = 4 * (size_t)floats(dc, ld, 1);
    if (b <= (size_t)kMaxSmem) return {dc, ld, 1, b};
  }
  return {0, 0, 0, 0};
}

}  // namespace tiles
