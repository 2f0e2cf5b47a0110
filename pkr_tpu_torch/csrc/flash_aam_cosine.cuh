// The cosine tile of both flash AAM kernels (sm_90a): one definition of the
// block geometry, of 1/||w|| and of e . w^T in 3xTF32 on the tensor cores
// (mma_tf32x3.cuh), so that the forward and the backward compute every
// cosine with the same instructions in the same order and get the same bits.
// The cosine of (e row b, W row c) is (e . w) * (1/||w||), where
//   1/||w|| = __frsqrt_rn(max(sum w^2, 1e-24)), the squares summed in
//             tile_rnorms' order, and
//   e . w   = the sum of the two half-depth sums of 16-deep 3xTF32 chunks
//             (cosine_dots),
// with the depth padded by zeros to padded_depth(D).  Both kernels tile the
// batch and the classes by TB and TC from offsets that are multiples of
// them, so (b, c) always lands on the same warp, lane and register.
#pragma once

#include "flash_aam_common.cuh"
#include "mma_tf32x3.cuh"

namespace flash_aam {

constexpr int TB = 32;          // batch rows per tile
constexpr int TC = 32;          // classes per tile
constexpr int DMAX = 256;       // largest depth
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

static_assert(TB == 32 && TC == 32 && WARPS == 8, "warp tiling of cosine_dots");

// The depth of a staged row: D rounded up to a power of two, at least 32
// (stage_rows needs DP / VEC to divide THREADS).
__host__ __device__ inline int padded_depth(int D) {
  int DP = 32;
  while (DP < D) DP *= 2;
  return DP;
}

// rinv[c] = 1 / ||W row c|| of a staged TC-row tile, ||w|| =
// sqrt(max(sum w^2, 1e-24)): 8 threads a row sum every 8th square in f32, a
// fixed butterfly adds them, and the reciprocal square root is rounded once
// (__frsqrt_rn).  Other threads see it after the next __syncthreads.
__device__ __forceinline__ void tile_rnorms(const float* ws, int ld, float* rinv) {
  const int r = threadIdx.x >> 3;
  const int part = threadIdx.x & 7;
  float sq = 0.0f;
  for (int c = part; c < ld; c += 8) {
    const float v = ws[tf32x3::at(r, c, ld)];
    sq = fmaf(v, v, sq);
  }
  sq += __shfl_xor_sync(FULL, sq, 4);
  sq += __shfl_xor_sync(FULL, sq, 2);
  sq += __shfl_xor_sync(FULL, sq, 1);
  if (part == 0) rinv[r] = __frsqrt_rn(fmaxf(sq, 1e-24f));
}

// The 16x8 tile of the 32x32 tile e . w^T that this warp finishes: rows
// 16 * (w % 4 / 2).., classes 8 * cosine_ntile(w)...  Warp w computes the
// 16x16 quadrant w % 4 over half the depth (w / 4), keeps the 16x8 half that
// cosine_ntile names and hands the other to the warp w ^ 4 of the same
// quadrant, through xch (8 x 4 x 32 floats).  Each 16-deep chunk's MMAs
// start from zero and their sum is added to the running f32 sum with a
// rounded add: the tensor cores never add a small term to a large sum, and
// the cosine's error is that of rounded f32 sums of DP / 32 chunk sums.
// The two warps of a quadrant meet at named barrier 1 + quadrant; nothing
// else waits, so the caller publishes other shared data with __syncthreads.
// dot[2 h + q] is row 16 * (w % 4 / 2) + lane / 4 + 8 h, class
// 8 * cosine_ntile(w) + 2 * (lane % 4) + q of the tile.
__device__ __forceinline__ int cosine_ntile(int warp) { return 2 * (warp & 1) + (warp >> 2); }

__device__ __forceinline__ void cosine_dots(float (&dot)[4], const float* es, const float* ws,
                                            int DP, float* xch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = warp & 3;
  const int kh = warp >> 2;
  const int k0 = kh * (DP / 2);
  float sum[1][2][4] = {};
#pragma unroll 2
  for (int kc = 0; kc < DP / 2; kc += 16) {
    float chunk[1][2][4] = {};
    tf32x3::warp_mma_k16<1, 2>(chunk, es, DP, 16 * (quad >> 1), ws, DP, 16 * (quad & 1),
                               k0 + kc);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[0][j][q] = __fadd_rn(sum[0][j][q], chunk[0][j][q]);
  }
  // keep n-tile kh of the quadrant, hand n-tile 1 - kh to the other half
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dot[q] = kh ? sum[0][1][q] : sum[0][0][q];
    xch[(warp * 4 + q) * 32 + lane] = kh ? sum[0][0][q] : sum[0][1][q];
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + quad) : "memory");
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dot[q] = __fadd_rn(dot[q], xch[((warp ^ 4) * 4 + q) * 32 + lane]);
}

}  // namespace flash_aam
