// Shared by the forward and backward flash AAM kernels (sm_90a): the ArcFace
// margin (both), and the forward's tile geometry and 64x64 tile of e . w^T on
// f32 FMAs with the norms of its 64 W rows.  The backward computes its
// cosines on the tensor cores (mma_tf32x3.cuh), so they differ from the
// forward's by about an ulp.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace flash_aam {

constexpr int BM = 64;          // batch rows per tile
constexpr int BN = 64;          // classes per tile
constexpr int BK = 16;          // depth of one staged chunk
constexpr int TM = 4;           // rows per thread
constexpr int TN = 4;           // classes per thread
constexpr int NTHREADS = 256;   // (BM / TM) x (BN / TN) = 16 x 16
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

static_assert((BM / TM) * (BN / TN) == NTHREADS, "thread tile");
static_assert(BM * BK == NTHREADS * 4 && BN * BK == NTHREADS * 4, "loader");

struct Margin {
  float s, cos_m, sin_m, th, mm;
};

// The margined, scaled logit.  The _rn intrinsics keep nvcc from contracting
// these steps into FMAs, so each rounds as the plain PyTorch version does.
__device__ __forceinline__ float margined(float cos, bool is_tgt, const Margin& mg) {
  float z = cos;
  if (is_tgt) {
    float sin2 = __fsub_rn(1.0f, __fmul_rn(cos, cos));
    float sin = sqrtf(fminf(fmaxf(sin2, 1e-12f), 1.0f));
    float phi = __fsub_rn(__fmul_rn(cos, mg.cos_m), __fmul_rn(sin, mg.sin_m));
    z = (__fsub_rn(cos, mg.th) > 0.0f) ? phi : __fsub_rn(cos, mg.mm);
  }
  return __fmul_rn(z, mg.s);
}

// ||w|| from the staged sum of squares, clamped as the plain version does.
__device__ __forceinline__ float row_norm(float sumsq) {
  return sqrtf(fmaxf(sumsq, 1e-24f));
}

// cos = (e . w) / ||w||, from one dot_tile output and its row's sum of squares.
__device__ __forceinline__ float cosine(float dot, float sumsq) {
  return __fdiv_rn(dot, row_norm(sumsq));
}

// acc[i][j] = e[row0 + ty*TM + i] . w[col0 + tx*TN + j] (0 outside B or C),
// summed over the depth in order with f32 FMAs, for thread (ty, tx) =
// (tid / 16, tid % 16); wsq[c] = sum of squares of W row col0 + c.  Rows and
// classes past the edge read as zeros.  All 256 threads must call it; it
// returns after a barrier, with wsq readable.  As, Bs and wsq are shared.
__device__ __forceinline__ void dot_tile(const float* __restrict__ e,
                                         const float* __restrict__ w, int B, int C,
                                         int D, int row0, int col0, float (*As)[BM],
                                         float (*Bs)[BN], float* wsq,
                                         float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // loader: each thread stages 4 consecutive depth values of one row
  const int ld_r = tid >> 2;
  const int ld_k = (tid & 3) * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float sq = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();  // the previous chunk (and wsq) has been read
    const int r = row0 + ld_r;
    const int c = col0 + ld_r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + ld_k + q;
      As[ld_k + q][ld_r] = (r < B && k < D) ? e[(size_t)r * D + k] : 0.0f;
      const float v = (c < C && k < D) ? w[(size_t)c * D + k] : 0.0f;
      Bs[ld_k + q][ld_r] = v;
      sq = fmaf(v, v, sq);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  // the 4 loader lanes of a W row are neighbours in one warp
  sq += __shfl_xor_sync(FULL, sq, 1);
  sq += __shfl_xor_sync(FULL, sq, 2);
  if ((tid & 3) == 0) wsq[ld_r] = sq;
  __syncthreads();
}

}  // namespace flash_aam
