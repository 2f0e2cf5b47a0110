// Forward flash AAM (ArcFace) cross-entropy for Hopper (sm_90a).
//
// Replaces the TPU kernel pkr_tpu/ops/flash_aam.py::_fwd_kernel (launched by
// _fwd_pallas).  For L2-normalised embeddings e (B, D), class weights W (C, D),
// labels (B,) and the precomputed margined target logits zt (B,), it returns
// per example, without ever writing the (B, C) logits:
//   lse = log sum_c exp(z_c)            z_c = s * (c == y ? phi(cos_c) : cos_c)
//   zy  = z_y                           (the very float that entered the max)
//   mx  = max_c z_c                     (top-1: zy >= mx)
//   cnt = #{c != y : z_c > zt}          (top-5: cnt < 5)
// with cos_c = e . w_c / sqrt(max(|w_c|^2, 1e-24)) and phi the ArcFace margin
// with the hard-margin guard.
//
// What bounds it: 2*B*C*D f32 operations against B*D + C*D f32 inputs.  At
// B=256, C=7325, D=256 that is 0.96 GFLOP (14 us at the H100's 67 TFLOP/s
// f32 CUDA-core peak) against 7.8 MB (2.3 us at 3.35 TB/s): compute-bound in
// f32.  The product must stay at f32 accuracy (cosines near +-1 feed the
// margin), so it runs on f32 FMAs, not TF32 tensor cores.
//
// Design.  The TPU kernel walks the class tiles in order on one core with the
// whole batch resident in VMEM.  Here blocks run in parallel, so the grid is
// (batch tiles of 64 rows) x (class splits).  A block loops over its split's
// 64-class tiles: a 64x64 SGEMM tile (256 threads, 4x4 outputs each, 16-deep
// chunks of e and W staged in shared memory), the row norms of W accumulated
// from the same staged chunks, then the margin epilogue and an online
// (max, sum-exp) update per thread.  Columns >= C are skipped, so W is never
// padded.  At the end the 16 threads that share a row merge their states with
// warp shuffles and the block writes one partial state per (split, row).  A
// second small kernel merges the splits in a fixed order, without atomics, so
// the result is deterministic.  The tile product and the margin live in
// flash_aam_common.cuh, shared with the backward kernel.  Faster versions
// (3xTF32 or wgmma, TMA) are later work.

#include "flash_aam_common.cuh"

namespace {

using namespace flash_aam;

__global__ void __launch_bounds__(NTHREADS)
fwd_partial_kernel(const float* __restrict__ e, const float* __restrict__ w,
                   const int* __restrict__ labels, const float* __restrict__ zt,
                   int B, int C, int D, int tiles_per_split, Margin mg,
                   float* __restrict__ part) {
  __shared__ __align__(16) float As[BK][BM];  // e chunk, depth-major
  __shared__ __align__(16) float Bs[BK][BN];  // W chunk, depth-major
  __shared__ float wsq[BN];                   // sum of squares of each W row

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // class group: columns tx*TN .. +TN-1
  const int ty = tid / 16;  // row group: rows ty*TM .. +TM-1
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int n_tiles = (C + BN - 1) / BN;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);

  int lab[TM];
  float ztr[TM], run_m[TM], run_s[TM], run_zy[TM], run_cnt[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    lab[i] = r < B ? labels[r] : -1;
    ztr[i] = r < B ? zt[r] : 0.0f;
    run_m[i] = NEG_INF;
    run_s[i] = 0.0f;
    run_zy[i] = 0.0f;
    run_cnt[i] = 0.0f;
  }

  for (int t = tile_lo; t < tile_hi; ++t) {
    const int col0 = t * BN;
    float acc[TM][TN];
    dot_tile(e, w, B, C, D, row0, col0, As, Bs, wsq, acc);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float z[TN];
      float tile_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col0 + tx * TN + j;
        const bool valid = c < C;
        const bool is_tgt = valid && c == lab[i];
        z[j] = margined(cosine(acc[i][j], wsq[tx * TN + j]), is_tgt, mg);
        if (valid) {
          tile_max = fmaxf(tile_max, z[j]);
          if (is_tgt) run_zy[i] += z[j];
          else if (z[j] > ztr[i]) run_cnt[i] += 1.0f;
        }
      }
      const float m_new = fmaxf(run_m[i], tile_max);
      float s_tile = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (col0 + tx * TN + j < C) s_tile += expf(z[j] - m_new);
      run_s[i] = run_s[i] * expf(run_m[i] - m_new) + s_tile;
      run_m[i] = m_new;
    }
  }

  // merge the 16 per-thread states of each row (lanes tx = 0..15 of one
  // half-warp); lane tx == 0 writes the block's partial state
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float m = run_m[i], s = run_s[i], zy = run_zy[i], cnt = run_cnt[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(FULL, m, off);
      const float s2 = __shfl_xor_sync(FULL, s, off);
      zy += __shfl_xor_sync(FULL, zy, off);
      cnt += __shfl_xor_sync(FULL, cnt, off);
      const float mn = fmaxf(m, m2);
      s = s * expf(m - mn) + s2 * expf(m2 - mn);
      m = mn;
    }
    const int r = row0 + ty * TM + i;
    if (tx == 0 && r < B) {
      const size_t plane = (size_t)n_splits * B;
      const size_t at = (size_t)split * B + r;
      part[at] = m;
      part[plane + at] = s;
      part[2 * plane + at] = zy;
      part[3 * plane + at] = cnt;
    }
  }
}

// Merge the per-split states of each row in split order:
// lse = M + log(sum_i s_i exp(m_i - M)), zy = sum zy_i, mx = M, cnt = sum cnt_i.
__global__ void merge_kernel(const float* __restrict__ part, int n_splits, int B,
                             float* __restrict__ lse, float* __restrict__ zy,
                             float* __restrict__ mx, float* __restrict__ cnt) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const size_t plane = (size_t)n_splits * B;
  const float* pm = part;
  const float* ps = part + plane;
  const float* pz = part + 2 * plane;
  const float* pc = part + 3 * plane;
  float M = NEG_INF;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, pm[(size_t)i * B + r]);
  float S = 0.0f, Z = 0.0f, K = 0.0f;
  for (int i = 0; i < n_splits; ++i) {
    const size_t at = (size_t)i * B + r;
    S += ps[at] * expf(pm[at] - M);
    Z += pz[at];
    K += pc[at];
  }
  lse[r] = M + logf(S);
  zy[r] = Z;
  mx[r] = M;
  cnt[r] = K;
}

}  // namespace

extern "C" {

int flash_aam_fwd_block_rows() { return BM; }
int flash_aam_fwd_block_classes() { return BN; }

// e (B, D) f32, w (C, D) f32, labels (B,) i32, zt (B,) f32, all contiguous on
// the card; part is scratch of 4 * n_splits * B floats with
// n_splits = ceil(ceil(C / BN) / tiles_per_split).  Launches on `stream` and
// returns the cudaError_t of the launches (0 on success).
int flash_aam_fwd(const void* e, const void* w, const void* labels, const void* zt,
                  int B, int C, int D, int tiles_per_split, int n_splits,
                  float s, float cos_m, float sin_m, float th, float mm,
                  void* part, void* lse, void* zy, void* mx, void* cnt,
                  void* stream) {
  const int n_tiles = (C + BN - 1) / BN;
  if (B <= 0 || C <= 0 || D <= 0 || tiles_per_split <= 0 ||
      n_splits != (n_tiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Margin mg{s, cos_m, sin_m, th, mm};
  dim3 grid((B + BM - 1) / BM, n_splits);
  fwd_partial_kernel<<<grid, NTHREADS, 0, st>>>(
      static_cast<const float*>(e), static_cast<const float*>(w),
      static_cast<const int*>(labels), static_cast<const float*>(zt), B, C, D,
      tiles_per_split, mg, static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(B + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part), n_splits, B, static_cast<float*>(lse),
      static_cast<float*>(zy), static_cast<float*>(mx), static_cast<float*>(cnt));
  return (int)cudaGetLastError();
}

}  // extern "C"
