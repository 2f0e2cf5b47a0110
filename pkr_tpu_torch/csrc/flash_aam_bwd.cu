// Backward flash AAM (ArcFace) cross-entropy for Hopper (sm_90a).
//
// Replaces the TPU kernel pkr_tpu/ops/flash_aam.py::_bwd_kernel (launched by
// _bwd_pallas).  For L2-normalised embeddings e (B, D), class weights W (C, D),
// labels (B,), the forward's lse (B,) and the per-example loss gradient
// g (B,), it returns, without ever writing the (B, C) logits:
//   a[b,c] = (p[b,c] - [c == y_b]) * dz/dcos[b,c] * g[b],  p = exp(z - lse)
//   de[b]  = sum_c a[b,c] w_hat[c]                            (B, D)
//   dw[c]  = (dw_hat[c] - (dw_hat[c] . w_hat[c]) w_hat[c]) / ||w_c||,
//            dw_hat[c] = sum_b a[b,c] e[b]                     (C, D)
// where dz/dcos is s off the target and s * phi'(cos) on it, with
// phi' = cos_m - sin_m * dsin inside the margin branch and 1 outside, and
// dsin = -cos / sin, set to 0 where 1 - cos^2 < 1e-12 (the sin clip, through
// which the dense head's autograd passes no gradient).  The cosines come from
// the same dot_tile and margin code as the forward kernel
// (flash_aam_common.cuh), so p is consistent with the forward's lse.
//
// What bounds it: the minimal work is 6*B*C*D f32 operations (the cosine
// product, then a . w_hat and a^T . e) against (B + C) * D f32 inputs and
// outputs.  At B=256, C=7325, D=256 that is 2.9 GFLOP (43 us at the H100's
// 67 TFLOP/s f32 CUDA-core peak) against 15 MB (4.6 us at 3.35 TB/s):
// compute-bound in f32.  The products stay at f32 accuracy, on f32 FMAs.
//
// Design.  The TPU kernel walks the class tiles in order on one core and
// carries de in VMEM across its grid.  Here blocks run in parallel and nothing
// carries over, and the two reductions run different ways: dw reduces over
// the batch, de over the classes.  So there are two kernels, neither with
// float atomics, both deterministic:
//   bwd_dw_kernel: one block per 64-class tile loops over all batch tiles,
//     recomputes each 64x64 tile of a into shared memory and accumulates its
//     (64 x D) dw_hat tile in registers; it holds whole rows of dw_hat, so it
//     applies the row projection and writes dW once.
//   bwd_de_partial_kernel: blocks over (batch tiles) x (class splits)
//     recompute the a tiles of their split and accumulate a (64 x D) de
//     tile; bwd_de_sum_kernel then adds the splits' partials in split order.
// The cosine tiles are computed twice, so the kernels do 8*B*C*D operations
// against the minimal 6*B*C*D; a fused design is later work.  D is at most
// 256 (one register tile of a row); the wrapper checks it.

#include "flash_aam_common.cuh"

namespace {

using namespace flash_aam;

constexpr int DMAX = NTHREADS;        // the staging loads one depth per thread
constexpr int DPT = DMAX / 16;        // depths per thread in the D-wide tiles
constexpr int RPT = 4;                // rows (or classes) per thread there

static_assert(16 * RPT == BM && BM == BN, "accumulator tile");

// dL/dcos times g for one logit: (p - onehot) * dz/dcos * g.
__device__ __forceinline__ float dlogit(float cos, bool is_tgt, float lse, float g,
                                        const Margin& mg) {
  const float p = expf(__fsub_rn(margined(cos, is_tgt, mg), lse));
  float dz = mg.s;
  if (is_tgt) {
    float dphi = 1.0f;
    if (__fsub_rn(cos, mg.th) > 0.0f) {
      const float sin2 = __fsub_rn(1.0f, __fmul_rn(cos, cos));
      const float sin = sqrtf(fminf(fmaxf(sin2, 1e-12f), 1.0f));
      const float dsin = sin2 >= 1e-12f ? -cos / sin : 0.0f;
      dphi = __fsub_rn(mg.cos_m, __fmul_rn(mg.sin_m, dsin));
    }
    dz = __fmul_rn(mg.s, dphi);
  }
  return __fmul_rn(__fmul_rn(__fsub_rn(p, is_tgt ? 1.0f : 0.0f), dz), g);
}

// The 64x64 tile of a for rows row0.. and classes col0.., zero outside B and C,
// written to shared memory as at[row][class] (TRANSPOSED = false) or
// at[class][row] (true).  Leaves wsq holding the tile's W row sums of squares.
template <bool TRANSPOSED>
__device__ __forceinline__ void a_tile(const float* __restrict__ e,
                                       const float* __restrict__ w,
                                       const int* __restrict__ labels,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ g, int B, int C, int D,
                                       int row0, int col0, const Margin& mg,
                                       float (*As)[BM], float (*Bs)[BN], float* wsq,
                                       float (*at)[BN]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[TM][TN];
  dot_tile(e, w, B, C, D, row0, col0, As, Bs, wsq, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    const bool row_ok = r < B;
    const int lab = row_ok ? labels[r] : -1;
    const float lse_r = row_ok ? lse[r] : 0.0f;
    const float g_r = row_ok ? g[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      float a = 0.0f;
      if (row_ok && c < C)
        a = dlogit(cosine(acc[i][j], wsq[tx * TN + j]), c == lab, lse_r, g_r, mg);
      if (TRANSPOSED) at[tx * TN + j][ty * TM + i] = a;
      else at[ty * TM + i][tx * TN + j] = a;
    }
  }
  __syncthreads();
}

// One block per 64-class tile: dw_hat = a^T e over every batch tile, then
// dW = (dw_hat - (dw_hat . w_hat) w_hat) / ||w||.  Thread (cg, dg) owns
// classes cg*4 .. +3 at depths dg + 16 j.
__global__ void __launch_bounds__(NTHREADS)
bwd_dw_kernel(const float* __restrict__ e, const float* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ g, int B, int C, int D, Margin mg,
              float* __restrict__ dw) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float wsq[BN];
  __shared__ __align__(16) float at[BM][BN];   // a[row][class]
  __shared__ float es[BK][DMAX];               // 16 rows of e

  const int tid = threadIdx.x;
  const int cg = tid / 16;
  const int dg = tid % 16;
  const int col0 = blockIdx.x * BN;
  float acc[RPT][DPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[k][j] = 0.0f;

  for (int row0 = 0; row0 < B; row0 += BM) {
    a_tile<false>(e, w, labels, lse, g, B, C, D, row0, col0, mg, As, Bs, wsq, at);
    for (int rr0 = 0; rr0 < BM; rr0 += BK) {
#pragma unroll
      for (int q = 0; q < BK; ++q) {
        const int r = row0 + rr0 + q;
        es[q][tid] = (r < B && tid < D) ? e[(size_t)r * D + tid] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < BK; ++q) {
        const float4 a4 = *reinterpret_cast<const float4*>(&at[rr0 + q][cg * RPT]);
        const float av[RPT] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float ev = es[q][dg + 16 * j];
#pragma unroll
          for (int k = 0; k < RPT; ++k) acc[k][j] = fmaf(av[k], ev, acc[k][j]);
        }
      }
      __syncthreads();  // es and, after the last chunk, at are free again
    }
  }

  // wsq still holds this class tile's sums of squares (every a_tile call
  // rewrote the same values)
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int cl = cg * RPT + k;
    const int c = col0 + cl;
    const float wn = row_norm(wsq[cl]);
    float what[DPT];
    float proj = 0.0f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = dg + 16 * j;
      what[j] = (c < C && d < D) ? w[(size_t)c * D + d] / wn : 0.0f;
      proj = fmaf(acc[k][j], what[j], proj);
    }
    // the 16 threads of a class are lanes dg = 0..15 of one half-warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) proj += __shfl_xor_sync(FULL, proj, off);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = dg + 16 * j;
      if (c < C && d < D)
        dw[(size_t)c * D + d] = (acc[k][j] - proj * what[j]) / wn;
    }
  }
}

// Blocks over (batch tile, class split): part[split] = a[rows, split] w_hat.
// Thread (rg, dg) owns rows rg*4 .. +3 at depths dg + 16 j.
__global__ void __launch_bounds__(NTHREADS)
bwd_de_partial_kernel(const float* __restrict__ e, const float* __restrict__ w,
                      const int* __restrict__ labels, const float* __restrict__ lse,
                      const float* __restrict__ g, int B, int C, int D,
                      int tiles_per_split, Margin mg, float* __restrict__ part) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float wsq[BN];
  __shared__ __align__(16) float at[BN][BM];   // a[class][row]
  __shared__ float ws[BK][DMAX];               // 16 rows of w_hat

  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int dg = tid % 16;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_tiles = (C + BN - 1) / BN;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  float acc[RPT][DPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[k][j] = 0.0f;

  for (int t = tile_lo; t < tile_hi; ++t) {
    const int col0 = t * BN;
    a_tile<true>(e, w, labels, lse, g, B, C, D, row0, col0, mg, As, Bs, wsq, at);
    for (int cc0 = 0; cc0 < BN; cc0 += BK) {
#pragma unroll
      for (int q = 0; q < BK; ++q) {
        const int c = col0 + cc0 + q;
        ws[q][tid] = (c < C && tid < D) ? w[(size_t)c * D + tid] / row_norm(wsq[cc0 + q])
                                        : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < BK; ++q) {
        const float4 a4 = *reinterpret_cast<const float4*>(&at[cc0 + q][rg * RPT]);
        const float av[RPT] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float wv = ws[q][dg + 16 * j];
#pragma unroll
          for (int k = 0; k < RPT; ++k) acc[k][j] = fmaf(av[k], wv, acc[k][j]);
        }
      }
      __syncthreads();  // ws and, after the last chunk, at and wsq are free again
    }
  }

  float* out = part + (size_t)split * B * D;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = row0 + rg * RPT + k;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = dg + 16 * j;
      if (r < B && d < D) out[(size_t)r * D + d] = acc[k][j];
    }
  }
}

// de = sum of the splits' partials, in split order.
__global__ void bwd_de_sum_kernel(const float* __restrict__ part, int n_splits,
                                  int n, float* __restrict__ de) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.0f;
  for (int s = 0; s < n_splits; ++s) sum += part[(size_t)s * n + i];
  de[i] = sum;
}

}  // namespace

extern "C" {

int flash_aam_bwd_block_rows() { return BM; }
int flash_aam_bwd_block_classes() { return BN; }
int flash_aam_bwd_max_dim() { return DMAX; }

// e (B, D) f32, w (C, D) f32, labels (B,) i32, lse (B,) f32, g (B,) f32, all
// contiguous on the card; part is scratch of n_splits * B * D floats with
// n_splits = ceil(ceil(C / BN) / tiles_per_split); de (B, D) and dw (C, D)
// f32 outputs.  Launches on `stream` and returns the cudaError_t of the
// launches (0 on success).
int flash_aam_bwd(const void* e, const void* w, const void* labels, const void* lse,
                  const void* g, int B, int C, int D, int tiles_per_split,
                  int n_splits, float s, float cos_m, float sin_m, float th, float mm,
                  void* part, void* de, void* dw, void* stream) {
  const int n_tiles = (C + BN - 1) / BN;
  if (B <= 0 || C <= 0 || D <= 0 || D > DMAX || tiles_per_split <= 0 ||
      n_splits != (n_tiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Margin mg{s, cos_m, sin_m, th, mm};
  const float* ef = static_cast<const float*>(e);
  const float* wf = static_cast<const float*>(w);
  const int* lab = static_cast<const int*>(labels);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  bwd_dw_kernel<<<n_tiles, NTHREADS, 0, st>>>(ef, wf, lab, lf, gf, B, C, D, mg,
                                              static_cast<float*>(dw));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + BM - 1) / BM, n_splits);
  bwd_de_partial_kernel<<<grid, NTHREADS, 0, st>>>(ef, wf, lab, lf, gf, B, C, D,
                                                   tiles_per_split, mg,
                                                   static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * D;
  bwd_de_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                     n_splits, n, static_cast<float*>(de));
  return (int)cudaGetLastError();
}

}  // extern "C"
