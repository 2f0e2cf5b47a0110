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
// with cos_c = (e . w_c) * (1 / sqrt(max(|w_c|^2, 1e-24))) and phi the
// ArcFace margin with the hard-margin guard.
//
// What bounds it: 2*B*C*D f32 operations against B*D + C*D f32 inputs.  At
// B=256, C=7325, D=256 that is 0.96 GFLOP (14 us at the H100's 67 TFLOP/s
// f32 CUDA-core peak) against 7.8 MB (2.3 us at 3.35 TB/s): compute-bound.
// The product must stay at f32 accuracy (cosines near +-1 feed the margin),
// so it runs on the tensor cores in 3xTF32 (mma_tf32x3.cuh): 6*B*C*D TF32
// operations, 5.8 us at 495 TFLOP/s.  As in the backward, the MMAs are not
// what sets the pace: the kernel is bound by issuing instructions, and its
// phases barely overlap.  About half the time is the cosine (splitting each
// staged operand into its TF32 parts); staging the W tiles (W passes from
// L2 once per batch tile), their norms and the epilogue take the rest, in
// roughly equal parts (see PERF.md).
//
// Design.  The TPU kernel walks the class tiles in order on one core with the
// whole batch resident in VMEM.  Here blocks run in parallel, so the grid is
// (32-row batch tiles) x (class splits), two blocks resident per SM.  A
// block keeps its e tile in shared memory and streams its split's 32-class
// W tiles, double-buffered with cp.async: tile t + 1 is in flight while tile
// t's cosines are formed.  The cosine tile is the backward's
// (flash_aam_cosine.cuh: tile_rnorms, cosine_dots) on the same tiles, so
// every cosine has the backward's bits and the lse handed to the backward is
// the log-sum-exp of the logits it recomputes.  The next tile's norms are
// taken after its copy lands, before the current tile's epilogue.  The
// epilogue works on each thread's 2 rows x 2 classes of its warp's 16x8
// cosine tile: the margin (flash_aam_common.cuh: margined) on the target,
// classes >= C skipped (W is never padded), and per row an online
// (max, sum-exp) that takes one expf per logit and rescales the sum only
// when the max moves.  zy is the target's z itself, and the max is taken
// over the same floats, so zy >= mx holds bit for bit when the target wins.
// At the end the 16 threads that share a row (4 lanes x 4 warps) merge
// their states in a fixed order, by shuffles and then through shared
// memory, and the block writes one partial state per (split, row).
// merge_kernel then merges the splits in a fixed order, without atomics, so
// two calls give the same bits.
//
// Depth.  For D <= DMAX (256), the rows are padded to padded_depth(D) in
// shared memory with zeros and the e tile stays resident.  Deeper rows take
// fwd_chunks_kernel: the same blocks and epilogue, with each class tile's
// cosines and norms streamed in 128-deep chunks of e and W through
// chunked_cosine (flash_aam_cosine.cuh), which the backward calls on the same
// tiles, so the bits still agree.  Rows of e and W whose length is a
// multiple of 4 are staged with 16-byte cp.async copies; other D take 4-byte
// copies (VEC = 1).

#include "flash_aam_cosine.cuh"

namespace {

using namespace flash_aam;

// The online state of one batch row over the classes seen so far.
struct RowState {
  float m, s, zy, cnt;
};

__device__ __forceinline__ void merge(RowState& a, const RowState& b) {
  const float mn = fmaxf(a.m, b.m);
  a.s = a.s * expf(a.m - mn) + b.s * expf(b.m - mn);
  a.m = mn;
  a.zy += b.zy;
  a.cnt += b.cnt;
}

__device__ __forceinline__ RowState shfl_xor(const RowState& a, int mask) {
  return {__shfl_xor_sync(FULL, a.m, mask), __shfl_xor_sync(FULL, a.s, mask),
          __shfl_xor_sync(FULL, a.zy, mask), __shfl_xor_sync(FULL, a.cnt, mask)};
}

// The labels, target logits and online states of the two batch rows whose
// logits this thread forms: rows row0 + 16 * (w % 4 / 2) + lane / 4 + 8 h
// of the tile, as cosine_dots lays out dot.  A row past B gets label -1 and
// its state is never written (write_states); a row inside B may carry any
// label: one outside [0, C) (a class-sharded head's shard-local label for a
// target on another shard) matches no column, so the row has no target term
// and counts every class against its zt.
struct Rows {
  int lab[2];
  float ztr[2];
  RowState st[2];
};

__device__ __forceinline__ Rows row_data(const int* __restrict__ labels,
                                         const float* __restrict__ zt, int B, int row0) {
  Rows rd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * ((threadIdx.x >> 5 & 3) >> 1) + ((threadIdx.x & 31) >> 2) + 8 * h;
    const bool ok = r < B;
    rd.lab[h] = ok ? labels[r] : -1;
    rd.ztr[h] = ok ? zt[r] : 0.0f;
    rd.st[h] = {NEG_INF, 0.0f, 0.0f, 0.0f};
  }
  return rd;
}

// Fold this thread's 2 rows x 2 classes of a class tile into its online
// states: c0 is the tile's first class plus this thread's first column,
// ri the 1 / ||w|| of its two classes.
__device__ __forceinline__ void fold_tile(Rows& rd, const float (&dot)[4], const float (&ri)[2],
                                          int c0, int C, const Margin& mg) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = c0 + q;
      if (c >= C) continue;
      RowState& st = rd.st[h];
      const bool is_tgt = c == rd.lab[h];
      const float z = margined(__fmul_rn(dot[2 * h + q], ri[q]), is_tgt, mg);
      if (is_tgt) st.zy += z;
      else if (z > rd.ztr[h]) st.cnt += 1.0f;
      if (z > st.m) {
        st.s = st.s * expf(st.m - z) + 1.0f;
        st.m = z;
      } else {
        st.s += expf(z - st.m);
      }
    }
}

// Merge the 16 states of each row of the block's tile, the 4 lanes of a
// warp that share it (shuffles) and then the 4 warps (through xch, in warp
// order), and write one partial state per (split, row).
__device__ __forceinline__ void write_states(Rows& rd, float* xch, int row0, int B, int split,
                                             float* __restrict__ part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // every warp is done with xch
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    merge(rd.st[h], shfl_xor(rd.st[h], 1));
    merge(rd.st[h], shfl_xor(rd.st[h], 2));
    if ((lane & 3) == 0) {
      float* o = xch + (warp * 16 + (lane >> 2) + 8 * h) * 4;
      o[0] = rd.st[h].m, o[1] = rd.st[h].s, o[2] = rd.st[h].zy, o[3] = rd.st[h].cnt;
    }
  }
  __syncthreads();
  if (threadIdx.x >= TB) return;
  const int r = threadIdx.x;
  const int grp = r >> 4;  // rows [16 grp, 16 grp + 16) are warps 2 grp, 2 grp + 1, + 4, + 5's
  RowState acc = {NEG_INF, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* o = xch + ((2 * grp + (k & 1) + 4 * (k >> 1)) * 16 + (r & 15)) * 4;
    merge(acc, {o[0], o[1], o[2], o[3]});
  }
  if (row0 + r >= B) return;
  const size_t plane = (size_t)gridDim.y * B;
  const size_t at = (size_t)split * B + row0 + r;
  part[at] = acc.m;
  part[plane + at] = acc.s;
  part[2 * plane + at] = acc.zy;
  part[3 * plane + at] = acc.cnt;
}

// D <= DMAX: one block per (batch tile blockIdx.x, class split blockIdx.y).
template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
fwd_tiles_kernel(const float* __restrict__ e, const float* __restrict__ w,
                 const int* __restrict__ labels, const float* __restrict__ zt, int B, int C,
                 int D, int DP, int tiles_per_split, Margin mg, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;                // [TB][DP]
  float* ws0 = es + TB * DP;       // [TC][DP], even class tiles of the split
  float* ws1 = ws0 + TC * DP;      // [TC][DP], odd ones
  float* rinv0 = ws1 + TC * DP;    // [TC], 1 / ||w|| of ws0's classes
  float* rinv1 = rinv0 + TC;       // [TC], of ws1's
  float* xch = rinv1 + TC;         // [WARPS][4][32]; at the end [WARPS][16][4] row states

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * TB;
  const int split = blockIdx.y;
  const int n_tiles = (C + TC - 1) / TC;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);

  tf32x3::stage_rows<VEC>(es, DP, e, D, row0, TB, B, D);
  tf32x3::stage_rows<VEC>(ws0, DP, w, D, tile_lo * TC, TC, C, D);
  tf32x3::commit();

  // this thread's classes cls0, cls0 + 1 of each tile (as cosine_dots lays
  // out dot)
  const int cls0 = 8 * cosine_ntile(warp) + 2 * (lane & 3);
  Rows rd = row_data(labels, zt, B, row0);
  tf32x3::wait_pending<0>();
  __syncthreads();
  tile_rnorms(ws0, DP, rinv0);

  for (int t = tile_lo; t < tile_hi; ++t) {
    const bool odd = (t - tile_lo) & 1;
    __syncthreads();  // tile t and its norms are ready, and every warp is done with t - 1
    if (t + 1 < tile_hi) {
      tf32x3::stage_rows<VEC>(odd ? ws0 : ws1, DP, w, D, (t + 1) * TC, TC, C, D);
      tf32x3::commit();
    }

    float dot[4];
    cosine_dots(dot, es, odd ? ws1 : ws0, DP, xch);
    const float* rinv = odd ? rinv1 : rinv0;
    const float ri[2] = {rinv[cls0], rinv[cls0 + 1]};
    // tile t + 1 has landed by now; its norms are taken into the other
    // buffer, which every warp finished reading before the barrier above
    tf32x3::wait_pending<0>();
    __syncthreads();
    if (t + 1 < tile_hi) tile_rnorms(odd ? ws0 : ws1, DP, odd ? rinv0 : rinv1);
    fold_tile(rd, dot, ri, t * TC + cls0, C, mg);
  }
  write_states(rd, xch, row0, B, split, part);
}

// D > DMAX: the same blocks, each class tile's cosines and norms streamed
// chunk by chunk through chunked_cosine (e's chunks too: a whole row of
// any depth does not fit), the rest as fwd_tiles_kernel.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
fwd_chunks_kernel(const float* __restrict__ e, const float* __restrict__ w,
                  const int* __restrict__ labels, const float* __restrict__ zt, int B, int C,
                  int D, int tiles_per_split, Margin mg, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* const eb[2] = {smem, smem + TB * KC};                    // [2][TB][KC]
  float* const wb[2] = {smem + 2 * TB * KC, smem + 2 * TB * KC + TC * KC};  // [2][TC][KC]
  float* rinv = wb[1] + TC * KC;                                  // [TC]
  float* xch = rinv + TC;                                         // [WARPS][4][32]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * TB;
  const int split = blockIdx.y;
  const int n_tiles = (C + TC - 1) / TC;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  const int cls0 = 8 * cosine_ntile(warp) + 2 * (lane & 3);
  Rows rd = row_data(labels, zt, B, row0);

  for (int t = tile_lo; t < tile_hi; ++t) {
    float dot[4];
    chunked_cosine<VEC, true>(dot, e, B, row0, w, C, t * TC, D, eb, wb, rinv, xch);
    __syncthreads();  // rinv
    const float ri[2] = {rinv[cls0], rinv[cls0 + 1]};
    fold_tile(rd, dot, ri, t * TC + cls0, C, mg);
  }
  write_states(rd, xch, row0, B, split, part);
}

// Merge the per-split states of each row, one warp a row: lane l takes the
// splits l, l + 32, ... in order, then a fixed butterfly joins the lanes:
// mx = M = max_i m_i, lse = M + log(sum_i s_i exp(m_i - M)), zy = sum zy_i
// (one split holds the target, the others add 0), cnt = sum cnt_i.
__global__ void merge_kernel(const float* __restrict__ part, int n_splits, int B,
                             float* __restrict__ lse, float* __restrict__ zy,
                             float* __restrict__ mx, float* __restrict__ cnt) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= B) return;  // the whole warp
  const size_t plane = (size_t)n_splits * B;
  float M = NEG_INF;
  for (int i = lane; i < n_splits; i += 32) M = fmaxf(M, part[(size_t)i * B + r]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
  float S = 0.0f, Z = 0.0f, K = 0.0f;
  for (int i = lane; i < n_splits; i += 32) {
    const size_t at = (size_t)i * B + r;
    S += part[plane + at] * expf(part[at] - M);
    Z += part[2 * plane + at];
    K += part[3 * plane + at];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    S += __shfl_xor_sync(FULL, S, o);
    Z += __shfl_xor_sync(FULL, Z, o);
    K += __shfl_xor_sync(FULL, K, o);
  }
  if (lane) return;
  lse[r] = M + logf(S);
  zy[r] = Z;
  mx[r] = M;
  cnt[r] = K;
}

template <int VEC>
cudaError_t launch(const float* e, const float* w, const int* labels, const float* zt, int B,
                   int C, int D, int tiles_per_split, int n_splits, const Margin& mg,
                   float* part, float* lse, float* zy, float* mx, float* cnt,
                   cudaStream_t st) {
  static_assert(WARPS * 128 >= WARPS * 16 * 4, "xch holds the warps' row states");
  const dim3 grid((B + TB - 1) / TB, n_splits);
  cudaError_t err;
  if (D <= DMAX) {
    const int DP = padded_depth(D);
    const size_t smem = sizeof(float) * (TB * DP + 2 * TC * DP + 2 * TC + WARPS * 128);
    err = cudaFuncSetAttribute(fwd_tiles_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    fwd_tiles_kernel<VEC><<<grid, THREADS, smem, st>>>(e, w, labels, zt, B, C, D, DP,
                                                       tiles_per_split, mg, part);
  } else {
    const size_t smem = sizeof(float) * (2 * (TB + TC) * KC + TC + WARPS * 128);
    err = cudaFuncSetAttribute(fwd_chunks_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    fwd_chunks_kernel<VEC><<<grid, THREADS, smem, st>>>(e, w, labels, zt, B, C, D,
                                                        tiles_per_split, mg, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<(B + 7) / 8, 256, 0, st>>>(part, n_splits, B, lse, zy, mx, cnt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_aam_fwd_block_rows() { return TB; }
int flash_aam_fwd_block_classes() { return TC; }

// e (B, D) f32, w (C, D) f32, labels (B,) i32, zt (B,) f32, all contiguous on
// the card; part is scratch of 4 * n_splits * B floats with
// n_splits = ceil(ceil(C / TC) / tiles_per_split).  Launches on `stream` and
// returns the cudaError_t of the launches (0 on success).
int flash_aam_fwd(const void* e, const void* w, const void* labels, const void* zt,
                  int B, int C, int D, int tiles_per_split, int n_splits,
                  float s, float cos_m, float sin_m, float th, float mm,
                  void* part, void* lse, void* zy, void* mx, void* cnt,
                  void* stream) {
  const int n_tiles = (C + TC - 1) / TC;
  if (B <= 0 || C <= 0 || D <= 0 || tiles_per_split <= 0 ||
      n_splits != (n_tiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  const Margin mg{s, cos_m, sin_m, th, mm};
  const float* ef = static_cast<const float*>(e);
  const float* wf = static_cast<const float*>(w);
  const int* lab = static_cast<const int*>(labels);
  const float* ztf = static_cast<const float*>(zt);
  float* pf = static_cast<float*>(part);
  float* out[4] = {static_cast<float*>(lse), static_cast<float*>(zy), static_cast<float*>(mx),
                   static_cast<float*>(cnt)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row to start on a 16-byte boundary
  const bool aligned = D % 4 == 0 && reinterpret_cast<uintptr_t>(e) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaError_t err =
      aligned ? launch<4>(ef, wf, lab, ztf, B, C, D, tiles_per_split, n_splits, mg, pf,
                          out[0], out[1], out[2], out[3], st)
              : launch<1>(ef, wf, lab, ztf, B, C, D, tiles_per_split, n_splits, mg, pf,
                          out[0], out[1], out[2], out[3], st);
  return (int)err;
}

}  // extern "C"
