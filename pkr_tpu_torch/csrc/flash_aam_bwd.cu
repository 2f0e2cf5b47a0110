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
// which the dense head's autograd passes no gradient).  The margin and the
// clip are the forward's code (flash_aam_common.cuh: margined).
//
// What bounds it: the minimal work is 6*B*C*D f32 operations (the cosine
// product, then a . w_hat and a^T . e) against (B + C) * D f32 inputs and
// outputs.  At B=256, C=7325, D=256 that is 2.9 GFLOP against 15 MB (4.6 us
// at 3.35 TB/s): compute-bound.  On the f32 CUDA cores (67 TFLOP/s) that is
// 43 us.  This kernel runs the products on the tensor cores in 3xTF32
// (mma_tf32x3.cuh), three TF32 products per f32 product, so its floor is
// 18*B*C*D operations at 495 TFLOP/s: 17.5 us at that shape.  bf16 or a
// single TF32 product is not accurate enough: cosines near +-1 feed the
// margin, and p = exp(s*z - lse) turns a cosine error into s times it.
// On the card the MMAs are not what sets the pace: splitting each operand
// into TF32 parts (five instructions a value), the epilogue and the waits
// between phases take most of the time (see PERF.md).
//
// Design.  The TPU kernel walks the class tiles in order on one core and
// carries de in VMEM across its grid.  Here blocks run in parallel and
// nothing carries over, and the two reductions run different ways: dw reduces
// over the batch, de over the classes.  So there are two passes, neither with
// float atomics, both deterministic (two calls give the same bits), run by
// one launch:
//   the dW pass: one block per 32-class tile (229 at C=7325) keeps its W
//     tile in shared memory, loops over the 32-row batch tiles (the next
//     one's cp.async copy in flight while the current one's MMAs run),
//     recomputes each 32x32 tile of a into shared memory and accumulates
//     dw_hat (32 x D) in registers; it owns whole rows, so it applies the
//     row projection and writes dW once;
//   the de pass: one block per (32-row batch tile, class split) keeps its
//     e tile, streams its split's W tiles (double-buffered the same way) and
//     accumulates a (32 x D) de partial; bwd_de_sum_kernel then adds the
//     splits' partials in split order.
// Each pass recomputes the cosine tiles, so they issue 8*B*C*D f32-product
// operations (24*B*C*D in TF32) against the minimal 6*B*C*D.  In both, each
// warp computes a 16x16 quadrant of a 32x32 cosine tile over half the
// depth, and the two halves are summed through shared memory, the pair of
// warps meeting at a barrier of their own (cosine_dots); then each warp
// computes 32-column slabs of the second product.  The de pass takes the
// norms of the next W tile while the second product runs, so no
// block-wide barrier sits inside the cosine.  1/||w|| is computed once per
// W row of a staged tile (the sum of squares in f32 on the CUDA cores,
// ||w|| = sqrt(max(sum w^2, 1e-24)), its reciprocal rounded once); the
// cosine is (e . w) * (1/||w||), de folds 1/||w|| into a (a * (1/||w||))
// instead of scaling every staged W element, and the a tile is split into
// its TF32 parts once, where it is formed, not by every warp that reads it.
//
// Four routes by depth, one launch each (launch):
//   D <= DMAX (256): bwd_tiles_kernel (dw_block, de_block).  Rows padded
//     to padded_depth(D) with zeros; three tiles fit twice in an SM's shared
//     memory, so two blocks run on each SM and one block's barriers overlap
//     the other's MMAs.  Warp w owns the output columns [32 w, 32 w + 32).
//   DMAX < D <= WMAX (512): bwd_wide_kernel (dw_wide_block, de_wide_block).
//     Three full-depth tiles (each n_chunks(D) resident 128-deep chunks,
//     up to 64 KB) fill one SM, so one block of 8 warps runs on each.  What
//     bounds it is that one block: its phases (cosine, a tile, second
//     product) meet at block-wide barriers, and no second block fills them.
//     So the design takes out the work that the chunked route repeats:
//     every tile is staged once and every cosine tile formed once (the dW
//     block stages its W tile and takes its norms once, then double-buffers
//     e's batch tiles at full depth; the de block stages its e tile once and
//     double-buffers its split's W tiles).  The cosine reads the resident
//     chunks (resident_cosine, the chunk order's bits), the second product
//     reads the tile that the cosine just read, so no copy waits behind the
//     MMAs, and the output depth is padded to 32 columns: warp w owns the
//     slabs [32 w, 32 w + 32) and [256 + 32 w, 256 + 32 w + 32), as far as
//     D reaches, in 64 accumulators a thread.  Two other layouts were
//     tried on an H100 and left out, both spilling without a clear gain:
//     16 warps of one slab each (128 registers a thread), and a cosine
//     that exchanges all its chunks at one barrier (255); see PERF.md.
//   WMAX < D <= CMAX (4096): bwd_cluster_kernel (dw_cluster_block,
//     de_cluster_block).  Three full-depth tiles no longer fit one block,
//     nor a 32 x D accumulator its registers, so a thread-block cluster of
//     n_s = n_slices(D) blocks (2 to 16: up to 8, the portable size, to
//     CPORT = 2048; 9 to 16, Hopper's non-portable sizes, which the kernel
//     is allowed before its launch, allow_cluster) splits the depth into
//     SW = 256-wide slices: each block is a tiles-route block of depth 256
//     on its slice (the stationary tile resident, the streamed ones through
//     one buffer, a 32 x 256 accumulator, warp w on the slice's depths
//     [32 w, 32 w + 32)).  Only the cosine needs the whole depth: each
//     block forms its two chunks' cosine_dots (and tile_sq for the norms)
//     and publishes them unsummed in its shared memory; after a cluster
//     barrier every block adds all n_chunks(D) partials, read through
//     distributed shared memory, in chunk order (flash_aam_cosine.cuh: the
//     chunk order), so every block forms the same a tile with the forward's
//     bits.
//     That exchange reads 2 n_s float4 a thread a tile: past the portable
//     size it sets the pace (a layout that kept it lost to the library at
//     D = 2304 on an H100; see PERF.md), so there (SHARE) each block forms
//     the a values of its 1/n_s share of the tile only and, after a second
//     cluster barrier, reads the whole a tile back ("a tile step's
//     exchange" below): the same a tile, the same bits.  Each pass forms
//     each cosine tile once (8*B*C*D over both passes).  The exchange
//     buffers alternate between tiles, so one barrier a tile suffices: a
//     block rewrites a buffer only past the barrier that its peers reach
//     after reading it.  dW's projection is each slice's sum added over the
//     slices in slice order, exchanged the same way, and every block ends
//     at a cluster barrier, so no block leaves while a peer reads its
//     shared memory.  What bounds it is the waits of each block (the
//     cluster barrier, the reads of the peers' partials, the copies): so
//     the streamed tiles take one buffer, not two, which brings a block to
//     94 KB and puts two blocks on each SM, one running while the other
//     waits (a layout with two buffers at one block an SM was slower on an
//     H100 at every shape timed; see PERF.md).  A cluster of 16 then takes
//     8 SMs of one GPC.  The de pass's splits are sized by the clusters
//     that the card holds at once (flash_aam_bwd_clusters), and its
//     clusters come first in the grid.
//   D > CMAX: bwd_passes_kernel (dw_passes_block, de_passes_block), after
//     bwd_norms_kernel.  A cluster of a block a slice would exceed Hopper's
//     largest (16), so a cluster of n_c = passes_cluster(D) blocks (9 to
//     16) walks the depth in P = n_passes(D) passes of one slice a block,
//     each block carrying the running chunk-order sum of its share of the
//     tile's cosines from pass to pass (flash_aam_cosine.cuh: the depth in
//     passes).  Each block takes half a tile (16 batch rows or classes)
//     across two slices, the 32 accumulators a thread of the other routes,
//     so a pass forms each cosine tile once up to D = 8192 (P = 2), where
//     a block on one 256-wide output chunk at a time would form it
//     ceil(D / 256) times.  Two blocks an SM.
//
// Numerics against the forward.  The cosine tile (tile_rnorms, cosine_dots)
// is flash_aam_cosine.cuh's, which the forward kernel calls on the same
// tiles, so every cosine here has the forward's bits and p = exp(z - lse)
// is the softmax of the very logits whose log-sum-exp the forward returned.
// That matters at the sin clip (cos -> 1), where phi' grows as
// sin_m * cos / sin and one ulp of cosine would move p by up to ~1e-3.  A
// saturated cosine is exact: 1.0 and 2.0 split into TF32 with no
// remainder, and 1/||w|| = 0.5.  Above DMAX both kernels form the chunk
// order's bits (flash_aam_cosine.cuh; the passes route through half_dots,
// cosine_dots' instructions for each cosine).
// Rows of e and W whose length is a multiple of 4 are staged with 16-byte
// cp.async copies; other D take 4-byte copies (VEC = 1).

#include "flash_aam_cosine.cuh"

namespace {

using namespace flash_aam;
using tf32x3::K_ROWS;
using tf32x3::MK_ROWS;
using tf32x3::at;

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

// Validity, label, lse and g of the two batch rows whose logits this thread
// forms (rows row0 + 16 * (w % 4 / 2) + lane / 4 + {0, 8}).  A row is valid
// iff it lies inside the batch (r < B); its label may lie anywhere.  A
// class-sharded head passes shard-local labels, y - shard * C, which lie
// outside [0, C) on every shard but the target's: such a row has no target
// column here and keeps its whole non-target gradient, as the TPU kernel
// (which masks by column only) gives it.
struct Rows {
  bool ok[2];
  int lab[2];
  float lse[2], g[2];
};

__device__ __forceinline__ Rows row_data(const int* __restrict__ labels,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ g, int B, int row0) {
  Rows rd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * ((threadIdx.x >> 5 & 3) >> 1) + ((threadIdx.x & 31) >> 2) + 8 * h;
    const bool ok = r < B;
    rd.ok[h] = ok;
    rd.lab[h] = ok ? labels[r] : 0;
    rd.lse[h] = ok ? lse[r] : 0.0f;
    rd.g[h] = ok ? g[r] : 0.0f;
  }
  return rd;
}

// The 32x32 tile of a for the rows of rd and classes col0.. from this
// warp's 16x8 cosine tile (cosine_dots), cos = dot * (1 / ||w||), split into
// TF32 big and small parts in the swizzled at_big[row][class] and
// at_small[row][class] (0 outside B and C); SCALE folds 1/||w|| into a.
// The caller syncs before reading them.
template <bool SCALE>
__device__ __forceinline__ void a_tile(const float (&dot)[4], const float* rinv,
                                       const Rows& rd, int C, int col0, const Margin& mg,
                                       float* at_big, float* at_small) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * ((warp & 3) >> 1) + (lane >> 2) + 8 * h;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int cls = 8 * cosine_ntile(warp) + 2 * (lane & 3) + q;
      const int c = col0 + cls;
      float a = 0.0f;
      if (rd.ok[h] && c < C) {
        const float ri = rinv[cls];
        a = dlogit(__fmul_rn(dot[2 * h + q], ri), c == rd.lab[h], rd.lse[h], rd.g[h], mg);
        if (SCALE) a = __fmul_rn(a, ri);
      }
      const tf32x3::Split sp = tf32x3::split(a);
      at_big[at(row, cls, TC)] = __uint_as_float(sp.big);
      at_small[at(row, cls, TC)] = __uint_as_float(sp.small);
    }
  }
}

// The dW pass, one block per TC-class tile: dw_hat = a^T e over every batch
// tile, then dW = (dw_hat - (dw_hat . w_hat) w_hat) / ||w||.  Warp w
// accumulates the classes x depths [32 w, 32 w + 32) of dw_hat.
template <int VEC>
__device__ __forceinline__ void dw_block(float* smem, int tile, const float* __restrict__ e,
                                         const float* __restrict__ w,
                                         const int* __restrict__ labels,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ g, int B, int C, int D,
                                         int DP, const Margin& mg, float* __restrict__ dw) {
  float* ws = smem;                    // [TC][DP]
  float* es0 = ws + TC * DP;           // [TB][DP], even batch tiles
  float* es1 = es0 + TB * DP;          // [TB][DP], odd batch tiles
  float* at_big = es1 + TB * DP;       // [TB][TC]
  float* at_small = at_big + TB * TC;  // [TB][TC]
  float* rinv = at_small + TB * TC;    // [TC]
  float* projp = rinv + TC;            // [WARPS][TC]
  float* xch = projp + WARPS * TC;     // [WARPS][4][32]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = tile * TC;
  const int n_bt = (B + TB - 1) / TB;
  const bool has_cols = 32 * warp < DP;

  tf32x3::stage_rows<VEC>(ws, DP, w, D, col0, TC, C, D);
  tf32x3::stage_rows<VEC>(es0, DP, e, D, 0, TB, B, D);
  tf32x3::commit();
  tf32x3::wait_pending<0>();
  __syncthreads();
  tile_rnorms(ws, DP, rinv);

  float acc[2][4][4] = {};
  for (int bt = 0; bt < n_bt; ++bt) {
    const float* ecur = (bt & 1) ? es1 : es0;
    tf32x3::wait_pending<0>();
    __syncthreads();  // tile bt has landed, and every warp is done with tile bt - 1
    if (bt + 1 < n_bt) {
      tf32x3::stage_rows<VEC>((bt & 1) ? es0 : es1, DP, e, D, (bt + 1) * TB, TB, B, D);
      tf32x3::commit();
    }
    const Rows rd = row_data(labels, lse, g, B, bt * TB);

    float dot[4];
    cosine_dots(dot, ecur, ws, DP, xch);
    a_tile<false>(dot, rinv, rd, C, col0, mg, at_big, at_small);
    __syncthreads();
    if (has_cols)
      tf32x3::warp_mma_k32<K_ROWS>(acc, at_big, at_small, ecur, DP, 32 * warp);
  }

  // acc[i][j][q] holds class 16 i + lane / 4 + 8 (q / 2) at depth
  // 32 warp + 8 j + 2 (lane % 4) + q % 2
  float what[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cls = 16 * i + (lane >> 2) + 8 * h;
      float proj = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int d = 32 * warp + 8 * j + 2 * (lane & 3) + q;
          const float v = has_cols ? __fmul_rn(ws[at(cls, d, DP)], rinv[cls]) : 0.0f;
          what[i][j][2 * h + q] = v;
          proj = fmaf(acc[i][j][2 * h + q], v, proj);
        }
      // the 4 lanes of a class are neighbours in the warp
      proj += __shfl_xor_sync(FULL, proj, 1);
      proj += __shfl_xor_sync(FULL, proj, 2);
      if ((lane & 3) == 0) projp[warp * TC + cls] = proj;
    }
  __syncthreads();
  if (!has_cols) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cls = 16 * i + (lane >> 2) + 8 * h;
      const int c = col0 + cls;
      if (c >= C) continue;
      float proj = 0.0f;
      for (int k = 0; k < WARPS; ++k) proj += projp[k * TC + cls];
      const float ri = rinv[cls];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int d = 32 * warp + 8 * j + 2 * (lane & 3) + q;
          const int idx = 2 * h + q;
          if (d < D)
            dw[(size_t)c * D + d] =
                __fmul_rn(__fsub_rn(acc[i][j][idx], __fmul_rn(proj, what[i][j][idx])), ri);
        }
    }
}

// The de pass, one block per (batch tile, class split): part[split] =
// a[rows, split] w_hat.  Warp w accumulates the rows x depths
// [32 w, 32 w + 32) of the partial.
template <int VEC>
__device__ __forceinline__ void de_block(float* smem, int row_tile, int split,
                                         const float* __restrict__ e,
                                         const float* __restrict__ w,
                                         const int* __restrict__ labels,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ g, int B, int C, int D,
                                         int DP, int tiles_per_split, const Margin& mg,
                                         float* __restrict__ part) {
  float* es = smem;                    // [TB][DP]
  float* ws0 = es + TB * DP;           // [TC][DP], even class tiles of the split
  float* ws1 = ws0 + TC * DP;          // [TC][DP], odd ones
  float* at_big = ws1 + TC * DP;       // [TB][TC]
  float* at_small = at_big + TB * TC;  // [TB][TC]
  float* rinv0 = at_small + TB * TC;   // [TC], 1 / ||w|| of ws0's classes
  float* rinv1 = rinv0 + TC;           // [TC], of ws1's
  float* xch = rinv1 + TC;             // [WARPS][4][32]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = row_tile * TB;
  const int n_tiles = (C + TC - 1) / TC;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  const bool has_cols = 32 * warp < DP;

  tf32x3::stage_rows<VEC>(es, DP, e, D, row0, TB, B, D);
  tf32x3::stage_rows<VEC>(ws0, DP, w, D, tile_lo * TC, TC, C, D);
  tf32x3::commit();

  const Rows rd = row_data(labels, lse, g, B, row0);
  tf32x3::wait_pending<0>();
  __syncthreads();
  tile_rnorms(ws0, DP, rinv0);

  float acc[2][4][4] = {};
  for (int t = tile_lo; t < tile_hi; ++t) {
    const bool odd = (t - tile_lo) & 1;
    const float* wcur = odd ? ws1 : ws0;
    __syncthreads();  // tile t and its norms are ready, and every warp is done with t - 1
    if (t + 1 < tile_hi) {
      tf32x3::stage_rows<VEC>(odd ? ws0 : ws1, DP, w, D, (t + 1) * TC, TC, C, D);
      tf32x3::commit();
    }

    float dot[4];
    cosine_dots(dot, es, wcur, DP, xch);
    a_tile<true>(dot, odd ? rinv1 : rinv0, rd, C, t * TC, mg, at_big, at_small);
    // tile t + 1 lands while the second product runs; its norms are taken
    // now, into the other buffer, so that the cosine never waits on them
    tf32x3::wait_pending<0>();
    __syncthreads();
    if (t + 1 < tile_hi) tile_rnorms(odd ? ws0 : ws1, DP, odd ? rinv0 : rinv1);
    if (has_cols)
      tf32x3::warp_mma_k32<MK_ROWS>(acc, at_big, at_small, wcur, DP, 32 * warp);
  }

  if (!has_cols) return;
  float* out = part + (size_t)split * B * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * i + (lane >> 2) + 8 * h;
      if (r >= B) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int d = 32 * warp + 8 * j + 2 * (lane & 3) + q;
          if (d < D) out[(size_t)r * D + d] = acc[i][j][2 * h + q];
        }
    }
}

// DMAX < D <= WMAX.  Every tile is resident at full depth as n_chunks(D)
// chunks of KC (stage_chunks), and warp w owns the SLABS slabs w and
// w + WARPS of 32 output columns each, those that start below D: slab s
// covers the depths [32 s, 32 s + 32), columns 32 (s % 4) .. of chunk s / 4.
constexpr int SLABS = WMAX / (32 * WARPS);

static_assert(KC == 4 * 32, "slab s lies in chunk s / 4");

// The second product's operand for slab `slab` of a resident tile.
__device__ __forceinline__ const float* slab_chunk(const float* tile, int slab) {
  return tile + (slab >> 2) * TB * KC;
}

// The floats of one resident tile, and the dW pass's shared memory (the de
// pass takes less: no projection scratch, a second norm buffer).
__host__ __device__ inline int wide_tile(int D) { return n_chunks(D) * TB * KC; }

__host__ __device__ inline int wide_smem_floats(int D) {
  return 3 * wide_tile(D) + 2 * TB * TC + TC + WARPS * TC + 2 * WARPS * 128;
}

// The dW pass for DMAX < D <= WMAX, one block per TC-class tile: dw_hat =
// a^T e over every batch tile, then dW = (dw_hat - (dw_hat . w_hat) w_hat)
// / ||w||, the projection summed by each thread over its slabs in order,
// then over the lanes of a class and over the warps in order.
template <int VEC>
__device__ __forceinline__ void dw_wide_block(float* smem, int tile, const float* __restrict__ e,
                                              const float* __restrict__ w,
                                              const int* __restrict__ labels,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ g, int B, int C, int D,
                                              const Margin& mg, float* __restrict__ dw) {
  const int T = wide_tile(D);
  float* ws = smem;                            // W tile, [n_ch][TC][KC]
  float* const eb[2] = {ws + T, ws + 2 * T};   // e's batch tiles, even and odd
  float* at_big = ws + 3 * T;                  // [TB][TC]
  float* at_small = at_big + TB * TC;          // [TB][TC]
  float* rinv = at_small + TB * TC;            // [TC]
  float* projp = rinv + TC;                    // [WARPS][TC]
  float* xch = projp + WARPS * TC;             // [2][WARPS][4][32]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = tile * TC;
  const int n_bt = (B + TB - 1) / TB;
  const int n_ch = n_chunks(D);

  stage_chunks<VEC>(ws, w, col0, C, D);
  stage_chunks<VEC>(eb[0], e, 0, B, D);
  tf32x3::commit();
  tf32x3::wait_pending<0>();
  __syncthreads();
  resident_rnorms(ws, n_ch, rinv);

  float acc[SLABS][2][4][4] = {};
  for (int bt = 0; bt < n_bt; ++bt) {
    const float* ecur = eb[bt & 1];
    tf32x3::wait_pending<0>();
    __syncthreads();  // tile bt has landed, and every warp is done with tile bt - 1
    if (bt + 1 < n_bt) {
      stage_chunks<VEC>(eb[(bt + 1) & 1], e, (bt + 1) * TB, B, D);
      tf32x3::commit();
    }
    const Rows rd = row_data(labels, lse, g, B, bt * TB);

    float dot[4];
    resident_cosine(dot, ecur, ws, n_ch, xch);
    a_tile<false>(dot, rinv, rd, C, col0, mg, at_big, at_small);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SLABS; ++i) {
      const int slab = warp + WARPS * i;
      if (32 * slab < D)
        tf32x3::warp_mma_k32<K_ROWS>(acc[i], at_big, at_small, slab_chunk(ecur, slab), KC,
                                     32 * (slab & 3));
    }
  }

  // acc[i][m][j][q] holds class 16 m + lane / 4 + 8 (q / 2) at depth
  // 32 (warp + WARPS i) + 8 j + 2 (lane % 4) + q % 2; w_hat is read back
  // from the resident W tile
  auto w_hat = [&](int cls, int slab, int j, int q) {
    const int dl = 32 * (slab & 3) + 8 * j + 2 * (lane & 3) + q;
    return __fmul_rn(slab_chunk(ws, slab)[at(cls, dl, KC)], rinv[cls]);
  };
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cls = 16 * m + (lane >> 2) + 8 * h;
      float proj = 0.0f;
#pragma unroll
      for (int i = 0; i < SLABS; ++i) {
        const int slab = warp + WARPS * i;
        if (32 * slab >= D) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            proj = fmaf(acc[i][m][j][2 * h + q], w_hat(cls, slab, j, q), proj);
      }
      // the 4 lanes of a class are neighbours in the warp
      proj += __shfl_xor_sync(FULL, proj, 1);
      proj += __shfl_xor_sync(FULL, proj, 2);
      if ((lane & 3) == 0) projp[warp * TC + cls] = proj;
    }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cls = 16 * m + (lane >> 2) + 8 * h;
      const int c = col0 + cls;
      if (c >= C) continue;
      float proj = 0.0f;
      for (int k = 0; k < WARPS; ++k) proj += projp[k * TC + cls];
      const float ri = rinv[cls];
#pragma unroll
      for (int i = 0; i < SLABS; ++i) {
        const int slab = warp + WARPS * i;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int d = 32 * slab + 8 * j + 2 * (lane & 3) + q;
            if (d < D)
              dw[(size_t)c * D + d] = __fmul_rn(
                  __fsub_rn(acc[i][m][j][2 * h + q], __fmul_rn(proj, w_hat(cls, slab, j, q))),
                  ri);
          }
      }
    }
}

// The de pass for DMAX < D <= WMAX, one block per (batch tile, class
// split): part[split] = a[rows, split] w_hat.
template <int VEC>
__device__ __forceinline__ void de_wide_block(float* smem, int row_tile, int split,
                                              const float* __restrict__ e,
                                              const float* __restrict__ w,
                                              const int* __restrict__ labels,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ g, int B, int C, int D,
                                              int tiles_per_split, const Margin& mg,
                                              float* __restrict__ part) {
  const int T = wide_tile(D);
  float* es = smem;                            // e tile, [n_ch][TB][KC]
  float* const wb[2] = {es + T, es + 2 * T};   // the split's W tiles, even and odd
  float* at_big = es + 3 * T;                  // [TB][TC]
  float* at_small = at_big + TB * TC;          // [TB][TC]
  float* const rinv[2] = {at_small + TB * TC, at_small + TB * TC + TC};  // [TC] each
  float* xch = rinv[1] + TC;                   // [2][WARPS][4][32]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = row_tile * TB;
  const int n_tiles = (C + TC - 1) / TC;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  const int n_ch = n_chunks(D);

  stage_chunks<VEC>(es, e, row0, B, D);
  stage_chunks<VEC>(wb[0], w, tile_lo * TC, C, D);
  tf32x3::commit();

  const Rows rd = row_data(labels, lse, g, B, row0);
  tf32x3::wait_pending<0>();
  __syncthreads();
  resident_rnorms(wb[0], n_ch, rinv[0]);

  float acc[SLABS][2][4][4] = {};
  for (int t = tile_lo; t < tile_hi; ++t) {
    const int cur = (t - tile_lo) & 1;
    __syncthreads();  // tile t and its norms are ready, and every warp is done with t - 1
    if (t + 1 < tile_hi) {
      stage_chunks<VEC>(wb[cur ^ 1], w, (t + 1) * TC, C, D);
      tf32x3::commit();
    }

    float dot[4];
    resident_cosine(dot, es, wb[cur], n_ch, xch);
    a_tile<true>(dot, rinv[cur], rd, C, t * TC, mg, at_big, at_small);
    // tile t + 1 lands while the second product runs; its norms are taken
    // now, into the other buffer, so that the cosine never waits on them
    tf32x3::wait_pending<0>();
    __syncthreads();
    if (t + 1 < tile_hi) resident_rnorms(wb[cur ^ 1], n_ch, rinv[cur ^ 1]);
#pragma unroll
    for (int i = 0; i < SLABS; ++i) {
      const int slab = warp + WARPS * i;
      if (32 * slab < D)
        tf32x3::warp_mma_k32<MK_ROWS>(acc[i], at_big, at_small, slab_chunk(wb[cur], slab), KC,
                                      32 * (slab & 3));
    }
  }

  float* out = part + (size_t)split * B * D;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * m + (lane >> 2) + 8 * h;
      if (r >= B) continue;
#pragma unroll
      for (int i = 0; i < SLABS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int d = 32 * (warp + WARPS * i) + 8 * j + 2 * (lane & 3) + q;
            if (d < D) out[(size_t)r * D + d] = acc[i][m][j][2 * h + q];
          }
    }
}

// WMAX < D <= CMAX: a cluster of n_slices(D) blocks per unit of work, block
// `slice` (its rank in the cluster) holding the depths [SW slice, SW slice
// + SW) of every tile (stage_slice) and warp w the 32 of them from 32 w on.
// Both passes share one layout (the de pass leaves the projection scratch
// unused): two slice tiles (the stationary one and one buffer for the
// streamed tiles), the a tile's parts, rinv, projection scratch, two cosine
// exchange buffers, and what the block publishes to its peers: two buffers
// of two chunks' partials (past CPORT, one of them and its share of the a
// tile), two of two chunks' sums of squares, and its slice's share of the
// projection.  96,096 bytes: two blocks an SM.
__host__ __device__ inline int cluster_smem_floats() {
  return 2 * 2 * TB * KC + 2 * TB * TC + TC + WARPS * TC + 2 * WARPS * 128 +
         2 * 2 * THREADS * 4 + 2 * 2 * TC + TC;
}

// Past CPORT (SHARE), a tile step exchanges shares (flash_aam_cosine.cuh:
// logit_share).  Each block publishes its two chunks' cosine partials
// (slice_partials); past cluster barrier A, each forms the a value of its
// share's slots only (cluster_logit_dot, then dlogit) and publishes it
// split into its TF32 parts (publish_a_share); past barrier B, each reads
// the whole a tile back (gather_a_tile) for its slice's second product.  A
// block so reads TB TC (n_ch / n_s + 2) floats of its peers a tile, not
// the TB TC n_ch of forming the whole tile itself, for a second barrier.
// One buffer of partials suffices: a block rewrites it only past the B
// barrier, which its peers reach after reading it; and its a share only
// past the next A barrier, which they reach after reading that.  Its
// blocks hold their 32 x 256 accumulators through the exchange, in the 128
// registers of two blocks an SM, so they keep XB_BWD reads in flight, not
// XB, and load the row data after the dots.
constexpr int XB_BWD = XB / 2;
//
// The batch row (rows row0 + slot_row) of the thread's slot of share sh:
// validity (a slot of the share, in B), label, lse and g.
struct ShareRow {
  bool ok;
  int lab;
  float lse, g;
};

__device__ __forceinline__ ShareRow share_row(const Share& sh, const int* __restrict__ labels,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ g, int B, int row0) {
  const int s = share_slot(sh);
  const int r = row0 + slot_row(s % (TB * TC));
  const bool ok = s < sh.i1 && r < B;
  return {ok, ok ? labels[r] : 0, ok ? lse[r] : 0.0f, ok ? g[r] : 0.0f};
}

// a of the thread's slot of share sh (class col0 + slot_col) from its dot
// and rinv, as a_tile forms it (0 outside B and C; SCALE folds 1/||w||
// in), published as its TF32 parts: big at apub[s - i0], small at
// apub[SHARE_MAX + s - i0].
template <bool SCALE>
__device__ __forceinline__ void publish_a_share(float dot, const Share& sh, const ShareRow& sr,
                                                const float* rinv, int C, int col0,
                                                const Margin& mg, float* apub) {
  const int s = share_slot(sh);
  if (s >= sh.i1) return;
  const int cls = slot_col(s);
  const int c = col0 + cls;
  float a = 0.0f;
  if (sr.ok && c < C) {
    const float ri = rinv[cls];
    a = dlogit(__fmul_rn(dot, ri), c == sr.lab, sr.lse, sr.g, mg);
    if (SCALE) a = __fmul_rn(a, ri);
  }
  const tf32x3::Split sp = tf32x3::split(a);
  apub[s - sh.i0] = __uint_as_float(sp.big);
  apub[SHARE_MAX + s - sh.i0] = __uint_as_float(sp.small);
}

// The whole a tile from the shares the cluster published (publish_a_share;
// slot s in block s / L's share), into the swizzled at_big[row][class] and
// at_small[row][class], half of a thread's slots at a time (XB_BWD reads in
// flight).  The caller syncs before reading them.
__device__ __forceinline__ void gather_a_tile(const float* apub, int n_s, float* at_big,
                                              float* at_small) {
  constexpr int M = TB * TC / THREADS / 2;
  const int L = (TB * TC + n_s - 1) / n_s;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float big[M], small[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int s = (int)threadIdx.x + THREADS * (2 * m + half);
      const int r = s / L;
      big[m] = cluster_ld(apub + (s - r * L), r);
      small[m] = cluster_ld(apub + SHARE_MAX + (s - r * L), r);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int s = (int)threadIdx.x + THREADS * (2 * m + half);
      at_big[at(slot_row(s), slot_col(s), TC)] = big[m];
      at_small[at(slot_row(s), slot_col(s), TC)] = small[m];
    }
  }
}

// The dW pass for WMAX < D <= CMAX, one cluster per TC-class tile.  Each
// block keeps its slice of the W tile, streams e's batch tiles at its
// slice through one buffer (the next tile's copy starts once every warp is
// done with the current one; the SM's other block runs meanwhile), and
// accumulates dw_hat over its slice in registers; for each batch tile the
// cluster exchanges the chunks' cosine partials (and, with the first, the
// sums of squares for 1/||w||) so that every block forms the whole a tile
// (past CPORT, share by share).  The projection dw_hat . w_hat is each
// slice's sum (the lanes of a class, then the warps in order) added over
// the slices in slice order, then each block writes its slice of dW once.
template <int VEC, bool SHARE>
__device__ __forceinline__ void dw_cluster_block(float* smem, int tile, int slice,
                                                 const float* __restrict__ e,
                                                 const float* __restrict__ w,
                                                 const int* __restrict__ labels,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ g, int B, int C,
                                                 int D, const Margin& mg,
                                                 float* __restrict__ dw) {
  constexpr int T = 2 * TB * KC;                     // one slice tile
  float* ws = smem;                                  // W tile's slice
  float* es = ws + T;                                // e's batch tile's slice
  float* at_big = ws + 2 * T;                        // [TB][TC]
  float* at_small = at_big + TB * TC;                // [TB][TC]
  float* rinv = at_small + TB * TC;                  // [TC]
  float* projp = rinv + TC;                          // [WARPS][TC]
  float* xch = projp + WARPS * TC;                   // [2][WARPS][4][32]
  float* pub = xch + 2 * WARPS * 128;                // [2][2][THREADS][4], published
  float* sqp = pub + 2 * 2 * THREADS * 4;            // [2][TC], published once
  float* projx = sqp + 2 * 2 * TC;                   // [TC], published
  float* apub = pub + 2 * THREADS * 4;               // SHARE: [2][SHARE_MAX], published

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = tile * TC;
  const int n_bt = (B + TB - 1) / TB;
  const int n_ch = n_chunks(D);
  const int k0 = 2 * slice;
  const int n_s = n_slices(D);
  const int d0 = slice * SW + 32 * warp;   // this warp's first depth
  const bool has_cols = d0 < D;
  const float* wslab = ws + (warp >> 2) * TC * KC;
  const Share sh = SHARE ? logit_share(slice, n_s) : Share{0, 0};

  stage_slice<VEC>(ws, w, col0, C, D, slice);
  stage_slice<VEC>(es, e, 0, B, D, slice);
  tf32x3::commit();
  tf32x3::wait_pending<0>();
  __syncthreads();
  slice_sq(ws, k0, n_ch, sqp);  // the first cluster barrier publishes it

  float acc[2][4][4] = {};
  for (int bt = 0; bt < n_bt; ++bt) {
    tf32x3::wait_pending<0>();
    __syncthreads();  // tile bt has landed
    // buffer bt % 2 is free: every peer read it at tile bt - 2 before it
    // arrived at tile bt - 1's barrier, which this block has passed (SHARE:
    // buffer 0, see above)
    float* pb = SHARE ? pub : pub + (bt & 1) * 2 * THREADS * 4;
    slice_partials(es, ws, k0, n_ch, xch, pb);
    cluster_arrive();
    if constexpr (SHARE) {
      cluster_wait();  // A: every block's partials
      if (bt == 0) cluster_rnorms_tail<XB_BWD>(sqp, n_ch, rinv);  // every class's
      const float dot = cluster_logit_dot<XB_BWD>(pb, sh, n_ch);
      const ShareRow sr = share_row(sh, labels, lse, g, B, bt * TB);
      if (bt == 0) __syncthreads();  // rinv
      publish_a_share<false>(dot, sh, sr, rinv, C, col0, mg, apub);
      cluster_arrive();
      cluster_wait();  // B: every block's a share
      gather_a_tile(apub, n_s, at_big, at_small);
    } else {
      const Rows rd = row_data(labels, lse, g, B, bt * TB);
      cluster_wait();
      if (bt == 0) {
        cluster_rnorms(sqp, n_ch, rinv);
        __syncthreads();
      }
      float dot[4];
      cluster_dot(dot, pb, n_ch);
      a_tile<false>(dot, rinv, rd, C, col0, mg, at_big, at_small);
    }
    __syncthreads();
    if (has_cols)
      tf32x3::warp_mma_k32<K_ROWS>(acc, at_big, at_small, es + (warp >> 2) * TB * KC, KC,
                                   32 * (warp & 3));
    if (bt + 1 < n_bt) {
      __syncthreads();  // every warp is done with tile bt
      stage_slice<VEC>(es, e, (bt + 1) * TB, B, D, slice);
      tf32x3::commit();
    }
  }

  // acc[i][j][q] holds class 16 i + lane / 4 + 8 (q / 2) at depth
  // d0 + 8 j + 2 (lane % 4) + q % 2; w_hat is read back from the W slice
  auto w_hat = [&](int cls, int j, int q) {
    return __fmul_rn(wslab[at(cls, 32 * (warp & 3) + 8 * j + 2 * (lane & 3) + q, KC)],
                     rinv[cls]);
  };
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cls = 16 * i + (lane >> 2) + 8 * h;
      float proj = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) proj = fmaf(acc[i][j][2 * h + q], w_hat(cls, j, q), proj);
      // the 4 lanes of a class are neighbours in the warp
      proj += __shfl_xor_sync(FULL, proj, 1);
      proj += __shfl_xor_sync(FULL, proj, 2);
      if ((lane & 3) == 0) projp[warp * TC + cls] = proj;
    }
  __syncthreads();
  if ((int)threadIdx.x < TC) {
    float proj = 0.0f;
    for (int k = 0; k < WARPS; ++k) proj += projp[k * TC + threadIdx.x];
    projx[threadIdx.x] = proj;
  }
  cluster_arrive();
  cluster_wait();
  // the whole projection of each class, the slices' shares in slice order,
  // into projp's first row (every thread of the block is past its reads)
  if ((int)threadIdx.x < TC) {
    float proj = 0.0f;
    for (int r = 0; r < n_s; ++r) {
      const float v = *cluster_map(projx + threadIdx.x, r);
      proj = r ? __fadd_rn(proj, v) : v;
    }
    projp[threadIdx.x] = proj;
  }
  __syncthreads();
  cluster_arrive();  // this block reads no peer's shared memory any more
  if (has_cols) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cls = 16 * i + (lane >> 2) + 8 * h;
        const int c = col0 + cls;
        if (c >= C) continue;
        const float proj = projp[cls];
        const float ri = rinv[cls];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int d = d0 + 8 * j + 2 * (lane & 3) + q;
            if (d < D)
              dw[(size_t)c * D + d] = __fmul_rn(
                  __fsub_rn(acc[i][j][2 * h + q], __fmul_rn(proj, w_hat(cls, j, q))), ri);
          }
      }
  }
  cluster_wait();  // no block leaves while a peer may read its shared memory
}

// The de pass for WMAX < D <= CMAX, one cluster per (batch tile, class
// split): each block keeps its slice of the e tile, streams its split's W
// tiles at its slice through one buffer as the dW pass streams e's, and
// writes part[split]'s depths of its slice; for each class tile the
// cluster exchanges the cosine partials and the sums of squares (past
// CPORT, the a tile share by share).
template <int VEC, bool SHARE>
__device__ __forceinline__ void de_cluster_block(float* smem, int row_tile, int split, int slice,
                                                 const float* __restrict__ e,
                                                 const float* __restrict__ w,
                                                 const int* __restrict__ labels,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ g, int B, int C,
                                                 int D, int tiles_per_split, const Margin& mg,
                                                 float* __restrict__ part) {
  constexpr int T = 2 * TB * KC;
  float* es = smem;                                  // e tile's slice
  float* wt = es + T;                                // W tile t's slice
  float* at_big = es + 2 * T;                        // [TB][TC]
  float* at_small = at_big + TB * TC;                // [TB][TC]
  float* rinv = at_small + TB * TC;                  // [TC]
  float* xch = rinv + TC + WARPS * TC;               // [2][WARPS][4][32]
  float* pub = xch + 2 * WARPS * 128;                // [2][2][THREADS][4], published
  float* sqp = pub + 2 * 2 * THREADS * 4;            // [2][2][TC], published
  float* apub = pub + 2 * THREADS * 4;               // SHARE: [2][SHARE_MAX], published

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = row_tile * TB;
  const int n_tiles = (C + TC - 1) / TC;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  const int n_ch = n_chunks(D);
  const int k0 = 2 * slice;
  const int d0 = slice * SW + 32 * warp;
  const bool has_cols = d0 < D;
  const int n_s = n_slices(D);
  const Share sh = SHARE ? logit_share(slice, n_s) : Share{0, 0};

  stage_slice<VEC>(es, e, row0, B, D, slice);
  stage_slice<VEC>(wt, w, tile_lo * TC, C, D, slice);
  tf32x3::commit();

  float acc[2][4][4] = {};
  for (int t = tile_lo; t < tile_hi; ++t) {
    const int cur = (t - tile_lo) & 1;
    tf32x3::wait_pending<0>();
    __syncthreads();  // tile t has landed
    // buffer cur is free, as in the dW pass
    float* pb = SHARE ? pub : pub + cur * 2 * THREADS * 4;
    float* sb = sqp + cur * 2 * TC;
    slice_partials(es, wt, k0, n_ch, xch, pb);
    slice_sq(wt, k0, n_ch, sb);
    cluster_arrive();
    if constexpr (SHARE) {
      cluster_wait();  // A: every block's partials
      cluster_rnorms_tail<XB_BWD>(sb, n_ch, rinv);
      const float dot = cluster_logit_dot<XB_BWD>(pb, sh, n_ch);
      // loaded for every tile, so that it holds no register across the
      // cosine (two blocks an SM leave 128 a thread)
      const ShareRow sr = share_row(sh, labels, lse, g, B, row0);
      __syncthreads();  // rinv
      publish_a_share<true>(dot, sh, sr, rinv, C, t * TC, mg, apub);
      cluster_arrive();
      cluster_wait();  // B: every block's a share
      gather_a_tile(apub, n_s, at_big, at_small);
    } else {
      // loaded for every tile, so that it holds no register across the
      // cosine (two blocks an SM leave 128 a thread)
      const Rows rd = row_data(labels, lse, g, B, row0);
      cluster_wait();
      cluster_rnorms(sb, n_ch, rinv);
      float dot[4];
      cluster_dot(dot, pb, n_ch);
      __syncthreads();  // rinv
      a_tile<true>(dot, rinv, rd, C, t * TC, mg, at_big, at_small);
    }
    __syncthreads();
    if (has_cols)
      tf32x3::warp_mma_k32<MK_ROWS>(acc, at_big, at_small, wt + (warp >> 2) * TC * KC, KC,
                                    32 * (warp & 3));
    if (t + 1 < tile_hi) {
      __syncthreads();  // every warp is done with tile t
      stage_slice<VEC>(wt, w, (t + 1) * TC, C, D, slice);
      tf32x3::commit();
    }
  }

  cluster_arrive();  // this block reads no peer's shared memory any more
  if (has_cols) {
    float* out = part + (size_t)split * B * D;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * i + (lane >> 2) + 8 * h;
        if (r >= B) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int d = d0 + 8 * j + 2 * (lane & 3) + q;
            if (d < D) out[(size_t)r * D + d] = acc[i][j][2 * h + q];
          }
      }
  }
  cluster_wait();  // no block leaves while a peer may read its shared memory
}

// D > CMAX: a cluster of n_c = passes_cluster(D) blocks walks the depth in
// P = n_passes(D) passes (flash_aam_cosine.cuh: the depth in passes), block
// `rank` on slice j n_c + rank in pass j.  A block of the cluster route's
// size holds one 32 x 256 accumulator in its 128 registers a thread, and a
// block here outputs P slices; so it takes half a tile, TH = 16 of its
// batch rows (dê) or classes (dW), and accumulates a 16 x 256 slice for
// two passes at once: the same 32 floats a thread.  Each tile step forms
// that half tile's cosines over every depth pass (half_dots: cosine_dots'
// instructions and order, so the chunk order's bits), so a pass forms each
// cosine tile once (twice past two passes: output groups of two, each
// forming it again).  The two halves of a tile are two clusters.  The
// cosine (four 128-deep chunks a block a tile step) and the exchange set
// the pace, so the share of each slot's partials is read in whole quads by
// every thread at once into shared memory (add_partials), each slot then
// summed in chunk order there; the a half tile is shared out as on the
// cluster route past CPORT.  1/||w|| comes from bwd_norms_kernel, launched
// first.  Both tiles stream chunk by chunk through two slots, the next
// chunk's copy in flight while the current one's MMAs run; past the last
// depth pass, the second product reads the group's output slices of the
// streamed tile: the last pass's where it is one, else a copy staged
// again (tb2, and tb when neither is the last).  The geometry n_c, P comes
// in as kernel parameters, in the constant bank, not in registers, which
// the accumulators and the cosine fill.
constexpr int TH = 16;            // the batch rows (dê) or classes (dW) of a half tile
constexpr int SLOTS_H = TH * TC;  // its logits: 512
constexpr int SHARE_H = (SLOTS_H + CLUSTER_PORTABLE) / (CLUSTER_PORTABLE + 1);  // ceil(512 / 9)
constexpr int N4 = 1;             // quads of partials in flight a thread (add_partials)

static_assert(TB == TC && SLOTS_H == TB * TH, "a half tile is half a tile either way");

// The first row and class of the half tile's 16 x 8 MMA tile ti (0..3):
// the dê pass's half tile is TH rows by TC classes (four tiles along the
// classes), the dW pass's TB rows by TH classes (two by two).
template <bool DW>
__device__ __forceinline__ int half_m0(int ti) { return DW ? 16 * (ti >> 1) : 0; }

template <bool DW>
__device__ __forceinline__ int half_n0(int ti) { return DW ? 8 * (ti & 1) : 8 * ti; }

// The row and class in the half tile of published slot s (0..511), thread
// s / 2's dot[s % 2] (half_dots).
template <bool DW>
__device__ __forceinline__ int half_row(int s) {
  const int u = s >> 1;
  return half_m0<DW>(u >> 5 & 3) + ((u & 31) >> 2) + 8 * (u >> 7);
}

template <bool DW>
__device__ __forceinline__ int half_col(int s) {
  const int u = s >> 1;
  return half_n0<DW>(u >> 5 & 3) + 2 * (u & 3) + (s & 1);
}

// cosine_dots for a half tile of 128-deep chunks: the rows of `rows` (TH
// of them in the dê pass, TB in the dW pass) against the classes of `cls`
// (TC; TH).  Warp w computes the 16 x 8 tile w % 4 over the half depth
// w / 4 as cosine_dots does (16-deep 3xTF32 steps added in order), keeps
// row g + 8 (w / 4) of it and hands the other to warp w ^ 4 through xch
// (WARPS x 2 x 32 floats); dot[q] = its own half's sum + the other's,
// slot 2 threadIdx.x + q (half_row, half_col).  The two warps of a tile
// meet at named barrier 1 + tile.
template <bool DW>
__device__ __forceinline__ void half_dots(float (&dot)[2], const float* rows, const float* cls,
                                          float* xch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ti = warp & 3;
  const int kh = warp >> 2;
  float sum[1][1][4] = {};
#pragma unroll 2
  for (int kc = 0; kc < KC / 2; kc += 16) {
    float chunk[1][1][4] = {};
    tf32x3::warp_mma_k16<1, 1>(chunk, rows, KC, half_m0<DW>(ti), cls, KC, half_n0<DW>(ti),
                               kh * (KC / 2) + kc);
#pragma unroll
    for (int q = 0; q < 4; ++q) sum[0][0][q] = __fadd_rn(sum[0][0][q], chunk[0][0][q]);
  }
  // keep row g + 8 kh (accumulators 2 kh, 2 kh + 1), hand the other over
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    dot[q] = kh ? sum[0][0][2 + q] : sum[0][0][q];
    xch[(warp * 2 + q) * 32 + lane] = kh ? sum[0][0][q] : sum[0][0][2 + q];
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + ti) : "memory");
#pragma unroll
  for (int q = 0; q < 2; ++q) dot[q] = __fadd_rn(dot[q], xch[((warp ^ 4) * 2 + q) * 32 + lane]);
}

// The passes route's shared memory: 105,224 bytes, two blocks an SM.
struct PassesSmem {
  float* sb;        // the stationary half tile's chunk slots: [2][TH][KC]
  float* tb;        // the streamed tile's chunk slots, a slice: [2][TB][KC]
  float* tb2;       // a second slice of the streamed tile: [2][TB][KC]
  float* at_big;    // [TB][TC]
  float* at_small;  // [TB][TC]
  float* xch;       // [2][WARPS][2][32]
  float* stash;     // at_big .. xch: free while the partials are read
  float* pub;       // [2][2][SLOTS_H], published
  float* apub;      // [2][SHARE_H], published
  float* rinv;      // [TC]
  float* projp;     // [2][WARPS][TH]
  float* projx;     // [2][TH], published
  float* projr;     // [TH], the projection, slices so far
  float* dotr;      // [THREADS], the share's running dots
};

constexpr int PASSES_STASH = 2 * TB * TC + 2 * WARPS * 64;

__device__ __forceinline__ PassesSmem passes_smem(float* smem) {
  PassesSmem m;
  m.sb = smem;
  m.tb = m.sb + 2 * TH * KC;
  m.tb2 = m.tb + 2 * TB * KC;
  m.at_big = m.tb2 + 2 * TB * KC;
  m.at_small = m.at_big + TB * TC;
  m.xch = m.at_small + TB * TC;
  m.stash = m.at_big;
  m.pub = m.at_big + PASSES_STASH;
  m.apub = m.pub + 2 * 2 * SLOTS_H;
  m.rinv = m.apub + 2 * SHARE_H;
  m.projp = m.rinv + TC;
  m.projx = m.projp + 2 * WARPS * TH;
  m.projr = m.projx + 2 * TH;
  m.dotr = m.projr + TH;
  return m;
}

__host__ __device__ inline int passes_smem_floats() {
  return 2 * TH * KC + 4 * TB * KC + PASSES_STASH + 2 * 2 * SLOTS_H + 2 * SHARE_H + TC +
         2 * WARPS * TH + 2 * TH + TH + THREADS;
}

// rinv[c] = the chunk order's 1/||W row c|| for every class, one block per
// TC-class tile streaming its chunks (the passes route's norms).
template <int VEC>
__global__ void __launch_bounds__(THREADS)
bwd_norms_kernel(const float* __restrict__ w, int C, int D, float* __restrict__ rinv) {
  __shared__ __align__(16) float ws[2 * TC * KC];
  stream_rnorms<VEC>(ws, w, C, D, rinv);
}

// The norms of the TC classes from col0 (bwd_norms_kernel's; those past C
// as a zero row's), into rinv: seen by the block after the next
// __syncthreads.
__device__ __forceinline__ void load_rnorms(const float* __restrict__ rinv_g, int C, int col0,
                                            float* rinv) {
  if ((int)threadIdx.x < TC)
    rinv[threadIdx.x] =
        col0 + (int)threadIdx.x < C ? rinv_g[col0 + threadIdx.x] : __frsqrt_rn(1e-24f);
}

// Chunk k (depths [k KC, k KC + KC), zeros past D) of the stationary rows
// [s_row0, s_row0 + TH) of s_x (s_n rows) and of the streamed rows
// [t_row0, t_row0 + TB) of t_x (t_n rows), into slot k % 2 of sb and tb
// (a slice's layout: chunk 2 s + c of slice s lies in slot c), as one
// group.
template <int VEC>
__device__ __forceinline__ void stage_chunk(const PassesSmem& m, const float* __restrict__ s_x,
                                            int s_row0, int s_n, const float* __restrict__ t_x,
                                            int t_row0, int t_n, int D, int k) {
  const int d0 = k * KC;
  const int off = d0 < D ? d0 : 0;  // a chunk at or past D is all zeros: no byte is read
  tf32x3::stage_rows<VEC>(m.sb + (k & 1) * TH * KC, KC, s_x + off, D, s_row0, TH, s_n, D - d0);
  tf32x3::stage_rows<VEC>(m.tb + (k & 1) * TB * KC, KC, t_x + off, D, t_row0, TB, t_n, D - d0);
  tf32x3::commit();
}

// Block `rank`'s share of a half tile's slots, one a thread.
__device__ __forceinline__ Share half_share(int rank, int n_c) {
  const int L = (SLOTS_H + n_c - 1) / n_c;
  return {rank * L, min(rank * L + L, SLOTS_H)};
}

// Add the partials of chunks [k0, k1) onto the running dot of each slot of
// share sh, dotr[t] for thread t of the share (set by chunk 0).  Chunk k's
// lie in pass j = k / (2 n_c), block k / 2 - j n_c's publish buffer j % 2,
// chunk k % 2 of it.  A slot's partials lie in k1 - k0 peers, and one
// thread reading them in chunk order would wait for each round trip in
// turn; so every thread of the block first reads whole quads
// of the share's slots (cluster_ld4, N4 in flight) into stash
// ([k1 - k0][nq quads][4]: at most 2400 floats at any D, under the
// PASSES_STASH of the layout), and past a __syncthreads each slot's thread
// adds its own from there in chunk order.  The caller syncs before the next use of
// stash.
__device__ __forceinline__ void add_partials(const float* pub, const Share& sh, int k0, int k1,
                                             int n_c, float* dotr, float* stash) {
  const int q0 = sh.i0 >> 2;
  const int nq = ((sh.i1 + 3) >> 2) - q0;
  const int n = (k1 - k0) * nq;
  for (int i0 = threadIdx.x; i0 < n; i0 += N4 * THREADS) {
    float4 v[N4];
#pragma unroll
    for (int u = 0; u < N4; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) {
        const int k = k0 + i / nq;
        const int j = k / (2 * n_c);
        v[u] = cluster_ld4(pub + (2 * (j & 1) + (k & 1)) * SLOTS_H + 4 * (q0 + i % nq),
                           (k >> 1) - j * n_c);
      }
    }
#pragma unroll
    for (int u = 0; u < N4; ++u)
      if (i0 + u * THREADS < n) *reinterpret_cast<float4*>(stash + 4 * (i0 + u * THREADS)) = v[u];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < sh.i1 - sh.i0) {
    const float* mine = stash + sh.i0 + t - 4 * q0;
    float dot = k0 ? dotr[t] : 0.0f;
    for (int k = k0; k < k1; ++k) {
      const float v = mine[(k - k0) * 4 * nq];
      dot = k ? __fadd_rn(dot, v) : v;
    }
    dotr[t] = dot;
  }
}

// One tile step's cosines: in depth pass j the block stages and dots its
// slice j n_c + rank of the stationary and streamed rows, chunk by chunk
// through the two slots (the next chunk's copy in flight while the current
// one's MMAs run), each chunk's partials published in buffer j % 2.  Up to
// two passes each has a buffer of its own, so the passes publish first and
// meet at one cluster barrier; with more, each pass meets at its own, and a
// buffer is rewritten only past the next pass's, which the peers reach
// after reading it.  Past each barrier the block adds the partials
// published since the last (add_partials).  Past the last it stages the
// streamed rows' slices of passes re_a into tb2 and re_b into tb (-1:
// none), which the caller waits for before its second product.  The dots
// are seen by the block after the next __syncthreads.
template <int VEC, bool DW>
__device__ __forceinline__ void passes_cosine(const PassesSmem& m, const Share& sh,
                                              const float* __restrict__ s_x, int s_row0,
                                              int s_n, const float* __restrict__ t_x,
                                              int t_row0, int t_n, int D, int n_c, int P,
                                              int rank, int re_a, int re_b) {
  const int n_ch = n_chunks(D);
  __syncthreads();  // every warp is done with sb, tb and tb2
  stage_chunk<VEC>(m, s_x, s_row0, s_n, t_x, t_row0, t_n, D, 2 * rank);
  int j0 = 0;  // the first pass whose partials are not added yet
  for (int i = 0; i < 2 * P; ++i) {
    const int j = i >> 1;
    const int c = i & 1;
    const int k = 2 * (j * n_c + rank) + c;
    tf32x3::wait_pending<0>();
    __syncthreads();  // chunk k has landed, and every warp is done with the other slot
    if (i + 1 < 2 * P)
      stage_chunk<VEC>(m, s_x, s_row0, s_n, t_x, t_row0, t_n, D, c ? k - 1 + 2 * n_c : k + 1);
    if (k < n_ch) {
      const float* sc = m.sb + c * TH * KC;
      const float* tc = m.tb + c * TB * KC;
      float dot[2];
      half_dots<DW>(dot, DW ? tc : sc, DW ? sc : tc, m.xch + c * WARPS * 64);
      *reinterpret_cast<float2*>(m.pub + (2 * (j & 1) + c) * SLOTS_H + 2 * threadIdx.x) =
          make_float2(dot[0], dot[1]);
    }
    if (c == 0 || (P <= 2 && j + 1 < P)) continue;
    cluster_arrive();
    cluster_wait();  // every block's partials so far; every warp here is past sb and tb
    if (j + 1 == P && (re_a >= 0 || re_b >= 0)) {
      if (re_a >= 0) stage_slice<VEC>(m.tb2, t_x, t_row0, t_n, D, re_a * n_c + rank);
      if (re_b >= 0) stage_slice<VEC>(m.tb, t_x, t_row0, t_n, D, re_b * n_c + rank);
      tf32x3::commit();
    }
    add_partials(m.pub, sh, 2 * n_c * j0, min(2 * n_c * (j + 1), n_ch), n_c, m.dotr, m.stash);
    j0 = j + 1;
  }
}

// a of the thread's slot of share sh (half_row, half_col from row0, col0),
// as a_tile forms it (0 outside B and C; SCALE folds 1/||w|| in; rinv from
// col0), published as its TF32 parts: big at apub[s - i0], small at
// apub[SHARE_H + s - i0].
template <bool DW, bool SCALE>
__device__ __forceinline__ void publish_half(float dot, const Share& sh,
                                             const int* __restrict__ labels,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ g, int B, int C,
                                             int row0, int col0, const float* rinv,
                                             const Margin& mg, float* apub) {
  const int s = share_slot(sh);
  if (s >= sh.i1) return;
  const int r = row0 + half_row<DW>(s);
  const int cls = half_col<DW>(s);
  const int c = col0 + cls;
  float a = 0.0f;
  if (r < B && c < C) {
    const float ri = rinv[cls];
    a = dlogit(__fmul_rn(dot, ri), c == labels[r], lse[r], g[r], mg);
    if (SCALE) a = __fmul_rn(a, ri);
  }
  const tf32x3::Split sp = tf32x3::split(a);
  apub[s - sh.i0] = __uint_as_float(sp.big);
  apub[SHARE_H + s - sh.i0] = __uint_as_float(sp.small);
}

// The whole a half tile from the shares the cluster published
// (publish_half; slot s in block s / L's share), into the swizzled
// at_big[row][class] and at_small[row][class].  The caller syncs before
// reading them.
template <bool DW>
__device__ __forceinline__ void gather_half(const float* apub, int n_c, float* at_big,
                                            float* at_small) {
  const int L = (SLOTS_H + n_c - 1) / n_c;
  float big[2], small[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = (int)threadIdx.x + THREADS * u;
    const int r = s / L;
    big[u] = cluster_ld(apub + (s - r * L), r);
    small[u] = cluster_ld(apub + SHARE_H + (s - r * L), r);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = (int)threadIdx.x + THREADS * u;
    at_big[at(half_row<DW>(s), half_col<DW>(s), TC)] = big[u];
    at_small[at(half_row<DW>(s), half_col<DW>(s), TC)] = small[u];
  }
}

// The dW pass for D > CMAX, one cluster per TC-class tile and half of it:
// the TH classes from c0.  For each output group o (its depth passes
// a = 2 o and b = a + 1, where b < P), the block accumulates dw_hat over
// its two output slices a n_c + rank and b n_c + rank across the batch
// tiles, then adds each slice's share of the projection dw_hat . w_hat
// (the lanes of a class, then the warps in order; w_hat from W in global
// memory) to the running projection, which every block carries in slice
// order (the group's slices read from its peers past a cluster barrier).
// The projection needs every slice, so past two passes the slices of the
// earlier groups are written unprojected and projected in place at the
// end, when the last group's are written from their accumulators.
template <int VEC>
__device__ __forceinline__ void dw_passes_block(const PassesSmem& m, int tile, int half, int rank,
                                                const float* __restrict__ e,
                                                const float* __restrict__ w,
                                                const int* __restrict__ labels,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ g,
                                                const float* __restrict__ rinv_g, int B, int C,
                                                int D, int n_c, int P, const Margin& mg,
                                                float* __restrict__ dw) {
  const int c0 = tile * TC + TH * half;
  if (c0 >= C) return;  // the whole cluster: no class here
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_bt = (B + TB - 1) / TB;
  const int n_s = n_slices(D);
  const int G = (P + 1) / 2;
  const Share sh = half_share(rank, n_c);
  load_rnorms(rinv_g, C, c0, m.rinv);

  // acc[x][0][j][q] holds class g + 8 (q / 2) (g = lane / 4) at depth
  // s_x SW + 32 warp + 8 j + 2 (lane % 4) + q % 2 of output slice s_x
  auto w_hat = [&](int cls, size_t d) {
    return c0 + cls < C && d < (size_t)D ? __fmul_rn(w[(size_t)(c0 + cls) * D + d], m.rinv[cls])
                                         : 0.0f;
  };
  float acc[2][1][4][4];
  for (int o = 0; o < G; ++o) {
    const int a = 2 * o;
    const int nx = a + 1 < P ? 2 : 1;  // output slices in the group
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[x][0][j][q] = 0.0f;
    for (int bt = 0; bt < n_bt; ++bt) {
      // the last depth pass's slice is the last group's; the others are
      // staged again
      passes_cosine<VEC, true>(m, sh, w, c0, C, e, bt * TB, B, D, n_c, P, rank,
                               a + 1 < P ? a : -1, nx == 2 && a + 2 < P ? a + 1 : -1);
      publish_half<true, false>(m.dotr[threadIdx.x], sh, labels, lse, g, B, C, bt * TB, c0,
                                m.rinv, mg, m.apub);
      cluster_arrive();
      cluster_wait();  // every block's a share
      gather_half<true>(m.apub, n_c, m.at_big, m.at_small);
      tf32x3::wait_pending<0>();  // the output slices staged again
      __syncthreads();
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float* tx = x == 0 && a + 1 < P ? m.tb2 : m.tb;
        if (x < nx && ((a + x) * n_c + rank) * SW + 32 * warp < D)
          tf32x3::warp_mma_k32<K_ROWS, 1>(acc[x], m.at_big, m.at_small,
                                          tx + (warp >> 2) * TB * KC, KC, 32 * (warp & 3));
      }
    }

    // each output slice's projection share (zero past D)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cls = (lane >> 2) + 8 * h;
        const size_t d0 = (size_t)((a + x) * n_c + rank) * SW + 32 * warp;
        float proj = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (x < nx)
              proj = fmaf(acc[x][0][j][2 * h + q], w_hat(cls, d0 + 8 * j + 2 * (lane & 3) + q),
                          proj);
          }
        // the 4 lanes of a class are neighbours in the warp
        proj += __shfl_xor_sync(FULL, proj, 1);
        proj += __shfl_xor_sync(FULL, proj, 2);
        if ((lane & 3) == 0) m.projp[(x * WARPS + warp) * TH + cls] = proj;
      }
    __syncthreads();
    if ((int)threadIdx.x < 2 * TH) {
      float proj = 0.0f;
      for (int k = 0; k < WARPS; ++k) proj += m.projp[((threadIdx.x / TH) * WARPS + k) * TH +
                                                     threadIdx.x % TH];
      m.projx[threadIdx.x] = proj;
    }
    if (o + 1 < G) {  // dw_hat of the group's slices, projected at the end
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + (lane >> 2) + 8 * h;
          const size_t row = (size_t)c * D + ((a + x) * n_c + rank) * SW + 32 * warp;
          if (c >= C) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              dw[row + 8 * j + 2 * (lane & 3) + q] = acc[x][0][j][2 * h + q];
        }
    }
    cluster_arrive();
    cluster_wait();  // every block's share of the group's slices
    if ((int)threadIdx.x < TH) {
      for (int x = 0; x < nx; ++x)
        for (int r = 0; r < n_c && (a + x) * n_c + r < n_s; ++r) {
          const float v = cluster_ld(m.projx + x * TH + threadIdx.x, r);
          m.projr[threadIdx.x] = (a + x) * n_c + r ? __fadd_rn(m.projr[threadIdx.x], v) : v;
        }
    }
  }

  __syncthreads();  // projr
  cluster_arrive();  // this block reads no peer's shared memory any more
  // dW = (dw_hat - proj w_hat) / ||w||: the last group's slices from their
  // accumulators, the earlier ones in place (each thread rereads what it
  // wrote)
  const int a = 2 * (G - 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int cls = (lane >> 2) + 8 * h;
    const int c = c0 + cls;
    if (c >= C) continue;
    const float proj = m.projr[cls];
    const float ri = m.rinv[cls];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const size_t d0 = (size_t)((a + x) * n_c + rank) * SW + 32 * warp;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const size_t d = d0 + 8 * j + 2 * (lane & 3) + q;
          if (a + x < P && d < (size_t)D)
            dw[(size_t)c * D + d] = __fmul_rn(
                __fsub_rn(acc[x][0][j][2 * h + q], __fmul_rn(proj, w_hat(cls, d))), ri);
        }
    }
    for (int o = 0; o < G - 1; ++o)
      for (int x = 0; x < 2; ++x) {
        const size_t row = (size_t)c * D + ((2 * o + x) * n_c + rank) * SW + 32 * warp;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const size_t k = row + 8 * j + 2 * (lane & 3) + q;
            dw[k] = __fmul_rn(__fsub_rn(dw[k], __fmul_rn(proj, __fmul_rn(w[k], ri))), ri);
          }
      }
  }
  cluster_wait();  // no block leaves while a peer may read its shared memory
}

// The dê pass for D > CMAX, one cluster per (batch tile, half, class split,
// output group): the TH batch rows from r0 of the tile, the group's depth
// passes a = 2 group and b = a + 1 (where b < P).  The block walks the
// split's W tiles, forming each tile's cosines over the depth passes, and
// writes part[split]'s depths of its output slices a n_c + rank and
// b n_c + rank.
template <int VEC>
__device__ __forceinline__ void de_passes_block(const PassesSmem& m, int row_tile, int half,
                                                int split, int group, int rank,
                                                const float* __restrict__ e,
                                                const float* __restrict__ w,
                                                const int* __restrict__ labels,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ g,
                                                const float* __restrict__ rinv_g, int B, int C,
                                                int D, int n_c, int P, int tiles_per_split,
                                                const Margin& mg, float* __restrict__ part) {
  const int r0 = row_tile * TB + TH * half;
  if (r0 >= B) return;  // the whole cluster: no batch row here
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (C + TC - 1) / TC;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  const int a = 2 * group;
  const int nx = a + 1 < P ? 2 : 1;  // output slices in the group
  const Share sh = half_share(rank, n_c);

  float acc[2][1][4][4] = {};
  for (int t = tile_lo; t < tile_hi; ++t) {
    // every warp is past its reads of rinv (publish_half) at tile t - 1
    load_rnorms(rinv_g, C, t * TC, m.rinv);
    // the last depth pass's slice is the last group's; the others are
    // staged again
    passes_cosine<VEC, false>(m, sh, e, r0, B, w, t * TC, C, D, n_c, P, rank,
                              a + 1 < P ? a : -1, nx == 2 && a + 2 < P ? a + 1 : -1);
    publish_half<false, true>(m.dotr[threadIdx.x], sh, labels, lse, g, B, C, r0, t * TC,
                              m.rinv, mg, m.apub);
    cluster_arrive();
    cluster_wait();  // every block's a share
    gather_half<false>(m.apub, n_c, m.at_big, m.at_small);
    tf32x3::wait_pending<0>();  // the output slices staged again
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float* tx = x == 0 && a + 1 < P ? m.tb2 : m.tb;
      if (x < nx && ((a + x) * n_c + rank) * SW + 32 * warp < D)
        tf32x3::warp_mma_k32<MK_ROWS, 1>(acc[x], m.at_big, m.at_small,
                                         tx + (warp >> 2) * TC * KC, KC, 32 * (warp & 3));
    }
  }
  cluster_arrive();  // this block reads no peer's shared memory any more
  float* out = part + (size_t)split * B * D;
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + (lane >> 2) + 8 * h;
      const int d0 = ((a + x) * n_c + rank) * SW + 32 * warp;
      if (x >= nx || r >= B) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int d = d0 + 8 * j + 2 * (lane & 3) + q;
          if (d < D) out[(size_t)r * D + d] = acc[x][0][j][2 * h + q];
        }
    }
  cluster_wait();  // no block leaves while a peer may read its shared memory
}

// Both passes in one launch: blocks [0, n_dw) run the dW pass on class tile
// blockIdx.x, the rest the de pass on (batch tile, split), batch tile
// fastest.  The passes share no data, so the de blocks take the SMs that
// the dW pass leaves free.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
bwd_tiles_kernel(const float* __restrict__ e, const float* __restrict__ w,
                 const int* __restrict__ labels, const float* __restrict__ lse,
                 const float* __restrict__ g, int B, int C, int D, int DP,
                 int tiles_per_split, Margin mg, float* __restrict__ part,
                 float* __restrict__ dw) {
  extern __shared__ __align__(16) float smem[];
  const int n_dw = (C + TC - 1) / TC;
  if ((int)blockIdx.x < n_dw) {
    dw_block<VEC>(smem, blockIdx.x, e, w, labels, lse, g, B, C, D, DP, mg, dw);
  } else {
    const int i = blockIdx.x - n_dw;
    const int n_rt = (B + TB - 1) / TB;
    de_block<VEC>(smem, i % n_rt, i / n_rt, e, w, labels, lse, g, B, C, D, DP,
                  tiles_per_split, mg, part);
  }
}

// The two passes for DMAX < D <= WMAX, on blocks of one an SM.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
bwd_wide_kernel(const float* __restrict__ e, const float* __restrict__ w,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ g, int B, int C, int D, int tiles_per_split,
                Margin mg, float* __restrict__ part, float* __restrict__ dw) {
  extern __shared__ __align__(16) float smem[];
  const int n_dw = (C + TC - 1) / TC;
  if ((int)blockIdx.x < n_dw) {
    dw_wide_block<VEC>(smem, blockIdx.x, e, w, labels, lse, g, B, C, D, mg, dw);
  } else {
    const int i = blockIdx.x - n_dw;
    const int n_rt = (B + TB - 1) / TB;
    de_wide_block<VEC>(smem, i % n_rt, i / n_rt, e, w, labels, lse, g, B, C, D,
                       tiles_per_split, mg, part);
  }
}

// The two passes for WMAX < D <= CMAX, launched in clusters of
// n_slices(D) blocks, consecutive in x, each block on the slice of its
// rank.  The de pass comes first: cluster u < n_de runs it on (batch tile,
// split) u, the rest the dW pass on class tile u - n_de.  A de cluster
// walks a whole split and a dW cluster only the batch tiles, so the long
// ones start first and the short ones fill the SMs around them.  Two
// blocks an SM.  SHARE (clusters past the portable size) exchanges the
// cosines share by share.
template <int VEC, bool SHARE>
__global__ void __launch_bounds__(THREADS, 2)
bwd_cluster_kernel(const float* __restrict__ e, const float* __restrict__ w,
                   const int* __restrict__ labels, const float* __restrict__ lse,
                   const float* __restrict__ g, int B, int C, int D, int tiles_per_split,
                   Margin mg, float* __restrict__ part, float* __restrict__ dw) {
  extern __shared__ __align__(16) float smem[];
  const int n_dw = (C + TC - 1) / TC;
  const int n_de = (int)gridDim.x / n_slices(D) - n_dw;
  const int unit = blockIdx.x / n_slices(D);
  const int slice = cluster_rank();
  if (unit < n_de) {
    const int n_rt = (B + TB - 1) / TB;
    de_cluster_block<VEC, SHARE>(smem, unit % n_rt, unit / n_rt, slice, e, w, labels, lse, g,
                                 B, C, D, tiles_per_split, mg, part);
  } else {
    dw_cluster_block<VEC, SHARE>(smem, unit - n_de, slice, e, w, labels, lse, g, B, C, D, mg,
                                 dw);
  }
}

// The two passes for D > CMAX, launched in clusters of n_c =
// passes_cluster(D) blocks walking P = n_passes(D) depth passes, de
// clusters first, as bwd_cluster_kernel: one for each (batch tile, half,
// split, output group), the group fastest, then one for each (class tile,
// half); two blocks an SM.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
bwd_passes_kernel(const float* __restrict__ e, const float* __restrict__ w,
                  const int* __restrict__ labels, const float* __restrict__ lse,
                  const float* __restrict__ g, const float* __restrict__ rinv_g, int B, int C,
                  int D, int n_c, int P, int tiles_per_split, Margin mg,
                  float* __restrict__ part, float* __restrict__ dw) {
  extern __shared__ __align__(16) float smem[];
  const PassesSmem m = passes_smem(smem);
  const int n_dw = 2 * ((C + TC - 1) / TC);
  const int n_de = (int)gridDim.x / n_c - n_dw;
  const int unit = blockIdx.x / n_c;
  const int rank = cluster_rank();
  if (unit < n_de) {
    const int G = (P + 1) / 2;
    const int n_rt = (B + TB - 1) / TB;
    const int u = unit / G / 2;
    de_passes_block<VEC>(m, u % n_rt, unit / G % 2, u / n_rt, unit % G, rank, e, w, labels,
                         lse, g, rinv_g, B, C, D, n_c, P, tiles_per_split, mg, part);
  } else {
    const int u = unit - n_de;
    dw_passes_block<VEC>(m, u / 2, u % 2, rank, e, w, labels, lse, g, rinv_g, B, C, D, n_c, P,
                         mg, dw);
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

// The route's kernel for depth D and its dynamic shared memory, with the
// kernel allowed that much (and, on the cluster route, its cluster size).
// Every launch and every occupancy query of this instantiation calls it
// first.
template <int VEC>
cudaError_t route(int D, const void** kernel, size_t* smem) {
  if (D <= DMAX) {
    const int DP = padded_depth(D);
    // the dW pass's layout (the de pass's is smaller: no projection scratch)
    *smem = sizeof(float) * (3 * TB * DP + 2 * TB * TC + TC + WARPS * TC + WARPS * 128);
    *kernel = reinterpret_cast<const void*>(bwd_tiles_kernel<VEC>);
  } else if (D <= WMAX) {
    *smem = sizeof(float) * wide_smem_floats(D);
    *kernel = reinterpret_cast<const void*>(bwd_wide_kernel<VEC>);
  } else if (D <= CMAX) {
    *smem = sizeof(float) * cluster_smem_floats();
    *kernel = D > CPORT ? reinterpret_cast<const void*>(bwd_cluster_kernel<VEC, true>)
                        : reinterpret_cast<const void*>(bwd_cluster_kernel<VEC, false>);
    const cudaError_t err = allow_cluster(*kernel, D);
    if (err != cudaSuccess) return err;
  } else {
    *smem = sizeof(float) * passes_smem_floats();
    *kernel = reinterpret_cast<const void*>(bwd_passes_kernel<VEC>);
    const cudaError_t err = allow_cluster(*kernel, D);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <int VEC>
cudaError_t launch(const float* e, const float* w, const int* labels, const float* lse,
                   const float* g, int B, int C, int D, int tiles_per_split, int n_splits,
                   const Margin& mg, float* part, float* de, float* dw, cudaStream_t st) {
  static_assert(TB == TC, "both passes stage three 32-row tiles");
  // the passes route runs its clusters on half tiles, and a de cluster for
  // each output group
  const int halves = D > CMAX ? 2 : 1;
  const int per_split = (B + TB - 1) / TB * (D > CMAX ? 2 * ((n_passes(D) + 1) / 2) : 1);
  const int blocks = halves * ((C + TC - 1) / TC) + per_split * n_splits;
  const void* kernel;
  size_t smem;
  cudaError_t err = route<VEC>(D, &kernel, &smem);
  if (err != cudaSuccess) return err;
  if (D <= DMAX) {
    bwd_tiles_kernel<VEC><<<blocks, THREADS, smem, st>>>(e, w, labels, lse, g, B, C, D,
                                                          padded_depth(D), tiles_per_split, mg,
                                                          part, dw);
  } else if (D <= WMAX) {
    bwd_wide_kernel<VEC><<<blocks, THREADS, smem, st>>>(e, w, labels, lse, g, B, C, D,
                                                         tiles_per_split, mg, part, dw);
  } else if (D <= CMAX) {
    // a refused cluster launch returns its error: no other route stands in
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(D, blocks, smem, st, &attr);
    err = D > CPORT ? cudaLaunchKernelEx(&cfg, bwd_cluster_kernel<VEC, true>, e, w, labels, lse,
                                         g, B, C, D, tiles_per_split, mg, part, dw)
                    : cudaLaunchKernelEx(&cfg, bwd_cluster_kernel<VEC, false>, e, w, labels, lse,
                                         g, B, C, D, tiles_per_split, mg, part, dw);
    if (err != cudaSuccess) return err;
  } else {
    // the norms first, into the scratch past the splits' partials
    float* rinv = part + (size_t)n_splits * B * D;
    bwd_norms_kernel<VEC><<<(C + TC - 1) / TC, THREADS, 0, st>>>(w, C, D, rinv);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config_of(passes_cluster(D), blocks, smem, st, &attr);
    err = cudaLaunchKernelEx(&cfg, bwd_passes_kernel<VEC>, e, w, labels, lse, g, rinv, B, C, D,
                             passes_cluster(D), n_passes(D), tiles_per_split, mg, part, dw);
    if (err != cudaSuccess) return err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = B * D;
  bwd_de_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, n_splits, n, de);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_aam_bwd_block_rows() { return TB; }
int flash_aam_bwd_block_classes() { return TC; }

// The route that depth D takes: 0 bwd_tiles_kernel, 1 bwd_wide_kernel,
// 2 bwd_passes_kernel, 3 bwd_cluster_kernel.
int flash_aam_bwd_route(int D) { return D <= DMAX ? 0 : D <= WMAX ? 1 : D <= CMAX ? 3 : 2; }

// The blocks of one cluster of depth D's route: n_slices(D) on the cluster
// route, passes_cluster(D) on the passes route, 1 on the others.
int flash_aam_bwd_cluster_size(int D) {
  return D <= WMAX ? 1 : D <= CMAX ? n_slices(D) : passes_cluster(D);
}

// The depth passes of the passes route for depth D, 1 on the others.
int flash_aam_bwd_passes(int D) { return D > CMAX ? n_passes(D) : 1; }

// The floats of scratch that flash_aam_bwd needs past the splits'
// partials: the passes route's norms, C of them.
int flash_aam_bwd_scratch(int C, int D) { return D > CMAX ? C : 0; }

// The clusters of the cluster or passes route for depth D that the current
// device holds at once (cudaOccupancyMaxActiveClusters with the route's
// shared memory; the 16-byte-copy kernel, as flash_aam_bwd_blocks_per_sm),
// or -1 off those routes or on a CUDA error.
int flash_aam_bwd_clusters(int D) {
  const void* kernel;
  size_t smem;
  int clusters = 0;
  cudaLaunchAttribute attr;
  if (D <= WMAX || route<4>(D, &kernel, &smem) != cudaSuccess) return -1;
  const cudaLaunchConfig_t cfg =
      cluster_config_of(flash_aam_bwd_cluster_size(D), 1, smem, nullptr, &attr);
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// The blocks of depth D's route that one SM of the current device holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the route's
// shared memory; the 16-byte-copy kernel, whose 4-byte twin has the same
// shared memory and register cap), or -1 on a CUDA error.
int flash_aam_bwd_blocks_per_sm(int D) {
  const void* kernel;
  size_t smem;
  int blocks = 0;
  if (D <= 0 || route<4>(D, &kernel, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// e (B, D) f32, w (C, D) f32, labels (B,) i32, lse (B,) f32, g (B,) f32, all
// contiguous on the card; part is scratch of n_splits * B * D floats with
// n_splits = ceil(ceil(C / TC) / tiles_per_split), and C more past CMAX
// (flash_aam_bwd_scratch); de (B, D) and dw (C, D) f32 outputs.  Launches on
// `stream` and returns the cudaError_t of the launches (0 on success).
int flash_aam_bwd(const void* e, const void* w, const void* labels, const void* lse,
                  const void* g, int B, int C, int D, int tiles_per_split,
                  int n_splits, float s, float cos_m, float sin_m, float th, float mm,
                  void* part, void* de, void* dw, void* stream) {
  const int n_tiles = (C + TC - 1) / TC;
  if (B <= 0 || C <= 0 || D <= 0 || tiles_per_split <= 0 ||
      n_splits != (n_tiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  const Margin mg{s, cos_m, sin_m, th, mm};
  const float* ef = static_cast<const float*>(e);
  const float* wf = static_cast<const float*>(w);
  const int* lab = static_cast<const int*>(labels);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(part);
  float* def = static_cast<float*>(de);
  float* dwf = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row to start on a 16-byte boundary
  const bool aligned = D % 4 == 0 && reinterpret_cast<uintptr_t>(e) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaError_t err =
      aligned ? launch<4>(ef, wf, lab, lf, gf, B, C, D, tiles_per_split, n_splits, mg, pf,
                          def, dwf, st)
              : launch<1>(ef, wf, lab, lf, gf, B, C, D, tiles_per_split, n_splits, mg, pf,
                          def, dwf, st);
  return (int)err;
}

}  // extern "C"
