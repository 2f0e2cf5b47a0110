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
// Three routes by depth, one launch each and then merge_kernel (launch):
//   D <= DMAX (256): fwd_tiles_kernel, above.  The rows are padded to
//     padded_depth(D) in shared memory with zeros.
//   DMAX < D <= CMAX (4096): fwd_cluster_kernel.  Whole-depth e and W
//     tiles no longer fit two blocks an SM, and streaming both in 128-deep
//     chunks would re-stage the e chunks for every class tile and meet at a
//     block-wide barrier every chunk.  So a thread-block
//     cluster of n_s = n_slices(D) blocks (2 to 16; past CPORT = 2048, 9 to
//     16, larger than the portable size, which the kernel is allowed before
//     its launch, allow_cluster) takes one (batch tile, split) and splits
//     the depth into SW = 256-wide slices, as the backward's cluster route
//     does (flash_aam_bwd.cu: de_cluster_block).  Block `slice` stages its
//     slice of the e tile once, split into its TF32 parts in the order in
//     which the MMAs read them, and streams its slice of the split's W
//     tiles through one buffer: tile t + 1's copy starts as soon as every
//     warp has read tile t, and is in flight through the cluster barrier
//     and the fold.  For each tile every block forms its two chunks'
//     cosine partials (each warp one 16 x 16 quadrant of one chunk,
//     cosine_dots' sum) and their sums of squares and publishes them
//     unsummed; after one cluster barrier the tile's owner, block
//     (t - tile_lo) % n_s, adds all n_chunks(D) of them in chunk order
//     through distributed shared memory (cluster_dot, cluster_rnorms:
//     the chunk order's bits, the backward's) and folds the tile.  So no e
//     chunk is staged twice, the block meets its peers once a tile, the
//     norms come from the published sums of squares, and each tile is
//     folded once, not n_s times.  Past the portable size the owner's
//     reads (2 n_s float4 a thread) set the pace, so there (SHARE) every
//     block folds its 1/n_s share of each tile instead (logit_share), a
//     thread one slot (a layout with owners was slower there than the
//     chunked route on an H100; see PERF.md).  Every block writes its own
//     partial state (an owner of no tile, or of no slot, writes the empty
//     one), and merge_kernel merges the n_splits * n_s of them in order.
//     The published buffers alternate between tiles, so one barrier a tile
//     suffices: a block rewrites a buffer only past the barrier that the
//     tile's readers reach after reading it; every block ends at a cluster
//     barrier, so none leaves while a peer may read its shared memory.  One
//     W buffer keeps a block at 115,328 bytes, two blocks an SM: one runs
//     while the other waits; a cluster of 16 takes 8 SMs of one GPC.  What
//     bounds the route is issuing instructions (the cosine's split of W,
//     the copies' and loads' address arithmetic), so its block keeps them
//     few (see "the cluster route" below).  The splits are those whose
//     last cluster ends first when the card runs them in grid order on the
//     clusters that it holds at once (flash_aam_fwd_clusters; ops/
//     flash_aam.py: _cluster_splits).
//   D > CMAX: fwd_passes_kernel, after fwd_norms_kernel.  A cluster of a
//     block a slice would exceed Hopper's largest (16), so a cluster of
//     n_c = passes_cluster(D) blocks (9 to 16) walks the depth in
//     P = n_passes(D) passes of one slice a block (flash_aam_cosine.cuh:
//     the depth in passes), pass by pass over the split's tiles: in each
//     pass a block stages and splits the e slice of that pass once, as the
//     cluster route does, and streams its slice of each W tile through one
//     buffer.  Each block folds its share of each tile's logits at the last
//     pass, as pairs of neighbouring classes of a row (pair_share: every
//     peer's two chunks of a pair are one float4, so a pair's partials of a
//     pass take n_c reads, all in flight at once); the share's running
//     chunk-order sums cross the passes in global memory (L2), and 1/||w||
//     comes from fwd_norms_kernel, launched first (stream_rnorms: the
//     backward's norms).  Where the cluster route's step is its MMAs, a
//     whole cluster barrier, the reads and the fold one after another on
//     every warp, here the barrier of a tile is split around the next
//     tile's MMAs, one warp's fence releases the block's partials for a
//     relaxed arrive, and warps 4..7 stage the next W tile while warps 0
//     and 1 add the partials (see "the passes route" below).  What bounds
//     it is the step's latency: the MMAs of both blocks of an SM, then the
//     pairs' reads and fold (see PERF.md).
// All deep routes form the chunk order's bits (flash_aam_cosine.cuh), which
// the backward forms on the same tiles, so the bits still agree.  Rows of e
// and W whose length is a multiple of 4 are staged with 16-byte cp.async
// copies; other D take 4-byte copies (VEC = 1).

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

// Fold one logit of a row, the dot `dot` of a class with 1 / ||w|| = ri,
// into the row's online state st: ztr is the row's target logit, is_tgt
// whether the class is the row's label.
__device__ __forceinline__ void fold_logit(RowState& st, float dot, float ri, bool is_tgt,
                                           float ztr, const Margin& mg) {
  const float z = margined(__fmul_rn(dot, ri), is_tgt, mg);
  if (is_tgt) st.zy += z;
  else if (z > ztr) st.cnt += 1.0f;
  if (z > st.m) {
    st.s = st.s * expf(st.m - z) + 1.0f;
    st.m = z;
  } else {
    st.s += expf(z - st.m);
  }
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
      fold_logit(rd.st[h], dot[2 * h + q], ri[q], c == rd.lab[h], rd.ztr[h], mg);
    }
}

// Merge the 16 states of each row of the block's tile, the 4 lanes of a
// warp that share it (shuffles) and then the 4 warps (through xch, in warp
// order), and write partial state `idx` of each row, of n_parts.
__device__ __forceinline__ void write_states(Rows& rd, float* xch, int row0, int B, int idx,
                                             int n_parts, float* __restrict__ part) {
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
  const int r = threadIdx.x;
  if (r >= TB || row0 + r >= B) return;
  const int grp = r >> 4;  // rows [16 grp, 16 grp + 16) are warps 2 grp, 2 grp + 1, + 4, + 5's
  RowState acc = {NEG_INF, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* o = xch + ((2 * grp + (k & 1) + 4 * (k >> 1)) * 16 + (r & 15)) * 4;
    merge(acc, {o[0], o[1], o[2], o[3]});
  }
  const size_t plane = (size_t)n_parts * B;
  const size_t at = (size_t)idx * B + row0 + r;
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
  write_states(rd, xch, row0, B, split, gridDim.y, part);
}

// ---- the cluster route (DMAX < D <= CMAX) ----
//
// The route is bound by issuing instructions (see PERF.md), so its block
// keeps them few while it forms the chunk order's bits:
// - the e slice is split into its TF32 parts once and kept in the order in
//   which the MMAs read their A fragments (stage_e_fragments), so the
//   cosine loads each fragment with one 16-byte load and splits only W;
// - each warp forms one 16 x 16 quadrant of one chunk over the chunk's
//   whole depth, both halves of cosine_dots' sum, with no exchange;
// - the W slices are staged with addresses fixed before the loop
//   (stage_slice_fast), and their sums of squares are taken in tile_sq's
//   order from four base addresses (slice_sq_fast).

// The e slice in fragment order: for chunk c, row block rb (rows 16 rb ..
// 16 rb + 15), 16-deep step s of the chunk, part p (0, 1: the big parts of
// MMA step 0, 1; 2, 3: the small parts) and lane (g, t), the four floats
// {A[g][k], A[g + 8][k], A[g][k + 1], A[g + 8][k + 1]} of rows 16 rb + ..
// at depths k = 16 s + 4 t + 2 (p % 2) of the chunk, as warp_mma_k16 feeds
// its A fragments.  16,384 floats.
__device__ __forceinline__ int e_fragment(int c, int rb, int s, int p) {
  return (((c * 2 + rb) * 8 + s) * 4 + p) * 32 * 4;
}

// Split the e slice, staged raw as two swizzled [TB][KC] chunks at raw, into
// ef (e_fragment's order).  The caller syncs before and after.
__device__ __forceinline__ void stage_e_fragments(const float* raw, float* ef) {
  for (int u = threadIdx.x; u < 2 * 2 * 8 * 32; u += THREADS) {
    const int lane = u & 31, s = u >> 5 & 7, rb = u >> 8 & 1, c = u >> 9;
    const int g = lane >> 2, k = 16 * s + 4 * (lane & 3);
    const float* ch = raw + c * TB * KC;
    const float4 r0 = *reinterpret_cast<const float4*>(ch + tf32x3::at(16 * rb + g, k, KC));
    const float4 r1 = *reinterpret_cast<const float4*>(ch + tf32x3::at(16 * rb + g + 8, k, KC));
    const float x[2][4] = {{r0.x, r0.y, r0.z, r0.w}, {r1.x, r1.y, r1.z, r1.w}};
    tf32x3::Split sp[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[h][e] = tf32x3::split(x[h][e]);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int e0 = 2 * st;
      float4* big = reinterpret_cast<float4*>(ef + e_fragment(c, rb, s, st)) + lane;
      float4* small = reinterpret_cast<float4*>(ef + e_fragment(c, rb, s, 2 + st)) + lane;
      *big = make_float4(__uint_as_float(sp[0][e0].big), __uint_as_float(sp[1][e0].big),
                         __uint_as_float(sp[0][e0 + 1].big), __uint_as_float(sp[1][e0 + 1].big));
      *small =
          make_float4(__uint_as_float(sp[0][e0].small), __uint_as_float(sp[1][e0].small),
                      __uint_as_float(sp[0][e0 + 1].small), __uint_as_float(sp[1][e0 + 1].small));
    }
  }
}

// tf32x3::warp_mma_k16<1, 2> at 16-deep step s of chunk c for row block rb,
// with A's fragments from ef (stage_e_fragments): the same fragments, the
// same MMAs in the same order, so the same bits.
__device__ __forceinline__ void warp_mma_k16_ef(float (&acc)[1][2][4], const float* ef, int c,
                                                int rb, int s, const float* B, int ldb, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int k = 16 * s + 4 * (lane & 3);
  uint32_t fa[4][4];  // [part][fragment register]
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint4 v = *(reinterpret_cast<const uint4*>(ef + e_fragment(c, rb, s, p)) + lane);
    fa[p][0] = v.x, fa[p][1] = v.y, fa[p][2] = v.z, fa[p][3] = v.w;
  }
  uint32_t bb[2][4], bs[2][4];  // [n-tile][depth]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(B + tf32x3::at(n0 + 8 * j + g, k, ldb));
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const tf32x3::Split sp = tf32x3::split(x[e]);
      bb[j][e] = sp.big, bs[j][e] = sp.small;
    }
  }
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int e0 = 2 * st;
    uint32_t fbb[2][2], fbs[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      fbb[j][0] = bb[j][e0], fbb[j][1] = bb[j][e0 + 1];
      fbs[j][0] = bs[j][e0], fbs[j][1] = bs[j][e0 + 1];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) tf32x3::mma(acc[0][j], fa[2 + st], fbb[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j) tf32x3::mma(acc[0][j], fa[st], fbs[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j) tf32x3::mma(acc[0][j], fa[st], fbb[j]);
  }
}

// The cosine_dots sum of one 16 x 16 quadrant (0..3, the quadrant that
// cosine_dots gives warps quad and quad + 4) of chunk c (0, 1) of the
// slice, over the chunk's whole depth: each half's 16-deep 3xTF32 steps
// added from 0 in order, then the two halves (cosine_dots' sum, one warp
// doing both halves, so no exchange).  dot[j] holds what cosine_dots gives
// thread 32 (4 j + quad) + lane of the tile.
__device__ __forceinline__ void quadrant_dots(float (&dot)[2][4], const float* ef,
                                              const float* ws, int c, int quad) {
  const float* wc = ws + c * TC * KC;
  float half[2][2][4];
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    float sum[1][2][4] = {};
#pragma unroll 2
    for (int s = 4 * kh; s < 4 * kh + 4; ++s) {
      float chunk[1][2][4] = {};
      warp_mma_k16_ef(chunk, ef, c, quad >> 1, s, wc, KC, 16 * (quad & 1));
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[0][j][q] = __fadd_rn(sum[0][j][q], chunk[0][j][q]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) half[kh][j][q] = sum[0][j][q];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) dot[j][q] = __fadd_rn(half[0][j][q], half[1][j][q]);
}

// slice_partials' partials, formed by other warps: warp w takes chunk
// k0 + w / 4 of the slice (if it lies below n_ch) and in it quadrant w % 4
// (quadrant_dots).  It publishes what cluster_dot reads: the four floats of
// thread 32 (4 j + q) + lane (the thread that cosine_dots gives n-tile j of
// quadrant q) at pub + c * THREADS * 4 + 4 * thread.
__device__ __forceinline__ void chunk_partials(const float* ef, const float* ws, int k0,
                                               int n_ch, float* pub) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = warp >> 2;
  const int quad = warp & 3;
  if (k0 + c >= n_ch) return;
  float dot[2][4];
  quadrant_dots(dot, ef, ws, c, quad);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    *reinterpret_cast<float4*>(pub + c * THREADS * 4 + 4 * ((4 * j + quad) * 32 + lane)) =
        make_float4(dot[j][0], dot[j][1], dot[j][2], dot[j][3]);
}

// stage_slice with the copies' addresses fixed outside their loop: with
// 16-byte copies every thread's rows keep one swizzle (they step by 8).
template <int VEC>
__device__ __forceinline__ void stage_slice_fast(float* dst, const float* __restrict__ x,
                                                 int row0, int n_rows, int D, int slice) {
  constexpr int PER_ROW = KC / VEC;          // threads per row
  constexpr int R_STEP = THREADS / PER_ROW;  // rows per pass
  const int col = threadIdx.x % PER_ROW * VEC;
  const int r = threadIdx.x / PER_ROW;
  const float* src = x + (size_t)(row0 + r) * D + slice * SW + col;
  const uint32_t d = tf32x3::smem_addr(dst + r * KC);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int left = D - slice * SW - c * KC - col;  // this thread's columns left in the row
    const int bytes = left <= 0 ? 0 : VEC == 4 ? 4 * min(4, left) : 4;
#pragma unroll
    for (int i = 0; i < TB / R_STEP; ++i) {
      const int rr = r + R_STEP * i;
      const bool ok = bytes > 0 && row0 + rr < n_rows;
      const uint32_t dd =
          d + 4u * (c * TB * KC + R_STEP * i * KC + (col ^ tf32x3::swz(rr)));
      const float* s = src + (size_t)R_STEP * i * D + c * KC;
      if (VEC == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dd),
                     "l"(ok ? s : x), "r"(ok ? bytes : 0));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dd),
                     "l"(ok ? s : x), "r"(ok ? bytes : 0));
    }
  }
}

// slice_sq with tile_sq's arithmetic (the same fmaf order, the same
// butterfly): logical column j + 8 (4 a + b) of row r lies at
// (j ^ (s & 4)) + 32 a + 8 (b ^ (s >> 3 & 3)), s = swz(r), so the 16 loads
// of a chunk take four base addresses and immediate offsets.
__device__ __forceinline__ void slice_sq_fast(const float* ws, int k0, int n_ch, float* sq) {
  const int r = threadIdx.x >> 3;
  const int j = threadIdx.x & 7;
  const int s = tf32x3::swz(r);
  const float* row = ws + r * KC + (j ^ (s & 4));
  const int k = s >> 3 & 3;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (k0 + c >= n_ch) break;
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float v = row[c * TC * KC + 32 * a + 8 * (b ^ k)];
        acc = fmaf(v, v, acc);
      }
    acc += __shfl_xor_sync(FULL, acc, 4);
    acc += __shfl_xor_sync(FULL, acc, 2);
    acc += __shfl_xor_sync(FULL, acc, 1);
    if (j == 0) sq[c * TC + r] = acc;
  }
}

// fwd_cluster_kernel's shared memory: the e slice in fragment order (both
// TF32 parts), one W tile's slice (two chunks; first the raw e slice, at
// the end the row states), two buffers of two chunks' published cosine
// partials, two buffers of two chunks' published sums of squares, and
// rinv.  115,328 bytes: two blocks an SM (each SM has 228 KB, and each
// block 1 KB of it is the system's).
__host__ __device__ inline int cluster_smem_floats() {
  return 2 * 2 * TB * KC + 2 * TC * KC + 2 * 2 * THREADS * 4 + 2 * 2 * TC + TC;
}

// Past CPORT (SHARE), each block folds its share of every tile
// (flash_aam_cosine.cuh: logit_share), one slot a thread: the online state
// of the slot's row (row0 + slot_row) over the tiles, with the row's label
// and target logit (a row past B gets label -1 and its state is never
// written; a thread that holds no slot keeps the empty state).
struct ShareState {
  int lab;
  float ztr;
  RowState st;
};

__device__ __forceinline__ ShareState share_state(const Share& sh,
                                                  const int* __restrict__ labels,
                                                  const float* __restrict__ zt, int B,
                                                  int row0) {
  const int r = row0 + slot_row(share_slot(sh) % (TB * TC));
  return {r < B ? labels[r] : -1, r < B ? zt[r] : 0.0f, {NEG_INF, 0.0f, 0.0f, 0.0f}};
}

// Fold the thread's slot of class tile col0.. (its dot from
// cluster_logit_dot, 1/||w|| from rinv) into its row's state, as fold_tile
// folds.
__device__ __forceinline__ void fold_share(ShareState& sx, float dot, const Share& sh,
                                           const float* rinv, int col0, int C,
                                           const Margin& mg) {
  const int s = share_slot(sh);
  if (s >= sh.i1) return;
  const int cls = slot_col(s);
  const int c = col0 + cls;
  if (c >= C) return;
  fold_logit(sx.st, dot, rinv[cls], c == sx.lab, sx.ztr, mg);
}

// Merge the block's states of each row of its tile and write partial state
// `idx` of each row, of n_parts: every thread puts its state in xs
// ([THREADS][4] floats), then thread r < TB merges those of the entries of
// row r in share order (a row that no entry of the share holds gets the
// empty state, which adds 0).  An entry is K slots: share entry j of thread
// j is slot K (i0 + j) and the K - 1 after it, all of one row (K = 1: the
// cluster route's slots; K = 2: the passes route's pairs).
template <int K = 1>
__device__ __forceinline__ void write_share_states(const ShareState& sx, const Share& sh,
                                                   float* xs, int row0, int B, int idx,
                                                   int n_parts, float* __restrict__ part) {
  float* o = xs + threadIdx.x * 4;
  o[0] = sx.st.m, o[1] = sx.st.s, o[2] = sx.st.zy, o[3] = sx.st.cnt;
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= TB || row0 + r >= B) return;
  RowState acc = {NEG_INF, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < sh.i1 - sh.i0; ++j) {
    if (slot_row(K * (sh.i0 + j)) != r) continue;
    const float* x = xs + j * 4;
    merge(acc, {x[0], x[1], x[2], x[3]});
  }
  const size_t plane = (size_t)n_parts * B;
  const size_t at = (size_t)idx * B + row0 + r;
  part[at] = acc.m;
  part[plane + at] = acc.s;
  part[2 * plane + at] = acc.zy;
  part[3 * plane + at] = acc.cnt;
}

// DMAX < D <= CMAX: one cluster of n_slices(D) blocks per (batch tile,
// split), consecutive in x, cluster u on batch tile u % n_rt of split
// u / n_rt, block `slice` (its rank) on the depths [SW slice, SW slice + SW)
// (see the top of this file).  SHARE (clusters past the portable size):
// every block folds its share of each tile, not the owner the whole tile.
template <int VEC, bool SHARE>
__global__ void __launch_bounds__(THREADS, 2)
fwd_cluster_kernel(const float* __restrict__ e, const float* __restrict__ w,
                   const int* __restrict__ labels, const float* __restrict__ zt, int B, int C,
                   int D, int tiles_per_split, Margin mg, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* ef = smem;                                  // the e slice, e_fragment's order
  float* wt = ef + 2 * 2 * TB * KC;                  // W tile t's slice
  float* pub = wt + 2 * TC * KC;                     // [2][2][THREADS][4], published
  float* sqp = pub + 2 * 2 * THREADS * 4;            // [2][2][TC], published
  float* rinv = sqp + 2 * 2 * TC;                    // [TC]

  const int n_s = n_slices(D);
  const int slice = cluster_rank();
  const int unit = blockIdx.x / n_s;
  const int n_rt = (B + TB - 1) / TB;
  const int row0 = unit % n_rt * TB;
  const int split = unit / n_rt;
  const int n_tiles = (C + TC - 1) / TC;
  const int n_splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  const int n_ch = n_chunks(D);
  const int k0 = 2 * slice;
  const int cls0 = 8 * cosine_ntile(threadIdx.x >> 5) + 2 * (threadIdx.x & 3);
  const Share sh = SHARE ? logit_share(slice, n_s) : Share{0, 0};

  stage_slice_fast<VEC>(wt, e, row0, B, D, slice);  // the raw e slice, through wt
  tf32x3::commit();
  Rows rd;
  ShareState sx;
  if constexpr (SHARE) sx = share_state(sh, labels, zt, B, row0);
  else rd = row_data(labels, zt, B, row0);
  tf32x3::wait_pending<0>();
  __syncthreads();
  stage_e_fragments(wt, ef);
  __syncthreads();  // every warp is done with the raw e slice
  stage_slice_fast<VEC>(wt, w, tile_lo * TC, C, D, slice);
  tf32x3::commit();

  for (int t = tile_lo; t < tile_hi; ++t) {
    const int cur = (t - tile_lo) & 1;
    tf32x3::wait_pending<0>();
    __syncthreads();  // tile t has landed, and the last reader of rinv is done with it
    // buffer cur is free: tile t - 2's readers read it before they arrived
    // at tile t - 1's barrier, which this block has passed
    float* pb = pub + cur * 2 * THREADS * 4;
    float* sb = sqp + cur * 2 * TC;
    chunk_partials(ef, wt, k0, n_ch, pb);
    slice_sq_fast(wt, k0, n_ch, sb);
    if (t + 1 < tile_hi) {
      __syncthreads();  // every warp is done with tile t's slice
      stage_slice_fast<VEC>(wt, w, (t + 1) * TC, C, D, slice);
      tf32x3::commit();
    }
    cluster_arrive();
    cluster_wait();
    if constexpr (SHARE) {
      cluster_rnorms_tail(sb, n_ch, rinv);
      const float dot = cluster_logit_dot(pb, sh, n_ch);
      __syncthreads();  // rinv
      fold_share(sx, dot, sh, rinv, t * TC, C, mg);
    } else if ((t - tile_lo) % n_s == slice) {
      cluster_rnorms(sb, n_ch, rinv);
      float dot[4];
      cluster_dot(dot, pb, n_ch);
      __syncthreads();  // rinv
      const float ri[2] = {rinv[cls0], rinv[cls0 + 1]};
      fold_tile(rd, dot, ri, t * TC + cls0, C, mg);
    }
  }
  cluster_arrive();  // this block reads no peer's shared memory any more
  // the last tile took no copy: wt is free for the row states
  if constexpr (SHARE)
    write_share_states(sx, sh, wt, row0, B, split * n_s + slice, n_splits * n_s, part);
  else
    write_states(rd, wt, row0, B, split * n_s + slice, n_splits * n_s, part);
  cluster_wait();  // no block leaves while a peer may read its shared memory
}

// ---- the passes route (D > CMAX) ----
//
// A block of the cluster route's layout (the e slice in fragment order,
// one W buffer, two buffers of published partials) on one slice of each
// depth pass.  What it changes is the wait.  The cluster route meets its
// peers at a whole cluster barrier every tile, each thread releasing its
// writes, and then reads 2 n_s floats a slot from them, one round trip
// after another, while every warp waits.  Here the barrier of a tile is
// split around the next tile's MMAs, one warp releases the block's
// writes, a pair of slots takes one float4 from each peer, all of a pass
// in flight at once, the next W tile is staged by the warps that hold no
// pair meanwhile, and no block forms sums of squares.

constexpr int PAIRS = TB * TC / 2;  // a tile's logits, in pairs of classes of one row

// fwd_passes_kernel's shared memory: the e slice of the pass in fragment
// order (both TF32 parts), one W tile's slice (two chunks; first the raw e
// slice of each pass, at the end the row states) and two buffers of a
// tile's published partials in pair order.  114,688 bytes: two blocks an SM.
__host__ __device__ inline int passes_smem_floats() {
  return 2 * 2 * TB * KC + 2 * TC * KC + 2 * PAIRS * 4;
}

// Block `rank`'s share of a tile's pairs in a cluster of n_c blocks: pairs
// [rank L, rank L + L) below PAIRS, L = ceil(PAIRS / n_c), one a thread
// from thread 0 (at most 57, in warps 0 and 1).  Pair p is slots 2 p and
// 2 p + 1 (slot_row, slot_col): classes 2 m and 2 m + 1 of one row.
__device__ __forceinline__ Share pair_share(int rank, int n_c) {
  const int L = (PAIRS + n_c - 1) / n_c;
  return {rank * L, min(rank * L + L, PAIRS)};
}

// Publish a warp's dots of chunk c of its slice (quadrant_dots) in pair
// order: pair p's four floats at pub + 4 p are chunk 0's two slots, then
// chunk 1's.
__device__ __forceinline__ void publish_pairs(const float (&dot)[2][4], int c, int quad,
                                              float* pub) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* o = pub + 8 * ((4 * j + quad) * 32 + lane) + 2 * c;  // pair 2 (32 (4 j + quad) + lane)
    *reinterpret_cast<float2*>(o) = make_float2(dot[j][0], dot[j][1]);
    *reinterpret_cast<float2*>(o + 4) = make_float2(dot[j][2], dot[j][3]);
  }
}

// Add one pass's partials of pair p onto its running dots d (set by chunk
// 0): the pass's chunks start at k0, and peer b published chunks k0 + 2 b
// and k0 + 2 b + 1 (those below n_ch; nb peers hold any) at pub + 4 p.
// Every read is issued before the first add, so their round trips overlap
// while the adds keep chunk order.  Called between the cluster barrier
// that follows the peers' publish_pairs and the next one.
__device__ __forceinline__ void gather_pair(float (&d)[2], const float* pub, int p, int k0,
                                            int n_ch, int nb) {
  float4 v[CLUSTER_MAX];
#pragma unroll
  for (int b = 0; b < CLUSTER_MAX; ++b) {
    if (b == nb) break;
    v[b] = cluster_ld4(pub + 4 * p, b);
  }
#pragma unroll
  for (int b = 0; b < CLUSTER_MAX; ++b) {
    if (b == nb) break;
    const int k = k0 + 2 * b;
    d[0] = k ? __fadd_rn(d[0], v[b].x) : v[b].x;
    d[1] = k ? __fadd_rn(d[1], v[b].y) : v[b].y;
    if (k + 1 < n_ch) {
      d[0] = __fadd_rn(d[0], v[b].z);
      d[1] = __fadd_rn(d[1], v[b].w);
    }
  }
}

// stage_slice_fast's copies (the two chunks of slice `slice` of the 32
// rows from row0) on the 128 threads of warps 4..7 alone: during a step
// the other warps add the peers' partials meanwhile.  16-byte copies take
// their addresses
// fixed outside the loop, as stage_slice_fast; 4-byte copies (64 a
// thread) compute each copy's place in turn, which holds fewer registers.
// Commits no group.
template <int VEC>
__device__ __forceinline__ void stage_slice_half(float* dst, const float* __restrict__ x,
                                                 int row0, int n_rows, int D, int slice) {
  constexpr int PER_ROW = KC / VEC;  // copies a row of a chunk
  const int u = threadIdx.x - 128;
  if constexpr (VEC == 4) {
    constexpr int R_STEP = 128 / PER_ROW;  // rows a pass
    const int col = u % PER_ROW * VEC;
    const int r = u / PER_ROW;
    const float* src = x + (size_t)(row0 + r) * D + slice * SW + col;
    const uint32_t d = tf32x3::smem_addr(dst + r * KC);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int left = D - slice * SW - c * KC - col;  // this thread's columns left in the row
      const int bytes = left <= 0 ? 0 : 4 * min(4, left);
#pragma unroll
      for (int i = 0; i < TB / R_STEP; ++i) {
        const int rr = r + R_STEP * i;
        const bool ok = bytes > 0 && row0 + rr < n_rows;
        const uint32_t dd =
            d + 4u * (c * TB * KC + R_STEP * i * KC + (col ^ tf32x3::swz(rr)));
        const float* s = src + (size_t)R_STEP * i * D + c * KC;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dd),
                     "l"(ok ? s : x), "r"(ok ? bytes : 0));
      }
    }
  } else {
#pragma unroll 1
    for (int k = u; k < 2 * TB * PER_ROW; k += 128) {
      const int c = k / (TB * PER_ROW);
      const int r = k / PER_ROW % TB;
      const int col = k % PER_ROW;
      const int d0 = (2 * slice + c) * KC;
      const bool ok = d0 + col < D && row0 + r < n_rows;
      const float* src = x + (size_t)(row0 + r) * D + d0 + col;
      const uint32_t dd = tf32x3::smem_addr(dst + c * TB * KC + tf32x3::at(r, col, KC));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dd),
                   "l"(ok ? src : x), "r"(ok ? 4 : 0));
    }
  }
}

// rinv[c] = the chunk order's 1/||W row c|| for every class, one block per
// TC-class tile (the passes route's norms, as the backward forms them).
template <int VEC>
__global__ void __launch_bounds__(THREADS)
fwd_norms_kernel(const float* __restrict__ w, int C, int D, float* __restrict__ rinv) {
  __shared__ __align__(16) float ws[2 * TC * KC];
  stream_rnorms<VEC>(ws, w, C, D, rinv);
}

// D > CMAX: one cluster of n_c = passes_cluster(D) blocks per (batch tile,
// split), consecutive in x, cluster u on batch tile u % n_rt of split
// u / n_rt; block `rank` takes slice j n_c + rank of depth pass j of
// P = n_passes(D) (see the top of this file).  Its steps go pass by pass,
// tile by tile: step i is tile tile_lo + i % nt of pass i / nt, and its
// partials go to pub buffer i % 2.  The cluster barrier of step i is split:
// a block arrives once it has published step i's partials and waits only
// after forming step i + 1's.  Past the wait it publishes step i + 1's
// partials and warp 7 releases them for the whole block (a __syncthreads,
// then a cluster-scope fence, so every thread may arrive relaxed); the
// threads that hold a pair (warps 0 and 1) add step i's partials of their
// pairs (gather_pair) onto the pairs' running sums, which they keep in
// `run` (TB TC floats a (batch tile, class tile); each thread rereads in
// the next pass only what it wrote) and fold at the last pass (rinv_g:
// fwd_norms_kernel's 1/||w||), while warps 4..7 stage the next W tile (or,
// at a pass's last tile, the next pass's raw e slice).  A
// block rewrites buffer i % 2 at step i only past the wait of step i - 1,
// which its peers pass only after adding step i - 2's partials from it;
// every block ends at a cluster barrier, so none leaves while a peer may
// read its shared memory.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
fwd_passes_kernel(const float* __restrict__ e, const float* __restrict__ w,
                  const int* __restrict__ labels, const float* __restrict__ zt,
                  const float* __restrict__ rinv_g, int B, int C, int D, int n_c, int P,
                  int tiles_per_split, Margin mg, float* __restrict__ run,
                  float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* ef = smem;                  // the e slice of the pass, e_fragment's order
  float* wt = ef + 2 * 2 * TB * KC;  // W tile t's slice
  float* pub = wt + 2 * TC * KC;     // [2][PAIRS][4], published

  const int rank = cluster_rank();
  const int unit = blockIdx.x / n_c;
  const int n_rt = (B + TB - 1) / TB;
  const int bt = unit % n_rt;
  const int row0 = bt * TB;
  const int split = unit / n_rt;
  const int n_tiles = (C + TC - 1) / TC;
  const int n_splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const int tile_lo = split * tiles_per_split;
  const int nt = min(tiles_per_split, n_tiles - tile_lo);
  const int steps = P * nt;
  const int n_ch = n_chunks(D);
  const int c = threadIdx.x >> 7;          // the warp's chunk of the slice
  const int quad = threadIdx.x >> 5 & 3;   // and its quadrant
  const Share sh = pair_share(rank, n_c);
  const int p = sh.i0 + threadIdx.x;       // the thread's pair, if below sh.i1
  const bool holds = p < sh.i1;
  const int prow = row0 + slot_row(2 * p);  // the pair's row, if below B
  const int pcol = slot_col(2 * p);
  RowState st = {NEG_INF, 0.0f, 0.0f, 0.0f};  // its online state

  if (threadIdx.x >= 128 && rank * SW < D) {  // pass 0's raw e slice, through wt
    stage_slice_half<VEC>(wt, e, row0, B, D, rank);
    tf32x3::commit();
  }
  float dot[2][4];
  int j = 0, t = tile_lo;  // step i's pass and tile
  for (int i = 0; i <= steps; ++i) {
    const int slice = j * n_c + rank;
    const bool mine = i < steps && slice * SW < D;  // the slice holds depths (the whole block)
    const bool forms = mine && 2 * slice + c < n_ch;  // and the warp's chunk (the whole warp)
    if (mine) {
      if (t == tile_lo) {  // a new pass: split its e slice, whose raw copy is in wt
        tf32x3::wait_pending<0>();
        __syncthreads();
        stage_e_fragments(wt, ef);
        __syncthreads();  // every warp is done with the raw e slice
        if (threadIdx.x >= 128) {
          stage_slice_half<VEC>(wt, w, t * TC, C, D, slice);
          tf32x3::commit();
        }
      }
      tf32x3::wait_pending<0>();
      __syncthreads();  // tile t has landed
      if (forms) quadrant_dots(dot, ef, wt, c, quad);
      __syncthreads();  // every warp is done with wt (and, at a pass's last tile, with ef)
    }
    if (i > 0) cluster_wait();  // every block's partials of step i - 1
    if (i < steps) {
      if (forms) publish_pairs(dot, c, quad, pub + (i & 1) * PAIRS * 4);
      __syncthreads();  // the block's partials of step i are written
      // one release for the block (cumulative over the __syncthreads)
      if (threadIdx.x >> 5 == 7) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    }
    if (threadIdx.x >= 128 && mine) {  // the next tile's slice, or the next pass's raw e slice
      if (t + 1 < tile_lo + nt) {
        stage_slice_half<VEC>(wt, w, (t + 1) * TC, C, D, slice);
        tf32x3::commit();
      } else if (j + 1 < P && (slice + n_c) * SW < D) {
        stage_slice_half<VEC>(wt, e, row0, B, D, slice + n_c);
        tf32x3::commit();
      }
    }
    if (i > 0 && holds) {  // step i - 1: tile tp of pass jp
      const int jp = t == tile_lo ? j - 1 : j;
      const int tp = t == tile_lo ? tile_lo + nt - 1 : t - 1;
      const bool last = jp + 1 == P;
      float2* rp = reinterpret_cast<float2*>(run) + ((size_t)bt * n_tiles + tp) * PAIRS + p;
      float d[2] = {0.0f, 0.0f}, ri[2] = {0.0f, 0.0f};
      if (jp > 0) {
        const float2 r = *rp;
        d[0] = r.x, d[1] = r.y;
      }
      // at the last pass, the norms and the row's label and target logit
      // (a row past B takes label -1 and its state is never written)
      int lab = -1;
      float ztr = 0.0f;
      if (last) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (tp * TC + pcol + q < C) ri[q] = rinv_g[tp * TC + pcol + q];
        if (prow < B) lab = labels[prow], ztr = zt[prow];
      }
      const int k0 = 2 * n_c * jp;
      gather_pair(d, pub + ((i - 1) & 1) * PAIRS * 4, p, k0, n_ch, min(n_c, (n_ch - k0 + 1) / 2));
      if (!last) {
        *rp = make_float2(d[0], d[1]);
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int cl = tp * TC + pcol + q;
          if (cl < C) fold_logit(st, d[q], ri[q], cl == lab, ztr, mg);
        }
      }
    }
    if (i == steps) break;
    // relaxed: the block's writes were released by warp 7's fence, and a
    // thread's reads of its peers are done once it has added them
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    if (++t == tile_lo + nt) t = tile_lo, ++j;
  }
  cluster_arrive();  // this block reads no peer's shared memory any more
  // the last step took no copy: wt is free for the row states
  write_share_states<2>(ShareState{-1, 0.0f, st}, sh, wt, row0, B, split * n_c + rank,
                        n_splits * n_c, part);
  cluster_wait();  // no block leaves while a peer may read its shared memory
}

// Merge the n_parts partial states of each row (one per split, or one per
// block of each split's cluster), one warp a row: lane l takes the parts l,
// l + 32, ... in order, then a fixed butterfly joins the lanes:
// mx = M = max_i m_i, lse = M + log(sum_i s_i exp(m_i - M)), zy = sum zy_i
// (one part holds the target, the others add 0), cnt = sum cnt_i.  A part
// that saw no class, (m, s) = (NEG_INF, 0), adds exactly 0 to the sum.
__global__ void merge_kernel(const float* __restrict__ part, int n_parts, int B,
                             float* __restrict__ lse, float* __restrict__ zy,
                             float* __restrict__ mx, float* __restrict__ cnt) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= B) return;  // the whole warp
  const size_t plane = (size_t)n_parts * B;
  float M = NEG_INF;
  for (int i = lane; i < n_parts; i += 32) M = fmaxf(M, part[(size_t)i * B + r]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
  float S = 0.0f, Z = 0.0f, K = 0.0f;
  for (int i = lane; i < n_parts; i += 32) {
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

// The routes by depth: 0 fwd_tiles_kernel, 1 fwd_cluster_kernel, 2
// fwd_passes_kernel.
inline int route_of(int D) { return D <= DMAX ? 0 : D <= CMAX ? 1 : 2; }

// The blocks of one unit of work of depth D's route: a cluster of
// n_slices(D) on the cluster route, of passes_cluster(D) on the passes
// route, 1 on the tiles route.
inline int cluster_size(int D) {
  return route_of(D) == 1 ? n_slices(D) : route_of(D) == 2 ? passes_cluster(D) : 1;
}

// The route's kernel for depth D and its dynamic shared memory, with the
// kernel allowed that much (and, on the cluster and passes routes, its
// cluster size).  Every launch and every occupancy query of this
// instantiation calls it first.
template <int VEC>
cudaError_t route(int D, const void** kernel, size_t* smem) {
  if (route_of(D) == 0) {
    const int DP = padded_depth(D);
    *smem = sizeof(float) * (TB * DP + 2 * TC * DP + 2 * TC + WARPS * 128);
    *kernel = reinterpret_cast<const void*>(fwd_tiles_kernel<VEC>);
  } else {
    if (route_of(D) == 1) {
      *smem = sizeof(float) * cluster_smem_floats();
      *kernel = D > CPORT ? reinterpret_cast<const void*>(fwd_cluster_kernel<VEC, true>)
                          : reinterpret_cast<const void*>(fwd_cluster_kernel<VEC, false>);
    } else {
      *smem = sizeof(float) * passes_smem_floats();
      *kernel = reinterpret_cast<const void*>(fwd_passes_kernel<VEC>);
    }
    // two such blocks need the SM's whole 228 KB as shared memory
    cudaError_t err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = allow_cluster(*kernel, D);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// The floats of scratch that a launch needs past the partial states: on
// the passes route the pairs' running sums (TB TC floats a (batch tile,
// class tile)) and then the norms (C).
inline size_t scratch_floats(int B, int C, int D) {
  if (route_of(D) != 2) return 0;
  return (size_t)((B + TB - 1) / TB) * ((C + TC - 1) / TC) * TB * TC + C;
}

template <int VEC>
cudaError_t launch(const float* e, const float* w, const int* labels, const float* zt, int B,
                   int C, int D, int tiles_per_split, int n_splits, const Margin& mg,
                   float* part, float* lse, float* zy, float* mx, float* cnt,
                   cudaStream_t st) {
  static_assert(WARPS * 128 >= WARPS * 16 * 4, "xch holds the warps' row states");
  const int n_rt = (B + TB - 1) / TB;
  const dim3 grid(n_rt, n_splits);
  const void* kernel;
  size_t smem;
  cudaError_t err = route<VEC>(D, &kernel, &smem);
  if (err != cudaSuccess) return err;
  // a refused cluster launch returns its error: no other route stands in
  cudaLaunchAttribute attr;
  if (route_of(D) == 0) {
    fwd_tiles_kernel<VEC><<<grid, THREADS, smem, st>>>(e, w, labels, zt, B, C, D,
                                                       padded_depth(D), tiles_per_split, mg,
                                                       part);
  } else if (route_of(D) == 1) {
    const cudaLaunchConfig_t cfg = cluster_config(D, n_rt * n_splits, smem, st, &attr);
    err = D > CPORT ? cudaLaunchKernelEx(&cfg, fwd_cluster_kernel<VEC, true>, e, w, labels, zt,
                                         B, C, D, tiles_per_split, mg, part)
                    : cudaLaunchKernelEx(&cfg, fwd_cluster_kernel<VEC, false>, e, w, labels, zt,
                                         B, C, D, tiles_per_split, mg, part);
    if (err != cudaSuccess) return err;
  } else {
    // the running sums and then the norms, past the partial states
    float* run = part + (size_t)4 * n_splits * cluster_size(D) * B;
    float* rinv = run + scratch_floats(B, C, D) - C;
    fwd_norms_kernel<VEC><<<(C + TC - 1) / TC, THREADS, 0, st>>>(w, C, D, rinv);
    const cudaLaunchConfig_t cfg =
        cluster_config_of(passes_cluster(D), n_rt * n_splits, smem, st, &attr);
    err = cudaLaunchKernelEx(&cfg, fwd_passes_kernel<VEC>, e, w, labels, zt,
                             static_cast<const float*>(rinv), B, C, D, passes_cluster(D),
                             n_passes(D), tiles_per_split, mg, run, part);
    if (err != cudaSuccess) return err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<(B + 7) / 8, 256, 0, st>>>(part, n_splits * cluster_size(D), B, lse, zy, mx,
                                            cnt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_aam_fwd_block_rows() { return TB; }
int flash_aam_fwd_block_classes() { return TC; }

// The route that depth D takes: 0 fwd_tiles_kernel, 1 fwd_cluster_kernel,
// 2 fwd_passes_kernel.
int flash_aam_fwd_route(int D) { return route_of(D); }

// The blocks of one cluster of depth D's route: n_slices(D) on the cluster
// route, passes_cluster(D) on the passes route, 1 on the tiles route.  Each
// block writes its own partial states.
int flash_aam_fwd_cluster_size(int D) { return cluster_size(D); }

// The depth passes of the passes route for depth D, 1 on the others.
int flash_aam_fwd_passes(int D) { return route_of(D) == 2 ? n_passes(D) : 1; }

// The floats of scratch that flash_aam_fwd needs past the partial states:
// on the passes route the running sums and the norms (scratch_floats).
long long flash_aam_fwd_scratch(int B, int C, int D) {
  return (long long)scratch_floats(B, C, D);
}

// The clusters of the cluster or passes route for depth D that the current
// device holds at once (cudaOccupancyMaxActiveClusters with the route's
// shared memory; the 16-byte-copy kernel, whose 4-byte twin has the same
// shared memory and register cap), or -1 on the tiles route or on a CUDA
// error.
int flash_aam_fwd_clusters(int D) {
  const void* kernel;
  size_t smem;
  int clusters = 0;
  cudaLaunchAttribute attr;
  if (route_of(D) == 0 || route<4>(D, &kernel, &smem) != cudaSuccess) return -1;
  const cudaLaunchConfig_t cfg = cluster_config_of(cluster_size(D), 1, smem, nullptr, &attr);
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// The blocks of depth D's route that one SM of the current device holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the route's
// shared memory; the 16-byte-copy kernel), or -1 on a CUDA error.
int flash_aam_fwd_blocks_per_sm(int D) {
  const void* kernel;
  size_t smem;
  int blocks = 0;
  if (D <= 0 || route<4>(D, &kernel, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// e (B, D) f32, w (C, D) f32, labels (B,) i32, zt (B,) f32, all contiguous on
// the card; part is scratch of 4 * n_splits * flash_aam_fwd_cluster_size(D)
// * B floats with n_splits = ceil(ceil(C / TC) / tiles_per_split), and
// flash_aam_fwd_scratch(B, C, D) more past CMAX.  Launches on `stream` and
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
