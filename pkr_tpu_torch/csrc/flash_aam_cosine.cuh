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
//
// Deeper rows (D > DMAX) do not fit the resident tiles.  Their cosines
// follow the chunk order, which defines their bits on every deep route of
// both kernels: the depth is cut into n_chunks(D) chunks of KC, the last one
// padded with zeros; chunk k's dot is cosine_dots over that chunk alone, and
//   e . w   = the chunks' dots, added with __fadd_rn in chunk order (the
//             first chunk's dot is the start, not 0 + it),
//   1/||w|| = __frsqrt_rn(max(sum w^2, 1e-24)), sum w^2 the chunks' tile_sq
//             added with __fadd_rn in the same order.
// Any route may form a chunk's dot and sum of squares wherever it likes, as
// long as it adds them in that order.  Up to WMAX deep, the backward keeps
// every chunk of its tiles resident (stage_chunks, resident_rnorms,
// resident_cosine).  Up to CMAX deep, both kernels split the depth over a
// thread-block cluster of n_slices(D) blocks, SW-wide slices of two chunks
// each (stage_slice): every block publishes its chunks' dots and tile_sq
// unsummed (slice_partials, slice_sq), and a block that needs the cosine
// tile adds all the cluster's in chunk order through distributed shared
// memory (cluster_dot, cluster_rnorms; past CPORT, each block its share of
// the tile: cluster_logit_dot, cluster_rnorms_tail).  A block's shared
// memory does not depend on the cluster's size, so the same blocks run in
// clusters of up to CLUSTER_MAX (16): past the portable size (8, to
// CPORT = 2048 deep) the kernel must be allowed a non-portable cluster
// (allow_cluster).  Beyond CMAX both kernels' clusters walk the depth in
// passes of one slice a block (passes_cluster, n_passes), each block's
// share of a tile's cosines carried across them as one running sum in
// chunk order, and 1/||w|| comes from a kernel of its own first
// (stream_rnorms).
#pragma once

#include "flash_aam_common.cuh"
#include "mma_tf32x3.cuh"

namespace flash_aam {

constexpr int TB = 32;          // batch rows per tile
constexpr int TC = 32;          // classes per tile
constexpr int DMAX = 256;       // largest depth of the resident tiles
constexpr int KC = 128;         // depth chunk of the chunk order (D > DMAX)
constexpr int WMAX = 512;       // deepest rows whose chunks stay resident
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

__host__ __device__ inline int n_chunks(int D) { return (D + KC - 1) / KC; }

// The sum of squares of row threadIdx.x / 8 of a staged TC-row tile, in the
// 8 threads of that row: each sums every 8th square in f32, then a fixed
// butterfly adds them.
__device__ __forceinline__ float tile_sq(const float* ws, int ld) {
  const int r = threadIdx.x >> 3;
  float sq = 0.0f;
  for (int c = threadIdx.x & 7; c < ld; c += 8) {
    const float v = ws[tf32x3::at(r, c, ld)];
    sq = fmaf(v, v, sq);
  }
  sq += __shfl_xor_sync(FULL, sq, 4);
  sq += __shfl_xor_sync(FULL, sq, 2);
  sq += __shfl_xor_sync(FULL, sq, 1);
  return sq;
}

// rinv[c] = 1 / ||W row c|| of a staged TC-row tile, ||w|| =
// sqrt(max(sum w^2, 1e-24)) with sum w^2 from tile_sq, the reciprocal square
// root rounded once (__frsqrt_rn).  Other threads see it after the next
// __syncthreads.
__device__ __forceinline__ void tile_rnorms(const float* ws, int ld, float* rinv) {
  const float sq = tile_sq(ws, ld);
  if ((threadIdx.x & 7) == 0) rinv[threadIdx.x >> 3] = __frsqrt_rn(fmaxf(sq, 1e-24f));
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

// Stage the 32 rows [row0, row0 + 32) of x (n_rows rows of D floats) at full
// depth into dst as n_chunks(D) resident chunks: chunk k is the swizzled
// [32][KC] tile dst + k * 32 * KC (zeros past D and past n_rows).  Commits
// no group.
template <int VEC>
__device__ __forceinline__ void stage_chunks(float* dst, const float* __restrict__ x,
                                             int row0, int n_rows, int D) {
  static_assert(TB == TC, "one chunk size for both operands");
  for (int k = 0; k < n_chunks(D); ++k)
    tf32x3::stage_rows<VEC>(dst + k * TB * KC, KC, x + k * KC, D, row0, TB, n_rows, D - k * KC);
}

// The chunk order's 1/||w|| from a resident TC-row tile of n_ch chunks.
// Other threads see it after the next __syncthreads.
__device__ __forceinline__ void resident_rnorms(const float* ws, int n_ch, float* rinv) {
  float sq = tile_sq(ws, KC);
  for (int k = 1; k < n_ch; ++k) sq = __fadd_rn(sq, tile_sq(ws + k * TC * KC, KC));
  if ((threadIdx.x & 7) == 0) rinv[threadIdx.x >> 3] = __frsqrt_rn(fmaxf(sq, 1e-24f));
}

// The chunk order's dot from resident tiles es and ws of n_ch chunks.  The
// chunks take the two exchange buffers xch and xch + WARPS * 128 in turn,
// so no block-wide barrier sits between them: a warp reaches chunk k + 2's
// writes only past chunk k + 1's pair barrier, which its partner reaches
// only after reading chunk k's.  The caller syncs between its last reads
// of xch and the next call.
__device__ __forceinline__ void resident_cosine(float (&dot)[4], const float* es,
                                                const float* ws, int n_ch, float* xch) {
  for (int k = 0; k < n_ch; ++k) {
    float part[4];
    cosine_dots(part, es + k * TB * KC, ws + k * TC * KC, KC, xch + (k & 1) * WARPS * 128);
#pragma unroll
    for (int q = 0; q < 4; ++q) dot[q] = k ? __fadd_rn(dot[q], part[q]) : part[q];
  }
}

// ---- thread-block clusters (WMAX < D <= CMAX) ----

constexpr int SW = 2 * KC;                  // the depth of one block's slice
constexpr int CLUSTER_PORTABLE = 8;         // the cluster size every card launches
constexpr int CLUSTER_MAX = 16;             // Hopper's largest, non-portable, cluster
constexpr int CPORT = CLUSTER_PORTABLE * SW;  // 2048: the deepest portable cluster
constexpr int CMAX = CLUSTER_MAX * SW;        // 4096: the cluster routes' deepest rows

__host__ __device__ inline int n_slices(int D) { return (D + SW - 1) / SW; }

// The launch configuration of `clusters` clusters of n blocks, consecutive
// in x; attr must outlive its use.
inline cudaLaunchConfig_t cluster_config_of(int n, int clusters, size_t smem, cudaStream_t st,
                                            cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * n);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The same for clusters of n_slices(D) blocks (the cluster routes).
inline cudaLaunchConfig_t cluster_config(int D, int clusters, size_t smem, cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
  return cluster_config_of(n_slices(D), clusters, smem, st, attr);
}

// Allow `kernel` (one instantiation of a cluster route's kernel) the
// clusters of depth D.  Past CPORT they are larger than the portable size:
// both a launch and cudaOccupancyMaxActiveClusters refuse such a cluster
// unless the kernel has cudaFuncAttributeNonPortableClusterSizeAllowed, so
// the route sets it before either.  The error, if any, is the caller's to
// return: no other route stands in.
inline cudaError_t allow_cluster(const void* kernel, int D) {
  if (D <= CPORT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The split barrier of the whole cluster: every thread of every block
// arrives (its shared memory writes released to the cluster), then waits
// (acquiring its peers').  Work between the two overlaps the peers' arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The generic address of p's counterpart in the shared memory of the
// cluster's block `rank` (distributed shared memory).
template <typename T>
__device__ __forceinline__ const T* cluster_map(const T* p, int rank) {
  unsigned long long out;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(reinterpret_cast<unsigned long long>(p)),
      "r"(rank));
  return reinterpret_cast<const T*>(out);
}

// Stage the depths [SW slice, SW slice + SW) of the 32 rows [row0, row0 + 32)
// of x as two resident chunks (stage_chunks' layout: chunks 2 slice and
// 2 slice + 1), zeros past D and past n_rows.  Commits no group.
template <int VEC>
__device__ __forceinline__ void stage_slice(float* dst, const float* __restrict__ x, int row0,
                                            int n_rows, int D, int slice) {
  static_assert(TB == TC, "one chunk size for both operands");
  for (int c = 0; c < 2; ++c) {
    const int d0 = (2 * slice + c) * KC;
    // a chunk that starts at or past D is all zeros: no byte is read
    tf32x3::stage_rows<VEC>(dst + c * TB * KC, KC, x + (d0 < D ? d0 : 0), D, row0, TB, n_rows,
                            D - d0);
  }
}

// The cosine_dots of the slice's chunks k0 and k0 + 1 that lie below n_ch,
// from resident two-chunk tiles es and ws, each published unsummed: this
// thread's four floats of chunk k0 + c at pub + c * THREADS * 4 +
// 4 * threadIdx.x.  The chunks take the exchange buffers xch and
// xch + WARPS * 128 in turn, as in resident_cosine; the caller syncs
// between its last reads of xch and the next call.
__device__ __forceinline__ void slice_partials(const float* es, const float* ws, int k0,
                                               int n_ch, float* xch, float* pub) {
  for (int c = 0; c < 2 && k0 + c < n_ch; ++c) {
    float part[4];
    cosine_dots(part, es + c * TB * KC, ws + c * TC * KC, KC, xch + c * WARPS * 128);
    *reinterpret_cast<float4*>(pub + c * THREADS * 4 + 4 * threadIdx.x) =
        make_float4(part[0], part[1], part[2], part[3]);
  }
}

// The tile_sq of the slice's chunks k0 and k0 + 1 below n_ch of a resident
// two-chunk TC-row tile, published at sq[c * TC + row].
__device__ __forceinline__ void slice_sq(const float* ws, int k0, int n_ch, float* sq) {
  for (int c = 0; c < 2 && k0 + c < n_ch; ++c) {
    const float s = tile_sq(ws + c * TC * KC, KC);
    if ((threadIdx.x & 7) == 0) sq[c * TC + (threadIdx.x >> 3)] = s;
  }
}

// The chunk order's dot from the partials the cluster published
// (slice_partials): chunk k's lies in block k / 2's pub, added with
// __fadd_rn in chunk order.  Called between a cluster barrier that follows
// every block's slice_partials and the next one.
__device__ __forceinline__ void cluster_dot(float (&dot)[4], const float* pub, int n_ch) {
  const float4* mine = reinterpret_cast<const float4*>(pub) + threadIdx.x;
  for (int k = 0; k < n_ch; ++k) {
    const float4 v = *cluster_map(mine + (k & 1) * THREADS, k >> 1);
    const float p[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) dot[q] = k ? __fadd_rn(dot[q], p[q]) : p[q];
  }
}

// The chunk order's 1/||w|| from the sums of squares the cluster published
// (slice_sq), added in chunk order; threads [0, TC) write rinv, which other
// threads see after the next __syncthreads.
__device__ __forceinline__ void cluster_rnorms(const float* sq, int n_ch, float* rinv) {
  if ((int)threadIdx.x >= TC) return;
  float s = 0.0f;
  for (int k = 0; k < n_ch; ++k) {
    const float v = *cluster_map(sq + (k & 1) * TC + threadIdx.x, k >> 1);
    s = k ? __fadd_rn(s, v) : v;
  }
  rinv[threadIdx.x] = __frsqrt_rn(fmaxf(s, 1e-24f));
}

// ---- past the portable size: a tile's cosines shared out ----
//
// Up to CLUSTER_PORTABLE blocks, every block (or, in the forward, the
// tile's owner block) forms the whole cosine tile from all n_ch partials
// (cluster_dot), reading 2 n_s float4 a thread a tile.  Past it that
// exchange sets the pace (its bytes grow with n_s), so each block forms
// only its share of the tile: the logits of the published slots s in
// [i0, i1), i0 = slice L, L = ceil(TB TC / n_s) (at most SHARE_MAX, one
// slot a thread), a chunk's partials lying in cosine_dots' layout (slot
// 4 (32 w + lane) + 2 h + q holds thread 32 w + lane's dot[2 h + q];
// slot_row, slot_col), so that a warp reads 128 contiguous bytes of a
// peer.  Each cosine adds its n_ch partials, one float from each chunk's
// block, in chunk order (cluster_logit_dot), XB reads at a time (fewer in
// the backward, whose blocks also hold their accumulators): a block
// reads TB TC n_ch / n_s floats a tile, not TB TC n_ch.  The last warp,
// which holds no slot, forms the norms meanwhile (cluster_rnorms_tail).
constexpr int XB = 8;
constexpr int SHARE_MAX = (TB * TC + CLUSTER_PORTABLE) / (CLUSTER_PORTABLE + 1);

static_assert(SHARE_MAX <= THREADS - 32, "one slot a thread, the last warp free");

// The float at p's counterpart in the shared memory of the cluster's block
// `rank`, read through its 32-bit shared::cluster address (cluster_map's
// generic address takes two registers, and a share keeps XB reads in
// flight).
__device__ __forceinline__ float cluster_ld(const float* p, int rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(tf32x3::smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// Hand add(k, v) the floats ld(k), k = 0 .. n - 1, in order, each read
// from a peer (cluster_ld) N at a time: each group's reads are all issued
// before its first add, so their latencies overlap while the adds keep
// their order.
template <int N, typename Ld, typename Add>
__device__ __forceinline__ void cluster_gather(int n, Ld ld, Add add) {
  for (int k0 = 0; k0 < n; k0 += N) {
    float v[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (k0 + i < n) v[i] = ld(k0 + i);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (k0 + i < n) add(k0 + i, v[i]);
  }
}

struct Share {
  int i0, i1;
};

// Block `slice`'s share for a cluster of n_s > CLUSTER_PORTABLE blocks.
__device__ __forceinline__ Share logit_share(int slice, int n_s) {
  const int L = (TB * TC + n_s - 1) / n_s;
  return {slice * L, min(slice * L + L, TB * TC)};
}

// The thread's slot of share sh: past i1 for a thread that holds none.
__device__ __forceinline__ int share_slot(const Share& sh) { return sh.i0 + (int)threadIdx.x; }

// The tile row and class of published slot s < TB TC (cosine_dots' layout).
__device__ __forceinline__ int slot_row(int s) {
  const int t = s >> 2;
  return 16 * ((t >> 5 & 3) >> 1) + ((t & 31) >> 2) + 8 * (s >> 1 & 1);
}

__device__ __forceinline__ int slot_col(int s) {
  const int t = s >> 2;
  return 8 * cosine_ntile(t >> 5) + 2 * (t & 3) + (s & 1);
}

// The chunk order's dot of the thread's slot of share sh from the partials
// the cluster published (slice_partials: chunk k's in block k / 2's pub,
// at (k % 2) THREADS 4 + s), added with __fadd_rn in chunk order; 0 for a
// thread that holds no slot; N reads in flight.  Called between the
// cluster barrier that follows every block's partials and the next one.
template <int N = XB>
__device__ __forceinline__ float cluster_logit_dot(const float* pub, const Share& sh, int n_ch) {
  const int s = share_slot(sh);
  float dot = 0.0f;
  if (s >= sh.i1) return dot;
  cluster_gather<N>(
      n_ch, [&](int k) { return cluster_ld(pub + (k & 1) * THREADS * 4 + s, k >> 1); },
      [&](int k, float v) { dot = k ? __fadd_rn(dot, v) : v; });
  return dot;
}

// cluster_rnorms on the last warp (lane c writes rinv[c]), which holds no
// slot of a share, N reads in flight; other threads see rinv after the
// next __syncthreads.
template <int N = XB>
__device__ __forceinline__ void cluster_rnorms_tail(const float* sq, int n_ch, float* rinv) {
  const int c = (int)threadIdx.x - (THREADS - TC);
  if (c < 0) return;
  float s = 0.0f;
  cluster_gather<N>(
      n_ch, [&](int k) { return cluster_ld(sq + (k & 1) * TC + c, k >> 1); },
      [&](int k, float v) { s = k ? __fadd_rn(s, v) : v; });
  rinv[c] = __frsqrt_rn(fmaxf(s, 1e-24f));
}

// ---- past CMAX: the depth in passes ----
//
// A cluster cannot exceed CLUSTER_MAX blocks, so past CMAX a cluster of
// n_c = passes_cluster(D) blocks walks the depth in n_passes(D) passes of
// n_c slices: in pass j block r holds slice j n_c + r, and the cluster the
// chunks [2 n_c j, 2 n_c j + 2 n_c).  Each block publishes its slice's
// partials unsummed and, past a cluster barrier, adds the partials
// published since the last one onto the running sum of its share's slots,
// which it carries from pass to pass: the passes go in depth order, so the
// sum adds every chunk in chunk order (flash_aam_bwd.cu: bwd_passes_kernel;
// flash_aam_fwd.cu: fwd_passes_kernel).  The fewest passes (CLUSTER_MAX
// slices each), then the fewest blocks that still cover the depth in that
// many passes: every pass but the last is full.  n_c > 8 at every D > CMAX,
// so these clusters share out each tile as the cluster routes past CPORT
// do.  1/||w|| comes from stream_rnorms, in a kernel launched first.
__host__ __device__ inline int passes_cluster(int D) {
  const int n_s = n_slices(D);
  const int p = (n_s + CLUSTER_MAX - 1) / CLUSTER_MAX;
  return (n_s + p - 1) / p;
}

__host__ __device__ inline int n_passes(int D) {
  return (n_slices(D) + passes_cluster(D) - 1) / passes_cluster(D);
}

// The four floats at p's counterpart in the shared memory of the cluster's
// block `rank` (16-byte aligned), as cluster_ld reads one.
__device__ __forceinline__ float4 cluster_ld4(const float* p, int rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(tf32x3::smem_addr(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// rinv[c] = the chunk order's 1/||W row c|| for the TC classes of class
// tile blockIdx.x (those below C), streaming its chunks through the two
// halves of ws (2 x TC x KC floats of shared memory), chunk k + 1's copy in
// flight while chunk k's squares are summed: the body of both kernels'
// norms kernels on their passes routes (bwd_norms_kernel,
// fwd_norms_kernel).
template <int VEC>
__device__ __forceinline__ void stream_rnorms(float* ws, const float* __restrict__ w, int C,
                                              int D, float* __restrict__ rinv) {
  const int col0 = blockIdx.x * TC;
  const int n_ch = n_chunks(D);
  auto stage = [&](int k) {
    tf32x3::stage_rows<VEC>(ws + (k & 1) * TC * KC, KC, w + k * KC, D, col0, TC, C, D - k * KC);
    tf32x3::commit();
  };
  stage(0);
  float sq = 0.0f;
  for (int k = 0; k < n_ch; ++k) {
    tf32x3::wait_pending<0>();
    __syncthreads();  // chunk k has landed, and every warp is done with chunk k - 1
    if (k + 1 < n_ch) stage(k + 1);
    const float t = tile_sq(ws + (k & 1) * TC * KC, KC);
    sq = k ? __fadd_rn(sq, t) : t;
  }
  const int c = col0 + (threadIdx.x >> 3);
  if ((threadIdx.x & 7) == 0 && c < C) rinv[c] = __frsqrt_rn(fmaxf(sq, 1e-24f));
}

}  // namespace flash_aam
