// f32-accurate matrix products on Hopper's tensor cores (3xTF32 on the
// warp-level mma.sync.m16n8k8 instruction), and cp.async staging of row tiles
// into swizzled shared memory.  Used by the backward flash AAM kernel.
//
// 3xTF32.  Each f32 operand x splits into big = rna_tf32(x) and
// small = rna_tf32(x - big) (x - big is exact in f32; rna_tf32 is
// cvt.rna.tf32.f32, see to_tf32).  A product then
// accumulates a_small*b_big + a_big*b_small + a_big*b_big in f32, small terms
// first, as CUTLASS's 3xTF32 does; the dropped a_small*b_small and the
// rounding of small leave about 2^-21 of each term, near f32's own rounding.
// Values that fit in 11 significant bits (1.0, 2.0, one-hot rows) split with
// no remainder, so their products are exact.
//
// Tiles in shared memory.  A tile of rows of `ld` floats (ld a multiple of
// 32) keeps element (r, c) at r * ld + (c ^ swz(r)), swz(r) = ((r & 1) << 4)
// | ((r & 2) << 2) | (r & 4).  Across a warp's lanes (g = lane / 4,
// t = lane % 4; row0, col0 and k0 multiples of 8) the fragment loads read
// (r = row0 + g, c = k0 + t) or (r = k0 + t, c = col0 + g) one float each,
// or (r = row0 + g, c = k0 + 4 t .. + 3) as one 16-byte vector; the swizzle
// sends each float pattern to 32 distinct banks and each quarter-warp of the
// vector pattern to 8 distinct 16-byte bank groups.  It leaves bits 0-1 of
// the column alone, so four aligned floats stay one 16-byte group.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ int swz(int r) { return ((r & 1) << 4) | ((r & 2) << 2) | (r & 4); }

__device__ __forceinline__ int at(int r, int c, int ld) { return r * ld + (c ^ swz(r)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `rows` rows of `cols` floats (row stride `stride` in global memory),
// starting at row `row0`, into the swizzled tile `dst` of row length `ld`.
// Rows at or past `n_rows` and columns at or past `cols` (up to `ld`) are
// filled with zeros through cp.async's source size.  VEC = 4 copies 16-byte
// groups (needs 16-byte aligned rows: cols % 4 == 0); VEC = 1 copies single
// floats.  ld / VEC must divide the block size.  Every thread of the block
// calls it; it commits no group.
template <int VEC>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* __restrict__ src,
                                           int stride, int row0, int rows, int n_rows,
                                           int cols) {
  const int per_row = ld / VEC;
  const int c = (threadIdx.x % per_row) * VEC;
  const int r_step = blockDim.x / per_row;
  int r = threadIdx.x / per_row;
  // the source and the destination row advance by fixed steps; only the
  // swizzle of the column is recomputed for each row
  const float* s = src + (size_t)(row0 + r) * stride + c;
  const size_t s_step = (size_t)r_step * stride;
  uint32_t d = smem_addr(dst + r * ld);
  const uint32_t d_step = 4u * r_step * ld;
  const bool col_ok = c < cols;
  const int bytes = VEC == 4 ? 4 * min(4, cols - c) : 4;
  for (; r < rows; r += r_step, s += s_step, d += d_step) {
    const bool ok = col_ok && row0 + r < n_rows;
    const uint32_t dd = d + 4u * (c ^ swz(r));
    if (VEC == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dd),
                   "l"(ok ? s : src), "r"(ok ? bytes : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dd),
                   "l"(ok ? s : src), "r"(ok ? bytes : 0));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 for finite x: keep 10 mantissa bits, rounding to nearest
// with ties away from zero (add half of the dropped range to the magnitude,
// then clear it).  nvcc lowers the cvt instruction itself to the same two
// integer operations plus a NaN/Inf guard, which finite operands do not need.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(__fsub_rn(x, __uint_as_float(big)))};
}

// d += a * b on one 16x8x8 tile, operands in TF32, sum in f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// How an operand of a product lies in its swizzled tile: MK_ROWS keeps A's
// element (m, k) at (r, c) = (m, k) and B's (k, n) at (n, k); K_ROWS keeps
// A's (m, k) at (k, m) and B's (k, n) at (k, n).
//
// The products below accumulate a warp's MT x NT tiles of 16 rows by 8
// columns: with g = lane / 4 and t = lane % 4, acc[i][j][0..1] holds
// (m0 + 16 i + g, n0 + 8 j + 2 t + {0, 1}) and acc[i][j][2..3] the same
// columns of row + 8.  Each f32 product is three MMAs, small terms first.
enum Layout { MK_ROWS, K_ROWS };

// acc[i][j] += A[16 i .., 0 .. 32) * B[0 .. 32, n0 + 8 j ..] for one warp,
// MT (2, or 1 for A's first 16 rows) by NT = 4 tiles in 3xTF32, where A is
// a 32x32 tile (row length 32) held as its TF32 parts A_big and A_small,
// laid out as LA says, and B has the depth along its rows (K_ROWS, row
// length ldb) and is split here.
// Every fragment address is a per-thread offset fixed before the loop plus
// a step that is the same for the whole warp: the swizzle of a row depends
// on its low three bits only, which the 8-deep steps leave alone.
template <Layout LA, int MT = 2>
__device__ __forceinline__ void warp_mma_k32(float (&acc)[MT][4][4], const float* A_big,
                                             const float* A_small, const float* B, int ldb,
                                             int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // B (k = 8 ks + t + 4 e, n = n0 + 8 j + g): row offset (t + 4 e) * ldb
  // plus the swizzled column
  int b_off[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < 4; ++j) b_off[e][j] = at(t + 4 * e, n0 + 8 * j + g, ldb);
  const int sg = swz(g);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t ab[MT][4], as[MT][4], bb[4][2], bs[4][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // a_r: m = 16 i + g + 8 (r % 2), k = 8 ks + t + 4 (r / 2)
        const int m = 16 * i + g + 8 * (r & 1);
        const int k = 8 * ks + t + 4 * (r >> 1);
        const int idx = LA == K_ROWS ? k * 32 + (m ^ swz(t + 4 * (r >> 1)))
                                     : m * 32 + (k ^ sg);
        ab[i][r] = __float_as_uint(A_big[idx]);
        as[i][r] = __float_as_uint(A_small[idx]);
      }
    const float* Bk = B + 8 * ks * ldb;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const Split sp = split(Bk[b_off[e][j]]);
        bb[j][e] = sp.big, bs[j][e] = sp.small;
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[i][j], as[i], bb[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[i][j], ab[i], bs[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[i][j], ab[i], bb[j]);
  }
}

// acc[i][j] += A[m0 + 16 i .., k0 .. k0 + 16) * B[n0 + 8 j .., k0 .. k0 + 16)^T
// for one warp, both operands with the depth along their rows (MK_ROWS), in
// 3xTF32: two 8-deep MMA steps.  Lane (g, t) loads depths k0 + 4 t .. + 3 of
// each of its rows as one 16-byte vector and feeds 4 t, 4 t + 1 to the
// first step's k-slots t, t + 4 and 4 t + 2, 4 t + 3 to the second's: a
// product may visit the depths in any order, as long as A and B agree.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_k16(float (&acc)[MT][NT][4], const float* A, int lda,
                                             int m0, const float* B, int ldb, int n0,
                                             int k0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int k = k0 + 4 * (lane & 3);
  uint32_t ab[MT][2][4], as[MT][2][4], bb[NT][4], bs[NT][4];  // [.][row + 8 h][depth]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * i + 8 * h + g;
      const float4 v = *reinterpret_cast<const float4*>(A + at(r, k, lda));
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Split sp = split(x[e]);
        ab[i][h][e] = sp.big, as[i][h][e] = sp.small;
      }
    }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(B + at(n0 + 8 * j + g, k, ldb));
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Split sp = split(x[e]);
      bb[j][e] = sp.big, bs[j][e] = sp.small;
    }
  }
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int e0 = 2 * st;
    uint32_t fab[MT][4], fas[MT][4], fbb[NT][2], fbs[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      fab[i][0] = ab[i][0][e0], fab[i][1] = ab[i][1][e0];
      fab[i][2] = ab[i][0][e0 + 1], fab[i][3] = ab[i][1][e0 + 1];
      fas[i][0] = as[i][0][e0], fas[i][1] = as[i][1][e0];
      fas[i][2] = as[i][0][e0 + 1], fas[i][3] = as[i][1][e0 + 1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      fbb[j][0] = bb[j][e0], fbb[j][1] = bb[j][e0 + 1];
      fbs[j][0] = bs[j][e0], fbs[j][1] = bs[j][e0 + 1];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(acc[i][j], fas[i], fbb[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(acc[i][j], fab[i], fbs[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(acc[i][j], fab[i], fbb[j]);
  }
}

}  // namespace tf32x3
