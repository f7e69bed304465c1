// Tensor-core building blocks at float32 accuracy for Hopper (sm_90a):
// split-TF32 ("3xTF32") warp products with mma.sync, and a cp.async ring
// that stages operand tiles into shared memory while the previous tile is
// multiplied.
//
// Split TF32. A float32 value v is split when its fragment is loaded from
// shared memory: hi = v rounded to TF32 (as cvt.rna rounds: 10-bit
// mantissa, to nearest, ties away from zero), lo = (v - hi) rounded the
// same way. A product a.b is then a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, three
// mma.sync.m16n8k8 TF32 products into float32 accumulators; the dropped
// a_lo.b_lo term and lo's own rounding are about 2^-21 of |a.b|, near
// float32's 2^-24, where one TF32 product keeps about 2^-11.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 * gid +
// tig; A (16 x 8) a0 = A[gid][tig], a1 = A[gid + 8][tig], a2 =
// A[gid][tig + 4], a3 = A[gid + 8][tig + 4]; B (8 x 8) b0 = B[tig][gid],
// b1 = B[tig + 4][gid]; C (16 x 8) c0, c1 = C[gid][2 tig + 0, 1], c2, c3 =
// C[gid + 8][2 tig + 0, 1]. The loads below take a tile stored in shared
// memory either way round; each is free of bank conflicts when the tile's
// row stride is 4 mod 32 (lane reads s[gid * ld + tig]) or 8 mod 32 (lane
// reads s[tig * ld + gid]), as each loader states.
//
// Everything here has internal linkage: each source that includes it gets
// its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tf32x3 {

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy kBytes (16 or 4) from global src to shared dst, or write zeros when
// !valid (src is then not read, but must be a valid address: pass the
// operand's base). 16-byte copies need both addresses 16-byte aligned.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  static_assert(kBytes == 16 || kBytes == 4, "cp.async copies 16 or 4 bytes here");
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A ring of kStages buffers over n tiles: stage(i, buf) issues tile i's
// cp.async copies into buffer buf; compute(i, buf) consumes tile i. Tile i
// + kStages - 1 is in flight while tile i is multiplied; one
// __syncthreads per tile. Every thread of the block calls it; on return
// no copy is pending and every buffer may be reused.
template <int kStages, class Stage, class Compute>
__device__ __forceinline__ void pipeline(int n, Stage&& stage, Compute&& compute) {
  static_assert(kStages >= 2, "a ring needs two stages at least");
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) stage(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();               // ... every thread's; and tile i - 1 is consumed
    const int j = i + kStages - 1;
    if (j < n) stage(j, j % kStages);
    cp_async_commit();
    compute(i, i % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Split-TF32 products
// ---------------------------------------------------------------------------

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (10 mantissa bits, to
// nearest, ties away from zero, the low 13 bits cleared), by an integer add
// and mask: conversions issue at a quarter of the float32 rate on this
// card, integer adds and logic at half of it.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo + O(2^-22 |v|): v - hi is exact, then rounded in turn.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a.b (no accumulator read)
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d += a.b at float32 accuracy: the two small terms first. The tensor
// cores round each accumulation toward zero, so a long chain of them
// drifts (about an ulp of d per product); a caller that sums over many
// products adds d into a float32 total every few dozen, as wgrad_kernel
// does (mma3_first starts d afresh).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// d = a.b at float32 accuracy
__device__ __forceinline__ void mma3_first(float (&d)[4], const FragA& a, const FragB& b) {
  mma_zero(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// acc += a.b at float32 accuracy, the k-step's three products formed from
// zero and added into acc in float32: no chain that the tensor cores
// round toward zero is longer than one k-step. Four FADDs more than mma3,
// for accumulators that have no float32 totals beside them.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const FragA& a, const FragB& b) {
  float d[4];
  mma3_first(d, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A[m][k] = s[m * ld + k] (rows of an operand tile; ld 4 mod 32)
__device__ __forceinline__ FragA load_a_rows(const float* s, int ld) {
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  const float* p = s + gid * ld + tig;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ld], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}

// A[m][k] = s[k * ld + m] (an operand tile transposed; ld 8 mod 32)
__device__ __forceinline__ FragA load_a_cols(const float* s, int ld) {
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  const float* p = s + tig * ld + gid;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8], f.hi[1], f.lo[1]);
  split(p[4 * ld], f.hi[2], f.lo[2]);
  split(p[4 * ld + 8], f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = s[k * ld + n] (ld 8 mod 32)
__device__ __forceinline__ FragB load_b_kn(const float* s, int ld) {
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  const float* p = s + tig * ld + gid;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4 * ld], f.hi[1], f.lo[1]);
  return f;
}

// B[k][n] = s[n * ld + k] (ld 4 mod 32)
__device__ __forceinline__ FragB load_b_nk(const float* s, int ld) {
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  const float* p = s + gid * ld + tig;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// Visit the four elements of an accumulator fragment: fn(row, col, index)
// with row in [0, 16) and col in [0, 8) of the tile.
template <class Fn>
__device__ __forceinline__ void for_each_acc(Fn&& fn) {
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) fn(gid + (e >> 1) * 8, 2 * tig + (e & 1), e);
}

}  // namespace tf32x3
}  // namespace
