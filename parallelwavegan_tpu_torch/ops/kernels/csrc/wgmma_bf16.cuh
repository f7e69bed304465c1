// Hopper's own building blocks for bf16 products (sm_90a): warpgroup
// matrix products (wgmma.mma_async m64nNk16, A from registers, B from
// shared memory through a matrix descriptor), the tensor memory
// accelerator's bulk copy into shared memory with an mbarrier that counts
// its bytes, the mbarrier ring's waits and arrivals, ldmatrix, and the async-proxy
// fence.
//
// wgmma (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply"). Four
// warps (a warpgroup, 128 threads whose first warp is a multiple of 4)
// issue one product of a 64-row tile. With A in registers, warp w of the
// warpgroup holds rows 16 w .. 16 w + 15 in mma.m16n8k16's A layout (a0 =
// A[gid][2 tig, 2 tig + 1], a1 = A[gid + 8][..], a2 = A[gid][2 tig + 8,
// ..], a3 = A[gid + 8][2 tig + 8, ..], lane = 4 gid + tig); the float32
// accumulator of m64nN gives warp w rows 16 w + gid (d[4 i], d[4 i + 1] at
// columns 8 i + 2 tig, + 1) and 16 w + gid + 8 (d[4 i + 2], d[4 i + 3]).
// B (16 x N) is read from shared memory by the async proxy: shared memory
// written by threads must be fenced (fence_proxy_async) before a wgmma
// reads it, and the A registers and accumulators must not be touched
// between the issue and the wait_group that retires the product.
//
// Matrix descriptors (CUTLASS's cute/arch/mma_sm90_desc.hpp and the
// canonical layouts of cute/atom/mma_traits_sm90_gmma.hpp): bits 0-13 the
// start address / 16, 16-29 the leading byte offset / 16, 32-45 the stride
// byte offset / 16, 62-63 the layout (0 none, 1 the 128-byte swizzle).
//  - K-major, 128-byte swizzle (desc_k_sw128): each of B's N columns is a
//    128-byte row of 64 k values, 8 rows form a 1024-byte atom (the stride
//    byte offset between atoms); the 16-byte chunk c of row n sits at c ^
//    (n % 8) (address bits 4-6 XOR bits 7-9, so the tile must start
//    1024-aligned); the k16 step s starts 32 s bytes in.
//  - MN-major, 128-byte swizzle (desc_mn_sw128, imm-trans-b 1): 8 k rows
//    of 64 n values (128 bytes each) form a 1024-byte atom, the chunk c of
//    row r at c ^ r; the leading byte offset steps to the next 64 n, the
//    stride byte offset to the next 8 k.
//  - No swizzle (desc_inter, layout 0), either major: B is cut into core
//    matrices of 8 x 8 values, each 128 contiguous bytes of 8 rows of 16
//    bytes (K-major: a row is one n's 8 k values; MN-major: one k's 8 n
//    values), placed anywhere 16-byte aligned; the two byte offsets give
//    the step to the next core matrix along K and along N. Which offset
//    field takes which step in each major is what
//    ops/kernels/probe_melgan_bf16.py measures on the card; the kernels
//    that use it (csrc/melgan_bf16.cuh) take the answer from there.
//
// Everything here has internal linkage: each source that includes it gets
// its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wgmma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and the bulk copy
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (and the
// other threads, after a __syncthreads)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` to come from the async proxy
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// waits until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed); a wait that outlasts 2^24
// polls (seconds, where a copy takes microseconds) traps, so that an
// arrival that never comes fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls == (1u << 24)) __trap();
}

// the tensor memory accelerator's bulk copy of `bytes` (a multiple of 16,
// both ends 16-byte aligned) from device memory into shared memory, its
// completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's generic-proxy shared memory accesses before later
// async-proxy ones (wgmma's reads of B)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// ldmatrix
// ---------------------------------------------------------------------------

// four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 give the 16-byte rows of
// matrix i, which lands in r[i] (lane = 4 g + t holds row g, elements 2 t,
// 2 t + 1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// the same, each matrix transposed: lane = 4 g + t holds elements (rows 2
// t, 2 t + 1) of column g
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.x4.trans.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_k_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// MN-major, 128-byte swizzle (imm-trans-b 1): 8 k rows of 64 n values, 128
// bytes each, form a 1024-byte atom (chunk c of row r at c ^ r); lbo steps
// to the next 64 n, sbo to the next 8 k; both in bytes
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// no swizzle: lbo and sbo in bytes (multiples of 16)
__device__ __forceinline__ uint64_t desc_inter(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving accesses of d across the asynchronous
// product
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . B: a 64 x 16 bf16 from registers, B 16 x 64 bf16 through
// desc_b (kTransB 0: K-major, 1: MN-major), float32 d; accumulate 0
// overwrites d.
template <int kTransB>
__device__ __forceinline__ void m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// d (+)= a . B as m64n64k16 does, B 16 x 16 (d: 8 floats)
template <int kTransB>
__device__ __forceinline__ void m64n16k16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// d (+)= a . B as m64n64k16 does, B 16 x 32 (d: 16 floats)
template <int kTransB>
__device__ __forceinline__ void m64n32k16(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// d (+)= a . B as m64n64k16 does, B 16 x 128: d (64 floats) holds two
// m64n64 accumulators side by side (d[32 h + e] is column 64 h + the
// m64n64 column of e)
template <int kTransB>
__device__ __forceinline__ void m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

}  // namespace wgmma
}  // namespace
