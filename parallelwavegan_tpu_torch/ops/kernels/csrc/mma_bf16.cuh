// bf16 tensor-core products for Hopper (sm_90a): one mma.sync.m16n8k16
// with bf16 operands and float32 accumulators per 16-deep k-step, the
// operand rounding of the JAX kernels' bf16-resident mode (`mxu_bf16`:
// dot operands cast to bf16, preferred_element_type float32).
//
// Rounding. A float32 operand is rounded to bf16 to nearest, ties to even
// (cvt.rn, as XLA's astype(bfloat16) rounds). A product of two bf16
// values is exact in float32, so a bf16 product differs from the same
// product taken in float32 on the rounded operands only in the order of
// its sums (the tensor cores round each accumulation toward zero, as
// csrc/mma_tf32x3.cuh says of TF32).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * gid +
// tig; each register holds two bf16, the lower index in the low half. A
// (16 x 16) a0 = A[gid][2 tig, 2 tig + 1], a1 = A[gid + 8][2 tig, ..],
// a2 = A[gid][2 tig + 8, 2 tig + 9], a3 = A[gid + 8][2 tig + 8, ..]; B
// (16 x 8) b0 = B[2 tig, 2 tig + 1][gid], b1 = B[2 tig + 8, 2 tig +
// 9][gid]; C (16 x 8) as m16n8k8: c0, c1 = C[gid][2 tig + 0, 1], c2, c3 =
// C[gid + 8][2 tig + 0, 1]. The weights are laid out once by the wrapper
// (ops/kernels/mma_bf16.py fragments) so that a lane's (b0, b1) is one
// 8-byte load: entry [ks][nt][lane] = (B[16 ks + 2 tig][8 nt + gid],
// B[.. + 1], B[.. + 8], B[.. + 9]).
//
// Everything here has internal linkage: each source that includes it gets
// its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace bf16mma {

// (lo, hi) rounded to bf16, to nearest even, packed: lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v rounded to bf16, to nearest even, as a float32
__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the float32 value of a bf16 held in the low 16 bits of h
__device__ __forceinline__ float widen(uint32_t h) { return __uint_as_float(h << 16); }

// four bf16 (8 bytes at p) as a float4
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(widen(u.x & 0xFFFFu), widen(u.x >> 16), widen(u.y & 0xFFFFu),
                     widen(u.y >> 16));
}

// d += a.b: a (16 x 16) bf16, b (16 x 8) bf16, d (16 x 8) float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace bf16mma
}  // namespace
