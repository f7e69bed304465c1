// The bf16 rounding of the JAX kernels' bf16-resident mode (`mxu_bf16`: dot
// operands cast to bf16, preferred_element_type float32), for the bf16
// kernels' operands and stores (sm_90a).
//
// Rounding. A float32 operand is rounded to bf16 to nearest, ties to even
// (cvt.rn, as XLA's astype(bfloat16) rounds). A product of two bf16
// values is exact in float32, so a bf16 product differs from the same
// product taken in float32 on the rounded operands only in the order of
// its sums (the tensor cores round each accumulation toward zero, as
// csrc/mma_tf32x3.cuh says of TF32).
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

}  // namespace bf16mma
}  // namespace
