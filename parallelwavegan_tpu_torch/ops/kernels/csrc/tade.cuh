// The pieces that the fused StyleMelGAN TADE kernels share (csrc/tade.cu:
// K8a, K8b; csrc/tade_bwd.cu: K9a, K9b; their bf16-resident modes
// csrc/tade_bf16.cu and csrc/tade_bwd_bf16.cu), in the channel-last (B, T,
// 64) layout: the widths, the 9-tap conv of rows staged in shared memory
// against weights split into TF32 hi and lo in the mma B fragments' order
// and streamed through a cp.async ring (conv9_tf32x3, every product split
// TF32 on the tensor cores, csrc/mma_tf32x3.cuh), the warp reductions, the
// gate of a row whose channels one warp holds (gate2), and the bf16 loads
// and stores of activations that the bf16-resident modes keep in memory
// (ldio2, stio2).
//
// Everything lives in namespace tadek inside an anonymous namespace: each
// source that includes it gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {
namespace tadek {

using namespace tf32x3;

constexpr int kC = 64;         // channels of every activation
constexpr int kK = 9;          // taps of every conv
constexpr int kHalf = 4;       // (kK - 1) / 2
constexpr int kThreads = 256;  // 8 warps: 4 of 32 rows x 2 of 32 columns
constexpr int kKC = 32;        // input channels of one weight chunk
constexpr int kChunkF = kKC * kC * 2;  // its floats: 4 k-steps x 8 tiles x 32 x 4
constexpr int kWStages = 2;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// The 32 x 32 output tile of warp (wm, wn) = warp % 4, warp / 4 of a 9-tap
// conv of 64 output columns: tot[mi][ni][e] = sum over taps j and input
// channels ci < CIN of in_s[(m + j D) ld + ci] W[j][ci][n] at rows m = 32
// wm + 16 mi + gid (+ 8 for e >= 2) and columns n = 32 wn + 8 ni + 2 tig
// (+ 1 for odd e). An m-tile at or past M is skipped. wf holds W in
// fragment order (9 CIN / 8 k-steps of 8 column tiles x 32 lanes x {hi, lo
// of B[tig][gid], hi, lo of B[tig + 4][gid]}, logical k = tig, tig + 4
// being channels 2 tig, 2 tig + 1 of the k-step; ops/kernels/tf32x3.py);
// w_s two chunks of it. The tensor cores round each accumulation toward
// zero, so each tap's tile sums (CIN / 8 k-steps, three products each)
// go into the float32 totals once per tap. Starts and ends on a barrier;
// a cp.async group committed before the call (a conv's input rows) has
// landed when the first product is formed.
template <int CIN, int D, int M>
__device__ __forceinline__ void conv9_tf32x3(const float* in_s, int ld,
                                             const float* __restrict__ wf, float* w_s,
                                             float (&tot)[2][4][4]) {
  constexpr int kPerTap = CIN / kKC;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bool on[2] = {32 * wm < M, 32 * wm + 16 < M};
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mi][ni][e] = 0.f;
  auto compute = [&](int c, int buf) {
    const int j = c / kPerTap, part = c % kPerTap;
    if (part == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    const float* xa = in_s + (32 * wm + gid + j * D) * ld + part * kKC + 2 * tig;
    const float* ws = w_s + buf * kChunkF + wn * 4 * 128 + lane * 4;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      FragA a[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (!on[mi]) continue;
        const float2 u = ld2(xa + mi * 16 * ld + ks * 8);
        const float2 v = ld2(xa + (mi * 16 + 8) * ld + ks * 8);
        split(u.x, a[mi].hi[0], a[mi].lo[0]);
        split(v.x, a[mi].hi[1], a[mi].lo[1]);
        split(u.y, a[mi].hi[2], a[mi].lo[2]);
        split(v.y, a[mi].hi[3], a[mi].lo[3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float4 w = *reinterpret_cast<const float4*>(ws + (ks * 8 + ni) * 128);
        const FragB b{{__float_as_uint(w.x), __float_as_uint(w.z)},
                      {__float_as_uint(w.y), __float_as_uint(w.w)}};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (on[mi]) mma3(acc[mi][ni], a[mi], b);
      }
    }
    if (part == kPerTap - 1) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[mi][ni][e] += acc[mi][ni][e];
    }
  };
  pipeline<kWStages>(
      kK * kPerTap,
      [&](int c, int buf) {
        const float* src = wf + (size_t)c * kChunkF;
        float* dst = w_s + buf * kChunkF;
#pragma unroll
        for (int e = threadIdx.x * 4; e < kChunkF; e += kThreads * 4)
          cp_async<16>(dst + e, src + e, true);
      },
      compute);
}

// Two channels at p (an even element of a bf16 activation) as float32.
__device__ __forceinline__ float2 ldio2(const uint16_t* __restrict__ p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(bf16mma::widen(u & 0xFFFFu), bf16mma::widen(u >> 16));
}

// v to the two channels at p, rounded to bf16 to nearest even (as JAX's
// astype(bfloat16) on a store).
__device__ __forceinline__ void stio2(uint16_t* __restrict__ p, float2 v) {
  *reinterpret_cast<uint32_t*>(p) = bf16mma::pack(v.x, v.y);
}

// The conv of the float32 kernels.
template <int CIN, int D, int M>
__device__ __forceinline__ void conv9(const float* in_s, int ld,
                                      const float* __restrict__ wf, float* w_s,
                                      float (&tot)[2][4][4]) {
  conv9_tf32x3<CIN, D, M>(in_s, ld, wf, w_s, tot);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The gate of one row, whose 64 channel pairs a warp holds: lane g has the
// softmax half's channels (2g, 2g+1) in a[0..1], the tanh half's in
// a[2..3]. Every lane of the warp must call it.
__device__ __forceinline__ float2 gate2(const float (&a)[4], int softmax) {
  float g0, g1;
  if (softmax) {
    const float mx = warp_max(fmaxf(a[0], a[1]));
    const float e0 = expf(a[0] - mx), e1 = expf(a[1] - mx);
    const float inv = 1.f / warp_sum(e0 + e1);
    g0 = e0 * inv;
    g1 = e1 * inv;
  } else {
    g0 = 1.f / (1.f + expf(-a[0]));
    g1 = 1.f / (1.f + expf(-a[1]));
  }
  return make_float2(g0 * tanhf(a[2]), g1 * tanhf(a[3]));
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tadek
}  // namespace
