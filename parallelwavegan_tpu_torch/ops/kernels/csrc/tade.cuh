// The pieces of the fused StyleMelGAN TADE kernels (csrc/tade.cu: K8a,
// K8b), float32 on the CUDA cores, in the channel-last (B, T, 64) layout:
// the 9-tap conv of rows staged in shared memory against weights streamed
// through a double-buffered cp.async ring (conv9), the staging of rows at
// a nearest-stretch rate (load_rows), and the gate of a row whose channels
// one warp holds (gate2). See csrc/tade.cu for the design. The backward
// (csrc/tade_bwd.cu: K9a, K9b) takes the widths, the warp reductions and
// set_smem from here; its products are its own, on the tensor cores.
//
// Everything lives in namespace tadek inside an anonymous namespace, so
// that a source can include csrc/mma_tf32x3.cuh too, and each source gets
// its own copy.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {
namespace tadek {

constexpr int kC = 64;         // channels of every activation
constexpr int kK = 9;          // taps of every conv
constexpr int kHalf = 4;       // (kK - 1) / 2
constexpr int kThreads = 256;
constexpr int kTile = 64;      // output rows per block
constexpr int kS = kC + 4;     // shared-memory row stride of 64-wide rows
constexpr int kCW = 32;        // input channels per streamed weight chunk
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// COUT / 4 threads across the columns, 4 columns each; R row groups. At
// COUT = 128 a row group is one warp.
template <int COUT>
struct Map {
  static constexpr int G = COUT / 4;
  static constexpr int R = kThreads / G;
};

// The output column of slot j of thread g: at 128 columns, (2g, 2g+1) of
// the first half then of the second; at 64, 4g .. 4g+3.
template <int COUT>
__device__ __forceinline__ int col(int g, int j) {
  if (COUT == 2 * kC) return j < 2 ? 2 * g + j : kC + 2 * g + j - 2;
  return 4 * g + j;
}

// Start copying one weight chunk (kCW rows of COUT) into shared memory in
// thread column order, as one cp.async group.
template <int COUT>
__device__ __forceinline__ void stage_w(float* dst, const float* src) {
  if (COUT == 2 * kC) {
    for (int e = threadIdx.x; e < kCW * kC; e += kThreads) {
      const int j = e / kC, h = e % kC;
      const int g = h >> 1, which = h & 1;
      __pipeline_memcpy_async(dst + j * COUT + 4 * g + 2 * which,
                              src + j * COUT + which * kC + 2 * g, 8);
    }
  } else {
    for (int e = threadIdx.x * 4; e < kCW * COUT; e += kThreads * 4)
      __pipeline_memcpy_async(dst + e, src + e, 16);
  }
  __pipeline_commit();
}

// acc[i][j] = bias[col(g, j)] (0 without kBias, bias then unread) + sum
// over taps k and input channels ci < CIN of
//   in_s[(m + k * D) * (CIN + 4) + ci] * w[k][ci][col(g, j)],
// m = min(r + i*R, M-1): output row m of the conv reads input rows m ..
// m + 8D. w is (9, CIN, COUT) in device memory; w_s holds two chunks.
// Starts and ends on a barrier. The bias is a compile-time choice, so the
// forward kernels, whose biases are always given, test nothing for it.
template <int COUT, int KR, int D, int CIN = kC, bool kBias = true>
__device__ __forceinline__ void conv9(const float* in_s, int M,
                                      const float* __restrict__ w,
                                      const float* __restrict__ bias,
                                      float* w_s, float (&acc)[KR][4]) {
  using P = Map<COUT>;
  constexpr int kChunk = kCW * COUT;
  constexpr int kChunks = kK * CIN / kCW;
  constexpr int kSin = CIN + 4;
  const int g = threadIdx.x % P::G, r = threadIdx.x / P::G;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float bj = kBias ? bias[col<COUT>(g, j)] : 0.f;
#pragma unroll
    for (int i = 0; i < KR; ++i) acc[i][j] = bj;
  }
  __syncthreads();  // input rows written, earlier readers of w_s done
  stage_w<COUT>(w_s, w);
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) {
      stage_w<COUT>(w_s + ((c + 1) & 1) * kChunk, w + (size_t)(c + 1) * kChunk);
      __pipeline_wait_prior(1);  // all but the newest group: chunk c
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk c visible to every thread
    const float* cur = w_s + (c & 1) * kChunk + 4 * g;
    const int k = c / (CIN / kCW), ci0 = (c % (CIN / kCW)) * kCW;
    const float* xin = in_s + k * D * kSin + ci0;
#pragma unroll 1
    for (int ci = 0; ci < kCW; ci += 4) {
      float4 q[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        q[cc] = *reinterpret_cast<const float4*>(cur + (ci + cc) * COUT);
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int m = min(r + i * P::R, M - 1);
        const float4 xv = *reinterpret_cast<const float4*>(xin + m * kSin + ci);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          acc[i][0] = fmaf(xs[cc], q[cc].x, acc[i][0]);
          acc[i][1] = fmaf(xs[cc], q[cc].y, acc[i][1]);
          acc[i][2] = fmaf(xs[cc], q[cc].z, acc[i][2]);
          acc[i][3] = fmaf(xs[cc], q[cc].w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // chunk c consumed: its half is refilled next step
  }
}

// rows p0 .. p0 + rows of src (row p reads source row p / s; zeros where p
// is outside [0, t_out)) into dst, kS floats apart.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int p0, int rows, int t_out, int s) {
  for (int idx = threadIdx.x; idx < rows * (kC / 4); idx += kThreads) {
    const int q = idx / (kC / 4), cc = (idx % (kC / 4)) * 4;
    const int p = p0 + q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p >= 0 && p < t_out)
      v = *reinterpret_cast<const float4*>(src + (size_t)(p / s) * kC + cc);
    *reinterpret_cast<float4*>(dst + q * kS + cc) = v;
  }
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
