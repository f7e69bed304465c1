// Fused HiFi-GAN decode tail for Hopper (sm_90a), float32 in and out; the
// residual units' convs on the tensor cores in split TF32.
//
// Replaces three Pallas TPU kernels of the JAX package
// (parallelwavegan_tpu/ops/pallas_kernels/):
//   hifigan_tail.py:256 fused_hifigan_tail (K1, kernel body _kernel_tail):
//     an optional MRF at the entry rate, then per stage leaky ->
//     ConvTranspose1d(k = 2s, s) -> mean of the MRF resblocks, then
//     leaky(0.01) -> Conv1d(k) -> tanh;
//   hifigan_mrf.py:178 fused_hifigan_mrf (K2a, _kernel) and :399
//     fused_hifigan_mrf_packed (K2b, _kernel_packed): one MRF stage.
// All in the channel-last (B, T, C) layout of the JAX package. Python
// (ops/kernels/hifigan_tail.py, ops/kernels/hifigan_mrf.py) sequences the
// launches below on one stream; the wrappers allocate every buffer and
// this file allocates nothing.
//
// What bounds it on the card. For HiFi-GAN v1 at 512 mel frames the tail
// works on 32768 x 128, 65536 x 64 and 131072 x 32 samples x channels:
// every activation is 16.8 MB in float32. Each MRF's 18 convs (K = 3, 7,
// 11 at three dilations, two convs each) take 126 taps of C x C
// multiply-adds per sample: 67.6 G multiply-adds at C = 128, 33.8 G at 64
// and 16.9 G at 32, about 95 % of the tail's 240 GFLOP; the transposed
// convs add 1.6 G, the output conv 29 M. Against about 1.1 GB of
// activation traffic that is bound by arithmetic: 3.58 ms for the tail on
// the CUDA cores in float32 (67 TFLOP/s), 1.46 ms on the tensor cores in
// split TF32 (three TF32 products per multiply at 495 TFLOP/s), against
// 0.3 ms of bytes at 3.35 TB/s. The MRF stages alone (K2): 135.3 GFLOP at
// C = 128 (2.02 ms in float32, 0.82 in split TF32), 101.5 for stages 2-3
// together (1.51, 0.62). The TPU kernels' space-to-depth lane packing only
// filled the 128-lane MXU and is not carried over.
//
// What the design does about it:
//  (a) resunit_tc_kernel<C>, C = 16 .. 128: one block per (time tile,
//      batch, resblock) computes one MRF residual unit x + conv2(leaky(
//      conv1(leaky(x)) + b1)) + b2 for the tile, conv1 at the unit's
//      dilation, conv2 at 1. The resblocks of an MRF are independent
//      chains, so one launch runs the units of one dilation depth for all
//      of them (a v1 MRF is 3 launches of about 800 blocks).
//      Each conv is an implicit GEMM, [tile rows x K C] . [K C x C], on
//      mma.sync.m16n8k8 in split TF32 (csrc/mma_tf32x3.cuh: v = hi + lo,
//      a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi). A is leaky(x) (conv1) or
//      h (conv2) in shared memory, read at rows r + k dil for tap k as
//      8-byte channel pairs (rows C + 8 floats apart: 8 or 24 mod 32, free
//      of bank conflicts) and split where the fragment is loaded. B is the
//      conv's weights, split once by the wrapper (ops/kernels/tf32x3.py
//      mrf_fragments, decode keeps the split) into TF32 hi and lo in the
//      mma B fragments' order, depth K C tap-major: one 16-byte shared load
//      gives a thread (hi, lo) of both B registers. They stream through a
//      two-stage cp.async ring of chunks (one k-step, 8 KB, at C = 128 and
//      4 KB at 64; a tap at C = 32), one barrier per chunk.
//      A warp owns 32 rows x 64 columns (2 x 8 tiles; all C columns below
//      C = 64), so each B fragment feeds two m-tiles and each A fragment up
//      to eight n-tiles. A tile is 128 conv1 rows at C = 128 (118 outputs
//      at K = 11, where the FFMA kernel's 64-row tiles gave 54) and 256 at
//      C <= 64, so halo recompute and the weights' L2 traffic fall.
//      The tensor cores round their accumulation toward zero, and a conv's
//      depth is up to 176 k-steps (K = 11, C = 128): each k-step's three
//      products are formed from zero and added into float32 accumulators
//      (mma3_add), so no rounded chain is longer than one k-step.
//      leaky(x) for tile + halo, zero outside [0, T), is staged once; the
//      conv1 epilogue applies b1, leaky and the "same" zero padding of
//      conv2 (the TPU kernel's mask_rows) on the accumulators and writes h
//      over leaky(x), which conv1 no longer needs; the conv2 epilogue adds
//      b2 and x and writes the unit's output to device memory. 113 KB at
//      C = 128 and K = 11, d = 5, so two blocks share an SM.
//  (b) resunit_kernel<C>, C = 1 .. 8 (off every shipped config; in the
//      tests): the same unit on the CUDA cores in float32 FFMA, each
//      thread an 8-row register tile, weights double-buffered through
//      shared memory 32 input channels of one tap at a time. The route
//      follows the width alone, never a failure.
//  mean_kernel then averages the resblocks' outputs.
//  (c) deconv_kernel: leaky -> strided transposed conv + bias in gather
//      form, y[j] = sum_k xd[j - (K-1) + pad + k] . w[k] with xd[s*i] =
//      x[i]. Outputs are computed phase by phase (j = s*m + ph), so every
//      thread of a phase takes the same taps.
//  (d) outconv_kernel: leaky(0.01) -> Conv1d(k) -> tanh, one output
//      sample per thread.
// Blocks share nothing and carry nothing from tile to tile, and every sum
// is taken in a fixed order: two runs give the same bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnitRows = 8;    // rows per thread in resunit_kernel
constexpr int kDeconvRows = 4;  // rows per thread and phase in deconv_kernel
constexpr int kWChunk = 32;     // input channels of weights staged at once
constexpr int kMaxChains = 8;   // resblocks of one MRF per launch
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// Thread map for C output channels: TN channels per thread, G threads
// across the channels, R rows per step of kThreads threads. Rows in shared
// memory are S floats apart: C + 4 keeps them 16-byte aligned for float4
// loads while threads of a quarter warp on different rows hit different
// banks; widths below 4 take scalar loads and C + 1.
template <int C>
struct Map {
  static constexpr bool V4 = C % 4 == 0;
  static constexpr int TN = V4 ? 4 : C;
  static constexpr int G = C / TN;
  static constexpr int R = kThreads / G;
  static constexpr int S = V4 ? C + 4 : C + 1;
  static constexpr int CH = C < kWChunk ? C : kWChunk;
};

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Start the asynchronous copy of one weight chunk (CH x C floats) into
// shared memory, as one cp.async group.
template <int C>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src) {
  using M = Map<C>;
  if constexpr (M::V4) {
    for (int idx = threadIdx.x * 4; idx < M::CH * C; idx += kThreads * 4)
      __pipeline_memcpy_async(dst + idx, src + idx, 16);
  } else {
    for (int idx = threadIdx.x; idx < M::CH * C; idx += kThreads)
      __pipeline_memcpy_async(dst + idx, src + idx, 4);
  }
  __pipeline_commit();
}

// acc[i][j] += sum_k sum_ci in_s[row_i + k*dil][ci] * w[k][ci][co0 + j]
// for row_i = r + i*R. w is (K, C, C) in gather form in device memory; it
// is read in chunks of CH input channels of one tap, the next chunk
// copied into the other half of w_s (2 x CH x C) while this one is used.
template <int C>
__device__ __forceinline__ void conv_rows(
    const float* __restrict__ in_s, const float* __restrict__ w,
    float* __restrict__ w_s, int K, int dil, int r, int g,
    float (&acc)[kUnitRows][Map<C>::TN]) {
  using M = Map<C>;
  constexpr int kChunks = C / M::CH;  // chunks per tap
  constexpr int kChunk = M::CH * C;   // floats per chunk
  const int n = K * kChunks;
  __syncthreads();  // inputs written, previous readers of w_s done
  stage_chunk<C>(w_s, w);
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage_chunk<C>(w_s + ((c + 1) & 1) * kChunk, w + (size_t)(c + 1) * kChunk);
      __pipeline_wait_prior(1);  // all but the newest group: chunk c
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk c visible to every thread
    {
      const float* cur = w_s + (c & 1) * kChunk;
      const int k = c / kChunks;
      const int ci0 = (c % kChunks) * M::CH;
      const float* xrow = in_s + (r + k * dil) * M::S + ci0;
      if constexpr (M::V4) {
        // four input channels of all rows per step: 8 broadcast float4
        // loads of x and 4 float4 loads of w feed 128 FMAs
#pragma unroll 2
        for (int ci = 0; ci < M::CH; ci += 4) {
          float4 xv[kUnitRows];
#pragma unroll
          for (int i = 0; i < kUnitRows; ++i)
            xv[i] = *reinterpret_cast<const float4*>(xrow + i * M::R * M::S + ci);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 q =
                *reinterpret_cast<const float4*>(cur + (ci + cc) * C + g * 4);
#pragma unroll
            for (int i = 0; i < kUnitRows; ++i) {
              const float x = lane(xv[i], cc);
              acc[i][0] = fmaf(x, q.x, acc[i][0]);
              acc[i][1] = fmaf(x, q.y, acc[i][1]);
              acc[i][2] = fmaf(x, q.z, acc[i][2]);
              acc[i][3] = fmaf(x, q.w, acc[i][3]);
            }
          }
        }
      } else {
        for (int ci = 0; ci < M::CH; ++ci) {
          float wv[M::TN];
#pragma unroll
          for (int j = 0; j < M::TN; ++j) wv[j] = cur[ci * C + g * M::TN + j];
#pragma unroll
          for (int i = 0; i < kUnitRows; ++i) {
            const float xv = xrow[i * M::R * M::S + ci];
#pragma unroll
            for (int j = 0; j < M::TN; ++j)
              acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // chunk c consumed: its half is refilled next step
  }
}

// One residual unit of one MRF chain (resblock): out = x + conv2(...).
// w1 and w2 are the gather-form weights (K, C, C) for resunit_kernel, the
// split fragments (K C / 8, C / 8, 32, 4) for resunit_tc_kernel.
struct Unit {
  const float* x;
  float* out;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  int K;
  int dil;
};

// The units of one dilation depth across the chains of an MRF, one per
// blockIdx.z. Passed by value (kernel parameter space).
struct Units {
  Unit u[kMaxChains];
};

// out = x + conv2(leaky(conv1(leaky(x)))) over one tile of one chain, on
// the CUDA cores (C <= 8).
template <int C>
__global__ void __launch_bounds__(kThreads) resunit_kernel(Units units, int T,
                                                           float slope) {
  using M = Map<C>;
  constexpr int rows = M::R * kUnitRows;  // conv1 rows: tile + 2 * p2
  const Unit& a = units.u[blockIdx.z];
  const int K = a.K;
  const int p2 = (K - 1) / 2;
  const int p1 = p2 * a.dil;
  const int tt = rows - 2 * p2;  // output rows of the tile
  const int t0 = blockIdx.x * tt;
  if (t0 >= T) return;  // the grid covers the chain with the most tiles
  const int xrows = rows + 2 * p1;
  const float* __restrict__ x = a.x;
  const float* __restrict__ w1 = a.w1;
  const float* __restrict__ w2 = a.w2;

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // 2 x CH x C, 16-byte aligned
  float* x_s = w_s + 2 * M::CH * C;              // xrows x S
  float* h_s = x_s;  // (rows + 2 * p2) x S, over x_s once conv1 is done

  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * T * C;
  const int g = threadIdx.x % M::G;
  const int r = threadIdx.x / M::G;
  const int co0 = g * M::TN;

  const int base = t0 - p1 - p2;
  for (int idx = threadIdx.x; idx < xrows * C; idx += kThreads) {
    const int rr = idx / C, cc = idx % C;
    const int t = base + rr;
    x_s[rr * M::S + cc] =
        (t >= 0 && t < T) ? leaky(xb[(size_t)t * C + cc], slope) : 0.f;
  }
  float acc[kUnitRows][M::TN];
#pragma unroll
  for (int i = 0; i < kUnitRows; ++i)
#pragma unroll
    for (int j = 0; j < M::TN; ++j) acc[i][j] = a.b1[co0 + j];
  conv_rows<C>(x_s, w1, w_s, K, a.dil, r, g, acc);  // ends on a barrier:
  // x_s is fully read, h_s takes its place
  // rows past the conv1 output are read only by idle conv2 rows
  for (int idx = threadIdx.x; idx < 2 * p2 * M::S; idx += kThreads)
    h_s[rows * M::S + idx] = 0.f;
#pragma unroll
  for (int i = 0; i < kUnitRows; ++i) {
    const int row = r + i * M::R;
    const int t = t0 - p2 + row;
    const bool in_seq = t >= 0 && t < T;
#pragma unroll
    for (int j = 0; j < M::TN; ++j)
      h_s[row * M::S + co0 + j] = in_seq ? leaky(acc[i][j], slope) : 0.f;
  }

#pragma unroll
  for (int i = 0; i < kUnitRows; ++i)
#pragma unroll
    for (int j = 0; j < M::TN; ++j) acc[i][j] = a.b2[co0 + j];
  conv_rows<C>(h_s, w2, w_s, K, 1, r, g, acc);

  float* ob = a.out + (size_t)b * T * C;
#pragma unroll
  for (int i = 0; i < kUnitRows; ++i) {
    const int row = r + i * M::R;
    const int t = t0 + row;
    if (row < tt && t < T) {
#pragma unroll
      for (int j = 0; j < M::TN; ++j) {
        const size_t o = (size_t)t * C + co0 + j;
        ob[o] = xb[o] + acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Residual units on the tensor cores (C = 16 .. 128)
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;      // cp.async ring of weight chunks
constexpr int kChunkF = 2048;   // floats of a ring stage (8 KB), the largest chunk

// The block's shape at width C: a warp owns kWM = 2 m-tiles (16 rows
// each) x kWN 8-column tiles.
template <int C>
struct Tc {
  static constexpr int kNT = C / 8;                        // 8-column tiles
  static constexpr int kWN = kNT < 8 ? kNT : 8;            // tiles of a warp
  static constexpr int kWM = 2;                            // m-tiles of a warp
  static constexpr int kWC = kNT / kWN;                    // warps across the columns
  static constexpr int kWR = kWarps / kWC;                 // warps down the rows
  static constexpr int kRows = 16 * kWM * kWR;             // conv rows of a tile
  static constexpr int kLd = C + 8;                        // row stride, 8 or 24 mod 32
  static constexpr int kPerTap = C / 8;                    // k-steps of a tap
  static constexpr int kStepF = kNT * 128;                 // floats of a k-step's weights
  // k-steps of a chunk: one at C >= 64 (at C = 64 two spilled 8 bytes)
  static constexpr int kKS = kStepF >= 1024 ? 1 : kChunkF / kStepF;
  static_assert(kKS >= 1 && kWarps % kWC == 0, "block map");
};

template <int C>
using TcAcc = float[Tc<C>::kWM][Tc<C>::kWN][4];

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// Visit a thread's accumulator pairs: fn(mi, ni, h, row, col) for
// acc[mi][ni][2h], acc[mi][ni][2h + 1] at tile row `row`, columns col and
// col + 1.
template <int C, class Fn>
__device__ __forceinline__ void for_each_pair(Fn&& fn) {
  using G = Tc<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % G::kWR, wn = warp / G::kWR, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < G::kWM; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::kWN; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(mi, ni, h, 16 * (G::kWM * wm + mi) + gid + 8 * h,
           8 * (wn * G::kWN + ni) + 2 * tig);
}

// acc += the conv of the tile's rows: for conv row r, sum over taps k of
// in_s[r + k dil] . W[k]. wf is the conv's split weights (K C / 8 k-steps
// of kNT x 32 x {hi, lo of B[tig][gid], hi, lo of B[tig + 4][gid]}; logical
// k = tig, tig + 4 is channel 2 tig, 2 tig + 1 of the k-step,
// ops/kernels/tf32x3.py), streamed through the ring in chunks of kKS
// k-steps. Each k-step's sum is added into acc in float32 (mma3_add). The
// n-tiles are the outer loop, so that each B fragment is loaded once and
// both m-tiles' A fragments are live. Every thread of the block calls it;
// it returns on a barrier, with in_s and the ring free.
template <int C>
__device__ __forceinline__ void conv_tc(const float* __restrict__ in_s,
                                        const float* __restrict__ wf,
                                        float* __restrict__ ring, int K, int dil,
                                        TcAcc<C>& acc) {
  using G = Tc<C>;
  const int nks = K * G::kPerTap;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % G::kWR, wn = warp / G::kWR, gid = lane >> 2, tig = lane & 3;
  const float* xa = in_s + (16 * G::kWM * wm + gid) * G::kLd + 2 * tig;
  const int boff = wn * G::kWN * 128 + lane * 4;

  auto stage = [&](int i, int buf) {
    const float* src = wf + (size_t)i * (G::kKS * G::kStepF);
    float* dst = ring + buf * kChunkF;
    const int nf = min(G::kKS, nks - i * G::kKS) * G::kStepF;
    for (int e = threadIdx.x * 4; e < nf; e += kThreads * 4)
      tf32x3::cp_async<16>(dst + e, src + e, true);
  };
  auto compute = [&](int i, int buf) {
    const float* b_s = ring + buf * kChunkF + boff;
#pragma unroll
    for (int s = 0; s < G::kKS; ++s) {
      const int ks = i * G::kKS + s;
      if (ks >= nks) break;
      const int tap = ks / G::kPerTap, ci0 = (ks % G::kPerTap) * 8;
      const float* a = xa + tap * dil * G::kLd + ci0;
      tf32x3::FragA f[G::kWM];
#pragma unroll
      for (int mi = 0; mi < G::kWM; ++mi) {
        const float2 u = ld2(a + mi * 16 * G::kLd), v = ld2(a + (mi * 16 + 8) * G::kLd);
        tf32x3::split(u.x, f[mi].hi[0], f[mi].lo[0]);
        tf32x3::split(v.x, f[mi].hi[1], f[mi].lo[1]);
        tf32x3::split(u.y, f[mi].hi[2], f[mi].lo[2]);
        tf32x3::split(v.y, f[mi].hi[3], f[mi].lo[3]);
      }
#pragma unroll
      for (int ni = 0; ni < G::kWN; ++ni) {
        const float4 w = *reinterpret_cast<const float4*>(b_s + (s * G::kNT + ni) * 128);
        const tf32x3::FragB b{{__float_as_uint(w.x), __float_as_uint(w.z)},
                              {__float_as_uint(w.y), __float_as_uint(w.w)}};
#pragma unroll
        for (int mi = 0; mi < G::kWM; ++mi) tf32x3::mma3_add(acc[mi][ni], f[mi], b);
      }
    }
  };
  tf32x3::pipeline<kStages>((nks + G::kKS - 1) / G::kKS, stage, compute);
}

template <int C>
__device__ __forceinline__ void zero(TcAcc<C>& acc) {
#pragma unroll
  for (int mi = 0; mi < Tc<C>::kWM; ++mi)
#pragma unroll
    for (int ni = 0; ni < Tc<C>::kWN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// out = x + conv2(leaky(conv1(leaky(x)) + b1)) + b2 over one tile of one
// chain, both convs on the tensor cores. conv1 computes kRows rows from
// t0 - p2, conv2 the tile's kRows - 2 p2 outputs from t0. At most 128
// registers a thread, so that two blocks share an SM.
template <int C>
__global__ void __launch_bounds__(kThreads, 2) resunit_tc_kernel(Units units, int T,
                                                                 float slope) {
  using G = Tc<C>;
  const Unit& a = units.u[blockIdx.z];
  const int K = a.K;
  const int p2 = (K - 1) / 2;
  const int p1 = p2 * a.dil;
  const int tt = G::kRows - 2 * p2;  // output rows of the tile
  const int t0 = blockIdx.x * tt;
  if (t0 >= T) return;  // the grid covers the chain with the most tiles
  const int xrows = G::kRows + 2 * p1;

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // kStages x kChunkF
  float* x_s = ring + kStages * kChunkF;          // xrows x kLd
  float* h_s = x_s;  // (kRows + K - 1) x kLd, over x_s once conv1 is done

  const int b = blockIdx.y;
  const float* xb = a.x + (size_t)b * T * C;
  const int base = t0 - p1 - p2;
  constexpr int kQ = C / 4;  // float4 pieces of a row
#pragma unroll 4
  for (int e = threadIdx.x; e < xrows * kQ; e += kThreads) {
    const int rr = e / kQ, q = (e % kQ) * 4, t = base + rr;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C + q));
      v = make_float4(leaky(v.x, slope), leaky(v.y, slope), leaky(v.z, slope),
                      leaky(v.w, slope));
    }
    *reinterpret_cast<float4*>(x_s + rr * G::kLd + q) = v;
  }

  TcAcc<C> acc;
  zero<C>(acc);
  conv_tc<C>(x_s, a.w1, ring, K, a.dil, acc);  // ends on a barrier: x_s is
  // fully read, h_s takes its place
  for_each_pair<C>([&](int mi, int ni, int h, int row, int col) {
    const int t = t0 - p2 + row;
    float2 v = make_float2(0.f, 0.f);
    if (t >= 0 && t < T) {
      const float2 bb = ld2(a.b1 + col);
      v = make_float2(leaky(acc[mi][ni][2 * h] + bb.x, slope),
                      leaky(acc[mi][ni][2 * h + 1] + bb.y, slope));
    }
    st2(h_s + row * G::kLd + col, v);
  });
  // rows past conv1's output are read only by conv2 rows past the tile
  for (int e = threadIdx.x; e < (K - 1) * C; e += kThreads)
    h_s[(G::kRows + e / C) * G::kLd + e % C] = 0.f;

  zero<C>(acc);
  conv_tc<C>(h_s, a.w2, ring, K, 1, acc);

  float* ob = a.out + (size_t)b * T * C;
  for_each_pair<C>([&](int mi, int ni, int h, int row, int col) {
    const int t = t0 + row;
    if (row >= tt || t >= T) return;
    const size_t o = (size_t)t * C + col;
    const float2 bb = ld2(a.b2 + col), xv = ld2(xb + o);
    st2(ob + o, make_float2(xv.x + (acc[mi][ni][2 * h] + bb.x),
                            xv.y + (acc[mi][ni][2 * h + 1] + bb.y)));
  });
}

struct Sources {
  const float* p[kMaxChains];
};

// out = (src[0] + src[1] + ... + src[n-1]) * scale: the MRF mean, summed in
// the JAX package's order.
__global__ void __launch_bounds__(kThreads) mean_kernel(Sources src, int n,
                                                        float* __restrict__ out,
                                                        long long numel,
                                                        float scale) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < numel;
       i += (long long)gridDim.x * kThreads) {
    float acc = src.p[0][i];
    for (int j = 1; j < n; ++j) acc += src.p[j][i];
    out[i] = acc * scale;
  }
}

// y = conv_transpose(leaky(x)) + bias; w is (K, CIN, COUT) in gather form.
template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads) deconv_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ bias, int T,
    int Tout, int K, int stride, int pad, int lo, int hi, float slope) {
  using M = Map<COUT>;
  constexpr int S = CIN + 1;
  constexpr int mt = M::R * kDeconvRows;  // input-rate rows per tile
  const int xrows = mt + hi - lo;

  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * mt;
  const float* xb = x + (size_t)b * T * CIN;
  for (int idx = threadIdx.x; idx < xrows * CIN; idx += kThreads) {
    const int rr = idx / CIN, cc = idx % CIN;
    const int i = m0 + lo + rr;
    x_s[rr * S + cc] =
        (i >= 0 && i < T) ? leaky(xb[(size_t)i * CIN + cc], slope) : 0.f;
  }
  __syncthreads();

  const int g = threadIdx.x % M::G;
  const int r = threadIdx.x / M::G;
  const int co0 = g * M::TN;
  float* yb = y + (size_t)b * Tout * COUT;
  for (int ph = 0; ph < stride; ++ph) {
    float acc[kDeconvRows][M::TN];
#pragma unroll
    for (int i = 0; i < kDeconvRows; ++i)
#pragma unroll
      for (int j = 0; j < M::TN; ++j) acc[i][j] = bias[co0 + j];
    // taps with (ph - (K-1) + pad + k) divisible by the stride
    const int k0 = (((K - 1 - pad - ph) % stride) + stride) % stride;
    for (int k = k0; k < K; k += stride) {
      const int off = (ph - (K - 1) + pad + k) / stride - lo;  // exact
      const float* wk = w + (size_t)k * CIN * COUT + co0;
      const float* xrow = x_s + (r + off) * S;
      for (int ci = 0; ci < CIN; ++ci) {
        float wv[M::TN];
#pragma unroll
        for (int j = 0; j < M::TN; ++j) wv[j] = __ldg(wk + ci * COUT + j);
#pragma unroll
        for (int i = 0; i < kDeconvRows; ++i) {
          const float xv = xrow[i * M::R * S + ci];
#pragma unroll
          for (int j = 0; j < M::TN; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDeconvRows; ++i) {
      const int j_out = (m0 + r + i * M::R) * stride + ph;
      if (j_out < Tout) {
#pragma unroll
        for (int j = 0; j < M::TN; ++j)
          yb[(size_t)j_out * COUT + co0 + j] = acc[i][j];
      }
    }
  }
}

// y = tanh(conv(leaky(x)) + bias), "same" padding; w is (K, CIN, cout).
template <int CIN>
__global__ void __launch_bounds__(kThreads) outconv_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ bias, int T, int K,
    int cout, float slope) {
  constexpr int S = CIN + 1;
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);

  const int p = (K - 1) / 2;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kThreads;
  const int xrows = kThreads + K - 1;
  const float* xb = x + (size_t)b * T * CIN;
  for (int idx = threadIdx.x; idx < xrows * CIN; idx += kThreads) {
    const int rr = idx / CIN, cc = idx % CIN;
    const int t = t0 - p + rr;
    x_s[rr * S + cc] =
        (t >= 0 && t < T) ? leaky(xb[(size_t)t * CIN + cc], slope) : 0.f;
  }
  __syncthreads();

  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  for (int co = 0; co < cout; ++co) {
    float acc = bias[co];
    for (int k = 0; k < K; ++k) {
      const float* xr = x_s + (threadIdx.x + k) * S;
      const float* wk = w + (size_t)k * CIN * cout + co;
#pragma unroll 8
      for (int ci = 0; ci < CIN; ++ci)
        acc = fmaf(xr[ci], __ldg(wk + (size_t)ci * cout), acc);
    }
    y[((size_t)b * T + t) * cout + co] = tanhf(acc);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

template <int C>
int launch_resunits(const Units& units, int n, int B, int T, float slope,
                    cudaStream_t stream) {
  using M = Map<C>;
  constexpr int rows = M::R * kUnitRows;
  int max_tiles = 0, max_xrows = 0;
  for (int i = 0; i < n; ++i) {
    const int p2 = (units.u[i].K - 1) / 2;
    const int tt = rows - 2 * p2;
    if (tt <= 0) return cudaErrorInvalidValue;
    max_tiles = max_tiles > (T + tt - 1) / tt ? max_tiles : (T + tt - 1) / tt;
    const int xrows = rows + 2 * p2 * units.u[i].dil;  // rows + 2 * p1
    max_xrows = max_xrows > xrows ? max_xrows : xrows;
  }
  // h (rows + 2 * p2 rows) reuses the x rows (rows + 2 * p1 >= that)
  const size_t smem =
      sizeof(float) * (2 * (size_t)M::CH * C + (size_t)max_xrows * M::S);
  cudaError_t e = set_smem(resunit_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(max_tiles, B, n);
  resunit_kernel<C><<<grid, kThreads, smem, stream>>>(units, T, slope);
  return cudaGetLastError();
}

template <int C>
int launch_resunits_tc(const Units& units, int n, int B, int T, float slope,
                       cudaStream_t stream) {
  using G = Tc<C>;
  int max_tiles = 0, max_xrows = 0;
  for (int i = 0; i < n; ++i) {
    const int K = units.u[i].K;
    const int tt = G::kRows - (K - 1);
    if (tt <= 0) return cudaErrorInvalidValue;
    max_tiles = max_tiles > (T + tt - 1) / tt ? max_tiles : (T + tt - 1) / tt;
    const int xrows = G::kRows + (K - 1) * units.u[i].dil;  // >= h's kRows + K - 1
    max_xrows = max_xrows > xrows ? max_xrows : xrows;
  }
  const size_t smem =
      sizeof(float) * ((size_t)kStages * kChunkF + (size_t)max_xrows * G::kLd);
  cudaError_t e = set_smem(resunit_tc_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(max_tiles, B, n);
  resunit_tc_kernel<C><<<grid, kThreads, smem, stream>>>(units, T, slope);
  return cudaGetLastError();
}

template <int CIN>
int launch_deconv(const float* x, float* y, const float* w, const float* bias,
                  int B, int T, int Tout, int K, int stride, int pad,
                  float slope, cudaStream_t stream) {
  constexpr int COUT = CIN / 2;
  using M = Map<COUT>;
  constexpr int mt = M::R * kDeconvRows;
  const int lo = floor_div(pad - (K - 1), stride);
  const int hi = floor_div(stride - 1 + pad, stride);
  const size_t smem = sizeof(float) * (size_t)(mt + hi - lo) * (CIN + 1);
  cudaError_t e = set_smem(deconv_kernel<CIN, COUT>, smem);
  if (e != cudaSuccess) return e;
  const int m_total = (Tout + stride - 1) / stride;
  const dim3 grid((m_total + mt - 1) / mt, B);
  deconv_kernel<CIN, COUT><<<grid, kThreads, smem, stream>>>(
      x, y, w, bias, T, Tout, K, stride, pad, lo, hi, slope);
  return cudaGetLastError();
}

template <int CIN>
int launch_outconv(const float* x, float* y, const float* w, const float* bias,
                   int B, int T, int K, int cout, float slope,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(kThreads + K - 1) * (CIN + 1);
  cudaError_t e = set_smem(outconv_kernel<CIN>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + kThreads - 1) / kThreads, B);
  outconv_kernel<CIN><<<grid, kThreads, smem, stream>>>(x, y, w, bias, T, K,
                                                        cout, slope);
  return cudaGetLastError();
}

bool bad_shape(int B, int T) { return B < 1 || B > 65535 || T < 1; }

}  // namespace

// Each entry point returns a cudaError_t value: 0 when the launch was
// accepted. Widths are powers of two up to 128.
extern "C" {

// One launch for n <= kMaxChains residual units (one per MRF chain); the
// arrays hold each unit's pointers, kernel size and dilation. At C >= 16
// the units run on the tensor cores and read f1, f2 (the split weights of
// ops/kernels/tf32x3.py mrf_fragments, 16-byte aligned; biases and x
// 8- and 16-byte aligned); below, on the CUDA cores, they read w1, w2 and
// f1, f2 may be null.
int hifigan_resunits(int n, const float* const* x, float* const* out,
                     const float* const* w1, const float* const* b1,
                     const float* const* w2, const float* const* b2,
                     const float* const* f1, const float* const* f2,
                     const int* K, const int* dil, int B, int T, int C,
                     float slope, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_shape(B, T) || n < 1 || n > kMaxChains) return cudaErrorInvalidValue;
  const bool tc = C >= 16;
  if (tc && (f1 == nullptr || f2 == nullptr)) return cudaErrorInvalidValue;
  Units units = {};
  for (int i = 0; i < n; ++i) {
    if (K[i] < 1 || K[i] % 2 == 0 || dil[i] < 1) return cudaErrorInvalidValue;
    if (tc && (f1[i] == nullptr || f2[i] == nullptr)) return cudaErrorInvalidValue;
    units.u[i] = Unit{x[i], out[i], tc ? f1[i] : w1[i], b1[i], tc ? f2[i] : w2[i],
                      b2[i], K[i], dil[i]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return launch_resunits<1>(units, n, B, T, slope, s);
    case 2:
      return launch_resunits<2>(units, n, B, T, slope, s);
    case 4:
      return launch_resunits<4>(units, n, B, T, slope, s);
    case 8:
      return launch_resunits<8>(units, n, B, T, slope, s);
    case 16:
      return launch_resunits_tc<16>(units, n, B, T, slope, s);
    case 32:
      return launch_resunits_tc<32>(units, n, B, T, slope, s);
    case 64:
      return launch_resunits_tc<64>(units, n, B, T, slope, s);
    case 128:
      return launch_resunits_tc<128>(units, n, B, T, slope, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int hifigan_deconv(const float* x, float* y, const float* w, const float* bias,
                   int B, int T, int Tout, int Cin, int Cout, int K,
                   int stride, int pad, float slope, int device,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_shape(B, T) || Tout < 1 || K < 1 || stride < 1 || pad < 0 ||
      Cout * 2 != Cin)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PWG_DECONV(c)                                                        \
  case c:                                                                    \
    return launch_deconv<c>(x, y, w, bias, B, T, Tout, K, stride, pad, slope, \
                            s);
  switch (Cin) {
    PWG_DECONV(2) PWG_DECONV(4) PWG_DECONV(8) PWG_DECONV(16)
    PWG_DECONV(32) PWG_DECONV(64) PWG_DECONV(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PWG_DECONV
}

int hifigan_outconv(const float* x, float* y, const float* w,
                    const float* bias, int B, int T, int Cin, int Cout, int K,
                    float slope, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_shape(B, T) || K < 1 || K % 2 == 0 || Cout < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PWG_OUT(c) \
  case c:          \
    return launch_outconv<c>(x, y, w, bias, B, T, K, Cout, slope, s);
  switch (Cin) {
    PWG_OUT(1) PWG_OUT(2) PWG_OUT(4) PWG_OUT(8)
    PWG_OUT(16) PWG_OUT(32) PWG_OUT(64) PWG_OUT(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PWG_OUT
}

// out = mean of n <= kMaxChains buffers of numel floats.
int hifigan_mean(int n, const float* const* src, float* out, long long numel,
                 int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n < 1 || n > kMaxChains || numel < 1) return cudaErrorInvalidValue;
  Sources sources = {};
  for (int i = 0; i < n; ++i) sources.p[i] = src[i];
  const long long want = (numel + kThreads - 1) / kThreads;
  const int blocks = want < 132 * 32 ? (int)want : 132 * 32;
  mean_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sources, n, out, numel, 1.0f / n);
  return cudaGetLastError();
}

const char* hifigan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
