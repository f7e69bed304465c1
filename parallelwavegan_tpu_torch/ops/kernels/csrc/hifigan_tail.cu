// Fused HiFi-GAN decode tail for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel
// parallelwavegan_tpu/ops/pallas_kernels/hifigan_tail.py:fused_hifigan_tail
// (kernel body _kernel_tail). It computes, in the channel-last (B, T, C)
// layout of the JAX package: an optional MRF at the entry rate, then per
// stage leaky -> ConvTranspose1d(k = 2s, s) -> mean of the MRF resblocks,
// then leaky(0.01) -> Conv1d(k) -> tanh. Python (ops/kernels/hifigan_tail.py)
// sequences the launches below on one stream; the wrapper allocates every
// buffer and this file allocates nothing.
//
// What bounds it on the card. For HiFi-GAN v1 at 512 mel frames the tail
// works on 32768 x 128, 65536 x 64 and 131072 x 32 samples x channels:
// every activation is 16.8 MB in float32. Its 18 MRF convs per stage (K =
// 3, 7, 11 at three dilations, two convs each) take 126 taps of C x C
// multiply-adds per sample, 119 G multiply-adds (239 GFLOP) for the whole
// tail, against about 1.1 GB of activation traffic with the intermediates
// below going through device memory. In float32 on the CUDA cores (67
// TFLOP/s, no TF32: the JAX reference computes in full f32) that is at
// least 3.6 ms of arithmetic against 0.3 ms of bytes at 3.35 TB/s, so this
// version is bound by FMA issue and shared-memory loads, not by HBM. The
// TPU kernel's space-to-depth lane packing only filled the 128-lane MXU
// and is not carried over.
//
// What the design does about it:
//  (a) resunit_kernel: one block per (time tile, batch, resblock) computes
//      one MRF residual unit x + conv_k1(leaky(conv_kd(leaky(x)))) for the
//      tile. The resblocks of an MRF are independent chains, so one launch
//      runs the units of one dilation depth for all of them: a v1 MRF is
//      3 launches of about 1,700 tiles instead of 9 of 529-607, which
//      leaves far less of the last wave of blocks empty.
//      leaky(x) for tile + halo and the conv_kd output for tile + halo stay
//      in shared memory, so each unit reads its input once and writes its
//      output once. The conv_kd output at positions outside [0, T) is set
//      to zero before the second conv ("same" zero padding per conv, the
//      TPU kernel's mask_rows), and written over the leaky(x) rows, which
//      conv_kd no longer needs: at C = 128 a block takes 92 KB, so two
//      blocks share an SM. Each thread holds an 8-row x 4-channel register
//      tile and reads activations and weights as float4, so that
//      shared-memory loads, not FMA issue, are no longer the first limit.
//      Weights go through shared memory 32 input channels of one tap at a
//      time, double-buffered with cp.async so that the next chunk's L2
//      latency hides under this chunk's FMAs.
//      mean_kernel then averages the resblocks' outputs.
//  (b) deconv_kernel: leaky -> strided transposed conv + bias in gather
//      form, y[j] = sum_k xd[j - (K-1) + pad + k] . w[k] with xd[s*i] =
//      x[i]. Outputs are computed phase by phase (j = s*m + ph), so every
//      thread of a phase takes the same taps.
//  (c) outconv_kernel: leaky(0.01) -> Conv1d(k) -> tanh, one output
//      sample per thread.
// Blocks share nothing and carry nothing from tile to tile.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

// out = x + conv2(leaky(conv1(leaky(x)))) over one tile of one chain.
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
// arrays hold each unit's pointers, kernel size and dilation.
int hifigan_resunits(int n, const float* const* x, float* const* out,
                     const float* const* w1, const float* const* b1,
                     const float* const* w2, const float* const* b2,
                     const int* K, const int* dil, int B, int T, int C,
                     float slope, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_shape(B, T) || n < 1 || n > kMaxChains) return cudaErrorInvalidValue;
  Units units = {};
  for (int i = 0; i < n; ++i) {
    if (K[i] < 1 || K[i] % 2 == 0 || dil[i] < 1) return cudaErrorInvalidValue;
    units.u[i] = Unit{x[i], out[i], w1[i], b1[i], w2[i], b2[i], K[i], dil[i]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PWG_UNIT(c) \
  case c:           \
    return launch_resunits<c>(units, n, B, T, slope, s);
  switch (C) {
    PWG_UNIT(1) PWG_UNIT(2) PWG_UNIT(4) PWG_UNIT(8)
    PWG_UNIT(16) PWG_UNIT(32) PWG_UNIT(64) PWG_UNIT(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PWG_UNIT
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
