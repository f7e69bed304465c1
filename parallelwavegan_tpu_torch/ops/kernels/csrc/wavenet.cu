// Fused WaveNet gated residual layer for Hopper (sm_90a), float32.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   parallelwavegan_tpu/ops/pallas_kernels/wavenet_stack.py:199
//     fused_wavenet_stack (K3, one dilation cycle per call; the forward of
//     wavenet_stack_train.py:338 wavenet_stack_train too), and
//   parallelwavegan_tpu/ops/pallas_kernels/wavenet.py:280
//     fused_gated_resblock (K5, one layer, optional causal padding).
// One launch computes one layer, in the channel-last (B, T, C) layout of
// the JAX package, for every row t of every batch item:
//   z     = sum_k x[t + k*dil - left] . Wconv[k] + bconv + c[t] . Waux
//   g     = tanh(z[:, :H]) * sigmoid(z[:, H:])
//   skip  = g . Wskip + bskip            (added to skip when accumulating)
//   x_out = (g . Wres + bres + x[t]) * sqrt(1/2)
// with rows of x outside [0, T) read as zero at every layer, as the JAX
// reference pads each layer (wavenet_stack.py:122-130). left is
// (K-1)*dil/2 (floor), or (K-1)*dil when causal. Python
// (ops/kernels/wavenet.py) runs a cycle as one launch per layer on the
// current stream and ping-pongs x between two buffers; this file
// allocates nothing.
//
// What bounds it on the card. At Parallel WaveGAN v1 widths (residual 64,
// gate 128, skip 64, aux 80, K = 3) one layer takes 3*64*128 + 80*128 +
// 64*64 + 64*64 = 43,008 multiply-adds per sample, against 4 * (64 + 80
// + 64 + 64) = 1,088 bytes of activations in and out: about 79 FLOP per
// byte, far above the card's float32 balance point (67 TFLOP/s over
// 3.35 TB/s = 20). One 10-layer cycle at 512 frames (T = 131,072) is
// 112.7 GFLOP, at least 1.68 ms on the CUDA cores, against 0.04 ms for
// the bytes a fused cycle must move, and 1.6 ms per decode even for the
// per-layer round trips of this design. So it is bound by FMA issue and
// by the shared-memory loads that feed it. The products are FFMA:
// one TF32 product per multiply missed the 1e-4 max|plain| agreement with
// the float32 reference in K4 on the card (4.6e-4 to 1.3e-3 of max|plain|
// at v1 shapes; PERF.md), where split TF32 on the tensor cores held
// it within 1e-5; this kernel's products are of the same kind, and split
// TF32 is untried here.
//
// What the design does about it:
//  - The TPU kernel keeps a whole cycle resident with a 1,023-row halo
//    per side; a 64-channel float32 tile with that halo does not fit a
//    block's 227 KB of shared memory, so a cycle here is one launch per
//    layer. The TPU's 128-lane channel padding and its small-dilation
//    XLA fallback are layout rules of that chip and are not carried
//    over.
//  - A block owns TT rows of one batch item. Both products of the layer
//    are (TT x depth) . (depth x 2H) with 2H = 128 output columns: the
//    gate pre-activation over depth K*C + Ca = 272, then [skip | res]
//    over the H = 64 gated channels. Each thread holds 16 rows x 4
//    columns in registers. Its four columns are a pair of tanh columns
//    and the matching pair of sigmoid columns, so the gate is applied
//    in registers; the [skip | res] pair is chosen the same way.
//  - The reduction is streamed in chunks of 32 input channels (of one
//    tap of x, or of c): the activation rows of the chunk and the
//    weight rows, permuted into the thread's column order while they
//    are copied, go through shared memory double-buffered with
//    cp.async, so that the next chunk's loads run under this chunk's
//    FMAs. Rows outside [0, T) are written as zeros instead of copied.
//    Each FMA step reads four input channels of one row as a float4
//    broadcast and the weights as one float4 per thread. The block is
//    held to 128 registers a thread (no spills) so that two blocks share
//    an SM: at 142 registers only one fitted, and a v1 cycle took 4.6 ms
//    instead of 3.7 on an H100 (chip_smoke.py).
//  - g stays in shared memory (over the dead activation buffers) for
//    the second product; skip and x_out are written once, and skip is
//    read-modified-written by the one thread that owns each element,
//    so there are no atomics.
// Blocks share nothing and carry nothing from tile to tile.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows per thread
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr size_t kMaxSmem = 227 * 1024;

// Thread map for H = CH gated channels (residual = skip = CH, gate = 2*CH):
// G threads across channel pairs, R row groups, TT rows per tile, CW
// input channels per streamed chunk, N = 2*CH staged output columns.
template <int CH>
struct WMap {
  static constexpr int G = CH / 2;
  static constexpr int R = kThreads / G;
  static constexpr int TT = R * kRows;
  static constexpr int CW = CH < 32 ? CH : 32;
  static constexpr int N = 2 * CH;
  static_assert(kThreads % G == 0 && CH % CW == 0 && CW % 4 == 0, "width");
  static_assert(2 * CW >= CH, "g (TT x CH) must fit the activation buffers");
};

struct Layer {
  const float* x;      // (B, T, CH)
  const float* c;      // (B, T, Ca)
  float* x_out;        // (B, T, CH)
  float* skip;         // (B, T, CH)
  const float* wconv;  // (K, CH, 2CH)
  const float* bconv;  // (2CH)
  const float* waux;   // (Ca, 2CH)
  const float* wskip;  // (CH, CH)
  const float* bskip;  // (CH)
  const float* wres;   // (CH, CH)
  const float* bres;   // (CH)
  int T, Ca, K, dil, left, accumulate;
};

// dst[j][4g .. 4g+1] = a[j][2g .. 2g+1], dst[j][4g+2 .. 4g+3] = b[j][2g ..
// 2g+1] for the CW rows j of a chunk; rows j >= valid are zero.
template <int CH>
__device__ __forceinline__ void stage_pairs(float* dst, const float* a,
                                            const float* b, int stride,
                                            int valid) {
  using M = WMap<CH>;
  for (int e = threadIdx.x; e < M::CW * CH; e += kThreads) {
    const int j = e / CH, h = e % CH;  // h: 2 * pair + which
    const int g = h >> 1, which = h & 1;
    float* d = dst + j * M::N + 4 * g + 2 * which;
    if (j < valid) {
      __pipeline_memcpy_async(d, (which ? b : a) + (size_t)j * stride + 2 * g, 8);
    } else {
      d[0] = 0.f;
      d[1] = 0.f;
    }
  }
}

// Start copying chunk idx of the gate product: the activation rows (TT x
// CW, row-major) and the weight rows (CW x N, thread column order), as
// one cp.async group. Chunks 0 .. K*CH/CW - 1 are taps of x, the rest
// are channels of c.
template <int CH>
__device__ __forceinline__ void stage_gate_chunk(const Layer& p, int b, int t0,
                                                 int idx, float* a_dst,
                                                 float* w_dst) {
  using M = WMap<CH>;
  constexpr int kPerTap = CH / M::CW;
  const int n_x = p.K * kPerTap;
  if (idx < n_x) {
    const int k = idx / kPerTap;
    const int c0 = (idx % kPerTap) * M::CW;
    const int base = t0 + k * p.dil - p.left;
    const float* xb = p.x + (size_t)b * p.T * CH + c0;
    for (int e = threadIdx.x; e < M::TT * (M::CW / 4); e += kThreads) {
      const int row = e / (M::CW / 4), q = (e % (M::CW / 4)) * 4;
      const int t = base + row;
      float* d = a_dst + row * M::CW + q;
      if (t >= 0 && t < p.T) {
        __pipeline_memcpy_async(d, xb + (size_t)t * CH + q, 16);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    const float* w = p.wconv + ((size_t)k * CH + c0) * M::N;
    stage_pairs<CH>(w_dst, w, w + CH, M::N, M::CW);
  } else {
    const int c0 = (idx - n_x) * M::CW;
    const float* cb = p.c + (size_t)b * p.T * p.Ca;
    for (int e = threadIdx.x; e < M::TT * M::CW; e += kThreads) {
      const int row = e / M::CW, j = e % M::CW;
      const int t = t0 + row, ch = c0 + j;
      float* d = a_dst + row * M::CW + j;
      if (t < p.T && ch < p.Ca) {
        __pipeline_memcpy_async(d, cb + (size_t)t * p.Ca + ch, 4);
      } else {
        *d = 0.f;
      }
    }
    const float* w = p.waux + (size_t)c0 * M::N;
    const int valid = p.Ca - c0 < M::CW ? p.Ca - c0 : M::CW;
    stage_pairs<CH>(w_dst, w, w + CH, M::N, valid);
  }
  __pipeline_commit();
}

// acc[i][j] += sum_ci a_s[row_i][col0 + ci] * w_s[ci][4g + j] over the CW
// channels of one chunk, row_i = r + i*R.
template <int CH>
__device__ __forceinline__ void fma_chunk(const float* __restrict__ a_s,
                                          int stride, int col0,
                                          const float* __restrict__ w_s,
                                          int r, int g,
                                          float (&acc)[kRows][4]) {
  using M = WMap<CH>;
  const float* arow = a_s + r * stride + col0;
#pragma unroll 1  // unrolling further costs the registers of a second block
  for (int ci = 0; ci < M::CW; ci += 4) {
    float4 w[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      w[cc] = *reinterpret_cast<const float4*>(w_s + (ci + cc) * M::N + 4 * g);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 xv =
          *reinterpret_cast<const float4*>(arow + i * M::R * stride + ci);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        acc[i][0] = fmaf(xs[cc], w[cc].x, acc[i][0]);
        acc[i][1] = fmaf(xs[cc], w[cc].y, acc[i][1]);
        acc[i][2] = fmaf(xs[cc], w[cc].z, acc[i][2]);
        acc[i][3] = fmaf(xs[cc], w[cc].w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// At most 128 registers a thread, so that two blocks (16 warps) share an SM.
template <int CH>
__global__ void __launch_bounds__(kThreads, 2) wavenet_layer_kernel(Layer p) {
  using M = WMap<CH>;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // 2 x CW x N
  float* a_s = w_s + 2 * M::CW * M::N;            // 2 x TT x CW
  float* g_s = a_s;  // TT x CH, over the activation buffers once read

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * M::TT;
  const int g = threadIdx.x % M::G;
  const int r = threadIdx.x / M::G;

  // gate pre-activation: columns (2g, 2g+1) of the tanh half and of the
  // sigmoid half
  float acc[kRows][4];
  {
    const float b0 = p.bconv[2 * g], b1 = p.bconv[2 * g + 1];
    const float b2 = p.bconv[CH + 2 * g], b3 = p.bconv[CH + 2 * g + 1];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i][0] = b0;
      acc[i][1] = b1;
      acc[i][2] = b2;
      acc[i][3] = b3;
    }
  }
  const int n1 = p.K * (CH / M::CW) + (p.Ca + M::CW - 1) / M::CW;
  stage_gate_chunk<CH>(p, b, t0, 0, a_s, w_s);
  for (int c = 0; c < n1; ++c) {
    if (c + 1 < n1) {
      const int nb = (c + 1) & 1;
      stage_gate_chunk<CH>(p, b, t0, c + 1, a_s + nb * M::TT * M::CW,
                           w_s + nb * M::CW * M::N);
      __pipeline_wait_prior(1);  // all but the newest group: chunk c
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk c visible to every thread
    fma_chunk<CH>(a_s + (c & 1) * M::TT * M::CW, M::CW, 0,
                  w_s + (c & 1) * M::CW * M::N, r, g, acc);
    __syncthreads();  // chunk c consumed: its buffers are refilled next
  }

  // gate, into shared memory for the second product
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r + i * M::R;
    const float g0 = tanhf(acc[i][0]) * sigmoid(acc[i][2]);
    const float g1 = tanhf(acc[i][1]) * sigmoid(acc[i][3]);
    *reinterpret_cast<float2*>(g_s + row * CH + 2 * g) = make_float2(g0, g1);
  }

  // [skip | res]: columns (2g, 2g+1) of each
  {
    const float b0 = p.bskip[2 * g], b1 = p.bskip[2 * g + 1];
    const float b2 = p.bres[2 * g], b3 = p.bres[2 * g + 1];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i][0] = b0;
      acc[i][1] = b1;
      acc[i][2] = b2;
      acc[i][3] = b3;
    }
  }
  constexpr int n2 = CH / M::CW;
  stage_pairs<CH>(w_s, p.wskip, p.wres, CH, M::CW);
  __pipeline_commit();
#pragma unroll 1
  for (int c = 0; c < n2; ++c) {
    if (c + 1 < n2) {
      const size_t off = (size_t)(c + 1) * M::CW * CH;
      stage_pairs<CH>(w_s + ((c + 1) & 1) * M::CW * M::N, p.wskip + off,
                      p.wres + off, CH, M::CW);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // weights of chunk c and (first time) g visible
    fma_chunk<CH>(g_s, CH, c * M::CW, w_s + (c & 1) * M::CW * M::N, r, g, acc);
    __syncthreads();
  }

  const size_t bo = (size_t)b * p.T * CH;
  const float* __restrict__ xb = p.x + bo;
  float* __restrict__ sk = p.skip + bo;
  float* __restrict__ xo = p.x_out + bo;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + r + i * M::R;
    if (t < p.T) {
      const size_t o = (size_t)t * CH + 2 * g;
      float2 s = make_float2(acc[i][0], acc[i][1]);
      if (p.accumulate) {
        const float2 prev = *reinterpret_cast<const float2*>(sk + o);
        s.x = prev.x + s.x;
        s.y = prev.y + s.y;
      }
      *reinterpret_cast<float2*>(sk + o) = s;
      const float2 xr = *reinterpret_cast<const float2*>(xb + o);
      *reinterpret_cast<float2*>(xo + o) = make_float2(
          (acc[i][2] + xr.x) * kSqrtHalf, (acc[i][3] + xr.y) * kSqrtHalf);
    }
  }
}

template <int CH>
int launch_layer(const Layer& p, int B, cudaStream_t stream) {
  using M = WMap<CH>;
  const size_t smem =
      sizeof(float) * (2 * (size_t)M::CW * M::N + 2 * (size_t)M::TT * M::CW);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wavenet_layer_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + M::TT - 1) / M::TT, B);
  wavenet_layer_kernel<CH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One gated layer. C is the residual width, which the kernel takes equal
// to the skip width and to half the gate width (16 or 64); Ca >= 1 is
// the conditioning width. skip is written (accumulate 0) or added to
// (accumulate 1). Returns a cudaError_t value: 0 when the launch was
// accepted.
int wavenet_layer(const float* x, const float* c, float* x_out, float* skip,
                  const float* wconv, const float* bconv, const float* waux,
                  const float* wskip, const float* bskip, const float* wres,
                  const float* bres, int B, int T, int C, int Ca, int K,
                  int dil, int causal, int accumulate, int device,
                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || B > 65535 || T < 1 || Ca < 1 || K < 1 || dil < 1)
    return cudaErrorInvalidValue;
  const int pad = (K - 1) * dil;
  const Layer p{x,     c,     x_out, skip, wconv, bconv,
                waux,  wskip, bskip, wres, bres,  T,
                Ca,    K,     dil,   causal ? pad : pad / 2,
                accumulate ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16:
      return launch_layer<16>(p, B, s);
    case 64:
      return launch_layer<64>(p, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
