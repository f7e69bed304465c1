// Fused MelGAN residual stacks for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel
// parallelwavegan_tpu/ops/pallas_kernels/melgan_stack.py:285
// fused_melgan_stacks_interior (K6, reached through :250
// fused_melgan_stacks). It computes melgan_stacks_xla (:83-101) on the
// whole sequence, padding included, in the channel-last (B, T, C) layout
// of the JAX package. One launch of stack_kernel computes one
// ResidualStack for every row t of every batch item:
//   z   = sum_k leaky(x_pad[t + (k - (K-1)/2) * d]) . Wd[k] + bd
//   out = leaky(z) . W1 + b1 + x[t] . Ws + bs
// where x_pad extends x past both ends by the stack's pad mode: reflect
// (p < 0 reads -p, p >= T reads 2T - 2 - p), replicate (clamp) or zeros.
// outconv_kernel is the generator's trailing act -> k-tap conv -> tanh,
// padded the same way. Python (ops/kernels/melgan_stack.py) sequences a
// stage's launches on one stream and allocates every buffer; this file
// allocates nothing.
//
// What bounds it on the card. Multi-band MelGAN v2 at 512 mel frames runs
// four stacks (dilations 1, 3, 9, 27) at T = 16384, C = 96 and four more
// at T = 32768, C = 48, then the k7 conv to 4 sub-bands. A stack takes 5
// C x C multiply-adds per sample (three taps, the 1x1 conv and the skip),
// 6.04 GFLOP for stage 1 and 3.11 GFLOP for stage 2 with its final conv,
// against 6 MB of activations in and out per launch. In float32 on the
// CUDA cores (67 TFLOP/s; the products are FFMA: one TF32 product per
// multiply missed the 1e-4 max|plain| agreement with the float32
// reference in K4 on the card, 4.6e-4 to 1.3e-3 of max|plain| at v1
// shapes, where split TF32 held it within 1e-5, PERF.md; split TF32
// is untried here) that is 0.090 and 0.046 ms of arithmetic against
// about 0.002 ms of bytes per launch at 3.35 TB/s, so the kernel is bound
// by FMA issue and by the shared-memory loads that feed it, not by HBM.
//
// What the design does about it:
//  - The TPU kernel packs p = 128 / C samples into the 128 lanes with
//    block-matrix weights to fill the MXU, keeps a stage's whole chain in
//    VMEM, and recomputes the first and last R outputs with the XLA twin
//    because its halos are zero-masked. None of that is carried over:
//    the padding is applied here per conv when the halo rows are loaded,
//    so no output is recomputed outside the kernel, and the block reads
//    the gather-form (K, Cin, Cout) weights as they are.
//  - A block owns TT rows of one batch item. Both products are (TT x
//    depth) . (depth x C): the dilated conv over depth K*C, then [leaky(z)
//    | x] . [W1; Ws] over depth 2C, so the 1x1 conv and the skip are one
//    product. Each thread holds 8 rows x 4 output channels in registers
//    (C / 4 threads across the channels, 256 / (C / 4) row groups), so
//    widths that are multiples of 16 but not powers of two (MB-MelGAN's 96
//    and 48) run natively with up to 256 threads and no padded lanes.
//  - leaky(x) for tile + halo, then [leaky(z) | x] for the tile, live in
//    one shared-memory buffer (the second over the first once it is
//    read), rows C + 4 or 2C + 4 floats apart for float4 loads. Weights go
//    through shared memory 32 (or 16) input channels at a time,
//    double-buffered with cp.async so that the next chunk's L2 latency
//    hides under this chunk's FMAs.
//  - One launch per stack, as K3's kernel runs one launch per layer;
//    keeping a stage's four stacks on chip (a 40-row halo per side) is
//    later work.
// Blocks share nothing and carry nothing from tile to tile.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;     // at most, per stack_kernel block
constexpr int kRows = 8;          // rows per thread in stack_kernel
constexpr int kOutThreads = 256;  // rows per outconv_kernel block
constexpr size_t kMaxSmem = 227 * 1024;

enum PadMode { kReflect = 0, kEdge = 1, kZero = 2 };

// Thread map for C channels (a multiple of 16 up to 128): G threads across
// the channels, 4 each; R row groups; NT threads launched; TT rows per
// tile; S1 and S2 the shared-memory row strides of leaky(x) and of
// [leaky(z) | x]; CH input channels per streamed weight chunk.
template <int C>
struct SMap {
  static_assert(C % 16 == 0 && C <= 128, "width");
  static constexpr int G = C / 4;
  static constexpr int R = kThreads / G;
  static constexpr int NT = G * R;
  static constexpr int TT = R * kRows;
  static constexpr int S1 = C + 4;
  static constexpr int S2 = 2 * C + 4;
  static constexpr int CH = C % 32 == 0 ? 32 : 16;
};

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The row of x that padded position p reads, or -1 for a zero row. A
// position more than `pad` outside [0, T) feeds only outputs past T,
// which are never stored, and reads zeros.
__device__ __forceinline__ int pad_row(int p, int T, int pad, int mode) {
  if (p >= 0 && p < T) return p;
  if (p < -pad || p >= T + pad || mode == kZero) return -1;
  if (mode == kReflect) return p < 0 ? -p : 2 * T - 2 - p;
  return p < 0 ? 0 : T - 1;
}

// Start the asynchronous copy of one weight chunk (CH x C floats) into
// shared memory, as one cp.async group.
template <int C>
__device__ __forceinline__ void stage_w(float* dst, const float* src) {
  using M = SMap<C>;
  for (int idx = threadIdx.x * 4; idx < M::CH * C; idx += M::NT * 4)
    __pipeline_memcpy_async(dst + idx, src + idx, 16);
  __pipeline_commit();
}

// One chunk of a product: CH x C weights in device memory, and the
// chunk's first activation column of row 0 in shared memory.
struct Chunk {
  const float* w;
  const float* a;
};

// acc[i][j] += sum over chunks c < n, channels ci < CH of
//   chunk(c).a[(r + i*R) * stride + ci] * chunk(c).w[ci * C + 4g + j],
// the next chunk's weights copied into the other half of w_s (2 x CH x C)
// while this one is used. Starts and ends on a barrier.
template <int C, class Src>
__device__ __forceinline__ void gemm_stream(float* w_s, int n, int stride,
                                            Src chunk, int r, int g,
                                            float (&acc)[kRows][4]) {
  using M = SMap<C>;
  constexpr int kChunk = M::CH * C;
  __syncthreads();  // activations written, earlier readers of w_s done
  stage_w<C>(w_s, chunk(0).w);
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage_w<C>(w_s + ((c + 1) & 1) * kChunk, chunk(c + 1).w);
      __pipeline_wait_prior(1);  // all but the newest group: chunk c
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk c visible to every thread
    const float* cur = w_s + (c & 1) * kChunk;
    const float* xrow = chunk(c).a + r * stride;
    // four input channels of all rows per step: 8 broadcast float4 loads
    // of activations and 4 float4 loads of weights feed 128 FMAs
#pragma unroll 2
    for (int ci = 0; ci < M::CH; ci += 4) {
      float4 xv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xrow + i * M::R * stride + ci);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 q =
            *reinterpret_cast<const float4*>(cur + (ci + cc) * C + g * 4);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float x = lane(xv[i], cc);
          acc[i][0] = fmaf(x, q.x, acc[i][0]);
          acc[i][1] = fmaf(x, q.y, acc[i][1]);
          acc[i][2] = fmaf(x, q.z, acc[i][2]);
          acc[i][3] = fmaf(x, q.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // chunk c consumed: its half is refilled next step
  }
}

struct Stack {
  const float* x;   // (B, T, C)
  float* out;       // (B, T, C)
  const float* wd;  // (K, C, C)
  const float* bd;  // (C)
  const float* w1;  // (C, C)
  const float* b1;  // (C)
  const float* ws;  // (C, C)
  const float* bs;  // (C)
  int T, K, dil, mode;
  float slope;
};

// One ResidualStack over one tile of TT rows of one batch item.
template <int C>
__global__ void __launch_bounds__(kThreads) stack_kernel(Stack p) {
  using M = SMap<C>;
  constexpr int kQ = C / 4;  // float4 per row
  constexpr int kPerTap = C / M::CH;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // 2 x CH x C
  float* a_s = w_s + 2 * M::CH * C;  // (TT + 2 pad) x S1, then TT x S2

  const int tid = threadIdx.x;
  const int g = tid % M::G;
  const int r = tid / M::G;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * M::TT;
  const int pad = (p.K - 1) / 2 * p.dil;
  const float* __restrict__ xb = p.x + (size_t)b * p.T * C;

  // leaky(x_pad) over rows t0 - pad .. t0 + TT + pad
  const int rows1 = M::TT + 2 * pad;
  for (int idx = tid; idx < rows1 * kQ; idx += M::NT) {
    const int rr = idx / kQ, q = (idx % kQ) * 4;
    const int src = pad_row(t0 - pad + rr, p.T, pad, p.mode);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0) {
      v = *reinterpret_cast<const float4*>(xb + (size_t)src * C + q);
      v = make_float4(leaky(v.x, p.slope), leaky(v.y, p.slope),
                      leaky(v.z, p.slope), leaky(v.w, p.slope));
    }
    *reinterpret_cast<float4*>(a_s + rr * M::S1 + q) = v;
  }

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = p.bd[g * 4 + j];
  // chunk c: tap c / kPerTap, input channels from (c % kPerTap) * CH
  gemm_stream<C>(w_s, p.K * kPerTap, M::S1, [&](int c) {
    const int k = c / kPerTap, ci0 = (c % kPerTap) * M::CH;
    return Chunk{p.wd + ((size_t)k * C + ci0) * C, a_s + k * p.dil * M::S1 + ci0};
  }, r, g, acc);

  // a_s is read: [leaky(z) | x] over rows t0 .. t0 + TT takes its place
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r + i * M::R;
    *reinterpret_cast<float4*>(a_s + row * M::S2 + g * 4) = make_float4(
        leaky(acc[i][0], p.slope), leaky(acc[i][1], p.slope),
        leaky(acc[i][2], p.slope), leaky(acc[i][3], p.slope));
  }
  for (int idx = tid; idx < M::TT * kQ; idx += M::NT) {
    const int rr = idx / kQ, q = (idx % kQ) * 4;
    const int t = t0 + rr;
    *reinterpret_cast<float4*>(a_s + rr * M::S2 + C + q) =
        t < p.T ? *reinterpret_cast<const float4*>(xb + (size_t)t * C + q)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = p.b1[g * 4 + j] + p.bs[g * 4 + j];
  // chunk c: input channels c * CH of [leaky(z) | x], rows of [W1; Ws]
  gemm_stream<C>(w_s, 2 * kPerTap, M::S2, [&](int c) {
    const int ci0 = c * M::CH;
    const float* w = ci0 < C ? p.w1 + (size_t)ci0 * C : p.ws + (size_t)(ci0 - C) * C;
    return Chunk{w, a_s + ci0};
  }, r, g, acc);

  float* __restrict__ ob = p.out + (size_t)b * p.T * C;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + r + i * M::R;
    if (t < p.T)
      *reinterpret_cast<float4*>(ob + (size_t)t * C + g * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// y = tanh(conv(leaky(x_pad)) + bias); w is (K, C, cout) in gather form,
// one output sample per thread.
__global__ void __launch_bounds__(kOutThreads) outconv_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ bias, int T, int C,
    int cout, int K, int mode, float slope) {
  extern __shared__ float4 smem4[];
  const int nw = K * C * cout;
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + ((nw + 3) & ~3);  // (kOutThreads + K - 1) x (C + 1)
  const int S = C + 1;
  const int pad = (K - 1) / 2;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kOutThreads;
  for (int idx = threadIdx.x; idx < nw; idx += kOutThreads) w_s[idx] = w[idx];
  const float* xb = x + (size_t)b * T * C;
  const int rows = kOutThreads + K - 1;
  for (int idx = threadIdx.x; idx < rows * C; idx += kOutThreads) {
    const int rr = idx / C, cc = idx % C;
    const int src = pad_row(t0 - pad + rr, T, pad, mode);
    x_s[rr * S + cc] = src >= 0 ? leaky(xb[(size_t)src * C + cc], slope) : 0.f;
  }
  __syncthreads();

  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  for (int co = 0; co < cout; ++co) {
    float acc = bias[co];
    for (int k = 0; k < K; ++k) {
      const float* xr = x_s + (threadIdx.x + k) * S;
      const float* wk = w_s + k * C * cout + co;
#pragma unroll 8
      for (int ci = 0; ci < C; ++ci) acc = fmaf(xr[ci], wk[ci * cout], acc);
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

template <int C>
int launch_stack(const Stack& p, int B, cudaStream_t stream) {
  using M = SMap<C>;
  const int pad = (p.K - 1) / 2 * p.dil;
  const size_t rows1 = (size_t)(M::TT + 2 * pad) * M::S1;
  const size_t rows2 = (size_t)M::TT * M::S2;
  const size_t smem =
      sizeof(float) * (2 * (size_t)M::CH * C + (rows1 > rows2 ? rows1 : rows2));
  cudaError_t e = set_smem(stack_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + M::TT - 1) / M::TT, B);
  stack_kernel<C><<<grid, M::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

bool bad_args(int B, int T, int K, int mode) {
  return B < 1 || B > 65535 || T < 1 || K < 1 || K % 2 == 0 || mode < kReflect ||
         mode > kZero;
}

}  // namespace

// Each entry point returns a cudaError_t value: 0 when the launch was
// accepted. mode: 0 reflect, 1 replicate, 2 zeros; reflect needs the pad
// ((K-1)/2 * dil) below T.
extern "C" {

// One ResidualStack: out = W1 . leaky(conv_d(leaky(x_pad))) + Ws . x, with
// biases. C is a multiple of 16 up to 128; w1 and ws are (C, C).
int melgan_stack(const float* x, float* out, const float* wd, const float* bd,
                 const float* w1, const float* b1, const float* ws,
                 const float* bs, int B, int T, int C, int K, int dil,
                 int mode, float slope, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_args(B, T, K, mode) || dil < 1) return cudaErrorInvalidValue;
  if (mode == kReflect && (K - 1) / 2 * dil >= T) return cudaErrorInvalidValue;
  const Stack p{x, out, wd, bd, w1, b1, ws, bs, T, K, dil, mode, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PWG_STACK(c) \
  case c:            \
    return launch_stack<c>(p, B, s);
  switch (C) {
    PWG_STACK(16) PWG_STACK(32) PWG_STACK(48) PWG_STACK(64)
    PWG_STACK(80) PWG_STACK(96) PWG_STACK(112) PWG_STACK(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PWG_STACK
}

// The generator's trailing leaky -> K-tap conv (C -> Cout) -> tanh.
int melgan_outconv(const float* x, float* y, const float* w, const float* bias,
                   int B, int T, int C, int Cout, int K, int mode, float slope,
                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_args(B, T, K, mode) || C < 1 || Cout < 1) return cudaErrorInvalidValue;
  if (mode == kReflect && (K - 1) / 2 >= T) return cudaErrorInvalidValue;
  const size_t nw = (size_t)K * C * Cout;
  const size_t smem = sizeof(float) * (((nw + 3) & ~(size_t)3) +
                                       (size_t)(kOutThreads + K - 1) * (C + 1));
  e = set_smem(outconv_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + kOutThreads - 1) / kOutThreads, B);
  outconv_kernel<<<grid, kOutThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, w, bias, T, C, Cout, K, mode, slope);
  return cudaGetLastError();
}

}  // extern "C"
