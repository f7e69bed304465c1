// Fused StyleMelGAN TADEResBlock decode for Hopper (sm_90a), float32.
//
// Replaces the two Pallas TPU kernels of
// parallelwavegan_tpu/ops/pallas_kernels/tade_decode.py, reached through
// fused_tade_blocks (:514):
//   K8a :366 _run_tade1 -> tade1_kernel, at the block's input rate T:
//     a  = aux1(c);  [s | h] = g1(a);  y = s * (x - mean1) * rstd1 + h
//     x2 = gate(gc1(y)),  writes x2 and a
//   K8b :437 _run_tade2 -> tade2_kernel<D>, at the output rate sT:
//     a2 = aux2(up(a));  [s | h] = g2(a2);
//     y2 = s * up((x2 - mean2) * rstd2) + h;  out = up(x) + gate(gc2_D(y2))
//     writes out and a2
// with every conv 9 taps at 64 input channels, "same" zero padding per
// conv (each intermediate is zero outside [0, T) or [0, sT) before the
// next conv reads it, as tade_decode.py:165-170 masks), up() the nearest
// x s stretch (output row p reads input row p / s), and gate() a softmax
// over the 64 channels (or a sigmoid) of the first half times tanh of the
// second. mean and rstd are the instance norms' per (batch, channel)
// statistics, computed between the launches by the Python wrapper
// (ops/kernels/tade_decode.py); this file allocates nothing. Layout is the
// JAX package's channel-last (B, T, 64), weights its gather form (9, 64,
// Cout).
//
// What bounds it on the card. Each kernel does ten 9 x 64 x 64 products
// per row (aux 64 columns, the gate convs 128 each): 184,320
// multiply-adds per row against 4 * 64 * 4 = 1 KB of rows in and out, so
// about 360 FLOP per byte, far above the float32 balance point (67
// TFLOP/s over 3.35 TB/s = 20). A 512-frame StyleMelGAN v1 decode sends
// blocks 3-8 here (T = 5632 .. 180224): 130.8 GFLOP for K8a, 195.2 for
// K8b, at least 1.95 and 2.91 ms on the CUDA cores against 0.11 and 0.16
// ms for their bytes. So the kernels are bound by FMA issue and by the
// shared-memory loads that feed it; TF32 tensor cores would miss the 2e-4
// agreement with the float32 reference, so the products are FFMA.
//
// What the design does about it:
//  - The TPU kernels pack two samples into the 128 lanes with block-matrix
//    weights, sum the softmax with a block-diagonal ones matmul and take a
//    per-phase row max. None of that is carried over: here one shared-
//    memory row is one sample, and the softmax's max and sum are warp
//    shuffles.
//  - A block owns 64 output rows of one batch item and keeps the chain of
//    three convs on chip: the input rows with a halo of 12 per side (16 +
//    4 at dilation D in K8b, at the output rate), then each conv's output
//    over the rows the next conv needs. Every product is (rows x 576) .
//    (576 x Cout), its weights streamed 32 input channels of one tap at a
//    time through shared memory, double-buffered with cp.async.
//  - In the 128-column gate convs each thread holds rows of columns (2g,
//    2g+1) of the softmax half and the same pair of the tanh half (the
//    weight columns are permuted while they are copied, as csrc/wavenet.cu
//    pairs its gate), and the 32 threads of a row group are one warp, so
//    the gate is applied in registers with a shuffle reduction per row.
//  - Two buffers of rows (input, then the gated product's input over the
//    dead input) and the weight ring fit 78-92 KB, two blocks per SM,
//    held to 128 registers a thread.
// Blocks share nothing and carry nothing from tile to tile.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kC = 64;         // channels of every activation
constexpr int kK = 9;          // taps of every conv
constexpr int kHalf = 4;       // (kK - 1) / 2
constexpr int kThreads = 256;
constexpr int kTile = 64;      // output rows per block
constexpr int kS = kC + 4;     // shared-memory row stride in floats
constexpr int kCW = 32;        // input channels per streamed weight chunk
constexpr int kChunks = kK * kC / kCW;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kWeightFloats = 2 * (size_t)kCW * 2 * kC;  // two chunks

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

// acc[i][j] = bias[col(g, j)] + sum over taps k and input channels ci of
//   in_s[(m + k * D) * kS + ci] * w[k][ci][col(g, j)],  m = min(r + i*R, M-1):
// output row m of the conv reads input rows m .. m + 8D. w is (9, 64,
// COUT) in device memory; w_s holds two chunks. Starts and ends on a
// barrier.
template <int COUT, int KR, int D>
__device__ __forceinline__ void conv9(const float* in_s, int M,
                                      const float* __restrict__ w,
                                      const float* __restrict__ bias,
                                      float* w_s, float (&acc)[KR][4]) {
  using P = Map<COUT>;
  constexpr int kChunk = kCW * COUT;
  const int g = threadIdx.x % P::G, r = threadIdx.x / P::G;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float bj = bias[col<COUT>(g, j)];
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
    const int k = c / (kC / kCW), ci0 = (c % (kC / kCW)) * kCW;
    const float* xin = in_s + k * D * kS + ci0;
#pragma unroll 1
    for (int ci = 0; ci < kCW; ci += 4) {
      float4 q[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        q[cc] = *reinterpret_cast<const float4*>(cur + (ci + cc) * COUT);
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int m = min(r + i * P::R, M - 1);
        const float4 xv = *reinterpret_cast<const float4*>(xin + m * kS + ci);
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

// Row m (of M) of a 64-column conv's output, at position pos: zero outside
// [0, t_out), stored to dst; rows [lo, lo + kTile) also to out (device).
template <int KR>
__device__ __forceinline__ void store_aux(const float (&acc)[KR][4], int M, int pos0,
                                          int t_out, float* dst, int lo,
                                          float* __restrict__ out) {
  using P = Map<kC>;
  const int g = threadIdx.x % P::G, r = threadIdx.x / P::G;
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int m = r + i * P::R;
    const int pos = pos0 + m;
    if (m >= M) continue;
    const bool in = pos >= 0 && pos < t_out;
    const float4 v = in ? make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3])
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + m * kS + 4 * g) = v;
    if (in && m >= lo && m < lo + kTile)
      *reinterpret_cast<float4*>(out + (size_t)pos * kC + 4 * g) = v;
  }
}

// y = s * (xr[pos / sc] - mean) * rstd + h over the M rows of a gate
// conv's output at positions pos0 + m, zero outside [0, t_out), into dst.
template <int KR>
__device__ __forceinline__ void store_modulated(const float (&acc)[KR][4], int M,
                                                int pos0, int t_out, int sc,
                                                const float* __restrict__ xr,
                                                float2 mu, float2 rs, float* dst) {
  using P = Map<2 * kC>;
  const int g = threadIdx.x % P::G, r = threadIdx.x / P::G;
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int m = r + i * P::R;
    const int pos = pos0 + m;
    if (m >= M) continue;
    float2 y = make_float2(0.f, 0.f);
    if (pos >= 0 && pos < t_out) {
      const float2 xv =
          *reinterpret_cast<const float2*>(xr + (size_t)(pos / sc) * kC + 2 * g);
      y.x = fmaf(acc[i][0], (xv.x - mu.x) * rs.x, acc[i][2]);
      y.y = fmaf(acc[i][1], (xv.y - mu.y) * rs.y, acc[i][3]);
    }
    *reinterpret_cast<float2*>(dst + m * kS + 2 * g) = y;
  }
}

struct Weights {  // one kernel's three convs, gather form, biases given
  const float* aux_w;  // (9, 64, 64)
  const float* aux_b;  // (64)
  const float* g_w;    // (9, 64, 128)
  const float* g_b;    // (128)
  const float* gc_w;   // (9, 64, 128)
  const float* gc_b;   // (128)
};

struct Tade1 {
  const float* x;     // (B, T, 64)
  const float* c;     // (B, T, 64)
  const float* mean;  // (B, 64) of x
  const float* rstd;  // (B, 64)
  float* x2;          // (B, T, 64)
  float* a;           // (B, T, 64)
  Weights w;
  int T, softmax;
};

struct Tade2 {
  const float* x;     // (B, T, 64), the block's input (residual)
  const float* x2;    // (B, T, 64)
  const float* a;     // (B, T, 64)
  const float* mean;  // (B, 64) of x2
  const float* rstd;  // (B, 64)
  float* out;         // (B, sT, 64)
  float* a2;          // (B, sT, 64)
  Weights w;
  int T, scale, softmax;
};

// Shared memory: the weight ring, then buffer 0 (rows of the first conv's
// input, later the last conv's input) and buffer 1 (the middle conv's).
size_t smem_bytes(int rows0, int rows1) {
  return sizeof(float) * (kWeightFloats + (size_t)(rows0 + rows1) * kS);
}

// K8a. Local rows: c at t0 - 12 + q, a at t0 - 8 + m, y at t0 - 4 + m,
// x2 at t0 + m.
constexpr int kRows0A = kTile + 6 * kHalf;  // c, then y
constexpr int kRows1A = kTile + 4 * kHalf;  // a

__global__ void __launch_bounds__(kThreads, 2) tade1_kernel(Tade1 p) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* buf0 = w_s + kWeightFloats;
  float* buf1 = buf0 + kRows0A * kS;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile, T = p.T;
  const size_t base = (size_t)b * T * kC;

  load_rows(buf0, p.c + base, t0 - 3 * kHalf, kRows0A, T, 1);
  {  // a = aux1(c)
    constexpr int M = kRows1A, KR = ceil_div(M, Map<kC>::R);
    float acc[KR][4];
    conv9<kC, KR, 1>(buf0, M, p.w.aux_w, p.w.aux_b, w_s, acc);
    store_aux<KR>(acc, M, t0 - 2 * kHalf, T, buf1, 2 * kHalf, p.a + base);
  }
  const int g = threadIdx.x % 32, r = threadIdx.x / 32;
  {  // y = s * norm(x) + h, [s | h] = g1(a); over the dead c rows
    constexpr int M = kTile + 2 * kHalf, KR = ceil_div(M, Map<2 * kC>::R);
    float acc[KR][4];
    conv9<2 * kC, KR, 1>(buf1, M, p.w.g_w, p.w.g_b, w_s, acc);
    const float2 mu = *reinterpret_cast<const float2*>(p.mean + b * kC + 2 * g);
    const float2 rs = *reinterpret_cast<const float2*>(p.rstd + b * kC + 2 * g);
    store_modulated<KR>(acc, M, t0 - kHalf, T, 1, p.x + base, mu, rs, buf0);
  }
  {  // x2 = gate(gc1(y))
    constexpr int M = kTile, KR = ceil_div(M, Map<2 * kC>::R);
    float acc[KR][4];
    conv9<2 * kC, KR, 1>(buf0, M, p.w.gc_w, p.w.gc_b, w_s, acc);
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const float2 v = gate2(acc[i], p.softmax);
      const int t = t0 + r + i * Map<2 * kC>::R;
      if (t < T) *reinterpret_cast<float2*>(p.x2 + base + (size_t)t * kC + 2 * g) = v;
    }
  }
}

// K8b at dilation D. Local rows at the output rate: up(a) at p0 + q with
// p0 = t0 - 4D - 8, a2 at p0 + 4 + m, y2 at t0 - 4D + m, out at t0 + m.
template <int D>
struct Geo2 {
  static constexpr int kHy = kHalf * D;                   // gc2's halo
  static constexpr int kRows0 = kTile + 2 * (kHy + 2 * kHalf);  // up(a), then y2
  static constexpr int kRows1 = kTile + 2 * (kHy + kHalf);      // a2
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2) tade2_kernel(Tade2 p) {
  using G2 = Geo2<D>;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* buf0 = w_s + kWeightFloats;
  float* buf1 = buf0 + G2::kRows0 * kS;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile, s = p.scale;
  const int t_out = s * p.T;
  const size_t in_base = (size_t)b * p.T * kC, out_base = (size_t)b * t_out * kC;
  const int p0 = t0 - G2::kHy - 2 * kHalf;

  load_rows(buf0, p.a + in_base, p0, G2::kRows0, t_out, s);
  {  // a2 = aux2(up(a))
    constexpr int M = G2::kRows1, KR = ceil_div(M, Map<kC>::R);
    float acc[KR][4];
    conv9<kC, KR, 1>(buf0, M, p.w.aux_w, p.w.aux_b, w_s, acc);
    store_aux<KR>(acc, M, p0 + kHalf, t_out, buf1, G2::kHy + kHalf,
                  p.a2 + out_base);
  }
  const int g = threadIdx.x % 32, r = threadIdx.x / 32;
  {  // y2 = s * up(norm(x2)) + h, [s | h] = g2(a2); over the dead up(a) rows
    constexpr int M = kTile + 2 * G2::kHy, KR = ceil_div(M, Map<2 * kC>::R);
    float acc[KR][4];
    conv9<2 * kC, KR, 1>(buf1, M, p.w.g_w, p.w.g_b, w_s, acc);
    const float2 mu = *reinterpret_cast<const float2*>(p.mean + b * kC + 2 * g);
    const float2 rs = *reinterpret_cast<const float2*>(p.rstd + b * kC + 2 * g);
    store_modulated<KR>(acc, M, t0 - G2::kHy, t_out, s, p.x2 + in_base, mu, rs,
                        buf0);
  }
  {  // out = up(x) + gate(gc2_D(y2))
    constexpr int M = kTile, KR = ceil_div(M, Map<2 * kC>::R);
    float acc[KR][4];
    conv9<2 * kC, KR, D>(buf0, M, p.w.gc_w, p.w.gc_b, w_s, acc);
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const float2 v = gate2(acc[i], p.softmax);
      const int t = t0 + r + i * Map<2 * kC>::R;
      if (t < t_out) {
        const float2 xr =
            *reinterpret_cast<const float2*>(p.x + in_base + (size_t)(t / s) * kC + 2 * g);
        *reinterpret_cast<float2*>(p.out + out_base + (size_t)t * kC + 2 * g) =
            make_float2(xr.x + v.x, xr.y + v.y);
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
int launch_tade2(const Tade2& p, int B, cudaStream_t stream) {
  using G2 = Geo2<D>;
  const size_t smem = smem_bytes(G2::kRows0, G2::kRows1);
  cudaError_t e = set_smem(tade2_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.scale * p.T + kTile - 1) / kTile, B);
  tade2_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool bad_args(int B, int T, int gate) {
  return B < 1 || B > 65535 || T < 1 || T > (1 << 24) || gate < 0 || gate > 1;
}

}  // namespace

// Each entry point returns a cudaError_t value: 0 when the launch was
// accepted. gate: 0 softmax over channels, 1 sigmoid. Every activation is
// (B, T, 64) float32 at its rate, weights (9, 64, 64) for aux and (9, 64,
// 128) for the two gate convs, biases given (zeros where a conv has none).
extern "C" {

// K8a: x2 = gate(gc1(g1(aux1(c)) modulating norm(x))), and a = aux1(c).
int tade1(const float* x, const float* c, const float* mean, const float* rstd,
          float* x2, float* a, const float* aux_w, const float* aux_b,
          const float* g_w, const float* g_b, const float* gc_w, const float* gc_b,
          int B, int T, int gate, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_args(B, T, gate)) return cudaErrorInvalidValue;
  const Tade1 p{x, c, mean, rstd, x2, a, {aux_w, aux_b, g_w, g_b, gc_w, gc_b},
                T, gate == 0};
  const size_t smem = smem_bytes(kRows0A, kRows1A);
  e = set_smem(tade1_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + kTile - 1) / kTile, B);
  tade1_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// K8b: out = up(x) + gate(gc2_dil(g2(aux2(up(a))) modulating up(norm(x2)))),
// and a2 = aux2(up(a)), at the output rate scale * T. scale 1 or 2,
// dilation 1 .. 4.
int tade2(const float* x, const float* x2, const float* a, const float* mean,
          const float* rstd, float* out, float* a2, const float* aux_w,
          const float* aux_b, const float* g_w, const float* g_b,
          const float* gc_w, const float* gc_b, int B, int T, int scale,
          int dilation, int gate, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_args(B, T, gate) || scale < 1 || scale > 2) return cudaErrorInvalidValue;
  const Tade2 p{x, x2, a, mean, rstd, out, a2, {aux_w, aux_b, g_w, g_b, gc_w, gc_b},
                T, scale, gate == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dilation) {
    case 1:
      return launch_tade2<1>(p, B, s);
    case 2:
      return launch_tade2<2>(p, B, s);
    case 3:
      return launch_tade2<3>(p, B, s);
    case 4:
      return launch_tade2<4>(p, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
