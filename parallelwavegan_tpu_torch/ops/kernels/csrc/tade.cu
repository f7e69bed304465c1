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
// shared-memory loads that feed it. The products are FFMA:
// one TF32 product per multiply missed the 1e-4 max|plain| agreement with
// the float32 reference in K4 on the card (4.6e-4 to 1.3e-3 of max|plain|
// at v1 shapes; PERF.md), where split TF32 on the tensor cores held
// it within 1e-5; this kernel's products are of the same kind, and split
// TF32 is untried here.
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
// Blocks share nothing and carry nothing from tile to tile. The shared
// pieces (conv9, the row staging, the gate) are in csrc/tade.cuh. With
// the Save pointers given, each kernel is the re-run of the backward
// (K9a, K9b in csrc/tade_bwd.cu): it keeps the gated conv's input, the
// modulation's scale and the gate's pre-activations instead of applying
// the gate (a compile-time variant; decode runs the kernels without it).

#include "tade.cuh"

namespace {

using namespace tadek;

constexpr size_t kWeightFloats = 2 * (size_t)kCW * 2 * kC;  // two chunks

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
// With kSave, rows [lo, lo + kTile) inside [0, t_out) also go to y_out and
// their scale s to s_out (device).
template <int KR, bool kSave>
__device__ __forceinline__ void store_modulated(const float (&acc)[KR][4], int M,
                                                int pos0, int t_out, int sc,
                                                const float* __restrict__ xr,
                                                float2 mu, float2 rs, float* dst, int lo,
                                                float* __restrict__ y_out,
                                                float* __restrict__ s_out) {
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
      if (kSave && m >= lo && m < lo + kTile) {
        const size_t o = (size_t)pos * kC + 2 * g;
        *reinterpret_cast<float2*>(y_out + o) = y;
        *reinterpret_cast<float2*>(s_out + o) = make_float2(acc[i][0], acc[i][1]);
      }
    }
    *reinterpret_cast<float2*>(dst + m * kS + 2 * g) = y;
  }
}

// The gated conv's row t (of t_out) from a thread's acc (columns (2g, 2g+1)
// of each half): with kSave its pre-activations [ta | tb] to tp (rows of
// 128); else gate(acc), plus the residual row xr[t / s] with kResidual, to
// out. Every lane of the warp must call it. The residual is a compile-time
// choice: a runtime null test of xr cost the decode's tade2_kernel<4>
// registers (PERF.md §6).
template <bool kSave, bool kResidual>
__device__ __forceinline__ void store_gated(const float (&a)[4], int t, int t_out,
                                            int softmax, float* __restrict__ out,
                                            const float* __restrict__ xr, int s,
                                            float* __restrict__ tp) {
  const int g = threadIdx.x % 32;
  if (kSave) {
    if (t < t_out) {
      float* row = tp + (size_t)t * 2 * kC + 2 * g;
      *reinterpret_cast<float2*>(row) = make_float2(a[0], a[1]);
      *reinterpret_cast<float2*>(row + kC) = make_float2(a[2], a[3]);
    }
    return;
  }
  float2 v = gate2(a, softmax);
  if (t >= t_out) return;
  if (kResidual) {
    const float2 x = *reinterpret_cast<const float2*>(xr + (size_t)(t / s) * kC + 2 * g);
    v = make_float2(x.x + v.x, x.y + v.y);
  }
  *reinterpret_cast<float2*>(out + (size_t)t * kC + 2 * g) = v;
}

struct Weights {  // one kernel's three convs, gather form, biases given
  const float* aux_w;  // (9, 64, 64)
  const float* aux_b;  // (64)
  const float* g_w;    // (9, 64, 128)
  const float* g_b;    // (128)
  const float* gc_w;   // (9, 64, 128)
  const float* gc_b;   // (128)
};

// What the backward's re-run keeps (K9, csrc/tade_bwd.cu), at the kernel's
// output rate L: the gated conv's input y and the modulation's scale s
// (B, L, 64), the gated conv's pre-activations t = [ta | tb] (B, L, 128),
// and for K8b at scale 2 the stretched conditioning up(a) (B, L, 64).
struct Save {
  float* y;
  float* s;
  float* t;
  float* ua;
};

struct Tade1 {
  const float* x;     // (B, T, 64)
  const float* c;     // (B, T, 64)
  const float* mean;  // (B, 64) of x
  const float* rstd;  // (B, 64)
  float* x2;          // (B, T, 64), not written with Save
  float* a;           // (B, T, 64)
  Weights w;
  Save sv;
  int T, softmax;
};

struct Tade2 {
  const float* x;     // (B, T, 64), the block's input (residual)
  const float* x2;    // (B, T, 64)
  const float* a;     // (B, T, 64)
  const float* mean;  // (B, 64) of x2
  const float* rstd;  // (B, 64)
  float* out;         // (B, sT, 64), not written with Save
  float* a2;          // (B, sT, 64)
  Weights w;
  Save sv;
  int T, scale, softmax;
};

// Shared memory: the weight ring, then buffer 0 (rows of the first conv's
// input, later the last conv's input) and buffer 1 (the middle conv's).
size_t smem_bytes(int rows0, int rows1) {
  return sizeof(float) * (kWeightFloats + (size_t)(rows0 + rows1) * kS);
}

// K8a. Local rows: c at t0 - 12 + q, a at t0 - 8 + m, y at t0 - 4 + m,
// x2 at t0 + m. kSave: the backward's re-run (struct Save).
constexpr int kRows0A = kTile + 6 * kHalf;  // c, then y
constexpr int kRows1A = kTile + 4 * kHalf;  // a

template <bool kSave>
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
    store_modulated<KR, kSave>(acc, M, t0 - kHalf, T, 1, p.x + base, mu, rs, buf0,
                               kHalf, p.sv.y + base, p.sv.s + base);
  }
  {  // x2 = gate(gc1(y))
    constexpr int M = kTile, KR = ceil_div(M, Map<2 * kC>::R);
    float acc[KR][4];
    conv9<2 * kC, KR, 1>(buf0, M, p.w.gc_w, p.w.gc_b, w_s, acc);
#pragma unroll
    for (int i = 0; i < KR; ++i)
      store_gated<kSave, false>(acc[i], t0 + r + i * Map<2 * kC>::R, T, p.softmax,
                                p.x2 + base, nullptr, 1, p.sv.t + 2 * base);
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

template <int D, bool kSave>
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

  if (kSave && p.sv.ua != nullptr) {  // up(a) over this block's rows
    for (int idx = threadIdx.x; idx < kTile * (kC / 4); idx += kThreads) {
      const int t = t0 + idx / (kC / 4), cc = (idx % (kC / 4)) * 4;
      if (t < t_out)
        *reinterpret_cast<float4*>(p.sv.ua + out_base + (size_t)t * kC + cc) =
            *reinterpret_cast<const float4*>(p.a + in_base + (size_t)(t / s) * kC + cc);
    }
  }
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
    store_modulated<KR, kSave>(acc, M, t0 - G2::kHy, t_out, s, p.x2 + in_base, mu, rs,
                               buf0, G2::kHy, p.sv.y + out_base, p.sv.s + out_base);
  }
  {  // out = up(x) + gate(gc2_D(y2))
    constexpr int M = kTile, KR = ceil_div(M, Map<2 * kC>::R);
    float acc[KR][4];
    conv9<2 * kC, KR, D>(buf0, M, p.w.gc_w, p.w.gc_b, w_s, acc);
#pragma unroll
    for (int i = 0; i < KR; ++i)
      store_gated<kSave, true>(acc[i], t0 + r + i * Map<2 * kC>::R, t_out,
                               p.softmax, p.out + out_base, p.x + in_base, s,
                               p.sv.t + 2 * out_base);
  }
}

template <bool kSave>
cudaError_t launch_tade1(const Tade1& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(kRows0A, kRows1A);
  cudaError_t e = set_smem(tade1_kernel<kSave>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + kTile - 1) / kTile, B);
  tade1_kernel<kSave><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kSave>
cudaError_t launch_tade2(const Tade2& p, int B, cudaStream_t stream) {
  using G2 = Geo2<D>;
  const size_t smem = smem_bytes(G2::kRows0, G2::kRows1);
  cudaError_t e = set_smem(tade2_kernel<D, kSave>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.scale * p.T + kTile - 1) / kTile, B);
  tade2_kernel<D, kSave><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kSave>
cudaError_t launch_tade2_dil(const Tade2& p, int B, int dilation, cudaStream_t s) {
  switch (dilation) {
    case 1:
      return launch_tade2<1, kSave>(p, B, s);
    case 2:
      return launch_tade2<2, kSave>(p, B, s);
    case 3:
      return launch_tade2<3, kSave>(p, B, s);
    case 4:
      return launch_tade2<4, kSave>(p, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_args(int B, int T, int gate) {
  return B < 1 || B > 65535 || T < 1 || T > (1 << 24) || gate < 0 || gate > 1;
}

}  // namespace

// Each entry point returns a cudaError_t value: 0 when the launch was
// accepted. gate: 0 softmax over channels, 1 sigmoid. Every activation is
// (B, T, 64) float32 at its rate, weights (9, 64, 64) for aux and (9, 64,
// 128) for the two gate convs, biases given (zeros where a conv has none).
// y, s and t (and ua) are null for decode; given, they make the launch the
// backward's re-run (struct Save), which writes them instead of x2 or out.
extern "C" {

// K8a: x2 = gate(gc1(g1(aux1(c)) modulating norm(x))), and a = aux1(c).
int tade1(const float* x, const float* c, const float* mean, const float* rstd,
          float* x2, float* a, const float* aux_w, const float* aux_b,
          const float* g_w, const float* g_b, const float* gc_w, const float* gc_b,
          float* y, float* s, float* t, int B, int T, int gate, int device,
          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const bool save = y != nullptr;
  if (bad_args(B, T, gate) || a == nullptr ||
      (save ? s == nullptr || t == nullptr : x2 == nullptr))
    return cudaErrorInvalidValue;
  const Tade1 p{x, c, mean, rstd, x2, a, {aux_w, aux_b, g_w, g_b, gc_w, gc_b},
                {y, s, t, nullptr}, T, gate == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return save ? launch_tade1<true>(p, B, st) : launch_tade1<false>(p, B, st);
}

// K8b: out = up(x) + gate(gc2_dil(g2(aux2(up(a))) modulating up(norm(x2)))),
// and a2 = aux2(up(a)), at the output rate scale * T. scale 1 or 2,
// dilation 1 .. 4. ua (the re-run's up(a)) may be null.
int tade2(const float* x, const float* x2, const float* a, const float* mean,
          const float* rstd, float* out, float* a2, const float* aux_w,
          const float* aux_b, const float* g_w, const float* g_b,
          const float* gc_w, const float* gc_b, float* y, float* s, float* t,
          float* ua, int B, int T, int scale, int dilation, int gate, int device,
          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const bool save = y != nullptr;
  if (bad_args(B, T, gate) || scale < 1 || scale > 2 || a2 == nullptr ||
      (save ? s == nullptr || t == nullptr : out == nullptr))
    return cudaErrorInvalidValue;
  const Tade2 p{x, x2, a, mean, rstd, out, a2, {aux_w, aux_b, g_w, g_b, gc_w, gc_b},
                {y, s, t, ua}, T, scale, gate == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return save ? launch_tade2_dil<true>(p, B, dilation, st)
              : launch_tade2_dil<false>(p, B, dilation, st);
}

}  // extern "C"
