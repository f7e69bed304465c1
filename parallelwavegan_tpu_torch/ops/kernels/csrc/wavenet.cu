// Fused WaveNet gated residual layer for Hopper (sm_90a), float32 in and
// out, every product on the tensor cores in split TF32.
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
//   g     = tanh(z[:, :C]) * sigmoid(z[:, C:])
//   skip  = g . Wskip + bskip            (added to skip when accumulating)
//   x_out = (g . Wres + bres + x[t]) * sqrt(1/2)
// with rows of x outside [0, T) read as zero at every layer, as the JAX
// reference pads each layer (wavenet_stack.py:122-130). left is
// (K-1)*dil/2 (floor), or (K-1)*dil when causal. Python
// (ops/kernels/wavenet.py) runs a cycle as one launch per layer on the
// current stream and ping-pongs x between two buffers; this file
// allocates nothing. K3's bf16-resident mode (compute_dtype=bfloat16) is
// csrc/wavenet_bf16.cu.
//
// What bounds it on the card. At Parallel WaveGAN v1 widths (residual 64,
// gate 128, skip 64, aux 80, K = 3) one layer takes 3*64*128 + 80*128 +
// 64*64 + 64*64 = 43,008 multiply-adds per sample, against 4 * (64 + 80
// + 64 + 64) = 1,088 bytes of activations in and out: about 79 FLOP per
// byte. One 10-layer cycle at 512 frames (T = 131,072) is 112.7 GFLOP:
// 1.68 ms on the CUDA cores at their float32 peak, 0.68 ms on the tensor
// cores in split TF32 (three TF32 products per multiply at 495 TFLOP/s),
// against about 0.53 ms for the bytes of the per-layer round trips. So it
// is bound by arithmetic. Every product runs on the tensor cores in split
// TF32 (csrc/mma_tf32x3.cuh: v = hi + lo, a.b = a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, three mma.sync.m16n8k8 into float32), which keeps float32's
// accuracy where one TF32 product per multiply missed the 1e-4 max|plain|
// agreement in K4, K8 and K9 (PERF.md;
// tests/test_torch_port_wavenet_fwd_tf32x3.py holds this decomposition
// to the float32 reference on the CPU). No product is left on FFMA: the
// kernel's FFMAs are those of tanhf and expf in the gate.
//
// What the design does about it (the patterns of K7, K8 and K9):
//  - The TPU kernel keeps a whole cycle resident with a 1,023-row halo
//    per side; a 64-channel float32 tile with that halo does not fit a
//    block's 227 KB of shared memory, so a cycle here is one launch per
//    layer. The TPU's 128-lane channel padding and its small-dilation
//    XLA fallback are layout rules of that chip and are not carried
//    over.
//  - The wrapper splits the weights once (ops/kernels/tf32x3.py
//    wavenet_fragments; decode keeps the split, training makes it once
//    per forward and K4's re-run reuses it) into TF32 hi and lo in the mma
//    B fragments' own order: one 16-byte shared load gives a thread (hi,
//    lo) of both B registers, with no split. Both products have 2C
//    columns, so the gate's [Wconv[0..K-1]; Waux] and [Wskip | Wres] are
//    one fragment tensor of depth K C + Ca8 + C (Ca zero-padded to a
//    multiple of 8), streamed in chunks of 32 rows (16 at C = 16) through
//    a two-stage cp.async ring.
//  - The columns are paired: in each 8-column tile a thread holds channel
//    j's tanh column beside its sigmoid column (and skip_j beside res_j),
//    and in the next tile channel j + 1. The gate is applied on the
//    accumulators, and the epilogue writes skip and x_out as float pairs.
//  - A warp owns 32 rows x 64 columns (2 x 8 tiles; at C = 16 all 32
//    columns), so each B fragment feeds two m-tiles and each A fragment
//    eight n-tiles. 8 warps cover 128 rows at C = 64 (256 at C = 16).
//  - Each tap's rows of x (and c's rows) are staged as a chunk of their own
//    by cp.async, zeros outside [0, T) and past Ca from its zero fill (4-
//    byte copies where Ca or c's address is not a multiple of 16 bytes,
//    chosen per call), rows 8 mod 32 floats apart, and split where a
//    fragment is loaded (an 8-byte load of the channel pair that logical
//    k = tig, tig + 4 reads). A window with the taps' halo would be
//    staged once at small dilations but does not fit beside the ring
//    once the dilation reaches a few dozen rows, and the taps' re-read
//    rows come from L2: one layer at d = 1 runs no faster than the
//    cycle's mean layer (PERF.md §6, PR 12). Splitting each staged
//    chunk once into (hi, lo) planes would double the operand buffers and
//    cost the second block per SM.
//  - The tensor cores round their accumulation toward zero. At 64
//    accumulators a thread, per-tap float32 totals beside them (as K8
//    keeps them) would cost the second block per SM; instead each k-step's
//    three products are formed from zero and added into the float32
//    accumulators (mma3_add), so no rounded chain is longer than one
//    k-step.
//  - g = tanh(z_t) sigmoid(z_s) is written once into shared memory over
//    the operand buffers (dead by then: the ring's last chunks are weights
//    only) and multiplied by [Wskip | Wres] from there. skip is
//    read-modified-written by the one thread that owns each element, so
//    there are no atomics.
//  - Two blocks of 104 KB share an SM at C = 64, held to 128 registers a
//    thread.
// Blocks share nothing and carry nothing from tile to tile, and every sum
// is taken in a fixed order: two runs give the same bits.

#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr size_t kMaxSmem = 227 * 1024;

// The block's shape at residual width CH (gate 2 CH, skip = residual = CH).
template <int CH>
struct Geo {
  static constexpr int kN = 2 * CH;                  // columns of both products
  static constexpr int kNT = kN / 8;                 // their 8-column tiles
  static constexpr int kWN = kNT < 8 ? kNT : 8;      // tiles of a warp
  static constexpr int kWC = kNT / kWN;              // warps across the columns
  static constexpr int kWR = kWarps / kWC;           // warps down the rows
  static constexpr int kTT = 32 * kWR;               // rows of a tile
  static constexpr int kKC = CH < 32 ? CH : 32;      // depth of a chunk
  static constexpr int kKS = kKC / 8;                // its k-steps
  static constexpr int kPerTap = CH / kKC;           // chunks of one tap
  static constexpr int kLdA = kKC + 8;               // staged row stride, 8 or 24 mod 32
  static constexpr int kLdG = CH + 8;                // g's row stride, 8 or 24 mod 32
  static constexpr int kAF = kTT * kLdA;             // floats of an operand chunk
  static constexpr int kStepF = kNT * 128;           // floats of one k-step's weights
  static constexpr int kBF = kKS * kStepF;           // of a weight chunk
  static constexpr size_t kSmem = sizeof(float) * kStages * (kAF + kBF);
  static_assert(kWN % 2 == 0 && kNT % kWN == 0 && kWarps % kWC == 0, "warp map");
  static_assert(kTT * kLdG <= kStages * kAF, "g must fit the operand buffers");
};

struct Layer {
  const float* x;      // (B, T, CH)
  const float* c;      // (B, T, Ca)
  float* x_out;        // (B, T, CH)
  float* skip;         // (B, T, CH)
  const float* wf;     // ((K CH + Ca8 + CH) / 8, CH / 4, 32, 4), fragment order
  const float* bconv;  // (2CH)
  const float* bskip;  // (CH)
  const float* bres;   // (CH)
  int T, Ca, K, dil, left, accumulate;
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

template <int CH>
using Acc = float[2][Geo<CH>::kWN][4];

template <int CH>
__device__ __forceinline__ void zero(Acc<CH>& v) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Geo<CH>::kWN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[mi][ni][e] = 0.f;
}

// acc += the first nks k-steps of a staged operand (rows kLd floats apart,
// the warp's rows from 32 wm) times a weight chunk in fragment order (k-
// steps of kNT column tiles x 32 lanes x {hi, lo of B[tig][gid], hi, lo
// of B[tig + 4][gid]}; logical k = tig, tig + 4 is channel 2 tig, 2 tig +
// 1 of the k-step, ops/kernels/tf32x3.py), over the warp's kWN tiles,
// each k-step's sum added into acc in float32 (mma3_add). The m-tiles are
// the outer loop, so that one A fragment is live at a time: with both
// live the kernel spilled at 128 registers.
template <int CH, int kLd>
__device__ __forceinline__ void product(const float* a_s, const float* b_s, int nks,
                                        Acc<CH>& acc) {
  using G = Geo<CH>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % G::kWR, wn = warp / G::kWR, gid = lane >> 2, tig = lane & 3;
  const float* xa = a_s + (32 * wm + gid) * kLd + 2 * tig;
  const float* wb = b_s + wn * G::kWN * 128 + lane * 4;
#pragma unroll
  for (int ks = 0; ks < G::kKS; ++ks) {
    if (ks >= nks) break;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      FragA a;
      const float2 u = ld2(xa + mi * 16 * kLd + ks * 8);
      const float2 v = ld2(xa + (mi * 16 + 8) * kLd + ks * 8);
      split(u.x, a.hi[0], a.lo[0]);
      split(v.x, a.hi[1], a.lo[1]);
      split(u.y, a.hi[2], a.lo[2]);
      split(v.y, a.hi[3], a.lo[3]);
#pragma unroll
      for (int ni = 0; ni < G::kWN; ++ni) {
        const float4 w = *reinterpret_cast<const float4*>(wb + (ks * G::kNT + ni) * 128);
        const FragB b{{__float_as_uint(w.x), __float_as_uint(w.z)},
                      {__float_as_uint(w.y), __float_as_uint(w.w)}};
        mma3_add(acc[mi][ni], a, b);
      }
    }
  }
}

// Visit a thread's column pairs: fn(mi, q, h, row, ch) for the warp's tile
// row `row` (32 wm + 16 mi + gid + 8 h) and the channels ch, ch + 1 that
// its tiles 2q and 2q + 1 hold (wavenet_fragments pairs the columns so
// that column 2 tig + e of tile nt is half e's channel 8 (nt / 2) + 2 tig
// + nt % 2): half 0's values are v[mi][2q][2h] and v[mi][2q + 1][2h], half
// 1's v[mi][2q][2h + 1] and v[mi][2q + 1][2h + 1].
template <int CH, class Fn>
__device__ __forceinline__ void for_each_pair(Fn&& fn) {
  using G = Geo<CH>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % G::kWR, wn = warp / G::kWR, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int q = 0; q < G::kWN / 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(mi, q, h, 32 * wm + 16 * mi + gid + 8 * h,
           8 * (wn * (G::kWN / 2) + q) + 2 * tig);
}

// Channels c0 .. c0 + kKC - 1 of the tile's rows of c (zero past Ca and T)
// into a_s, four channels a thread and step: one 16-byte copy (kV4) or four
// 4-byte ones. The staging loops stay rolled: unrolled, they spilled at
// 128 registers, with the accumulators live.
template <int CH, bool kV4>
__device__ __forceinline__ void stage_aux(float* a_s, const float* c, int c0, int t0, int T,
                                          int ca) {
  using G = Geo<CH>;
  constexpr int kPieces = G::kKC / 4;
#pragma unroll 1
  for (int e = threadIdx.x; e < G::kTT * kPieces; e += kThreads) {
    const int r = e / kPieces, q = (e % kPieces) * 4, t = t0 + r, ch = c0 + q;
    const float* src = c + (size_t)t * ca + ch;
    float* dst = a_s + r * G::kLdA + q;
    if constexpr (kV4) {
      const bool ok = t < T && ch < ca;
      cp_async<16>(dst, ok ? src : c, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = t < T && ch + j < ca;
        cp_async<4>(dst + j, ok ? src + j : c, ok);
      }
    }
  }
}

// One layer for one tile of kTT rows of batch item blockIdx.y. The ring's
// chunks: the K taps of x (kPerTap each), c's channels (the last chunk
// ragged), then [Wskip | Wres] against g. kV4: c is copied in 16-byte
// pieces. At most 128 registers a thread, so that two blocks share an SM.
template <int CH, bool kV4>
__global__ void __launch_bounds__(kThreads, 2) wavenet_layer_kernel(Layer p) {
  using G = Geo<CH>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // kStages operand chunks, then
  float* w_ring = smem + kStages * G::kAF;        // kStages weight chunks
  float* g_s = smem;                              // g, over the operand chunks
  const int b = blockIdx.y, t0 = blockIdx.x * G::kTT, T = p.T;
  const float* x = p.x + (size_t)b * T * CH;
  const float* c = p.c + (size_t)b * T * p.Ca;
  const int nx = p.K * G::kPerTap;
  const int ks_out = (p.K * CH + ((p.Ca + 7) & ~7)) / 8;  // [skip | res]'s first k-step
  const int ng = nx + (ks_out - nx * G::kKS + G::kKS - 1) / G::kKS;  // chunks of z
  // chunk i's first k-step and k-step count
  auto ks_first = [&](int i) { return i < ng ? i * G::kKS : ks_out + (i - ng) * G::kKS; };
  auto ks_count = [&](int i) { return i < ng ? min(G::kKS, ks_out - i * G::kKS) : G::kKS; };

  Acc<CH> acc;
  zero<CH>(acc);

  auto stage = [&](int i, int buf) {
    const float* src = p.wf + (size_t)ks_first(i) * G::kStepF;
    float* dst = w_ring + buf * G::kBF;
    const int nf = ks_count(i) * G::kStepF;
    for (int e = threadIdx.x * 4; e < nf; e += kThreads * 4) cp_async<16>(dst + e, src + e, true);
    if (i >= ng) return;  // g is the operand
    float* a_s = smem + buf * G::kAF;
    if (i < nx) {
      const int tap = i / G::kPerTap, c0 = (i % G::kPerTap) * G::kKC;
      const int r0 = t0 + tap * p.dil - p.left;
      constexpr int kPieces = G::kKC / 4;
#pragma unroll 1
      for (int e = threadIdx.x; e < G::kTT * kPieces; e += kThreads) {
        const int r = e / kPieces, q = (e % kPieces) * 4, t = r0 + r;
        const bool ok = t >= 0 && t < T;
        cp_async<16>(a_s + r * G::kLdA + q, ok ? x + (size_t)t * CH + c0 + q : x, ok);
      }
    } else {
      stage_aux<CH, kV4>(a_s, c, (i - nx) * G::kKC, t0, T, p.Ca);
    }
  };

  auto compute = [&](int i, int buf) {
    const float* b_s = w_ring + buf * G::kBF;
    if (i < ng) {
      product<CH, G::kLdA>(smem + buf * G::kAF, b_s, ks_count(i), acc);
      return;
    }
    if (i == ng) {  // z complete: the gate on the accumulators, g into g_s
      for_each_pair<CH>([&](int mi, int q, int h, int row, int ch) {
        const float2 bt = ld2(p.bconv + ch), bs = ld2(p.bconv + CH + ch);
        const float g0 = tanhf(acc[mi][2 * q][2 * h] + bt.x) *
                         sigmoid(acc[mi][2 * q][2 * h + 1] + bs.x);
        const float g1 = tanhf(acc[mi][2 * q + 1][2 * h] + bt.y) *
                         sigmoid(acc[mi][2 * q + 1][2 * h + 1] + bs.y);
        st2(g_s + row * G::kLdG + ch, make_float2(g0, g1));
      });
      zero<CH>(acc);
      __syncthreads();  // every warp's channels of g visible
    }
    product<CH, G::kLdG>(g_s + (i - ng) * G::kKC, b_s, G::kKS, acc);
  };

  pipeline<kStages>(ng + G::kPerTap, stage, compute);

  const size_t bo = (size_t)b * T * CH;
  for_each_pair<CH>([&](int mi, int q, int h, int row, int ch) {
    const int t = t0 + row;
    if (t >= T) return;
    const size_t o = bo + (size_t)t * CH + ch;
    const float2 bs = ld2(p.bskip + ch), br = ld2(p.bres + ch);
    float2 s = make_float2(acc[mi][2 * q][2 * h] + bs.x, acc[mi][2 * q + 1][2 * h] + bs.y);
    if (p.accumulate) {
      const float2 prev = ld2(p.skip + o);
      s = make_float2(prev.x + s.x, prev.y + s.y);
    }
    st2(p.skip + o, s);
    const float2 xr = ld2(p.x + o);
    st2(p.x_out + o,
        make_float2((acc[mi][2 * q][2 * h + 1] + br.x + xr.x) * kSqrtHalf,
                    (acc[mi][2 * q + 1][2 * h + 1] + br.y + xr.y) * kSqrtHalf));
  });
}

template <int CH, bool kV4>
int launch_layer(const Layer& p, int B, cudaStream_t stream) {
  using G = Geo<CH>;
  if (G::kSmem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(wavenet_layer_kernel<CH, kV4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)G::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + G::kTT - 1) / G::kTT, B);
  wavenet_layer_kernel<CH, kV4><<<grid, kThreads, G::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int CH>
int launch_width(const Layer& p, int B, cudaStream_t stream) {
  const bool v4 = p.Ca % 4 == 0 && reinterpret_cast<uintptr_t>(p.c) % 16 == 0;
  return v4 ? launch_layer<CH, true>(p, B, stream) : launch_layer<CH, false>(p, B, stream);
}

}  // namespace

extern "C" {

// One gated layer. C is the residual width, which the kernel takes equal
// to the skip width and to half the gate width (16 or 64); Ca >= 1 is
// the conditioning width. wf is the layer's weights as
// ops/kernels/tf32x3.py wavenet_fragments lays them out; x and wf must be
// 16-byte aligned, the biases 8-byte aligned. skip is written
// (accumulate 0) or added to (accumulate 1). Returns a cudaError_t value:
// 0 when the launch was accepted.
int wavenet_layer(const float* x, const float* c, float* x_out, float* skip,
                  const float* wf, const float* bconv, const float* bskip,
                  const float* bres, int B, int T, int C, int Ca, int K, int dil,
                  int causal, int accumulate, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || B > 65535 || T < 1 || Ca < 1 || K < 1 || dil < 1)
    return cudaErrorInvalidValue;
  const int pad = (K - 1) * dil;
  const Layer p{x,     c, x_out, skip, wf, bconv, bskip, bres, T, Ca, K, dil,
                causal ? pad : pad / 2, accumulate ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16:
      return launch_width<16>(p, B, s);
    case 64:
      return launch_width<64>(p, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
