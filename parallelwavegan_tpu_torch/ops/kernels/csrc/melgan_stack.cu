// Fused MelGAN residual stacks for Hopper (sm_90a), float32 in and out,
// both products of a stack on the tensor cores in split TF32. The
// bf16-resident mode of mixed precision is csrc/melgan_stack_bf16.cu.
//
// Replaces the Pallas TPU kernel
// parallelwavegan_tpu/ops/pallas_kernels/melgan_stack.py:285
// fused_melgan_stacks_interior (K6, reached through :250
// fused_melgan_stacks). It computes melgan_stacks_xla (:83-101) on the
// whole sequence, padding included, in the channel-last (B, T, C) layout
// of the JAX package. One launch of stack_tc_kernel computes one
// ResidualStack for every row t of every batch item:
//   z   = sum_k leaky(x_pad[t + (k - (K-1)/2) * d]) . Wd[k] + bd
//   out = [leaky(z) | x[t]] . [W1; Ws] + b1 + bs
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
// C x C multiply-adds per sample (three taps, the 1x1 conv and the skip):
// 6.04 GFLOP for stage 1 and 3.11 GFLOP for stage 2 with its final conv.
// A launch reads its input and writes its output once, 12.6 MB at either
// stage (6.3 MB each way), and its weights, 0.2 MB at C = 96: 0.004 ms
// at 3.35 TB/s. The products are the bound: 0.023 ms of a stage-1 stack
// in float32 on the CUDA cores (67 TFLOP/s), 0.0092 ms in split TF32
// (three TF32 products per multiply at 495 TFLOP/s; a stage-2 stack
// half that). MelGAN v1's training forward (B=8, C = 128, 64, 32) is 44.1
// GFLOP: 0.658 ms in float32, 0.267 in split TF32.
//
// What the design does about it:
//  - Both products are implicit GEMMs on mma.sync.m16n8k8 in split TF32
//    (csrc/mma_tf32x3.cuh: v = hi + lo, a.b = a_lo.b_hi + a_hi.b_lo +
//    a_hi.b_hi, float32 accumulators), which keeps float32's accuracy
//    where one TF32 product per multiply misses the 1e-4 max|plain| check
//    (K4, K8, K9; PERF.md). The dilated conv is [tile rows x K C] . [K C
//    x C], A the rows r + k d of one staged window of x (LeakyReLU
//    applied, and the activation split, where a fragment is loaded); then
//    [leaky(z) | x] . [W1; Ws] over depth 2C, so the 1x1 conv and the
//    skip are one product. leaky(z + bd) is formed on the accumulators
//    and written to shared memory beside the window's x rows, as that
//    product's A operand.
//  - The weights are split once (split_kernel; its plain version is
//    ops/kernels/tf32x3.py stack_forward_fragments; decode keeps the
//    split, a training forward makes it once and K7's re-run reuses it)
//    into TF32 hi and lo in the mma B fragments' order: a stack's K + 2
//    matrices Wd[k], W1, Ws are (K + 2) C / 8 k-steps of one contiguous
//    stream, one 16-byte shared load gives a thread (hi, lo) of both B
//    registers. They go through a cp.async ring of chunks, one barrier
//    per chunk: two stages of 3 k-steps at C = 96 and of 6 (a tap) at 48,
//    the most that leaves two blocks an SM, fewer barriers than chunks of
//    2, which measured slower there; three stages of 2 k-steps at the other
//    widths (two at 128). The split launch also packs the three biases
//    into one (3, C) row.
//  - A warp owns 32 rows x 48 columns (6 tiles of 8) at MB-MelGAN v2's C
//    = 96 and 48, else 32 x 32 (32 x 16 where C is not a multiple of 32),
//    K7's shape; kWC warps across the columns, kWR down the rows (Geo).
//    Each tap's tile sums (C / 8 k-steps, the tensor cores rounding
//    toward zero) are added into float32 totals, as are each half of the
//    second product's: no rounded chain runs through a product's whole
//    depth. Measured on the card, both choices are faster than K7's tiles
//    at 96 and 48 and than each k-step added into float32 (mma3_add).
//  - The tile's x rows and their halo, tile + 2P rows with P = (K-1)/2 d,
//    are staged once, raw (the skip reads them as they are), the padding
//    applied by the copy's source row and cp.async's zero fill. A window
//    that would not fit beside the ring and leaky(z) (P above about 100
//    rows at C = 128) is staged one tap at a time instead, the centre tap
//    last, whose rows are the tile's own.
//  - Rows per tile: 64 at C = 96 (4 warps), 80, 112 and 128, 128 at C =
//    48 (4 warps) and 64, 256 at C = 16 and 32. At B = 1, T = 16384, C =
//    96 that is 256 blocks, two to an SM (112.6 KB each at P = 27).
//  - L2 traffic of the weights, which at decode competes with the
//    products: each block streams 5 C^2 weights in hi and lo, 369 KB at C
//    = 96, so 256 blocks read 94 MB of L2 per stage-1 launch, about 16
//    us at 6 TB/s against its 9.2 us arithmetic bound; 128-row tiles
//    halve that but leave one block of 12 warps an SM, which measured
//    slower. At v1's training shapes (B = 8) it is 262 MB a stage-1
//    launch (400 blocks) against 0.11 ms of products.
//  - outconv_kernel stays on the CUDA cores: its 88 MFLOP at v2's stage 2
//    (C = 48 -> 4, K = 7) are 1.3 us at 67 TFLOP/s against 1.9 us of
//    reading its input; one output row per thread with its four outputs'
//    sums side by side.
// Blocks share nothing and carry nothing from tile to tile, and every sum
// is taken in a fixed order: two runs give the same bits.

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kOutRows = 128;  // rows per outconv_kernel block, one a thread
constexpr size_t kMaxSmem = 227 * 1024;

enum PadMode { kReflect = 0, kEdge = 1, kZero = 2 };

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
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

// The shape of a stack block at width C (a multiple of 16 up to 128).
template <int C>
struct Geo {
  static_assert(C % 16 == 0 && C <= 128, "width");
  static constexpr int kNT = C / 8;                 // 8-column tiles of the output
  // tiles of one warp: 32 x 48 at MB-MelGAN v2's 96 and 48 (faster there
  // than K7's 32 x 32 and 32 x 16, PERF.md), else K7's shape
  static constexpr int kNTW = C == 96 || C == 48 ? 6 : C % 32 == 0 ? 4 : 2;
  static constexpr int kWC = kNT / kNTW;  // warps across the columns
  static constexpr int kWR = kWC == 1 ? (C == 48 ? 4 : 8) : kWC == 2 ? (C == 96 ? 2 : 4) : 2;
  static constexpr int kM = 32 * kWR;               // rows of a tile
  static constexpr int kThreads = 32 * kWR * kWC;
  static constexpr int kMinBlocks = kThreads <= 256 ? 2 : 1;
  static constexpr int kLd = C + 8;        // staged row stride, 8 or 24 mod 32
  static constexpr int kPerTap = C / 8;  // k-steps of a C-deep product
  // words of a k-step's weights: (hi, lo) of two TF32 values, a lane of
  // each column tile
  static constexpr int kStepF = kNT * 128;
  // k-steps of a chunk (divides kPerTap): at MB-MelGAN v2's widths as many
  // as two ring stages and two blocks an SM leave room for
  static constexpr int kKS = C == 96 ? 3 : C == 48 ? 6 : 2;
  static constexpr int kChunks = kPerTap / kKS;  // chunks of a C-deep product
  static constexpr int kChunkF = kKS * kStepF;
  static constexpr int kStages = C == 128 || C == 96 || C == 48 ? 2 : 3;
  // floats of shared memory besides the window of x: the ring and leaky(z)
  static constexpr size_t kFixedF = (size_t)kStages * kChunkF + (size_t)kM * kLd;
};

template <int N>
__device__ __forceinline__ void zero(float (&v)[2][N][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < N; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[mi][ni][e] = 0.f;
}

// tot += acc; acc = 0
template <int N>
__device__ __forceinline__ void add_into(float (&tot)[2][N][4], float (&acc)[2][N][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < N; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[mi][ni][e] += acc[mi][ni][e];
        acc[mi][ni][e] = 0.f;
      }
}

// Visit a warp's accumulator elements: fn(mi, ni, h, row, col) for the
// pair of columns (col, col + 1) at tile row `row` (the warp's rows 32 wm
// + 16 mi + gid + 8 h, columns 8 (wn kNTW + ni) + 2 tig), whose values
// are v[mi][ni][2 h] and v[mi][ni][2 h + 1].
template <int C, class Fn>
__device__ __forceinline__ void for_each_pair(Fn&& fn) {
  using G = Geo<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % G::kWR, wn = warp / G::kWR, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::kNTW; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(mi, ni, h, 32 * wm + 16 * mi + gid + 8 * h, 8 * (wn * G::kNTW + ni) + 2 * tig);
}

// acc += one chunk's kKS k-steps: a points at this thread's element (row
// gid, channel pair 2 tig) of the chunk's first k-step in a staged tile
// (rows kLd apart, LeakyReLU applied when kAct); b at this thread's lane
// of the warp's first column tile in the chunk's weights (kNT tiles x 32
// lanes x {hi, lo of B[tig][gid], hi, lo of B[tig + 4][gid]} per k-step;
// logical k = tig, tig + 4 is channel 2 tig, 2 tig + 1 of the k-step,
// ops/kernels/tf32x3.py).
template <int C, bool kAct>
__device__ __forceinline__ void chunk_mma(const float* a, const float* b, float slope,
                                          float (&acc)[2][Geo<C>::kNTW][4]) {
  using G = Geo<C>;
#pragma unroll
  for (int s = 0; s < G::kKS; ++s) {
    FragA f[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float2 u = ld2(a + mi * 16 * G::kLd + s * 8);
      float2 v = ld2(a + (mi * 16 + 8) * G::kLd + s * 8);
      if (kAct) {
        u = make_float2(leaky(u.x, slope), leaky(u.y, slope));
        v = make_float2(leaky(v.x, slope), leaky(v.y, slope));
      }
      split(u.x, f[mi].hi[0], f[mi].lo[0]);
      split(v.x, f[mi].hi[1], f[mi].lo[1]);
      split(u.y, f[mi].hi[2], f[mi].lo[2]);
      split(v.y, f[mi].hi[3], f[mi].lo[3]);
    }
#pragma unroll
    for (int ni = 0; ni < G::kNTW; ++ni) {
      const float4 w = *reinterpret_cast<const float4*>(b + (s * G::kNT + ni) * 128);
      const FragB fb{{__float_as_uint(w.x), __float_as_uint(w.z)},
                     {__float_as_uint(w.y), __float_as_uint(w.w)}};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][ni], f[mi], fb);
    }
  }
}

struct Stack {
  const float* x;     // (B, T, C)
  float* out;         // (B, T, C)
  const float* wf;    // (K + 2) C / 8 k-steps of split weights: Wd[0..K-1], W1, Ws
  const float* bias;  // (3, C): bd, b1, bs
  int T, K, dil, pad, mode, whole;  // whole: one window holds every tap's rows
  float slope;
};

// One ResidualStack over one tile of kM rows of one batch item, its
// products split TF32.
template <int C>
__global__ void __launch_bounds__(Geo<C>::kThreads, Geo<C>::kMinBlocks)
    stack_tc_kernel(Stack p) {
  using G = Geo<C>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // kStages x kChunkF
  float* h_s = ring + G::kStages * G::kChunkF;    // kM x kLd: leaky(z + bd)
  float* win = h_s + G::kM * G::kLd;              // window of x rows, kLd apart
  const int b = blockIdx.y, t0 = blockIdx.x * G::kM, T = p.T, d = p.dil;
  const float* x = p.x + (size_t)b * T * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % G::kWR, wn = warp / G::kWR;
  const int a_off = (32 * wm + (lane >> 2)) * G::kLd + 2 * (lane & 3);
  const int b_off = wn * G::kNTW * 128 + lane * 4;
  const float* wout = p.wf + (size_t)p.K * G::kPerTap * G::kStepF;  // W1, then Ws
  constexpr int kQ = C / 4;  // 16-byte pieces of a row
  const int center = (p.K - 1) / 2;
  const int nseg = p.whole ? 1 : p.K;
  float acc[2][G::kNTW][4], tot[2][G::kNTW][4];
  zero(acc);
  zero(tot);

  for (int seg = 0; seg < nseg; ++seg) {
    // taps k0 .. k0 + ntaps - 1 read window rows r + (k - k0) d; the last
    // segment holds the centre tap, whose rows are the tile's, and runs the
    // second product too
    const bool last = seg == nseg - 1;
    const int k0 = p.whole ? 0 : last ? center : seg < center ? seg : seg + 1;
    const int ntaps = p.whole ? p.K : 1;
    const int rows = G::kM + (ntaps - 1) * d;
    const int base = t0 + k0 * d - p.pad;  // padded position of window row 0
    for (int e = threadIdx.x; e < rows * kQ; e += G::kThreads) {
      const int r = e / kQ, q = (e % kQ) * 4;
      const int row = pad_row(base + r, T, p.pad, p.mode);
      const bool ok = row >= 0;
      cp_async<16>(win + r * G::kLd + q, ok ? x + (size_t)row * C + q : x, ok);
    }
    cp_async_commit();  // waited for with the ring's first chunk
    const int nz = ntaps * G::kChunks;  // chunks of z in this segment
    const float* wz = p.wf + (size_t)k0 * G::kPerTap * G::kStepF;

    auto stage = [&](int i, int buf) {
      const float* src = i < nz ? wz + (size_t)i * G::kChunkF
                                : wout + (size_t)(i - nz) * G::kChunkF;
      float* dst = ring + buf * G::kChunkF;
      for (int e = threadIdx.x * 4; e < G::kChunkF; e += G::kThreads * 4)
        cp_async<16>(dst + e, src + e, true);
    };

    auto compute = [&](int i, int buf) {
      const float* wb = ring + buf * G::kChunkF + b_off;
      if (i < nz) {
        const int tap = i / G::kChunks, c0 = (i % G::kChunks) * G::kKS * 8;
        const float* a = win + tap * d * G::kLd + c0 + a_off;
        chunk_mma<C, true>(a, wb, p.slope, acc);
        if (i % G::kChunks == G::kChunks - 1) add_into(tot, acc);  // a tap's sum
        if (last && i == nz - 1) {
          // z complete: leaky(z + bd) beside the tile's x, visible to every
          // warp after the ring's next barrier
          for_each_pair<C>([&](int mi, int ni, int h, int r, int col) {
            st2(h_s + r * G::kLd + col,
                make_float2(leaky(tot[mi][ni][2 * h] + p.bias[col], p.slope),
                            leaky(tot[mi][ni][2 * h + 1] + p.bias[col + 1], p.slope)));
          });
          zero(tot);
        }
      } else {
        const int j = i - nz, c0 = (j % G::kChunks) * G::kKS * 8;
        // leaky(z), then the tile's own x rows (the last segment's)
        const float* a = j < G::kChunks ? h_s : win + (p.pad - k0 * d) * G::kLd;
        chunk_mma<C, false>(a + c0 + a_off, wb, p.slope, acc);
        if (j % G::kChunks == G::kChunks - 1) add_into(tot, acc);  // W1's, Ws's sum
      }
    };

    tf32x3::pipeline<G::kStages>(nz + (last ? 2 * G::kChunks : 0), stage, compute);
  }

  float* ob = p.out + (size_t)b * T * C;
  for_each_pair<C>([&](int mi, int ni, int h, int r, int col) {
    if (t0 + r >= T) return;
    const float* b1 = p.bias + C + col;
    const float2 v = make_float2(tot[mi][ni][2 * h] + (b1[0] + b1[C]),
                                 tot[mi][ni][2 * h + 1] + (b1[1] + b1[C + 1]));
    st2(ob + (size_t)(t0 + r) * C + col, v);
  });
}

// y = tanh(conv(leaky(x_pad)) + bias); w is (K, C, cout) in gather form,
// C a multiple of 4. One output row per thread, four outputs' sums side by
// side (groups of four in turn); the weights as one float4 per (group,
// tap, channel), read by every thread at once. The block's rows and halo
// are staged with leaky applied, C + 1 floats apart (thread i reads row i
// + k).
__global__ void __launch_bounds__(kOutRows) outconv_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ bias, int T, int C,
    int cout, int K, int mode, float slope) {
  extern __shared__ float4 smem4[];
  const int kc = K * C, groups = (cout + 3) / 4;
  float4* w_s = smem4;                                     // groups x K C
  float* x_s = reinterpret_cast<float*>(w_s + groups * kc);  // (kOutRows + K - 1) x (C + 1)
  const int S = C + 1, pad = (K - 1) / 2, q4 = C / 4;
  const int b = blockIdx.y, t0 = blockIdx.x * kOutRows;
  for (int e = threadIdx.x; e < groups * kc; e += kOutRows) {
    const int g = e / kc, i = e % kc;
    float v[4];
#pragma unroll
    for (int o = 0; o < 4; ++o)
      v[o] = 4 * g + o < cout ? w[(size_t)i * cout + 4 * g + o] : 0.f;
    w_s[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
  const float* xb = x + (size_t)b * T * C;
  const int rows = kOutRows + K - 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * q4; e += kOutRows) {
    const int rr = e / q4, c4 = (e % q4) * 4;
    const int src = pad_row(t0 - pad + rr, T, pad, mode);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0) v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)src * C + c4));
    float* d = x_s + rr * S + c4;
    d[0] = leaky(v.x, slope);
    d[1] = leaky(v.y, slope);
    d[2] = leaky(v.z, slope);
    d[3] = leaky(v.w, slope);
  }
  __syncthreads();

  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  for (int g = 0; g < groups; ++g) {
    float acc[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[o] = 4 * g + o < cout ? bias[4 * g + o] : 0.f;
    for (int k = 0; k < K; ++k) {
      const float* xr = x_s + (threadIdx.x + k) * S;
      const float4* wk = w_s + g * kc + k * C;
#pragma unroll 8
      for (int ci = 0; ci < C; ++ci) {
        const float xv = xr[ci];
        const float4 wv = wk[ci];
        acc[0] = fmaf(xv, wv.x, acc[0]);
        acc[1] = fmaf(xv, wv.y, acc[1]);
        acc[2] = fmaf(xv, wv.z, acc[2]);
        acc[3] = fmaf(xv, wv.w, acc[3]);
      }
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (4 * g + o >= cout) continue;
      const size_t i = ((size_t)b * T + t) * cout + 4 * g + o;
      y[i] = tanhf(acc[o]);
    }
  }
}

// ---------------------------------------------------------------------------
// The weights' split (what the stack kernel reads)
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 256;
constexpr int kSplitStacks = 16;  // stacks of one split_kernel launch

struct SplitArgs {
  const float* w[kSplitStacks][3];  // wd (K, C, C), w1, ws (C, C)
  const float* b[kSplitStacks][3];  // bd, b1, bs (C), or null for zeros
  int k[kSplitStacks];
  long long off[kSplitStacks];  // float4 entries of frag before the stack's
  float4* frag;
  float* biases;  // (stacks, 3, C)
  int C;
};

// Stack blockIdx.y's K + 2 matrices Wd[k], W1, Ws split into TF32 hi and
// lo in the mma B fragments' order (ops/kernels/tf32x3.py _fragments, the
// plain version): entry [m][ks][nt][lane] = (hi, lo of W_m[8 ks + 2 tig][8
// nt + gid], hi, lo of W_m[8 ks + 2 tig + 1][8 nt + gid]), lane = 4 gid +
// tig; and its three biases as one (3, C) row, zeros for a missing one.
__global__ void __launch_bounds__(kSplitThreads) split_kernel(SplitArgs a) {
  const int i = blockIdx.y, C = a.C, K = a.k[i];
  const int per_m = (C / 8) * (C / 8) * 32;  // entries of one matrix
  const int e = blockIdx.x * kSplitThreads + threadIdx.x;
  if (e < 3 * C) {
    const float* src = a.b[i][e / C];
    a.biases[(size_t)i * 3 * C + e] = src != nullptr ? src[e % C] : 0.f;
  }
  if (e >= (K + 2) * per_m) return;
  const int m = e / per_m, r = e % per_m, lane = r % 32;
  const int nt = (r / 32) % (C / 8), ks = r / 32 / (C / 8);
  const int row = 8 * ks + 2 * (lane & 3), col = 8 * nt + (lane >> 2);
  const float* w = m < K ? a.w[i][0] + (size_t)m * C * C : a.w[i][m - K + 1];
  uint32_t h0, l0, h1, l1;
  split(w[(size_t)row * C + col], h0, l0);
  split(w[(size_t)(row + 1) * C + col], h1, l1);
  a.frag[a.off[i] + e] = make_float4(__uint_as_float(h0), __uint_as_float(l0),
                                     __uint_as_float(h1), __uint_as_float(l1));
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int C>
int launch_stack(Stack p, int B, cudaStream_t stream) {
  using G = Geo<C>;
  // one window of every tap's rows where it fits, else one tap's at a time
  p.whole = sizeof(float) * (G::kFixedF + (size_t)(G::kM + 2 * p.pad) * G::kLd) <= kMaxSmem;
  const size_t rows = p.whole ? G::kM + 2 * p.pad : G::kM;
  const size_t smem = sizeof(float) * (G::kFixedF + rows * G::kLd);
  cudaError_t e = set_smem(stack_tc_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + G::kM - 1) / G::kM, B);
  stack_tc_kernel<C><<<grid, G::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int launch_width(const Stack& p, int B, int C, cudaStream_t s) {
  switch (C) {
    case 16: return launch_stack<16>(p, B, s);
    case 32: return launch_stack<32>(p, B, s);
    case 48: return launch_stack<48>(p, B, s);
    case 64: return launch_stack<64>(p, B, s);
    case 80: return launch_stack<80>(p, B, s);
    case 96: return launch_stack<96>(p, B, s);
    case 112: return launch_stack<112>(p, B, s);
    case 128: return launch_stack<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

int launch_outconv(const float* x, float* y, const float* w, const float* bias, int B,
                   int T, int C, int Cout, int K, int mode, float slope, cudaStream_t s) {
  const size_t smem = sizeof(float4) * ((Cout + 3) / 4) * K * C +
                      sizeof(float) * (kOutRows + K - 1) * (C + 1);
  cudaError_t e = set_smem(outconv_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + kOutRows - 1) / kOutRows, B);
  outconv_kernel<<<grid, kOutRows, smem, s>>>(x, y, w, bias, T, C, Cout, K, mode, slope);
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

// One ResidualStack: out = W1 . leaky(conv_d(leaky(x_pad)) + bd) + b1 +
// Ws . x + bs. C is a multiple of 16 up to 128; wf is the stack's K + 2
// matrices Wd[k] (K, C, C), W1 and Ws (C, C) split into TF32 hi and lo in
// the mma fragments' order (ops/kernels/tf32x3.py stack_forward_fragments,
// (K + 2, C / 8, C / 8, 32, 4)); bias the (3, C) biases bd, b1, bs (zeros
// without bias); x, out and wf 16-byte aligned.
int melgan_stack(const float* x, float* out, const float* wf, const float* bias,
                 int B, int T, int C, int K, int dil, int mode, float slope,
                 int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_args(B, T, K, mode) || dil < 1) return cudaErrorInvalidValue;
  const int pad = (K - 1) / 2 * dil;
  if (mode == kReflect && pad >= T) return cudaErrorInvalidValue;
  const Stack p{x, out, wf, bias, T, K, dil, pad, mode, 1, slope};
  return launch_width(p, B, C, static_cast<cudaStream_t>(stream));
}

// The generator's trailing leaky -> K-tap conv (C -> Cout) -> tanh: C a
// multiple of 4; x 16-byte aligned.
int melgan_outconv(const float* x, float* y, const float* w, const float* bias,
                   int B, int T, int C, int Cout, int K, int mode, float slope,
                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_args(B, T, K, mode) || C < 4 || C % 4 != 0 || Cout < 1)
    return cudaErrorInvalidValue;
  if (mode == kReflect && (K - 1) / 2 >= T) return cudaErrorInvalidValue;
  return launch_outconv(x, y, w, bias, B, T, C, Cout, K, mode, slope,
                        static_cast<cudaStream_t>(stream));
}

// What stack_tc_kernel reads of n ResidualStacks of width C (a multiple
// of 16 up to 128): their weights split, the stacks' (K + 2, C / 8, C / 8,
// 32, 4) tensors one after another from out, then their biases packed,
// (n, 3, C). w holds 6 pointers a stack: wd (k[i], C, C), w1 and ws (C,
// C) contiguous, then bd, b1, bs (C) or null. One launch per 16 stacks.
int melgan_stack_split(int n, const float* const* w, const int* k, float* out, int C,
                       int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n < 0 || C < 16 || C > 128 || C % 16 != 0) return cudaErrorInvalidValue;
  long long total = 0;  // float4 entries of the splits
  for (int i = 0; i < n; ++i) {
    if (k[i] < 1) return cudaErrorInvalidValue;
    total += (long long)(k[i] + 2) * (C / 8) * (C / 8) * 32;
  }
  long long off = 0;
  for (int g = 0; g < n; g += kSplitStacks) {
    SplitArgs a{};
    const int m = n - g < kSplitStacks ? n - g : kSplitStacks;
    int most = 3 * C;  // threads of one stack: its entries, and its biases
    for (int j = 0; j < m; ++j) {
      const float* const* p = w + 6 * (g + j);
      for (int q = 0; q < 3; ++q) {
        a.w[j][q] = p[q];
        a.b[j][q] = p[3 + q];
      }
      a.k[j] = k[g + j];
      a.off[j] = off;
      const int entries = (k[g + j] + 2) * (C / 8) * (C / 8) * 32;
      off += entries;
      most = entries > most ? entries : most;
    }
    a.frag = reinterpret_cast<float4*>(out);
    a.biases = out + 4 * total + (size_t)g * 3 * C;
    a.C = C;
    split_kernel<<<dim3((most + kSplitThreads - 1) / kSplitThreads, m), kSplitThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // extern "C"
