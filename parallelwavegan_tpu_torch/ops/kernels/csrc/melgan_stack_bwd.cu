// Backward of the fused MelGAN residual stacks (K7) for Hopper (sm_90a),
// float32 in and out, every product of a stack on the tensor cores in split
// TF32. The bf16-resident mode of mixed precision is
// csrc/melgan_stack_bwd_bf16.cu.
//
// Replaces the Pallas TPU kernel of the JAX package
//   parallelwavegan_tpu/ops/pallas_kernels/melgan_stack_train.py:247
//     _run_stacks_bwd (its body _kernel_stacks_bwd :103-239), the backward
//     of _stacks_core (:342) / fused_melgan_stacks_train (:380).
// One call of melgan_stack_bwd computes the backward of one ResidualStack
// (the forward of csrc/melgan_stack.cu) in the channel-last (B, T, C)
// layout, from the stack's input x (re-run by K6 from the stage's saved
// input, ops/kernels/melgan_stack_train.py) and the cotangent g of its
// output. With P = (K-1)/2 * d and xp = pad(leaky(x)) (reflect, replicate
// or zeros, as the forward pads):
//   z       = sum_k xp[t + k*d - P] . Wd[k] + bd          (recomputed)
//   dW1 = leaky(z)^T g, db1 = sum g, dWs = x^T g, dbs = sum g
//   dz      = (g . W1^T) * leaky'(z)
//   dWd[k]  = sum_t xp[t + k*d - P]^T dz[t], dbd = sum dz
//   dxp[q]  = sum_k dz[q - k*d + P] . Wd[k]^T   for q in [-P, T + P)
//   dx      = leaky'(x) * fold(dxp) + g . Ws^T
// where fold is the adjoint of the padding: the cotangent of a padded
// position lands on the row the forward read it from (reflect: q < 0 on
// row -q, q >= T on row 2T - 2 - q; replicate: on row 0 or T - 1; zeros:
// nowhere). leaky'(v) is 1 at v >= 0, as the JAX kernel's _dleaky (:73).
// melgan_outconv_bwd is the backward of the generator's trailing act ->
// K-tap conv (C -> Cout) -> tanh, from its input and its output y:
//   dpre = dy * (1 - y^2), dWf[k] = sum_t xp[t + k - P]^T dpre[t],
//   dbf = sum dpre, dx = leaky'(x) * fold(sum_k dpre[q - k + P] . Wf[k]^T).
//
// Four kernels per stack, on the caller's stream:
//  1. dz_kernel<C>, one block per tile of kM rows of one batch item: z over
//     the K taps of pad(leaky(x)), then dh = g . W1^T, in one cp.async ring
//     of chunks (a tap's kKC input channels of the operand rows beside the
//     matching chunk of weights); writes h = leaky(z) and dz.
//  2. wgrad_kernel<C>, one block per 1,024 rows of one batch item and per
//     job, K9's design (csrc/tade_bwd.cu stage_wgrad_kernel): a job is 32
//     columns of a cotangent against the operand's rows side by side, dz
//     against up to three taps of pad(leaky(x)) (one staged window with
//     its halo; the taps are shifted views of it), or g against [h | x]
//     (dW1 and dWs), so each cotangent element is read once for all the
//     products it enters. The job's products and the cotangent's column
//     sums (the biases) go to a slab of its own.
//  3. wgrad_reduce_kernel: every gradient element is the sum of its slabs
//     in a fixed order, so two runs give the same bits (no atomics; the TPU
//     kernel accumulates into revisited output blocks, race-free only
//     because its grid is sequential, :15-18).
//  4. dx_kernel<C>, one block per tile: the transposed dilated conv of dz
//     straight onto the tile's rows, the padding's adjoint added in the
//     tiles that hold the rows it lands on (a second pass over the same
//     weights whose operand rows are the sums of the dz rows that the
//     padded positions read), times leaky'(x), plus g . Ws^T.
// No (B, T + 2P, C) buffer of the padded cotangent is written and read
// back. The final conv's backward is outconv_bwd_kernel<K> (dpre, dx and
// the per-block weight-gradient slabs, on the CUDA cores) and
// slab_sum_kernel. The TPU kernel's 128-lane space-to-depth packing,
// block-matrix weights, shift tables and halo'd tile recompute are not
// carried over: each stack's input comes from device memory.
//
// What bounds it on the card, and the design. A stack's backward does 13 C
// x C multiply-adds per row (3 taps of z again, g . W1^T, 3 taps of the
// transposed conv, g . Ws^T, and 5 C x C weight-gradient products)
// against about 10 C floats of activations read and written per row: at
// MelGAN v1's C = 128, 64 and 32, 52 to 208 FLOP per byte, bound by
// arithmetic. Every product runs on the tensor cores in split TF32
// (csrc/mma_tf32x3.cuh: v = hi + lo, a.b = a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, three mma.sync.m16n8k8 into float32), which keeps float32's
// accuracy where one TF32 product per multiply missed the 1e-4 max|plain|
// agreement in K4 (PERF.md; tests/test_torch_port_melgan_tf32x3.py holds
// this decomposition to float32 autograd on the CPU). As in K4, K8 and K9:
//  - The wrapper splits the weights once per call (ops/kernels/tf32x3.py
//    stack_fragments) into TF32 hi and lo in the mma B fragments' order:
//    one 16-byte shared load gives a thread (hi, lo) of both B registers,
//    and only the activations are split in the loops. The operand rows are
//    staged raw (pad mapping by the copy's source row, zeros by cp.async's
//    zero fill) and LeakyReLU is applied where a fragment is loaded.
//  - The row products stage each tap's rows as chunks of their own, not
//    one window with a 2P-row halo: such a window of C = 128 channels
//    beside the weights' chunks does not fit a block once P reaches a few
//    dozen rows (P = 3 d at K = 7, any d), and a tap's re-read rows come
//    from L2. The weight gradients, whose jobs hold 32 cotangent columns,
//    do share one window among up to three taps.
//  - A warp owns 32 rows x 32 columns (4 tiles of 8; 32 x 16 where C is
//    not a multiple of 32), so the block's shape follows C: kWC column
//    warps, kWR row warps (Geo). Each tap's tile sums go into float32
//    totals, and the weight gradients' every 32 rows, because the tensor
//    cores round each accumulation toward zero.
//  - dz_kernel keeps z's sign as a bit mask once h is written, so dh needs
//    no second set of totals; dx_kernel scales the conv's totals by
//    leaky'(x) before the skip product is added into them.
// Every element of the outputs is a sum in a fixed order: two runs give
// the same bits.

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

enum PadMode { kReflect = 0, kEdge = 1, kZero = 2 };

constexpr int kMaxK = 7;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// 1 at v >= 0, as the JAX kernels' _dleaky
__device__ __forceinline__ float dleaky(float v, float slope) {
  return v >= 0.f ? 1.f : slope;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// The row of x that padded position p reads, or -1 for a zero row
// (csrc/melgan_stack.cu's pad_row).
__device__ __forceinline__ int pad_row(int p, int T, int pad, int mode) {
  if (p >= 0 && p < T) return p;
  if (p < -pad || p >= T + pad || mode == kZero) return -1;
  if (mode == kReflect) return p < 0 ? -p : 2 * T - 2 - p;
  return p < 0 ? 0 : T - 1;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// Row products (dz_kernel, dx_kernel)
// ---------------------------------------------------------------------------

// The shape of a row-product block at width C, its products split TF32.
template <int C>
struct Geo {
  static constexpr int kNT = C / 8;                 // 8-column tiles of the output
  static constexpr int kNTW = C % 32 == 0 ? 4 : 2;  // tiles of one warp
  static constexpr int kWC = kNT / kNTW;            // warps across the columns
  // warps down the rows: at most 12 warps of 4 tiles (C = 128: 384
  // threads, so a thread may hold the ~160 registers it wants)
  static constexpr int kWR = kWC == 1 ? 8 : kWC <= 3 ? 4 : kWC == 4 ? 3 : 2;
  static constexpr int kM = 32 * kWR;               // rows of a tile
  static constexpr int kThreads = 32 * kWR * kWC;
  static constexpr int kKC = C % 32 == 0 ? 32 : 16;  // input channels of a chunk
  static constexpr int kChunks = C / kKC;            // chunks of one C-deep product
  static constexpr int kLdA = kKC + 8;  // staged row stride, 8 or 24 mod 32
  static constexpr int kAF = kM * kLdA;              // floats of a staged operand chunk
  static constexpr int kBF = kKC * C * 2;  // words of a weight chunk: (hi, lo) of each value
  static constexpr int kStageF = kAF + kBF;
  static constexpr int kStages = 2;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStageF;
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

template <int N>
__device__ __forceinline__ void add_into(float (&tot)[2][N][4], const float (&acc)[2][N][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < N; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mi][ni][e] += acc[mi][ni][e];
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

// acc += the staged chunk's rows (kLdA apart; LeakyReLU applied when kAct)
// times the chunk's weights in fragment order (kKC / 8 k-steps of kNT
// column tiles x 32 lanes x {hi, lo of B[tig][gid], hi, lo of B[tig +
// 4][gid]}; logical k = tig, tig + 4 is channel 2 tig, 2 tig + 1 of the
// k-step, ops/kernels/tf32x3.py).
template <int C, bool kAct>
__device__ __forceinline__ void chunk_mma(const float* a_s, const float* b_s, float slope,
                                          float (&acc)[2][Geo<C>::kNTW][4]) {
  using G = Geo<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % G::kWR, wn = warp / G::kWR, gid = lane >> 2, tig = lane & 3;
  const float* xa = a_s + (32 * wm + gid) * G::kLdA + 2 * tig;
  const float* wb = b_s + wn * G::kNTW * 128 + lane * 4;
#pragma unroll
  for (int ks = 0; ks < G::kKC / 8; ++ks) {
    FragA a[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float2 u = ld2(xa + mi * 16 * G::kLdA + ks * 8);
      float2 v = ld2(xa + (mi * 16 + 8) * G::kLdA + ks * 8);
      if (kAct) {
        u = make_float2(leaky(u.x, slope), leaky(u.y, slope));
        v = make_float2(leaky(v.x, slope), leaky(v.y, slope));
      }
      split(u.x, a[mi].hi[0], a[mi].lo[0]);
      split(v.x, a[mi].hi[1], a[mi].lo[1]);
      split(u.y, a[mi].hi[2], a[mi].lo[2]);
      split(v.y, a[mi].hi[3], a[mi].lo[3]);
    }
#pragma unroll
    for (int ni = 0; ni < G::kNTW; ++ni) {
      const float4 w = *reinterpret_cast<const float4*>(wb + (ks * G::kNT + ni) * 128);
      const FragB b{{__float_as_uint(w.x), __float_as_uint(w.z)},
                    {__float_as_uint(w.y), __float_as_uint(w.w)}};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][ni], a[mi], b);
    }
  }
}

// Copy weight chunk `chunk` of a fragment tensor into b_s.
template <int C>
__device__ __forceinline__ void stage_weights(float* b_s, const float* wf, int chunk) {
  using G = Geo<C>;
  const float* src = wf + (size_t)chunk * G::kBF;
  for (int e = threadIdx.x * 4; e < G::kBF; e += G::kThreads * 4)
    cp_async<16>(b_s + e, src + e, true);
}

struct StackArgs {
  const float* x;   // stack input (B, T, C)
  const float* g;   // cotangent of the stack output (B, T, C)
  const float* wf;  // 2K + 2 matrices in fragment order: Wd[k], W1^T, Wd[k]^T, Ws^T
  const float* bd;  // (C)
  float* dz;        // (B, T, C)
  float* h;         // leaky(z) (B, T, C)
  float* dx;        // (B, T, C)
  int T, K, dil, pad, mode;
  float slope;
};

// z over the K taps, then dh = g . W1^T, in one ring of K kChunks + kChunks
// chunks; h = leaky(z) is written when z is complete, dz = dh * leaky'(z)
// at the end.
template <int C>
__global__ void __launch_bounds__(Geo<C>::kThreads, 1) dz_kernel(StackArgs p) {
  using G = Geo<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, t0 = blockIdx.x * G::kM, T = p.T;
  const float* x = p.x + (size_t)b * T * C;
  const float* g = p.g + (size_t)b * T * C;
  const size_t row0 = (size_t)b * T;
  const int nz = p.K * G::kChunks;
  constexpr int kPieces = G::kKC / 4;  // 16-byte pieces of a staged row
  float acc[2][G::kNTW][4], tot[2][G::kNTW][4];
  uint32_t neg = 0;  // bit (mi, ni, h, j) set where z < 0
  zero(acc);
  zero(tot);

  auto stage = [&](int c, int buf) {
    float* a_s = smem + buf * G::kStageF;
    stage_weights<C>(a_s + G::kAF, p.wf, c);  // Wd's taps, then W1^T: contiguous
    const int tap = c / G::kChunks, c0 = (c % G::kChunks) * G::kKC;
    for (int e = threadIdx.x; e < G::kM * kPieces; e += G::kThreads) {
      const int r = e / kPieces, q = (e % kPieces) * 4;
      const int row = c < nz ? pad_row(t0 + r + tap * p.dil - p.pad, T, p.pad, p.mode)
                             : (t0 + r < T ? t0 + r : -1);
      const float* src = c < nz ? x : g;
      const bool ok = row >= 0;
      cp_async<16>(a_s + r * G::kLdA + q, ok ? src + (size_t)row * C + c0 + q : src, ok);
    }
  };

  auto compute = [&](int c, int buf) {
    const float* a_s = smem + buf * G::kStageF;
    const int part = c % G::kChunks;
    if (c == nz) {  // z complete: h out, z's sign kept
      for_each_pair<C>([&](int mi, int ni, int h, int r, int col) {
        const float z0 = tot[mi][ni][2 * h] + p.bd[col];
        const float z1 = tot[mi][ni][2 * h + 1] + p.bd[col + 1];
        const int bit = ((mi * G::kNTW + ni) * 2 + h) * 2;
        neg |= (z0 < 0.f ? 1u : 0u) << bit;
        neg |= (z1 < 0.f ? 1u : 0u) << (bit + 1);
        if (t0 + r < T)
          st2(p.h + (row0 + t0 + r) * C + col,
              make_float2(leaky(z0, p.slope), leaky(z1, p.slope)));
      });
    }
    if (part == 0) zero(acc);
    if (c < nz) {
      chunk_mma<C, true>(a_s, a_s + G::kAF, p.slope, acc);
      if (part == G::kChunks - 1) add_into(tot, acc);
    } else {
      chunk_mma<C, false>(a_s, a_s + G::kAF, p.slope, acc);
    }
  };

  tf32x3::pipeline<G::kStages>(nz + G::kChunks, stage, compute);

  for_each_pair<C>([&](int mi, int ni, int h, int r, int col) {
    if (t0 + r >= T) return;
    const int bit = ((mi * G::kNTW + ni) * 2 + h) * 2;
    const float d0 = (neg >> bit) & 1u ? p.slope : 1.f;
    const float d1 = (neg >> (bit + 1)) & 1u ? p.slope : 1.f;
    st2(p.dz + (row0 + t0 + r) * C + col,
        make_float2(acc[mi][ni][2 * h] * d0, acc[mi][ni][2 * h + 1] * d1));
  });
}

// The operand row of the padding's adjoint for row t at one tap: the sum
// of the dz rows that the padded positions folded onto t read (padded
// position q reads dz row q + off, off = P - tap * dil; rows outside [0,
// T) are zero), channels ch .. ch + 3.
template <int C>
__device__ __forceinline__ float4 fold_row(const float* dz, int t, int ch, int off, int T,
                                           int P, int mode) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](int u) {
    if (u >= 0 && u < T) {
      const float4 v = *reinterpret_cast<const float4*>(dz + (size_t)u * C + ch);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  };
  if (mode == kReflect) {
    if (t >= 1 && t <= P) add(off - t);
    if (t >= T - 1 - P && t <= T - 2) add(2 * T - 2 - t + off);
  } else if (mode == kEdge) {
    if (t == 0)
      for (int j = 1; j <= P; ++j) add(off - j);
    if (t == T - 1)
      for (int j = 0; j < P; ++j) add(T + j + off);
  }
  return s;
}

// dx = leaky'(x) * (sum_k dz[t + P - k d] . Wd[k]^T + fold) + g . Ws^T:
// the K taps' chunks, the fold's (the same weights; only in a tile that
// holds a row the padding folds onto), then the skip's, in one ring.
template <int C>
__global__ void __launch_bounds__(Geo<C>::kThreads, 1) dx_kernel(StackArgs p) {
  using G = Geo<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, t0 = blockIdx.x * G::kM, T = p.T, P = p.pad;
  const size_t row0 = (size_t)b * T;
  const float* dz = p.dz + row0 * C;
  const float* g = p.g + row0 * C;
  bool fold = false;  // the same in every thread
  if (P > 0 && p.mode == kReflect)
    fold = (t0 <= P && t0 + G::kM > 1) || (t0 <= T - 2 && t0 + G::kM > T - 1 - P);
  else if (P > 0 && p.mode == kEdge)
    fold = t0 == 0 || t0 + G::kM > T - 1;
  const int nc = p.K * G::kChunks, nf = fold ? nc : 0;
  const float* wf = p.wf + (size_t)(p.K + 1) * G::kChunks * G::kBF;  // Wd^T's taps, Ws^T
  constexpr int kPieces = G::kKC / 4;
  float acc[2][G::kNTW][4], tot[2][G::kNTW][4];
  zero(acc);
  zero(tot);

  auto stage = [&](int c, int buf) {
    float* a_s = smem + buf * G::kStageF;
    stage_weights<C>(a_s + G::kAF, wf, c < nc ? c : c - nf);
    const int cc = c < nc ? c : c < nc + nf ? c - nc : c - nc - nf;
    const int tap = cc / G::kChunks, c0 = (cc % G::kChunks) * G::kKC;
    const int off = P - tap * p.dil;
    for (int e = threadIdx.x; e < G::kM * kPieces; e += G::kThreads) {
      const int r = e / kPieces, q = (e % kPieces) * 4, t = t0 + r;
      float* dst = a_s + r * G::kLdA + q;
      if (c >= nc && c < nc + nf) {  // plain stores: visible after the ring's barrier
        *reinterpret_cast<float4*>(dst) = fold_row<C>(dz, t, c0 + q, off, T, P, p.mode);
      } else {
        const int row = c < nc ? t + off : t;
        const bool ok = row >= 0 && row < T;
        const float* src = c < nc ? dz : g;
        cp_async<16>(dst, ok ? src + (size_t)row * C + c0 + q : src, ok);
      }
    }
  };

  auto compute = [&](int c, int buf) {
    const float* a_s = smem + buf * G::kStageF;
    if (c == nc + nf) {  // the conv complete: times leaky'(x)
      for_each_pair<C>([&](int mi, int ni, int h, int r, int col) {
        if (t0 + r >= T) return;
        const float2 xv = ld2(p.x + (row0 + t0 + r) * C + col);
        tot[mi][ni][2 * h] *= dleaky(xv.x, p.slope);
        tot[mi][ni][2 * h + 1] *= dleaky(xv.y, p.slope);
      });
    }
    const int part = c % G::kChunks;
    if (part == 0) zero(acc);
    chunk_mma<C, false>(a_s, a_s + G::kAF, p.slope, acc);
    if (part == G::kChunks - 1) add_into(tot, acc);
  };

  tf32x3::pipeline<G::kStages>(nc + nf + G::kChunks, stage, compute);

  for_each_pair<C>([&](int mi, int ni, int h, int r, int col) {
    if (t0 + r >= T) return;
    st2(p.dx + (row0 + t0 + r) * C + col,
          make_float2(tot[mi][ni][2 * h], tot[mi][ni][2 * h + 1]));
  });
}

// ---------------------------------------------------------------------------
// Weight gradients of a stack
// ---------------------------------------------------------------------------

constexpr int kWRows = 1024;  // rows of one slab
constexpr int kWN = 32;       // cotangent columns of one job
constexpr int kWMaxSeg = 3;   // operand segments (taps, or h and x) of one job
constexpr int kMaxJobs = 32;
constexpr int kRThreads = 256;

// Rows of one staged step: 128 at C = 64 (a 16-warp block, one per SM by
// its registers), else 64 (at C <= 48 two 8-warp blocks then share an SM;
// at C >= 80 a 128-row window would not fit twice in the ring).
__host__ __device__ constexpr int w_step(int C) { return C == 64 ? 128 : 64; }
__host__ __device__ constexpr int w_slab(int C) { return (kWMaxSeg * C + 1) * kWN; }

template <int C>
struct WGeo {
  static constexpr int kWarps = C >= 64 ? 16 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kS = w_step(C);           // rows of one staged step
  static constexpr int kLdOp = C + 4;            // operand rows: 2 ld = 8 mod 32
  static constexpr int kOpRows = 2 * kS;         // a window of kS + span, or two of kS
  static constexpr int kLdCot = kWN + 4;         // staged cotangent rows, 16-byte aligned
  static constexpr int kRawF = kOpRows * kLdOp + kS * kLdCot;
  static constexpr int kStages = 2;
  static constexpr int kLdT = kS + 8;            // transposed cotangent rows, 8 mod 32
  static constexpr int kNTW = (kWMaxSeg * C / 8 + kWarps - 1) / kWarps;
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kStages * kRawF + 2 * kWN * kLdT + 2 * kWN);
};

// dW_s[ci][c0 + m] = sum_t A_s[t][ci] cot[t][c0 + m] (m < 32) for each
// segment s: with act, A_s[t] = pad(leaky(src[0]))[t + shift0 + s dil]
// (taps of the dilated conv), else A_s = src[s] (h and x); db[i][c0 + m]
// = sum_t cot[t][c0 + m] where db[i] is set.
struct WJob {
  const float* cot;
  const float* src[2];
  float* dw[kWMaxSeg];
  float* db[2];
  int c0, nseg, act, shift0;
  const void* reserved[3];  // keeps a job's size, and so the kernels' parameter offsets
};

struct WArgs {
  WJob job[kMaxJobs];
  float* part;  // (jobs, ctas, slab)
  int njobs, T, C, dil, pad, mode, ctas_per_item, ctas, slab;
  float slope;
};

// One block: kWRows rows of batch item blockIdx.y for job blockIdx.z, the
// slab cot^T A: its row m (cotangent column c0 + m) and column n = s C +
// ci (segment s, channel ci) at slab[n * 32 + m], the column sums at row
// kWMaxSeg C. Warp w owns both 16-row tiles and the 8-column tiles w +
// kWarps jj.
template <int C>
__global__ void __launch_bounds__(WGeo<C>::kThreads, 1) wgrad_kernel(WArgs w) {
  using G = WGeo<C>;
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // the cp.async ring
  float* th = raw + G::kStages * G::kRawF;       // cotangent hi, transposed
  float* tl = th + kWN * G::kLdT;                // and lo
  float* csum = tl + kWN * G::kLdT;              // column sums of two row groups
  const WJob& jb = w.job[blockIdx.z];
  const int T = w.T, item = blockIdx.y, tb = blockIdx.x * kWRows;
  const int te = min(T, tb + kWRows), d = w.dil, nseg = jb.nseg, act = jb.act;
  const int ntiles = nseg * (C / 8);
  const size_t bo = (size_t)item * T * C;
  const float* cot = jb.cot + bo + jb.c0;
  // act: one window of kS + (nseg - 1) d rows; else nseg windows of kS rows
  const int arows = act ? G::kS + (nseg - 1) * d : G::kS, nwin = act ? 1 : nseg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // the cotangent element (crow + kWarps u, ccol) that this thread splits
  const int ccol = 4 * (warp & 7) + (lane & 3), crow = (lane >> 2) + 8 * (warp >> 3);
  float colsum = 0.f;
  float acc[2][G::kNTW][4], tot[2][G::kNTW][4];
  zero(acc);
  zero(tot);

  auto stage = [&](int i, int buf) {
    float* ra = raw + buf * G::kRawF;
    float* rb = ra + G::kOpRows * G::kLdOp;
    const int r0 = tb + i * G::kS;
    constexpr int kP = C / 4;  // 16-byte pieces of an operand row
    for (int win = 0; win < nwin; ++win) {
      const float* src = jb.src[win] + bo;
      for (int e = threadIdx.x; e < arows * kP; e += G::kThreads) {
        const int q = e / kP, c4 = (e % kP) * 4;
        const int row = act ? pad_row(r0 + jb.shift0 + q, T, w.pad, w.mode)
                            : (r0 + q < T ? r0 + q : -1);
        const bool ok = row >= 0;
        cp_async<16>(ra + (win * G::kS + q) * G::kLdOp + c4,
                     ok ? src + (size_t)row * C + c4 : src, ok);
      }
    }
    for (int e = threadIdx.x; e < G::kS * (kWN / 4); e += G::kThreads) {
      const int r = e >> 3, c4 = (e & 7) * 4, t = r0 + r;
      const bool ok = t < te && jb.c0 + c4 < C;  // rows past the slab read as zero
      cp_async<16>(rb + r * G::kLdCot + c4, ok ? cot + (size_t)t * C + c4 : cot, ok);
    }
  };

  auto compute = [&](int, int buf) {
    const float* ra = raw + buf * G::kRawF;
    const float* rb = ra + G::kOpRows * G::kLdOp;
#pragma unroll
    for (int u = 0; u < G::kS / G::kWarps; ++u) {
      const int r = crow + G::kWarps * u;
      const float v = rb[r * G::kLdCot + ccol];
      colsum += v;
      uint32_t hv, lv;
      split(v, hv, lv);
      th[ccol * G::kLdT + r] = __uint_as_float(hv);
      tl[ccol * G::kLdT + r] = __uint_as_float(lv);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < G::kS / 8; ++ks) {
      if (ks % 4 == 0) zero(acc);
      // cot^T's 16-row tiles: A[m][k] = cot[row 8 ks + 2 tig (+1)][col m]
      FragA fa[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int o = (mi * 16 + gid) * G::kLdT + ks * 8 + 2 * tig;
        const float2 h0 = ld2(th + o), h1 = ld2(th + o + 8 * G::kLdT);
        const float2 l0 = ld2(tl + o), l1 = ld2(tl + o + 8 * G::kLdT);
        fa[mi].hi[0] = __float_as_uint(h0.x);
        fa[mi].hi[1] = __float_as_uint(h1.x);
        fa[mi].hi[2] = __float_as_uint(h0.y);
        fa[mi].hi[3] = __float_as_uint(h1.y);
        fa[mi].lo[0] = __float_as_uint(l0.x);
        fa[mi].lo[1] = __float_as_uint(l1.x);
        fa[mi].lo[2] = __float_as_uint(l0.y);
        fa[mi].lo[3] = __float_as_uint(l1.y);
      }
#pragma unroll
      for (int jj = 0; jj < G::kNTW; ++jj) {
        const int nt = warp + G::kWarps * jj;
        if (nt >= ntiles) break;
        const int s = nt / (C / 8), ct = nt % (C / 8);
        // B[k][n] = A_s[row 8 ks + 2 tig (+1)][channel 8 ct + gid]
        const float* pb = ra + (ks * 8 + 2 * tig + (act ? s * d : s * G::kS)) * G::kLdOp +
                          ct * 8 + gid;
        float v0 = pb[0], v1 = pb[G::kLdOp];
        if (act) {
          v0 = leaky(v0, w.slope);
          v1 = leaky(v1, w.slope);
        }
        FragB fb;
        split(v0, fb.hi[0], fb.lo[0]);
        split(v1, fb.hi[1], fb.lo[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][jj], fa[mi], fb);
      }
      if (ks % 4 == 3) add_into(tot, acc);
    }
  };

  tf32x3::pipeline<G::kStages>((te - tb + G::kS - 1) / G::kS, stage, compute);

  const int cta = item * w.ctas_per_item + blockIdx.x;
  float* slab = w.part + ((size_t)blockIdx.z * w.ctas + cta) * w.slab;
#pragma unroll
  for (int jj = 0; jj < G::kNTW; ++jj) {
    const int nt = warp + G::kWarps * jj;
    if (nt >= ntiles) break;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      for_each_acc([&](int r, int c, int e) {
        slab[(nt * 8 + c) * kWN + mi * 16 + r] = tot[mi][jj][e];
      });
  }
  // the sums of one column: 8 lanes of a warp, then warps w and w + 8
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) colsum += __shfl_xor_sync(0xffffffffu, colsum, o);
  if (lane < 4) csum[(warp >> 3) * kWN + ccol] = colsum;
  __syncthreads();
  if (threadIdx.x < kWN)
    slab[kWMaxSeg * C * kWN + threadIdx.x] =
        G::kWarps > 8 ? csum[threadIdx.x] + csum[kWN + threadIdx.x] : csum[threadIdx.x];
}

// Element e of job blockIdx.y's slab: the sum of its slabs, cta 0 first,
// into its gradient.
__global__ void __launch_bounds__(kRThreads) wgrad_reduce_kernel(WArgs w) {
  const WJob& jb = w.job[blockIdx.y];
  const int C = w.C, e = blockIdx.x * kRThreads + threadIdx.x;
  const int n = e / kWN, m = e % kWN;
  const bool sums = n == kWMaxSeg * C;
  if (e >= w.slab || jb.c0 + m >= C || (n >= jb.nseg * C && !sums)) return;
  const float* src = w.part + (size_t)blockIdx.y * w.ctas * w.slab + e;
  float s = 0.f;
  for (int cta = 0; cta < w.ctas; ++cta) s += src[(size_t)cta * w.slab];
  if (!sums) {
    jb.dw[n / C][(size_t)(n % C) * C + jb.c0 + m] = s;
  } else {
    if (jb.db[0] != nullptr) jb.db[0][jb.c0 + m] = s;
    if (jb.db[1] != nullptr) jb.db[1][jb.c0 + m] = s;
  }
}

// Taps k .. k + n - 1 of a job: at most kWMaxSeg, spanning at most a
// step's rows, so that they share one staged window.
int tap_group(int k, int K, int dil, int C) {
  int n = 1;
  while (k + n < K && n < kWMaxSeg && n * dil <= w_step(C)) ++n;
  return n;
}

int count_jobs(int C, int K, int dil) {
  int per_group = 1;  // g against [h | x]
  for (int k = 0; k < K; k += tap_group(k, K, dil, C)) ++per_group;
  return per_group * ((C + kWN - 1) / kWN);
}

// ---------------------------------------------------------------------------
// The final conv (C -> Cout <= 4), on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kOThreads = 256;
constexpr int kORowsF = 16384;  // rows x C of one block
constexpr int kOMaxCout = 4;

__host__ __device__ constexpr int o_rows(int C) { return kORowsF / C; }

struct OutArgs {
  const float* x;   // the conv's input (B, T, C)
  const float* y;   // its output after tanh (B, T, Cout)
  const float* dy;  // the cotangent of y
  const float* w;   // (K, C, Cout)
  float* dx;        // (B, T, C)
  float* part;      // (ctas, slab): dW (K, C, Cout) then db (Cout) per block
  int T, C, Cout, mode, ctas_per_item, slab;
  float slope;
};

// dpre = dy (1 - y^2) at row u of batch item b (0 outside [0, T)).
__device__ __forceinline__ float dpre_at(const OutArgs& p, size_t row0, int u, int o) {
  if (u < 0 || u >= p.T) return 0.f;
  const size_t i = (row0 + u) * p.Cout + o;
  const float yv = p.y[i];
  return p.dy[i] * (1.f - yv * yv);
}

// One block: o_rows(C) rows of one batch item. Thread (c, rg) = (tid % C,
// tid / C) takes channel c of rows rg * rpt .. rg * rpt + rpt - 1: every
// thread works at Cout = 1. dpre of the block's rows and their halo is
// formed once into shared memory; dx of each row from it (K x Cout
// multiply-adds), the weight gradient from a sliding window of the
// padded input in registers; then the row groups' gradients are summed in
// shared memory, in a fixed order, into the block's slab.
template <int K>
__global__ void __launch_bounds__(kOThreads) outconv_bwd_kernel(OutArgs p) {
  constexpr int P = (K - 1) / 2;
  extern __shared__ float4 smem4[];
  const int C = p.C, T = p.T, Cout = p.Cout, rows = o_rows(C);
  float4* dp = smem4;                                          // rows + 2P rows of dpre
  float* red = reinterpret_cast<float*>(dp + rows + 2 * P);    // row groups' sums
  const int b = blockIdx.y, t0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * T;
  for (int i = threadIdx.x; i < rows + 2 * P; i += kOThreads) {
    float v[kOMaxCout];
#pragma unroll
    for (int o = 0; o < kOMaxCout; ++o)
      v[o] = o < Cout ? dpre_at(p, row0, t0 - P + i, o) : 0.f;
    dp[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  const int ngroups = kOThreads / C, c = threadIdx.x % C, rg = threadIdx.x / C;
  const bool on = rg < ngroups;
  float wr[K][kOMaxCout], gw[K][kOMaxCout], gb[kOMaxCout];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 0; o < kOMaxCout; ++o) {
      wr[k][o] = on && o < Cout ? p.w[((size_t)k * C + c) * Cout + o] : 0.f;
      gw[k][o] = 0.f;
    }
#pragma unroll
  for (int o = 0; o < kOMaxCout; ++o) gb[o] = 0.f;
  __syncthreads();

  const int rpt = (rows + ngroups - 1) / ngroups;
  const int ta = t0 + rg * rpt, tz = min(min(ta + rpt, t0 + rows), T);
  if (on && ta < tz) {
    const float* xb = p.x + row0 * C + c;
    // win[k]: x at the padded position t + k - P, the row it reads
    float win[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = pad_row(ta + k - P, T, P, p.mode);
      win[k] = r >= 0 ? xb[(size_t)r * C] : 0.f;
    }
    for (int t = ta; t < tz; ++t) {
      if (t > ta) {
#pragma unroll
        for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
        const int r = pad_row(t + P, T, P, p.mode);
        win[K - 1] = r >= 0 ? xb[(size_t)r * C] : 0.f;
      }
      // the transposed conv at row t: dpre rows t + P - k
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 dv = dp[t - t0 + 2 * P - k];
        s += dv.x * wr[k][0] + dv.y * wr[k][1] + dv.z * wr[k][2] + dv.w * wr[k][3];
      }
      // the padding's adjoint: the padded positions folded onto row t
      auto tconv = [&](int q) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int o = 0; o < kOMaxCout; ++o)
            if (o < Cout) v += dpre_at(p, row0, q + P - k, o) * wr[k][o];
        return v;
      };
      if (P > 0 && p.mode == kReflect) {
        if (t >= 1 && t <= P) s += tconv(-t);
        if (t >= T - 1 - P && t <= T - 2) s += tconv(2 * T - 2 - t);
      } else if (P > 0 && p.mode == kEdge) {
        if (t == 0)
          for (int j = 1; j <= P; ++j) s += tconv(-j);
        if (t == T - 1)
          for (int j = 0; j < P; ++j) s += tconv(T + j);
      }
      p.dx[(row0 + t) * C + c] = dleaky(win[P], p.slope) * s;
      const float4 dv = dp[t - t0 + P];
      const float dvo[kOMaxCout] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float a = leaky(win[k], p.slope);
#pragma unroll
        for (int o = 0; o < kOMaxCout; ++o) gw[k][o] += a * dvo[o];
      }
      if (c == 0) {
        const float dvu[kOMaxCout] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int o = 0; o < kOMaxCout; ++o) gb[o] += dvu[o];
      }
    }
  }
  // the row groups' sums into the slab: group 0 first
  const int nw = K * C * Cout;
  if (on) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int o = 0; o < kOMaxCout; ++o)
        if (o < Cout) red[(size_t)rg * (nw + Cout) + ((size_t)k * C + c) * Cout + o] = gw[k][o];
    if (c == 0)
#pragma unroll
      for (int o = 0; o < kOMaxCout; ++o)
        if (o < Cout) red[(size_t)rg * (nw + Cout) + nw + o] = gb[o];
  }
  __syncthreads();
  float* slab = p.part + ((size_t)b * p.ctas_per_item + blockIdx.x) * p.slab;
  for (int e = threadIdx.x; e < nw + Cout; e += kOThreads) {
    float s = 0.f;
    for (int r = 0; r < ngroups; ++r) s += red[(size_t)r * (nw + Cout) + e];
    slab[e] = s;
  }
}

// dw[e] (e < nw) or db[e - nw] (e < n) = the sum of the ctas' slabs at e,
// cta 0 first.
__global__ void __launch_bounds__(kRThreads) slab_sum_kernel(const float* part, int ctas,
                                                            int n, int nw, float* dw,
                                                            float* db) {
  const int e = blockIdx.x * kRThreads + threadIdx.x;
  if (e >= n || (e >= nw && db == nullptr)) return;
  float s = 0.f;
  for (int cta = 0; cta < ctas; ++cta) s += part[(size_t)cta * n + e];
  if (e < nw)
    dw[e] = s;
  else
    db[e - nw] = s;
}

size_t out_smem(int C, int K) {
  const int P = (K - 1) / 2;
  return sizeof(float4) * (o_rows(C) + 2 * P) +
         sizeof(float) * (size_t)(kOThreads / C) * (K * C * kOMaxCout + kOMaxCout);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool bad_args(int B, int T, int C, int K, int pad, int mode) {
  return B < 1 || B > 65535 || T < 1 || T > (1 << 26) || C < 16 || C > 128 ||
         C % 16 != 0 || K < 1 || K % 2 == 0 || K > kMaxK || mode < kReflect ||
         mode > kZero || (mode == kReflect && pad >= T);
}

long long stack_part_floats(int B, int T, int C, int K, int dil) {
  const long long ctas = (long long)B * ((T + kWRows - 1) / kWRows);
  return (long long)count_jobs(C, K, dil) * ctas * w_slab(C);
}

template <int C>
cudaError_t launch_stack(const StackArgs& p, WArgs& w, int B, cudaStream_t s) {
  using G = Geo<C>;
  using WG = WGeo<C>;
  cudaError_t e = set_smem(dz_kernel<C>, G::kSmem);
  if (e == cudaSuccess) e = set_smem(dx_kernel<C>, G::kSmem);
  if (e == cudaSuccess) e = set_smem(wgrad_kernel<C>, WG::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + G::kM - 1) / G::kM, B);
  dz_kernel<C><<<grid, G::kThreads, G::kSmem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_kernel<C><<<dim3(w.ctas_per_item, B, w.njobs), WG::kThreads, WG::kSmem, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_reduce_kernel<<<dim3((w.slab + kRThreads - 1) / kRThreads, w.njobs),
                        kRThreads, 0, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dx_kernel<C><<<grid, G::kThreads, G::kSmem, s>>>(p);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_outconv(const OutArgs& p, int B, float* dw, float* db, cudaStream_t s) {
  const size_t smem = out_smem(p.C, K);
  cudaError_t e = set_smem(outconv_bwd_kernel<K>, smem);
  if (e != cudaSuccess) return e;
  outconv_bwd_kernel<K><<<dim3(p.ctas_per_item, B), kOThreads, smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nw = K * p.C * p.Cout;
  slab_sum_kernel<<<(p.slab + kRThreads - 1) / kRThreads, kRThreads, 0, s>>>(
      p.part, B * p.ctas_per_item, p.slab, nw, dw, db);
  return cudaGetLastError();
}

long long melgan_outconv_bwd_part_floats_(int B, int T, int C, int Cout, int K) {
  if (Cout < 1 || Cout > kOMaxCout || bad_args(B, T, C, K, 0, kZero)) return -1;
  return (long long)B * ((T + o_rows(C) - 1) / o_rows(C)) * (K * C * Cout + Cout);
}

int stack_bwd(const StackArgs& p, float* part, float* dwd, float* dbd, float* dw1, float* db1,
              float* dws, float* dbs, long long part_floats, int B, int C, int device,
              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int T = p.T, K = p.K, dil = p.dil;
  if (dil < 1 || bad_args(B, T, C, K, p.pad, p.mode) || count_jobs(C, K, dil) > kMaxJobs ||
      part_floats < stack_part_floats(B, T, C, K, dil))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  WArgs w{};
  w.part = part;
  w.T = T;
  w.C = C;
  w.dil = dil;
  w.pad = p.pad;
  w.mode = p.mode;
  w.slope = p.slope;
  w.ctas_per_item = (T + kWRows - 1) / kWRows;
  w.ctas = B * w.ctas_per_item;
  w.slab = w_slab(C);
  int j = 0;
  for (int c0 = 0; c0 < C; c0 += kWN) {
    for (int k = 0, n = 0; k < K; k += n) {
      n = tap_group(k, K, dil, C);
      WJob& jb = w.job[j++];
      jb = WJob{p.dz, {p.x, nullptr}, {nullptr, nullptr, nullptr},
                {k == 0 ? dbd : nullptr, nullptr}, c0, n, 1, k * dil - p.pad};
      for (int i = 0; i < n; ++i) jb.dw[i] = dwd + (size_t)(k + i) * C * C;
    }
    w.job[j++] = WJob{p.g, {p.h, p.x}, {dw1, dws, nullptr}, {db1, dbs}, c0, 2, 0, 0};
  }
  w.njobs = j;

  switch (C) {
    case 16: return launch_stack<16>(p, w, B, s);
    case 32: return launch_stack<32>(p, w, B, s);
    case 48: return launch_stack<48>(p, w, B, s);
    case 64: return launch_stack<64>(p, w, B, s);
    case 80: return launch_stack<80>(p, w, B, s);
    case 96: return launch_stack<96>(p, w, B, s);
    case 112: return launch_stack<112>(p, w, B, s);
    default: return launch_stack<128>(p, w, B, s);
  }
}

int outconv_bwd(const OutArgs& p, float* dw, float* db, long long part_floats, int B, int K,
                int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p.Cout < 1 || p.Cout > kOMaxCout || bad_args(B, p.T, p.C, K, (K - 1) / 2, p.mode) ||
      part_floats < melgan_outconv_bwd_part_floats_(B, p.T, p.C, p.Cout, K))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_outconv<1>(p, B, dw, db, s);
    case 3: return launch_outconv<3>(p, B, dw, db, s);
    case 5: return launch_outconv<5>(p, B, dw, db, s);
    default: return launch_outconv<7>(p, B, dw, db, s);
  }
}

}  // namespace

extern "C" {

// Floats of scratch that melgan_stack_bwd needs for a shape, or -1 when
// the shape is refused or the count does not fit an int.
int melgan_stack_bwd_part_floats(int B, int T, int C, int K, int dil) {
  if (dil < 1 || bad_args(B, T, C, K, 0, kZero)) return -1;
  const long long n = stack_part_floats(B, T, C, K, dil);
  return n > 2147483647LL ? -1 : (int)n;
}

// Floats of scratch that melgan_outconv_bwd needs for a shape, or -1.
int melgan_outconv_bwd_part_floats(int B, int T, int C, int Cout, int K) {
  const long long n = melgan_outconv_bwd_part_floats_(B, T, C, Cout, K);
  return n > 2147483647LL ? -1 : (int)n;
}

// The backward of one ResidualStack (see the top of this file): x its
// input, g the cotangent of its output, wf the 2K + 2 matrices Wd[k]
// (K, C, C), W1^T, Wd[k]^T and Ws^T split into TF32 hi and lo in the mma
// fragments' order (ops/kernels/tf32x3.py stack_fragments), bd the
// forward's dilated-conv bias (zeros without bias). Writes dx (which must
// alias neither x nor g) and every weight and bias gradient; dz, h (B, T,
// C) and part (part_floats floats, at least melgan_stack_bwd_part_floats)
// are scratch. C is a multiple of 16 up to 128, K odd up to 7; reflect
// padding needs P = (K-1)/2 * dil below T; every pointer 16-byte aligned.
// Returns a cudaError_t value: 0 when every launch was accepted.
int melgan_stack_bwd(const float* x, const float* g, float* dx, float* dz, float* h,
                     float* part, const float* wf, const float* bd, float* dwd,
                     float* dbd, float* dw1, float* db1, float* dws, float* dbs,
                     long long part_floats, int B, int T, int C, int K, int dil,
                     int mode, float slope, int device, void* stream) {
  const StackArgs p{x, g, wf, bd, dz, h, dx, T, K, dil, (K - 1) / 2 * dil, mode, slope};
  return stack_bwd(p, part, dwd, dbd, dw1, db1, dws, dbs, part_floats, B, C,
                          device, stream);
}

// The backward of the trailing leaky -> K-tap conv (C -> Cout) -> tanh: x
// its input, y its output, dy the cotangent of y, w (K, C, Cout) float32.
// Writes dx and the gradients of w (K, C, Cout) and b (Cout); part
// (part_floats floats, at least melgan_outconv_bwd_part_floats) is scratch.
// Cout 1 .. 4, K odd up to 7. Returns a cudaError_t value.
int melgan_outconv_bwd(const float* x, const float* y, const float* dy, float* dx,
                       float* part, const float* w, float* dw, float* db,
                       long long part_floats, int B, int T, int C, int Cout, int K,
                       int mode, float slope, int device, void* stream) {
  const int rows = o_rows(C);
  const OutArgs p{x, y, dy, w, dx, part, T, C, Cout, mode, (T + rows - 1) / rows,
                  K * C * Cout + Cout, slope};
  return outconv_bwd(p, dw, db, part_floats, B, K, device, stream);
}

}  // extern "C"
