// Backward of the fused WaveNet gated layers (K4) for Hopper (sm_90a),
// float32 in and out, every product on the tensor cores in split TF32.
//
// Replaces the Pallas TPU kernel of the JAX package
//   parallelwavegan_tpu/ops/pallas_kernels/wavenet_stack_train.py:187
//     _stack_bwd_pallas (its body _bwd_body :57-184), the backward of
//     wavenet_stack_train (:338) / fused_wavenet_cycle_train (:368).
// One call of wavenet_layer_bwd computes the backward of one gated layer
// l, in the channel-last (B, T, C) layout, from the layer's input x_l
// (re-run by K3 from the chunk's saved input, ops/kernels/wavenet_train.py),
// the cotangent dx_{l+1} of its output and the skip cotangent dS (the same
// for every layer):
//   z     = sum_k x_l[t + k*dil - left] . Wconv[k] + bconv + c[t] . Waux
//   a = tanh z[:, :C], s = sigmoid z[:, C:], g = a * s
//   dxn   = dx_{l+1} * sqrt(1/2)
//   dg    = dxn . Wres^T + dS . Wskip^T
//   dz    = [dg * s * (1 - a^2), dg * a * s * (1 - s)]
//   dx_l  = dxn + sum_k dz[t - k*dil + left] . Wconv[k]^T   (zero outside [0, T))
//   dc   += dz . Waux^T
//   dWconv[k] = sum_t x_l[t + k*dil - left]^T dz[t], dbconv = sum_t dz,
//   dWaux = c^T dz, dWskip = g^T dS, dbskip = sum dS, dWres = g^T dxn,
//   dbres = sum dxn
// with every row of x_l, dz outside [0, T) read as zero, as the forward pads
// each layer. left is (K-1)*dil/2 (non-causal, as the JAX kernel).
//
// Four kernels per call, on the caller's stream:
//  1. dz_kernel, one block per 64 rows of one batch item: z over the K
//     taps of x_l and c, and dg over [dxn | dS], into registers; the gate's
//     VJP there, and dz (B, T, 2C) and g (B, T, C) written out.
//  2. wgrad_kernel, one block of 512 threads per 1,024 rows of one batch
//     item and per job: every weight gradient as A^T B over the block's
//     rows into a partial slab of its own, with the column sums of B (the
//     biases) on the CUDA cores. A job is a half of dz's columns against
//     the K taps of x_l and c side by side (so dz is read once for all
//     taps, at K <= 3; larger K takes three taps per job), or g against
//     dS, or g against dxn.
//  3. wgrad_reduce_kernel: every gradient element is the sum of its slabs
//     in a fixed order, so two runs give the same bits (no atomics; the TPU
//     kernel accumulates into revisited output blocks, race-free only
//     because its grid is sequential, :18-20).
//  4. dx_kernel, one block per 128 rows: the transposed dilated conv of dz
//     plus the residual dxn into dx_l, then dz . Waux^T written into (or
//     added to) dc, 80 columns per pass.
// The TPU kernel's 128-lane channel padding and its double-halo tile
// recompute (:197-239) are not carried over: each layer's input comes
// from device memory and every shift reads its own rows.
//
// What bounds it on the card, and the design. At Parallel WaveGAN v1
// widths (C = 64, gate 128, aux 80, K = 3) one layer's backward is 34,816
// (z) + 8,192 (dg) + 24,576 (conv transpose) + 10,240 (dc) + 43,008 (weight
// grads) = 120,832 multiply-adds per row against about 2.1 KB of
// activations read and written per row: far above the card's balance
// point, so it is bound by arithmetic. Every product runs on the tensor
// cores in split TF32 (csrc/mma_tf32x3.cuh: three TF32 products per
// multiply, float32 accumulators), which keeps float32's accuracy where
// one TF32 product misses the 2e-4 + 1e-3 |plain| and 1e-4 max|plain|
// agreement with the float32 reference (tests/test_torch_port_wavenet_tf32x3.py
// holds both forms to float32 autograd; PERF.md has the card's figures).
// No product is left on FFMA. mma.sync.m16n8k8 rather than wgmma: its
// fragments load from shared tiles in either orientation (the forward
// products read operand rows, the transposed conv and dc read weights
// transposed, the weight gradients read rows as columns), where wgmma
// wants K-major tiles in its own swizzled layout and 64-row warpgroup
// tiles; and the split needs each value in registers anyway. mma.sync's
// TF32 rate is about 65 % of wgmma's on this card. The split rounds with
// an integer add and mask rather than cvt.rna.tf32, which issues at a
// quarter of the float32 rate and made the split, not the products, the
// limit. Operands are staged by cp.async (16-byte copies, or 4-byte ones
// when an aux width or an address is not a multiple of 16 bytes, chosen
// per call) into a ring of three stages, so a tile's copies overlap the
// tensor cores' work on the one before, with no per-element index
// division; tile strides are padded so that every fragment load is free of
// bank conflicts. The warp maps fit each product: dz_kernel's warps each
// own 32 rows and gate channels j of both halves (z[:, j], z[:, C + j] and
// dg[:, j] land in the same thread, so the gate's VJP needs no shared
// memory); dx and dc spread their 8-column tiles over two warp columns
// (dc's 80 columns as 5 and 5 tiles); the weight gradients are formed
// transposed, B^T A, so that A's 272 columns at v1 spread over eight warp
// columns.
// Weight gradients are a kernel of their own, not fused into dz_kernel:
// fused, one block would hold 43,008 accumulators (168 KB, more than a
// block's registers) or write a slab per 64 rows; a separate kernel holds
// at most 80 per thread (40 of the tensor cores' tile sums, 40 of float32
// totals) and writes a slab per 1,024 rows. The totals are there because
// the tensor cores round their accumulation toward zero: a chain of 1,024
// rows drifted to 1e-3 of a gradient of order 10, so the tile sums are
// added into float32 totals every 32 rows. g is written for this kernel.
// dz_kernel adds each k-step's three products into its float32
// accumulators (mma3_add) rather than chaining z's 34 k-steps (at v1) on
// the tensor cores: the chain's rounding left dWconv at 0.97 of the GPU
// tests' 2e-4 + 1e-3 |plain| limit, and past it once K3 became split TF32
// (PERF.md §6, PR 12).
// dx is not fused into dz_kernel either: at dilations up to 512 the
// transposed conv needs dz rows a whole dilation away.

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kThreads = 256;
constexpr int kTM = 64;          // rows of a dz_kernel block
constexpr int kKC = 32;          // depth (channels) of one staged chunk
constexpr int kAS = kKC + 4;     // row stride of a staged chunk, 4 mod 32
constexpr int kStages = 3;       // the cp.async ring
constexpr int kMaxCa = 128;
constexpr int kMaxK = 7;
constexpr int kTX = 128;         // rows of a dx_kernel block
constexpr int kWR = 1024;        // rows of one weight-gradient block
constexpr int kWS = 32;          // rows of one staged weight-gradient tile
constexpr int kWThreads = 512;   // threads of a weight-gradient block
constexpr int kWCols = kWThreads / 64;  // its warp columns
constexpr int kTapsPerJob = 3;
constexpr int kMaxSeg = kTapsPerJob + 1;
constexpr int kMaxJobs = 2 * ((kMaxK + kTapsPerJob - 1) / kTapsPerJob) + 2;
constexpr int kMaxMA = kTapsPerJob * 64 + kMaxCa;  // widest A of a job
constexpr int kNTW = (kMaxMA / 8 + kWCols - 1) / kWCols;  // 8-column tiles per warp column
constexpr float kSqrtHalf = 0.70710678118654752f;

struct LayerBwd {
  const float* x;    // x_l (B, T, C)
  const float* c;    // (B, T, Ca)
  const float* dxo;  // dx_{l+1} (B, T, C)
  const float* dsk;  // skip cotangent (B, T, C)
  float* dx;         // dx_l (B, T, C)
  float* dc;         // (B, T, Ca)
  float* dz;         // (B, T, 2C)
  float* g;          // (B, T, C)
  const float* wconv;  // (K, C, 2C)
  const float* bconv;  // (2C)
  const float* waux;   // (Ca, 2C)
  const float* wskip;  // (C, C)
  const float* wres;   // (C, C)
  int T, Ca, K, dil, left, accumulate_dc;
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// Row stride of a staged tile of w columns (w a multiple of 8) whose
// fragments are read across rows (load_a_cols, load_b_kn): 8 mod 32.
__host__ __device__ constexpr int ld8(int w) { return w + ((8 - w) & 31); }

// Rows r0 .. r0 + kRows - 1 of one batch item's operand src (rows ld
// floats apart, zero outside [0, T)), channels c0 .. c0 + kKC - 1 (zero
// from P on), into dst (rows kAS apart).
template <int kRows, bool kV4>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int ld, int P,
                                           int c0, int r0, int T) {
  constexpr int kV = kV4 ? 4 : 1;
  constexpr unsigned kG = kKC / kV;
#pragma unroll
  for (unsigned e = threadIdx.x; e < kRows * kG; e += kThreads) {
    const int r = e / kG, q = e % kG * kV;
    const int t = r0 + r, ch = c0 + q;
    const bool ok = t >= 0 && t < T && ch < P;
    cp_async<4 * kV>(dst + r * kAS + q, ok ? src + (size_t)t * ld + ch : src, ok);
  }
}

// Rows c0 .. c0 + kKC - 1 of a weight w (P rows of kN floats; zero from P
// on) into dst (rows kLd apart).
template <int kN, int kLd, bool kV4>
__device__ __forceinline__ void stage_w(float* dst, const float* w, int P, int c0) {
  constexpr int kV = kV4 ? 4 : 1;
  constexpr unsigned kG = kN / kV;
#pragma unroll
  for (unsigned e = threadIdx.x; e < kKC * kG; e += kThreads) {
    const int r = e / kG, q = e % kG * kV;
    const bool ok = c0 + r < P;
    cp_async<4 * kV>(dst + r * kLd + q, ok ? w + (size_t)(c0 + r) * kN + q : w, ok);
  }
}

// A weight read transposed: dst[n * kAS + k] = w[n * wld + c0 + k] for n <
// nrows (zero from N on) and k < kKC (zero from P on).
template <bool kV4>
__device__ __forceinline__ void stage_wt(float* dst, const float* w, int wld, int N,
                                         int nrows, int P, int c0) {
  constexpr int kV = kV4 ? 4 : 1;
  constexpr unsigned kG = kKC / kV;
  for (unsigned e = threadIdx.x; e < nrows * kG; e += kThreads) {
    const int n = e / kG, q = e % kG * kV;
    const bool ok = n < N && c0 + q < P;
    cp_async<4 * kV>(dst + n * kAS + q, ok ? w + (size_t)n * wld + c0 + q : w, ok);
  }
}

// k-steps of 8 that a chunk of depth P - c0 (at most kKC) needs
__device__ __forceinline__ int ksteps(int P, int c0) {
  return min(kKC / 8, (P - c0 + 7) / 8);
}

template <int kC>
__host__ __device__ constexpr int dz_stage_floats() {
  return kTM * kAS + (kKC * (2 * kC + 8) > kC * kAS ? kKC * (2 * kC + 8) : kC * kAS);
}

// Warp w owns rows 32 (w & 1) .. + 31 (two 16-row tiles) and the gate
// channel tiles jt = (w >> 1) + 4 i (8 channels each): z's columns jt of
// both halves and dg's columns jt. Chunks: the K taps of x_l and c against
// Wconv and Waux (z), then dxn and dS against Wres^T and Wskip^T (dg).
template <int kC, bool kV4>
__global__ void __launch_bounds__(kThreads, 2) dz_kernel(LayerBwd p) {
  constexpr int kN = 2 * kC, kLdG = kN + 8;
  constexpr int kJT = kC / 8, kJW = (kJT + 3) / 4;
  constexpr int kNX = (kC + kKC - 1) / kKC;  // chunks of one C-wide operand
  constexpr int kStage = dz_stage_floats<kC>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, t0 = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  const size_t bo = (size_t)b * p.T;
  const float* x = p.x + bo * kC;
  const float* c = p.c + bo * p.Ca;
  const float* dxo = p.dxo + bo * kC;
  const float* dsk = p.dsk + bo * kC;
  const int nxk = p.K * kNX, nz = nxk + (p.Ca + kKC - 1) / kKC;

  float az[2][kJW][2][4], adg[2][kJW][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jw = 0; jw < kJW; ++jw)
#pragma unroll
      for (int e = 0; e < 4; ++e) az[mi][jw][0][e] = az[mi][jw][1][e] = adg[mi][jw][e] = 0.f;

  auto stage = [&](int i, int buf) {
    float* as = smem + buf * kStage;
    float* bs = as + kTM * kAS;
    if (i < nxk) {
      const int k = i / kNX, c0 = (i - k * kNX) * kKC;
      stage_rows<kTM, kV4>(as, x, kC, kC, c0, t0 + k * p.dil - p.left, p.T);
      stage_w<kN, kLdG, kV4>(bs, p.wconv + (size_t)k * kC * kN, kC, c0);
    } else if (i < nz) {
      const int c0 = (i - nxk) * kKC;
      stage_rows<kTM, kV4>(as, c, p.Ca, p.Ca, c0, t0, p.T);
      stage_w<kN, kLdG, kV4>(bs, p.waux, p.Ca, c0);
    } else {
      const int j = i - nz, res = j < kNX, c0 = (res ? j : j - kNX) * kKC;
      stage_rows<kTM, kV4>(as, res ? dxo : dsk, kC, kC, c0, t0, p.T);
      stage_wt<kV4>(bs, res ? p.wres : p.wskip, kC, kC, kC, kC, c0);
    }
  };

  auto compute = [&](int i, int buf) {
    if (wn >= kJT) return;  // C = 16: two of the four warp columns
    const float* as = smem + buf * kStage + wm * 32 * kAS;
    const float* bs = smem + buf * kStage + kTM * kAS;
    if (i < nz) {
      const int n = i < nxk ? ksteps(kC, (i % kNX) * kKC) : ksteps(p.Ca, (i - nxk) * kKC);
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        if (ks >= n) break;
        const FragA a0 = load_a_rows(as + ks * 8, kAS);
        const FragA a1 = load_a_rows(as + 16 * kAS + ks * 8, kAS);
#pragma unroll
        for (int jw = 0; jw < kJW; ++jw) {
          const int jt = wn + 4 * jw;
          if (jt >= kJT) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const FragB bf = load_b_kn(bs + ks * 8 * kLdG + h * kC + jt * 8, kLdG);
            mma3_add(az[0][jw][h], a0, bf);
            mma3_add(az[1][jw][h], a1, bf);
          }
        }
      }
    } else {
      if (i == nz + kNX) {  // dxn's chunks done: dg so far is dx_{l+1} . Wres^T
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int jw = 0; jw < kJW; ++jw)
#pragma unroll
            for (int e = 0; e < 4; ++e) adg[mi][jw][e] *= kSqrtHalf;
      }
      const int n = ksteps(kC, ((i - nz) % kNX) * kKC);
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        if (ks >= n) break;
        const FragA a0 = load_a_rows(as + ks * 8, kAS);
        const FragA a1 = load_a_rows(as + 16 * kAS + ks * 8, kAS);
#pragma unroll
        for (int jw = 0; jw < kJW; ++jw) {
          const int jt = wn + 4 * jw;
          if (jt >= kJT) break;
          const FragB bf = load_b_nk(bs + jt * 8 * kAS + ks * 8, kAS);
          mma3_add(adg[0][jw], a0, bf);
          mma3_add(adg[1][jw], a1, bf);
        }
      }
    }
  };

  pipeline<kStages>(nz + 2 * kNX, stage, compute);
  if (wn >= kJT) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int jw = 0; jw < kJW; ++jw) {
      const int jt = wn + 4 * jw;
      if (jt >= kJT) break;
      for_each_acc([&](int r, int col, int e) {
        const int t = t0 + wm * 32 + mi * 16 + r, j = jt * 8 + col;
        if (t >= p.T) return;
        const float a = tanhf(az[mi][jw][0][e] + p.bconv[j]);
        const float s = sigmoid(az[mi][jw][1][e] + p.bconv[kC + j]);
        const float dg = adg[mi][jw][e];
        float* dz = p.dz + (bo + t) * kN;
        dz[j] = dg * s * (1.f - a * a);
        dz[kC + j] = dg * a * s * (1.f - s);
        p.g[(bo + t) * kC + j] = a * s;
      });
    }
  }
}

// dc's columns per pass of dx_kernel
constexpr int kDT = 10;  // 8-column tiles

__host__ __device__ constexpr int dx_stage_floats(int C) {
  return kTX * kAS + (C > 8 * kDT ? C : 8 * kDT) * kAS;
}

// Warp w owns rows 32 (w & 3) .. + 31 and the 8-column tiles (w >> 2) + 2 i
// of dx, then of dc. Rings: the K taps of dz against Wconv^T; then, per
// 8 kDT columns of dc, dz against those rows of Waux^T.
template <int kC, bool kV4>
__global__ void __launch_bounds__(kThreads, 2) dx_kernel(LayerBwd p) {
  constexpr int kN = 2 * kC;
  constexpr int kXT = kC / 8, kXW = (kXT + 1) / 2, kDW = kDT / 2;
  constexpr int kNZ = kN / kKC;  // chunks of one dz row
  constexpr int kStage = dx_stage_floats(kC);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, t0 = blockIdx.x * kTX;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const size_t bo = (size_t)b * p.T;
  const float* dz = p.dz + bo * kN;

  {
    float acc[2][kXW][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int xw = 0; xw < kXW; ++xw)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][xw][e] = 0.f;
    pipeline<kStages>(
        p.K * kNZ,
        [&](int i, int buf) {
          float* as = smem + buf * kStage;
          const int k = i / kNZ, c0 = (i - k * kNZ) * kKC;
          stage_rows<kTX, kV4>(as, dz, kN, kN, c0, t0 + p.left - k * p.dil, p.T);
          stage_wt<kV4>(as + kTX * kAS, p.wconv + (size_t)k * kC * kN, kN, kC, kC, kN, c0);
        },
        [&](int, int buf) {
          const float* as = smem + buf * kStage + wm * 32 * kAS;
          const float* bs = smem + buf * kStage + kTX * kAS;
#pragma unroll
          for (int ks = 0; ks < kKC / 8; ++ks) {
            const FragA a0 = load_a_rows(as + ks * 8, kAS);
            const FragA a1 = load_a_rows(as + 16 * kAS + ks * 8, kAS);
#pragma unroll
            for (int xw = 0; xw < kXW; ++xw) {
              const int nt = wn + 2 * xw;
              if (nt >= kXT) break;
              const FragB bf = load_b_nk(bs + nt * 8 * kAS + ks * 8, kAS);
              mma3(acc[0][xw], a0, bf);
              mma3(acc[1][xw], a1, bf);
            }
          }
        });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int xw = 0; xw < kXW; ++xw) {
        const int nt = wn + 2 * xw;
        if (nt >= kXT) break;
        for_each_acc([&](int r, int col, int e) {
          const int t = t0 + wm * 32 + mi * 16 + r;
          if (t >= p.T) return;
          const size_t o = (bo + t) * kC + nt * 8 + col;
          p.dx[o] = acc[mi][xw][e] + p.dxo[o] * kSqrtHalf;
        });
      }
    }
  }

  for (int n0 = 0; n0 < p.Ca; n0 += 8 * kDT) {
    const int nc = min(p.Ca - n0, 8 * kDT), dct = (nc + 7) / 8;
    float acc[2][kDW][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int dw = 0; dw < kDW; ++dw)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][dw][e] = 0.f;
    pipeline<kStages>(
        kNZ,
        [&](int i, int buf) {
          float* as = smem + buf * kStage;
          stage_rows<kTX, kV4>(as, dz, kN, kN, i * kKC, t0, p.T);
          stage_wt<kV4>(as + kTX * kAS, p.waux + (size_t)n0 * kN, kN, nc, dct * 8, kN,
                        i * kKC);
        },
        [&](int, int buf) {
          const float* as = smem + buf * kStage + wm * 32 * kAS;
          const float* bs = smem + buf * kStage + kTX * kAS;
#pragma unroll
          for (int ks = 0; ks < kKC / 8; ++ks) {
            const FragA a0 = load_a_rows(as + ks * 8, kAS);
            const FragA a1 = load_a_rows(as + 16 * kAS + ks * 8, kAS);
#pragma unroll
            for (int dw = 0; dw < kDW; ++dw) {
              const int nt = wn + 2 * dw;
              if (nt >= dct) break;
              const FragB bf = load_b_nk(bs + nt * 8 * kAS + ks * 8, kAS);
              mma3(acc[0][dw], a0, bf);
              mma3(acc[1][dw], a1, bf);
            }
          }
        });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int dw = 0; dw < kDW; ++dw) {
        const int nt = wn + 2 * dw;
        if (nt >= dct) break;
        for_each_acc([&](int r, int col, int e) {
          const int t = t0 + wm * 32 + mi * 16 + r, a = n0 + nt * 8 + col;
          if (t >= p.T || a >= p.Ca) return;
          const size_t o = (bo + t) * p.Ca + a;
          p.dc[o] = p.accumulate_dc ? p.dc[o] + acc[mi][dw][e] : acc[mi][dw][e];
        });
      }
    }
  }
}

// One segment of a weight-gradient job's A: channels [0, width) of src
// (rows ld floats apart, read at row t + shift, zero outside [0, T)),
// staged at columns off .. of the tile; its gradient rows go to dw (rows
// dw_ld floats apart).
struct WSeg {
  const float* src;
  int ld, width, shift, off;
  float* dw;
  int dw_ld;
};

// A job: dW = scale * A^T B and db = scale * sum B over the rows of every
// batch item. A is its segments side by side (ma columns, a multiple of
// 16, staged lda apart); B is n (<= 64) columns of b (rows b_ld apart,
// staged ldb apart). Its slabs, (ma + 1) x n floats each (the last row
// db's), start at part in the partial buffer.
struct WJob {
  WSeg seg[kMaxSeg];
  int nseg, ma, lda;
  const float* b;
  int b_ld, n, ldb;
  float scale;
  float* db;
  long long part;
  int slab;
};

struct WArgs {
  WJob job[kMaxJobs];
  float* part;
  int njobs, T, ctas_per_item, ctas;
};

// A piece of a staged weight-gradient row (16 or 4 bytes): columns col ..
// of A's tile (a) or of B's, copied from base + (t + shift) * ld for row t
// of the block's batch item; zeros where !valid (dummy is then the
// address passed).
struct Piece {
  const float* base;
  const float* dummy;
  int ld, shift, col;
  bool a, used, valid;
};

template <int kV>
__device__ __forceinline__ Piece piece_of(const WJob& jb, int c, size_t bo) {
  Piece pc{};
  const int q = c * kV;
  if (q < jb.ma) {
    int s = 0;
    while (s + 1 < jb.nseg && q >= jb.seg[s + 1].off) ++s;
    const WSeg& sg = jb.seg[s];
    pc = Piece{sg.src + bo * sg.ld + (q - sg.off), sg.src, sg.ld, sg.shift, q,
               true, true, q - sg.off < sg.width};
  } else if (q - jb.ma < (jb.n + 7) / 8 * 8) {
    pc = Piece{jb.b + bo * jb.b_ld + (q - jb.ma), jb.b, jb.b_ld, 0, q - jb.ma,
               false, true, q - jb.ma < jb.n};
  }
  return pc;
}

// One block: kWR rows of batch item blockIdx.y for job blockIdx.z. The
// block forms the slab transposed, B^T A (n x ma), so that A's ma columns
// (272 at v1) spread over eight warp columns as 5, 5, 4, 4, 4, 4, 4, 4
// tiles: warp w owns the 16-row tiles 2 (w & 1) + i (i < 2) of B's n
// columns and the 8-column tiles (w >> 1) + 8 j of A's; threads below n
// also sum B's columns. A staged row is at most 96 pieces of 16 bytes (ma
// + n <= 384 floats): thread e copies piece e % 128 of rows e / 128 + 4 i,
// its addresses worked out once.
template <bool kV4>
__global__ void __launch_bounds__(kWThreads, 1) wgrad_kernel(WArgs w) {
  constexpr int kV = kV4 ? 4 : 1;
  constexpr unsigned kPieces = kV4 ? 128 : 512;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const WJob& jb = w.job[blockIdx.z];
  const int item = blockIdx.y, t_begin = blockIdx.x * kWR;
  const int t_end = min(w.T, t_begin + kWR);
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int mt0 = 2 * wm, mtiles = (jb.n + 15) / 16, ntiles = jb.ma / 8;
  const int stage_floats = kWS * (jb.lda + jb.ldb);
  const size_t bo = (size_t)item * w.T;
  const Piece mine = piece_of<kV>(jb, threadIdx.x % kPieces, bo);

  // acc: one staged tile's products on the tensor cores; sum: the block's
  // float32 total, to which acc is added after every tile
  float acc[2][kNTW][4], sum[2][kNTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;
  float colsum = 0.f;

  auto stage = [&](int i, int buf) {
    float* as = smem + buf * stage_floats;
    float* bs = as + kWS * jb.lda;
    for (unsigned e = threadIdx.x; e < kWS * kPieces; e += kWThreads) {
      const int r = e / kPieces;
      const Piece pc = kV4 ? mine : piece_of<kV>(jb, e % kPieces, bo);
      if (!pc.used) continue;
      const int t = t_begin + i * kWS + r, ts = t + pc.shift;
      const bool ok = pc.valid && t < t_end && ts >= 0 && ts < w.T;
      cp_async<4 * kV>((pc.a ? as + r * jb.lda : bs + r * jb.ldb) + pc.col,
                       ok ? pc.base + (size_t)ts * pc.ld : pc.dummy, ok);
    }
  };

  auto compute = [&](int, int buf) {
    const float* as = smem + buf * stage_floats;
    const float* bs = as + kWS * jb.lda;
    if (threadIdx.x < jb.n) {
#pragma unroll
      for (int r = 0; r < kWS; ++r) colsum += bs[r * jb.ldb + threadIdx.x];
    }
#pragma unroll
    for (int ks = 0; ks < kWS / 8; ++ks) {
      // B^T's 16-row tiles: B's columns, read across the staged rows
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (mt0 + i < mtiles) a[i] = load_a_cols(bs + ks * 8 * jb.ldb + (mt0 + i) * 16, jb.ldb);
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        const int nt = wn + kWCols * j;
        if (nt >= ntiles) break;
        const FragB bf = load_b_kn(as + ks * 8 * jb.lda + nt * 8, jb.lda);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (mt0 + i >= mtiles) break;
          if (ks == 0)
            mma3_first(acc[i][j], a[i], bf);
          else
            mma3(acc[i][j], a[i], bf);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNTW; ++j) {
      if (wn + kWCols * j >= ntiles) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (mt0 + i >= mtiles) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += acc[i][j][e];
      }
    }
  };

  pipeline<kStages>((t_end - t_begin + kWS - 1) / kWS, stage, compute);

  const int cta = item * w.ctas_per_item + blockIdx.x;
  float* slab = w.part + jb.part + (size_t)cta * jb.slab;
#pragma unroll
  for (int j = 0; j < kNTW; ++j) {
    const int nt = wn + kWCols * j;
    if (nt >= ntiles) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (mt0 + i >= mtiles) break;
      for_each_acc([&](int r, int col, int e) {
        const int n = (mt0 + i) * 16 + r;
        if (n < jb.n) slab[(nt * 8 + col) * jb.n + n] = sum[i][j][e];
      });
    }
  }
  if (threadIdx.x < jb.n) slab[jb.ma * jb.n + threadIdx.x] = colsum;
}

// Element e of job blockIdx.y's slab: the sum of its slabs, cta 0 first,
// times the job's scale, into its gradient (rows of padding are dropped).
__global__ void __launch_bounds__(kThreads) wgrad_reduce_kernel(WArgs w) {
  const WJob& jb = w.job[blockIdx.y];
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= jb.slab) return;
  const int m = e / jb.n, n = e - m * jb.n;
  float* dst = m == jb.ma && jb.db ? jb.db + n : nullptr;
  for (int s = 0; s < jb.nseg; ++s) {
    const WSeg& sg = jb.seg[s];
    if (m >= sg.off && m < sg.off + sg.width) dst = sg.dw + (size_t)(m - sg.off) * sg.dw_ld + n;
  }
  if (dst == nullptr) return;
  const float* src = w.part + jb.part + e;
  float sum = 0.f;
  for (int cta = 0; cta < w.ctas; ++cta) sum += src[(size_t)cta * jb.slab];
  *dst = sum * jb.scale;
}

int round8(int v) { return (v + 7) / 8 * 8; }

// The weight-gradient jobs of one layer, with their slabs laid out in the
// partial buffer; returns the floats of that buffer. Pointers may be null
// for a size query. Per group of up to kTapsPerJob taps (the last with
// Waux) two jobs, one per half of dz's columns (the first group's with
// dbconv); then g against dS (dbskip) and g against dxn (dbres).
long long plan_wgrad(WArgs& w, const LayerBwd& p, float* dwconv, float* dbconv,
                     float* dwaux, float* dwskip, float* dbskip, float* dwres,
                     float* dbres, int B, int C) {
  const int T = p.T, N = 2 * C;
  w.T = T;
  w.ctas_per_item = (T + kWR - 1) / kWR;
  w.ctas = B * w.ctas_per_item;
  int j = 0;
  auto finish = [&](WJob& jb, int width) {
    jb.ma = (width + 15) / 16 * 16;
    jb.lda = ld8(jb.ma);
    jb.ldb = ld8(round8(jb.n));
    jb.slab = (jb.ma + 1) * jb.n;
  };
  for (int k0 = 0; k0 < p.K; k0 += kTapsPerJob) {
    const int k1 = k0 + kTapsPerJob < p.K ? k0 + kTapsPerJob : p.K;
    for (int h = 0; h < 2; ++h) {
      WJob& jb = w.job[j++];
      jb = WJob{};
      int off = 0;
      for (int k = k0; k < k1; ++k) {
        jb.seg[jb.nseg++] = WSeg{p.x, C, C, k * p.dil - p.left, off,
                                 dwconv ? dwconv + (size_t)k * C * N + h * C : nullptr, N};
        off += round8(C);
      }
      if (k1 == p.K) {
        jb.seg[jb.nseg++] = WSeg{p.c, p.Ca, p.Ca, 0, off, dwaux ? dwaux + h * C : nullptr, N};
        off += round8(p.Ca);
      }
      jb.b = p.dz ? p.dz + h * C : nullptr;
      jb.b_ld = N;
      jb.n = C;
      jb.scale = 1.f;
      jb.db = k0 == 0 && dbconv ? dbconv + h * C : nullptr;
      finish(jb, off);
    }
  }
  const float* rhs[2] = {p.dsk, p.dxo};
  float* dws[2] = {dwskip, dwres};
  float* dbs[2] = {dbskip, dbres};
  for (int r = 0; r < 2; ++r) {
    WJob& jb = w.job[j++];
    jb = WJob{};
    jb.seg[jb.nseg++] = WSeg{p.g, C, C, 0, 0, dws[r], C};
    jb.b = rhs[r];
    jb.b_ld = C;
    jb.n = C;
    jb.scale = r ? kSqrtHalf : 1.f;
    jb.db = dbs[r];
    finish(jb, C);
  }
  w.njobs = j;
  long long total = 0;
  for (int i = 0; i < j; ++i) {
    w.job[i].part = total;
    total += (long long)w.ctas * w.job[i].slab;
  }
  return total;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int kC, bool kV4>
cudaError_t launch_layer(const LayerBwd& p, WArgs& w, int B, cudaStream_t s) {
  const dim3 rows((p.T + kTM - 1) / kTM, B);
  const int dz_smem = sizeof(float) * kStages * dz_stage_floats<kC>();
  cudaError_t e = cudaFuncSetAttribute(
      dz_kernel<kC, kV4>, cudaFuncAttributeMaxDynamicSharedMemorySize, dz_smem);
  if (e != cudaSuccess) return e;
  dz_kernel<kC, kV4><<<rows, kThreads, dz_smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  int stage = 0, slab = 0;
  for (int i = 0; i < w.njobs; ++i) {
    const int f = kWS * (w.job[i].lda + w.job[i].ldb);
    stage = f > stage ? f : stage;
    slab = w.job[i].slab > slab ? w.job[i].slab : slab;
  }
  const int w_smem = sizeof(float) * kStages * stage;
  e = cudaFuncSetAttribute(wgrad_kernel<kV4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           w_smem);
  if (e != cudaSuccess) return e;
  wgrad_kernel<kV4><<<dim3(w.ctas_per_item, B, w.njobs), kWThreads, w_smem, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_reduce_kernel<<<dim3((slab + kThreads - 1) / kThreads, w.njobs), kThreads, 0, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int dx_smem = sizeof(float) * kStages * dx_stage_floats(kC);
  e = cudaFuncSetAttribute(dx_kernel<kC, kV4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dx_smem);
  if (e != cudaSuccess) return e;
  dx_kernel<kC, kV4><<<dim3((p.T + kTX - 1) / kTX, B), kThreads, dx_smem, s>>>(p);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int C, int Ca, int K) {
  return B < 1 || B > 65535 || T < 1 || (C != 16 && C != 64) || Ca < 1 || Ca > kMaxCa ||
         K < 1 || K > kMaxK;
}

}  // namespace

extern "C" {

// Floats of the partial buffer that wavenet_layer_bwd needs for a shape,
// or -1 for a shape it does not take or a count larger than an int.
int wavenet_bwd_part_floats(int B, int T, int C, int Ca, int K) {
  if (bad_shape(B, T, C, Ca, K)) return -1;
  WArgs w{};
  LayerBwd p{};
  p.T = T;
  p.Ca = Ca;
  p.K = K;
  const long long n = plan_wgrad(w, p, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, B, C);
  return n > 2147483647LL ? -1 : (int)n;
}

// The backward of one non-causal gated layer (see the top of this file).
// C is the residual width (= skip width = half the gate width, 16 or 64),
// Ca the conditioning width (at most 128), K at most 7. dx must not alias
// dxo. dc is written (accumulate_dc 0) or added to (1); every gradient of
// the layer's weights is written. part holds part_floats floats of
// scratch, at least wavenet_bwd_part_floats(B, T, C, Ca, K). Operands are
// copied in 16-byte pieces when Ca is a multiple of 4 and every operand is
// 16-byte aligned, else in 4-byte pieces. Returns a cudaError_t value: 0
// when every launch was accepted.
int wavenet_layer_bwd(const float* x, const float* c, const float* dxo,
                      const float* dsk, float* dx, float* dc, float* dz,
                      float* g, float* part, const float* wconv,
                      const float* bconv, const float* waux,
                      const float* wskip, const float* wres, float* dwconv,
                      float* dbconv, float* dwaux, float* dwskip,
                      float* dbskip, float* dwres, float* dbres,
                      long long part_floats, int B, int T, int C, int Ca,
                      int K, int dil, int accumulate_dc, int device,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_shape(B, T, C, Ca, K) || dil < 1) return cudaErrorInvalidValue;
  const LayerBwd p{x,     c,    dxo,   dsk,   dx, dc,  dz,           g,
                   wconv, bconv, waux, wskip, wres, T, Ca, K, dil, (K - 1) * dil / 2,
                   accumulate_dc ? 1 : 0};
  WArgs w{};
  const long long need =
      plan_wgrad(w, p, dwconv, dbconv, dwaux, dwskip, dbskip, dwres, dbres, B, C);
  if (need > 2147483647LL || part_floats < need) return cudaErrorInvalidValue;
  w.part = part;
  const void* operands[] = {x, c, dxo, dsk, dz, g, wconv, waux, wskip, wres};
  bool v4 = Ca % 4 == 0;
  for (const void* ptr : operands) v4 = v4 && aligned16(ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 16)
    return v4 ? launch_layer<16, true>(p, w, B, s) : launch_layer<16, false>(p, w, B, s);
  return v4 ? launch_layer<64, true>(p, w, B, s) : launch_layer<64, false>(p, w, B, s);
}

}  // extern "C"
