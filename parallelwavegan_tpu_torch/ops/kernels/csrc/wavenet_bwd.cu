// Backward of the fused WaveNet gated layers (K4) for Hopper (sm_90a),
// float32.
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
//  1. dz_kernel, one block per 64 rows of one batch item: recomputes z as a
//     row product over the K taps of x_l and c, then dg over [dxn | dS],
//     both through shared memory, and writes dz (B, T, 2C) and g (B, T, C).
//  2. wgrad_partial_kernel, one block per 1,024 rows of one batch item and
//     per weight-gradient job (a tap of Wconv with dbconv, Waux in pieces
//     of 64 input channels, Wskip with dbskip, Wres with dbres): the
//     job's (P x N) product over its rows, and the column sums of its right
//     operand, into a partial slab of its own.
//  3. wgrad_reduce_kernel: every gradient element is the sum of the slabs
//     in a fixed order, so two runs give the same bits (no atomics; the TPU
//     kernel accumulates into revisited output blocks, race-free only
//     because its grid is sequential, :18-20).
//  4. dx_kernel: the transposed dilated conv of dz, plus the residual dxn,
//     into dx_l, and dz . Waux^T written into (or added to) dc.
// The TPU kernel's 128-lane channel padding and its double-halo tile
// recompute (:197-239) are not carried over: here each layer's input
// comes from device memory and every shift reads its own rows.
//
// What bounds it on the card. At Parallel WaveGAN v1 widths (C = 64,
// gate 128, aux 80, K = 3) one layer's backward is 34,816 (z) + 8,192
// (dg) + 24,576 (conv transpose) + 10,240 (dc) + 43,008 (weight grads) =
// 120,832 multiply-adds per row, against about 2.1 KB of activations read
// and written per row: far above the card's float32 balance point, so it
// is bound by FMA issue. TF32 tensor cores would miss the 2e-4 agreement
// with the float32 reference, so the products are FFMA. This first design
// stages operands through shared memory without double buffering and
// leaves idle threads where a product is narrower than 128 columns; it
// aims at being right, and its time stands beside its bound in PERF.md.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;         // rows of one row-product block
constexpr int kCW = 16;           // input channels staged per step
constexpr int kRT = 8;            // rows per thread
constexpr int kRG = kTile / kRT;  // row groups
constexpr int kMaxN = 128;        // widest product output
constexpr int kMaxSegs = 8;       // K taps + c
constexpr int kRowsPerCta = 1024; // rows of one weight-gradient partial
constexpr int kRS = 32;           // rows staged per step of a partial
constexpr int kMaxP = 64;         // input channels of one weight-gradient job
constexpr int kSlab = (kMaxP + 1) * kMaxN;  // P rows, then the column sums
constexpr int kMaxJobs = 12;
constexpr float kSqrtHalf = 0.70710678118654752f;

// One operand of a row product: rows src[b][t + shift][0 .. P) * scale
// (zero outside [0, T)) times W[p][n], read at w + p * w_row + n * w_col.
struct Seg {
  const float* src;
  int ld, P, shift;
  float scale;
  const float* w;
  int w_row, w_col;
};

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
  int T, C, Ca, K, dil, left, accumulate_dc;
};

// A job of the weight gradients: dw (P x N, row-major) = sum_t a[t +
// shift]^T (b[t] * scale), and db (N, optional) = sum_t b[t] * scale,
// over t in [0, T) of every batch item.
struct WJob {
  const float* a;
  int a_ld, P, shift;
  const float* b;
  int b_ld, N;
  float scale;
  float* dw;
  float* db;
};

struct WArgs {
  WJob job[kMaxJobs];
  float* part;  // (jobs, ctas, kSlab)
  int njobs, T, ctas_per_item, ctas;
};

struct RowMap {
  int np, ng, cg, rg;
  bool active;
  __device__ explicit RowMap(int n) {
    np = (n + 3) & ~3;
    ng = np / 4;
    cg = threadIdx.x % ng;
    rg = threadIdx.x / ng;
    active = rg < kRG;
  }
};

// acc[i][j] += sum over the segments of A[row][p] * W[p][4*cg + j] for the
// block's rows t0 + row, row = rg + kRG * i. Every thread of the block
// must call it (it synchronises).
__device__ void row_product(const Seg* segs, int nseg, int n, int b, int t0,
                            int T, float* a_s, float* w_s,
                            float (&acc)[kRT][4]) {
  const RowMap m(n);
  for (int s = 0; s < nseg; ++s) {
    const Seg sg = segs[s];
    const float* src = sg.src + (size_t)b * T * sg.ld;
    for (int c0 = 0; c0 < sg.P; c0 += kCW) {
      for (int e = threadIdx.x; e < kTile * kCW; e += kThreads) {
        const int row = e / kCW, j = e % kCW;
        const int t = t0 + row + sg.shift;
        float v = 0.f;
        if (t >= 0 && t < T && c0 + j < sg.P)
          v = src[(size_t)t * sg.ld + c0 + j] * sg.scale;
        a_s[row * (kCW + 1) + j] = v;
      }
      for (int e = threadIdx.x; e < kCW * m.np; e += kThreads) {
        const int p = e / m.np, col = e % m.np;
        float v = 0.f;
        if (c0 + p < sg.P && col < n)
          v = sg.w[(size_t)(c0 + p) * sg.w_row + (size_t)col * sg.w_col];
        w_s[p * m.np + col] = v;
      }
      __syncthreads();
      if (m.active) {
#pragma unroll 4
        for (int ci = 0; ci < kCW; ++ci) {
          const float4 w =
              *reinterpret_cast<const float4*>(w_s + ci * m.np + 4 * m.cg);
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            const float a = a_s[(m.rg + kRG * i) * (kCW + 1) + ci];
            acc[i][0] = fmaf(a, w.x, acc[i][0]);
            acc[i][1] = fmaf(a, w.y, acc[i][1]);
            acc[i][2] = fmaf(a, w.z, acc[i][2]);
            acc[i][3] = fmaf(a, w.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kRT][4]) {
#pragma unroll
  for (int i = 0; i < kRT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// shared memory of the row kernels (floats): w_s, a_s, then (dz_kernel
// only) z and dg of the block's rows
constexpr int kRowSmem = kCW * kMaxN + kTile * (kCW + 1);
constexpr int kDzSmem = kRowSmem + kTile * kMaxN + kTile * (kMaxN / 2);

__global__ void __launch_bounds__(kThreads) dz_kernel(LayerBwd p) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* a_s = w_s + kCW * kMaxN;
  float* z_s = a_s + kTile * (kCW + 1);
  float* dg_s = z_s + kTile * kMaxN;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int C = p.C, N = 2 * C;

  Seg segs[kMaxSegs];
  for (int k = 0; k < p.K; ++k)
    segs[k] = Seg{p.x, C, C, k * p.dil - p.left, 1.f,
                  p.wconv + (size_t)k * C * N, N, 1};
  segs[p.K] = Seg{p.c, p.Ca, p.Ca, 0, 1.f, p.waux, N, 1};
  float acc[kRT][4];
  {
    const RowMap m(N);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = (m.active && 4 * m.cg + j < N) ? p.bconv[4 * m.cg + j] : 0.f;
    }
    row_product(segs, p.K + 1, N, b, t0, p.T, a_s, w_s, acc);
    if (m.active) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * m.cg + j < N) z_s[(m.rg + kRG * i) * N + 4 * m.cg + j] = acc[i][j];
      }
    }
  }
  // dg = dxn . Wres^T + dS . Wskip^T: W[p][n] = Wres[n][p]
  segs[0] = Seg{p.dxo, C, C, 0, kSqrtHalf, p.wres, 1, C};
  segs[1] = Seg{p.dsk, C, C, 0, 1.f, p.wskip, 1, C};
  zero(acc);
  {
    const RowMap m(C);
    row_product(segs, 2, C, b, t0, p.T, a_s, w_s, acc);
    if (m.active) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * m.cg + j < C) dg_s[(m.rg + kRG * i) * C + 4 * m.cg + j] = acc[i][j];
      }
    }
  }
  __syncthreads();
  const size_t bo = (size_t)b * p.T;
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int row = e / C, j = e % C;
    const int t = t0 + row;
    if (t >= p.T) continue;
    const float a = tanhf(z_s[row * N + j]);
    const float s = sigmoid(z_s[row * N + C + j]);
    const float dg = dg_s[row * C + j];
    float* dzr = p.dz + (bo + t) * N;
    dzr[j] = dg * s * (1.f - a * a);
    dzr[C + j] = dg * a * s * (1.f - s);
    p.g[(bo + t) * C + j] = a * s;
  }
}

__global__ void __launch_bounds__(kThreads) dx_kernel(LayerBwd p) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* a_s = w_s + kCW * kMaxN;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int C = p.C, N = 2 * C;
  const size_t bo = (size_t)b * p.T;

  // dx_l[t] = dxn[t] + sum_k dz[t - k*dil + left] . Wconv[k]^T:
  // W[p][n] = Wconv[k][n][p]
  Seg segs[kMaxSegs];
  for (int k = 0; k < p.K; ++k)
    segs[k] = Seg{p.dz, N, N, p.left - k * p.dil, 1.f,
                  p.wconv + (size_t)k * C * N, 1, N};
  float acc[kRT][4];
  zero(acc);
  {
    const RowMap m(C);
    row_product(segs, p.K, C, b, t0, p.T, a_s, w_s, acc);
    if (m.active) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = t0 + m.rg + kRG * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 4 * m.cg + j;
          if (t < p.T && col < C) {
            const size_t o = (bo + t) * C + col;
            p.dx[o] = acc[i][j] + p.dxo[o] * kSqrtHalf;
          }
        }
      }
    }
  }
  // dc[t] (+)= dz[t] . Waux^T: W[p][n] = Waux[n][p]
  segs[0] = Seg{p.dz, N, N, 0, 1.f, p.waux, 1, N};
  zero(acc);
  {
    const RowMap m(p.Ca);
    row_product(segs, 1, p.Ca, b, t0, p.T, a_s, w_s, acc);
    if (m.active) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = t0 + m.rg + kRG * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 4 * m.cg + j;
          if (t < p.T && col < p.Ca) {
            const size_t o = (bo + t) * p.Ca + col;
            p.dc[o] = p.accumulate_dc ? p.dc[o] + acc[i][j] : acc[i][j];
          }
        }
      }
    }
  }
}

// One block: kRowsPerCta rows of batch item blockIdx.y for job blockIdx.z.
// Thread (pg, ng) holds rows 8*pg .. 8*pg+7 and columns 4*ng .. 4*ng+3 of
// the job's (P x N) product; the threads of pg 0 also sum the columns.
__global__ void __launch_bounds__(kThreads) wgrad_partial_kernel(WArgs w) {
  __shared__ __align__(16) float a_s[kRS * kMaxP];
  __shared__ __align__(16) float b_s[kRS * kMaxN];
  const WJob jb = w.job[blockIdx.z];
  const int item = blockIdx.y;
  const int t_begin = blockIdx.x * kRowsPerCta;
  const int t_end = min(w.T, t_begin + kRowsPerCta);
  const int pg = threadIdx.x / 32, ng = threadIdx.x % 32;
  const float* a = jb.a + (size_t)item * w.T * jb.a_ld;
  const float* bs = jb.b + (size_t)item * w.T * jb.b_ld;

  float acc[8][4];
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int r0 = t_begin; r0 < t_end; r0 += kRS) {
    for (int e = threadIdx.x; e < kRS * kMaxP; e += kThreads) {
      const int r = e / kMaxP, q = e % kMaxP;
      const int t = r0 + r, ta = t + jb.shift;
      float v = 0.f;
      if (t < t_end && ta >= 0 && ta < w.T && q < jb.P)
        v = a[(size_t)ta * jb.a_ld + q];
      a_s[e] = v;
    }
    for (int e = threadIdx.x; e < kRS * kMaxN; e += kThreads) {
      const int r = e / kMaxN, n = e % kMaxN;
      const int t = r0 + r;
      float v = 0.f;
      if (t < t_end && n < jb.N) v = bs[(size_t)t * jb.b_ld + n] * jb.scale;
      b_s[e] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRS; ++r) {
      const float4 bv = *reinterpret_cast<const float4*>(b_s + r * kMaxN + 4 * ng);
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + r * kMaxP + 8 * pg);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a_s + r * kMaxP + 8 * pg + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
      }
      if (pg == 0) {
        sum[0] += bv.x;
        sum[1] += bv.y;
        sum[2] += bv.z;
        sum[3] += bv.w;
      }
    }
    __syncthreads();
  }

  const int cta = item * w.ctas_per_item + blockIdx.x;
  float* slab = w.part + ((size_t)blockIdx.z * w.ctas + cta) * kSlab;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int prow = 8 * pg + i;
    if (prow >= jb.P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * ng + j < jb.N) slab[prow * kMaxN + 4 * ng + j] = acc[i][j];
  }
  if (pg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * ng + j < jb.N) slab[jb.P * kMaxN + 4 * ng + j] = sum[j];
  }
}

// Element e of job blockIdx.y: the sum of its slabs, cta 0 first.
__global__ void __launch_bounds__(kThreads) wgrad_reduce_kernel(WArgs w) {
  const WJob jb = w.job[blockIdx.y];
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int prow = e / kMaxN, n = e % kMaxN;
  if (prow > jb.P || n >= jb.N) return;
  if (prow == jb.P && jb.db == nullptr) return;
  const float* src = w.part + (size_t)blockIdx.y * w.ctas * kSlab + e;
  float s = 0.f;
  for (int cta = 0; cta < w.ctas; ++cta) s += src[(size_t)cta * kSlab];
  if (prow < jb.P)
    jb.dw[(size_t)prow * jb.N + n] = s;
  else
    jb.db[n] = s;
}

}  // namespace

extern "C" {

// Floats of the partial buffer that wavenet_layer_bwd needs for a shape,
// or -1 when that is more than an int holds.
int wavenet_bwd_part_floats(int B, int T, int Ca, int K) {
  const long long jobs = K + (Ca + kMaxP - 1) / kMaxP + 2;
  const long long ctas = (long long)B * ((T + kRowsPerCta - 1) / kRowsPerCta);
  const long long n = jobs * ctas * kSlab;
  return n > 2147483647LL ? -1 : (int)n;
}

// The backward of one non-causal gated layer (see the top of this file).
// C is the residual width (= skip width = half the gate width, at most 64),
// Ca the conditioning width (at most 128). dx must not alias dxo. dc is
// written (accumulate_dc 0) or added to (1); every gradient of the layer's
// weights is written. part holds part_floats floats of scratch, at least
// wavenet_bwd_part_floats(B, T, Ca, K). Returns a cudaError_t value: 0
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
  if (B < 1 || B > 65535 || T < 1 || C < 1 || C > kMaxP || Ca < 1 ||
      Ca > kMaxN || K < 1 || K + 1 > kMaxSegs || dil < 1)
    return cudaErrorInvalidValue;
  const int n_aux = (Ca + kMaxP - 1) / kMaxP;
  const int njobs = K + n_aux + 2;
  const int need = wavenet_bwd_part_floats(B, T, Ca, K);
  if (njobs > kMaxJobs || need < 0 || part_floats < need)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int left = (K - 1) * dil / 2;
  const int N = 2 * C;
  const LayerBwd p{x,     c,     dxo,   dsk,   dx,   dc,   dz,   g, wconv,
                   bconv, waux,  wskip, wres,  T,    C,    Ca,   K, dil,
                   left,  accumulate_dc ? 1 : 0};
  const dim3 rows((T + kTile - 1) / kTile, B);

  const size_t dz_smem = sizeof(float) * kDzSmem;
  e = cudaFuncSetAttribute(dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dz_smem);
  if (e != cudaSuccess) return e;
  dz_kernel<<<rows, kThreads, dz_smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  WArgs w{};
  int j = 0;
  for (int k = 0; k < K; ++k)
    w.job[j++] = WJob{x, C, C, k * dil - left, dz, N, N, 1.f,
                      dwconv + (size_t)k * C * N, k == 0 ? dbconv : nullptr};
  for (int a0 = 0; a0 < Ca; a0 += kMaxP)
    w.job[j++] = WJob{c + a0, Ca, Ca - a0 < kMaxP ? Ca - a0 : kMaxP, 0, dz, N,
                      N, 1.f, dwaux + (size_t)a0 * N, nullptr};
  w.job[j++] = WJob{g, C, C, 0, dsk, C, C, 1.f, dwskip, dbskip};
  w.job[j++] = WJob{g, C, C, 0, dxo, C, C, kSqrtHalf, dwres, dbres};
  w.part = part;
  w.njobs = njobs;
  w.T = T;
  w.ctas_per_item = (T + kRowsPerCta - 1) / kRowsPerCta;
  w.ctas = B * w.ctas_per_item;
  wgrad_partial_kernel<<<dim3(w.ctas_per_item, B, njobs), kThreads, 0, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_reduce_kernel<<<dim3((kSlab + kThreads - 1) / kThreads, njobs),
                        kThreads, 0, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  dx_kernel<<<rows, kThreads, sizeof(float) * kRowSmem, s>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
