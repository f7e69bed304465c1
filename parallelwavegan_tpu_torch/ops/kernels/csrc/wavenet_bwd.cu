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
// Four kernels per call, on the caller's stream (the row products and
// kernels 2 and 3 are csrc/rowprod.cuh's, shared with K7):
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

#include "rowprod.cuh"

namespace {

constexpr int kTile = 64;  // rows of one row-product block
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
  int T, C, Ca, K, dil, left, accumulate_dc;
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// shared memory of the row kernels (floats): w_s, a_s, then (dz_kernel
// only) z and dg of the block's rows
constexpr int kRowSmem = row_smem_floats(kTile);
constexpr int kDzSmem = kRowSmem + kTile * kMaxN + kTile * (kMaxN / 2);

__global__ void __launch_bounds__(kThreads) dz_kernel(LayerBwd p) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* a_s = w_s + kCW * kMaxN;
  float* z_s = a_s + kTile * kAS;
  float* dg_s = z_s + kTile * kMaxN;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int C = p.C, N = 2 * C;
  const Pad rows{p.T, 0, 0, kZero, 0.f};

  Seg segs[kMaxSegs];
  for (int k = 0; k < p.K; ++k)
    segs[k] = Seg{p.x, C, C, k * p.dil - p.left, 1.f,
                  p.wconv + (size_t)k * C * N, N, 1};
  segs[p.K] = Seg{p.c, p.Ca, p.Ca, 0, 1.f, p.waux, N, 1};
  float acc[kRT][4];
  {
    const RowMap m(N, kTile);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = (m.active && 4 * m.cg + j < N) ? p.bconv[4 * m.cg + j] : 0.f;
    }
    row_product<false, false>(segs, p.K + 1, rows, N, kTile, b, t0, w_s, a_s, acc);
    if (m.active) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * m.cg + j < N) z_s[(m.rg + m.rgs * i) * N + 4 * m.cg + j] = acc[i][j];
      }
    }
  }
  // dg = dxn . Wres^T + dS . Wskip^T: W[p][n] = Wres[n][p]
  segs[0] = Seg{p.dxo, C, C, 0, kSqrtHalf, p.wres, 1, C};
  segs[1] = Seg{p.dsk, C, C, 0, 1.f, p.wskip, 1, C};
  zero(acc);
  {
    const RowMap m(C, kTile);
    row_product<false, false>(segs, 2, rows, C, kTile, b, t0, w_s, a_s, acc);
    if (m.active) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * m.cg + j < C) dg_s[(m.rg + m.rgs * i) * C + 4 * m.cg + j] = acc[i][j];
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
  const Pad rows{p.T, 0, 0, kZero, 0.f};

  // dx_l[t] = dxn[t] + sum_k dz[t - k*dil + left] . Wconv[k]^T:
  // W[p][n] = Wconv[k][n][p]
  Seg segs[kMaxSegs];
  for (int k = 0; k < p.K; ++k)
    segs[k] = Seg{p.dz, N, N, p.left - k * p.dil, 1.f,
                  p.wconv + (size_t)k * C * N, 1, N};
  float acc[kRT][4];
  zero(acc);
  {
    const RowMap m(C, kTile);
    row_product<false, false>(segs, p.K, rows, C, kTile, b, t0, w_s, a_s, acc);
    if (m.active) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = t0 + m.rg + m.rgs * i;
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
    const RowMap m(p.Ca, kTile);
    row_product<false, false>(segs, 1, rows, p.Ca, kTile, b, t0, w_s, a_s, acc);
    if (m.active) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = t0 + m.rg + m.rgs * i;
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

// weight-gradient jobs of one layer: the K taps of Wconv (the first with
// dbconv), Waux in pieces of kMaxP input channels, Wskip with dbskip and
// Wres with dbres
int layer_jobs(int Ca, int K) { return K + (Ca + kMaxP - 1) / kMaxP + 2; }

}  // namespace

extern "C" {

// Floats of the partial buffer that wavenet_layer_bwd needs for a shape,
// or -1 when that is more than an int holds.
int wavenet_bwd_part_floats(int B, int T, int Ca, int K) {
  return scratch_floats(B, T, kMaxN, layer_jobs(Ca, K));
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
  const int need = wavenet_bwd_part_floats(B, T, Ca, K);
  if (need < 0 || part_floats < need) return cudaErrorInvalidValue;
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
  w.T = T;
  w.mode = kZero;
  int j = 0;
  for (int k = 0; k < K; ++k)
    w.job[j++] = WJob{x, C, C, k * dil - left, 0, dz, N, 1.f,
                      dwconv + (size_t)k * C * N, k == 0 ? dbconv : nullptr};
  for (int a0 = 0; a0 < Ca; a0 += kMaxP)
    w.job[j++] = WJob{c + a0, Ca, Ca - a0 < kMaxP ? Ca - a0 : kMaxP, 0, 0, dz, N,
                      1.f, dwaux + (size_t)a0 * N, nullptr};
  w.job[j++] = WJob{g, C, C, 0, 0, dsk, C, 1.f, dwskip, dbskip};
  w.job[j++] = WJob{g, C, C, 0, 0, dxo, C, kSqrtHalf, dwres, dbres};
  e = launch_wgrad<kMaxN / 4>(w, j, B, part, part_floats, s);
  if (e != cudaSuccess) return e;

  dx_kernel<<<rows, kThreads, sizeof(float) * kRowSmem, s>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
