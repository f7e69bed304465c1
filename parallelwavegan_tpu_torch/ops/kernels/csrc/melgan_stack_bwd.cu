// Backward of the fused MelGAN residual stacks (K7) for Hopper (sm_90a),
// float32.
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
// Five kernels per call, on the caller's stream:
//  1. dz_kernel (stack) or dpre_kernel (final conv);
//  2. wgrad_partial_kernel, one block per 1,024 rows of one batch item and
//     per weight-gradient job (a tap of Wd, W1, Ws or a tap of Wf, each in
//     pieces of at most 64 input channels): the job's (P x N) product over
//     its rows, and the column sums of its right operand, into a partial
//     slab of its own;
//  3. wgrad_reduce_kernel: every gradient element is the sum of its slabs
//     in a fixed order, so two runs give the same bits (no atomics; the TPU
//     kernel accumulates into revisited output blocks, race-free only
//     because its grid is sequential, :15-18);
//  4. dxp_kernel: the transposed dilated conv of dz (or dpre) over every
//     padded position, into dxp (B, T + 2P, C);
//  5. dx_kernel: fold(dxp) times leaky'(x), plus g . Ws^T for a stack.
// The TPU kernel's 128-lane space-to-depth packing, block-matrix weights,
// shift tables and halo'd tile recompute are not carried over: each
// stack's input comes from device memory, every tap reads its own rows,
// and the padding's adjoint is applied on the rows it concerns.
//
// What bounds it on the card. A stack's backward takes 13 C x C
// multiply-adds per row (3 taps of z again, g . W1^T, 3 taps of the
// transposed conv, g . Ws^T, and 5 C x C weight-gradient products) against
// about 10 C floats of activations read and written per row: at MelGAN
// v1's C = 128, 64 and 32 that is 52 to 208 FLOP per byte, above the
// card's float32 balance point (20 FLOP per byte at 67 TFLOP/s and 3.35
// TB/s), so it is bound by FMA issue. The products are FFMA:
// one TF32 product per multiply missed the 1e-4 max|plain| agreement with
// the float32 reference in K4 on the card (4.6e-4 to 1.3e-3 of max|plain|
// at v1 shapes; PERF.md), where split TF32 on the tensor cores held
// it within 1e-5; this kernel's products are of the same kind, and split
// TF32 is untried here.
// This first design stages operands through shared memory without double
// buffering, 8 rows x 4 output channels per thread (float4 loads of both
// operands feed 128 FMAs per 12 loads); it aims at being right, and its
// time stands beside its bound in PERF.md.

#include "rowprod.cuh"

namespace {

constexpr int kMaxTile = full_tile(16);                // rows of a tile at C = 16
constexpr int kRowSmem = row_smem_floats(kMaxTile);  // floats

struct StackBwd {
  const float* x;   // stack input (B, T, C)
  const float* g;   // cotangent of the stack output (B, T, C)
  float* dz;        // (B, T, C)
  float* h;         // leaky(z) (B, T, C)
  const float* wd;  // (K, C, C)
  const float* bd;  // (C)
  const float* w1;  // (C, C)
  int T, C, K, dil, pad, mode;
  float slope;
};

// z again (K taps of pad(leaky(x))), then dh = g . W1^T; writes dz =
// dh * leaky'(z) and h = leaky(z). One block per tile of one batch item.
__global__ void __launch_bounds__(kThreads) dz_kernel(StackBwd p) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* a_s = w_s + kCW * kMaxN;
  const int C = p.C, b = blockIdx.y, tile = full_tile(C);
  const RowMap m(C, tile);
  const int u0 = blockIdx.x * tile;

  Seg segs[kMaxSegs];
  for (int k = 0; k < p.K; ++k)
    segs[k] = Seg{p.x, C, C, k * p.dil - p.pad, 1.f, p.wd + (size_t)k * C * C, C, 1};
  float z[kRT][4];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = m.active ? p.bd[4 * m.cg + j] : 0.f;
  row_product(segs, p.K, Pad{p.T, 1, p.pad, p.mode, p.slope}, C, tile, b, u0, w_s,
              a_s, z);

  // dh = g . W1^T: W[q][n] = W1[n][q]
  segs[0] = Seg{p.g, C, C, 0, 1.f, p.w1, 1, C};
  float dh[kRT][4];
  zero(dh);
  row_product(segs, 1, Pad{p.T, 0, 0, kZero, 0.f}, C, tile, b, u0, w_s,
              a_s, dh);
  if (!m.active) return;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int t = u0 + m.rg + i * m.rgs;
    if (t >= p.T) continue;
    const size_t o = ((size_t)b * p.T + t) * C + 4 * m.cg;
    *reinterpret_cast<float4*>(p.dz + o) = make_float4(
        dh[i][0] * dleaky(z[i][0], p.slope), dh[i][1] * dleaky(z[i][1], p.slope),
        dh[i][2] * dleaky(z[i][2], p.slope), dh[i][3] * dleaky(z[i][3], p.slope));
    *reinterpret_cast<float4*>(p.h + o) =
        make_float4(leaky(z[i][0], p.slope), leaky(z[i][1], p.slope),
                    leaky(z[i][2], p.slope), leaky(z[i][3], p.slope));
  }
}

// dpre = dy * (1 - y^2), elementwise over n values.
__global__ void __launch_bounds__(kThreads) dpre_kernel(const float* y,
                                                        const float* dy,
                                                        float* dpre, size_t n) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads)
    dpre[i] = dy[i] * (1.f - y[i] * y[i]);
}

struct DxArgs {
  const float* src;  // cotangent of the conv output: dz (ld C) or dpre
  int src_ld;        // its row length: C, or Cout for the final conv
  const float* w;    // tap k, W[q][n] = w[k * w_tap + n * src_ld + q]
  int w_tap;
  float* dxp;        // (B, T + 2 * pad, C)
  const float* x;    // the conv's input (B, T, C)
  const float* g;    // cotangent of the stack output, for g . Ws^T
  const float* ws;   // (C, C), or null (final conv: no skip)
  float* dx;         // (B, T, C)
  int T, C, K, dil, pad, mode;
  float slope;
};

// dxp[u] = sum_k src[u - k * dil] . W[k]^T for u in [0, T + 2 * pad), the
// cotangent of padded position u - pad (src rows outside [0, T) are zero).
__global__ void __launch_bounds__(kThreads) dxp_kernel(DxArgs p) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* a_s = w_s + kCW * kMaxN;
  const int C = p.C, b = blockIdx.y, tile = full_tile(C);
  const RowMap m(C, tile);
  const int u0 = blockIdx.x * tile;
  const int rows = p.T + 2 * p.pad;

  Seg segs[kMaxSegs];
  for (int k = 0; k < p.K; ++k)
    segs[k] = Seg{p.src, p.src_ld, p.src_ld, -k * p.dil, 1.f,
                  p.w + (size_t)k * p.w_tap, 1, p.src_ld};
  float acc[kRT][4];
  zero(acc);
  row_product(segs, p.K, Pad{p.T, 0, 0, kZero, 0.f}, C, tile, b, u0, w_s,
              a_s, acc);
  if (!m.active) return;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int u = u0 + m.rg + i * m.rgs;
    if (u >= rows) continue;
    *reinterpret_cast<float4*>(p.dxp + ((size_t)b * rows + u) * C + 4 * m.cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The cotangent of row r of leaky(x): its own padded position and, where
// the forward's padding read row r again, those positions too. dxp points
// at the batch item's T + 2 * pad rows.
__device__ __forceinline__ float fold(const float* dxp, int r, int col, int T,
                                      int pad, int C, int mode) {
  float s = dxp[(size_t)(pad + r) * C + col];
  if (mode == kReflect) {
    if (r >= 1 && r <= pad) s += dxp[(size_t)(pad - r) * C + col];
    if (r >= T - 1 - pad && r <= T - 2)
      s += dxp[(size_t)(pad + 2 * T - 2 - r) * C + col];
  } else if (mode == kEdge) {
    if (r == 0)
      for (int u = 0; u < pad; ++u) s += dxp[(size_t)u * C + col];
    if (r == T - 1)
      for (int u = T + pad; u < T + 2 * pad; ++u) s += dxp[(size_t)u * C + col];
  }
  return s;
}

// dx = leaky'(x) * fold(dxp) (+ g . Ws^T).
__global__ void __launch_bounds__(kThreads) dx_kernel(DxArgs p) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* a_s = w_s + kCW * kMaxN;
  const int C = p.C, b = blockIdx.y, tile = full_tile(C);
  const RowMap m(C, tile);
  const int u0 = blockIdx.x * tile;

  float acc[kRT][4];
  zero(acc);
  if (p.ws != nullptr) {  // the same branch in every thread
    const Seg seg{p.g, C, C, 0, 1.f, p.ws, 1, C};  // W[q][n] = Ws[n][q]
    row_product(&seg, 1, Pad{p.T, 0, 0, kZero, 0.f}, C, tile, b, u0, w_s,
                a_s, acc);
  }
  if (!m.active) return;
  const float* dxp = p.dxp + (size_t)b * (p.T + 2 * p.pad) * C;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int t = u0 + m.rg + i * m.rgs;
    if (t >= p.T) continue;
    const size_t o = ((size_t)b * p.T + t) * C + 4 * m.cg;
    const float4 xv = *reinterpret_cast<const float4*>(p.x + o);
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = acc[i][j] + dleaky(lane(xv, j), p.slope) *
                               fold(dxp, t, 4 * m.cg + j, p.T, p.pad, C, p.mode);
    *reinterpret_cast<float4*>(p.dx + o) = make_float4(out[0], out[1], out[2], out[3]);
  }
}

// Jobs for a gradient (taps x C_in x N, rows N apart) of the product of
// the rows A[t + shift_k] (k < taps; a read as pad(leaky(a)) when act) and
// b (B, T, N), in pieces of kMaxP input channels; the first piece of the
// first tap also takes db. Returns the next free job index.
int add_jobs(WArgs& w, int j, const float* a, int C, int taps, int dil,
             int pad, int act, const float* b, int N, float* dw, float* db) {
  for (int k = 0; k < taps; ++k)
    for (int c0 = 0; c0 < C; c0 += kMaxP)
      w.job[j++] = WJob{a + c0, C, C - c0 < kMaxP ? C - c0 : kMaxP, k * dil - pad,
                        act, b, N, 1.f, dw + ((size_t)k * C + c0) * N,
                        k == 0 && c0 == 0 ? db : nullptr};
  return j;
}

int pieces(int C) { return (C + kMaxP - 1) / kMaxP; }

cudaError_t set_row_smem() {
  const int bytes = (int)(sizeof(float) * kRowSmem);
  cudaError_t e = cudaFuncSetAttribute(
      dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dxp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dx_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

// Steps 4 and 5 of a call: dxp, then dx.
cudaError_t launch_dx(const DxArgs& d, int B, cudaStream_t s) {
  const size_t smem = sizeof(float) * kRowSmem;
  const int tile = full_tile(d.C);
  dxp_kernel<<<dim3((d.T + 2 * d.pad + tile - 1) / tile, B), kThreads, smem, s>>>(d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dx_kernel<<<dim3((d.T + tile - 1) / tile, B), kThreads, smem, s>>>(d);
  return cudaGetLastError();
}

bool bad_args(int B, int T, int C, int K, int pad, int mode) {
  return B < 1 || B > 65535 || T < 1 || C < 16 || C > kMaxN || C % 16 != 0 ||
         K < 1 || K % 2 == 0 || K > kMaxSegs || mode < kReflect ||
         mode > kZero || (mode == kReflect && pad >= T);
}

}  // namespace

extern "C" {

// Floats of scratch that melgan_stack_bwd needs for a shape, or -1 when
// the jobs do not fit one launch or the count an int.
int melgan_stack_bwd_part_floats(int B, int T, int C, int K) {
  return scratch_floats(B, T, C, (K + 2) * pieces(C));
}

// Floats of scratch that melgan_outconv_bwd needs for a shape, or -1.
int melgan_outconv_bwd_part_floats(int B, int T, int C, int Cout, int K) {
  return scratch_floats(B, T, Cout, K * pieces(C));
}

// The backward of one ResidualStack (see the top of this file): x its
// input, g the cotangent of its output, bd the forward's dilated-conv bias
// (zeros without bias). Writes dx (which must alias neither x nor g) and
// every weight and bias gradient; dz, h (B, T, C), dxp (B, T + 2P, C) and
// part (part_floats floats, at least melgan_stack_bwd_part_floats) are
// scratch. C is a multiple of 16 up to 128, K odd up to 7; reflect
// padding needs P = (K-1)/2 * dil below T. Returns a cudaError_t value: 0
// when every launch was accepted.
int melgan_stack_bwd(const float* x, const float* g, float* dx, float* dz,
                     float* h, float* dxp, float* part, const float* wd,
                     const float* bd, const float* w1, const float* ws,
                     float* dwd, float* dbd, float* dw1, float* db1,
                     float* dws, float* dbs, long long part_floats, int B,
                     int T, int C, int K, int dil, int mode, float slope,
                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int pad = (K - 1) / 2 * dil;
  if (dil < 1 || bad_args(B, T, C, K, pad, mode)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = set_row_smem();
  if (e != cudaSuccess) return e;
  const int tile = full_tile(C);

  const StackBwd p{x, g, dz, h, wd, bd, w1, T, C, K, dil, pad, mode, slope};
  dz_kernel<<<dim3((T + tile - 1) / tile, B), kThreads, sizeof(float) * kRowSmem,
              s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  WArgs w{};
  w.T = T;
  w.pad = pad;
  w.mode = mode;
  w.slope = slope;
  int j = add_jobs(w, 0, x, C, K, dil, pad, 1, dz, C, dwd, dbd);
  e = launch_wgrad(w, j, B, part, part_floats, s);
  if (e != cudaSuccess) return e;
  // dW1 = h^T g and dWs = x^T g share the right operand g
  j = add_jobs(w, 0, h, C, 1, 1, 0, 0, g, C, dw1, db1);
  j = add_jobs(w, j, x, C, 1, 1, 0, 0, g, C, dws, dbs);
  e = launch_wgrad(w, j, B, part, part_floats, s);
  if (e != cudaSuccess) return e;

  const DxArgs d{dz, C, wd, C * C, dxp, x, g, ws, dx, T, C, K, dil, pad, mode, slope};
  return launch_dx(d, B, s);
}

// The backward of the trailing leaky -> K-tap conv (C -> Cout) -> tanh: x
// its input, y its output, dy the cotangent of y. Writes dx and the
// gradients of w (K, C, Cout) and b (Cout); dpre (B, T, Cout), dxp (B, T +
// K - 1, C) and part are scratch. Returns a cudaError_t value.
int melgan_outconv_bwd(const float* x, const float* y, const float* dy,
                       float* dx, float* dpre, float* dxp, float* part,
                       const float* w, float* dw, float* db,
                       long long part_floats, int B, int T, int C, int Cout,
                       int K, int mode, float slope, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int pad = (K - 1) / 2;
  if (Cout < 1 || Cout > kMaxN || bad_args(B, T, C, K, pad, mode))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = set_row_smem();
  if (e != cudaSuccess) return e;

  const size_t n = (size_t)B * T * Cout;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  dpre_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(y, dy,
                                                                           dpre, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  WArgs wa{};
  wa.T = T;
  wa.pad = pad;
  wa.mode = mode;
  wa.slope = slope;
  const int j = add_jobs(wa, 0, x, C, K, 1, pad, 1, dpre, Cout, dw, db);
  e = launch_wgrad(wa, j, B, part, part_floats, s);
  if (e != cudaSuccess) return e;

  const DxArgs d{dpre, Cout, w, C * Cout, dxp, x, nullptr, nullptr, dx,
                 T, C, K, 1, pad, mode, slope};
  return launch_dx(d, B, s);
}

}  // extern "C"
