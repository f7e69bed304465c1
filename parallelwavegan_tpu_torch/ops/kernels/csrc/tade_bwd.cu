// Backward of the fused StyleMelGAN TADEResBlock (K9a, K9b) for Hopper
// (sm_90a), float32.
//
// Replaces the two Pallas TPU kernels of the JAX package
//   parallelwavegan_tpu/ops/pallas_kernels/tade_train.py
//     K9a :438 _run_tade1_bwd (body _kernel_tade1_bwd :226), stage 1
//     K9b :523 _run_tade2_bwd (body _kernel_tade2_bwd :312), stage 2
// the backward of tade_block_train (:659) / fused_tade_blocks_train (:709).
// A stage is the half of a block that one forward kernel computes
// (csrc/tade.cu): at its rate L (T for stage 1, sT for stage 2)
//   a' = aux(src);  [s | h] = g(a');  y = s * up(xn) + h;  t = gc_D(y)
//   out = gate(t)        (stage 1: x2; stage 2: out - up(x))
// with src = c (stage 1) or up(a) (stage 2), xn the instance-normalised x
// or x2 (up() its nearest x sc stretch at stage 2), every conv 9 taps,
// "same" zero padding (each intermediate zero outside [0, L) before the
// next conv reads it), D = 1 for gc1 and the block's dilation for gc2.
// One call of tade_stage_bwd takes the stage's re-run (csrc/tade.cu's
// kernels with Save: y, s, t, a' and up(a), from the saved block input,
// c, x2 and a, as the JAX residuals) and the cotangents dout of the gate's
// output and dext of a' from outside (dco, the block's c_out cotangent, at
// stage 2; stage 2's da stretched back at stage 1), and computes
//   dT   = gate'(t) dout        softmax: [p (u - sum u p) | dout p (1 - th^2)]
//                               with p = softmax(ta), th = tanh(tb), u = dout th
//   dy   = sum_k dT[u - (k-4)D] . Wgc[k]^T         (rows of dT outside [0, L): 0)
//   dG   = [dy * up(xn) | dy],  dxn = dy * s       (zero outside [0, L))
//   da'  = sum_k dG[u - (k-4)] . Wg[k]^T + dext
//   dsrc = sum_k da'[u - (k-4)] . Waux[k]^T
//   dWgc[k] = sum_t y[t + (k-4)D]^T dT[t],  dWg[k] = sum_t a'[t + k-4]^T dG[t],
//   dWaux[k] = sum_t src[t + k-4]^T da'[t],  and each bias the column sum.
// The Python wrapper (ops/kernels/tade_train.py) then applies what is glue
// in JAX too: the stretch adjoint (pairs of rows summed) and the instance
// norm's backward r (dxn - E[dxn] - xn E[dxn xn]) as torch reductions.
// The TPU kernels' space-to-depth lane packing, block-matrix weights,
// shift tables, owned-row masks and halo'd tile recompute are not carried
// over: the re-run keeps what the reverse reads in device memory.
//
// Three kernels per call, on the caller's stream:
//  1. stage_bwd_kernel<D>, one block per 64 rows of one batch item: the
//     chain dT -> dy -> dG -> da' -> dsrc in shared memory, K8's structure
//     reversed. Each transposed conv is a conv9 of csrc/tade.cuh with the
//     taps reversed and the weights transposed (the wrapper passes
//     Wt[j] = W[8-j]^T), over the rows the next one needs: dT over 80 + 8D
//     rows (the gate's VJP computed while the rows are staged, one warp per
//     row, the softmax sums as shuffles), dy and dG over 80, da' over 72,
//     dsrc over 64; rows outside [0, L) are zeroed, the adjoint of the
//     forward's padding. Its own rows of dT, dG, dxn, da' and dsrc go to
//     device memory.
//  2. wgrad_partial_kernel (csrc/rowprod.cuh, shared with K7): one
//     block per 1,024 rows of one batch item and per job (a tap of Wgc or
//     Wg, 64 x 128; then, in a second launch, a tap of Waux, 64 x 64): the
//     job's product and its right operand's column sums into a slab.
//  3. wgrad_reduce_kernel: the slabs summed in a fixed order, so two runs
//     give the same bits (no atomics; the TPU kernels accumulate into
//     revisited output blocks, race-free only on its sequential grid).
//
// What bounds it on the card. A stage's backward does 9 x 64 x (128 + 128
// + 64) = 184,320 multiply-adds per row for the three transposed convs and
// as many for the weight gradients; with the re-run's as many again, about
// 1.1 MFLOP per row against about 3.5 KB of activations read and written
// per row (the re-run's outputs included): some 300 FLOP per byte, far
// above the float32 balance point (67 TFLOP/s over 3.35 TB/s = 20), so it
// is bound by FMA issue. The products are FFMA:
// one TF32 product per multiply missed the 1e-4 max|plain| agreement with
// the float32 reference in K4 on the card (4.6e-4 to 1.3e-3 of max|plain|
// at v1 shapes; PERF.md), where split TF32 on the tensor cores held
// it within 1e-5; this kernel's products are of the same kind, and split
// TF32 is untried here. The chain kernel
// is K8's design (two blocks per SM at D <= 3); the weight gradients take
// the shared partial kernel as it is. This first design aims at being
// right, and its time stands beside its bound in PERF.md.

#include "rowprod.cuh"
#include "tade.cuh"

namespace {

namespace tk = tadek;

constexpr int kC2 = 2 * tk::kC;                         // the gated convs' width
constexpr int kS2 = kC2 + 4;                            // row stride of 128-wide rows
constexpr int kWFloats = 2 * tk::kCW * tk::kC;          // two 64-column weight chunks

template <int D>
struct GeoB {
  static constexpr int kRowsG = tk::kTile + 4 * tk::kHalf;   // dy, dG
  static constexpr int kRowsA = tk::kTile + 2 * tk::kHalf;   // da'
  static constexpr int kRowsT = kRowsG + 2 * tk::kHalf * D;  // dT
  static constexpr size_t kSmem =
      sizeof(float) * (kWFloats + (size_t)(kRowsT + kRowsG) * kS2);
  static_assert(kRowsA * tk::kS <= kRowsT * kS2, "da' rows reuse the dT buffer");
};

struct StageBwd {
  const float* t;       // (B, L, 128) the gated conv's pre-activations [ta | tb]
  const float* dout;    // (B, L, 64) cotangent of the gate's output
  const float* s;       // (B, L, 64) the modulation's scale
  const float* xr;      // (B, L / sc, 64) the normalised input's source, x or x2
  const float* mean;    // (B, 64) its statistics
  const float* rstd;    // (B, 64)
  const float* dext;    // (B, L, 64) cotangent of a' from outside
  const float* wt_gc;   // (9, 128, 64) Wt[j] = Wgc[8-j]^T
  const float* wt_g;    // (9, 128, 64)
  const float* wt_aux;  // (9, 64, 64)
  float* dT;            // (B, L, 128)
  float* dG;            // (B, L, 128)
  float* dxn;           // (B, L, 64) cotangent of up(xn)
  float* da;            // (B, L, 64) cotangent of a'
  float* dsrc;          // (B, L, 64) cotangent of src
  int L, sc, softmax;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The VJP of one row of gate(t) = softmax(ta) (or sigmoid(ta)) * tanh(tb),
// whose channels (2l, 2l+1) of each half lane l holds (the JAX _gate_vjp,
// tade_train.py:156-170). Every lane of the warp must call it.
__device__ __forceinline__ void gate_vjp(float2 ta, float2 tb, float2 g, int softmax,
                                         float2& dta, float2& dtb) {
  const float th0 = tanhf(tb.x), th1 = tanhf(tb.y);
  float p0, p1;
  if (softmax) {
    const float mx = tk::warp_max(fmaxf(ta.x, ta.y));
    const float e0 = expf(ta.x - mx), e1 = expf(ta.y - mx);
    const float inv = 1.f / tk::warp_sum(e0 + e1);
    p0 = e0 * inv;
    p1 = e1 * inv;
    const float u0 = g.x * th0, u1 = g.y * th1;
    const float su = tk::warp_sum(u0 * p0 + u1 * p1);
    dta = make_float2(p0 * (u0 - su), p1 * (u1 - su));
  } else {
    p0 = 1.f / (1.f + expf(-ta.x));
    p1 = 1.f / (1.f + expf(-ta.y));
    dta = make_float2(g.x * th0 * p0 * (1.f - p0), g.y * th1 * p1 * (1.f - p1));
  }
  dtb = make_float2(g.x * p0 * (1.f - th0 * th0), g.y * p1 * (1.f - th1 * th1));
}

// Local rows: dT at t0 - 8 - 4D + q, dy and dG at t0 - 8 + m, da' at
// t0 - 4 + m, dsrc at t0 + m.
template <int D>
__global__ void __launch_bounds__(tk::kThreads, 2) stage_bwd_kernel(StageBwd p) {
  using G = GeoB<D>;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* bufT = w_s + kWFloats;           // dT rows, later da' rows
  float* bufG = bufT + G::kRowsT * kS2;   // dG rows
  float* bufA = bufT;
  const int b = blockIdx.y, t0 = blockIdx.x * tk::kTile, L = p.L;
  const size_t row0 = (size_t)b * L;      // this batch item's first row

  {  // dT, one warp per row
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int pos0 = t0 - 2 * tk::kHalf - tk::kHalf * D;
    for (int q = warp; q < G::kRowsT; q += tk::kThreads / 32) {
      const int pos = pos0 + q;
      float2 dta = make_float2(0.f, 0.f), dtb = dta;
      if (pos >= 0 && pos < L) {  // the same for the whole warp
        const float* tr = p.t + (row0 + pos) * kC2 + 2 * lane;
        gate_vjp(*reinterpret_cast<const float2*>(tr),
                 *reinterpret_cast<const float2*>(tr + tk::kC),
                 *reinterpret_cast<const float2*>(p.dout + (row0 + pos) * tk::kC + 2 * lane),
                 p.softmax, dta, dtb);
        if (pos >= t0 && pos < t0 + tk::kTile) {
          float* o = p.dT + (row0 + pos) * kC2 + 2 * lane;
          *reinterpret_cast<float2*>(o) = dta;
          *reinterpret_cast<float2*>(o + tk::kC) = dtb;
        }
      }
      *reinterpret_cast<float2*>(bufT + q * kS2 + 2 * lane) = dta;
      *reinterpret_cast<float2*>(bufT + q * kS2 + tk::kC + 2 * lane) = dtb;
    }
  }
  using P = tk::Map<tk::kC>;
  const int g = threadIdx.x % P::G, r = threadIdx.x / P::G;
  {  // dy = gc_D^T(dT); dG = [dy * up(xn) | dy], dxn = dy * s
    constexpr int M = G::kRowsG, KR = tk::ceil_div(M, P::R);
    float acc[KR][4];
    tk::conv9<tk::kC, KR, D, kC2, false>(bufT, M, p.wt_gc, nullptr, w_s, acc);
    const float4 mu = ld4(p.mean + b * tk::kC + 4 * g);
    const float4 rs = ld4(p.rstd + b * tk::kC + 4 * g);
    const float* xr = p.xr + (row0 / p.sc) * tk::kC + 4 * g;
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int m = r + i * P::R;
      const int pos = t0 - 2 * tk::kHalf + m;
      if (m >= M) continue;
      float4 ga = make_float4(0.f, 0.f, 0.f, 0.f), gb = ga;
      if (pos >= 0 && pos < L) {
        const float4 xv = ld4(xr + (size_t)(pos / p.sc) * tk::kC);
        gb = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        ga = make_float4(gb.x * ((xv.x - mu.x) * rs.x), gb.y * ((xv.y - mu.y) * rs.y),
                         gb.z * ((xv.z - mu.z) * rs.z), gb.w * ((xv.w - mu.w) * rs.w));
        if (m >= 2 * tk::kHalf && m < 2 * tk::kHalf + tk::kTile) {
          const size_t o = (row0 + pos) * tk::kC + 4 * g;
          const float4 sv = ld4(p.s + o);
          st4(p.dxn + o, make_float4(gb.x * sv.x, gb.y * sv.y, gb.z * sv.z, gb.w * sv.w));
          st4(p.dG + (row0 + pos) * kC2 + 4 * g, ga);
          st4(p.dG + (row0 + pos) * kC2 + tk::kC + 4 * g, gb);
        }
      }
      st4(bufG + m * kS2 + 4 * g, ga);
      st4(bufG + m * kS2 + tk::kC + 4 * g, gb);
    }
  }
  {  // da' = g^T(dG) + dext, over the dead dT rows
    constexpr int M = G::kRowsA, KR = tk::ceil_div(M, P::R);
    float acc[KR][4];
    tk::conv9<tk::kC, KR, 1, kC2, false>(bufG, M, p.wt_g, nullptr, w_s, acc);
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int m = r + i * P::R;
      const int pos = t0 - tk::kHalf + m;
      if (m >= M) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pos >= 0 && pos < L) {
        const size_t o = (row0 + pos) * tk::kC + 4 * g;
        const float4 e = ld4(p.dext + o);
        v = make_float4(acc[i][0] + e.x, acc[i][1] + e.y, acc[i][2] + e.z,
                        acc[i][3] + e.w);
        if (m >= tk::kHalf && m < tk::kHalf + tk::kTile) st4(p.da + o, v);
      }
      st4(bufA + m * tk::kS + 4 * g, v);
    }
  }
  {  // dsrc = aux^T(da')
    constexpr int M = tk::kTile, KR = tk::ceil_div(M, P::R);
    float acc[KR][4];
    tk::conv9<tk::kC, KR, 1, tk::kC, false>(bufA, M, p.wt_aux, nullptr, w_s, acc);
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int pos = t0 + r + i * P::R;
      if (pos < L)
        st4(p.dsrc + (row0 + pos) * tk::kC + 4 * g,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

template <int D>
cudaError_t launch_chain(const StageBwd& p, int B, cudaStream_t s) {
  cudaError_t e = tk::set_smem(stage_bwd_kernel<D>, GeoB<D>::kSmem);
  if (e != cudaSuccess) return e;
  stage_bwd_kernel<D><<<dim3((p.L + tk::kTile - 1) / tk::kTile, B), tk::kThreads,
                        GeoB<D>::kSmem, s>>>(p);
  return cudaGetLastError();
}

// The 9 jobs of a conv's weight gradient: dw[k] (64 x N) = sum_t a[t + (k-4)
// dil]^T b[t], the first also taking db. Returns the next free job index.
int add_conv_jobs(WArgs& w, int j, const float* a, int dil, const float* b, int N,
                  float* dw, float* db) {
  for (int k = 0; k < tk::kK; ++k)
    w.job[j++] = WJob{a, tk::kC, tk::kC, (k - tk::kHalf) * dil, 0, b, N, 1.f,
                      dw + (size_t)k * tk::kC * N, k == 0 ? db : nullptr};
  return j;
}

}  // namespace

extern "C" {

// Floats of scratch (part) that tade_stage_bwd needs for B x L rows, or -1
// when the count does not fit an int.
int tade_stage_bwd_part_floats(int B, int L) {
  return scratch_floats(B, L, kC2, 2 * tk::kK);
}

// The backward of one stage (see the top of this file). t, s, y and ain
// (a') are the re-run's, src is c (stage 1) or up(a) (stage 2), all at rate
// L; xr is at rate L / scale. Writes dT, dG (B, L, 128), dxn, da, dsrc (B,
// L, 64) and the weight gradients in gather form (9, 64, 128 | 64) with
// their biases; part (part_floats floats, at least
// tade_stage_bwd_part_floats) is scratch. scale 1 or 2 (L a multiple of
// it), dilation 1 .. 4, gate 0 softmax or 1 sigmoid. Returns a cudaError_t
// value: 0 when every launch was accepted.
int tade_stage_bwd(const float* t, const float* dout, const float* s, const float* xr,
                   const float* mean, const float* rstd, const float* dext,
                   const float* wt_gc, const float* wt_g, const float* wt_aux,
                   const float* y, const float* ain, const float* src, float* dT,
                   float* dG, float* dxn, float* da, float* dsrc, float* dw_gc,
                   float* db_gc, float* dw_g, float* db_g, float* dw_aux,
                   float* db_aux, float* part, long long part_floats, int B, int L,
                   int scale, int dilation, int gate, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || B > 65535 || L < 1 || L > (1 << 24) || scale < 1 || scale > 2 ||
      L % scale != 0 || gate < 0 || gate > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StageBwd p{t, dout, s, xr, mean, rstd, dext, wt_gc, wt_g, wt_aux,
                   dT, dG, dxn, da, dsrc, L, scale, gate == 0};
  switch (dilation) {
    case 1:
      e = launch_chain<1>(p, B, st);
      break;
    case 2:
      e = launch_chain<2>(p, B, st);
      break;
    case 3:
      e = launch_chain<3>(p, B, st);
      break;
    case 4:
      e = launch_chain<4>(p, B, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;

  WArgs w{};
  w.T = L;
  w.mode = kZero;
  int j = add_conv_jobs(w, 0, y, dilation, dT, kC2, dw_gc, db_gc);
  j = add_conv_jobs(w, j, ain, 1, dG, kC2, dw_g, db_g);
  e = launch_wgrad<kC2 / 4>(w, j, B, part, part_floats, st);
  if (e != cudaSuccess) return e;
  j = add_conv_jobs(w, 0, src, 1, da, tk::kC, dw_aux, db_aux);
  return launch_wgrad<tk::kC / 4>(w, j, B, part, part_floats, st);
}

}  // extern "C"
