// Fused StyleMelGAN TADEResBlock forward for Hopper (sm_90a), float32 in and
// out, every conv product on the tensor cores in split TF32. The
// bf16-resident mode of mixed precision is csrc/tade_bf16.cu.
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
// JAX package's channel-last (B, T, 64).
//
// What bounds it on the card. Each kernel does ten 9 x 64 x 64 products
// per row (aux 64 columns, the gate convs 128 each): 184,320
// multiply-adds per row against 4 * 64 * 4 = 1 KB of rows in and out, so
// about 360 FLOP per byte, far above the card's balance point: it is bound
// by arithmetic. Every conv product runs on the tensor cores in split TF32
// (csrc/mma_tf32x3.cuh: v = hi + lo, a.b = a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, three mma.sync.m16n8k8 TF32 products into float32), which
// keeps float32's accuracy where one TF32 product per multiply missed the
// 1e-4 max|plain| agreement in K4 on the card and in K9's emulation
// (PERF.md; tests/test_torch_port_tade_fwd_tf32x3.py holds this
// decomposition to the float32 reference on the CPU). No conv product is
// left on FFMA.
//
// What the design does about it:
//  - The TPU kernels pack two samples into the 128 lanes with block-matrix
//    weights, sum the softmax with a block-diagonal ones matmul and take a
//    per-phase row max. None of that is carried over.
//  - A block of 8 warps owns TO output rows of one batch item, TO = 120 -
//    8D (K8a: D = 1, 112 rows; K8b: 112, 104, 96, 88 at D = 1-4), so that
//    the first conv's rows are 128, and keeps the chain of three convs on
//    chip: the first conv's input rows with their halo (12 per side in
//    K8a; 8 + 4D in K8b, at the output rate, the stretch applied while
//    staging), copied by cp.async, then each conv's output over the rows
//    the next conv needs: 128 of the first (aux), 120 of the second (g),
//    TO of the gated conv.
//  - Each conv is tadek::conv9_tf32x3 (csrc/tade.cuh, the conv of K9's
//    chain): a pass forms a 128-row x 64-column output tile, 32 x 32 a
//    warp, against depth 9 x 64, the weights split once by the wrapper
//    into TF32 hi and lo in the B fragments' own order (ops/kernels/
//    tf32x3.py forward_fragments: one 16-byte shared load per fragment, no
//    split) and streamed 16 KB at a time through a two-stage cp.async
//    ring; rows sit 72 floats apart (8 mod 32: the A pairs' 8-byte loads
//    are free of bank conflicts) and only A is split in the loop; each
//    tap's tile sums go into float32 totals, since the tensor cores round
//    their accumulation toward zero. aux is one pass, g and gc (128
//    columns) two.
//  - forward_fragments permutes the 128-column convs' columns so that a
//    thread's accumulators hold s_j beside h_j (ta_j beside tb_j), and in
//    the next column tile channel j + 1: the modulation is applied in
//    registers and stored as float pairs. The gated conv's two passes are
//    staged to shared memory (32 channel pairs each, over a buffer that is
//    dead by then) and the gate is applied one warp per row, its softmax
//    sums as shuffles.
//  - Two buffers of 136 rows (the input rows, then y; the first conv's
//    output, then the gate's first half) and the ring take 108.5 KB: two
//    blocks per SM, held to 128 registers a thread.
// Blocks share nothing and carry nothing from tile to tile, and every sum
// is taken in a fixed order: two runs give the same bits. With the Save
// pointers given, each kernel is the re-run of the backward (K9a, K9b in
// csrc/tade_bwd.cu): it keeps the gated conv's input, the modulation's
// scale and the gate's pre-activations instead of applying the gate (a
// compile-time variant; decode runs the kernels without it).

#include "tade.cuh"

namespace {

using namespace tadek;

constexpr int kLd = kC + 8;               // row stride of staged rows, 8 mod 32
constexpr int kM1 = 128;                  // rows of the first conv (aux)
constexpr int kM2 = kM1 - 2 * kHalf;      // 120: rows of the second (g)
constexpr int kRows = kM1 + 2 * kHalf;    // 136: rows of each buffer
constexpr int kPassF = kK * kC * kC * 2;  // floats of one 64-column weight pass

// floats of the weight ring (float32 hi/lo chunks), then the bytes of
// shared memory: the ring and two buffers
constexpr int kRingF = kWStages * kChunkF;
constexpr size_t kSmem = sizeof(float) * ((size_t)kRingF + 2 * kRows * kLd);

// output rows of a block whose gated conv has dilation D
template <int D>
constexpr int kTO = kM2 - 2 * kHalf * D;

// Rows p0 .. p0 + kRows of src at rate t_out into dst, kLd floats apart,
// as one cp.async group: row p reads source row p / s, zeros where p is
// outside [0, t_out).
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int p0, int t_out, int s) {
  for (int idx = threadIdx.x; idx < kRows * (kC / 4); idx += kThreads) {
    const int q = idx >> 4, c4 = (idx & 15) * 4, p = p0 + q;
    const bool ok = p >= 0 && p < t_out;
    cp_async<16>(dst + q * kLd + c4, ok ? src + (size_t)(p / s) * kC + c4 : src, ok);
  }
  cp_async_commit();
}

// Pass `pass` of a conv over the rows in in_s (see conv9_tf32x3): weight
// passes 0 (aux), 1-2 (g), 3-4 (gc) of the wrapper's fragments.
template <int D, int M>
__device__ __forceinline__ void conv(const float* in_s, const float* __restrict__ wf,
                                     int pass, float* w_s, float (&tot)[2][4][4]) {
  conv9<kC, D, M>(in_s, kLd, wf + (size_t)pass * kPassF, w_s, tot);
}

// The first conv's tile + bias, zero outside [0, L), into dst (row m at
// position pos0 + m); rows m in [lo, lo + TO) inside [0, L) also to out
// (device).
template <int TO>
__device__ __forceinline__ void store_aux(const float (&tot)[2][4][4],
                                          const float* __restrict__ bias, int pos0, int L,
                                          float* dst, int lo, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int ch = 32 * wn + 8 * ni + 2 * tig;
    const float2 bv = ld2(bias + ch);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 32 * wm + 16 * mi + gid + 8 * h, pos = pos0 + m;
        float2 v = make_float2(0.f, 0.f);
        if (pos >= 0 && pos < L) {
          v = make_float2(tot[mi][ni][2 * h] + bv.x, tot[mi][ni][2 * h + 1] + bv.y);
          if (m >= lo && m < lo + TO) st2(out + (size_t)pos * kC + ch, v);
        }
        st2(dst + m * kLd + ch, v);
      }
  }
}

// The even channel of a thread's column pair q (0, 1) in pass p (0, 1) of
// a 128-column conv: forward_fragments puts, in columns 2 tig and 2 tig +
// 1 of column tile 8p + 4wn + 2q + e, channel 8 (4p + 2wn + q) + 2 tig + e
// of the first half and of the second.
__device__ __forceinline__ int pair_channel(int p, int q) {
  return 8 * (4 * p + 2 * (threadIdx.x >> 7) + q) + 2 * (threadIdx.x & 3);
}

// Pass p of the second conv, [s | h] = g(a') + bias: y = s * (xr[pos / sc]
// - mean) * rstd + h over rows m < kM2 at positions pos0 + m, zero outside
// [0, L), into dst. With kSave, rows m in [lo, lo +
// TO) inside [0, L) also send their s to s_out (device, float32); their y
// goes from dst (save_rows).
template <int TO, bool kSave>
__device__ __forceinline__ void store_modulated(
    const float (&tot)[2][4][4], int p, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ rstd, int pos0, int L,
    int sc, const float* __restrict__ xr, float* dst, int lo, float* __restrict__ s_out) {
  const int wm = (threadIdx.x >> 5) & 3, gid = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int ch = pair_channel(p, q);
    const float2 bs = ld2(bias + ch), bh = ld2(bias + kC + ch);
    const float2 mu = ld2(mean + ch), rs = ld2(rstd + ch);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 32 * wm + 16 * mi + gid + 8 * h, pos = pos0 + m;
        if (m >= kM2) continue;
        float2 y = make_float2(0.f, 0.f);
        if (pos >= 0 && pos < L) {
          const float2 s = make_float2(tot[mi][2 * q][2 * h] + bs.x,
                                       tot[mi][2 * q + 1][2 * h] + bs.y);
          const float2 xv = ld2(xr + (size_t)(pos / sc) * kC + ch);
          y.x = fmaf(s.x, (xv.x - mu.x) * rs.x, tot[mi][2 * q][2 * h + 1] + bh.x);
          y.y = fmaf(s.y, (xv.y - mu.y) * rs.y, tot[mi][2 * q + 1][2 * h + 1] + bh.y);
          if (kSave && m >= lo && m < lo + TO) st2(s_out + (size_t)pos * kC + ch, s);
        }
        st2(dst + m * kLd + ch, y);
      }
  }
}

// The block's own rows of the gated conv's input, local rows lo .. lo + TO
// of y_s at positions t0 .. t0 + TO, inside [0, L), to y_out (device), in
// 16-byte pieces. Copying them here
// rather than from the epilogue's registers kept the Save variant of K8a
// at 128 registers without a spill.
template <int TO>
__device__ __forceinline__ void save_rows(const float* y_s, int lo, int t0, int L,
                                          float* __restrict__ y_out) {
  for (int idx = threadIdx.x; idx < TO * (kC / 4); idx += kThreads) {
    const int m = idx >> 4, c4 = (idx & 15) * 4, t = t0 + m;
    if (t < L)
      *reinterpret_cast<float4*>(y_out + (size_t)t * kC + c4) =
          *reinterpret_cast<const float4*>(y_s + (m + lo) * kLd + c4);
  }
}

// Pass p of the gated conv, [ta | tb] + bias over rows m < TO, into S: row
// m holds channels 32p .. 32p + 31 of ta at S[m kLd + j] and of tb at S[m
// kLd + 32 + j], j = channel - 32p.
template <int TO>
__device__ __forceinline__ void stage_gate_inputs(const float (&tot)[2][4][4], int p,
                                                  const float* __restrict__ bias,
                                                  float* S) {
  const int wm = (threadIdx.x >> 5) & 3, gid = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int ch = pair_channel(p, q), j = ch - 32 * p;
    const float2 ba = ld2(bias + ch), bb = ld2(bias + kC + ch);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 32 * wm + 16 * mi + gid + 8 * h;
        if (m >= TO) continue;
        st2(S + m * kLd + j, make_float2(tot[mi][2 * q][2 * h] + ba.x,
                                         tot[mi][2 * q + 1][2 * h] + ba.y));
        st2(S + m * kLd + 32 + j, make_float2(tot[mi][2 * q][2 * h + 1] + bb.x,
                                              tot[mi][2 * q + 1][2 * h + 1] + bb.y));
      }
  }
}

// The gated conv's row t (of t_out) from lane g's channels (2g, 2g+1) of
// each half in a: with kSave its pre-activations [ta | tb] to tp (rows of
// 128, float32); else gate(a), plus the residual row xr[t / s] with
// kResidual, to out.
// Every lane of the warp must call it. The residual is a compile-time
// choice: a runtime null test of xr costs registers.
template <bool kSave, bool kResidual>
__device__ __forceinline__ void store_gated(const float (&a)[4], int t, int t_out,
                                            int softmax, float* __restrict__ out,
                                            const float* __restrict__ xr, int s,
                                            float* __restrict__ tp) {
  const int g = threadIdx.x % 32;
  if (kSave) {
    if (t < t_out) {
      float* row = tp + (size_t)t * 2 * kC + 2 * g;
      st2(row, make_float2(a[0], a[1]));
      st2(row + kC, make_float2(a[2], a[3]));
    }
    return;
  }
  float2 v = gate2(a, softmax);
  if (t >= t_out) return;
  if (kResidual) {
    const float2 x = ld2(xr + (size_t)(t / s) * kC + 2 * g);
    v = make_float2(x.x + v.x, x.y + v.y);
  }
  st2(out + (size_t)t * kC + 2 * g, v);
}

// Rows t0 + m, m < TO, of the gated conv's output, staged in S0 (channels
// 0-31) and S1 (32-63), through store_gated, one warp per row.
template <int TO, bool kSave, bool kResidual>
__device__ __forceinline__ void gate_rows(const float* S0, const float* S1, int t0,
                                          int t_out, int softmax, float* __restrict__ out,
                                          const float* __restrict__ xr, int s,
                                          float* __restrict__ tp) {
  const int lane = threadIdx.x & 31;
  const float* S = (lane < 16 ? S0 : S1) + 2 * (lane & 15);
  for (int m = threadIdx.x >> 5; m < TO; m += kThreads / 32) {
    const int t = t0 + m;
    if (t >= t_out) break;  // the same for the whole warp
    const float2 ta = ld2(S + m * kLd), tb = ld2(S + m * kLd + 32);
    const float a[4] = {ta.x, ta.y, tb.x, tb.y};
    store_gated<kSave, kResidual>(a, t, t_out, softmax, out, xr, s, tp);
  }
}

// One kernel's three convs: aux, g, gc in fragment order, (5, 72, 8, 32, 4)
// float32 (TF32 hi, lo)
struct Weights {
  const float* wf;
  const float* aux_b;  // (64)
  const float* g_b;    // (128)
  const float* gc_b;   // (128)
};

// What the backward's re-run keeps (K9, csrc/tade_bwd.cu), at the kernel's
// output rate L: the gated conv's input y and the modulation's scale s (B,
// L, 64), the gated conv's pre-activations t = [ta | tb] (B, L, 128), and
// for K8b at scale 2 the stretched conditioning up(a) (B, L, 64).
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

// K8a. Local rows: c at t0 - 12 + q, a at t0 - 8 + m, y at t0 - 4 + m,
// x2 at t0 + m. kSave: the backward's re-run (struct Save).
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 2) tade1_kernel(Tade1 p) {
  constexpr int TO = kTO<1>;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* buf0 = w_s + kRingF;  // c, then y, then the gate's second half
  float* buf1 = buf0 + kRows * kLd;   // a, then the gate's first half
  const int b = blockIdx.y, t0 = blockIdx.x * TO, T = p.T;
  const size_t base = (size_t)b * T * kC;
  float tot[2][4][4];

  stage_rows(buf0, p.c + base, t0 - 3 * kHalf, T, 1);
  conv<1, kM1>(buf0, p.w.wf, 0, w_s, tot);  // a = aux1(c)
  store_aux<TO>(tot, p.w.aux_b, t0 - 2 * kHalf, T, buf1, 2 * kHalf, p.a + base);
  for (int h = 0; h < 2; ++h) {  // y = s * norm(x) + h, [s | h] = g1(a)
    conv<1, kM2>(buf1, p.w.wf, 1 + h, w_s, tot);
    store_modulated<TO, kSave>(tot, h, p.w.g_b, p.mean + b * kC, p.rstd + b * kC,
                               t0 - kHalf, T, 1, p.x + base, buf0, kHalf, p.sv.s + base);
  }
  for (int h = 0; h < 2; ++h) {  // x2 = gate(gc1(y))
    conv<1, TO>(buf0, p.w.wf, 3 + h, w_s, tot);
    stage_gate_inputs<TO>(tot, h, p.w.gc_b, h ? buf0 : buf1);
    // y is whole in buf0 until the second pass's epilogue
    if (kSave && h == 0) save_rows<TO>(buf0, kHalf, t0, T, p.sv.y + base);
  }
  __syncthreads();
  gate_rows<TO, kSave, false>(buf1, buf0, t0, T, p.softmax, p.x2 + base,
                              static_cast<const float*>(nullptr), 1,
                              p.sv.t + 2 * base);
}

// K8b at dilation D. Local rows at the output rate: up(a) at p0 + q with
// p0 = t0 - 4D - 8, a2 at p0 + 4 + m, y2 at t0 - 4D + m, out at t0 + m.
template <int D, bool kSave>
__global__ void __launch_bounds__(kThreads, 2) tade2_kernel(Tade2 p) {
  constexpr int TO = kTO<D>;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* buf0 = w_s + kRingF;  // up(a), then y2, then the gate's second half
  float* buf1 = buf0 + kRows * kLd;   // a2, then the gate's first half
  const int b = blockIdx.y, t0 = blockIdx.x * TO, s = p.scale;
  const int t_out = s * p.T;
  const size_t in_base = (size_t)b * p.T * kC, out_base = (size_t)b * t_out * kC;
  const int p0 = t0 - kHalf * D - 2 * kHalf;
  float tot[2][4][4];

  if (kSave && p.sv.ua != nullptr) {  // up(a) over this block's rows, 4 channels a piece
    for (int idx = threadIdx.x; idx < TO * (kC / 4); idx += kThreads) {
      const int t = t0 + idx / (kC / 4), cc = (idx % (kC / 4)) * 4;
      if (t < t_out)
        *reinterpret_cast<float4*>(p.sv.ua + out_base + (size_t)t * kC + cc) =
            *reinterpret_cast<const float4*>(p.a + in_base + (size_t)(t / s) * kC + cc);
    }
  }
  stage_rows(buf0, p.a + in_base, p0, t_out, s);
  conv<1, kM1>(buf0, p.w.wf, 0, w_s, tot);  // a2 = aux2(up(a))
  store_aux<TO>(tot, p.w.aux_b, p0 + kHalf, t_out, buf1, kHalf * D + kHalf,
                p.a2 + out_base);
  for (int h = 0; h < 2; ++h) {  // y2 = s * up(norm(x2)) + h, [s | h] = g2(a2)
    conv<1, kM2>(buf1, p.w.wf, 1 + h, w_s, tot);
    store_modulated<TO, kSave>(tot, h, p.w.g_b, p.mean + b * kC, p.rstd + b * kC,
                               t0 - kHalf * D, t_out, s, p.x2 + in_base, buf0, kHalf * D,
                               p.sv.s + out_base);
  }
  for (int h = 0; h < 2; ++h) {  // out = up(x) + gate(gc2_D(y2))
    conv<D, TO>(buf0, p.w.wf, 3 + h, w_s, tot);
    stage_gate_inputs<TO>(tot, h, p.w.gc_b, h ? buf0 : buf1);
    if (kSave && h == 0) save_rows<TO>(buf0, kHalf * D, t0, t_out, p.sv.y + out_base);
  }
  __syncthreads();
  gate_rows<TO, kSave, true>(buf1, buf0, t0, t_out, p.softmax, p.out + out_base,
                             p.x + in_base, s, p.sv.t + 2 * out_base);
}

template <bool kSave>
cudaError_t launch_tade1(const Tade1& p, int B, cudaStream_t stream) {
  cudaError_t e = set_smem(tade1_kernel<kSave>, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + kTO<1> - 1) / kTO<1>, B);
  tade1_kernel<kSave><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kSave>
cudaError_t launch_tade2(const Tade2& p, int B, cudaStream_t stream) {
  cudaError_t e = set_smem(tade2_kernel<D, kSave>, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.scale * p.T + kTO<D> - 1) / kTO<D>, B);
  tade2_kernel<D, kSave><<<grid, kThreads, kSmem, stream>>>(p);
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
// (B, T, 64) float32 at its rate. wf is the half's three convs (aux (9, 64,
// 64), then g and gc (9, 64, 128), gather form) split into TF32 hi and lo
// in the mma fragments' order, the 128-column convs' columns paired
// (ops/kernels/tf32x3.py forward_fragments); biases float32, given (zeros
// where a conv has none); every pointer 16-byte aligned. y, s and t (and
// ua) are null for decode; given, they make the launch the backward's
// re-run (struct Save), which writes them instead of x2 or out.
extern "C" {

// K8a: x2 = gate(gc1(g1(aux1(c)) modulating norm(x))), and a = aux1(c).
int tade1(const float* x, const float* c, const float* mean, const float* rstd,
          float* x2, float* a, const float* wf, const float* aux_b, const float* g_b,
          const float* gc_b, float* y, float* s, float* t, int B, int T, int gate,
          int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const bool save = y != nullptr;
  if (bad_args(B, T, gate) || a == nullptr ||
      (save ? s == nullptr || t == nullptr : x2 == nullptr))
    return cudaErrorInvalidValue;
  const Tade1 p{x, c, mean, rstd, x2, a, {wf, aux_b, g_b, gc_b}, {y, s, t, nullptr},
                T, gate == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return save ? launch_tade1<true>(p, B, st) : launch_tade1<false>(p, B, st);
}

// K8b: out = up(x) + gate(gc2_dil(g2(aux2(up(a))) modulating up(norm(x2)))),
// and a2 = aux2(up(a)), at the output rate scale * T. scale 1 or 2,
// dilation 1 .. 4. ua (the re-run's up(a)) may be null.
int tade2(const float* x, const float* x2, const float* a, const float* mean,
          const float* rstd, float* out, float* a2, const float* wf, const float* aux_b,
          const float* g_b, const float* gc_b, float* y, float* s, float* t, float* ua,
          int B, int T, int scale, int dilation, int gate, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const bool save = y != nullptr;
  if (bad_args(B, T, gate) || scale < 1 || scale > 2 || a2 == nullptr ||
      (save ? s == nullptr || t == nullptr : out == nullptr))
    return cudaErrorInvalidValue;
  const Tade2 p{x,  x2, a, mean, rstd, out, a2, {wf, aux_b, g_b, gc_b}, {y, s, t, ua},
                T, scale, gate == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return save ? launch_tade2_dil<true>(p, B, dilation, st)
              : launch_tade2_dil<false>(p, B, dilation, st);
}

}  // extern "C"
