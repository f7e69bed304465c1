// Backward of the fused StyleMelGAN TADEResBlock (K9a, K9b) for Hopper
// (sm_90a), float32 in and out, every product on the tensor cores in split
// TF32.
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
//  1. stage_bwd_kernel<D>, one block of 256 threads per 112 rows of one
//     batch item: the chain dT -> dy -> dG -> da' -> dsrc in shared memory.
//     dT over 128 + 8D rows (the gate's VJP computed while the rows are
//     staged, one warp per row, the softmax sums as shuffles, the next
//     row's loads issued before this row's sums), dy and dG
//     over 128, da' over 128 (120 needed), dsrc over 112; rows outside
//     [0, L) are zeroed, the adjoint of the forward's padding. Each
//     transposed conv is conv9_tf32x3 (csrc/tade.cuh, K8's conv too): a
//     128 x 64 (or 112 x 64) output tile against depth 9 x 128 (dy, da')
//     or 9 x 64 (dsrc). Its own rows of dT, dG, dxn, da' and dsrc go to
//     device memory.
//  2. stage_wgrad_kernel, one block of 512 threads per 1,024 rows of one
//     batch item and per job: a job is one conv's nine taps against 32
//     columns of its cotangent (Wgc: 4 jobs over dT, Wg: 4 over dG, Waux: 2
//     over da'), so every cotangent element is read once for all nine taps.
//     Each step stages 128 rows of the cotangent and the operand's rows t0
//     - 4d .. t0 + 128 + 4d; the nine taps are shifted views of that tile. The
//     job's 576 x 32 products and the cotangent's column sums go to a slab.
//  3. stage_wgrad_reduce_kernel: the slabs summed in a fixed order, so two
//     runs give the same bits (no atomics; the TPU kernels accumulate into
//     revisited output blocks, race-free only on its sequential grid).
//
// What bounds it on the card, and the design. A stage's backward does 9 x
// 64 x (128 + 128 + 64) = 184,320 multiply-adds per row for the three
// transposed convs and as many for the weight gradients against about 2.3
// KB of rows read and written: far above the card's balance point, so it
// is bound by arithmetic. Every product runs on the tensor cores in split
// TF32 (csrc/mma_tf32x3.cuh: v = hi + lo, a.b = a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, three mma.sync.m16n8k8 into float32), which keeps float32's
// accuracy where one TF32 product per multiply missed the 1e-4 max|plain|
// agreement in K4 (PERF.md; tests/test_torch_port_tade_tf32x3.py holds
// this decomposition to float32 autograd on the CPU). No product is left
// on FFMA. mma.sync rather than wgmma: the chain's A operand is rows that
// the kernel writes itself and reads at nine row shifts, and the weight
// gradients read rows as columns; wgmma wants 64-row K-major tiles in its
// own swizzled layout.
// What held K4's product kernels at 20-37 % of mma.sync's rate (PERF.md
// §6; ncu is refused on the card): knocking out its tensor-core
// products, its split, or its cp.async staging each saved 8-24 % of a
// kernel, the products and the split together 32-39 %: no one unit binds;
// the warps issue too many instructions per product (scalar fragment
// loads, a split of every value each time it is loaded, per-piece staging
// arithmetic). So here:
//  - The weights are split once, by the wrapper (ops/kernels/tf32x3.py),
//    into TF32 hi and lo and stored in the mma B fragments' own order: one
//    16-byte shared load gives a thread its (hi, lo) of both B registers,
//    with no split and no bank conflict. A chunk of 32 input channels of
//    one tap (4 k-steps x 8 column tiles, 16 KB) is one contiguous copy,
//    double-buffered by cp.async.
//  - In the chain each k-step's logical depth k = tig reads channel 2 tig
//    and k = tig + 4 channel 2 tig + 1 (the weights are arranged to
//    match), so an A fragment is two 8-byte loads from rows kept at a
//    stride of 8 mod 32 (free of bank conflicts); only A is split in the
//    loop. A warp owns 32 rows x 32 columns (2 x 4 tiles); 8 warps cover
//    128 x 64. dT, dG and da' take turns in one buffer (each is dead when
//    the next is written), so a block needs 111-116 KB at D <= 3 and two
//    blocks share an SM, held to 128 registers a thread.
//  - The tensor cores round each accumulation toward zero (K4 drifted to
//    1.1e-3 over 1,024 rows), so each conv adds a tap's tile sums (16
//    k-steps, 48 products; 8 at 64 channels) into float32 totals once per
//    tap.
//  - The weight gradients split each cotangent element once, when it is
//    staged, into hi and lo planes, transposed, 136 floats apart (8-byte
//    fragment loads free of bank conflicts); the operand's rows are read as
//    they landed from cp.async, 68 floats apart (4 mod 16: free of bank
//    conflicts), and split as loaded, since each is read by one warp per
//    tap (logical k = tig is row 2 tig of a k-step, tig + 4 row 2 tig + 1).
//    The job is formed transposed, cot^T A (32 x 576): 16 warps each own
//    both 16-row tiles and 4 or 5 of the 72 8-column tiles (tap, 8
//    channels). The tile sums go into float32 totals every 32 rows.
//    Same-call variants on the card (PERF.md §6): splitting the
//    operand once into staged (hi, lo) pairs was 10 % slower than this,
//    64-row steps 7 % slower; in the chain, 240-row tiles of 16 warps (one
//    block per SM, 6.7 % halo), a split of two instructions (truncated hi,
//    lo left to the tensor cores) and copying the next conv's first weight
//    chunk during the epilogue gained nothing.
// Every element of the stage's outputs is a sum in a fixed order: two runs
// give the same bits.
//
// The bf16-resident mode (tade_stage_bwd_bf16) is csrc/tade_bwd_bf16.cu:
// the same function with JAX's bf16 roundings, on Hopper's warpgroup
// products; its note says how it is built, tested on the CPU and run on
// the card.

#include "mma_tf32x3.cuh"
#include "tade.cuh"

namespace {

namespace tk = tadek;
using namespace tf32x3;

constexpr int kC = tk::kC;         // 64: every activation's width
constexpr int kC2 = 2 * kC;        // the gated convs' width
constexpr int kK = tk::kK;         // 9 taps
constexpr int kHalf = tk::kHalf;   // 4

// the chain kernel
constexpr int kCThreads = 256;
constexpr int kTO = 112;           // output rows (dsrc) of a block
constexpr int kMG = 128;           // rows of the dy and da' products
constexpr int kLd2 = kC2 + 8;      // row stride of 128-wide rows, 8 mod 32
constexpr int kLd1 = kC + 8;       // row stride of 64-wide rows, 8 mod 32
constexpr int kChunkF = tk::kChunkF;   // floats of one weight chunk
constexpr int kWStages = tk::kWStages;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

template <int D>
struct GeoB {
  static constexpr int kRowsT = kMG + 2 * kHalf * D;  // dT
  static constexpr int kRowsG = kMG + 2 * kHalf;      // dG (the last 8 read by padding)
  static constexpr int kActF = imax(imax(kRowsT, kRowsG) * kLd2, kMG * kLd1);
  static constexpr int kRingF = kWStages * kChunkF;  // the weight ring: (hi, lo) chunks
  static constexpr size_t kSmem = sizeof(float) * ((size_t)kActF + kRingF);
};

struct StageBwd {
  const float* t;       // (B, L, 128) the gated conv's pre-activations [ta | tb]
  const float* dout;    // (B, L, 64) cotangent of the gate's output
  const float* s;       // (B, L, 64) the modulation's scale
  const float* xr;      // (B, L / sc, 64) the normalised input's source, x or x2
  const float* mean;    // (B, 64) its statistics
  const float* rstd;    // (B, 64)
  const float* dext;    // (B, L, 64) cotangent of a' from outside
  const float* wf_gc;   // gc's transposed conv in fragment order (ops/kernels/tf32x3.py)
  const float* wf_g;
  const float* wf_aux;
  float* dT;            // (B, L, 128)
  float* dG;            // (B, L, 128)
  float* dxn;           // (B, L, 64) cotangent of up(xn)
  float* da;            // (B, L, 64) cotangent of a'
  float* dsrc;          // (B, L, 64) cotangent of src
  int L, sc, softmax;
};

using tk::conv9;
using tk::ld2;
using tk::st2;

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
__global__ void __launch_bounds__(kCThreads, 2) stage_bwd_kernel(StageBwd p) {
  using G = GeoB<D>;
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // dT, then dG, then da'
  float* w_s = act + G::kActF;
  const int b = blockIdx.y, t0 = blockIdx.x * kTO, L = p.L;
  const size_t row0 = (size_t)b * L;  // this batch item's first row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2, gid = lane >> 2, tig = lane & 3;

  {  // dT, one warp per row
    const int pos0 = t0 - 2 * kHalf - kHalf * D;
    constexpr int kStep = kCThreads / 32;
    // row q's [ta | tb] and dout, loaded a row ahead of its VJP
    float2 ta = make_float2(0.f, 0.f), tb = ta, g = ta;
    auto load = [&](int q) {
      const int pos = pos0 + q;
      if (q < G::kRowsT && pos >= 0 && pos < L) {  // the same for the whole warp
        const float* tr = p.t + (row0 + pos) * kC2 + 2 * lane;
        ta = ld2(tr);
        tb = ld2(tr + kC);
        g = ld2(p.dout + (row0 + pos) * kC + 2 * lane);
      }
    };
    load(warp);
    for (int q = warp; q < G::kRowsT; q += kStep) {
      const int pos = pos0 + q;
      float2 dta = make_float2(0.f, 0.f), dtb = dta;
      const float2 cta = ta, ctb = tb, cg = g;
      load(q + kStep);
      if (pos >= 0 && pos < L) {
        gate_vjp(cta, ctb, cg, p.softmax, dta, dtb);
        if (pos >= t0 && pos < t0 + kTO) {
          float* o = p.dT + (row0 + pos) * kC2 + 2 * lane;
          st2(o, dta);
          st2(o + kC, dtb);
        }
      }
      st2(act + q * kLd2 + 2 * lane, dta);
      st2(act + q * kLd2 + kC + 2 * lane, dtb);
    }
  }
  float tot[2][4][4];
  // dy = gc_D^T(dT); dG = [dy * up(xn) | dy], dxn = dy * s, over dT's rows
  conv9<kC2, D, kMG>(act, kLd2, p.wf_gc, w_s, tot);
  {
    const auto* xr = p.xr + (row0 / p.sc) * kC;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int ch = 32 * wn + 8 * ni + 2 * tig;
        const float2 mu = ld2(p.mean + b * kC + ch), rs = ld2(p.rstd + b * kC + ch);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 32 * wm + 16 * mi + gid + 8 * h;
          const int pos = t0 - 2 * kHalf + m;
          float2 ga = make_float2(0.f, 0.f), gb = ga;
          if (pos >= 0 && pos < L) {
            gb = make_float2(tot[mi][ni][2 * h], tot[mi][ni][2 * h + 1]);
            const float2 xv = ld2(xr + (size_t)(pos / p.sc) * kC + ch);
            ga = make_float2(gb.x * ((xv.x - mu.x) * rs.x), gb.y * ((xv.y - mu.y) * rs.y));
            if (m >= 2 * kHalf && m < 2 * kHalf + kTO) {
              const size_t o = (row0 + pos) * kC + ch;
              const float2 sv = ld2(p.s + o);
              st2(p.dxn + o, make_float2(gb.x * sv.x, gb.y * sv.y));
              st2(p.dG + (row0 + pos) * kC2 + ch, ga);
              st2(p.dG + (row0 + pos) * kC2 + kC + ch, gb);
            }
          }
          st2(act + m * kLd2 + ch, ga);
          st2(act + m * kLd2 + kC + ch, gb);
        }
      }
  }
  // da' = g^T(dG) + dext, over the dead dG rows
  conv9<kC2, 1, kMG>(act, kLd2, p.wf_g, w_s, tot);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 32 * wm + 16 * mi + gid + 8 * h, ch = 32 * wn + 8 * ni + 2 * tig;
        const int pos = t0 - kHalf + m;
        float2 v = make_float2(0.f, 0.f);
        if (pos >= 0 && pos < L) {
          const size_t o = (row0 + pos) * kC + ch;
          const float2 e = ld2(p.dext + o);
          v = make_float2(tot[mi][ni][2 * h] + e.x, tot[mi][ni][2 * h + 1] + e.y);
          if (m >= kHalf && m < kHalf + kTO) st2(p.da + o, v);
        }
        st2(act + m * kLd1 + ch, v);
      }
  // dsrc = aux^T(da')
  conv9<kC, 1, kTO>(act, kLd1, p.wf_aux, w_s, tot);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (32 * wm + 16 * mi >= kTO) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 32 * wm + 16 * mi + gid + 8 * h, ch = 32 * wn + 8 * ni + 2 * tig;
        const int pos = t0 + m;
        if (pos < L)
          st2(p.dsrc + (row0 + pos) * kC + ch,
                make_float2(tot[mi][ni][2 * h], tot[mi][ni][2 * h + 1]));
      }
  }
}

template <int D>
cudaError_t launch_chain(const StageBwd& p, int B, cudaStream_t s) {
  using G = GeoB<D>;
  cudaError_t e = tk::set_smem(stage_bwd_kernel<D>, G::kSmem);
  if (e != cudaSuccess) return e;
  stage_bwd_kernel<D><<<dim3((p.L + kTO - 1) / kTO, B), kCThreads, G::kSmem, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight gradients
// ---------------------------------------------------------------------------

constexpr int kGThreads = 512;
constexpr int kGRows = 1024;                   // rows of one slab
constexpr int kGS = 128;                       // rows of one staged step
constexpr int kGN = 32;                        // cotangent columns of one job
constexpr int kGMaxD = 4;
constexpr int kGMaxA = kGS + 2 * kHalf * kGMaxD;  // operand rows of a step
constexpr int kGRawLd = kGN + 4;               // staged cotangent rows, 16-byte aligned
constexpr int kGRawLdA = kC + 4;  // 4 mod 16: B fragments read straight from the ring
constexpr int kGRawA = kGMaxA * kGRawLdA;
constexpr int kGRaw = kGRawA + kGS * kGRawLd;  // floats of one raw stage
constexpr int kGStages = 3;
constexpr int kGLdT = kGS + 8;                 // transposed cotangent rows, 8 mod 32
constexpr int kGTiles = kK * kC / 8;           // 72 8-column tiles (tap, channels)
constexpr int kGWarps = kGThreads / 32;
constexpr int kGNT = (kGTiles + kGWarps - 1) / kGWarps;  // 5: tiles of a warp
constexpr int kGSlab = (kK * kC + 1) * kGN;    // 576 x 32 products, then the sums
constexpr int kGJobs = 10;
constexpr size_t kGSmem =
    sizeof(float) * ((size_t)kGStages * kGRaw + 2 * kGN * kGLdT + 2 * kGN);

// dW[k][ci][c0 + n] = sum_t a[t + (k-4) dil][ci] b[t][c0 + n] (n < 32),
// db[c0 + n] = sum_t b[t][c0 + n]; b's rows nb floats apart.
struct GJob {
  const float* a;
  const float* b;
  float* dw;
  float* db;
  int dil, nb, c0;
};

struct GArgs {
  GJob job[kGJobs];
  float* part;  // (jobs, ctas, kGSlab)
  int L, ctas_per_item, ctas;
};

// One block: kGRows rows of batch item blockIdx.y for job blockIdx.z, the
// slab cot^T A: its row m (cotangent column c0 + m) and column n = 64 k +
// ci (tap k, channel ci) at slab[n * 32 + m], the column sums after them.
// Warp w owns m-tiles 0, 1 and the 8-column tiles w + 16 jj (jj < 5).
__global__ void __launch_bounds__(kGThreads, 1) stage_wgrad_kernel(GArgs w) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // the cp.async ring
  float* th = raw + kGStages * kGRaw;            // cotangent hi, transposed
  float* tl = th + kGN * kGLdT;                  // and lo
  float* csum = tl + kGN * kGLdT;                // column sums of two row groups
  const GJob& jb = w.job[blockIdx.z];
  const int L = w.L, item = blockIdx.y, tb = blockIdx.x * kGRows;
  const int te = min(L, tb + kGRows), d = jb.dil, arows = kGS + 2 * kHalf * d;
  const size_t bo = (size_t)item * L;
  const float* a = jb.a + bo * kC;
  const float* bsrc = jb.b + bo * jb.nb + jb.c0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // the cotangent element (crow + 16 u, ccol) that this thread splits
  const int ccol = 4 * (warp & 7) + (lane & 3), crow = (lane >> 2) + 8 * (warp >> 3);
  float colsum = 0.f;
  float acc[2][kGNT][4], tot[2][kGNT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jj = 0; jj < kGNT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mi][jj][e] = 0.f;

  auto stage = [&](int i, int buf) {
    float* ra = raw + buf * kGRaw;
    float* rb = ra + kGRawA;
    const int r0 = tb + i * kGS;
    for (int e = threadIdx.x; e < arows * (kC / 4); e += kGThreads) {
      const int q = e >> 4, c4 = (e & 15) * 4, t = r0 - kHalf * d + q;
      const bool ok = t >= 0 && t < L;
      cp_async<16>(ra + q * kGRawLdA + c4, ok ? a + (size_t)t * kC + c4 : a, ok);
    }
    for (int e = threadIdx.x; e < kGS * (kGN / 4); e += kGThreads) {
      const int r = e >> 3, c4 = (e & 7) * 4, t = r0 + r;
      const bool ok = t < te;  // rows past the slab's read as zero
      cp_async<16>(rb + r * kGRawLd + c4, ok ? bsrc + (size_t)t * jb.nb + c4 : bsrc, ok);
    }
  };

  auto compute = [&](int, int buf) {
    const float* ra = raw + buf * kGRaw;
    const float* rb = ra + kGRawA;
#pragma unroll
    for (int u = 0; u < kGS / 16; ++u) {
      const int r = crow + 16 * u;
      const float v = rb[r * kGRawLd + ccol];
      colsum += v;
      uint32_t h, l;
      split(v, h, l);
      th[ccol * kGLdT + r] = __uint_as_float(h);
      tl[ccol * kGLdT + r] = __uint_as_float(l);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kGS / 8; ++ks) {
      if (ks % 4 == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int jj = 0; jj < kGNT; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][jj][e] = 0.f;
      }
      // cot^T's 16-row tiles: A[m][k] = cot[row 8 ks + 2 tig (+1)][col m]
      FragA fa[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int o = (mi * 16 + gid) * kGLdT + ks * 8 + 2 * tig;
        const float2 h0 = ld2(th + o), h1 = ld2(th + o + 8 * kGLdT);
        const float2 l0 = ld2(tl + o), l1 = ld2(tl + o + 8 * kGLdT);
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
      for (int jj = 0; jj < kGNT; ++jj) {
        const int nt = warp + kGWarps * jj;
        if (nt >= kGTiles) break;
        // B[k][n] = a[row 8 ks + 2 tig (+1) + tap d][channel 8 g + gid]
        const float* pb = ra + (ks * 8 + 2 * tig + (nt >> 3) * d) * kGRawLdA + (nt & 7) * 8 + gid;
        FragB fb;
        split(pb[0], fb.hi[0], fb.lo[0]);
        split(pb[kGRawLdA], fb.hi[1], fb.lo[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][jj], fa[mi], fb);
      }
      if (ks % 4 == 3) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int jj = 0; jj < kGNT; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) tot[mi][jj][e] += acc[mi][jj][e];
      }
    }
  };

  pipeline<kGStages>((te - tb + kGS - 1) / kGS, stage, compute);

  const int cta = item * w.ctas_per_item + blockIdx.x;
  float* slab = w.part + ((size_t)blockIdx.z * w.ctas + cta) * kGSlab;
#pragma unroll
  for (int jj = 0; jj < kGNT; ++jj) {
    const int nt = warp + kGWarps * jj;
    if (nt >= kGTiles) break;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      for_each_acc([&](int r, int c, int e) {
        slab[(nt * 8 + c) * kGN + mi * 16 + r] = tot[mi][jj][e];
      });
  }
  // the sums of one column: 8 lanes of a warp, then warps w and w + 8
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) colsum += __shfl_xor_sync(0xffffffffu, colsum, o);
  if (lane < 4) csum[(warp >> 3) * kGN + ccol] = colsum;
  __syncthreads();
  if (threadIdx.x < kGN)
    slab[kK * kC * kGN + threadIdx.x] = csum[threadIdx.x] + csum[kGN + threadIdx.x];
}

// Element e of job blockIdx.y's slab: the sum of its slabs, cta 0 first,
// into its gradient (float32 in both modes).
__global__ void __launch_bounds__(256) stage_wgrad_reduce_kernel(GArgs w) {
  const GJob& jb = w.job[blockIdx.y];
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= kGSlab) return;
  const float* src = w.part + (size_t)blockIdx.y * w.ctas * kGSlab + e;
  float s = 0.f;
  for (int cta = 0; cta < w.ctas; ++cta) s += src[(size_t)cta * kGSlab];
  const int row = e / kGN, m = e % kGN;
  if (row < kK * kC)
    jb.dw[(size_t)row * jb.nb + jb.c0 + m] = s;
  else
    jb.db[jb.c0 + m] = s;
}

long long part_floats_of(int B, int L) {
  return (long long)kGJobs * B * ((L + kGRows - 1) / kGRows) * kGSlab;
}

}  // namespace

extern "C" {

// Floats of scratch (part) that tade_stage_bwd needs for B x L rows, or -1
// when the count does not fit an int.
int tade_stage_bwd_part_floats(int B, int L) {
  const long long n = part_floats_of(B, L);
  return n > 2147483647LL ? -1 : (int)n;
}

// The backward of one stage (see the top of this file). t, s, y and ain
// (a') are the re-run's, src is c (stage 1) or up(a) (stage 2), all at rate
// L; xr is at rate L / scale. wf_gc, wf_g and wf_aux are the transposed
// convs' weights split into TF32 hi and lo in the mma fragments' order
// (ops/kernels/tf32x3.py conv_fragments). Writes dT, dG (B, L, 128), dxn,
// da, dsrc (B, L, 64) and the weight gradients in gather form (9, 64, 128
// | 64) with their biases; part (part_floats floats, at least
// tade_stage_bwd_part_floats) is scratch. scale 1 or 2 (L a multiple of
// it), dilation 1 .. 4, gate 0 softmax or 1 sigmoid; every pointer 16-byte
// aligned. Returns a cudaError_t value: 0 when every launch was accepted.
int tade_stage_bwd(const float* t, const float* dout, const float* s, const float* xr,
                   const float* mean, const float* rstd, const float* dext,
                   const float* wf_gc, const float* wf_g, const float* wf_aux,
                   const float* y, const float* ain, const float* src, float* dT,
                   float* dG, float* dxn, float* da, float* dsrc, float* dw_gc,
                   float* db_gc, float* dw_g, float* db_g, float* dw_aux,
                   float* db_aux, float* part, long long part_floats, int B, int L,
                   int scale, int dilation, int gate, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || B > 65535 || L < 1 || L > (1 << 24) || scale < 1 || scale > 2 ||
      L % scale != 0 || gate < 0 || gate > 1 || dilation < 1 || dilation > kGMaxD ||
      part_floats < part_floats_of(B, L))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StageBwd p{t,  dout, s,  xr,  mean, rstd, dext, wf_gc, wf_g, wf_aux,
                   dT, dG,   dxn, da, dsrc, L,    scale, gate == 0};
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
    default:
      e = launch_chain<4>(p, B, st);
      break;
  }
  if (e != cudaSuccess) return e;

  GArgs w{};
  w.part = part;
  w.L = L;
  w.ctas_per_item = (L + kGRows - 1) / kGRows;
  w.ctas = B * w.ctas_per_item;
  int j = 0;
  for (int c0 = 0; c0 < kC2; c0 += kGN) w.job[j++] = GJob{y, dT, dw_gc, db_gc, dilation, kC2, c0};
  for (int c0 = 0; c0 < kC2; c0 += kGN) w.job[j++] = GJob{ain, dG, dw_g, db_g, 1, kC2, c0};
  for (int c0 = 0; c0 < kC; c0 += kGN) w.job[j++] = GJob{src, da, dw_aux, db_aux, 1, kC, c0};
  e = tk::set_smem(stage_wgrad_kernel, kGSmem);
  if (e != cudaSuccess) return e;
  stage_wgrad_kernel<<<dim3(w.ctas_per_item, B, kGJobs), kGThreads, kGSmem, st>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  stage_wgrad_reduce_kernel<<<dim3((kGSlab + 255) / 256, kGJobs), 256, 0, st>>>(w);
  return cudaGetLastError();
}

}  // extern "C"
