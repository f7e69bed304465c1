// The bf16-resident mode of the fused StyleMelGAN TADEResBlock forward (K8a,
// K8b) for Hopper (sm_90a): every conv product on the warpgroup products
// (wgmma), the weights brought in by the tensor memory accelerator (TMA),
// the staged rows and the convs' operands kept in shared memory as bf16.
//
// Replaces, in the bf16-resident mode (mxu_bf16, turned on by a bf16 input
// in tade_train.py:776 and :680), the two Pallas TPU kernels of
//   parallelwavegan_tpu/ops/pallas_kernels/tade_decode.py
//     K8a :366 _run_tade1 (body _kernel_tade1 :221), at the input rate T
//     K8b :437 _run_tade2 (body _kernel_tade2 :271), at the output rate sT
// The function is csrc/tade.cu's (its note gives the block's algebra: a =
// aux(src), [s | h] = g(a), y = s * norm + h, t = gc_D(y), the gate, K8b's
// stretch and residual), with JAX's bf16 roundings (_apply_conv,
// tade_decode.py:173-190): x, c, x2, a, out and a2 bf16 in memory, the
// statistics float32 (from the bf16 values); each conv's source rows and
// weights rounded to bf16 to nearest even, each tap's product over bf16
// operands summed into float32; the biases, the modulation, the gate and
// the residual in float32, rounded to bf16 only on store. With the Save
// pointers given, a kernel is the backward's re-run (K9a, K9b in
// csrc/tade_bwd_bf16.cu): it writes y and up(a) in bf16, the modulation's
// scale s and the gated conv's pre-activations t in float32, and no gate.
// The plain versions are ops/kernels/tade_decode.py tade1_reference_bf16 and
// tade2_reference_bf16 (and tade_train.py's tade{1,2}_rerun_reference_bf16
// for Save). Built with every source by ops/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a: wgmma needs the "a"); on the CPU the
// wrapper runs the plain version, and
// tests/test_torch_port_tade_fwd_bf16_layout.py emulates this file's layouts
// and arithmetic; on the card chip_smoke.py phases 28-29 and
// tests/test_torch_port_cuda.py -m gpu -k tade_bf16 run it.
//
// What bounds it on the card. Each kernel does ten 9 x 64 x 64 products a
// row (aux 64 columns, g and gc 128 each), 184,320 multiply-adds against
// about 0.5 KB of bf16 rows in and out: bound by the tensor cores (989
// TFLOP/s bf16).
//
// One block of three warpgroups per TO output rows of one batch item; each
// product covers 192 rows, 64 a warpgroup (wgmma's m64), so that the three
// convs of the chain stay on chip: TO = 192 - 8 - 8D rows (176 for K8a, 168
// for K8b at v1's D = 2), the aux conv's 192 rows all needed, g's 184 of
// 192, gc's TO of 192: 960 rows of 64-column products per TO rows, 5.45
// at K8a and D = 1, 5.71 at D = 2, 6.32 at D = 4 (the mma.sync bf16 kernels
// before it: 5.43, 5.85, 6.55; their 16-row tiles past a conv's rows were
// skipped, their 128-row blocks had more halo).
// Local rows: y at t0 - 4D + m, a' at t0 - 4D - 4 + m, the source (c, or
// up(a) at the output rate) at t0 - 4D - 8 + m; K8a is the case D = 1,
// scale 1, without the residual.
//  - The source rows are staged from device memory as bf16 by cp.async, 16
//    bytes a piece, K8b's nearest stretch applied as they are (row p reads
//    p / s), zeros outside [0, L), 144 bytes apart (16 mod 128: ldmatrix
//    reads 8 rows without a bank conflict). The aux conv's output a' and g's
//    modulated rows y, both conv operands that JAX rounds to bf16, are
//    rounded once into shared memory as bf16 (y over the source rows, which
//    are dead by then) and read by the next conv as they are.
//  - Each conv is 9 taps of 4 k16 products a warpgroup, m64n64k16 for aux
//    and m64n128k16 for g and gc (their 128 columns in one product): A from
//    ldmatrix at the tap's row shift j D into wgmma's A registers, B the
//    tap's weights, laid out once per call by the wrapper in the K-major
//    128-byte-swizzle layout (ops/kernels/mma_bf16.py tade_forward_wgmma:
//    one 8 KB or 16 KB tile a tap, 27 taps in the order the kernel uses
//    them) and brought by the bulk copy into a ring of 6 stages with "full"
//    and "empty" mbarriers; thread 0 issues the copies (a producer warp
//    spilled in csrc/tade_bwd_bf16.cu). A tap's products are retired and
//    added into float32 totals before the next tap's are issued, as
//    csrc/tade_bwd_bf16.cu's chain does: the tensor cores truncate each
//    accumulation. g's and gc's columns are paired (tade_forward_wgmma, as
//    tf32x3.forward_fragments pairs them): a thread holds s_j beside h_j
//    (ta_j beside tb_j) and channel j + 1 in the next column tile, so the
//    modulation and the gate run on the totals in registers; a thread holds
//    16 of a row's 64 channels, and the softmax's max and sum are taken over
//    the 4 threads of its quad by shuffles, in float32.
//  - An m64n128 accumulator and its totals take 128 registers a thread, so
//    a block of 384 threads runs one to an SM (170 registers allowed); the
//    ring is 96 KB and the rows 58-61 KB.
// The alternatives, on one H100 (ops/kernels/probe_tade_bf16.py; PERF.md):
// kernel time per StyleMelGAN v1 G-step forward (blocks 4-8, B = 32) 4.9
// ms for this design, 6.6 at two warpgroups, 5.1 with two accumulators in
// flight or totals every three taps (all with the same totals, bit for
// bit, but the last); the nine taps summed by the tensor cores into one
// accumulator, issued back to back at two blocks an SM, 3.5 ms, but that
// sum's truncation moved x2 past the bf16 check's bound (1.055e-3 rms of
// plain) at the card tests' shapes.
// Blocks share nothing, and every sum is taken in a fixed order: two runs
// give the same bits.
//
// The instance norm's statistics of the bf16 input (tade_stats_bf16) are
// computed here too, from the bf16 rows: the wrapper's float32 copy of the
// input and torch's reduction took 4-8 times as long on the card
// (time_tade.py's split by part).

#include "tade.cuh"
#include "wgmma_bf16.cuh"

namespace {

namespace tk = tadek;

constexpr int kC = tk::kC;             // 64: every activation's width
constexpr int kK = tk::kK;             // 9 taps
constexpr int kHalf = tk::kHalf;       // 4
constexpr int kLd = kC + 8;            // bf16 row stride of the staged rows, 144 bytes
constexpr int kThreads = 384;          // three warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kM = 192;                // rows of each product, 64 a warpgroup
constexpr int kStages = 6;             // the weight ring, one tap's tiles a stage
constexpr int kLag = 2;                // a stage is refilled kLag taps after its use
constexpr int kTileB = kC * kC * 2;    // one tap's weights for 64 columns: 64 x 64 bf16, 8 KB
constexpr int kStageB = 2 * kTileB;    // a stage: one tap of g or gc, 128 columns
constexpr int kTaps = 3 * kK;          // 27 taps a launch: aux, g, gc

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

template <int D>
struct Geo {
  static constexpr int kTO = kM - 2 * kHalf - 2 * kHalf * D;  // output rows of a block
  // the source rows (kM + 8), then y (gc reads kM + 8D)
  static constexpr int kXB = (kM + 2 * kHalf * imax(D, 1)) * kLd * 2;
  // a' (kM + 8 rows: g's last rows read 8 past the product)
  static constexpr int kAB = (kM + 2 * kHalf) * kLd * 2;
  static constexpr int kRingB = kStages * kStageB;
  static constexpr size_t kSmem = 1024 + kRingB + kXB + kAB + 2 * kStages * 8;
};

struct Args {
  const uint16_t* src;  // the aux conv's input (B, T, 64): K8a c, K8b a (stretched)
  const uint16_t* xm;   // the modulated input (B, T, 64): K8a x, K8b x2 (stretched)
  const uint16_t* xr;   // K8b's residual x (B, T, 64)
  const float* mean;    // (B, 64) of xm
  const float* rstd;
  uint16_t* out;        // (B, L, 64): K8a x2, K8b out; not written with Save
  uint16_t* a;          // (B, L, 64): a' (K8a a, K8b a2)
  const uint16_t* w;    // tade_forward_wgmma's 45 tiles
  const float* aux_b;   // (64)
  const float* g_b;     // (128)
  const float* gc_b;    // (128)
  uint16_t* y;          // Save: (B, L, 64) the gated conv's input
  float* s;             // Save: (B, L, 64) the modulation's scale
  float* t;             // Save: (B, L, 128) the gated conv's pre-activations [ta | tb]
  uint16_t* ua;         // Save at scale 2: (B, L, 64) up(a), or null
  int T, scale, softmax;
};

// Thread 0 copies tap i's weights (aux's 9 taps one 8 KB tile each, then
// g's and gc's two tiles each) into its stage of the ring.
__device__ __forceinline__ void load_tap(const uint16_t* __restrict__ w, int i, uint8_t* ring,
                                         uint64_t* full) {
  const int st = i % kStages, bytes = i < kK ? kTileB : kStageB;
  const size_t off = i < kK ? (size_t)i * kTileB : (size_t)kK * kTileB + (size_t)(i - kK) * kStageB;
  wgmma::mbar_arrive_expect_tx(full + st, bytes);
  wgmma::bulk_load(ring + st * kStageB, w + off / 2, bytes, full + st);
}

// Each warp hands tap i's stage back once its products have retired; thread
// 0 then refills the stage of the tap kLag back with the tap kStages on from
// it, once every warp has handed that one back.
__device__ __forceinline__ void hand_back(const uint16_t* __restrict__ w, int i, uint8_t* ring,
                                          uint64_t* full, uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) wgmma::mbar_arrive(empty + i % kStages);
  const int r = i - kLag;
  if (threadIdx.x == 0 && r >= 0 && r + kStages < kTaps) {
    wgmma::mbar_wait(empty + r % kStages, (r / kStages) & 1);
    load_tap(w, r + kStages, ring, full);
  }
}

// tot[e] = sum over taps j and input channels ci of in[(m + j DD) kLd + ci]
// W[j][ci][n] at the accumulator's rows m (warp w: 16 w + gid, + 8) and
// columns n (8 i + 2 tig, + 1) of the block's 192 x N tile, each tap's
// weights stage `tap` of the ring (`tap` counting the launch's taps). Each
// tap's four k16 products are one group, retired before the next tap's are
// issued and added into float32 totals: the tensor cores truncate each
// accumulation. Every thread calls it; it ends without a barrier.
template <int N, int DD>
__device__ __forceinline__ void conv9(const uint16_t* in, const uint16_t* __restrict__ w,
                                      uint8_t* ring, uint64_t* full, uint64_t* empty, int& tap,
                                      float (&tot)[N / 2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this lane's ldmatrix row (m) and column (k) within a k16 step
  const uint16_t* a0 = in + (16 * warp + (lane & 15)) * kLd + (lane >> 4) * 8;
  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) tot[e] = acc[e] = 0.f;
#pragma unroll 1
  for (int j = 0; j < kK; ++j, ++tap) {
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma::ldmatrix_x4(a[ks], a0 + j * DD * kLd + ks * 16);
    wgmma::fence();
    const int st = tap % kStages;
    wgmma::mbar_wait(full + st, (tap / kStages) & 1);
    const uint64_t desc = wgmma::desc_k_sw128(ring + st * kStageB);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (N == 128)
        wgmma::m64n128k16<0>(acc, a[ks], desc + 2 * ks, ks > 0);
      else
        wgmma::m64n64k16<0>(acc, a[ks], desc + 2 * ks, ks > 0);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    hand_back(w, tap, ring, full, empty);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) tot[e] += acc[e];
  }
}

// The channel of accumulator column tile i (0-15) of a 128-column conv, for
// this thread's tig: tade_forward_wgmma puts channel 8 (i / 2) + 2 tig + i
// % 2 of the first half in column 8 i + 2 tig and of the second half in 8 i
// + 2 tig + 1.
__device__ __forceinline__ int pair_channel(int i) {
  return 8 * (i >> 1) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Rows lo .. lo + n of rows_s (bf16, kLd apart) to dst rows pos0 .. pos0 +
// n inside [0, L), 16 bytes a piece.
__device__ __forceinline__ void copy_rows(const uint16_t* rows_s, int lo, int n, int pos0,
                                          int L, uint16_t* __restrict__ dst) {
  for (int e = threadIdx.x; e < n * (kC / 8); e += kThreads) {
    const int m = e >> 3, c8 = (e & 7) * 8, pos = pos0 + m;
    if (pos < L)
      *reinterpret_cast<uint4*>(dst + (size_t)pos * kC + c8) =
          *reinterpret_cast<const uint4*>(rows_s + (m + lo) * kLd + c8);
  }
}

__device__ __forceinline__ void st_bf16x2(uint16_t* p, float2 v) {
  *reinterpret_cast<uint32_t*>(p) = bf16mma::pack(v.x, v.y);
}

// Local rows: y at t0 - 4D + m, a' at t0 - 4D - 4 + m, the source at t0 -
// 4D - 8 + m, the output at t0 + m. kSave: the backward's re-run (struct
// Args); kResidual: K8b's up(x) added to the gate.
template <int D, bool kSave, bool kResidual>
__device__ __forceinline__ void tade_fwd(const Args& p) {
  using G = Geo<D>;
  constexpr int TO = G::kTO;
  constexpr int kYRows = TO + 2 * kHalf * D;  // rows of y the gated conv reads
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  uint16_t* xs = reinterpret_cast<uint16_t*>(ring + G::kRingB);  // the source, then y
  uint16_t* as = reinterpret_cast<uint16_t*>(ring + G::kRingB + G::kXB);  // a'
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::kRingB + G::kXB + G::kAB);
  uint64_t* empty = full + kStages;
  const int b = blockIdx.y, t0 = blockIdx.x * TO, sc = p.scale, L = sc * p.T;
  const size_t in0 = (size_t)b * p.T * kC, out0 = (size_t)b * L * kC;
  const int y0 = t0 - kHalf * D, a0 = y0 - kHalf, s0 = a0 - kHalf;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      wgmma::mbar_init(full + st, 1);
      wgmma::mbar_init(empty + st, kWarps);
    }
    wgmma::fence_mbar_init();
    for (int i = 0; i < kStages; ++i) load_tap(p.w, i, ring, full);
  }
  // the source rows: row u reads src row (s0 + u) / sc, zeros outside [0, L)
  for (int e = threadIdx.x; e < (kM + 2 * kHalf) * (kC / 8); e += kThreads) {
    const int u = e >> 3, c8 = (e & 7) * 8, pos = s0 + u;
    const bool ok = pos >= 0 && pos < L;
    tf32x3::cp_async<16>(
        reinterpret_cast<float*>(xs + u * kLd + c8),
        reinterpret_cast<const float*>(ok ? p.src + in0 + (size_t)(pos / sc) * kC + c8 : p.src),
        ok);
  }
  tf32x3::cp_async_commit();
  // a' rows past the aux conv's, read by g's dropped last rows
  for (int e = threadIdx.x; e < 2 * kHalf * (kC / 2); e += kThreads)
    *reinterpret_cast<uint32_t*>(as + (kM + e / (kC / 2)) * kLd + 2 * (e % (kC / 2))) = 0u;
  tf32x3::cp_async_wait<0>();
  __syncthreads();
  if (kSave && p.ua != nullptr)  // up(a) over this block's rows, from the staged rows
    copy_rows(xs, 2 * kHalf + kHalf * D, TO, t0, L, p.ua + out0);

  int tap = 0;
  {  // a' = aux(src) + bias, zero outside [0, L), rounded to bf16 once
    float tot[32];
    conv9<64, 1>(xs, p.w, ring, full, empty, tap, tot);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ch = 8 * i + 2 * tig;
      const float2 bv = tk::ld2(p.aux_b + ch);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * warp + gid + 8 * h, pos = a0 + m;
        float2 v = make_float2(0.f, 0.f);
        if (pos >= 0 && pos < L)
          v = make_float2(tot[4 * i + 2 * h] + bv.x, tot[4 * i + 2 * h + 1] + bv.y);
        st_bf16x2(as + m * kLd + ch, v);
      }
    }
  }
  __syncthreads();  // a' whole; every warp's aux products have read the source rows
  copy_rows(as, kHalf + kHalf * D, TO, t0, L, p.a + out0);
  // y rows past g's, read by the gated conv's dropped last rows
  for (int e = threadIdx.x; e < 2 * kHalf * D * (kC / 2); e += kThreads)
    *reinterpret_cast<uint32_t*>(xs + (kM + e / (kC / 2)) * kLd + 2 * (e % (kC / 2))) = 0u;

  float tot[64];
  {  // y = s * (xm[pos / sc] - mean) * rstd + h, [s | h] = g(a') + bias, zero
     // outside [0, L) and past the rows the gated conv reads, rounded to
     // bf16 once over the source rows
    conv9<128, 1>(as, p.w, ring, full, empty, tap, tot);
    const float* mean = p.mean + b * kC;
    const float* rstd = p.rstd + b * kC;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int ch = pair_channel(2 * q);
      const float2 bs = tk::ld2(p.g_b + ch), bh = tk::ld2(p.g_b + kC + ch);
      const float2 mu = tk::ld2(mean + ch), rs = tk::ld2(rstd + ch);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * warp + gid + 8 * h, pos = y0 + m;
        float2 y = make_float2(0.f, 0.f);
        if (pos >= 0 && pos < L && m < kYRows) {
          const int e0 = 8 * q + 2 * h, e1 = e0 + 4;  // channels ch, ch + 1
          const float2 s = make_float2(tot[e0] + bs.x, tot[e1] + bs.y);
          const float2 xv = tk::ldio2(p.xm + in0 + (size_t)(pos / sc) * kC + ch);
          y.x = fmaf(s.x, (xv.x - mu.x) * rs.x, tot[e0 + 1] + bh.x);
          y.y = fmaf(s.y, (xv.y - mu.y) * rs.y, tot[e1 + 1] + bh.y);
          if (kSave && m >= kHalf * D && m < kHalf * D + TO)
            tk::st2(p.s + out0 + (size_t)pos * kC + ch, s);
        }
        st_bf16x2(xs + m * kLd + ch, y);
      }
    }
  }
  __syncthreads();  // y whole
  if (kSave) copy_rows(xs, kHalf * D, TO, t0, L, p.y + out0);

  // t = gc_D(y) + bias: with kSave to p.t, else the gate (plus up(x)) to out
  conv9<128, D>(xs, p.w, ring, full, empty, tap, tot);
#pragma unroll
  for (int e = 0; e < 64; ++e)  // + bias: column 8 i + 2 tig + (e & 1), i = e / 4
    tot[e] += p.gc_b[(e & 1) * kC + pair_channel(e >> 2)];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // row 16 warp + gid + 8 h: 16 of its channels here
    const int m = 16 * warp + gid + 8 * h, pos = t0 + m;
    if (kSave) {
      if (m >= TO || pos >= L) continue;
      float* row = p.t + 2 * out0 + (size_t)pos * 2 * kC;
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // channels ch, ch + 1
        const int e0 = 8 * q + 2 * h, e1 = e0 + 4, ch = pair_channel(2 * q);
        tk::st2(row + ch, make_float2(tot[e0], tot[e1]));
        tk::st2(row + kC + ch, make_float2(tot[e0 + 1], tot[e1 + 1]));
      }
      continue;
    }
    float g[16];  // [i]: channel pair_channel(i)
    if (p.softmax) {  // over the row's 64 channels: this thread's 16, then its quad's
      float mx = tot[2 * h];
#pragma unroll
      for (int i = 1; i < 16; ++i) mx = fmaxf(mx, tot[4 * i + 2 * h]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        g[i] = expf(tot[4 * i + 2 * h] - mx);
        sum += g[i];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
#pragma unroll
      for (int i = 0; i < 16; ++i) g[i] = g[i] * inv * tanhf(tot[4 * i + 2 * h + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        g[i] = 1.f / (1.f + expf(-tot[4 * i + 2 * h])) * tanhf(tot[4 * i + 2 * h + 1]);
    }
    if (m >= TO || pos >= L) continue;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {  // channels ch, ch + 1
      const int ch = pair_channel(i);
      float2 v = make_float2(g[i], g[i + 1]);
      if (kResidual) {
        const float2 x = tk::ldio2(p.xr + in0 + (size_t)(pos / sc) * kC + ch);
        v = make_float2(x.x + v.x, x.y + v.y);
      }
      st_bf16x2(p.out + out0 + (size_t)pos * kC + ch, v);
    }
  }
}

// K8a: tade_fwd at D = 1 without the residual; K8b at the gated conv's
// dilation D with it.
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1) tade1_bf16_kernel(__grid_constant__ const Args p) {
  tade_fwd<1, kSave, false>(p);
}

template <int D, bool kSave>
__global__ void __launch_bounds__(kThreads, 1) tade2_bf16_kernel(__grid_constant__ const Args p) {
  tade_fwd<D, kSave, true>(p);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int to, const Args& p, int B, cudaStream_t s) {
  cudaError_t e = tk::set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((p.scale * p.T + to - 1) / to, B), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool kSave>
cudaError_t launch_tade1(const Args& p, int B, cudaStream_t s) {
  return launch(tade1_bf16_kernel<kSave>, Geo<1>::kSmem, Geo<1>::kTO, p, B, s);
}

template <int D, bool kSave>
cudaError_t launch_tade2(const Args& p, int B, cudaStream_t s) {
  return launch(tade2_bf16_kernel<D, kSave>, Geo<D>::kSmem, Geo<D>::kTO, p, B, s);
}

template <bool kSave>
cudaError_t launch_tade2_dil(const Args& p, int B, int dilation, cudaStream_t s) {
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

// ---------------------------------------------------------------------------
// the instance norm's statistics
// ---------------------------------------------------------------------------

constexpr int kStatRows = 512;     // rows of a chunk
constexpr int kStatThreads = 512;  // 64 row lanes x 8 column groups of 8 channels
constexpr float kEps = 1e-5f;

// Chunk blockIdx.x of item blockIdx.y: the float32 mean of each channel
// over the chunk's rows and the sum of squared deviations from it (two
// passes over the bf16 rows, the second from cache), to part (B, chunks,
// 2, 64).
__global__ void __launch_bounds__(kStatThreads) stats_chunk_kernel(const uint16_t* __restrict__ x,
                                                                   float* __restrict__ part,
                                                                   int T) {
  __shared__ float red[kStatThreads / 8][kC + 1];
  __shared__ float mean_s[kC];
  const int lane_r = threadIdx.x >> 3, c8 = (threadIdx.x & 7) * 8;
  const int r0 = blockIdx.x * kStatRows, r1 = min(T, r0 + kStatRows);
  const uint16_t* xb = x + (size_t)blockIdx.y * T * kC;
  float* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * kC;
  float acc[8];
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    float mu[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) mu[k] = pass ? mean_s[c8 + k] : 0.f;
    for (int r = r0 + lane_r; r < r1; r += kStatThreads / 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(xb + (size_t)r * kC + c8);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v = bf16mma::widen(k & 1 ? w[k / 2] >> 16 : w[k / 2] & 0xFFFFu);
        acc[k] = pass ? fmaf(v - mu[k], v - mu[k], acc[k]) : acc[k] + v;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) red[lane_r][c8 + k] = acc[k];
    __syncthreads();
    if (threadIdx.x < kC) {  // the row lanes in order
      float v = 0.f;
      for (int l = 0; l < kStatThreads / 8; ++l) v += red[l][threadIdx.x];
      if (pass == 0) mean_s[threadIdx.x] = v / (float)(r1 - r0);
      out[pass * kC + threadIdx.x] = pass ? v : v / (float)(r1 - r0);
    }
    __syncthreads();
  }
}

// Item blockIdx.x: the chunks merged in order (Chan et al.'s pairwise
// update: the mean of the chunks' means by their rows, then each chunk's
// squared deviations plus its rows times its mean's squared distance from
// the whole mean) into mean and 1 / sqrt(var + eps), var the biased
// variance, as torch.var_mean(unbiased=False) gives them.
__global__ void stats_merge_kernel(const float* __restrict__ part, float* __restrict__ mean,
                                   float* __restrict__ rstd, int T, int chunks) {
  const int c = threadIdx.x;
  const float* p = part + (size_t)blockIdx.x * chunks * 2 * kC;
  float m = 0.f;
  for (int k = 0; k < chunks; ++k)
    m += p[k * 2 * kC + c] * (float)(min(T, (k + 1) * kStatRows) - k * kStatRows);
  m /= (float)T;
  float m2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float d = p[k * 2 * kC + c] - m;
    m2 += p[k * 2 * kC + kC + c] + d * d * (float)(min(T, (k + 1) * kStatRows) - k * kStatRows);
  }
  mean[blockIdx.x * kC + c] = m;
  rstd[blockIdx.x * kC + c] = rsqrtf(fmaxf(m2 / (float)T, 0.f) + kEps);
}

}  // namespace

// Each entry point returns a cudaError_t value: 0 when the launch was
// accepted. gate: 0 softmax over channels, 1 sigmoid. The activations are
// (B, T, 64) bf16 at their rate; mean and rstd (B, 64) float32; wf the
// half's three convs (aux, g, gc) as ops/kernels/mma_bf16.py
// tade_forward_wgmma lays them out, (5, 9, 64, 64) bf16; biases float32,
// given (zeros where a conv has none); every pointer 16-byte aligned. y, s
// and t (and ua) are null for a forward; given, they make the launch the
// backward's re-run, which writes them (y, ua bf16; s, t float32) instead
// of x2 or out.
extern "C" {

// Floats of scratch (part) that tade_stats_bf16 needs for B x T rows, or -1
// when the count does not fit an int.
int tade_stats_bf16_part_floats(int B, int T) {
  if (B < 1 || T < 1) return -1;
  const long long n = (long long)B * ((T + kStatRows - 1) / kStatRows) * 2 * kC;
  return n > 2147483647LL ? -1 : (int)n;
}

// The instance norm's statistics of a bf16 activation x (B, T, 64): the
// float32 mean (B, 64) and 1 / sqrt(var + 1e-5) (B, 64) over time, var the
// biased variance, from the bf16 values without a float32 copy; part
// (tade_stats_bf16_part_floats floats) is scratch. Two launches.
int tade_stats_bf16(const uint16_t* x, float* part, float* mean, float* rstd, int B, int T,
                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || B > 65535 || T < 1 || T > (1 << 24)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (T + kStatRows - 1) / kStatRows;
  stats_chunk_kernel<<<dim3(chunks, B), kStatThreads, 0, st>>>(x, part, T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  stats_merge_kernel<<<B, kC, 0, st>>>(part, mean, rstd, T, chunks);
  return cudaGetLastError();
}

// K8a: x2 = gate(gc1(g1(aux1(c)) modulating norm(x))), and a = aux1(c).
int tade1_bf16(const uint16_t* x, const uint16_t* c, const float* mean, const float* rstd,
               uint16_t* x2, uint16_t* a, const uint16_t* wf, const float* aux_b,
               const float* g_b, const float* gc_b, uint16_t* y, float* s, float* t, int B,
               int T, int gate, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const bool save = y != nullptr;
  if (bad_args(B, T, gate) || a == nullptr ||
      (save ? s == nullptr || t == nullptr : x2 == nullptr))
    return cudaErrorInvalidValue;
  const Args p{c, x, nullptr, mean, rstd, x2, a, wf, aux_b, g_b, gc_b, y, s, t, nullptr,
               T, 1, gate == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return save ? launch_tade1<true>(p, B, st) : launch_tade1<false>(p, B, st);
}

// K8b: out = up(x) + gate(gc2_dil(g2(aux2(up(a))) modulating up(norm(x2)))),
// and a2 = aux2(up(a)), at the output rate scale * T. scale 1 or 2,
// dilation 1 .. 4. ua (the re-run's up(a)) may be null.
int tade2_bf16(const uint16_t* x, const uint16_t* x2, const uint16_t* a, const float* mean,
               const float* rstd, uint16_t* out, uint16_t* a2, const uint16_t* wf,
               const float* aux_b, const float* g_b, const float* gc_b, uint16_t* y,
               float* s, float* t, uint16_t* ua, int B, int T, int scale, int dilation,
               int gate, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const bool save = y != nullptr;
  if (bad_args(B, T, gate) || scale < 1 || scale > 2 || a2 == nullptr ||
      (save ? s == nullptr || t == nullptr : out == nullptr))
    return cudaErrorInvalidValue;
  const Args p{a, x2, x, mean, rstd, out, a2, wf, aux_b, g_b, gc_b, y, s, t, ua,
               T, scale, gate == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return save ? launch_tade2_dil<true>(p, B, dilation, st)
              : launch_tade2_dil<false>(p, B, dilation, st);
}

}  // extern "C"
