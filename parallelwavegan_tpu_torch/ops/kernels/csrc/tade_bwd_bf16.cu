// The bf16-resident mode of the StyleMelGAN TADEResBlock stage backward
// (K9a, K9b) for Hopper (sm_90a): the transposed convs and the weight
// gradients on the warpgroup products (wgmma), the weights brought in by
// the tensor memory accelerator (TMA), the cotangent rows kept in shared
// memory as bf16.
//
// Replaces, in the bf16-resident mode (mxu_bf16), the two Pallas TPU
// kernels of the JAX package
//   parallelwavegan_tpu/ops/pallas_kernels/tade_train.py
//     K9a :438 _run_tade1_bwd (body _kernel_tade1_bwd :226), stage 1
//     K9b :523 _run_tade2_bwd (body _kernel_tade2_bwd :312), stage 2
// The function is csrc/tade_bwd.cu's (its note gives the stage's algebra:
// dT = gate'(t) dout, dy = gc_D^T(dT), dG = [dy up(xn) | dy], dxn = dy s,
// da' = g^T(dG) + dext, dsrc = aux^T(da'), the three weight gradients and
// the biases' column sums), with JAX's bf16 roundings (_apply_conv_t and
// _conv_wgrads, tade_train.py:173-208): dout, dext, xr, y, a', src, dxn
// and dsrc bf16 in memory, t and s float32; each cotangent (dT, dG, da')
// rounded to bf16 once, as the operand of its transposed conv and of its
// weight gradient; every product of bf16 operands summed in float32; each
// bias the float32 column sum of its unrounded cotangent. The plain
// version is ops/kernels/tade_train.py stage_backward_reference_bf16.
// Built with every source by ops/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a: wgmma needs the "a"); on the
// CPU the wrapper runs the plain version, and
// tests/test_torch_port_tade_bwd_bf16_layout.py emulates this file's
// layouts and arithmetic; on the card chip_smoke.py phases 28-29 and
// tests/test_torch_port_cuda.py -m gpu -k tade_bf16 run it.
//
// Three kernels per call, on the caller's stream:
//  1. chain_bf16_kernel<D>: one block of two warpgroups per 112 rows of one
//     batch item; each product covers 128 rows, 64 a warpgroup. dT over 128
//     + 8D rows (the gate's VJP, one warp per row, each warp's rows loaded
//     4 ahead and their VJPs formed two at a time, the rows' warp
//     reductions interleaved), dy and dG over 128, da' over 128 (120
//     needed), dsrc over 128 (112 kept). Each cotangent is rounded to bf16 into one shared
//     buffer of bf16 rows (272 or 144 bytes apart: 16 mod 128, so ldmatrix
//     reads 8 rows without a bank conflict) and read by the next transposed
//     conv at the tap's row shift (k - 4) D through ldmatrix as wgmma's A
//     registers. Each tap's 64 input channels of weights (8 KB) are one
//     wgmma B tile, laid out once per call by the wrapper in the K-major
//     128-byte-swizzle layout (ops/kernels/mma_bf16.py tade_conv_wgmma);
//     the tensor memory accelerator's bulk copy brings them, 45 tiles a
//     call, into a ring of 6 stages, each with a "full" mbarrier (the
//     copy's bytes) and an "empty" one (the 8 warps' arrivals once their
//     products have retired). A tap's products (one or two tiles, 4 or 8
//     m64n64k16) are one group, retired together and added into a float32
//     total per tap (the tensor cores truncate each accumulation, as
//     csrc/tade_bwd.cu's note measured). The epilogues put a product's float32
//     rows in shared memory and take them one warp per row, so every
//     device-memory access is a whole row: its own rows of dT, dG and da'
//     to device memory as bf16 (the weight gradients' operands), dxn and
//     dsrc as bf16, and the float32 column sums of its own rows of dT, dG
//     and da' (320 values, warp by warp in a fixed order) to tsum.
//     Thread 0 issues the copies: the first 6 while dT is formed, then,
//     after each tile, the tile 6 on from the one 2 back, once every warp
//     has handed that one back. A ninth, producer warp (measured first)
//     put 18 warps on an SM's four register files and held every thread to
//     96 registers, where the chain spilled; with 8 warps a block has 128,
//     two blocks an SM. A bulk copy, not a tensor-map copy: each tile is
//     laid out already swizzled, one contiguous 8 KB run.
//  2. wgrad_bf16_kernel: one block of three warpgroups per job and chunk of
//     rows (a multiple of 448 rows: whole chain tiles and 64-row steps) of
//     one batch item, the jobs of a chunk neighbouring blocks (their reads
//     of its rows close together in time); a job is one conv
//     and a group of its taps over the conv's whole cotangent width: Wgc
//     taps 0-2, 3-5, 6-8 over dT (128 columns), the same over dG for Wg,
//     Waux taps 0-5 and 6-8 over da' (64), 8 jobs. Each 64-row step stages
//     the operand's rows t0 - 4d .. t0 + 64 + 4d (144 bytes apart) and the
//     cotangent's 64 rows (MN-major 128-byte-swizzle atoms of 8 rows of 64
//     columns) through a cp.async ring of 5 stages, 3 steps ahead.
//     Warpgroup w forms dW[k] = X_k^T . cot for its tap k: A = X_k^T from
//     ldmatrix.trans at the tap's row shift, B = the cotangent through an
//     MN-major descriptor; at 128 columns four m64n128k16 a step, retired
//     while the next step is staged, at 64 two taps of four m64n64k16; the
//     products added into float32 totals every step. The job's first tap
//     group also sums the chain's tile sums of its chunk in order (the
//     bias). Totals go to a slab.
//  3. wgrad_bf16_reduce_kernel: the slabs summed in a fixed order into the
//     float32 gradients (no atomics: two runs give the same bits).
//
// What bounds it on the card. A stage's backward does 9 x 64 x (128 + 128
// + 64) = 184,320 multiply-adds a row for the transposed convs and as many
// for the weight gradients against about 1.2 KB of bf16 rows read and
// written: bound by the tensor cores (989 TFLOP/s bf16). The design keeps
// each cotangent in bf16 once (the parent converted each float32 row to
// bf16 nine times, once a tap, and wrote 320 floats a row to device
// memory for the weight-gradient kernel to round), feeds every product's
// weights from shared memory to wgmma with no per-thread loads, and stages
// each operand row once per three taps (the parent once per 32 columns).
// Where the time goes (PERF.md §6, clock64 per phase on the card): the
// chain's gate VJP and epilogues, and each tap's products retiring before
// the next are issued (a second accumulator set does not fit in 128
// registers); the weight gradients' step barrier.
//
// Resources (ptxas -v on the card, PERF.md §6): chain_bf16_kernel<D> 256
// threads at 124-125 registers (128 allowed), no spill, two blocks an SM,
// 90-96 KB of shared memory; wgrad_bf16_kernel 384 threads at 166
// registers, no spill, one block an SM, 151 KB. Every element of the outputs is a sum in a fixed
// order: two runs give the same bits.

#include "tade.cuh"
#include "wgmma_bf16.cuh"

namespace {

namespace tk = tadek;

constexpr int kC = tk::kC;         // 64: every activation's width
constexpr int kC2 = 2 * kC;        // the gated convs' width
constexpr int kK = tk::kK;         // 9 taps
constexpr int kHalf = tk::kHalf;   // 4
constexpr int kSums = 2 * kC2 + kC;  // a tile's column sums: dT, dG, da'

// ---------------------------------------------------------------------------
// the chain
// ---------------------------------------------------------------------------

constexpr int kTO = 112;                // rows of dsrc a block owns
constexpr int kM = 128;                 // rows of each product: two warpgroups of 64
constexpr int kLd2 = kC2 + 8;           // bf16 row stride of 128-wide rows
constexpr int kLd1 = kC + 8;            // of 64-wide rows
constexpr int kCThreads = 256;          // two warpgroups
constexpr int kWarps = kCThreads / 32;
constexpr int kRowsW = kM / kWarps;     // rows of a product a warp's epilogue takes
constexpr int kLdF = kC + 8;            // float32 row stride of a product's rows
constexpr int kAhead = 4;               // rows a warp loads ahead in the gate's VJP
constexpr int kVjpRows = 2;             // rows whose VJPs a warp forms at once
constexpr int kStages = 6;              // the weight ring
constexpr int kLag = 2;                 // a stage is refilled kLag tiles after its use
constexpr int kTileB = kC * kC * 2;     // one tap's 64 input channels: 64 x 64 bf16
constexpr int kTiles = 2 * kK * 2 + kK;  // 45 weight tiles a call: gc 18, g 18, aux 9

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

template <int D>
struct ChainGeo {
  static constexpr int kRowsT = kM + 2 * kHalf * D;  // dT
  static constexpr int kRowsG = kM + 2 * kHalf;      // dG, da' (the last 8 zero)
  static constexpr int kActB =
      round_up(imax(imax(kRowsT, kRowsG) * kLd2 * 2, kM * kLdF * 4), 1024);
  static constexpr int kRingB = kStages * kTileB;
  static constexpr int kSumB = kWarps * kC2 * 4;     // the warps' column sums
  static constexpr size_t kSmem = 1024 + kRingB + kActB + kSumB + 2 * kStages * 8;
};

struct ChainArgs {
  const float* t;        // (B, L, 128) the gated conv's pre-activations [ta | tb]
  const uint16_t* dout;  // (B, L, 64) cotangent of the gate's output
  const float* s;        // (B, L, 64) the modulation's scale
  const uint16_t* xr;    // (B, L / sc, 64) the normalised input's source
  const float* mean;     // (B, 64) its statistics
  const float* rstd;
  const uint16_t* dext;  // (B, L, 64) cotangent of a' from outside
  const uint16_t* w[3];  // gc, g, aux: tade_conv_wgmma's tiles
  uint16_t* dT;          // (B, L, 128), bf16
  uint16_t* dG;          // (B, L, 128), bf16
  uint16_t* dxn;         // (B, L, 64)
  uint16_t* da;          // (B, L, 64), bf16
  uint16_t* dsrc;        // (B, L, 64)
  float* tsum;           // (B, tiles, 320) column sums of the block's own rows
  int L, sc, softmax, tiles;
};

// Thread 0 copies weight tile i (gc's 18, g's 18, aux's 9 in turn) into
// its stage of the ring.
__device__ __forceinline__ void load_tile(const ChainArgs& p, int i, uint8_t* ring,
                                          uint64_t* full) {
  const int st = i % kStages, c = i < 2 * kK ? 0 : i < 4 * kK ? 1 : 2;
  wgmma::mbar_arrive_expect_tx(full + st, kTileB);
  wgmma::bulk_load(ring + st * kTileB, p.w[c] + (size_t)(i - 2 * kK * c) * (kTileB / 2), kTileB,
                   full + st);
}

// tot[e] = sum over taps j and input channels ci < CIN of
// in[(m + j DD) ld + ci] Wt[j][ci][n] at the accumulator's rows m (warp w:
// 16 w + gid, + 8) and columns n (8 i + 2 tig, + 1) of the
// block's 128 x 64 tile, B from the ring (one tile per 64 input channels
// of a tap, `tile` counting the call's tiles). Each warp hands a tile's
// stage back once its products have retired; thread 0 then refills the
// stage of the tile kLag back with the tile kStages on from it, once every
// warp has handed it back. Every thread calls it; it ends without a
// barrier.
template <int CIN, int DD>
__device__ __forceinline__ void conv9(const ChainArgs& p, const uint16_t* in, int ld,
                                      uint8_t* ring, uint64_t* full, uint64_t* empty, int& tile,
                                      float (&tot)[32]) {
  constexpr int kPer = CIN / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this lane's ldmatrix row (m) and column (k) within a k16 step
  const uint16_t* a0 = in + (16 * warp + (lane & 15)) * ld + (lane >> 4) * 8;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) tot[e] = acc[e] = 0.f;
#pragma unroll 1
  for (int j = 0; j < kK; ++j) {
    // the tap's products (all its tiles) in one group
    uint32_t a[kPer][4][4];
#pragma unroll
    for (int kb = 0; kb < kPer; ++kb)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma::ldmatrix_x4(a[kb][ks], a0 + j * DD * ld + kb * 64 + ks * 16);
    wgmma::fence();
#pragma unroll
    for (int kb = 0; kb < kPer; ++kb) {
      const int st = (tile + kb) % kStages;
      wgmma::mbar_wait(full + st, ((tile + kb) / kStages) & 1);
      const uint64_t desc = wgmma::desc_k_sw128(ring + st * kTileB);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma::m64n64k16<0>(acc, a[kb][ks], desc + 2 * ks, kb > 0 || ks > 0);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    __syncwarp();
#pragma unroll
    for (int kb = 0; kb < kPer; ++kb, ++tile) {
      if (lane == 0) wgmma::mbar_arrive(empty + tile % kStages);
      // the stage of the tile kLag back, handed back by every warp by now
      if (threadIdx.x == 0 && tile >= kLag && tile - kLag + kStages < kTiles) {
        wgmma::mbar_wait(empty + (tile - kLag) % kStages, ((tile - kLag) / kStages) & 1);
        load_tile(p, tile - kLag + kStages, ring, full);
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) tot[e] += acc[e];
  }
}

// The VJP of R rows of gate(t) = softmax(ta) (or sigmoid(ta)) * tanh(tb),
// whose channels (2l, 2l+1) of each half lane l holds (the JAX _gate_vjp,
// tade_train.py:156-170), the rows' warp reductions interleaved (R
// independent shuffles a step); a row's arithmetic is csrc/tade_bwd.cu
// gate_vjp's, which the float32 mode keeps. Every lane of the warp must
// call it.
template <int R>
__device__ __forceinline__ void gate_vjp_rows(const float2 (&ta)[R], const float2 (&tb)[R],
                                              const float2 (&g)[R], int softmax,
                                              float2 (&dta)[R], float2 (&dtb)[R]) {
  float th0[R], th1[R], p0[R], p1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    th0[r] = tanhf(tb[r].x);
    th1[r] = tanhf(tb[r].y);
  }
  if (softmax) {
    float mx[R], sum[R], e0[R], e1[R], su[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = fmaxf(ta[r].x, ta[r].y);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      e0[r] = expf(ta[r].x - mx[r]);
      e1[r] = expf(ta[r].y - mx[r]);
      sum[r] = e0[r] + e1[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float inv = 1.f / sum[r];
      p0[r] = e0[r] * inv;
      p1[r] = e1[r] * inv;
      su[r] = g[r].x * th0[r] * p0[r] + g[r].y * th1[r] * p1[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) su[r] += __shfl_xor_sync(0xffffffffu, su[r], o);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float u0 = g[r].x * th0[r], u1 = g[r].y * th1[r];
      dta[r] = make_float2(p0[r] * (u0 - su[r]), p1[r] * (u1 - su[r]));
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p0[r] = 1.f / (1.f + expf(-ta[r].x));
      p1[r] = 1.f / (1.f + expf(-ta[r].y));
      dta[r] = make_float2(g[r].x * th0[r] * p0[r] * (1.f - p0[r]),
                           g[r].y * th1[r] * p1[r] * (1.f - p1[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    dtb[r] = make_float2(g[r].x * p0[r] * (1.f - th0[r] * th0[r]),
                         g[r].y * p1[r] * (1.f - th1[r] * th1[r]));
}

// The block's 128 x 64 product (the accumulator layout of conv9) into
// float32 rows kLdF apart, for the epilogues' row-by-row pass.
__device__ __forceinline__ void to_rows(const float (&tot)[32], float* yf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tk::st2(yf + (16 * warp + gid + 8 * h) * kLdF + 8 * i + 2 * tig,
              make_float2(tot[4 * i + 2 * h], tot[4 * i + 2 * h + 1]));
}

// Local rows: dT at t0 - 8 - 4D + q, dy and dG at t0 - 8 + m, da' at
// t0 - 4 + m, dsrc at t0 + m.
template <int D>
__global__ void __launch_bounds__(kCThreads, 2)
    chain_bf16_kernel(__grid_constant__ const ChainArgs p) {
  using G = ChainGeo<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  uint16_t* act = reinterpret_cast<uint16_t*>(ring + G::kRingB);
  float* wsum = reinterpret_cast<float*>(ring + G::kRingB + G::kActB);
  uint64_t* full = reinterpret_cast<uint64_t*>(wsum + 8 * kC2);
  uint64_t* empty = full + kStages;
  const int b = blockIdx.y, t0 = blockIdx.x * kTO, L = p.L;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      wgmma::mbar_init(full + st, 1);
      wgmma::mbar_init(empty + st, kCThreads / 32);
    }
    wgmma::fence_mbar_init();
    for (int i = 0; i < kStages; ++i) load_tile(p, i, ring, full);  // land during dT
  }
  __syncthreads();

  const size_t row0 = (size_t)b * L;  // this batch item's first row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float* tsum = p.tsum + ((size_t)b * p.tiles + blockIdx.x) * kSums;
  float* yf = reinterpret_cast<float*>(act);  // a product's float32 rows, in act's place
  int tile = 0;
  float tot[32];

  {  // dT, one warp per row, rounded once into the shared rows; each warp's
     // rows loaded kAhead rows ahead of their VJPs. A row outside [0, L)
     // loads zeros, whose VJP is zero: the rows need no branch, so the
     // compiler can interleave their reductions.
    const int pos0 = t0 - 2 * kHalf - kHalf * D;
    constexpr int kRows = G::kRowsT / kWarps;  // 16 + D rows a warp
    float2 ta[kAhead], tb[kAhead], g[kAhead], sa = make_float2(0.f, 0.f), sb = sa;
    auto load = [&](int k) {  // row warp + 8 k into slot k % kAhead
      const int pos = pos0 + warp + kWarps * k, r = k % kAhead;
      ta[r] = tb[r] = g[r] = make_float2(0.f, 0.f);
      if (pos >= 0 && pos < L) {  // the same for the whole warp
        const float* tr = p.t + (row0 + pos) * kC2 + 2 * lane;
        ta[r] = tk::ld2(tr);
        tb[r] = tk::ld2(tr + kC);
        g[r] = tk::ldio2(p.dout + (row0 + pos) * kC + 2 * lane);
      }
    };
#pragma unroll
    for (int k = 0; k < kAhead; ++k) load(k);
#pragma unroll
    for (int k0 = 0; k0 < kRows; k0 += kVjpRows) {  // rows k0 .. k0 + kVjpRows - 1
      float2 cta[kVjpRows], ctb[kVjpRows], cg[kVjpRows], dta[kVjpRows], dtb[kVjpRows];
#pragma unroll
      for (int r = 0; r < kVjpRows; ++r) {  // a row past the warp's is zero
        const int k = k0 + r;
        cta[r] = ctb[r] = cg[r] = make_float2(0.f, 0.f);
        if (k < kRows) {
          cta[r] = ta[k % kAhead];
          ctb[r] = tb[k % kAhead];
          cg[r] = g[k % kAhead];
        }
      }
      gate_vjp_rows<kVjpRows>(cta, ctb, cg, p.softmax, dta, dtb);
#pragma unroll
      for (int r = 0; r < kVjpRows; ++r) {
        const int k = k0 + r, q = warp + kWarps * k, pos = pos0 + q;
        if (k >= kRows) continue;
        if (k + kAhead < kRows) load(k + kAhead);
        if (pos >= t0 && pos < t0 + kTO && pos < L) {
          uint16_t* o = p.dT + (row0 + pos) * kC2 + 2 * lane;
          tk::stio2(o, dta[r]);
          tk::stio2(o + kC, dtb[r]);
          sa = make_float2(sa.x + dta[r].x, sa.y + dta[r].y);
          sb = make_float2(sb.x + dtb[r].x, sb.y + dtb[r].y);
        }
        tk::stio2(act + q * kLd2 + 2 * lane, dta[r]);
        tk::stio2(act + q * kLd2 + kC + 2 * lane, dtb[r]);
      }
    }
    tk::st2(wsum + warp * kC2 + 2 * lane, sa);
    tk::st2(wsum + warp * kC2 + kC + 2 * lane, sb);
  }
  __syncthreads();
  if (threadIdx.x < kC2) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += wsum[w * kC2 + threadIdx.x];
    tsum[threadIdx.x] = v;
  }

  // dy = gc_D^T(dT); dG = [dy * up(xn) | dy], dxn = dy * s, one warp per row
  conv9<kC2, D>(p, act, kLd2, ring, full, empty, tile, tot);
  __syncthreads();  // every warp's products have read dT
  to_rows(tot, yf);
  __syncthreads();
  {
    const uint16_t* xr = p.xr + (row0 / p.sc) * kC + 2 * lane;
    const float2 mu = tk::ld2(p.mean + b * kC + 2 * lane), rs = tk::ld2(p.rstd + b * kC + 2 * lane);
    float2 dy[kRowsW];
#pragma unroll
    for (int k = 0; k < kRowsW; ++k) dy[k] = tk::ld2(yf + (warp + kWarps * k) * kLdF + 2 * lane);
    __syncthreads();  // every warp has read dy
    float2 sa = make_float2(0.f, 0.f), sb = sa;
#pragma unroll
    for (int k0 = 0; k0 < kRowsW; k0 += kRowsW / 2) {  // row m = warp + 8 k at t0 - 8 + m
      float2 sv[kRowsW / 2];
      uint32_t xw[kRowsW / 2];  // xr's two channels, bf16
#pragma unroll
      for (int k = 0; k < kRowsW / 2; ++k) {
        const int m = warp + kWarps * (k0 + k), pos = t0 - 2 * kHalf + m;
        sv[k] = make_float2(0.f, 0.f);
        xw[k] = 0u;
        if (pos >= 0 && pos < L)
          xw[k] = *reinterpret_cast<const uint32_t*>(xr + (size_t)(pos / p.sc) * kC);
        if (m >= 2 * kHalf && m < 2 * kHalf + kTO && pos < L)
          sv[k] = tk::ld2(p.s + (row0 + pos) * kC + 2 * lane);
      }
#pragma unroll
      for (int k = 0; k < kRowsW / 2; ++k) {
        const int m = warp + kWarps * (k0 + k), pos = t0 - 2 * kHalf + m;
        float2 ga = make_float2(0.f, 0.f), gb = ga;
        if (pos >= 0 && pos < L) {
          gb = dy[k0 + k];
          const float2 xv =
              make_float2(bf16mma::widen(xw[k] & 0xFFFFu), bf16mma::widen(xw[k] >> 16));
          ga = make_float2(gb.x * ((xv.x - mu.x) * rs.x), gb.y * ((xv.y - mu.y) * rs.y));
          if (m >= 2 * kHalf && m < 2 * kHalf + kTO) {
            const size_t o = (row0 + pos) * kC + 2 * lane;
            tk::stio2(p.dxn + o, make_float2(gb.x * sv[k].x, gb.y * sv[k].y));
            tk::stio2(p.dG + (row0 + pos) * kC2 + 2 * lane, ga);
            tk::stio2(p.dG + (row0 + pos) * kC2 + kC + 2 * lane, gb);
            sa = make_float2(sa.x + ga.x, sa.y + ga.y);
            sb = make_float2(sb.x + gb.x, sb.y + gb.y);
          }
        }
        tk::stio2(act + m * kLd2 + 2 * lane, ga);
        tk::stio2(act + m * kLd2 + kC + 2 * lane, gb);
      }
    }
    // the 8 rows past the product, read by da' rows 120-127
    for (int e = threadIdx.x; e < 2 * kHalf * (kC2 / 2); e += kCThreads)
      *reinterpret_cast<uint32_t*>(act + (kM + e / (kC2 / 2)) * kLd2 + 2 * (e % (kC2 / 2))) = 0u;
    tk::st2(wsum + warp * kC2 + 2 * lane, sa);
    tk::st2(wsum + warp * kC2 + kC + 2 * lane, sb);
  }
  __syncthreads();
  if (threadIdx.x < kC2) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += wsum[w * kC2 + threadIdx.x];
    tsum[kC2 + threadIdx.x] = v;
  }

  // da' = g^T(dG) + dext, one warp per row
  conv9<kC2, 1>(p, act, kLd2, ring, full, empty, tile, tot);
  __syncthreads();
  to_rows(tot, yf);
  __syncthreads();
  {
    float2 v[kRowsW];
    uint32_t ew[kRowsW];  // dext's two channels, bf16
#pragma unroll
    for (int k = 0; k < kRowsW; ++k) {  // row m = warp + 8 k at t0 - 4 + m
      const int m = warp + kWarps * k, pos = t0 - kHalf + m;
      v[k] = tk::ld2(yf + m * kLdF + 2 * lane);
      ew[k] = 0u;
      if (pos >= 0 && pos < L)
        ew[k] = *reinterpret_cast<const uint32_t*>(p.dext + (row0 + pos) * kC + 2 * lane);
    }
    __syncthreads();
    float2 sa = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kRowsW; ++k) {
      const int m = warp + kWarps * k, pos = t0 - kHalf + m;
      float2 u = make_float2(0.f, 0.f);
      if (pos >= 0 && pos < L) {
        u = make_float2(v[k].x + bf16mma::widen(ew[k] & 0xFFFFu),
                        v[k].y + bf16mma::widen(ew[k] >> 16));
        if (m >= kHalf && m < kHalf + kTO) {
          tk::stio2(p.da + (row0 + pos) * kC + 2 * lane, u);
          sa = make_float2(sa.x + u.x, sa.y + u.y);
        }
      }
      tk::stio2(act + m * kLd1 + 2 * lane, u);
    }
    for (int i = threadIdx.x; i < 2 * kHalf * (kC / 2); i += kCThreads)
      *reinterpret_cast<uint32_t*>(act + (kM + i / (kC / 2)) * kLd1 + 2 * (i % (kC / 2))) = 0u;
    tk::st2(wsum + warp * kC + 2 * lane, sa);
  }
  __syncthreads();
  if (threadIdx.x < kC) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += wsum[w * kC + threadIdx.x];
    tsum[2 * kC2 + threadIdx.x] = v;
  }

  // dsrc = aux^T(da')
  conv9<kC, 1>(p, act, kLd1, ring, full, empty, tile, tot);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * warp + gid + 8 * h, pos = t0 + m;
      if (m < kTO && pos < L)
        tk::stio2(p.dsrc + (row0 + pos) * kC + 8 * i + 2 * tig,
                  make_float2(tot[4 * i + 2 * h], tot[4 * i + 2 * h + 1]));
    }
}

template <int D>
cudaError_t launch_chain(const ChainArgs& p, int B, cudaStream_t s) {
  using G = ChainGeo<D>;
  cudaError_t e = tk::set_smem(chain_bf16_kernel<D>, G::kSmem);
  if (e != cudaSuccess) return e;
  chain_bf16_kernel<D><<<dim3(p.tiles, B), kCThreads, G::kSmem, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// weight gradients
// ---------------------------------------------------------------------------

constexpr int kGThreads = 384;                    // three warpgroups
constexpr int kGS = 64;                           // rows of one step
constexpr int kGMaxD = 4;
constexpr int kGRowsX = kGS + 2 * kHalf * kGMaxD;  // operand rows of a step
constexpr int kGCotB = kGS * kC2 * 2;             // the cotangent's rows, 16 KB
constexpr int kGCotAtoms = kGS * 128;             // bytes of its 64-column block of atoms
constexpr int kGStageB = round_up(kGCotB + kGRowsX * kLd1 * 2, 1024);
constexpr int kGStages = 5;
constexpr size_t kGSmem = 1024 + (size_t)kGStages * kGStageB;
constexpr int kGSlabW = 6 * kC * kC;              // a job's weight sums (6 64 x 64 units)
constexpr int kGSlab = kGSlabW + kC2;             // then its bias sums
constexpr int kGJobs = 8;
constexpr int kGQuantum = 4 * kTO;                // 448: whole chain tiles and steps
constexpr int kSMs = 132;                         // the H100's SMs: the chunking's target

// job: dW[tap][ci][co] = sum_t x[t + (tap - 4) dil][ci] cot[t][co] over
// the taps tap0 .. (3 taps at n = 128, 6 at 64), cot's rows n bf16 wide;
// sum_off >= 0: also the bias, tsum's columns sum_off .. + n
struct WJob {
  const uint16_t* x;
  const uint16_t* cot;
  float* dw;
  float* db;
  int n, dil, tap0, sum_off;
};

struct WArgs {
  WJob job[kGJobs];
  const float* tsum;  // (B, tiles, 320)
  float* part;        // (jobs, ctas, kGSlab)
  int L, chunk, chunks_per_item, ctas, tiles;
};

__global__ void __launch_bounds__(kGThreads, 1) wgrad_bf16_kernel(__grid_constant__ const WArgs w) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  // the jobs of one chunk are neighbouring blocks, so that they read its
  // rows at about the same time (from L2 after the first)
  const WJob& jb = w.job[blockIdx.x];
  const int L = w.L, item = blockIdx.z, cs = blockIdx.y * w.chunk;
  const int ce = min(L, cs + w.chunk), d = jb.dil, n = jb.n;
  const uint16_t* x = jb.x + (size_t)item * L * kC;
  const uint16_t* cot = jb.cot + (size_t)item * L * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, gid = lane >> 2, tig = lane & 3;
  // this warpgroup's two 64 x 64 units: (tap, first cotangent column); at
  // 128 columns both halves of one tap, at 64 two taps
  int tap[2], col[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    tap[u] = n == kC2 ? jb.tap0 + wg : jb.tap0 + 2 * wg + u;
    col[u] = n == kC2 ? 64 * u : 0;
  }
  // both units' totals side by side, as m64n128's accumulator holds them
  float tot[64], acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) tot[e] = acc[e] = 0.f;

  // step i's operand rows into x_s (q = t - (t0 - 4d)), its cotangent rows
  // into MN-major 128-byte-swizzle atoms: the 16-byte chunk of row t and
  // columns 8 cb .. at (cb / 8) kGCotAtoms + (t / 8) 1024 + (t % 8) 128 +
  // 16 ((cb % 8) ^ (t % 8))
  auto stage = [&](int i, int buf) {
    uint8_t* st = sm + buf * kGStageB;
    uint16_t* xs = reinterpret_cast<uint16_t*>(st + kGCotB);
    const int r0 = cs + i * kGS, rows = kGS + 2 * kHalf * d;
    for (int e = threadIdx.x; e < rows * (kC / 8); e += kGThreads) {
      const int q = e >> 3, c8 = (e & 7) * 8, t = r0 - kHalf * d + q;
      const bool ok = t >= 0 && t < L;
      tf32x3::cp_async<16>(reinterpret_cast<float*>(xs + q * kLd1 + c8),
                           reinterpret_cast<const float*>(ok ? x + (size_t)t * kC + c8 : x), ok);
    }
    const int nb = n / 8;  // 16-byte column blocks of a row
    for (int e = threadIdx.x; e < kGS * nb; e += kGThreads) {
      // pairs of neighbouring blocks of one row (a 32-byte sector) per two lanes
      const int r = (e >> 1) % kGS, cb = 2 * ((e >> 1) / kGS) + (e & 1), t = r0 + r;
      const bool ok = t < ce;  // rows past the chunk read as zero
      const int o = (cb >> 3) * kGCotAtoms + (r >> 3) * 1024 + (r & 7) * 128 +
                    (((cb & 7) ^ (r & 7)) << 4);
      tf32x3::cp_async<16>(reinterpret_cast<float*>(st + o),
                           reinterpret_cast<const float*>(ok ? cot + (size_t)t * n + cb * 8 : cot),
                           ok);
    }
  };

  // A = X_tap^T: A[ci][t] = x_s[t + tap d][ci], this warp's channels 16 w4 ..
  auto load_a = [&](const uint16_t* xs, int tp, uint32_t (&a)[4][4]) {
    const uint16_t* a0 = xs + ((lane & 7) + ((lane >> 4) << 3) + tp * d) * kLd1 + 16 * w4 +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma::ldmatrix_x4_trans(a[ks], a0 + ks * 16 * kLd1);
  };

  // the 128-wide products of a step retire during the next step's staging
  bool pending = false;
  auto retire = [&]() {
    if (!pending) return;
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
#pragma unroll
    for (int e = 0; e < 64; ++e) tot[e] += acc[e];
    pending = false;
  };
  uint32_t a[4][4];

  auto compute = [&](int buf) {
    uint8_t* st = sm + buf * kGStageB;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(st + kGCotB);
    const uint32_t cot_s = wgmma::smem_u32(st);
    if (n == kC2) {  // one tap, both column halves: m64n128
      retire();
      load_a(xs, tap[0], a);
      wgmma::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma::m64n128k16<1>(
            acc, a[ks], wgmma::desc_mn_sw128(cot_s + ks * 2048, kGCotAtoms, 1024), ks > 0);
      wgmma::commit();
      pending = true;
      return;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // two taps of 64 columns, one after the other
      if (tap[u] >= kK) continue;  // the same for the whole warpgroup
      float(&au)[32] = *reinterpret_cast<float(*)[32]>(acc + 32 * u);
      load_a(xs, tap[u], a);
      wgmma::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma::m64n64k16<1>(au, a[ks], wgmma::desc_mn_sw128(cot_s + ks * 2048, kGCotAtoms, 1024),
                            ks > 0);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(au);
#pragma unroll
      for (int e = 0; e < 32; ++e) tot[32 * u + e] += au[e];
    }
  };

  // a ring of kGStages, kGStages - 2 steps staged ahead: the stage refilled
  // in step i is step i - 2's, whose products retired in step i - 1
  const int steps = (ce - cs + kGS - 1) / kGS;
#pragma unroll
  for (int i = 0; i < kGStages - 2; ++i) {
    if (i < steps) stage(i, i);
    tf32x3::cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    tf32x3::cp_async_wait<kGStages - 3>();  // step i has landed (this thread's copies)
    wgmma::fence_proxy_async();             // ... visible to wgmma
    __syncthreads();                        // every thread's; step i - 2's products retired
    const int j = i + kGStages - 2;
    if (j < steps) stage(j, j % kGStages);
    tf32x3::cp_async_commit();
    compute(i % kGStages);
  }
  retire();
  tf32x3::cp_async_wait<0>();

  float* slab =
      w.part + ((size_t)blockIdx.x * w.ctas + item * w.chunks_per_item + blockIdx.y) * kGSlab;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (tap[u] >= kK) continue;
    float* o = slab + (size_t)(tap[u] - jb.tap0) * kC * n + col[u];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tk::st2(o + (16 * w4 + gid + 8 * h) * n + 8 * i + 2 * tig,
                make_float2(tot[32 * u + 4 * i + 2 * h], tot[32 * u + 4 * i + 2 * h + 1]));
  }
  if (jb.sum_off >= 0 && threadIdx.x < n) {  // the bias: this chunk's tiles in order
    const int lo = cs / kTO, hi = ce == L ? w.tiles : ce / kTO;
    const float* ts = w.tsum + (size_t)item * w.tiles * kSums + jb.sum_off + threadIdx.x;
    float v = 0.f;
    for (int i = lo; i < hi; ++i) v += ts[(size_t)i * kSums];
    slab[kGSlabW + threadIdx.x] = v;
  }
}

// Element e of job blockIdx.y's slab: the sum of its slabs, cta 0 first,
// into its gradient.
__global__ void __launch_bounds__(256) wgrad_bf16_reduce_kernel(__grid_constant__ const WArgs w) {
  const WJob& jb = w.job[blockIdx.y];
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= kGSlab) return;
  const int unit = kC * jb.n, tap = jb.tap0 + e / unit;
  if (e < kGSlabW ? tap >= kK : jb.sum_off < 0 || e - kGSlabW >= jb.n) return;
  const float* src = w.part + (size_t)blockIdx.y * w.ctas * kGSlab + e;
  float s = 0.f;
  for (int cta = 0; cta < w.ctas; ++cta) s += src[(size_t)cta * kGSlab];
  if (e < kGSlabW)
    jb.dw[(size_t)tap * unit + e % unit] = s;
  else
    jb.db[e - kGSlabW] = s;
}

struct Plan {
  int tiles, chunk, chunks_per_item, ctas;
  long long tsum_floats, part_floats;
};

// the chain's tiles, and the weight gradients' chunks: about two blocks
// an SM over the 8 jobs, each chunk a whole number of 448-row quanta
Plan plan_of(int B, int L) {
  Plan q;
  q.tiles = (L + kTO - 1) / kTO;
  const int per_item = (2 * kSMs + kGJobs * B - 1) / (kGJobs * B);
  const int rows = (L + per_item - 1) / per_item;
  q.chunk = (rows + kGQuantum - 1) / kGQuantum * kGQuantum;
  q.chunks_per_item = (L + q.chunk - 1) / q.chunk;
  q.ctas = B * q.chunks_per_item;
  q.tsum_floats = (long long)B * q.tiles * kSums;
  q.part_floats = q.tsum_floats + (long long)kGJobs * q.ctas * kGSlab;
  return q;
}

}  // namespace

extern "C" {

// Floats of scratch (part) that tade_stage_bwd_bf16 needs for B x L rows,
// or -1 when the count does not fit an int.
int tade_stage_bwd_bf16_part_floats(int B, int L) {
  if (B < 1 || L < 1) return -1;
  const long long n = plan_of(B, L).part_floats;
  return n > 2147483647LL ? -1 : (int)n;
}

// The backward of one stage in the bf16-resident mode (the top of this
// file). t, s (float32) and y, ain (a'), src (bf16) are the re-run's, src
// is c (stage 1) or up(a) (stage 2), all at rate L; xr (bf16) is at rate
// L / scale; dout, dext bf16; mean, rstd float32. wt_gc, wt_g, wt_aux are
// the transposed convs' weights in ops/kernels/mma_bf16.py
// tade_conv_wgmma's tiles. Writes dT, dG (B, L, 128), dxn, da (a'), dsrc
// (B, L, 64), all bf16, and the float32 weight gradients in gather form
// (9, 64, 128 | 64) with their biases; part (part_floats floats, at least
// tade_stage_bwd_bf16_part_floats) is scratch. scale 1 or 2 (L a multiple
// of it), dilation 1 .. 4, gate 0 softmax or 1 sigmoid; every pointer
// 16-byte aligned. Returns a cudaError_t value: 0 when every launch was
// accepted.
int tade_stage_bwd_bf16(const float* t, const uint16_t* dout, const float* s,
                        const uint16_t* xr, const float* mean, const float* rstd,
                        const uint16_t* dext, const uint16_t* wt_gc, const uint16_t* wt_g,
                        const uint16_t* wt_aux, const uint16_t* y, const uint16_t* ain,
                        const uint16_t* src, uint16_t* dT, uint16_t* dG, uint16_t* dxn,
                        uint16_t* da, uint16_t* dsrc, float* dw_gc, float* db_gc, float* dw_g,
                        float* db_g, float* dw_aux, float* db_aux, float* part,
                        long long part_floats, int B, int L, int scale, int dilation, int gate,
                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || B > 65535 || L < 1 || L > (1 << 24) || scale < 1 || scale > 2 ||
      L % scale != 0 || gate < 0 || gate > 1 || dilation < 1 || dilation > kGMaxD)
    return cudaErrorInvalidValue;
  const Plan q = plan_of(B, L);
  if (part_floats < q.part_floats) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* tsum = part;
  const ChainArgs p{t,  dout, s,   xr,   mean, rstd,    dext,     {wt_gc, wt_g, wt_aux},
                    dT, dG,   dxn, da,   dsrc, tsum,    L,        scale,
                    gate == 0, q.tiles};
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

  WArgs w{};
  w.tsum = tsum;
  w.part = part + q.tsum_floats;
  w.L = L;
  w.chunk = q.chunk;
  w.chunks_per_item = q.chunks_per_item;
  w.ctas = q.ctas;
  w.tiles = q.tiles;
  int j = 0;
  for (int t0 = 0; t0 < kK; t0 += 3)
    w.job[j++] = WJob{y, dT, dw_gc, db_gc, kC2, dilation, t0, t0 == 0 ? 0 : -1};
  for (int t0 = 0; t0 < kK; t0 += 3)
    w.job[j++] = WJob{ain, dG, dw_g, db_g, kC2, 1, t0, t0 == 0 ? kC2 : -1};
  for (int t0 = 0; t0 < kK; t0 += 6)
    w.job[j++] = WJob{src, da, dw_aux, db_aux, kC, 1, t0, t0 == 0 ? 2 * kC2 : -1};
  e = tk::set_smem(wgrad_bf16_kernel, kGSmem);
  if (e != cudaSuccess) return e;
  wgrad_bf16_kernel<<<dim3(kGJobs, q.chunks_per_item, B), kGThreads, kGSmem, st>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_bf16_reduce_kernel<<<dim3((kGSlab + 255) / 256, kGJobs), 256, 0, st>>>(w);
  return cudaGetLastError();
}

}  // extern "C"
