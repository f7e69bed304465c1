// The bf16-resident mode of the fused WaveNet stack (K3 with
// compute_dtype=bfloat16) for Hopper (sm_90a): both products of every layer
// on the warpgroup products (wgmma), each layer's weights kept in shared
// memory by the tensor memory accelerator (TMA), one host call per stack.
//
// Replaces, in the bf16-resident mode, the Pallas TPU kernel of the JAX
// package
//   parallelwavegan_tpu/ops/pallas_kernels/wavenet_stack.py:199
//     fused_wavenet_stack (body _kernel :59-172, casts at :240-253, bf16
//     scratch at :291-292),
// which the JAX generator runs for pallas_stack_bf16
// (models/parallel_wavegan.py:184-187). Per layer, for every row t of every
// batch item (channel-last (B, T, C), C the residual width = the skip width
// = half the gate width):
//   z     = sum_k x[t + k d - left] . Wconv[k] + bconv + c[t] . Waux
//   g     = bf16(tanh(z[:, :C]) * sigmoid(z[:, C:]))
//   skip  = (skip + g . Wskip) + bskip          (float32; written at layer 0)
//   x_out = bf16((g . Wres + bres + x[t]) * sqrt(1/2))
// left = (K - 1) d / 2 (floor), rows of x outside [0, T) read as zero at
// every layer, x (when a call starts), c and the weights rounded to bf16 to
// nearest even, every sum float32: JAX's roundings. The plain version is
// ops/kernels/wavenet.py wavenet_stack_reference_bf16. Built with every
// source by ops/kernels/build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a: wgmma needs the "a"); on the CPU the wrapper runs the plain
// version and tests/test_torch_port_wavenet_bf16_layout.py emulates this
// file's layouts and arithmetic; on the card chip_smoke.py phases 30-31 and
// tests/test_torch_port_cuda.py -m gpu -k bf16 run it.
//
// What bounds it on the card. At Parallel WaveGAN v1 widths (C = 64, gate
// 128, aux 80, K = 3) a layer does 43,008 multiply-adds a row; one 10-layer
// cycle at T = 131,072 is 112.7 GFLOP, 0.114 ms at 989 TFLOP/s, against 89
// MB of the cycle's own inputs and outputs (0.027 ms at 3.35 TB/s): the
// function is bound by its operations. A launch per layer moves more: bf16
// x in and out (256 B a row), bf16 c (160 B) and the float32 skip's read
// and write (512 B), 1.2 GB a cycle, 0.36 ms at 3.35 TB/s; so this design
// is bound by those bytes, and its aim is to keep the memory busy.
//
// The design (each point settled by a measurement on the card, PERF.md §6):
//  - A launch is one layer, persistent: as many blocks of two warpgroups
//    as fit on the card (one an SM), each warpgroup taking 64-row tiles
//    (wgmma's m64) of all batch items in turn, 2 blockIdx.x + w, + 2
//    gridDim.x, .., with stages and a named barrier of its own, so that the
//    two never wait for each other. wavenet_stack_bf16 queues every layer's
//    launch on the caller's stream in one host call; x ping-pongs between
//    two buffers.
//  - The layer's weights, both products as one (K C + Ca16 + C) x 2C
//    matrix (the gate's [Wconv[0..K-1]; Waux], Waux zero-padded to Ca16 =
//    Ca rounded up to 16 rows, and [Wskip | Wres] below it, the columns
//    paired: tanh_j beside sigmoid_j, skip_j beside res_j), are laid out
//    once per decode by ops/kernels/mma_bf16.py wavenet_wgmma in 8 x 8 core
//    matrices of 128 contiguous bytes (MN-major, no swizzle: the leading
//    byte offset steps along K, the stride byte offset along N, as
//    ops/kernels/probe_melgan_bf16.py measured), and brought into shared
//    memory by one bulk copy a block, issued by thread 0: 84 KB at v1,
//    resident for all the block's tiles, shared by both warpgroups.
//  - A tile's rows of x are loaded once as one window of 64 + (K - 1) d
//    rows, which every tap reads at its row shift k d; past d = 64 the
//    window is longer than the taps' K runs of 64 rows, and those are
//    loaded instead. With the tile's rows of c (Ca16 channels), they are
//    copied by cp.async with its zero fill (rows outside [0, T), channels
//    past Ca; c in 4-byte pieces where its rows are not 16-byte multiples,
//    as at Ca = 10, and element by element where they are not 4-byte ones)
//    into one of the warpgroup's two stages, the next tile's during this
//    tile's products. x's rows are 128 bytes in the 16-byte-chunk XOR
//    swizzle at C = 64 (C + 8 elements apart at C = 16), c's Ca16 + 8
//    elements apart: ldmatrix reads 8 rows without a bank conflict. Two
//    stages a warpgroup of the longest window (192 rows) and c beside the
//    weights: 225 KB at v1, one block an SM.
//  - The gate is one chain of wgmma.m64nNk16 (N = 2C: 128 at C = 64, 32 at
//    C = 16) over the K taps' C / 16 steps and c's Ca16 / 16, A by ldmatrix
//    from the stage, B from the resident tile, in groups of four k16 steps
//    whose A registers alternate between two sets, so that one group's
//    ldmatrix runs while the group before it multiplies. The chain is not
//    cut per tap: the tensor cores' truncated accumulation over its 17
//    steps at v1 keeps 99.96 % of each layer's residual bit-equal to the
//    plain version's (phase 30's rule: 99 %).
//  - The gate runs on the accumulators without branches (tanh_k3,
//    sigmoid_k3) and g is rounded to bf16 into the A registers of [Wskip |
//    Wres]'s product: the pairing puts a thread's channels 2 tig, 2 tig + 1
//    (and + 8) of rows gid, gid + 8 where wgmma's A layout wants them, so g
//    never goes to shared memory.
//  - The skip's previous values are loaded as a tile starts, in flight
//    through its products and gate; the epilogue takes x[t] from the
//    window's middle tap (from device memory only for an even K past d =
//    64), adds the biases in JAX's order and stores the skip as float pairs
//    and x_out rounded to bf16 (cvt.rn).
// Blocks share nothing, every sum is taken in a fixed order: two runs give
// the same bits.

#include "melgan_bf16.cuh"

namespace {

using melbf::kThreads;

constexpr int kWGThreads = 128;  // a warpgroup
constexpr int kWM = 64;          // rows of a warpgroup's tile (wgmma's m64)
#ifdef MELBF_CLOCKS
using melbf::kClockBlocks;
using melbf::melbf_clocks;
#endif

constexpr float kSqrtHalf = 0.70710678118654752f;

// What one launch (one layer) reads.
struct LayerArgs {
  const uint16_t* x;   // the layer's input (B, T, C) bf16
  const uint16_t* c;   // (B, T, Ca) bf16
  uint16_t* x_out;     // (B, T, C) bf16
  float* skip;         // (B, T, C) float32
  const uint16_t* w;   // the layer's (K C + Ca16 + C) x 2C tile (wavenet_wgmma)
  const float* bconv;  // (2C)
  const float* bskip;  // (C)
  const float* bres;   // (C)
  int T, Ca, ca16, K, dil, left, accumulate;
  int whole;     // the x rows one window of 64 + (K - 1) d rows, else K runs of 64
  int rows;      // x rows of a stage
  int stages;    // 1 or 2
  int cvec;      // c's copy: 16- or 4-byte cp.async, or 2 (element by element)
  int tiles, ntiles;  // row tiles of an item, of the launch
};

// The shape of a block at residual width C.
template <int C>
struct Geo {
  static_assert(C == 16 || C == 64, "width");
  static constexpr int kN = 2 * C;           // columns of both products
  static constexpr int kQ = C / 8;           // 16-byte chunks of an x row
  static constexpr int kXRowB = C == 64 ? 128 : 2 * (C + 8);  // x row in shared memory
  static constexpr uint32_t kKCore = 16 * kN;  // bytes to the next core matrix along K
  static constexpr uint32_t kK16 = 2 * kKCore;  // bytes of a k16 step of the tile
  // the byte offset of chunk q of x row r in a stage: the XOR swizzle at C = 64
  static __device__ __forceinline__ uint32_t xoff(int r, int q) {
    if constexpr (C == 64)
      return (uint32_t)r * 128u + ((uint32_t)(q ^ (r & 7)) << 4);
    else
      return (uint32_t)r * kXRowB + ((uint32_t)q << 4);
  }
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(wgmma::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(wgmma::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// The gate's tanh and sigmoid without branches (tanhf and an IEEE division
// branch to their slow paths, which kept the 32 values a thread computes
// from overlapping): tanh as its Taylor polynomial to a^7 below |a| = 1/8
// (the next term is 1e-9 of it there), else (1 - e) / (1 + e) with e =
// exp(-2 |a|); sigmoid 1 / (1 + exp(-v)). exp is ex2.approx and the
// divisions approximate: a few float32 ulps from tanhf and expf, which moves
// g's bf16 rounding once in thousands (the CPU emulation in
// tests/test_torch_port_wavenet_bf16_layout.py writes the same formulas
// out).
__device__ __forceinline__ float tanh_k3(float a) {
  const float t = fabsf(a), a2 = a * a;
  const float e = __expf(-2.f * t);
  const float big = copysignf(__fdividef(1.f - e, 1.f + e), a);
  const float small =
      fmaf(a * a2, fmaf(a2, fmaf(a2, -17.f / 315.f, 2.f / 15.f), -1.f / 3.f), a);
  return t < 0.125f ? small : big;
}

__device__ __forceinline__ float sigmoid_k3(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

// One layer. Each warpgroup takes its own tiles of kWM rows in turn:
// warpgroup w of block i tiles 2 i + w, + 2 gridDim.x, .. (tile j: batch item
// j / tiles, rows from (j % tiles) kWM), with its own stages and a named
// barrier of its own, so that the two never wait for each other; they share
// the layer's weights.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    wavenet_bf16_kernel(const __grid_constant__ LayerArgs p) {
  using G = Geo<C>;
  constexpr int N = G::kN;
  constexpr int kXS = C / 16;  // k16 steps of a tap, and of [Wskip | Wres]
  extern __shared__ __align__(128) uint8_t smem[];
  const int T = p.T, K = p.K;
  const int sx = K * kXS, S = sx + p.ca16 / 16;  // the gate's k16 steps: x's, then c's
  const uint32_t wbytes = (uint32_t)(S + kXS) * G::kK16;
  const int cld = p.ca16 + 8;  // c's row stride in elements
  const uint32_t xbytes = (uint32_t)p.rows * G::kXRowB;
  const uint32_t sbytes = xbytes + (uint32_t)kWM * cld * 2;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127, warp = (tid >> 5) & 3,
            lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  uint8_t* stage0 = smem + wbytes + (size_t)wg * p.stages * sbytes;  // this warpgroup's
  float* bias = reinterpret_cast<float*>(smem + wbytes + 2 * (size_t)p.stages * sbytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bias + 4 * C);  // bconv, bskip, bres above
  MELBF_CLOCK_START(0);

  if (tid == 0) {
    wgmma::mbar_init(bar, 1);
    wgmma::fence_mbar_init();
  }
  for (int e = tid; e < 4 * C; e += kThreads)
    bias[e] = e < 2 * C ? p.bconv[e] : e < 3 * C ? p.bskip[e - 2 * C] : p.bres[e - 3 * C];
  __syncthreads();
  if (tid == 0) {
    wgmma::mbar_arrive_expect_tx(bar, wbytes);
    wgmma::bulk_load(smem, p.w, wbytes, bar);
  }
  // this warpgroup's 128 threads alone
  auto wg_sync = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };

  // tile's x rows and c rows into stage s, by this warpgroup's cp.async
  // copies (one commit group)
  auto prefetch = [&](int tile, int s) {
    const int b = tile / p.tiles, t0 = (tile % p.tiles) * kWM;
    uint8_t* xs = stage0 + (size_t)s * sbytes;
    const uint16_t* x = p.x + (size_t)b * T * C;
    for (int e = wtid; e < p.rows * G::kQ; e += kWGThreads) {
      const int r = e / G::kQ, q = e % G::kQ;
      const int t = (p.whole ? t0 + r : t0 + (r / kWM) * p.dil + r % kWM) - p.left;
      const bool ok = t >= 0 && t < T;
      cp16(xs + G::xoff(r, q), ok ? x + (size_t)t * C + 8 * q : x, ok);
    }
    uint16_t* cs = reinterpret_cast<uint16_t*>(xs + xbytes);
    const uint16_t* c = p.c + (size_t)b * T * p.Ca;
    if (p.cvec == 16) {
      const int nq = p.ca16 / 8;
      for (int e = wtid; e < kWM * nq; e += kWGThreads) {
        const int r = e / nq, ch = 8 * (e % nq), t = t0 + r;
        const bool ok = t < T && ch < p.Ca;
        cp16(cs + r * cld + ch, ok ? c + (size_t)t * p.Ca + ch : c, ok);
      }
    } else if (p.cvec == 4) {
      const int nq = p.ca16 / 2;
      for (int e = wtid; e < kWM * nq; e += kWGThreads) {
        const int r = e / nq, ch = 2 * (e % nq), t = t0 + r;
        const bool ok = t < T && ch < p.Ca;
        cp4(cs + r * cld + ch, ok ? c + (size_t)t * p.Ca + ch : c, ok);
      }
    } else {  // plain loads, seen by the warpgroup after its next barrier
      for (int e = wtid; e < kWM * p.ca16; e += kWGThreads) {
        const int r = e / p.ca16, ch = e % p.ca16, t = t0 + r;
        cs[r * cld + ch] = t < T && ch < p.Ca ? c[(size_t)t * p.Ca + ch] : uint16_t(0);
      }
    }
    tf32x3::cp_async_commit();
  };

  const int step = 2 * gridDim.x;
  int tile = 2 * blockIdx.x + wg;
  if (tile < p.ntiles) prefetch(tile, 0);
  wgmma::mbar_wait(bar, 0);  // the weights have landed
  const uint32_t wbase = wgmma::smem_u32(smem);
  const int arow = 16 * warp + (lane & 15), achunk = lane >> 4;  // this lane's ldmatrix row
  MELBF_STAMP(5);

  for (int it = 0; tile < p.ntiles; ++it, tile += step) {
    const int s = p.stages == 2 ? it & 1 : 0;
    const int b = tile / p.tiles, t0 = (tile % p.tiles) * kWM;
    const size_t bo = (size_t)b * T * C;
    // the skip's previous values, in flight through the gate's products
    float2 prev[C / 8][2];
#pragma unroll
    for (int q = 0; q < C / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 16 * warp + gid + 8 * h;
        prev[q][h] = p.accumulate && t < T
                         ? *reinterpret_cast<const float2*>(p.skip + bo + (size_t)t * C +
                                                            8 * q + 2 * tig)
                         : make_float2(0.f, 0.f);
      }
    wg_sync();  // the warpgroup is done with the tile before (and its stage)
    if (p.stages == 2) {
      if (tile + step < p.ntiles) prefetch(tile + step, s ^ 1);
      else tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      if (it > 0) prefetch(tile, 0);
      tf32x3::cp_async_wait<0>();
    }
    wg_sync();  // this tile's rows have landed, every thread's copies
    MELBF_STAMP(0);
    const uint8_t* xs = stage0 + (size_t)s * sbytes;
    const uint16_t* cs = reinterpret_cast<const uint16_t*>(xs + xbytes);

    // A of the gate's k16 step k: x's tap k / kXS, or c's step k - sx
    auto load_a = [&](uint32_t (&a)[4], int k) {
      if (k < sx) {
        const int tap = k / kXS, j = k % kXS;
        const int r = (p.whole ? tap * p.dil : tap * kWM) + arow;
        wgmma::ldmatrix_x4(a, xs + G::xoff(r, 2 * j + achunk));
      } else {
        wgmma::ldmatrix_x4(a, cs + arow * cld + 16 * (k - sx) + 8 * achunk);
      }
    };
    float acc[N / 2];
    uint32_t a0[4][4], a1[4][4];
    auto load_group = [&](uint32_t (&a)[4][4], int g) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < S) load_a(a[j], 4 * g + j);
    };
    auto issue_group = [&](const uint32_t (&a)[4][4], int g) {
      wgmma::fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * g + j;
        if (k < S)
          melbf::mma_cols<N, 1>(acc, a[j], melbf::desc_b(wbase + k * G::kK16, G::kKCore, 128),
                                128, k > 0);
      }
      wgmma::commit();
    };
    // the gate: one chain of S k16 steps, groups of four, A in two sets
    const int ng = (S + 3) / 4;
    load_group(a0, 0);
    for (int g = 0; g < ng; g += 2) {
      issue_group(a0, g);
      wgmma::wait<1>();  // group g - 1 has retired: a1 is free
      if (g + 1 < ng) {
        load_group(a1, g + 1);
        issue_group(a1, g + 1);
        wgmma::wait<1>();  // group g has retired: a0 is free
        if (g + 2 < ng) load_group(a0, g + 2);
      }
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    MELBF_STAMP(1);

    // g = tanh(z_t) sigmoid(z_s) rounded to bf16, straight into the A
    // registers of [Wskip | Wres]: step s's a[2 half + h] holds rows gid + 8 h,
    // channels 16 s + 8 half + 2 tig, + 1, which column tiles 4 s + 2 half
    // and + 1 hold (paired: tanh in the even column, sigmoid in the odd)
    uint32_t ga[kXS][4];
#pragma unroll
    for (int s16 = 0; s16 < kXS; ++s16)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * s16 + 2 * half, ch = 16 * s16 + 8 * half + 2 * tig;
          const float g0 = tanh_k3(acc[4 * i + 2 * h] + bias[ch]) *
                           sigmoid_k3(acc[4 * i + 2 * h + 1] + bias[C + ch]);
          const float g1 = tanh_k3(acc[4 * i + 4 + 2 * h] + bias[ch + 1]) *
                           sigmoid_k3(acc[4 * i + 4 + 2 * h + 1] + bias[C + ch + 1]);
          ga[s16][2 * half + h] = bf16mma::pack(g0, g1);
        }
    MELBF_STAMP(2);
    wgmma::fence();
#pragma unroll
    for (int s16 = 0; s16 < kXS; ++s16)
      melbf::mma_cols<N, 1>(acc, ga[s16],
                            melbf::desc_b(wbase + (S + s16) * G::kK16, G::kKCore, 128), 128,
                            s16 > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    MELBF_STAMP(3);

    // x[t] sits in the window at row left + r, or in the middle tap's run
    const int xmid = p.whole ? p.left : (K % 2 ? (K / 2) * kWM : -1);
#pragma unroll
    for (int q = 0; q < C / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + gid + 8 * h, t = t0 + r, ch = 8 * q + 2 * tig;
        if (t >= T) continue;
        const size_t o = bo + (size_t)t * C + ch;
        const float s0 = acc[8 * q + 2 * h], s1 = acc[8 * q + 4 + 2 * h];
        const float r0 = acc[8 * q + 2 * h + 1], r1 = acc[8 * q + 4 + 2 * h + 1];
        const float* bs = bias + 2 * C;
        const float2 sk = p.accumulate
                              ? make_float2((prev[q][h].x + s0) + bs[ch],
                                            (prev[q][h].y + s1) + bs[ch + 1])
                              : make_float2(s0 + bs[ch], s1 + bs[ch + 1]);
        *reinterpret_cast<float2*>(p.skip + o) = sk;
        const uint32_t u =
            xmid >= 0 ? *reinterpret_cast<const uint32_t*>(xs + G::xoff(xmid + r, q) + 4 * tig)
                      : *reinterpret_cast<const uint32_t*>(p.x + o);
        const float* br = bias + 3 * C;
        *reinterpret_cast<uint32_t*>(p.x_out + o) =
            bf16mma::pack((r0 + br[ch] + bf16mma::widen(u & 0xFFFFu)) * kSqrtHalf,
                          (r1 + br[ch + 1] + bf16mma::widen(u >> 16)) * kSqrtHalf);
      }
    MELBF_STAMP(4);
  }
  tf32x3::cp_async_wait<0>();
}

// The x rows of a warpgroup's stage at dilation d: one window of kWM + (K - 1)
// d rows, or K runs of kWM where that is fewer.
inline bool whole_window(int K, int d) { return d <= kWM || K == 1; }
inline int stage_rows(int K, int d) { return whole_window(K, d) ? kWM + (K - 1) * d : K * kWM; }

// The shared memory of a launch at x rows `rows` a stage.
template <int C>
size_t smem_of(int K, int ca16, int rows, int stages) {
  using G = Geo<C>;
  const size_t w = (size_t)((K * C + ca16) / 16 + C / 16) * G::kK16;
  const size_t stage = (size_t)rows * G::kXRowB + (size_t)kWM * (ca16 + 8) * 2;
  return w + 2 * stages * stage + 16 * (size_t)C + 16;
}

template <int C>
int run_stack(LayerArgs p, uint16_t* xa, uint16_t* xb, const int* dils, int L,
              size_t tile_elems, cudaStream_t stream) {
  // every layer's stages: two where they fit, else one; the launches share
  // the largest layer's shared memory size, so one occupancy query serves
  size_t smem = 0;
  for (int l = 0; l < L; ++l) {
    if (dils[l] < 1) return cudaErrorInvalidValue;
    const int rows = stage_rows(p.K, dils[l]);
    size_t need = smem_of<C>(p.K, p.ca16, rows, 2);
    if (need > melbf::kMaxSmem) need = smem_of<C>(p.K, p.ca16, rows, 1);
    if (need > melbf::kMaxSmem) return cudaErrorInvalidValue;
    smem = need > smem ? need : smem;
  }
  cudaError_t e = melbf::set_smem(wavenet_bf16_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const int grid = melbf::persistent_grid(wavenet_bf16_kernel<C>, smem, (p.ntiles + 1) / 2);
  const uint16_t* w0 = p.w;
  const float *bc = p.bconv, *bs = p.bskip, *br = p.bres;
  for (int l = 0; l < L; ++l) {
    const int d = dils[l];
    p.dil = d;
    p.left = (p.K - 1) * d / 2;
    p.whole = whole_window(p.K, d);
    p.rows = stage_rows(p.K, d);
    p.stages = smem_of<C>(p.K, p.ca16, p.rows, 2) <= melbf::kMaxSmem ? 2 : 1;
    p.x_out = l % 2 == 0 ? xa : xb;
    p.w = w0 + (size_t)l * tile_elems;
    p.bconv = bc + (size_t)l * 2 * C;
    p.bskip = bs + (size_t)l * C;
    p.bres = br + (size_t)l * C;
    p.accumulate = l > 0;
    wavenet_bf16_kernel<C><<<grid, kThreads, smem, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    p.x = p.x_out;
  }
  return cudaSuccess;
}

}  // namespace

#ifdef MELBF_CLOCKS
// The phase cycles this source's kernel stamped (melgan_bf16.cuh), copied to
// out (kClockSlots x kClockBlocks x kClockPhases), then zeroed.
extern "C" int wavenet_stack_bf16_clocks(void* out) {
  const size_t bytes = sizeof(melbf_clocks);
  void* dev = nullptr;
  cudaError_t e = cudaMemcpyFromSymbol(out, melbf_clocks, bytes);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, melbf_clocks);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, bytes);
  return e;
}
#endif

extern "C" {

// L gated layers of one dilation cycle in the bf16-resident mode (the top of
// this file), every launch queued on `stream` by this one call: x (B, T, C)
// and c (B, T, Ca) bf16, layer l writing its x_out to xa (l even) or xb (l
// odd), both (B, T, C) bf16 and neither x, so that the last layer's output
// is in xa for an odd L and xb for an even one; skip (B, T, C) float32,
// written by layer 0 and added to by the others. tiles is the layers'
// weights as ops/kernels/mma_bf16.py wavenet_wgmma lays them out ((L, (K C
// + Ca16 + C) 2C) bf16); bconv (L, 2C), bskip and bres (L, C) float32;
// dils the L dilations (host memory). C is 16 or 64; x, the buffers, c (at
// a Ca that is a multiple of 8) and tiles 16-byte aligned, the skip 8-byte
// aligned. Returns a cudaError_t value: 0 when every launch was accepted.
int wavenet_stack_bf16(const uint16_t* x, const uint16_t* c, uint16_t* xa, uint16_t* xb,
                       float* skip, const uint16_t* tiles, const float* bconv,
                       const float* bskip, const float* bres, const int* dils, int L, int B,
                       int T, int C, int Ca, int K, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (L < 1 || B < 1 || T < 1 || Ca < 1 || K < 1) return cudaErrorInvalidValue;
  const long long tiles_per = (T + kWM - 1) / kWM;
  if (tiles_per * B > 2147483647LL) return cudaErrorInvalidValue;
  LayerArgs p{};
  p.x = x;
  p.c = c;
  p.skip = skip;
  p.w = tiles;
  p.bconv = bconv;
  p.bskip = bskip;
  p.bres = bres;
  p.T = T;
  p.Ca = Ca;
  p.ca16 = (Ca + 15) / 16 * 16;
  p.K = K;
  const uintptr_t ca = reinterpret_cast<uintptr_t>(c);
  p.cvec = Ca % 8 == 0 && ca % 16 == 0 ? 16 : Ca % 2 == 0 && ca % 4 == 0 ? 4 : 2;
  p.tiles = (int)tiles_per;
  p.ntiles = (int)(tiles_per * B);
  const size_t tile_elems = (size_t)(K * C + p.ca16 + C) * 2 * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16:
      return run_stack<16>(p, xa, xb, dils, L, tile_elems, s);
    case 64:
      return run_stack<64>(p, xa, xb, dils, L, tile_elems, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
