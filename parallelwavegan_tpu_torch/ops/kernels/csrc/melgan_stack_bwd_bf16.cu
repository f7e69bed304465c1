// The bf16-resident mode of the fused MelGAN residual stacks' backward (K7)
// for Hopper (sm_90a): every product of a stack on the warpgroup products
// (wgmma), the weights brought in by the tensor memory accelerator (TMA),
// the operand rows kept in shared memory as bf16, and bf16 cotangents
// between the kernels.
//
// Replaces, in the bf16-resident mode (mxu_bf16, turned on at
// melgan_stack_train.py:253-289), the Pallas TPU kernel of the JAX package
//   parallelwavegan_tpu/ops/pallas_kernels/melgan_stack_train.py:247
//     _run_stacks_bwd (body _kernel_stacks_bwd :103-239)
// The function is csrc/melgan_stack_bwd.cu's (its note gives a stack's
// algebra: z recomputed, dW1 = leaky(z)^T g, dWs = x^T g, dz = (g . W1^T)
// leaky'(z), dWd[k] = xp_k^T dz, dx = leaky'(x) fold(dz . Wd^T) + g . Ws^T)
// with JAX's bf16 roundings (_apply_conv_t and _conv_wgrads,
// tade_train.py:173-210): every product's operands rounded to bf16 where
// JAX casts them (the padded leaky(x), dz, leaky(z), x, g and the weights),
// summed in float32; each bias gradient the float32 sum of its unrounded
// cotangent; the padding's adjoint sums in float32 the dz rows that the
// padded positions read and rounds that sum once per tap. The plain
// version is ops/kernels/melgan_stack_train.py
// melgan_stacks_backward_reference_bf16. Built with every source by
// ops/kernels/build.py; on the CPU the wrapper runs the plain version, and
// tests/test_torch_port_melgan_bf16_layout.py emulates this file's layouts
// and arithmetic; on the card chip_smoke.py phase 25 and
// tests/test_torch_port_cuda.py -m gpu -k bf16 run it.
//
// Every reader of h = leaky(z), dz and the cotangent g between stacks
// rounds it to bf16 before use and only the biases sum it unrounded, so
// each is stored once as bf16, with the float32 column sums of its
// unrounded rows per tile written by the kernel that forms it; dz's first
// and last P rows of each batch item, which the padding's adjoint sums,
// are kept in float32 too. Six launches a stack, on the caller's stream:
//  1. dz_bf16_kernel<C>, K6's engine (csrc/melgan_bf16.cuh: persistent
//     blocks of two warpgroups over 128-row tiles, the next tile's window
//     of x loaded while this one's products run): z over the taps of the
//     window bf16(leaky(pad x)), z's sign kept as bits, h = bf16(leaky(z +
//     bd)) out; dh = g . W1^T (the same W1 tile read K-major), g's rows
//     loaded during the taps; dz = dh leaky'(z) out as bf16, its fold rows
//     as float32, its tile column sums; g's tile column sums where g is
//     the stage's dy. As it forms the window it writes the tile's own rows
//     of bf16(leaky(x)) and bf16(x), the weight gradients' operands, and
//     x's signs, a bit a value, for dx.
//  2. wgrad_bf16_kernel<C>: one block of two warpgroups per job and chunk
//     of rows; a job is 128 rows of the products' stacked A = [xp_0^T; ..;
//     xp_{K-1}^T] against dz, or [h^T; x^T] against g, so that one staged
//     cotangent step (64 rows, MN-major core matrices) feeds every product
//     a warpgroup of the job takes: A by ldmatrix.trans at the tap's row
//     shift, B the cotangent through an MN-major descriptor, added into
//     float32 totals every step; every row staged by cp.async (the pad
//     mode's source rows of bf16(leaky(x)) for the taps), a ring of 4
//     steps, 3 ahead; the totals go to a slab of the job's.
//  3. wgrad_reduce_bf16_kernel: the slabs summed in a fixed order.
//  4.-5. colsum_kernel: the bias gradients, the tile sums summed in a fixed
//     order (dz's for bd, g's for b1 and bs).
//  6. dx_bf16_kernel<C>, the same engine, the dz windows loaded two deep:
//     the transposed conv of dz onto the tile's rows (the tap's tile read
//     K-major as Wd[k]^T), in the tiles that hold rows the padding folds
//     onto one more product per tap over the fold's rows (float32 sums of
//     dz's kept rows, rounded once), times leaky'(x) from x's sign bits,
//     plus g . Ws^T; dx out as bf16 with its tile column sums (the next
//     stack's g).
// Every tile's output goes out through shared memory, a warp's stores one
// contiguous run of a row. The final conv's backward
// (outconv_bwd_bf16_kernel<K> + slab_sum_kernel) stays on the CUDA cores;
// its dx is the last stack's g, bf16 with column sums. No atomics: two
// runs give the same bits.
//
// What bounds it on the card: 13 C^2 multiply-adds a row per stack (K6's
// re-run aside), 0.128 ms per MelGAN v1 G step at 989 TFLOP/s, against
// about 30 bytes a value per stack in this dataflow (dz 14: x, g in, h, dz,
// bf16(leaky(x)), bf16(x) and the sign bits out; the weight gradients 10;
// dx 6) and 8 for K6's re-run, 2.2 GB per v1 G step (0.67 ms at 3.35
// TB/s): bound by the bytes. Where the time goes, phase by phase
// (ops/kernels/probe_melgan_bf16.py --clocks; PERF.md §6): dz's window
// conversion and taps, the weight gradients' staging (the jobs re-read
// their cotangent from L2), dx's taps.

#include "melgan_bf16.cuh"

namespace {

using namespace melbf;

// ---------------------------------------------------------------------------
// Row products (dz_bf16_kernel, dx_bf16_kernel)
// ---------------------------------------------------------------------------

struct DzArgs {
  const float* xf;     // the stack's input (B, T, C): float32 ...
  const uint16_t* xh;  // ... or bf16; the other null
  const uint16_t* g;   // cotangent of the stack's output (B, T, C), bf16
  const uint16_t* w;   // the stack's K + 2 tiles
  const float* bd;     // (C)
  uint16_t* h;         // (B, T, C): bf16(leaky(z))
  uint16_t* dz;        // (B, T, C): bf16(dz)
  float* dzf;          // (B, 2P, C): dz rows 0 .. P - 1, then T - P .. T - 1
  float* dzsum;        // (B tiles, C): dz's column sums per tile
  float* gsum;         // (B tiles, C): g's, or null
  uint16_t* xl;        // (B, T, C): bf16(leaky(x)), the weight gradients' operand
  uint16_t* xb;        // (B, T, C): bf16(x), or null where x is bf16 already
  uint8_t* xs;         // (B, tiles kM, C / 8): x's signs (signs()), dx_bf16_kernel's
  int T, K, dil, pad, mode, whole, stages, tiles, ntiles;
  float slope, slope_x;
};

// Row tiles blockIdx.x, + gridDim.x, .. (as K6's): z over the taps, h out,
// z's sign kept, dh = g . W1^T, dz out; the tile's own rows of
// bf16(leaky(x)), bf16(x) and x's signs out as they are formed.
template <int C>
__global__ void __launch_bounds__(kThreads, Geo<C>::kMinBlocks)
    dz_bf16_kernel(__grid_constant__ const DzArgs p) {
  using G = Geo<C>;
  constexpr int kLd = G::kLd;
  extern __shared__ __align__(128) uint8_t smem[];
  const int T = p.T, d = p.dil, P = p.pad, K = p.K;
  const int rows_win = p.whole ? kM + 2 * P : kM;
  uint16_t* grows = reinterpret_cast<uint16_t*>(smem + (size_t)p.stages * G::kTileB);
  float* csum = reinterpret_cast<float*>(grows + kM * kLd);  // kWarps x C
  uint16_t* win = reinterpret_cast<uint16_t*>(csum + kWarps * C);
  uint8_t* raw = reinterpret_cast<uint8_t*>(win + (size_t)rows_win * kLd);  // the next window
  const bool f32 = p.xf != nullptr;
  const size_t raw_b = p.whole ? (size_t)rows_win * C * (f32 ? 4 : 2) : 0;
  // bd, read from shared memory in the tile loop (from the parameter space
  // the compiler hoists it out of it, into registers: the kernel spilled)
  float* bd = reinterpret_cast<float*>(raw + raw_b);
  uint64_t* full = reinterpret_cast<uint64_t*>(bd + C);
  for (int e = threadIdx.x; e < C; e += kThreads) bd[e] = p.bd[e];
  const int nper = K + 1, mine = (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const Ring ring{smem, full, full + p.stages, p.w, p.stages, G::kTileB, mine * nper, nper, K,
                  K, K};
  ring.start();
  auto item = [&](int tile, int& t0) {
    t0 = (tile % p.tiles) * kM;
    return (size_t)(tile / p.tiles) * T * C;
  };
  auto prefetch_window = [&](int tile) {
    int t0;
    const size_t io = item(tile, t0);
    prefetch_raw<C>(raw, f32 ? p.xf + io : nullptr, f32 ? nullptr : p.xh + io, t0 - P, rows_win,
                    T, P, p.mode);
  };
  auto prefetch_g = [&](int tile) {
    int t0;
    const size_t io = item(tile, t0);
    stage_raw<C>(grows, kLd, p.g + io, t0, kM, T);
  };
  // cp.async groups: (whole) the window, then g's rows, each one a tile ahead
  if (p.whole) prefetch_window(blockIdx.x);
  tf32x3::cp_async_commit();
  prefetch_g(blockIdx.x);
  tf32x3::cp_async_commit();
  MELBF_CLOCK_START(1);

  for (int it = 0, tile = blockIdx.x; tile < p.ntiles; ++it, tile += gridDim.x) {
    int t0;
    const size_t io = item(tile, t0);
    const float* xf = f32 ? p.xf + io : nullptr;
    const uint16_t* xh = f32 ? nullptr : p.xh + io;
    uint16_t* xl = p.xl + io;
    uint16_t* xb = p.xb != nullptr ? p.xb + io : nullptr;
    uint8_t* xs = p.xs + (size_t)(tile / p.tiles) * p.tiles * kM * (C / 8);
    float acc[C / 2], tot[C / 2];
    const int u0 = it * nper;
    tf32x3::cp_async_wait<1>();  // the window has landed; g's rows may still be on their way
    __syncthreads();
    MELBF_STAMP(0);
    if (p.whole) {
      convert_raw<C>(win, kLd, nullptr, raw, f32, t0 - P, rows_win, P, T, p.slope_x, xl, xb,
                     xs);
      __syncthreads();  // raw is free: the next tile's window loads during this one's products
      if (tile + gridDim.x < p.ntiles) prefetch_window(tile + gridDim.x);
      tf32x3::cp_async_commit();
      MELBF_STAMP(1);
      for (int k = 0; k < K; ++k) {
        tile_product<C, false>(acc, win + k * d * kLd, kLd, ring.wait(u0 + k), false);
        ring.hand_back(u0 + k);
#pragma unroll
        for (int e = 0; e < C / 2; ++e) tot[e] = k == 0 ? acc[e] : tot[e] + acc[e];
      }
    } else {  // one tap's rows at a time; the centre tap's are the tile's own
      tf32x3::cp_async_commit();  // (no window ahead: the groups stay in step)
      for (int k = 0; k < K; ++k) {
        const bool centre = k == (K - 1) / 2;
        stage_x<C>(win, kLd, xf, xh, t0 + k * d - P, kM, T, P, p.mode, true, p.slope_x,
                   centre ? xl : nullptr, centre ? xb : nullptr, t0, centre ? xs : nullptr);
        __syncthreads();
        tile_product<C, false>(acc, win, kLd, ring.wait(u0 + k), false);
        ring.hand_back(u0 + k);
#pragma unroll
        for (int e = 0; e < C / 2; ++e) tot[e] = k == 0 ? acc[e] : tot[e] + acc[e];
        __syncthreads();  // every warp's products have read the window
      }
    }
    MELBF_STAMP(2);
    // z = tot + bd: z's sign kept, h = leaky(z) out through the window's rows
    uint32_t neg[(C / 2 + 31) / 32];
#pragma unroll
    for (int i = 0; i < (C / 2 + 31) / 32; ++i) neg[i] = 0u;
    for_each_pair<C>([&](int e, int, int col) {
      const float z0 = tot[e] + bd[col], z1 = tot[e + 1] + bd[col + 1];
      neg[e >> 5] |= (z0 < 0.f ? 1u : 0u) << (e & 31);
      neg[(e + 1) >> 5] |= (z1 < 0.f ? 1u : 0u) << ((e + 1) & 31);
      tot[e] = leaky(z0, p.slope);
      tot[e + 1] = leaky(z1, p.slope);
    });
    __syncthreads();  // every warp's products have read the window
    store_rows<C, true>(tot, win, p.h + io, t0, T);
    MELBF_STAMP(3);
    tf32x3::cp_async_wait<1>();  // g's rows have landed
    __syncthreads();
    MELBF_STAMP(4);
    // dh = g . W1^T, then dz = dh leaky'(z)
    tile_product<C, true>(acc, grows, kLd, ring.wait(u0 + K), false);
    ring.hand_back(u0 + K);
#pragma unroll
    for (int e = 0; e < C / 2; ++e)
      if ((neg[e >> 5] >> (e & 31)) & 1u) acc[e] *= p.slope;
    MELBF_STAMP(5);
    float* dzf = p.dzf + (size_t)(tile / p.tiles) * 2 * P * C;
    for_each_pair<C>([&](int e, int r, int col) {  // the padding's adjoint's float32 rows
      const int t = t0 + r;
      if (t >= T) return;
      const float2 v = make_float2(acc[e], acc[e + 1]);
      if (t < P) *reinterpret_cast<float2*>(dzf + (size_t)t * C + col) = v;
      if (t >= T - P) *reinterpret_cast<float2*>(dzf + (size_t)(P + t - (T - P)) * C + col) = v;
    });
    store_rows<C, true>(acc, win, p.dz + io, t0, T);
    col_sums<C>(acc, [&](int r) { return t0 + r < T; }, csum, p.dzsum + (size_t)tile * C);
    if (p.gsum != nullptr) {  // the stage's dy: its bf16 values
      if (threadIdx.x < C) {
        float s = 0.f;
        for (int r = 0; r < kM && t0 + r < T; ++r) s += bf16mma::widen(grows[r * kLd + threadIdx.x]);
        p.gsum[(size_t)tile * C + threadIdx.x] = s;
      }
      __syncthreads();
    }
    MELBF_STAMP(6);
    // every warp is done with g's rows: the next tile's
    if (tile + gridDim.x < p.ntiles) prefetch_g(tile + gridDim.x);
    tf32x3::cp_async_commit();
    MELBF_STAMP(7);
  }
}

struct DxArgs {
  const uint16_t* dz;  // (B, T, C) bf16
  const float* dzf;    // (B, 2P, C): dz's kept float32 rows
  const uint16_t* g;   // (B, T, C) bf16
  const uint8_t* xs;   // (B, tiles kM, C / 8): the signs of the stack's input x
  const uint16_t* w;   // the stack's K + 2 tiles
  uint16_t* dx;        // (B, T, C) bf16
  float* dxsum;        // (B tiles, C): dx's column sums per tile, or null
  int T, K, dil, pad, mode, whole, stages, tiles, ntiles;
  float slope;
};

// The fold's operand rows of tap k for the tile at t0: at row t, the
// float32 sum of the dz rows that the padded positions folded onto t read
// (padded position q reads dz row q + P - k d; rows outside [0, T) are
// zero; dzf holds rows u < P at u, rows u >= T - P at P + u - (T - P)),
// rounded once; zeros at the rows nothing folds onto.
template <int C>
__device__ __forceinline__ void stage_fold(uint16_t* dst, int ld, const float* dzf, int t0,
                                           int k, int T, int P, int dil, int mode) {
  constexpr int kQ = C / 8;
  const int off = P - k * dil;
  for (int e = threadIdx.x; e < kM * kQ; e += kThreads) {
    const int r = e / kQ, c8 = (e % kQ) * 8, t = t0 + r;
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    auto add = [&](int u) {
      if (u < 0 || u >= T) return;
      const float* src = dzf + (size_t)(u < P ? u : P + u - (T - P)) * C + c8;
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b = *reinterpret_cast<const float4*>(src + 4);
      s[0] += a.x, s[1] += a.y, s[2] += a.z, s[3] += a.w;
      s[4] += b.x, s[5] += b.y, s[6] += b.z, s[7] += b.w;
    };
    if (mode == kReflect) {
      if (t >= 1 && t <= P) add(off - t);
      if (t >= T - 1 - P && t <= T - 2) add(2 * T - 2 - t + off);
    } else if (mode == kEdge) {
      if (t == 0)
        for (int j = 1; j <= P; ++j) add(off - j);
      if (t == T - 1)
        for (int j = 0; j < P; ++j) add(T + j + off);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c8) =
        make_uint4(bf16mma::pack(s[0], s[1]), bf16mma::pack(s[2], s[3]),
                   bf16mma::pack(s[4], s[5]), bf16mma::pack(s[6], s[7]));
  }
}

// Row tiles blockIdx.x, + gridDim.x, .. (as K6's): dx = leaky'(x) (the
// transposed conv of dz, the fold's rows where the tile holds rows the
// padding folds onto) + g . Ws^T. Whole windows are loaded two deep: the
// next tile's dz rows land during this one's products.
template <int C>
__global__ void __launch_bounds__(kThreads, Geo<C>::kMinBlocks)
    dx_bf16_kernel(__grid_constant__ const DxArgs p) {
  using G = Geo<C>;
  constexpr int kLd = G::kLd;
  extern __shared__ __align__(128) uint8_t smem[];
  const int T = p.T, d = p.dil, P = p.pad, K = p.K;
  const int rows_win = p.whole ? kM + 2 * P : kM;
  uint16_t* grows = reinterpret_cast<uint16_t*>(smem + (size_t)p.stages * G::kTileB);
  uint16_t* fold = grows + kM * kLd;
  uint8_t* sgn = reinterpret_cast<uint8_t*>(fold + kM * kLd);  // the tile's x signs
  float* csum = reinterpret_cast<float*>(sgn + kM * C / 8);     // kWarps x C
  uint16_t* wins = reinterpret_cast<uint16_t*>(csum + kWarps * C);  // one or (whole) two
  uint64_t* full = reinterpret_cast<uint64_t*>(wins + (size_t)(p.whole ? 2 : 1) * rows_win * kLd);
  // the taps' tiles, then Ws's (tile K + 1)
  const int nper = K + 1, mine = (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const Ring ring{smem, full, full + p.stages, p.w, p.stages, G::kTileB, mine * nper, nper, K,
                  K + 1, K + 1};
  ring.start();
  auto item = [&](int tile, int& t0) {
    t0 = (tile % p.tiles) * kM;
    return (size_t)(tile / p.tiles) * T * C;
  };
  // tap k at row r reads dz row t0 + r + P - k d: window rows from t0 - P
  // (all taps), or from t0 + P - k d (tap k alone)
  auto prefetch_window = [&](int tile, int buf) {
    int t0;
    const size_t io = item(tile, t0);
    stage_raw<C>(wins + (size_t)buf * rows_win * kLd, kLd, p.dz + io, t0 - P, rows_win, T);
  };
  auto prefetch_g = [&](int tile) {  // g's rows and x's signs
    int t0;
    const size_t io = item(tile, t0);
    stage_raw<C>(grows, kLd, p.g + io, t0, kM, T);
    const uint8_t* s = p.xs + (size_t)tile * kM * (C / 8);  // tiles kM rows an item
    for (int e = threadIdx.x; e < C; e += kThreads)  // kM C / 8 bytes, C pieces of 16
      tf32x3::cp_async<16>(reinterpret_cast<float*>(sgn + 16 * e),
                           reinterpret_cast<const float*>(s + 16 * e), true);
  };
  // cp.async groups: (whole) the window, then g's rows, each one a tile ahead
  if (p.whole) prefetch_window(blockIdx.x, 0);
  tf32x3::cp_async_commit();
  prefetch_g(blockIdx.x);
  tf32x3::cp_async_commit();
  MELBF_CLOCK_START(2);

  for (int it = 0, tile = blockIdx.x; tile < p.ntiles; ++it, tile += gridDim.x) {
    int t0;
    const size_t io = item(tile, t0);
    const int b = tile / p.tiles;
    const bool folding = folds(t0, T, P, p.mode);  // the same in every thread
    const float* dzf = p.dzf + (size_t)b * 2 * P * C;
    float acc[C / 2], tot[C / 2];
    const int u0 = it * nper;
    tf32x3::cp_async_wait<1>();  // the window has landed; g's rows may still be on their way
    __syncthreads();  // ... for every thread; the tile before is done with the other window
    uint16_t* win = wins + (size_t)(p.whole ? it & 1 : 0) * rows_win * kLd;
    if (p.whole && tile + gridDim.x < p.ntiles) prefetch_window(tile + gridDim.x, (it + 1) & 1);
    tf32x3::cp_async_commit();
    MELBF_STAMP(0);
    for (int k = 0; k < K; ++k) {
      if (!p.whole) {
        if (k > 0) __syncthreads();  // every warp's products have read the window
        stage_raw<C>(win, kLd, p.dz + io, t0 + P - k * d, kM, T);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();  // (g's rows too)
        __syncthreads();
      }
      const uint32_t tap = ring.wait(u0 + k);
      tile_product<C, true>(acc, win + (p.whole ? 2 * P - k * d : 0) * kLd, kLd, tap, false);
      if (folding) {
        __syncthreads();  // the fold rows of the tap before have been read
        stage_fold<C>(fold, kLd, dzf, t0, k, T, P, d, p.mode);
        __syncthreads();
        tile_product<C, true>(acc, fold, kLd, tap, true);
      }
      ring.hand_back(u0 + k);
#pragma unroll
      for (int e = 0; e < C / 2; ++e) tot[e] = k == 0 ? acc[e] : tot[e] + acc[e];
    }
    MELBF_STAMP(1);
    tf32x3::cp_async_wait<1>();  // g's rows and x's signs have landed
    __syncthreads();  // ... for every thread; every warp's products have read the fold rows
    MELBF_STAMP(2);
    // the transposed conv times leaky'(x)
    for_each_pair<C>([&](int e, int r, int col) {
      const uint32_t s = sgn[r * (C / 8) + col / 8] >> (col % 8);
      if (s & 1u) tot[e] *= p.slope;
      if (s & 2u) tot[e + 1] *= p.slope;
    });
    MELBF_STAMP(3);
    tile_product<C, true>(acc, grows, kLd, ring.wait(u0 + K), false);  // g . Ws^T
    ring.hand_back(u0 + K);
#pragma unroll
    for (int e = 0; e < C / 2; ++e) tot[e] += acc[e];
    MELBF_STAMP(4);
    store_rows<C, true>(tot, fold, p.dx + io, t0, T);  // through the fold's rows
    if (p.dxsum != nullptr)
      col_sums<C>(tot, [&](int r) { return t0 + r < T; }, csum, p.dxsum + (size_t)tile * C);
    else
      __syncthreads();
    MELBF_STAMP(5);
    // every warp is done with g's rows (and the one-tap window): the next tile's
    if (tile + gridDim.x < p.ntiles) prefetch_g(tile + gridDim.x);
    tf32x3::cp_async_commit();
    MELBF_STAMP(6);
  }
}

// ---------------------------------------------------------------------------
// Weight gradients of a stack
// ---------------------------------------------------------------------------

constexpr int kWS = 64;        // rows of one step
constexpr int kMaxJobs = 9;    // 7 of the taps' (K = 7, C = 128), 2 of [h | x]
constexpr int kWinAct = 0;     // bf16(leaky(pad x)), the taps' operand
constexpr int kWinX = 1;       // bf16(x)
constexpr int kWinH = 2;       // h, bf16 already

// A job: 128 rows m0 .. m0 + 127 of a stacked A (segment s, channel ci at
// row s C + ci: the taps' xp_k^T against dz, or h^T, x^T against g) over
// the whole cotangent width. Segment s reads window seg_win[s] from row
// seg_off[s]; window w is win_rows rows of kind win_kind[w], row q of the
// step at rows r0 .. reading padded position (or row) r0 + win_shift[w] + q.
struct WJob {
  const uint16_t* cot;
  float* dw[kMaxK];  // segment s's gradient (C, C), gather form
  int taps;          // 1: the taps' job (against dz), 0: [h | x]'s (against g)
  int m0, nseg, nwin, win_rows;
  int seg_win[kMaxK], seg_off[kMaxK];
  int win_kind[kMaxK], win_shift[kMaxK];
};

constexpr int kWStages = 4;  // the steps' ring, kWStages - 1 steps staged ahead

struct WArgs {
  WJob job[kMaxJobs];
  const uint16_t* xl;  // (B, T, C) bf16(leaky(x)) (dz_bf16_kernel's)
  const uint16_t* xb;  // (B, T, C) bf16(x)
  const uint16_t* h;
  float* part;  // (jobs, ctas, kM x C) slabs
  int njobs, T, pad, mode, chunk, chunks_per_item, ctas, stage_b;
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1) wgrad_bf16_kernel(__grid_constant__ const WArgs w) {
  using G = Geo<C>;
  constexpr int kLd = G::kLd;
  constexpr int kCotB = kWS * C * 2;  // a step's cotangent rows
  extern __shared__ __align__(128) uint8_t smem[];
  const WJob& jb = w.job[blockIdx.x];
  const int T = w.T, item = blockIdx.z, cs = blockIdx.y * w.chunk;
  const int ce = min(T, cs + w.chunk);
  const size_t io = (size_t)item * T * C;
  const uint16_t* cot = jb.cot + io;
  const uint16_t* src[3] = {w.xl + io, w.xb + io, w.h + io};  // by window kind
  const int winb = jb.win_rows * G::kRowB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, w4 = warp & 3;
  // this warpgroup's 64 rows of A, and this warp's 16 (segment s, channels ci0 ..)
  const bool live = jb.m0 + 64 * wg < jb.nseg * C;  // the same for the whole warpgroup
  const int m = jb.m0 + 64 * wg + 16 * w4, s = m / C < jb.nseg ? m / C : 0, ci0 = m % C;
  const int a_row = jb.seg_off[s] + (lane & 7) + ((lane >> 4) << 3);
  const int a_col = ci0 + ((lane >> 3) & 1) * 8;
  float acc[C / 2], tot[C / 2];
#pragma unroll
  for (int e = 0; e < C / 2; ++e) tot[e] = 0.f;

  // step i's rows into stage buf, all by cp.async: the cotangent in MN-major
  // core matrices (the 16 bytes of row r, channels 8 j .. at (r / 8) 16 C +
  // 128 j + 16 (r % 8)), then the job's windows (the taps' through the pad
  // mode's source rows)
  auto stage = [&](int i, int buf) {
    uint8_t* st = smem + (size_t)buf * w.stage_b;
    const int r0 = cs + i * kWS;
    for (int e = threadIdx.x; e < kWS * (C / 8); e += kThreads) {
      const int r = e / (C / 8), j = e % (C / 8), t = r0 + r;
      const bool ok = t < ce;  // rows past the chunk read as zero
      tf32x3::cp_async<16>(reinterpret_cast<float*>(st + (r >> 3) * 16 * C + j * 128 + (r & 7) * 16),
                           reinterpret_cast<const float*>(ok ? cot + (size_t)t * C + 8 * j : cot),
                           ok);
    }
    for (int v = 0; v < jb.nwin; ++v) {
      const int kind = jb.win_kind[v];
      stage_raw<C>(reinterpret_cast<uint16_t*>(st + kCotB + v * winb), kLd, src[kind],
                   r0 + jb.win_shift[v], jb.win_rows, T, kind == kWinAct ? w.pad : 0,
                   kind == kWinAct ? w.mode : kZero);
    }
  };

  const int steps = (ce - cs + kWS - 1) / kWS;
  MELBF_CLOCK_START(3);
#pragma unroll
  for (int i = 0; i < kWStages - 1; ++i) {
    if (i < steps) stage(i, i);
    tf32x3::cp_async_commit();
  }
  MELBF_STAMP(0);
  for (int i = 0; i < steps; ++i) {
    tf32x3::cp_async_wait<kWStages - 2>();  // step i has landed (this thread's copies)
    wgmma::fence_proxy_async();
    __syncthreads();  // every thread's; step i - 1's products retired
    MELBF_STAMP(1);
    // the stage of step i - 1 takes step i + kWStages - 1
    if (i + kWStages - 1 < steps) stage(i + kWStages - 1, (i + kWStages - 1) % kWStages);
    tf32x3::cp_async_commit();
    MELBF_STAMP(2);
    const uint8_t* st = smem + (size_t)(i % kWStages) * w.stage_b;
    if (live) {
      // A = X_s^T by ldmatrix.trans: A[ci][t] = window row t + seg_off[s], channel ci
      const uint16_t* a0 = reinterpret_cast<const uint16_t*>(st + kCotB + jb.seg_win[s] * winb) +
                           a_row * kLd + a_col;
      uint32_t a[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma::ldmatrix_x4_trans(a[ks], a0 + ks * 16 * kLd);
      const uint64_t desc = desc_b(wgmma::smem_u32(st), 16 * C, 128);
      wgmma::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_cols<C, 1>(acc, a[ks], desc + ((ks * 32 * C) >> 4), 128, ks > 0);
      wgmma::commit();
    }
    if (live) {
      wgmma::wait<0>();
      wgmma::fence_operand(acc);
#pragma unroll
      for (int e = 0; e < C / 2; ++e) tot[e] += acc[e];
    }
    MELBF_STAMP(3);
  }
  tf32x3::cp_async_wait<0>();

  float* slab = w.part + ((size_t)blockIdx.x * w.ctas + (size_t)item * w.chunks_per_item +
                          blockIdx.y) * (kM * C);
  if (live)
    for_each_pair<C>([&](int e, int r, int col) {
      *reinterpret_cast<float2*>(slab + (size_t)r * C + col) = make_float2(tot[e], tot[e + 1]);
    });
}

// Element e of job blockIdx.y's slab: the sum of its slabs, cta 0 first,
// into its gradient.
__global__ void __launch_bounds__(256) wgrad_reduce_bf16_kernel(__grid_constant__ const WArgs w,
                                                                int C) {
  const WJob& jb = w.job[blockIdx.y];
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= kM * C) return;
  const int m = jb.m0 + e / C, s = m / C;
  if (s >= jb.nseg) return;
  const float* src = w.part + (size_t)blockIdx.y * w.ctas * (kM * C) + e;
  float v = 0.f;
  for (int cta = 0; cta < w.ctas; ++cta) v += src[(size_t)cta * (kM * C)];
  jb.dw[s][(size_t)(m % C) * C + e % C] = v;
}

// out0[c] (and out1[c] where set) = sum over r of in[r][c], in a fixed
// order: warp w takes rows w, w + 32, .., then the warps in turn. One
// block of 32 x 32 threads per 32 columns.
__global__ void __launch_bounds__(1024) colsum_kernel(const float* in, int rows, int C,
                                                      float* out0, float* out1) {
  __shared__ float part[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < C)
    for (int r = warp; r < rows; r += 32) s += in[(size_t)r * C + c];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < C) {
    float v = 0.f;
    for (int j = 0; j < 32; ++j) v += part[j][lane];
    out0[c] = v;
    if (out1 != nullptr) out1[c] = v;
  }
}

// ---------------------------------------------------------------------------
// The final conv (C -> Cout <= 4), on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kOThreads = 256;
constexpr int kORowsF = 16384;  // rows x C of one block
constexpr int kOMaxCout = 4;

__host__ __device__ constexpr int o_rows(int C) { return kORowsF / C; }

struct OutArgs {
  const float* x;       // the conv's input (B, T, C), the float32 chain
  const float* y;       // its output after tanh (B, T, Cout), float32
  const uint16_t* dyh;  // the cotangent of y, bf16
  const float* w;       // (K, C, Cout) holding bf16 values
  uint16_t* g;          // (B, T, C): dx, bf16 (the last stack's g)
  float* gsum;          // (ctas, C): its column sums per block
  float* part;          // (ctas, slab): dW (K, C, Cout) then db (Cout) per block
  int T, C, Cout, mode, ctas_per_item, slab;
  float slope;
};

// dpre = dy (1 - y^2) at row u of batch item b (0 outside [0, T)).
__device__ __forceinline__ float dpre_at(const OutArgs& p, size_t row0, int u, int o) {
  if (u < 0 || u >= p.T) return 0.f;
  const size_t i = (row0 + u) * p.Cout + o;
  const float yv = p.y[i];
  return bf16mma::widen(p.dyh[i]) * (1.f - yv * yv);
}

// csrc/melgan_stack_bwd.cu's outconv_bwd_kernel in the bf16 mode: one
// block of o_rows(C) rows of one batch item, thread (c, rg) = (tid % C, tid
// / C) channel c of a group of rows; dpre of the block's rows and halo
// formed once into shared memory; the operands of every product rounded to
// bf16 (dpre, leaky(x); w holds bf16 values), the padding's adjoint summing
// the dpre rows that the padded positions read before rounding, the bias
// gradient the unrounded dpre's sum; dx written as bf16, with the block's
// column sums of its unrounded values; the row groups' sums into the slab
// and gsum in a fixed order.
template <int K>
__global__ void __launch_bounds__(kOThreads) outconv_bwd_bf16_kernel(OutArgs p) {
  constexpr int P = (K - 1) / 2;
  extern __shared__ float4 smem4[];
  const int C = p.C, T = p.T, Cout = p.Cout, rows = o_rows(C);
  const int ngroups = kOThreads / C;
  float4* dp = smem4;                                        // rows + 2P rows of dpre
  float* red = reinterpret_cast<float*>(dp + rows + 2 * P);  // row groups' sums
  float* gred = red + (size_t)ngroups * (K * C * Cout + Cout);  // row groups' dx sums
  const int b = blockIdx.y, t0 = blockIdx.x * rows;
  const size_t row0 = (size_t)b * T;
  for (int i = threadIdx.x; i < rows + 2 * P; i += kOThreads) {
    float v[kOMaxCout];
#pragma unroll
    for (int o = 0; o < kOMaxCout; ++o) v[o] = o < Cout ? dpre_at(p, row0, t0 - P + i, o) : 0.f;
    dp[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  const int c = threadIdx.x % C, rg = threadIdx.x / C;
  const bool on = rg < ngroups;
  float wr[K][kOMaxCout], gw[K][kOMaxCout], gb[kOMaxCout], gs = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 0; o < kOMaxCout; ++o) {
      wr[k][o] = on && o < Cout ? p.w[((size_t)k * C + c) * Cout + o] : 0.f;
      gw[k][o] = 0.f;
    }
#pragma unroll
  for (int o = 0; o < kOMaxCout; ++o) gb[o] = 0.f;
  __syncthreads();

  const int rpt = (rows + ngroups - 1) / ngroups;
  const int ta = t0 + rg * rpt, tz = min(min(ta + rpt, t0 + rows), T);
  if (on && ta < tz) {
    const float* xb = p.x + row0 * C + c;
    // win[k]: x at the padded position t + k - P, the row it reads
    float win[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = pad_row(ta + k - P, T, P, p.mode);
      win[k] = r >= 0 ? xb[(size_t)r * C] : 0.f;
    }
    for (int t = ta; t < tz; ++t) {
      if (t > ta) {
#pragma unroll
        for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
        const int r = pad_row(t + P, T, P, p.mode);
        win[K - 1] = r >= 0 ? xb[(size_t)r * C] : 0.f;
      }
      // the transposed conv at row t: dpre rows t + P - k
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 dv = dp[t - t0 + 2 * P - k];
        s += bf16mma::to_bf16(dv.x) * wr[k][0] + bf16mma::to_bf16(dv.y) * wr[k][1] +
             bf16mma::to_bf16(dv.z) * wr[k][2] + bf16mma::to_bf16(dv.w) * wr[k][3];
      }
      // the padding's adjoint: per tap, the sum of the dpre rows that the
      // positions folded onto t read, rounded once
      const bool folded = P > 0 && ((p.mode == kReflect && ((t >= 1 && t <= P) ||
                                                            (t >= T - 1 - P && t <= T - 2))) ||
                                    (p.mode == kEdge && (t == 0 || t == T - 1)));
      if (folded) {
        auto fold = [&](int k, int o) {
          float v = 0.f;
          if (p.mode == kReflect) {
            if (t >= 1 && t <= P) v += dpre_at(p, row0, -t + P - k, o);
            if (t >= T - 1 - P && t <= T - 2) v += dpre_at(p, row0, 2 * T - 2 - t + P - k, o);
          } else {
            if (t == 0)
              for (int j = 1; j <= P; ++j) v += dpre_at(p, row0, -j + P - k, o);
            if (t == T - 1)
              for (int j = 0; j < P; ++j) v += dpre_at(p, row0, T + j + P - k, o);
          }
          return bf16mma::to_bf16(v);
        };
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int o = 0; o < kOMaxCout; ++o)
            if (o < Cout) v += fold(k, o) * wr[k][o];
        s += v;
      }
      const float dx = dleaky(win[P], p.slope) * s;
      p.g[(row0 + t) * C + c] = __bfloat16_as_ushort(__float2bfloat16_rn(dx));
      gs += dx;
      const float4 dv = dp[t - t0 + P];
      const float dvo[kOMaxCout] = {bf16mma::to_bf16(dv.x), bf16mma::to_bf16(dv.y),
                                    bf16mma::to_bf16(dv.z), bf16mma::to_bf16(dv.w)};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float a = bf16mma::to_bf16(leaky(win[k], p.slope));
#pragma unroll
        for (int o = 0; o < kOMaxCout; ++o) gw[k][o] += a * dvo[o];
      }
      if (c == 0) {
        const float dvu[kOMaxCout] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int o = 0; o < kOMaxCout; ++o) gb[o] += dvu[o];
      }
    }
  }
  // the row groups' sums into the slab and gsum: group 0 first
  const int nw = K * C * Cout;
  if (on) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int o = 0; o < kOMaxCout; ++o)
        if (o < Cout) red[(size_t)rg * (nw + Cout) + ((size_t)k * C + c) * Cout + o] = gw[k][o];
    if (c == 0)
#pragma unroll
      for (int o = 0; o < kOMaxCout; ++o)
        if (o < Cout) red[(size_t)rg * (nw + Cout) + nw + o] = gb[o];
    gred[rg * C + c] = gs;
  }
  __syncthreads();
  const size_t cta = (size_t)b * p.ctas_per_item + blockIdx.x;
  float* slab = p.part + cta * p.slab;
  for (int e = threadIdx.x; e < nw + Cout; e += kOThreads) {
    float s = 0.f;
    for (int r = 0; r < ngroups; ++r) s += red[(size_t)r * (nw + Cout) + e];
    slab[e] = s;
  }
  for (int e = threadIdx.x; e < C; e += kOThreads) {
    float s = 0.f;
    for (int r = 0; r < ngroups; ++r) s += gred[r * C + e];
    p.gsum[cta * C + e] = s;
  }
}

// dw[e] (e < nw) or db[e - nw] (e < n) = the sum of the ctas' slabs at e,
// cta 0 first.
__global__ void __launch_bounds__(256) slab_sum_kernel(const float* part, int ctas, int n, int nw,
                                                       float* dw, float* db) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n || (e >= nw && db == nullptr)) return;
  float s = 0.f;
  for (int cta = 0; cta < ctas; ++cta) s += part[(size_t)cta * n + e];
  if (e < nw)
    dw[e] = s;
  else
    db[e - nw] = s;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

constexpr int kSMs = 132;  // the H100's SMs: the weight gradients' chunking target

bool bad_args(int B, int T, int C, int K, int pad, int mode) {
  return B < 1 || B > 65535 || T < 1 || T > (1 << 26) || C < 16 || C > 128 || C % 16 != 0 ||
         K < 1 || K % 2 == 0 || K > kMaxK || mode < kReflect || mode > kZero ||
         (mode == kReflect && pad >= T);
}

// The weight gradients' jobs of a stack (their cotangents, windows and
// gradients set by the caller), and the chunking of the rows.
struct Plan {
  int njobs, tiles, chunk, chunks_per_item, ctas;
  long long sums, dzf, slabs;  // floats of each part of the scratch
};

int jobs_of(int C, int K, WJob* out, int dil, int pad) {
  int n = 0;
  for (int fam = 0; fam < 2; ++fam) {
    const int nseg = fam == 0 ? K : 2;
    for (int m0 = 0; m0 < nseg * C; m0 += kM) {
      WJob jb{};
      jb.taps = fam == 0;
      jb.m0 = m0;
      jb.nseg = nseg;
      const int s_lo = m0 / C, s_end = (m0 + kM + C - 1) / C;
      const int s_hi = (s_end < nseg ? s_end : nseg) - 1;
      const int nin = s_hi - s_lo + 1;
      if (fam == 0 && (nin - 1) * dil <= (nin - 1) * kWS) {  // one window of the taps' rows
        jb.nwin = 1;
        jb.win_rows = kWS + (nin - 1) * dil;
        jb.win_kind[0] = kWinAct;
        jb.win_shift[0] = s_lo * dil - pad;
        for (int s = s_lo; s <= s_hi; ++s) jb.seg_off[s] = (s - s_lo) * dil;
      } else {  // a window of kWS rows a segment
        jb.nwin = nin;
        jb.win_rows = kWS;
        for (int s = s_lo; s <= s_hi; ++s) {
          jb.seg_win[s] = s - s_lo;
          jb.win_kind[s - s_lo] = fam == 0 ? kWinAct : s == 0 ? kWinH : kWinX;
          jb.win_shift[s - s_lo] = fam == 0 ? s * dil - pad : 0;
        }
      }
      if (out != nullptr) out[n] = jb;
      ++n;
    }
  }
  return n;
}

Plan plan_of(int B, int T, int C, int K, int dil) {
  Plan q;
  const int pad = (K - 1) / 2 * dil;
  q.njobs = jobs_of(C, K, nullptr, dil, pad);
  q.tiles = (T + kM - 1) / kM;
  const int target = kSMs * (C <= 64 ? 2 : 1);
  const int per_item = (target + q.njobs * B - 1) / (q.njobs * B);
  const int rows = (T + per_item - 1) / per_item;
  q.chunk = (rows + kWS - 1) / kWS * kWS;
  q.chunks_per_item = (T + q.chunk - 1) / q.chunk;
  q.ctas = B * q.chunks_per_item;
  q.sums = 2LL * B * q.tiles * C;
  q.dzf = 2LL * B * pad * C;
  q.slabs = (long long)q.njobs * q.ctas * kM * C;
  return q;
}

template <int C>
cudaError_t launch_stack(DzArgs dz, DxArgs dx, WArgs w, const Plan& q, int B, float* dbd,
                         float* db1, float* dbs, const float* gsum, int gsum_rows,
                         cudaStream_t s) {
  using G = Geo<C>;
  const size_t P = dz.pad, es = dz.xf != nullptr ? 4 : 2, sums = (size_t)kWarps * C * 4;
  // beside the ring: dz's g rows, column sums, window and (whole) its next
  // load; dx's g rows, fold rows, column sums and (whole) two windows
  auto dz_other = [&](bool whole) {
    const size_t rows = whole ? kM + 2 * P : kM;
    return (size_t)kM * G::kRowB + sums + rows * G::kRowB + (whole ? rows * C * es : 0) + 4 * C;
  };
  auto dx_other = [&](bool whole) {
    return 2 * (size_t)kM * G::kRowB + (size_t)kM * C / 8 + sums +
           (whole ? 2 * (kM + 2 * P) : kM) * G::kRowB;
  };
  // whole windows where they fit beside two stages of the ring, else one
  // tap's rows at a time
  dz.whole = G::stages(dz_other(true), dz.K + 1) >= 2;
  dx.whole = G::stages(dx_other(true), dx.K + 1) >= 2;
  dz.stages = G::stages(dz_other(dz.whole), dz.K + 1);
  dx.stages = G::stages(dx_other(dx.whole), dx.K + 1);
  if (dz.stages < 2 || dx.stages < 2) return cudaErrorInvalidValue;
  const size_t dz_smem = dz_other(dz.whole) + (size_t)dz.stages * (G::kTileB + 16);
  const size_t dx_smem = dx_other(dx.whole) + (size_t)dx.stages * (G::kTileB + 16);
  int win_b = 0;
  for (int j = 0; j < w.njobs; ++j) {
    const int b = w.job[j].nwin * w.job[j].win_rows * G::kRowB;
    win_b = b > win_b ? b : win_b;
  }
  w.stage_b = (kWS * C * 2 + win_b + 127) / 128 * 128;
  const size_t w_smem = (size_t)kWStages * w.stage_b;
  cudaError_t e = set_smem(dz_bf16_kernel<C>, dz_smem);
  if (e == cudaSuccess) e = set_smem(dx_bf16_kernel<C>, dx_smem);
  if (e == cudaSuccess) e = set_smem(wgrad_bf16_kernel<C>, w_smem);
  if (e != cudaSuccess) return e;
  dz_bf16_kernel<C><<<persistent_grid(dz_bf16_kernel<C>, dz_smem, dz.ntiles), kThreads, dz_smem,
                      s>>>(dz);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_bf16_kernel<C><<<dim3(w.njobs, q.chunks_per_item, B), kThreads, w_smem, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_reduce_bf16_kernel<<<dim3((kM * C + 255) / 256, w.njobs), 256, 0, s>>>(w, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  colsum_kernel<<<(C + 31) / 32, 1024, 0, s>>>(dz.dzsum, B * q.tiles, C, dbd, nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  colsum_kernel<<<(C + 31) / 32, 1024, 0, s>>>(gsum != nullptr ? gsum : dz.gsum,
                                               gsum != nullptr ? gsum_rows : B * q.tiles, C,
                                               db1, dbs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dx_bf16_kernel<C><<<persistent_grid(dx_bf16_kernel<C>, dx_smem, dx.ntiles), kThreads, dx_smem,
                      s>>>(dx);
  return cudaGetLastError();
}

size_t out_smem(int C, int K) {
  const int P = (K - 1) / 2, ngroups = kOThreads / C;
  return sizeof(float4) * (o_rows(C) + 2 * P) +
         sizeof(float) * (size_t)ngroups * (K * C * kOMaxCout + kOMaxCout + C);
}

long long outconv_part_floats(int B, int T, int C, int Cout, int K) {
  if (Cout < 1 || Cout > kOMaxCout || bad_args(B, T, C, K, 0, kZero)) return -1;
  return (long long)B * ((T + o_rows(C) - 1) / o_rows(C)) * (K * C * Cout + Cout);
}

template <int K>
cudaError_t launch_outconv(const OutArgs& p, int B, float* dw, float* db, cudaStream_t s) {
  const size_t smem = out_smem(p.C, K);
  cudaError_t e = set_smem(outconv_bwd_bf16_kernel<K>, smem);
  if (e != cudaSuccess) return e;
  outconv_bwd_bf16_kernel<K><<<dim3(p.ctas_per_item, B), kOThreads, smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nw = K * p.C * p.Cout;
  slab_sum_kernel<<<(p.slab + 255) / 256, 256, 0, s>>>(p.part, B * p.ctas_per_item, p.slab, nw,
                                                        dw, db);
  return cudaGetLastError();
}

}  // namespace

#ifdef MELBF_CLOCKS
// The phase cycles this source's kernels stamped (melgan_bf16.cuh), copied
// to out (kClockSlots x kClockBlocks x kClockPhases), then zeroed.
extern "C" int melgan_stack_bwd_bf16_clocks(void* out) {
  const size_t bytes = sizeof(melbf_clocks);
  void* dev = nullptr;
  cudaError_t e = cudaMemcpyFromSymbol(out, melbf_clocks, bytes);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, melbf_clocks);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, bytes);
  return e;
}
#endif

extern "C" {

// Floats of scratch (part) that melgan_stack_bwd_bf16 needs for a shape, or
// -1 when the shape is refused or the count does not fit an int.
int melgan_stack_bwd_bf16_part_floats(int B, int T, int C, int K, int dil) {
  if (dil < 1 || bad_args(B, T, C, K, 0, kZero)) return -1;
  const Plan q = plan_of(B, T, C, K, dil);
  const long long n = q.sums + q.dzf + q.slabs;
  return n > 2147483647LL ? -1 : (int)n;
}

// Rows of the column sums per tile that the bf16 backward's kernels write
// for a (B, T, C) cotangent they form: the stacks' (outconv 0), or the final
// conv's (outconv 1).
int melgan_bf16_sum_rows(int B, int T, int C, int outconv) {
  if (B < 1 || T < 1 || C < 4) return -1;
  return B * (outconv ? (T + o_rows(C) - 1) / o_rows(C) : (T + kM - 1) / kM);
}

// The backward of one ResidualStack in the JAX kernel's bf16-resident mode
// (the top of this file). x the stack's input, bf16 where x_bf16 is set
// (the stage's input; its LeakyReLU then multiplies by slope_x), else
// float32 (the chain K6's re-run wrote); g the cotangent of its output,
// bf16, with gsum (gsum_rows, C) the column sums of its unrounded rows, or
// gsum null where g is the stage's dy (its values are then summed here);
// wf the stack's K + 2 tiles (ops/kernels/mma_bf16.py stack_wgmma, as K6
// reads them); bd the forward's dilated-conv bias (zeros without bias).
// Writes dx (bf16, aliasing neither x nor g) and, where dxsum is set, its
// column sums per tile ((melgan_bf16_sum_rows, C) floats), and every weight
// and bias gradient in float32; dz, h, xl and xb (B, T, C) bf16 (xb unused
// where x_bf16 is set), xs (B, T rounded up to 128, C / 8) bytes and part
// (part_floats floats, at least melgan_stack_bwd_bf16_part_floats) are
// scratch. C a multiple of 16 up to
// 128, K odd up to 7; reflect padding needs P = (K-1)/2 * dil below T; every
// pointer 16-byte aligned. Returns a cudaError_t value: 0 when every launch
// was accepted.
int melgan_stack_bwd_bf16(const void* x, const void* g, const float* gsum, int gsum_rows,
                          void* dx, float* dxsum, void* dz, void* h, void* xl, void* xb,
                          void* xs, float* part, long long part_floats, const void* wf, const float* bd,
                          float* dwd, float* dbd, float* dw1, float* db1, float* dws, float* dbs,
                          int B, int T, int C, int K, int dil, int mode, float slope,
                          float slope_x, int x_bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int pad = (K - 1) / 2 * dil;
  if (dil < 1 || bad_args(B, T, C, K, pad, mode)) return cudaErrorInvalidValue;
  const Plan q = plan_of(B, T, C, K, dil);
  if (part_floats < q.sums + q.dzf + q.slabs || (gsum != nullptr && gsum_rows < 1) ||
      (long long)q.tiles * B > 2147483647LL)
    return cudaErrorInvalidValue;
  const float* xf = x_bf16 ? nullptr : static_cast<const float*>(x);
  const uint16_t* xh = x_bf16 ? static_cast<const uint16_t*>(x) : nullptr;
  const uint16_t* gh = static_cast<const uint16_t*>(g);
  const uint16_t* w16 = static_cast<const uint16_t*>(wf);
  // bf16(x): the stage's bf16 input as it is, else written by dz_bf16_kernel
  uint16_t* xb16 = x_bf16 ? nullptr : static_cast<uint16_t*>(xb);
  float* dzsum = part;
  float* gsum_here = part + q.sums / 2;
  float* dzf = part + q.sums;
  const int ntiles = q.tiles * B;
  DzArgs dzp{xf, xh, gh, w16, bd, static_cast<uint16_t*>(h), static_cast<uint16_t*>(dz), dzf,
             dzsum, gsum != nullptr ? nullptr : gsum_here, static_cast<uint16_t*>(xl), xb16,
             static_cast<uint8_t*>(xs), T, K, dil, pad, mode, 1, 1, q.tiles, ntiles, slope,
             slope_x};
  DxArgs dxp{static_cast<const uint16_t*>(dz), dzf, gh, static_cast<const uint8_t*>(xs), w16,
             static_cast<uint16_t*>(dx), dxsum, T, K, dil, pad, mode, 1, 1, q.tiles, ntiles,
             slope};
  WArgs w{};
  w.xl = static_cast<const uint16_t*>(xl);
  w.xb = x_bf16 ? xh : xb16;
  w.h = static_cast<const uint16_t*>(h);
  w.part = part + q.sums + q.dzf;
  w.njobs = jobs_of(C, K, w.job, dil, pad);
  w.T = T;
  w.pad = pad;
  w.mode = mode;
  w.chunk = q.chunk;
  w.chunks_per_item = q.chunks_per_item;
  w.ctas = q.ctas;
  for (int j = 0; j < w.njobs; ++j) {
    WJob& jb = w.job[j];
    const bool taps = jb.taps;
    jb.cot = taps ? static_cast<const uint16_t*>(dz) : gh;
    for (int s = 0; s < jb.nseg; ++s)
      jb.dw[s] = taps ? dwd + (size_t)s * C * C : s == 0 ? dw1 : dws;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_stack<16>(dzp, dxp, w, q, B, dbd, db1, dbs, gsum, gsum_rows, s);
    case 32: return launch_stack<32>(dzp, dxp, w, q, B, dbd, db1, dbs, gsum, gsum_rows, s);
    case 48: return launch_stack<48>(dzp, dxp, w, q, B, dbd, db1, dbs, gsum, gsum_rows, s);
    case 64: return launch_stack<64>(dzp, dxp, w, q, B, dbd, db1, dbs, gsum, gsum_rows, s);
    case 80: return launch_stack<80>(dzp, dxp, w, q, B, dbd, db1, dbs, gsum, gsum_rows, s);
    case 96: return launch_stack<96>(dzp, dxp, w, q, B, dbd, db1, dbs, gsum, gsum_rows, s);
    case 112: return launch_stack<112>(dzp, dxp, w, q, B, dbd, db1, dbs, gsum, gsum_rows, s);
    default: return launch_stack<128>(dzp, dxp, w, q, B, dbd, db1, dbs, gsum, gsum_rows, s);
  }
}

// Floats of scratch that melgan_outconv_bwd_bf16 needs for a shape, or -1.
int melgan_outconv_bwd_bf16_part_floats(int B, int T, int C, int Cout, int K) {
  const long long n = outconv_part_floats(B, T, C, Cout, K);
  return n > 2147483647LL ? -1 : (int)n;
}

// The backward of the trailing leaky -> K-tap conv (C -> Cout) -> tanh in
// the bf16-resident mode: x its input and y its output (float32, K6's
// re-run), dy the cotangent of y (bf16), w (K, C, Cout) holding bf16
// values (rounded by the caller). Writes g = dx (bf16, the last stack's
// cotangent) and gsum ((melgan_bf16_sum_rows with outconv 1, C) floats,
// its column sums per block), and the float32 gradients of w and b; part
// (part_floats floats) is scratch. Cout 1 .. 4, K odd up to 7. Returns a
// cudaError_t value.
int melgan_outconv_bwd_bf16(const float* x, const float* y, const void* dy, void* g,
                            float* gsum, float* part, const float* w, float* dw, float* db,
                            long long part_floats, int B, int T, int C, int Cout, int K,
                            int mode, float slope, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (Cout < 1 || Cout > kOMaxCout || bad_args(B, T, C, K, (K - 1) / 2, mode) ||
      part_floats < outconv_part_floats(B, T, C, Cout, K))
    return cudaErrorInvalidValue;
  const int rows = o_rows(C);
  const OutArgs p{x, y, static_cast<const uint16_t*>(dy), w, static_cast<uint16_t*>(g), gsum,
                  part, T, C, Cout, mode, (T + rows - 1) / rows, K * C * Cout + Cout, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_outconv<1>(p, B, dw, db, s);
    case 3: return launch_outconv<3>(p, B, dw, db, s);
    case 5: return launch_outconv<5>(p, B, dw, db, s);
    default: return launch_outconv<7>(p, B, dw, db, s);
  }
}


}  // extern "C"
