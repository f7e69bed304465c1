// The bf16-resident mode of the fused MelGAN residual stacks (K6) for
// Hopper (sm_90a): both products of a stack on the warpgroup products
// (wgmma), the weights brought in by the tensor memory accelerator (TMA),
// the operand rows kept in shared memory as bf16.
//
// Replaces, in the bf16-resident mode (mxu_bf16, turned on by a bf16 input
// at melgan_stack.py:302-326), the Pallas TPU kernel of the JAX package
//   parallelwavegan_tpu/ops/pallas_kernels/melgan_stack.py:285
//     fused_melgan_stacks_interior (body _kernel_stacks :109)
// The function is csrc/melgan_stack.cu's (one launch a ResidualStack: z =
// sum_k leaky(x_pad[t + (k - (K-1)/2) d]) . Wd[k] + bd, out = [leaky(z) |
// x] . [W1; Ws] + b1 + bs, the padding reflect, replicate or zeros) with
// JAX's bf16 roundings: every product's A operand (the padded leaky(x),
// leaky(z + bd), x) and the weights rounded to bf16 to nearest even, each
// product summed in float32; z, the stack's sum and the chain between a
// stage's stacks float32; the stage's input and output bf16 in device
// memory. On the stage's bf16 input LeakyReLU multiplies by slope_x =
// bf16(slope), as JAX's _leaky multiplies in x's type. The plain version is
// ops/kernels/melgan_stack.py stacks_forward_bf16. melgan_outconv_bf16, the
// generator's trailing act -> conv -> tanh, stays on the CUDA cores. Built
// with every source by ops/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a: wgmma needs the "a"); on the CPU the
// wrapper runs the plain version, and
// tests/test_torch_port_melgan_bf16_layout.py emulates this file's layouts
// and arithmetic; on the card chip_smoke.py phase 25 and
// tests/test_torch_port_cuda.py -m gpu -k bf16 run it.
//
// What bounds it on the card. A stack does (K + 2) C^2 multiply-adds a row
// against its input and output rows (2 to 4 bytes a value each way): at
// MelGAN v1's training forward (B = 8, stages 1-3) 44.1 GFLOP, 0.045 ms at
// 989 TFLOP/s, against 67 MB of bf16 activations and weights (0.020 ms);
// the float32 chain between stacks, which the JAX kernel keeps in VMEM and
// K7's re-run reads, moves 8 bytes a value a stack more (PERF.md §6).
//
// The design (csrc/melgan_bf16.cuh, the engine K7 shares): persistent
// blocks of two warpgroups, each over 128-row tiles of a batch item in turn.
//  - The window of the tile's rows and their 2P halo (P = (K-1)/2 d) is
//    loaded by cp.async while the tile before runs its products, the pad
//    mode's source rows by the copy's row, and formed once it has landed
//    into bf16 operand rows bf16(leaky(x)), its own rows once more into
//    bf16(x), the skip's operand. A window that would not fit beside the
//    ring is staged one tap at a time by plain loads.
//  - Each tap is C / 16 wgmma.m64nCk16 (A by ldmatrix at the tap's row
//    shift k d, B the tap's tile), retired and added into float32 totals.
//    z + bd and LeakyReLU run on the totals in registers, rounded once into
//    shared memory over the window, and [leaky(z) | x] . [W1; Ws] is two
//    more products, each retired, summed as JAX sums them: (leaky(z) . W1 +
//    b1) + (x . Ws + bs). The tile's output goes out through shared
//    memory, a warp's stores one contiguous run of a row.
//  - The weights are laid out once per forward (layout_kernel; its plain
//    version ops/kernels/mma_bf16.py stack_wgmma: one 2 C^2-byte tile per
//    matrix, Wd[0..K-1], W1, Ws), read as B = W through an MN-major
//    no-swizzle descriptor (K7 reads the same tiles as W^T), and brought by
//    the bulk copy into a ring: all K + 2 tiles for good where they fit
//    beside the rows (C <= 96 at MB-MelGAN v2's P = 27), else two stages.
//  - One block an SM from C = 64 (C = 128: 172 registers), two below.
// Blocks share nothing, and every sum is taken in a fixed order: two runs
// give the same bits.

#include "melgan_bf16.cuh"

namespace {

using namespace melbf;

constexpr int kOutRows = 128;  // rows per outconv_kernel block, one a thread

struct FwdArgs {
  const float* xf;     // the stack's input (B, T, C): float32 (the chain) ...
  const uint16_t* xh;  // ... or bf16 (the stage's input); the other null
  float* outf;         // its output: float32 (the chain) ...
  uint16_t* outh;      // ... or bf16 (the stage's output); the other null
  const uint16_t* w;   // K + 2 tiles: Wd[0 .. K-1], W1, Ws
  const float* bias;   // (3, C): bd, b1, bs
  int T, K, dil, pad, mode;
  int whole;           // the window fits: prefetched, every tap's rows at once
  int stages, tiles, ntiles;  // the ring; row tiles of an item, of the launch
  float slope, slope_x;  // z's LeakyReLU slope; x's
};

// One ResidualStack over row tiles blockIdx.x, + gridDim.x, .. of kM rows
// (tile i: batch item i / tiles, rows from (i % tiles) kM).
template <int C>
__global__ void __launch_bounds__(kThreads, Geo<C>::kMinBlocks)
    stack_bf16_kernel(__grid_constant__ const FwdArgs p) {
  using G = Geo<C>;
  constexpr int kLd = G::kLd;
  extern __shared__ __align__(128) uint8_t smem[];
  const int T = p.T, d = p.dil, P = p.pad, K = p.K;
  const int rows_win = p.whole ? kM + 2 * P : kM;
  uint16_t* skip = reinterpret_cast<uint16_t*>(smem + (size_t)p.stages * G::kTileB);  // bf16(x)
  uint16_t* win = skip + kM * kLd;  // the window, then leaky(z + bd)
  uint8_t* raw = reinterpret_cast<uint8_t*>(win + (size_t)rows_win * kLd);  // the next window
  const bool f32 = p.xf != nullptr;
  const size_t raw_b = p.whole ? (size_t)rows_win * C * (f32 ? 4 : 2) : 0;
  // the biases, read from shared memory in the tile loop (from the
  // parameter space the compiler hoists them out of it, into registers)
  float* bias = reinterpret_cast<float*>(raw + raw_b);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias + 3 * C);
  for (int e = threadIdx.x; e < 3 * C; e += kThreads) bias[e] = p.bias[e];
  const int nper = K + 2, mine = (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const Ring ring{smem, full, full + p.stages, p.w, p.stages, G::kTileB, mine * nper, nper, K,
                  K, K + 1};
  ring.start();
  auto item = [&](int tile, int& t0) {
    t0 = (tile % p.tiles) * kM;
    return (size_t)(tile / p.tiles) * T * C;
  };
  auto prefetch = [&](int tile) {
    int t0;
    const size_t io = item(tile, t0);
    prefetch_raw<C>(raw, f32 ? p.xf + io : nullptr, f32 ? nullptr : p.xh + io, t0 - P, rows_win,
                    T, P, p.mode);
  };
  if (p.whole && mine > 0) prefetch(blockIdx.x);
  tf32x3::cp_async_commit();
  MELBF_CLOCK_START(0);

  for (int it = 0, tile = blockIdx.x; tile < p.ntiles; ++it, tile += gridDim.x) {
    int t0;
    const size_t io = item(tile, t0);
    const float* xf = f32 ? p.xf + io : nullptr;
    const uint16_t* xh = f32 ? nullptr : p.xh + io;
    float acc[C / 2], tot[C / 2];
    const int u0 = it * nper;  // this tile's first use of the ring
    if (p.whole) {
      tf32x3::cp_async_wait<0>();
      __syncthreads();  // the window has landed; the tile before is done with win and skip
      MELBF_STAMP(0);
      convert_raw<C>(win, kLd, skip, raw, f32, t0 - P, rows_win, P, T, p.slope_x, nullptr,
                     nullptr);
      __syncthreads();  // raw is free: the next tile's window loads during this one's products
      if (tile + gridDim.x < p.ntiles) prefetch(tile + gridDim.x);
      tf32x3::cp_async_commit();
      MELBF_STAMP(1);
      for (int k = 0; k < K; ++k) {
        tile_product<C, false>(acc, win + k * d * kLd, kLd, ring.wait(u0 + k), false);
        ring.hand_back(u0 + k);
#pragma unroll
        for (int e = 0; e < C / 2; ++e) tot[e] = k == 0 ? acc[e] : tot[e] + acc[e];
      }
    } else {  // one tap's rows at a time
      __syncthreads();  // the tile before is done with skip
      stage_x<C>(skip, kLd, xf, xh, t0, kM, T, 0, kZero, false, 0.f);
      for (int k = 0; k < K; ++k) {
        stage_x<C>(win, kLd, xf, xh, t0 + k * d - P, kM, T, P, p.mode, true, p.slope_x);
        __syncthreads();
        tile_product<C, false>(acc, win, kLd, ring.wait(u0 + k), false);
        ring.hand_back(u0 + k);
#pragma unroll
        for (int e = 0; e < C / 2; ++e) tot[e] = k == 0 ? acc[e] : tot[e] + acc[e];
        if (k < K - 1) __syncthreads();  // every warp's products have read the window
      }
    }
    MELBF_STAMP(2);
    __syncthreads();  // every warp's products have read the window
    // leaky(z + bd), rounded once, over the window's first rows
    for_each_pair<C>([&](int e, int r, int col) {
      st_bf16x2(win + r * kLd + col, leaky(tot[e] + bias[col], p.slope),
                leaky(tot[e + 1] + bias[col + 1], p.slope));
    });
    __syncthreads();
    MELBF_STAMP(3);
    // (leaky(z) . W1 + b1) + (x . Ws + bs), JAX's order of the sums
    tile_product<C, false>(acc, win, kLd, ring.wait(u0 + K), false);
    ring.hand_back(u0 + K);
    for_each_pair<C>([&](int e, int, int col) {
      tot[e] = acc[e] + bias[C + col];
      tot[e + 1] = acc[e + 1] + bias[C + col + 1];
    });
    tile_product<C, false>(acc, skip, kLd, ring.wait(u0 + K + 1), false);
    ring.hand_back(u0 + K + 1);
    for_each_pair<C>([&](int e, int, int col) {
      tot[e] += acc[e] + bias[2 * C + col];
      tot[e + 1] += acc[e + 1] + bias[2 * C + col + 1];
    });
    MELBF_STAMP(4);
    __syncthreads();  // every warp's products have read skip and the window
    if (p.outh != nullptr)  // through skip and the window's rows, coalesced
      store_rows<C, true>(tot, skip, p.outh + io, t0, T);
    else
      store_rows<C, false>(tot, skip, p.outf + io, t0, T);
    MELBF_STAMP(5);
  }
}

// y = tanh(conv(bf16(leaky(x_pad))) + bias), the bf16 mode of
// csrc/melgan_stack.cu's outconv_kernel: w (K, C, cout) in gather form
// holding bf16 values (rounded by the caller), C a multiple of 4, x the
// float32 chain; one output row per thread, four outputs' sums side by
// side (groups of four in turn); the weights as one float4 per (group,
// tap, channel), read by every thread at once. The block's rows and halo
// are staged with leaky applied and rounded to bf16, C + 1 floats apart
// (thread i reads row i + k). y is written as bf16 where yh is set, else
// float32 (what K7's re-run reads).
__global__ void __launch_bounds__(kOutRows) outconv_bf16_kernel(
    const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ bias, int T, int C, int cout, int K, int mode, float slope,
    uint16_t* __restrict__ yh) {
  extern __shared__ float4 smem4[];
  const int kc = K * C, groups = (cout + 3) / 4;
  float4* w_s = smem4;                                       // groups x K C
  float* x_s = reinterpret_cast<float*>(w_s + groups * kc);  // (kOutRows + K - 1) x (C + 1)
  const int S = C + 1, pad = (K - 1) / 2, q4 = C / 4;
  const int b = blockIdx.y, t0 = blockIdx.x * kOutRows;
  for (int e = threadIdx.x; e < groups * kc; e += kOutRows) {
    const int g = e / kc, i = e % kc;
    float v[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) v[o] = 4 * g + o < cout ? w[(size_t)i * cout + 4 * g + o] : 0.f;
    w_s[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
  const float* xb = x + (size_t)b * T * C;
  const int rows = kOutRows + K - 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * q4; e += kOutRows) {
    const int rr = e / q4, c4 = (e % q4) * 4;
    const int src = pad_row(t0 - pad + rr, T, pad, mode);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0) v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)src * C + c4));
    float* d = x_s + rr * S + c4;
    d[0] = bf16mma::to_bf16(leaky(v.x, slope));
    d[1] = bf16mma::to_bf16(leaky(v.y, slope));
    d[2] = bf16mma::to_bf16(leaky(v.z, slope));
    d[3] = bf16mma::to_bf16(leaky(v.w, slope));
  }
  __syncthreads();

  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  for (int g = 0; g < groups; ++g) {
    float acc[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[o] = 4 * g + o < cout ? bias[4 * g + o] : 0.f;
    for (int k = 0; k < K; ++k) {
      const float* xr = x_s + (threadIdx.x + k) * S;
      const float4* wk = w_s + g * kc + k * C;
#pragma unroll 8
      for (int ci = 0; ci < C; ++ci) {
        const float xv = xr[ci];
        const float4 wv = wk[ci];
        acc[0] = fmaf(xv, wv.x, acc[0]);
        acc[1] = fmaf(xv, wv.y, acc[1]);
        acc[2] = fmaf(xv, wv.z, acc[2]);
        acc[3] = fmaf(xv, wv.w, acc[3]);
      }
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (4 * g + o >= cout) continue;
      const size_t i = ((size_t)b * T + t) * cout + 4 * g + o;
      if (yh != nullptr)
        yh[i] = __bfloat16_as_ushort(__float2bfloat16_rn(tanhf(acc[o])));
      else
        y[i] = tanhf(acc[o]);
    }
  }
}

template <int C>
int launch_stack(FwdArgs p, int B, cudaStream_t stream) {
  using G = Geo<C>;
  const int es = p.xf != nullptr ? 4 : 2;
  auto other = [&](bool whole) {  // the rows: skip, the window and (whole) its next load
    const size_t rows = whole ? kM + 2 * (size_t)p.pad : kM;
    return (size_t)kM * G::kRowB + rows * G::kRowB + (whole ? rows * C * es : 0) + 12 * C;
  };
  // the window prefetched whole where it fits beside two stages of the
  // ring, else one tap's rows at a time
  p.whole = G::stages(other(true), p.K + 2) >= 2;
  p.stages = G::stages(other(p.whole), p.K + 2);
  if (p.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = other(p.whole) + (size_t)p.stages * G::kTileB + 16 * (size_t)p.stages;
  cudaError_t e = set_smem(stack_bf16_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  p.tiles = (p.T + kM - 1) / kM;
  if ((long long)p.tiles * B > 2147483647LL) return cudaErrorInvalidValue;
  p.ntiles = p.tiles * B;
  const int grid = persistent_grid(stack_bf16_kernel<C>, smem, p.ntiles);
  stack_bf16_kernel<C><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The weights' layout (what the stack kernels read)
// ---------------------------------------------------------------------------

constexpr int kLayoutThreads = 256;
constexpr int kLayoutStacks = 16;  // stacks of one layout_kernel launch

struct LayoutArgs {
  const void* w[kLayoutStacks][3];  // wd (K, C, C), w1, ws (C, C)
  const void* b[kLayoutStacks][3];  // bd, b1, bs (C), or null for zeros
  int k[kLayoutStacks];
  long long off[kLayoutStacks];  // tiles' elements before the stack's
  uint16_t* tiles;
  float* biases;  // (stacks, 3, C)
  int C, w_bf16, b_bf16;  // whether the weights, the biases are bf16 (else float32)
};

__device__ __forceinline__ float value_at(const void* p, size_t i, int bf16) {
  return bf16 ? bf16mma::widen(static_cast<const uint16_t*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Stack blockIdx.y's K + 2 matrices Wd[k], W1, Ws rounded to bf16 into
// their tiles (ops/kernels/mma_bf16.py stack_wgmma, the plain version: 16
// bytes of the tile, a core matrix's row, hold W[8 i + r][8 j .. 8 j + 7] at
// ((i C / 8 + j) 8 + r) 16 bytes), one such row a thread; and its three
// biases as one float32 (3, C) row, zeros for a missing one.
__global__ void __launch_bounds__(kLayoutThreads) layout_kernel(LayoutArgs a) {
  const int st = blockIdx.y, C = a.C, K = a.k[st];
  const int e = blockIdx.x * kLayoutThreads + threadIdx.x;
  if (e < 3 * C) {
    const void* src = a.b[st][e / C];
    a.biases[(size_t)st * 3 * C + e] = src != nullptr ? value_at(src, e % C, a.b_bf16) : 0.f;
  }
  const int per_tile = C * C / 8;  // 16-byte rows of a tile
  if (e >= (K + 2) * per_tile) return;
  const int m = e / per_tile, q = e % per_tile, r = q % 8, core = q / 8;
  const int ci = 8 * (core / (C / 8)) + r, co = 8 * (core % (C / 8));
  const void* w = m < K ? a.w[st][0] : a.w[st][m - K + 1];
  const size_t base = (m < K ? (size_t)m * C * C : 0) + (size_t)ci * C + co;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = value_at(w, base + j, a.w_bf16);
  *reinterpret_cast<uint4*>(a.tiles + a.off[st] + (size_t)m * C * C + 8 * (size_t)q) =
      make_uint4(bf16mma::pack(v[0], v[1]), bf16mma::pack(v[2], v[3]), bf16mma::pack(v[4], v[5]),
                 bf16mma::pack(v[6], v[7]));
}

bool bad_args(int B, int T, int K, int mode) {
  return B < 1 || B > 65535 || T < 1 || K < 1 || K % 2 == 0 || mode < kReflect ||
         mode > kZero;
}

}  // namespace

#ifdef MELBF_CLOCKS
// The phase cycles this source's kernels stamped (melgan_bf16.cuh), copied
// to out (kClockSlots x kClockBlocks x kClockPhases), then zeroed.
extern "C" int melgan_stack_bf16_clocks(void* out) {
  const size_t bytes = sizeof(melbf_clocks);
  void* dev = nullptr;
  cudaError_t e = cudaMemcpyFromSymbol(out, melbf_clocks, bytes);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, melbf_clocks);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, bytes);
  return e;
}
#endif

// Each entry point returns a cudaError_t value: 0 when the launch was
// accepted. mode: 0 reflect, 1 replicate, 2 zeros; reflect needs the pad
// ((K-1)/2 * dil) below T.
extern "C" {

// One ResidualStack in the JAX kernel's bf16-resident mode (the top of this
// file). x is bf16 where x_bf16 is set (the stage's input; its LeakyReLU
// then multiplies by slope_x), else float32 (the chain between stacks); out
// is bf16 where out_bf16 is set (the stage's output), else float32. wf is
// the stack's K + 2 tiles in bf16 (ops/kernels/mma_bf16.py stack_wgmma,
// (K + 2, C * C)); bias the (3, C) float32 biases bd, b1, bs (zeros without
// bias). C a multiple of 16 up to 128; x, out and wf 16-byte aligned.
int melgan_stack_bf16(const void* x, void* out, const void* wf, const float* bias, int B,
                      int T, int C, int K, int dil, int mode, float slope, float slope_x,
                      int x_bf16, int out_bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_args(B, T, K, mode) || dil < 1) return cudaErrorInvalidValue;
  const int pad = (K - 1) / 2 * dil;
  if (mode == kReflect && pad >= T) return cudaErrorInvalidValue;
  FwdArgs p{};
  p.xf = x_bf16 ? nullptr : static_cast<const float*>(x);
  p.xh = x_bf16 ? static_cast<const uint16_t*>(x) : nullptr;
  p.outf = out_bf16 ? nullptr : static_cast<float*>(out);
  p.outh = out_bf16 ? static_cast<uint16_t*>(out) : nullptr;
  p.w = static_cast<const uint16_t*>(wf);
  p.bias = bias;
  p.T = T, p.K = K, p.dil = dil, p.pad = pad, p.mode = mode;
  p.slope = slope, p.slope_x = slope_x;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_stack<16>(p, B, s);
    case 32: return launch_stack<32>(p, B, s);
    case 48: return launch_stack<48>(p, B, s);
    case 64: return launch_stack<64>(p, B, s);
    case 80: return launch_stack<80>(p, B, s);
    case 96: return launch_stack<96>(p, B, s);
    case 112: return launch_stack<112>(p, B, s);
    case 128: return launch_stack<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The generator's trailing leaky -> K-tap conv (C -> Cout) -> tanh in the
// bf16-resident mode: leaky(x) rounded to bf16 (x is the float32 chain), w
// holding bf16 values (rounded by the caller), float32 sums; y bf16 where
// y_bf16 is set, else float32 (what K7's re-run reads: 1 - y^2 on the
// unrounded tanh, as the JAX backward recomputes it). C a multiple of 4; x
// 16-byte aligned.
int melgan_outconv_bf16(const float* x, void* y, const float* w, const float* bias, int B,
                        int T, int C, int Cout, int K, int mode, float slope, int y_bf16,
                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_args(B, T, K, mode) || C < 4 || C % 4 != 0 || Cout < 1) return cudaErrorInvalidValue;
  if (mode == kReflect && (K - 1) / 2 >= T) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float4) * ((Cout + 3) / 4) * K * C +
                      sizeof(float) * (kOutRows + K - 1) * (C + 1);
  e = set_smem(outconv_bf16_kernel, smem);
  if (e != cudaSuccess) return e;
  outconv_bf16_kernel<<<dim3((T + kOutRows - 1) / kOutRows, B), kOutRows, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, y_bf16 ? nullptr : static_cast<float*>(y), w, bias, T, C, Cout, K, mode, slope,
      y_bf16 ? static_cast<uint16_t*>(y) : nullptr);
  return cudaGetLastError();
}

// What the stack kernels read of n ResidualStacks of width C (a multiple of
// 16 up to 128): their tiles one stack after another at tiles
// (stack_wgmma's (K + 2, C * C) bf16 each), and their biases packed at
// biases, (n, 3, C) float32. w holds 6 pointers a stack: wd (k[i], C, C),
// w1 and ws (C, C) contiguous, bf16 where w_bf16 is set, else float32; then
// bd, b1, bs (C), bf16 where b_bf16 is set, else float32, or null. One
// launch per 16 stacks.
int melgan_stack_tiles_bf16(int n, const void* const* w, const int* k, void* tiles,
                            float* biases, int C, int w_bf16, int b_bf16, int device,
                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n < 0 || C < 16 || C > 128 || C % 16 != 0) return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i)
    if (k[i] < 1) return cudaErrorInvalidValue;
  long long off = 0;  // the tiles' elements before a stack's
  for (int g = 0; g < n; g += kLayoutStacks) {
    LayoutArgs a{};
    const int m = n - g < kLayoutStacks ? n - g : kLayoutStacks;
    int most = 3 * C;  // threads of one stack: its 16-byte rows, and its biases
    for (int j = 0; j < m; ++j) {
      const void* const* p = w + 6 * (g + j);
      for (int q = 0; q < 3; ++q) {
        a.w[j][q] = p[q];
        a.b[j][q] = p[3 + q];
      }
      a.k[j] = k[g + j];
      a.off[j] = off;
      off += (long long)(k[g + j] + 2) * C * C;
      const int rows = (k[g + j] + 2) * C * C / 8;
      most = rows > most ? rows : most;
    }
    a.tiles = static_cast<uint16_t*>(tiles);
    a.biases = biases + (size_t)g * 3 * C;
    a.C = C;
    a.w_bf16 = w_bf16;
    a.b_bf16 = b_bf16;
    layout_kernel<<<dim3((most + kLayoutThreads - 1) / kLayoutThreads, m), kLayoutThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}


}  // extern "C"
