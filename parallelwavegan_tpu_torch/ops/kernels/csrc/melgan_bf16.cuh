// The row-product engine that the bf16-resident MelGAN stack kernels share
// (K6's csrc/melgan_stack_bf16.cu and K7's csrc/melgan_stack_bwd_bf16.cu),
// on Hopper's warpgroup products (sm_90a).
//
// A row-product block is two warpgroups (256 threads) over a tile of kM =
// 128 rows of one batch item, 64 a warpgroup (wgmma's m64). Its operand
// rows sit in shared memory as bf16, (C + 8) * 2 bytes apart (an odd
// multiple of 16 bytes at every C = 16 .. 128, so that ldmatrix reads 8
// rows without a bank conflict), each rounded once where it is formed. A
// product of depth C is C / 16 wgmma.m64nCk16 with A from ldmatrix at the
// tap's row shift and B a C x C weight tile in shared memory; N = C is cut
// into wgmma widths of 128, 64, 32 and 16 (mma_cols). A tap's products are
// one group, retired before the next tap's are issued and added into
// float32 totals by the caller: the tensor cores truncate each
// accumulation (csrc/tade_bf16.cu's note).
//
// Weight tiles (ops/kernels/mma_bf16.py stack_wgmma): a C x C matrix W
// (gather form, [ci][co]) is cut into 8 x 8 core matrices of 128
// contiguous bytes, core (i, j) = W[8 i .. 8 i + 7][8 j .. 8 j + 7] at (i *
// C / 8 + j) * 128 bytes, its row r (ci = 8 i + r) 16 bytes at 16 r. The
// same tile is B = W (k = ci, n = co) through an MN-major descriptor, and
// B = W^T (k = co, n = ci) through a K-major one: no swizzle, the next core
// along ci 16 C bytes on, along co 128 bytes on (TileB). The tensor memory
// accelerator's bulk copy brings each tile (2 C^2 bytes) into a ring of
// stages with "full" and "empty" mbarriers, thread 0 issuing the copies, or
// once for all of a block's row tiles where they all fit (Ring).
//
// A launch is persistent: as many blocks as fit on the card, each taking
// row tiles blockIdx.x, + gridDim.x, .. in turn. Where a tile's window of
// rows and halo fits beside the ring, the next tile's rows are loaded by
// cp.async (prefetch_raw) while this one's products run, and formed into
// operand rows once they have landed (convert_raw); a window that does not
// fit is staged one tap at a time by plain loads (stage_x).
//
// Everything here has internal linkage: each source that includes it gets
// its own copy.

#pragma once

#include <mutex>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {
namespace melbf {

enum PadMode { kReflect = 0, kEdge = 1, kZero = 2 };

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kM = 128;        // rows of a row-product tile, 64 a warpgroup
constexpr int kMaxK = 7;
constexpr size_t kMaxSmem = 227 * 1024;

// The no-swizzle descriptors' offset fields (ops/kernels/probe_melgan_bf16.py,
// measured on the card): in both majors the leading byte offset is the step
// to the next core matrix along K and the stride byte offset along N.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr, uint32_t k_step, uint32_t n_step) {
  return wgmma::desc_inter(addr, k_step, n_step);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// 1 at v >= 0, as the JAX kernels' _dleaky
__device__ __forceinline__ float dleaky(float v, float slope) {
  return v >= 0.f ? 1.f : slope;
}

__device__ __forceinline__ void st_bf16x2(uint16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16mma::pack(a, b);
}

// bit j set where v[j] < 0 (leaky'(v) = slope; 1 at v >= 0)
__device__ __forceinline__ uint8_t signs(const float (&v)[8]) {
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s |= (v[j] < 0.f ? 1u : 0u) << j;
  return (uint8_t)s;
}

// The row of x that padded position p reads, or -1 for a zero row: a
// position more than `pad` outside [0, T) reads zeros (csrc/melgan_stack.cu
// pad_row).
__device__ __forceinline__ int pad_row(int p, int T, int pad, int mode) {
  if (p >= 0 && p < T) return p;
  if (p < -pad || p >= T + pad || mode == kZero) return -1;
  if (mode == kReflect) return p < 0 ? -p : 2 * T - 2 - p;
  return p < 0 ? 0 : T - 1;
}

// Where MELBF_CLOCKS is defined (ops/kernels/probe_melgan_bf16.py compiles
// the sources so), thread 0 of each block adds the clock64 cycles between
// a kernel's stamps into melbf_clocks[slot][block % 1024][phase]: where a
// block's time goes, phase by phase. Otherwise the stamps are nothing.
#ifdef MELBF_CLOCKS
constexpr int kClockSlots = 4, kClockBlocks = 1024, kClockPhases = 8;
__device__ unsigned long long melbf_clocks[kClockSlots][kClockBlocks][kClockPhases];
#define MELBF_CLOCK_START(slot)          \
  const int melbf_slot = (slot);         \
  unsigned long long melbf_t = clock64()
#define MELBF_STAMP(phase)                                                                      \
  do {                                                                                          \
    if (threadIdx.x == 0) {                                                                     \
      const unsigned long long melbf_now = clock64();                                           \
      const int melbf_b = (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) %    \
                          kClockBlocks;                                                         \
      melbf_clocks[melbf_slot][melbf_b][phase] += melbf_now - melbf_t;                          \
      melbf_t = melbf_now;                                                                      \
    }                                                                                           \
  } while (0)
#else
#define MELBF_CLOCK_START(slot)
#define MELBF_STAMP(phase)
#endif

// What the host learnt of a kernel on a device: the dynamic shared memory
// its attribute allows, and its blocks an SM at one size. A call's host
// time was mostly these queries, asked again at every launch.
struct Launch {
  const void* fn;
  int device, sms;
  size_t allowed, occ_smem;
  int occ;
};

inline std::mutex& launch_mutex() {
  static std::mutex m;
  return m;
}

// this source's entry for kernel fn on the current device (the caller holds
// launch_mutex()), or null when the table is full
inline Launch* launch_of(const void* fn) {
  static Launch table[256];
  static int n = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n; ++i)
    if (table[i].fn == fn && table[i].device == dev) return &table[i];
  if (n == 256) return nullptr;
  table[n] = Launch{fn, dev, 0, 0, 0, 0};
  cudaDeviceGetAttribute(&table[n].sms, cudaDevAttrMultiProcessorCount, dev);
  return &table[n++];
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(launch_mutex());
  Launch* l = launch_of(reinterpret_cast<const void*>(kernel));
  if (l != nullptr && l->allowed >= bytes) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && l != nullptr) l->allowed = bytes;
  return e;
}

// The shape of a row-product block at width C (a multiple of 16 up to 128).
template <int C>
struct Geo {
  static_assert(C % 16 == 0 && C >= 16 && C <= 128, "width");
  static constexpr int kLd = C + 8;            // bf16 row stride, elements
  static constexpr int kRowB = 2 * kLd;        // in bytes
  static constexpr int kTileB = 2 * C * C;     // one weight tile
  // two blocks an SM (128 registers) below C = 64; at 64 the backward's
  // kernels spilled there
  static constexpr int kMinBlocks = C < 64 ? 2 : 1;

  // The ring's stages beside `other` bytes of shared memory: every one of
  // the nper tiles a row tile uses (resident) where they fit, else as many
  // as fit, at most nper - 1; 0 where not two fit.
  static int stages(size_t other, int nper) {
    const size_t room = other + 16 * (size_t)nper < kMaxSmem
                            ? (kMaxSmem - other - 16 * (size_t)nper) / kTileB : 0;
    if (room >= (size_t)nper) return nper;
    return room >= 2 ? (int)(room < (size_t)nper - 1 ? room : nper - 1) : 0;
  }
};

// d (+)= a . B over N columns (a multiple of 16 up to 128) as wgmma widths
// 128, 64, 32, 16 in turn; d holds the accumulator of m64nN (column tile i
// in d[4 i .. 4 i + 3]); B's core matrices n_step bytes apart along N.
template <int N, int kTrans>
__device__ __forceinline__ void mma_cols(float* d, const uint32_t (&a)[4], uint64_t desc,
                                         uint32_t n_step, int accumulate) {
  if constexpr (N >= 128) {
    wgmma::m64n128k16<kTrans>(*reinterpret_cast<float(*)[64]>(d), a, desc, accumulate);
  } else if constexpr (N >= 64) {
    wgmma::m64n64k16<kTrans>(*reinterpret_cast<float(*)[32]>(d), a, desc, accumulate);
    if constexpr (N > 64)
      mma_cols<N - 64, kTrans>(d + 32, a, desc + ((8 * n_step) >> 4), n_step, accumulate);
  } else if constexpr (N >= 32) {
    wgmma::m64n32k16<kTrans>(*reinterpret_cast<float(*)[16]>(d), a, desc, accumulate);
    if constexpr (N > 32)
      mma_cols<N - 32, kTrans>(d + 16, a, desc + ((4 * n_step) >> 4), n_step, accumulate);
  } else {
    static_assert(N == 16, "width");
    wgmma::m64n16k16<kTrans>(*reinterpret_cast<float(*)[8]>(d), a, desc, accumulate);
  }
}

// acc (+)= A . B, retired: A the block's kM rows of bf16 starting at `rows`
// (ld elements apart; warp w takes rows 16 w .. 16 w + 15 through
// ldmatrix), depth C; B's k16 step s through desc0 + s k16_step bytes, its
// core matrices n_step bytes apart along N; kTrans 1 for an MN-major B.
// The k16 steps go in groups of four (16 A registers), each group issued,
// committed and retired. Every thread of the block calls it.
template <int C, int kTrans>
__device__ __forceinline__ void row_product(float (&acc)[C / 2], const uint16_t* rows, int ld,
                                            uint64_t desc0, uint32_t k16_step, uint32_t n_step,
                                            bool accumulate) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint16_t* a0 = rows + (16 * warp + (lane & 15)) * ld + (lane >> 4) * 8;
  constexpr int kS = C / 16;
#pragma unroll
  for (int g = 0; g < kS; g += 4) {
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (g + j < kS) wgmma::ldmatrix_x4(a[j], a0 + (g + j) * 16);
    wgmma::fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (g + j < kS)
        mma_cols<C, kTrans>(acc, a[j], desc0 + (((g + j) * k16_step) >> 4), n_step,
                            accumulate || g + j > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
  }
}

// The weight ring: the block's uses 0 .. nuse - 1 of a stack's tiles, nper
// uses a row tile (uses u = 0 .. K - 1 of a row tile are the taps' tiles 0 ..
// K - 1, then tiles extra0 and extra1), use i in stage i % stages. Where
// every one of a row tile's nper weight tiles has a stage of its own
// (resident), they are loaded once and stay for all the block's row tiles.
// Otherwise thread 0 loads the first `stages` uses; each warp hands a use's
// stage back once its products have retired (hand_back), and thread 0 then
// refills the stage of the use before with the use `stages` on from it,
// once every warp has handed that one back.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  const uint16_t* w;  // the stack's tiles, 2 C^2 bytes each
  int stages, tile_b, nuse, nper, k, extra0, extra1;

  __device__ __forceinline__ bool resident() const { return stages >= nper; }
  __device__ __forceinline__ int tile_of(int i) const {
    const int u = i % nper;
    return u < k ? u : u == k ? extra0 : extra1;
  }
  __device__ __forceinline__ void load(int i) const {
    const int st = i % stages;
    wgmma::mbar_arrive_expect_tx(full + st, tile_b);
    wgmma::bulk_load(base + (size_t)st * tile_b, w + (size_t)tile_of(i) * (tile_b / 2), tile_b,
                     full + st);
  }
  // thread 0 sets the barriers up and issues the first copies; the caller
  // puts a __syncthreads between this and the first wait
  __device__ __forceinline__ void start() const {
    if (threadIdx.x != 0) return;
    for (int st = 0; st < stages; ++st) {
      wgmma::mbar_init(full + st, 1);
      wgmma::mbar_init(empty + st, kWarps);
    }
    wgmma::fence_mbar_init();
    const int n = resident() ? nper : stages;
    for (int i = 0; i < n && i < nuse; ++i) load(i);
  }
  // the shared address of use i's tile, once it has landed
  __device__ __forceinline__ uint32_t wait(int i) const {
    if (resident()) {
      if (i < nper) wgmma::mbar_wait(full + i, 0);
      return wgmma::smem_u32(base + (size_t)(i % nper) * tile_b);
    }
    wgmma::mbar_wait(full + i % stages, (i / stages) & 1);
    return wgmma::smem_u32(base + (size_t)(i % stages) * tile_b);
  }
  __device__ __forceinline__ void hand_back(int i) const {
    if (resident()) return;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) wgmma::mbar_arrive(empty + i % stages);
    const int r = i - 1;
    if (threadIdx.x == 0 && r >= 0 && r + stages < nuse) {
      wgmma::mbar_wait(empty + r % stages, (r / stages) & 1);
      load(r + stages);
    }
  }
};

// B = W (k = ci, n = co; MN-major) or B = W^T (k = co, n = ci; K-major) of a
// C-wide tile at shared address `tile`: (descriptor, k16 step, n step) in
// bytes.
template <int C, bool kTransposed>
struct TileB {
  static constexpr uint32_t kCiStep = 16 * C, kCoStep = 128;
  static constexpr int kTrans = kTransposed ? 0 : 1;
  static constexpr uint32_t kK16 = kTransposed ? 2 * kCoStep : 2 * kCiStep;
  static constexpr uint32_t kN = kTransposed ? kCiStep : kCoStep;
  static __device__ __forceinline__ uint64_t desc(uint32_t tile) {
    return kTransposed ? desc_b(tile, kCoStep, kCiStep) : desc_b(tile, kCiStep, kCoStep);
  }
};

// acc = rows . W (or W^T), retired: row_product over tile `tile`
template <int C, bool kTransposed>
__device__ __forceinline__ void tile_product(float (&acc)[C / 2], const uint16_t* rows, int ld,
                                             uint32_t tile, bool accumulate) {
  using B = TileB<C, kTransposed>;
  row_product<C, B::kTrans>(acc, rows, ld, B::desc(tile), B::kK16, B::kN, accumulate);
}

// Visit a thread's accumulator pairs: fn(e, row, col) for the values v[e],
// v[e + 1] at tile row `row`, columns col, col + 1 (warp w: rows 16 w +
// gid and + 8, columns 8 i + 2 tig).
template <int N, class Fn>
__device__ __forceinline__ void for_each_pair(Fn&& fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) fn(4 * i + 2 * h, 16 * warp + gid + 8 * h, 8 * i + 2 * tig);
}

// out[c] = the sum over the tile's rows r with valid(r) of v at (r, c), v in
// the accumulator layout, in a fixed order (the 16 rows of a warp by
// shuffles, then the warps in turn through sm, kWarps x N floats). Every
// thread calls it; it ends with a __syncthreads.
template <int N, class Valid>
__device__ __forceinline__ void col_sums(const float (&v)[N / 2], Valid&& valid, float* sm,
                                         float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bool v0 = valid(16 * warp + gid), v1 = valid(16 * warp + gid + 8);
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = (v0 ? v[4 * i + e] : 0.f) + (v1 ? v[4 * i + 2 + e] : 0.f);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (gid == 0) sm[warp * N + 8 * i + 2 * tig + e] = s;
    }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sm[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Rows r in [0, rows) of dst (bf16, ld apart): bf16(leaky(x)) (act, slope)
// or bf16(x) of the row that padded position base + r reads, zeros where it
// reads none. x is this batch item's rows, float32 (xf) or bf16 (xh); plain
// loads, rounded once as they are stored. Where out_l (out_x) is set, the
// rows of positions t0 .. t0 + kM - 1 below T are also written there, this
// batch item's rows of (B, T, C), as they are formed (bf16(x): before
// LeakyReLU); where out_s is set, their signs: byte p C / 8 + c / 8, bit c %
// 8, set where x[p][c] < 0. Every thread calls it.
template <int C>
__device__ __forceinline__ void stage_x(uint16_t* __restrict__ dst, int ld,
                                        const float* __restrict__ xf,
                                        const uint16_t* __restrict__ xh, int base, int rows,
                                        int T, int pad, int mode, bool act, float slope,
                                        uint16_t* out_l = nullptr, uint16_t* out_x = nullptr,
                                        int t0 = 0, uint8_t* out_s = nullptr) {
  constexpr int kQ = C / 8;  // 8-channel pieces of a row
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * kQ; e += kThreads) {
    const int r = e / kQ, c8 = (e % kQ) * 8, p = base + r;
    const int row = pad_row(p, T, pad, mode);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0) {
      float v[8];
      if (xh != nullptr) {
        const uint4 u = *reinterpret_cast<const uint4*>(xh + (size_t)row * C + c8);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[2 * j] = bf16mma::widen(w[j] & 0xFFFFu);
          v[2 * j + 1] = bf16mma::widen(w[j] >> 16);
        }
      } else {
        const float4 a = *reinterpret_cast<const float4*>(xf + (size_t)row * C + c8);
        const float4 b = *reinterpret_cast<const float4*>(xf + (size_t)row * C + c8 + 4);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
      }
      const bool own = p >= t0 && p < t0 + kM && p < T;
      if (out_s != nullptr && own) out_s[(size_t)p * (C / 8) + c8 / 8] = signs(v);
      if (out_x != nullptr && own)
        *reinterpret_cast<uint4*>(out_x + (size_t)p * C + c8) =
            make_uint4(bf16mma::pack(v[0], v[1]), bf16mma::pack(v[2], v[3]),
                       bf16mma::pack(v[4], v[5]), bf16mma::pack(v[6], v[7]));
      if (act) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = leaky(v[j], slope);
      }
      o = make_uint4(bf16mma::pack(v[0], v[1]), bf16mma::pack(v[2], v[3]),
                     bf16mma::pack(v[4], v[5]), bf16mma::pack(v[6], v[7]));
      if (out_l != nullptr && own) *reinterpret_cast<uint4*>(out_l + (size_t)p * C + c8) = o;
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c8) = o;
  }
}

// The window of positions base .. base + rows - 1 loaded as it is, by
// cp.async, into raw (row r at r C values of x's type: float32 where xf is
// set, else bf16), the pad mode's source rows by the copy's row and zeros
// by its zero fill; the caller commits. convert_raw forms the operand rows
// from it.
template <int C>
__device__ __forceinline__ void prefetch_raw(uint8_t* raw, const float* xf, const uint16_t* xh,
                                             int base, int rows, int T, int pad, int mode) {
  const int es = xf != nullptr ? 4 : 2, per = 16 / es;  // values of a 16-byte piece
  const int kq = C / per;
  const uint8_t* src = xf != nullptr ? reinterpret_cast<const uint8_t*>(xf)
                                     : reinterpret_cast<const uint8_t*>(xh);
  for (int e = threadIdx.x; e < rows * kq; e += kThreads) {
    const int r = e / kq, c = (e % kq) * per;
    const int row = pad_row(base + r, T, pad, mode);
    const bool ok = row >= 0;
    tf32x3::cp_async<16>(reinterpret_cast<float*>(raw + ((size_t)r * C + c) * es),
                         reinterpret_cast<const float*>(
                             ok ? src + ((size_t)row * C + c) * es : src),
                         ok);
  }
}

// stage_x's rows (act, slope) from a window that prefetch_raw loaded (base
// the position of its row 0); where skip is set, its rows r - pad, r in
// [pad, pad + kM), also get bf16(x); out_l, out_x and out_s as in stage_x.
template <int C>
__device__ __forceinline__ void convert_raw(uint16_t* __restrict__ dst, int ld,
                                            uint16_t* __restrict__ skip,
                                            const uint8_t* __restrict__ raw, bool f32, int base,
                                            int rows, int pad, int T, float slope,
                                            uint16_t* out_l, uint16_t* out_x,
                                            uint8_t* out_s = nullptr) {
  constexpr int kQ = C / 8;
#pragma unroll 2
  for (int e = threadIdx.x; e < rows * kQ; e += kThreads) {
    const int r = e / kQ, c8 = (e % kQ) * 8, p = base + r;
    float v[8];
    if (f32) {
      const float4 a = *reinterpret_cast<const float4*>(raw + ((size_t)r * C + c8) * 4);
      const float4 b = *reinterpret_cast<const float4*>(raw + ((size_t)r * C + c8 + 4) * 4);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(raw + ((size_t)r * C + c8) * 2);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = bf16mma::widen(w[j] & 0xFFFFu);
        v[2 * j + 1] = bf16mma::widen(w[j] >> 16);
      }
    }
    const bool own = r >= pad && r < pad + kM;
    if (out_s != nullptr && own && p < T) out_s[(size_t)p * (C / 8) + c8 / 8] = signs(v);
    if ((skip != nullptr || out_x != nullptr) && own) {
      const uint4 xb = make_uint4(bf16mma::pack(v[0], v[1]), bf16mma::pack(v[2], v[3]),
                                  bf16mma::pack(v[4], v[5]), bf16mma::pack(v[6], v[7]));
      if (skip != nullptr) *reinterpret_cast<uint4*>(skip + (r - pad) * ld + c8) = xb;
      if (out_x != nullptr && p < T) *reinterpret_cast<uint4*>(out_x + (size_t)p * C + c8) = xb;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = leaky(v[j], slope);
    const uint4 o = make_uint4(bf16mma::pack(v[0], v[1]), bf16mma::pack(v[2], v[3]),
                               bf16mma::pack(v[4], v[5]), bf16mma::pack(v[6], v[7]));
    *reinterpret_cast<uint4*>(dst + r * ld + c8) = o;
    if (out_l != nullptr && own && p < T) *reinterpret_cast<uint4*>(out_l + (size_t)p * C + c8) = o;
  }
}

// Rows r in [0, rows) of dst (bf16, ld apart) = src's rows base + r (bf16,
// this batch item's), zeros outside [0, T) (or, with a pad, the rows that
// the padded positions read: pad_row), by cp.async (the caller commits and
// waits).
template <int C>
__device__ __forceinline__ void stage_raw(uint16_t* dst, int ld, const uint16_t* src, int base,
                                          int rows, int T, int pad = 0, int mode = kZero) {
  constexpr int kQ = C / 8;
  for (int e = threadIdx.x; e < rows * kQ; e += kThreads) {
    const int r = e / kQ, c8 = (e % kQ) * 8, t = pad_row(base + r, T, pad, mode);
    const bool ok = t >= 0;
    tf32x3::cp_async<16>(reinterpret_cast<float*>(dst + r * ld + c8),
                         reinterpret_cast<const float*>(ok ? src + (size_t)t * C + c8 : src), ok);
  }
}

// The blocks of a persistent row-product launch over `ntiles` tiles: as
// many as fit on the card at `smem` bytes a block.
template <typename Kernel>
int persistent_grid(Kernel kernel, size_t smem, int ntiles) {
  int n = 0;
  {
    std::lock_guard<std::mutex> lock(launch_mutex());
    Launch* l = launch_of(reinterpret_cast<const void*>(kernel));
    int per_sm = 0, sms = 0;
    if (l != nullptr && l->occ > 0 && l->occ_smem == smem) {
      per_sm = l->occ;
      sms = l->sms;
    } else {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
      if (l != nullptr && per_sm > 0) {
        l->occ = per_sm;
        l->occ_smem = smem;
      }
    }
    n = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n < ntiles ? n : ntiles;
}

// v (the accumulator layout, rows t0 + r of kM) to rows of dst (C apart,
// this batch item's), those below T: through `stage` in shared memory
// (float32 rows C + 4 apart, or with kBF16 rounded to bf16, C + 8 apart),
// then 16 bytes a thread, a warp's stores one contiguous run of a row. The
// caller makes sure no warp still reads `stage`; it ends with a
// __syncthreads.
template <int C, bool kBF16>
__device__ __forceinline__ void store_rows(const float (&v)[C / 2], void* stage, void* dst,
                                           int t0, int T) {
  constexpr int kLdS = kBF16 ? C + 8 : C + 4;  // elements of a staged row
  constexpr int kEs = kBF16 ? 2 : 4;
  constexpr int kQ = C * kEs / 16;  // 16-byte pieces of a row
  uint8_t* s8 = static_cast<uint8_t*>(stage);
  for_each_pair<C>([&](int e, int r, int col) {
    if constexpr (kBF16)
      st_bf16x2(reinterpret_cast<uint16_t*>(s8) + r * kLdS + col, v[e], v[e + 1]);
    else
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(s8) + r * kLdS + col) =
          make_float2(v[e], v[e + 1]);
  });
  __syncthreads();
  uint8_t* d8 = static_cast<uint8_t*>(dst);
  for (int e = threadIdx.x; e < kM * kQ; e += kThreads) {
    const int r = e / kQ, q = e % kQ;
    if (t0 + r < T)
      *reinterpret_cast<uint4*>(d8 + ((size_t)(t0 + r) * C) * kEs + 16 * q) =
          *reinterpret_cast<const uint4*>(s8 + (size_t)r * kLdS * kEs + 16 * q);
  }
  __syncthreads();
}

// Whether a kM-row tile starting at t0 holds a row that the padding's
// adjoint folds onto (reflect: 1 .. P and T - 1 - P .. T - 2; replicate: 0
// and T - 1).
__device__ __forceinline__ bool folds(int t0, int T, int P, int mode) {
  if (P == 0) return false;
  if (mode == kReflect) return (t0 <= P && t0 + kM > 1) || (t0 <= T - 2 && t0 + kM > T - 1 - P);
  if (mode == kEdge) return t0 == 0 || t0 + kM > T - 1;
  return false;
}

}  // namespace melbf
}  // namespace
