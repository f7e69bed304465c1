// Row products and weight gradients of the backward kernel K7
// (melgan_stack_bwd.cu), float32 on the CUDA cores, in the channel-last
// (B, T, C) layout.
//
// row_product: a block's tile of output rows u0 .. u0 + tile - 1 of one
//   batch item times small weight matrices, summed over segments (a conv
//   tap, or another operand) that each read their operand at a row shift;
//   operands and weights are staged through shared memory kCW input
//   channels at a time, and each thread holds kRT rows x 4 output columns.
// wgrad_partial_kernel / wgrad_reduce_kernel: weight gradients dW = A^T b
//   and db = sum b over every row of every batch item, as partial slabs
//   (one per kRowsPerCta rows of a batch item and per job) that the reduce
//   sums in a fixed order, so two runs give the same bits without atomics;
//   the partial kernel's thread map is fitted to each job (kNG = 0) or
//   fixed at compile time (kNG > 0, which no kernel takes now).
// An operand's rows are read as stored (times a scale, zero outside
// [0, T)), or, with Pad::act, as pad(leaky(.)): the padded LeakyReLU input
// of a MelGAN stack's dilated conv (reflect, replicate or zeros, as
// csrc/melgan_stack.cu pads).
//
// Everything here has internal linkage: each source that includes it gets
// its own copy of the kernels.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRT = 8;             // rows per thread in a row product
constexpr int kCW = 16;            // input channels staged per step
constexpr int kAS = kCW + 4;       // row stride of staged float4 operand rows
constexpr int kMaxN = 128;         // widest product output
constexpr int kMaxSegs = 8;        // segments of one row product
constexpr int kRowsPerCta = 1024;  // rows of one weight-gradient partial
constexpr int kRS = 32;            // rows staged per step of a partial
constexpr int kMaxP = 64;          // input channels of one gradient job
constexpr int kMaxJobs = 32;

// Floats of shared memory that a row product of tile rows stages.
__host__ __device__ constexpr int row_smem_floats(int tile) {
  return kCW * kMaxN + tile * kAS;
}

// Rows of a tile in which every thread holds kRT rows of n columns (n a
// multiple of 4 that divides 4 * kThreads).
__host__ __device__ constexpr int full_tile(int n) {
  return kThreads / (n / 4) * kRT;
}

enum PadMode { kReflect = 0, kEdge = 1, kZero = 2 };

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// 1 at v >= 0, as the JAX kernels' _dleaky
__device__ __forceinline__ float dleaky(float v, float slope) {
  return v >= 0.f ? 1.f : slope;
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// log2 of the least power of two >= v (v >= 1)
__device__ __forceinline__ int ceil_log2(int v) {
  return v <= 1 ? 0 : 32 - __clz(v - 1);
}

__device__ __forceinline__ void zero(float (&acc)[kRT][4]) {
#pragma unroll
  for (int i = 0; i < kRT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// The row of x that padded position p reads, or -1 for a zero row
// (csrc/melgan_stack.cu's pad_row).
__device__ __forceinline__ int pad_row(int p, int T, int pad, int mode) {
  if (p >= 0 && p < T) return p;
  if (p < -pad || p >= T + pad || mode == kZero) return -1;
  if (mode == kReflect) return p < 0 ? -p : 2 * T - 2 - p;
  return p < 0 ? 0 : T - 1;
}

// How operand rows are read: T rows per batch item; with act, row t is
// pad(leaky(.)) at padded position t (pad rows each side, mode, slope),
// else row t as stored, zero outside [0, T).
struct Pad {
  int T, act, pad, mode;
  float slope;
};

// Element ch of row t of one batch item's operand (rows ld floats apart).
__device__ __forceinline__ float load(const float* src, int ld, int t, int ch,
                                      float scale, const Pad& pd) {
  if (pd.act) {
    const int r = pad_row(t, pd.T, pd.pad, pd.mode);
    return r >= 0 ? leaky(src[(size_t)r * ld + ch], pd.slope) : 0.f;
  }
  return t >= 0 && t < pd.T ? src[(size_t)t * ld + ch] * scale : 0.f;
}

// One segment of a row product: for output row u, the operand row u +
// shift, channels [0, P), times scale, times W[p][n] read at w + p * w_row
// + n * w_col.
struct Seg {
  const float* src;
  int ld, P, shift;
  float scale;
  const float* w;
  int w_row, w_col;
};

// Thread map of a row product with n output columns over tile rows: ng
// groups of 4 columns, rgs = tile / kRT row groups; thread (rg, cg) holds
// rows rg + i * rgs (i < kRT) and columns 4 * cg .. 4 * cg + 3.
struct RowMap {
  int ng, rgs, cg, rg;
  bool active;
  __device__ RowMap(int n, int tile) {
    ng = (n + 3) / 4;
    rgs = tile / kRT;
    cg = threadIdx.x % ng;
    rg = threadIdx.x / ng;
    active = rg < rgs;
  }
};

// acc[i][j] += sum over the segments and their channels p of
// A[u0 + rg + i * rgs + shift][p] * W[p][4 * cg + j] for batch item b.
// w_s holds kCW * kMaxN floats, a_s tile * kAS (16-byte aligned). Every
// thread of the block must call it (it synchronises). The staged operand
// rows are read as float4 (12 shared loads per 128 FMAs).
__device__ __forceinline__ void row_product(const Seg* segs, int nseg, const Pad& pd,
                                            int n, int tile, int b, int u0, float* w_s,
                                            float* a_s, float (&acc)[kRT][4]) {
  const RowMap m(n, tile);
  const int np = 4 * m.ng;
  for (int g = 0; g < nseg; ++g) {
    const Seg sg = segs[g];
    const float* src = sg.src + (size_t)b * pd.T * sg.ld;
    for (int c0 = 0; c0 < sg.P; c0 += kCW) {
      for (int e = threadIdx.x; e < tile * kCW; e += kThreads) {
        const int row = e / kCW, j = e % kCW;
        a_s[row * kAS + j] =
            c0 + j < sg.P ? load(src, sg.ld, u0 + row + sg.shift, c0 + j, sg.scale, pd)
                          : 0.f;
      }
      // weights: thread e stages W[c0 + e / np][e % np]
      for (int e = threadIdx.x; e < kCW * np; e += kThreads) {
        const int p = e / np, col = e % np;
        w_s[p * np + col] =
            c0 + p < sg.P && col < n
                ? sg.w[(size_t)(c0 + p) * sg.w_row + (size_t)col * sg.w_col]
                : 0.f;
      }
      __syncthreads();
      if (m.active) {
        const float* arow = a_s + m.rg * kAS;
#pragma unroll
        for (int ci = 0; ci < kCW; ci += 4) {
          float4 av[kRT];
#pragma unroll
          for (int i = 0; i < kRT; ++i)
            av[i] = *reinterpret_cast<const float4*>(arow + i * m.rgs * kAS + ci);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 w =
                *reinterpret_cast<const float4*>(w_s + (ci + cc) * np + 4 * m.cg);
#pragma unroll
            for (int i = 0; i < kRT; ++i) {
              const float a = lane(av[i], cc);
              acc[i][0] = fmaf(a, w.x, acc[i][0]);
              acc[i][1] = fmaf(a, w.y, acc[i][1]);
              acc[i][2] = fmaf(a, w.z, acc[i][2]);
              acc[i][3] = fmaf(a, w.w, acc[i][3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// A job of the weight gradients: dw (P x N, rows N apart) = sum_t
// A[t + shift]^T (b[t] * scale) and db (N, optional) = sum_t b[t] * scale,
// over t in [0, T) of every batch item. A's rows are those of a (a_ld
// floats apart), read as pad(leaky(a)) when act (WArgs' pad, mode and
// slope), else as stored and zero outside [0, T); b's rows are N floats.
struct WJob {
  const float* a;
  int a_ld, P, shift, act;
  const float* b;
  int N;
  float scale;
  float* dw;
  float* db;
};

struct WArgs {
  WJob job[kMaxJobs];
  float* part;  // (jobs, ctas, slab)
  int njobs, T, pad, mode, ctas_per_item, ctas, slab;
  float slope;
};

// One block: kRowsPerCta rows of batch item blockIdx.y for job blockIdx.z.
// Thread (pg, cg) holds the job's rows pg * rpt .. pg * rpt + rpt - 1 and
// columns 4 * cg .. 4 * cg + 3; the threads of pg 0 also sum the columns.
// kNG > 0 fixes the map at compile time, kNG column groups and rpt =
// kMaxP / (kThreads / kNG) for every job (unused); kNG = 0 fits it to each
// job's N and P (K7, from 1 to 128 wide).
template <int kNG>
__global__ void __launch_bounds__(kThreads) wgrad_partial_kernel(WArgs w) {
  // 8 floats past the last row: a thread's rows may run past P
  __shared__ __align__(16) float a_s[kRS * kMaxP + 8];
  __shared__ __align__(16) float b_s[kRS * kMaxN];
  const WJob jb = w.job[blockIdx.z];
  const int item = blockIdx.y;
  const int t_begin = blockIdx.x * kRowsPerCta;
  const int t_end = min(w.T, t_begin + kRowsPerCta);
  const int ng = kNG > 0 ? kNG : (jb.N + 3) / 4, pgs = kThreads / ng;
  // at most 8: pgs >= 8, P <= 64
  const int rpt = kNG > 0 ? kMaxP / (kThreads / kNG) : (jb.P + pgs - 1) / pgs;
  const int cg = threadIdx.x % ng, pg = threadIdx.x / ng;
  const bool active = pg < pgs && pg * rpt < jb.P;
  const Pad pd{w.T, jb.act, w.pad, w.mode, w.slope};
  const float* a = jb.a + (size_t)item * w.T * jb.a_ld;
  const float* bsrc = jb.b + (size_t)item * w.T * jb.N;

  float acc[8][4];
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // staged widths rounded up to powers of two, so that the staging loops
  // split their index with a shift and a mask
  const int la = ceil_log2(jb.P), lb = ceil_log2(4 * ng);
  for (int r0 = t_begin; r0 < t_end; r0 += kRS) {
    for (int e = threadIdx.x; e < kRS << la; e += kThreads) {
      const int r = e >> la, q = e & ((1 << la) - 1);
      const int t = r0 + r;
      a_s[r * kMaxP + q] =
          t < t_end && q < jb.P ? load(a, jb.a_ld, t + jb.shift, q, 1.f, pd) : 0.f;
    }
    // columns past N read as zeros up to the thread map's 4 * ng; rows of
    // A past P feed only accumulators never stored
    for (int e = threadIdx.x; e < kRS << lb; e += kThreads) {
      const int r = e >> lb, n = e & ((1 << lb) - 1);
      const int t = r0 + r;
      b_s[r * kMaxN + n] =
          t < t_end && n < jb.N ? bsrc[(size_t)t * jb.N + n] * jb.scale : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < kRS; ++r) {
        const float4 bv = *reinterpret_cast<const float4*>(b_s + r * kMaxN + 4 * cg);
        const float* ar = a_s + r * kMaxP + pg * rpt;
        float av[8];
        if (rpt % 4 == 0) {  // 16-byte aligned: float4 loads
#pragma unroll
          for (int q = 0; q < 8; q += 4) {
            const float4 v = q < rpt ? *reinterpret_cast<const float4*>(ar + q)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
            av[q] = v.x;
            av[q + 1] = v.y;
            av[q + 2] = v.z;
            av[q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) av[i] = i < rpt ? ar[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < rpt) {
            acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
            acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
            acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
            acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
          }
        }
        if (pg == 0) {
          sum[0] += bv.x;
          sum[1] += bv.y;
          sum[2] += bv.z;
          sum[3] += bv.w;
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const int cta = item * w.ctas_per_item + blockIdx.x;
  float* slab = w.part + ((size_t)blockIdx.z * w.ctas + cta) * w.slab;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int prow = pg * rpt + i;
    if (i >= rpt || prow >= jb.P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * cg + j < jb.N) slab[prow * jb.N + 4 * cg + j] = acc[i][j];
  }
  if (pg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * cg + j < jb.N) slab[jb.P * jb.N + 4 * cg + j] = sum[j];
  }
}

// Element e of job blockIdx.y: the sum of its slabs, cta 0 first.
__global__ void __launch_bounds__(kThreads) wgrad_reduce_kernel(WArgs w) {
  const WJob jb = w.job[blockIdx.y];
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int prow = e / jb.N, n = e % jb.N;
  if (prow > jb.P) return;
  if (prow == jb.P && jb.db == nullptr) return;
  const float* src = w.part + (size_t)blockIdx.y * w.ctas * w.slab + e;
  float s = 0.f;
  for (int cta = 0; cta < w.ctas; ++cta) s += src[(size_t)cta * w.slab];
  if (prow < jb.P)
    jb.dw[(size_t)prow * jb.N + n] = s;
  else
    jb.db[n] = s;
}

// Floats of partial slabs for jobs of at most N columns over B x T rows,
// or -1 when there are more jobs than one launch takes or the count does
// not fit an int.
int scratch_floats(int B, int T, int N, int jobs) {
  const long long ctas = (long long)B * ((T + kRowsPerCta - 1) / kRowsPerCta);
  const long long n = (long long)jobs * ctas * (kMaxP + 1) * N;
  return jobs > kMaxJobs || n > 2147483647LL ? -1 : (int)n;
}

// The partial and reduce launches of w's first njobs jobs (T, pad, mode
// and slope set by the caller), with part holding have floats; kNG as
// wgrad_partial_kernel's (every job at most 4 * kNG wide).
template <int kNG = 0>
cudaError_t launch_wgrad(WArgs& w, int njobs, int B, float* part,
                         long long have, cudaStream_t s) {
  int n_max = 1;
  for (int j = 0; j < njobs && j < kMaxJobs; ++j)
    n_max = w.job[j].N > n_max ? w.job[j].N : n_max;
  w.njobs = njobs;
  w.part = part;
  w.ctas_per_item = (w.T + kRowsPerCta - 1) / kRowsPerCta;
  w.ctas = B * w.ctas_per_item;
  w.slab = (kMaxP + 1) * n_max;
  if (njobs < 1 || njobs > kMaxJobs || n_max > (kNG > 0 ? 4 * kNG : kMaxN) ||
      have < (long long)njobs * w.ctas * w.slab)
    return cudaErrorInvalidValue;
  wgrad_partial_kernel<kNG><<<dim3(w.ctas_per_item, B, njobs), kThreads, 0, s>>>(w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_reduce_kernel<<<dim3((w.slab + kThreads - 1) / kThreads, njobs), kThreads,
                        0, s>>>(w);
  return cudaGetLastError();
}

}  // namespace
