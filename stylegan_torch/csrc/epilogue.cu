// Fused synthesis-layer epilogue for Hopper (sm_90a).
//
//   y   = leaky_relu(x + noise_weight[c] * noise[b, r], 0.2)              (f32)
//   out = (y - mean_bc(y)) * rsqrt(var_bc(y) + 1e-5) * (s0[b, c] + 1) + s1[b, c]
//
// i.e. NoiseLayer -> lrelu -> InstanceNorm2d -> StyleMod (reference
// CustomLayers.py:183-248).  x and out are (B, R, C) row-major, R = H*W: the
// storage of an NHWC tensor, or of an NCHW tensor in channels_last format.
// noise is (B, R): one scalar per pixel, broadcast over C in registers.
// noise_weight is (C,) f32, style (B, 2C) f32 laid out [s0 | s1].  x, noise
// and out are float or bfloat16 (templated); all arithmetic is float32.
//
// Replaces the two Pallas TPU kernels of stylegan_tpu/ops/pallas/epilogue.py:
// _stats_kernel (K1, :36, launched at :73: per-(b, c) sums over spatial
// tiles) and _apply_kernel (K2, :49, launched at :101: normalise and
// modulate).
//
// What bounds it: bytes.  Per element it does ~10 flops and moves one read
// and one write of x, far below the card's ~20 flops per byte of f32 ALU
// balance.  At batch 8 a 1024^2 forward's 18 epilogues must move 4.34 GB in
// f32 (1.30 ms at 3.35 TB/s) and half that in bf16.
//
// The design has two paths, chosen per call by sgt::make_plan in
// epilogue_plan.h (host-only, tested on the CPU):
//
//   1. One pass, where the (b, channel chunk) slab fits on chip: in the
//      shared memory of one block, or of a thread-block cluster of 2 blocks
//      that split its rows (planes up to 64^2 x 256 in f32 and bf16).  The
//      block loads its slab once with 16-byte cp.async, takes the mean and
//      then the centred sum of squares from shared memory, exchanges the
//      per-block (mean, M2) over distributed shared memory and merges them
//      in rank order, then normalises from shared memory and writes out.  It
//      reads x once and writes it once, the bytes bound itself, in one
//      launch.  Chunks of 128-byte rows, narrowed down to 32-byte rows until
//      the grid holds about one block per SM.  Clusters of 4 and 8 (which
//      would hold 128^2 x 128) lost to two passes on the card (PERF.md).
//   2. Two passes, for the larger planes (128^2 x 128 and up).  Pass 1
//      streams x with several 16-byte loads in flight per thread (four in
//      f32; one in bf16, whose 8-wide vectors already hold 8 Welford states
//      a thread and lose occupancy to more) and leaves a Welford (mean, M2)
//      per (b, split, c).  The last block to finish a (b, chunk), found by a
//      ticket counter after __threadfence(), merges the splits in a fixed
//      tree order (bitwise deterministic: the ticket only picks which block
//      merges) and writes (mean, rstd * (s0 + 1)), so there is no finalize
//      launch.  Pass 2 recomputes y and writes out, walking its blocks in
//      the reverse of pass 1's order, so that its first blocks may re-read
//      from the 50 MB L2 what pass 1 read last.  Two launches per batch
//      group (so that a group's second read hits L2), and one persistent
//      launch interleaving the passes of neighbouring batch items, were
//      both slower on the card and are gone (PERF.md).
//
// The split-plane form serves a plane whose rows lie on several ranks (the
// spatial serving path, parallel/spatial.py), where no launch sees the whole
// plane: K1-partial (stats_kernel with PARTIAL) leaves this rank's merged
// (mean, M2) per (b, c); the ranks gather those, each merges them in rank
// order (Chan's formula, on the host's side of the launch: a few (B, C)
// tensor ops) into (mean, rstd * (s0 + 1)), and K2-apply (apply_kernel)
// normalises this rank's rows from them.  Both take path 2's geometry at
// every slab size (sgt_epilogue_split_plan), one launch each; they are bound
// by bytes as the unsplit passes are, and read x twice, as path 2 does.
//
// Common to all: noise is read as one scalar per row, never broadcast to
// (B, R, C) in memory; every thread moves 16 bytes per load and store along
// C (VEC = 4 floats or 8 bf16), or scalars where C or a pointer does not
// allow it; partials merge with Chan's pairwise formula, never as
// E[y^2] - mean^2, which cancels over 2^20 post-lrelu values with a positive
// mean.  No atomics touch a sum, so results are bitwise deterministic.
//
// The backward (K3, below) replaces the custom VJP's _bwd of
// stylegan_tpu/ops/pallas/epilogue.py:139-142, which is XLA autodiff of the
// plain composition.  It too is bound by bytes: it must read g, x and noise
// once and write dx (and dnoise when asked), plus vectors of B x C; at batch
// 2 in f32 a 1024^2 G backward's 18 calls must move about 1.6 GB, about
// 0.48 ms at 3.35 TB/s.  The forward saves (mean, rstd) per (b, c) when a
// gradient may be needed, so the backward never recomputes the statistics.
// It has the forward's two paths, planned by sgt::make_bwd_plan:
//
//   1. One pass (onepass_bwd_kernel), where the (b, channel chunk) slabs of
//      g and x fit in the shared memory of one block or of a cluster of 2
//      (planes up to 64^2 x 256 at batch 2 and 8): one launch loads both with
//      16-byte cp.async, takes the per-(b, c) sums of g and g * (y - mean)
//      from shared memory (a cluster adds its ranks' sums over DSMEM in rank
//      order), writes dstyle and then dx from shared memory.  Chunks as
//      the forward's path 1.
//   2. Two passes (bwd_sums_kernel, bwd_dx_kernel) for the larger planes:
//      pass 1 the sums, pass 2 dx, so g and x are read twice (5/3 of the
//      bound's bytes).  Both take one wave of about two blocks per SM, and
//      pass 2 walks its blocks and rows in the reverse of pass 1's order, so
//      that each of its blocks starts on what its pass-1 block read last.
//      More loads in flight, more or fewer blocks, and L2 eviction hints
//      made no difference or lost on the H100 (PERF.md).
//
// The cross-block sums (over up to 2^20 rows per (b, c) on path 2, and over
// B x H x W rows for dnoise_weight) take the forward's machinery: per-split
// partials, a ticket, and a fixed-order merge in the last block; no float
// atomics.
//
// The split-plane backward serves a plane whose rows lie on several ranks
// (the spatial train step): K3-partial (bwd_sums_kernel with PARTIAL) leaves
// this rank's per-(b, c) (sum g, sum g * (y - mean)) over its rows, with
// (mean, rstd) the merged statistics its forward saved, and its share of
// dstyle; the ranks gather those and each adds them in rank order (on the
// host's side of the launch), and K3-apply (bwd_dx_kernel with SPLIT) forms
// the coefficients from the merged sums over the plane's row count and
// writes this rank's dx, its share of dnoise_weight and its rows of dnoise.
// Both take path 2's geometry at every slab size (sgt_epilogue_bwd_split_plan),
// one launch each, and are bound by bytes as the unsplit passes are.
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W are in PERF.md, measured by
// chip_smoke.py; none is stated here.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_plan.h"

namespace {

namespace cg = cooperative_groups;
using sgt::kThreads;

constexpr float kSlope = 0.2f;
constexpr float kEps = 1e-5f;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// u = x + w * z rounded as the plain version rounds it (the product, then
// the sum; no fused multiply-add), so that the backward takes the lrelu's
// slope on the same side of 0 as the plain version does.
__device__ __forceinline__ float noisy(float x, float w, float z) {
  return __fadd_rn(x, __fmul_rn(w, z));
}

__device__ __forceinline__ float noisy_lrelu(float x, float w, float z) {
  const float y = noisy(x, w, z);
  return y >= 0.f ? y : kSlope * y;
}

// Chan's merge of (na, ma, m2a) with (nb, mb, m2b) into the first; nb > 0.
__device__ __forceinline__ void chan(float& na, float& ma, float& m2a,
                                     float nb, float mb, float m2b) {
  const float f = nb / (na + nb);
  const float d = mb - ma;
  ma = fmaf(d, f, ma);
  m2a = m2a + m2b + d * d * na * f;
  na += nb;
}

// Global -> shared copy of one Pack: cp.async where the size allows (16 or
// 4 bytes), else a plain load and store (a bf16 scalar).
template <typename T, int VEC>
__device__ __forceinline__ void copy_in(T* dst, const T* src) {
  constexpr int kBytes = sizeof(T) * VEC;
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Sum over ty of v[VEC] per lane, in a fixed tree order; every thread gets
// the block's sum back.  red holds TY x (TX * VEC) floats.
template <int VEC>
__device__ __forceinline__ void block_sum(float (&v)[VEC], float* red) {
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  const int cc = blockDim.x * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[ty * cc + tx * VEC + i] = v[i];
  __syncthreads();
  for (int stride = TY / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        red[ty * cc + tx * VEC + i] += red[(ty + stride) * cc + tx * VEC + i];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = red[tx * VEC + i];
  __syncthreads();  // red is reused
}

// ---------------------------------------------------------------- path 1 --
// grid (chunks * cluster, B), block (TX, TY), clusters of `cluster` blocks
// along x.  Block `rank` of a cluster holds rows [rank * rpr, (rank+1) * rpr)
// of the (b, chunk) slab; thread (tx, ty) owns channels c0 .. c0 + VEC - 1
// of rows ty, ty + TY, ... of it, in shared memory and in registers alike.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
onepass_kernel(const T* __restrict__ x, const T* __restrict__ noise,
               const float* __restrict__ nw, const float* __restrict__ style,
               T* __restrict__ out, float2* __restrict__ saved, int64_t R,
               int C, int cluster, int64_t rpr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y, tid = ty * TX + tx;
  const int cc = TX * VEC;
  const int rank = blockIdx.x % cluster, chunk = blockIdx.x / cluster;
  const int b = blockIdx.y;
  const int64_t r0 = (int64_t)rank * rpr;
  const int rows = (int)(r0 < R ? min64(rpr, R - r0) : 0);

  T* s_x = reinterpret_cast<T*>(smem);
  T* s_z = reinterpret_cast<T*>(smem + sgt::align16(rpr * cc * sizeof(T)));
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(s_z) + sgt::align16(rpr * sizeof(T)));
  float2* s_ex = reinterpret_cast<float2*>(
      reinterpret_cast<unsigned char*>(red) + sgt::align16(TY * cc * 4));

  const int c0 = chunk * cc + tx * VEC;
  const bool active = c0 < C;
  const T* xb = x + ((size_t)b * R + r0) * C + c0;
  if (active)
    for (int r = ty; r < rows; r += TY)
      copy_in<T, VEC>(s_x + r * cc + tx * VEC, xb + (size_t)r * C);
  const T* nb = noise + (size_t)b * R + r0;
  for (int r = tid; r < rows; r += TX * TY) s_z[r] = nb[r];
  float w[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) w[i] = active ? nw[c0 + i] : 0.f;
  copy_wait_all();
  __syncthreads();

  // the block's mean, then its centred sum of squares, from shared memory
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (active)
    for (int r = ty; r < rows; r += TY) {
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(s_x + r * cc + tx * VEC);
      const float z = to_float(s_z[r]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += noisy_lrelu(to_float(p.v[i]), w[i], z);
    }
  block_sum<VEC>(acc, red);
  float mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = rows > 0 ? acc[i] / (float)rows : 0.f;
    acc[i] = 0.f;
  }
  if (active)
    for (int r = ty; r < rows; r += TY) {
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(s_x + r * cc + tx * VEC);
      const float z = to_float(s_z[r]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = noisy_lrelu(to_float(p.v[i]), w[i], z) - mean[i];
        acc[i] = fmaf(d, d, acc[i]);
      }
    }
  block_sum<VEC>(acc, red);
#pragma unroll
  for (int i = 0; i < VEC; ++i) m2[i] = acc[i];

  if (cluster > 1) {
    // every block merges all ranks' (mean, M2) in rank order: the same
    // operations in the same order, so the blocks of a cluster agree
    cg::cluster_group cl = cg::this_cluster();
    if (ty == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        s_ex[tx * VEC + i] = make_float2(mean[i], m2[i]);
    }
    cl.sync();
    float n = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
    for (int k = 0; k < cluster; ++k) {
      const int64_t rk = (int64_t)k * rpr;
      const float nk = (float)(rk < R ? min64(rpr, R - rk) : 0);
      if (nk == 0.f) continue;
      const float2* ex = cl.map_shared_rank(s_ex, k);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float2 e = ex[tx * VEC + i];
        float nn = n;
        chan(nn, mean[i], m2[i], nk, e.x, e.y);
      }
      n += nk;
    }
    cl.sync();  // no block leaves while another reads its partials
  }

  if (!active) return;
  const float* s0 = style + (size_t)b * 2 * C;
  float scale[VEC], shift[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float rstd = rsqrtf(m2[i] / (float)R + kEps);
    if (saved != nullptr && ty == 0 && rank == 0)
      saved[(size_t)b * C + c0 + i] = make_float2(mean[i], rstd);
    scale[i] = rstd * (s0[c0 + i] + 1.f);
    shift[i] = s0[C + c0 + i];
  }
  T* ob = out + ((size_t)b * R + r0) * C + c0;
  for (int r = ty; r < rows; r += TY) {
    const Pack<T, VEC> p =
        *reinterpret_cast<const Pack<T, VEC>*>(s_x + r * cc + tx * VEC);
    const float z = to_float(s_z[r]);
    Pack<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = noisy_lrelu(to_float(p.v[i]), w[i], z);
      o.v[i] = from_float<T>(fmaf(y - mean[i], scale[i], shift[i]));
    }
    *reinterpret_cast<Pack<T, VEC>*>(ob + (size_t)r * C) = o;
  }
}

// ---------------------------------------------------------------- path 2 --
// Pass 1: per-(b, split, c) Welford statistics of y over the split's rows.
// grid (splits, chunks, B), block (TX, TY) with TX * TY == kThreads
// and TY a power of two.  Thread (tx, ty) owns channels c0 .. c0 + VEC - 1
// and rows r0 + ty, r0 + ty + TY, ...  The last block of a (b, chunk) merges
// its splits and writes stats (mean, rstd * (s0 + 1)); with PARTIAL (K1 of
// a plane whose rows lie on several ranks) it writes the merged (mean, M2)
// of its R rows instead, and reads neither style nor saved.
// Each thread issues UNROLL loads before their Welford updates.  bf16's
// 8-wide vectors already hold 8 Welford states a thread: more loads in
// flight cost occupancy and lost on the H100 (PERF.md).
template <typename T, int VEC, bool PARTIAL = false,
          int UNROLL = VEC == 8 ? 1 : 4>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, const T* __restrict__ noise,
             const float* __restrict__ nw, const float* __restrict__ style,
             float2* __restrict__ partials, float2* __restrict__ stats,
             float2* __restrict__ saved, int* __restrict__ tickets, int64_t R,
             int C, int64_t rows_per_split) {
  __shared__ float s_mean[kThreads * VEC];
  __shared__ float s_m2[kThreads * VEC];
  __shared__ float s_n[kThreads];
  __shared__ int s_last;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int tid = ty * TX + tx;
  const int split = blockIdx.x, splits = gridDim.x, chunk = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = (chunk * TX + tx) * VEC;
  const bool active = c0 < C;
  const int64_t r0 = (int64_t)split * rows_per_split;
  const int64_t r1 = min64(r0 + rows_per_split, R);

  float w[VEC], mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    w[i] = active ? nw[c0 + i] : 0.f;
    mean[i] = 0.f;
    m2[i] = 0.f;
  }
  float n = 0.f;
  if (active) {
    const T* xb = x + (size_t)b * R * C + c0;
    const T* nb = noise + (size_t)b * R;
    for (int64_t r = r0 + ty; r < r1; r += (int64_t)TY * UNROLL) {
      Pack<T, VEC> p[UNROLL];
      float z[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // all loads first, then the math
        const int64_t ru = r + (int64_t)u * TY;
        if (ru < r1) {
          p[u] = *reinterpret_cast<const Pack<T, VEC>*>(xb + ru * C);
          z[u] = to_float(nb[ru]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + (int64_t)u * TY < r1) {
          n += 1.f;
          const float inv = 1.f / n;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float y = noisy_lrelu(to_float(p[u].v[i]), w[i], z[u]);
            const float d = y - mean[i];
            mean[i] = fmaf(d, inv, mean[i]);
            m2[i] = fmaf(d, y - mean[i], m2[i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_mean[tid * VEC + i] = mean[i];
    s_m2[tid * VEC + i] = m2[i];
  }
  s_n[tid] = n;
  __syncthreads();

  // Tree over the row groups: slot tid absorbs slot tid + stride * TX, which
  // no thread writes at this level.
  for (int stride = TY / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
      const int other = tid + stride * TX;
      const float nb = s_n[other];
      if (nb > 0.f) {
        float na = s_n[tid];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float nn = na;
          chan(nn, s_mean[tid * VEC + i], s_m2[tid * VEC + i], nb,
               s_mean[other * VEC + i], s_m2[other * VEC + i]);
        }
        s_n[tid] = na + nb;
      }
    }
    __syncthreads();
  }

  const int chunks = gridDim.y;
  if (ty == 0 && active) {
    float2* o = partials + ((size_t)b * splits + split) * C + c0;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      o[i] = make_float2(s_mean[tx * VEC + i], s_m2[tx * VEC + i]);
  }
  // The last block of this (b, chunk) merges.  The ticket only picks which
  // block does it; the merge order is fixed.
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * chunks + chunk;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // G groups of threads per channel; group g merges a contiguous run of
  // splits serially, then a tree merges neighbouring runs in order.
  const int nch = TX * VEC;
  const int G = kThreads / nch;
  const int lane = tid % nch, g = tid / nch;
  const int c = chunk * nch + lane;
  const int per = (splits + G - 1) / G;
  const int sb = g * per, se = min(sb + per, splits);
  constexpr int kBatch = 8;  // partials loaded before they are merged
  float gn = 0.f, gm = 0.f, gm2 = 0.f;
  if (c < C && g < G) {
    for (int s = sb; s < se; s += kBatch) {
      float2 ps[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (s + u < se)
          ps[u] = __ldcg(partials + ((size_t)b * splits + s + u) * C + c);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (s + u < se) {
          const int64_t rs = (int64_t)(s + u) * rows_per_split;
          chan(gn, gm, gm2, (float)min64(rows_per_split, R - rs), ps[u].x,
               ps[u].y);
        }
    }
  }
  if (g < G) {
    s_n[tid] = gn;
    s_mean[tid] = gm;
    s_m2[tid] = gm2;
  }
  __syncthreads();
  for (int stride = 1; stride < G; stride *= 2) {
    if (g < G && g % (2 * stride) == 0 && g + stride < G) {
      const int other = tid + stride * nch;
      const float nb = s_n[other];
      if (nb > 0.f) {
        float na = s_n[tid];
        chan(na, s_mean[tid], s_m2[tid], nb, s_mean[other], s_m2[other]);
        s_n[tid] = na;
      }
    }
    __syncthreads();
  }
  if (g == 0 && c < C) {
    if constexpr (PARTIAL) {
      stats[(size_t)b * C + c] = make_float2(s_mean[tid], s_m2[tid]);
    } else {
      const float rstd = rsqrtf(s_m2[tid] / (float)R + kEps);
      stats[(size_t)b * C + c] = make_float2(
          s_mean[tid], rstd * (style[(size_t)b * 2 * C + c] + 1.f));
      if (saved != nullptr)
        saved[(size_t)b * C + c] = make_float2(s_mean[tid], rstd);
    }
  }
  if (tid == 0) *ticket = 0;  // ready for the next call
}

// Pass 2: recompute y and write (y - mean) * scale + s1.
// grid (row blocks, chunks, B), block (TX, TY); the blocks walk the grid
// from its last linear index down, so the first to run may re-read from L2
// what pass 1 read last (0-8% faster than pass 1's order on the H100).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const T* __restrict__ noise,
             const float* __restrict__ nw, const float* __restrict__ style,
             const float2* __restrict__ stats, T* __restrict__ out,
             int64_t R, int C, int64_t rows_per_block) {
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  const unsigned bx = gridDim.x - 1 - blockIdx.x;
  const unsigned by = gridDim.y - 1 - blockIdx.y;
  const int b = (int)(gridDim.z - 1 - blockIdx.z);
  const int c0 = (by * blockDim.x + tx) * VEC;
  if (c0 >= C) return;
  const int64_t r0 = (int64_t)bx * rows_per_block;
  const int64_t r1 = min64(r0 + rows_per_block, R);

  float w[VEC], mean[VEC], scale[VEC], shift[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float2 st = stats[(size_t)b * C + c0 + i];
    w[i] = nw[c0 + i];
    mean[i] = st.x;
    scale[i] = st.y;
    shift[i] = style[(size_t)b * 2 * C + C + c0 + i];
  }
  const T* xb = x + (size_t)b * R * C + c0;
  T* ob = out + (size_t)b * R * C + c0;
  const T* nb = noise + (size_t)b * R;
  for (int64_t r = r0 + ty; r < r1; r += TY) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + r * C);
    const float z = to_float(nb[r]);
    Pack<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = noisy_lrelu(to_float(p.v[i]), w[i], z);
      o.v[i] = from_float<T>(fmaf(y - mean[i], scale[i], shift[i]));
    }
    *reinterpret_cast<Pack<T, VEC>*>(ob + r * C) = o;
  }
}

// -------------------------------------------------------------- backward --
// Given g = d loss / d out, with u = x + nw * n, y = lrelu(u),
// yh = (y - mean) * r and r = rsqrt(var + eps) saved by the forward:
//   ds1[b, c] = sum_r g            ds0[b, c] = sum_r g * yh
//   dy = (s0 + 1) * r * (g - mean_r(g) - yh * mean_r(g * yh))
//   du = u >= 0 ? dy : 0.2 * dy     (dx = du)
//   dnw[c] = sum_{b, r} du * n     dn[b, r] = sum_c du * nw[c]
// Path 1 (onepass_bwd_kernel) holds the (b, chunk) slabs of g and x in
// shared memory and does all of it in one launch.  Path 2 takes the
// per-(b, c) sums in one pass (bwd_sums_kernel), then writes dx and reduces
// dnw and dn in a second (bwd_dx_kernel); both run the grid (splits, chunks,
// B) of blocks (TX, TY), TX * TY == kThreads: thread (tx, ty) owns channels
// c0 .. c0 + VEC - 1 and rows r0 + ty, r0 + ty + TY, ... of its split.  On
// both paths dnw and dn are summed over the row splits (a cluster's ranks on
// path 1) and channel chunks by the last block to finish, found by tickets.

// Rows of g and x in flight per thread (16 bytes each) in bwd_sums_kernel
// and bwd_dx_kernel: f32, bf16 (PERF.md).
constexpr int kBwdSumsUnroll = 4;
constexpr int kBwdSumsUnrollBf16 = 1;
constexpr int kBwdDxUnroll = 2;
constexpr int kBwdDxUnrollBf16 = 2;

// Sum over ty of v[VEC] per lane, in a fixed tree order, into red[tx * VEC
// + i] (red holds the block's threads x VEC floats); read by ty == 0 after
// the call.
template <int VEC>
__device__ __forceinline__ void tree_over_rows(const float (&v)[VEC],
                                               float* red) {
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x;
  const int tid = ty * TX + tx;
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[tid * VEC + i] = v[i];
  __syncthreads();
  for (int stride = blockDim.y / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
      const int other = tid + stride * TX;
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[tid * VEC + i] += red[other * VEC + i];
    }
    __syncthreads();
  }
}

// True in every thread of the block that took the last ticket of `ticket`
// out of `count`; the others may return.  Call after writing the partials.
__device__ __forceinline__ bool last_block(int* ticket, int count,
                                           int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    *s_flag = atomicAdd(ticket, 1) == count - 1;
  __syncthreads();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ float2 as_float2(float v) {
  return make_float2(v, 0.f);
}
__device__ __forceinline__ float2 as_float2(float2 v) { return v; }

// Fixed-order sum of parts[k * stride + c], k < K, for the block's nch
// channels c = c_base .. c_base + nch - 1 (< C): the block's threads form
// nthreads / nch groups, each adding a contiguous run of k (loads batched,
// added in k order), then a tree adds neighbouring runs.  P is float or
// float2; the sums of the first (second) field land in rx[lane] (ry[lane])
// for the threads of group 0 (tid < nch).  Needs nthreads >= nch.
template <typename P>
__device__ __forceinline__ void fixed_order_sum(const P* parts, int64_t K,
                                                int64_t stride, int c_base,
                                                int nch, int C, float* rx,
                                                float* ry) {
  constexpr int kBatch = 8;  // partials loaded before they are added
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int G = nthreads / nch, lane = tid % nch, grp = tid / nch;
  const int c = c_base + lane;
  const int64_t per = (K + G - 1) / G;
  const int64_t kb = grp * per, ke = min64(kb + per, K);
  float2 acc = make_float2(0.f, 0.f);
  if (c < C && grp < G)
    for (int64_t k = kb; k < ke; k += kBatch) {
      P ps[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k + u < ke) ps[u] = __ldcg(parts + (k + u) * stride + c);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k + u < ke) {
          const float2 v = as_float2(ps[u]);
          acc.x += v.x;
          acc.y += v.y;
        }
    }
  if (grp < G) {
    rx[tid] = acc.x;
    if (ry != nullptr) ry[tid] = acc.y;
  }
  __syncthreads();
  for (int s = 1; s < G; s *= 2) {
    if (grp < G && grp % (2 * s) == 0 && grp + s < G) {
      rx[tid] += rx[tid + s * nch];
      if (ry != nullptr) ry[tid] += ry[tid + s * nch];
    }
    __syncthreads();
  }
}

// The end of a backward block, after its rows of dx: write its dnw partial
// (acc, this thread's channels summed over its rows) for (b, split), then,
// in the last block of a chunk over every (b, split), add those partials in
// that order into dnw; and where C spans several chunks, in the last block
// of a (b, split) over the chunks, add the dn partials of its rows [r0, r1)
// in chunk order into dn.  red holds nthreads * VEC floats.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_finish(
    const float (&acc)[VEC], float* red, int* s_flag, bool active, int c0,
    int b, int B, int split, int splits, int chunk, int chunks, int64_t r0,
    int64_t r1, int64_t R, int C, float* dnw, T* dn, float* dnw_parts,
    const float* dn_parts, int* tickets_w, int* tickets_n) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y, tid = ty * blockDim.x + tx;
  const bool want_dnw = dnw != nullptr;
  if (want_dnw) {
    tree_over_rows<VEC>(acc, red);
    if (ty == 0 && active) {
      float* o = dnw_parts + ((size_t)b * splits + split) * C + c0;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = red[tx * VEC + i];
    }
  }
  const bool dn_merge = dn != nullptr && chunks > 1;
  if (!want_dnw && !dn_merge) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int flags = 0;
    if (want_dnw && atomicAdd(tickets_w + chunk, 1) == B * splits - 1)
      flags |= 1;
    if (dn_merge &&
        atomicAdd(tickets_n + (size_t)b * splits + split, 1) == chunks - 1)
      flags |= 2;
    *s_flag = flags;
  }
  __syncthreads();
  const int flags = *s_flag;
  if (flags == 0) return;
  __threadfence();
  if (flags & 1) {  // dnw[c] over every (b, split), in that order
    const int nch = blockDim.x * VEC, c_base = chunk * nch;
    fixed_order_sum(dnw_parts, (int64_t)B * splits, C, c_base, nch, C, red,
                    (float*)nullptr);
    if (tid < nch && c_base + tid < C) dnw[c_base + tid] = red[tid];
    if (tid == 0) tickets_w[chunk] = 0;
  }
  if (flags & 2) {  // dn[b, r] over the chunks, in chunk order
    for (int64_t r = r0 + tid; r < r1; r += nthreads) {
      float v = 0.f;
      for (int k = 0; k < chunks; ++k)
        v += __ldcg(dn_parts + ((size_t)k * B + b) * R + r);
      dn[(size_t)b * R + r] = from_float<T>(v);
    }
    if (tid == 0) tickets_n[(size_t)b * splits + split] = 0;
  }
}

// This thread's share of dn[b, r] (`row`), summed over the TX lanes of its
// row (neighbours in one warp, TX divides 32), written by lane 0 where the
// row exists: into dn when one chunk spans C, else into the chunk's partials.
// Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void dn_row(float row, bool exists, int b, int B,
                                       int chunk, int chunks, int64_t r,
                                       int64_t R, T* dn, float* dn_parts) {
  const int TX = blockDim.x, nthreads = TX * blockDim.y;
  const unsigned mask = nthreads >= 32 ? 0xffffffffu : (1u << nthreads) - 1u;
  for (int off = TX / 2; off > 0; off >>= 1)
    row += __shfl_xor_sync(mask, row, off);
  if (threadIdx.x == 0 && exists) {
    if (chunks == 1)
      dn[(size_t)b * R + r] = from_float<T>(row);
    else
      dn_parts[((size_t)chunk * B + b) * R + r] = row;
  }
}

// ------------------------------------------------------ backward, path 1 --
// grid (chunks * cluster, B), block (TX, TY), clusters of `cluster` blocks
// along x, as onepass_kernel: block `rank` holds rows [rank * rpr,
// (rank+1) * rpr) of the (b, chunk) slabs of g and x, and thread (tx, ty)
// owns channels c0 .. c0 + VEC - 1 of rows ty, ty + TY, ... of them.  It
// takes the block's sums of g and g * (y - mean) from shared memory in a
// fixed tree, adds the cluster's partials over DSMEM in rank order, forms
// the coefficients, writes dstyle (rank 0), then dx from shared memory; dnw
// and dn take the tickets of bwd_finish with the ranks as row splits.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
onepass_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const T* __restrict__ noise, const float* __restrict__ nw,
                   const float* __restrict__ style,
                   const float2* __restrict__ saved, T* __restrict__ dx,
                   float* __restrict__ dnw, T* __restrict__ dn,
                   float* __restrict__ dstyle, float* __restrict__ dnw_parts,
                   float* __restrict__ dn_parts, int* __restrict__ tickets_w,
                   int* __restrict__ tickets_n, int64_t R, int C, int cluster,
                   int64_t rpr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y, tid = ty * TX + tx;
  const int cc = TX * VEC;
  const int rank = blockIdx.x % cluster, chunk = blockIdx.x / cluster;
  const int chunks = gridDim.x / cluster, b = blockIdx.y, B = gridDim.y;
  const int64_t r0 = (int64_t)rank * rpr;
  const int rows = (int)(r0 < R ? min64(rpr, R - r0) : 0);

  const int64_t slab = sgt::align16(rpr * cc * sizeof(T));
  T* s_g = reinterpret_cast<T*>(smem);
  T* s_x = reinterpret_cast<T*>(smem + slab);
  T* s_z = reinterpret_cast<T*>(smem + 2 * slab);
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(s_z) + sgt::align16(rpr * sizeof(T)));
  float2* s_ex = reinterpret_cast<float2*>(
      reinterpret_cast<unsigned char*>(red) + sgt::align16(TY * cc * 4));

  const int c0 = chunk * cc + tx * VEC;
  const bool active = c0 < C;
  const size_t base = ((size_t)b * R + r0) * C + c0;
  if (active)
    for (int r = ty; r < rows; r += TY) {
      copy_in<T, VEC>(s_g + r * cc + tx * VEC, g + base + (size_t)r * C);
      copy_in<T, VEC>(s_x + r * cc + tx * VEC, x + base + (size_t)r * C);
    }
  const T* nb = noise + (size_t)b * R + r0;
  for (int r = tid; r < rows; r += TX * TY) s_z[r] = nb[r];
  float w[VEC], mean[VEC], rstd[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float2 st =
        active ? saved[(size_t)b * C + c0 + i] : make_float2(0.f, 0.f);
    w[i] = active ? nw[c0 + i] : 0.f;
    mean[i] = st.x;
    rstd[i] = st.y;
  }
  copy_wait_all();
  __syncthreads();

  float sg[VEC], sgy[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sg[i] = sgy[i] = 0.f;
  if (active)
    for (int r = ty; r < rows; r += TY) {
      const Pack<T, VEC> pg =
          *reinterpret_cast<const Pack<T, VEC>*>(s_g + r * cc + tx * VEC);
      const Pack<T, VEC> px =
          *reinterpret_cast<const Pack<T, VEC>*>(s_x + r * cc + tx * VEC);
      const float z = to_float(s_z[r]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float gv = to_float(pg.v[i]);
        const float y = noisy_lrelu(to_float(px.v[i]), w[i], z);
        sg[i] += gv;
        sgy[i] = fmaf(gv, y - mean[i], sgy[i]);
      }
    }
  block_sum<VEC>(sg, red);
  block_sum<VEC>(sgy, red);

  if (cluster > 1) {
    // every block adds all ranks' sums in rank order: the same operations
    // in the same order, so the blocks of a cluster agree
    cg::cluster_group cl = cg::this_cluster();
    if (ty == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        s_ex[tx * VEC + i] = make_float2(sg[i], sgy[i]);
    }
    cl.sync();
#pragma unroll
    for (int i = 0; i < VEC; ++i) sg[i] = sgy[i] = 0.f;
    for (int k = 0; k < cluster; ++k) {
      const float2* ex = cl.map_shared_rank(s_ex, k);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float2 e = ex[tx * VEC + i];
        sg[i] += e.x;
        sgy[i] += e.y;
      }
    }
    cl.sync();  // no block leaves while another reads its partials
  }

  // dy = a * g - k0 - (y - mean) * k1, as bwd_sums_kernel's coefficients
  const float* sb = style + (size_t)b * 2 * C;
  const float inv_r = 1.f / (float)R;
  float a[VEC], k0[VEC], k1[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float sum_gy = sgy[i] * rstd[i];  // sum g * yh
    a[i] = active ? (sb[c0 + i] + 1.f) * rstd[i] : 0.f;
    k0[i] = a[i] * sg[i] * inv_r;
    k1[i] = a[i] * sum_gy * inv_r * rstd[i];
    if (dstyle != nullptr && active && rank == 0 && ty == 0) {
      dstyle[(size_t)b * 2 * C + c0 + i] = sum_gy;
      dstyle[(size_t)b * 2 * C + C + c0 + i] = sg[i];
    }
  }

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  const bool want_dn = dn != nullptr;
  T* dxb = dx == nullptr ? nullptr : dx + base;
  // every thread runs the same row iterations, for dn_row's shuffles
  for (int rb = 0; rb < rows; rb += TY) {
    const int r = rb + ty;
    float row = 0.f;  // this thread's channels' share of dn[b, r0 + r]
    if (active && r < rows) {
      const Pack<T, VEC> pg =
          *reinterpret_cast<const Pack<T, VEC>*>(s_g + r * cc + tx * VEC);
      const Pack<T, VEC> px =
          *reinterpret_cast<const Pack<T, VEC>*>(s_x + r * cc + tx * VEC);
      const float z = to_float(s_z[r]);
      Pack<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float uu = noisy(to_float(px.v[i]), w[i], z);
        const float y = uu >= 0.f ? uu : kSlope * uu;
        const float dy =
            fmaf(a[i], to_float(pg.v[i]), -k0[i]) - (y - mean[i]) * k1[i];
        const float du = uu >= 0.f ? dy : kSlope * dy;
        o.v[i] = from_float<T>(du);
        acc[i] = fmaf(du, z, acc[i]);
        row = fmaf(du, w[i], row);
      }
      if (dxb != nullptr)
        *reinterpret_cast<Pack<T, VEC>*>(dxb + (size_t)r * C) = o;
    }
    if (want_dn)
      dn_row<T>(row, r < rows, b, B, chunk, chunks, r0 + r, R, dn, dn_parts);
  }
  // its shared memory is all dynamic (a static part would count against
  // the opt-in maximum); the ticket flag takes s_ex, free once the cluster
  // has exchanged its sums
  int* s_flag = reinterpret_cast<int*>(s_ex);
  bwd_finish<T, VEC>(acc, red, s_flag, active, c0, b, B, rank, cluster,
                     chunk, chunks, r0, r0 + rows, R, C, dnw, dn, dnw_parts,
                     dn_parts, tickets_w, tickets_n);
}

// ------------------------------------------------------ backward, path 2 --
// coef = (mean, a, a * mean(g), a * r * mean(g * yh)) with a = (s0 + 1) * r,
// from st = (mean, r) and the sums of g and g * (y - mean) over the plane's
// rows (inv_rows = 1 / rows), so that pass 2 computes
// dy = a * g - coef.z - (y - mean) * coef.w.
__device__ __forceinline__ float4 bwd_coef(float2 st, float sum_g,
                                           float sum_gym, float s0,
                                           float inv_rows) {
  const float sum_gy = sum_gym * st.y;  // * r: sum g * yh
  const float a = (s0 + 1.f) * st.y;
  return make_float4(st.x, a, a * sum_g * inv_rows,
                     a * sum_gy * inv_rows * st.y);
}

// Pass 1: partials (sum g, sum g * (y - mean)) per (b, split, c); the last
// block of a (b, chunk) adds the splits in a fixed order and writes dstyle
// (when asked) and coef (bwd_coef).  With PARTIAL (K3-partial: this rank's
// rows of a split plane) it writes the added sums into `sums` instead of
// coef, and dstyle (when asked) as this rank's share; it reads no style.
template <typename T, int VEC, bool PARTIAL = false,
          int UNROLL = VEC == 8 ? kBwdSumsUnrollBf16 : kBwdSumsUnroll>
__global__ void __launch_bounds__(kThreads)
bwd_sums_kernel(const T* __restrict__ g, const T* __restrict__ x,
                const T* __restrict__ noise, const float* __restrict__ nw,
                const float* __restrict__ style,
                const float2* __restrict__ saved, float2* __restrict__ parts,
                float4* __restrict__ coef, float2* __restrict__ sums,
                float* __restrict__ dstyle, int* __restrict__ tickets,
                int64_t R, int C, int64_t rows_per_split) {
  __shared__ float s_g[kThreads * VEC];
  __shared__ float s_gy[kThreads * VEC];
  __shared__ int s_flag;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int split = blockIdx.x, splits = gridDim.x, chunk = blockIdx.y;
  const int chunks = gridDim.y, b = blockIdx.z;
  const int c0 = (chunk * TX + tx) * VEC;
  const bool active = c0 < C;
  const int64_t r0 = (int64_t)split * rows_per_split;
  const int64_t r1 = min64(r0 + rows_per_split, R);

  float w[VEC], mean[VEC], sg[VEC], sgy[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    w[i] = active ? nw[c0 + i] : 0.f;
    mean[i] = active ? saved[(size_t)b * C + c0 + i].x : 0.f;
    sg[i] = sgy[i] = 0.f;
  }
  if (active) {
    const T* gb = g + (size_t)b * R * C + c0;
    const T* xb = x + (size_t)b * R * C + c0;
    const T* nb = noise + (size_t)b * R;
    for (int64_t r = r0 + ty; r < r1; r += (int64_t)TY * UNROLL) {
      Pack<T, VEC> pg[UNROLL], px[UNROLL];
      float z[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // all loads first, then the math
        const int64_t ru = r + (int64_t)u * TY;
        if (ru < r1) {
          pg[u] = *reinterpret_cast<const Pack<T, VEC>*>(gb + ru * C);
          px[u] = *reinterpret_cast<const Pack<T, VEC>*>(xb + ru * C);
          z[u] = to_float(nb[ru]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + (int64_t)u * TY < r1) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float gv = to_float(pg[u].v[i]);
            const float y = noisy_lrelu(to_float(px[u].v[i]), w[i], z[u]);
            sg[i] += gv;
            sgy[i] = fmaf(gv, y - mean[i], sgy[i]);
          }
        }
      }
    }
  }
  tree_over_rows<VEC>(sg, s_g);
  tree_over_rows<VEC>(sgy, s_gy);
  if (ty == 0 && active) {
    float2* o = parts + ((size_t)b * splits + split) * C + c0;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      o[i] = make_float2(s_g[tx * VEC + i], s_gy[tx * VEC + i]);
  }
  int* ticket = tickets + (size_t)b * chunks + chunk;
  if (!last_block(ticket, splits, &s_flag)) return;

  const int nch = TX * VEC, c_base = chunk * nch;
  fixed_order_sum(parts + (size_t)b * splits * C, splits, C, c_base, nch, C,
                  s_g, s_gy);
  const int tid = ty * TX + tx, c = c_base + tid;
  if (tid < nch && c < C) {
    const float2 st = saved[(size_t)b * C + c];
    const float sum_g = s_g[tid], sum_gym = s_gy[tid];
    if (dstyle != nullptr) {
      dstyle[(size_t)b * 2 * C + c] = sum_gym * st.y;  // * r: sum g * yh
      dstyle[(size_t)b * 2 * C + C + c] = sum_g;
    }
    if constexpr (PARTIAL) {
      sums[(size_t)b * C + c] = make_float2(sum_g, sum_gym);
    } else {
      coef[(size_t)b * C + c] = bwd_coef(st, sum_g, sum_gym,
                                         style[(size_t)b * 2 * C + c],
                                         1.f / (float)R);
    }
  }
  if (tid == 0) *ticket = 0;  // ready for the next call
}

// Pass 2: dx, and partials of dnw per (b, split, c) and of dn per (chunk, b,
// r), merged by bwd_finish.  It walks its blocks, and each block its rows,
// in the reverse of pass 1's order, so that it first re-reads what pass 1
// read last (PERF.md).  Every thread runs the same row iterations, so that
// the TX lanes of a row can add their channels' dn terms with warp shuffles.
// With SPLIT (K3-apply: this rank's rows of a split plane) each thread forms
// its channels' coef itself (bwd_coef) from `saved`, the ranks' merged
// `sums` and style, over the plane's rows (inv_rows), instead of reading
// pass 1's; dnw is then this rank's share.
template <typename T, int VEC, bool SPLIT = false,
          int UNROLL = VEC == 8 ? kBwdDxUnrollBf16 : kBwdDxUnroll>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
              const T* __restrict__ noise, const float* __restrict__ nw,
              const float4* __restrict__ coef, T* __restrict__ dx,
              float* __restrict__ dnw, T* __restrict__ dn,
              float* __restrict__ dnw_parts, float* __restrict__ dn_parts,
              int* __restrict__ tickets_w, int* __restrict__ tickets_n,
              int64_t R, int C, int64_t rows_per_split,
              const float2* __restrict__ saved,
              const float2* __restrict__ sums,
              const float* __restrict__ style, float inv_rows) {
  __shared__ float s_w[kThreads * VEC];
  __shared__ int s_flag;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int splits = gridDim.x, chunks = gridDim.y, B = gridDim.z;
  const int split = splits - 1 - blockIdx.x;
  const int chunk = chunks - 1 - blockIdx.y;
  const int b = B - 1 - blockIdx.z;
  const int c0 = (chunk * TX + tx) * VEC;
  const bool active = c0 < C;
  const int64_t r0 = (int64_t)split * rows_per_split;
  const int64_t r1 = min64(r0 + rows_per_split, R);
  const bool want_dn = dn != nullptr;

  float w[VEC], mean[VEC], a[VEC], k0[VEC], k1[VEC], acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float4 k = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {
      const size_t bc = (size_t)b * C + c0 + i;
      if constexpr (SPLIT) {
        const float2 sm = sums[bc];
        k = bwd_coef(saved[bc], sm.x, sm.y, style[(size_t)b * 2 * C + c0 + i],
                     inv_rows);
      } else {
        k = coef[bc];
      }
    }
    w[i] = active ? nw[c0 + i] : 0.f;
    mean[i] = k.x;
    a[i] = k.y;
    k0[i] = k.z;
    k1[i] = k.w;
    acc[i] = 0.f;
  }
  const T* gb = g + (size_t)b * R * C + c0;
  const T* xb = x + (size_t)b * R * C + c0;
  T* dxb = dx == nullptr ? nullptr : dx + (size_t)b * R * C + c0;
  const T* nb = noise + (size_t)b * R;
  const int64_t step = (int64_t)TY * UNROLL;
  const int64_t steps = (r1 - r0 + step - 1) / step;
  for (int64_t s = 0; s < steps; ++s) {
    const int64_t base = r0 + (steps - 1 - s) * step;
    Pack<T, VEC> pg[UNROLL], px[UNROLL];
    float z[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t ru = base + ty + (int64_t)u * TY;
      if (active && ru < r1) {
        pg[u] = *reinterpret_cast<const Pack<T, VEC>*>(gb + ru * C);
        px[u] = *reinterpret_cast<const Pack<T, VEC>*>(xb + ru * C);
        z[u] = to_float(nb[ru]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t ru = base + ty + (int64_t)u * TY;
      float row = 0.f;  // this thread's channels' share of dn[b, ru]
      if (active && ru < r1) {
        Pack<T, VEC> o;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float uu = noisy(to_float(px[u].v[i]), w[i], z[u]);
          const float y = uu >= 0.f ? uu : kSlope * uu;
          const float dy =
              fmaf(a[i], to_float(pg[u].v[i]), -k0[i]) - (y - mean[i]) * k1[i];
          const float du = uu >= 0.f ? dy : kSlope * dy;
          o.v[i] = from_float<T>(du);
          acc[i] = fmaf(du, z[u], acc[i]);
          row = fmaf(du, w[i], row);
        }
        if (dxb != nullptr) *reinterpret_cast<Pack<T, VEC>*>(dxb + ru * C) = o;
      }
      if (want_dn)
        dn_row<T>(row, ru < r1, b, B, chunk, chunks, ru, R, dn, dn_parts);
    }
  }
  bwd_finish<T, VEC>(acc, s_w, &s_flag, active, c0, b, B, split, splits,
                     chunk, chunks, r0, r1, R, C, dnw, dn, dnw_parts,
                     dn_parts, tickets_w, tickets_n);
}

// ------------------------------------------------------------- launching --
// Launches a one-pass kernel on the grid (chunks * cluster, B) in clusters
// of `cluster` blocks along x.  It may take up to 227 KB of dynamic shared
// memory: opted in once per kernel and device (`done`, a bit per device),
// not per call.
template <typename... Params, typename... Args>
cudaError_t launch_onepass(void (*kernel)(Params...), unsigned* done,
                           int chunks, int cluster, int B, dim3 block,
                           long long smem_bytes, cudaStream_t stream,
                           Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(dev < 32 && (*done >> dev & 1u))) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sgt::kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 32) *done |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(chunks * cluster), (unsigned)B);
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int VEC>
cudaError_t launch(const SgtPlan& p, const void* xv, const void* noisev,
                   const void* nwv, const void* stylev, void* outv,
                   void* savedv, void* workspace, int B, int64_t R, int C,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* noise = static_cast<const T*>(noisev);
  const float* nw = static_cast<const float*>(nwv);
  const float* style = static_cast<const float*>(stylev);
  T* out = static_cast<T*>(outv);
  float2* saved = static_cast<float2*>(savedv);
  const dim3 block(p.tx, p.ty);
  if (p.path == 1) {
    static unsigned done = 0;
    return launch_onepass(onepass_kernel<T, VEC>, &done, p.chunks, p.cluster,
                          B, block, p.smem_bytes, stream, x, noise, nw, style,
                          out, saved, (int64_t)R, C, p.cluster,
                          (int64_t)p.rows_per_rank);
  }
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  float2* partials = reinterpret_cast<float2*>(ws);
  float2* stats = reinterpret_cast<float2*>(ws + p.stats_offset);
  int* tickets = reinterpret_cast<int*>(ws + p.tickets_offset);
  stats_kernel<T, VEC><<<dim3(p.splits, p.chunks, B), block, 0, stream>>>(
      x, noise, nw, style, partials, stats, saved, tickets, R, C,
      p.rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned row_blocks = (unsigned)sgt::cdiv(R, p.rows_per_block);
  apply_kernel<T, VEC><<<dim3(row_blocks, p.chunks, B), block, 0, stream>>>(
      x, noise, nw, style, stats, out, R, C, p.rows_per_block);
  return cudaGetLastError();
}

// The split-plane forward (a plane whose rows lie on several ranks), on a
// plan of sgt_epilogue_split_plan: K1-partial writes this rank's (mean, M2)
// per (b, c) over its R rows into `partial`; after the caller's rank-order
// merge, K2-apply reads (mean, rstd * (s0 + 1)) per (b, c) from `stats`.
template <typename T, int VEC>
cudaError_t launch_partial(const SgtPlan& p, const void* xv,
                           const void* noisev, const void* nwv,
                           void* partialv, void* workspace, int B, int64_t R,
                           int C, cudaStream_t stream) {
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  stats_kernel<T, VEC, true>
      <<<dim3(p.splits, p.chunks, B), dim3(p.tx, p.ty), 0, stream>>>(
          static_cast<const T*>(xv), static_cast<const T*>(noisev),
          static_cast<const float*>(nwv), nullptr,
          reinterpret_cast<float2*>(ws), static_cast<float2*>(partialv),
          nullptr, reinterpret_cast<int*>(ws + p.tickets_offset), R, C,
          p.rows_per_split);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_apply(const SgtPlan& p, const void* xv, const void* noisev,
                         const void* nwv, const void* stylev,
                         const void* statsv, void* outv, int B, int64_t R,
                         int C, cudaStream_t stream) {
  const unsigned row_blocks = (unsigned)sgt::cdiv(R, p.rows_per_block);
  apply_kernel<T, VEC>
      <<<dim3(row_blocks, p.chunks, B), dim3(p.tx, p.ty), 0, stream>>>(
          static_cast<const T*>(xv), static_cast<const T*>(noisev),
          static_cast<const float*>(nwv), static_cast<const float*>(stylev),
          static_cast<const float2*>(statsv), static_cast<T*>(outv), R, C,
          p.rows_per_block);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const SgtBwdPlan& p, const void* gv, const void* xv,
                       const void* noisev, const void* nwv,
                       const void* stylev, const void* savedv, void* dxv,
                       void* dnwv, void* dnv, void* dstylev, void* workspace,
                       int B, int64_t R, int C, cudaStream_t stream) {
  const T* g = static_cast<const T*>(gv);
  const T* x = static_cast<const T*>(xv);
  const T* noise = static_cast<const T*>(noisev);
  const float* nw = static_cast<const float*>(nwv);
  const float* style = static_cast<const float*>(stylev);
  const float2* saved = static_cast<const float2*>(savedv);
  T* dx = static_cast<T*>(dxv);
  float* dnw = static_cast<float*>(dnwv);
  T* dn = static_cast<T*>(dnv);
  float* dstyle = static_cast<float*>(dstylev);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  float2* parts = reinterpret_cast<float2*>(ws);
  float4* coef = reinterpret_cast<float4*>(ws + p.coef_offset);
  float* dnw_parts = reinterpret_cast<float*>(ws + p.dnw_offset);
  float* dn_parts = reinterpret_cast<float*>(ws + p.dn_offset);
  int* tickets = reinterpret_cast<int*>(ws + p.tickets_offset);
  int* tickets_w = tickets + (size_t)B * p.chunks;
  int* tickets_n = tickets_w + p.chunks;
  const dim3 block(p.tx, p.ty);
  if (p.path == 1) {
    static unsigned done = 0;
    return launch_onepass(onepass_bwd_kernel<T, VEC>, &done, p.chunks,
                          p.cluster, B, block, p.smem_bytes, stream, g, x,
                          noise, nw, style, saved, dx, dnw, dn, dstyle,
                          dnw_parts, dn_parts, tickets_w, tickets_n,
                          (int64_t)R, C, p.cluster,
                          (int64_t)p.rows_per_split);
  }
  const dim3 grid(p.splits, p.chunks, B);
  bwd_sums_kernel<T, VEC><<<grid, block, 0, stream>>>(
      g, x, noise, nw, style, saved, parts, coef, nullptr, dstyle, tickets, R,
      C, p.rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dx_kernel<T, VEC><<<grid, block, 0, stream>>>(
      g, x, noise, nw, coef, dx, dnw, dn, dnw_parts, dn_parts, tickets_w,
      tickets_n, R, C, p.rows_per_split, nullptr, nullptr, nullptr, 0.f);
  return cudaGetLastError();
}

// The split-plane backward (a plane whose rows lie on several ranks), on a
// plan of sgt_epilogue_bwd_split_plan: K3-partial writes this rank's
// (sum g, sum g * (y - mean)) per (b, c) over its R rows into `sums` and,
// where dstyle is not null, this rank's share of dstyle; after the caller's
// rank-order sum, K3-apply writes dx, dnw (this rank's share) and dn from the
// merged sums over the plane's rows.  Their workspace parts do not overlap:
// K3-partial takes the pass-1 partials and tickets, K3-apply the dnw and dn
// partials and their tickets.
template <typename T, int VEC>
cudaError_t launch_bwd_partial(const SgtBwdPlan& p, const void* gv,
                               const void* xv, const void* noisev,
                               const void* nwv, const void* savedv,
                               void* sumsv, void* dstylev, void* workspace,
                               int B, int64_t R, int C, cudaStream_t stream) {
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  bwd_sums_kernel<T, VEC, true>
      <<<dim3(p.splits, p.chunks, B), dim3(p.tx, p.ty), 0, stream>>>(
          static_cast<const T*>(gv), static_cast<const T*>(xv),
          static_cast<const T*>(noisev), static_cast<const float*>(nwv),
          nullptr, static_cast<const float2*>(savedv),
          reinterpret_cast<float2*>(ws), nullptr,
          static_cast<float2*>(sumsv), static_cast<float*>(dstylev),
          reinterpret_cast<int*>(ws + p.tickets_offset), R, C,
          p.rows_per_split);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd_apply(const SgtBwdPlan& p, const void* gv,
                             const void* xv, const void* noisev,
                             const void* nwv, const void* stylev,
                             const void* savedv, const void* sumsv,
                             long long plane_rows, void* dxv, void* dnwv,
                             void* dnv, void* workspace, int B, int64_t R,
                             int C, cudaStream_t stream) {
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  int* tickets_w =
      reinterpret_cast<int*>(ws + p.tickets_offset) + (size_t)B * p.chunks;
  bwd_dx_kernel<T, VEC, true>
      <<<dim3(p.splits, p.chunks, B), dim3(p.tx, p.ty), 0, stream>>>(
          static_cast<const T*>(gv), static_cast<const T*>(xv),
          static_cast<const T*>(noisev), static_cast<const float*>(nwv),
          nullptr, static_cast<T*>(dxv), static_cast<float*>(dnwv),
          static_cast<T*>(dnv), reinterpret_cast<float*>(ws + p.dnw_offset),
          reinterpret_cast<float*>(ws + p.dn_offset), tickets_w,
          tickets_w + p.chunks, R, C, p.rows_per_split,
          static_cast<const float2*>(savedv),
          static_cast<const float2*>(sumsv), static_cast<const float*>(stylev),
          1.f / (float)plane_rows);
  return cudaGetLastError();
}

}  // namespace

// Launches one epilogue call on `stream`: the one or two kernels of `plan`,
// which sgt_epilogue_plan made for this (is_bf16, B, R, C) and alignment.
// Where `saved` is not null (a call whose gradient may be needed) the
// kernels also write (mean, rstd) per (b, c) there, (B, C) float2, for the
// backward; inference passes null.
// Returns 0 on success, else a cudaError_t (cudaErrorInvalidValue when the
// plan does not fit the call: vectors over an unaligned pointer, or a
// workspace short of the plan's).  The caller allocates out (B, R, C) and a
// workspace of the plan's workspace_bytes whose tickets (from
// tickets_offset) are zero; the kernels leave them at zero, so the caller
// may reuse it for later calls in the same stream order.
extern "C" int sgt_epilogue_forward(
    const void* x, const void* noise, const void* noise_weight,
    const void* style, void* out, void* workspace, long long workspace_bytes,
    int is_bf16, int B, long long R, int C, const SgtPlan* plan, void* saved,
    void* stream) {
  const SgtPlan& p = *plan;
  const bool aligned = (((uintptr_t)x | (uintptr_t)out) % 16) == 0;
  if ((p.vec > 1 && !aligned) || p.workspace_bytes > workspace_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_LAUNCH(T, V) \
  launch<T, V>(p, x, noise, noise_weight, style, out, saved, workspace, B, R, \
               C, s)
  if (!is_bf16 && p.vec == 4) return (int)SGT_LAUNCH(float, 4);
  if (!is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(float, 1);
  if (is_bf16 && p.vec == 8) return (int)SGT_LAUNCH(__nv_bfloat16, 8);
  if (is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(__nv_bfloat16, 1);
#undef SGT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Launches the backward of one epilogue call on `stream`: the one or two
// kernels of `plan`, which sgt_epilogue_bwd_plan made for this (is_bf16, B,
// R, C), alignment and want_dn (dn not null).  g, x and dx are (B, R, C),
// noise and dn (B, R) in the forward's dtype; noise_weight and dnw (C,),
// style and dstyle (B, 2C), saved (B, C) float2, all float32.  dx, dnw, dn
// and dstyle may each be null: that gradient is then not written.  The
// workspace is the plan's workspace_bytes with its tickets (from
// tickets_offset) zero; the kernels leave them at zero.  Returns 0 or a
// cudaError_t, as sgt_epilogue_forward does.
extern "C" int sgt_epilogue_backward(
    const void* g, const void* x, const void* noise, const void* noise_weight,
    const void* style, const void* saved, void* dx, void* dnw, void* dn,
    void* dstyle, void* workspace, long long workspace_bytes, int is_bf16,
    int B, long long R, int C, const SgtBwdPlan* plan, void* stream) {
  const SgtBwdPlan& p = *plan;
  const bool aligned =
      (((uintptr_t)g | (uintptr_t)x | (uintptr_t)dx) % 16) == 0;
  if ((p.vec > 1 && !aligned) || p.workspace_bytes > workspace_bytes ||
      (dn != nullptr && p.chunks > 1 && !p.dn_partials))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_LAUNCH(T, V)                                                    \
  launch_bwd<T, V>(p, g, x, noise, noise_weight, style, saved, dx, dnw, dn, \
                   dstyle, workspace, B, R, C, s)
  if (!is_bf16 && p.vec == 4) return (int)SGT_LAUNCH(float, 4);
  if (!is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(float, 1);
  if (is_bf16 && p.vec == 8) return (int)SGT_LAUNCH(__nv_bfloat16, 8);
  if (is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(__nv_bfloat16, 1);
#undef SGT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K1-partial: the per-(b, c) (mean, M2) of y = lrelu(x + nw * noise) over
// this rank's R rows of a split plane, into `partial`, (B, C) float2, on
// `stream`; one launch.  x (B, R, C) and noise (B, R) in one dtype,
// noise_weight (C,) float32; the plan is sgt_epilogue_split_plan's, and the
// workspace its workspace_bytes with the tickets (from tickets_offset)
// zero, which the kernel leaves at zero.  Returns 0 or a cudaError_t, as
// sgt_epilogue_forward does.
extern "C" int sgt_epilogue_partial(const void* x, const void* noise,
                                    const void* noise_weight, void* partial,
                                    void* workspace, long long workspace_bytes,
                                    int is_bf16, int B, long long R, int C,
                                    const SgtPlan* plan, void* stream) {
  const SgtPlan& p = *plan;
  if (p.path != 2 || (p.vec > 1 && (uintptr_t)x % 16 != 0) ||
      p.workspace_bytes > workspace_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_LAUNCH(T, V) \
  launch_partial<T, V>(p, x, noise, noise_weight, partial, workspace, B, R, \
                       C, s)
  if (!is_bf16 && p.vec == 4) return (int)SGT_LAUNCH(float, 4);
  if (!is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(float, 1);
  if (is_bf16 && p.vec == 8) return (int)SGT_LAUNCH(__nv_bfloat16, 8);
  if (is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(__nv_bfloat16, 1);
#undef SGT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K2-apply: out = (y - mean) * scale + s1 over this rank's R rows, with
// (mean, scale = rstd * (s0 + 1)) per (b, c) read from `stats`, (B, C)
// float2, which the caller merged from every rank's K1-partial; style
// (B, 2C) float32 gives s1.  One launch on `stream`, no workspace; the plan
// is sgt_epilogue_split_plan's.  Returns 0 or a cudaError_t.
extern "C" int sgt_epilogue_apply(const void* x, const void* noise,
                                  const void* noise_weight, const void* style,
                                  const void* stats, void* out, int is_bf16,
                                  int B, long long R, int C,
                                  const SgtPlan* plan, void* stream) {
  const SgtPlan& p = *plan;
  const bool aligned = (((uintptr_t)x | (uintptr_t)out) % 16) == 0;
  if (p.path != 2 || (p.vec > 1 && !aligned))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_LAUNCH(T, V) \
  launch_apply<T, V>(p, x, noise, noise_weight, style, stats, out, B, R, C, s)
  if (!is_bf16 && p.vec == 4) return (int)SGT_LAUNCH(float, 4);
  if (!is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(float, 1);
  if (is_bf16 && p.vec == 8) return (int)SGT_LAUNCH(__nv_bfloat16, 8);
  if (is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(__nv_bfloat16, 1);
#undef SGT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K3-partial: this rank's (sum g, sum g * (y - mean)) per (b, c) over its R
// rows of a split plane into `sums`, (B, C) float2, and, where dstyle is not
// null, its share of dstyle, (B, 2C) float32: [sum g * yh | sum g].  saved
// is the (B, C) float2 (mean, rstd) merged over the plane that the split
// forward saved.  g and x (B, R, C) and noise (B, R) in one dtype,
// noise_weight (C,) float32; the plan is sgt_epilogue_bwd_split_plan's, the
// workspace its workspace_bytes with the tickets zero, which the kernel
// leaves at zero.  One launch on `stream`; returns 0 or a cudaError_t.
extern "C" int sgt_epilogue_backward_partial(
    const void* g, const void* x, const void* noise, const void* noise_weight,
    const void* saved, void* sums, void* dstyle, void* workspace,
    long long workspace_bytes, int is_bf16, int B, long long R, int C,
    const SgtBwdPlan* plan, void* stream) {
  const SgtBwdPlan& p = *plan;
  const bool aligned = (((uintptr_t)g | (uintptr_t)x) % 16) == 0;
  if (p.path != 2 || (p.vec > 1 && !aligned) ||
      p.workspace_bytes > workspace_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_LAUNCH(T, V)                                                    \
  launch_bwd_partial<T, V>(p, g, x, noise, noise_weight, saved, sums, dstyle, \
                           workspace, B, R, C, s)
  if (!is_bf16 && p.vec == 4) return (int)SGT_LAUNCH(float, 4);
  if (!is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(float, 1);
  if (is_bf16 && p.vec == 8) return (int)SGT_LAUNCH(__nv_bfloat16, 8);
  if (is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(__nv_bfloat16, 1);
#undef SGT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K3-apply: dx (B, R, C), this rank's share of dnoise_weight (C,) float32
// and its rows of dnoise (B, R), each where not null, from `sums`, the
// (B, C) float2 that every rank's K3-partial gave, added in rank order, over
// the plane's `plane_rows` rows; style (B, 2C) float32 and saved as for
// K3-partial.  The plan is sgt_epilogue_bwd_split_plan's (want_dn as dn is
// given), the workspace its workspace_bytes with the tickets zero.  One
// launch on `stream`; returns 0 or a cudaError_t.
extern "C" int sgt_epilogue_backward_apply(
    const void* g, const void* x, const void* noise, const void* noise_weight,
    const void* style, const void* saved, const void* sums,
    long long plane_rows, void* dx, void* dnw, void* dn, void* workspace,
    long long workspace_bytes, int is_bf16, int B, long long R, int C,
    const SgtBwdPlan* plan, void* stream) {
  const SgtBwdPlan& p = *plan;
  const bool aligned =
      (((uintptr_t)g | (uintptr_t)x | (uintptr_t)dx) % 16) == 0;
  if (p.path != 2 || (p.vec > 1 && !aligned) ||
      p.workspace_bytes > workspace_bytes || plane_rows < R ||
      (dn != nullptr && p.chunks > 1 && !p.dn_partials))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_LAUNCH(T, V)                                                     \
  launch_bwd_apply<T, V>(p, g, x, noise, noise_weight, style, saved, sums,  \
                         plane_rows, dx, dnw, dn, workspace, B, R, C, s)
  if (!is_bf16 && p.vec == 4) return (int)SGT_LAUNCH(float, 4);
  if (!is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(float, 1);
  if (is_bf16 && p.vec == 8) return (int)SGT_LAUNCH(__nv_bfloat16, 8);
  if (is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(__nv_bfloat16, 1);
#undef SGT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
