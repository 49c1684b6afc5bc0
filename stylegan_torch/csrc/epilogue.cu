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
// Common to both: noise is read as one scalar per row, never broadcast to
// (B, R, C) in memory; every thread moves 16 bytes per load and store along
// C (VEC = 4 floats or 8 bf16), or scalars where C or a pointer does not
// allow it; partials merge with Chan's pairwise formula, never as
// E[y^2] - mean^2, which cancels over 2^20 post-lrelu values with a positive
// mean.  No atomics touch a sum, so results are bitwise deterministic.
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

__device__ __forceinline__ float noisy_lrelu(float x, float w, float z) {
  const float y = x + w * z;
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
               T* __restrict__ out, int64_t R, int C, int cluster,
               int64_t rpr) {
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
    scale[i] = rsqrtf(m2[i] / (float)R + kEps) * (s0[c0 + i] + 1.f);
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
// its splits and writes stats (mean, rstd * (s0 + 1)).
// Each thread issues UNROLL loads before their Welford updates.  bf16's
// 8-wide vectors already hold 8 Welford states a thread: more loads in
// flight cost occupancy and lost on the H100 (PERF.md).
template <typename T, int VEC, int UNROLL = VEC == 8 ? 1 : 4>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, const T* __restrict__ noise,
             const float* __restrict__ nw, const float* __restrict__ style,
             float2* __restrict__ partials, float2* __restrict__ stats,
             int* __restrict__ tickets, int64_t R, int C,
             int64_t rows_per_split) {
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
    const float rstd = rsqrtf(s_m2[tid] / (float)R + kEps);
    stats[(size_t)b * C + c] =
        make_float2(s_mean[tid], rstd * (style[(size_t)b * 2 * C + c] + 1.f));
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

// ------------------------------------------------------------- launching --
// The one-pass kernel may take up to 227 KB of dynamic shared memory: opted
// in once per instantiation and device, not per call.
template <typename T, int VEC>
cudaError_t allow_smem() {
  static unsigned done = 0;  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(onepass_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sgt::kMaxSmem);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <typename T, int VEC>
cudaError_t launch(const SgtPlan& p, const void* xv, const void* noisev,
                   const void* nwv, const void* stylev, void* outv,
                   void* workspace, int B, int64_t R, int C,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* noise = static_cast<const T*>(noisev);
  const float* nw = static_cast<const float*>(nwv);
  const float* style = static_cast<const float*>(stylev);
  T* out = static_cast<T*>(outv);
  const dim3 block(p.tx, p.ty);
  if (p.path == 1) {
    cudaError_t err = allow_smem<T, VEC>();
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(p.chunks * p.cluster), (unsigned)B);
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = (size_t)p.smem_bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = p.cluster > 1 ? 1 : 0;
    return cudaLaunchKernelEx(&cfg, onepass_kernel<T, VEC>, x, noise, nw,
                              style, out, (int64_t)R, C, p.cluster,
                              (int64_t)p.rows_per_rank);
  }
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  float2* partials = reinterpret_cast<float2*>(ws);
  float2* stats = reinterpret_cast<float2*>(ws + p.stats_offset);
  int* tickets = reinterpret_cast<int*>(ws + p.tickets_offset);
  stats_kernel<T, VEC><<<dim3(p.splits, p.chunks, B), block, 0, stream>>>(
      x, noise, nw, style, partials, stats, tickets, R, C, p.rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned row_blocks = (unsigned)sgt::cdiv(R, p.rows_per_block);
  apply_kernel<T, VEC><<<dim3(row_blocks, p.chunks, B), block, 0, stream>>>(
      x, noise, nw, style, stats, out, R, C, p.rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Launches one epilogue call on `stream`: the one or two kernels of `plan`,
// which sgt_epilogue_plan made for this (is_bf16, B, R, C) and alignment.
// Returns 0 on success, else a cudaError_t (cudaErrorInvalidValue when the
// plan does not fit the call: vectors over an unaligned pointer, or a
// workspace short of the plan's).  The caller allocates out (B, R, C) and a
// workspace of the plan's workspace_bytes whose tickets (from
// tickets_offset) are zero; the kernels leave them at zero, so the caller
// may reuse it for later calls in the same stream order.
extern "C" int sgt_epilogue_forward(
    const void* x, const void* noise, const void* noise_weight,
    const void* style, void* out, void* workspace, long long workspace_bytes,
    int is_bf16, int B, long long R, int C, const SgtPlan* plan,
    void* stream) {
  const SgtPlan& p = *plan;
  const bool aligned = (((uintptr_t)x | (uintptr_t)out) % 16) == 0;
  if ((p.vec > 1 && !aligned) || p.workspace_bytes > workspace_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_LAUNCH(T, V) \
  launch<T, V>(p, x, noise, noise_weight, style, out, workspace, B, R, C, s)
  if (!is_bf16 && p.vec == 4) return (int)SGT_LAUNCH(float, 4);
  if (!is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(float, 1);
  if (is_bf16 && p.vec == 8) return (int)SGT_LAUNCH(__nv_bfloat16, 8);
  if (is_bf16 && p.vec == 1) return (int)SGT_LAUNCH(__nv_bfloat16, 1);
#undef SGT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
