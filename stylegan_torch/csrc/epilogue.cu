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
// _stats_kernel (K1, per-(b, c) sums over spatial tiles) and _apply_kernel
// (K2, normalise and modulate).
//
// What bounds it: bytes.  Per element it does ~10 flops and moves 2-3 x 4
// bytes, far below the card's ~20 flops per byte of f32 ALU balance.  At
// batch 8 in f32 a 1024^2 forward's 18 epilogues move about 6.1 GiB in this
// two-pass design (x read twice, out written once): about 1.96 ms at
// 3.35 TB/s.  The floor, one read and one write of x, is about 1.3 ms.
//
// What the design does about it:
//   * noise is read as one scalar per row, never broadcast to (B, R, C) in
//     memory (the TPU wrapper's broadcast_to was a whole extra pass);
//   * every thread moves 16 bytes per load and store along C, neighbouring
//     threads on neighbouring addresses (VEC = 4 floats or 8 bf16; VEC = 1
//     when C or a pointer does not allow it);
//   * pass 1 is split over (split, C-chunk, b) blocks so even 1024^2 x 16
//     gives ~1000 blocks; each block leaves a partial (mean, M2) per
//     (b, split, c) in a workspace, with no atomics, so the result is
//     deterministic;
//   * partials merge with Chan's pairwise formula, never as E[y^2] - mean^2,
//     which cancels over 2^20 post-lrelu values with a positive mean;
//   * the launch geometry (vector width, block shape, splits) is decided in
//     one place, geometry() below; the caller asks sgt_epilogue_splits for
//     the workspace's size;
//   * a tiny finalize pass folds the partials, rstd and (s0 + 1) into one
//     (mean, scale) pair per (b, c), so pass 2 is one sub and one fma per
//     element on top of the recomputed y.
// Planes held in shared memory for a one-pass kernel, TMA, and a persistent
// grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// Pass 1: per-(b, split, c) Welford statistics of y over the split's rows.
// grid (splits, chunks, B), block (TX, TY) with TX * TY == kThreads and TY a
// power of two.  Thread (tx, ty) owns channels c0 .. c0 + VEC - 1 and rows
// r0 + ty, r0 + ty + TY, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, const T* __restrict__ noise,
             const float* __restrict__ nw, float2* __restrict__ partials,
             int64_t R, int C, int64_t rows_per_split) {
  __shared__ float s_mean[kThreads * VEC];
  __shared__ float s_m2[kThreads * VEC];
  __shared__ float s_n[kThreads];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int tid = ty * TX + tx;
  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.z;
  const int c0 = (blockIdx.y * TX + tx) * VEC;
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
    for (int64_t r = r0 + ty; r < r1; r += TY) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + r * C);
      const float z = to_float(nb[r]);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float y = noisy_lrelu(to_float(p.v[i]), w[i], z);
        const float d = y - mean[i];
        mean[i] = fmaf(d, inv, mean[i]);
        m2[i] = fmaf(d, y - mean[i], m2[i]);
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
        const float na = s_n[tid];
        const float f = nb / (na + nb);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float ma = s_mean[tid * VEC + i];
          const float d = s_mean[other * VEC + i] - ma;
          s_mean[tid * VEC + i] = fmaf(d, f, ma);
          s_m2[tid * VEC + i] =
              s_m2[tid * VEC + i] + s_m2[other * VEC + i] + d * d * na * f;
        }
        s_n[tid] = na + nb;
      }
    }
    __syncthreads();
  }

  if (ty == 0 && active) {
    float2* out = partials + ((size_t)b * splits + split) * C + c0;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      out[i] = make_float2(s_mean[tx * VEC + i], s_m2[tx * VEC + i]);
  }
}

// Pass 1b: one thread per (b, c) merges the splits in order (deterministic)
// and writes (mean, rstd * (s0 + 1)).
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float2* __restrict__ partials,
                const float* __restrict__ style, float2* __restrict__ stats,
                int B, int C, int splits, int64_t R, int64_t rows_per_split) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C) return;
  const int b = idx / C, c = idx - b * C;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float nb =
        (float)min64(rows_per_split, R - (int64_t)s * rows_per_split);
    const float2 p = partials[((size_t)b * splits + s) * C + c];
    const float f = nb / (n + nb);
    const float d = p.x - mean;
    mean = fmaf(d, f, mean);
    m2 = m2 + p.y + d * d * n * f;
    n += nb;
  }
  const float rstd = rsqrtf(m2 / n + kEps);
  stats[idx] = make_float2(mean, rstd * (style[(size_t)b * 2 * C + c] + 1.f));
}

// Pass 2: recompute y and write (y - mean) * scale + s1.
// grid (row blocks, chunks, B), block (TX, TY).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const T* __restrict__ noise,
             const float* __restrict__ nw, const float* __restrict__ style,
             const float2* __restrict__ stats, T* __restrict__ out,
             int64_t R, int C, int64_t rows_per_block) {
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  const int b = blockIdx.z;
  const int c0 = (blockIdx.y * blockDim.x + tx) * VEC;
  if (c0 >= C) return;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
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

// Block shape and work split of one call, decided here only.
//   vec: 16-byte vectors along C (4 floats, 8 bf16) where C and the x / out
//        pointers allow, else scalars;
//   tx:  threads along C, a power of two, at most a warp; ty = kThreads / tx
//        along the rows (a power of two, as pass 1's tree merge needs);
//   pass 1 splits the rows so that B x chunks x splits is about
//   kTargetStatsBlocks, each thread walking at least kMinRowsPerThread rows;
//   pass 2 gives each block ty * kMinRowsPerThread rows.
constexpr int kTargetStatsBlocks = 1024;  // ~8 per SM of 132
constexpr int kMinRowsPerThread = 8;

struct Geometry {
  int vec, tx, ty, chunks, splits;
  int64_t rows_per_split, rows_per_block;
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

Geometry geometry(int B, int64_t R, int C, bool bf16, const void* x,
                  const void* out) {
  Geometry g;
  const bool aligned = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  g.vec = bf16 ? 8 : 4;
  if (C % g.vec != 0 || !aligned) g.vec = 1;
  const int lanes = (int)ceil_div(C, g.vec);
  g.tx = 1;
  while (g.tx < lanes && g.tx < 32) g.tx *= 2;
  g.ty = kThreads / g.tx;
  g.chunks = (int)ceil_div(C, g.tx * g.vec);
  int64_t want_splits = kTargetStatsBlocks / ((int64_t)B * g.chunks);
  if (want_splits < 1) want_splits = 1;
  int64_t rps = ceil_div(R, want_splits);
  if (rps < (int64_t)g.ty * kMinRowsPerThread)
    rps = (int64_t)g.ty * kMinRowsPerThread;
  g.rows_per_split = ceil_div(rps, g.ty) * g.ty;
  g.splits = (int)ceil_div(R, g.rows_per_split);
  g.rows_per_block = (int64_t)g.ty * kMinRowsPerThread;
  return g;
}

template <typename T, int VEC>
cudaError_t launch(const Geometry& g, const void* x, const void* noise,
                   const void* nw, const void* style, void* out,
                   void* partials, void* stats, int B, int64_t R, int C,
                   cudaStream_t stream) {
  const dim3 block(g.tx, g.ty);
  stats_kernel<T, VEC><<<dim3(g.splits, g.chunks, B), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(noise),
      static_cast<const float*>(nw), static_cast<float2*>(partials), R, C,
      g.rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<<<(B * C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float2*>(partials), static_cast<const float*>(style),
      static_cast<float2*>(stats), B, C, g.splits, R, g.rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t row_blocks = ceil_div(R, g.rows_per_block);
  apply_kernel<T, VEC><<<dim3((unsigned)row_blocks, g.chunks, B), block, 0,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(noise),
      static_cast<const float*>(nw), static_cast<const float*>(style),
      static_cast<const float2*>(stats), static_cast<T*>(out), R, C,
      g.rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Number of pass-1 row splits for this call: the caller sizes the partials
// workspace (B, splits, C, 2) f32 with it.  Host-only; launches nothing.
extern "C" int sgt_epilogue_splits(int is_bf16, int B, long long R, int C,
                                   const void* x, const void* out) {
  return geometry(B, R, C, is_bf16 != 0, x, out).splits;
}

// Launches the three passes on `stream`; returns cudaGetLastError() (0 on
// success).  The caller allocates out (B, R, C), partials (B, splits, C, 2)
// f32 with `splits` from sgt_epilogue_splits, and stats (B, C, 2) f32.
extern "C" int sgt_epilogue_forward(
    const void* x, const void* noise, const void* noise_weight,
    const void* style, void* out, void* partials, void* stats, int is_bf16,
    int B, long long R, int C, int splits, void* stream) {
  const Geometry g = geometry(B, R, C, is_bf16 != 0, x, out);
  if (g.splits != splits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_LAUNCH(T, V)                                                  \
  launch<T, V>(g, x, noise, noise_weight, style, out, partials, stats, B, \
               R, C, s)
  if (!is_bf16 && g.vec == 4) return (int)SGT_LAUNCH(float, 4);
  if (!is_bf16 && g.vec == 1) return (int)SGT_LAUNCH(float, 1);
  if (is_bf16 && g.vec == 8) return (int)SGT_LAUNCH(__nv_bfloat16, 8);
  if (is_bf16 && g.vec == 1) return (int)SGT_LAUNCH(__nv_bfloat16, 1);
#undef SGT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
