// StyleGAN2's layer epilogue for Hopper (sm_90a), float32: two kernels.
//
//   out = sqrt(2) * leaky_relu(x + strength * noise[b, h, w] + bias[c], 0.2)
//
// after each modulated 3x3 convolution of the synthesis network
// (NVlabs/stylegan2 networks_stylegan2.py: `x += noise * noise_strength`,
// then apply_bias_act with act='lrelu', whose gain is sqrt(2)).  The
// demodulation is in the convolution's per-sample kernels (the fused form).
// strength is one float32 a layer, read from the device so that no call
// waits for the host.  x and out are (B, C, H, W) stored NCHW; noise is
// (B, H, W), one scalar a pixel.
//
// `epilogue2_kernel` (sgt_epilogue2) takes the same-size layers' x as it
// is.  `epilogue2_up_kernel` (sgt_epilogue2_up) takes an up-layer's
// transposed convolution output y, (B, C, 2H+1, 2H+1) (every up-layer's
// plane is square), and applies the 4x4 FIR first (upfirdn_2d's filter at
// gain 4, one pixel of zero padding a side): x = FIR(y), (B, C, 2H, 2H),
// then the epilogue, so that x never goes to device memory.
//
// They replace no TPU kernel: the JAX package has no StyleGAN2.  They exist
// because StyleGAN1's epilogue kernels (epilogue.cu: noise, lrelu, instance
// norm, AdaIN) compute what StyleGAN2 dropped, the plain composition
// reads and writes the plane three times, and the FIR as a depthwise
// convolution of its own read the (2H+1)^2 plane and wrote the (2H)^2 one
// at a seventh of the bytes' rate.
//
// What bounds them: bytes.  Per element the same-size kernel reads x once
// and writes out once, plus one noise scalar per pixel and C + 1 floats; a
// batch-8 1024^2 forward's 9 same-size calls must move 4.2 GB.  So it is one
// pass: each thread moves one 16-byte vector of x (4 pixels of a channel),
// with 32-bit index arithmetic where the plane allows it, and scalars where
// H*W or a pointer does not allow vectors.
//
// The up kernel reads the (2H+1)^2 plane once and writes the (2H)^2 plane
// once (4.26 GB over the forward's 8 up-layers at batch 8, 1024^2); its 16
// taps an output (8.4 G fused multiply-adds a request) are about a fifth
// of that time on the float32 pipes.  A block of 8 warps takes a tile of
// 8R output rows (R = 8 from 64 rows on, fewer on smaller planes) by
// 4 * cq columns (cq = 32 column quads, or a whole row of a narrower plane)
// of pw = 32 / cq planes, the planes side by side in a warp's lanes.  It
// stages the tile's input rows with their 3-pixel halo in shared memory by
// 4-byte cp.async (the (2H+1) row pitch is odd, so no row is 16-byte
// aligned), zero-filling outside the plane; each thread then computes 4
// adjacent columns by R rows, reading 7 words a staged row (one float4,
// one float2, one word: conflict-free, the shared pitch a multiple of 4)
// and adding each into the up to 4 output rows it feeds, taps and sums in
// registers, and stores float4 rows of out.
//
// Neither takes a sum across threads, and the up kernel adds an output's
// 16 products in a fixed order (filter rows, then columns, each in
// order), so results are bitwise deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSqrt2 = 1.4142135623730951f;

__device__ __forceinline__ float act(float v) {
  return (v < 0.f ? v * 0.2f : v) * kSqrt2;
}

// n elements, element e = (b * C + c) * HW + hw; VEC (4 or 1) elements a
// thread, all of one (b, c): HW % VEC == 0.
template <typename I, int VEC>
__global__ void __launch_bounds__(kThreads)
epilogue2_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                 const float* __restrict__ bias,
                 const float* __restrict__ strength, float* __restrict__ out,
                 I n, I C, I HW) {
  const I e = ((I)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (e >= n) return;
  const float st = __ldg(strength);
  float v[VEC];
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(x + e));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(x + e);
  }
  const I hw = e % HW, bc = e / HW;
  const float bb = __ldg(bias + bc % C);
  const float* nz = noise + (bc / C) * HW + hw;
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    v[k] = act(fmaf(st, __ldg(nz + k), v[k]) + bb);
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    out[e] = v[0];
  }
}

template <typename I>
cudaError_t launch(const float* x, const float* noise, const float* bias,
                   const float* strength, float* out, long long n, int C,
                   long long HW, bool vec, cudaStream_t stream) {
  const int v = vec ? 4 : 1;
  const long long threads = (n + v - 1) / v;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (vec)
    epilogue2_kernel<I, 4><<<blocks, kThreads, 0, stream>>>(
        x, noise, bias, strength, out, (I)n, (I)C, (I)HW);
  else
    epilogue2_kernel<I, 1><<<blocks, kThreads, 0, stream>>>(
        x, noise, bias, strength, out, (I)n, (I)C, (I)HW);
  return cudaGetLastError();
}

constexpr int kUpWarps = kThreads / 32;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  // 4 bytes global -> shared; with `valid` false nothing is read and the
  // word is zeroed (src must still be a mapped address)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// y: n = B*C square planes of side S; out and the FIR's result: side
// So = S - 1; noise (B, So, So).  Block b: column tile b % col_tiles, then
// row tile, then plane group (pw planes).  Dynamic shared memory:
// pw x (8R + 3) rows x (4cq + 4) floats, at most 36.4 KB (pw = 2, cq = 16,
// R = 8), under the 48 KB a launch may take without opting in.  `vec`:
// So % 4 == 0 and out, noise 16-byte aligned.
template <int R>
__global__ void __launch_bounds__(kThreads)
epilogue2_up_kernel(const float* __restrict__ y, const float* __restrict__ fir,
                    const float* __restrict__ noise,
                    const float* __restrict__ bias,
                    const float* __restrict__ strength,
                    float* __restrict__ out, int n, int C, int S, int cq,
                    int pw, int row_tiles, int col_tiles, bool vec) {
  constexpr int TH = kUpWarps * R;
  extern __shared__ __align__(16) float sm[];
  const int So = S - 1;
  const int pitch = 4 * cq + 4, width = 4 * cq + 3;
  unsigned t = blockIdx.x;
  const int ct = t % col_tiles;
  t /= col_tiles;
  const int rt = t % row_tiles;
  const long long plane0 = (long long)(t / row_tiles) * pw;
  const int y0 = rt * TH, x0 = ct * 4 * cq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // staged row p * (TH + 3) + r holds plane plane0 + p's input row
  // y0 - 1 + r, columns x0 - 1 .. x0 + 4cq + 1
  for (int row = warp; row < pw * (TH + 3); row += kUpWarps) {
    const int p = row / (TH + 3), r = row - p * (TH + 3);
    const long long pl = plane0 + p;
    const int gy = y0 - 1 + r;
    const bool row_ok = pl < n && gy >= 0 && gy < S;
    const float* src = row_ok ? y + (pl * S + gy) * (long long)S : y;
    float* dst = sm + row * pitch;
    for (int c = lane; c < width; c += 32) {
      const int gx = x0 - 1 + c;
      const bool ok = row_ok && gx >= 0 && gx < S;
      cp_async4(dst + c, ok ? src + gx : y, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int p = lane / cq, q = lane - p * cq;
  const long long pl = plane0 + p;
  if (p >= pw || pl >= n) return;
  // the depthwise convolution's taps: the FIR at gain 4, flipped
  float k[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) k[u][v] = 4.f * __ldg(fir + (3 - u) * 4 + 3 - v);

  // output row y0 + warp * R + r, column x0 + 4q + j reads staged rows
  // warp * R + r + u and columns 4q + j + v, u and v in 0..3
  const float* base = sm + (p * (TH + 3) + warp * R) * pitch + 4 * q;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll
  for (int s = 0; s < R + 3; ++s) {
    const float* in = base + s * pitch;
    const float4 a = *reinterpret_cast<const float4*>(in);
    const float2 b = *reinterpret_cast<const float2*>(in + 4);
    const float w[7] = {a.x, a.y, a.z, a.w, b.x, b.y, in[6]};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int u = s - r;
      if (u < 0 || u > 3) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[r][j] = fmaf(k[u][v], w[j + v], acc[r][j]);
    }
  }

  const float st = __ldg(strength), bb = __ldg(bias + pl % C);
  const long long plane_out = (long long)So * So;
  const float* nz = noise + (pl / C) * plane_out;
  float* o = out + pl * plane_out;
  const int x = x0 + 4 * q;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = y0 + warp * R + r;
    if (i >= So) break;
    const int e = i * So + x;
    if (vec) {
      if (x >= So) break;
      const float4 z = __ldg(reinterpret_cast<const float4*>(nz + e));
      *reinterpret_cast<float4*>(o + e) = make_float4(
          act(fmaf(st, z.x, acc[r][0]) + bb), act(fmaf(st, z.y, acc[r][1]) + bb),
          act(fmaf(st, z.z, acc[r][2]) + bb), act(fmaf(st, z.w, acc[r][3]) + bb));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < So)
          o[e + j] = act(fmaf(st, __ldg(nz + e + j), acc[r][j]) + bb);
    }
  }
}

template <int R>
cudaError_t launch_up(const float* y, const float* fir, const float* noise,
                      const float* bias, const float* strength, float* out,
                      int n, int C, int S, int cq, int pw, int row_tiles,
                      int col_tiles, unsigned blocks, bool vec,
                      cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * pw * (kUpWarps * R + 3) * (4 * cq + 4);
  epilogue2_up_kernel<R><<<blocks, kThreads, smem, stream>>>(
      y, fir, noise, bias, strength, out, n, C, S, cq, pw, row_tiles,
      col_tiles, vec);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, C, H, W) float32 stored NCHW; noise (B, H*W); bias (C,);
// strength one float.  Returns the launch's cudaError_t.
extern "C" int sgt_epilogue2(const void* x, const void* noise,
                             const void* bias, const void* strength,
                             void* out, int B, long long HW, int C,
                             void* stream) {
  const long long n = (long long)B * HW * C;
  if (n == 0) return 0;
  const bool vec =
      HW % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
       16) == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* nf = static_cast<const float*>(noise);
  const auto* bf = static_cast<const float*>(bias);
  const auto* sf = static_cast<const float*>(strength);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      n < (1LL << 31)
          ? launch<uint32_t>(xf, nf, bf, sf, of, n, C, HW, vec, s)
          : launch<long long>(xf, nf, bf, sf, of, n, C, HW, vec, s);
  return (int)err;
}

// y: (B, C, S, S) float32 stored NCHW, S odd and at least 3; fir (4, 4),
// the FIR normalised to sum 1; noise (B, S - 1, S - 1); bias (C,);
// strength one float; out (B, C, S - 1, S - 1).  Returns the launch's
// cudaError_t.
extern "C" int sgt_epilogue2_up(const void* y, const void* fir,
                                const void* noise, const void* bias,
                                const void* strength, void* out, int B, int C,
                                int S, void* stream) {
  const long long n = (long long)B * C;
  if (n == 0) return 0;
  if (S < 3 || S % 2 == 0 || n >= (1LL << 31) ||
      (long long)S * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int So = S - 1;
  const int quads = (So + 3) / 4;
  const int cq = quads < 32 ? quads : 32;
  const int pw = 32 / cq;
  const int col_tiles = (quads + cq - 1) / cq;
  const int R = So > 32 ? 8 : So > 16 ? 4 : So > 8 ? 2 : 1;
  const int row_tiles = (So + kUpWarps * R - 1) / (kUpWarps * R);
  const long long blocks =
      (n + pw - 1) / pw * (long long)row_tiles * col_tiles;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  const bool vec =
      So % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(noise) | reinterpret_cast<uintptr_t>(out)) %
       16) == 0;
  const auto* yf = static_cast<const float*>(y);
  const auto* ff = static_cast<const float*>(fir);
  const auto* nf = static_cast<const float*>(noise);
  const auto* bf = static_cast<const float*>(bias);
  const auto* sf = static_cast<const float*>(strength);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int ni = (int)n;
  const unsigned nb = (unsigned)blocks;
  cudaError_t err;
  switch (R) {
    case 8:
      err = launch_up<8>(yf, ff, nf, bf, sf, of, ni, C, S, cq, pw, row_tiles,
                         col_tiles, nb, vec, s);
      break;
    case 4:
      err = launch_up<4>(yf, ff, nf, bf, sf, of, ni, C, S, cq, pw, row_tiles,
                         col_tiles, nb, vec, s);
      break;
    case 2:
      err = launch_up<2>(yf, ff, nf, bf, sf, of, ni, C, S, cq, pw, row_tiles,
                         col_tiles, nb, vec, s);
      break;
    default:
      err = launch_up<1>(yf, ff, nf, bf, sf, of, ni, C, S, cq, pw, row_tiles,
                         col_tiles, nb, vec, s);
  }
  return (int)err;
}
