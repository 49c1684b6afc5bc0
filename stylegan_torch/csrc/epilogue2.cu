// StyleGAN2's layer epilogue for Hopper (sm_90a), float32.
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
// It replaces no TPU kernel: the JAX package has no StyleGAN2.  It exists
// because StyleGAN1's epilogue kernels (epilogue.cu: noise, lrelu, instance
// norm, AdaIN) compute what StyleGAN2 dropped, and the plain composition
// reads and writes the plane three times.
//
// What bounds it: bytes.  Per element it reads x once and writes out once,
// plus one noise scalar per pixel and C + 1 floats; a batch-8 1024^2
// forward's 17 calls must move 8.50 GB (2.54 ms at 3.35 TB/s).  So it is one
// pass: each thread moves one 16-byte vector of x (4 pixels of a channel),
// with 32-bit index arithmetic where the plane allows it, and scalars where
// H*W or a pointer does not allow vectors.  No sum is taken, so results are
// bitwise deterministic.

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
