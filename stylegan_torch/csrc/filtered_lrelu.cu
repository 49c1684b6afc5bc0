// StyleGAN3's filtered leaky ReLU for Hopper (sm_90a), float32, one pass.
//
//   out = upfirdn(clamp(gain * lrelu(upfirdn(x + b, fu, up, pad), slope),
//                       +-clamp), fd, down 2)
//
// after each modulated convolution of StyleGAN3's synthesis network
// (NVlabs/stylegan3 torch_utils/ops/filtered_lrelu.py, `_filtered_lrelu_ref`:
// bias, upfirdn2d up with the separable 1-D filter fu at gain up^2 and the
// layer's padding, lrelu with its gain and clamp, upfirdn2d down by 2 with
// the separable fd).  x and out are (B, C, H, W) stored NCHW; b is (C,).
// upfirdn's filters are true convolutions (the kernel takes them flipped),
// so an asymmetric filter gives what the published op gives.
//
// It replaces no TPU kernel: the JAX package has no StyleGAN3.  It exists
// because the plain chain writes the oversampled plane, up^2 / 4 times the
// output's samples before the down filter (layer 10 of a batch-8 1024^2
// forward: 81 planes of 2098^2, 11.4 GB), and reads and writes it again
// for each step; here that plane lives only in shared memory.
//
// What bounds it: about equally operations and bytes.  A batch-8 1024^2
// forward's 14 calls must move 16.7 GB (5.0 ms at 3.35 TB/s) and do 357
// GFLOP of filter taps (5.3 ms at 67 TFLOP/s), counting the separable
// passes' taps once per sample they produce.  So the passes stay separable
// and polyphase, and each thread keeps a run of outputs and their inputs in
// registers.
//
// A block of 8 warps takes a 32 x 32 tile of the output of one (b, c)
// plane, with up in {2, 4}, 6 * up taps in fu, 12 in fd.  Along each axis
// the tile's 32 outputs read 74 samples of the oversampled plane, which
// read up to 46 (up 2) or 26 (up 4) of x.  The block computes 80 samples
// of the oversampled plane along each axis, starting `s` < up before the
// first one it needs, so that every thread's pattern of taps is the same
// and known when compiling:
//   0. x's samples (+ b; zero outside the plane) into shared memory;
//   1. the up filter down the columns: 8 consecutive oversampled rows a
//      thread from their (7 + 6 up - 1) / up + 1 x rows, 6 taps each
//      (polyphase: the zeros of the upsampling are never multiplied);
//   2. the up filter along the rows, the same way, then lrelu, gain and
//      clamp: the 80 x 80 oversampled tile;
//   3. the down filter along the rows: 4 outputs a thread from 18 samples,
//      12 taps each, on the 74 rows the tile needs;
//   4. the down filter down the columns, the same way, into out.
// Each pass's threads take consecutive columns (passes 1 and 4) or
// consecutive rows of an odd row pitch (passes 2 and 3), so no two lanes
// of a warp meet in a bank of shared memory.  x's tile and pass 3's output
// share one buffer: 50.8 KB a block for up 2, 44.5 KB for up 4.
//
// No sum is taken across threads, and each output adds its products in a
// fixed order (the taps in order, pass by pass), so results are bitwise
// deterministic.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;         // output rows and columns a block
constexpr int kPhaseTaps = 6;     // taps a phase of the up filter
constexpr int kDownTaps = 12;     // taps of the down filter (down 2)
constexpr int kN = 8;             // samples a thread, up passes
constexpr int kNd = 4;            // outputs a thread, down passes
constexpr int kRU = 80;           // oversampled samples a block, each axis
constexpr int kVP = kRU + 1;      // odd pitch of the oversampled tile
constexpr int kDR = 2 * kTile + kDownTaps - 2;   // 74 rows pass 3 makes
constexpr int kDP = kTile + 1;    // odd pitch of pass 3's output
constexpr int kDIn = 2 * kNd + kDownTaps - 2;    // 18 samples, 4 outputs

template <int UP>
struct Geo {
  static constexpr int kKu = UP * kPhaseTaps;
  static constexpr int kXN = (kRU - 1 + kKu - 1) / UP + 1;   // x samples
  static constexpr int kXP = kXN | 1;                         // odd pitch
  static constexpr int kM = (kN - 1 + kKu - 1) / UP + 1;      // x a thread
  static constexpr int kXD = kXN * kXP > kDR * kDP ? kXN * kXP : kDR * kDP;
  static constexpr int kFloats = kXD + kRU * kXP + kRU * kVP + kKu + kDownTaps;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// blocks: B * C * tiles, tile-fastest; H, W the input plane, Ho, Wo the
// output's; s = (-lo) mod up, the shift of the first computed sample.
template <int UP>
__global__ void __launch_bounds__(kThreads)
filtered_lrelu_kernel(const float* __restrict__ x, const float* __restrict__ fu,
                      const float* __restrict__ fd,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int C, int H, int W, int Ho, int Wo, int lo, int s,
                      int tiles_c, int tiles, float gain, float slope,
                      float clamp) {
  using G = Geo<UP>;
  extern __shared__ float smem[];
  float* xd = smem;                       // x's tile, later pass 3's output
  float* a = xd + G::kXD;                 // pass 1: kRU rows x kXN columns
  float* v = a + kRU * G::kXP;            // pass 2: kRU x kRU
  float* taps = v + kRU * kVP;            // fu flipped at gain up, fd flipped
  const int tid = threadIdx.x;
  const int tile = (int)(blockIdx.x % (unsigned)tiles);
  const long long plane = blockIdx.x / (unsigned)tiles;
  const int o0r = (tile / tiles_c) * kTile, o0c = (tile % tiles_c) * kTile;

  if (tid < G::kKu)
    taps[tid] = UP * __ldg(fu + G::kKu - 1 - tid);
  else if (tid < G::kKu + kDownTaps)
    taps[tid] = __ldg(fd + kDownTaps - 1 - (tid - G::kKu));

  // 0. x + b from the first x sample the tile reads, (2 o0 - s - lo) / up
  //    (exact), zero outside the plane.
  {
    const int qr = (2 * o0r - s - lo) / UP, qc = (2 * o0c - s - lo) / UP;
    const float bb = __ldg(bias + plane % C);
    const float* xp = x + plane * H * W;
    // every load issued before the first store waits on one
    constexpr int kLoads = (G::kXN * G::kXN + kThreads - 1) / kThreads;
    float xv[kLoads];
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      const int i = qr + e / G::kXN, j = qc + e % G::kXN;
      xv[l] = (e < G::kXN * G::kXN && i >= 0 && i < H && j >= 0 && j < W)
                  ? __ldg(xp + (long long)i * W + j) + bb : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      if (e < G::kXN * G::kXN) xd[(e / G::kXN) * G::kXP + e % G::kXN] = xv[l];
    }
  }
  __syncthreads();

  // 1. Down the columns: oversampled row n (of kRU) from x rows
  //    m = n / up + ..., with tap m * up - (n mod the run).
  {
    float g[G::kKu];
#pragma unroll
    for (int k = 0; k < G::kKu; ++k) g[k] = taps[k];
    for (int e = tid; e < (kRU / kN) * G::kXN; e += kThreads) {
      const int c = e % G::kXN, j = e / G::kXN;
      const float* src = xd + j * (kN / UP) * G::kXP + c;
      float xr[G::kM];
#pragma unroll
      for (int m = 0; m < G::kM; ++m) xr[m] = src[m * G::kXP];
      float* dst = a + j * kN * G::kXP + c;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < G::kM; ++m) {
          const int k = m * UP - n;
          if (k >= 0 && k < G::kKu) acc = fmaf(xr[m], g[k], acc);
        }
        dst[n * G::kXP] = acc;
      }
    }
  }
  __syncthreads();

  // 2. Along the rows, then lrelu, gain and clamp.
  {
    float g[G::kKu];
#pragma unroll
    for (int k = 0; k < G::kKu; ++k) g[k] = taps[k];
    for (int e = tid; e < kRU * (kRU / kN); e += kThreads) {
      const int r = e % kRU, j = e / kRU;
      const float* src = a + r * G::kXP + j * (kN / UP);
      float xr[G::kM];
#pragma unroll
      for (int m = 0; m < G::kM; ++m) xr[m] = src[m];
      float* dst = v + r * kVP + j * kN;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < G::kM; ++m) {
          const int k = m * UP - n;
          if (k >= 0 && k < G::kKu) acc = fmaf(xr[m], g[k], acc);
        }
        float y = (acc < 0.f ? acc * slope : acc) * gain;
        dst[n] = fminf(fmaxf(y, -clamp), clamp);
      }
    }
  }
  __syncthreads();

  // 3. The down filter along the 74 rows the tile needs (from row s).
  float h[kDownTaps];
#pragma unroll
  for (int k = 0; k < kDownTaps; ++k) h[k] = taps[G::kKu + k];
  for (int e = tid; e < kDR * (kTile / kNd); e += kThreads) {
    const int r = e % kDR, j = e / kDR;
    const float* src = v + (s + r) * kVP + s + 2 * kNd * j;
    float vr[kDIn];
#pragma unroll
    for (int k = 0; k < kDIn; ++k) vr[k] = src[k];
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kDownTaps; ++k) acc = fmaf(vr[2 * n + k], h[k], acc);
      xd[r * kDP + j * kNd + n] = acc;
    }
  }
  __syncthreads();

  // 4. Down the columns, into out.
  float* op = out + plane * Ho * Wo;
  for (int e = tid; e < kTile * (kTile / kNd); e += kThreads) {
    const int c = e % kTile, j = e / kTile;
    const float* src = xd + 2 * kNd * j * kDP + c;
    float vr[kDIn];
#pragma unroll
    for (int k = 0; k < kDIn; ++k) vr[k] = src[k * kDP];
    const int col = o0c + c;
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kDownTaps; ++k) acc = fmaf(vr[2 * n + k], h[k], acc);
      const int row = o0r + j * kNd + n;
      if (row < Ho && col < Wo) op[(long long)row * Wo + col] = acc;
    }
  }
}

template <int UP>
cudaError_t launch(const float* x, const float* fu, const float* fd,
                   const float* bias, float* out, int B, int C, int H, int W,
                   int Ho, int Wo, int lo, float gain, float slope,
                   float clamp, cudaStream_t stream) {
  using G = Geo<UP>;
  cudaError_t err = cudaFuncSetAttribute(
      filtered_lrelu_kernel<UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles_c = (Wo + kTile - 1) / kTile;
  const int tiles = tiles_c * ((Ho + kTile - 1) / kTile);
  const long long blocks = (long long)B * C * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int s = ((-lo) % UP + UP) % UP;
  filtered_lrelu_kernel<UP><<<(unsigned)blocks, kThreads, G::kBytes, stream>>>(
      x, fu, fd, bias, out, C, H, W, Ho, Wo, lo, s, tiles_c, tiles, gain,
      slope, clamp);
  return cudaGetLastError();
}

}  // namespace

// x (B, C, H, W), fu (6 up,), fd (12,), bias (C,), out (B, C, Ho, Wo), all
// float32 and contiguous; up 2 or 4, down 2; lo the padding before the
// first sample of each axis (the wrapper checks the shapes, Ho and Wo).
extern "C" int sgt_filtered_lrelu(const float* x, const float* fu,
                                  const float* fd, const float* bias,
                                  float* out, int B, int C, int H, int W,
                                  int Ho, int Wo, int up, int lo, float gain,
                                  float slope, float clamp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (up == 2)
    return launch<2>(x, fu, fd, bias, out, B, C, H, W, Ho, Wo, lo, gain,
                     slope, clamp, st);
  if (up == 4)
    return launch<4>(x, fu, fd, bias, out, B, C, H, W, Ho, Wo, lo, gain,
                     slope, clamp, st);
  return (int)cudaErrorInvalidValue;
}
