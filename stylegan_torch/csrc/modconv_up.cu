// StyleGAN2's modulated up-convolution for Hopper (sm_90a), float32 on the
// CUDA cores: one kernel, one launch a layer for the whole batch.
//
//   y[s, o] = conv_transpose2d(x[s], flip(ww[s])^T, stride 2)[o]
//
// x (B, Ci, H, W) and the per-sample kernels ww (B, Co, Ci, 3, 3), as
// ops/modconv.py::modulate_weight makes them (demodulation folded in), give
// y (B, Co, 2H+1, 2W+1), all contiguous NCHW.  It is the TF original's
// `conv2d_transpose` of the spatially flipped kernel (NVlabs/stylegan2
// networks_stylegan2.py::modulated_conv2d_layer with up=True, before its
// FIR, which the epilogue2_up kernel applies).  It replaces no TPU kernel:
// the JAX package has no StyleGAN2.  It exists because cuDNN runs the
// grouped transposed convolution as one backward-data kernel a sample on
// side streams, at about a quarter of the float32 peak, and sums in no fixed
// order.
//
// The four sub-pixel phases.  Output (oy, ox) = (2a + py, 2b + px) of cell
// (a, b), a in 0..H, b in 0..W, with w = ww[s, o, i] (taps w[r][c]) and x
// read zero outside the plane:
//   (2a,   2b)   += x[a][b] w[2][2] + x[a][b-1] w[2][0]
//                 + x[a-1][b] w[0][2] + x[a-1][b-1] w[0][0]
//   (2a,   2b+1) += x[a][b] w[2][1] + x[a-1][b] w[0][1]
//   (2a+1, 2b)   += x[a][b] w[1][2] + x[a][b-1] w[1][0]
//   (2a+1, 2b+1) += x[a][b] w[1][1]
// so an input pixel meets each of the 9 taps once: no zero tap is
// multiplied, 2 * H * W * 9 * Ci * Co operations a sample.  The cell (a, H)
// row and (H, b) column hold only their even outputs.
//
// What bounds it: operations.  A batch-8 1024^2 forward's 8 up-layers are
// 360.6 GFLOP (5.38 ms at 67 TFLOP/s) against about 3.5 GB (1.04 ms at 3.35
// TB/s).  TF32 is off on this path and wgmma takes no float32 operands, so
// it is a SIMT implicit GEMM:
//
// * A block: one sample, kTM = 32 output channels (4 warps of 8) and TP =
//   32 NC cells, consecutive in the row-major order of the (H+1) x (W+1)
//   cells, so that no tile of a 2-D grid is wasted on the plane's odd last
//   row and column.  NC, the cells a thread, is 3 from 1024 cells a plane,
//   2 from 256 and 1 below, so that the small planes still fill the card.
//   At NC = 3 a thread holds 96 sums in at most 168 registers, so that 3
//   blocks (12 warps) share an SM: on the card that beat NC = 4 (128 sums,
//   254 registers, 8 warps) by 7%, the loop being bound by latency.
// * A stage: kKC = 8 input channels.  For each, the tile's x as two rows
//   of TP + 1 values (x[a][b] and x[a-1][b] of cells c0 - 1 .. c0 + TP - 1:
//   x[a][b-1] is the value of the cell before, and the cell before (a, 0)
//   is (a-1, W), which reads zero, as x[a][-1] must), and the weights as
//   [input channel][tap][output channel], 4-byte cp.async copies (the
//   cells' rows wrap and the taps come in 9-word runs, so nothing is
//   16-byte aligned) that transpose the weights on the way and zero-fill
//   outside the plane and past Ci and Co; a ring of kStages stages.  Each
//   thread computes its copies' sources and sizes once, and a stage whose
//   channels are all below Ci copies without a test: the staging is about
//   a tenth of the instructions the compute issues.
// * A thread: 8 output channels by NC cells (lane + 32 j) by the 4 phases,
//   in registers.  Per input channel it reads 4 NC values of x (conflict-
//   free words) and 9 taps x 8 channels of weights (float4 broadcasts) for
//   72 NC fused multiply-adds, the next channel's x and the next tap's
//   weights loaded ahead.  The broadcasts are what the loop's shared memory
//   spends most on (2 SM cycles each on an H100, against about 1 for a
//   lane-distinct word); with latency they hold it near half the peak.
//
// The grid is (sample, channel tile, cell tile); no sum is split across
// threads or blocks, and every output adds its products in one order (input
// channels in order, then the taps in the order written above), so two
// calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKC = 8;                  // input channels a stage
constexpr int kTaps = 9;
constexpr int kCo = 8;                  // output channels a thread
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTM = kCo * kWarps;       // output channels a block
constexpr int kWP = kTM + 4;            // a tap row's pitch: 4 mod 32 words
constexpr int kStages = 4;

template <int NC>
struct Tile {
  static constexpr int TP = 32 * NC;                   // cells a block
  static constexpr int XP = TP + 4;                    // an x row's pitch
  static constexpr int XS = kKC * 2 * XP;              // x floats a stage
  static constexpr int WS = kKC * kTaps * kWP;         // weight floats
  static constexpr int STAGE = XS + WS;
  static constexpr int XQ = (2 * (TP + 1) + kThreads - 1) / kThreads;
  static constexpr size_t SMEM = sizeof(float) * kStages * STAGE;
};

// 4 bytes global -> shared (dst a shared address); with size 0 nothing is
// read and the word is zeroed (src must still be a mapped address)
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          int size) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[c][j] += w[c] * p[j]
template <int NC>
__device__ __forceinline__ void fma_tile(float (&acc)[kCo][NC],
                                         const float (&w)[kCo],
                                         const float (&p)[NC]) {
#pragma unroll
  for (int c = 0; c < kCo; ++c)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[c][j] = fmaf(w[c], p[j], acc[c][j]);
}

__device__ __forceinline__ void load_taps(const float* src, float (&w)[kCo]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// The x values a thread reads for one input channel of a stage: x[a][b],
// x[a][b-1], x[a-1][b], x[a-1][b-1] of its cells c0 + lane + 32 j (r0 and r1
// the channel's two rows, from the thread's lane on).
template <int NC>
__device__ __forceinline__ void load_x(const float* r0, const float* r1,
                                       float (&p)[4][NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    p[0][j] = r0[32 * j + 1];
    p[1][j] = r0[32 * j];
    p[2][j] = r1[32 * j + 1];
    p[3][j] = r1[32 * j];
  }
}

// Block bid: cell tile bid % cell_tiles, then channel tile, then sample.
// Dynamic shared memory: kStages x (x rows, then weights), Tile<NC>::SMEM.
template <int NC>
__global__ void __launch_bounds__(kThreads, 3)
modconv_up_kernel(const float* __restrict__ x, const float* __restrict__ ww,
                  float* __restrict__ y, int Ci, int Co, int H, int W,
                  int cell_tiles, int co_tiles) {
  using T = Tile<NC>;
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned bid = blockIdx.x;
  const int pt = bid % cell_tiles;
  bid /= cell_tiles;
  const int ct = bid % co_tiles;
  const int s = bid / co_tiles;
  const int c0 = pt * T::TP, co0 = ct * kTM;
  const int W1 = W + 1, ncells = (H + 1) * W1;
  const long long HW = (long long)H * W;
  const float* xs = x + (long long)s * Ci * HW;
  const unsigned sm0 = static_cast<unsigned>(__cvta_generic_to_shared(sm));

  // x staging: this thread's (row r, index i) pairs of the two rows, each
  // the value x[a - r][b] of cell c0 - 1 + i: its source in channel 0 (the
  // plane's start where it reads zero), its size (4, or 0 for a zero) and
  // its place in the stage (-1: no pair; only the last can be)
  const float* xsrc[T::XQ];
  int xsz[T::XQ], xdst[T::XQ];
#pragma unroll
  for (int k = 0; k < T::XQ; ++k) {
    const int q = threadIdx.x + k * kThreads;
    const int r = q / (T::TP + 1), i = q - r * (T::TP + 1);
    const int g = c0 - 1 + i, a = g / W1 - r, b = g % W1;
    const bool ok = q < 2 * (T::TP + 1) && g >= 0 && g < ncells && a >= 0 &&
                    a < H && b < W;
    xsrc[k] = xs + (ok ? a * W + b : 0);
    xsz[k] = ok ? 4 : 0;
    xdst[k] = q < 2 * (T::TP + 1) ? r * T::XP + i : -1;
  }
  // weight staging: warp w copies channel quads 2w and 2w + 1 of the tile,
  // lane (r_sub = lane / 4, c_sub = lane % 4) the words r = 8 rb + r_sub
  // (r = 9 ci + tap) of its channel's run of kKC x 9; a channel past Co
  // reads channel 0's run at size 0
  const int r_sub = lane >> 2, c_sub = lane & 3;
  const float* wsrc[2];
  int wsz[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int co = co0 + (2 * warp + m) * 4 + c_sub;
    wsrc[m] = ww + ((long long)s * Co + (co < Co ? co : 0)) * Ci * kTaps +
              r_sub;
    wsz[m] = co < Co ? 4 : 0;
  }
  const unsigned wdst = (T::XS + r_sub * kWP + 8 * warp + c_sub) * 4;

  // stage kc (input channels kc kKC ..) into ring slot `slot`; a stage past
  // Ci's last full one checks each channel, the others copy without a test
  auto load = [&](int kc, int slot) {
    const int ci0 = kc * kKC;
    const unsigned base = sm0 + slot * T::STAGE * 4;
    if (ci0 + kKC <= Ci) {
#pragma unroll
      for (int k = 0; k < T::XQ; ++k) {
        if (k == T::XQ - 1 && xdst[k] < 0) break;
        const float* src = xsrc[k] + ci0 * HW;
#pragma unroll
        for (int ci = 0; ci < kKC; ++ci, src += HW)
          cp_async4(base + (xdst[k] + ci * 2 * T::XP) * 4, src, xsz[k]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int rb = 0; rb < kTaps; ++rb)
          cp_async4(base + wdst + (8 * rb * kWP + 4 * m) * 4,
                    wsrc[m] + ci0 * kTaps + 8 * rb, wsz[m]);
      return;
    }
#pragma unroll
    for (int k = 0; k < T::XQ; ++k) {
      if (k == T::XQ - 1 && xdst[k] < 0) break;
#pragma unroll
      for (int ci = 0; ci < kKC; ++ci) {
        const bool ok = ci0 + ci < Ci;
        cp_async4(base + (xdst[k] + ci * 2 * T::XP) * 4,
                  ok ? xsrc[k] + (ci0 + ci) * HW : xs, ok ? xsz[k] : 0);
      }
    }
    const int rows = 9 * (Ci - ci0) - r_sub;  // r_sub + 8 rb < 9 (Ci - ci0)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int rb = 0; rb < kTaps; ++rb) {
        const bool ok = 8 * rb < rows;
        cp_async4(base + wdst + (8 * rb * kWP + 4 * m) * 4,
                  ok ? wsrc[m] + ci0 * kTaps + 8 * rb : ww, ok ? wsz[m] : 0);
      }
  };

  float ee[kCo][NC], eo[kCo][NC], oe[kCo][NC], oo[kCo][NC];
#pragma unroll
  for (int c = 0; c < kCo; ++c)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ee[c][j] = eo[c][j] = oe[c][j] = oo[c][j] = 0.f;

  const int nk = (Ci + kKC - 1) / kKC;
#pragma unroll 1
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nk) load(k, k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the slot read in the last round is free for the round kStages - 1 on
    const int kn = k + kStages - 1;
    if (kn < nk) load(kn, kn % kStages);
    cp_async_commit();

    const float* sx = sm + (k % kStages) * T::STAGE + lane;
    const float* sw = sm + (k % kStages) * T::STAGE + T::XS + warp * kCo;
    // operands one step ahead in registers: the next channel's x and the
    // next tap's weights
    float p[4][NC], w[kCo], wn[kCo];
    load_x(sx, sx + T::XP, p);
    load_taps(sw, w);
#pragma unroll
    for (int ci = 0; ci < kKC; ++ci) {
      const float* wt = sw + ci * kTaps * kWP;
      float pn[4][NC];
      if (ci + 1 < kKC)
        load_x(sx + (ci + 1) * 2 * T::XP, sx + (ci + 1) * 2 * T::XP + T::XP,
               pn);
      load_taps(wt + 1 * kWP, wn); fma_tile(ee, w, p[3]);    // w[0][0]
      load_taps(wt + 2 * kWP, w);  fma_tile(eo, wn, p[2]);   // w[0][1]
      load_taps(wt + 3 * kWP, wn); fma_tile(ee, w, p[2]);    // w[0][2]
      load_taps(wt + 4 * kWP, w);  fma_tile(oe, wn, p[1]);   // w[1][0]
      load_taps(wt + 5 * kWP, wn); fma_tile(oo, w, p[0]);    // w[1][1]
      load_taps(wt + 6 * kWP, w);  fma_tile(oe, wn, p[0]);   // w[1][2]
      load_taps(wt + 7 * kWP, wn); fma_tile(ee, w, p[1]);    // w[2][0]
      load_taps(wt + 8 * kWP, w);  fma_tile(eo, wn, p[0]);   // w[2][1]
      if (ci + 1 < kKC) load_taps(wt + kTaps * kWP, wn);
      fma_tile(ee, w, p[0]);                                  // w[2][2]
      if (ci + 1 < kKC) {
#pragma unroll
        for (int c = 0; c < kCo; ++c) w[c] = wn[c];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < NC; ++j) p[u][j] = pn[u][j];
      }
    }
  }
  cp_async_wait<0>();

  const int Ho = 2 * H + 1, Wo = 2 * W + 1;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int g = c0 + lane + 32 * j;
    if (g >= ncells) break;
    const int a = g / W1, b = g - a * W1;
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
      const int co = co0 + warp * kCo + c;
      if (co >= Co) break;
      float* o = y + (((long long)s * Co + co) * Ho + 2 * a) * Wo + 2 * b;
      o[0] = ee[c][j];
      if (b < W) o[1] = eo[c][j];
      if (a < H) {
        o[Wo] = oe[c][j];
        if (b < W) o[Wo + 1] = oo[c][j];
      }
    }
  }
}

template <int NC>
cudaError_t launch(const float* x, const float* ww, float* y, int B, int Ci,
                   int Co, int H, int W, cudaStream_t stream) {
  using T = Tile<NC>;
  // above 48 KB of shared memory a launch needs the opt-in (on the current
  // device, so it is asked each time)
  const cudaError_t err = cudaFuncSetAttribute(
      modconv_up_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (err != cudaSuccess) return err;
  const long long ncells = (long long)(H + 1) * (W + 1);
  const int cell_tiles = (int)((ncells + T::TP - 1) / T::TP);
  const int co_tiles = (Co + kTM - 1) / kTM;
  const long long blocks = (long long)cell_tiles * co_tiles * B;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  modconv_up_kernel<NC><<<(unsigned)blocks, kThreads, T::SMEM, stream>>>(
      x, ww, y, Ci, Co, H, W, cell_tiles, co_tiles);
  return cudaGetLastError();
}

}  // namespace

// x (B, Ci, H, W), ww (B, Co, Ci, 3, 3), y (B, Co, 2H+1, 2W+1): float32,
// contiguous NCHW.  Returns the launch's cudaError_t.
extern "C" int sgt_modconv_up(const void* x, const void* ww, void* y, int B,
                              int Ci, int Co, int H, int W, void* stream) {
  if (B == 0 || Co == 0) return 0;
  if (B < 0 || Ci < 1 || Co < 0 || H < 1 || W < 1 ||
      (long long)(H + 1) * (W + 1) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(ww);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const long long ncells = (long long)(H + 1) * (W + 1);
  cudaError_t err;
  if (ncells >= 1024)
    err = launch<3>(xf, wf, yf, B, Ci, Co, H, W, s);
  else if (ncells >= 256)
    err = launch<2>(xf, wf, yf, B, Ci, Co, H, W, s);
  else
    err = launch<1>(xf, wf, yf, B, Ci, Co, H, W, s);
  return (int)err;
}
