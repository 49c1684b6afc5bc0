// Host-side plan of one epilogue call: which path, block shape, channel
// chunking, cluster size, row splits, shared memory and workspace.  Plain
// C++ with no CUDA include, so that the CPU tests compile it with the host
// compiler and check it; epilogue.cu includes it and launches what it says.
//
// Paths (see epilogue.cu's header for why), of the forward and the backward
// alike:
//   1  one-pass: each (b, channel chunk) slab (of x; of g and x for the
//      backward) is held in the shared memory of one block, or of a cluster
//      of kMaxCluster blocks that split its rows; one launch.
//   2  two-pass: a first pass whose last block per (b, chunk) merges the row
//      splits, then a second pass; two launches.
//
// Exported: sgt_epilogue_plan, sgt_epilogue_split_plan, sgt_epilogue_bwd_plan
// and sgt_epilogue_bwd_split_plan (defined once, in the translation unit that
// includes this header: the kernel library or the test's shim).

#ifndef SGT_EPILOGUE_PLAN_H_
#define SGT_EPILOGUE_PLAN_H_

#ifdef __CUDACC__
#define SGT_HD __host__ __device__
#else
#define SGT_HD
#endif

extern "C" {

struct SgtPlan {
  int path;            // 1 or 2
  int vec;             // elements per 16-byte vector (4 f32, 8 bf16), or 1
  int tx, ty;          // block shape: tx threads along C, ty along the rows
  int chunk_c;         // channels per block: tx * vec
  int chunks;          // channel chunks: ceil(C / chunk_c)
  int cluster;         // path 1: blocks per (b, chunk); 1 on path 2
  int splits;          // path 2: pass-1 row splits per (b, chunk)
  int launches;        // CUDA launches per call: 1 or 2
  long long rows_per_rank;   // path 1: rows held by each block of a cluster
  long long rows_per_split;  // path 2: rows of one pass-1 block
  long long rows_per_block;  // path 2: rows of one pass-2 block
  long long smem_bytes;      // path 1: dynamic shared memory per block
  long long stats_offset;    // path 2: workspace bytes before the stats
  long long tickets_offset;  // path 2: workspace bytes before the tickets
  long long workspace_bytes; // path 2: partials, stats and tickets
};

// The backward.  Path 1 (epilogue.cu's onepass_bwd_kernel): the grid
// (chunks * cluster, B) of (tx, ty) blocks, clusters of `cluster` along x;
// the ranks of a cluster are its row splits (splits == cluster,
// rows_per_split the rows of a rank).  Path 2 (bwd_sums_kernel, then
// bwd_dx_kernel): both launches take the grid (splits, chunks, B) of (tx, ty)
// blocks, tx * ty == kThreads.  Workspace, in this order, each part 16-byte
// aligned: pass-1 partials (B, splits, C) float2 and coefficients (B, C)
// float4 (path 2 only: empty on path 1), dnoise_weight partials
// (B, splits, C) float, dnoise partials (chunks, B, R) float when
// dn_partials, and the tickets: B * chunks (pass 1), chunks (dnoise_weight),
// B * splits (dnoise).
struct SgtBwdPlan {
  int path;            // 1 or 2
  int vec, tx, ty, chunk_c, chunks;
  int cluster;         // path 1: blocks per (b, chunk); 1 on path 2
  int splits;          // row splits per (b, chunk): the ranks on path 1
  int launches;        // CUDA launches per call: 1 or 2
  int dn_partials;     // dnoise is summed over channel chunks
  long long rows_per_split;  // rows of one split (of one rank on path 1)
  long long smem_bytes;      // path 1: dynamic shared memory per block
  long long coef_offset, dnw_offset, dn_offset, tickets_offset;
  long long workspace_bytes;
};

}  // extern "C"

namespace sgt {

constexpr int kThreads = 256;
constexpr long long kMaxSmem = 232448;  // 227 KB: a block's most on sm_90
// Clusters of 4 and 8 would hold planes up to 128^2 x 128 on chip, but lost
// to two passes at every main-path shape on the H100 (PERF.md).
constexpr int kMaxCluster = 2;
constexpr int kMinBlocks = 128;         // about one block per SM of 132
constexpr int kMinRowBytes = 32;        // a sector: the narrowest chunk row
// Pass-1 blocks to aim for; bf16 (8-wide vectors, one load in flight) did
// best with half of f32's on the H100 (PERF.md).
constexpr int kTargetStatsBlocks = 1024;
// Blocks of each of the backward's two passes to aim for: about two per SM,
// one wave in both passes (PERF.md).
constexpr int kTargetBwdBlocks = 256;
constexpr int kMinRowsPerThread = 8;

SGT_HD inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
SGT_HD inline long long align16(long long n) { return (n + 15) / 16 * 16; }
inline int pow2_at_least(long long n, int cap) {
  int p = 1;
  while (p < n && p < cap) p *= 2;
  return p;
}

// Dynamic shared memory of a one-pass block: `slabs` slabs (x; or g and x),
// their noise column, the reduction buffer (ty x chunk_c f32) and the
// partials that a cluster exchanges (chunk_c float2); each part 16-byte
// aligned.
inline long long onepass_smem(int elem, int slabs, int chunk_c, int ty,
                              long long rows) {
  return slabs * align16(rows * chunk_c * elem) + align16(rows * elem) +
         align16((long long)ty * chunk_c * 4) + (long long)chunk_c * 8;
}

// The geometry of a one-pass launch, where one fits.
struct OnePass {
  int tx, ty, cluster;
  long long rows_per_rank, smem_bytes;
};

inline bool fit_one_pass(int vec, int elem, int slabs, int B, long long R,
                         int C, int max_tx, OnePass* f) {
  // Widest rows first (128 bytes), then narrower down to a sector; within a
  // width the smallest cluster whose slabs fit.  A grid of fewer than
  // kMinBlocks blocks narrows the chunk down to a sector, then, for planes
  // of many rows, doubles the cluster.
  int best_tx = 0, best_cl = 0;
  for (int tx = max_tx; tx >= 1 && !best_tx; tx /= 2) {
    const int cc = tx * vec;
    if (cc * elem < kMinRowBytes && tx != max_tx) break;
    for (int cl = 1; cl <= kMaxCluster; cl *= 2) {
      const long long rpr = cdiv(R, cl);
      if (cl > 1 && (cl - 1) * rpr >= R) break;  // a rank would hold no rows
      const int ty = pow2_at_least(rpr, kThreads / tx);
      if (onepass_smem(elem, slabs, cc, ty, rpr) <= kMaxSmem) {
        best_tx = tx;
        best_cl = cl;
        break;
      }
    }
  }
  if (!best_tx) return false;
  for (;;) {
    const long long blocks = (long long)B * cdiv(C, best_tx * vec) * best_cl;
    if (blocks >= kMinBlocks) break;
    const long long rpr2 = cdiv(R, best_cl * 2);
    if (best_tx > 1 && (best_tx / 2) * vec * elem >= kMinRowBytes) {
      best_tx /= 2;
    } else if (best_cl < kMaxCluster && rpr2 >= 2 * kThreads &&
               (best_cl * 2 - 1) * rpr2 < R) {
      best_cl *= 2;
    } else {
      break;
    }
  }
  f->tx = best_tx;
  f->cluster = best_cl;
  f->rows_per_rank = cdiv(R, best_cl);
  f->ty = pow2_at_least(f->rows_per_rank, kThreads / best_tx);
  f->smem_bytes = onepass_smem(elem, slabs, best_tx * vec, f->ty,
                               f->rows_per_rank);
  return true;
}

inline bool one_pass(SgtPlan& p, int elem, int B, long long R, int C,
                     int max_tx) {
  OnePass f;
  if (!fit_one_pass(p.vec, elem, 1, B, R, C, max_tx, &f))
    return false;
  p.path = 1;
  p.tx = f.tx;
  p.ty = f.ty;
  p.chunk_c = f.tx * p.vec;
  p.chunks = (int)cdiv(C, p.chunk_c);
  p.cluster = f.cluster;
  p.rows_per_rank = f.rows_per_rank;
  p.smem_bytes = f.smem_bytes;
  p.launches = 1;
  return true;
}

// Rows of one pass-1 block: about `target` blocks over the grid, at least
// kMinRowsPerThread rows a thread, a whole number of row groups.
inline long long split_rows(long long target, int B, long long R, int chunks,
                            int ty) {
  long long want = target / ((long long)B * chunks);
  if (want < 1) want = 1;
  long long rps = cdiv(R, want);
  if (rps < (long long)ty * kMinRowsPerThread)
    rps = (long long)ty * kMinRowsPerThread;
  return cdiv(rps, ty) * ty;
}

// Workspace of path 2, in this order, each part 16-byte aligned: partials
// (B, splits, C) float2, stats (B, C) float2, tickets (B, chunks) int32.
inline void two_pass(SgtPlan& p, int B, long long R, int C, int max_tx) {
  p.path = 2;
  p.tx = max_tx;
  p.ty = kThreads / p.tx;
  p.chunk_c = p.tx * p.vec;
  p.chunks = (int)cdiv(C, p.chunk_c);
  // half as many pass-1 blocks in bf16
  p.rows_per_split = split_rows(
      p.vec == 8 ? kTargetStatsBlocks / 2 : kTargetStatsBlocks, B, R,
      p.chunks, p.ty);
  p.splits = (int)cdiv(R, p.rows_per_split);
  p.rows_per_block = (long long)p.ty * kMinRowsPerThread;
  p.launches = 2;
  p.stats_offset = align16((long long)B * p.splits * C * 8);
  p.tickets_offset = p.stats_offset + align16((long long)B * C * 8);
  p.workspace_bytes = p.tickets_offset + align16((long long)B * p.chunks * 4);
}

inline bool valid_call(int B, long long R, int C) {
  return B >= 1 && R >= 1 && C >= 1 && B <= 65535 && R <= (1LL << 31);
}

// Elements per 16-byte vector (4 f32, 8 bf16), or 1 where C or a pointer
// does not allow vectors; and the threads along C: a power of two, at most
// a warp, at most 128-byte rows.
inline void lanes(int is_bf16, int C, int aligned, int* vec, int* max_tx) {
  const int elem = is_bf16 ? 2 : 4;
  int v = is_bf16 ? 8 : 4;
  if (C % v != 0 || !aligned) v = 1;
  int tx = pow2_at_least(cdiv(C, v), 32);
  while (tx > 1 && tx * v * elem > 128) tx /= 2;
  *vec = v;
  *max_tx = tx;
}

// 0 on success; -1 for an empty or oversized call.
inline int make_plan(int is_bf16, int B, long long R, int C, int aligned,
                     SgtPlan* out) {
  if (!valid_call(B, R, C)) return -1;
  SgtPlan p = {};
  const int elem = is_bf16 ? 2 : 4;
  int max_tx = 1;
  lanes(is_bf16, C, aligned, &p.vec, &max_tx);
  p.cluster = 1;
  p.splits = 1;
  if (!one_pass(p, elem, B, R, C, max_tx)) two_pass(p, B, R, C, max_tx);
  *out = p;
  return 0;
}

// The plan of the split-plane forward (K1-partial, then K2-apply, on each
// rank's rows of a plane split over ranks): the two-pass geometry at every
// size, small slabs included, so that one code path serves every slab.
// Each of the two entries launches one kernel; K1-partial takes the
// workspace (its stats part unused: it writes the caller's buffer).
inline int make_split_plan(int is_bf16, int B, long long R, int C,
                           int aligned, SgtPlan* out) {
  if (!valid_call(B, R, C)) return -1;
  SgtPlan p = {};
  int max_tx = 1;
  lanes(is_bf16, C, aligned, &p.vec, &max_tx);
  p.cluster = 1;
  two_pass(p, B, R, C, max_tx);
  p.launches = 1;
  *out = p;
  return 0;
}

// The backward's plan: one pass where the slabs of g and x fit on chip (as
// the forward's path 1), else two passes over the forward's two-pass chunks
// with the backward's own split target.  `split` (the split-plane backward,
// K3-partial then K3-apply on each rank's rows of a plane split over ranks)
// takes the two-pass geometry at every size, one launch per entry.
// `aligned`: g, x and dx start on 16-byte boundaries.
inline int make_bwd_plan(int is_bf16, int B, long long R, int C, int aligned,
                         int want_dn, SgtBwdPlan* out, bool split = false) {
  if (!valid_call(B, R, C)) return -1;
  SgtBwdPlan p = {};
  const int elem = is_bf16 ? 2 : 4;
  int max_tx = 1;
  lanes(is_bf16, C, aligned, &p.vec, &max_tx);
  OnePass f;
  if (!split && fit_one_pass(p.vec, elem, 2, B, R, C, max_tx, &f)) {
    p.path = 1;
    p.tx = f.tx;
    // the last block's merges give each channel ty / vec >= 1 threads
    p.ty = f.ty < p.vec ? p.vec : f.ty;
    p.cluster = p.splits = f.cluster;
    p.rows_per_split = f.rows_per_rank;
    p.smem_bytes = onepass_smem(elem, 2, p.tx * p.vec, p.ty, f.rows_per_rank);
    p.launches = 1;
  } else {
    p.path = 2;
    p.tx = max_tx;
    p.ty = kThreads / p.tx;
    p.cluster = 1;
    p.rows_per_split =
        split_rows(kTargetBwdBlocks, B, R, cdiv(C, p.tx * p.vec), p.ty);
    p.splits = (int)cdiv(R, p.rows_per_split);
    p.launches = split ? 1 : 2;
  }
  p.chunk_c = p.tx * p.vec;
  p.chunks = (int)cdiv(C, p.chunk_c);
  p.dn_partials = want_dn && p.chunks > 1;
  const long long bsc = (long long)B * p.splits * C;
  long long off = p.path == 2 ? align16(bsc * 8) : 0;
  p.coef_offset = off;
  if (p.path == 2) off += align16((long long)B * C * 16);
  p.dnw_offset = off;
  off += align16(bsc * 4);
  p.dn_offset = off;
  if (p.dn_partials) off += align16((long long)p.chunks * B * R * 4);
  p.tickets_offset = off;
  off += align16(((long long)B * p.chunks + p.chunks +
                  (long long)B * p.splits) * 4);
  p.workspace_bytes = off;
  *out = p;
  return 0;
}

}  // namespace sgt

extern "C" int sgt_epilogue_plan(int is_bf16, int B, long long R, int C,
                                 int aligned, SgtPlan* plan) {
  return sgt::make_plan(is_bf16, B, R, C, aligned, plan);
}

extern "C" int sgt_epilogue_split_plan(int is_bf16, int B, long long R,
                                       int C, int aligned, SgtPlan* plan) {
  return sgt::make_split_plan(is_bf16, B, R, C, aligned, plan);
}

extern "C" int sgt_epilogue_bwd_plan(int is_bf16, int B, long long R, int C,
                                     int aligned, int want_dn,
                                     SgtBwdPlan* plan) {
  return sgt::make_bwd_plan(is_bf16, B, R, C, aligned, want_dn, plan);
}

extern "C" int sgt_epilogue_bwd_split_plan(int is_bf16, int B, long long R,
                                           int C, int aligned, int want_dn,
                                           SgtBwdPlan* plan) {
  return sgt::make_bwd_plan(is_bf16, B, R, C, aligned, want_dn, plan, true);
}

#endif  // SGT_EPILOGUE_PLAN_H_
