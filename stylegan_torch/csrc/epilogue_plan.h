// Host-side plan of one epilogue call: which path, block shape, channel
// chunking, cluster size, row splits, shared memory and workspace.  Plain
// C++ with no CUDA include, so that the CPU tests compile it with the host
// compiler and check it; epilogue.cu includes it and launches what it says.
//
// Paths (see epilogue.cu's header for why):
//   1  one-pass: each (b, channel chunk) slab is held in the shared memory of
//      one block, or of a cluster of kMaxCluster blocks that split its rows;
//      one launch.
//   2  two-pass: a stats pass whose last block per (b, chunk) merges the row
//      splits, then an apply pass; two launches.
//
// Exported: sgt_epilogue_plan (defined once, in the translation unit that
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
constexpr int kMinRowsPerThread = 8;

SGT_HD inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
SGT_HD inline long long align16(long long n) { return (n + 15) / 16 * 16; }
inline int pow2_at_least(long long n, int cap) {
  int p = 1;
  while (p < n && p < cap) p *= 2;
  return p;
}

// Dynamic shared memory of a one-pass block: the slab of x, its noise
// column, the reduction buffer (ty x chunk_c f32) and the partials that a
// cluster exchanges (chunk_c float2); each part 16-byte aligned.
inline long long onepass_smem(int elem, int chunk_c, int ty, long long rows) {
  return align16(rows * chunk_c * elem) + align16(rows * elem) +
         align16((long long)ty * chunk_c * 4) + (long long)chunk_c * 8;
}

inline bool one_pass(SgtPlan& p, int elem, int B, long long R, int C,
                     int max_tx) {
  // Widest rows first (128 bytes), then narrower down to a sector; within a
  // width the smallest cluster whose slab fits.  A grid of fewer than
  // kMinBlocks blocks narrows the chunk down to a sector, then, for planes
  // of many rows, doubles the cluster.
  int best_tx = 0, best_cl = 0;
  for (int tx = max_tx; tx >= 1 && !best_tx; tx /= 2) {
    const int cc = tx * p.vec;
    if (cc * elem < kMinRowBytes && tx != max_tx) break;
    for (int cl = 1; cl <= kMaxCluster; cl *= 2) {
      const long long rpr = cdiv(R, cl);
      if (cl > 1 && (cl - 1) * rpr >= R) break;  // a rank would hold no rows
      const int ty = pow2_at_least(rpr, kThreads / tx);
      if (onepass_smem(elem, cc, ty, rpr) <= kMaxSmem) {
        best_tx = tx;
        best_cl = cl;
        break;
      }
    }
  }
  if (!best_tx) return false;
  for (;;) {
    const long long blocks = (long long)B * cdiv(C, best_tx * p.vec) * best_cl;
    if (blocks >= kMinBlocks) break;
    const long long rpr2 = cdiv(R, best_cl * 2);
    if (best_tx > 1 && (best_tx / 2) * p.vec * elem >= kMinRowBytes) {
      best_tx /= 2;
    } else if (best_cl < kMaxCluster && rpr2 >= 2 * kThreads &&
               (best_cl * 2 - 1) * rpr2 < R) {
      best_cl *= 2;
    } else {
      break;
    }
  }
  p.path = 1;
  p.tx = best_tx;
  p.chunk_c = best_tx * p.vec;
  p.chunks = (int)cdiv(C, p.chunk_c);
  p.cluster = best_cl;
  p.rows_per_rank = cdiv(R, best_cl);
  p.ty = pow2_at_least(p.rows_per_rank, kThreads / best_tx);
  p.smem_bytes = onepass_smem(elem, p.chunk_c, p.ty, p.rows_per_rank);
  p.launches = 1;
  return true;
}

// Workspace of path 2, in this order, each part 16-byte aligned: partials
// (B, splits, C) float2, stats (B, C) float2, tickets (B, chunks) int32.
inline void two_pass(SgtPlan& p, int B, long long R, int C, int max_tx) {
  p.path = 2;
  p.tx = max_tx;
  p.ty = kThreads / p.tx;
  p.chunk_c = p.tx * p.vec;
  p.chunks = (int)cdiv(C, p.chunk_c);
  const long long target =
      p.vec == 8 ? kTargetStatsBlocks / 2 : kTargetStatsBlocks;
  long long want = target / ((long long)B * p.chunks);
  if (want < 1) want = 1;
  long long rps = cdiv(R, want);
  if (rps < (long long)p.ty * kMinRowsPerThread)
    rps = (long long)p.ty * kMinRowsPerThread;
  p.rows_per_split = cdiv(rps, p.ty) * p.ty;
  p.splits = (int)cdiv(R, p.rows_per_split);
  p.rows_per_block = (long long)p.ty * kMinRowsPerThread;
  p.launches = 2;
  p.stats_offset = align16((long long)B * p.splits * C * 8);
  p.tickets_offset = p.stats_offset + align16((long long)B * C * 8);
  p.workspace_bytes = p.tickets_offset + align16((long long)B * p.chunks * 4);
}

// 0 on success; -1 for an empty or oversized call.
inline int make_plan(int is_bf16, int B, long long R, int C, int aligned,
                     SgtPlan* out) {
  if (B < 1 || R < 1 || C < 1 || B > 65535 || R > (1LL << 31)) return -1;
  SgtPlan p = {};
  const int elem = is_bf16 ? 2 : 4;
  p.vec = is_bf16 ? 8 : 4;
  if (C % p.vec != 0 || !aligned) p.vec = 1;
  // threads along C: a power of two, at most a warp, at most 128-byte rows
  const int lanes = (int)cdiv(C, p.vec);
  int max_tx = pow2_at_least(lanes, 32);
  while (max_tx > 1 && max_tx * p.vec * elem > 128) max_tx /= 2;
  p.cluster = 1;
  p.splits = 1;
  if (!one_pass(p, elem, B, R, C, max_tx)) two_pass(p, B, R, C, max_tx);
  *out = p;
  return 0;
}

}  // namespace sgt

extern "C" int sgt_epilogue_plan(int is_bf16, int B, long long R, int C,
                                 int aligned, SgtPlan* plan) {
  return sgt::make_plan(is_bf16, B, R, C, aligned, plan);
}

#endif  // SGT_EPILOGUE_PLAN_H_
