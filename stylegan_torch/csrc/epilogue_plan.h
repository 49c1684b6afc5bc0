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
// The split-plane entries (a plane whose rows lie on several ranks): K2-apply
// takes path 2's geometry at every slab size, one launch; K1-partial and
// K3-partial, per-(b, c) reductions whose result leaves the launch, take
// make_partial_plan's: one launch of clusters of blocks that merge over
// distributed shared memory; K3-apply takes make_bwd_apply_plan's: one
// launch, a cluster per channel chunk for a small slab, a streaming grid of
// whole waves for a large one.
//
// Exported: sgt_epilogue_plan, sgt_epilogue_split_plan (K2-apply's),
// sgt_epilogue_partial_plan (K1-partial's), sgt_epilogue_bwd_plan,
// sgt_epilogue_bwd_partial_plan (K3-partial's) and
// sgt_epilogue_bwd_apply_plan (K3-apply's), defined once, in the
// translation unit that includes this header: the kernel library or the
// test's shim.

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

// The split-plane partial reductions (K1-partial; K3-partial): per-(b, c)
// sums over this rank's R rows that leave the launch for a cross-rank
// merge.  One launch on the grid (splits, chunks, B) of (tx, ty) blocks in
// thread-block clusters of `cluster` along x: the blocks of a cluster split
// a (b, chunk)'s rows and merge their partials over distributed shared
// memory in rank order; `groups` clusters cover the rows, and where there
// are several, each writes one partial and the last to finish, found by a
// ticket, merges them in group order.  Workspace (groups > 1 only), each
// part 16-byte aligned: the clusters' partials (B, groups, C) float2, then
// the tickets (B, chunks) int32.
struct SgtPartialPlan {
  int vec, tx, ty, chunk_c, chunks;
  int cluster;         // blocks per cluster: row splits merged over DSMEM
  int groups;          // clusters per (b, chunk)
  int splits;          // cluster * groups row splits per (b, chunk)
  int nonportable;     // cluster > 8: launched with the non-portable opt-in
  int unroll;          // rows a thread loads at once: 1 (K1-partial) or 4
  long long rows_per_split;
  long long tickets_offset;   // workspace bytes before the tickets
  long long workspace_bytes;  // 0 where one cluster covers a (b, chunk)
};

// K3-apply's plan (dx, this rank's share of dnoise_weight and its rows of
// dnoise, from the ranks' merged sums).  One launch on the grid
// (B * splits, chunks) of (tx, ty) blocks: block x holds split x % splits
// of b = x / splits, rows [split * rows_per_split, ...) of its (b, chunk),
// and thread (tx, ty) channels c0 .. c0 + vec - 1 of rows r0 + ty,
// r0 + ty + ty_count, ..., `unroll` rows at once and the next `unroll`
// loaded while these compute.  Two forms:
//   1 (cluster)  B * splits <= kMaxApplyCluster blocks, a power of two, form
//                one thread-block cluster per chunk that covers its B x R
//                rows; the cluster's rank 0 adds the blocks' dnoise_weight
//                partials over distributed shared memory in rank order and
//                writes the result: no workspace, fence or ticket.
//   2 (stream)   whole rows where C * elem <= kApplyWholeRowBytes, else
//                128-byte chunks; kApplyWaves waves of the kernel's resident
//                blocks (`wave`, the caller's occupancy times the SMs),
//                fewer where a thread would get under kApplyStreamRows rows;
//                each block writes a dnoise_weight partial and the last of
//                a chunk, by ticket, adds them in block order.  With whole
//                16-byte-vector rows and R a multiple of 8, `ring` > 0
//                stages of g, x and noise in shared memory (smem_bytes),
//                each a step of rows (ty * unroll; the splits whole steps)
//                filled by bulk asynchronous copies (the tensor memory
//                accelerator) and waited on by an mbarrier, take the place
//                of the register loads.
// Where dnoise is asked for and C spans several chunks (dn_partials), each
// block writes its rows' partial dnoise and the last chunk of a (b, split),
// by ticket, adds them in chunk order.  Workspace, each part 16-byte
// aligned: dnoise_weight partials (B * splits, C) float (form 2), dnoise
// partials (chunks, B, R) float (dn_partials), then the tickets: chunks
// (form 2), then B * splits (dn_partials); none in form 1 without dnoise
// partials.
struct SgtApplyPlan {
  int form;            // 1 cluster, 2 stream
  int vec, tx, ty, chunk_c, chunks;
  int cluster;         // blocks per cluster: B * splits in form 1, else 1
  int splits;          // row splits per (b, chunk)
  int nonportable;     // cluster > 8: launched with the non-portable opt-in
  int unroll;          // rows a thread loads at once
  int reverse;         // blocks and their rows walked last to first
  int dn_partials;     // dnoise summed over chunks through the workspace
  int ring;            // form 2: shared-memory stages of bulk copies, or 0
  int ahead;           // form 2 in registers: loads one step ahead
  long long rows_per_split;
  long long smem_bytes;      // the ring's dynamic shared memory per block
  long long dn_offset;       // workspace bytes before the dnoise partials
  long long tickets_offset;  // workspace bytes before the tickets
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
// The split-plane partial reductions (make_partial_plan), K1-partial's and
// K3-partial's: the rows each thread loads at once (16 bytes each, of x; of
// g and x), and K1-partial's in bf16 in the cluster form (its 8-wide
// vectors hold 8 Welford states a thread: more loads lost there); the
// blocks a streaming grid aims at, K1-partial's f32 and bf16, K3-partial's;
// the most blocks a grid of clusters aims at (about one wave of them on the
// H100), the slab's bytes per block it aims at, and the most rounds a
// thread takes in it; a row split's fewest rows; blocks per cluster (8:
// the portable most); a streaming thread's fewest rows where the grid
// keeps kMinBlocks; the most partials a merging block loads, over its
// channels.
constexpr int kPartialUnroll = 4;
constexpr int kPartialClusterUnrollBf16 = 1;
constexpr long long kStreamBlocks = 1024;
constexpr long long kStreamBlocksBf16 = 256;
constexpr long long kBwdStreamBlocks = 256;
constexpr long long kMaxPartialBlocks = 256;
constexpr long long kClusterBlockBytes = 128 << 10;
constexpr long long kMaxClusterRounds = 8;
constexpr long long kMinSplitRows = 32;
constexpr int kMaxPartialCluster = 8;
constexpr long long kStreamRowsPerThread = 32;
constexpr long long kMaxMergeLoads = 4096;
// K3-apply (make_bwd_apply_plan): the most blocks of a form-1 cluster (8:
// the portable most), the most bytes of g, x and dx a slab may have in
// form 1 and a form-1 block aims at, a form-1 row split's fewest rows, the
// most load steps a form-1 thread takes, the rows a thread loads at once
// in each form (f32, bf16; 2, 4 or 8) and whether form 2 loads them a step
// ahead, the widest rows a form-2 block takes whole (bf16, the ring's;
// f32), form 2's waves, its
// fewest rows a thread, and whether both forms walk their blocks and rows
// last to first.
constexpr int kMaxApplyCluster = 8;
constexpr long long kApplyClusterBytes = 7 << 20;
constexpr long long kApplyBlockBytes = 64 << 10;
constexpr long long kApplyMinSplitRows = 16;
constexpr long long kApplyClusterSteps = 2;
constexpr int kApplyClusterUnroll = 4;
constexpr int kApplyClusterUnrollBf16 = 2;
constexpr int kApplyStreamUnroll = 2;
constexpr int kApplyStreamUnrollBf16 = 2;
constexpr int kApplyStreamAhead = 1;
constexpr int kApplyWholeRowBytes = 256;
constexpr int kApplyWholeRowBytesF32 = 128;
constexpr long long kApplyWaves = 1;
constexpr long long kApplyStreamRows = 4;
constexpr int kApplyReverse = 1;
// Form 2's stages of bulk copies in shared memory where it takes whole
// 16-byte-vector rows (f32, bf16; 0: register loads, one step ahead), the
// rows a thread takes from a stage, and the shared memory a block keeps
// beside them (its static buffers, under 16 KB).
constexpr int kApplyRingStages = 0;
constexpr int kApplyRingStagesBf16 = 3;
constexpr int kApplyRingUnroll = 8;
constexpr long long kApplyStaticSmem = 16 << 10;

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

// K2-apply's plan (on each rank's rows of a plane split over ranks, after
// K1-partial and the ranks' merge): the two-pass geometry at every size,
// small slabs included, one launch; it takes no workspace.
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

// The plan of a split-plane partial reduction, K1-partial's or
// K3-partial's, reading `slabs` tensors of (B, R, C) (x; g and x):
// `unroll` and `stream_unroll` rows a thread loads at once in the two
// forms, `stream_blocks` the grid a streaming slab aims at:
//   cluster  a slab that each thread loads in one round on at most
//            kMaxPartialBlocks blocks (the chunk narrowed down to 32-byte
//            rows as far as that takes), where the clusters then reach the
//            aim or the stream form's grid; or in up to kMaxClusterRounds
//            rounds on a grid that 128-byte chunks fill.  The aim is a
//            block per kClusterBlockBytes of the slab, kMinBlocks to
//            kMaxPartialBlocks; one cluster of up to kMaxPartialCluster
//            blocks per (b, chunk) covers its rows, so no workspace, fence
//            or ticket.
//   stream   the rest: about stream_blocks blocks, splits of at least
//            kStreamRowsPerThread rows a thread (fewer where the grid would
//            fall short of kMinBlocks) and at most kMaxMergeLoads / chunk_c
//            of them per (b, chunk) (the merge's loads, over the block's
//            threads), in chunks of 128-byte rows narrowed while that grows
//            a grid short of stream_blocks; no cluster: the last block of a
//            (b, chunk), by ticket, merges its splits.
// Clusters and tickets are never combined: clusters that cannot cover a
// (b, chunk) lost to both on the H100 (PERF.md).
inline int make_partial_plan(int is_bf16, int B, long long R, int C,
                             int aligned, int slabs, int unroll,
                             int stream_unroll, long long stream_blocks,
                             SgtPartialPlan* out) {
  if (!valid_call(B, R, C)) return -1;
  SgtPartialPlan p = {};
  const int elem = is_bf16 ? 2 : 4;
  int max_tx = 1;
  lanes(is_bf16, C, aligned, &p.vec, &max_tx);
  auto chunks_at = [&](int t) { return cdiv(C, t * p.vec); };
  // blocks that give each thread one round of 16-byte row vectors (lanes
  // past C included)
  const long long one_round =
      cdiv((long long)B * R * chunks_at(max_tx) * max_tx,
           (long long)kThreads * unroll);
  // the cluster form's aim: a block per kClusterBlockBytes of the slab,
  // kMinBlocks to kMaxPartialBlocks
  long long target =
      cdiv((long long)B * R * C * elem * slabs, kClusterBlockBytes);
  if (target < kMinBlocks) target = kMinBlocks;
  if (target > kMaxPartialBlocks) target = kMaxPartialBlocks;
  const long long max_splits = cdiv(R, kMinSplitRows);
  const long long one_cluster =
      max_splits < kMaxPartialCluster ? max_splits : kMaxPartialCluster;
  auto narrow = [&](int t) {
    return t > 1 && (t / 2) * p.vec * elem >= kMinRowBytes;
  };
  // the stream form's most splits per (b, chunk) at a width
  auto most = [&](int t) {
    long long m = cdiv(R, (long long)(kThreads / t) * kStreamRowsPerThread);
    const long long fill = cdiv(kMinBlocks, (long long)B * chunks_at(t));
    if (m < fill) m = fill;
    if (m > max_splits) m = max_splits;
    const long long by_merge = kMaxMergeLoads / (t * p.vec);
    return m < by_merge ? m : by_merge;
  };
  auto grid_at = [&](int t) { return (long long)B * chunks_at(t) * most(t); };
  int stream_tx = max_tx;
  while (narrow(stream_tx) && grid_at(stream_tx) < stream_blocks &&
         grid_at(stream_tx / 2) > grid_at(stream_tx))
    stream_tx /= 2;
  long long stream_groups =
      cdiv(stream_blocks, (long long)B * chunks_at(stream_tx));
  if (stream_groups > most(stream_tx)) stream_groups = most(stream_tx);
  const long long stream_grid =
      (long long)B * chunks_at(stream_tx) * stream_groups;
  // the cluster form
  int tx = max_tx;
  while (narrow(tx) && (long long)B * chunks_at(tx) * one_cluster < target)
    tx /= 2;
  const long long reach = (long long)B * chunks_at(tx) * one_cluster;
  long long cl = 1, groups = 1;
  if ((one_round <= kMaxPartialBlocks &&
       reach >= (target < stream_grid ? target : stream_grid)) ||
      (one_round <= kMaxClusterRounds * kMaxPartialBlocks &&
       (long long)B * chunks_at(max_tx) * one_cluster >= target)) {
    if (one_round > kMaxPartialBlocks) tx = max_tx;
    long long s = cdiv(target, (long long)B * chunks_at(tx));
    if (s > one_cluster) s = one_cluster;
    while (cl < s) cl *= 2;
    p.unroll = unroll;
  } else {
    tx = stream_tx;
    groups = stream_groups;
    p.unroll = stream_unroll;
  }
  long long rps = cdiv(R, cl * groups);
  while ((cl * groups - 1) * rps >= R) {  // no split without rows
    if (groups > 1) --groups; else cl /= 2;
    rps = cdiv(R, cl * groups);
  }
  p.tx = tx;
  p.chunk_c = tx * p.vec;
  p.chunks = (int)chunks_at(tx);
  p.cluster = (int)cl;
  p.groups = (int)groups;
  p.splits = (int)(cl * groups);
  p.nonportable = cl > 8;
  p.rows_per_split = rps;
  int ty = pow2_at_least(rps, kThreads / tx);
  if (ty * tx < 32) ty = 32 / tx;
  if (ty < p.vec) ty = p.vec;
  p.ty = ty;
  if (groups > 1) {
    p.tickets_offset = align16((long long)B * groups * C * 8);
    p.workspace_bytes = p.tickets_offset + align16((long long)B * p.chunks * 4);
  }
  *out = p;
  return 0;
}

// The backward's plan: one pass where the slabs of g and x fit on chip (as
// the forward's path 1), else two passes over the forward's two-pass chunks
// with the backward's own split target.
// `aligned`: g, x and dx start on 16-byte boundaries.
inline int make_bwd_plan(int is_bf16, int B, long long R, int C, int aligned,
                         int want_dn, SgtBwdPlan* out) {
  if (!valid_call(B, R, C)) return -1;
  SgtBwdPlan p = {};
  const int elem = is_bf16 ? 2 : 4;
  int max_tx = 1;
  lanes(is_bf16, C, aligned, &p.vec, &max_tx);
  OnePass f;
  if (fit_one_pass(p.vec, elem, 2, B, R, C, max_tx, &f)) {
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
    p.launches = 2;
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

// The rows a thread takes at once in K3-apply's form (1 cluster, 2 stream
// in registers, 3 stream through the ring).
inline int apply_unroll(int form, int is_bf16) {
  if (form == 1) return is_bf16 ? kApplyClusterUnrollBf16 : kApplyClusterUnroll;
  if (form == 3) return kApplyRingUnroll;
  return is_bf16 ? kApplyStreamUnrollBf16 : kApplyStreamUnroll;
}

// The lanes of a form-2 K3-apply block that takes whole rows of C channels
// in vectors of vec (a power of two, at most a warp, rows of at most
// kApplyWholeRowBytes in bf16, kApplyWholeRowBytesF32 in f32), or 0 where
// it takes 128-byte chunks.
inline int apply_whole_lanes(int elem, int C, int vec) {
  const int most = elem == 2 ? kApplyWholeRowBytes : kApplyWholeRowBytesF32;
  if (C % vec != 0 || (long long)C * elem > most) return 0;
  const int lanes = C / vec;
  return (lanes & (lanes - 1)) == 0 && lanes <= 32 ? lanes : 0;
}

// The dynamic shared memory of `ring` stages of a step's rows (ty *
// unroll) of g, of x and of noise; and the ring a form-2 block takes:
// kApplyRingStages(Bf16) stages of kApplyRingUnroll rows a thread, as many
// as fit beside kApplyStaticSmem, where it takes whole rows of 16-byte
// vectors and R is a multiple of 8 (each stage's noise then whole 16-byte
// vectors), else 0.
inline long long apply_ring_smem(int ring, int ty, int unroll, int C,
                                 int elem) {
  const long long rows = (long long)ty * unroll;
  return ring * (2 * rows * C * elem + align16(rows * elem));
}
inline int apply_ring(int elem, long long R, int C, int vec) {
  const int whole = apply_whole_lanes(elem, C, vec);
  if (vec == 1 || !whole || R % 8 != 0) return 0;
  const int unroll = apply_unroll(3, elem == 2);
  int ring = elem == 2 ? kApplyRingStagesBf16 : kApplyRingStages;
  while (ring > 0 && apply_ring_smem(ring, kThreads / whole, unroll, C,
                                     elem) > kMaxSmem - kApplyStaticSmem)
    --ring;
  return ring;
}

// The threads along rows of a block of tx lanes whose split has rps rows,
// `unroll` a thread at once: enough for one step where that is under a
// block of kThreads, at least a warp and vec row groups (the last block's
// merges give each channel ty / vec threads).
inline int apply_ty(int tx, int vec, long long rps, int unroll) {
  int ty = pow2_at_least(cdiv(rps, unroll), kThreads / tx);
  if (ty * tx < 32) ty = 32 / tx;
  if (ty < vec) ty = vec;
  return ty;
}

// K3-apply's plan (SgtApplyPlan above) for this rank's R rows of a split
// plane; `wave` is the stream form's resident blocks on the card (its
// occupancy times the SMs: sgt_epilogue_bwd_apply_wave).  Form 1 where g,
// x and dx hold at most kApplyClusterBytes and a cluster of at most
// kMaxApplyCluster blocks (a power of two) covers a chunk's B x R rows in
// at most kApplyClusterSteps load steps a thread:
// the chunk is narrowed from 128-byte rows down to 32-byte ones while the
// grid is short of the aim (a block per kApplyBlockBytes of g, x and dx,
// kMinBlocks to kMaxPartialBlocks), then each b's rows split into the
// fewest runs of at least kApplyMinSplitRows rows that reach it.  Else
// form 2.
inline int make_bwd_apply_plan(int is_bf16, int B, long long R, int C,
                               int aligned, int want_dn, long long wave,
                               SgtApplyPlan* out) {
  if (!valid_call(B, R, C) || wave < 1) return -1;
  SgtApplyPlan p = {};
  const int elem = is_bf16 ? 2 : 4;
  int max_tx = 1;
  lanes(is_bf16, C, aligned, &p.vec, &max_tx);
  auto chunks_at = [&](int t) { return cdiv(C, (long long)t * p.vec); };
  auto narrow = [&](int t) {
    return t > 1 && (t / 2) * p.vec * elem >= kMinRowBytes;
  };
  long long target = cdiv((long long)B * R * C * elem * 3, kApplyBlockBytes);
  if (target < kMinBlocks) target = kMinBlocks;
  if (target > kMaxPartialBlocks) target = kMaxPartialBlocks;
  // form 1
  int tx = max_tx;
  while (narrow(tx) && (long long)B * chunks_at(tx) < target) tx /= 2;
  long long s = 1;
  while (s < cdiv(target, (long long)B * chunks_at(tx)) &&
         (long long)B * s * 2 <= kMaxApplyCluster &&
         cdiv(R, s * 2) >= kApplyMinSplitRows)
    s *= 2;
  const long long cl = (long long)B * s;
  int unroll = apply_unroll(1, is_bf16);
  long long rps = cdiv(R, s);
  int ty = apply_ty(tx, p.vec, rps, unroll);
  if ((cl & (cl - 1)) == 0 && cl <= kMaxApplyCluster &&
      (long long)B * R * C * elem * 3 <= kApplyClusterBytes &&
      cdiv(rps, (long long)ty * unroll) <= kApplyClusterSteps) {
    p.form = 1;
    p.cluster = (int)cl;
  } else {
    p.form = 2;
    p.cluster = 1;
    const int whole = apply_whole_lanes(elem, C, p.vec);
    tx = whole ? whole : max_tx;
    ty = kThreads / tx;
    p.ring = apply_ring(elem, R, C, p.vec);
    p.ahead = !p.ring && kApplyStreamAhead;
    unroll = apply_unroll(p.ring ? 3 : 2, is_bf16);
    p.smem_bytes = apply_ring_smem(p.ring, ty, unroll, C, elem);
    s = cdiv(kApplyWaves * wave, (long long)B * chunks_at(tx));
    const long long most = cdiv(R, (long long)ty * kApplyStreamRows);
    if (s > most) s = most;
    if (s < 1) s = 1;
    rps = cdiv(R, s);
    if (p.ring) {  // whole steps a split
      const long long step = (long long)ty * unroll;
      rps = cdiv(rps, step) * step;
      s = cdiv(R, rps);
    }
  }
  while ((s - 1) * rps >= R) {  // no split without rows
    --s;
    rps = cdiv(R, s);
  }
  if (p.form == 1) {
    p.cluster = (int)(B * s);
    ty = apply_ty(tx, p.vec, rps, unroll);
  }
  p.tx = tx;
  p.ty = ty;
  p.chunk_c = tx * p.vec;
  p.chunks = (int)chunks_at(tx);
  p.splits = (int)s;
  p.nonportable = p.cluster > 8;
  p.unroll = unroll;
  p.reverse = kApplyReverse;
  p.rows_per_split = rps;
  p.dn_partials = want_dn && p.chunks > 1;
  long long off = 0;
  if (p.form == 2) off = align16((long long)B * s * C * 4);
  p.dn_offset = off;
  if (p.dn_partials) off += align16((long long)p.chunks * B * R * 4);
  p.tickets_offset = off;
  const long long tickets =
      (p.form == 2 ? p.chunks : 0) + (p.dn_partials ? (long long)B * s : 0);
  if (tickets) off += align16(tickets * 4);
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

extern "C" int sgt_epilogue_partial_plan(int is_bf16, int B, long long R,
                                         int C, int aligned,
                                         SgtPartialPlan* plan) {
  return sgt::make_partial_plan(
      is_bf16, B, R, C, aligned, 1,
      is_bf16 ? sgt::kPartialClusterUnrollBf16 : sgt::kPartialUnroll,
      sgt::kPartialUnroll,
      is_bf16 ? sgt::kStreamBlocksBf16 : sgt::kStreamBlocks, plan);
}

extern "C" int sgt_epilogue_bwd_partial_plan(int is_bf16, int B, long long R,
                                             int C, int aligned,
                                             SgtPartialPlan* plan) {
  return sgt::make_partial_plan(is_bf16, B, R, C, aligned, 2,
                                sgt::kPartialUnroll, sgt::kPartialUnroll,
                                sgt::kBwdStreamBlocks, plan);
}

extern "C" int sgt_epilogue_bwd_plan(int is_bf16, int B, long long R, int C,
                                     int aligned, int want_dn,
                                     SgtBwdPlan* plan) {
  return sgt::make_bwd_plan(is_bf16, B, R, C, aligned, want_dn, plan);
}

extern "C" int sgt_epilogue_bwd_apply_plan(int is_bf16, int B, long long R,
                                           int C, int aligned, int want_dn,
                                           long long wave,
                                           SgtApplyPlan* plan) {
  return sgt::make_bwd_apply_plan(is_bf16, B, R, C, aligned, want_dn, wave,
                                  plan);
}

#endif  // SGT_EPILOGUE_PLAN_H_
