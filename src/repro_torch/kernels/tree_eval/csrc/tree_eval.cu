// Tree-evaluation kernels K1–K8 for Hopper (sm_90a), with a plain C interface
// that ``repro_torch/kernels/tree_eval/kernel.py`` loads through ctypes.
//
// Each kernel evaluates float32 records (M, A), row-major and contiguous,
// against breadth-first branchless tree tables over N nodes: attr_idx,
// threshold, child, class_val (and, for the one-hot form, attr_select
// (A, N)).  K1/K2 write int32 classes (M,); the forest kernels take the same
// tables stacked (T, N) / (T, A, N) and write per-tree classes (T, M) (K3/K4)
// or the forest's int32 vote counts (M, C) (K5/K6).  K7/K8 are K3 gather and
// K4 on the quantized layout: the same (T, N) tables at their stored widths,
// int8/int16/int32 indices and bf16/f16/f32 thresholds.
//
// Which TPU kernel each replaces (src/repro/kernels/tree_eval/kernel.py):
//   K1 speculative_kernel              <- speculative_pallas / _speculative_compute
//   K2 data_parallel_kernel            <- data_parallel_pallas / _data_parallel_compute
//   K3 fused_speculative_kernel        <- fused_speculative_pallas
//   K4 fused_data_parallel_kernel      <- fused_data_parallel_pallas
//   K5 fused_votes_speculative_kernel  <- fused_votes_speculative_pallas (+ _accumulate_votes)
//   K6 fused_votes_data_parallel_kernel <- fused_votes_data_parallel_pallas
//   K7 fused_speculative_q_kernel<TT>   <- fused_speculative_q_pallas (_fused_q_pallas,
//                                          _quant_speculative_compute)
//   K8 fused_data_parallel_q_kernel<TT> <- fused_data_parallel_q_pallas
//
// Bound on this card.  The function's bytes are few: at the paper shape
// (M = 65,536, A = 19) K1/K2 read 4.98 MB of records and write 0.26 MB of
// classes, about 1.6 us at 3.35 TB/s; K3/K4 at T = 16 also write 4.19 MB of
// per-tree classes, about 2.7 us; K5/K6 write 65,536·C·4 B of votes instead,
// about 2.0 us at C = 7.  The tree tables (a few KB) are negligible.  The
// data-parallel kernels come within 3–4x of that (launch, the first load of
// the records and max_depth dependent rounds); the speculative ones cannot, since
// Procedures 4/5 evaluate all N nodes of a tree for every record and then
// run ``jumps`` pointer-jump rounds over them: N·(1 + jumps) shared-memory
// accesses or warp shuffles per (record, tree), where a descent makes d_µ
// compares.  What bounds K1/K3/K5/K7 is the issue of those accesses and
// shuffles (they share one pipe, 32 lanes a clock per SM), not bytes.
//
// The speculative tile (speculative_block).  A warp owns whole records: each
// CTA takes an equal run of M / grid records, tile by tile, and each of its
// warps evaluates its own rows of the tile against every tree.  Lane l holds
// the nodes n = l + 32·s (slot s < k = ceil(N/32)); lanes with n ≥ N are
// inert.  A record's path is read and written only by the warp that owns it,
// so the tree loop has no CTA barrier: one follows each staging of records
// (per tile) and of tables (per chunk of trees), and nothing else.
//   - Register path, k ≤ 2 (N ≤ 64; the paper's forest has N 51): per tree a
//     lane keeps its k nodes' attr, threshold and child (or its k attr_select
//     columns) in registers, and per record its k path entries; a jump
//     fetches path[src] with k __shfl_sync, one per slot, kept where
//     src >> 5 names the slot.  No division by N anywhere.  A warp takes two
//     records a step, so that its shuffle chains interleave.
//   - Shared path, k > 2 (the paper's tree has N 75): each warp keeps two
//     records' paths, double-buffered, in 4·N ints of shared memory, rounds
//     separated by __syncwarp(); the two records share each table load.
//   The cut-off: a full round costs k·k shuffles on the register path and
//   2·k shared-memory accesses a record on the shared path; equal at k = 2,
//   where the registers also spare the __syncwarp()s.  The last round is
//   for node 0 alone, path[path[0]]: exact, since nothing else is read
//   afterwards, and 1 + k shuffles (or two loads) instead of a round.
// Tables are staged once per CTA, not once per tree, by one loop that issues
// all their loads together: the whole forest when it fits beside the tile in
// 48 KB (13 KB for the paper's 16 trees in the gather form), else in equal
// chunks of trees.  Outputs leave without a barrier: a warp gathers its
// records' final nodes of a tree into one register a lane (32 records at a
// time), looks their classes up, and either stores them with one coalesced
// store (ClassStore) or adds them to its own rows of a (rows, C) vote tile in
// shared memory, which it writes once, coalesced, after the last tree
// (VoteTally; a class outside [0, C) casts no vote).  The grid is as many
// CTAs as the card holds at once with this footprint (SMs × occupancy) and
// at most one per ``warps`` records, so the records fill the card in one
// whole wave instead of leaving a tail of CTAs.
// The one-hot form keeps the records @ attr_select product (exact f32 FMAs
// on the CUDA cores, never TF32, on sanitized records: one nonzero term per
// column, so the sum is exact whatever its order).  On the register path a
// lane holds its k attr_select columns (A·k ≤ 40 floats) for the whole tree
// and reads each record value once, four at a time, as a shared-memory
// broadcast of the 16-byte-aligned record row, into four partial sums; with
// more attributes it takes the shared path, which reads the columns from
// shared memory.
//
// The data-parallel kernels K2/K4/K6/K8 (data_parallel_block): a descent is
// max_depth dependent rounds idx = child + (x[attr] > threshold), each two
// shared-memory loads, and what bounds these kernels is the latency of
// those chains and how many are in flight.  A CTA has ceil(block_m / 2)
// threads (kDpThreads, 512, at most: the tile has at most 1,024 rows) and
// takes an equal run of the M records, starting at a multiple of 4, tile by
// tile (block_m rows); thread i owns rows i, i + threads, ... of a tile for
// every tree, so the tree loop has no CTA barrier.  With the grid below, a
// thread of K4/K6/K8 owns one row while the card is not full (at M 65,536
// and the default 256-row tile: 512 CTAs of 128 threads, each tile's second
// half reserved but empty) and its second only where a CTA's run is longer
// than its threads; K2's CTAs take two rows a thread.  A thread walks several
// of its (row, tree) descents at once, in straight-line rounds that issue
// all their node loads, then all their record loads, so that the chains'
// latencies overlap: K2 two rows, K4/K8 four trees of a row (kDpChains), K6
// three (kDpVoteChains); the last nk·T mod R descents take one step of
// their own, so no slot is idle.  A node is 8 bytes, {attr | child << 16,
// threshold bits} (both indices fit in 16 bits, since a record row and a
// tree's tables must fit in a CTA's shared memory), so a round is one
// 8-byte load (a half-warp a wavefront; lanes on one node share a
// broadcast, and distinct nodes conflict only in one bank pair) and one
// 4-byte record load; the record rows have an odd stride (A | 1), so lanes
// on the same attribute never conflict.  The class table is read once a
// descent.  The record tile is copied with cp.async, 16 bytes at a time,
// when A is odd and the contiguous rows·A span is 16-byte aligned (else
// one float at a time), while the forest's tables are staged: once per
// CTA, by one loop that loads kStageBatch nodes a thread before it stores
// them, the whole forest when it fits beside the tile in 48 KB (9.8 KB for
// the paper's 16 trees), else in equal chunks of trees (kernel.py's
// ``table_chunk``), one barrier a chunk.  K6's vote tile (rows, C) is zeroed
// and added to by the thread that owns each row, and written once a tile,
// coalesced, as (M, C), so no atomics reach device memory.  The grid is as
// many CTAs as the card holds at once with this footprint and at most one per
// ``threads`` records (K2: per 2·threads, so that both its rows are live), so
// a cascade stage of a few thousand records still spreads over the SMs.

// The quantized kernels K7/K8.  Their tables are a few KB (4,192 B for the
// paper's 16-tree forest in bf16), so narrowing them cannot move the bound.
// They are K3 gather's and K4's block functions with another table-loading
// policy (``QuantTables``): the tables are read from device memory at their
// stored width, upcast in registers (sign extension; __half2float,
// __bfloat162float, exact) and written to shared memory at full width (or
// packed into K4's 8-byte nodes), so the inner loops are K3's and K4's own.
// The threshold type is a template parameter; the index widths are runtime
// codes, read by a switch that is uniform across the CTA and runs only while
// tables are staged.

// Shared memory and the tile.  The caller passes each launch's dynamic
// shared-memory bytes (``smem``), its trees a table chunk and its threads
// (speculative: warps) a CTA, and for the speculative kernels register slots
// a lane: kernel.py's ``smem_bytes`` is the one formula for the footprint of
// the layout that speculative_block and data_parallel_block carve out below,
// and the wrapper checks it against the card's limit before launching.
// Nothing here computes a size of its own.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSpecThreads = 256;          // most threads of a speculative CTA (8 warps)
constexpr int kDpThreads = 512;            // most threads of a data-parallel CTA (tile ≤ 1,024 rows)
constexpr int kDpChains = 4;               // descents a thread of K4/K8 walks at once
constexpr int kDpVoteChains = 3;           // the same for K6 (at 4 it spills; measured faster at 3)
constexpr int kStageBatch = 4;             // nodes a thread loads at once while staging tables
constexpr int kDefaultSmem = 48 * 1024;    // above this a launch must opt in
constexpr int kSelectRegisters = 40;       // attr_select floats a lane holds (one-hot register path)
constexpr unsigned kFullWarp = 0xffffffffu;

// Output policies of the block functions below.  Both call ``bind`` with the
// end of their shared-memory layout (where a policy may keep a tile) and
// ``put`` from the thread or lane that holds row r's class of tree t.
// data_parallel_block calls ``row_begin`` from the thread that owns row r
// before its first tree, and, where ``kTile`` says the policy keeps a tile,
// ``tile_finish`` from every thread after a barrier that follows the last
// tree.  speculative_block calls ``warp_begin``/``warp_finish`` from each
// warp around its rows [rb, rb + nr) of a tile.

// K1–K4, K7/K8: the per-tree class of each record, at out[t·M + m0 + r].
struct ClassStore {
  static constexpr bool kTile = false;
  int* out;
  int M;
  __device__ void put(int t, long long m0, int r, int cls) {
    out[(long long)t * M + m0 + r] = cls;
  }
  __device__ void bind(int*) {}
  __device__ void row_begin(int) {}
  __device__ void tile_finish(long long, int) {}
  __device__ void warp_begin(int, int) {}
  __device__ void warp_finish(long long, int, int) {}
};

// K5/K6: one vote per tree into a (rows, C) tile, written once as (M, C).
// A class outside [0, C) casts no vote.
struct VoteTally {
  static constexpr bool kTile = true;
  int* out;
  int C;
  int* tile;
  __device__ void put(int, long long, int r, int cls) {
    if (cls >= 0 && cls < C) tile[r * C + cls] += 1;
  }
  __device__ void bind(int* smem_end) { tile = smem_end; }
  __device__ void row_begin(int r) {
    for (int c = 0; c < C; ++c) tile[r * C + c] = 0;
  }
  __device__ void tile_finish(long long m0, int rows) {
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) out[m0 * C + i] = tile[i];
  }
  __device__ void warp_begin(int rb, int nr) {
    for (int i = threadIdx.x & 31; i < nr * C; i += 32) tile[rb * C + i] = 0;
    __syncwarp();
  }
  __device__ void warp_finish(long long m0, int rb, int nr) {
    __syncwarp();
    for (int i = threadIdx.x & 31; i < nr * C; i += 32) out[(m0 + rb) * C + i] = tile[rb * C + i];
  }
};

// Table-loading policies of the block functions below: ``node`` reads node
// i of the stacked (T, N) tables, widened to int32 indices and an f32
// threshold.  The staging loops that use them follow the policies; the
// one-hot form also reads F32Tables' (T, A, N) attr_select.

// K1–K6: full-width tables, copied as they are.
struct F32Tables {
  const int* attr_idx;
  const float* attr_select;
  const float* threshold;
  const int* child;
  const int* class_val;
  __device__ void node(long long i, int& attr, float& thr, int& chd, int& cls) const {
    attr = attr_idx[i];
    thr = threshold[i];
    chd = child[i];
    cls = class_val[i];
  }
};

__device__ __forceinline__ float upcast(float x) { return x; }
__device__ __forceinline__ float upcast(__half x) { return __half2float(x); }
__device__ __forceinline__ float upcast(__nv_bfloat16 x) { return __bfloat162float(x); }

// Entry i of an index table stored ``bytes`` wide (1, 2 or 4), sign-extended.
__device__ __forceinline__ int load_index(const void* table, int bytes, long long i) {
  switch (bytes) {
    case 1: return static_cast<const signed char*>(table)[i];
    case 2: return static_cast<const short*>(table)[i];
    default: return static_cast<const int*>(table)[i];
  }
}

// K7/K8: the quantized layout, read at its stored widths and widened in
// registers on the way into shared memory.
template <typename TT>
struct QuantTables {
  using threshold_type = TT;
  const void* attr_idx;
  const TT* threshold;
  const void* child;
  const void* class_val;
  int attr_bytes;
  int child_bytes;
  int cls_bytes;
  __device__ void node(long long i, int& attr, float& thr, int& chd, int& cls) const {
    attr = load_index(attr_idx, attr_bytes, i);
    thr = upcast(threshold[i]);
    chd = load_index(child, child_bytes, i);
    cls = load_index(class_val, cls_bytes, i);
  }
};

// Trees [t0, t0 + tn) of ``tables`` into speculative_block's shared-memory
// tables, in one loop that issues all their loads together: int32
// attributes (gather form) or the f32 attr_select (one-hot form, which
// shares that space), f32 thresholds, int32 children and classes.  The
// caller synchronizes after.
template <bool ONEHOT, typename Tables>
__device__ void stage_trees(const Tables& tables, int t0, int tn, int A, int N, int* s_attr,
                            float* s_sel, float* s_thr, int* s_child, int* s_cls) {
  const long long base = (long long)t0 * N;
  const int nodes = tn * N;
  const int total = ONEHOT ? nodes * A : nodes;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    if constexpr (ONEHOT) s_sel[i] = tables.attr_select[base * A + i];
    if (i < nodes) {
      int attr;
      tables.node(base + i, attr, s_thr[i], s_child[i], s_cls[i]);
      if (!ONEHOT) s_attr[i] = attr;
    }
  }
}

// Trees [t0, t0 + tn) of ``tables`` into data_parallel_block's node table:
// node i is {attr | child << 16, threshold bits}, its class in s_cls[i].
// A thread loads kStageBatch nodes before it stores any, so that their
// loads are in flight together.  The caller synchronizes after.
template <typename Tables>
__device__ void stage_nodes(const Tables& tables, int t0, int tn, int N, uint2* s_node,
                            int* s_cls) {
  const long long base = (long long)t0 * N;
  const int n = tn * N;
  for (int i0 = threadIdx.x; i0 < n; i0 += kStageBatch * blockDim.x) {
    int attr[kStageBatch], chd[kStageBatch], cls[kStageBatch];
    float thr[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) tables.node(base + i, attr[u], thr[u], chd[u], cls[u]);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        s_node[i] = make_uint2((unsigned)attr[u] | ((unsigned)chd[u] << 16), __float_as_uint(thr[u]));
        s_cls[i] = cls[u];
      }
    }
  }
}

// path[src] of a path held K slots a lane (node n in slot n >> 5 of lane
// n & 31): one shuffle per slot, kept where src >> 5 names it.  Only
// shuffle results are selected, never p[s] by a runtime slot: the compiler
// folds a select between two elements of p into a runtime index, which
// moves p to local memory.
template <int K>
__device__ __forceinline__ int fetch_path(const int (&p)[K], int src) {
  int got = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int v = __shfl_sync(kFullWarp, p[s], src & 31);
    if ((src >> 5) == s) got = v;
  }
  return got;
}

// Pointer jumping on the register path for R records at once (independent
// chains of shuffles the warp can interleave): ``jumps`` - 1 full rounds of
// path[n] <- path[path[n]], then the last one for node 0 alone.  ``end[r]``
// is record r's final node, the same in every lane.
template <int R, int K>
__device__ __forceinline__ void jump_registers(int (&p)[R][K], int jumps, int (&end)[R]) {
  for (int j = 1; j < jumps; ++j) {
    int q[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int s = 0; s < K; ++s) q[r][s] = fetch_path<K>(p[r], p[r][s]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int s = 0; s < K; ++s) p[r][s] = q[r][s];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int root = __shfl_sync(kFullWarp, p[r][0], 0);  // path[0]
    end[r] = jumps > 0 ? fetch_path<K>(p[r], root) : root;
  }
}

// records @ attr_select for a lane's K nodes, from the record row ``x``
// (16-byte aligned, zero-padded) and the K columns held in ``sel``: four
// partial sums, so the FMAs do not wait on each other.  Exact on sanitized
// records whatever the order: one term of a column is nonzero, the padding
// and the rest add ±0.
template <int K, int AMAX>
__device__ __forceinline__ void select_values(const float* x, int A, const float (&sel)[K][AMAX],
                                              float (&v)[K]) {
  float part[K][4];
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int c = 0; c < 4; ++c) part[s][c] = 0.0f;
  }
#pragma unroll
  for (int a = 0; a < AMAX; a += 4) {
    if (a < A) {
      const float4 xv = *reinterpret_cast<const float4*>(x + a);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        part[s][0] = fmaf(xv.x, sel[s][a], part[s][0]);
        part[s][1] = fmaf(xv.y, sel[s][a + 1], part[s][1]);
        part[s][2] = fmaf(xv.z, sel[s][a + 2], part[s][2]);
        part[s][3] = fmaf(xv.w, sel[s][a + 3], part[s][3]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) v[s] = (part[s][0] + part[s][1]) + (part[s][2] + part[s][3]);
}

// The tile and the staged tables that a warp reads, and its rows of the tile.
struct SpecTile {
  const float* rec;    // (rows, A4) records, rows padded with zeros to A4
  const int* attr;     // (chunk, N), gather form
  const float* sel;    // (chunk, A, N), one-hot form
  const float* thr;    // (chunk, N)
  const int* child;    // (chunk, N)
  const int* cls;      // (chunk, N)
  int A, A4, N, jumps;
  long long m0;        // first record of the tile
  int rb, nr;          // this warp's rows [rb, rb + nr)
};

// One tree (tl of the staged chunk, t of the forest) on the register path.
template <bool ONEHOT, int K, typename Out>
__device__ __forceinline__ void tree_registers(const SpecTile& g, int tl, int t, Out& out) {
  constexpr int AMAX = ONEHOT ? kSelectRegisters / K : 4;
  static_assert(AMAX % 4 == 0, "attr_select registers are read four at a time");
  const int lane = threadIdx.x & 31;
  const int N = g.N;
  int attr[K];
  float thr[K];
  int child[K];
  float sel[K][AMAX];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int n = lane + 32 * s;
    const bool live = n < N;  // lanes past the last node are inert
    const int i = tl * N + n;
    attr[s] = (!ONEHOT && live) ? g.attr[i] : 0;
    thr[s] = live ? g.thr[i] : 0.0f;
    child[s] = live ? g.child[i] : 0;
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      sel[s][a] = (ONEHOT && live && a < g.A) ? g.sel[(tl * g.A + a) * N + n] : 0.0f;
    }
  }
  constexpr int R = 2;  // records a step: independent work for the warp
  for (int r0 = 0; r0 < g.nr; r0 += 32) {
    const int rn = min(32, g.nr - r0);
    int end = 0;  // lane j: final node of record r0 + j
    for (int j = 0; j < rn; j += R) {
      int p[R][K];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // past the last record, a step repeats it; no lane keeps that result
        const float* x = g.rec + (g.rb + r0 + min(j + r, rn - 1)) * g.A4;
        if (ONEHOT) {
          float v[K];
          select_values<K, AMAX>(x, g.A, sel, v);
#pragma unroll
          for (int s = 0; s < K; ++s) p[r][s] = child[s] + (v[s] > thr[s] ? 1 : 0);
        } else {
#pragma unroll
          for (int s = 0; s < K; ++s) p[r][s] = child[s] + (x[attr[s]] > thr[s] ? 1 : 0);
        }
      }
      int e[R];
      jump_registers<R, K>(p, g.jumps, e);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane == j + r) end = e[r];
      }
    }
    if (lane < rn) out.put(t, g.m0, g.rb + r0 + lane, g.cls[tl * N + end]);
  }
}

// One tree on the shared path, two records a step: ``path`` is this warp's
// 4·N ints, two double-buffered N-int paths.  The records share each load
// of the tables (and of attr_select), and their rounds share the
// __syncwarp()s.
template <bool ONEHOT, typename Out>
__device__ __forceinline__ void tree_shared(const SpecTile& g, int tl, int t, Out& out, int* path) {
  constexpr int R = 2;
  const int lane = threadIdx.x & 31;
  const int N = g.N;
  const int A = g.A;
  const int* attr = g.attr + tl * N;
  const float* sel = g.sel + tl * A * N;
  const float* thr = g.thr + tl * N;
  const int* child = g.child + tl * N;
  for (int r0 = 0; r0 < g.nr; r0 += 32) {
    const int rn = min(32, g.nr - r0);
    int end = 0;
    for (int j = 0; j < rn; j += R) {
      const float* x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = g.rec + (g.rb + r0 + min(j + r, rn - 1)) * g.A4;
      int* cur = path;          // record r's path at cur[r·N + n]
      int* nxt = path + R * N;
      for (int n = lane; n < N; n += 32) {
        float v[R];
        if (ONEHOT) {  // four partial sums, exact as in select_values
          float part[R][4];
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) part[r][c] = 0.0f;
          }
          for (int a = 0; a < A; a += 4) {
            float col[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) col[c] = a + c < A ? sel[(a + c) * N + n] : 0.0f;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 xv = *reinterpret_cast<const float4*>(x[r] + a);
              part[r][0] = fmaf(xv.x, col[0], part[r][0]);
              part[r][1] = fmaf(xv.y, col[1], part[r][1]);
              part[r][2] = fmaf(xv.z, col[2], part[r][2]);
              part[r][3] = fmaf(xv.w, col[3], part[r][3]);
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) v[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
        } else {
          const int at = attr[n];
#pragma unroll
          for (int r = 0; r < R; ++r) v[r] = x[r][at];
        }
        const float th = thr[n];
        const int ch = child[n];
#pragma unroll
        for (int r = 0; r < R; ++r) cur[r * N + n] = ch + (v[r] > th ? 1 : 0);
      }
      __syncwarp();
      for (int k = 1; k < g.jumps; ++k) {
        for (int n = lane; n < N; n += 32) {
#pragma unroll
          for (int r = 0; r < R; ++r) nxt[r * N + n] = cur[r * N + cur[r * N + n]];
        }
        __syncwarp();
        int* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
      int e[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int root = cur[r * N];
        e[r] = g.jumps > 0 ? cur[r * N + root] : root;
      }
      __syncwarp();  // the next step overwrites the paths
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane == j + r) end = e[r];
      }
    }
    if (lane < rn) out.put(t, g.m0, g.rb + r0 + lane, g.cls[tl * N + end]);
  }
}

// One CTA: an equal run of the M records, tile by tile (``bm`` rows at
// most), against T trees staged ``chunk`` at a time.  K is the register
// path's slots a lane (1 or 2), or 0 for the shared path.
template <bool ONEHOT, int K, typename Tables, typename Out>
__device__ void speculative_block(const float* __restrict__ records, Tables tables,
                                  Out out, int M, int A, int N,
                                  int T, int bm, int chunk, int jumps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A4 = (A + 3) & ~3;  // record rows padded to 16 bytes
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int cn = chunk * N;
  float* s_rec = reinterpret_cast<float*>(smem);
  float* s_thr = s_rec + bm * A4;
  int* s_child = reinterpret_cast<int*>(s_thr + cn);
  int* s_cls = s_child + cn;
  int* s_attr = s_cls + cn;                             // gather form
  float* s_sel = reinterpret_cast<float*>(s_cls + cn);  // one-hot form
  int* s_path = s_cls + cn + (ONEHOT ? A * cn : cn);    // shared path: 4·N per warp
  out.bind(s_path + (K == 0 ? 4 * N * warps : 0));
  s_path += 4 * N * w;

  SpecTile g{s_rec, s_attr, s_sel, s_thr, s_child, s_cls, A, A4, N, jumps, 0, 0, 0};
  const long long lo = (long long)M * blockIdx.x / gridDim.x;
  const long long hi = (long long)M * (blockIdx.x + 1) / gridDim.x;
  bool staged = false;
  for (long long m0 = lo; m0 < hi; m0 += bm) {
    const int rows = (int)min((long long)bm, hi - m0);
    if (m0 != lo) __syncthreads();  // the last tile is no longer read
    for (int i = threadIdx.x; i < rows * A4; i += blockDim.x) {
      const int r = i / A4;
      const int a = i - r * A4;
      s_rec[i] = a < A ? records[(m0 + r) * A + a] : 0.0f;
    }
    const int per = (rows + warps - 1) / warps;
    g.m0 = m0;
    g.rb = w * per;
    g.nr = max(0, min(per, rows - g.rb));
    out.warp_begin(g.rb, g.nr);
    for (int t0 = 0; t0 < T; t0 += chunk) {
      const int tn = min(chunk, T - t0);
      if (!staged || chunk < T) {  // the whole forest stays staged across tiles
        if (t0 > 0) __syncthreads();  // the last chunk is no longer read
        stage_trees<ONEHOT>(tables, t0, tn, A, N, s_attr, s_sel, s_thr, s_child, s_cls);
        staged = true;
      }
      __syncthreads();
      for (int tl = 0; tl < tn; ++tl) {
        if constexpr (K == 0) {
          tree_shared<ONEHOT>(g, tl, t0 + tl, out, s_path);
        } else {
          tree_registers<ONEHOT, K>(g, tl, t0 + tl, out);
        }
      }
    }
    out.warp_finish(m0, g.rb, g.nr);
  }
}

// 16 bytes from device memory to shared memory, asynchronously (cp.async):
// a thread issues all its copies before it waits for any.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Waits for this thread's copy16_async copies; a barrier makes them visible.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [m0, m0 + rows) of the (M, A) records into the tile ``s_rec``, rows
// ``As`` floats apart.  When the tile keeps the rows as they lie (A odd) and
// the contiguous span is 16-byte aligned, the span goes by copy16_async (the
// caller must copy_async_wait() before its barrier); the rest, and any other
// tile, one float at a time.
__device__ void stage_records(float* s_rec, const float* __restrict__ records, long long m0,
                              int rows, int A, int As) {
  const float* src = records + m0 * A;
  const int n = rows * A;
  const int pad = As - A;
  int done = 0;
  if (pad == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    done = n & ~3;
    for (int q = threadIdx.x; q < (n >> 2); q += blockDim.x) copy16_async(s_rec + 4 * q, src + 4 * q);
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x) s_rec[e + (e / A) * pad] = src[e];
}

// R of one thread's descents at once, from the cursor (row tid + k·threads,
// tree tl of the staged chunk of ``tn``), which it advances: R independent
// chains of max_depth rounds.  The rounds are straight-line code, all R node
// loads, then all R record loads, so the chains' latencies overlap (a branch
// around a chain would make the warp wait on each chain in turn).
template <int R, typename Out>
__device__ __forceinline__ void descend_step(const float* s_rec, int As, const uint2* s_node,
                                             const int* s_cls, int N, int tn, int t0,
                                             long long m0, int max_depth, int& k, int& tl,
                                             Out& out) {
  const float* x[R];
  const uint2* node[R];
  int row[R], tree[R], idx[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    row[s] = threadIdx.x + k * blockDim.x;
    tree[s] = tl;
    x[s] = s_rec + row[s] * As;
    node[s] = s_node + tl * N;
    idx[s] = 0;
    if (++tl == tn) {
      tl = 0;
      ++k;
    }
  }
  for (int d = 0; d < max_depth; ++d) {
    uint2 nd[R];
    float v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) nd[s] = node[s][idx[s]];
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = x[s][nd[s].x & 0xffffu];
#pragma unroll
    for (int s = 0; s < R; ++s) idx[s] = (int)(nd[s].x >> 16) + (v[s] > __uint_as_float(nd[s].y) ? 1 : 0);
  }
#pragma unroll
  for (int s = 0; s < R; ++s) out.put(t0 + tree[s], m0, row[s], s_cls[tree[s] * N + idx[s]]);
}

// One thread's descents through the staged chunk of ``tn`` trees: its pairs
// (row tid + k·threads, tree tl) for k < nk, in the order k·tn + tl, R at a
// time, and the last (nk·tn mod R, at most 3) in one step of their own.
template <int R, typename Out>
__device__ __forceinline__ void descend(const float* s_rec, int As, const uint2* s_node,
                                        const int* s_cls, int N, int tn, int t0, long long m0,
                                        int nk, int max_depth, Out& out) {
  static_assert(R >= 1 && R <= 4, "the remainder takes at most three chains");
  const int items = nk * tn;
  int k = 0, tl = 0, j = 0;
  for (; j + R <= items; j += R) {
    descend_step<R>(s_rec, As, s_node, s_cls, N, tn, t0, m0, max_depth, k, tl, out);
  }
  switch (items - j) {
    case 3:
      if constexpr (R > 3) descend_step<3>(s_rec, As, s_node, s_cls, N, tn, t0, m0, max_depth, k, tl, out);
      break;
    case 2:
      if constexpr (R > 2) descend_step<2>(s_rec, As, s_node, s_cls, N, tn, t0, m0, max_depth, k, tl, out);
      break;
    case 1:
      if constexpr (R > 1) descend_step<1>(s_rec, As, s_node, s_cls, N, tn, t0, m0, max_depth, k, tl, out);
      break;
  }
}

// Procedure 3.  One CTA: an equal run of the M records (starting at a
// multiple of 4), tile by tile (``bm`` rows at most), against T trees
// staged ``chunk`` at a time; R chains a thread.
template <int R, typename Tables, typename Out>
__device__ void data_parallel_block(const float* __restrict__ records, Tables tables,
                                    Out out, int M, int A, int N, int T, int bm, int chunk,
                                    int max_depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int As = A | 1;  // odd row stride: lanes on one attribute hit distinct banks
  const int cn = chunk * N;
  float* s_rec = reinterpret_cast<float*>(smem);
  uint2* s_node = reinterpret_cast<uint2*>(s_rec + ((bm * As + 3) & ~3));
  int* s_cls = reinterpret_cast<int*>(s_node + cn);
  out.bind(s_cls + cn);

  const long long quads = ((long long)M + 3) / 4;
  const long long lo = min((long long)M, 4 * (quads * blockIdx.x / gridDim.x));
  const long long hi = min((long long)M, 4 * (quads * (blockIdx.x + 1) / gridDim.x));
  bool staged = false;
  for (long long m0 = lo; m0 < hi; m0 += bm) {
    const int rows = (int)min((long long)bm, hi - m0);
    if (m0 != lo) __syncthreads();  // the last tile is no longer read
    stage_records(s_rec, records, m0, rows, A, As);
    const int nk = (int)threadIdx.x < rows ? (rows - 1 - (int)threadIdx.x) / (int)blockDim.x + 1 : 0;
    for (int k = 0; k < nk; ++k) out.row_begin(threadIdx.x + k * blockDim.x);
    for (int t0 = 0; t0 < T; t0 += chunk) {
      const int tn = min(chunk, T - t0);
      if (!staged || chunk < T) {  // the whole forest stays staged across tiles
        if (t0 > 0) __syncthreads();  // the last chunk is no longer read
        stage_nodes(tables, t0, tn, N, s_node, s_cls);
        staged = true;
      }
      copy_async_wait();  // this tile's records, copied while the tables were staged
      __syncthreads();
      descend<R>(s_rec, As, s_node, s_cls, N, tn, t0, m0, nk, max_depth, out);
    }
    if (Out::kTile) {
      __syncthreads();
      out.tile_finish(m0, rows);
    }
  }
}

// CTAs a SM that each speculative instantiation is compiled for: ptxas then
// holds its registers to 65,536 / (256·n) a thread.  Chosen on the H100: the
// gather forms run best with the registers they ask for (the register path
// takes 64, four CTAs a SM), the one-hot register path at three CTAs (80
// registers, a few bytes spilled, against two CTAs without), the one-hot
// shared path at four.
constexpr int spec_min_ctas(bool onehot, int k) { return !onehot ? 1 : k > 0 ? 3 : 4; }

// K1: one tree.
template <bool ONEHOT, int K>
__global__ void __launch_bounds__(kSpecThreads, spec_min_ctas(ONEHOT, K))
speculative_kernel(const float* records, const int* attr_idx, const float* attr_select,
                   const float* threshold, const int* child, const int* class_val,
                   int* out, int M, int A, int N, int bm, int jumps) {
  speculative_block<ONEHOT, K>(
      records, F32Tables{attr_idx, attr_select, threshold, child, class_val},
      ClassStore{out, M}, M, A, N, 1, bm, 1, jumps);
}

// K3: the whole forest in one launch, the record tile resident across trees.
template <bool ONEHOT, int K>
__global__ void __launch_bounds__(kSpecThreads, spec_min_ctas(ONEHOT, K))
fused_speculative_kernel(const float* records, const int* attr_idx,
                         const float* attr_select, const float* threshold,
                         const int* child, const int* class_val, int* out,
                         int M, int A, int N, int T, int bm, int chunk, int jumps) {
  speculative_block<ONEHOT, K>(
      records, F32Tables{attr_idx, attr_select, threshold, child, class_val},
      ClassStore{out, M}, M, A, N, T, bm, chunk, jumps);
}

// K5: K3 with the forest's votes tallied in shared memory, (M, C).
template <bool ONEHOT, int K>
__global__ void __launch_bounds__(kSpecThreads, spec_min_ctas(ONEHOT, K))
fused_votes_speculative_kernel(const float* records, const int* attr_idx,
                               const float* attr_select, const float* threshold,
                               const int* child, const int* class_val, int* out,
                               int M, int A, int N, int T, int C, int bm, int chunk,
                               int jumps) {
  speculative_block<ONEHOT, K>(
      records, F32Tables{attr_idx, attr_select, threshold, child, class_val},
      VoteTally{out, C, nullptr}, M, A, N, T, bm, chunk, jumps);
}

// K2: one tree, two rows a thread.
__global__ void __launch_bounds__(kDpThreads)
data_parallel_kernel(const float* records, const int* attr_idx, const float* threshold,
                     const int* child, const int* class_val, int* out, int M, int A, int N,
                     int bm, int max_depth) {
  data_parallel_block<2>(records, F32Tables{attr_idx, nullptr, threshold, child, class_val},
                         ClassStore{out, M}, M, A, N, 1, bm, 1, max_depth);
}

// K4: the whole forest in one launch.
__global__ void __launch_bounds__(kDpThreads)
fused_data_parallel_kernel(const float* records, const int* attr_idx, const float* threshold,
                           const int* child, const int* class_val, int* out, int M, int A,
                           int N, int T, int bm, int chunk, int max_depth) {
  data_parallel_block<kDpChains>(records, F32Tables{attr_idx, nullptr, threshold, child, class_val},
                                 ClassStore{out, M}, M, A, N, T, bm, chunk, max_depth);
}

// K6: K4 with the forest's votes tallied in shared memory, (M, C).
__global__ void __launch_bounds__(kDpThreads)
fused_votes_data_parallel_kernel(const float* records, const int* attr_idx,
                                 const float* threshold, const int* child,
                                 const int* class_val, int* out, int M, int A, int N, int T,
                                 int C, int bm, int chunk, int max_depth) {
  data_parallel_block<kDpVoteChains>(records, F32Tables{attr_idx, nullptr, threshold, child, class_val},
                                     VoteTally{out, C, nullptr}, M, A, N, T, bm, chunk, max_depth);
}

// K7: K3 gather on the quantized layout.
template <typename TT, int K>
__global__ void __launch_bounds__(kSpecThreads, spec_min_ctas(false, K))
fused_speculative_q_kernel(const float* records, QuantTables<TT> tables, int* out,
                           int M, int A, int N, int T, int bm, int chunk, int jumps) {
  speculative_block<false, K>(records, tables, ClassStore{out, M}, M, A, N, T, bm, chunk,
                              jumps);
}

// K8: K4 on the quantized layout.
template <typename TT>
__global__ void __launch_bounds__(kDpThreads)
fused_data_parallel_q_kernel(const float* records, QuantTables<TT> tables, int* out, int M,
                             int A, int N, int T, int bm, int chunk, int max_depth) {
  data_parallel_block<kDpChains>(records, tables, ClassStore{out, M}, M, A, N, T, bm, chunk,
                                 max_depth);
}

__global__ void empty_kernel() {}

int allow_smem(const void* kernel, int smem) {
  if (smem <= kDefaultSmem) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// CTAs of ``threads`` threads and ``smem`` bytes that one SM holds at once.
template <typename... KArgs>
cudaError_t resident_per_sm(void (*kernel)(KArgs...), int threads, int smem, int* per_sm) {
  if (int err = allow_smem(reinterpret_cast<const void*>(kernel), smem)) {
    return static_cast<cudaError_t>(err);
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

// As many CTAs of ``threads`` threads as the card holds at once with this
// footprint, at most one per ``per_cta`` records; each CTA takes an equal
// run of the M records.
template <typename... KArgs, typename... Args>
int launch_wave(void (*kernel)(KArgs...), int M, int threads, int per_cta, int smem,
                cudaStream_t stream, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = resident_per_sm(kernel, threads, smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long by_rows = ((long long)M + per_cta - 1) / per_cta;
  const long long grid = resident < by_rows ? resident : by_rows;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The speculative kernels: CTAs of ``warps`` warps, at most one per ``warps``
// records (one record a warp).
template <typename... KArgs, typename... Args>
int launch_speculative(void (*kernel)(KArgs...), int M, int warps, int smem,
                       cudaStream_t stream, Args... args) {
  return launch_wave(kernel, M, 32 * warps, warps, smem, stream, args...);
}

// Whether a data-parallel launch can hold its tile: ``threads`` own the
// ``bm`` rows two at most each, and a node's indices fit in 16 bits.
bool valid_data_parallel(int threads, int bm, int chunk, int A, int N) {
  return threads >= 1 && threads <= kDpThreads && bm >= 1 && bm <= 2 * threads &&
         chunk >= 1 && A <= 65536 && N <= 65536;
}

// Whether a lane can hold ``slots`` register slots of N nodes (and, for the
// one-hot form, their attr_select columns); 0 is the shared path.
bool valid_slots(int slots, int N, int A, bool onehot, int warps) {
  if (warps < 1 || warps * 32 > kSpecThreads) return false;
  if (slots == 0) return true;
  if (slots != 1 && slots != 2) return false;
  return N <= 32 * slots && (!onehot || A <= kSelectRegisters / slots);
}

// The instantiation for ``slots``: 1 or 2 (register path), else 0 (shared path).
template <typename F>
F by_slots(int slots, F shared, F one, F two) {
  return slots == 1 ? one : slots == 2 ? two : shared;
}

// Each speculative kernel's instantiation for its form and ``slots``.
auto k1_kernel(bool onehot, int slots) {
  return onehot ? by_slots(slots, &speculative_kernel<true, 0>, &speculative_kernel<true, 1>,
                           &speculative_kernel<true, 2>)
                : by_slots(slots, &speculative_kernel<false, 0>, &speculative_kernel<false, 1>,
                           &speculative_kernel<false, 2>);
}
auto k3_kernel(bool onehot, int slots) {
  return onehot ? by_slots(slots, &fused_speculative_kernel<true, 0>,
                           &fused_speculative_kernel<true, 1>, &fused_speculative_kernel<true, 2>)
                : by_slots(slots, &fused_speculative_kernel<false, 0>,
                           &fused_speculative_kernel<false, 1>, &fused_speculative_kernel<false, 2>);
}
auto k5_kernel(bool onehot, int slots) {
  return onehot ? by_slots(slots, &fused_votes_speculative_kernel<true, 0>,
                           &fused_votes_speculative_kernel<true, 1>,
                           &fused_votes_speculative_kernel<true, 2>)
                : by_slots(slots, &fused_votes_speculative_kernel<false, 0>,
                           &fused_votes_speculative_kernel<false, 1>,
                           &fused_votes_speculative_kernel<false, 2>);
}
template <typename TT>
auto k7_kernel(int slots) {
  return by_slots(slots, &fused_speculative_q_kernel<TT, 0>, &fused_speculative_q_kernel<TT, 1>,
                  &fused_speculative_q_kernel<TT, 2>);
}

// Threshold storage codes of kernel.py's THR_CODES.
enum ThrCode { kThrF32 = 0, kThrF16 = 1, kThrBF16 = 2 };

bool valid_index_bytes(int b) { return b == 1 || b == 2 || b == 4; }

// ``f(TT{})`` for the threshold type TT that ``thr_code`` names.
template <typename F>
int with_threshold_type(int thr_code, F f) {
  switch (thr_code) {
    case kThrF32: return f(float{});
    case kThrF16: return f(__half{});
    case kThrBF16: return f(__nv_bfloat16{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7 or K8 on the quantized tables: ``launch_with(QuantTables<TT>{...})``
// for the threshold type that ``thr_code`` names.
template <typename F>
int with_quant_tables(const void* attr_idx, const void* threshold, const void* child,
                      const void* class_val, int thr_code, int attr_bytes, int child_bytes,
                      int cls_bytes, F launch_with) {
  if (!valid_index_bytes(attr_bytes) || !valid_index_bytes(child_bytes) ||
      !valid_index_bytes(cls_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  return with_threshold_type(thr_code, [&](auto tag) {
    using TT = decltype(tag);
    return launch_with(QuantTables<TT>{attr_idx, static_cast<const TT*>(threshold), child,
                                       class_val, attr_bytes, child_bytes, cls_bytes});
  });
}

}  // namespace

extern "C" {

int k1_speculative(const float* records, const int* attr_idx, const float* attr_select,
                   const float* threshold, const int* child, const int* class_val,
                   int* out, int M, int A, int N, int bm, int jumps, int onehot,
                   int warps, int slots, int smem, void* stream) {
  if (!valid_slots(slots, N, A, onehot, warps)) return (int)cudaErrorInvalidValue;
  return launch_speculative(k1_kernel(onehot, slots), M, warps, smem,
                            static_cast<cudaStream_t>(stream), records, attr_idx, attr_select,
                            threshold, child, class_val, out, M, A, N, bm, jumps);
}

int k2_data_parallel(const float* records, const int* attr_idx, const float* threshold,
                     const int* child, const int* class_val, int* out, int M, int A,
                     int N, int bm, int max_depth, int threads, int smem, void* stream) {
  if (!valid_data_parallel(threads, bm, 1, A, N)) return (int)cudaErrorInvalidValue;
  return launch_wave(data_parallel_kernel, M, threads, 2 * threads, smem,
                     static_cast<cudaStream_t>(stream), records, attr_idx, threshold, child,
                     class_val, out, M, A, N, bm, max_depth);
}

int k3_fused_speculative(const float* records, const int* attr_idx,
                         const float* attr_select, const float* threshold,
                         const int* child, const int* class_val, int* out, int M,
                         int A, int N, int T, int bm, int chunk, int jumps, int onehot,
                         int warps, int slots, int smem, void* stream) {
  if (!valid_slots(slots, N, A, onehot, warps) || chunk < 1) return (int)cudaErrorInvalidValue;
  return launch_speculative(k3_kernel(onehot, slots), M, warps, smem,
                            static_cast<cudaStream_t>(stream), records, attr_idx, attr_select,
                            threshold, child, class_val, out, M, A, N, T, bm, chunk, jumps);
}

int k4_fused_data_parallel(const float* records, const int* attr_idx,
                           const float* threshold, const int* child,
                           const int* class_val, int* out, int M, int A, int N, int T,
                           int bm, int chunk, int max_depth, int threads, int smem,
                           void* stream) {
  if (!valid_data_parallel(threads, bm, chunk, A, N)) return (int)cudaErrorInvalidValue;
  return launch_wave(fused_data_parallel_kernel, M, threads, threads, smem,
                     static_cast<cudaStream_t>(stream), records, attr_idx, threshold, child,
                     class_val, out, M, A, N, T, bm, chunk, max_depth);
}

int k5_fused_votes_speculative(const float* records, const int* attr_idx,
                               const float* attr_select, const float* threshold,
                               const int* child, const int* class_val, int* out,
                               int M, int A, int N, int T, int C, int bm, int chunk,
                               int jumps, int onehot, int warps, int slots, int smem,
                               void* stream) {
  if (!valid_slots(slots, N, A, onehot, warps) || chunk < 1) return (int)cudaErrorInvalidValue;
  return launch_speculative(k5_kernel(onehot, slots), M, warps, smem,
                            static_cast<cudaStream_t>(stream), records, attr_idx, attr_select,
                            threshold, child, class_val, out, M, A, N, T, C, bm, chunk, jumps);
}

int k6_fused_votes_data_parallel(const float* records, const int* attr_idx,
                                 const float* threshold, const int* child,
                                 const int* class_val, int* out, int M, int A, int N,
                                 int T, int C, int bm, int chunk, int max_depth, int threads,
                                 int smem, void* stream) {
  if (!valid_data_parallel(threads, bm, chunk, A, N)) return (int)cudaErrorInvalidValue;
  return launch_wave(fused_votes_data_parallel_kernel, M, threads, threads, smem,
                     static_cast<cudaStream_t>(stream), records, attr_idx, threshold, child,
                     class_val, out, M, A, N, T, C, bm, chunk, max_depth);
}

int k7_fused_speculative_q(const float* records, const void* attr_idx,
                           const void* threshold, const void* child,
                           const void* class_val, int* out, int M, int A, int N, int T,
                           int bm, int chunk, int jumps, int thr_code, int attr_bytes,
                           int child_bytes, int cls_bytes, int warps, int slots, int smem,
                           void* stream) {
  if (!valid_slots(slots, N, A, false, warps) || chunk < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return with_quant_tables(
      attr_idx, threshold, child, class_val, thr_code, attr_bytes, child_bytes, cls_bytes,
      [&](auto tables) {
        using TT = typename decltype(tables)::threshold_type;
        return launch_speculative(k7_kernel<TT>(slots), M, warps, smem, s, records, tables,
                                  out, M, A, N, T, bm, chunk, jumps);
      });
}

int k8_fused_data_parallel_q(const float* records, const void* attr_idx,
                             const void* threshold, const void* child,
                             const void* class_val, int* out, int M, int A, int N,
                             int T, int bm, int chunk, int max_depth, int thr_code,
                             int attr_bytes, int child_bytes, int cls_bytes, int threads,
                             int smem, void* stream) {
  if (!valid_data_parallel(threads, bm, chunk, A, N)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return with_quant_tables(
      attr_idx, threshold, child, class_val, thr_code, attr_bytes, child_bytes, cls_bytes,
      [&](auto tables) {
        using TT = typename decltype(tables)::threshold_type;
        return launch_wave(fused_data_parallel_q_kernel<TT>, M, threads, threads, smem, s,
                           records, tables, out, M, A, N, T, bm, chunk, max_depth);
      });
}

// CTAs that one SM holds at once of kernel K``kernel`` (1–8) in form
// ``variant`` (K1/K3/K5: the one-hot flag; K7/K8: the threshold code; else
// 0), with ``slots`` (speculative kernels), ``threads`` a CTA and ``smem`` as
// its launch takes them: the grid of a launch of M records is min(SMs ×
// this, ceil(M / records a CTA at least)).
int tree_eval_per_sm(int kernel, int variant, int slots, int threads, int smem, int* per_sm) {
  switch (kernel) {
    case 1: return (int)resident_per_sm(k1_kernel(variant, slots), threads, smem, per_sm);
    case 2: return (int)resident_per_sm(data_parallel_kernel, threads, smem, per_sm);
    case 3: return (int)resident_per_sm(k3_kernel(variant, slots), threads, smem, per_sm);
    case 4: return (int)resident_per_sm(fused_data_parallel_kernel, threads, smem, per_sm);
    case 5: return (int)resident_per_sm(k5_kernel(variant, slots), threads, smem, per_sm);
    case 6: return (int)resident_per_sm(fused_votes_data_parallel_kernel, threads, smem, per_sm);
    case 7:
      return with_threshold_type(variant, [&](auto tag) {
        return (int)resident_per_sm(k7_kernel<decltype(tag)>(slots), threads, smem, per_sm);
      });
    case 8:
      return with_threshold_type(variant, [&](auto tag) {
        return (int)resident_per_sm(fused_data_parallel_q_kernel<decltype(tag)>, threads, smem,
                                    per_sm);
      });
  }
  return (int)cudaErrorInvalidValue;
}

// An empty launch, for the host cost of one launch through this interface.
int tree_eval_empty(cudaStream_t stream) {
  empty_kernel<<<1, 1, 0, stream>>>();
  return (int)cudaGetLastError();
}

const char* tree_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
