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
// data-parallel kernels come near that; the speculative ones cannot, since
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
// The data-parallel kernels K2/K4/K6/K8 (data_parallel_block): one thread per
// record descends max_depth levels; each CTA stages its record tile once,
// coalesced, and streams the trees' tables through shared memory, one tree
// at a time.  K6's vote tile is zeroed before tree 0, the thread that owns
// row r adds one at [r][cls] after each tree, and the CTA writes the tile
// once as (M, C), so no atomics reach device memory.
//
// The quantized kernels K7/K8.  Their tables are a few KB (4,192 B for the
// paper's 16-tree forest in bf16), so narrowing them cannot move the bound.
// They are K3 gather's and K4's block functions with another table-loading
// policy (``QuantTables``): the tables are read from device memory at their
// stored width, upcast in registers (sign extension; __half2float,
// __bfloat162float, exact) and written to shared memory as int32/f32, so the
// inner loops are K3's and K4's own.  The threshold type is a template
// parameter; the index widths are runtime codes, read by a switch that is
// uniform across the CTA and runs only while tables are staged.

// Shared memory and the tile.  The caller passes each launch's dynamic
// shared-memory bytes (``smem``) and, for the speculative kernels, its warps
// a CTA, trees a table chunk and register slots a lane: kernel.py's
// ``smem_bytes`` is the one formula for the footprint of the layout that
// speculative_block and data_parallel_block carve out below, and the wrapper
// checks it against the card's limit before launching.  Nothing here
// computes a size of its own.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSpecThreads = 256;          // most threads of a speculative CTA (8 warps)
constexpr int kDefaultSmem = 48 * 1024;    // above this a launch must opt in
constexpr int kSelectRegisters = 40;       // attr_select floats a lane holds (one-hot register path)
constexpr unsigned kFullWarp = 0xffffffffu;

template <typename T>
__device__ void block_copy(T* dst, const T* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Output policies of the block functions below.  data_parallel_block calls
// ``begin`` with the end of its shared-memory layout (where a policy may
// keep a tile) before the first barrier, ``put`` from the thread that owns
// row r, and ``finish`` after the last tree's barrier.  speculative_block
// calls ``bind`` with the end of its layout, ``warp_begin``/``warp_finish``
// from each warp around its rows [rb, rb + nr) of a tile, and ``put`` from
// the lane that holds row r's class of tree t.

// K1–K4, K7/K8: the per-tree class of each record, at out[t·M + m0 + r].
struct ClassStore {
  int* out;
  int M;
  __device__ void begin(int*, int) {}
  __device__ void put(int t, long long m0, int r, int cls) {
    out[(long long)t * M + m0 + r] = cls;
  }
  __device__ void finish(long long, int) {}
  __device__ void bind(int*) {}
  __device__ void warp_begin(int, int) {}
  __device__ void warp_finish(long long, int, int) {}
};

// K5/K6: one vote per tree into a (rows, C) tile, written once as (M, C).
// A class outside [0, C) casts no vote.
struct VoteTally {
  int* out;
  int C;
  int* tile;
  __device__ void begin(int* smem_end, int rows) {
    tile = smem_end;
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) tile[i] = 0;
  }
  __device__ void put(int, long long, int r, int cls) {
    if (cls >= 0 && cls < C) tile[r * C + cls] += 1;
  }
  __device__ void finish(long long m0, int rows) {
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) out[m0 * C + i] = tile[i];
  }
  __device__ void bind(int* smem_end) { tile = smem_end; }
  __device__ void warp_begin(int rb, int nr) {
    for (int i = threadIdx.x & 31; i < nr * C; i += 32) tile[rb * C + i] = 0;
    __syncwarp();
  }
  __device__ void warp_finish(long long m0, int rb, int nr) {
    __syncwarp();
    for (int i = threadIdx.x & 31; i < nr * C; i += 32) out[(m0 + rb) * C + i] = tile[rb * C + i];
  }
};

// Table-loading policies of the block functions below.  ``stage`` copies
// tree t's tables into shared memory as int32 attributes/children/classes
// and f32 thresholds (data_parallel_block); ``stage_trees`` copies trees
// [t0, t0 + tn) the same way in one loop, and for the one-hot form also
// their f32 attr_select (speculative_block).  The caller synchronizes after.

// K1–K6: full-width tables, copied as they are.
struct F32Tables {
  const int* attr_idx;
  const float* attr_select;
  const float* threshold;
  const int* child;
  const int* class_val;
  template <bool ONEHOT>
  __device__ void stage(int t, int A, int N, int* s_attr, float* s_sel, float* s_thr,
                        int* s_child, int* s_cls) const {
    const long long tn = (long long)t * N;
    if (ONEHOT) {
      block_copy(s_sel, attr_select + tn * A, A * N);
    } else {
      block_copy(s_attr, attr_idx + tn, N);
    }
    block_copy(s_thr, threshold + tn, N);
    block_copy(s_child, child + tn, N);
    block_copy(s_cls, class_val + tn, N);
  }
  template <bool ONEHOT>
  __device__ void stage_trees(int t0, int tn, int A, int N, int* s_attr, float* s_sel,
                              float* s_thr, int* s_child, int* s_cls) const {
    const long long base = (long long)t0 * N;
    const int nodes = tn * N;
    const int total = ONEHOT ? nodes * A : nodes;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      if (ONEHOT) s_sel[i] = attr_select[base * A + i];
      if (i < nodes) {
        if (!ONEHOT) s_attr[i] = attr_idx[base + i];
        s_thr[i] = threshold[base + i];
        s_child[i] = child[base + i];
        s_cls[i] = class_val[base + i];
      }
    }
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
  template <bool ONEHOT>
  __device__ void stage(int t, int, int N, int* s_attr, float*, float* s_thr,
                        int* s_child, int* s_cls) const {
    static_assert(!ONEHOT, "the quantized layout has no attr_select");
    const long long tn = (long long)t * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      s_attr[i] = load_index(attr_idx, attr_bytes, tn + i);
      s_thr[i] = upcast(threshold[tn + i]);
      s_child[i] = load_index(child, child_bytes, tn + i);
      s_cls[i] = load_index(class_val, cls_bytes, tn + i);
    }
  }
  template <bool ONEHOT>
  __device__ void stage_trees(int t0, int tn, int, int N, int* s_attr, float*, float* s_thr,
                              int* s_child, int* s_cls) const {
    static_assert(!ONEHOT, "the quantized layout has no attr_select");
    const long long base = (long long)t0 * N;
    for (int i = threadIdx.x; i < tn * N; i += blockDim.x) {
      s_attr[i] = load_index(attr_idx, attr_bytes, base + i);
      s_thr[i] = upcast(threshold[base + i]);
      s_child[i] = load_index(child, child_bytes, base + i);
      s_cls[i] = load_index(class_val, cls_bytes, base + i);
    }
  }
};

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
        tables.template stage_trees<ONEHOT>(t0, tn, A, N, s_attr, s_sel, s_thr, s_child, s_cls);
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

// Procedure 3: one thread per record, max_depth dependent rounds.
template <typename Tables, typename Out>
__device__ void data_parallel_block(const float* __restrict__ records, Tables tables,
                                    Out out, int M, int A, int N,
                                    int T, int bm, int max_depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rec = reinterpret_cast<float*>(smem);
  int* s_attr = reinterpret_cast<int*>(s_rec + (size_t)bm * A);
  float* s_thr = reinterpret_cast<float*>(s_attr + N);
  int* s_child = reinterpret_cast<int*>(s_thr + N);
  int* s_cls = s_child + N;

  const long long m0 = (long long)blockIdx.x * bm;
  const int rows = (int)(M - m0 < bm ? M - m0 : bm);
  const int r = threadIdx.x;
  const float* x = s_rec + r * A;
  out.begin(s_cls + N, rows);
  // Staged through shared memory so the row-major (M, A) reads coalesce.
  block_copy(s_rec, records + m0 * A, rows * A);
  for (int t = 0; t < T; ++t) {
    tables.template stage<false>(t, A, N, s_attr, nullptr, s_thr, s_child, s_cls);
    __syncthreads();
    if (r < rows) {
      int idx = 0;
      for (int d = 0; d < max_depth; ++d) {
        idx = s_child[idx] + (x[s_attr[idx]] > s_thr[idx] ? 1 : 0);
      }
      out.put(t, m0, r, s_cls[idx]);
    }
    __syncthreads();  // the next tree overwrites the tables
  }
  out.finish(m0, rows);
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

// K2: one tree.
__global__ void data_parallel_kernel(const float* records, const int* attr_idx,
                                     const float* threshold, const int* child,
                                     const int* class_val, int* out, int M, int A,
                                     int N, int bm, int max_depth) {
  data_parallel_block(records, F32Tables{attr_idx, nullptr, threshold, child, class_val},
                      ClassStore{out, M}, M, A, N, 1, bm, max_depth);
}

// K4: the whole forest in one launch.
__global__ void fused_data_parallel_kernel(const float* records, const int* attr_idx,
                                           const float* threshold, const int* child,
                                           const int* class_val, int* out, int M,
                                           int A, int N, int T, int bm, int max_depth) {
  data_parallel_block(records, F32Tables{attr_idx, nullptr, threshold, child, class_val},
                      ClassStore{out, M}, M, A, N, T, bm, max_depth);
}

// K6: K4 with the forest's votes accumulated in shared memory, (M, C).
__global__ void fused_votes_data_parallel_kernel(const float* records,
                                                 const int* attr_idx,
                                                 const float* threshold,
                                                 const int* child,
                                                 const int* class_val, int* out,
                                                 int M, int A, int N, int T, int C,
                                                 int bm, int max_depth) {
  data_parallel_block(records, F32Tables{attr_idx, nullptr, threshold, child, class_val},
                      VoteTally{out, C, nullptr}, M, A, N, T, bm, max_depth);
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
__global__ void fused_data_parallel_q_kernel(const float* records, QuantTables<TT> tables,
                                             int* out, int M, int A, int N, int T, int bm,
                                             int max_depth) {
  data_parallel_block(records, tables, ClassStore{out, M}, M, A, N, T, bm, max_depth);
}

int allow_smem(const void* kernel, int smem) {
  if (smem <= kDefaultSmem) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The data-parallel kernels: one CTA of ``threads`` per ``bm`` records.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int M, int bm, int threads, int smem,
           cudaStream_t stream, Args... args) {
  if (int err = allow_smem(reinterpret_cast<const void*>(kernel), smem)) return err;
  const int grid = (M + bm - 1) / bm;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// CTAs of ``warps`` warps and ``smem`` bytes that one SM holds at once.
template <typename... KArgs>
cudaError_t resident_per_sm(void (*kernel)(KArgs...), int warps, int smem, int* per_sm) {
  if (int err = allow_smem(reinterpret_cast<const void*>(kernel), smem)) {
    return static_cast<cudaError_t>(err);
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, 32 * warps, smem);
}

// The speculative kernels: as many CTAs of ``warps`` warps as the card holds
// at once with this footprint, at most one per ``warps`` records; each CTA
// takes an equal run of the M records.
template <typename... KArgs, typename... Args>
int launch_speculative(void (*kernel)(KArgs...), int M, int warps, int smem,
                       cudaStream_t stream, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = resident_per_sm(kernel, warps, smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long by_rows = ((long long)M + warps - 1) / warps;
  const long long grid = resident < by_rows ? resident : by_rows;
  kernel<<<(unsigned)grid, 32 * warps, smem, stream>>>(args...);
  return (int)cudaGetLastError();
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
  switch (thr_code) {
    case kThrF32:
      return launch_with(QuantTables<float>{attr_idx, static_cast<const float*>(threshold),
                                            child, class_val, attr_bytes, child_bytes,
                                            cls_bytes});
    case kThrF16:
      return launch_with(QuantTables<__half>{attr_idx, static_cast<const __half*>(threshold),
                                             child, class_val, attr_bytes, child_bytes,
                                             cls_bytes});
    case kThrBF16:
      return launch_with(QuantTables<__nv_bfloat16>{
          attr_idx, static_cast<const __nv_bfloat16*>(threshold), child, class_val,
          attr_bytes, child_bytes, cls_bytes});
    default:
      return (int)cudaErrorInvalidValue;
  }
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
                     int N, int bm, int max_depth, int smem, void* stream) {
  return launch(data_parallel_kernel, M, bm, bm, smem,
                static_cast<cudaStream_t>(stream), records, attr_idx, threshold,
                child, class_val, out, M, A, N, bm, max_depth);
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
                           int bm, int max_depth, int smem, void* stream) {
  return launch(fused_data_parallel_kernel, M, bm, bm, smem,
                static_cast<cudaStream_t>(stream), records, attr_idx, threshold,
                child, class_val, out, M, A, N, T, bm, max_depth);
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
                                 int T, int C, int bm, int max_depth, int smem,
                                 void* stream) {
  return launch(fused_votes_data_parallel_kernel, M, bm, bm, smem,
                static_cast<cudaStream_t>(stream), records, attr_idx, threshold,
                child, class_val, out, M, A, N, T, C, bm, max_depth);
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
                             int T, int bm, int max_depth, int thr_code, int attr_bytes,
                             int child_bytes, int cls_bytes, int smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return with_quant_tables(
      attr_idx, threshold, child, class_val, thr_code, attr_bytes, child_bytes, cls_bytes,
      [&](auto tables) {
        using TT = typename decltype(tables)::threshold_type;
        return launch(fused_data_parallel_q_kernel<TT>, M, bm, bm, smem, s, records, tables,
                      out, M, A, N, T, bm, max_depth);
      });
}

// CTAs that one SM holds at once of speculative kernel K``kernel`` (1, 3, 5
// or 7) in form ``variant`` (one-hot flag; K7: threshold code), with
// ``slots``, ``warps`` and ``smem`` as its launch takes them: the grid of a
// launch of M records is min(SMs × this, ceil(M / warps)).
int tree_eval_speculative_per_sm(int kernel, int variant, int slots, int warps, int smem,
                                 int* per_sm) {
  switch (kernel) {
    case 1: return (int)resident_per_sm(k1_kernel(variant, slots), warps, smem, per_sm);
    case 3: return (int)resident_per_sm(k3_kernel(variant, slots), warps, smem, per_sm);
    case 5: return (int)resident_per_sm(k5_kernel(variant, slots), warps, smem, per_sm);
    case 7:
      switch (variant) {
        case kThrF32: return (int)resident_per_sm(k7_kernel<float>(slots), warps, smem, per_sm);
        case kThrF16: return (int)resident_per_sm(k7_kernel<__half>(slots), warps, smem, per_sm);
        case kThrBF16:
          return (int)resident_per_sm(k7_kernel<__nv_bfloat16>(slots), warps, smem, per_sm);
      }
  }
  return (int)cudaErrorInvalidValue;
}

const char* tree_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
