// Tree-evaluation kernels K1–K6 for Hopper (sm_90a), with a plain C interface
// that ``repro_torch/kernels/tree_eval/kernel.py`` loads through ctypes.
//
// Each kernel evaluates float32 records (M, A), row-major and contiguous,
// against breadth-first branchless tree tables over N nodes: attr_idx,
// threshold, child, class_val (and, for the one-hot form, attr_select
// (A, N)).  K1/K2 write int32 classes (M,); the forest kernels take the same
// tables stacked (T, N) / (T, A, N) and write per-tree classes (T, M) (K3/K4)
// or the forest's int32 vote counts (M, C) (K5/K6).
//
// Which TPU kernel each replaces (src/repro/kernels/tree_eval/kernel.py):
//   K1 speculative_kernel              <- speculative_pallas / _speculative_compute
//   K2 data_parallel_kernel            <- data_parallel_pallas / _data_parallel_compute
//   K3 fused_speculative_kernel        <- fused_speculative_pallas
//   K4 fused_data_parallel_kernel      <- fused_data_parallel_pallas
//   K5 fused_votes_speculative_kernel  <- fused_votes_speculative_pallas (+ _accumulate_votes)
//   K6 fused_votes_data_parallel_kernel <- fused_votes_data_parallel_pallas
//
// Bound on this card.  The work is small integer and compare arithmetic over
// data that is read once, so memory is the bound: at the paper shape
// (M = 65,536, A = 19) K1/K2 read 65,536·19·4 B = 4.98 MB of records and write
// 0.26 MB of classes, about 1.6 us at 3.35 TB/s; K3/K4 at T = 16 also write
// 4.19 MB of per-tree classes, about 2.7 us.  K5/K6 write votes instead,
// 65,536·C·4 B = 1.84 MB at C = 7: about 2.0 us for the whole 16-tree forest.
// The tree tables (a few KB) are negligible.
//
// What the design does about it.  Each CTA reads its record tile from device
// memory exactly once, with consecutive threads on consecutive words
// (coalesced), into shared memory; every later access — the per-node
// attribute gathers, the pointer jumps, the per-record descent — is a
// shared-memory access.  The forest kernels keep the tile resident while
// the T trees' tables stream through shared memory, so records are read once
// per forest, not once per tree.  Outputs are written once, coalesced.
// The TPU workarounds are gone: attributes are gathered from the tile (the
// one-hot form keeps the records @ attr_select product, as exact f32 FMAs on
// the CUDA cores, never TF32), and pointer jumps are shared-memory gathers
// rather than one-hot permutation products.
//
// The vote kernels K5/K6.  On the TPU the tree axis is a sequential grid
// dimension, and each tree step revisits one (block_m, C) output block in
// VMEM.  Here the tree axis is already the loop inside the CTA, so K5/K6 are
// K3/K4's device functions with another output policy (``VoteTally``): a
// (block_m, C) int32 tile in shared memory, zeroed before tree 0; after each
// tree the thread that owns row r adds one at [r][cls] when 0 <= cls < C;
// after the last tree the CTA writes the tile once, coalesced, as row-major
// (M, C).  Each CTA owns its rows across all trees, so no atomics to device
// memory are needed, and the (T, M) per-tree classes never reach it.

// Shared memory.  The caller passes each launch's dynamic shared-memory bytes
// (``smem``): kernel.py's ``smem_bytes`` is the one formula for the footprint
// of the layout that speculative_block and data_parallel_block carve out
// below, and the wrapper checks it against the card's limit before launching.
// Nothing here computes a size of its own.

#include <cuda_runtime.h>

namespace {

constexpr int kSpecThreads = 256;          // threads of a speculative CTA
constexpr int kDefaultSmem = 48 * 1024;    // above this a launch must opt in

template <typename T>
__device__ void block_copy(T* dst, const T* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Output policies of the block functions below.  ``begin`` gets the end of
// the block's shared-memory layout (where a policy may keep a tile) before
// the first barrier; ``put`` takes row r's class for tree t from the thread
// that owns row r; ``finish`` runs after the last tree's barrier.

// K1–K4: the per-tree class of each record, at out[t·M + m0 + r].
struct ClassStore {
  int* out;
  int M;
  __device__ void begin(int*, int) {}
  __device__ void put(int t, long long m0, int r, int cls) {
    out[(long long)t * M + m0 + r] = cls;
  }
  __device__ void finish(long long, int) {}
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
};

// Procedure 4/5 on one record tile and one tree held in shared memory.
// Returns the buffer that holds the jumped paths; ends with a barrier.
template <bool ONEHOT>
__device__ const int* speculative_tile(const float* rec, int rows, int A, int N,
                                       const int* attr, const float* sel,
                                       const float* thr, const int* child,
                                       int* p0, int* p1, int jumps) {
  const int total = rows * N;
  // Node evaluation: thread i owns (record r, node n); path = child + (v > t).
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / N;
    const int n = i - r * N;
    const float* x = rec + r * A;
    float v;
    if (ONEHOT) {
      // records @ attr_select: one nonzero term per column on sanitized
      // records, so the f32 sum is exact whatever its order.
      v = 0.0f;
      for (int a = 0; a < A; ++a) v = fmaf(x[a], sel[a * N + n], v);
    } else {
      v = x[attr[n]];
    }
    p0[i] = child[n] + (v > thr[n] ? 1 : 0);
  }
  // Pointer jumping, path[r][n] <- path[r][path[r][n]], double-buffered.
  for (int j = 0; j < jumps; ++j) {
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = (i / N) * N;
      p1[i] = p0[row + p0[i]];
    }
    int* t = p0;
    p0 = p1;
    p1 = t;
  }
  __syncthreads();
  return p0;
}

// One CTA: record tile [m0, m0 + rows) against T trees, tile resident.
template <bool ONEHOT, typename Out>
__device__ void speculative_block(const float* __restrict__ records,
                                  const int* __restrict__ attr_idx,
                                  const float* __restrict__ attr_select,
                                  const float* __restrict__ threshold,
                                  const int* __restrict__ child,
                                  const int* __restrict__ class_val,
                                  Out out, int M, int A, int N,
                                  int T, int bm, int jumps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rec = reinterpret_cast<float*>(smem);
  int* s_p0 = reinterpret_cast<int*>(s_rec + (size_t)bm * A);
  int* s_p1 = s_p0 + (size_t)bm * N;
  float* s_thr = reinterpret_cast<float*>(s_p1 + (size_t)bm * N);
  int* s_child = reinterpret_cast<int*>(s_thr + N);
  int* s_cls = s_child + N;
  int* s_attr = s_cls + N;                              // gather form
  float* s_sel = reinterpret_cast<float*>(s_cls + N);   // one-hot form

  const long long m0 = (long long)blockIdx.x * bm;
  const int rows = (int)(M - m0 < bm ? M - m0 : bm);
  out.begin(s_cls + N + (ONEHOT ? A * N : N), rows);
  block_copy(s_rec, records + m0 * A, rows * A);
  for (int t = 0; t < T; ++t) {
    const long long tn = (long long)t * N;
    if (ONEHOT) {
      block_copy(s_sel, attr_select + tn * A, A * N);
    } else {
      block_copy(s_attr, attr_idx + tn, N);
    }
    block_copy(s_thr, threshold + tn, N);
    block_copy(s_child, child + tn, N);
    block_copy(s_cls, class_val + tn, N);
    __syncthreads();
    const int* p = speculative_tile<ONEHOT>(s_rec, rows, A, N, s_attr, s_sel,
                                            s_thr, s_child, s_p0, s_p1, jumps);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      out.put(t, m0, r, s_cls[p[r * N]]);
    }
    __syncthreads();  // the next tree overwrites tables and paths
  }
  out.finish(m0, rows);
}

// Procedure 3: one thread per record, max_depth dependent rounds.
template <typename Out>
__device__ void data_parallel_block(const float* __restrict__ records,
                                    const int* __restrict__ attr_idx,
                                    const float* __restrict__ threshold,
                                    const int* __restrict__ child,
                                    const int* __restrict__ class_val,
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
    const long long tn = (long long)t * N;
    block_copy(s_attr, attr_idx + tn, N);
    block_copy(s_thr, threshold + tn, N);
    block_copy(s_child, child + tn, N);
    block_copy(s_cls, class_val + tn, N);
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

// K1: one tree.
template <bool ONEHOT>
__global__ void __launch_bounds__(kSpecThreads)
speculative_kernel(const float* records, const int* attr_idx, const float* attr_select,
                   const float* threshold, const int* child, const int* class_val,
                   int* out, int M, int A, int N, int bm, int jumps) {
  speculative_block<ONEHOT>(records, attr_idx, attr_select, threshold, child,
                            class_val, ClassStore{out, M}, M, A, N, 1, bm, jumps);
}

// K3: the whole forest in one launch, the record tile resident across trees.
template <bool ONEHOT>
__global__ void __launch_bounds__(kSpecThreads)
fused_speculative_kernel(const float* records, const int* attr_idx,
                         const float* attr_select, const float* threshold,
                         const int* child, const int* class_val, int* out,
                         int M, int A, int N, int T, int bm, int jumps) {
  speculative_block<ONEHOT>(records, attr_idx, attr_select, threshold, child,
                            class_val, ClassStore{out, M}, M, A, N, T, bm, jumps);
}

// K5: K3 with the forest's votes accumulated in shared memory, (M, C).
template <bool ONEHOT>
__global__ void __launch_bounds__(kSpecThreads)
fused_votes_speculative_kernel(const float* records, const int* attr_idx,
                               const float* attr_select, const float* threshold,
                               const int* child, const int* class_val, int* out,
                               int M, int A, int N, int T, int C, int bm, int jumps) {
  speculative_block<ONEHOT>(records, attr_idx, attr_select, threshold, child,
                            class_val, VoteTally{out, C, nullptr}, M, A, N, T, bm,
                            jumps);
}

// K2: one tree.
__global__ void data_parallel_kernel(const float* records, const int* attr_idx,
                                     const float* threshold, const int* child,
                                     const int* class_val, int* out, int M, int A,
                                     int N, int bm, int max_depth) {
  data_parallel_block(records, attr_idx, threshold, child, class_val,
                      ClassStore{out, M}, M, A, N, 1, bm, max_depth);
}

// K4: the whole forest in one launch.
__global__ void fused_data_parallel_kernel(const float* records, const int* attr_idx,
                                           const float* threshold, const int* child,
                                           const int* class_val, int* out, int M,
                                           int A, int N, int T, int bm, int max_depth) {
  data_parallel_block(records, attr_idx, threshold, child, class_val,
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
  data_parallel_block(records, attr_idx, threshold, child, class_val,
                      VoteTally{out, C, nullptr}, M, A, N, T, bm, max_depth);
}

template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int M, int bm, int threads, int smem,
           cudaStream_t stream, Args... args) {
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (M + bm - 1) / bm;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k1_speculative(const float* records, const int* attr_idx, const float* attr_select,
                   const float* threshold, const int* child, const int* class_val,
                   int* out, int M, int A, int N, int bm, int jumps, int onehot,
                   int smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (onehot) {
    return launch(speculative_kernel<true>, M, bm, kSpecThreads, smem, s, records,
                  attr_idx, attr_select, threshold, child, class_val, out, M, A, N,
                  bm, jumps);
  }
  return launch(speculative_kernel<false>, M, bm, kSpecThreads, smem, s, records,
                attr_idx, attr_select, threshold, child, class_val, out, M, A, N,
                bm, jumps);
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
                         int A, int N, int T, int bm, int jumps, int onehot,
                         int smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (onehot) {
    return launch(fused_speculative_kernel<true>, M, bm, kSpecThreads, smem, s,
                  records, attr_idx, attr_select, threshold, child, class_val, out,
                  M, A, N, T, bm, jumps);
  }
  return launch(fused_speculative_kernel<false>, M, bm, kSpecThreads, smem, s,
                records, attr_idx, attr_select, threshold, child, class_val, out, M,
                A, N, T, bm, jumps);
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
                               int M, int A, int N, int T, int C, int bm, int jumps,
                               int onehot, int smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (onehot) {
    return launch(fused_votes_speculative_kernel<true>, M, bm, kSpecThreads, smem, s,
                  records, attr_idx, attr_select, threshold, child, class_val, out,
                  M, A, N, T, C, bm, jumps);
  }
  return launch(fused_votes_speculative_kernel<false>, M, bm, kSpecThreads, smem, s,
                records, attr_idx, attr_select, threshold, child, class_val, out, M,
                A, N, T, C, bm, jumps);
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

const char* tree_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
