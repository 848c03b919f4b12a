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
//
// The quantized kernels K7/K8.  Their tables are a few KB (4,192 B for the
// paper's 16-tree forest in bf16), so they are bound by the same record and
// class bytes as K3/K4 and narrowing them cannot move that bound.  They are
// K3 gather's and K4's block functions with another table-loading policy
// (``QuantTables``): each tree's tables are read from device memory at their
// stored width, upcast in registers (sign extension; __half2float,
// __bfloat162float, exact) and written to shared memory as int32/f32 once
// per tree per CTA, so the inner loops are K3/K4's own.  No pass on the host
// or the device widens the tables before the launch.  The threshold type is
// a template parameter (three instantiations per kernel); the index widths
// are runtime codes, read by a switch that is uniform across the CTA and
// runs only while a tree is staged.

// Shared memory.  The caller passes each launch's dynamic shared-memory bytes
// (``smem``): kernel.py's ``smem_bytes`` is the one formula for the footprint
// of the layout that speculative_block and data_parallel_block carve out
// below, and the wrapper checks it against the card's limit before launching.
// Nothing here computes a size of its own.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// Table-loading policies of the block functions below.  ``stage`` copies
// tree t's tables into shared memory as int32 attributes/children/classes
// and f32 thresholds (and, for the one-hot form, f32 attr_select); the
// caller synchronizes after it.

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
template <bool ONEHOT, typename Tables, typename Out>
__device__ void speculative_block(const float* __restrict__ records, Tables tables,
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
    tables.template stage<ONEHOT>(t, A, N, s_attr, s_sel, s_thr, s_child, s_cls);
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

// K1: one tree.
template <bool ONEHOT>
__global__ void __launch_bounds__(kSpecThreads)
speculative_kernel(const float* records, const int* attr_idx, const float* attr_select,
                   const float* threshold, const int* child, const int* class_val,
                   int* out, int M, int A, int N, int bm, int jumps) {
  speculative_block<ONEHOT>(
      records, F32Tables{attr_idx, attr_select, threshold, child, class_val},
      ClassStore{out, M}, M, A, N, 1, bm, jumps);
}

// K3: the whole forest in one launch, the record tile resident across trees.
template <bool ONEHOT>
__global__ void __launch_bounds__(kSpecThreads)
fused_speculative_kernel(const float* records, const int* attr_idx,
                         const float* attr_select, const float* threshold,
                         const int* child, const int* class_val, int* out,
                         int M, int A, int N, int T, int bm, int jumps) {
  speculative_block<ONEHOT>(
      records, F32Tables{attr_idx, attr_select, threshold, child, class_val},
      ClassStore{out, M}, M, A, N, T, bm, jumps);
}

// K5: K3 with the forest's votes accumulated in shared memory, (M, C).
template <bool ONEHOT>
__global__ void __launch_bounds__(kSpecThreads)
fused_votes_speculative_kernel(const float* records, const int* attr_idx,
                               const float* attr_select, const float* threshold,
                               const int* child, const int* class_val, int* out,
                               int M, int A, int N, int T, int C, int bm, int jumps) {
  speculative_block<ONEHOT>(
      records, F32Tables{attr_idx, attr_select, threshold, child, class_val},
      VoteTally{out, C, nullptr}, M, A, N, T, bm, jumps);
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
template <typename TT>
__global__ void __launch_bounds__(kSpecThreads)
fused_speculative_q_kernel(const float* records, QuantTables<TT> tables, int* out,
                           int M, int A, int N, int T, int bm, int jumps) {
  speculative_block<false>(records, tables, ClassStore{out, M}, M, A, N, T, bm, jumps);
}

// K8: K4 on the quantized layout.
template <typename TT>
__global__ void fused_data_parallel_q_kernel(const float* records, QuantTables<TT> tables,
                                             int* out, int M, int A, int N, int T, int bm,
                                             int max_depth) {
  data_parallel_block(records, tables, ClassStore{out, M}, M, A, N, T, bm, max_depth);
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

// Threshold storage codes of kernel.py's THR_CODES.
enum ThrCode { kThrF32 = 0, kThrF16 = 1, kThrBF16 = 2 };

bool valid_index_bytes(int b) { return b == 1 || b == 2 || b == 4; }

// K7 (SPEC) or K8 with the threshold type chosen by ``thr_code``.
template <bool SPEC, typename TT>
int launch_q(const float* records, const void* attr_idx, const void* threshold,
             const void* child, const void* class_val, int* out, int M, int A, int N,
             int T, int bm, int depth_arg, int attr_bytes, int child_bytes, int cls_bytes,
             int smem, cudaStream_t stream) {
  const QuantTables<TT> tables{attr_idx, static_cast<const TT*>(threshold), child,
                               class_val, attr_bytes, child_bytes, cls_bytes};
  if (SPEC) {
    return launch(fused_speculative_q_kernel<TT>, M, bm, kSpecThreads, smem, stream,
                  records, tables, out, M, A, N, T, bm, depth_arg);
  }
  return launch(fused_data_parallel_q_kernel<TT>, M, bm, bm, smem, stream, records,
                tables, out, M, A, N, T, bm, depth_arg);
}

template <bool SPEC>
int dispatch_q(const float* records, const void* attr_idx, const void* threshold,
               const void* child, const void* class_val, int* out, int M, int A, int N,
               int T, int bm, int depth_arg, int thr_code, int attr_bytes,
               int child_bytes, int cls_bytes, int smem, void* stream) {
  if (!valid_index_bytes(attr_bytes) || !valid_index_bytes(child_bytes) ||
      !valid_index_bytes(cls_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (thr_code) {
    case kThrF32:
      return launch_q<SPEC, float>(records, attr_idx, threshold, child, class_val, out, M,
                                   A, N, T, bm, depth_arg, attr_bytes, child_bytes,
                                   cls_bytes, smem, s);
    case kThrF16:
      return launch_q<SPEC, __half>(records, attr_idx, threshold, child, class_val, out,
                                    M, A, N, T, bm, depth_arg, attr_bytes, child_bytes,
                                    cls_bytes, smem, s);
    case kThrBF16:
      return launch_q<SPEC, __nv_bfloat16>(records, attr_idx, threshold, child, class_val,
                                           out, M, A, N, T, bm, depth_arg, attr_bytes,
                                           child_bytes, cls_bytes, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

int k7_fused_speculative_q(const float* records, const void* attr_idx,
                           const void* threshold, const void* child,
                           const void* class_val, int* out, int M, int A, int N, int T,
                           int bm, int jumps, int thr_code, int attr_bytes,
                           int child_bytes, int cls_bytes, int smem, void* stream) {
  return dispatch_q<true>(records, attr_idx, threshold, child, class_val, out, M, A, N, T,
                          bm, jumps, thr_code, attr_bytes, child_bytes, cls_bytes, smem,
                          stream);
}

int k8_fused_data_parallel_q(const float* records, const void* attr_idx,
                             const void* threshold, const void* child,
                             const void* class_val, int* out, int M, int A, int N,
                             int T, int bm, int max_depth, int thr_code, int attr_bytes,
                             int child_bytes, int cls_bytes, int smem, void* stream) {
  return dispatch_q<false>(records, attr_idx, threshold, child, class_val, out, M, A, N,
                           T, bm, max_depth, thr_code, attr_bytes, child_bytes, cls_bytes,
                           smem, stream);
}

const char* tree_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
