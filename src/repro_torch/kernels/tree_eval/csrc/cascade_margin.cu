// The early-exit cascade's margin pass for Hopper (sm_90a), with a plain C
// interface that ``repro_torch/kernels/tree_eval/margin.py`` loads through
// ctypes.
//
// The cascade (``cascade.py``) turns the forest's (M, C) int32 vote tally
// into a vote margin in two places: each stage that leaves trees to run
// tests the survivors for an exit, and the finish takes every record's
// winner, margin and confidence and bins the margins into the
// ``cascade.exit_margin`` histogram.  Both scan a tally row once for top-1,
// top-2 and the lowest class holding top-1 (``row_top2``), the rule of
// ``core.forest.vote_winner`` (ties to the lowest class) and of a
// ``topk(2)`` margin (a tie at the top gives margin 0).
//   cascade_exit_test_kernel  stage s's exit test: for survivor i (record
//     alive[i]) exit_stage[alive[i]] = s where (double)(top1 - top2) > thr,
//     keep[i] = not that.  ``thr`` is bound * remaining, computed by the
//     host in double: the comparison is numpy's (an int margin against a
//     float64 product), never a float32 one.
//   cascade_finish_kernel  classes (int32), margin (int32) and confidence:
//     margin / max(remaining, 1) in double, clamped to [0, 1], 1.0 where no
//     tree remains, rounded once to float32; and, given a histogram buffer,
//     the margins binned into it (below).
//
// These kernels replace no TPU kernel.  The JAX package leaves the margin to
// XLA's fused ops and reads the margins back to the host for its histogram;
// on this card the same torch ops cost two ``topk`` (a gatherTopK and a
// bitonic sort a call), some twenty small launches, and a blocking copy of
// the M margins to the host for NumPy to bin while the card waits.  They
// were added to take the margin off that path: one launch each, no sort,
// and no read of the margins by the host.
//
// Bound on this card.  At the paper's frame (M = 65,536, C = 7) the exit
// test of stage 0 reads the 1.83 MB tally, 0.52 MB of survivor indices and
// writes 66 KB of keep flags and the exit stages of the records that leave;
// the finish reads the tally and the 0.26 MB trees_evaluated and writes
// three 0.26 MB vectors.  About 2.9 MB each, some 0.9 us at 3.35 TB/s, below
// what a launch costs: both are launch-bound.  So each is one launch of one
// thread a row, 256 rows a CTA, and no second pass.  A row's C loads are
// strided by C ints across a warp; the warp's rows are one contiguous run of
// 32·C ints, so its loads touch that run's cache lines and nothing else.
//
// The histogram.  The buffer is int64 (n_bins + 4,): the bucket counts (the
// n_bounds boundaries of ``obs.metrics.Histogram`` and its overflow bucket:
// a margin goes to the first boundary it does not exceed, numpy's
// searchsorted(side="left")), then the count, the sum, the least and the
// greatest margin.  A warp counts its rows' buckets with one ballot a bucket
// and reduces count, sum, least and greatest with shuffles; its lane 0 adds
// them to the CTA's shared bins; after one barrier the CTA adds each
// nonzero bin to the buffer with one atomicAdd (atomicMin, atomicMax).  So
// the buffer takes at most n_bins + 4 atomics a CTA, and the host reads it
// only when someone reads the histogram.  A null buffer bins nothing (the
// registry is disabled).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // one row a thread
constexpr int kMaxBounds = 31;      // histogram boundaries a launch takes (32 buckets)
constexpr unsigned kFull = 0xffffffffu;

// The histogram's boundaries, passed by value with the launch.
struct Bounds {
  double b[kMaxBounds];
  int n;
};

// One tally row: its greatest count, the lowest class holding it, and the
// second greatest count (equal to the greatest where two classes tie).
__device__ __forceinline__ void row_top2(const int* __restrict__ row, int C, int& top1, int& top2,
                                         int& cls) {
  top1 = row[0];
  top2 = INT_MIN;
  cls = 0;
  for (int c = 1; c < C; ++c) {
    const int v = row[c];
    if (v > top1) {
      top2 = top1;
      top1 = v;
      cls = c;
    } else if (v > top2) {
      top2 = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cascade_exit_test_kernel(const int* __restrict__ votes, const long long* __restrict__ alive, int n,
                         int C, int stage, double thr, int* __restrict__ exit_stage,
                         unsigned char* __restrict__ keep) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long r = alive[i];
  int top1, top2, cls;
  row_top2(votes + r * C, C, top1, top2, cls);
  const bool decided = static_cast<double>(top1 - top2) > thr;
  if (decided) exit_stage[r] = stage;
  keep[i] = decided ? 0 : 1;
}

__global__ void __launch_bounds__(kThreads)
cascade_finish_kernel(const int* __restrict__ votes, const int* __restrict__ trees_evaluated,
                      int M, int C, int t_total, int* __restrict__ classes,
                      int* __restrict__ margin, float* __restrict__ confidence,
                      long long* __restrict__ hist, Bounds bounds) {
  __shared__ double s_bounds[kMaxBounds];
  __shared__ unsigned s_bins[kMaxBounds + 1];
  __shared__ unsigned long long s_count, s_sum;
  __shared__ int s_min, s_max;
  const int n_bins = bounds.n + 1;
  const int t = threadIdx.x;
  if (hist != nullptr) {   // uniform over the grid
    if (t < bounds.n) s_bounds[t] = bounds.b[t];
    if (t < n_bins) s_bins[t] = 0;
    if (t == 0) {
      s_count = 0;
      s_sum = 0;
      s_min = INT_MAX;
      s_max = INT_MIN;
    }
    __syncthreads();
  }

  const int i = blockIdx.x * kThreads + t;
  const bool valid = i < M;
  int m = 0;
  if (valid) {
    int top1, top2, cls;
    row_top2(votes + static_cast<long long>(i) * C, C, top1, top2, cls);
    m = top1 - top2;
    classes[i] = cls;
    margin[i] = m;
    const int remaining = t_total - trees_evaluated[i];
    float conf = 1.0f;
    if (remaining > 0) {
      const double ratio = static_cast<double>(m) / static_cast<double>(remaining);
      conf = __double2float_rn(fmin(fmax(ratio, 0.0), 1.0));
    }
    confidence[i] = conf;
  }
  if (hist == nullptr) return;

  int bin = 0;
  if (valid) {
    const double v = static_cast<double>(m);
    while (bin < bounds.n && v > s_bounds[bin]) ++bin;
  }
  const int lane = t & 31;
  for (int b = 0; b < n_bins; ++b) {
    const unsigned c = __popc(__ballot_sync(kFull, valid && bin == b));
    if (lane == 0 && c != 0) atomicAdd(&s_bins[b], c);
  }
  const unsigned count = __popc(__ballot_sync(kFull, valid));
  long long sum = valid ? m : 0;
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(kFull, sum, off);
  const int lo = __reduce_min_sync(kFull, valid ? m : INT_MAX);
  const int hi = __reduce_max_sync(kFull, valid ? m : INT_MIN);
  if (lane == 0 && count != 0) {
    atomicAdd(&s_count, static_cast<unsigned long long>(count));
    atomicAdd(&s_sum, static_cast<unsigned long long>(sum));
    atomicMin(&s_min, lo);
    atomicMax(&s_max, hi);
  }
  __syncthreads();

  auto* out = reinterpret_cast<unsigned long long*>(hist);
  if (t < n_bins) {
    if (s_bins[t] != 0) atomicAdd(out + t, static_cast<unsigned long long>(s_bins[t]));
  } else if (s_count != 0) {
    if (t == n_bins) atomicAdd(out + n_bins, s_count);
    if (t == n_bins + 1) atomicAdd(out + n_bins + 1, s_sum);
    if (t == n_bins + 2) atomicMin(hist + n_bins + 2, static_cast<long long>(s_min));
    if (t == n_bins + 3) atomicMax(hist + n_bins + 3, static_cast<long long>(s_max));
  }
}

int blocks(int rows) { return (rows + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Stage ``stage``'s exit test over the ``n`` survivors ``alive`` (int64
// record indices) of the (M, C) tally ``votes``: writes ``exit_stage`` of
// the records that leave and ``keep`` (n bytes, 1 for a record that stays).
int cascade_exit_test(const int* votes, const long long* alive, int n, int C, int stage,
                      double thr, int* exit_stage, unsigned char* keep, cudaStream_t stream) {
  if (n < 1 || C < 2) return (int)cudaErrorInvalidValue;
  cascade_exit_test_kernel<<<blocks(n), kThreads, 0, stream>>>(votes, alive, n, C, stage, thr,
                                                                exit_stage, keep);
  return (int)cudaGetLastError();
}

// The finish over the (M, C) tally: classes, margin and confidence (M,)
// each; and, where ``hist`` is not null, the margins binned into it by the
// ``n_bounds`` ascending ``bounds`` (a host array, copied into the launch).
int cascade_finish(const int* votes, const int* trees_evaluated, int M, int C, int t_total,
                   int* classes, int* margin, float* confidence, long long* hist,
                   const double* bounds, int n_bounds, cudaStream_t stream) {
  if (M < 1 || C < 2 || n_bounds < 0 || n_bounds > kMaxBounds) return (int)cudaErrorInvalidValue;
  Bounds b{};
  for (int k = 0; k < n_bounds; ++k) b.b[k] = bounds[k];
  b.n = n_bounds;
  cascade_finish_kernel<<<blocks(M), kThreads, 0, stream>>>(
      votes, trees_evaluated, M, C, t_total, classes, margin, confidence, hist, b);
  return (int)cudaGetLastError();
}

const char* cascade_margin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
