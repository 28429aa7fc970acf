// C7 quantile_counts: integer quantile-tree counts of the kept rows.
//
// Replaces the count half of K12, pipelinedp_tpu/executor.py: the leaf
// scatter-add and level roll-ups of quantile_outputs' dense chunk
// (:859-880), the per-level child segment sums of the lazy descent
// (_lazy_quantile_outputs, :796-808), and the leaf of each row
// (_leaf_indices, :270, at :402-405).
//
// Rows come in partition-sorted order (C5 after C2): sorted row i belongs
// to partition skey2[i] (kept when < n_partitions), and its value is
// values[row_perm[perm[i]]] (values[perm[i]] when row_perm is null), the
// unclipped value of the bounding-sorted row. Its leaf is
//   trunc((v - min) / (span > 0 ? span : 1) * L), clipped to [0, L),
// with the saturating, NaN-to-0 float-to-int conversion of XLA
// (__float2int_rz / __double2int_rz; a C++ cast overflows undefined).
//
// The windowed form (the blocked route, K15b: pipelinedp_tpu/parallel/
// large_p.py _block_trace, :195-205, whose block rows are rebased to
// spk - base) takes the rows of one partition block: the caller passes
// skey2 + lo and perm + lo, sorted row i belongs to partition
// skey2[i] - base, and rows outside [0, n_partitions) count nowhere. perm
// may be null: sorted row i is then bounded row i (the host-staged
// stream, whose values are already in sorted order). The dense route
// passes base 0 and a permutation.
//
// Three entries:
//   quantile_leaf_counts   the leaf histogram int32[P, L]
//   quantile_level_counts  level l from level l + 1: sums of B children
//   quantile_child_counts  for every (partition, quantile) the counts of
//                          the B children at one level of the node
//                          node[p, q], over the rows below it: all
//                          quantiles in one pass over the rows. The lazy
//                          descent's h passes share a leaf buffer
//                          (int32, one a sorted row): the level-1 pass
//                          gathers each row's value and writes its leaf
//                          (-1 outside [0, P)), levels 2..h read skey2
//                          and the buffer in order, 8 B a row, where the
//                          gather reads two random 8-byte indices and a
//                          random value (the JAX package computes
//                          row_leaf once too, executor.py:403-405, :800)
// Counts are integers, so atomics give the same result in any order. The
// sorted order puts a warp's 32 rows in one or two partitions, where a
// rating-like value falls on a few leaves: the leaf histogram's
// __match_any_sync groups the lanes of equal counters and one lane adds
// the group's size, one atomic per (warp, counter) instead of one a row.
// The child counts count a tile of 2048 rows in shared memory, a few
// partitions' (quantile, child) counts, and flush each with one atomic:
// the match cost a pass more than its reads from the leaf buffer.
//
// Bound: bytes. Each row reads skey2 (4 B), perm and row_perm (8 B each)
// and its value (F), gathered; the histogram is P * L * 4 B, zero-filled
// by the caller. The roll-ups read every level once. A child-count pass
// from the leaf buffer reads skey2 and the buffer (8 B a row).
#include "common.cuh"

namespace {

template <typename F>
struct Rows {
  const int32_t* skey2;
  const long long* perm;
  const long long* row_perm;
  const F* values;
  long long n;
  long long base;  // partition of sorted row i: skey2[i] - base
  int n_partitions;
  int n_leaves;
  F lo, den;  // min_value; the span, or 1 where the span is not > 0

  // The partition of sorted row i, or -1 outside [0, n_partitions).
  __device__ __forceinline__ long long partition(long long i) const {
    const long long p = static_cast<long long>(skey2[i]) - base;
    return p >= 0 && p < n_partitions ? p : -1;
  }

  __device__ __forceinline__ F value(long long i) const {
    long long r = perm ? perm[i] : i;
    if (row_perm) r = row_perm[r];
    return values[r];
  }
};

__device__ __forceinline__ int to_int_rz(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int to_int_rz(double x) {
  return __double2int_rz(x);
}

template <typename F>
__device__ __forceinline__ int leaf_of(const Rows<F>& rows, F v) {
  const F frac = (v - rows.lo) / rows.den;
  const int leaf = to_int_rz(frac * static_cast<F>(rows.n_leaves));
  return leaf < 0 ? 0 : (leaf > rows.n_leaves - 1 ? rows.n_leaves - 1 : leaf);
}

template <typename F>
Rows<F> make_rows(const void* skey2, const void* perm, const void* row_perm,
                  const void* values, long long n, long long base,
                  int n_partitions, int n_leaves, double min_v,
                  double max_v) {
  const F lo = static_cast<F>(min_v);
  const F span = static_cast<F>(max_v) - lo;
  return Rows<F>{static_cast<const int32_t*>(skey2),
                 static_cast<const long long*>(perm),
                 static_cast<const long long*>(row_perm),
                 static_cast<const F*>(values),
                 n,
                 base,
                 n_partitions,
                 n_leaves,
                 lo,
                 span > F(0) ? span : F(1)};
}

// One thread a sorted row; every lane of a warp reaches the match.
template <typename F>
__global__ void leaf_counts_kernel(Rows<F> rows, int* __restrict__ hist) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long key = -1;
  if (i < rows.n) {
    const long long p = rows.partition(i);
    if (p >= 0) key = p * rows.n_leaves + leaf_of(rows, rows.value(i));
  }
  const unsigned peers =
      __match_any_sync(pdp::kFullMask, static_cast<unsigned long long>(key));
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + key, __popc(peers));
}

__global__ void rollup_kernel(const int* __restrict__ finer,
                              int* __restrict__ coarser, long long n_coarse,
                              int branching) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_coarse) return;
  const int* c = finer + i * branching;
  int s = 0;
  for (int b = 0; b < branching; ++b) s += c[b];
  coarser[i] = s;
}

// Where the child counts find a row's leaf: computed from its gathered
// value and written to the leaf buffer, -1 for a row outside
// [0, n_partitions) (kFill), or read from that buffer (kRead: no
// permutation, no value, no float arithmetic).
enum LeafMode { kFill = 1, kRead = 2 };

// A block of the child counts takes kChildTile sorted rows, kChildRows a
// thread (striped), and counts them in shared memory: the sorted rows of a
// tile fall in a few partitions, [lo, hi] of the tile's rows (a block
// reduction, no extra read), whose (quantile, child) counts the block
// flushes with one atomic each. A tile whose partitions' counts exceed
// kHistInts (rows out of order, or many quantiles) adds to the output
// directly. (4 or 16 rows a thread, and a resident grid that loads the
// next tile while it counts this one, each measured slower on the card.)
constexpr int kChildThreads = 256;
constexpr int kChildRows = 8;
constexpr int kChildTile = kChildThreads * kChildRows;
constexpr int kHistInts = 4096;

template <typename F, int kMode>
__global__ void __launch_bounds__(kChildThreads)
    child_counts_kernel(Rows<F> rows, int shift, int branching,
                        const int* __restrict__ node, int n_q,
                        int* __restrict__ leaf_buf,
                        int* __restrict__ counts) {
  __shared__ int hist[kHistInts];
  __shared__ int warp_lo[kChildThreads / 32], warp_hi[kChildThreads / 32];
  const long long tile0 = static_cast<long long>(blockIdx.x) * kChildTile;
  const int group = n_q * branching;  // counts a partition
  // Every row's partition (-1 outside [0, P)) and leaf first, so that
  // their loads (and the gather's chains) are in flight together.
  int p[kChildRows], leaf[kChildRows];
  int lo = 0x7fffffff, hi = -1;
#pragma unroll
  for (int k = 0; k < kChildRows; ++k) {
    const long long i = tile0 + k * kChildThreads + threadIdx.x;
    p[k] = -1;
    leaf[k] = -1;
    if (i < rows.n) {
      p[k] = static_cast<int>(rows.partition(i));
      if constexpr (kMode == kRead) {
        leaf[k] = leaf_buf[i];
      } else if (p[k] >= 0) {
        leaf[k] = leaf_of(rows, rows.value(i));
      }
    }
    if (p[k] >= 0) {
      lo = p[k] < lo ? p[k] : lo;
      hi = p[k] > hi ? p[k] : hi;
    }
  }
  if constexpr (kMode == kFill) {
#pragma unroll
    for (int k = 0; k < kChildRows; ++k) {
      const long long i = tile0 + k * kChildThreads + threadIdx.x;
      if (i < rows.n) leaf_buf[i] = p[k] >= 0 ? leaf[k] : -1;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(pdp::kFullMask, lo, d));
    hi = max(hi, __shfl_xor_sync(pdp::kFullMask, hi, d));
  }
  if ((threadIdx.x & 31) == 0) {
    warp_lo[threadIdx.x >> 5] = lo;
    warp_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kChildThreads / 32; ++w) {
    lo = min(lo, warp_lo[w]);
    hi = max(hi, warp_hi[w]);
  }
  const long long width = static_cast<long long>(hi) - lo + 1;
  const int span = width >= 1 && width * group <= kHistInts
                       ? static_cast<int>(width) : 0;
  const int cover = span * group;
  for (int j = threadIdx.x; j < cover; j += kChildThreads) hist[j] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kChildRows; ++k) {
    if (p[k] < 0 || leaf[k] < 0) continue;
    const int row_node = leaf[k] / shift;
    const int parent = row_node / branching, child = row_node % branching;
    const int* nodes = node + static_cast<long long>(p[k]) * n_q;
    const int slot = p[k] - lo;
    const bool local = slot < span;
    for (int q = 0; q < n_q; ++q) {
      if (nodes[q] != parent) continue;
      if (local) {
        atomicAdd(hist + slot * group + q * branching + child, 1);
      } else {
        atomicAdd(counts + static_cast<long long>(p[k]) * group +
                      q * branching + child, 1);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cover; j += kChildThreads) {
    const int v = hist[j];
    if (v != 0) atomicAdd(counts + static_cast<long long>(lo) * group + j, v);
  }
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

template <typename F>
int launch_leaf(const void* skey2, const void* perm, const void* row_perm,
                const void* values, long long n, long long base,
                int n_partitions, int n_leaves, double min_v, double max_v,
                void* hist, cudaStream_t s) {
  if (n <= 0) return 0;
  const Rows<F> rows = make_rows<F>(skey2, perm, row_perm, values, n, base,
                                    n_partitions, n_leaves, min_v, max_v);
  leaf_counts_kernel<F><<<blocks_for(n, 256), 256, 0, s>>>(
      rows, static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_child(const void* skey2, const void* perm, const void* row_perm,
                 const void* values, long long n, long long base,
                 int n_partitions, int n_leaves, int shift, int branching,
                 const void* node, int n_q, double min_v, double max_v,
                 void* counts, void* leaf_buf, int mode, cudaStream_t s) {
  const Rows<F> rows = make_rows<F>(skey2, perm, row_perm, values, n, base,
                                    n_partitions, n_leaves, min_v, max_v);
  const unsigned blocks = blocks_for(n, kChildTile);
  const int* nodes = static_cast<const int*>(node);
  int* leaf = static_cast<int*>(leaf_buf);
  int* out = static_cast<int*>(counts);
  if (mode == kRead) {
    child_counts_kernel<F, kRead><<<blocks, kChildThreads, 0, s>>>(
        rows, shift, branching, nodes, n_q, leaf, out);
  } else {
    child_counts_kernel<F, kFill><<<blocks, kChildThreads, 0, s>>>(
        rows, shift, branching, nodes, n_q, leaf, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hist: int32[n_partitions, n_leaves], zero-filled by the caller. perm:
// nullable; base: sorted row i's partition is skey2[i] - base.
extern "C" int quantile_leaf_counts(const void* skey2, const void* perm,
                                    const void* row_perm, const void* values,
                                    long long n, long long base,
                                    int n_partitions, int n_leaves,
                                    double min_v, double max_v, void* hist,
                                    int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_leaf<double>(skey2, perm, row_perm, values, n, base,
                                   n_partitions, n_leaves, min_v, max_v,
                                   hist, s)
             : launch_leaf<float>(skey2, perm, row_perm, values, n, base,
                                  n_partitions, n_leaves, min_v, max_v, hist,
                                  s);
}

// levels: tree_height device pointers (a host array), levels[l - 1] =
// int32[n_partitions, B^l]; the last (the leaves) is read, the others are
// written, finest first.
extern "C" int quantile_level_counts(void* const* levels, int n_partitions,
                                     int tree_height, int branching,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long width = 1;
  for (int l = 1; l < tree_height; ++l) width *= branching;
  for (int l = tree_height - 1; l >= 1; --l) {
    const long long n_coarse = static_cast<long long>(n_partitions) * width;
    if (n_coarse > 0) {
      rollup_kernel<<<blocks_for(n_coarse, 256), 256, 0, s>>>(
          static_cast<const int*>(levels[l]), static_cast<int*>(levels[l - 1]),
          n_coarse, branching);
    }
    width /= branching;
  }
  return static_cast<int>(cudaGetLastError());
}

// node: int32[n_partitions, n_q], nodes of level (level - 1); shift =
// B^(h - level); counts: int32[n_partitions, n_q, B], zero-filled by the
// caller. perm / base as for quantile_leaf_counts. leaf_buf: int32[n];
// leaf_mode a LeafMode (kRead reads skey2 and the buffer alone).
extern "C" int quantile_child_counts(const void* skey2, const void* perm,
                                     const void* row_perm, const void* values,
                                     long long n, long long base,
                                     int n_partitions, int n_leaves,
                                     int shift, int branching,
                                     const void* node, int n_q, double min_v,
                                     double max_v, void* counts,
                                     void* leaf_buf, int leaf_mode, int f64,
                                     void* stream) {
  if (n <= 0) return 0;
  if ((leaf_mode != kFill && leaf_mode != kRead) || leaf_buf == nullptr)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_child<double>(skey2, perm, row_perm, values, n, base,
                                    n_partitions, n_leaves, shift, branching,
                                    node, n_q, min_v, max_v, counts, leaf_buf,
                                    leaf_mode, s)
             : launch_child<float>(skey2, perm, row_perm, values, n, base,
                                   n_partitions, n_leaves, shift, branching,
                                   node, n_q, min_v, max_v, counts, leaf_buf,
                                   leaf_mode, s);
}
