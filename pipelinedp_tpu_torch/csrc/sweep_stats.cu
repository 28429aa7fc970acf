// C19 sweep_stats: the utility-analysis sweep's per-partition sufficient
// statistics.
//
// Replaces the segment sums of K19, pipelinedp_tpu/analysis/kernels.py
// sweep_kernel (:220, :262-322): per configuration k and preaggregated row
// (one privacy id's contribution to one partition) the l0 keep fraction
// q = keep_fraction(contributed, l0[k]) (error_model.py:70), the five
// metric terms of every metric (:79: raw, clipping to min and max, the l0
// bounding error's mean and variance) and, for private analysis, the three
// Bernoulli moments of q (:106), each summed over the partition's rows;
// per partition the rows (n_users), the counts (n_rows) and the first
// metric's raw sum (size; n_users without metrics).
//
// The rows arrive ordered by partition (C5's stable permutation) with each
// partition's run [offsets[p], offsets[p + 1]) (C10 at the boundaries
// 0..P), so rows outside [0, P) are never read. A first pass gathers the
// three row columns into that order. Then one thread owns one
// (configuration, partition) and walks the partition's rows in row order,
// computing the terms on the fly and adding them from 0: the order of
// jax.ops.segment_sum on the CPU (a scatter-add over the rows in order), so
// the statistics are bit-equal to the JAX package's there; no [K, N, 5]
// term tensor exists, and no float atomics reorder a sum from run to run.
// A warp holds 32 configurations of one partition, so its lanes read the
// same row at once (one broadcast load) and differ only in their
// parameters.
//
// Bound: FP64 (float32) operations at full width: ~25 operations a metric
// and ~6 for the moments, per row and configuration, against N x 24 bytes
// of rows read once. A hot partition is one long serial walk (Netflix's top
// movie holds ~10^5 rows): the kernel's time is at least that walk's.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;     // configurations a warp
constexpr int kParts = 4;      // partitions a block (warps)
constexpr int kMaxMetrics = 3;
constexpr int kStat = 5;
constexpr int kSel = 3;

template <typename T>
__global__ void gather_rows3(const long long* __restrict__ perm, long long n,
                             const T* __restrict__ a, const T* __restrict__ b,
                             const T* __restrict__ c, T* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = perm[i];
  out[i] = a[r];
  out[n + i] = b[r];
  out[2 * n + i] = c[r];
}

// The metric's per-row value: SUM the sum, COUNT the count,
// PRIVACY_ID_COUNT 1 where the count is positive.
template <typename T>
__device__ __forceinline__ T metric_value(int code, T count, T sum) {
  if (code == 0) return sum;
  if (code == 1) return count;
  return count > T(0) ? T(1) : T(0);
}

template <typename T>
__global__ void partition_stats(const T* __restrict__ rows, long long n,
                                const long long* __restrict__ offsets,
                                long long n_parts, int n_cfg,
                                const T* __restrict__ l0,
                                const T* __restrict__ lo,
                                const T* __restrict__ hi, int ms,
                                int n_metrics, int code0, int code1,
                                int code2, int priv, T* __restrict__ stats,
                                T* __restrict__ sel, T* __restrict__ n_users,
                                T* __restrict__ n_rows,
                                T* __restrict__ size) {
  const int k = blockIdx.y * kLanes + threadIdx.x;
  const long long p =
      static_cast<long long>(blockIdx.x) * kParts + threadIdx.y;
  if (k >= n_cfg || p >= n_parts) return;
  const int codes[kMaxMetrics] = {code0, code1, code2};
  const T* counts = rows;
  const T* sums = rows + n;
  const T* contributed = rows + 2 * n;
  const T l0k = l0[k];
  T lok[kMaxMetrics], hik[kMaxMetrics];
  T acc[kMaxMetrics][kStat];
#pragma unroll
  for (int m = 0; m < kMaxMetrics; ++m) {
    lok[m] = m < n_metrics ? lo[static_cast<long long>(k) * ms + m] : T(0);
    hik[m] = m < n_metrics ? hi[static_cast<long long>(k) * ms + m] : T(0);
#pragma unroll
    for (int j = 0; j < kStat; ++j) acc[m][j] = T(0);
  }
  T mu = T(0), var = T(0), skew3 = T(0);
  T users = T(0), total = T(0), first = T(0);
  const bool lead = k == 0;
  const long long begin = offsets[p], end = offsets[p + 1];
  for (long long i = begin; i < end; ++i) {
    const T count = counts[i], sum = sums[i], np = contributed[i];
    // error_model.keep_fraction: where(n > 0, min(1, l0 / max(n, 1)), 0).
    const T safe_n = pdp::max_nan(np, T(1));
    const T q = np > T(0) ? pdp::min_nan(T(1), l0k / safe_n) : T(0);
    const T drop_q = T(1) - q;
#pragma unroll
    for (int m = 0; m < kMaxMetrics; ++m) {
      if (m >= n_metrics) break;
      // error_model.metric_stat_terms, in its order of operations.
      const T v = metric_value(codes[m], count, sum);
      const T clipped = pdp::min_nan(pdp::max_nan(v, lok[m]), hik[m]);
      const T err = clipped - v;
      acc[m][0] += v;
      acc[m][1] += v < lok[m] ? err : T(0);
      acc[m][2] += v > hik[m] ? err : T(0);
      acc[m][3] += -clipped * drop_q;
      acc[m][4] += clipped * clipped * q * drop_q;
    }
    if (priv) {
      // error_model.selection_moment_terms.
      const T centered = q * drop_q;
      mu += q;
      var += centered;
      skew3 += centered * (T(1) - T(2) * q);
    }
    if (lead) {
      users += T(1);
      total += count;
      if (n_metrics > 0) first += metric_value(code0, count, sum);
    }
  }
  const long long kp = static_cast<long long>(k) * n_parts + p;
#pragma unroll
  for (int m = 0; m < kMaxMetrics; ++m) {
    if (m >= n_metrics) break;
    T* out = stats + (kp * n_metrics + m) * kStat;
#pragma unroll
    for (int j = 0; j < kStat; ++j) out[j] = acc[m][j];
  }
  if (priv) {
    sel[kp * kSel] = mu;
    sel[kp * kSel + 1] = var;
    sel[kp * kSel + 2] = skew3;
  }
  if (lead) {
    n_users[p] = users;
    n_rows[p] = total;
    size[p] = n_metrics > 0 ? first : users;
  }
}

template <typename T>
int launch(const void* counts, const void* sums, const void* contributed,
           const void* perm, long long n, const void* offsets,
           long long n_parts, const void* l0, const void* lo, const void* hi,
           int n_cfg, int ms, int n_metrics, const int* codes, int priv,
           void* scratch, void* stats, void* sel, void* n_users,
           void* n_rows, void* size, cudaStream_t s) {
  T* rows = static_cast<T*>(scratch);
  if (n > 0) {
    constexpr int kBlock = 256;
    gather_rows3<T><<<static_cast<unsigned>((n + kBlock - 1) / kBlock),
                      kBlock, 0, s>>>(
        static_cast<const long long*>(perm), n,
        static_cast<const T*>(counts), static_cast<const T*>(sums),
        static_cast<const T*>(contributed), rows);
  }
  if (n_parts > 0 && n_cfg > 0) {
    const dim3 block(kLanes, kParts);
    const dim3 grid(static_cast<unsigned>((n_parts + kParts - 1) / kParts),
                    static_cast<unsigned>((n_cfg + kLanes - 1) / kLanes));
    partition_stats<T><<<grid, block, 0, s>>>(
        rows, n, static_cast<const long long*>(offsets), n_parts, n_cfg,
        static_cast<const T*>(l0), static_cast<const T*>(lo),
        static_cast<const T*>(hi), ms, n_metrics, codes[0], codes[1],
        codes[2], priv, static_cast<T*>(stats), static_cast<T*>(sel),
        static_cast<T*>(n_users), static_cast<T*>(n_rows),
        static_cast<T*>(size));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// counts, sums, contributed: T[n] (T double when f64, else float); perm:
// int64[n], the stable order by partition; offsets: int64[n_parts + 1];
// l0: T[n_cfg]; lo, hi: T[n_cfg, ms]; codes: int[3], the first n_metrics
// used; scratch: T[3, n]. Outputs: stats T[n_cfg, n_parts, n_metrics, 5];
// sel T[n_cfg, n_parts, 3] (written when priv); n_users, n_rows, size
// T[n_parts].
extern "C" int sweep_stats(const void* counts, const void* sums,
                           const void* contributed, const void* perm,
                           long long n, const void* offsets,
                           long long n_parts, const void* l0, const void* lo,
                           const void* hi, int n_cfg, int ms, int n_metrics,
                           const int* codes, int priv, int f64,
                           void* scratch, void* stats, void* sel,
                           void* n_users, void* n_rows, void* size,
                           void* stream) {
  if (n_metrics < 0 || n_metrics > kMaxMetrics) return 1;  // invalid value
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(counts, sums, contributed, perm, n, offsets,
                              n_parts, l0, lo, hi, n_cfg, ms, n_metrics,
                              codes, priv, scratch, stats, sel, n_users,
                              n_rows, size, s)
             : launch<float>(counts, sums, contributed, perm, n, offsets,
                             n_parts, l0, lo, hi, n_cfg, ms, n_metrics, codes,
                             priv, scratch, stats, sel, n_users, n_rows, size,
                             s);
}
