// C20 sweep_report: keep probabilities, report rows and their reduction by
// partition-size bucket.
//
// Replaces the rest of K19, pipelinedp_tpu/analysis/kernels.py
// sweep_kernel: the bucket of each partition (:283-285), the windowed keep
// probability (_windowed_keep_prob :167, _keep_prob_batch :116,
// _norm_cdf_skew :160), the per-partition report and info rows
// (error_model.py:113 metric_report_terms, :148 info_terms) and their sums
// over each bucket's partitions (:331-338).
//
// Four launches:
//   1. bucket: searchsorted(bounds, size, side right) - 1, clipped, with
//      the bounds in the working float (jnp.asarray(BUCKET_BOUNDS, f));
//   2. one block groups the partitions by bucket, keeping partition order
//      (each of the <= 32 buckets counts and places its own);
//   3. keep: one thread a (configuration, partition). Private analysis
//      builds the `window` support points mu + (w - (window - 1) / 2) step,
//      step = max(1, 16 sigma / window), takes the skew-corrected normal
//      PMF restricted to [-0.5, n_users + 0.5] and adds pmf x keep over the
//      points in order from 0; sigma = 0 keeps at rint(mu) (jnp.round
//      rounds half to even). The selector runs only its own branch, with
//      the JAX package's sanitized parameters (eps1 and delta1 are the
//      configuration's own when the branch runs), so an unused branch can
//      neither change the value nor leak a NaN. Public analysis keeps 1;
//   4. reduce: one thread a (configuration, bucket, field) walks the
//      bucket's partitions in order and adds that field of each one's
//      report or info row from 0: segment_sum's order on the CPU. A field
//      is recomputed from the statistics where it is added, so the
//      [K, P, M, 24] rows are never written.
// Every expression keeps the JAX package's order of operations; --fmad=false
// keeps each product rounded on its own.
//
// Bound: FP64 (float32) operations: the window's ~2 erfc, ~2 exp and the
// selector's transcendental functions per point, K x P x window points.
#include "common.cuh"

namespace {

constexpr int kStat = 5;
constexpr int kSel = 3;
constexpr int kReport = 24;
constexpr int kInfo = 5;
constexpr int kMaxBuckets = 32;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float erfc_(float x) { return erfcf(x); }
__device__ __forceinline__ double erfc_(double x) { return erfc(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T clip01(T x) {
  return pdp::min_nan(pdp::max_nan(x, T(0)), T(1));
}

// One configuration's selector scalars (kernels.SWEEP_SELECTION).
template <typename T>
struct Selector {
  T kind, pre_shift, eps1, delta1, n_cross, pi_cross, threshold, scale;
};

template <typename T>
__device__ __forceinline__ Selector<T> selector_of(const T* cfg, int n_cfg,
                                                   int k) {
  Selector<T> s;
  s.kind = cfg[k];
  s.pre_shift = cfg[n_cfg + k];
  s.eps1 = cfg[2 * n_cfg + k];
  s.delta1 = cfg[3 * n_cfg + k];
  s.n_cross = cfg[4 * n_cfg + k];
  s.pi_cross = cfg[5 * n_cfg + k];
  s.threshold = cfg[6 * n_cfg + k];
  s.scale = pdp::max_nan(cfg[7 * n_cfg + k], T(1e-30));
  return s;
}

// _keep_prob_batch at one (possibly fractional) privacy-id count x.
template <typename T>
__device__ T keep_at(T x, const Selector<T>& s, T sqrt2) {
  const T n = x - s.pre_shift;
  T p;
  if (s.kind == T(0)) {
    // Truncated geometric (partition_selection.py closed form, log space).
    const T n_eff = pdp::max_nan(n, T(1));
    const T n1 = pdp::min_nan(n_eff, s.n_cross);
    const T log_pi1 = log_(s.delta1) + (n1 - T(1)) * s.eps1 +
                      log1p_(-exp_(-n1 * s.eps1)) - log1p_(-exp_(-s.eps1));
    const T pi1 = exp_(pdp::min_nan(log_pi1, T(0)));
    const T kk = pdp::max_nan(n_eff - s.n_cross, T(0));
    const T decay = exp_(-kk * s.eps1);
    const T geo =
        s.eps1 < T(700)
            ? exp_(-s.eps1) * (T(1) - decay) /
                  (T(1) - exp_(-pdp::min_nan(s.eps1, T(700))))
            : T(0);
    const T q = decay * (T(1) - s.pi_cross) - s.delta1 * geo;
    p = clip01(n_eff <= s.n_cross ? pi1 : T(1) - pdp::max_nan(q, T(0)));
  } else if (s.kind == T(1)) {
    // Laplace thresholding.
    const T z = (n - s.threshold) / s.scale;
    p = z >= T(0) ? T(1) - T(0.5) * exp_(-abs_(z)) : T(0.5) * exp_(-abs_(z));
  } else {
    // Gaussian thresholding.
    const T zg = (s.threshold - n) / s.scale;
    p = T(0.5) * erfc_(zg / sqrt2);
  }
  return n <= T(0) ? T(0) : p;
}

// _norm_cdf_skew.
template <typename T>
__device__ __forceinline__ T norm_cdf_skew(T z, T skew, T sqrt2, T sqrt2pi) {
  const T cdf = T(0.5) * erfc_(-z / sqrt2);
  const T pdf = exp_(T(-0.5) * z * z) / sqrt2pi;
  return clip01(cdf + skew * (T(1) - z * z) * pdf / T(6));
}

template <typename T>
__global__ void size_buckets(const T* __restrict__ size, long long n_parts,
                             const T* __restrict__ bounds, int nb,
                             int32_t* __restrict__ bucket) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_parts) return;
  const T v = size[p];
  int i = 0;  // searchsorted(bounds, v, side="right"): bounds <= v
  while (i < nb && bounds[i] <= v) ++i;
  bucket[p] = min(max(i - 1, 0), nb - 1);
}

// order[0, n_parts): the partitions grouped by bucket, each group in
// partition order; order[n_parts + b]: the first position of bucket b
// (b = 0..nb).
__global__ void group_by_bucket(const int32_t* __restrict__ bucket,
                                long long n_parts, int nb,
                                int32_t* __restrict__ order) {
  __shared__ long long counts[kMaxBuckets];
  __shared__ long long starts[kMaxBuckets + 1];
  const int b = threadIdx.x;
  long long c = 0;
  if (b < nb)
    for (long long p = 0; p < n_parts; ++p) c += bucket[p] == b;
  counts[b] = c;
  __syncthreads();
  if (b == 0) {
    starts[0] = 0;
    for (int j = 0; j < nb; ++j) starts[j + 1] = starts[j] + counts[j];
    for (int j = 0; j <= nb; ++j)
      order[n_parts + j] = static_cast<int32_t>(starts[j]);
  }
  __syncthreads();
  if (b < nb) {
    long long at = starts[b];
    for (long long p = 0; p < n_parts; ++p)
      if (bucket[p] == b) order[at++] = static_cast<int32_t>(p);
  }
}

template <typename T>
__global__ void keep_probs(const T* __restrict__ sel,
                           const T* __restrict__ n_users,
                           const T* __restrict__ cfg, int n_cfg,
                           long long n_parts, int window, int pub,
                           T* __restrict__ keep_prob) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_cfg) * n_parts) return;
  if (pub) {
    keep_prob[t] = T(1);
    return;
  }
  const int k = static_cast<int>(t / n_parts);
  const long long p = t - static_cast<long long>(k) * n_parts;
  const Selector<T> s = selector_of(cfg, n_cfg, k);
  // jnp.sqrt of a Python float, in the working float.
  const T sqrt2 = pdp::sqrt_(T(2));
  const T sqrt2pi = pdp::sqrt_(T(2.0 * 3.141592653589793));
  const T mu = sel[t * kSel], var = sel[t * kSel + 1],
          third = sel[t * kSel + 2];
  const T sigma = pdp::sqrt_(pdp::max_nan(var, T(0)));
  T out;
  if (sigma > T(0)) {
    const T safe_sigma = pdp::max_nan(sigma, T(1e-30));
    const T skew = third / (safe_sigma * safe_sigma * safe_sigma);
    const T step = pdp::max_nan(T(1), T(16) * sigma / T(window));
    const T half = T(window - 1) / T(2);
    const T top = n_users[p] + T(0.5);
    T p_win = T(0);
    for (int w = 0; w < window; ++w) {
      const T xs = mu + (T(w) - half) * step;
      const T z_hi = (xs + T(0.5) * step - mu) / safe_sigma;
      const T z_lo = (xs - T(0.5) * step - mu) / safe_sigma;
      T pmf = pdp::max_nan(norm_cdf_skew(z_hi, skew, sqrt2, sqrt2pi) -
                               norm_cdf_skew(z_lo, skew, sqrt2, sqrt2pi),
                           T(0));
      // Support restricted to [0, n_users] like the host PMF.
      if (!(xs > T(-0.5) && xs <= top)) pmf = T(0);
      p_win += pmf * keep_at(xs, s, sqrt2);
    }
    out = p_win;
  } else {
    // Degenerate sigma: all-or-nothing ids, the PMF concentrated at mu.
    out = keep_at(pdp::rint_(mu), s, sqrt2);
  }
  keep_prob[t] = clip01(out);
}

// Field f of partition p's report row for metric m
// (error_model.metric_report_terms; weight = the keep probability).
template <typename T>
__device__ __forceinline__ T report_field(const T* st, T kp, T ns, int f) {
  const T raw = st[0], mn = st[1], mx = st[2], l0m = st[3], l0v = st[4];
  const T w = kp;
  if (f >= 20) {
    const T drop_l0 = -l0m;
    const T drop_linf = mn - mx;
    if (f == 20) return drop_l0;
    if (f == 21) return drop_linf;
    if (f == 22) return (raw - drop_l0 - drop_linf) * (T(1) - kp);
    return raw;
  }
  const bool rel = f >= 10;
  const int g = rel ? f - 10 : f;
  if (g == 4 || g == 5) return T(0) * w;
  const T inv = raw != T(0) ? T(1) / raw : T(0);
  const T inv2 = inv * inv;
  T v;
  if (g == 6) {
    v = rel ? l0m * inv : l0m;
  } else if (g == 7) {
    v = rel ? l0v * inv2 : l0v;
  } else if (g == 8) {
    v = rel ? mn * inv : mn;
  } else if (g == 9) {
    v = rel ? mx * inv : mx;
  } else {
    const T mean = l0m + mn + mx;
    const T var = l0v + ns * ns;
    if (g == 0) {
      v = rel ? mean * inv : mean;
    } else if (g == 1) {
      v = rel ? var * inv2 : var;
    } else {
      const T rmse = pdp::sqrt_(mean * mean + var);
      if (g == 2) {
        v = rel ? rmse * inv : rmse;
      } else {
        const T rmse_drop = kp * rmse + (T(1) - kp) * abs_(raw);
        v = rel ? rmse_drop * inv : rmse_drop;
      }
    }
  }
  return v * w;
}

// Field f of partition p's info row (error_model.info_terms).
template <typename T>
__device__ __forceinline__ T info_field(T users, T kp, int pub, int f) {
  const T w = kp;
  if (pub) {
    const T non_empty = users > T(0) ? T(1) : T(0);
    if (f == 0) return non_empty;
    if (f == 1) return T(1) - non_empty;
    if (f == 4) return T(1) * w;
    return T(0);
  }
  if (f == 0) return T(1);
  if (f == 1) return T(0);
  if (f == 2) return kp;
  if (f == 3) return kp * (T(1) - kp);
  return w * T(1);
}

template <typename T>
__global__ void bucket_sums(const T* __restrict__ stats,
                            const T* __restrict__ n_users,
                            const T* __restrict__ keep_prob,
                            const T* __restrict__ noise_std,
                            const int32_t* __restrict__ order, int n_cfg,
                            long long n_parts, int n_metrics, int ms, int nb,
                            int pub, T* __restrict__ bucket_rows,
                            T* __restrict__ bucket_info) {
  const int width = n_metrics * kReport + kInfo;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_cfg) * nb * width) return;
  const int f = static_cast<int>(t % width);
  const int b = static_cast<int>((t / width) % nb);
  const int k = static_cast<int>(t / (static_cast<long long>(width) * nb));
  const long long begin = order[n_parts + b], end = order[n_parts + b + 1];
  const T* kp_row = keep_prob + static_cast<long long>(k) * n_parts;
  T acc = T(0);
  if (f < n_metrics * kReport) {
    const int m = f / kReport, g = f % kReport;
    const T ns = noise_std[static_cast<long long>(k) * ms + m];
    const T* st_k = stats + static_cast<long long>(k) * n_parts * n_metrics *
                                kStat;
    for (long long j = begin; j < end; ++j) {
      const long long p = order[j];
      acc += report_field(st_k + (p * n_metrics + m) * kStat, kp_row[p], ns,
                          g);
    }
    bucket_rows[((static_cast<long long>(k) * nb + b) * n_metrics + m) *
                    kReport +
                g] = acc;
  } else {
    const int g = f - n_metrics * kReport;
    for (long long j = begin; j < end; ++j) {
      const long long p = order[j];
      acc += info_field(n_users[p], kp_row[p], pub, g);
    }
    bucket_info[(static_cast<long long>(k) * nb + b) * kInfo + g] = acc;
  }
}

unsigned blocks_for(long long n, int block) {
  return static_cast<unsigned>((n + block - 1) / block);
}

template <typename T>
int launch(const void* stats, const void* sel, const void* n_users,
           const void* size, const void* noise_std, const void* sel_cfg,
           const void* bounds, int n_cfg, long long n_parts, int n_metrics,
           int ms, int nb, int pub, int window, void* order, void* bucket,
           void* keep_prob, void* bucket_rows, void* bucket_info,
           cudaStream_t s) {
  constexpr int kBlock = 256;
  int32_t* ord = static_cast<int32_t*>(order);
  int32_t* bk = static_cast<int32_t*>(bucket);
  if (n_parts > 0)
    size_buckets<T><<<blocks_for(n_parts, kBlock), kBlock, 0, s>>>(
        static_cast<const T*>(size), n_parts, static_cast<const T*>(bounds),
        nb, bk);
  group_by_bucket<<<1, kMaxBuckets, 0, s>>>(bk, n_parts, nb, ord);
  const long long kp = static_cast<long long>(n_cfg) * n_parts;
  if (kp > 0)
    keep_probs<T><<<blocks_for(kp, 128), 128, 0, s>>>(
        static_cast<const T*>(sel), static_cast<const T*>(n_users),
        static_cast<const T*>(sel_cfg), n_cfg, n_parts, window, pub,
        static_cast<T*>(keep_prob));
  const long long fields =
      static_cast<long long>(n_cfg) * nb * (n_metrics * kReport + kInfo);
  if (fields > 0)
    bucket_sums<T><<<blocks_for(fields, kBlock), kBlock, 0, s>>>(
        static_cast<const T*>(stats), static_cast<const T*>(n_users),
        static_cast<const T*>(keep_prob), static_cast<const T*>(noise_std),
        ord, n_cfg, n_parts, n_metrics, ms, nb, pub,
        static_cast<T*>(bucket_rows), static_cast<T*>(bucket_info));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats: T[n_cfg, n_parts, n_metrics, 5]; sel: T[n_cfg, n_parts, 3] (null
// when pub); n_users, size: T[n_parts]; noise_std: T[n_cfg, ms]; sel_cfg:
// T[8, n_cfg]; bounds: T[nb], nb <= 32; order: int32[n_parts + nb + 1]
// scratch. Outputs: bucket int32[n_parts]; keep_prob T[n_cfg, n_parts];
// bucket_rows T[n_cfg, nb, n_metrics, 24]; bucket_info T[n_cfg, nb, 5].
extern "C" int sweep_report(const void* stats, const void* sel,
                            const void* n_users, const void* size,
                            const void* noise_std, const void* sel_cfg,
                            const void* bounds, int n_cfg, long long n_parts,
                            int n_metrics, int ms, int nb, int pub,
                            int window, int f64, void* order, void* bucket,
                            void* keep_prob, void* bucket_rows,
                            void* bucket_info, void* stream) {
  if (nb < 1 || nb > kMaxBuckets || n_parts >= (1LL << 31) || window < 1)
    return 1;  // cudaErrorInvalidValue
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(stats, sel, n_users, size, noise_std, sel_cfg,
                              bounds, n_cfg, n_parts, n_metrics, ms, nb, pub,
                              window, order, bucket, keep_prob, bucket_rows,
                              bucket_info, s)
             : launch<float>(stats, sel, n_users, size, noise_std, sel_cfg,
                             bounds, n_cfg, n_parts, n_metrics, ms, nb, pub,
                             window, order, bucket, keep_prob, bucket_rows,
                             bucket_info, s);
}
