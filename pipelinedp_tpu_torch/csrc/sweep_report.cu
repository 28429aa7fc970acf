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
// Two launches:
//   1. tile_sums: a block a (configuration, tile of partitions), a thread a
//      partition of each 256-partition round of its tile. The thread takes
//      its partition's bucket (searchsorted(bounds, size, side right) - 1,
//      clipped, with the bounds in the working float), its keep probability
//      (private analysis: the `window` support points mu + (w - (window -
//      1) / 2) step, step = max(1, 16 sigma / window), the skew-corrected
//      normal PMF restricted to [-0.5, n_users + 0.5], pmf x keep added over
//      the points in order from 0; sigma = 0 keeps at rint(mu), jnp.round
//      rounding half to even; public analysis keeps 1) and its report and
//      info rows (from the statistics; never written to device memory),
//      a metric's 24 fields at a time into shared memory. Each (bucket,
//      field) is reduced within the tile in a fixed order: lane g of a
//      warp adds field g over each of the warp's buckets, the bucket's
//      lanes in lane order from 0; the block adds the warps' sums in warp
//      order; the rounds follow in order. Each value is computed and read
//      once, whatever the number of buckets a warp holds, and the grid is
//      the configurations x tiles whatever the sizes' distribution. The
//      tile's sums of the buckets it holds go to scratch, with a mask of
//      those buckets;
//   2. bucket_totals: a thread a (configuration, bucket, field) adds the
//      tiles' sums in tile order from 0 (skipping tiles without the
//      bucket) into bucket_rows and bucket_info.
// No float atomics: a call gives the same bits every time. The order of the
// bucket sums is not segment_sum's on the CPU; a fixed tree over <= 2^31
// terms is within ~1e-12 of it in float64.
// The selector runs only its own branch (and, for the truncated geometric,
// only the side of n_cross it needs), with the JAX package's sanitized
// parameters (eps1 and delta1 are the configuration's own when the branch
// runs), so an unused branch can neither change the value nor leak a NaN;
// a point with n <= 0 keeps 0 before any branch is evaluated (the JAX
// package's where). The per-configuration terms of the truncated
// geometric (log delta1, log1p(-exp(-eps1)), exp(-eps1) and the geometric
// denominator) are computed once a thread: the same calls on the same
// inputs. Every expression keeps the JAX package's order of operations,
// both CDFs of every window point included (sharing a point's upper CDF
// with the next point's lower one moves the keep probability by up to
// ~5e-10 where sigma is tiny and mu near a boundary, beyond the 1e-9 gate
// of the report fields that carry 1 - keep_prob); --fmad=false keeps each
// product rounded on its own.
//
// Bound: FP64 (float32) operations: the window's 2 erfc, 2 exp and the
// selector's transcendental functions per point, K x P x window points.
#include "common.cuh"

namespace {

constexpr int kStat = 5;
constexpr int kSel = 3;
constexpr int kReport = 24;
constexpr int kInfo = 5;
constexpr int kMaxBuckets = 32;
constexpr int kMaxMetrics = 3;
constexpr int kThreads = 256;  // partitions a round of a tile
constexpr int kWarps = kThreads / 32;
// Fields a pass holds: a metric's report (float32) or half of it
// (float64), kGroup<T> x (kThreads + 1) values, ~25 KB.
template <typename T>
constexpr int kGroup = sizeof(T) == 4 ? kReport : kReport / 2;
// Blocks an SM holds: the window's float64 arithmetic wants the threads
// (64 registers a thread; at most ~44 KB of shared memory a block).
constexpr int kBlocksPerSm = 4;
// Blocks a call aims at: a configuration's tiles are the partitions'
// 256-partition rounds, joined R at a time so that K x tiles stays near
// this (the scratch is K x tiles x buckets x fields).
constexpr long long kTargetBlocks = 4096;

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

// One configuration's selector scalars (kernels.SWEEP_SELECTION) and the
// truncated geometric's per-configuration terms.
template <typename T>
struct Selector {
  T kind, pre_shift, eps1, delta1, n_cross, pi_cross, threshold, scale;
  T log_delta1, log1p_e, exp_e, geo_den;
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
  if (s.kind == T(0)) {
    s.log_delta1 = log_(s.delta1);
    s.log1p_e = log1p_(-exp_(-s.eps1));
    s.exp_e = exp_(-s.eps1);
    s.geo_den = T(1) - exp_(-pdp::min_nan(s.eps1, T(700)));
  }
  return s;
}

// _keep_prob_batch at one (possibly fractional) privacy-id count x.
template <typename T>
__device__ T keep_at(T x, const Selector<T>& s, T sqrt2) {
  const T n = x - s.pre_shift;
  if (n <= T(0)) return T(0);
  if (s.kind == T(0)) {
    // Truncated geometric (partition_selection.py closed form, log space).
    const T n_eff = pdp::max_nan(n, T(1));
    if (n_eff <= s.n_cross) {
      const T n1 = pdp::min_nan(n_eff, s.n_cross);
      const T log_pi1 = s.log_delta1 + (n1 - T(1)) * s.eps1 +
                        log1p_(-exp_(-n1 * s.eps1)) - s.log1p_e;
      return clip01(exp_(pdp::min_nan(log_pi1, T(0))));
    }
    const T kk = pdp::max_nan(n_eff - s.n_cross, T(0));
    const T decay = exp_(-kk * s.eps1);
    const T geo =
        s.eps1 < T(700) ? s.exp_e * (T(1) - decay) / s.geo_den : T(0);
    const T q = decay * (T(1) - s.pi_cross) - s.delta1 * geo;
    return clip01(T(1) - pdp::max_nan(q, T(0)));
  }
  if (s.kind == T(1)) {
    // Laplace thresholding.
    const T z = (n - s.threshold) / s.scale;
    return z >= T(0) ? T(1) - T(0.5) * exp_(-abs_(z))
                     : T(0.5) * exp_(-abs_(z));
  }
  // Gaussian thresholding.
  const T zg = (s.threshold - n) / s.scale;
  return T(0.5) * erfc_(zg / sqrt2);
}

// _norm_cdf_skew.
template <typename T>
__device__ __forceinline__ T norm_cdf_skew(T z, T skew, T sqrt2, T sqrt2pi) {
  const T cdf = T(0.5) * erfc_(-z / sqrt2);
  const T pdf = exp_(T(-0.5) * z * z) / sqrt2pi;
  return clip01(cdf + skew * (T(1) - z * z) * pdf / T(6));
}

// _windowed_keep_prob of one (configuration, partition).
template <typename T>
__device__ T keep_prob_of(const T* sel, T users, int window,
                          const Selector<T>& s) {
  // jnp.sqrt of a Python float, in the working float.
  const T sqrt2 = pdp::sqrt_(T(2));
  const T sqrt2pi = pdp::sqrt_(T(2.0 * 3.141592653589793));
  const T mu = sel[0], var = sel[1], third = sel[2];
  const T sigma = pdp::sqrt_(pdp::max_nan(var, T(0)));
  if (!(sigma > T(0))) {
    // Degenerate sigma: all-or-nothing ids, the PMF concentrated at mu.
    return clip01(keep_at(pdp::rint_(mu), s, sqrt2));
  }
  const T safe_sigma = pdp::max_nan(sigma, T(1e-30));
  const T skew = third / (safe_sigma * safe_sigma * safe_sigma);
  const T step = pdp::max_nan(T(1), T(16) * sigma / T(window));
  const T half = T(window - 1) / T(2);
  const T top = users + T(0.5);
  T p_win = T(0);
  for (int w = 0; w < window; ++w) {
    const T xs = mu + (T(w) - half) * step;
    const T z_hi = (xs + T(0.5) * step - mu) / safe_sigma;
    const T z_lo = (xs - T(0.5) * step - mu) / safe_sigma;
    // Support restricted to [0, n_users] like the host PMF (a point
    // outside it takes pmf 0 whatever its CDFs, so they are not taken).
    const T pmf =
        xs > T(-0.5) && xs <= top
            ? pdp::max_nan(norm_cdf_skew(z_hi, skew, sqrt2, sqrt2pi) -
                               norm_cdf_skew(z_lo, skew, sqrt2, sqrt2pi),
                           T(0))
            : T(0);
    p_win += pmf * keep_at(xs, s, sqrt2);
  }
  return clip01(p_win);
}

// A partition's report row for one metric (error_model.metric_report_terms;
// weight = the keep probability), from its five statistics: the terms
// every field shares, computed once, then field g.
template <typename T>
struct Report {
  T raw, mn, mx, l0m, l0v, kp, inv, inv2, mean, var, rmse, rmse_drop;
};

template <typename T>
__device__ __forceinline__ Report<T> report_of(const T* st, T kp, T ns) {
  Report<T> r;
  r.raw = st[0];
  r.mn = st[1];
  r.mx = st[2];
  r.l0m = st[3];
  r.l0v = st[4];
  r.kp = kp;
  r.inv = r.raw != T(0) ? T(1) / r.raw : T(0);
  r.inv2 = r.inv * r.inv;
  r.mean = r.l0m + r.mn + r.mx;
  r.var = r.l0v + ns * ns;
  r.rmse = pdp::sqrt_(r.mean * r.mean + r.var);
  r.rmse_drop = kp * r.rmse + (T(1) - kp) * abs_(r.raw);
  return r;
}

template <typename T>
__device__ __forceinline__ T report_field(const Report<T>& r, int g) {
  const T w = r.kp;
  if (g >= 20) {
    const T drop_l0 = -r.l0m;
    const T drop_linf = r.mn - r.mx;
    if (g == 20) return drop_l0;
    if (g == 21) return drop_linf;
    if (g == 22) return (r.raw - drop_l0 - drop_linf) * (T(1) - r.kp);
    return r.raw;
  }
  const bool rel = g >= 10;
  if (rel) g -= 10;
  if (g == 4 || g == 5) return T(0) * w;
  T v;
  if (g == 6) {
    v = rel ? r.l0m * r.inv : r.l0m;
  } else if (g == 7) {
    v = rel ? r.l0v * r.inv2 : r.l0v;
  } else if (g == 8) {
    v = rel ? r.mn * r.inv : r.mn;
  } else if (g == 9) {
    v = rel ? r.mx * r.inv : r.mx;
  } else if (g == 0) {
    v = rel ? r.mean * r.inv : r.mean;
  } else if (g == 1) {
    v = rel ? r.var * r.inv2 : r.var;
  } else if (g == 2) {
    v = rel ? r.rmse * r.inv : r.rmse;
  } else {
    v = rel ? r.rmse_drop * r.inv : r.rmse_drop;
  }
  return v * w;
}

// Field g of a partition's info row (error_model.info_terms).
template <typename T>
__device__ __forceinline__ T info_field(T users, T kp, int pub, int g) {
  const T w = kp;
  if (pub) {
    const T non_empty = users > T(0) ? T(1) : T(0);
    if (g == 0) return non_empty;
    if (g == 1) return T(1) - non_empty;
    if (g == 4) return T(1) * w;
    return T(0);
  }
  if (g == 0) return T(1);
  if (g == 1) return T(0);
  if (g == 2) return kp;
  if (g == 3) return kp * (T(1) - kp);
  return w * T(1);
}

struct Plan {
  long long tiles;       // tiles a configuration
  long long tile_parts;  // partitions a tile (a multiple of kThreads)
  size_t part_bytes;     // the tiles' sums, then their bucket masks
};

Plan plan_of(int n_cfg, long long n_parts, int n_metrics, int nb, int f64) {
  Plan p{};
  const long long rounds = (n_parts + kThreads - 1) / kThreads;
  const long long cfgs = n_cfg > 0 ? n_cfg : 1;
  const long long most = (kTargetBlocks + cfgs - 1) / cfgs;
  const long long per_tile = rounds > 0 ? (rounds + most - 1) / most : 1;
  p.tile_parts = per_tile * kThreads;
  p.tiles = (n_parts + p.tile_parts - 1) / p.tile_parts;
  const size_t fields = static_cast<size_t>(n_metrics) * kReport + kInfo;
  p.part_bytes = pdp::align_up(static_cast<size_t>(cfgs) * p.tiles * nb *
                               fields * (f64 ? 8 : 4));
  return p;
}

// Bytes of tile_sums' dynamic shared memory: the tile's sums [nb, fields]
// and a pass's field values [kGroup<T>, kThreads + 1].
template <typename T>
size_t tile_smem(int nb, int fields) {
  return (static_cast<size_t>(nb) * fields +
          static_cast<size_t>(kGroup<T>) * (kThreads + 1)) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    tile_sums(const T* __restrict__ stats, const T* __restrict__ sel,
              const T* __restrict__ n_users, const T* __restrict__ size,
              const T* __restrict__ noise_std, const T* __restrict__ cfg,
              const T* __restrict__ bounds, int n_cfg, long long n_parts,
              int n_metrics, int ms, int nb, int pub, int window,
              long long tiles, long long tile_parts,
              int32_t* __restrict__ bucket, T* __restrict__ keep_prob,
              T* __restrict__ part, unsigned* __restrict__ part_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned wmask[kWarps];
  __shared__ unsigned lmask[kWarps][kMaxBuckets];  // a bucket's lanes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = blockIdx.x % tiles;
  const int k = static_cast<int>(blockIdx.x / tiles);
  const bool has_cfg = k < n_cfg;
  const int fields = n_metrics * kReport + kInfo;
  T* acc = reinterpret_cast<T*>(smem);  // [nb, fields]
  T* vals = acc + nb * fields;          // [kGroup<T>, kThreads + 1]
  constexpr int group = kGroup<T>;
  constexpr int per_metric = kReport / group;
  const long long begin = tile * tile_parts;
  const long long end =
      begin + tile_parts < n_parts ? begin + tile_parts : n_parts;
  Selector<T> s{};
  if (has_cfg && !pub) s = selector_of(cfg, n_cfg, k);
  unsigned tile_mask = 0u;
  for (long long p0 = begin; p0 < end; p0 += kThreads) {
    const long long p = p0 + threadIdx.x;
    const bool valid = p < end;
    int b = 0;
    T kp = T(1), users = T(0);
    if (valid) {
      const T v = size[p];
      int i = 0;  // searchsorted(bounds, v, side="right"): bounds <= v
      while (i < nb && __ldg(bounds + i) <= v) ++i;
      b = min(max(i - 1, 0), nb - 1);
      if (k == 0) bucket[p] = b;
      users = n_users[p];
      if (has_cfg) {
        const long long kp_at = static_cast<long long>(k) * n_parts + p;
        if (!pub) kp = keep_prob_of(sel + kp_at * kSel, users, window, s);
        keep_prob[kp_at] = kp;
      }
    }
    if (!has_cfg) continue;
    // The warp's buckets and each one's lanes.
    const unsigned wm =
        __reduce_or_sync(pdp::kFullMask, valid ? 1u << b : 0u);
    for (unsigned todo = wm; todo; todo &= todo - 1) {
      const int bb = __ffs(todo) - 1;
      const unsigned lanes = __ballot_sync(pdp::kFullMask, valid && b == bb);
      if (lane == 0) lmask[warp][bb] = lanes;
    }
    if (lane == 0) wmask[warp] = wm;
    __syncthreads();
    unsigned round_mask = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) round_mask |= wmask[w];
    const int n_buckets = __popc(round_mask);
    // Passes of `group` fields (a metric's 24 report fields in one or two,
    // then the 5 info fields): each thread writes its partition's values,
    // lane g of a warp adds field g over each of the warp's buckets in
    // lane order into the bucket's first lane, and the block adds the
    // warps' sums in warp order into the tile's.
    Report<T> r{};
    for (int pass = 0; pass <= per_metric * n_metrics; ++pass) {
      const bool info = pass == per_metric * n_metrics;
      const int m = pass / per_metric, part = pass % per_metric;
      const int width = info ? kInfo : group;
      const int f0 = info ? n_metrics * kReport : m * kReport + part * group;
      if (valid) {
        T* col = vals + threadIdx.x;
        if (info) {
#pragma unroll
          for (int g = 0; g < kInfo; ++g)
            col[g * (kThreads + 1)] = info_field(users, kp, pub, g);
        } else {
          if (part == 0) {
            T st[kStat];
            const T* sp = stats + ((static_cast<long long>(k) * n_parts +
                                    p) * n_metrics + m) * kStat;
#pragma unroll
            for (int j = 0; j < kStat; ++j) st[j] = sp[j];
            r = report_of(st, kp,
                          noise_std[static_cast<long long>(k) * ms + m]);
          }
#pragma unroll
          for (int g = 0; g < group; ++g)
            col[g * (kThreads + 1)] = report_field(r, part * group + g);
        }
      }
      __syncwarp();
      if (lane < width) {
        T* row = vals + lane * (kThreads + 1) + warp * 32;
        for (unsigned todo = wm; todo; todo &= todo - 1) {
          const unsigned lanes = lmask[warp][__ffs(todo) - 1];
          T sum = T(0);
          for (unsigned j = lanes; j; j &= j - 1) sum = sum + row[__ffs(j) - 1];
          row[__ffs(lanes) - 1] = sum;
        }
      }
      __syncthreads();
      for (int at = threadIdx.x; at < n_buckets * width; at += kThreads) {
        const int g = at % width;
        unsigned rest = round_mask;
        for (int i = at / width; i > 0; --i) rest &= rest - 1;
        const int bb = __ffs(rest) - 1;
        T tot = T(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if ((wmask[w] >> bb) & 1u)
            tot = tot + vals[g * (kThreads + 1) + w * 32 +
                             __ffs(lmask[w][bb]) - 1];
        T& cell = acc[bb * fields + f0 + g];
        cell = (((tile_mask >> bb) & 1u) ? cell : T(0)) + tot;
      }
      __syncthreads();
    }
    tile_mask |= round_mask;
  }
  if (!has_cfg) return;
  const long long slot = static_cast<long long>(k) * tiles + tile;
  for (unsigned todo = tile_mask; todo; todo &= todo - 1) {
    const int bb = __ffs(todo) - 1;
    T* out = part + (slot * nb + bb) * fields;
    for (int f = threadIdx.x; f < fields; f += kThreads)
      out[f] = acc[bb * fields + f];
  }
  if (threadIdx.x == 0) part_mask[slot] = tile_mask;
}

template <typename T>
__global__ void bucket_totals(const T* __restrict__ part,
                              const unsigned* __restrict__ part_mask,
                              int n_cfg, long long tiles, int n_metrics,
                              int nb, T* __restrict__ bucket_rows,
                              T* __restrict__ bucket_info) {
  const int fields = n_metrics * kReport + kInfo;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_cfg) * nb * fields) return;
  const int f = static_cast<int>(t % fields);
  const int b = static_cast<int>((t / fields) % nb);
  const int k = static_cast<int>(t / (static_cast<long long>(fields) * nb));
  T acc = T(0);
  const long long first = static_cast<long long>(k) * tiles;
  for (long long j = first; j < first + tiles; ++j)
    if ((__ldg(part_mask + j) >> b) & 1u)
      acc = acc + part[(j * nb + b) * fields + f];
  if (f < n_metrics * kReport) {
    const int m = f / kReport, g = f % kReport;
    bucket_rows[((static_cast<long long>(k) * nb + b) * n_metrics + m) *
                    kReport + g] = acc;
  } else {
    bucket_info[(static_cast<long long>(k) * nb + b) * kInfo + f -
                n_metrics * kReport] = acc;
  }
}

template <typename T>
int launch(const void* stats, const void* sel, const void* n_users,
           const void* size, const void* noise_std, const void* sel_cfg,
           const void* bounds, int n_cfg, long long n_parts, int n_metrics,
           int ms, int nb, int pub, int window, void* scratch, void* bucket,
           void* keep_prob, void* bucket_rows, void* bucket_info,
           cudaStream_t s) {
  const Plan plan = plan_of(n_cfg, n_parts, n_metrics, nb, sizeof(T) == 8);
  T* part = static_cast<T*>(scratch);
  unsigned* mask = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) +
                                               plan.part_bytes);
  const long long blocks = (n_cfg > 0 ? n_cfg : 1) * plan.tiles;
  const size_t smem = tile_smem<T>(nb, n_metrics * kReport + kInfo);
  if (blocks > 0)
    tile_sums<T><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const T*>(stats), static_cast<const T*>(sel),
        static_cast<const T*>(n_users), static_cast<const T*>(size),
        static_cast<const T*>(noise_std), static_cast<const T*>(sel_cfg),
        static_cast<const T*>(bounds), n_cfg, n_parts, n_metrics, ms, nb,
        pub, window, plan.tiles, plan.tile_parts,
        static_cast<int32_t*>(bucket), static_cast<T*>(keep_prob), part,
        mask);
  const long long outs =
      static_cast<long long>(n_cfg) * nb * (n_metrics * kReport + kInfo);
  if (outs > 0)
    bucket_totals<T><<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                       s>>>(part, mask, n_cfg, plan.tiles, n_metrics, nb,
                            static_cast<T*>(bucket_rows),
                            static_cast<T*>(bucket_info));
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int n_cfg, long long n_parts, int n_metrics, int nb,
                 int window) {
  return n_cfg >= 0 && n_parts >= 0 && n_parts < (1LL << 31) && nb >= 1 &&
         nb <= kMaxBuckets && n_metrics >= 0 && n_metrics <= kMaxMetrics &&
         window >= 1;
}

}  // namespace

// Bytes of sweep_report's scratch at this shape (the tiles' bucket sums
// and masks); -1 for a shape it does not take.
extern "C" long long sweep_report_scratch_bytes(int n_cfg, long long n_parts,
                                                int n_metrics, int nb,
                                                int f64) {
  if (!valid_shape(n_cfg, n_parts, n_metrics, nb, 1)) return -1;
  const Plan plan = plan_of(n_cfg, n_parts, n_metrics, nb, f64);
  return static_cast<long long>(
      plan.part_bytes +
      pdp::align_up(sizeof(unsigned) * (n_cfg > 0 ? n_cfg : 1) * plan.tiles));
}

// stats: T[n_cfg, n_parts, n_metrics, 5]; sel: T[n_cfg, n_parts, 3] (null
// when pub); n_users, size: T[n_parts]; noise_std: T[n_cfg, ms]; sel_cfg:
// T[8, n_cfg]; bounds: T[nb], nb <= 32; n_metrics <= 3; scratch:
// sweep_report_scratch_bytes(...) bytes. Outputs: bucket int32[n_parts];
// keep_prob T[n_cfg, n_parts]; bucket_rows T[n_cfg, nb, n_metrics, 24];
// bucket_info T[n_cfg, nb, 5].
extern "C" int sweep_report(const void* stats, const void* sel,
                            const void* n_users, const void* size,
                            const void* noise_std, const void* sel_cfg,
                            const void* bounds, int n_cfg, long long n_parts,
                            int n_metrics, int ms, int nb, int pub,
                            int window, int f64, void* scratch, void* bucket,
                            void* keep_prob, void* bucket_rows,
                            void* bucket_info, void* stream) {
  if (!valid_shape(n_cfg, n_parts, n_metrics, nb, window))
    return 1;  // cudaErrorInvalidValue
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(stats, sel, n_users, size, noise_std, sel_cfg,
                              bounds, n_cfg, n_parts, n_metrics, ms, nb, pub,
                              window, scratch, bucket, keep_prob, bucket_rows,
                              bucket_info, s)
             : launch<float>(stats, sel, n_users, size, noise_std, sel_cfg,
                             bounds, n_cfg, n_parts, n_metrics, ms, nb, pub,
                             window, scratch, bucket, keep_prob, bucket_rows,
                             bucket_info, s);
}
