// C4 release_epilogue: partition selection, noise, metric formulas and the
// release sentinel's flag word, one thread per partition.
//
// Replaces, from pipelinedp_tpu: ops/selection_ops.py keep_probabilities /
// sample_keep_decisions (:69, :108, K6), executor.py finalize (:551-639,
// K7) with its jax.random draws (K1), and the flag reduction of
// numeric.py _column_flags / _flags_from_kept (:80-107, K9).
//
// Per partition p:
//   keep    private selection: est = ceil(row_count / max_rows), the keep
//           probability of the strategy, uniform(key_sel)[p] < probability;
//           public: 1
//   noise   slot s draws element p under its key (the host derives
//           fold_in(fold_in(key_noise, entry), sub) for each slot):
//           Laplace sign(u) * log1p(-|u|) * std / sqrt(2), Gaussian
//           sqrt(2) * erf_inv(u) * std. Secure noise (K13, finalize's
//           secure branch, :585-590): snap(col) + atom * gran[s], the atom
//           searched in slot s's table with the words bits(k1)[p],
//           bits(k2)[p] of (k1, k2) = split(slot key)
//   outputs count / privacy_id_count / sum / mean / variance with the
//           formulas and operation order of finalize
//   flags   NaN (1), Inf (2), |x| >= max/2 (4) over kept partitions, one
//           atomicOr of integers per block (order-free, so deterministic).
//
// The lane entry, release_epilogue_lanes (K24: the megabatched service's
// vmap over job lanes, executor.py:984), runs L jobs' partitions as one
// range of L * P: blockIdx.y is the lane, a partition p' = lane * P + p
// draws every noise and selection value at counter p under its lane's
// keys (rows of a [L, 2 + 2 * n_slots] table on the device: key_sel,
// then the slot keys), and each lane ORs its flags into its own word. A
// lane's outputs are its solo run's. With secure noise the lanes share
// the slots' tables and each row also holds the split of every slot key,
// (k1, k2) = split(slot_keys[l][s]), made on the host: lane l searches
// with the words bits(k1)[p], bits(k2)[p], as its solo run does.
//
// Bound: operations at small P, bytes at large P: it reads up to 5 F
// columns and writes up to 5 plus keep; each noise draw is one threefry
// (~100 integer operations) and a log1p or an erf_inv polynomial, a secure
// draw two threefry (the slot's split is made once, at launch) and a
// 12-13 round table search (dependent loads from
// the read-only cache).
#include "common.cuh"

namespace {

constexpr int kMaxEntries = 8;
constexpr int kMaxSlots = 8;

enum Kind { kCount = 0, kPidCount = 1, kSum = 2, kMean = 3, kVariance = 4 };
enum Out { oCount = 1, oPid = 2, oSum = 4, oMean = 8, oVariance = 16 };

struct Params {
  int n_entries;
  int kind[kMaxEntries];
  int outputs[kMaxEntries];
  int offset[kMaxEntries];
  double std[kMaxSlots];
  unsigned key[kMaxSlots][2];
  int gaussian;
  int degenerate;
  double mid, min_v;
  int private_selection;
  unsigned key_sel[2];
  double max_rows;
  // Selection scalars (ops/selection_ops.selection_scalars order).
  double sel[14];
  // Secure noise: the slots' packed tables [n_slots, table_len] (null:
  // continuous noise) and each slot's grid.
  const unsigned long long* table;
  int table_len;
  double gran[kMaxSlots];
  pdp::SecureKey skey[kMaxSlots];  // split(key[s]), derived at launch
};

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float erfc_(float x) { return erfcf(x); }
__device__ __forceinline__ double erfc_(double x) { return erfc(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }

// ops/selection_ops.keep_probabilities for one privacy-id count estimate.
template <typename F>
__device__ F keep_probability(const Params& P, F est) {
  const double* s = P.sel;
  const int kind = static_cast<int>(s[0]);
  const F n = est - static_cast<F>(s[1]);
  F prob;
  if (kind == 0) {
    const F eps1 = static_cast<F>(s[2]), n_cross = static_cast<F>(s[4]);
    const F n_eff = pdp::max_nan(n, F(1));
    const F n1 = pdp::min_nan(n_eff, n_cross);
    const F log_pi1 = static_cast<F>(s[6]) + (n1 - F(1)) * eps1 +
                      pdp::log1p_(-exp_(-n1 * eps1)) - static_cast<F>(s[7]);
    const F pi1 = exp_(pdp::min_nan(log_pi1, F(0)));
    const F k = pdp::max_nan(n_eff - n_cross, F(0));
    const F decay = exp_(-k * eps1);
    const F geo = s[10] != 0.0
                      ? static_cast<F>(s[8]) * (F(1) - decay) /
                            static_cast<F>(s[9])
                      : F(0);
    const F q = decay * static_cast<F>(s[13]) - static_cast<F>(s[3]) * geo;
    const F pi2 = F(1) - pdp::max_nan(q, F(0));
    prob = pdp::min_nan(pdp::max_nan(n_eff <= n_cross ? pi1 : pi2, F(0)),
                        F(1));
  } else if (kind == 1) {
    const F z = (n - static_cast<F>(s[11])) / static_cast<F>(s[12]);
    const F az = z < F(0) ? -z : z;
    prob = z >= F(0) ? F(1) - F(0.5) * exp_(-az) : F(0.5) * exp_(-az);
  } else {
    const F z = (static_cast<F>(s[11]) - n) / static_cast<F>(s[12]);
    prob = F(0.5) * erfc_(z / static_cast<F>(1.4142135623730951));
  }
  return n <= F(0) ? F(0) : prob;
}

// Slot s's split key: the launch's, or lane_key's (its words at 2 + 2 *
// n_slots + 4 * s: k1, then k2).
__device__ __forceinline__ pdp::SecureKey slot_secure_key(
    const Params& P, const unsigned* lane_key, int n_slots, int slot) {
  if (!lane_key) return P.skey[slot];
  const unsigned* w = lane_key + 2 + 2 * n_slots + 4 * slot;
  pdp::SecureKey k;
  k.hi[0] = w[0];
  k.hi[1] = w[1];
  k.lo[0] = w[2];
  k.lo[1] = w[3];
  return k;
}

template <typename F>
__device__ __forceinline__ F noised(const Params& P, const unsigned* lane_key,
                                    int n_slots, F col, int slot,
                                    uint64_t p) {
  if (P.table) {
    uint32_t uhi, ulo;
    pdp::secure_words(slot_secure_key(P, lane_key, n_slots, slot), p, uhi,
                      ulo);
    return pdp::snapped_release<F>(
        col, uhi, ulo, P.table + static_cast<long long>(slot) * P.table_len,
        P.table_len, static_cast<F>(P.gran[slot]));
  }
  const F std = static_cast<F>(P.std[slot]);
  const unsigned k0 = lane_key ? lane_key[2 + 2 * slot] : P.key[slot][0];
  const unsigned k1 = lane_key ? lane_key[3 + 2 * slot] : P.key[slot][1];
  if (P.gaussian) return col + pdp::normal<F>(k0, k1, p) * std;
  const F b = std / pdp::sqrt_(F(2));
  return col + pdp::laplace<F>(k0, k1, p) * b;
}

template <typename F>
__global__ void epilogue_kernel(Params P, int n_partitions,
                                const F* __restrict__ count,
                                const F* __restrict__ pid_count,
                                const F* __restrict__ sum,
                                const F* __restrict__ nsum,
                                const F* __restrict__ nsum2,
                                uint8_t* __restrict__ keep_out,
                                F* __restrict__ o_count,
                                F* __restrict__ o_pid,
                                F* __restrict__ o_sum,
                                F* __restrict__ o_mean,
                                F* __restrict__ o_var,
                                unsigned* __restrict__ flags,
                                const unsigned* __restrict__ lane_keys,
                                int n_slots) {
  // Lane blockIdx.y (0 for one job): its columns start at lane * P, its
  // keys are row `lane` of lane_keys, its flag word is flags[lane].
  const long long lane = blockIdx.y;
  const long long at = lane * n_partitions;
  const long long row_words = 2 + 2 * n_slots + (P.table ? 4 * n_slots : 0);
  const unsigned* lane_key =
      lane_keys ? lane_keys + lane * row_words : nullptr;
  count += at;
  pid_count += at;
  if (sum) sum += at;
  if (nsum) nsum += at;
  if (nsum2) nsum2 += at;
  keep_out += at;
  if (o_count) o_count += at;
  if (o_pid) o_pid += at;
  if (o_sum) o_sum += at;
  if (o_mean) o_mean += at;
  if (o_var) o_var += at;
  flags += lane;
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned f = 0u;
  if (p < n_partitions) {
    bool keep = true;
    if (P.private_selection) {
      const F est = static_cast<F>(static_cast<long long>(
          ceil_(pid_count[p] / static_cast<F>(P.max_rows))));
      const F prob = keep_probability<F>(P, est);
      const unsigned ks0 = lane_key ? lane_key[0] : P.key_sel[0];
      const unsigned ks1 = lane_key ? lane_key[1] : P.key_sel[1];
      const F u = pdp::uniform<F>(ks0, ks1, static_cast<uint64_t>(p), F(0),
                                  F(1));
      keep = u < prob;
    }
    keep_out[p] = keep ? 1 : 0;
    const F mid = static_cast<F>(P.mid);
    F r_count = 0, r_pid = 0, r_sum = 0, r_mean = 0, r_var = 0;
    for (int e = 0; e < P.n_entries; ++e) {
      const int off = P.offset[e];
      const uint64_t q = static_cast<uint64_t>(p);
      switch (P.kind[e]) {
        case kCount:
          r_count = noised<F>(P, lane_key, n_slots, count[p], off, q);
          break;
        case kPidCount:
          r_pid = noised<F>(P, lane_key, n_slots, pid_count[p], off, q);
          break;
        case kSum:
          r_sum = noised<F>(P, lane_key, n_slots, sum[p], off, q);
          break;
        case kMean: {
          const F dp_count = noised<F>(P, lane_key, n_slots, count[p], off, q);
          const F dp_nsum =
              noised<F>(P, lane_key, n_slots, nsum[p], off + 1, q);
          const F denom = pdp::max_nan(dp_count, F(1));
          r_mean = mid + dp_nsum / denom;
          if (P.outputs[e] & oCount) r_count = dp_count;
          if (P.outputs[e] & oSum) r_sum = r_mean * dp_count;
          break;
        }
        case kVariance: {
          const F dp_count = noised<F>(P, lane_key, n_slots, count[p], off, q);
          const F denom = pdp::max_nan(dp_count, F(1));
          F nmean, nsqmean;
          if (P.degenerate) {
            nmean = static_cast<F>(P.min_v);
            nsqmean = nmean * nmean;
          } else {
            nmean =
                noised<F>(P, lane_key, n_slots, nsum[p], off + 1, q) / denom;
            nsqmean =
                noised<F>(P, lane_key, n_slots, nsum2[p], off + 2, q) / denom;
          }
          r_var = nsqmean - nmean * nmean;
          const F dp_mean = P.degenerate ? nmean + F(0) : nmean + mid;
          if (P.outputs[e] & oMean) r_mean = dp_mean;
          if (P.outputs[e] & oCount) r_count = dp_count;
          if (P.outputs[e] & oSum) r_sum = dp_mean * dp_count;
          break;
        }
      }
    }
    if (o_count) o_count[p] = r_count;
    if (o_pid) o_pid[p] = r_pid;
    if (o_sum) o_sum[p] = r_sum;
    if (o_mean) o_mean[p] = r_mean;
    if (o_var) o_var[p] = r_var;
    if (keep) {
      if (o_count) f |= pdp::value_flags(r_count);
      if (o_pid) f |= pdp::value_flags(r_pid);
      if (o_sum) f |= pdp::value_flags(r_sum);
      if (o_mean) f |= pdp::value_flags(r_mean);
      if (o_var) f |= pdp::value_flags(r_var);
    }
  }
  pdp::block_or_flags(f, flags);
}

}  // namespace

namespace {

// Fills the launch parameters shared by both entries; -1 on a bad plan.
int fill_params(Params* P, const int* plan, int n_entries,
                const double* stds, const unsigned* keys, int n_slots,
                const double* sel, const unsigned* key_sel, const int* misc,
                const double* scal, const void* table, int table_len,
                const double* gran) {
  if (n_entries > kMaxEntries || n_slots > kMaxSlots) return -1;
  if (table != nullptr && (table_len < 1 || table_len % 2 == 0)) return -1;
  P->n_entries = n_entries;
  for (int e = 0; e < n_entries; ++e) {
    P->kind[e] = plan[3 * e];
    P->outputs[e] = plan[3 * e + 1];
    P->offset[e] = plan[3 * e + 2];
  }
  for (int s = 0; s < n_slots; ++s) {
    P->std[s] = stds[s];
    P->key[s][0] = keys ? keys[2 * s] : 0u;
    P->key[s][1] = keys ? keys[2 * s + 1] : 0u;
    if (table != nullptr) {
      P->gran[s] = gran[s];
      P->skey[s] = pdp::secure_key(P->key[s][0], P->key[s][1]);
    }
  }
  P->table = static_cast<const unsigned long long*>(table);
  P->table_len = table_len;
  P->gaussian = misc[0];
  P->degenerate = misc[1];
  P->private_selection = misc[2];
  P->mid = scal[0];
  P->min_v = scal[1];
  P->max_rows = scal[2];
  P->key_sel[0] = key_sel ? key_sel[0] : 0u;
  P->key_sel[1] = key_sel ? key_sel[1] : 0u;
  for (int i = 0; i < 14; ++i) P->sel[i] = sel[i];
  return 0;
}

template <typename F>
void launch(const Params& P, int n_partitions, int n_lanes,
            const void* count, const void* pid_count, const void* sum,
            const void* nsum, const void* nsum2, void* keep, void* o_count,
            void* o_pid, void* o_sum, void* o_mean, void* o_var,
            void* flags, const void* lane_keys, int n_slots,
            cudaStream_t s) {
  const int threads = 256;
  const dim3 grid((n_partitions + threads - 1) / threads, n_lanes);
  epilogue_kernel<F><<<grid, threads, 0, s>>>(
      P, n_partitions, static_cast<const F*>(count),
      static_cast<const F*>(pid_count), static_cast<const F*>(sum),
      static_cast<const F*>(nsum), static_cast<const F*>(nsum2),
      static_cast<uint8_t*>(keep), static_cast<F*>(o_count),
      static_cast<F*>(o_pid), static_cast<F*>(o_sum),
      static_cast<F*>(o_mean), static_cast<F*>(o_var),
      static_cast<unsigned*>(flags),
      static_cast<const unsigned*>(lane_keys), n_slots);
}

}  // namespace

// plan: n_entries x (kind, output mask, std offset); stds / keys: one per
// noise slot; sel: the 14 selection scalars; misc = (gaussian, degenerate,
// private_selection); scal = (mid, min_v, max_rows). Outputs: keep (u8),
// up to five F columns (null when absent), flags (one zeroed u32). Secure
// noise: table u64[n_slots, table_len] (null: continuous noise), gran one
// grid a slot.
extern "C" int release_epilogue(
    const int* plan, int n_entries, const double* stds,
    const unsigned* keys, int n_slots, const double* sel,
    const unsigned* key_sel, const int* misc, const double* scal,
    int n_partitions, const void* count, const void* pid_count,
    const void* sum, const void* nsum, const void* nsum2, void* keep,
    void* o_count, void* o_pid, void* o_sum, void* o_mean, void* o_var,
    void* flags, const void* table, int table_len, const double* gran,
    int f64, void* stream) {
  Params P{};
  if (fill_params(&P, plan, n_entries, stds, keys, n_slots, sel, key_sel,
                  misc, scal, table, table_len, gran) != 0)
    return -1;
  if (n_partitions <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(P, n_partitions, 1, count, pid_count, sum, nsum, nsum2,
                   keep, o_count, o_pid, o_sum, o_mean, o_var, flags,
                   nullptr, n_slots, s);
  } else {
    launch<float>(P, n_partitions, 1, count, pid_count, sum, nsum, nsum2,
                  keep, o_count, o_pid, o_sum, o_mean, o_var, flags, nullptr,
                  n_slots, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The lane entry: columns and outputs are [n_lanes * n_partitions], lane l
// at [l * n_partitions, (l + 1) * n_partitions); lane_keys is the lanes'
// u32 [n_lanes, 2 + 2 * n_slots] table on the device (key_sel, then each
// slot's key; with a secure table [n_lanes, 2 + 6 * n_slots], each slot's
// split (k1, k2) after them); flags are n_lanes zeroed u32. Secure noise:
// table u64[n_slots, table_len] shared by the lanes (null: continuous
// noise), gran one grid a slot.
extern "C" int release_epilogue_lanes(
    const int* plan, int n_entries, const double* stds, int n_slots,
    const double* sel, const int* misc, const double* scal,
    int n_partitions, int n_lanes, const void* lane_keys,
    const void* count, const void* pid_count, const void* sum,
    const void* nsum, const void* nsum2, void* keep, void* o_count,
    void* o_pid, void* o_sum, void* o_mean, void* o_var, void* flags,
    const void* table, int table_len, const double* gran, int f64,
    void* stream) {
  Params P{};
  if (fill_params(&P, plan, n_entries, stds, nullptr, n_slots, sel,
                  nullptr, misc, scal, table, table_len, gran) != 0)
    return -1;
  if (n_lanes < 1 || n_lanes > 65535 || lane_keys == nullptr) return -1;
  if (n_partitions <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(P, n_partitions, n_lanes, count, pid_count, sum, nsum,
                   nsum2, keep, o_count, o_pid, o_sum, o_mean, o_var, flags,
                   lane_keys, n_slots, s);
  } else {
    launch<float>(P, n_partitions, n_lanes, count, pid_count, sum, nsum,
                  nsum2, keep, o_count, o_pid, o_sum, o_mean, o_var, flags,
                  lane_keys, n_slots, s);
  }
  return static_cast<int>(cudaGetLastError());
}
