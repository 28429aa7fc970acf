// C2 bound_rows: contribution bounding over the sorted row stream.
//
// Replaces, from pipelinedp_tpu: the segment scans of ops/segment_ops.py
// (:16 segment_starts_and_ids, :35 boundary_mask, :45
// segment_rank_of_segments, :59 segment_start_positions, :66
// next_segment_start) and the row half of executor.py's
// bounded_row_columns (:387-436: Linf rank, L0 pair rank, value clipping,
// pair-sum clipping, nsum / nsum2), together K4 and the row half of K5.
//
// Rows are read in bounding-sort order through `perm` (C1's keys sorted
// lexicographically); output i belongs to sorted position i. Per row:
//   rank      = i - (start of its (pid, pk) pair)          a max-scan
//   pair_rank = pairs started in its pid before its own   a segmented
//               count of pair starts, reset at pid starts
//   keep      = valid & rank < linf (when capped) & pair_rank < l0
// Both scans run as one three-pass tile scan: per-tile aggregates, one
// block scanning the aggregates in order, then a pass that rescans each
// tile from its prefix and writes the row outputs. The pair total for
// pair-sum clipping is summed in row order by the pair's first thread.
// With `k1 == nullptr` every row is its own pair (contribution bounds
// already enforced) and no scan runs. l0 = 0 means no cross-partition cap
// (the total bound replaces it). Standalone selection passes no values and
// asks for no columns: it needs key2 and pair_start only.
//
// The lane entry, bound_rows_lanes (K24: the megabatched service's vmap
// over job lanes, executor.py:984, :1141), bounds L jobs' rows as one
// stream: the bounding sort (C5) has the lane as its most significant
// word, so lane l's rows are the sorted positions [l * n, (l + 1) * n).
// A pid run and a pair run also break where the lane changes (two lanes
// may hold the same pid, or the same keys, side by side), the pair-sum
// walk stops there, and a kept row writes key2 = lane * P + partition,
// a dropped one L * P (the caller checks L * (P + 1) < 2^31). Each lane's
// outputs are its solo run's. Without keys (contribution bounds already
// enforced) every row is its own pair, as in the solo entry, and its key2
// is lane * P + pk.
//
// A second entry, total_bound_rows, is the total contribution bound of
// executor.py:366-378 (max_contributions = K): over the rows in (pid, u)
// order (perm and the sorted pid from radix_sort) it ranks each row within
// its pid by the same tile scan (a max-scan of pid-start positions) and
// writes the carried columns in that order, with valid0 = valid & rank < K
// and the sentinels pid = INT32_MAX, pk = n_partitions where !valid0. The
// gather of the payloads is that same pass: no separate gather runs.
// Its lane entry, total_bound_rows_lanes, takes the sorted int64 words
// lane << 32 | pid of C1's total_keys_lanes: a run of equal words is one
// pid of one lane, so the rank restarts at every lane start, and lane l's
// rows keep their block [l * n, (l + 1) * n) of the output, where C1's
// lane entry draws them at the solo run's counters.
//
// Bound: bytes. Each pass reads perm, k1, k2 (8 B each) for its rows; the
// last pass also reads value and valid and writes key2 (4 B), pair_start
// (1 B) and up to three F columns. The reads through perm are gathers
// (a 32 B sector for an 8 B key), which is what the layout costs; the
// scans themselves are a few integer operations a row.
#include "common.cuh"

namespace {

struct BoundAgg {
  long long a;  // max of pair-start positions (-1 = none)
  long long c;  // pair starts since the last pid start
  int f;        // a pid starts inside
};

struct BoundOp {
  using T = BoundAgg;
  static __device__ __forceinline__ T identity() { return T{-1, 0, 0}; }
  static __device__ __forceinline__ T combine(T x, T y) {
    return T{x.a > y.a ? x.a : y.a, y.f ? y.c : x.c + y.c, x.f | y.f};
  }
  static __device__ __forceinline__ T shfl_up(T v, int d) {
    v.a = __shfl_up_sync(pdp::kFullMask, v.a, d);
    v.c = __shfl_up_sync(pdp::kFullMask, v.c, d);
    v.f = __shfl_up_sync(pdp::kFullMask, v.f, d);
    return v;
  }
};

struct Keys {
  const long long* perm;
  const long long* k1;
  const long long* k2;
  long long lane_rows;  // rows a lane (0: one lane)
  __device__ __forceinline__ long long row(long long i) const {
    return perm ? perm[i] : i;
  }
  __device__ __forceinline__ bool lane_start(long long i) const {
    return lane_rows != 0 && i % lane_rows == 0;
  }
};

// Boundary flags of sorted position i: a new (pid, pk) pair, a new pid.
__device__ __forceinline__ void flags_at(const Keys& keys, long long i,
                                         bool* new_pair, bool* new_pid) {
  if (i == 0 || keys.lane_start(i)) {
    *new_pair = *new_pid = true;
    return;
  }
  const long long r = keys.row(i), q = keys.row(i - 1);
  const long long a1 = keys.k1[r], b1 = keys.k1[q];
  *new_pid = (a1 >> 32) != (b1 >> 32);
  *new_pair = a1 != b1 || keys.k2[r] != keys.k2[q];
}

__device__ __forceinline__ BoundAgg element(const Keys& keys, long long i) {
  bool new_pair, new_pid;
  flags_at(keys, i, &new_pair, &new_pid);
  return BoundAgg{new_pair ? i : -1, new_pair ? 1 : 0, new_pid ? 1 : 0};
}

__global__ void tile_aggregates(Keys keys, long long n, BoundAgg* aggs) {
  __shared__ BoundAgg smem[32];
  const long long base =
      static_cast<long long>(blockIdx.x) * pdp::kTile +
      static_cast<long long>(threadIdx.x) * pdp::kItems;
  BoundAgg acc = BoundOp::identity();
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    if (base + k < n) acc = BoundOp::combine(acc, element(keys, base + k));
  }
  BoundAgg total;
  pdp::block_exclusive_scan<BoundOp>(acc, smem, &total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

template <typename F>
struct Params {
  long long n;
  int n_partitions;
  int n_lanes;  // key2 = lane * n_partitions + partition; dropped: n_lanes * P
  long long linf;  // 0 = no per-partition row cap
  long long l0;
  int clip_per_value, clip_pair_sum;
  F min_v, max_v, min_s, max_s, mid;
};

template <typename F>
__device__ __forceinline__ F clip(F x, F lo, F hi) {
  x = x > lo ? x : lo;
  return x < hi ? x : hi;
}

template <typename F>
__device__ __forceinline__ F clipped_value(const Params<F>& p, F v) {
  return p.clip_per_value ? clip(v, p.min_v, p.max_v) : v;
}

// Writes the outputs of sorted position i given its rank in the pair and
// the pair's rank in its pid.
template <typename F>
__device__ __forceinline__ void emit(const Params<F>& p, const Keys& keys,
                                     const F* values, const uint8_t* valid,
                                     const int32_t* pk, long long i,
                                     bool new_pair, long long rank,
                                     long long pair_rank, int32_t* key2,
                                     uint8_t* pair_start, F* sum, F* nsum,
                                     F* nsum2) {
  const long long r = keys.row(i);
  const bool v = valid[r] != 0;
  const bool pair_kept = p.l0 == 0 || pair_rank < p.l0;
  const bool keep = v && (p.linf == 0 || rank < p.linf) && pair_kept;
  const F clipped = values ? clipped_value(p, values[r]) : F(0);
  const int32_t spk =
      keys.k2 ? static_cast<int32_t>(keys.k2[r] & 0xFFFFFFFFll)
              : (v ? pk[r] : p.n_partitions);
  const long long lane = keys.lane_rows ? i / keys.lane_rows : 0;
  key2[i] = keep ? static_cast<int32_t>(lane * p.n_partitions + spk)
                 : p.n_lanes * p.n_partitions;
  const bool starts = new_pair && keep;
  pair_start[i] = starts ? 1 : 0;
  if (sum) {
    F contrib = keep ? clipped : F(0);
    if (p.clip_pair_sum) {
      F total = contrib;
      if (starts && keys.k1) {
        const long long k1 = keys.k1[r], k2 = keys.k2[r];
        for (long long j = i + 1; j < p.n; ++j) {
          if (p.linf != 0 && j - i >= p.linf) break;
          if (keys.lane_start(j)) break;
          const long long rj = keys.row(j);
          if (keys.k1[rj] != k1 || keys.k2[rj] != k2) break;
          if (valid[rj]) total = total + clipped_value(p, values[rj]);
        }
      }
      contrib = starts ? clip(total, p.min_s, p.max_s) : F(0);
    }
    sum[i] = contrib;
  }
  if (nsum) {
    const F centered = keep ? clipped - p.mid : F(0);
    nsum[i] = centered;
    if (nsum2) nsum2[i] = centered * centered;
  }
}

template <typename F>
__global__ void finalize_rows(Params<F> p, Keys keys,
                              const BoundAgg* __restrict__ prefixes,
                              const F* __restrict__ values,
                              const uint8_t* __restrict__ valid,
                              const int32_t* __restrict__ pk,
                              int32_t* __restrict__ key2,
                              uint8_t* __restrict__ pair_start,
                              F* __restrict__ sum, F* __restrict__ nsum,
                              F* __restrict__ nsum2) {
  __shared__ BoundAgg smem[32];
  const long long base =
      static_cast<long long>(blockIdx.x) * pdp::kTile +
      static_cast<long long>(threadIdx.x) * pdp::kItems;
  if (!keys.k1) {  // every row is its own pair: nothing to scan
#pragma unroll
    for (int k = 0; k < pdp::kItems; ++k) {
      if (base + k < p.n)
        emit(p, keys, values, valid, pk, base + k, true, 0, 0, key2,
             pair_start, sum, nsum, nsum2);
    }
    return;
  }
  BoundAgg elems[pdp::kItems];
  BoundAgg acc = BoundOp::identity();
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    elems[k] = base + k < p.n ? element(keys, base + k) : BoundOp::identity();
    acc = BoundOp::combine(acc, elems[k]);
  }
  BoundAgg total;
  const BoundAgg excl = pdp::block_exclusive_scan<BoundOp>(acc, smem, &total);
  BoundAgg state = BoundOp::combine(prefixes[blockIdx.x], excl);
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    const long long i = base + k;
    if (i >= p.n) break;
    state = BoundOp::combine(state, elems[k]);
    emit(p, keys, values, valid, pk, i, elems[k].a >= 0, i - state.a,
         state.c - 1, key2, pair_start, sum, nsum, nsum2);
  }
}

// Total bound: new_pid(i) ? i : -1 over the rows in (pid, u) order. K is
// int32 (a pid) or int64 (lane << 32 | pid, the lane entry).
template <typename K>
__device__ __forceinline__ long long pid_start(const K* spid, long long i) {
  return i == 0 || spid[i] != spid[i - 1] ? i : -1;
}

__device__ __forceinline__ int32_t pid_of(int32_t k) { return k; }
__device__ __forceinline__ int32_t pid_of(long long k) {
  return static_cast<int32_t>(k & 0xFFFFFFFFll);
}

template <typename K>
__global__ void pid_start_aggregates(const K* __restrict__ spid,
                                     long long n, long long* aggs) {
  __shared__ long long smem[32];
  const long long base =
      static_cast<long long>(blockIdx.x) * pdp::kTile +
      static_cast<long long>(threadIdx.x) * pdp::kItems;
  long long acc = -1;
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    if (base + k < n)
      acc = pdp::MaxPosOp::combine(acc, pid_start(spid, base + k));
  }
  long long total;
  pdp::block_exclusive_scan<pdp::MaxPosOp>(acc, smem, &total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

template <typename F, typename K>
__global__ void total_bound_finalize(
    const long long* __restrict__ perm, const K* __restrict__ spid,
    const long long* __restrict__ prefixes, long long n,
    long long total_bound, int n_partitions, const int32_t* __restrict__ pk,
    const F* __restrict__ values, const uint8_t* __restrict__ valid,
    int32_t* __restrict__ pid_out, int32_t* __restrict__ pk_out,
    F* __restrict__ values_out, uint8_t* __restrict__ valid_out) {
  __shared__ long long smem[32];
  const long long base =
      static_cast<long long>(blockIdx.x) * pdp::kTile +
      static_cast<long long>(threadIdx.x) * pdp::kItems;
  long long starts[pdp::kItems];
  long long acc = -1;
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    starts[k] = base + k < n ? pid_start(spid, base + k) : -1;
    acc = pdp::MaxPosOp::combine(acc, starts[k]);
  }
  long long total;
  const long long excl =
      pdp::block_exclusive_scan<pdp::MaxPosOp>(acc, smem, &total);
  long long state = pdp::MaxPosOp::combine(prefixes[blockIdx.x], excl);
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    const long long i = base + k;
    if (i >= n) break;
    state = pdp::MaxPosOp::combine(state, starts[k]);
    const long long r = perm[i];
    const bool v = valid[r] != 0 && i - state < total_bound;
    pid_out[i] = v ? pid_of(spid[i]) : 0x7FFFFFFF;
    pk_out[i] = v ? pk[r] : n_partitions;
    values_out[i] = values[r];
    valid_out[i] = v ? 1 : 0;
  }
}

template <typename F, typename K>
int launch_total(const void* perm, const void* spid, const void* pk,
                 const void* values, const void* valid, long long n,
                 long long total_bound, int n_partitions, void* scratch,
                 void* pid_out, void* pk_out, void* values_out,
                 void* valid_out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = pdp::n_tiles(n);
  long long* aggs = static_cast<long long*>(scratch);
  const K* sp = static_cast<const K*>(spid);
  pid_start_aggregates<K><<<static_cast<unsigned>(tiles), pdp::kThreads, 0,
                            s>>>(sp, n, aggs);
  pdp::scan_tile_aggregates<pdp::MaxPosOp><<<1, 1024, 0, s>>>(aggs, tiles,
                                                              nullptr);
  total_bound_finalize<F, K><<<static_cast<unsigned>(tiles), pdp::kThreads,
                               0, s>>>(
      static_cast<const long long*>(perm), sp, aggs, n, total_bound,
      n_partitions, static_cast<const int32_t*>(pk),
      static_cast<const F*>(values), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(pid_out), static_cast<int32_t*>(pk_out),
      static_cast<F*>(values_out), static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch(const void* perm, const void* k1, const void* k2, const void* pk,
           const void* values, const void* valid, long long n,
           long long lane_rows, int n_partitions, long long linf,
           long long l0, int clip_per_value, int clip_pair_sum,
           const double* scalars, void* scratch, void* key2,
           void* pair_start, void* sum, void* nsum, void* nsum2,
           void* stream) {
  if (n <= 0) return 0;
  if (lane_rows < 0 || (lane_rows > 0 && n % lane_rows != 0)) return -1;
  if (k1 == nullptr && pk == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = pdp::n_tiles(n);
  const int n_lanes = lane_rows > 0 ? static_cast<int>(n / lane_rows) : 1;
  Keys keys{static_cast<const long long*>(perm),
            static_cast<const long long*>(k1),
            static_cast<const long long*>(k2), lane_rows};
  BoundAgg* aggs = static_cast<BoundAgg*>(scratch);
  if (keys.k1) {
    tile_aggregates<<<static_cast<unsigned>(tiles), pdp::kThreads, 0, s>>>(
        keys, n, aggs);
    pdp::scan_tile_aggregates<BoundOp><<<1, 1024, 0, s>>>(aggs, tiles,
                                                          nullptr);
  }
  Params<F> p{n,
              n_partitions,
              n_lanes,
              linf,
              l0,
              clip_per_value,
              clip_pair_sum,
              static_cast<F>(scalars[0]),
              static_cast<F>(scalars[1]),
              static_cast<F>(scalars[2]),
              static_cast<F>(scalars[3]),
              static_cast<F>(scalars[4])};
  finalize_rows<F><<<static_cast<unsigned>(tiles), pdp::kThreads, 0, s>>>(
      p, keys, aggs, static_cast<const F*>(values),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pk),
      static_cast<int32_t*>(key2), static_cast<uint8_t*>(pair_start),
      static_cast<F*>(sum), static_cast<F*>(nsum), static_cast<F*>(nsum2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch the caller allocates for n rows: one aggregate per tile (of
// either entry).
extern "C" long long bound_rows_scratch_bytes(long long n) {
  return pdp::n_tiles(n) * static_cast<long long>(sizeof(BoundAgg));
}

// scalars = (min_v, max_v, min_s, max_s, mid). k1/k2 null: rows are their
// own pairs and pk supplies the partition (contribution bounds enforced).
extern "C" int bound_rows(const void* perm, const void* k1, const void* k2,
                          const void* pk, const void* values,
                          const void* valid, long long n, int n_partitions,
                          long long linf, long long l0, int clip_per_value,
                          int clip_pair_sum, const double* scalars,
                          void* scratch, void* key2, void* pair_start,
                          void* sum, void* nsum, void* nsum2, int f64,
                          void* stream) {
  return f64 ? launch<double>(perm, k1, k2, pk, values, valid, n, 0,
                              n_partitions, linf, l0, clip_per_value,
                              clip_pair_sum, scalars, scratch, key2,
                              pair_start, sum, nsum, nsum2, stream)
             : launch<float>(perm, k1, k2, pk, values, valid, n, 0,
                             n_partitions, linf, l0, clip_per_value,
                             clip_pair_sum, scalars, scratch, key2,
                             pair_start, sum, nsum, nsum2, stream);
}

// The lane entry: n = L * lane_rows rows in (lane, k1, k2, u) order;
// key2 = lane * n_partitions + partition where kept, L * n_partitions
// elsewhere. k1 / k2 null: every row is its own pair, in lane order, and
// pk (lane-local) supplies its partition. Same scratch as bound_rows.
extern "C" int bound_rows_lanes(const void* perm, const void* k1,
                                const void* k2, const void* pk,
                                const void* values, const void* valid,
                                long long n,
                                long long lane_rows, int n_partitions,
                                long long linf, long long l0,
                                int clip_per_value, int clip_pair_sum,
                                const double* scalars, void* scratch,
                                void* key2, void* pair_start, void* sum,
                                void* nsum, void* nsum2, int f64,
                                void* stream) {
  if (lane_rows <= 0) return -1;
  return f64 ? launch<double>(perm, k1, k2, pk, values, valid, n,
                              lane_rows, n_partitions, linf, l0,
                              clip_per_value, clip_pair_sum, scalars,
                              scratch, key2, pair_start, sum, nsum, nsum2,
                              stream)
             : launch<float>(perm, k1, k2, pk, values, valid, n,
                             lane_rows, n_partitions, linf, l0,
                             clip_per_value, clip_pair_sum, scalars,
                             scratch, key2, pair_start, sum, nsum, nsum2,
                             stream);
}

// perm / spid: radix_sort of (pid_sent, u) with the sorted pid_sent;
// outputs in that order: pid and pk with sentinels, values, valid0.
extern "C" int total_bound_rows(const void* perm, const void* spid,
                                const void* pk, const void* values,
                                const void* valid, long long n,
                                long long total_bound, int n_partitions,
                                void* scratch, void* pid_out, void* pk_out,
                                void* values_out, void* valid_out, int f64,
                                void* stream) {
  return f64 ? launch_total<double, int32_t>(
                   perm, spid, pk, values, valid, n, total_bound,
                   n_partitions, scratch, pid_out, pk_out, values_out,
                   valid_out, stream)
             : launch_total<float, int32_t>(
                   perm, spid, pk, values, valid, n, total_bound,
                   n_partitions, scratch, pid_out, pk_out, values_out,
                   valid_out, stream);
}

// The total-bound lane entry: perm / slane_pid from radix_sort of C1's
// (lane << 32 | pid, u) with the sorted words; n = L * lane_rows (each
// lane's rows stay in its block); pk_out's sentinel is the lane-local
// n_partitions. Same scratch as bound_rows.
extern "C" int total_bound_rows_lanes(const void* perm,
                                      const void* slane_pid, const void* pk,
                                      const void* values, const void* valid,
                                      long long n, long long lane_rows,
                                      long long total_bound, int n_partitions,
                                      void* scratch, void* pid_out,
                                      void* pk_out, void* values_out,
                                      void* valid_out, int f64,
                                      void* stream) {
  if (lane_rows <= 0 || n % lane_rows != 0) return -1;
  return f64 ? launch_total<double, long long>(
                   perm, slane_pid, pk, values, valid, n, total_bound,
                   n_partitions, scratch, pid_out, pk_out, values_out,
                   valid_out, stream)
             : launch_total<float, long long>(
                   perm, slane_pid, pk, values, valid, n, total_bound,
                   n_partitions, scratch, pid_out, pk_out, values_out,
                   valid_out, stream);
}
