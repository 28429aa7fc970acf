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
// The pair total for pair-sum clipping is summed in row order by the
// pair's first row. With `k1 == nullptr` every row is its own pair
// (contribution bounds already enforced) and no scan runs. l0 = 0 means
// no cross-partition cap (the total bound replaces it). Standalone
// selection passes no values and asks for no columns: it needs key2 and
// pair_start only.
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
// its pid (a max-scan of pid-start positions) and writes the carried
// columns in that order, with valid0 = valid & rank < K and the sentinels
// pid = INT32_MAX, pk = n_partitions where !valid0. The gather of the
// payloads is that same pass. Its lane entry, total_bound_rows_lanes,
// takes the sorted int64 words lane << 32 | pid of C1's total_keys_lanes:
// a run of equal words is one pid of one lane, so the rank restarts at
// every lane start, and lane l's rows keep their block [l * n, (l + 1) *
// n) of the output, where C1's lane entry draws them at the solo run's
// counters.
//
// Bound on this card: bytes. The least traffic is perm (8 B), k1, k2 (8 B
// each), value and valid read once a row, and key2 (4 B), pair_start
// (1 B) and up to three F columns written once. The keys, value and
// valid are reached through perm: random gathers, a 32-byte sector for
// each 1-8 useful bytes, which is what the layout costs (replaced three
// passes that gathered ~10 sectors a row).
//
// Design: one pass over tiles of 2048 rows (256 threads) with a decoupled
// look-back (pdp::look_back, csrc/common.cuh, shared with C3).
//   * A block claims its tile from an atomic counter. Consecutive threads
//     read consecutive perm entries (coalesced) and gather each row's k1,
//     k2, valid and value once, into the tile's shared memory; one more
//     row, the tile's predecessor, gives the first row's boundary flags.
//     Every other read of a key or value is from that staged copy.
//   * The boundary flags (new pair, new pid) are taken in that striped
//     layout, then each thread scans its 8 consecutive rows' flags (one
//     8-byte shared load), a block scan gives the tile aggregate, and the
//     tile publishes it (or, at tile 0 and where its first row starts a
//     pid, its inclusive prefix at once). Warp 0 walks back to the
//     nearest inclusive prefix or pid start and publishes the tile's own
//     inclusive prefix. The scan's operators are integer max and sums:
//     exact in any association.
//   * Each row's keep bit goes back to shared memory and the outputs are
//     written in the striped layout again (coalesced). The pair-sum walk
//     reads the staged tile and goes to global memory only for a pair
//     that runs past the tile's end; it folds in row order from the
//     pair's first row, as before, so the float columns are unchanged.
//   * The solo entry takes k1 in sorted order only: the bounding sort's
//     sorted_top (C5 rebuilds it from the packed key at no gather), read
//     coalesced, so three random sectors a row are left (k2, valid,
//     value). Streamed loads and stores carry the
//     evict-first hint (__ldcs / __stcs), and so do the solo entry's
//     gathers of k2 and the values, so the 1-byte valid column (16 MB at
//     2^24 rows, a 32-byte sector for 32 rows) tends to stay in the 50 MB
//     L2 between its rows' gathers. The lane entry's gathers stay inside
//     a lane's block of rows, which L2 holds, and keep the default.
//   * One C call: one memset resets the counter and the status words,
//     then one launch. The keyless entries run no scan: one striped pass.
//   * What is left: the random gathers. The lane entry has the lane as
//     the sort's top word, so it gathers k1 too, but within each lane's
//     block of rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                 // rows a thread scans
constexpr int kTile = kThreads * kItems;  // rows a tile
constexpr uint8_t kNewPair = 1, kNewPid = 2, kKeep = 4;

struct BoundAgg {
  long long a;  // max of pair-start positions (-1 = none)
  long long c;  // pair starts since the last pid start
  int f;        // a pid starts inside
  int pad;
};

struct BoundOp {
  using T = BoundAgg;
  static __device__ __forceinline__ T identity() { return T{-1, 0, 0, 0}; }
  static __device__ __forceinline__ T combine(T x, T y) {
    return T{x.a > y.a ? x.a : y.a, y.f ? y.c : x.c + y.c, x.f | y.f, 0};
  }
  static __device__ __forceinline__ T shfl_up(T v, int d) {
    v.a = __shfl_up_sync(pdp::kFullMask, v.a, d);
    v.c = __shfl_up_sync(pdp::kFullMask, v.c, d);
    v.f = __shfl_up_sync(pdp::kFullMask, v.f, d);
    return v;
  }
  static __device__ __forceinline__ T shfl(T v, int src) {
    v.a = __shfl_sync(pdp::kFullMask, v.a, src);
    v.c = __shfl_sync(pdp::kFullMask, v.c, src);
    v.f = __shfl_sync(pdp::kFullMask, v.f, src);
    return v;
  }
  // A pid starts inside: the pair count restarts and a pair starts there.
  static __device__ __forceinline__ bool ends_walk(const T& v) {
    return v.f != 0;
  }
};

template <typename F>
struct Params {
  long long n;
  long long lane_rows;  // rows a lane (0: one lane)
  int n_partitions;
  int n_lanes;  // key2 = lane * n_partitions + partition; dropped: n_lanes * P
  long long linf;  // 0 = no per-partition row cap
  long long l0;
  int clip_per_value, clip_pair_sum;
  F min_v, max_v, min_s, max_s, mid;

  __device__ __forceinline__ bool lane_start(long long i) const {
    return lane_rows != 0 && i % lane_rows == 0;
  }
  __device__ __forceinline__ long long lane(long long i) const {
    return lane_rows ? i / lane_rows : 0;
  }
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

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// Shared memory of bound_tiles<F>: k1, k2 of the tile's rows and of the
// row before it, then value, valid and the flags of the tile's rows.
template <typename F>
constexpr int tile_bytes() {
  return (kTile + 1) * 16 + kTile * static_cast<int>(sizeof(F) + 2);
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    bound_tiles(Params<F> p, const long long* __restrict__ perm,
                const long long* __restrict__ k1, bool k1_sorted,
                const long long* __restrict__ k2,
                const F* __restrict__ values,
                const uint8_t* __restrict__ valid, pdp::Scan<BoundAgg> scan,
                int32_t* __restrict__ key2, uint8_t* __restrict__ pair_start,
                F* __restrict__ sum, F* __restrict__ nsum,
                F* __restrict__ nsum2) {
  extern __shared__ __align__(16) unsigned char staged[];
  long long* s_k1 = reinterpret_cast<long long*>(staged);  // [0]: row t0 - 1
  long long* s_k2 = s_k1 + kTile + 1;
  F* s_val = reinterpret_cast<F*>(s_k2 + kTile + 1);
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_val + kTile);
  uint8_t* s_flag = s_valid + kTile;
  __shared__ BoundAgg scan_smem[32];
  const long long tile = pdp::claim_tile(scan.counter);
  const long long t0 = tile * kTile;
  const int tile_n = static_cast<int>(p.n - t0 < kTile ? p.n - t0 : kTile);
  const int tid = threadIdx.x;

  // Stage: perm read coalesced, each row's keys, valid and value gathered
  // once; k1 read coalesced where it comes in sorted order (k1_sorted, the
  // solo entry), else gathered too (the lane entry).
  long long r[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    r[k] = j < tile_n ? (perm ? __ldcs(perm + t0 + j) : t0 + j) : -1;
  }
  // One stream's gathers touch each sector of k2 and of the values about
  // once while it is in L2: evict them first, so valid's stay. A lane's
  // gathers stay inside its block of rows, which L2 holds: default.
  const bool one_touch = p.lane_rows == 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (r[k] < 0) continue;
    s_k1[j + 1] = k1_sorted ? __ldcs(k1 + t0 + j) : k1[r[k]];
    s_k2[j + 1] = one_touch ? __ldcs(k2 + r[k]) : k2[r[k]];
    s_valid[j] = valid[r[k]];
    if (values) s_val[j] = one_touch ? __ldcs(values + r[k]) : values[r[k]];
  }
  if (tid == 0 && t0 > 0) {
    const long long q = perm ? perm[t0 - 1] : t0 - 1;
    s_k1[0] = k1[k1_sorted ? t0 - 1 : q];
    s_k2[0] = k2[q];
  }
  __syncthreads();
  // Boundary flags of every row.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j >= tile_n) continue;
    const long long i = t0 + j;
    uint8_t f = kNewPair | kNewPid;
    if (i != 0 && !p.lane_start(i)) {
      const long long a1 = s_k1[j + 1], b1 = s_k1[j];
      f = (a1 >> 32) != (b1 >> 32) ? kNewPid : 0;
      if (a1 != b1 || s_k2[j + 1] != s_k2[j]) f |= kNewPair;
    }
    s_flag[j] = f;
  }
  __syncthreads();
  // Scan: thread t owns rows [8t, 8t + 8) of the tile.
  const int first = tid * kItems;
  uint64_t flags8 = *reinterpret_cast<const uint64_t*>(s_flag + first);
  BoundAgg e[kItems];
  BoundAgg acc = BoundOp::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint8_t f = static_cast<uint8_t>(flags8 >> (8 * k));
    const bool in = first + k < tile_n;
    const bool np = in && (f & kNewPair), npid = in && (f & kNewPid);
    e[k] = BoundAgg{np ? t0 + first + k : -1, np ? 1 : 0, npid ? 1 : 0, 0};
    acc = BoundOp::combine(acc, e[k]);
  }
  BoundAgg total;
  const BoundAgg excl =
      pdp::block_exclusive_scan<BoundOp>(acc, scan_smem, &total);
  const BoundAgg before = pdp::tile_prefix<BoundOp>(
      scan, tile, tile == 0 || (s_flag[0] & kNewPid), total);
  BoundAgg state = BoundOp::combine(before, excl);
  uint64_t keep8 = flags8;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = first + k;
    if (j >= tile_n) break;
    state = BoundOp::combine(state, e[k]);
    const long long rank = t0 + j - state.a, pair_rank = state.c - 1;
    const bool keep = s_valid[j] != 0 && (p.linf == 0 || rank < p.linf) &&
                      (p.l0 == 0 || pair_rank < p.l0);
    if (keep) keep8 |= static_cast<uint64_t>(kKeep) << (8 * k);
  }
  *reinterpret_cast<uint64_t*>(s_flag + first) = keep8;
  __syncthreads();
  // Outputs, coalesced.
  const int dropped = p.n_lanes * p.n_partitions;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j >= tile_n) continue;
    const long long i = t0 + j;
    const uint8_t f = s_flag[j];
    const bool keep = f & kKeep;
    const bool starts = keep && (f & kNewPair);
    const int32_t spk = static_cast<int32_t>(s_k2[j + 1] & 0xFFFFFFFFll);
    __stcs(key2 + i, keep ? static_cast<int32_t>(p.lane(i) * p.n_partitions +
                                                 spk)
                          : dropped);
    pair_start[i] = starts ? 1 : 0;
    if (!sum && !nsum) continue;
    const F clipped = clipped_value(p, s_val[j]);
    if (sum) {
      F contrib = keep ? clipped : F(0);
      if (p.clip_pair_sum) {
        F total_s = contrib;
        if (starts) {
          // The pair's rows in order: staged, then past the tile's end.
          const long long pk1 = s_k1[j + 1], pk2 = s_k2[j + 1];
          for (long long m = 1;; ++m) {
            if (p.linf != 0 && m >= p.linf) break;
            const long long jj = j + m;
            if (jj < tile_n) {
              if (s_flag[jj] & kNewPair) break;
              if (s_valid[jj]) total_s = total_s + clipped_value(p, s_val[jj]);
              continue;
            }
            const long long ii = t0 + jj;
            if (ii >= p.n || p.lane_start(ii)) break;
            const long long rj = perm ? perm[ii] : ii;
            if (k1[k1_sorted ? ii : rj] != pk1 || k2[rj] != pk2) break;
            if (valid[rj]) total_s = total_s + clipped_value(p, values[rj]);
          }
        }
        contrib = starts ? clip(total_s, p.min_s, p.max_s) : F(0);
      }
      __stcs(sum + i, contrib);
    }
    if (nsum) {
      const F centered = keep ? clipped - p.mid : F(0);
      __stcs(nsum + i, centered);
      if (nsum2) __stcs(nsum2 + i, centered * centered);
    }
  }
}

// Rows that are their own pairs (contribution bounds enforced), in order.
template <typename F>
__global__ void __launch_bounds__(kThreads)
    bound_keyless(Params<F> p, const int32_t* __restrict__ pk,
                  const F* __restrict__ values,
                  const uint8_t* __restrict__ valid,
                  int32_t* __restrict__ key2,
                  uint8_t* __restrict__ pair_start, F* __restrict__ sum,
                  F* __restrict__ nsum, F* __restrict__ nsum2) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < p.n; i += stride) {
    const bool keep = valid[i] != 0;
    key2[i] = keep ? static_cast<int32_t>(p.lane(i) * p.n_partitions + pk[i])
                   : p.n_lanes * p.n_partitions;
    pair_start[i] = keep ? 1 : 0;
    if (!sum && !nsum) continue;
    const F clipped = clipped_value(p, values[i]);
    if (sum) {
      const F contrib = keep ? clipped : F(0);
      sum[i] = p.clip_pair_sum ? (keep ? clip(contrib, p.min_s, p.max_s)
                                       : F(0))
                               : contrib;
    }
    if (nsum) {
      const F centered = keep ? clipped - p.mid : F(0);
      nsum[i] = centered;
      if (nsum2) nsum2[i] = centered * centered;
    }
  }
}

// Total bound. K is int32 (a pid) or int64 (lane << 32 | pid, the lane
// entry).
__device__ __forceinline__ int32_t pid_of(int32_t k) { return k; }
__device__ __forceinline__ int32_t pid_of(long long k) {
  return static_cast<int32_t>(k & 0xFFFFFFFFll);
}

template <typename F, typename K>
__global__ void __launch_bounds__(kThreads)
    total_tiles(const long long* __restrict__ perm, const K* __restrict__ spid,
                long long n, long long total_bound, int n_partitions,
                const int32_t* __restrict__ pk, const F* __restrict__ values,
                const uint8_t* __restrict__ valid, pdp::Scan<long long> scan,
                int32_t* __restrict__ pid_out, int32_t* __restrict__ pk_out,
                F* __restrict__ values_out, uint8_t* __restrict__ valid_out) {
  __shared__ K s_pid[kTile + 1];  // [0]: row t0 - 1
  __shared__ __align__(8) uint8_t s_flag[kTile];
  __shared__ long long scan_smem[32];
  const long long tile = pdp::claim_tile(scan.counter);
  const long long t0 = tile * kTile;
  const int tile_n = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
  const int tid = threadIdx.x;
  // Stage: the sorted pid and perm coalesced; pk, value and valid
  // gathered once, kept in registers for the writes.
  int32_t g_pk[kItems];
  F g_val[kItems];
  uint8_t g_valid[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j >= tile_n) continue;
    const long long r = perm[t0 + j];
    s_pid[j + 1] = spid[t0 + j];
    g_pk[k] = pk[r];
    g_val[k] = values[r];
    g_valid[k] = valid[r];
  }
  if (tid == 0 && t0 > 0) s_pid[0] = spid[t0 - 1];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j < tile_n)
      s_flag[j] = t0 + j == 0 || s_pid[j + 1] != s_pid[j] ? 1 : 0;
  }
  __syncthreads();
  const int first = tid * kItems;
  const uint64_t flags8 = *reinterpret_cast<const uint64_t*>(s_flag + first);
  long long e[kItems];
  long long acc = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool start = first + k < tile_n && ((flags8 >> (8 * k)) & 1);
    e[k] = start ? t0 + first + k : -1;
    acc = pdp::MaxPosOp::combine(acc, e[k]);
  }
  long long total;
  const long long excl =
      pdp::block_exclusive_scan<pdp::MaxPosOp>(acc, scan_smem, &total);
  const long long before = pdp::tile_prefix<pdp::MaxPosOp>(
      scan, tile, tile == 0 || s_flag[0] != 0, total);
  long long state = pdp::MaxPosOp::combine(before, excl);
  uint64_t keep8 = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (first + k >= tile_n) break;
    state = pdp::MaxPosOp::combine(state, e[k]);
    if (t0 + first + k - state < total_bound) keep8 |= 1ull << (8 * k);
  }
  *reinterpret_cast<uint64_t*>(s_flag + first) = keep8;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j >= tile_n) continue;
    const long long i = t0 + j;
    const bool v = g_valid[k] != 0 && s_flag[j] != 0;
    pid_out[i] = v ? pid_of(s_pid[j + 1]) : 0x7FFFFFFF;
    pk_out[i] = v ? g_pk[k] : n_partitions;
    values_out[i] = g_val[k];
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
  const long long tiles = tiles_of(n);
  cudaMemsetAsync(scratch, 0, pdp::scan_reset_bytes(tiles), s);
  total_tiles<F, K><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const long long*>(perm), static_cast<const K*>(spid), n,
      total_bound, n_partitions, static_cast<const int32_t*>(pk),
      static_cast<const F*>(values), static_cast<const uint8_t*>(valid),
      pdp::carve_scan<long long>(scratch, tiles), static_cast<int32_t*>(pid_out),
      static_cast<int32_t*>(pk_out), static_cast<F*>(values_out),
      static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch(const void* perm, const void* k1, bool k1_sorted,
           const void* k2, const void* pk,
           const void* values, const void* valid, long long n,
           long long lane_rows, int n_partitions, long long linf,
           long long l0, int clip_per_value, int clip_pair_sum,
           const double* scalars, void* scratch, void* key2,
           void* pair_start, void* sum, void* nsum, void* nsum2,
           void* stream) {
  if (n <= 0) return 0;
  if (lane_rows < 0 || (lane_rows > 0 && n % lane_rows != 0)) return -1;
  if (k1 == nullptr && pk == nullptr) return -1;
  if ((k1 == nullptr) != (k2 == nullptr)) return -1;
  if ((sum != nullptr || nsum != nullptr) && values == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_lanes = lane_rows > 0 ? static_cast<int>(n / lane_rows) : 1;
  Params<F> p{n,
              lane_rows,
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
  if (k1 == nullptr) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    bound_keyless<F><<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192),
                       kThreads, 0, s>>>(
        p, static_cast<const int32_t*>(pk), static_cast<const F*>(values),
        static_cast<const uint8_t*>(valid), static_cast<int32_t*>(key2),
        static_cast<uint8_t*>(pair_start), static_cast<F*>(sum),
        static_cast<F*>(nsum), static_cast<F*>(nsum2));
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = tiles_of(n);
  constexpr int kBytes = tile_bytes<F>();
  cudaFuncSetAttribute(bound_tiles<F>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  cudaMemsetAsync(scratch, 0, pdp::scan_reset_bytes(tiles), s);
  bound_tiles<F><<<static_cast<unsigned>(tiles), kThreads, kBytes, s>>>(
      p, static_cast<const long long*>(perm),
      static_cast<const long long*>(k1), k1_sorted,
      static_cast<const long long*>(k2),
      static_cast<const F*>(values), static_cast<const uint8_t*>(valid),
      pdp::carve_scan<BoundAgg>(scratch, tiles), static_cast<int32_t*>(key2),
      static_cast<uint8_t*>(pair_start), static_cast<F*>(sum),
      static_cast<F*>(nsum), static_cast<F*>(nsum2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch the caller allocates for n rows (either entry): the tile
// counter, a status word and two published aggregates per tile of 2048.
extern "C" long long bound_rows_scratch_bytes(long long n) {
  return static_cast<long long>(pdp::scan_bytes<BoundAgg>(tiles_of(n)));
}

// scalars = (min_v, max_v, min_s, max_s, mid). sk1 is k1 in sorted order
// (radix_sort's sorted_top of the bounding sort). sk1/k2 null: rows are
// their own pairs and pk supplies the partition (contribution bounds
// enforced).
extern "C" int bound_rows(const void* perm, const void* sk1, const void* k2,
                          const void* pk, const void* values,
                          const void* valid, long long n, int n_partitions,
                          long long linf, long long l0, int clip_per_value,
                          int clip_pair_sum, const double* scalars,
                          void* scratch, void* key2, void* pair_start,
                          void* sum, void* nsum, void* nsum2, int f64,
                          void* stream) {
  return f64 ? launch<double>(perm, sk1, true, k2, pk, values, valid, n, 0,
                              n_partitions, linf, l0, clip_per_value,
                              clip_pair_sum, scalars, scratch, key2,
                              pair_start, sum, nsum, nsum2, stream)
             : launch<float>(perm, sk1, true, k2, pk, values, valid, n, 0,
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
  return f64 ? launch<double>(perm, k1, false, k2, pk, values, valid, n,
                              lane_rows, n_partitions, linf, l0,
                              clip_per_value, clip_pair_sum, scalars,
                              scratch, key2, pair_start, sum, nsum, nsum2,
                              stream)
             : launch<float>(perm, k1, false, k2, pk, values, valid, n,
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
