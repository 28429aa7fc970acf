// C3 reduce_partitions: dense per-partition columns from the bounded rows.
//
// Replaces the partition half of K5: pipelinedp_tpu/executor.py
// reduce_rows_to_partitions (:455-514), which takes cumsum differences
// (ops/segment_ops.py:78 chunked_cumsum) at searchsorted partition starts;
// the compensated sums of K14 (ops/segment_ops.py:122,138); the blocked
// route's reduction, parallel/large_p.py:183 _block_trace; and a lane of
// K24a, executor.py:984.
//
// Rows arrive sorted by key2 = keep ? partition : n_partitions
// (executor.py:476-484): `skey2` is that sorted key and `perm` maps each
// sorted position to its bounded row. The reduction is a segmented sum
// over the sorted stream; the last row of each partition's run writes that
// partition's count, pid_count, sum, nsum and nsum2, and the entry zero-
// fills the outputs first, so partitions with no kept row read 0.
//
// Bound on this card: bytes. skey2 (4 B a row) and perm (8 B) stream;
// pair_start and up to three F columns are gathered through perm, a 32-byte
// sector for 1-4 useful bytes each; the outputs are 5 F columns of
// n_partitions. The gathers dominate on the dense route.
//
// Design: one pass, tiles of 512 rows (1024 for the vector entry), a
// look-back over tile aggregates.
//   * A block claims its tile from an atomic counter, so tiles start in
//     order and no block waits on one that has not started. Each thread
//     reads its 2 rows' keys and perm entries, then issues their column
//     gathers together: every row is gathered once. Small tiles keep a
//     few resident blocks an SM busy on a window of ~0.6M rows.
//   * The block scans its tile (each thread's rows in order, then a warp
//     and a block scan: a fixed association) and publishes the tile's
//     aggregate with a ready flag (release / acquire, gpu scope).
//   * A tile whose first row continues a run that ends inside it, at a
//     kept partition, folds the earlier tiles' aggregates back to the tile
//     where the run began: warp 0 takes them 32 at a time, nearest last,
//     in a warp scan, and a tile in which a run starts (SegOp's f flag)
//     ends the walk. Only aggregates are read, never inclusive prefixes,
//     so the association depends on the data and the tiling alone: the
//     same inputs give the same bits on every run, and no float atomics
//     are used. Only tiles holding such a run end walk, each run's tiles
//     once, so the walk stays linear when one partition holds every row.
//   * One C call: it zero-fills the outputs and resets the counter and the
//     flags with one cudaMemsetAsync (the wrapper allocates the scratch
//     right after the outputs), then launches once (once per four
//     coordinates of a vector sum).
//   * What is left: the gathers are random 32-byte sectors, so the device
//     time stays several times the bound of useful bytes; on a window of
//     ~0.6M rows the wrapper's host time (checks, one allocation, the
//     ctypes call) is as long as the kernel's.
//
// A second entry, reduce_vectors, sums VECTOR_SUM's D value coordinates
// per partition (executor.py:408-411 and the vsum stack at :509-511): the
// same scan, four coordinates a launch, with each sorted row's
// coordinates gathered through both permutations (partition sort, then
// bounding sort) instead of a bounded n x D copy.
//
// The compensated entry (numeric_mode="safe") carries each float32 sum as
// a TwoSum pair (hi, lo) through the same scan: hi the rounded sum, lo the
// exact residues of its additions, added in plain float. A partition's sum
// is emitted as hi + lo rounded once: exact for integer-valued sums to
// ~2^48, where a float32 sum drops low bits past 2^24. Each run is summed
// directly, so no long prefix is differenced; an overflowed hi is emitted
// as is (Inf, or NaN where +Inf and -Inf met), never the NaN of its
// residues. The file is built with --fmad=false and no fast-math: a
// contracted or reassociated TwoSum loses the residue. float64 and the
// integer counts take the plain entry, as in the JAX package
// (segment_ops.py:132-133).
//
// The windowed entry (the blocked route, whose rows are a window [lo,
// lo + len) of the partition-sorted stream rebased to spk - base) is the
// same scan over a window: the caller passes skey2 + lo and perm + lo, row
// r's partition is skey2[r] - base, and a result outside [0, n_partitions)
// is dropped, so the rows of neighbouring blocks and the dropped rows'
// sentinel write nothing. perm may be null: the rows are then in sorted
// order already (the host-staged stream) and pair_start and the columns
// are windows too. The dense route passes base 0 and a permutation.
//
// The lane entries (L jobs' partitions as one range of L * P): lane l's
// kept rows are the window [bounds[l], bounds[l + 1]) of the stream
// (key2 = l * P + partition; the dropped rows' L * P sorts last), found by
// lane_bounds. Each lane is tiled from its own first row and walks back
// within itself, so a position of lane l is summed with the association of
// the same position in the lane's solo run, whose kept rows start the
// stream: the float sums are bit for bit the solo kernel's.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;    // threads a tile
constexpr int kScalarItems = 2;  // consecutive rows a thread: 512-row tiles
constexpr int kVectorItems = 4;  // (the vector entry: 1024-row tiles)
constexpr int kVec = 4;          // coordinates a vector launch

long long tiles_of(long long n, int items) {
  const long long rows = static_cast<long long>(kThreads) * items;
  return (n + rows - 1) / rows;
}

// A float sum: plain (C false) or compensated (C true).
template <typename F, bool C>
struct Acc;

template <typename F>
struct Acc<F, false> {
  F v;
  static __device__ __forceinline__ Acc of(F x) { return Acc{x}; }
  __device__ __forceinline__ Acc plus(const Acc& o) const {
    return Acc{v + o.v};
  }
  __device__ __forceinline__ F value() const { return v; }
  __device__ __forceinline__ Acc shfl_up(int d) const {
    return Acc{__shfl_up_sync(pdp::kFullMask, v, d)};
  }
  __device__ __forceinline__ Acc shfl(int src) const {
    return Acc{__shfl_sync(pdp::kFullMask, v, src)};
  }
};

template <typename F>
struct Acc<F, true> {
  F hi, lo;
  static __device__ __forceinline__ Acc of(F x) { return Acc{x, F(0)}; }
  // _comp_combine: (s, e) = TwoSum(hi, o.hi), lo' = e + (lo + o.lo).
  __device__ __forceinline__ Acc plus(const Acc& o) const {
    const F s = hi + o.hi;
    const F bv = s - hi;
    const F av = s - bv;
    const F e = (hi - av) + (o.hi - bv);
    return Acc{s, e + (lo + o.lo)};
  }
  __device__ __forceinline__ F value() const {
    return isfinite(hi) ? hi + lo : hi;
  }
  __device__ __forceinline__ Acc shfl_up(int d) const {
    return Acc{__shfl_up_sync(pdp::kFullMask, hi, d),
               __shfl_up_sync(pdp::kFullMask, lo, d)};
  }
  __device__ __forceinline__ Acc shfl(int src) const {
    return Acc{__shfl_sync(pdp::kFullMask, hi, src),
               __shfl_sync(pdp::kFullMask, lo, src)};
  }
};

template <typename F, bool C>
struct Seg {
  long long cnt, pc;
  Acc<F, C> s, ns, ns2;
  int f;  // a segment starts inside
};

template <typename F, bool C>
struct SegOp {
  using T = Seg<F, C>;
  static __device__ __forceinline__ T identity() {
    const Acc<F, C> z = Acc<F, C>::of(F(0));
    return T{0, 0, z, z, z, 0};
  }
  static __device__ __forceinline__ T combine(T x, T y) {
    if (y.f) return T{y.cnt, y.pc, y.s, y.ns, y.ns2, 1};
    return T{x.cnt + y.cnt, x.pc + y.pc, x.s.plus(y.s), x.ns.plus(y.ns),
             x.ns2.plus(y.ns2), x.f};
  }
  static __device__ __forceinline__ T shfl_up(T v, int d) {
    v.cnt = __shfl_up_sync(pdp::kFullMask, v.cnt, d);
    v.pc = __shfl_up_sync(pdp::kFullMask, v.pc, d);
    v.s = v.s.shfl_up(d);
    v.ns = v.ns.shfl_up(d);
    v.ns2 = v.ns2.shfl_up(d);
    v.f = __shfl_up_sync(pdp::kFullMask, v.f, d);
    return v;
  }
  static __device__ __forceinline__ bool ends_walk(const T& v) {
    return v.f != 0;
  }
  static __device__ __forceinline__ T shfl(T v, int src) {
    v.cnt = __shfl_sync(pdp::kFullMask, v.cnt, src);
    v.pc = __shfl_sync(pdp::kFullMask, v.pc, src);
    v.s = v.s.shfl(src);
    v.ns = v.ns.shfl(src);
    v.ns2 = v.ns2.shfl(src);
    v.f = __shfl_sync(pdp::kFullMask, v.f, src);
    return v;
  }
};

template <typename F, bool C>
struct VSeg {
  Acc<F, C> v[kVec];
  int f;  // a segment starts inside
};

template <typename F, bool C>
struct VSegOp {
  using T = VSeg<F, C>;
  static __device__ __forceinline__ T identity() {
    T t;
#pragma unroll
    for (int c = 0; c < kVec; ++c) t.v[c] = Acc<F, C>::of(F(0));
    t.f = 0;
    return t;
  }
  static __device__ __forceinline__ T combine(T x, T y) {
    if (y.f) return y;
#pragma unroll
    for (int c = 0; c < kVec; ++c) x.v[c] = x.v[c].plus(y.v[c]);
    return x;
  }
  static __device__ __forceinline__ T shfl_up(T v, int d) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) v.v[c] = v.v[c].shfl_up(d);
    v.f = __shfl_up_sync(pdp::kFullMask, v.f, d);
    return v;
  }
  static __device__ __forceinline__ bool ends_walk(const T& v) {
    return v.f != 0;
  }
  static __device__ __forceinline__ T shfl(T v, int src) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) v.v[c] = v.v[c].shfl(src);
    v.f = __shfl_sync(pdp::kFullMask, v.f, src);
    return v;
  }
};

// The scalar columns: gathers through perm (null: position i is bounded
// row i) and the run-end writes.
template <typename F, bool C>
struct ScalarRows {
  using Op = SegOp<F, C>;
  using T = Seg<F, C>;
  static constexpr int kItems = kScalarItems;
  const long long* perm;
  const uint8_t* pair_start;
  const F* sum;
  const F* nsum;
  const F* nsum2;
  F* count;
  F* pid_count;
  F* out_sum;
  F* out_nsum;
  F* out_nsum2;

  __device__ __forceinline__ long long row(long long i) const {
    return perm ? __ldg(perm + i) : i;
  }
  __device__ __forceinline__ T element(long long r, int f) const {
    return T{1,
             __ldg(pair_start + r),
             Acc<F, C>::of(sum ? __ldg(sum + r) : F(0)),
             Acc<F, C>::of(nsum ? __ldg(nsum + r) : F(0)),
             Acc<F, C>::of(nsum2 ? __ldg(nsum2 + r) : F(0)),
             f};
  }
  __device__ __forceinline__ void write(long long key, const T& s) const {
    count[key] = static_cast<F>(s.cnt);
    pid_count[key] = static_cast<F>(s.pc);
    if (out_sum) out_sum[key] = s.s.value();
    if (out_nsum) out_nsum[key] = s.ns.value();
    if (out_nsum2) out_nsum2[key] = s.ns2.value();
  }
};

// Coordinates [d0, d0 + kVec) of the vector values: sorted position i is
// bounded row perm[i] (null: i), whose values are row row_perm[r] (null:
// r) of values[*, dim]; vsum is partition-major, dim a partition.
template <typename F, bool C>
struct VectorRows {
  using Op = VSegOp<F, C>;
  using T = VSeg<F, C>;
  static constexpr int kItems = kVectorItems;
  const long long* perm;
  const long long* row_perm;
  const F* values;
  F* vsum;
  int dim, d0;

  __device__ __forceinline__ long long row(long long i) const {
    const long long r = perm ? __ldg(perm + i) : i;
    return row_perm ? __ldg(row_perm + r) : r;
  }
  __device__ __forceinline__ T element(long long r, int f) const {
    const F* v = values + r * dim + d0;
    T e;
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      e.v[c] = Acc<F, C>::of(d0 + c < dim ? __ldg(v + c) : F(0));
    e.f = f;
    return e;
  }
  __device__ __forceinline__ void write(long long key, const T& s) const {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      if (d0 + c < dim) vsum[key * dim + d0 + c] = s.v[c].value();
    }
  }
};

// The scan of one tile. Solo (bounds null): the rows are [0, n) of skey2
// / rows, partition skey2 - base, outputs at that partition. Lanes:
// claimed tile v is tile v mod lane_tiles of lane v / lane_tiles, whose
// rows are [bounds[l], bounds[l + 1]) and partitions skey2 - l * P, written
// at skey2 itself (l * P + partition).
template <class Rows>
__global__ void __launch_bounds__(kThreads)
    reduce_tiles(Rows rows, const int32_t* __restrict__ skey2, long long n,
                 long long base, int n_partitions,
                 const long long* __restrict__ bounds, long long lane_tiles,
                 unsigned long long* counter, int* ready,
                 typename Rows::T* aggs) {
  using Op = typename Rows::Op;
  using T = typename Rows::T;
  constexpr int kItems = Rows::kItems;
  __shared__ T smem[32];
  __shared__ T s_prefix;
  __shared__ long long s_claim;
  if (threadIdx.x == 0)
    s_claim = static_cast<long long>(atomicAdd(counter, 1ULL));
  __syncthreads();
  const long long v = s_claim;
  long long tile = v, lo = 0, out_at = 0;
  if (bounds != nullptr) {
    const long long lane = v / lane_tiles;
    tile = v - lane * lane_tiles;
    lo = bounds[lane];
    n = bounds[lane + 1] - lo;
    base = lane * n_partitions;
    out_at = base;
  }
  const long long t0 = tile * kThreads * kItems;
  if (t0 >= n) return;  // a lane's tile past its rows: none reads it
  const int32_t* key = skey2 + lo;
  const long long first = t0 + static_cast<long long>(threadIdx.x) * kItems;

  int32_t k_[kItems];
  long long r_[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + k;
    k_[k] = i < n ? key[i] : 0;
    r_[k] = i < n ? rows.row(lo + i) : 0;
  }
  const int32_t prev = first > 0 && first < n ? key[first - 1] : 0;
  const int32_t next = first + kItems < n ? key[first + kItems] : 0;
  T e[kItems];
  bool last[kItems];
  bool any_last = false;
  T acc = Op::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + k;
    last[k] = false;
    e[k] = Op::identity();
    if (i < n) {
      const int32_t before = k ? k_[k - 1] : prev;
      const int32_t after = k + 1 < kItems ? k_[k + 1] : next;
      e[k] = rows.element(r_[k], (i == 0 || k_[k] != before) ? 1 : 0);
      last[k] = i + 1 == n || k_[k] != after;
      any_last |= last[k];
      acc = Op::combine(acc, e[k]);
    }
  }
  T total;
  const T excl = pdp::block_exclusive_scan<Op>(acc, smem, &total);
  const bool ends = __syncthreads_or(any_last);
  if (threadIdx.x == 0) pdp::publish(aggs + v, ready + v, total, 1);
  if (threadIdx.x < 32) {
    // The tile's first run needs the rows before the tile when it began
    // earlier, ends here and is kept.
    T prefix = Op::identity();
    const long long key0 = static_cast<long long>(key[t0]) - base;
    if (t0 > 0 && ends && key[t0 - 1] == key[t0] && key0 >= 0 &&
        key0 < n_partitions)
      prefix = pdp::look_back<Op>(aggs, nullptr, ready, v - tile, tile);
    if (threadIdx.x == 0) s_prefix = prefix;
  }
  __syncthreads();
  T state = Op::combine(s_prefix, excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + k;
    if (i >= n) break;
    state = Op::combine(state, e[k]);
    const long long kk = static_cast<long long>(k_[k]) - base;
    if (last[k] && kk >= 0 && kk < n_partitions) rows.write(out_at + kk, state);
  }
}

// bounds[l] = the first position with skey2 >= l * n_partitions, for l in
// [0, n_lanes].
__global__ void lane_bounds(const int32_t* __restrict__ skey2, long long n,
                            int n_partitions, int n_lanes,
                            long long* __restrict__ bounds) {
  const long long l =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l > n_lanes) return;
  const long long target = l * n_partitions;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (static_cast<long long>(skey2[mid]) < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  bounds[l] = lo;
}

// The scratch of `groups` scans of `tiles` tiles (one group a launch):
// their counters and ready flags (reset by one memset), the aggregates
// (shared: the launches run in stream order) and, for lanes, the L + 1
// lane bounds.
struct Scratch {
  long long flags_at, aggs_at, bounds_at, total;
};

long long round16(long long b) { return (b + 15) / 16 * 16; }

Scratch scratch_layout(long long tiles, int groups, long long agg_bytes,
                       long long n_lanes) {
  Scratch s;
  s.flags_at = round16(groups * 8LL);
  s.aggs_at = s.flags_at + round16(groups * tiles * 4LL);
  s.bounds_at = s.aggs_at + round16(tiles * agg_bytes);
  s.total = s.bounds_at + (n_lanes > 0 ? (n_lanes + 1) * 8LL : 0);
  return s;
}

int vector_groups(int dim) { return (dim + kVec - 1) / kVec; }

template <typename F, bool C>
long long agg_bytes(bool vec) {
  return vec ? sizeof(VSeg<F, C>) : sizeof(Seg<F, C>);
}

long long agg_bytes_of(int f64, int comp, bool vec) {
  if (f64) return agg_bytes<double, false>(vec);
  return comp ? agg_bytes<float, true>(vec) : agg_bytes<float, false>(vec);
}

// One launch of reduce_tiles for group g of the scratch.
template <class Rows>
void launch_group(const Rows& rows, const void* skey2, long long n,
                  long long base, int n_partitions, const long long* bounds,
                  long long lane_tiles, long long tiles, int g, char* scratch,
                  const Scratch& lay, cudaStream_t s) {
  auto* counter = reinterpret_cast<unsigned long long*>(scratch) + g;
  int* ready = reinterpret_cast<int*>(scratch + lay.flags_at) + g * tiles;
  auto* aggs = reinterpret_cast<typename Rows::T*>(scratch + lay.aggs_at);
  reduce_tiles<Rows><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      rows, static_cast<const int32_t*>(skey2), n, base, n_partitions,
      bounds, lane_tiles, counter, ready, aggs);
}

// The lane bounds, found before the scan (lanes), or null (a solo scan).
const long long* find_bounds(const void* skey2, long long n, int n_partitions,
                             long long n_lanes, char* scratch,
                             const Scratch& lay, cudaStream_t s) {
  if (n_lanes == 0) return nullptr;
  auto* bounds = reinterpret_cast<long long*>(scratch + lay.bounds_at);
  lane_bounds<<<static_cast<unsigned>((n_lanes + 1 + 255) / 256), 256, 0,
                s>>>(static_cast<const int32_t*>(skey2), n, n_partitions,
                     static_cast<int>(n_lanes), bounds);
  return bounds;
}

bool lane_shape(long long n, long long lane_rows, const void* perm,
                long long* n_lanes) {
  if (lane_rows <= 0 || n % lane_rows != 0 || perm == nullptr) return false;
  *n_lanes = n / lane_rows;
  return *n_lanes <= 65535;
}

template <typename F, bool C>
int run_scalar(const void* skey2, const void* perm, const void* pair_start,
               const void* row_sum, const void* row_nsum,
               const void* row_nsum2, long long n, long long lane_rows,
               bool lanes, int n_partitions, long long base, void* scratch,
               void* fill, long long fill_bytes, void* count, void* pid_count,
               void* sum, void* nsum, void* nsum2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long n_lanes = 0;
  if (lanes && n > 0 && !lane_shape(n, lane_rows, perm, &n_lanes)) return -1;
  const long long lane_tiles = lanes ? tiles_of(lane_rows, kScalarItems) : 0;
  const long long tiles =
      lanes ? n_lanes * lane_tiles : tiles_of(n, kScalarItems);
  const Scratch lay = scratch_layout(tiles, 1, sizeof(Seg<F, C>), n_lanes);
  char* sc = static_cast<char*>(scratch);
  // One memset where the caller placed the scratch right after the
  // outputs (kernels._c3_buffer).
  const bool joined = static_cast<char*>(fill) + fill_bytes == sc;
  const long long head = n > 0 ? lay.aggs_at : 0;
  if (fill_bytes + (joined ? head : 0) > 0)
    cudaMemsetAsync(fill, 0, fill_bytes + (joined ? head : 0), s);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (!joined) cudaMemsetAsync(sc, 0, lay.aggs_at, s);
  const long long* bounds =
      find_bounds(skey2, n, n_partitions, n_lanes, sc, lay, s);
  const ScalarRows<F, C> rows{static_cast<const long long*>(perm),
                              static_cast<const uint8_t*>(pair_start),
                              static_cast<const F*>(row_sum),
                              static_cast<const F*>(row_nsum),
                              static_cast<const F*>(row_nsum2),
                              static_cast<F*>(count),
                              static_cast<F*>(pid_count),
                              static_cast<F*>(sum),
                              static_cast<F*>(nsum),
                              static_cast<F*>(nsum2)};
  launch_group(rows, skey2, n, base, n_partitions, bounds, lane_tiles,
               tiles, 0, sc, lay, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename F, bool C>
int run_vectors(const void* skey2, const void* perm, const void* row_perm,
                const void* values, long long n, long long lane_rows,
                bool lanes, int dim, int n_partitions, long long base,
                void* scratch, void* vsum, void* stream) {
  if (dim < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long n_lanes = 0;
  if (lanes && n > 0 && !lane_shape(n, lane_rows, perm, &n_lanes)) return -1;
  const long long out_bytes =
      (lanes ? n_lanes : 1) * n_partitions * dim * sizeof(F);
  if (out_bytes > 0) cudaMemsetAsync(vsum, 0, out_bytes, s);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int groups = vector_groups(dim);
  const long long lane_tiles = lanes ? tiles_of(lane_rows, kVectorItems) : 0;
  const long long tiles =
      lanes ? n_lanes * lane_tiles : tiles_of(n, kVectorItems);
  const Scratch lay =
      scratch_layout(tiles, groups, sizeof(VSeg<F, C>), n_lanes);
  char* sc = static_cast<char*>(scratch);
  cudaMemsetAsync(sc, 0, lay.aggs_at, s);
  const long long* bounds =
      find_bounds(skey2, n, n_partitions, n_lanes, sc, lay, s);
  for (int g = 0; g < groups; ++g) {
    const VectorRows<F, C> rows{static_cast<const long long*>(perm),
                                static_cast<const long long*>(row_perm),
                                static_cast<const F*>(values),
                                static_cast<F*>(vsum), dim, g * kVec};
    launch_group(rows, skey2, n, base, n_partitions, bounds, lane_tiles,
                 tiles, g, sc, lay, s);
  }
  return static_cast<int>(cudaGetLastError());
}

long long scratch_bytes(long long tiles, int groups, int f64, int comp,
                        bool vec, long long n_lanes) {
  return scratch_layout(tiles, groups, agg_bytes_of(f64, comp, vec), n_lanes)
      .total;
}

}  // namespace

extern "C" long long reduce_partitions_scratch_bytes(long long n, int f64,
                                                     int comp) {
  return scratch_bytes(tiles_of(n, kScalarItems), 1, f64, comp, false, 0);
}

// Zero-fills fill[0, fill_bytes) (the caller's block of output columns:
// count, pid_count and the present sums; scratch may follow it directly),
// then writes every partition with a kept row. perm: nullable (rows already in sorted order); base: row i's
// partition is skey2[i] - base (0 on the dense route). comp: compensated
// float32 sums (ignored for float64).
extern "C" int reduce_partitions(const void* skey2, const void* perm,
                                 const void* pair_start, const void* row_sum,
                                 const void* row_nsum, const void* row_nsum2,
                                 long long n, int n_partitions,
                                 long long base, void* scratch, void* fill,
                                 long long fill_bytes, void* count,
                                 void* pid_count, void* sum, void* nsum,
                                 void* nsum2, int f64, int comp,
                                 void* stream) {
  if (f64)
    return run_scalar<double, false>(
        skey2, perm, pair_start, row_sum, row_nsum, row_nsum2, n, 0, false,
        n_partitions, base, scratch, fill, fill_bytes, count, pid_count, sum,
        nsum, nsum2, stream);
  return comp ? run_scalar<float, true>(
                    skey2, perm, pair_start, row_sum, row_nsum, row_nsum2, n,
                    0, false, n_partitions, base, scratch, fill, fill_bytes,
                    count, pid_count, sum, nsum, nsum2, stream)
              : run_scalar<float, false>(
                    skey2, perm, pair_start, row_sum, row_nsum, row_nsum2, n,
                    0, false, n_partitions, base, scratch, fill, fill_bytes,
                    count, pid_count, sum, nsum, nsum2, stream);
}

extern "C" long long reduce_vectors_scratch_bytes(long long n, int dim,
                                                  int f64, int comp) {
  return scratch_bytes(tiles_of(n, kVectorItems), vector_groups(dim), f64,
                       comp, true, 0);
}

// Vector sums: skey2 / perm / base as for reduce_partitions; row_perm
// (nullable) maps a bounded row to its row of values [*, dim]. vsum:
// [n_partitions, dim], zero-filled here. comp: compensated float32 sums
// (ignored for float64).
extern "C" int reduce_vectors(const void* skey2, const void* perm,
                              const void* row_perm, const void* values,
                              long long n, int dim, int n_partitions,
                              long long base, void* scratch, void* vsum,
                              int f64, int comp, void* stream) {
  if (f64)
    return run_vectors<double, false>(skey2, perm, row_perm, values, n, 0,
                                      false, dim, n_partitions, base,
                                      scratch, vsum, stream);
  return comp ? run_vectors<float, true>(skey2, perm, row_perm, values, n, 0,
                                         false, dim, n_partitions, base,
                                         scratch, vsum, stream)
              : run_vectors<float, false>(skey2, perm, row_perm, values, n,
                                          0, false, dim, n_partitions, base,
                                          scratch, vsum, stream);
}

// Scratch of the lane entries: dim 0 for reduce_partitions_lanes, D for
// reduce_vectors_lanes.
extern "C" long long reduce_partitions_lanes_scratch_bytes(long long lane_rows,
                                                           long long n_lanes,
                                                           int f64, int comp,
                                                           int dim) {
  const bool vec = dim > 0;
  return scratch_bytes(
      n_lanes * tiles_of(lane_rows, vec ? kVectorItems : kScalarItems),
      vec ? vector_groups(dim) : 1, f64, comp, vec, n_lanes);
}

// The lane entry: n = L * lane_rows rows sorted by key2 = lane *
// n_partitions + partition (dropped rows L * n_partitions, last); outputs
// are [L * n_partitions], lane l's partitions at [l * n_partitions,
// (l + 1) * n_partitions), in the block fill[0, fill_bytes) zero-filled
// here. comp: compensated float32 sums (ignored for float64).
extern "C" int reduce_partitions_lanes(const void* skey2, const void* perm,
                                       const void* pair_start,
                                       const void* row_sum,
                                       const void* row_nsum,
                                       const void* row_nsum2, long long n,
                                       long long lane_rows, int n_partitions,
                                       void* scratch, void* fill,
                                       long long fill_bytes, void* count,
                                       void* pid_count, void* sum,
                                       void* nsum, void* nsum2, int f64,
                                       int comp, void* stream) {
  if (f64)
    return run_scalar<double, false>(
        skey2, perm, pair_start, row_sum, row_nsum, row_nsum2, n, lane_rows,
        true, n_partitions, 0, scratch, fill, fill_bytes, count, pid_count,
        sum, nsum, nsum2, stream);
  return comp ? run_scalar<float, true>(
                    skey2, perm, pair_start, row_sum, row_nsum, row_nsum2, n,
                    lane_rows, true, n_partitions, 0, scratch, fill,
                    fill_bytes, count, pid_count, sum, nsum, nsum2, stream)
              : run_scalar<float, false>(
                    skey2, perm, pair_start, row_sum, row_nsum, row_nsum2, n,
                    lane_rows, true, n_partitions, 0, scratch, fill,
                    fill_bytes, count, pid_count, sum, nsum, nsum2, stream);
}

// The vector lane entry: skey2 / perm as for reduce_partitions_lanes;
// row_perm (nullable) maps a bounded row to its row of values [*, dim];
// vsum: [L * n_partitions, dim], zero-filled here. Scratch:
// reduce_partitions_lanes_scratch_bytes(..., dim).
extern "C" int reduce_vectors_lanes(const void* skey2, const void* perm,
                                    const void* row_perm, const void* values,
                                    long long n, long long lane_rows,
                                    int dim, int n_partitions, void* scratch,
                                    void* vsum, int f64, int comp,
                                    void* stream) {
  if (f64)
    return run_vectors<double, false>(skey2, perm, row_perm, values, n,
                                      lane_rows, true, dim, n_partitions, 0,
                                      scratch, vsum, stream);
  return comp ? run_vectors<float, true>(skey2, perm, row_perm, values, n,
                                         lane_rows, true, dim, n_partitions,
                                         0, scratch, vsum, stream)
              : run_vectors<float, false>(skey2, perm, row_perm, values, n,
                                          lane_rows, true, dim, n_partitions,
                                          0, scratch, vsum, stream);
}
