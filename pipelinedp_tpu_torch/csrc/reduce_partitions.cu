// C3 reduce_partitions: dense per-partition columns from the bounded rows.
//
// Replaces the partition half of K5: pipelinedp_tpu/executor.py
// reduce_rows_to_partitions (:455-514), which takes cumsum differences
// (ops/segment_ops.py:78 chunked_cumsum) at searchsorted partition starts.
//
// Rows arrive sorted by key2 = keep ? partition : n_partitions
// (executor.py:476-484): `skey2` is that sorted key and `perm` maps each
// sorted position to its bounded row. The reduction is a segmented sum
// over the sorted stream, as a three-pass tile scan: per-tile aggregates,
// one block scanning them in order, then a pass that rescans each tile
// from its prefix. The last row of each partition's run writes that
// partition's count, pid_count, sum, nsum and nsum2; partitions with no
// kept row keep the zeros the caller filled. The tiles, the order in which
// a block combines its threads and the order of the tile prefixes are all
// fixed, and no float atomics are used: the same inputs give the same bits
// on every run. Work per tile is fixed too, so a hot partition spreads
// over as many blocks as it has rows.
//
// A second entry, reduce_vectors, sums VECTOR_SUM's D value coordinates
// per partition (executor.py:408-411 and the vsum stack at :509-511): the
// same tile scan over the same sorted stream, four coordinates a pass set,
// with each sorted row's coordinates gathered through both permutations
// (partition sort, then bounding sort) instead of a bounded n x D copy.
//
// The compensated entry (numeric_mode="safe", K14: ops/segment_ops.py
// compensated_cumsum / compensated_segment_diff, :100-157, used at
// executor.py:488-494) carries each float32 sum as a TwoSum pair (hi, lo)
// through the same scan: hi the rounded sum, lo the exact residues of its
// additions, added in plain float. A partition's sum is emitted as hi + lo
// rounded once: exact for integer-valued sums to ~2^48, where a float32
// sum drops low bits past 2^24. Each run is summed directly, so no long
// prefix is differenced; an overflowed hi is emitted as is (Inf, or NaN
// where +Inf and -Inf met), never the NaN of its residues. The file is
// built with --fmad=false and no fast-math: a contracted or reassociated
// TwoSum loses the residue. float64 and the integer counts take the plain
// entry, as in the JAX package (segment_ops.py:132-133).
//
// The windowed entry (the blocked route, K15b: pipelinedp_tpu/parallel/
// large_p.py _block_trace, :156-212, whose rows are a window [lo, lo + len)
// of the partition-sorted stream rebased to spk - base) is the same scan
// over a window: the caller passes skey2 + lo and perm + lo, row r's
// partition is skey2[r] - base, and a result outside [0, n_partitions) is
// dropped, so the rows of neighbouring blocks and the dropped rows'
// sentinel write nothing. perm may be null: the rows are then in sorted
// order already (the host-staged stream) and pair_start and the columns
// are windows too. The dense route passes base 0 and a permutation.
//
// Bound: bytes. Each pass reads skey2 (4 B) and, in the last pass, perm
// (8 B) and through it pair_start (1 B) and up to three F columns; the
// outputs are 5 F columns of n_partitions. The reads through perm are
// gathers. The vector entry reads perm and row_perm (8 B each) and D F
// values a row, and writes D F values a partition.
#include "common.cuh"

namespace {

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
};

template <typename F, bool C>
struct Rows {
  const int32_t* skey2;
  const long long* perm;
  const uint8_t* pair_start;
  const F* sum;
  const F* nsum;
  const F* nsum2;
  long long n;
  long long base;  // partition of row i: skey2[i] - base

  __device__ __forceinline__ Seg<F, C> element(long long i) const {
    const long long r = perm ? perm[i] : i;
    return Seg<F, C>{1,
                     pair_start[r],
                     Acc<F, C>::of(sum ? sum[r] : F(0)),
                     Acc<F, C>::of(nsum ? nsum[r] : F(0)),
                     Acc<F, C>::of(nsum2 ? nsum2[r] : F(0)),
                     (i == 0 || skey2[i] != skey2[i - 1]) ? 1 : 0};
  }
};

// One tile's aggregate: the rows [tile * kTile, (tile + 1) * kTile) of
// `rows` (identity past rows.n), written by thread 0 to *out.
template <typename F, bool C>
__device__ __forceinline__ void tile_aggregate(const Rows<F, C>& rows,
                                               long long tile,
                                               Seg<F, C>* out) {
  using Op = SegOp<F, C>;
  __shared__ Seg<F, C> smem[32];
  const long long base = tile * pdp::kTile +
                         static_cast<long long>(threadIdx.x) * pdp::kItems;
  Seg<F, C> acc = Op::identity();
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    if (base + k < rows.n) acc = Op::combine(acc, rows.element(base + k));
  }
  Seg<F, C> total;
  pdp::block_exclusive_scan<Op>(acc, smem, &total);
  if (threadIdx.x == 0) *out = total;
}

// Rescans one tile from its prefix; the last row of each partition's run
// writes that partition's columns (partition = skey2 - rows.base, kept
// when in [0, n_partitions)).
template <typename F, bool C>
__device__ __forceinline__ void write_tile(const Rows<F, C>& rows,
                                           long long tile, Seg<F, C> prefix,
                                           int n_partitions, F* count,
                                           F* pid_count, F* sum, F* nsum,
                                           F* nsum2) {
  using Op = SegOp<F, C>;
  __shared__ Seg<F, C> smem[32];
  const long long base = tile * pdp::kTile +
                         static_cast<long long>(threadIdx.x) * pdp::kItems;
  Seg<F, C> elems[pdp::kItems];
  Seg<F, C> acc = Op::identity();
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    elems[k] = base + k < rows.n ? rows.element(base + k) : Op::identity();
    acc = Op::combine(acc, elems[k]);
  }
  Seg<F, C> total;
  const Seg<F, C> excl = pdp::block_exclusive_scan<Op>(acc, smem, &total);
  Seg<F, C> state = Op::combine(prefix, excl);
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    const long long i = base + k;
    if (i >= rows.n) break;
    state = Op::combine(state, elems[k]);
    const int32_t sk = rows.skey2[i];
    const bool last = i + 1 == rows.n || rows.skey2[i + 1] != sk;
    const long long key = static_cast<long long>(sk) - rows.base;
    if (last && key >= 0 && key < n_partitions) {
      count[key] = static_cast<F>(state.cnt);
      pid_count[key] = static_cast<F>(state.pc);
      if (sum) sum[key] = state.s.value();
      if (nsum) nsum[key] = state.ns.value();
      if (nsum2) nsum2[key] = state.ns2.value();
    }
  }
}

template <typename F, bool C>
__global__ void tile_aggregates(Rows<F, C> rows, Seg<F, C>* aggs) {
  tile_aggregate(rows, blockIdx.x, aggs + blockIdx.x);
}

template <typename F, bool C>
__global__ void write_partitions(Rows<F, C> rows, const Seg<F, C>* prefixes,
                                 int n_partitions, F* __restrict__ count,
                                 F* __restrict__ pid_count,
                                 F* __restrict__ sum, F* __restrict__ nsum,
                                 F* __restrict__ nsum2) {
  write_tile(rows, blockIdx.x, prefixes[blockIdx.x], n_partitions, count,
             pid_count, sum, nsum, nsum2);
}

// --- Lane entry: L jobs' partitions as one range of L * P. -------------
//
// Lane l's kept rows are the window [bounds[l], bounds[l + 1]) of the
// partition-sorted stream (key2 = l * P + partition; the dropped rows'
// L * P sorts last). Each lane scans its own window from its own first
// row, in tiles of its own (blockIdx.y = lane, blockIdx.x = tile of the
// lane), and its tile prefixes are scanned by a block of its own. A
// position of lane l is thus summed with the association of the same
// position in the lane's solo run, whose kept rows start the stream: the
// float sums are bit for bit the solo kernel's, not only in the same row
// order. The compensated lane entry (numeric_mode="safe") carries the
// same TwoSum pairs a lane, and the vector lane entry scans each lane's
// window for its D coordinates, four a pass set, as the solo entries do.

// The lane entries' scratch: n_aggs tile aggregates of `each` bytes, then
// the L + 1 lane bounds at the next 16-byte boundary (a float32
// aggregate's size is not a multiple of 8).
__host__ __device__ __forceinline__ long long lane_aggs_bytes(long long n_aggs,
                                                              long long each) {
  return (n_aggs * each + 15) / 16 * 16;
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

template <typename F, bool C>
__device__ __forceinline__ Rows<F, C> lane_window(Rows<F, C> rows,
                                                  const long long* bounds,
                                                  int n_partitions) {
  const long long lane = blockIdx.y;
  const long long lo = bounds[lane];
  rows.skey2 += lo;
  rows.perm += lo;
  rows.n = bounds[lane + 1] - lo;
  rows.base = lane * n_partitions;
  return rows;
}

template <typename F, bool C>
__global__ void tile_aggregates_lanes(Rows<F, C> rows,
                                      const long long* __restrict__ bounds,
                                      int n_partitions, long long lane_tiles,
                                      Seg<F, C>* aggs) {
  const Rows<F, C> w = lane_window(rows, bounds, n_partitions);
  tile_aggregate(w, blockIdx.x, aggs + blockIdx.y * lane_tiles + blockIdx.x);
}

template <class Op>
__global__ void scan_lane_aggregates(typename Op::T* aggs,
                                     long long lane_tiles) {
  __shared__ typename Op::T smem[32];
  pdp::block_scan_in_place<Op>(aggs + blockIdx.x * lane_tiles, lane_tiles,
                               smem, nullptr);
}

template <typename F, bool C>
__global__ void write_partitions_lanes(
    Rows<F, C> rows, const long long* __restrict__ bounds,
    const Seg<F, C>* prefixes, int n_partitions, long long lane_tiles,
    F* __restrict__ count, F* __restrict__ pid_count, F* __restrict__ sum,
    F* __restrict__ nsum, F* __restrict__ nsum2) {
  const Rows<F, C> w = lane_window(rows, bounds, n_partitions);
  if (static_cast<long long>(blockIdx.x) * pdp::kTile >= w.n) return;
  const long long at = static_cast<long long>(blockIdx.y) * n_partitions;
  write_tile(w, blockIdx.x, prefixes[blockIdx.y * lane_tiles + blockIdx.x],
             n_partitions, count + at, pid_count + at,
             sum ? sum + at : nullptr, nsum ? nsum + at : nullptr,
             nsum2 ? nsum2 + at : nullptr);
}

template <typename F, bool C>
int launch(const void* skey2, const void* perm, const void* pair_start,
           const void* row_sum, const void* row_nsum, const void* row_nsum2,
           long long n, int n_partitions, long long base, void* scratch,
           void* count, void* pid_count, void* sum, void* nsum, void* nsum2,
           void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = pdp::n_tiles(n);
  Rows<F, C> rows{static_cast<const int32_t*>(skey2),
               static_cast<const long long*>(perm),
               static_cast<const uint8_t*>(pair_start),
               static_cast<const F*>(row_sum),
               static_cast<const F*>(row_nsum),
               static_cast<const F*>(row_nsum2),
               n,
               base};
  Seg<F, C>* aggs = static_cast<Seg<F, C>*>(scratch);
  tile_aggregates<F, C><<<static_cast<unsigned>(tiles), pdp::kThreads, 0,
                          s>>>(rows, aggs);
  pdp::scan_tile_aggregates<SegOp<F, C>><<<1, 1024, 0, s>>>(aggs, tiles,
                                                            nullptr);
  write_partitions<F, C><<<static_cast<unsigned>(tiles), pdp::kThreads, 0,
                           s>>>(
      rows, aggs, n_partitions, static_cast<F*>(count),
      static_cast<F*>(pid_count), static_cast<F*>(sum),
      static_cast<F*>(nsum), static_cast<F*>(nsum2));
  return static_cast<int>(cudaGetLastError());
}

template <typename F, bool C>
int launch_lanes(const void* skey2, const void* perm, const void* pair_start,
                 const void* row_sum, const void* row_nsum,
                 const void* row_nsum2, long long n, long long lane_rows,
                 int n_partitions, void* scratch, void* count,
                 void* pid_count, void* sum, void* nsum, void* nsum2,
                 void* stream) {
  if (n <= 0) return 0;
  if (lane_rows <= 0 || n % lane_rows != 0 || perm == nullptr) return -1;
  const long long n_lanes = n / lane_rows;
  if (n_lanes > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long lane_tiles = pdp::n_tiles(lane_rows);
  Seg<F, C>* aggs = static_cast<Seg<F, C>*>(scratch);
  long long* bounds = reinterpret_cast<long long*>(
      static_cast<char*>(scratch) +
      lane_aggs_bytes(n_lanes * lane_tiles, sizeof(Seg<F, C>)));
  Rows<F, C> rows{static_cast<const int32_t*>(skey2),
                  static_cast<const long long*>(perm),
                  static_cast<const uint8_t*>(pair_start),
                  static_cast<const F*>(row_sum),
                  static_cast<const F*>(row_nsum),
                  static_cast<const F*>(row_nsum2),
                  n,
                  0};
  lane_bounds<<<static_cast<unsigned>((n_lanes + 1 + 255) / 256), 256, 0,
                s>>>(static_cast<const int32_t*>(skey2), n, n_partitions,
                     static_cast<int>(n_lanes), bounds);
  const dim3 grid(static_cast<unsigned>(lane_tiles),
                  static_cast<unsigned>(n_lanes));
  tile_aggregates_lanes<F, C><<<grid, pdp::kThreads, 0, s>>>(
      rows, bounds, n_partitions, lane_tiles, aggs);
  scan_lane_aggregates<SegOp<F, C>><<<static_cast<unsigned>(n_lanes), 1024,
                                      0, s>>>(aggs, lane_tiles);
  write_partitions_lanes<F, C><<<grid, pdp::kThreads, 0, s>>>(
      rows, bounds, aggs, n_partitions, lane_tiles, static_cast<F*>(count),
      static_cast<F*>(pid_count), static_cast<F*>(sum),
      static_cast<F*>(nsum), static_cast<F*>(nsum2));
  return static_cast<int>(cudaGetLastError());
}

// --- Vector entry: kVec coordinates per scan, one segment flag. ---------

constexpr int kVec = 4;

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
};

template <typename F, bool C>
struct VRows {
  const int32_t* skey2;
  const long long* perm;      // null: sorted position i is bounded row i
  const long long* row_perm;  // null: the bounded rows are the value rows
  const F* values;            // [n, dim]
  long long n;
  long long base;  // partition of row i: skey2[i] - base
  int dim, d0;

  __device__ __forceinline__ VSeg<F, C> element(long long i) const {
    long long r = perm ? perm[i] : i;
    if (row_perm) r = row_perm[r];
    const F* row = values + r * dim;
    VSeg<F, C> e;
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      e.v[c] = Acc<F, C>::of(d0 + c < dim ? row[d0 + c] : F(0));
    e.f = (i == 0 || skey2[i] != skey2[i - 1]) ? 1 : 0;
    return e;
  }
};

template <typename F, bool C>
__device__ __forceinline__ void vector_tile_aggregate(const VRows<F, C>& rows,
                                                      long long tile,
                                                      VSeg<F, C>* out) {
  using Op = VSegOp<F, C>;
  __shared__ VSeg<F, C> smem[32];
  const long long base = tile * pdp::kTile +
                         static_cast<long long>(threadIdx.x) * pdp::kItems;
  VSeg<F, C> acc = Op::identity();
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    if (base + k < rows.n) acc = Op::combine(acc, rows.element(base + k));
  }
  VSeg<F, C> total;
  pdp::block_exclusive_scan<Op>(acc, smem, &total);
  if (threadIdx.x == 0) *out = total;
}

template <typename F, bool C>
__global__ void vector_tile_aggregates(VRows<F, C> rows, VSeg<F, C>* aggs) {
  vector_tile_aggregate(rows, blockIdx.x, aggs + blockIdx.x);
}

// Rescans one tile from its prefix; the last row of each partition's run
// writes its coordinates [d0, d0 + kVec) of vsum (partition-major, dim a
// row; partition = skey2 - rows.base, kept when in [0, n_partitions)).
template <typename F, bool C>
__device__ __forceinline__ void write_vector_tile(const VRows<F, C>& rows,
                                                  long long tile,
                                                  VSeg<F, C> prefix,
                                                  int n_partitions,
                                                  F* vsum) {
  using Op = VSegOp<F, C>;
  __shared__ VSeg<F, C> smem[32];
  const long long base = tile * pdp::kTile +
                         static_cast<long long>(threadIdx.x) * pdp::kItems;
  VSeg<F, C> elems[pdp::kItems];
  VSeg<F, C> acc = Op::identity();
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    elems[k] = base + k < rows.n ? rows.element(base + k) : Op::identity();
    acc = Op::combine(acc, elems[k]);
  }
  VSeg<F, C> total;
  const VSeg<F, C> excl = pdp::block_exclusive_scan<Op>(acc, smem, &total);
  VSeg<F, C> state = Op::combine(prefix, excl);
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    const long long i = base + k;
    if (i >= rows.n) break;
    state = Op::combine(state, elems[k]);
    const int32_t sk = rows.skey2[i];
    const bool last = i + 1 == rows.n || rows.skey2[i + 1] != sk;
    const long long key = static_cast<long long>(sk) - rows.base;
    if (last && key >= 0 && key < n_partitions) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        if (rows.d0 + c < rows.dim)
          vsum[key * rows.dim + rows.d0 + c] =
              state.v[c].value();
      }
    }
  }
}

template <typename F, bool C>
__global__ void write_vectors(VRows<F, C> rows, const VSeg<F, C>* prefixes,
                              int n_partitions, F* __restrict__ vsum) {
  write_vector_tile(rows, blockIdx.x, prefixes[blockIdx.x], n_partitions,
                    vsum);
}

// The vector lane entry: lane blockIdx.y scans its window [bounds[l],
// bounds[l + 1]) of the stream in tiles of its own, as the scalar lane
// entry does, and writes its partitions at [l * P, (l + 1) * P) of vsum.
template <typename F, bool C>
__device__ __forceinline__ VRows<F, C> vector_lane_window(
    VRows<F, C> rows, const long long* bounds, int n_partitions) {
  const long long lane = blockIdx.y;
  const long long lo = bounds[lane];
  rows.skey2 += lo;
  rows.perm += lo;
  rows.n = bounds[lane + 1] - lo;
  rows.base = lane * n_partitions;
  return rows;
}

template <typename F, bool C>
__global__ void vector_tile_aggregates_lanes(
    VRows<F, C> rows, const long long* __restrict__ bounds, int n_partitions,
    long long lane_tiles, VSeg<F, C>* aggs) {
  const VRows<F, C> w = vector_lane_window(rows, bounds, n_partitions);
  vector_tile_aggregate(w, blockIdx.x,
                        aggs + blockIdx.y * lane_tiles + blockIdx.x);
}

template <typename F, bool C>
__global__ void write_vectors_lanes(VRows<F, C> rows,
                                    const long long* __restrict__ bounds,
                                    const VSeg<F, C>* prefixes,
                                    int n_partitions, long long lane_tiles,
                                    F* __restrict__ vsum) {
  const VRows<F, C> w = vector_lane_window(rows, bounds, n_partitions);
  if (static_cast<long long>(blockIdx.x) * pdp::kTile >= w.n) return;
  write_vector_tile(w, blockIdx.x,
                    prefixes[blockIdx.y * lane_tiles + blockIdx.x],
                    n_partitions,
                    vsum + static_cast<long long>(blockIdx.y) *
                               n_partitions * rows.dim);
}

template <typename F, bool C>
int launch_vectors(const void* skey2, const void* perm, const void* row_perm,
                   const void* values, long long n, int dim,
                   int n_partitions, long long base, void* scratch,
                   void* vsum, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = pdp::n_tiles(n);
  VSeg<F, C>* aggs = static_cast<VSeg<F, C>*>(scratch);
  for (int d0 = 0; d0 < dim; d0 += kVec) {
    VRows<F, C> rows{static_cast<const int32_t*>(skey2),
                  static_cast<const long long*>(perm),
                  static_cast<const long long*>(row_perm),
                  static_cast<const F*>(values),
                  n,
                  base,
                  dim,
                  d0};
    vector_tile_aggregates<F, C><<<static_cast<unsigned>(tiles),
                                   pdp::kThreads, 0, s>>>(rows, aggs);
    // 512 threads: the float64 aggregate (and the compensated float32
    // one, as wide) needs more than the 64 registers a thread of a
    // 1024-thread block may have.
    pdp::scan_tile_aggregates<VSegOp<F, C>><<<1, 512, 0, s>>>(aggs, tiles,
                                                              nullptr);
    write_vectors<F, C><<<static_cast<unsigned>(tiles), pdp::kThreads, 0,
                          s>>>(rows, aggs, n_partitions,
                               static_cast<F*>(vsum));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F, bool C>
int launch_vectors_lanes(const void* skey2, const void* perm,
                         const void* row_perm, const void* values,
                         long long n, long long lane_rows, int dim,
                         int n_partitions, void* scratch, void* vsum,
                         void* stream) {
  if (n <= 0) return 0;
  if (lane_rows <= 0 || n % lane_rows != 0 || perm == nullptr) return -1;
  const long long n_lanes = n / lane_rows;
  if (n_lanes > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long lane_tiles = pdp::n_tiles(lane_rows);
  VSeg<F, C>* aggs = static_cast<VSeg<F, C>*>(scratch);
  long long* bounds = reinterpret_cast<long long*>(
      static_cast<char*>(scratch) +
      lane_aggs_bytes(n_lanes * lane_tiles, sizeof(VSeg<F, C>)));
  lane_bounds<<<static_cast<unsigned>((n_lanes + 1 + 255) / 256), 256, 0,
                s>>>(static_cast<const int32_t*>(skey2), n, n_partitions,
                     static_cast<int>(n_lanes), bounds);
  const dim3 grid(static_cast<unsigned>(lane_tiles),
                  static_cast<unsigned>(n_lanes));
  for (int d0 = 0; d0 < dim; d0 += kVec) {
    VRows<F, C> rows{static_cast<const int32_t*>(skey2),
                     static_cast<const long long*>(perm),
                     static_cast<const long long*>(row_perm),
                     static_cast<const F*>(values),
                     n,
                     0,
                     dim,
                     d0};
    vector_tile_aggregates_lanes<F, C><<<grid, pdp::kThreads, 0, s>>>(
        rows, bounds, n_partitions, lane_tiles, aggs);
    // 512 threads, as the solo entry's scan of its tile aggregates.
    scan_lane_aggregates<VSegOp<F, C>><<<static_cast<unsigned>(n_lanes),
                                         512, 0, s>>>(aggs, lane_tiles);
    write_vectors_lanes<F, C><<<grid, pdp::kThreads, 0, s>>>(
        rows, bounds, aggs, n_partitions, lane_tiles, static_cast<F*>(vsum));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long reduce_vectors_scratch_bytes(long long n, int f64,
                                                  int comp) {
  const long long each = f64 ? sizeof(VSeg<double, false>)
                             : (comp ? sizeof(VSeg<float, true>)
                                     : sizeof(VSeg<float, false>));
  return pdp::n_tiles(n) * each;
}

// Vector sums: skey2 / perm / base as for reduce_partitions; row_perm
// (nullable) maps a bounded row to its row of values [*, dim]. vsum:
// [n_partitions, dim], zero-filled by the caller. comp: compensated float32
// sums (ignored for float64).
extern "C" int reduce_vectors(const void* skey2, const void* perm,
                              const void* row_perm, const void* values,
                              long long n, int dim, int n_partitions,
                              long long base, void* scratch, void* vsum,
                              int f64, int comp, void* stream) {
  if (f64)
    return launch_vectors<double, false>(skey2, perm, row_perm, values, n,
                                         dim, n_partitions, base, scratch,
                                         vsum, stream);
  return comp ? launch_vectors<float, true>(skey2, perm, row_perm, values, n,
                                            dim, n_partitions, base, scratch,
                                            vsum, stream)
              : launch_vectors<float, false>(skey2, perm, row_perm, values,
                                             n, dim, n_partitions, base,
                                             scratch, vsum, stream);
}

extern "C" long long reduce_partitions_scratch_bytes(long long n, int f64,
                                                     int comp) {
  const long long each = f64 ? sizeof(Seg<double, false>)
                             : (comp ? sizeof(Seg<float, true>)
                                     : sizeof(Seg<float, false>));
  return pdp::n_tiles(n) * each;
}

// Outputs must be zero-filled by the caller: partitions without a kept row
// are not written. perm: nullable (rows already in sorted order); base:
// row i's partition is skey2[i] - base (0 on the dense route). comp:
// compensated float32 sums (ignored for float64).
extern "C" int reduce_partitions(const void* skey2, const void* perm,
                                 const void* pair_start, const void* row_sum,
                                 const void* row_nsum, const void* row_nsum2,
                                 long long n, int n_partitions,
                                 long long base, void* scratch, void* count,
                                 void* pid_count, void* sum, void* nsum,
                                 void* nsum2, int f64, int comp,
                                 void* stream) {
  if (f64)
    return launch<double, false>(skey2, perm, pair_start, row_sum, row_nsum,
                                 row_nsum2, n, n_partitions, base, scratch,
                                 count, pid_count, sum, nsum, nsum2, stream);
  return comp ? launch<float, true>(skey2, perm, pair_start, row_sum,
                                    row_nsum, row_nsum2, n, n_partitions,
                                    base, scratch, count, pid_count, sum,
                                    nsum, nsum2, stream)
              : launch<float, false>(skey2, perm, pair_start, row_sum,
                                     row_nsum, row_nsum2, n, n_partitions,
                                     base, scratch, count, pid_count, sum,
                                     nsum, nsum2, stream);
}

// Scratch of the lane entries: one aggregate per tile of a lane, per
// lane, and the L + 1 lane bounds (vec: the vector entry's aggregates).
extern "C" long long reduce_partitions_lanes_scratch_bytes(long long lane_rows,
                                                           long long n_lanes,
                                                           int f64, int comp,
                                                           int vec) {
  long long each;
  if (vec) {
    each = f64 ? sizeof(VSeg<double, false>)
               : (comp ? sizeof(VSeg<float, true>)
                       : sizeof(VSeg<float, false>));
  } else {
    each = f64 ? sizeof(Seg<double, false>)
               : (comp ? sizeof(Seg<float, true>)
                       : sizeof(Seg<float, false>));
  }
  return lane_aggs_bytes(n_lanes * pdp::n_tiles(lane_rows), each) +
         (n_lanes + 1) * static_cast<long long>(sizeof(long long));
}

// The lane entry: n = L * lane_rows rows sorted by key2 = lane *
// n_partitions + partition (dropped rows L * n_partitions, last); outputs
// are [L * n_partitions], zero-filled by the caller, lane l's partitions
// at [l * n_partitions, (l + 1) * n_partitions). comp: compensated float32
// sums (ignored for float64).
extern "C" int reduce_partitions_lanes(const void* skey2, const void* perm,
                                       const void* pair_start,
                                       const void* row_sum,
                                       const void* row_nsum,
                                       const void* row_nsum2, long long n,
                                       long long lane_rows, int n_partitions,
                                       void* scratch, void* count,
                                       void* pid_count, void* sum,
                                       void* nsum, void* nsum2, int f64,
                                       int comp, void* stream) {
  if (f64)
    return launch_lanes<double, false>(skey2, perm, pair_start, row_sum,
                                       row_nsum, row_nsum2, n, lane_rows,
                                       n_partitions, scratch, count,
                                       pid_count, sum, nsum, nsum2, stream);
  return comp ? launch_lanes<float, true>(skey2, perm, pair_start, row_sum,
                                          row_nsum, row_nsum2, n, lane_rows,
                                          n_partitions, scratch, count,
                                          pid_count, sum, nsum, nsum2, stream)
              : launch_lanes<float, false>(skey2, perm, pair_start, row_sum,
                                           row_nsum, row_nsum2, n, lane_rows,
                                           n_partitions, scratch, count,
                                           pid_count, sum, nsum, nsum2,
                                           stream);
}

// The vector lane entry: skey2 / perm as for reduce_partitions_lanes;
// row_perm (nullable) maps a bounded row to its row of values [*, dim];
// vsum: [L * n_partitions, dim], zero-filled by the caller. Scratch:
// reduce_partitions_lanes_scratch_bytes(..., vec = 1).
extern "C" int reduce_vectors_lanes(const void* skey2, const void* perm,
                                    const void* row_perm, const void* values,
                                    long long n, long long lane_rows,
                                    int dim, int n_partitions, void* scratch,
                                    void* vsum, int f64, int comp,
                                    void* stream) {
  if (dim < 1) return -1;
  if (f64)
    return launch_vectors_lanes<double, false>(skey2, perm, row_perm, values,
                                               n, lane_rows, dim,
                                               n_partitions, scratch, vsum,
                                               stream);
  return comp ? launch_vectors_lanes<float, true>(skey2, perm, row_perm,
                                                  values, n, lane_rows, dim,
                                                  n_partitions, scratch,
                                                  vsum, stream)
              : launch_vectors_lanes<float, false>(skey2, perm, row_perm,
                                                   values, n, lane_rows, dim,
                                                   n_partitions, scratch,
                                                   vsum, stream);
}
