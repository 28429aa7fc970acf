// C23 reshard_exchange: every valid row of one source shard written
// straight to its final slot on its destination shard.
//
// Replaces K22's exchange, pipelinedp_tpu/parallel/reshard.py
// _exchange_kernel (:133): per shard an argsort by dest, [D, cap_send]
// invalid-padded buckets, one lax.all_to_all per column, then an argsort
// of the received [D * cap_send] rows valid-first, sliced to out_cap.
// That receive order is: source shard 0's rows for this destination in
// their row order, then source 1's, ... then the padding. So the row of
// source s with destination d and rank r (C22) lands at
// offset[s][d] + r, offset[s][d] = sum over s' < s of count[s'][d], and
// no sort runs. The launch for source s also fills its own shard's
// receive buffer past its received rows, [recv_s, out_cap), with the
// padding row (pid 0, pk -1, values 0, valid false), as the JAX buckets
// are filled.
//
// The caller passes one target a destination: the destination shard's
// output columns and offset[s][d] where that shard lies on the source's
// device (a mesh whose slots share a card: every target), or a staging
// slice of count[s][d] rows on the source's device at offset 0, which
// parallel/collectives.all_to_all then peer-copies into place. One entry
// serves pid, pk, values (float32 or float64, [n] or [n, V]; absent for
// the selection) and valid.
//
// One launch. Blocks [0, tiles) each take a tile of PDP_EXCHANGE_TILE
// rows (cuda_build.py), laid in pid's 16-byte phase as C22's tiles are;
// the blocks past them fill the padding. A tile's rows for destination d
// have consecutive ranks (C22's rank is stable), so they form one run
// [offset[d] + r0[d], + c[d]) of the target. A tile block:
//   1. loads dest and rank, four rows a group (16-byte loads where
//      aligned), and finds each bucket's first rank r0 and its count c:
//      per warp a min and a max reduction of the rank a bucket
//      (__reduce_min_sync / __reduce_max_sync), then over the 8 warps;
//   2. loads pid, pk and the values the same way and lays them out in
//      shared memory bucket by bucket: bucket d from the exclusive sum of
//      the counts before it, row r at r - r0[d] within it (the values
//      only where a row's are at most kStagedValueBytes; wider rows keep
//      their tile row and are read from the source at the copy);
//   3. writes the runs: each run is cut at the target's 16-byte phase into
//      a scalar head, groups of four rows and a scalar tail; consecutive
//      threads take consecutive pieces, so a run's groups are consecutive
//      16-byte stores of pid and pk, one word of valid (four true bytes)
//      and 16-byte stores of the values, each where its own column is
//      aligned there; the ends are row by row, so no store touches a row
//      of another run.
// The Targets table is a __grid_constant__ parameter, read in place.
//
// Bound: bytes, each row's dest and rank read (8), each valid row read
// once (pid 4, pk 4, values 4V or 8V) and written once (13 + value bytes),
// plus the padding written.
#include "common.cuh"

#ifndef PDP_EXCHANGE_TILE
#error "PDP_EXCHANGE_TILE comes from cuda_build.py"
#endif

namespace {

constexpr int kMaxShards = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = PDP_EXCHANGE_TILE;
constexpr int kGroups = kTile / 4;
constexpr int kGroupsPerThread = kGroups / kThreads;
constexpr int kRowsPerThread = 4 * kGroupsPerThread;
constexpr int kStagedValueBytes = 48;  // values staged in shared memory
constexpr int kFillRows = 16384;       // padding rows a fill block
constexpr int kMaxDevices = 64;
static_assert(kTile % (4 * kThreads) == 0, "whole groups a thread");
static_assert(kTile <= 65536, "a tile row fits 16 bits");

struct Targets {
  int32_t* pid[kMaxShards];
  int32_t* pk[kMaxShards];
  void* values[kMaxShards];
  unsigned char* valid[kMaxShards];
  long long offset[kMaxShards];
};

struct Source {
  const int32_t* pid;
  const int32_t* pk;
  const void* values;
  const int32_t* dest;
  const int32_t* rank;
  long long n;
  int phase;   // pid's row offset within its 16 bytes
  int width;   // values a row (0: none)
  int n_shards;
  long long tiles;
};

struct Fill {
  int32_t* pid;
  int32_t* pk;
  void* values;
  unsigned char* valid;
  long long start, end;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Four consecutive int32 of a column from row i0: one 16-byte load where
// aligned, else four.
__device__ __forceinline__ int4 load4(const int32_t* p, long long i0) {
  if (aligned16(p + i0)) return *reinterpret_cast<const int4*>(p + i0);
  return make_int4(p[i0], p[i0 + 1], p[i0 + 2], p[i0 + 3]);
}

__device__ __forceinline__ int at(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// v copied over [lo, hi) of p: element stores up to the first 16-byte
// boundary and after the last, 16-byte stores between; the block's threads
// stride over the pieces.
template <typename T>
__device__ void fill_range(T* p, long long lo, long long hi, T v) {
  constexpr int kPer = 16 / sizeof(T);
  if (lo >= hi) return;
  long long head = (16 - (reinterpret_cast<uintptr_t>(p + lo) & 15)) & 15;
  head = head / static_cast<long long>(sizeof(T));
  if (head > hi - lo) head = hi - lo;
  const long long mid = (hi - lo - head) / kPer;
  for (long long j = threadIdx.x; j < head; j += blockDim.x) p[lo + j] = v;
  union {
    T e[kPer];
    uint4 u;
  } word;
#pragma unroll
  for (int e = 0; e < kPer; ++e) word.e[e] = v;
  uint4* vec = reinterpret_cast<uint4*>(p + lo + head);
  for (long long j = threadIdx.x; j < mid; j += blockDim.x) vec[j] = word.u;
  for (long long j = lo + head + mid * kPer + threadIdx.x; j < hi;
       j += blockDim.x)
    p[j] = v;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    exchange(const Source src, const __grid_constant__ Targets t,
             const Fill fill, bool staged) {
  if (blockIdx.x >= src.tiles) {
    // The padding past the received rows: the padding row.
    const long long lo = fill.start + (blockIdx.x - src.tiles) *
                                          static_cast<long long>(kFillRows);
    const long long hi = min(lo + kFillRows, fill.end);
    fill_range<int32_t>(fill.pid, lo, hi, 0);
    fill_range<int32_t>(fill.pk, lo, hi, -1);
    fill_range<unsigned char>(fill.valid, lo, hi, 0);
    if (src.width > 0)
      fill_range<W>(static_cast<W*>(fill.values), lo * src.width,
                    hi * src.width, W(0));
    return;
  }
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int32_t pid_s[kTile];
  __shared__ int32_t pk_s[kTile];
  __shared__ uint16_t row_s[kTile];
  __shared__ int warp_min[kWarps][kMaxShards];
  __shared__ int warp_max[kWarps][kMaxShards];
  __shared__ int r0_s[kMaxShards];
  __shared__ int start_s[kMaxShards];   // the bucket's first staged row
  __shared__ int head_s[kMaxShards];
  __shared__ int groups_s[kMaxShards];
  __shared__ int item_s[kMaxShards + 1];  // the bucket's first piece
  W* vals_s = reinterpret_cast<W*>(dyn);
  const W* values = static_cast<const W*>(src.values);
  const int D = src.n_shards, V = src.width;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long k = blockIdx.x;

  // 1. dest and rank, a bucket's first rank and count.
  int d[kRowsPerThread], r[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kGroupsPerThread; ++m) {
    const int q = threadIdx.x + kThreads * m;
    const long long i0 = (k * kGroups + q) * 4 - src.phase;
    if (i0 >= 0 && i0 + 4 <= src.n) {
      const int4 dv = load4(src.dest, i0), rv = load4(src.rank, i0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[4 * m + e] = at(dv, e);
        r[4 * m + e] = at(rv, e);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long i = i0 + e;
        const bool in = i >= 0 && i < src.n;
        d[4 * m + e] = in ? src.dest[i] : D;
        r[4 * m + e] = in ? src.rank[i] : 0;
      }
    }
  }
  for (int b = 0; b < D; ++b) {
    unsigned lo = 0xffffffffu, hi = 0;
#pragma unroll
    for (int e = 0; e < kRowsPerThread; ++e) {
      if (d[e] == b) {
        lo = min(lo, static_cast<unsigned>(r[e]));
        hi = max(hi, static_cast<unsigned>(r[e]) + 1u);
      }
    }
    lo = __reduce_min_sync(pdp::kFullMask, lo);
    hi = __reduce_max_sync(pdp::kFullMask, hi);
    if (lane == 0) {
      warp_min[w][b] = static_cast<int>(lo);
      warp_max[w][b] = static_cast<int>(hi);
    }
  }
  __syncthreads();
  if (w == 0) {
    // Lane b: bucket b's run, its staged start and its pieces.
    const int b = lane;
    int count = 0, first = 0, head = 0, groups = 0, pieces = 0;
    if (b < D) {
      unsigned lo = 0xffffffffu, hi = 0;
      for (int v = 0; v < kWarps; ++v) {
        lo = min(lo, static_cast<unsigned>(warp_min[v][b]));
        hi = max(hi, static_cast<unsigned>(warp_max[v][b]));
      }
      if (hi > 0) {
        first = static_cast<int>(lo);
        count = static_cast<int>(hi - lo);
      }
      const long long a = t.offset[b] + first;
      const int phase = static_cast<int>(
          ((reinterpret_cast<uintptr_t>(t.pid[b]) >> 2) + a) & 3);
      head = min(count, (4 - phase) & 3);
      groups = (count - head) >> 2;
      pieces = count - 3 * groups;  // head + groups + tail
    }
    const int start =
        pdp::warp_inclusive_scan<pdp::SumOp<int>>(count) - count;
    const int item =
        pdp::warp_inclusive_scan<pdp::SumOp<int>>(pieces) - pieces;
    if (b < D) {
      r0_s[b] = first;
      start_s[b] = start;
      head_s[b] = head;
      groups_s[b] = groups;
      item_s[b] = item;
    }
    if (b == D - 1) item_s[D] = item + pieces;
  }
  __syncthreads();

  // 2. the rows, laid out bucket by bucket.
#pragma unroll
  for (int m = 0; m < kGroupsPerThread; ++m) {
    const int q = threadIdx.x + kThreads * m;
    const long long i0 = (k * kGroups + q) * 4 - src.phase;
    const bool whole = i0 >= 0 && i0 + 4 <= src.n;
    int4 pv = make_int4(0, 0, 0, 0), kv = pv;
    if (whole) {
      pv = *reinterpret_cast<const int4*>(src.pid + i0);
      kv = load4(src.pk, i0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = d[4 * m + e];
      if (b >= D) continue;  // an invalid row, or past the view
      const long long i = i0 + e;
      const int p = start_s[b] + r[4 * m + e] - r0_s[b];
      pid_s[p] = whole ? at(pv, e) : src.pid[i];
      pk_s[p] = whole ? at(kv, e) : src.pk[i];
      row_s[p] = static_cast<uint16_t>(4 * q + e);
    }
    if (staged && V > 0) {
      const W* in = values + i0 * V;
      // Where each row's values go in shared memory (-1: nowhere).
      int place[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = d[4 * m + e];
        place[e] = b < D ? (start_s[b] + r[4 * m + e] - r0_s[b]) * V : -1;
      }
      if (whole && aligned16(in)) {
        // 4V values: 16-byte loads, each element to its row's place.
        constexpr int kPer = 16 / sizeof(W);
        int e = 0, col = 0, at = place[0];
        for (int c = 0; c < 4 * V / kPer; ++c) {
          union {
            uint4 u;
            W e[kPer];
          } word;
          word.u = reinterpret_cast<const uint4*>(in)[c];
#pragma unroll
          for (int z = 0; z < kPer; ++z) {
            if (at >= 0) vals_s[at + col] = word.e[z];
            if (++col == V) {
              col = 0;
              ++e;
              at = e == 1 ? place[1] : e == 2 ? place[2] : place[3];
            }
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (place[e] >= 0)
            for (int c = 0; c < V; ++c) vals_s[place[e] + c] = in[e * V + c];
      }
    }
  }
  __syncthreads();

  // 3. the runs, a piece a thread.
  const long long tile_row0 = k * kTile - src.phase;
  const int pieces = item_s[D];
  for (int it = threadIdx.x; it < pieces; it += kThreads) {
    int b = 0;
    while (b + 1 < D && item_s[b + 1] <= it) ++b;
    const int piece = it - item_s[b], head = head_s[b], groups = groups_s[b];
    int row, rows;  // within the run
    if (piece < head) {
      row = piece;
      rows = 1;
    } else if (piece < head + groups) {
      row = head + 4 * (piece - head);
      rows = 4;
    } else {
      row = head + 4 * groups + (piece - head - groups);
      rows = 1;
    }
    const int p = start_s[b] + row;
    const long long pos = t.offset[b] + r0_s[b] + row;
    int32_t* o_pid = t.pid[b] + pos;
    int32_t* o_pk = t.pk[b] + pos;
    unsigned char* o_valid = t.valid[b] + pos;
    W* o_vals = V > 0 ? static_cast<W*>(t.values[b]) + pos * V : nullptr;
    if (rows == 4) {
      *reinterpret_cast<int4*>(o_pid) =
          make_int4(pid_s[p], pid_s[p + 1], pid_s[p + 2], pid_s[p + 3]);
      const int4 kv =
          make_int4(pk_s[p], pk_s[p + 1], pk_s[p + 2], pk_s[p + 3]);
      if (aligned16(o_pk)) {
        *reinterpret_cast<int4*>(o_pk) = kv;
      } else {
        o_pk[0] = kv.x;
        o_pk[1] = kv.y;
        o_pk[2] = kv.z;
        o_pk[3] = kv.w;
      }
      if ((reinterpret_cast<uintptr_t>(o_valid) & 3) == 0) {
        *reinterpret_cast<unsigned*>(o_valid) = 0x01010101u;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) o_valid[e] = 1;
      }
    } else {
      *o_pid = pid_s[p];
      *o_pk = pk_s[p];
      *o_valid = 1;
    }
    if (V > 0) {
      // Element x of the piece's rows: staged, the piece's rows are
      // consecutive in shared memory; else read from the source row.
      auto value_at = [&](int x) -> W {
        if (staged) return vals_s[p * V + x];
        const int e = x / V;
        return values[(tile_row0 + row_s[p + e]) * V + (x - e * V)];
      };
      if (rows == 4 && aligned16(o_vals)) {
        constexpr int kPer = 16 / sizeof(W);
        for (int c = 0; c < 4 * V; c += kPer) {
          union {
            uint4 u;
            W e[kPer];
          } word;
#pragma unroll
          for (int z = 0; z < kPer; ++z) word.e[z] = value_at(c + z);
          reinterpret_cast<uint4*>(o_vals)[c / kPer] = word.u;
        }
      } else {
        for (int x = 0; x < rows * V; ++x) o_vals[x] = value_at(x);
      }
    }
  }
}

int row_phase(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

template <typename W>
int launch(const Source& src, const Targets& t, const Fill& fill,
           cudaStream_t st) {
  const long long pad = fill.end - fill.start;
  const long long fill_blocks = pad > 0 ? (pad + kFillRows - 1) / kFillRows
                                        : 0;
  const long long blocks = src.tiles + fill_blocks;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const bool staged =
      src.width * static_cast<int>(sizeof(W)) <= kStagedValueBytes;
  const size_t dyn = staged ? static_cast<size_t>(kTile) * src.width *
                                  sizeof(W)
                            : 0;
  // The opt-in past 48 KB of shared memory, once a type and a device.
  static bool opted[kMaxDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device >= kMaxDevices || !opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        exchange<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kTile * kStagedValueBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < kMaxDevices) opted[device] = true;
  }
  exchange<W><<<static_cast<unsigned>(blocks), kThreads, dyn, st>>>(
      src, t, fill, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Source shard's rows: pid, pk int32[n], values [n, width] of value_bytes
// (4 or 8; width 0 and values null for none), dest, rank int32[n] (C22;
// dest sends an invalid row to bucket n_shards, which no target takes).
// table: int64 words, five runs of n_shards (the targets' pid, pk, values
// and valid pointers, then their offsets), then the fill (pid, pk, values,
// valid, start, end): the source's own receive buffer, whose rows
// [start, end) get the padding row. n_shards <= 32.
extern "C" int reshard_exchange(const void* pid, const void* pk,
                                const void* values, int width,
                                int value_bytes, const void* dest,
                                const void* rank, long long n, int n_shards,
                                const long long* table, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || n < 0 || width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Targets t = {};
  for (int d = 0; d < n_shards; ++d) {
    t.pid[d] = reinterpret_cast<int32_t*>(table[d]);
    t.pk[d] = reinterpret_cast<int32_t*>(table[n_shards + d]);
    t.values[d] = reinterpret_cast<void*>(table[2 * n_shards + d]);
    t.valid[d] = reinterpret_cast<unsigned char*>(table[3 * n_shards + d]);
    t.offset[d] = table[4 * n_shards + d];
  }
  const long long* f = table + 5 * n_shards;
  Fill fill = {reinterpret_cast<int32_t*>(f[0]),
               reinterpret_cast<int32_t*>(f[1]),
               reinterpret_cast<void*>(f[2]),
               reinterpret_cast<unsigned char*>(f[3]), f[4], f[5]};
  Source src = {static_cast<const int32_t*>(pid),
                static_cast<const int32_t*>(pk),
                values,
                static_cast<const int32_t*>(dest),
                static_cast<const int32_t*>(rank),
                n,
                row_phase(pid),
                width,
                n_shards,
                0};
  src.tiles = n > 0 ? (n + src.phase + kTile - 1) / kTile : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 0 || value_bytes == 4) return launch<uint32_t>(src, t, fill, st);
  if (value_bytes == 8)
    return launch<unsigned long long>(src, t, fill, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
