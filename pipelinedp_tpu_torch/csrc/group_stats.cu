// C17 group_stats: the grouped statistics of the dataset histograms.
//
// Replaces the segment work of K20, pipelinedp_tpu/dataset_histograms/
// device_histograms.py _group_stats_kernel (:130), over row streams that
// C5 radix_sort already sorted (the JAX package's executor._sort_rows):
//   * group_stats_pairs, on the rows sorted by (pid, pk) (invalid rows
//     carry the keys (INT32_MAX, INT32_MAX) and sink to the tail):
//       new_pair / new_pid   the first valid row of each (pid, pk) / pid;
//       pair_len, pair_sum   rows and float32 value sum of each pair, the
//                            sum added in row order from 0 (one thread a
//                            pair walks its rows: bit-equal to
//                            jax.ops.segment_sum on the CPU);
//       l1, l0               rows and pairs of each pid (int32, as
//                            :167-171 count them);
//       pair_pk              the pk of each pair start, INT32_MAX elsewhere
//                            (the key of the third sort);
//   * group_stats_keys, on a stream sorted by one key: the first valid row
//     of each key (new_seg) and its run length (count_per_pk on the pk
//     stream, pids_per_pk on the pair starts re-keyed by pk).
// Every invalid row is a segment of its own, as in the JAX package. A
// stat is written at its group's first row and 0 at every other row; the
// rows are read through C5's permutation (int64 perm), so the columns are
// never gathered whole.
//
// Run lengths and the pairs in a pid come from a three-pass tile scan of a
// segmented (start position, marked rows) state: per-tile aggregates, one
// block scanning them, then each row its inclusive state; the last row of
// a segment writes the stats at the segment's first row. Pair sums come
// from a walk instead, because a scan would add the floats in another
// order than the JAX package.
//
// Bound: bytes. Each row's keys, flags and value are read (through the
// permutation) and its outputs written once; a pair's walk re-reads its
// own rows, which are few.
#include "common.cuh"

namespace {

constexpr int32_t kI32Max = 0x7fffffff;
constexpr uint8_t kMark = 1;       // counted in the segment's cnt (new_pair)
constexpr uint8_t kSegStart = 2;   // starts a scanned segment
constexpr uint8_t kOutput = 4;     // the row holds its segment's stats
constexpr uint8_t kPairStart = 8;  // starts a pair segment (walk)

struct Seg {
  long long pos;  // last segment start at or before the row, -1 = none
  long long cnt;  // marked rows from that start to the row
};

struct SegOp {
  using T = Seg;
  static __device__ __forceinline__ T identity() { return Seg{-1, 0}; }
  static __device__ __forceinline__ T combine(T a, T b) {
    return b.pos >= 0 ? b : Seg{a.pos, a.cnt + b.cnt};
  }
  static __device__ __forceinline__ T shfl_up(T v, int d) {
    return Seg{__shfl_up_sync(pdp::kFullMask, v.pos, d),
               __shfl_up_sync(pdp::kFullMask, v.cnt, d)};
  }
};

// Rows base + t * kItems .. + kItems - 1 of the tile for thread t: each
// thread scans its own consecutive rows.
__device__ __forceinline__ long long first_row() {
  return static_cast<long long>(blockIdx.x) * pdp::kTile +
         static_cast<long long>(threadIdx.x) * pdp::kItems;
}

__device__ __forceinline__ Seg element(const uint8_t* flags, long long r) {
  const uint8_t f = flags[r];
  return Seg{(f & kSegStart) ? r : -1, (f & kMark) ? 1 : 0};
}

__global__ void seg_tile_aggregates(const uint8_t* __restrict__ flags,
                                    long long n, Seg* __restrict__ aggs) {
  __shared__ Seg smem[32];
  Seg acc = SegOp::identity();
  const long long base = first_row();
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    if (base + k < n) acc = SegOp::combine(acc, element(flags, base + k));
  }
  Seg total;
  pdp::block_exclusive_scan<SegOp>(acc, smem, &total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

// Pass 3: each row's inclusive state; the last row of a segment whose
// first row is an output row writes len (and cnt) there; other output
// rows are written by their segment's end, every other row gets 0.
__global__ void seg_write(const uint8_t* __restrict__ flags, long long n,
                          const Seg* __restrict__ prefixes,
                          int32_t* __restrict__ len_out,
                          int32_t* __restrict__ cnt_out) {
  __shared__ Seg smem[32];
  const long long base = first_row();
  Seg acc = SegOp::identity();
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    if (base + k < n) acc = SegOp::combine(acc, element(flags, base + k));
  }
  Seg total;
  const Seg excl = pdp::block_exclusive_scan<SegOp>(acc, smem, &total);
  Seg state = SegOp::combine(prefixes[blockIdx.x], excl);
  for (int k = 0; k < pdp::kItems; ++k) {
    const long long r = base + k;
    if (r >= n) break;
    state = SegOp::combine(state, element(flags, r));
    if (!(flags[r] & kOutput)) {
      len_out[r] = 0;
      if (cnt_out != nullptr) cnt_out[r] = 0;
    }
    const bool last = r + 1 == n || (flags[r + 1] & kSegStart);
    if (last && state.pos >= 0 && (flags[state.pos] & kOutput)) {
      len_out[state.pos] = static_cast<int32_t>(r - state.pos + 1);
      if (cnt_out != nullptr)
        cnt_out[state.pos] = static_cast<int32_t>(state.cnt);
    }
  }
}

// The segmented scan over flags[n] (kSegStart, kMark, kOutput).
void segment_scan(const uint8_t* flags, long long n, Seg* aggs,
                  int32_t* len_out, int32_t* cnt_out, cudaStream_t s) {
  const long long tiles = pdp::n_tiles(n);
  seg_tile_aggregates<<<static_cast<unsigned>(tiles), pdp::kThreads, 0, s>>>(
      flags, n, aggs);
  pdp::scan_tile_aggregates<SegOp><<<1, 1024, 0, s>>>(aggs, tiles, nullptr);
  seg_write<<<static_cast<unsigned>(tiles), pdp::kThreads, 0, s>>>(
      flags, n, aggs, len_out, cnt_out);
}

__device__ __forceinline__ int32_t sunk(const int32_t* keys,
                                        const uint8_t* valid, long long src) {
  return valid[src] ? keys[src] : kI32Max;
}

__global__ void pair_flags(const int32_t* __restrict__ pid,
                           const int32_t* __restrict__ pk,
                           const uint8_t* __restrict__ valid,
                           const long long* __restrict__ perm, long long n,
                           uint8_t* __restrict__ flags,
                           uint8_t* __restrict__ new_pair,
                           uint8_t* __restrict__ new_pid,
                           int32_t* __restrict__ pair_pk) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long src = perm[r];
  const bool v = valid[src] != 0;
  const int32_t p = sunk(pid, valid, src), q = sunk(pk, valid, src);
  bool pair_head = true, pid_head = true;
  if (r > 0) {
    const long long prev = perm[r - 1];
    const int32_t pp = sunk(pid, valid, prev), pq = sunk(pk, valid, prev);
    pid_head = p != pp;
    pair_head = pid_head || q != pq;
  }
  const bool is_pair = pair_head && v, is_pid = pid_head && v;
  new_pair[r] = is_pair;
  new_pid[r] = is_pid;
  pair_pk[r] = is_pair ? q : kI32Max;
  // The pid segments are scanned; pair starts are its marks.
  flags[r] = (is_pair ? kMark : 0) | ((is_pid || !v) ? kSegStart : 0) |
             (is_pid ? kOutput : 0) | ((is_pair || !v) ? kPairStart : 0);
}

// One thread a pair start walks the pair's rows: length and the float32
// sum of its values in row order.
__global__ void pair_walk(const uint8_t* __restrict__ flags,
                          const float* __restrict__ values,
                          const long long* __restrict__ perm, long long n,
                          int32_t* __restrict__ pair_len,
                          float* __restrict__ pair_sum) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  if (!(flags[r] & kMark)) {  // not a pair's first row
    pair_len[r] = 0;
    pair_sum[r] = 0.0f;
    return;
  }
  float sum = 0.0f;
  long long j = r;
  do {
    if (values != nullptr) sum += values[perm[j]];
    ++j;
  } while (j < n && !(flags[j] & kPairStart));
  pair_len[r] = static_cast<int32_t>(j - r);
  pair_sum[r] = sum;
}

__global__ void key_flags(const int32_t* __restrict__ keys,
                          const uint8_t* __restrict__ valid,
                          const long long* __restrict__ perm, long long n,
                          uint8_t* __restrict__ flags,
                          uint8_t* __restrict__ new_seg) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long src = perm[r];
  const bool v = valid[src] != 0;
  const bool head = r == 0 || keys[src] != keys[perm[r - 1]];
  const bool is_seg = head && v;
  new_seg[r] = is_seg;
  flags[r] = ((is_seg || !v) ? kSegStart : 0) | (is_seg ? kOutput : 0);
}

constexpr int kBlock = 256;

unsigned blocks_for(long long count) {
  return static_cast<unsigned>((count + kBlock - 1) / kBlock);
}

// Scratch layout: flags u8[n] (rounded up to 16 B), then the tile
// aggregates.
Seg* aggs_of(void* scratch, long long n) {
  return reinterpret_cast<Seg*>(static_cast<char*>(scratch) +
                                ((n + 15) / 16) * 16);
}

}  // namespace

extern "C" long long group_stats_scratch_bytes(long long n) {
  return ((n + 15) / 16) * 16 +
         (pdp::n_tiles(n) + 1) * static_cast<long long>(sizeof(Seg));
}

// pid, pk: int32[n]; values: float32[n] or null; valid: u8[n]; perm:
// int64[n], the stable order by (pid, pk) with invalid rows' keys sunk to
// INT32_MAX. Outputs in sorted order: new_pair, new_pid u8[n]; pair_len,
// l1, l0, pair_pk int32[n]; pair_sum float32[n].
extern "C" int group_stats_pairs(const void* pid, const void* pk,
                                 const void* values, const void* valid,
                                 const void* perm, long long n, void* scratch,
                                 void* new_pair, void* new_pid,
                                 void* pair_len, void* pair_sum, void* l1,
                                 void* l0, void* pair_pk, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* flags = static_cast<uint8_t*>(scratch);
  const long long* p = static_cast<const long long*>(perm);
  pair_flags<<<blocks_for(n), kBlock, 0, s>>>(
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(pk),
      static_cast<const uint8_t*>(valid), p, n, flags,
      static_cast<uint8_t*>(new_pair), static_cast<uint8_t*>(new_pid),
      static_cast<int32_t*>(pair_pk));
  pair_walk<<<blocks_for(n), kBlock, 0, s>>>(
      flags, static_cast<const float*>(values), p, n,
      static_cast<int32_t*>(pair_len), static_cast<float*>(pair_sum));
  segment_scan(flags, n, aggs_of(scratch, n), static_cast<int32_t*>(l1),
               static_cast<int32_t*>(l0), s);
  return static_cast<int>(cudaGetLastError());
}

// keys: int32[n]; valid: u8[n]; perm: int64[n], the stable order by keys.
// Outputs in sorted order: new_seg u8[n], seg_len int32[n].
extern "C" int group_stats_keys(const void* keys, const void* valid,
                                const void* perm, long long n, void* scratch,
                                void* new_seg, void* seg_len, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* flags = static_cast<uint8_t*>(scratch);
  key_flags<<<blocks_for(n), kBlock, 0, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(valid),
      static_cast<const long long*>(perm), n, flags,
      static_cast<uint8_t*>(new_seg));
  segment_scan(flags, n, aggs_of(scratch, n), static_cast<int32_t*>(seg_len),
               nullptr, s);
  return static_cast<int>(cudaGetLastError());
}
