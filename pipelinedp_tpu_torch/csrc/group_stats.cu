// C17 group_stats: the grouped statistics of the dataset histograms.
//
// Replaces the segment work of K20, pipelinedp_tpu/dataset_histograms/
// device_histograms.py _group_stats_kernel (:130), over row streams that
// C5 radix_sort already sorted (the JAX package's executor._sort_rows):
//   * group_stats_pairs, on the rows sorted by (pid, pk) (invalid rows
//     carry the keys (INT32_MAX, INT32_MAX) and sink to the tail):
//       new_pair / new_pid   the first valid row of each (pid, pk) / pid;
//       pair_len, pair_sum   rows and float32 value sum of each pair, the
//                            sum added in row order from 0 (bit-equal to
//                            jax.ops.segment_sum on the CPU);
//       l1, l0               rows and pairs of each pid (int32, as
//                            :167-171 count them);
//       pair_pk              the pk of each pair start, INT32_MAX elsewhere
//                            (the key of the third sort);
//   * group_stats_keys, on a stream sorted by one key: the first valid row
//     of each key (new_seg) and its run length (count_per_pk on the pk
//     stream, pids_per_pk on the pair starts re-keyed by pk).
// Every invalid row is a segment of its own, as in the JAX package. A
// stat is written at its group's first row and 0 at every other row.
//
// Design: each entry is one launch over tiles of 2048 rows (256 threads)
// with a decoupled look-back (pdp::look_back, csrc/common.cuh, as C2 and
// C3 use it), after one memset.
//   * A block claims its tile from an atomic counter. Consecutive threads
//     read consecutive entries of perm and of the sorted key (the sort's
//     sorted_top: the sunk pid for the pairs entry, the key for the keys
//     entry), coalesced, and gather each row's valid byte (and for pairs
//     its pk and value) once, into shared memory; the pairs entry gathers
//     valid only where the sunk pid is INT32_MAX, the only key an invalid
//     row has there. The row before the tile
//     gives the first row's boundary, the row after it whether the tile's
//     last row ends its segment; every other key is read from the staged
//     copy. No key the sort returned is gathered.
//   * The per-pid (per-key) segments are scanned with a (last segment
//     start, marked rows since) state, the start tagged with whether its
//     row holds output: each thread scans its 8 consecutive rows, a block
//     scan gives the tile aggregate and warp 0 walks back to the nearest
//     inclusive prefix or segment start. The last row of a segment writes
//     its length (l1 / seg_len) and marked rows (l0: the pair starts) at
//     the segment's first row, which may lie in an earlier tile.
//   * Every other output is written in the striped layout (coalesced,
//     evict-first). A pair's first row walks the pair's staged rows for
//     pair_len and pair_sum, from 0 in row order, and goes to global
//     memory only for a pair that runs past the tile's end.
//
// Bound: bytes. perm, the sorted key, valid (and pk, value) read once a
// row, each output written once. valid, pk and value are reached through
// perm: random gathers, a 32-byte sector for 1-4 useful bytes. Replaced
// five launches (pairs: flags, a walk and a three-launch scan; keys: flags
// and the scan) that gathered each key twice through perm and re-read the
// flags per pass. Measured slower on the card: the pairs entry gathering
// valid for every row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                 // rows a thread scans
constexpr int kTile = kThreads * kItems;  // rows a tile
constexpr int32_t kI32Max = 0x7fffffff;
constexpr uint8_t kMark = 1;       // counted in the segment's cnt (new_pair)
constexpr uint8_t kSegStart = 2;   // starts a scanned segment
constexpr uint8_t kOutput = 4;     // the row holds its segment's stats
constexpr uint8_t kPairStart = 8;  // ends the walk of the pair before it
constexpr uint8_t kPair = 16;      // a pair's first valid row (new_pair)

struct Seg {
  long long pos;  // 2 * (last segment start) + (it holds output); -1: none
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
  static __device__ __forceinline__ T shfl(T v, int src) {
    return Seg{__shfl_sync(pdp::kFullMask, v.pos, src),
               __shfl_sync(pdp::kFullMask, v.cnt, src)};
  }
  // A segment starts inside: nothing earlier matters.
  static __device__ __forceinline__ bool ends_walk(const T& v) {
    return v.pos >= 0;
  }
};

struct Inputs {
  const long long* perm;
  const int32_t* key;    // sorted: the sunk pid (pairs) or the key (keys)
  const int32_t* pk;     // pairs: gathered through perm
  const float* values;   // pairs, may be null (sums 0)
  const uint8_t* valid;  // gathered through perm
  long long n;
};

struct Outputs {
  uint8_t* head;      // new_pid / new_seg
  int32_t* len;       // l1 / seg_len
  int32_t* cnt;       // l0 (pairs)
  uint8_t* new_pair;  // pairs
  int32_t* pair_len;
  float* pair_sum;
  int32_t* pair_pk;
};

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// Row r's valid byte, sorted key `key`. The pairs entry's key is the sunk
// pid: an invalid row's is INT32_MAX, so only such rows are gathered.
template <bool kPairs>
__device__ __forceinline__ uint8_t valid_of(const Inputs& in, int32_t key,
                                            long long r) {
  if (kPairs && key != kI32Max) return 1;
  return in.valid[r];
}

template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
    stats_tiles(Inputs in, pdp::Scan<Seg> scan, Outputs out) {
  // [0]: the row before the tile; [tile_n + 1]: the row after it.
  __shared__ int32_t s_key[kTile + 2];
  __shared__ int32_t s_pk[kPairs ? kTile + 2 : 1];
  __shared__ float s_val[kPairs ? kTile : 1];
  __shared__ uint8_t s_valid[kTile + 1];
  __shared__ __align__(8) uint8_t s_flag[kTile];
  __shared__ Seg scan_smem[32];
  const long long tile = pdp::claim_tile(scan.counter);
  const long long t0 = tile * kTile;
  const int tile_n = static_cast<int>(in.n - t0 < kTile ? in.n - t0 : kTile);
  const bool has_next = t0 + tile_n < in.n;
  const int tid = threadIdx.x;

  // Stage: perm and the sorted key coalesced, the rest gathered once.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j >= tile_n) continue;
    const long long r = __ldcs(in.perm + t0 + j);
    const int32_t key = __ldcs(in.key + t0 + j);
    s_key[j + 1] = key;
    const uint8_t v = valid_of<kPairs>(in, key, r);
    s_valid[j] = v;
    if constexpr (kPairs) {
      s_pk[j + 1] = v ? __ldcs(in.pk + r) : kI32Max;
      s_val[j] = in.values ? __ldcs(in.values + r) : 0.0f;
    }
  }
  if (tid == 0 && t0 > 0) {
    const int32_t key = in.key[t0 - 1];
    s_key[0] = key;
    if constexpr (kPairs) {
      const long long r = in.perm[t0 - 1];
      s_pk[0] = valid_of<kPairs>(in, key, r) ? in.pk[r] : kI32Max;
    }
  }
  if (tid == 32 && has_next) {
    const int32_t key = in.key[t0 + tile_n];
    s_key[tile_n + 1] = key;
    s_valid[tile_n] = valid_of<kPairs>(in, key, in.perm[t0 + tile_n]);
  }
  __syncthreads();
  // Boundary flags of every row.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j >= tile_n) continue;
    const long long i = t0 + j;
    const bool v = s_valid[j] != 0;
    const bool key_head = i == 0 || s_key[j + 1] != s_key[j];
    bool pair_head = false;
    if constexpr (kPairs) pair_head = key_head || s_pk[j + 1] != s_pk[j];
    const bool head = key_head && v, pair = pair_head && v;
    s_flag[j] = (pair ? kMark | kPair : 0) | (head || !v ? kSegStart : 0) |
                (head ? kOutput : 0) | (pair || !v ? kPairStart : 0);
  }
  __syncthreads();
  // The tile's last row ends its segment where the next row starts one.
  const bool next_starts =
      !has_next || !s_valid[tile_n] ||
      s_key[tile_n + 1] != s_key[tile_n];

  // Scan: thread t owns rows [8t, 8t + 8) of the tile.
  const int first = tid * kItems;
  const uint64_t flags8 = *reinterpret_cast<const uint64_t*>(s_flag + first);
  Seg e[kItems];
  Seg acc = SegOp::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint8_t f = static_cast<uint8_t>(flags8 >> (8 * k));
    const bool live = first + k < tile_n;
    const long long i = t0 + first + k;
    e[k] = Seg{live && (f & kSegStart) ? 2 * i + ((f & kOutput) ? 1 : 0)
                                       : -1,
               live && (f & kMark) ? 1 : 0};
    acc = SegOp::combine(acc, e[k]);
  }
  Seg total;
  const Seg excl = pdp::block_exclusive_scan<SegOp>(acc, scan_smem, &total);
  const Seg before = pdp::tile_prefix<SegOp>(
      scan, tile, tile == 0 || (s_flag[0] & kSegStart), total);
  Seg state = SegOp::combine(before, excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = first + k;
    if (j >= tile_n) break;
    state = SegOp::combine(state, e[k]);
    const bool last = j + 1 < tile_n ? (s_flag[j + 1] & kSegStart) != 0
                                     : next_starts;
    if (last && state.pos >= 0 && (state.pos & 1)) {
      const long long start = state.pos >> 1;
      out.len[start] = static_cast<int32_t>(t0 + j - start + 1);
      if (kPairs) out.cnt[start] = static_cast<int32_t>(state.cnt);
    }
  }

  // The other outputs, striped.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid + k * kThreads;
    if (j >= tile_n) continue;
    const long long i = t0 + j;
    const uint8_t f = s_flag[j];
    out.head[i] = (f & kOutput) ? 1 : 0;
    if (!(f & kOutput)) {
      __stcs(out.len + i, 0);
      if (kPairs) __stcs(out.cnt + i, 0);
    }
    if constexpr (!kPairs) continue;
    const bool pair = f & kPair;
    out.new_pair[i] = pair ? 1 : 0;
    __stcs(out.pair_pk + i, pair ? s_pk[j + 1] : kI32Max);
    int32_t len = 0;
    float sum = 0.0f;
    if (pair) {
      // The pair's rows in order: staged, then past the tile's end.
      const int32_t pid = s_key[j + 1], pk = s_pk[j + 1];
      sum = sum + s_val[j];
      len = 1;
      for (long long m = j + 1;; ++m) {
        if (m < tile_n) {
          if (s_flag[m] & kPairStart) break;
          sum = sum + s_val[m];
          ++len;
          continue;
        }
        const long long ii = t0 + m;
        if (ii >= in.n) break;
        const long long r = in.perm[ii];
        if (in.key[ii] != pid || !valid_of<kPairs>(in, pid, r) ||
            in.pk[r] != pk)
          break;
        sum = sum + (in.values ? in.values[r] : 0.0f);
        ++len;
      }
    }
    __stcs(out.pair_len + i, len);
    __stcs(out.pair_sum + i, sum);
  }
}

template <bool kPairs>
int launch(const Inputs& in, void* scratch, const Outputs& out,
           cudaStream_t s) {
  if (in.n <= 0) return 0;
  const long long tiles = tiles_of(in.n);
  cudaMemsetAsync(scratch, 0, pdp::scan_reset_bytes(tiles), s);
  stats_tiles<kPairs><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      in, pdp::carve_scan<Seg>(scratch, tiles), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch for n rows (either entry): the tile counter, a status word and
// two published states per tile of 2048.
extern "C" long long group_stats_scratch_bytes(long long n) {
  return static_cast<long long>(pdp::scan_bytes<Seg>(tiles_of(n)));
}

// perm: int64[n], the stable order by (pid, pk) with invalid rows' keys
// sunk to INT32_MAX; spid: the sunk pid in that order (C5's sorted_top);
// pk: int32[n]; values: float32[n] or null; valid: u8[n]. Outputs in
// sorted order: new_pair, new_pid u8[n]; pair_len, l1, l0, pair_pk
// int32[n]; pair_sum float32[n].
extern "C" int group_stats_pairs(const void* perm, const void* spid,
                                 const void* pk, const void* values,
                                 const void* valid, long long n,
                                 void* scratch, void* new_pair, void* new_pid,
                                 void* pair_len, void* pair_sum, void* l1,
                                 void* l0, void* pair_pk, void* stream) {
  const Inputs in{static_cast<const long long*>(perm),
                  static_cast<const int32_t*>(spid),
                  static_cast<const int32_t*>(pk),
                  static_cast<const float*>(values),
                  static_cast<const uint8_t*>(valid), n};
  const Outputs out{static_cast<uint8_t*>(new_pid),
                    static_cast<int32_t*>(l1),
                    static_cast<int32_t*>(l0),
                    static_cast<uint8_t*>(new_pair),
                    static_cast<int32_t*>(pair_len),
                    static_cast<float*>(pair_sum),
                    static_cast<int32_t*>(pair_pk)};
  return launch<true>(in, scratch, out, static_cast<cudaStream_t>(stream));
}

// perm: int64[n], the stable order by keys; skeys: the keys in that order
// (C5's sorted_top); valid: u8[n]. Outputs in sorted order: new_seg u8[n],
// seg_len int32[n].
extern "C" int group_stats_keys(const void* perm, const void* skeys,
                                const void* valid, long long n, void* scratch,
                                void* new_seg, void* seg_len, void* stream) {
  const Inputs in{static_cast<const long long*>(perm),
                  static_cast<const int32_t*>(skeys), nullptr, nullptr,
                  static_cast<const uint8_t*>(valid), n};
  const Outputs out{static_cast<uint8_t*>(new_seg),
                    static_cast<int32_t*>(seg_len),
                    nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch<false>(in, scratch, out, static_cast<cudaStream_t>(stream));
}
