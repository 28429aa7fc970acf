// C22 reshard_count: each row's destination shard, the shard's send counts
// and each row's stable rank within its destination bucket.
//
// Replaces K22's counting half, pipelinedp_tpu/parallel/reshard.py
// _dest_shard (:91) and _count_stats_kernel (:106): dest(row) =
// _hash_mix(u32(pid) * 0x9E3779B9 ^ salt) % D (executor.py:277's murmur3
// finaliser), invalid rows to bucket D, and the per-destination send
// counts that the JAX package psums / pmaxes into [max send, max receive,
// total]. Here the caller stacks the D shards' [D] counts into the [D, D]
// table, fetches it (D^2 ints, mesh.host_fetch) and derives the same three
// numbers on the host, exactly as :120-122 do; and this kernel also writes
// each row's rank among the earlier rows of its bucket, which is what lets
// C23 write every row straight to its final slot, with no sort.
//
// One pass, one launch after the memset of its status words. Tiles of
// PDP_RESHARD_TILE rows (cuda_build.py) are claimed in order
// (pdp::claim_tile). The tiles are laid in pid's 16-byte phase: with s the
// row offset of pid within its 16 bytes, tile k holds the rows
// [k * TILE - s, (k + 1) * TILE - s), so every whole group of four rows is
// one 16-byte load of pid, one 4-byte load of valid (where valid shares the
// phase) and one 16-byte store of dest and of rank (the wrapper lays the
// outputs in pid's phase). Groups cut by the view's ends go row by row.
//
// A block of 256 threads:
//   1. loads its tile, four rows a group, group q = thread + 256 m: dest of
//      every row, stored at once, and kept as a byte in shared memory;
//      while D + 1 <= 8 the tile's bucket totals too (a thread's counts in
//      8-bit fields of one word, summed by __reduce_add_sync), published
//      at once, so that the later tiles' walks (step 4) find them while
//      this tile still ranks (published after the ranking, the walks
//      waited on them);
//   2. ranks the tile in 16 slots of 256 rows, one row a thread: while
//      D + 1 <= kBallotBuckets (8), a warp's rows of one bucket are found
//      by four ballots, one of each bit of the bucket and one of the real
//      rows (as radix ranks take them), whatever D is; above, by
//      __match_any_sync; the group's popcount goes to a per-(slot, warp)
//      count table in shared memory (each entry written by one lane: no
//      shared atomics), and the row keeps its rank among the earlier lanes
//      of its group;
//   3. scans the count table, one warp a bucket, into each (slot, warp)'s
//      offset in the tile and the tile's bucket totals;
//   4. publishes the totals (above 8 buckets; below, step 1 did) and
//      looks back over the earlier tiles, bucket
//      by bucket: each (tile, bucket) status is one 64-bit word, flag and
//      count together (1: the tile's count, 2: the inclusive count of
//      tiles [0, tile]), so a word needs no fence between value and flag;
//      warp w walks buckets w, w + 8, ..., 32 tiles at a time, as
//      pdp::look_back does;
//   5. rank = the bucket's count before the tile + the (slot, warp)
//      offset + the lane rank, staged in shared memory and stored four
//      rows at a time; the last tile's inclusive counts are `counts`.
// The ranks follow the row order, so the exchange is stable, as the JAX
// package's argsort(dest, stable=True) is.
//
// Bound: bytes, 13 B a row (pid 4 + valid 1 read, dest 4 + rank 4
// written); the status words are (D + 1) * 8 B a tile, 1/1300 of that at
// D = 4.
#include "common.cuh"

#ifndef PDP_RESHARD_TILE
#error "PDP_RESHARD_TILE comes from cuda_build.py"
#endif

namespace {

constexpr int kMaxShards = 64;
constexpr int kMaxBuckets = kMaxShards + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = PDP_RESHARD_TILE;
constexpr int kSlots = kTile / kThreads;        // slots of 256 rows a tile
constexpr int kGroups = kTile / 4;              // 4-row groups a tile
constexpr int kGroupsPerThread = kGroups / kThreads;
constexpr int kEntries = kSlots * kWarps;       // (slot, warp) counts
constexpr int kBallotBuckets = 8;
constexpr unsigned kNone = 0xffu;               // a row past the view
static_assert(kTile % (4 * kThreads) == 0, "whole groups a thread");
static_assert(kEntries % 32 == 0, "whole warps a bucket's scan");
static_assert(kTile < 65536, "a (slot, warp) offset fits 16 bits");

__device__ __forceinline__ uint32_t hash_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// h % n for a 32-bit h and 1 <= n < 2^32, exactly, by the multiplier
// magic = 2^64 / n + 1 (Lemire's fastmod): two 64-bit multiplies in place
// of the division.
__device__ __forceinline__ unsigned fast_mod(uint32_t h, unsigned n,
                                             unsigned long long magic) {
  return static_cast<unsigned>(__umul64hi(magic * h, n));
}

__device__ __forceinline__ unsigned bucket(int32_t pid, bool valid,
                                           int n_shards,
                                           unsigned long long magic,
                                           uint32_t salt) {
  if (!valid) return static_cast<unsigned>(n_shards);
  const uint32_t h =
      hash_mix((static_cast<uint32_t>(pid) * 0x9E3779B9u) ^ salt);
  return fast_mod(h, static_cast<unsigned>(n_shards), magic);
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long word(unsigned flag,
                                                   unsigned count) {
  return (static_cast<unsigned long long>(flag) << 32) | count;
}

// Warp-wide: the rows of bucket b in tiles [0, tile), from the status
// words of tiles [.., tile) (row j * nb + b), 32 tiles a step, lane 31
// the nearest: the nearest tile holding an inclusive count ends the walk
// and drops the lanes before it. (Wider steps, 4 or 8 tiles a lane, were
// slower.)
__device__ unsigned look_back(const unsigned long long* status, int nb,
                              int b, long long tile) {
  const int lane = threadIdx.x & 31;
  unsigned acc = 0;
  for (long long hi = tile;; hi -= 32) {
    const long long j = hi - 32 + lane;
    unsigned long long w = 0;
    if (j >= 0) {
      const unsigned long long* p = status + j * nb + b;
      while (((w = load_word(p)) >> 32) == 0) {
      }
    }
    const unsigned inclusive =
        __ballot_sync(pdp::kFullMask, (w >> 32) == 2);
    unsigned a = static_cast<unsigned>(w);
    if (inclusive != 0u && lane < 31 - __clz(inclusive)) a = 0;
    acc += __reduce_add_sync(pdp::kFullMask, a);
    if (inclusive != 0u || hi <= 32) break;
  }
  return acc;
}

struct Frame {
  long long n;
  unsigned long long magic;  // fast_mod's multiplier for n_shards
  int phase;       // pid's row offset within its 16 bytes
  bool valid_vec;  // valid shares the phase: 4 rows are one aligned word
  bool out_vec;    // dest and rank share it: 4 rows are one int4
};

// One kernel a bucket capacity: kBuckets = kBallotBuckets ranks by
// ballots, kMaxBuckets by __match_any_sync; the smaller one's count table
// leaves room for more blocks an SM.
template <int kBuckets>
__global__ void __launch_bounds__(kThreads)
    count_ranks(const int32_t* __restrict__ pid,
                const unsigned char* __restrict__ valid, Frame f,
                int n_shards, uint32_t salt, int32_t* __restrict__ dest,
                int32_t* __restrict__ rank, int32_t* __restrict__ counts,
                unsigned long long* __restrict__ counter,
                unsigned long long* __restrict__ status, long long tiles) {
  // A row's bucket (kNone: no row) and its rank in its warp's group.
  __shared__ __align__(4) unsigned char d_s[kTile];
  __shared__ unsigned char lane_s[kTile];
  __shared__ uint16_t table[kBuckets * kEntries];
  __shared__ __align__(16) int32_t rank_s[kTile];
  __shared__ unsigned total_s[kBuckets];
  __shared__ unsigned prefix_s[kBuckets];
  __shared__ unsigned warp_total[kWarps][kBallotBuckets];
  const int nb = n_shards + 1;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long k = pdp::claim_tile(counter);
  unsigned long long counted = 0;  // 8-bit counts of the thread's buckets

  // 1. dest, four rows a group.
#pragma unroll
  for (int m = 0; m < kGroupsPerThread; ++m) {
    const int q = t + kThreads * m;
    const long long i0 = (k * kGroups + q) * 4 - f.phase;
    unsigned d[4];
    if (i0 >= 0 && i0 + 4 <= f.n) {
      const int4 p = *reinterpret_cast<const int4*>(pid + i0);
      unsigned v;
      if (f.valid_vec) {
        v = *reinterpret_cast<const unsigned*>(valid + i0);
      } else {
        v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) v |= unsigned(valid[i0 + e]) << (8 * e);
      }
      d[0] = bucket(p.x, (v & 0xffu) != 0, n_shards, f.magic, salt);
      d[1] = bucket(p.y, (v & 0xff00u) != 0, n_shards, f.magic, salt);
      d[2] = bucket(p.z, (v & 0xff0000u) != 0, n_shards, f.magic, salt);
      d[3] = bucket(p.w, (v & 0xff000000u) != 0, n_shards, f.magic, salt);
      if (f.out_vec) {
        *reinterpret_cast<int4*>(dest + i0) =
            make_int4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dest[i0 + e] = d[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long i = i0 + e;
        d[e] = kNone;
        if (i >= 0 && i < f.n) {
          d[e] = bucket(pid[i], valid[i] != 0, n_shards, f.magic, salt);
          dest[i] = d[e];
        }
      }
    }
    *reinterpret_cast<uchar4*>(d_s + 4 * q) =
        make_uchar4(d[0], d[1], d[2], d[3]);
    if (kBuckets == kBallotBuckets) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d[e] != kNone) counted += 1ull << (8 * d[e]);
    }
  }
  if (kBuckets == kBallotBuckets) {
    // The tile's bucket totals now, so that later tiles find this one's
    // counts published while it ranks its rows.
#pragma unroll
    for (int b = 0; b < kBallotBuckets; ++b) {
      const unsigned c = __reduce_add_sync(
          pdp::kFullMask, static_cast<unsigned>(counted >> (8 * b)) & 0xffu);
      if (lane == 0) warp_total[w][b] = c;
    }
  }
  __syncthreads();
  if (kBuckets == kBallotBuckets && t < nb) {
    unsigned total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) total += warp_total[v][t];
    total_s[t] = total;
    store_word(status + k * nb + t, word(k == 0 ? 2 : 1, total));
  }

  // 2. ranks within (slot, warp), counts a (slot, warp).
  const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
  for (int j = 0; j < kSlots; ++j) {
    const unsigned d = d_s[j * kThreads + t];
    const int e = j * kWarps + w;
    unsigned mine = 0;
    if (kBuckets == kBallotBuckets) {
      // A bucket below 8 is its three bits: the lanes of bucket x are
      // those whose bit ballots agree with x's bits, among the real rows.
      const unsigned real = __ballot_sync(pdp::kFullMask, d != kNone);
      const unsigned b0 = __ballot_sync(pdp::kFullMask, d & 1u);
      const unsigned b1 = __ballot_sync(pdp::kFullMask, d & 2u);
      const unsigned b2 = __ballot_sync(pdp::kFullMask, d & 4u);
      auto lanes_of = [&](unsigned x) {
        return real & (x & 1u ? b0 : ~b0) & (x & 2u ? b1 : ~b1) &
               (x & 4u ? b2 : ~b2);
      };
      if (d != kNone) mine = lanes_of(d);
      if (lane < nb) table[e * kBuckets + lane] = __popc(lanes_of(lane));
    } else {
      for (int b = lane; b < nb; b += 32) table[e * kBuckets + b] = 0;
      __syncwarp();
      mine = __match_any_sync(pdp::kFullMask, d);
      if (d != kNone && lane == __ffs(mine) - 1)
        table[e * kBuckets + d] = __popc(mine);
    }
    lane_s[j * kThreads + t] = __popc(mine & below);
  }
  __syncthreads();

  // 3. each (slot, warp)'s offset within the tile, and the tile's totals.
  for (int b = w; b < nb; b += kWarps) {
    unsigned carry = 0;
#pragma unroll
    for (int c = 0; c < kEntries / 32; ++c) {
      uint16_t* at = table + (c * 32 + lane) * kBuckets + b;
      const unsigned x = *at;
      const unsigned inc = pdp::warp_inclusive_scan<pdp::SumOp<unsigned>>(x);
      *at = static_cast<uint16_t>(carry + inc - x);
      carry += __shfl_sync(pdp::kFullMask, inc, 31);
    }
    if (kBuckets != kBallotBuckets && lane == 0) total_s[b] = carry;
  }
  __syncwarp();

  // 4. publish (the ballot path did at step 1; a barrier since keeps that
  // store before the inclusive one), then look back. Here a bucket's
  // words are written by lane 0 of the warp that walks it, so its two
  // stores keep their order.
  if (kBuckets != kBallotBuckets)
    for (int b = w; b < nb; b += kWarps)
      if (lane == 0) store_word(status + k * nb + b, word(k == 0 ? 2 : 1,
                                                          total_s[b]));
  for (int b = w; b < nb; b += kWarps) {
    const unsigned before = k == 0 ? 0u : look_back(status, nb, b, k);
    if (lane == 0) {
      prefix_s[b] = before;
      if (k > 0) store_word(status + k * nb + b, word(2, before + total_s[b]));
      if (k == tiles - 1) counts[b] = static_cast<int32_t>(before + total_s[b]);
    }
  }
  __syncthreads();

  // 5. ranks, staged, then stored four rows at a time.
#pragma unroll 4
  for (int j = 0; j < kSlots; ++j) {
    const int p = j * kThreads + t;
    const unsigned d = d_s[p];
    if (d != kNone)
      rank_s[p] = static_cast<int32_t>(
          prefix_s[d] + table[(j * kWarps + w) * kBuckets + d] + lane_s[p]);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kGroupsPerThread; ++m) {
    const int q = t + kThreads * m;
    const long long i0 = (k * kGroups + q) * 4 - f.phase;
    if (f.out_vec && i0 >= 0 && i0 + 4 <= f.n) {
      *reinterpret_cast<int4*>(rank + i0) =
          *reinterpret_cast<const int4*>(rank_s + 4 * q);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e >= 0 && i0 + e < f.n) rank[i0 + e] = rank_s[4 * q + e];
    }
  }
}

int row_phase(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

long long n_tiles(long long n, int phase) {
  return (n + phase + kTile - 1) / kTile;
}

}  // namespace

// pid int32[n], valid bool[n] -> dest int32[n] (n_shards for an invalid
// row), rank int32[n] (the row's rank among the earlier rows of its
// bucket), counts int32[n_shards + 1] (rows a bucket, the invalid last).
// dest and rank give 16-byte stores where they share pid's 16-byte phase.
// scratch: scratch_bytes, 256-byte aligned, at least the tile counter
// (256 B) and one 8-byte status word a (tile, bucket); the call clears
// what it uses. 1 <= n_shards <= 64.
extern "C" int reshard_count(const void* pid, const void* valid, long long n,
                             int n_shards, unsigned salt, void* dest,
                             void* rank, void* counts, void* scratch,
                             long long scratch_bytes, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    cudaMemsetAsync(counts, 0, sizeof(int32_t) * (n_shards + 1), st);
    return static_cast<int>(cudaGetLastError());
  }
  Frame f;
  f.n = n;
  f.magic = ~0ULL / static_cast<unsigned>(n_shards) + 1;
  f.phase = row_phase(pid);
  const long long tiles = n_tiles(n, f.phase);
  const long long need = 256 + tiles * (n_shards + 1) * 8;
  if (scratch_bytes < need || (reinterpret_cast<uintptr_t>(scratch) & 255))
    return static_cast<int>(cudaErrorInvalidValue);
  f.valid_vec = (reinterpret_cast<uintptr_t>(valid) & 3) == f.phase;
  f.out_vec = row_phase(dest) == f.phase && row_phase(rank) == f.phase;
  cudaMemsetAsync(scratch, 0, need, st);
  char* base = static_cast<char*>(scratch);
  auto kernel = n_shards + 1 <= kBallotBuckets ? count_ranks<kBallotBuckets>
                                               : count_ranks<kMaxBuckets>;
  kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const int32_t*>(pid),
      static_cast<const unsigned char*>(valid), f, n_shards, salt,
      static_cast<int32_t*>(dest), static_cast<int32_t*>(rank),
      static_cast<int32_t*>(counts),
      reinterpret_cast<unsigned long long*>(base),
      reinterpret_cast<unsigned long long*>(base + 256), tiles);
  return static_cast<int>(cudaGetLastError());
}
