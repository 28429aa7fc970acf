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
// Three launches over tiles of 256 rows (one row a thread):
//   1. dest of every row, written out, and the tile's bucket histogram
//      (shared-memory atomics), stored bucket-major [D + 1][tiles];
//   2. one block a bucket scans its row of tile counts into exclusive
//      per-tile offsets and writes the bucket's total;
//   3. the rank: the tile's offset of the bucket + the counts of the
//      bucket in the tile's earlier warps + the row's rank among the
//      earlier lanes of its warp with the same bucket (__match_any_sync).
// The ranks follow the row order, so the exchange is stable, as the JAX
// package's argsort(dest, stable=True) is.
//
// Bound: bytes, 13 B a row (pid 4 + valid 1 read, dest 4 + rank 4
// written); the tile table is (D + 1) * 4 B a tile, 1/64 of that at D = 4.
// Launch 3 re-reads dest (4 B a row more); the design keeps every pass a
// streaming, coalesced pass and spends shared memory only on the D + 1
// counters of a tile (and of each of its 8 warps).
#include "common.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr int kRows = 256;  // rows a tile = threads a block
constexpr int kWarps = kRows / 32;

__device__ __forceinline__ uint32_t hash_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void tile_histograms(const int32_t* __restrict__ pid,
                                const bool* __restrict__ valid, long long n,
                                int n_shards, uint32_t salt,
                                int32_t* __restrict__ dest,
                                int32_t* __restrict__ tile_counts,
                                long long tiles) {
  __shared__ int hist[kMaxShards + 1];
  for (int b = threadIdx.x; b <= n_shards; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  if (i < n) {
    int d = n_shards;
    if (valid[i]) {
      const uint32_t h =
          hash_mix((static_cast<uint32_t>(pid[i]) * 0x9E3779B9u) ^ salt);
      d = static_cast<int>(h % static_cast<uint32_t>(n_shards));
    }
    dest[i] = d;
    atomicAdd(&hist[d], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b <= n_shards; b += blockDim.x)
    tile_counts[b * tiles + blockIdx.x] = hist[b];
}

__global__ void scan_buckets(int32_t* __restrict__ tile_counts,
                             long long tiles, int32_t* __restrict__ counts) {
  __shared__ int32_t smem[32];
  pdp::block_scan_in_place<pdp::SumOp<int32_t>>(
      tile_counts + blockIdx.x * tiles, tiles, smem, counts + blockIdx.x);
}

__global__ void tile_ranks(const int32_t* __restrict__ dest, long long n,
                           int n_shards,
                           const int32_t* __restrict__ tile_offsets,
                           long long tiles, int32_t* __restrict__ rank) {
  __shared__ int warp_counts[kWarps][kMaxShards + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * (kMaxShards + 1); k += blockDim.x)
    (&warp_counts[0][0])[k] = 0;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  // Rows past n take bucket -1: they match no real row.
  const int d = i < n ? dest[i] : -1;
  const unsigned same = __match_any_sync(pdp::kFullMask, d);
  const int lane_rank = __popc(same & ((1u << lane) - 1u));
  if (d >= 0 && lane == __ffs(same) - 1) warp_counts[warp][d] = __popc(same);
  __syncthreads();
  if (d < 0) return;
  int r = tile_offsets[d * tiles + blockIdx.x] + lane_rank;
  for (int w = 0; w < warp; ++w) r += warp_counts[w][d];
  rank[i] = r;
}

}  // namespace

// Scratch int32 elements of a launch over n rows and n_shards shards.
extern "C" long long reshard_count_scratch_elements(long long n,
                                                    int n_shards) {
  return ((n + kRows - 1) / kRows) * (n_shards + 1);
}

// pid int32[n], valid bool[n] -> dest int32[n] (n_shards for an invalid
// row), rank int32[n] (the row's rank among the earlier rows of its
// bucket), counts int32[n_shards + 1] (rows a bucket, the invalid last);
// scratch int32[reshard_count_scratch_elements]. 1 <= n_shards <= 64.
extern "C" int reshard_count(const void* pid, const void* valid, long long n,
                             int n_shards, unsigned salt, void* dest,
                             void* rank, void* counts, void* scratch,
                             void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    cudaMemsetAsync(counts, 0, sizeof(int32_t) * (n_shards + 1), st);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = (n + kRows - 1) / kRows;
  int32_t* table = static_cast<int32_t*>(scratch);
  tile_histograms<<<static_cast<unsigned>(tiles), kRows, 0, st>>>(
      static_cast<const int32_t*>(pid), static_cast<const bool*>(valid), n,
      n_shards, salt, static_cast<int32_t*>(dest), table, tiles);
  scan_buckets<<<n_shards + 1, 1024, 0, st>>>(table, tiles,
                                               static_cast<int32_t*>(counts));
  tile_ranks<<<static_cast<unsigned>(tiles), kRows, 0, st>>>(
      static_cast<const int32_t*>(dest), n, n_shards, table, tiles,
      static_cast<int32_t*>(rank));
  return static_cast<int>(cudaGetLastError());
}
