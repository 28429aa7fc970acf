// C10 block_offsets: the row window of every partition block.
//
// Replaces the searchsorted of the blocked route, K15a,
// pipelinedp_tpu/parallel/large_p.py aggregate_blocked (:1517-1522) and
// select_partitions_blocked (:1304-1308), and of the meshed route,
// _sharded_block_offsets (:785-796, :1069): jnp.searchsorted(stream,
// boundaries, side="left") over the partition-sorted row stream of pass 1,
// which gives each block b of partitions [bound[b], bound[b + 1]) its rows
// [offset[b], offset[b + 1]) and, at the last boundary, the number of
// surviving rows.
//
// One warp a boundary: a lower-bound search over the int32 stream
// (ascending), written as int64. Each round the 32 lanes read the last
// rows of 32 equal chunks of the range left, in one load through the
// read-only path (__ldg); __ballot_sync and __popc count the chunks that
// lie wholly below the boundary, which names the chunk holding the answer,
// 1/32 of the range. 2^24 rows take 5 dependent rounds where one thread's
// binary search took 24.
//
// Two entries, one search:
//  * block_offsets: one stream against m boundaries read from the device
//    (the host-staged route's survivor count, the sweep's P + 1
//    partition starts);
//  * block_window_offsets: S streams of one device (a mesh's shards that
//    share a card) in one launch, their pointer-and-length table passed by
//    value in the kernel's parameters. Boundary b of every stream is
//    min(base + b * capacity, INT32_MAX, end) for b in 0..n_blocks, made
//    in the kernel (kernels.block_window_boundaries), so the
//    caller uploads nothing.
//
// Bound: the bytes (each boundary read or made, each offset written) are
// under a kilobyte at the blocked route's 6 boundaries, 2e-7 ms at
// 3.35 TB/s. What bounds the kernel is the launch plus ~log32(n) dependent
// memory latencies a warp (5 at 2^24 rows); the warps search in parallel.
#include "common.cuh"

namespace {

constexpr int kBlock = 128;  // 4 warps a block
constexpr int kMaxStreams = 64;

struct Streams {
  const int32_t* ptr[kMaxStreams];
  long long n[kMaxStreams];
};

// The first index of stream[0, n) holding a value >= v (n where none
// does); every lane of the warp returns it. The answer lies in [lo, hi]
// and the rows [lo, hi) are not yet read; a round reads row
// lo + (k + 1) * step - 1, the last of chunk k, on lane k.
__device__ __forceinline__ long long warp_lower_bound(
    const int32_t* __restrict__ stream, long long n, long long v, int lane) {
  long long lo = 0, hi = n;
  while (lo < hi) {  // warp-uniform: every lane holds the same lo, hi
    const long long step = (hi - lo + 31) >> 5;
    const long long last = lo + (lane + 1) * step - 1;
    const bool below =
        last < hi && static_cast<long long>(__ldg(stream + last)) < v;
    // Chunks [0, c) lie wholly below v; chunk c's last row (if it lies
    // in [lo, hi)) holds a value >= v.
    const int c = __popc(__ballot_sync(pdp::kFullMask, below));
    const long long next_lo = lo + c * step;
    const long long next_hi = next_lo + step - 1;
    lo = next_lo < hi ? next_lo : hi;
    hi = next_hi < hi ? next_hi : hi;
  }
  return lo;
}

__global__ void lower_bounds(const int32_t* __restrict__ stream, long long n,
                             const int32_t* __restrict__ boundaries,
                             long long m, long long* __restrict__ offsets) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (w >= m) return;  // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const long long off =
      warp_lower_bound(stream, n, __ldg(boundaries + w), lane);
  if (lane == 0) offsets[w] = off;
}

__global__ void window_lower_bounds(const __grid_constant__ Streams streams,
                                    long long n_warps, long long n_bounds,
                                    long long base, long long capacity,
                                    long long end,
                                    long long* __restrict__ offsets) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (w >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const long long s = w / n_bounds;
  long long v = base + (w - s * n_bounds) * capacity;
  v = v < INT32_MAX ? v : INT32_MAX;
  v = v < end ? v : end;
  const long long off =
      warp_lower_bound(streams.ptr[s], streams.n[s], v, lane);
  if (lane == 0) offsets[w] = off;
}

unsigned grid_for(long long warps) {
  return static_cast<unsigned>((warps * 32 + kBlock - 1) / kBlock);
}

}  // namespace

// stream: int32[n] ascending; boundaries: int32[m]; offsets: int64[m].
extern "C" int block_offsets(const void* stream, long long n,
                             const void* boundaries, long long m,
                             void* offsets, void* stream_handle) {
  if (m <= 0) return 0;
  lower_bounds<<<grid_for(m), kBlock, 0,
                 static_cast<cudaStream_t>(stream_handle)>>>(
      static_cast<const int32_t*>(stream), n,
      static_cast<const int32_t*>(boundaries), m,
      static_cast<long long*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// table: the S streams' addresses, then their lengths (int64[2 * S]);
// stream s is int32[table[S + s]] ascending, S = n_streams <= 64, all on
// the current device. offsets: int64[n_streams, n_blocks + 1], row s the
// lower bounds in stream s of min(base + b * capacity, INT32_MAX, end).
extern "C" int block_window_offsets(const long long* table, int n_streams,
                                    long long base, long long capacity,
                                    long long n_blocks, long long end,
                                    void* offsets, void* stream_handle) {
  if (n_streams < 1 || n_streams > kMaxStreams || n_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Streams streams{};
  for (int s = 0; s < n_streams; ++s) {
    streams.ptr[s] = reinterpret_cast<const int32_t*>(table[s]);
    streams.n[s] = table[n_streams + s];
  }
  const long long n_bounds = n_blocks + 1;
  const long long n_warps = n_bounds * n_streams;
  window_lower_bounds<<<grid_for(n_warps), kBlock, 0,
                        static_cast<cudaStream_t>(stream_handle)>>>(
      streams, n_warps, n_bounds, base, capacity, end,
      static_cast<long long*>(offsets));
  return static_cast<int>(cudaGetLastError());
}
