// C10 block_offsets: the row window of every partition block.
//
// Replaces the searchsorted of the blocked route, K15a,
// pipelinedp_tpu/parallel/large_p.py aggregate_blocked (:1517-1522) and
// select_partitions_blocked (:1304-1308): jnp.searchsorted(stream,
// boundaries, side="left") over the partition-sorted row stream of pass 1,
// which gives each block b of partitions [bound[b], bound[b + 1]) its rows
// [offset[b], offset[b + 1]) and, at the last boundary, the number of
// surviving rows.
//
// One thread a boundary: a lower-bound binary search over the int32
// stream (ascending), written as int64. The boundaries are few (one per
// block plus one), so the kernel is a handful of dependent loads per
// thread; its time is the launch and ~log2(n) reads from L2.
//
// Bound: bytes in principle (each boundary read once, each offset written
// once, and the ~log2(n) stream reads per boundary), in practice launch
// latency: (n_blocks + 1) * log2(n) 4-byte reads are a few kilobytes.
#include "common.cuh"

namespace {

__global__ void lower_bounds(const int32_t* __restrict__ stream, long long n,
                             const int32_t* __restrict__ boundaries,
                             long long m, long long* __restrict__ offsets) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int32_t v = boundaries[j];
  long long lo = 0, hi = n;  // first index with stream[index] >= v
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (stream[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  offsets[j] = lo;
}

}  // namespace

// stream: int32[n] ascending; boundaries: int32[m]; offsets: int64[m].
extern "C" int block_offsets(const void* stream, long long n,
                             const void* boundaries, long long m,
                             void* offsets, void* stream_handle) {
  if (m <= 0) return 0;
  constexpr int kBlock = 128;
  lower_bounds<<<static_cast<unsigned>((m + kBlock - 1) / kBlock), kBlock, 0,
                 static_cast<cudaStream_t>(stream_handle)>>>(
      static_cast<const int32_t*>(stream), n,
      static_cast<const int32_t*>(boundaries), m,
      static_cast<long long*>(offsets));
  return static_cast<int>(cudaGetLastError());
}
