// C6 compact_kept: kept-first compaction of the released partitions.
//
// Replaces K8, pipelinedp_tpu/executor.py compact_release (:936): a stable
// argsort of ~keep (kept ids ascending, then dropped ids ascending, the
// kept prefix exactly nonzero(keep)) and a gather of every output column
// into that order; also the same compaction at the end of
// select_partitions_release_kernel (:1128).
//
// A flag scan and a scatter, as a three-pass tile scan: per-tile kept
// counts, one block scanning them in order (and writing the total
// n_kept), then a pass in which each row learns kept_before, the kept
// rows before it, and writes itself to
//   keep ? kept_before : n_kept + (i - kept_before)
// in `order` and in every output column. Inside a tile a warp takes 32
// neighbouring rows a step; a ballot and its popcounts rank them, and one
// warp scans the per-(step, warp) counts. Tiles are independent, so any
// P up to the dense route's 2^21 spreads over many blocks.
//
// A column holds `width` elements a partition (1, or D for a vector sum's
// [P, D]); a row moves whole. Any number of columns: the scatter runs
// once per group of kMaxColumns.
//
// The lane entry, compact_kept_lanes (K24: the megabatched service's vmap
// over job lanes, executor.py:984, :1141), compacts L jobs' [L, P] keep
// flags lane by lane: blockIdx.y is the lane, each lane has its tiles,
// its scan of their counts and its n_kept, and `order` holds lane-local
// ids, so row l of every output is lane l's solo compaction.
//
// Bound: bytes. Reads keep (1 B) and the columns, writes order (8 B) and
// the columns once each. Writes of dropped rows are as coalesced as the
// reads; kept rows are written densely in order.
#include "common.cuh"

namespace {

constexpr int kMaxColumns = 32;
constexpr int kWarps = pdp::kThreads / 32;
static_assert(pdp::kItems * kWarps == 64, "two (step, warp) counts a lane");

struct Columns {
  const void* in[kMaxColumns];
  void* out[kMaxColumns];
  int width[kMaxColumns];
  int n;
};

// Row k * kThreads + threadIdx.x of the block's tile: a striped layout,
// so each step of a warp reads and writes 32 neighbouring rows.
__device__ __forceinline__ long long row_of(int k) {
  return static_cast<long long>(blockIdx.x) * pdp::kTile +
         static_cast<long long>(k) * pdp::kThreads + threadIdx.x;
}

// The lane of the block (blockIdx.y; 0 for one job) shifts every pointer
// to its row: keep and order by n, the per-tile counts by the tiles of n.
__global__ void kept_per_tile(const uint8_t* __restrict__ keep, long long n,
                              long long* __restrict__ aggs) {
  __shared__ long long smem[32];
  keep += static_cast<long long>(blockIdx.y) * n;
  aggs += static_cast<long long>(blockIdx.y) * gridDim.x;
  long long c = 0;
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    const long long i = row_of(k);
    if (i < n && keep[i]) ++c;
  }
  long long total;
  pdp::block_exclusive_scan<pdp::SumOp<long long>>(c, smem, &total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

template <typename W>
__global__ void scatter_kept(const uint8_t* __restrict__ keep, long long n,
                             const long long* __restrict__ prefixes,
                             const long long* __restrict__ n_kept_total,
                             Columns cols, long long* __restrict__ order,
                             long long* __restrict__ n_kept) {
  const long long job = blockIdx.y;  // the lane of the batch (0: one job)
  keep += job * n;
  prefixes += job * gridDim.x;
  n_kept_total += job;
  order += job * n;
  n_kept += job;
  // Kept rows of each (step, warp) of the tile, then their exclusive
  // prefix in row order (step-major, then warp).
  __shared__ int step_warp[pdp::kItems * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned ballot[pdp::kItems];
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    const long long i = row_of(k);
    ballot[k] = __ballot_sync(pdp::kFullMask, i < n && keep[i]);
    if (lane == 0) step_warp[k * kWarps + warp] = __popc(ballot[k]);
  }
  __syncthreads();
  if (warp == 0) {
    // kItems * kWarps = 64 counts: two per lane, scanned by the warp.
    const int a = step_warp[2 * lane], b = step_warp[2 * lane + 1];
    int inc = a + b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(pdp::kFullMask, inc, d);
      if (lane >= d) inc += t;
    }
    const int excl = inc - a - b;
    step_warp[2 * lane] = excl;
    step_warp[2 * lane + 1] = excl + a;
  }
  __syncthreads();
  const long long tile_prefix = prefixes[blockIdx.x];
  const long long kept_all = *n_kept_total;
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_kept = kept_all;
#pragma unroll
  for (int k = 0; k < pdp::kItems; ++k) {
    const long long i = row_of(k);
    if (i >= n) break;
    const bool kept = (ballot[k] >> lane) & 1u;
    const long long before = tile_prefix + step_warp[k * kWarps + warp] +
                             __popc(ballot[k] & lanes_below);
    const long long dst = kept ? before : kept_all + (i - before);
    order[dst] = i;
    for (int j = 0; j < cols.n; ++j) {
      const int w = cols.width[j];
      const long long at = job * n * w;
      for (int c = 0; c < w; ++c) {
        static_cast<W*>(cols.out[j])[at + dst * w + c] =
            static_cast<const W*>(cols.in[j])[at + i * w + c];
      }
    }
  }
}

// Pass 2 per lane: block l scans lane l's tile counts in place and writes
// its total to totals[l].
__global__ void scan_lane_counts(long long* aggs, long long n_tiles,
                                 long long* totals) {
  __shared__ long long smem[32];
  pdp::block_scan_in_place<pdp::SumOp<long long>>(
      aggs + static_cast<long long>(blockIdx.x) * n_tiles, n_tiles, smem,
      totals + blockIdx.x);
}

int launch(const void* keep, long long n, int n_lanes,
           const void* const* in_cols, void* const* out_cols,
           const int* widths, int n_cols, int elem_bytes, void* scratch,
           void* order, void* n_kept, void* stream) {
  if (n_cols < 0) return -1;
  if (elem_bytes != 4 && elem_bytes != 8) return -1;
  if (n_lanes < 1 || n_lanes > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* aggs = static_cast<long long*>(scratch);
  if (n <= 0) {
    cudaMemsetAsync(n_kept, 0, sizeof(long long) * n_lanes, s);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = pdp::n_tiles(n);
  long long* totals = aggs + tiles * n_lanes;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(n_lanes));
  const uint8_t* flags = static_cast<const uint8_t*>(keep);
  kept_per_tile<<<grid, pdp::kThreads, 0, s>>>(flags, n, aggs);
  scan_lane_counts<<<static_cast<unsigned>(n_lanes), 1024, 0, s>>>(
      aggs, tiles, totals);
  // One scatter per group of up to kMaxColumns columns (a kernel argument
  // holds their pointers); each rewrites the same order and n_kept.
  int first = 0;
  do {
    Columns cols{};
    cols.n = n_cols - first < kMaxColumns ? n_cols - first : kMaxColumns;
    for (int c = 0; c < cols.n; ++c) {
      cols.in[c] = in_cols[first + c];
      cols.out[c] = out_cols[first + c];
      cols.width[c] = widths[first + c];
    }
    if (elem_bytes == 8) {
      scatter_kept<uint64_t><<<grid, pdp::kThreads, 0, s>>>(
          flags, n, aggs, totals, cols, static_cast<long long*>(order),
          static_cast<long long*>(n_kept));
    } else {
      scatter_kept<uint32_t><<<grid, pdp::kThreads, 0, s>>>(
          flags, n, aggs, totals, cols, static_cast<long long*>(order),
          static_cast<long long*>(n_kept));
    }
    first += cols.n;
  } while (first < n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch for P partitions: one count per tile plus the total.
extern "C" long long compact_kept_scratch_bytes(long long n) {
  return (pdp::n_tiles(n) + 1) * static_cast<long long>(sizeof(long long));
}

// keep: u8[n]; in_cols / out_cols: n_cols device pointers (host arrays) of
// elements of `elem_bytes` (4 or 8), widths[j] elements a partition;
// order: int64[n]; n_kept: one int64.
extern "C" int compact_kept(const void* keep, long long n,
                            const void* const* in_cols, void* const* out_cols,
                            const int* widths, int n_cols, int elem_bytes,
                            void* scratch, void* order, void* n_kept,
                            void* stream) {
  return launch(keep, n, 1, in_cols, out_cols, widths, n_cols, elem_bytes,
                scratch, order, n_kept, stream);
}

// The lane entry: keep u8[n_lanes, n] and every column [n_lanes, n, width]
// row-major; order int64[n_lanes, n] of lane-local ids; n_kept
// int64[n_lanes]. Scratch: compact_kept_lanes_scratch_bytes(n, n_lanes).
extern "C" long long compact_kept_lanes_scratch_bytes(long long n,
                                                      long long n_lanes) {
  return (pdp::n_tiles(n) + 1) * n_lanes *
         static_cast<long long>(sizeof(long long));
}

extern "C" int compact_kept_lanes(const void* keep, long long n, int n_lanes,
                                  const void* const* in_cols,
                                  void* const* out_cols, const int* widths,
                                  int n_cols, int elem_bytes, void* scratch,
                                  void* order, void* n_kept, void* stream) {
  return launch(keep, n, n_lanes, in_cols, out_cols, widths, n_cols,
                elem_bytes, scratch, order, n_kept, stream);
}
