// C6 compact_kept: kept-first compaction of the released partitions.
//
// Replaces K8, pipelinedp_tpu/executor.py compact_release (:936): a stable
// argsort of ~keep (kept ids ascending, then dropped ids ascending, the
// kept prefix exactly nonzero(keep)) and a gather of every output column
// into that order; also the same compaction at the end of
// select_partitions_release_kernel (:1128).
//
// A flag scan and a scatter in one cooperative launch. The work is a flat
// range of lanes x tiles (one lane for a solo call; tiles of pdp::kTile
// partitions, at least one a lane, so an empty lane still writes its
// n_kept). The grid is what the card holds at once (the host sizes it
// from the occupancy, compact_kept_blocks_per_sm, and launches it with
// cudaLaunchCooperativeKernel, which refuses a grid that does not fit);
// block b takes the contiguous run of `run` tiles from b * run.
//   Phase 1: each block ballots the keep flags of its tiles, keeps the
//     ballots of its first kRunTiles tiles in shared memory and writes
//     each tile's kept count to the tile-count words.
//   One grid-wide barrier (cooperative_groups' grid sync).
//   Phase 2: for each lane its run meets, a block sums that lane's tile
//     counts (all of them: the lane's n_kept; those before its first
//     tile: its kept prefix), then walks its tiles in order. Each row
//     learns kept_before, the kept rows before it, and writes itself to
//       keep ? kept_before : n_kept + (i - kept_before)
//     in `order` and in every output column. Inside a tile a warp takes
//     32 neighbouring rows a step; the ballot and its popcounts rank
//     them, and one warp scans the per-(step, warp) counts.
// A one-pass look-back cannot place the dropped rows (their slot needs
// the lane's total), so the barrier stays; a cooperative launch makes it
// one device operation a call, where the three launches of a tile scan
// each cost more than P = 17,770's 36 KB of work.
//
// A column holds `width` elements a partition (1, or D for a vector sum's
// [P, D]); a row moves whole. The column pointers and widths travel in
// the launch's parameters, kMaxColumns at a time: more columns are one
// more launch, which writes the same order and n_kept again.
//
// The lane entry (K24: the megabatched service's vmap over job lanes,
// executor.py:984, :1141) compacts L jobs' [L, P] keep flags lane by
// lane: `order` holds lane-local ids and row l of every output is lane
// l's solo compaction.
//
// Bound: bytes. Reads keep (1 B) and the columns, writes order (8 B) and
// the columns once each; the tile counts (4 B a tile) are read back from
// L2. Writes of dropped rows are as coalesced as the reads; kept rows are
// written densely in order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxColumns = 32;
constexpr int kWarps = pdp::kThreads / 32;
// Tiles of a block's run whose ballots phase 1 keeps for phase 2; later
// tiles of a longer run ballot keep again.
constexpr int kRunTiles = 8;
static_assert(pdp::kItems * kWarps == 64, "two (step, warp) counts a lane");

struct Columns {
  const void* in[kMaxColumns];
  void* out[kMaxColumns];
  int width[kMaxColumns];
  int n;
};

// The flat range of work: n partitions a lane, `tiles` tiles a lane,
// items = lanes x tiles, `run` tiles a block.
struct Range {
  long long n;
  long long tiles;
  long long items;
  long long run;
};

// Row k * kThreads + threadIdx.x of tile t: a striped layout, so each
// step of a warp reads and writes 32 neighbouring rows.
__device__ __forceinline__ long long row_of(long long tile, int k) {
  return tile * pdp::kTile + static_cast<long long>(k) * pdp::kThreads +
         threadIdx.x;
}

// Word k of the warp's ballots of a tile: the rows it keeps.
__device__ __forceinline__ unsigned ballot_of(const uint8_t* flags,
                                              long long n, long long tile,
                                              int k) {
  const long long i = row_of(tile, k);
  return __ballot_sync(pdp::kFullMask, i < n && flags[i]);
}

// (the sum of every tile count of the lane, the sum of those before
// `tile`), each to every thread: one block reduction of the pair.
__device__ __forceinline__ void lane_sums(const int* counts, long long tiles,
                                          long long tile, long long* smem,
                                          long long* total,
                                          long long* before) {
  long long all = 0, pre = 0;
  for (long long j = threadIdx.x; j < tiles; j += pdp::kThreads) {
    const int v = __ldcg(counts + j);
    all += v;
    if (j < tile) pre += v;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    all += __shfl_xor_sync(pdp::kFullMask, all, d);
    pre += __shfl_xor_sync(pdp::kFullMask, pre, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smem[warp] = all;
    smem[kWarps + warp] = pre;
  }
  __syncthreads();
  all = pre = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    all += smem[w];
    pre += smem[kWarps + w];
  }
  *total = all;
  *before = pre;
  __syncthreads();  // smem is rewritten by the next lane's sums
}

// A group of (column, element) slots of the thread's kItems rows, loaded
// together and then stored. The compiler must take the columns to alias,
// so a store orders every later load: loading a group at once overlaps
// its latencies, where a load and a store a slot and row would chain 40
// round trips for P = 17,770's five columns. kGroup slots are 32
// registers of 4-byte words either way.
template <typename W>
struct Slots {
  static constexpr int kGroup = 16 / static_cast<int>(sizeof(W));
  W v[kGroup][pdp::kItems];
  int col[kGroup], elem[kGroup];
  int m;
};

// Loads the group that starts at slot (j, c) (element c of column j) for
// the rows of `tile` in lane row at_lane, and advances (j, c) past it.
template <typename W>
__device__ __forceinline__ void load_group(Slots<W>& s, const Columns& cols,
                                           int& j, int& c, long long at_lane,
                                           long long tile, long long n) {
  s.m = 0;
#pragma unroll
  for (int g = 0; g < Slots<W>::kGroup; ++g) {
    if (j < cols.n) {
      const int w = cols.width[j];
      const W* src = static_cast<const W*>(cols.in[j]) + at_lane * w + c;
#pragma unroll
      for (int k = 0; k < pdp::kItems; ++k) {
        const long long i = row_of(tile, k);
        if (i < n) s.v[g][k] = src[i * w];
      }
      s.col[g] = j;
      s.elem[g] = c;
      s.m = g + 1;
      if (++c == w) {
        c = 0;
        ++j;
      }
    }
  }
}

template <typename W>
__device__ __forceinline__ void store_group(const Slots<W>& s,
                                            const Columns& cols,
                                            long long at_lane,
                                            const long long* dst,
                                            long long tile, long long n) {
#pragma unroll
  for (int g = 0; g < Slots<W>::kGroup; ++g) {
    if (g < s.m) {
      const int w = cols.width[s.col[g]];
      W* out = static_cast<W*>(cols.out[s.col[g]]) + at_lane * w + s.elem[g];
#pragma unroll
      for (int k = 0; k < pdp::kItems; ++k) {
        if (row_of(tile, k) < n) out[dst[k] * w] = s.v[g][k];
      }
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(pdp::kThreads)
    compact_kernel(const uint8_t* __restrict__ keep, Range g, Columns cols,
                   long long* __restrict__ order,
                   long long* __restrict__ n_kept,
                   int* __restrict__ tile_counts) {
  __shared__ unsigned kept_bits[kRunTiles][pdp::kItems][kWarps];
  __shared__ int step_warp[pdp::kItems * kWarps];
  __shared__ int tile_kept;
  __shared__ long long smem[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long first = static_cast<long long>(blockIdx.x) * g.run;
  const long long last = first + g.run < g.items ? first + g.run : g.items;

  // Phase 1: the kept count of every tile of the run.
  for (long long it = first; it < last; ++it) {
    const long long l = it / g.tiles, t = it - l * g.tiles;
    int c = 0;
#pragma unroll
    for (int k = 0; k < pdp::kItems; ++k) {
      const unsigned b = ballot_of(keep + l * g.n, g.n, t, k);
      if (it - first < kRunTiles && lane == 0)
        kept_bits[it - first][k][warp] = b;
      c += __popc(b);
    }
    if (lane == 0) step_warp[warp] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += step_warp[w];
      tile_counts[it] = s;
    }
    __syncthreads();
  }

  // The first tile's first group of column values needs no count: its
  // loads are in flight across the barrier.
  Slots<W> slots;
  int next_col = 0, next_elem = 0;
  if (first < last) {
    const long long l = first / g.tiles;
    load_group(slots, cols, next_col, next_elem, l * g.n,
               first - l * g.tiles, g.n);
  }

  cg::this_grid().sync();

  // Phase 2: rank and scatter, tile by tile.
  long long lane_now = -1, kept_all = 0, before = 0;
  for (long long it = first; it < last; ++it) {
    const long long l = it / g.tiles, t = it - l * g.tiles;
    const long long at_lane = l * g.n;
    if (it != first) {
      next_col = next_elem = 0;
      load_group(slots, cols, next_col, next_elem, at_lane, t, g.n);
    }
    if (l != lane_now) {
      lane_sums(tile_counts + l * g.tiles, g.tiles, t, smem, &kept_all,
                &before);
      lane_now = l;
      if (t == 0 && threadIdx.x == 0) n_kept[l] = kept_all;
    }
    unsigned ballot[pdp::kItems];
#pragma unroll
    for (int k = 0; k < pdp::kItems; ++k) {
      ballot[k] = it - first < kRunTiles ? kept_bits[it - first][k][warp]
                                         : ballot_of(keep + at_lane, g.n, t,
                                                     k);
      if (lane == 0) step_warp[k * kWarps + warp] = __popc(ballot[k]);
    }
    __syncthreads();
    if (warp == 0) {
      // kItems * kWarps = 64 counts: two per lane, scanned by the warp.
      const int a = step_warp[2 * lane], b = step_warp[2 * lane + 1];
      int inc = a + b;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(pdp::kFullMask, inc, d);
        if (lane >= d) inc += v;
      }
      const int excl = inc - a - b;
      step_warp[2 * lane] = excl;
      step_warp[2 * lane + 1] = excl + a;
      if (lane == 31) tile_kept = inc;
    }
    __syncthreads();
    long long dst[pdp::kItems];
#pragma unroll
    for (int k = 0; k < pdp::kItems; ++k) {
      const long long i = row_of(t, k);
      const bool kept = (ballot[k] >> lane) & 1u;
      const long long kb = before + step_warp[k * kWarps + warp] +
                           __popc(ballot[k] & lanes_below);
      dst[k] = kept ? kb : kept_all + (i - kb);
      if (i < g.n) order[at_lane + dst[k]] = i;
    }
    store_group(slots, cols, at_lane, dst, t, g.n);
    while (next_col < cols.n) {
      load_group(slots, cols, next_col, next_elem, at_lane, t, g.n);
      store_group(slots, cols, at_lane, dst, t, g.n);
    }
    before += tile_kept;
    __syncthreads();  // step_warp and tile_kept are rewritten next tile
  }
}

// A refused launch (a grid the card cannot hold at once:
// cudaErrorCooperativeLaunchTooLarge) returns its error, cleared from the
// runtime's last error so that it does not surface in a later call.
template <typename W>
int launch(const void* keep, const Range& g, unsigned grid, Columns cols,
           void* order, void* n_kept, void* counts, cudaStream_t s) {
  void* args[] = {&keep, const_cast<Range*>(&g), &cols, &order, &n_kept,
                  &counts};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(compact_kernel<W>), dim3(grid),
      dim3(pdp::kThreads), args, 0, s);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// The plan's words (kernels._compact_plan): the layout of the call, then
// (width, byte offset of the output) for each column.
enum PlanWord {
  kN,          // partitions a lane
  kLanes,      // lanes
  kTiles,      // tiles a lane
  kRun,        // tiles a block
  kGrid,       // blocks
  kElemBytes,  // 4 or 8
  kCols,       // columns
  kOrderAt,    // byte offsets in the output allocation
  kNKeptAt,
  kCountsAt,
  kColumnWords  // first of the columns' (width, offset) pairs
};

}  // namespace

// Blocks of compact_kernel<W> one SM holds at once, for W of elem_bytes
// (4 or 8) on the current device; < 0: -cudaError.
extern "C" int compact_kept_blocks_per_sm(int elem_bytes) {
  int blocks = 0;
  const cudaError_t e =
      elem_bytes == 8
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, compact_kernel<uint64_t>, pdp::kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, compact_kernel<uint32_t>, pdp::kThreads, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// keep: u8[lanes, n]; plan: the PlanWord words; in_cols: the columns'
// device pointers ([lanes, n, width] row-major each); out: the output
// allocation, holding order int64[lanes, n] (lane-local ids), n_kept
// int64[lanes], the tile counts int32[lanes x tiles] and every output
// column at the plan's offsets. One cooperative launch a group of
// kMaxColumns columns (one for none).
extern "C" int compact_kept(const void* keep, const long long* plan,
                            const long long* in_cols, void* out,
                            void* stream) {
  const int n_cols = static_cast<int>(plan[kCols]);
  const int elem = static_cast<int>(plan[kElemBytes]);
  if (n_cols < 0 || (elem != 4 && elem != 8) || plan[kGrid] < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(out);
  const Range g{plan[kN], plan[kTiles], plan[kLanes] * plan[kTiles],
                plan[kRun]};
  const unsigned grid = static_cast<unsigned>(plan[kGrid]);
  int first = 0;
  do {
    Columns cols{};
    cols.n = n_cols - first < kMaxColumns ? n_cols - first : kMaxColumns;
    for (int c = 0; c < cols.n; ++c) {
      cols.in[c] = reinterpret_cast<const void*>(in_cols[first + c]);
      cols.width[c] = static_cast<int>(plan[kColumnWords + 2 * (first + c)]);
      cols.out[c] = base + plan[kColumnWords + 2 * (first + c) + 1];
    }
    const int status =
        elem == 8 ? launch<uint64_t>(keep, g, grid, cols, base + plan[kOrderAt],
                                     base + plan[kNKeptAt],
                                     base + plan[kCountsAt], s)
                  : launch<uint32_t>(keep, g, grid, cols, base + plan[kOrderAt],
                                     base + plan[kNKeptAt],
                                     base + plan[kCountsAt], s);
    if (status != 0) return status;
    first += cols.n;
  } while (first < n_cols);
  return 0;
}
