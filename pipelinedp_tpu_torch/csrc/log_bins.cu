// C18 log_bins: the binning of the dataset histograms.
//
// Replaces the binning of K20, pipelinedp_tpu/dataset_histograms/
// device_histograms.py:
//   * log_bins_int: _bin_int_kernel (:66) with _log_bin_bounds (:45), the
//     3-leading-digit log histogram of an int32 stat over the rows its mask
//     selects: per bin lower, upper, count, sum and max, compacted to the
//     front in ascending lower, and the number of bins; one launch bins up
//     to PDP_LOG_BINS_MAX_STATS stats, as a histogram call bins its five
//     integer stats;
//   * log_bins_float: _bin_float_kernel (:108), the equal-width histogram of
//     n_buckets (10,000) buckets between the min and max of a float32 stat:
//     lo, hi and per bucket count, float32 sum and max.
//
// The JAX package sorts the rows once per integer histogram. Here no sort
// is needed: a value's bin follows from its bounds, computed in the same
// pure int32 arithmetic (power-of-ten table, the is_pow10 case, the
// decade-wide bin at an exact bound), and the bin's lower maps to a slot:
// lowers 1..1000 to slots 0..999, and above 1000 the lower m * 10^(e-2)
// (m in 100..999, e = floor(log10 lower)) to 1000 + (e - 3) * 900 + m - 101,
// ascending with the lower; 6,514 slots cover int32. Bin sums are exact
// int64 (the JAX package's device path sums float32 cumsum differences,
// exact while a bin's sum is below 2^24; its host path is exact).
//
// The float histogram's edges reproduce jnp.linspace(lo, hi, n + 1) in
// float32 as XLA compiles it for the CPU: step_i = 1 - i * c and
// edge_i = i * (hi * c) + lo * step_i, each with one rounding (fused
// multiply-adds, c = float32(1 / n)), the last edge hi. A row's bucket is
// jnp.searchsorted(edges, v, side="right") - 1, clipped, as the JAX
// package's default search runs it: ceil(log2(n + 2)) halvings of
// [0, n + 1) (Edges::search), which also places values where the edges
// decrease somewhere (lo == hi, or a range of a few ulps). Where the edges
// do not decrease (every block checks all of them) that bucket is the one
// b in [0, n) with (b == 0 or edge_b <= v) and (b == n - 1 or
// v < edge_b+1), so the kernel guesses b = (v - lo) * n / (hi - lo) in
// float32, steps at most once against the exact edges and, where the guess
// still fails the test, takes the search; the edges are computed where
// needed, not stored. Counts and maxes are
// exact; a bucket's sum is added in float64 and rounded once to float32:
// the float32 of the bucket's sum up to float64 rounding in another order,
// where the JAX package adds the float32 values one at a time (which
// drifts once a sum passes 2^24).
//
// Design. Both entries are one cooperative launch (cudaLaunchCooperative
// Kernel, cooperative_groups' grid sync), the grid what the card holds at
// once (log_bins_*_blocks_per_sm, asked once a device, which also raises
// the kernels' shared-memory limit once). Phase 0 zeroes the global
// accumulators (the float entry also takes each block's min and max); a
// grid barrier; each block bins its chunk of the rows (of every stat in
// turn, the integer entry, so that a dense stat's work spreads over the
// card) into shared memory and adds its non-empty slots into the global
// ones; a second grid barrier; then every block finishes its share of the
// slots: the integer entry compacts the non-empty slots of stat
// block % stats in slot order (the first block to fill a global slot
// counts it in its range's counter, so a block's place is the sum of the
// counters before its range), the float entry rounds the sums and writes
// the maxes. So a call is one device operation.
//   * Bytes in flight: a thread loads 16 mask bytes and the 16 matching
//     values (one uint4 of mask, four of values) a step and loads the next
//     step's before it bins this one: 2 x 80 B a thread, 81,920 B of
//     loads in flight an SM in both entries (integer: two blocks of 256
//     threads in 2 x 104,224 B of shared slots; float: one block of 512 in
//     16 x n_buckets = 160,000 B). A thread walks only the rows its mask
//     bytes select, and bins 16 selected rows of one value (Netflix's pair
//     lengths) at once. Unaligned stats load row by row.
//   * Few contended atomics: a lane keeps a run (the slot of its last
//     rows, their count, sum, max) and a cache of kIntCache / kFloatCache
//     more slots in registers; a row adds into the run, a new slot moves
//     the run into the cache, and only an entry evicted from the cache
//     (round robin; every lane's eviction on one code path) goes to shared
//     memory. At the block's end each warp combines its lanes' entries of
//     one slot (ballot, redux, butterfly) before one shared atomic a slot
//     and warp; a round that finds a slot on one lane alone ends the
//     combining and the rest go one by one. Netflix's pair sums (5
//     buckets) and pair lengths (1 slot) bin in registers.
//   * Shared 64-bit atomicAdd, integer and float64, compiles to a
//     compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN.64). The integer
//     sums are kept in shared memory as two 32-bit words (a native add on
//     the low word, its carry and the high word on the other); the float64
//     sums take the loop, on evictions and once a warp and slot at the end.
//
// Bound: bytes. Each row's value and mask are read once (the float entry
// twice: the min and max first); the outputs are a few hundred KB.
#include <cfloat>
#include <cstdint>
#include <cooperative_groups.h>

#include "common.cuh"

#ifndef PDP_LOG_BINS_MAX_STATS
#error "PDP_LOG_BINS_MAX_STATS comes from cuda_build.py"
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kSlots = 6514;
constexpr int kMaxStats = PDP_LOG_BINS_MAX_STATS;
constexpr int kRows = 16;  // rows a thread loads a step
constexpr int kIntThreads = 256;
constexpr int kFloatThreads = 512;
constexpr int kIntCache = 4;
constexpr int kFloatCache = 6;
constexpr unsigned kFull = pdp::kFullMask;
constexpr int kMaxSharedBytes = 232448;  // a block's most on sm_90

// An integer stat's output record (kernels.LOG_BINS_RECORD): counts,
// sums int64[kSlots], n_bins int64, lowers, uppers, maxes int32[kSlots].
constexpr long long kSumsAt = 8LL * kSlots;
constexpr long long kNBinsAt = 16LL * kSlots;
constexpr long long kLowersAt = kNBinsAt + 8;
constexpr long long kRecordBytes = kLowersAt + 12LL * kSlots;
static_assert(kRecordBytes % 16 == 0, "records stay 16-byte aligned");
// Its global accumulators: count u64, sum u64, max key u32 [kSlots], and
// the non-empty slots of each compacting block's range, u32
// [kMaxRanges], padded to 256 bytes.
constexpr int kMaxRanges = 1024;
constexpr long long kScratchBytes =
    (20LL * kSlots + 4LL * kMaxRanges + 255) / 256 * 256;

// A 4-byte word of a uint4 (k a constant after unrolling).
__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

// kRows rows from r: the mask bytes and the values' bits, zeros past end.
struct Group {
  uint4 m;
  uint4 v[4];
};

__device__ __forceinline__ void load_group(const uint32_t* __restrict__ values,
                                           const uint8_t* __restrict__ mask,
                                           long long r, long long end,
                                           bool vec, Group& g) {
  if (vec && r + kRows <= end) {
    g.m = __ldg(reinterpret_cast<const uint4*>(mask + r));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g.v[q] = __ldg(reinterpret_cast<const uint4*>(values + r) + q);
    return;
  }
  uint32_t mw[4] = {0u, 0u, 0u, 0u}, vw[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const bool in = r + j < end;
    mw[j >> 2] |= (in && mask[r + j] ? 1u : 0u) << (8 * (j & 3));
    vw[j] = in ? values[r + j] : 0u;
  }
  g.m = make_uint4(mw[0], mw[1], mw[2], mw[3]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    g.v[q] = make_uint4(vw[4 * q], vw[4 * q + 1], vw[4 * q + 2],
                        vw[4 * q + 3]);
}

// The rows of a group its mask selects, one bit a row (a mask byte that
// is not 0 selects).
__device__ __forceinline__ unsigned selected(const uint4& m) {
  const auto bits4 = [](uint32_t w) {
    // Bytes 0-3 as 0 / 1 at bits 0, 8, 16, 24, gathered to bits 21-24.
    return (((__vcmpne4(w, 0u) & 0x01010101u) * 0x00204081u) >> 21) & 0xFu;
  };
  return bits4(m.x) | bits4(m.y) << 4 | bits4(m.z) << 8 | bits4(m.w) << 12;
}

// Value j of a group (selects on registers, no local memory).
__device__ __forceinline__ uint32_t pick(const Group& g, int j) {
  const uint4 q = j < 8 ? (j < 4 ? g.v[0] : g.v[1])
                        : (j < 12 ? g.v[2] : g.v[3]);
  const int c = j & 3;
  return c < 2 ? (c == 0 ? q.x : q.y) : (c == 2 ? q.z : q.w);
}

// Whether a group's 16 rows are all selected and hold one value.
__device__ __forceinline__ bool uniform(const Group& g, unsigned sel) {
  const uint32_t v = g.v[0].x;
  bool same = sel == 0xFFFFu;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    same &= (g.v[q].x == v) & (g.v[q].y == v) & (g.v[q].z == v) &
            (g.v[q].w == v);
  return same;
}

// Rows [begin, end) of a block's chunk, kRows a thread a step, the next
// step's loads issued before this one is binned; row(value bits, count)
// for each selected row in row order, or once for a group whose 16 rows
// all hold one selected value.
template <typename RowFn>
__device__ __forceinline__ void for_each_row(const uint32_t* values,
                                             const uint8_t* mask,
                                             long long begin, long long end,
                                             RowFn row) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(values) |
        reinterpret_cast<uintptr_t>(mask)) & 15) == 0;
  const long long step = static_cast<long long>(kRows) * blockDim.x;
  long long r = begin + static_cast<long long>(kRows) * threadIdx.x;
  Group cur, nxt;
  if (r < end) load_group(values, mask, r, end, vec, cur);
  for (; r < end; r += step) {
    if (r + step < end) load_group(values, mask, r + step, end, vec, nxt);
    unsigned sel = selected(cur.m);
    if (uniform(cur, sel)) {
      row(cur.v[0].x, static_cast<unsigned>(kRows));
      sel = 0u;
    }
    for (; sel != 0u; sel &= sel - 1u) row(pick(cur, __ffs(sel) - 1), 1u);
    cur = nxt;
  }
}

// A block's chunk of n rows: multiples of kRows, in block order.
__device__ __forceinline__ void chunk_of(long long n, int block, int blocks,
                                         long long* begin, long long* end) {
  long long chunk = (n + blocks - 1) / blocks;
  chunk = (chunk + kRows - 1) / kRows * kRows;
  *begin = min(n, block * chunk);
  *end = min(n, *begin + chunk);
}


// The accumulators of one slot: count, sum, max key (an order-preserving
// unsigned image of the value; 0 is below every value).
template <typename Sum>
struct Acc {
  int slot;
  unsigned count;
  Sum sum;
  unsigned maxk;
};

// A block's integer slots in shared memory: the sums as two 32-bit words,
// so that an add is one native atomic on the low word (and, where it
// carries or the value is negative, one on the high word).
struct IntSink {
  unsigned* count;
  unsigned* lo;
  unsigned* hi;
  unsigned* maxk;
  __device__ __forceinline__ void add(const Acc<unsigned long long>& a) const {
    atomicAdd(&count[a.slot], a.count);
    const unsigned x = static_cast<unsigned>(a.sum);
    const unsigned old = atomicAdd(&lo[a.slot], x);
    const unsigned up = static_cast<unsigned>(a.sum >> 32) + (old + x < old);
    if (up != 0u) atomicAdd(&hi[a.slot], up);
    atomicMax(&maxk[a.slot], a.maxk);
  }
};

// A block's float buckets in shared memory.
struct FloatSink {
  unsigned* count;
  double* sum;
  unsigned* maxk;
  __device__ __forceinline__ void add(const Acc<double>& a) const {
    atomicAdd(&count[a.slot], a.count);
    atomicAdd(&sum[a.slot], a.sum);
    atomicMax(&maxk[a.slot], a.maxk);
  }
};

// A lane's run and its cache of K more slots, in registers.
template <typename Sum, int K, typename Sink>
struct LaneBins {
  Acc<Sum> run;
  Acc<Sum> e[K];
  int next;

  __device__ __forceinline__ void init() {
    run = Acc<Sum>{-1, 0u, Sum(0), 0u};
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = Acc<Sum>{-1, 0u, Sum(0), 0u};
    next = 0;
  }

  // The run moves into the cache: into its slot's entry, or in place of
  // the round robin's victim, which goes to the sink.
  __device__ __forceinline__ void retire_run(const Sink& sink) {
    if (run.slot < 0) return;
    bool hit = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool h = e[k].slot == run.slot;
      e[k].count += h ? run.count : 0u;
      e[k].sum += h ? run.sum : Sum(0);
      e[k].maxk = h ? max(e[k].maxk, run.maxk) : e[k].maxk;
      hit |= h;
    }
    if (hit) return;
    Acc<Sum> victim = run;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == next) {
        const Acc<Sum> t = e[k];
        e[k] = run;
        victim = t;
      }
    }
    next = next == K - 1 ? 0 : next + 1;
    if (victim.slot >= 0) sink.add(victim);
  }

  // count rows of one value: v is their sum, key the value's.
  __device__ __forceinline__ void add(int slot, Sum v, unsigned key,
                                      unsigned count, const Sink& sink) {
    if (slot != run.slot) {
      retire_run(sink);
      run = Acc<Sum>{slot, 0u, Sum(0), 0u};
    }
    run.count += count;
    run.sum += v;
    run.maxk = max(run.maxk, key);
  }

  // Every entry into the sink, each warp combining its lanes' entries of
  // one slot first. All lanes of the warp call it.
  __device__ __forceinline__ void flush(const Sink& sink) {
    retire_run(sink);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Acc<Sum> a = e[k];
      unsigned pending = __ballot_sync(kFull, a.slot >= 0);
      while (pending) {
        const int leader = __ffs(pending) - 1;
        const int slot = __shfl_sync(kFull, a.slot, leader);
        const bool in = a.slot == slot;
        const unsigned peers = __ballot_sync(kFull, in);
        if (__popc(peers) == 1) break;  // the rest go one by one
        Acc<Sum> t{slot, __reduce_add_sync(kFull, in ? a.count : 0u),
                   in ? a.sum : Sum(0),
                   __reduce_max_sync(kFull, in ? a.maxk : 0u)};
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          t.sum += __shfl_xor_sync(kFull, t.sum, d);
        if (lane == leader) sink.add(t);
        if (in) a.slot = -1;
        pending &= ~peers;
      }
      if (a.slot >= 0) sink.add(a);
    }
  }
};

// Block-wide sums of two counters (every thread gets them); red holds
// 2 x the block's warps.
__device__ __forceinline__ void block_sum2(long long* a, long long* b,
                                           long long* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    *a += __shfl_xor_sync(kFull, *a, d);
    *b += __shfl_xor_sync(kFull, *b, d);
  }
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = *a;
    red[2 * warp + 1] = *b;
  }
  __syncthreads();
  *a = *b = 0;
  for (int w = 0; w < warps; ++w) {
    *a += red[2 * w];
    *b += red[2 * w + 1];
  }
}

// ---------------------------------------------------------------------------
// Integer entry.

struct IntStats {
  const uint32_t* values[kMaxStats];
  const uint8_t* mask[kMaxStats];
  long long n[kMaxStats];
  int count;      // stats
  char* out;      // the stats' records, kRecordBytes each
  char* scratch;  // their accumulators, kScratchBytes each
};

struct IntShared {
  unsigned count[kSlots];
  unsigned lo[kSlots];
  unsigned hi[kSlots];
  unsigned maxk[kSlots];  // v ^ 0x80000000
};
constexpr size_t kIntSmem = sizeof(IntShared);

// (lower, upper) of the 3-leading-digit bin of v >= 1, as
// _log_bin_bounds computes them in int32 (the upper wraps as XLA's int32
// add does near 2^31); pow10 a table of 10^0..10^9 in shared memory.
__device__ __forceinline__ void bin_bounds(int32_t v, const int32_t* pow10,
                                           int32_t* lower, int32_t* upper) {
  int d = 0;
#pragma unroll
  for (int k = 0; k < 10; ++k) d += v >= pow10[k] ? 1 : 0;
  const bool is_pow10 = v == pow10[min(d - 1, 9)];
  int e = is_pow10 ? d - 1 : d;
  e = max(e, 3);
  const int32_t base = pow10[min(e - 3, 7)];
  const int32_t lo = v / base * base;
  const bool at_bound = e <= 9 && v == pow10[min(e, 9)];
  const int32_t size = at_bound ? base * 10 : base;
  *lower = lo;
  *upper = static_cast<int32_t>(static_cast<uint32_t>(lo) +
                                static_cast<uint32_t>(size));
}

__device__ __forceinline__ int slot_of(int32_t lower, const int32_t* pow10) {
  if (lower <= 1000) return lower - 1;
  int e = 3;
  while (e < 9 && lower >= pow10[e + 1]) ++e;
  const int32_t m = lower / pow10[e - 2];
  return 1000 + (e - 3) * 900 + m - 101;
}

__device__ __forceinline__ int32_t lower_of(int slot, const int32_t* pow10) {
  if (slot < 1000) return slot + 1;
  const int u = slot - 999;  // 1 ...
  const int e = 3 + u / 900;
  const int32_t m = u % 900 + 100;
  return m * pow10[e - 2];
}

// The slot of a value (values below 1 bin as 1); below 1001 the bin is
// the value itself.
__device__ __forceinline__ int value_slot(int32_t v, const int32_t* pow10) {
  const int32_t c = v > 1 ? v : 1;
  if (c <= 1000) return c - 1;
  int32_t lower, upper;
  bin_bounds(c, pow10, &lower, &upper);
  return slot_of(lower, pow10);
}

// The blocks that compact stat s of `stats` (blocks b with b % stats ==
// s), and the slots of each one's range.
__device__ __forceinline__ int compact_blocks(int s, int stats) {
  return (static_cast<int>(gridDim.x) - s + stats - 1) / stats;
}
__device__ __forceinline__ int compact_range(int blocks) {
  return (kSlots + blocks - 1) / blocks;
}

// A stat's accumulators in the scratch.
struct IntGlobal {
  unsigned long long* count;
  unsigned long long* sum;
  unsigned* maxk;
  unsigned* ranges;  // non-empty slots of each compacting block's range
  __device__ __forceinline__ explicit IntGlobal(char* scratch)
      : count(reinterpret_cast<unsigned long long*>(scratch)),
        sum(count + kSlots),
        maxk(reinterpret_cast<unsigned*>(sum + kSlots)),
        ranges(maxk + kSlots) {}
};

// Block `block` of a stat's `blocks`: the non-empty slots of its range of
// slots at their place in slot order (the ranges' counts before it give
// the place), and zeros at the places of its range past the bin count;
// block 0 writes the bin count.
__device__ void compact_int(const IntGlobal& g, char* record, int block,
                            int blocks, const int32_t* pow10,
                            long long* red) {
  long long* counts = reinterpret_cast<long long*>(record);
  long long* sums = reinterpret_cast<long long*>(record + kSumsAt);
  long long* n_bins = reinterpret_cast<long long*>(record + kNBinsAt);
  int32_t* lowers = reinterpret_cast<int32_t*>(record + kLowersAt);
  int32_t* uppers = lowers + kSlots;
  int32_t* maxes = uppers + kSlots;
  const int range = compact_range(blocks);
  const int first = min(kSlots, block * range);
  const int last = min(kSlots, first + range);
  long long before = 0, total = 0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    const long long full = __ldcg(&g.ranges[b]);
    total += full;
    before += b < block ? full : 0;
  }
  block_sum2(&before, &total, red);
  long long o = before;
  for (int base = first; base < last; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const unsigned long long c = i < last ? __ldcg(&g.count[i]) : 0ull;
    long long chunk;
    const long long at = o + pdp::block_exclusive_scan<pdp::SumOp<long long>>(
                                 c != 0ull ? 1 : 0, red, &chunk);
    if (c != 0ull) {
      int32_t lower, upper;
      bin_bounds(lower_of(i, pow10), pow10, &lower, &upper);
      lowers[at] = lower;
      uppers[at] = upper;
      counts[at] = static_cast<long long>(c);
      sums[at] = static_cast<long long>(__ldcg(&g.sum[i]));
      maxes[at] = static_cast<int32_t>(__ldcg(&g.maxk[i]) ^ 0x80000000u);
    }
    o += chunk;
  }
  for (long long j = max(total, static_cast<long long>(first)) + threadIdx.x;
       j < last; j += blockDim.x) {
    lowers[j] = 0;
    uppers[j] = 0;
    counts[j] = 0;
    sums[j] = 0;
    maxes[j] = 0;
  }
  if (block == 0 && threadIdx.x == 0) *n_bins = total;
}

// The block's non-empty shared slots into the stat's accumulators (the
// first block to fill a slot counts it in its compacting range), and back
// to zero.
__device__ __forceinline__ void flush_slots(IntShared* sh, const IntGlobal& g,
                                            int range) {
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    const unsigned c = sh->count[i];
    if (c == 0u) continue;
    if (atomicAdd(&g.count[i], static_cast<unsigned long long>(c)) == 0ull)
      atomicAdd(&g.ranges[i / range], 1u);
    atomicAdd(&g.sum[i],
              static_cast<unsigned long long>(sh->hi[i]) << 32 | sh->lo[i]);
    atomicMax(&g.maxk[i], sh->maxk[i]);
    sh->count[i] = sh->lo[i] = sh->hi[i] = sh->maxk[i] = 0u;
  }
  __syncthreads();
}

// Every block bins its chunk of every stat (so a dense stat's work is
// spread over the whole card), then block b compacts a share of stat
// b % stats.
__global__ void __launch_bounds__(kIntThreads, 2)
    int_kernel(const __grid_constant__ IntStats a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  IntShared* sh = reinterpret_cast<IntShared*>(smem_raw);
  __shared__ int32_t pow10[10];
  __shared__ long long red[32];  // block_sum2's, block_exclusive_scan's

  // Phase 0: the accumulators and the shared slots to zero.
  {
    uint4* g = reinterpret_cast<uint4*>(a.scratch);
    const long long words = a.count * kScratchBytes / 16;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < words; i += static_cast<long long>(gridDim.x) * blockDim.x)
      g[i] = make_uint4(0u, 0u, 0u, 0u);
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = threadIdx.x; i < static_cast<int>(kIntSmem / 16);
         i += blockDim.x)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < 10) {
      int32_t p = 1;
      for (int k = 0; k < static_cast<int>(threadIdx.x); ++k) p *= 10;
      pow10[threadIdx.x] = p;
    }
  }
  cg::this_grid().sync();

  const IntSink sink{sh->count, sh->lo, sh->hi, sh->maxk};
  for (int s = 0; s < a.count; ++s) {
    long long begin, end;
    chunk_of(a.n[s], blockIdx.x, gridDim.x, &begin, &end);
    LaneBins<unsigned long long, kIntCache, IntSink> bins;
    bins.init();
    for_each_row(a.values[s], a.mask[s], begin, end,
                 [&](uint32_t bits, unsigned count) {
      const int32_t v = static_cast<int32_t>(bits);
      bins.add(value_slot(v, pow10),
               static_cast<unsigned long long>(static_cast<long long>(v)) *
                   count,
               bits ^ 0x80000000u, count, sink);
    });
    bins.flush(sink);
    flush_slots(sh, IntGlobal(a.scratch + s * kScratchBytes),
                compact_range(compact_blocks(s, a.count)));
  }
  cg::this_grid().sync();
  const int s = blockIdx.x % a.count;
  compact_int(IntGlobal(a.scratch + s * kScratchBytes),
              a.out + s * kRecordBytes, blockIdx.x / a.count,
              compact_blocks(s, a.count), pow10, red);
}

// ---------------------------------------------------------------------------
// Float entry.

struct FloatArgs {
  const uint32_t* values;
  const uint8_t* mask;
  long long n;
  int n_buckets;
  float c;
  float* lo_hi;
  float* edges;
  int32_t* counts;
  float* sums;
  unsigned* maxk;  // the maxes' words: keys until the last phase
  double* sums64;
  float* partials;  // [gridDim.x, 2]
};

// An order-preserving unsigned image of a float and back.
__device__ __forceinline__ unsigned float_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// edges[i] for i < n as XLA's CPU code computes jnp.linspace in float32
// (see the header; hc = hi * c); edges[n] = hi.
__device__ __forceinline__ float edge(int i, int n, float lo, float hi,
                                      float hc, float c) {
  if (i == n) return hi;
  const float fi = static_cast<float>(i);
  const float step = __fmaf_rn(-fi, c, 1.0f);
  return __fmaf_rn(fi, hc, __fmul_rn(lo, step));
}

struct Edges {
  int n;
  float lo, hi, hc, c;
  float scale;  // n / (hi - lo): 0 where the range overflows
  int levels;   // ceil(log2(n + 2)): the search's halvings
  bool monotone;

  __device__ __forceinline__ float at(int i) const {
    return edge(i, n, lo, hi, hc, c);
  }
  // jnp.searchsorted(edges, v, side="right") - 1, clipped to [0, n), as
  // its scan runs: `levels` halvings of [low, high) = [0, n + 1), high to
  // mid where v sorts below edges[mid] (a NaN edge above every value that
  // is not NaN), else low to mid; the result is high. On edges that do
  // not decrease this is the upper bound.
  __device__ __forceinline__ int search(float v) const {
    int low = 0, high = n + 1;
    for (int k = 0; k < levels; ++k) {
      const int mid = (low + high) >> 1;
      const float e = at(mid);
      const bool left = v < e || (isnan(e) && !isnan(v));
      low = left ? low : mid;
      high = left ? mid : high;
    }
    return min(max(high - 1, 0), n - 1);
  }
  __device__ __forceinline__ int bucket(float v) const {
    if (!monotone) return search(v);
    const float g = (v - lo) * scale;
    int b = g >= 0.0f ? (g < static_cast<float>(n - 1) ? static_cast<int>(g)
                                                       : n - 1)
                      : 0;
    float e0 = at(b), e1 = at(b + 1);
    if (e0 > v) {
      if (b > 0) {
        --b;
        e1 = e0;
        e0 = at(b);
      }
    } else if (!(e1 > v) && b < n - 1) {
      ++b;
      e0 = e1;
      e1 = at(b + 1);
    }
    const bool ok = (b == 0 || !(e0 > v)) && (b == n - 1 || e1 > v);
    return ok ? b : search(v);
  }
};

__device__ __forceinline__ void block_min_max(float* lo, float* hi,
                                              float* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    *lo = fminf(*lo, __shfl_xor_sync(kFull, *lo, d));
    *hi = fmaxf(*hi, __shfl_xor_sync(kFull, *hi, d));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) {
    red[2 * warp] = *lo;
    red[2 * warp + 1] = *hi;
  }
  __syncthreads();
  *lo = FLT_MAX;
  *hi = -FLT_MAX;
  for (int w = 0; w < warps; ++w) {
    *lo = fminf(*lo, red[2 * w]);
    *hi = fmaxf(*hi, red[2 * w + 1]);
  }
}

__global__ void __launch_bounds__(kFloatThreads, 1)
    float_kernel(const __grid_constant__ FloatArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = a.n_buckets;
  double* s_sum = reinterpret_cast<double*>(smem_raw);
  unsigned* s_count = reinterpret_cast<unsigned*>(s_sum + nb);
  unsigned* s_maxk = s_count + nb;
  __shared__ float red[2 * (kFloatThreads / 32)];
  const long long gthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gt =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long begin, end;
  chunk_of(a.n, blockIdx.x, gridDim.x, &begin, &end);

  // Phase 0: the accumulators to zero; this block's min and max.
  for (long long i = gt; i < nb; i += gthreads) {
    a.counts[i] = 0;
    a.maxk[i] = 0u;
    a.sums64[i] = 0.0;
  }
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    s_sum[i] = 0.0;
    s_count[i] = 0u;
    s_maxk[i] = 0u;
  }
  float lo = FLT_MAX, hi = -FLT_MAX;
  for_each_row(a.values, a.mask, begin, end, [&](uint32_t bits, unsigned) {
    const float v = __uint_as_float(bits);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  });
  block_min_max(&lo, &hi, red);
  if (threadIdx.x == 0) {
    a.partials[2 * blockIdx.x] = lo;
    a.partials[2 * blockIdx.x + 1] = hi;
  }
  cg::this_grid().sync();

  // Phase 1: lo and hi (every block folds the partials in the same
  // order), the edges' monotonicity, then the rows.
  lo = FLT_MAX;
  hi = -FLT_MAX;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
    lo = fminf(lo, __ldcg(&a.partials[2 * b]));
    hi = fmaxf(hi, __ldcg(&a.partials[2 * b + 1]));
  }
  block_min_max(&lo, &hi, red);
  const float range = hi - lo;
  int levels = 0;
  while ((1LL << levels) < nb + 2LL) ++levels;
  Edges E{nb, lo, hi, __fmul_rn(hi, a.c), a.c,
          range < FLT_MAX ? static_cast<float>(nb) / range : 0.0f, levels,
          true};
  bool down = false;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const float e = E.at(i);
    down |= !(e <= E.at(i + 1));
    if (blockIdx.x == 0) a.edges[i] = e;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.edges[nb] = hi;
    a.lo_hi[0] = lo;
    a.lo_hi[1] = hi;
  }
  E.monotone = !__syncthreads_or(down);

  const FloatSink sink{s_count, s_sum, s_maxk};
  LaneBins<double, kFloatCache, FloatSink> bins;
  bins.init();
  for_each_row(a.values, a.mask, begin, end,
               [&](uint32_t bits, unsigned count) {
    const float v = __uint_as_float(bits);
    // count x v is exact in float64 (count <= 16).
    bins.add(E.bucket(v), static_cast<double>(v) * count, float_key(v),
             count, sink);
  });
  bins.flush(sink);
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const unsigned c = s_count[i];
    if (c == 0u) continue;
    atomicAdd(&a.counts[i], static_cast<int32_t>(c));
    atomicAdd(&a.sums64[i], s_sum[i]);
    atomicMax(&a.maxk[i], s_maxk[i]);
  }
  cg::this_grid().sync();
  // Phase 2: sums rounded once to float32; maxes from their keys,
  // -FLT_MAX where a bucket is empty (and below it, as the plain
  // version's initial value holds).
  float* maxes = reinterpret_cast<float*>(a.maxk);
  for (long long i = gt; i < nb; i += gthreads) {
    a.sums[i] = static_cast<float>(__ldcg(&a.sums64[i]));
    maxes[i] = fmaxf(key_float(__ldcg(&a.maxk[i])), -FLT_MAX);
  }
}

size_t float_smem(int n_buckets) {
  return static_cast<size_t>(n_buckets) * (8 + 4 + 4);
}

// A refused launch (a grid the card cannot hold at once) returns its
// error, cleared from the runtime's last error.
int launch_cooperative(const void* kernel, dim3 grid, int threads,
                       void* args, size_t smem, cudaStream_t s) {
  void* params[] = {args};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, grid,
                                                    dim3(threads), params,
                                                    smem, s);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// Raises the kernel's dynamic shared-memory limit to what a block may
// hold beside its static shared memory, then asks the occupancy.
int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSharedBytes - static_cast<int>(attr.sharedSizeBytes));
  if (e != cudaSuccess) return -static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

}  // namespace

// The integer entry's layout: an output record's bytes, a stat's
// accumulators' bytes.
extern "C" long long log_bins_int_record_bytes() { return kRecordBytes; }
extern "C" long long log_bins_int_scratch_bytes() { return kScratchBytes; }

// Blocks of each kernel one SM holds on the current device (< 0:
// -cudaError); raises the kernels' shared-memory limit first, so the host
// asks once a device before the first launch.
extern "C" int log_bins_int_blocks_per_sm() {
  return blocks_per_sm(reinterpret_cast<const void*>(int_kernel),
                       kIntThreads, kIntSmem);
}
extern "C" int log_bins_float_blocks_per_sm(int n_buckets) {
  if (n_buckets < 1 || float_smem(n_buckets) > kMaxSharedBytes) return -1;
  return blocks_per_sm(reinterpret_cast<const void*>(float_kernel),
                       kFloatThreads, float_smem(n_buckets));
}

// table: for each of the n_stats stats the values' (int32[n]) and the
// mask's (u8[n]) device pointers, then the n_stats row counts, as int64
// words. out: n_stats records of log_bins_int_record_bytes() each, then
// n_stats accumulators of log_bins_int_scratch_bytes() each. grid blocks
// (within what the card holds at once).
extern "C" int log_bins_int(const long long* table, int n_stats, int grid,
                            void* out, void* stream) {
  if (n_stats < 1 || n_stats > kMaxStats || grid < n_stats ||
      (grid + n_stats - 1) / n_stats > kMaxRanges)
    return -1;
  IntStats a{};
  for (int s = 0; s < n_stats; ++s) {
    a.values[s] = reinterpret_cast<const uint32_t*>(table[2 * s]);
    a.mask[s] = reinterpret_cast<const uint8_t*>(table[2 * s + 1]);
    a.n[s] = table[2 * n_stats + s];
    if (a.n[s] < 0) return -1;
  }
  a.count = n_stats;
  a.out = static_cast<char*>(out);
  a.scratch = a.out + n_stats * kRecordBytes;
  return launch_cooperative(reinterpret_cast<const void*>(int_kernel),
                            dim3(grid), kIntThreads, &a,
                            kIntSmem, static_cast<cudaStream_t>(stream));
}

// values: float32[n]; mask: u8[n]; c: float32(1 / n_buckets); grid
// blocks (within what the card holds at once). Outputs: lo_hi float32[2];
// edges float32[n_buckets + 1]; counts int32, sums and maxes float32
// [n_buckets]; scratch: float64[n_buckets], then float32[2 * grid].
extern "C" int log_bins_float(const void* values, const void* mask,
                              long long n, int n_buckets, float c, int grid,
                              void* scratch, void* lo_hi, void* edges,
                              void* counts, void* sums, void* maxes,
                              void* stream) {
  if (n_buckets < 1 || n < 0 || grid < 1 ||
      float_smem(n_buckets) > kMaxSharedBytes)
    return -1;
  double* sums64 = static_cast<double*>(scratch);
  FloatArgs a{static_cast<const uint32_t*>(values),
              static_cast<const uint8_t*>(mask),
              n,
              n_buckets,
              c,
              static_cast<float*>(lo_hi),
              static_cast<float*>(edges),
              static_cast<int32_t*>(counts),
              static_cast<float*>(sums),
              static_cast<unsigned*>(maxes),
              sums64,
              reinterpret_cast<float*>(sums64 + n_buckets)};
  return launch_cooperative(reinterpret_cast<const void*>(float_kernel),
                            dim3(grid), kFloatThreads, &a,
                            float_smem(n_buckets),
                            static_cast<cudaStream_t>(stream));
}
