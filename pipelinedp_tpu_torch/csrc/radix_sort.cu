// C5 radix_sort: the stable permutation that sorts rows by up to four key
// words, most significant word first (an LSD radix sort).
//
// Replaces the K3 sorts of pipelinedp_tpu/executor.py: `_sort_rows` (:307,
// one lax.sort carrying payloads) at the bounding sort (:383), the
// total-bound sort (:370), the sort by kept partition (:482) and the
// selection sort (:1057).
//
// Key words are int32, int64, float32 or float64. Each is mapped to an
// unsigned integer with the same order (the sign bit of an integer
// flipped; a float's bits flipped whole when negative, its sign bit set
// otherwise), so the JAX package's signed keys and non-negative uniforms
// sort as they do under lax.sort. Only the bits that differ between rows
// are sorted. radix_sort_varying ORs every row's mapped word with row 0's
// and copies those masks to the host: one small copy and a stream
// synchronisation a sort. The wrapper owns the plan: it turns each mask
// into at most 4 runs of adjacent bits, packed next to each other into
// the sort key, and hands the kernel the whole plan (each run's place in
// the word and in the key, each word's passes) as the Plan struct below,
// which the kernel uses as it comes. So constant bits (a pid below 2^19,
// the 17 zero bits between pk < 2^15 and hash1 in k2, a uniform's
// exponent) cost no pass. A word of at most 32 varying bits is sorted as
// uint32. Padding rows carry pid = INT32_MAX, as in the JAX package, which
// makes all 31 pid bits vary where a dataset is padded.
//
// The megabatched service's lane-batched release (K24) sorts L jobs' rows
// by (lane, k1, k2, u): the lane is a fourth, most significant word,
// constant for one job and so skipped there.
//
// Bound on this card: bytes. The least work is each key word read once and
// the int64 permutation written once; an LSD sort of B packed bits needs
// ceil(B / 8) passes that each read and write the key and the 32-bit
// permutation, and the first pass of every word after the first gathers
// it through the permutation so far (a 32-byte sector a row).
//
// Design: Onesweep (Adinets and Merrill, "Onesweep: A Faster Least
// Significant Digit Radix Sort for GPUs", 2022), one launch a digit pass.
//   * digit_starts reads every word once, in row order, and counts the
//     digits of every pass of every word (a digit's global count does not
//     depend on the order the rows are in); the last block to finish turns
//     the counts into each digit's first output row. A warp adds a run of
//     equal digits in neighbouring lanes with one shared atomic, so sorted
//     or clustered keys do not serialise on one counter.
//   * sweep_pass, once a pass. A block takes its tile of 4096 rows from an
//     atomic counter, so it only ever looks back at tiles already running.
//     A warp owns 512 consecutive rows and loads them 32 at a time
//     (coalesced). Eight ballots, one per digit bit, give the lanes
//     holding a lane's digit, and the lowest of them adds the group to the
//     warp's count, so a row's rank never depends on a later row, each
//     pass is stable and the sort is the stable lexicographic sort. The
//     warps' counts give the tile's per-digit counts, published
//     ("aggregate") in one 64-bit status word per digit; thread d reads
//     the nearest 4 earlier tiles' words for digit d during the tile's own
//     scan, walks back to the first "inclusive" one, and publishes its own
//     inclusive prefix. The tile is staged in shared memory in output
//     order and written out, consecutive threads to consecutive rows of a
//     digit's run. The first pass of a word reads its packed key straight
//     from the word (through the permutation so far); the last pass of a
//     word writes no key, and the last pass of the sort writes the int64
//     permutation and, asked for, word 0 in sorted order (rebuilt from the
//     packed key and row 0's constant bits: no gather).
//   * The status words carry the pass number (an epoch), so one memset a
//     sort, made with the masks' reset before the host reads them, serves
//     every pass: a word of an earlier pass reads as not yet published.
//   * What bounds it now: a pass is latency-bound, not bandwidth-bound
//     (32- and 64-bit keys take about the same time, 0.2-0.26 ms at 2^24
//     rows against 0.08-0.12 ms of bytes), and the first pass of each
//     word after the first gathers 8 bytes a row through the permutation,
//     a random 32-byte sector, at about 3x a plain pass. 2048-row tiles,
//     512-thread blocks of 8192 rows, register caps that fit more blocks,
//     __match_any_sync in place of the ballots, counting the next pass's
//     digits inside each pass, and streaming cache hints measured slower
//     or no faster.
//   * Keys stay 8 bits a digit: the ballot ranking is 8 ballots a row and
//     a [8 warps x 256] count table; 11 bits would take 11 ballots and a
//     table 8 times larger for 13 passes instead of 17 on the bounding
//     keys.
//   * The host synchronisation stays: it lets the host skip every pass of
//     a constant digit or word and build the packing, and costs one small
//     copy and the device's wait for the host's next launches
//     (chip_smoke.py's three_way split of the bounding sort measures
//     both). A device-side plan would launch every possible pass (8 a
//     64-bit word) whatever the data.
// Loads are 4 or 8 bytes a thread: a 16-byte load of four neighbouring
// rows would need a shared-memory transpose before the ranking, whose
// order within a warp is the row order.
#include "common.cuh"


namespace {

// Shared with the wrapper, which plans the sort: pipelinedp_tpu_torch/
// cuda_build.py names them and passes them as -D macros.
#if !defined(PDP_SORT_MAX_WORDS) || !defined(PDP_SORT_MAX_RUNS) || \
    !defined(PDP_SORT_DIGIT_BITS) || !defined(PDP_SORT_TILE)
#error "build radix_sort.cu through pipelinedp_tpu_torch/cuda_build.py"
#endif
constexpr int kMaxWords = PDP_SORT_MAX_WORDS;
constexpr int kMaxRuns = PDP_SORT_MAX_RUNS;
constexpr int kDigitBits = PDP_SORT_DIGIT_BITS;
constexpr int kTile = PDP_SORT_TILE;      // rows a block ranks

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = kTile / kThreads;  // rows per lane and pass
static_assert(kItems * kThreads == kTile && kItems % 2 == 0, "tile");
constexpr int kWarpSpan = 32 * kItems;    // consecutive rows a warp owns
constexpr int kBuckets = 1 << kDigitBits;
static_assert(kBuckets == kThreads, "one thread per digit");
constexpr int kMaxPasses = kMaxWords * 64 / kDigitBits;

enum Kind { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

__host__ __device__ __forceinline__ bool is_wide(int kind) {
  return kind == kInt64 || kind == kFloat64;
}

// Maps element i of a key word to an unsigned integer of the same order.
__device__ __forceinline__ uint64_t ordered_bits(const void* word, int kind,
                                                 long long i) {
  if (kind == kInt32) {
    return static_cast<uint32_t>(static_cast<const int32_t*>(word)[i]) ^
           0x80000000u;
  }
  if (kind == kInt64) {
    return static_cast<uint64_t>(static_cast<const long long*>(word)[i]) ^
           (1ull << 63);
  }
  if (kind == kFloat32) {
    const uint32_t b = static_cast<const uint32_t*>(word)[i];
    return b ^ ((b >> 31) ? 0xFFFFFFFFu : 0x80000000u);
  }
  const uint64_t b = static_cast<const uint64_t*>(word)[i];
  return b ^ ((b >> 63) ? ~0ull : (1ull << 63));
}

// The word's bits of a mapped value (ordered_bits inverted).
__device__ __forceinline__ uint64_t unmapped_bits(uint64_t m, int kind) {
  if (kind == kInt32) return static_cast<uint32_t>(m) ^ 0x80000000u;
  if (kind == kInt64) return m ^ (1ull << 63);
  if (kind == kFloat32) {
    const uint32_t b = static_cast<uint32_t>(m);
    return (b >> 31) ? (b ^ 0x80000000u) : ~b;
  }
  return (m >> 63) ? (m ^ (1ull << 63)) : ~m;
}

struct Words {
  const void* ptr[kMaxWords];
  int kind[kMaxWords];
  int n;
};

Words make_words(const void* const* words, const int* kinds, int n_words) {
  Words w{};
  w.n = n_words;
  for (int k = 0; k < n_words; ++k) {
    w.ptr[k] = words[k];
    w.kind[k] = kinds[k];
  }
  return w;
}

__device__ __forceinline__ long long grid_start() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// masks[k] |= OR over rows of (word k of the row) ^ (word k of row 0).
__global__ void varying_bits(Words words, long long n,
                             unsigned long long* masks) {
  for (int k = 0; k < words.n; ++k) {
    const uint64_t first = ordered_bits(words.ptr[k], words.kind[k], 0);
    uint64_t acc = 0;
    for (long long i = grid_start(); i < n; i += grid_stride())
      acc |= ordered_bits(words.ptr[k], words.kind[k], i) ^ first;
    const uint32_t lo = __reduce_or_sync(pdp::kFullMask,
                                         static_cast<uint32_t>(acc));
    const uint32_t hi = __reduce_or_sync(pdp::kFullMask,
                                         static_cast<uint32_t>(acc >> 32));
    if ((threadIdx.x & 31) == 0 && (lo | hi))
      atomicOr(&masks[k], (static_cast<unsigned long long>(hi) << 32) | lo);
  }
}

// The sort's plan, made by the wrapper (kernels._sort_plan, a ctypes copy
// of these two structs) and used as it comes. A word's varying bits as at
// most kMaxRuns runs of adjacent bits, packed next to each other into the
// sort key.
struct Runs {
  int n;
  int bits;               // width of the packed key
  int lo[kMaxRuns];       // first bit of run j in the mapped word
  int at[kMaxRuns];       // first bit of run j in the packed key
  uint64_t mask[kMaxRuns];
  uint64_t varying;       // the mapped word's bits the runs cover
};

__device__ __forceinline__ uint64_t pack(const Runs& runs, uint64_t t) {
  uint64_t key = 0;
  for (int j = 0; j < runs.n; ++j)
    key |= ((t >> runs.lo[j]) & runs.mask[j]) << runs.at[j];
  return key;
}

__device__ __forceinline__ uint64_t unpack(const Runs& runs, uint64_t key) {
  uint64_t t = 0;
  for (int j = 0; j < runs.n; ++j)
    t |= ((key >> runs.at[j]) & runs.mask[j]) << runs.lo[j];
  return t;
}

// The varying words, least significant first, and their passes.
struct Plan {
  int n_words;
  int word[kMaxWords];       // index into Words
  int first_pass[kMaxWords]; // global number of the word's first pass
  int passes[kMaxWords];
  Runs runs[kMaxWords];
  int total_passes;
};

// Adds one to hist[digit] for every in-range lane; a run of equal digits
// in neighbouring lanes is added once, by its first lane.
__device__ __forceinline__ void count_digit(uint32_t* hist, int digit,
                                            bool in, int lane) {
  const int d = in ? digit : -1 - lane;
  const int prev = __shfl_up_sync(pdp::kFullMask, d, 1);
  const bool head = lane == 0 || d != prev;
  const unsigned heads = __ballot_sync(pdp::kFullMask, head);
  if (in && head) {
    const unsigned later = heads & ((~0u << lane) << 1);
    const int next = later ? __ffs(later) - 1 : 32;
    atomicAdd(&hist[digit], static_cast<uint32_t>(next - lane));
  }
}

// starts[pass][digit] = rows whose packed key has a smaller digit in that
// pass (the digit's first output row), for every pass of the plan: the
// blocks add their shared-memory counts into starts, and the last block to
// finish turns each pass's counts into exclusive prefixes in place.
__global__ void __launch_bounds__(kThreads)
    digit_starts(Words words, Plan plan, long long n,
                 uint32_t* __restrict__ starts, unsigned* done) {
  __shared__ uint32_t local[kMaxPasses * kBuckets];
  __shared__ uint32_t smem[32];
  __shared__ bool last;
  const int cells = plan.total_passes * kBuckets;
  for (int c = threadIdx.x; c < cells; c += kThreads) local[c] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp_first =
      static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x - lane);
  for (long long b = warp_first; b < n; b += grid_stride()) {
    const long long i = b + lane;
    const bool in = i < n;
    for (int w = 0; w < plan.n_words; ++w) {
      const int k = plan.word[w];
      const uint64_t key =
          in ? pack(plan.runs[w], ordered_bits(words.ptr[k], words.kind[k],
                                               i))
             : 0;
      for (int q = 0; q < plan.passes[w]; ++q)
        count_digit(local + (plan.first_pass[w] + q) * kBuckets,
                    static_cast<int>((key >> (q * kDigitBits)) &
                                     (kBuckets - 1)),
                    in, lane);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    if (local[c]) atomicAdd(&starts[c], local[c]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  for (int q = 0; q < plan.total_passes; ++q) {
    uint32_t* row = starts + q * kBuckets;
    uint32_t all;
    const uint32_t count = __ldcg(row + threadIdx.x);
    row[threadIdx.x] = pdp::block_exclusive_scan<pdp::SumOp<uint32_t>>(
        count, smem, &all);
  }
}

// A tile's status word for one digit: the pass's epoch (pass + 1) in bits
// 40-47, the flag in bits 32-33 (1 aggregate, 2 inclusive prefix), the
// count in bits 0-31. A word of an earlier pass or 0 is not published.
constexpr uint64_t kAggregate = 1ull << 32, kInclusive = 2ull << 32;

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

struct Pass {
  // Keys: the word itself through perm_in (the word's first pass), else
  // keys_in (packed keys in the current order).
  const void* word;
  int kind;
  Runs runs;
  const void* keys_in;
  const uint32_t* perm_in;  // null: the identity
  void* keys_out;           // null: the word's last pass
  uint32_t* perm_out;       // the sort's last pass: perm_out64 instead
  long long* perm_out64;
  // The sort's last pass with sorted_top: 1 rebuilds word 0 from this
  // word's keys (this word is word 0), 2 writes word 0's row 0 (word 0 is
  // constant).
  int top_mode;
  const void* top_word;
  int top_kind;
  void* top_out;
  long long n;
  int shift;
  int pass;
  const uint32_t* starts;  // this pass's first output row of each digit
  unsigned* counter;
  uint64_t* status;        // [tiles][256]
};

template <typename K>
__device__ __forceinline__ int digit_of(K key, int shift) {
  return static_cast<int>((key >> shift) & (kBuckets - 1));
}

// Bytes of dynamic shared memory sweep_pass<K> stages a tile in.
template <typename K>
constexpr int staging_bytes() {
  return kTile * static_cast<int>(sizeof(K) + sizeof(uint32_t));
}

// Earlier tiles the look-back reads at once, nearest first.
constexpr int kWindow = 4;

__device__ __forceinline__ void load_window(const uint64_t* status,
                                            long long j, int d,
                                            uint64_t (&s)[kWindow]) {
#pragma unroll
  for (int w = 0; w < kWindow; ++w)
    s[w] = j - w >= 0 ? load_status(status + (j - w) * kBuckets + d) : 0;
}

template <typename K>
__global__ void __launch_bounds__(kThreads) sweep_pass(Pass a) {
  extern __shared__ __align__(16) unsigned char staging[];
  K* tile_keys = reinterpret_cast<K*>(staging);
  uint32_t* tile_perm =
      reinterpret_cast<uint32_t*>(staging + kTile * sizeof(K));
  __shared__ uint32_t warp_rank[kWarps][kBuckets];
  __shared__ uint32_t out_base[kBuckets];     // output row of a run, less
                                              // its start in the tile
  __shared__ uint32_t local_start[kBuckets];  // run start inside the tile
  __shared__ uint32_t smem[32];
  __shared__ unsigned s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = threadIdx.x;  // the digit this thread counts
  if (threadIdx.x == 0) s_tile = atomicAdd(a.counter, 1u);
  for (int w = 0; w < kWarps; ++w) warp_rank[w][d] = 0;
  const uint32_t digit_start = a.starts[d];
  __syncthreads();
  const long long tile = s_tile;
  const long long tile_start = tile * kTile;
  const long long base =
      tile_start + static_cast<long long>(warp) * kWarpSpan + lane;
  const unsigned lanes_below = (1u << lane) - 1u;
  K key[kItems];
  uint32_t row[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + 32ll * k;
    row[k] = i < a.n ? (a.perm_in ? a.perm_in[i] : static_cast<uint32_t>(i))
                     : 0u;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + 32ll * k;
    if (i >= a.n) {
      key[k] = K(0);
    } else if (a.keys_in) {
      key[k] = static_cast<const K*>(a.keys_in)[i];
    } else {
      key[k] = static_cast<K>(pack(a.runs, ordered_bits(a.word, a.kind,
                                                        row[k])));
    }
  }
  // Ranks below 512 (a warp's rows), two to a register.
  uint32_t rank2[kItems / 2];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool in = base + 32ll * k < a.n;
    const int digit = digit_of(key[k], a.shift);
    // The lanes holding this lane's digit: one ballot per digit bit.
    unsigned peers = __ballot_sync(pdp::kFullMask, in);
#pragma unroll
    for (int b = 0; b < kDigitBits; ++b) {
      const bool bit = (digit >> b) & 1;
      const unsigned with_bit = __ballot_sync(pdp::kFullMask, bit);
      peers &= bit ? with_bit : ~with_bit;
    }
    const int leader = __ffs(peers) - 1;
    uint32_t before = 0;
    if (in && lane == leader) {
      before = warp_rank[warp][digit];
      warp_rank[warp][digit] = before + __popc(peers);
    }
    before = __shfl_sync(pdp::kFullMask, before, leader < 0 ? 0 : leader);
    const uint32_t r = before + __popc(peers & lanes_below);
    rank2[k / 2] = (k & 1) ? (rank2[k / 2] | (r << 16)) : r;
    __syncwarp();
  }
  __syncthreads();
  // Thread d: rows of digit d in the tile, and in its earlier warps.
  uint32_t tile_count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_rank[w][d];
    warp_rank[w][d] = tile_count;
    tile_count += c;
  }
  uint64_t* status = a.status + tile * kBuckets + d;
  const uint64_t epoch = static_cast<uint64_t>(a.pass + 1) << 40;
  store_status(status, epoch | (tile == 0 ? kInclusive : kAggregate) |
                           tile_count);
  uint64_t s[kWindow];
  load_window(a.status, tile - 1, d, s);
  uint32_t all;
  local_start[d] = pdp::block_exclusive_scan<pdp::SumOp<uint32_t>>(
      tile_count, smem, &all);
  // Look back over earlier tiles' counts of digit d to an inclusive one,
  // nearest first, kWindow tiles a round; a round stops at the first tile
  // not yet published, and the next reads again from there.
  uint32_t earlier = 0;
  long long j = tile - 1;
  bool done = tile == 0;
  while (!done) {
    bool stalled = false;
#pragma unroll
    for (int w = 0; w < kWindow; ++w) {
      if (done || stalled) continue;
      if ((s[w] >> 40) != (epoch >> 40)) {
        stalled = true;
        continue;
      }
      earlier += static_cast<uint32_t>(s[w]);
      --j;
      done = (s[w] & kInclusive) != 0;
    }
    if (!done) load_window(a.status, j, d, s);
  }
  if (tile > 0)
    store_status(status, epoch | kInclusive | (earlier + tile_count));
  out_base[d] = digit_start + earlier - local_start[d];
  __syncthreads();
  // Stage the tile in shared memory in output order ...
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + 32ll * k;
    if (i < a.n) {
      const int digit = digit_of(key[k], a.shift);
      const uint32_t at = local_start[digit] + warp_rank[warp][digit] +
                          ((rank2[k / 2] >> (16 * (k & 1))) & 0xFFFFu);
      tile_keys[at] = key[k];
      tile_perm[at] = row[k];
    }
  }
  __syncthreads();
  // ... and write it out: consecutive threads write consecutive rows of
  // a digit's run.
  const long long left = a.n - tile_start;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  K* keys_out = static_cast<K*>(a.keys_out);
  for (int jj = threadIdx.x; jj < tile_n; jj += kThreads) {
    const K k = tile_keys[jj];
    const uint32_t dst = out_base[digit_of(k, a.shift)] + jj;
    if (keys_out) keys_out[dst] = k;
    if (a.perm_out64) {
      a.perm_out64[dst] = tile_perm[jj];
    } else {
      a.perm_out[dst] = tile_perm[jj];
    }
    if (a.top_mode == 0) continue;
    const uint64_t row0 = ordered_bits(a.top_word, a.top_kind, 0);
    const uint64_t t =
        a.top_mode == 1
            ? unmapped_bits((row0 & ~a.runs.varying) |
                                unpack(a.runs, static_cast<uint64_t>(k)),
                            a.top_kind)
            : unmapped_bits(row0, a.top_kind);
    if (is_wide(a.top_kind)) {
      static_cast<uint64_t*>(a.top_out)[dst] = t;
    } else {
      static_cast<uint32_t*>(a.top_out)[dst] = static_cast<uint32_t>(t);
    }
  }
}

// No word varies: out[i] = i and sorted_top (when asked for) = word 0.
__global__ void identity_perm(long long n, long long* __restrict__ out,
                              const void* top, int top_kind,
                              void* sorted_top) {
  for (long long i = grid_start(); i < n; i += grid_stride()) {
    out[i] = i;
    if (sorted_top == nullptr) continue;
    if (is_wide(top_kind)) {
      static_cast<uint64_t*>(sorted_top)[i] =
          static_cast<const uint64_t*>(top)[i];
    } else {
      static_cast<uint32_t*>(sorted_top)[i] =
          static_cast<const uint32_t*>(top)[i];
    }
  }
}

unsigned grid_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 4096 ? (want > 0 ? want : 1) : 4096);
}

long long n_tiles(long long n) { return (n + kTile - 1) / kTile; }

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// Scratch: the part one memset resets (masks, digit starts, the finished
// histogram blocks' count, tile counters, status words), then the
// ping-pong keys and permutations.
struct Scratch {
  unsigned long long* masks;
  uint32_t* starts;
  unsigned* counters;  // [0]: finished digit_starts blocks; [1 + pass]: tiles
  uint64_t* status;
  void* keys[2];
  uint32_t* perm[2];
};

size_t reset_bytes(long long n) {
  return align_up(kMaxWords * 8) + align_up(kMaxPasses * kBuckets * 4) +
         align_up((1 + kMaxPasses) * 4) +
         align_up(static_cast<size_t>(n_tiles(n)) * kBuckets * 8);
}

Scratch carve(void* scratch, long long n) {
  char* p = static_cast<char*>(scratch);
  Scratch s;
  s.masks = reinterpret_cast<unsigned long long*>(p);
  p += align_up(kMaxWords * 8);
  s.starts = reinterpret_cast<uint32_t*>(p);
  p += align_up(kMaxPasses * kBuckets * 4);
  s.counters = reinterpret_cast<unsigned*>(p);
  p += align_up((1 + kMaxPasses) * 4);
  s.status = reinterpret_cast<uint64_t*>(p);
  p += align_up(static_cast<size_t>(n_tiles(n)) * kBuckets * 8);
  const size_t key_bytes = align_up(static_cast<size_t>(n) * 8);
  const size_t perm_bytes = align_up(static_cast<size_t>(n) * 4);
  s.keys[0] = p;
  s.keys[1] = p + key_bytes;
  p += 2 * key_bytes;
  s.perm[0] = reinterpret_cast<uint32_t*>(p);
  s.perm[1] = reinterpret_cast<uint32_t*>(p + perm_bytes);
  return s;
}

template <typename K>
void launch_pass(const Pass& p, long long tiles, cudaStream_t stream) {
  constexpr int kStaging = staging_bytes<K>();
  cudaFuncSetAttribute(sweep_pass<K>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kStaging);
  sweep_pass<K><<<static_cast<unsigned>(tiles), kThreads, kStaging,
                  stream>>>(p);
}

}  // namespace

// Scratch the caller allocates for n rows: the reset region (4 masks,
// 32 x 256 histogram counts, 32 tile counters, a 64-bit status word per
// digit and tile of 4096 rows: 0.5 B a row), two 8-byte key buffers and
// two 4-byte permutations: ~24.5 B a row.
extern "C" long long radix_sort_scratch_bytes(long long n) {
  return static_cast<long long>(reset_bytes(n) +
                                2 * align_up(static_cast<size_t>(n) * 8) +
                                2 * align_up(static_cast<size_t>(n) * 4));
}

// Resets the scratch's control region, ORs each word's rows against row
// 0 into its mask and copies the n_words masks to host_masks, waiting for
// the copy (the host plans the passes from them).
extern "C" int radix_sort_varying(const void* const* words, const int* kinds,
                                  int n_words, long long n, void* scratch,
                                  unsigned long long* host_masks,
                                  void* stream) {
  if (n_words < 1 || n_words > kMaxWords) return -1;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch s = carve(scratch, n);
  cudaMemsetAsync(scratch, 0, reset_bytes(n), st);
  varying_bits<<<grid_for(n), kThreads, 0, st>>>(
      make_words(words, kinds, n_words), n, s.masks);
  cudaMemcpyAsync(host_masks, s.masks, n_words * sizeof(unsigned long long),
                  cudaMemcpyDeviceToHost, st);
  const cudaError_t err = cudaStreamSynchronize(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// words[0] is the most significant key word; plan_in is the plan the
// host made from radix_sort_varying's masks (same scratch, not touched in
// between). Writes perm (int64[n]) and, when sorted_top is not null, word
// 0 in sorted order.
extern "C" int radix_sort(const void* const* words, const int* kinds,
                          int n_words, long long n, const void* plan_in,
                          void* scratch, void* perm, void* sorted_top,
                          void* stream) {
  if (n_words < 1 || n_words > kMaxWords) return -1;
  if (n <= 0) return 0;
  if (n >= (1ll << 31)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan plan = *static_cast<const Plan*>(plan_in);
  if (plan.total_passes == 0) {
    identity_perm<<<grid_for(n), kThreads, 0, st>>>(
        n, static_cast<long long*>(perm), words[0], kinds[0], sorted_top);
    return static_cast<int>(cudaGetLastError());
  }
  Scratch s = carve(scratch, n);
  const Words w = make_words(words, kinds, n_words);
  const long long tiles = n_tiles(n);
  digit_starts<<<static_cast<unsigned>(tiles < 1024 ? tiles : 1024),
                 kThreads, 0, st>>>(w, plan, n, s.starts, s.counters);
  const uint32_t* perm_cur = nullptr;
  int keys_at = 0;
  for (int v = 0; v < plan.n_words; ++v) {
    const int k = plan.word[v];
    const bool wide = plan.runs[v].bits > 32;
    for (int q = 0; q < plan.passes[v]; ++q) {
      const int pass = plan.first_pass[v] + q;
      const bool last_of_word = q + 1 == plan.passes[v];
      const bool last = pass + 1 == plan.total_passes;
      Pass p{};
      p.word = words[k];
      p.kind = kinds[k];
      p.runs = plan.runs[v];
      p.keys_in = q == 0 ? nullptr : s.keys[keys_at];
      p.perm_in = perm_cur;
      p.keys_out = last_of_word ? nullptr : s.keys[keys_at ^ (q == 0 ? 0 : 1)];
      uint32_t* perm_next = perm_cur == s.perm[0] ? s.perm[1] : s.perm[0];
      p.perm_out = last ? nullptr : perm_next;
      p.perm_out64 = last ? static_cast<long long*>(perm) : nullptr;
      if (last && sorted_top != nullptr) {
        p.top_mode = k == 0 ? 1 : 2;
        p.top_word = words[0];
        p.top_kind = kinds[0];
        p.top_out = sorted_top;
      }
      p.n = n;
      p.shift = q * kDigitBits;
      p.pass = pass;
      p.starts = s.starts + pass * kBuckets;
      p.counter = s.counters + 1 + pass;
      p.status = s.status;
      if (wide) {
        launch_pass<uint64_t>(p, tiles, st);
      } else {
        launch_pass<uint32_t>(p, tiles, st);
      }
      if (q > 0) keys_at ^= 1;
      perm_cur = perm_next;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
