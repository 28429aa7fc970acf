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
// are sorted: one pass first ORs every row's mapped word with row 0's and
// the host reads those masks back (one small copy per sort); the varying
// bits, packed together without the constant runs between them, are the
// sort key. So constant bits (a pid below 2^19, the 17 zero bits between
// pk < 2^15 and hash1 in k2, a uniform's exponent) cost no pass. A word
// of at most 32 varying bits is sorted as uint32. Padding rows carry
// pid = INT32_MAX, as in the JAX package, which makes all 31 pid bits
// vary where a dataset is padded: one more pass for k1 and for the
// total-bound pid than the 19 bits of 480,189 users need.
//
// The megabatched service's lane-batched release (K24) sorts L jobs' rows
// by (lane, k1, k2, u): the lane is a fourth, most significant word,
// constant for one job and so skipped there.
//
// Words are sorted from the least significant up; each word's varying
// bits are gathered through the permutation so far into a key buffer,
// then sorted 8 bits a pass. A pass is three launches:
//   1. digit_counts   per-tile histograms of the digit (shared-memory
//                     integer atomics, order-free), stored digit-major;
//   2. scan_digits    one block per digit scans its counts over the tiles;
//   3. scatter_keys   each tile ranks its rows stably (a warp owns 512
//                     consecutive rows and walks them 32 at a time: eight
//                     ballots, one per digit bit, give the lanes of one
//                     digit, the lowest of them adds the group to the
//                     warp's count),
//                     stages key and permutation in shared memory in
//                     output order, and writes each digit's run to
//                     digit start + earlier tiles, so consecutive threads
//                     store to consecutive addresses.
// The rank of a row never depends on a later row, so each pass is stable
// and the whole sort is the stable lexicographic sort.
//
// Bound: bytes. The least work is each key word read once and the int64
// permutation written once. Each pass reads the key twice and the
// permutation once (uint32 inside) and writes both, and each word after
// the first is gathered through the permutation; at 2^24 rows and 17
// passes that is ~25x the bound. Fewer passes (wider digits, one
// decoupled-lookback pass per digit) are the way to close the gap.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // rows per lane and pass
constexpr int kWarpSpan = 32 * kItems;    // consecutive rows a warp owns
constexpr int kTile = kThreads * kItems;  // rows a block ranks
constexpr int kDigitBits = 8;
constexpr int kBuckets = 1 << kDigitBits;
static_assert(kBuckets == kThreads, "one thread per digit");
constexpr int kMaxWords = 4;

enum Kind { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

struct Words {
  const void* ptr[kMaxWords];
  int kind[kMaxWords];
  int n;
};

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

__host__ __device__ __forceinline__ bool is_wide(int kind) {
  return kind == kInt64 || kind == kFloat64;
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

// The varying bits of a word as at most kMaxRuns runs of adjacent bits,
// packed next to each other into the sort key: the constant bits between
// runs are dropped, which keeps the order (they are equal in every row).
constexpr int kMaxRuns = 4;
struct Runs {
  int n;
  int bits;               // width of the packed key
  int lo[kMaxRuns];       // first bit of run j in the mapped word
  int at[kMaxRuns];       // first bit of run j in the packed key
  uint64_t mask[kMaxRuns];
};

// out[i] = the packed varying bits of the word at row perm[i] (row i
// without perm).
template <typename K>
__global__ void extract_keys(const void* word, int kind,
                             const uint32_t* __restrict__ perm, long long n,
                             Runs runs, K* __restrict__ out) {
  for (long long i = grid_start(); i < n; i += grid_stride()) {
    const long long r = perm ? perm[i] : i;
    const uint64_t t = ordered_bits(word, kind, r);
    uint64_t key = 0;
    for (int j = 0; j < runs.n; ++j)
      key |= ((t >> runs.lo[j]) & runs.mask[j]) << runs.at[j];
    out[i] = static_cast<K>(key);
  }
}

template <typename K>
__device__ __forceinline__ int digit_of(K key, int shift) {
  return static_cast<int>((key >> shift) & (kBuckets - 1));
}

// counts[digit * n_tiles + tile] = rows of the tile with that digit.
template <typename K>
__global__ void digit_counts(const K* __restrict__ keys, long long n,
                             int shift, long long n_tiles,
                             uint32_t* __restrict__ counts) {
  __shared__ uint32_t hist[kBuckets];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads +
                        threadIdx.x;
    if (i < n) atomicAdd(&hist[digit_of(keys[i], shift)], 1u);
  }
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * n_tiles + blockIdx.x] =
      hist[threadIdx.x];
}

// Block d: exclusive prefix of digit d's counts over the tiles, in place;
// totals[d] = rows with digit d.
__global__ void scan_digits(uint32_t* counts, long long n_tiles,
                            uint32_t* totals) {
  __shared__ uint32_t smem[32];
  pdp::block_scan_in_place<pdp::SumOp<uint32_t>>(
      counts + static_cast<long long>(blockIdx.x) * n_tiles, n_tiles, smem,
      totals + blockIdx.x);
}

// Bytes of dynamic shared memory scatter_keys<K> stages a tile in.
template <typename K>
constexpr int staging_bytes() {
  return kTile * static_cast<int>(sizeof(K) + sizeof(uint32_t));
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    scatter_keys(const K* __restrict__ keys_in,
                 const uint32_t* __restrict__ perm_in, long long n,
                 int shift, long long n_tiles,
                 const uint32_t* __restrict__ counts,
                 const uint32_t* __restrict__ totals,
                 K* __restrict__ keys_out, uint32_t* __restrict__ perm_out) {
  extern __shared__ __align__(16) unsigned char staging[];
  K* tile_keys = reinterpret_cast<K*>(staging);
  uint32_t* tile_perm =
      reinterpret_cast<uint32_t*>(staging + kTile * sizeof(K));
  __shared__ uint32_t warp_rank[kWarps][kBuckets];
  __shared__ uint32_t tile_base[kBuckets];    // output start of the run
  __shared__ uint32_t local_start[kBuckets];  // run start inside the tile
  __shared__ uint32_t smem[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile_start = static_cast<long long>(blockIdx.x) * kTile;
  {
    // Thread d: where this tile's rows of digit d start in the output.
    uint32_t all;
    const uint32_t digit_start =
        pdp::block_exclusive_scan<pdp::SumOp<uint32_t>>(
            totals[threadIdx.x], smem, &all);
    tile_base[threadIdx.x] =
        digit_start +
        counts[static_cast<long long>(threadIdx.x) * n_tiles + blockIdx.x];
  }
  for (int w = 0; w < kWarps; ++w) warp_rank[w][threadIdx.x] = 0;
  __syncthreads();

  const long long base =
      tile_start + static_cast<long long>(warp) * kWarpSpan + lane;
  const unsigned lanes_below = (1u << lane) - 1u;
  K key[kItems];
  uint32_t rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + 32ll * k;
    const bool in = i < n;
    key[k] = in ? keys_in[i] : K(0);
    const int digit = digit_of(key[k], shift);
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
    before = __shfl_sync(pdp::kFullMask, before, leader);
    rank[k] = before + __popc(peers & lanes_below);
    __syncwarp();
  }
  __syncthreads();
  uint32_t tile_count = 0;
  // Thread d: rows of digit d in the earlier warps of the tile.
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_rank[w][threadIdx.x];
    warp_rank[w][threadIdx.x] = tile_count;
    tile_count += c;
  }
  {
    uint32_t all;
    local_start[threadIdx.x] =
        pdp::block_exclusive_scan<pdp::SumOp<uint32_t>>(tile_count, smem,
                                                        &all);
  }
  __syncthreads();
  // Stage the tile in shared memory in output order ...
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + 32ll * k;
    if (i < n) {
      const int digit = digit_of(key[k], shift);
      const uint32_t at =
          local_start[digit] + warp_rank[warp][digit] + rank[k];
      tile_keys[at] = key[k];
      tile_perm[at] = perm_in ? perm_in[i] : static_cast<uint32_t>(i);
    }
  }
  __syncthreads();
  // ... and write it out: consecutive threads write consecutive rows of
  // a digit's run.
  const long long left = n - tile_start;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  for (int j = threadIdx.x; j < tile_n; j += kThreads) {
    const K k = tile_keys[j];
    const int digit = digit_of(k, shift);
    const uint32_t dst = tile_base[digit] + (j - local_start[digit]);
    keys_out[dst] = k;
    perm_out[dst] = tile_perm[j];
  }
}

// out[i] = perm[i] as int64 (i without perm); sorted_top[i] = word 0 of
// row perm[i] when asked for.
__global__ void write_perm(const uint32_t* __restrict__ perm, long long n,
                           long long* __restrict__ out, const void* top,
                           int top_kind, void* sorted_top) {
  for (long long i = grid_start(); i < n; i += grid_stride()) {
    const long long r = perm ? perm[i] : i;
    out[i] = r;
    if (sorted_top == nullptr) continue;
    if (is_wide(top_kind)) {
      static_cast<uint64_t*>(sorted_top)[i] =
          static_cast<const uint64_t*>(top)[r];
    } else {
      static_cast<uint32_t*>(sorted_top)[i] =
          static_cast<const uint32_t*>(top)[r];
    }
  }
}

unsigned grid_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 4096 ? (want > 0 ? want : 1) : 4096);
}

long long n_tiles(long long n) { return (n + kTile - 1) / kTile; }

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

struct Scratch {
  void* keys[2];
  uint32_t* perm[2];
  uint32_t* counts;
  uint32_t* totals;
};

Scratch carve(void* scratch, long long n) {
  char* p = static_cast<char*>(scratch);
  const size_t key_bytes = align_up(static_cast<size_t>(n) * 8);
  const size_t perm_bytes = align_up(static_cast<size_t>(n) * 4);
  Scratch s;
  s.keys[0] = p;
  s.keys[1] = p + key_bytes;
  p += 2 * key_bytes;
  s.perm[0] = reinterpret_cast<uint32_t*>(p);
  s.perm[1] = reinterpret_cast<uint32_t*>(p + perm_bytes);
  p += 2 * perm_bytes;
  s.counts = reinterpret_cast<uint32_t*>(p);
  p += align_up(static_cast<size_t>(kBuckets) * n_tiles(n) * 4);
  s.totals = reinterpret_cast<uint32_t*>(p);
  return s;
}

// The runs of a non-zero varying-bit mask m. Where m has more than
// kMaxRuns runs, the narrowest gaps are sorted as if they varied.
Runs runs_of(uint64_t m) {
  for (;;) {
    int start[32], end[32], count = 0;
    for (int b = 0; b < 64;) {
      if (!((m >> b) & 1)) {
        ++b;
        continue;
      }
      int e = b;
      while (e < 64 && ((m >> e) & 1)) ++e;
      start[count] = b;
      end[count] = e;
      ++count;
      b = e;
    }
    if (count <= kMaxRuns) {
      Runs runs{};
      runs.n = count;
      for (int j = 0; j < count; ++j) {
        const int width = end[j] - start[j];
        runs.lo[j] = start[j];
        runs.at[j] = runs.bits;
        runs.mask[j] = width >= 64 ? ~0ull : ((1ull << width) - 1);
        runs.bits += width;
      }
      return runs;
    }
    int narrowest = 1;
    for (int j = 2; j < count; ++j) {
      if (start[j] - end[j - 1] < start[narrowest] - end[narrowest - 1])
        narrowest = j;
    }
    for (int b = end[narrowest - 1]; b < start[narrowest]; ++b)
      m |= 1ull << b;
  }
}

// Sorts by one word's packed varying bits, carrying the permutation:
// *perm_cur is null (identity) or one of s.perm.
template <typename K>
int sort_word(const void* word, int kind, long long n, const Runs& runs,
              Scratch& s, uint32_t** perm_cur, cudaStream_t stream) {
  const int bits = runs.bits;
  const long long tiles = n_tiles(n);
  K* keys = static_cast<K*>(s.keys[0]);
  K* spare = static_cast<K*>(s.keys[1]);
  constexpr int kStaging = staging_bytes<K>();
  cudaFuncSetAttribute(scatter_keys<K>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kStaging);
  extract_keys<K><<<grid_for(n), kThreads, 0, stream>>>(
      word, kind, *perm_cur, n, runs, keys);
  for (int shift = 0; shift < bits; shift += kDigitBits) {
    uint32_t* perm_next = *perm_cur == s.perm[0] ? s.perm[1] : s.perm[0];
    digit_counts<K><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
        keys, n, shift, tiles, s.counts);
    scan_digits<<<kBuckets, 1024, 0, stream>>>(s.counts, tiles, s.totals);
    scatter_keys<K><<<static_cast<unsigned>(tiles), kThreads, kStaging,
                      stream>>>(keys, *perm_cur, n, shift, tiles, s.counts,
                                s.totals, spare, perm_next);
    K* t = keys;
    keys = spare;
    spare = t;
    *perm_cur = perm_next;
  }
  return static_cast<int>(cudaGetLastError());
}

Words make_words(const void* const* words, const int* kinds, int n_words) {
  Words w{};
  w.n = n_words;
  for (int k = 0; k < n_words; ++k) {
    w.ptr[k] = words[k];
    w.kind[k] = kinds[k];
  }
  return w;
}

}  // namespace

extern "C" long long radix_sort_scratch_bytes(long long n) {
  return static_cast<long long>(
      2 * align_up(static_cast<size_t>(n) * 8) +
      2 * align_up(static_cast<size_t>(n) * 4) +
      align_up(static_cast<size_t>(kBuckets) * n_tiles(n) * 4) +
      align_up(kBuckets * 4));
}

// masks (n_words zeroed u64 on the device) receive the varying bits of
// each word; the host reads them and passes them to radix_sort.
extern "C" int radix_sort_varying(const void* const* words, const int* kinds,
                                  int n_words, long long n, void* masks,
                                  void* stream) {
  if (n_words < 1 || n_words > kMaxWords) return -1;
  if (n <= 0) return 0;
  varying_bits<<<grid_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      make_words(words, kinds, n_words), n,
      static_cast<unsigned long long*>(masks));
  return static_cast<int>(cudaGetLastError());
}

// words[0] is the most significant key word; masks are the host copies of
// radix_sort_varying's output. Writes perm (int64[n]) and, when sorted_top
// is not null, word 0 in sorted order.
extern "C" int radix_sort(const void* const* words, const int* kinds,
                          int n_words, long long n,
                          const unsigned long long* masks, void* scratch,
                          void* perm, void* sorted_top, void* stream) {
  if (n_words < 1 || n_words > kMaxWords) return -1;
  if (n <= 0) return 0;
  if (n >= (1ll << 32)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch s = carve(scratch, n);
  uint32_t* perm_cur = nullptr;
  for (int k = n_words - 1; k >= 0; --k) {
    const unsigned long long m = masks[k];
    if (m == 0) continue;  // constant word: nothing to sort
    const Runs runs = runs_of(m);
    const int status =
        runs.bits <= 32
            ? sort_word<uint32_t>(words[k], kinds[k], n, runs, s, &perm_cur,
                                  st)
            : sort_word<uint64_t>(words[k], kinds[k], n, runs, s, &perm_cur,
                                  st);
    if (status != 0) return status;
  }
  write_perm<<<grid_for(n), kThreads, 0, st>>>(
      perm_cur, n, static_cast<long long*>(perm), words[0], kinds[0],
      sorted_top);
  return static_cast<int>(cudaGetLastError());
}
