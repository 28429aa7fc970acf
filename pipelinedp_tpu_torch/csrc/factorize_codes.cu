// C12 factorize_codes: first-occurrence dense codes of 64-bit key hashes.
//
// Replaces K16a, pipelinedp_tpu/device_encode.py _factorize_kernel (:181,
// exposed as factorize_codes, :232): each row of (n, 3) uint32 hash rows
// [hash_hi, hash_lo, valid] gets the rank of its hash among the distinct
// hashes ordered by their first row, over every non-sentinel row, valid or
// not (an invalid row still claims its vocabulary slot, as the host
// encoder factorizes the raw column before rows are invalidated); a
// sentinel row (both lanes 0xffffffff) or an invalid row codes to -1. The
// distinct count goes to n_unique.
//
// The JAX kernel sorts twice (by hash and row, then by first occurrence)
// and scatters once. Here no row is sorted: an open-addressing hash table
// on the card keeps each distinct hash with its smallest row.
//   1. insert_rows (one coalesced read of the rows): a row's 64-bit key
//      (the two lanes joined) picks its home slot by a multiplicative hash
//      and probes linearly, reading a slot's key and row in one 16-byte
//      load. An empty slot holds the sentinel pattern, which data never
//      holds (the host hash remaps uint64-max); a slot is claimed by
//      atomicCAS on its key and its row kept by atomicMin, which runs only
//      where the slot's row is larger (a hot key's later rows read and
//      leave). Lanes of a warp holding the same key merge first
//      (__match_any_sync): the lowest lane, the smallest row of the 32
//      consecutive rows, touches the slot for all of them. Each row's slot
//      (or none: a dropped row) is kept for pass 5. Probing stops after
//      max_probes slots: the table was sized for fewer distinct hashes
//      than the rows hold, the overflow flag is set and n_unique reports
//      -1.
//   2. flag_slots (one pass over the table): each occupied slot sets its
//      smallest row's bit in a row bitmap and counts one distinct hash.
//   3. scan_words: the exclusive prefix of the bitmap words' popcounts, one
//      pass with a decoupled look-back (pdp::look_back).
//   4. code_slots (the table again), where the table fits in half the
//      L2: a slot's code is the number of flagged rows before its
//      smallest row.
//   5. assign_codes (the kept slots read coalesced): codes[i] = the code
//      of row i's slot (read from the slot, or taken from its row and the
//      bitmap where pass 4 did not run), or -1.
//   6. with a heads table (the mesh factorize's local phase, C24): the
//      distinct hash of code k as the hash row (hi, lo, 1) at slot k of a
//      [heads_cap] table, the distinct hashes in first-row order; slots
//      past n_unique keep the sentinel row the table's memset wrote. Pass
//      4 writes it from each slot's key where it runs; else write_heads,
//      one pass over the bitmap, reads each flagged row's lanes.
// A key's smallest row is unique, so the codes, n_unique and the heads do
// not depend on the order of the atomics, nor on which slot a key lands
// in.
//
// The table has a power-of-two number of 16-byte slots, at least twice the
// distinct count the host planned with (kernels.factorize_table_plan: the
// ingest passes the count its unique merge already holds, else the rows
// bound it), so the load factor stays at or below 1/2. The Netflix users'
// table (2^20 slots, 16 MB) sits in the 50 MB L2; (q)'s 4.7M partition
// hashes (2^24 slots) do not and probe at device-memory speed.
//
// Bound: bytes. The rows are read once (12 B a row) and the codes written
// once (4 B); the table's memset, the slot kept a row (4 B written, 4 B
// read) and the probes' sectors add the rest. Measured slower on the card:
// no slot kept a row, pass 5 probing the table again from a second read of
// the rows; on an L2-sized table, pass 5 reading the slot's row and the
// bitmap with no pass 4; on (q)'s 268 MB one, pass 4; the slot's key and
// row read apart.
#include "common.cuh"

namespace {

constexpr unsigned long long kEmpty = ~0ull;  // the sentinel hash
constexpr uint32_t kNoSlot = 0xffffffffu;
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;
constexpr int kThreads = 256;
constexpr int kScanItems = 8;                         // words a thread
constexpr int kScanTile = kThreads * kScanItems;      // words a tile

struct __align__(16) Slot {
  unsigned long long key;  // kEmpty: free
  uint32_t row;            // smallest row holding the key
  int32_t code;            // its code, once pass 4 has run
};

struct Table {
  Slot* slots;
  uint32_t mask;  // capacity - 1
  int shift;      // 64 - log2(capacity)
  int max_probes;
};

// The scratch of one call: a memset to 0xff covers the slots, one to 0
// the control words, the scan's state and the row bitmap; the rest is
// written before it is read.
struct Control {
  int overflow;
  int n_unique;
};

struct Scratch {
  uint32_t* heads;     // [heads_cap, 3] hash rows, first in the 0xff region
  Slot* slots;
  Control* control;
  pdp::Scan<int> scan;
  uint32_t* bits;      // one bit a row: a hash's smallest row
  int* word_prefix;    // flagged rows before each bitmap word
  uint32_t* slot_of;   // each row's slot, kNoSlot for a dropped row
  size_t table_bytes;  // the slots
  size_t fill_bytes;   // the 0xff region (heads and slots)
  size_t zero_bytes;   // the 0 region after it
};

long long words_of(long long n) { return (n + 31) / 32; }
long long scan_tiles(long long n) {
  return (words_of(n) + kScanTile - 1) / kScanTile;
}

size_t heads_bytes(long long heads_cap) {
  return pdp::align_up(static_cast<size_t>(heads_cap) * 12);
}

Scratch carve(void* scratch, long long n, long long capacity,
              long long heads_cap) {
  using pdp::align_up;
  Scratch s;
  char* p = static_cast<char*>(scratch);
  s.heads = reinterpret_cast<uint32_t*>(p);
  p += heads_bytes(heads_cap);
  s.table_bytes = align_up(static_cast<size_t>(capacity) * sizeof(Slot));
  s.slots = reinterpret_cast<Slot*>(p);
  p += s.table_bytes;
  s.fill_bytes = static_cast<size_t>(p - static_cast<char*>(scratch));
  char* zero = p;
  s.control = reinterpret_cast<Control*>(p);
  p += align_up(sizeof(Control));
  const long long tiles = scan_tiles(n);
  s.scan = pdp::carve_scan<int>(p, tiles);
  p += pdp::scan_bytes<int>(tiles);
  s.bits = reinterpret_cast<uint32_t*>(p);
  p += align_up(static_cast<size_t>(words_of(n)) * 4);
  // Zeroed: the control words, the scan's counter and status words (its
  // published values between them and the bitmap along) and the bitmap.
  s.zero_bytes = static_cast<size_t>(p - zero);
  s.word_prefix = reinterpret_cast<int*>(p);
  p += align_up(static_cast<size_t>(words_of(n)) * 4);
  s.slot_of = reinterpret_cast<uint32_t*>(p);
  return s;
}

size_t scratch_bytes(long long n, long long capacity, long long heads_cap) {
  using pdp::align_up;
  return heads_bytes(heads_cap) +
         align_up(static_cast<size_t>(capacity) * sizeof(Slot)) +
         align_up(sizeof(Control)) + pdp::scan_bytes<int>(scan_tiles(n)) +
         2 * align_up(static_cast<size_t>(words_of(n)) * 4) +
         align_up(static_cast<size_t>(n) * 4);
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// The key's slot after claiming it or finding it, with `row` kept if it is
// the smallest so far; kNoSlot after max_probes slots (overflow set).
__device__ uint32_t insert(const Table& t, unsigned long long key,
                           uint32_t row, int* overflow) {
  uint32_t s = static_cast<uint32_t>((key * kGolden) >> t.shift);
  for (int probe = 0; probe < t.max_probes; ++probe, s = (s + 1) & t.mask) {
    Slot* slot = t.slots + s;
    // Key and row in one 16-byte read from L2.
    const ulonglong2 seen =
        __ldcg(reinterpret_cast<const ulonglong2*>(slot));
    unsigned long long k = seen.x;
    uint32_t kept = static_cast<uint32_t>(seen.y);
    if (k == kEmpty) {
      k = atomicCAS(&slot->key, kEmpty, key);
      if (k == kEmpty) {
        atomicMin(&slot->row, row);
        return s;
      }
      kept = 0xffffffffu;  // read before the key was claimed
    }
    if (k == key) {
      if (kept > row) atomicMin(&slot->row, row);
      return s;
    }
    // A long probe stops once any thread has found the table too small.
    if ((probe & 63) == 63 && load_volatile(overflow)) return kNoSlot;
  }
  atomicExch(overflow, 1);
  return kNoSlot;
}

__global__ void __launch_bounds__(kThreads)
    insert_rows(const uint32_t* __restrict__ rows, long long n, Table t,
                int* __restrict__ overflow, uint32_t* __restrict__ slot_of) {
  __shared__ uint32_t staged[3 * kThreads];
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < n; base += stride) {
    // The block's 256 rows (768 words) read coalesced.
    const long long words = 3 * (n - base < kThreads ? n - base : kThreads);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int w = threadIdx.x + k * kThreads;
      if (w < words) staged[w] = __ldcs(rows + 3 * base + w);
    }
    __syncthreads();
    const long long i = base + threadIdx.x;
    const bool in = i < n;
    const uint32_t hi = in ? staged[3 * threadIdx.x] : 0xffffffffu;
    const uint32_t lo = in ? staged[3 * threadIdx.x + 1] : 0xffffffffu;
    const bool valid = in && staged[3 * threadIdx.x + 2] == 1u;
    const unsigned long long key =
        (static_cast<unsigned long long>(hi) << 32) | lo;
    const bool real = key != kEmpty;
    const unsigned active = __ballot_sync(pdp::kFullMask, real);
    uint32_t slot = kNoSlot;
    int leader = lane;
    if (real) {
      // Lanes hold consecutive rows: the lowest lane of a key has its
      // smallest row here.
      const unsigned peers = __match_any_sync(active, key);
      leader = __ffs(peers) - 1;
      if (lane == leader)
        slot = insert(t, key, static_cast<uint32_t>(i), overflow);
    }
    slot = __shfl_sync(pdp::kFullMask, slot, leader);
    if (in) __stcs(slot_of + i, real && valid ? slot : kNoSlot);
  }
}

__global__ void __launch_bounds__(kThreads)
    flag_slots(const Slot* __restrict__ slots, long long capacity,
               uint32_t* __restrict__ bits, Control* __restrict__ control) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  int count = 0;
  for (long long s = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       s < capacity; s += stride) {
    const Slot slot = slots[s];
    if (slot.key == kEmpty) continue;
    atomicOr(bits + (slot.row >> 5), 1u << (slot.row & 31));
    ++count;
  }
  count = __reduce_add_sync(pdp::kFullMask, count);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(&control->n_unique, count);
}

__global__ void __launch_bounds__(kThreads)
    scan_words(const uint32_t* __restrict__ bits, long long n_words,
               pdp::Scan<int> scan, int* __restrict__ word_prefix) {
  __shared__ int smem[32];
  const long long tile = pdp::claim_tile(scan.counter);
  const long long first = tile * kScanTile + threadIdx.x * kScanItems;
  int c[kScanItems];
  int acc = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    c[k] = first + k < n_words ? __popc(bits[first + k]) : 0;
    acc += c[k];
  }
  int total;
  const int excl =
      pdp::block_exclusive_scan<pdp::SumOp<int>>(acc, smem, &total);
  int before =
      pdp::tile_prefix<pdp::SumOp<int>>(scan, tile, tile == 0, total) + excl;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (first + k < n_words) word_prefix[first + k] = before;
    before += c[k];
  }
}

// Each occupied slot's code: the flagged rows before its smallest row;
// with a heads table, the slot's key as the hash row of its code there.
__global__ void __launch_bounds__(kThreads)
    code_slots(Slot* __restrict__ slots, long long capacity,
               const uint32_t* __restrict__ bits,
               const int* __restrict__ word_prefix,
               uint32_t* __restrict__ heads, long long heads_cap) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long s = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       s < capacity; s += stride) {
    const Slot slot = slots[s];
    if (slot.key == kEmpty) continue;
    const uint32_t r = slot.row, w = r >> 5;
    const int code =
        word_prefix[w] + __popc(bits[w] & ((1u << (r & 31)) - 1u));
    slots[s].code = code;
    if (heads != nullptr && code < heads_cap) {
      heads[3 * static_cast<long long>(code)] =
          static_cast<uint32_t>(slot.key >> 32);
      heads[3 * static_cast<long long>(code) + 1] =
          static_cast<uint32_t>(slot.key);
      heads[3 * static_cast<long long>(code) + 2] = 1u;
    }
  }
}

// kCoded: the slots hold their codes (pass 4 ran); else a row's code is
// taken from its slot's row and the bitmap here.
template <bool kCoded>
__global__ void __launch_bounds__(kThreads)
    assign_codes(const uint32_t* __restrict__ slot_of, long long n,
                 const Slot* __restrict__ slots,
                 const uint32_t* __restrict__ bits,
                 const int* __restrict__ word_prefix,
                 const Control* __restrict__ control,
                 int32_t* __restrict__ codes, int32_t* __restrict__ n_unique) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (first == 0)
    *n_unique = control->overflow ? -1 : control->n_unique;
  for (long long i = first; i < n; i += stride) {
    const uint32_t s = __ldcs(slot_of + i);
    int32_t code = -1;
    if (s != kNoSlot) {
      if constexpr (kCoded) {
        code = slots[s].code;
      } else {
        const uint32_t r = slots[s].row, w = r >> 5;
        code = word_prefix[w] + __popc(bits[w] & ((1u << (r & 31)) - 1u));
      }
    }
    __stcs(codes + i, code);
  }
}

// The k-th flagged row's lanes at slot k of the heads table (k below
// heads_cap: a table too small for the distinct count is reported by the
// caller's check of n_unique against it).
__global__ void __launch_bounds__(kThreads)
    write_heads(const uint32_t* __restrict__ rows, long long n_words,
                const uint32_t* __restrict__ bits,
                const int* __restrict__ word_prefix, long long heads_cap,
                uint32_t* __restrict__ heads) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       w < n_words; w += stride) {
    uint32_t b = bits[w];
    long long k = word_prefix[w];
    for (; b != 0u && k < heads_cap; b &= b - 1u, ++k) {
      const long long r = 32 * w + (__ffs(b) - 1);
      heads[3 * k] = rows[3 * r];
      heads[3 * k + 1] = rows[3 * r + 1];
      heads[3 * k + 2] = 1u;
    }
  }
}

// Pass 4 runs where the table fits in half the card's L2: there a row's
// slot is an L2 hit and one read of its code replaces three dependent
// ones. A larger table's slots come from device memory either way, and a
// pass over all of it costs more than it saves.
bool coded_table(size_t table_bytes) {
  int device = 0, l2 = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
  return table_bytes <= static_cast<size_t>(l2) / 2;
}

unsigned grid_for(long long count) {
  const long long blocks = (count + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 8192 ? blocks : 8192);
}

}  // namespace

// Scratch for n rows, a table of `capacity` slots and a heads table of
// heads_cap rows (0: none).
extern "C" long long factorize_codes_scratch_bytes(long long n,
                                                   long long capacity,
                                                   long long heads_cap) {
  return static_cast<long long>(scratch_bytes(n, capacity, heads_cap));
}

// rows: uint32[n, 3] (hash_hi, hash_lo, valid); capacity: the table's
// slots, a power of two >= 2 (kernels.factorize_table_plan), max_probes:
// the probes a key may take; codes: int32[n]; n_unique: one int32, -1
// where the table overflowed (the codes are then undefined). n < 2^31.
// heads_cap > 0: the scratch starts with the heads table, uint32
// [heads_cap, 3], written by pass 6 (sentinel rows past n_unique).
extern "C" int factorize_codes(const void* rows, long long n,
                               long long capacity, int max_probes,
                               void* scratch, void* codes, void* n_unique,
                               long long heads_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads_cap < 0) return -1;
  if (n <= 0) {
    cudaMemsetAsync(n_unique, 0, sizeof(int32_t), st);
    if (heads_cap > 0) cudaMemsetAsync(scratch, 0xff, heads_cap * 12, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (capacity < 2 || (capacity & (capacity - 1)) != 0 || max_probes < 1 ||
      capacity > (1ll << 32))
    return -1;
  Scratch s = carve(scratch, n, capacity, heads_cap);
  Table t{s.slots, static_cast<uint32_t>(capacity - 1),
          64 - (63 - __builtin_clzll(static_cast<unsigned long long>(
                         capacity))),
          max_probes};
  cudaMemsetAsync(scratch, 0xff, s.fill_bytes, st);
  cudaMemsetAsync(s.control, 0, s.zero_bytes, st);
  insert_rows<<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(rows), n, t, &s.control->overflow,
      s.slot_of);
  flag_slots<<<grid_for(capacity), kThreads, 0, st>>>(s.slots, capacity,
                                                      s.bits, s.control);
  scan_words<<<static_cast<unsigned>(scan_tiles(n)), kThreads, 0, st>>>(
      s.bits, words_of(n), s.scan, s.word_prefix);
  if (coded_table(s.table_bytes)) {
    code_slots<<<grid_for(capacity), kThreads, 0, st>>>(
        s.slots, capacity, s.bits, s.word_prefix,
        heads_cap > 0 ? s.heads : nullptr, heads_cap);
    assign_codes<true><<<grid_for(n), kThreads, 0, st>>>(
        s.slot_of, n, s.slots, s.bits, s.word_prefix, s.control,
        static_cast<int32_t*>(codes), static_cast<int32_t*>(n_unique));
  } else {
    if (heads_cap > 0)
      write_heads<<<grid_for(words_of(n)), kThreads, 0, st>>>(
          static_cast<const uint32_t*>(rows), words_of(n), s.bits,
          s.word_prefix, heads_cap, s.heads);
    assign_codes<false><<<grid_for(n), kThreads, 0, st>>>(
        s.slot_of, n, s.slots, s.bits, s.word_prefix, s.control,
        static_cast<int32_t*>(codes), static_cast<int32_t*>(n_unique));
  }
  return static_cast<int>(cudaGetLastError());
}
