// C14 append_rows: the streamed ingest's device row buffers.
//
// Replaces K17, pipelinedp_tpu/runtime/pipeline.py _append_fn (:305) and
// _grow_fn (:325): the streaming accumulator keeps (pid, pk, values)
// columns in persistent power-of-two device buffers; a chunk lands at a
// row offset, and a buffer that is full grows to a larger power of two
// whose tail carries the pad values ((0, -1, 0) on the host-encoded route,
// the hash sentinel's bit pattern on the hash route), so the final buffers
// equal executor.pad_rows over the concatenated rows.
//
// The chunk rows themselves reach the buffer by an asynchronous copy from
// pinned host memory (runtime/pipeline.py); this source is what writes on
// the device, one C entry and one launch for both uses over up to three
// columns:
//   * fill_tail: every column's pad value over rows [start, cap);
//   * grow: every column copied into its new, larger buffer, whose rows
//     past the old capacity take the pad value.
// A column is [cap] or [cap, width] of 4- or 8-byte elements; a pad value
// arrives as its bit pattern.
//
// Design. Each column's copied bytes and filled bytes are split into
// regions: a 16-byte-aligned body written (and read, for a copy) in
// 16-byte vectors, and the few elements before and after it (an unaligned
// start, a count that is not a multiple of 16 bytes) element by element; a
// column whose buffers are not 16-byte aligned is one element-wise region.
// The pad's 16-byte pattern is built once a column on the host. One flat
// grid covers every region: region r takes its own run of blocks, so a
// narrow column leaves no block idle; a thread moves kUnroll units, its
// loads all issued before its stores (64 B in flight a thread in the
// body).
//
// Bound: bytes. grow reads the old buffers and writes the new ones once;
// fill_tail writes the tail once.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxColumns = 3;
// A column's copy and fill, each a head, a body and a tail.
constexpr int kMaxRegions = kMaxColumns * 2 * 3;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kBlockUnits = static_cast<long long>(kThreads) * kUnroll;

struct Region {
  char* dst;
  const char* src;      // null: the pad
  long long units;      // of `unit` bytes
  long long first_block;
  uint4 pattern;        // the pad, repeated over 16 bytes
  int unit;             // 16, 8 or 4
};

struct Plan {
  Region r[kMaxRegions];
  int n;
};

template <typename W>
__device__ __forceinline__ W pad_of(const uint4& p);
template <>
__device__ __forceinline__ uint4 pad_of<uint4>(const uint4& p) {
  return p;
}
template <>
__device__ __forceinline__ unsigned long long pad_of<unsigned long long>(
    const uint4& p) {
  return static_cast<unsigned long long>(p.x) |
         (static_cast<unsigned long long>(p.y) << 32);
}
template <>
__device__ __forceinline__ unsigned pad_of<unsigned>(const uint4& p) {
  return p.x;
}

template <typename W>
__device__ __forceinline__ void move(const Region& g, long long at) {
  W* dst = reinterpret_cast<W*>(g.dst);
  const W* src = reinterpret_cast<const W*>(g.src);
  W v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = at + u * kThreads;
    if (i < g.units) v[u] = src ? __ldg(src + i) : pad_of<W>(g.pattern);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = at + u * kThreads;
    if (i < g.units) dst[i] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads)
    write_regions(const __grid_constant__ Plan p) {
  int r = 0;
  while (r + 1 < p.n && p.r[r + 1].first_block <= blockIdx.x) ++r;
  const Region& g = p.r[r];
  const long long at =
      (static_cast<long long>(blockIdx.x) - g.first_block) * kBlockUnits +
      threadIdx.x;
  if (g.unit == 16)
    move<uint4>(g, at);
  else if (g.unit == 8)
    move<unsigned long long>(g, at);
  else
    move<unsigned>(g, at);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Bytes [begin, end) of dst (and of src, where not null) as regions:
// head, 16-byte body, tail where both buffers are 16-byte aligned, else
// one element-wise region.
void add_regions(Plan& p, long long& blocks, char* dst, const char* src,
                 long long begin, long long end, int elem,
                 const uint4& pattern) {
  auto add = [&](long long b, long long e, int unit) {
    if (e <= b) return;
    Region& g = p.r[p.n++];
    g = Region{dst + b, src ? src + b : nullptr, (e - b) / unit, blocks,
               pattern, unit};
    blocks += (g.units + kBlockUnits - 1) / kBlockUnits;
  };
  if (!aligned(dst) || (src && !aligned(src))) {
    add(begin, end, elem);
    return;
  }
  const long long body_begin = (begin + 15) / 16 * 16;
  const long long body_end = end / 16 * 16;
  if (body_begin >= body_end) {
    add(begin, end, elem);
    return;
  }
  add(begin, body_begin, elem);
  add(body_begin, body_end, 16);
  add(body_end, end, elem);
}

}  // namespace

// table: five int64 words a column (n_cols <= 3): the destination buffer,
// the source buffer (0: nothing copied), the width (elements a row), the
// element bytes (4 or 8) and the pad's bit pattern. Rows [0, copy_rows)
// are copied from the source, rows [fill_begin, fill_end) take the pad.
// fill_tail: copy_rows 0, [start, cap); grow: copy_rows old_cap,
// [old_cap, new_cap).
extern "C" int append_rows(const long long* table, int n_cols,
                           long long copy_rows, long long fill_begin,
                           long long fill_end, void* stream) {
  if (n_cols < 1 || n_cols > kMaxColumns || copy_rows < 0 ||
      fill_begin < copy_rows || fill_end < fill_begin)
    return -1;
  Plan p{};
  long long blocks = 0;
  for (int j = 0; j < n_cols; ++j) {
    const long long* w = table + 5 * j;
    char* dst = reinterpret_cast<char*>(w[0]);
    const char* src = reinterpret_cast<const char*>(w[1]);
    const long long width = w[2];
    const int elem = static_cast<int>(w[3]);
    const unsigned long long bits = static_cast<unsigned long long>(w[4]);
    if ((elem != 4 && elem != 8) || width < 1 || (copy_rows > 0 && !src))
      return -1;
    const unsigned lo = static_cast<unsigned>(bits);
    const unsigned hi = elem == 8 ? static_cast<unsigned>(bits >> 32) : lo;
    const uint4 pattern = make_uint4(lo, hi, lo, hi);
    const long long row = width * elem;
    add_regions(p, blocks, dst, src, 0, copy_rows * row, elem, pattern);
    add_regions(p, blocks, dst, nullptr, fill_begin * row, fill_end * row,
                elem, pattern);
  }
  if (p.n == 0) return 0;
  if (blocks > 0x7fffffffLL) return -1;
  write_regions<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
