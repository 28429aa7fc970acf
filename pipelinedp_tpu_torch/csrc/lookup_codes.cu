// C13 lookup_codes: first-occurrence codes of key hashes by table search.
//
// Replaces K16b, pipelinedp_tpu/device_encode.py _lookup_kernel (:272,
// exposed as lookup_codes, :298): each row of (n, 3) uint32 hash rows
// [hash_hi, hash_lo, valid] finds its hash in the host-merged table of the
// distinct hashes (build_lookup_table: (Vcap, 2) uint32 lanes in ascending
// uint64 order, sentinel-padded to a rounded capacity) and takes that
// entry's first-occurrence code; a sentinel row (both lanes 0xffffffff) or
// an invalid row takes -1. The codes equal C12 factorize_codes'.
//
// One thread a row: a lower-bound binary search over the table with the
// lanes compared as unsigned (hi, lo) pairs, the uint64 order the table
// was laid out in, then one gather of table_codes at min(position,
// Vcap - 1), as the JAX kernel clamps.
//
// Bound: bytes. Each row reads its 12 B and writes a 4 B code; the table
// (12 B an entry) is read from L2 by every search, ~log2(Vcap) dependent
// loads a row, which is what this kernel waits on.
#include "common.cuh"

namespace {

constexpr uint32_t kSentinel = 0xffffffffu;

__global__ void lookup(const uint32_t* __restrict__ rows, long long n,
                       const uint32_t* __restrict__ table, long long v_cap,
                       const int32_t* __restrict__ table_codes,
                       int32_t* __restrict__ codes) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t rhi = rows[3 * i], rlo = rows[3 * i + 1];
  if ((rhi == kSentinel && rlo == kSentinel) || rows[3 * i + 2] != 1u) {
    codes[i] = -1;
    return;
  }
  long long lo = 0, hi = v_cap;  // the first entry with (hi, lo) >= the row's
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const uint32_t mh = table[2 * mid], ml = table[2 * mid + 1];
    if (mh < rhi || (mh == rhi && ml < rlo))
      lo = mid + 1;
    else
      hi = mid;
  }
  codes[i] = table_codes[lo < v_cap - 1 ? lo : v_cap - 1];
}

}  // namespace

// rows: uint32[n, 3]; table: uint32[v_cap, 2] ascending as uint64;
// table_codes: int32[v_cap]; codes: int32[n]. v_cap >= 1.
extern "C" int lookup_codes(const void* rows, long long n, const void* table,
                            long long v_cap, const void* table_codes,
                            void* codes, void* stream) {
  if (n <= 0) return 0;
  if (v_cap < 1) return -1;
  constexpr int kBlock = 256;
  lookup<<<static_cast<unsigned>((n + kBlock - 1) / kBlock), kBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), n,
      static_cast<const uint32_t*>(table), v_cap,
      static_cast<const int32_t*>(table_codes), static_cast<int32_t*>(codes));
  return static_cast<int>(cudaGetLastError());
}
