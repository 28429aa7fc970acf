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
// and scatters once. Here the wrapper sorts once, with C5 radix_sort over
// the two lanes as int32 words: stable, so a run of equal hashes keeps its
// rows in order and its head is the hash's first row. The signed order of
// the words is not the uint64 order, but grouping needs only adjacency;
// the sentinel is recognised by its bit pattern. Then, over the sorted
// positions and the rows:
//   1. head_counts / head_ids (a three-pass tile scan): a position is a
//      head where its hash differs from the previous position's and is
//      not the sentinel; each position learns uid, the hash-order id of
//      its run, and each head writes its row to first_row[uid] and flags
//      that row in row order (unique rows: one head per hash);
//   2. flag_counts / flag_ranks (a second tile scan, in row order): the
//      exclusive count of flagged rows before a row is its first-
//      occurrence rank, so rank[first_row[u]] is hash u's code;
//   3. assign: codes[perm[i]] = rank[first_row[uid[i]]], or -1.
//
// Bound: bytes. The rows are read once through the sort's permutation
// (12 B a row, gathered), the codes written once; the scans add ~13 B a
// row of scratch traffic and the sort its own passes.
#include "common.cuh"

namespace {

constexpr uint32_t kSentinel = 0xffffffffu;

// Thread t of tile b takes the kItems consecutive positions starting here.
__device__ __forceinline__ long long first_item() {
  return static_cast<long long>(blockIdx.x) * pdp::kTile +
         static_cast<long long>(threadIdx.x) * pdp::kItems;
}

__device__ __forceinline__ bool is_sentinel(const uint32_t* rows,
                                            long long r) {
  return rows[3 * r] == kSentinel && rows[3 * r + 1] == kSentinel;
}

// Sorted position i starts a run of a real (non-sentinel) hash.
__device__ __forceinline__ bool is_head(const uint32_t* __restrict__ rows,
                                        const long long* __restrict__ perm,
                                        long long i) {
  const long long r = perm[i];
  const uint32_t h = rows[3 * r], l = rows[3 * r + 1];
  if (h == kSentinel && l == kSentinel) return false;
  if (i == 0) return true;
  const long long q = perm[i - 1];
  return rows[3 * q] != h || rows[3 * q + 1] != l;
}

__global__ void head_counts(const uint32_t* __restrict__ rows,
                            const long long* __restrict__ perm, long long n,
                            long long* __restrict__ aggs) {
  __shared__ long long smem[32];
  const long long base = first_item();
  long long c = 0;
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    if (i < n && is_head(rows, perm, i)) ++c;
  }
  long long total;
  pdp::block_exclusive_scan<pdp::SumOp<long long>>(c, smem, &total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

__global__ void head_ids(const uint32_t* __restrict__ rows,
                         const long long* __restrict__ perm, long long n,
                         const long long* __restrict__ prefixes,
                         int32_t* __restrict__ uid,
                         int32_t* __restrict__ first_row,
                         uint8_t* __restrict__ row_flag) {
  __shared__ long long smem[32];
  const long long base = first_item();
  bool head[pdp::kItems];
  long long c = 0;
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    head[j] = i < n && is_head(rows, perm, i);
    c += head[j];
  }
  long long total;
  const long long excl =
      pdp::block_exclusive_scan<pdp::SumOp<long long>>(c, smem, &total);
  // The id of the last head before this thread's positions (-1: none).
  long long u = prefixes[blockIdx.x] + excl - 1;
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    if (head[j]) {
      ++u;
      const long long r = perm[i];
      first_row[u] = static_cast<int32_t>(r);
      row_flag[r] = 1;
    }
    uid[i] = static_cast<int32_t>(u);
  }
}

__global__ void flag_counts(const uint8_t* __restrict__ row_flag, long long n,
                            long long* __restrict__ aggs) {
  __shared__ long long smem[32];
  const long long base = first_item();
  long long c = 0;
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    if (i < n) c += row_flag[i];
  }
  long long total;
  pdp::block_exclusive_scan<pdp::SumOp<long long>>(c, smem, &total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

__global__ void flag_ranks(const uint8_t* __restrict__ row_flag, long long n,
                           const long long* __restrict__ prefixes,
                           int32_t* __restrict__ rank) {
  __shared__ long long smem[32];
  const long long base = first_item();
  uint8_t f[pdp::kItems];
  long long c = 0;
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    f[j] = i < n ? row_flag[i] : 0;
    c += f[j];
  }
  long long total;
  long long before =
      prefixes[blockIdx.x] +
      pdp::block_exclusive_scan<pdp::SumOp<long long>>(c, smem, &total);
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    rank[i] = static_cast<int32_t>(before);
    before += f[j];
  }
}

__global__ void assign(const uint32_t* __restrict__ rows,
                       const long long* __restrict__ perm, long long n,
                       const int32_t* __restrict__ uid,
                       const int32_t* __restrict__ first_row,
                       const int32_t* __restrict__ rank,
                       const long long* __restrict__ n_heads,
                       int32_t* __restrict__ codes,
                       int32_t* __restrict__ n_unique) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i == 0) *n_unique = static_cast<int32_t>(*n_heads);
  if (i >= n) return;
  const long long r = perm[i];
  if (is_sentinel(rows, r) || rows[3 * r + 2] != 1u) {
    codes[r] = -1;
    return;
  }
  codes[r] = rank[first_row[uid[i]]];
}

constexpr long long kAlign = 256;

long long aligned(long long bytes) {
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

}  // namespace

// Scratch for n rows: two tile-aggregate arrays (each with its total),
// uid / first_row / rank (int32[n] each) and row_flag (u8[n]).
extern "C" long long factorize_codes_scratch_bytes(long long n) {
  const long long aggs = aligned((pdp::n_tiles(n) + 1) * 8);
  return 2 * aggs + 3 * aligned(4 * n) + aligned(n);
}

// rows: uint32[n, 3] (hash_hi, hash_lo, valid); perm: int64[n], the stable
// order of the rows by (hash_hi, hash_lo); codes: int32[n]; n_unique: one
// int32. n < 2^31.
extern "C" int factorize_codes(const void* rows, const void* perm, long long n,
                               void* scratch, void* codes, void* n_unique,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    cudaMemsetAsync(n_unique, 0, sizeof(int32_t), s);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = pdp::n_tiles(n);
  char* p = static_cast<char*>(scratch);
  long long* head_aggs = reinterpret_cast<long long*>(p);
  p += aligned((tiles + 1) * 8);
  long long* flag_aggs = reinterpret_cast<long long*>(p);
  p += aligned((tiles + 1) * 8);
  int32_t* uid = reinterpret_cast<int32_t*>(p);
  p += aligned(4 * n);
  int32_t* first_row = reinterpret_cast<int32_t*>(p);
  p += aligned(4 * n);
  int32_t* rank = reinterpret_cast<int32_t*>(p);
  p += aligned(4 * n);
  uint8_t* row_flag = reinterpret_cast<uint8_t*>(p);

  const uint32_t* r = static_cast<const uint32_t*>(rows);
  const long long* pm = static_cast<const long long*>(perm);
  const unsigned grid = static_cast<unsigned>(tiles);
  cudaMemsetAsync(row_flag, 0, static_cast<size_t>(n), s);
  head_counts<<<grid, pdp::kThreads, 0, s>>>(r, pm, n, head_aggs);
  pdp::scan_tile_aggregates<pdp::SumOp<long long>><<<1, 1024, 0, s>>>(
      head_aggs, tiles, head_aggs + tiles);
  head_ids<<<grid, pdp::kThreads, 0, s>>>(r, pm, n, head_aggs, uid, first_row,
                                          row_flag);
  flag_counts<<<grid, pdp::kThreads, 0, s>>>(row_flag, n, flag_aggs);
  pdp::scan_tile_aggregates<pdp::SumOp<long long>><<<1, 1024, 0, s>>>(
      flag_aggs, tiles, flag_aggs + tiles);
  flag_ranks<<<grid, pdp::kThreads, 0, s>>>(row_flag, n, flag_aggs, rank);
  constexpr int kBlock = 256;
  assign<<<static_cast<unsigned>((n + kBlock - 1) / kBlock), kBlock, 0, s>>>(
      r, pm, n, uid, first_row, rank, head_aggs + tiles,
      static_cast<int32_t*>(codes), static_cast<int32_t*>(n_unique));
  return static_cast<int>(cudaGetLastError());
}
