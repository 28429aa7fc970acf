// C24 mesh_factorize: first-occurrence codes of row-sharded 64-bit key
// hashes over a device mesh.
//
// Replaces K23b, pipelinedp_tpu/device_encode.py _mesh_unique_cap_kernel
// (:302) and _mesh_factorize_kernel (:322), driven by mesh_factorize_codes
// (:406). Shard s holds `local` rows of (n, 3) uint32 hash rows [hash_hi,
// hash_lo, valid]; row i of shard s has the global position
// gpos = s * local + i. Every row gets the rank of its hash among the
// distinct non-sentinel hashes ordered by their first global position
// (sentinel or invalid rows code to -1), the codes columnar.factorize
// gives the concatenated stream.
//
// The JAX kernel runs one shard_map program a phase, with the merge
// replicated on every shard. Here the wrapper (kernels.py) runs, with a
// C5 radix_sort before each scan:
//   1. mesh_local_uniques, one launch a shard, over the shard's rows in
//      the stable C5 order by (hi, lo) as int32 words (a run's head is the
//      hash's first row there). A position is a head where its hash
//      differs from the previous position's and is not the sentinel
//      (recognised by value: in signed order it does not sort last). Each
//      position gets lseg, the id of its run among the heads; n_new is
//      the head count (the unique-cap phase). With a table it also
//      writes head k's (hi, lo, gpos) to slot k of a [uniq_cap] table and
//      pads slots n_new.. with the sentinel and INT32_MAX. The host code
//      keeps the phase-1 sort and lseg for phase 2.
//   2. mesh_merge_heads, once on the gathering device, over the gathered
//      [D x uniq_cap] table in the C5 order by (hi, lo, gpos): heads
//      exclude the sentinel, gseg is each slot's run id, n_unique the head
//      count, and first_by_u[gseg] the run head's gpos (its smallest).
//   3. mesh_merge_remap, after a C5 sort of first_by_u (perm2): the rank
//      of unique u is its place in that order, and remap[slot] is the rank
//      of the slot's unique (-1 for a sentinel slot).
//   4. mesh_remap_rows, one launch a shard:
//      codes[perm[i]] = dropped ? -1 : remap[s * uniq_cap + lseg[i]].
//
// Bound: bytes. Each phase reads its rows through the sort's permutation
// (12 B a row, gathered) and writes 4 B a row; the merge moves O(uniques).
#include "common.cuh"

namespace {

constexpr uint32_t kSentinel = 0xffffffffu;
constexpr int32_t kIntMax = 0x7fffffff;

// The two hash lanes of row r: hi[stride * r], lo[stride * r] (stride 3
// for (n, 3) rows, 1 for the gathered table's separate columns).
struct Lanes {
  const uint32_t* hi;
  const uint32_t* lo;
  long long stride;
  __device__ __forceinline__ uint32_t h(long long r) const {
    return hi[stride * r];
  }
  __device__ __forceinline__ uint32_t l(long long r) const {
    return lo[stride * r];
  }
  __device__ __forceinline__ bool sentinel(long long r) const {
    return h(r) == kSentinel && l(r) == kSentinel;
  }
};

__device__ __forceinline__ long long first_item() {
  return static_cast<long long>(blockIdx.x) * pdp::kTile +
         static_cast<long long>(threadIdx.x) * pdp::kItems;
}

// Sorted position i starts a run of a real (non-sentinel) hash.
__device__ __forceinline__ bool is_head(const Lanes& a,
                                        const long long* __restrict__ perm,
                                        long long i) {
  const long long r = perm[i];
  if (a.sentinel(r)) return false;
  if (i == 0) return true;
  const long long q = perm[i - 1];
  return a.h(q) != a.h(r) || a.l(q) != a.l(r);
}

__global__ void head_counts(Lanes a, const long long* __restrict__ perm,
                            long long n, long long* __restrict__ aggs) {
  __shared__ long long smem[32];
  const long long base = first_item();
  long long c = 0;
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    if (i < n && is_head(a, perm, i)) ++c;
  }
  long long total;
  pdp::block_exclusive_scan<pdp::SumOp<long long>>(c, smem, &total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

// Run ids of every sorted position, and each head's payload: its lanes to
// out_hi / out_lo[u] (when not null) and its position to out_pos[u], the
// position being pos_of_row[r] where given, else pos_base + r. Heads past
// cap write nothing (the wrapper sizes cap to the head count).
__global__ void head_ids(Lanes a, const long long* __restrict__ perm,
                         long long n, const long long* __restrict__ prefixes,
                         int32_t* __restrict__ seg,
                         const int32_t* __restrict__ pos_of_row,
                         long long pos_base, int32_t* __restrict__ out_hi,
                         int32_t* __restrict__ out_lo,
                         int32_t* __restrict__ out_pos, long long cap) {
  __shared__ long long smem[32];
  const long long base = first_item();
  bool head[pdp::kItems];
  long long c = 0;
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    head[j] = i < n && is_head(a, perm, i);
    c += head[j];
  }
  long long total;
  const long long excl =
      pdp::block_exclusive_scan<pdp::SumOp<long long>>(c, smem, &total);
  long long u = prefixes[blockIdx.x] + excl - 1;
#pragma unroll
  for (int j = 0; j < pdp::kItems; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    if (head[j]) {
      ++u;
      if (u < cap) {
        const long long r = perm[i];
        if (out_hi != nullptr) {
          out_hi[u] = static_cast<int32_t>(a.h(r));
          out_lo[u] = static_cast<int32_t>(a.l(r));
        }
        out_pos[u] = pos_of_row != nullptr
                         ? pos_of_row[r]
                         : static_cast<int32_t>(pos_base + r);
      }
    }
    seg[i] = static_cast<int32_t>(u);
  }
}

// Slots past the head count: the sentinel lanes (when out_hi is given)
// and INT32_MAX positions; also writes the count as int32.
__global__ void pad_slots(const long long* __restrict__ n_heads,
                          long long cap, int32_t* __restrict__ out_hi,
                          int32_t* __restrict__ out_lo,
                          int32_t* __restrict__ out_pos,
                          int32_t* __restrict__ count) {
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long h = *n_heads;
  if (k == 0) *count = static_cast<int32_t>(h);
  if (k >= cap || k < h) return;
  if (out_hi != nullptr) {
    out_hi[k] = -1;
    out_lo[k] = -1;
  }
  out_pos[k] = kIntMax;
}

__global__ void invert(const long long* __restrict__ perm2, long long m,
                       int32_t* __restrict__ inv) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < m) inv[perm2[j]] = static_cast<int32_t>(j);
}

__global__ void remap_slots(Lanes a, const long long* __restrict__ perm1,
                            const int32_t* __restrict__ gseg, long long m,
                            const int32_t* __restrict__ inv,
                            int32_t* __restrict__ remap) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const long long r = perm1[i];
  remap[r] = a.sentinel(r) ? -1 : inv[gseg[i]];
}

__global__ void remap_rows(const uint32_t* __restrict__ rows,
                           const long long* __restrict__ perm,
                           const int32_t* __restrict__ lseg, long long n,
                           const int32_t* __restrict__ remap, long long cap,
                           int32_t* __restrict__ codes) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = perm[i];
  const bool sentinel =
      rows[3 * r] == kSentinel && rows[3 * r + 1] == kSentinel;
  const int32_t u = lseg[i];
  codes[r] = (sentinel || rows[3 * r + 2] != 1u || u < 0 || u >= cap)
                 ? -1
                 : remap[u];
}

constexpr int kBlock = 256;

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

// The three-pass head scan over n sorted positions, then the padding of
// [cap] slots and the int32 count.
int head_scan(const Lanes& a, const long long* perm, long long n,
              long long* aggs, int32_t* seg, const int32_t* pos_of_row,
              long long pos_base, int32_t* out_hi, int32_t* out_lo,
              int32_t* out_pos, long long cap, int32_t* count,
              cudaStream_t s) {
  const long long tiles = pdp::n_tiles(n);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>(tiles);
    head_counts<<<grid, pdp::kThreads, 0, s>>>(a, perm, n, aggs);
    pdp::scan_tile_aggregates<pdp::SumOp<long long>><<<1, 1024, 0, s>>>(
        aggs, tiles, aggs + tiles);
    head_ids<<<grid, pdp::kThreads, 0, s>>>(a, perm, n, aggs, seg,
                                            pos_of_row, pos_base, out_hi,
                                            out_lo, out_pos, cap);
  } else {
    cudaMemsetAsync(aggs, 0, sizeof(long long), s);
  }
  pad_slots<<<blocks(cap > 0 ? cap : 1), kBlock, 0, s>>>(
      aggs + tiles, cap, out_hi, out_lo, out_pos, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tile-aggregate scratch of a head scan over n positions.
extern "C" long long mesh_scan_scratch_bytes(long long n) {
  return (pdp::n_tiles(n) + 1) * 8;
}

// rows: uint32[n, 3] of one shard; perm: int64[n], its stable order by
// (hash_hi, hash_lo); lseg: int32[n]; n_new: one int32. With t_hi not
// null, t_hi / t_lo / t_pos: int32[uniq_cap], the compacted heads in run
// order with gpos = gpos_base + row. gpos_base + n < 2^31.
extern "C" int mesh_local_uniques(const void* rows, const void* perm,
                                  long long n, long long gpos_base,
                                  long long uniq_cap, void* scratch,
                                  void* lseg, void* n_new, void* t_hi,
                                  void* t_lo, void* t_pos, void* stream) {
  const uint32_t* r = static_cast<const uint32_t*>(rows);
  const Lanes a{r, r + 1, 3};
  int32_t* pos = static_cast<int32_t*>(t_pos);
  return head_scan(a, static_cast<const long long*>(perm), n,
                   static_cast<long long*>(scratch),
                   static_cast<int32_t*>(lseg), nullptr, gpos_base,
                   static_cast<int32_t*>(t_hi), static_cast<int32_t*>(t_lo),
                   pos, pos != nullptr ? uniq_cap : 0,
                   static_cast<int32_t*>(n_new),
                   static_cast<cudaStream_t>(stream));
}

// g_hi / g_lo / g_pos: int32[m], the gathered tables; perm1: int64[m],
// their stable order by (hi, lo, pos); gseg: int32[m]; first_by_u:
// int32[m] (INT32_MAX past the head count); n_unique: one int32.
extern "C" int mesh_merge_heads(const void* g_hi, const void* g_lo,
                                const void* g_pos, const void* perm1,
                                long long m, void* scratch, void* gseg,
                                void* first_by_u, void* n_unique,
                                void* stream) {
  const Lanes a{static_cast<const uint32_t*>(g_hi),
                static_cast<const uint32_t*>(g_lo), 1};
  return head_scan(a, static_cast<const long long*>(perm1), m,
                   static_cast<long long*>(scratch),
                   static_cast<int32_t*>(gseg),
                   static_cast<const int32_t*>(g_pos), 0, nullptr, nullptr,
                   static_cast<int32_t*>(first_by_u), m,
                   static_cast<int32_t*>(n_unique),
                   static_cast<cudaStream_t>(stream));
}

// perm2: int64[m], the stable order of first_by_u; inv: int32[m] scratch;
// remap: int32[m], the code of every gathered slot (-1: sentinel).
extern "C" int mesh_merge_remap(const void* g_hi, const void* g_lo,
                                const void* perm1, const void* gseg,
                                const void* perm2, long long m, void* inv,
                                void* remap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const Lanes a{static_cast<const uint32_t*>(g_hi),
                static_cast<const uint32_t*>(g_lo), 1};
  int32_t* iv = static_cast<int32_t*>(inv);
  invert<<<blocks(m), kBlock, 0, s>>>(static_cast<const long long*>(perm2), m,
                                      iv);
  remap_slots<<<blocks(m), kBlock, 0, s>>>(
      a, static_cast<const long long*>(perm1),
      static_cast<const int32_t*>(gseg), m, iv, static_cast<int32_t*>(remap));
  return static_cast<int>(cudaGetLastError());
}

// rows / perm / lseg of one shard (as mesh_local_uniques), remap: int32
// [uniq_cap], the shard's window of the merged remap; codes: int32[n].
extern "C" int mesh_remap_rows(const void* rows, const void* perm,
                               const void* lseg, long long n,
                               const void* remap, long long uniq_cap,
                               void* codes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  remap_rows<<<blocks(n), kBlock, 0, s>>>(
      static_cast<const uint32_t*>(rows), static_cast<const long long*>(perm),
      static_cast<const int32_t*>(lseg), n,
      static_cast<const int32_t*>(remap), uniq_cap,
      static_cast<int32_t*>(codes));
  return static_cast<int>(cudaGetLastError());
}
