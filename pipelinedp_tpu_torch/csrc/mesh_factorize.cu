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
// The JAX kernel sorts each shard, all-gathers the compacted unique tables
// with their first positions, sorts the gathered table twice in a merge
// replicated on every shard, and scatters the codes back. Here nothing is
// sorted; C12's hash table (csrc/factorize_codes.cu) does the grouping:
//   1. the local phase, one C12 run a shard (kernels.mesh_local_uniques):
//      each row's local code, the rank of its hash among the shard's
//      distinct hashes by first row, n_new (the unique-cap count), and
//      C12's heads table: slot k holds the hash rows' lanes (hi, lo, 1)
//      of the shard's k-th distinct hash by first row, the sentinel row
//      past n_new. One run serves the count and the table phase.
//   2. the merge, one C12 run on the gathering device over the gathered
//      [D x uniq_cap] slots (kernels.mesh_merge_ranks). The shards hold
//      consecutive global positions in shard order, and a shard's slots
//      hold its hashes in first-row order, so the gathered slots list
//      every shard's distinct hashes in the order of their first global
//      position on that shard. A hash's first gathered slot is therefore
//      its global first occurrence, and two hashes' first slots are in the
//      order of their global first positions: C12's first-row codes of the
//      gathered slots are the global codes (sentinel pads code to -1), and
//      its count is n_unique.
//   3. the remap, this file, one launch a shard:
//      codes[r] = lcode[r] < 0 ? -1 : window[lcode[r]], where window is
//      the shard's [uniq_cap] slice of the merge's codes. Sentinel and
//      invalid rows have local code -1.
//
// Bound: bytes. The remap reads a local code and writes a code a row (8 B)
// and gathers from the window (uniq_cap * 4 B, held in L2).
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kItems = 4;  // consecutive codes a thread, one 16-byte access

__global__ void __launch_bounds__(kBlock)
    remap_codes(const int32_t* __restrict__ lcode, long long n,
                const int32_t* __restrict__ window, long long cap,
                int32_t* __restrict__ codes) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) * kItems;
  if (i >= n) return;
  if (i + kItems <= n) {
    const int4 u = __ldcs(reinterpret_cast<const int4*>(lcode + i));
    int4 c;
    c.x = u.x < 0 || u.x >= cap ? -1 : __ldg(window + u.x);
    c.y = u.y < 0 || u.y >= cap ? -1 : __ldg(window + u.y);
    c.z = u.z < 0 || u.z >= cap ? -1 : __ldg(window + u.z);
    c.w = u.w < 0 || u.w >= cap ? -1 : __ldg(window + u.w);
    __stcs(reinterpret_cast<int4*>(codes + i), c);
    return;
  }
  for (long long j = i; j < n; ++j) {
    const int32_t u = lcode[j];
    codes[j] = u < 0 || u >= cap ? -1 : window[u];
  }
}

}  // namespace

// lcode: int32[n], one shard's local codes (mesh_local_uniques); window:
// int32[uniq_cap], the shard's slice of the merged codes; codes: int32[n].
// lcode and codes 16-byte aligned.
extern "C" int mesh_remap_codes(const void* lcode, long long n,
                                const void* window, long long uniq_cap,
                                void* codes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if ((reinterpret_cast<uintptr_t>(lcode) | reinterpret_cast<uintptr_t>(
           codes)) % 16 != 0)
    return -1;
  const long long per_block = static_cast<long long>(kBlock) * kItems;
  remap_codes<<<static_cast<unsigned>((n + per_block - 1) / per_block),
                kBlock, 0, s>>>(static_cast<const int32_t*>(lcode), n,
                                static_cast<const int32_t*>(window),
                                uniq_cap, static_cast<int32_t*>(codes));
  return static_cast<int>(cudaGetLastError());
}
