// C21 combine_shards: the cross-shard sum of the shards' partial columns.
//
// Replaces K21's collectives, pipelinedp_tpu/parallel/sharded.py
// _combine_partials (:161): the lax.psum of every per-shard partial column
// (count / pid_count / sum / nsum / nsum2 / vsum, the selection's counts)
// and, in numeric_mode="safe" for float32, segment_ops.compensated_psum
// (pipelinedp_tpu/ops/segment_ops.py:160: an all_gather over the shard
// axis folded through the TwoSum combiner _comp_combine, :108, by
// jax.lax.associative_scan); and the int32 psums of the quantile counts
// inside executor.py (:807 the lazy regime's child counts, :875 the dense
// regime's leaf histogram). The analysis sweep's psums (analysis/
// kernels.py:369 sharded_sweep) take the same plain entry, and K23c's
// heartbeat (parallel/mesh.py:150) the int32 one.
//
// combine_parts reads each shard's columns where they lie: part (s, c),
// shard s's column c, is a contiguous run of one dtype, and the D x C
// (pointer, length) table goes by value in the kernel's parameters
// (__grid_constant__, read in place). One launch writes every output
// column; a table larger than the parameter space launches once per group
// of whole columns. The callers no longer concatenate a shard's columns
// or stack the shards (parallel/collectives.psum_columns), and the
// [D, M] stack entries (kernels.combine_shards, heartbeat_sum) pass the
// stack's D rows as the parts of one column.
//
// Each column's elements split into slots: a vector slot of 16 bytes
// (4 4-byte or 2 8-byte elements) where the D parts and the output share
// their address modulo 16, single elements for the column's head up to
// that alignment, for its ragged tail (17,770 % 4 = 2) and for a column
// whose parts are aligned apart. The blocks take equal chunks of the
// columns' joined slot space, at most 16 a streaming multiprocessor, so
// the grid fills the card at any size. Every element is folded by the
// same sequence, whatever its slot, its block or the grouping:
//
//  * plain: int32, int64, float32 or float64, in shard order 0..D-1
//    ((p0 + p1) + p2 ...). Integer sums are exact (and wrap as XLA's int32
//    psum wraps); float sums take the shard order, where XLA's CPU
//    all-reduce takes its own (the tests state the bound).
//  * compensated: float32 (hi, lo) pairs, starting from (p_s, 0),
//    combined in the association of associative_scan's last element:
//    pairs of neighbours, then the pairs' scan, an odd tail folded on the
//    right (segment_ops._associative_scan's tree), and hi + lo rounded
//    once. TwoSum is not associative in its low word, so only this tree
//    gives the JAX package's bits.
//
// Bound: bytes, (D + 1) * M * element size over 3.35 TB/s. At the main
// path's shapes (D = 4, M = 17,770 x 6 columns, 2.1 MB) that is under a
// microsecond: the combine is launch-bound, and what the design saves is
// host work and copies (one launch in place of D + 2 launches and two
// passes over the D x M values), then 16-byte reads at the larger shapes.
#include "common.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr int kMaxColumns = 32;  // output columns a launch
constexpr int kMaxParts = 256;   // D x C input pointers a launch
constexpr int kBlock = 128;
constexpr long long kMaxBlocks = 132 * 16;
// Element bytes by dtype code: 0 int32, 1 int64, 2 float32, 3 float64.
constexpr long long kElemBytes[4] = {4, 8, 4, 8};

struct PartTable {
  const void* in[kMaxParts];        // part (s, c) at in[s * n_cols + c]
  void* out[kMaxColumns];
  long long n[kMaxColumns];         // column c's elements
  long long slot_end[kMaxColumns];  // joined slot index past column c's
  long long head[kMaxColumns];      // single-element slots before its
                                    // vectors (n: none is a vector)
  int n_shards, n_cols;
};

template <typename T>
union Pack {  // one 16-byte slot
  int4 raw;
  T v[16 / sizeof(T)];
};

// Integer sums wrap (unsigned arithmetic: no signed overflow).
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ long long add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }

// _comp_combine: (h1, l1) then (h2, l2) -> (fl(h1 + h2), residue + (l1 + l2)).
__device__ __forceinline__ void comp_combine(float h1, float l1, float h2,
                                             float l2, float& h, float& l) {
  const float s = h1 + h2;
  const float bv = s - h1;
  const float av = s - bv;
  const float e = (h1 - av) + (h2 - bv);
  h = s;
  l = e + (l1 + l2);
}

// hi + lo of associative_scan's last element over the pairs (hi[s], 0),
// s < n_shards; hi is overwritten.
__device__ __forceinline__ float comp_tree(float* hi, int n_shards) {
  float lo[kMaxShards];
  float tail_hi[8], tail_lo[8];  // one odd tail a halving: log2(64) + 1
  for (int s = 0; s < n_shards; ++s) lo[s] = 0.0f;
  int n = n_shards, tails = 0;
  while (n > 1) {
    if (n & 1) {  // last(scan(e)) = fn(last(scan(pairs(e[:-1]))), e[-1])
      --n;
      tail_hi[tails] = hi[n];
      tail_lo[tails] = lo[n];
      ++tails;
    }
    for (int i = 0; i < n / 2; ++i)
      comp_combine(hi[2 * i], lo[2 * i], hi[2 * i + 1], lo[2 * i + 1],
                   hi[i], lo[i]);
    n /= 2;
  }
  float h = hi[0], l = lo[0];
  for (int t = tails - 1; t >= 0; --t)  // innermost tail first
    comp_combine(h, l, tail_hi[t], tail_lo[t], h, l);
  return h + l;
}

template <typename T, bool kCompensated>
__device__ __forceinline__ void fold_one(const PartTable& t, int c,
                                         long long e) {
  const int cols = t.n_cols;
  if constexpr (kCompensated) {
    float hi[kMaxShards];
    for (int s = 0; s < t.n_shards; ++s)
      hi[s] = __ldg(static_cast<const float*>(t.in[s * cols + c]) + e);
    static_cast<float*>(t.out[c])[e] = comp_tree(hi, t.n_shards);
  } else {
    T acc = __ldg(static_cast<const T*>(t.in[c]) + e);
    for (int s = 1; s < t.n_shards; ++s)
      acc = add(acc, __ldg(static_cast<const T*>(t.in[s * cols + c]) + e));
    static_cast<T*>(t.out[c])[e] = acc;
  }
}

template <typename T, bool kCompensated>
__device__ __forceinline__ void fold_vector(const PartTable& t, int c,
                                            long long e) {
  constexpr int kW = 16 / sizeof(T);
  const int cols = t.n_cols;
  Pack<T> acc;
  if constexpr (kCompensated) {
    Pack<float> parts[kMaxShards];
    for (int s = 0; s < t.n_shards; ++s)
      parts[s].raw = __ldg(reinterpret_cast<const int4*>(
          static_cast<const float*>(t.in[s * cols + c]) + e));
    for (int k = 0; k < kW; ++k) {
      float hi[kMaxShards];
      for (int s = 0; s < t.n_shards; ++s) hi[s] = parts[s].v[k];
      acc.v[k] = comp_tree(hi, t.n_shards);
    }
  } else {
    acc.raw = __ldg(
        reinterpret_cast<const int4*>(static_cast<const T*>(t.in[c]) + e));
    for (int s = 1; s < t.n_shards; ++s) {
      Pack<T> p;
      p.raw = __ldg(reinterpret_cast<const int4*>(
          static_cast<const T*>(t.in[s * cols + c]) + e));
#pragma unroll
      for (int k = 0; k < kW; ++k) acc.v[k] = add(acc.v[k], p.v[k]);
    }
  }
  *reinterpret_cast<int4*>(static_cast<T*>(t.out[c]) + e) = acc.raw;
}

// Block b folds the joined slots [b * per_block, (b + 1) * per_block).
template <typename T, bool kCompensated>
__global__ void fold_parts(const __grid_constant__ PartTable t,
                           long long n_slots, long long per_block) {
  constexpr long long kW = 16 / sizeof(T);
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const long long last =
      first + per_block < n_slots ? first + per_block : n_slots;
  int c = 0;
  long long col_start = 0;
  for (long long j = first + threadIdx.x; j < last; j += blockDim.x) {
    while (j >= t.slot_end[c]) col_start = t.slot_end[c++];
    const long long k = j - col_start;
    const long long head = t.head[c];
    const long long vectors = (t.n[c] - head) / kW;
    if (k >= head && k < head + vectors)
      fold_vector<T, kCompensated>(t, c, head + (k - head) * kW);
    else
      fold_one<T, kCompensated>(
          t, c, k < head ? k : head + vectors * kW + (k - head - vectors));
  }
}

template <typename T, bool kCompensated>
int launch(const PartTable& t, long long n_slots, cudaStream_t st) {
  if (n_slots <= 0) return 0;
  long long blocks = (n_slots + kBlock - 1) / kBlock;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  const long long per_block = (n_slots + blocks - 1) / blocks;
  blocks = (n_slots + per_block - 1) / per_block;
  fold_parts<T, kCompensated><<<static_cast<unsigned>(blocks), kBlock, 0,
                                st>>>(t, n_slots, per_block);
  return static_cast<int>(cudaGetLastError());
}

// One launch over the group of columns [c0, c0 + cols) of the parts
// in[s * n_cols + c], writing out[c] (n[c] elements each).
int launch_group(const long long* in, const long long* out,
                 const long long* n, int n_shards, int n_cols, int c0,
                 int cols, int dtype_code, bool compensated,
                 cudaStream_t st) {
  const long long size = kElemBytes[dtype_code];
  const long long width = 16 / size;
  PartTable t{};
  t.n_shards = n_shards;
  t.n_cols = cols;
  long long slots = 0;
  for (int c = 0; c < cols; ++c) {
    const long long m = n[c0 + c];
    const long long mis = out[c0 + c] & 15;
    bool aligned = mis % size == 0;
    for (int s = 0; s < n_shards; ++s) {
      const long long p = in[static_cast<long long>(s) * n_cols + c0 + c];
      t.in[s * cols + c] = reinterpret_cast<const void*>(p);
      aligned = aligned && (p & 15) == mis;
    }
    t.out[c] = reinterpret_cast<void*>(out[c0 + c]);
    t.n[c] = m;
    long long head = aligned ? ((16 - mis) & 15) / size : m;
    head = head < m ? head : m;
    t.head[c] = head;
    slots += m - (m - head) / width * (width - 1);
    t.slot_end[c] = slots;
  }
  switch (dtype_code) {
    case 0:
      return launch<int32_t, false>(t, slots, st);
    case 1:
      return launch<long long, false>(t, slots, st);
    case 2:
      return compensated ? launch<float, true>(t, slots, st)
                         : launch<float, false>(t, slots, st);
    default:
      return launch<double, false>(t, slots, st);
  }
}

bool valid(int n_shards, int dtype_code, int compensated) {
  return n_shards >= 1 && n_shards <= kMaxShards && dtype_code >= 0 &&
         dtype_code <= 3 && (!compensated || dtype_code == 2);
}

}  // namespace

// table: the D x C parts' addresses, shard-major (part (s, c) at
// table[s * n_cols + c]), then the C output columns' addresses, then each
// column's elements (int64[(D + 2) * C]). dtype_code 0 int32, 1 int64,
// 2 float32, 3 float64; compensated (float32 only) takes the TwoSum tree.
// Launches once per group of min(32, 256 / D) columns.
extern "C" int combine_parts(const long long* table, int n_shards,
                             int n_cols, int dtype_code, int compensated,
                             void* stream) {
  if (!valid(n_shards, dtype_code, compensated) || n_cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long parts = static_cast<long long>(n_shards) * n_cols;
  const int group = kMaxParts / n_shards < kMaxColumns
                        ? kMaxParts / n_shards
                        : kMaxColumns;
  for (int c0 = 0; c0 < n_cols; c0 += group) {
    const int status = launch_group(
        table, table + parts, table + parts + n_cols, n_shards, n_cols, c0,
        n_cols - c0 < group ? n_cols - c0 : group, dtype_code,
        compensated != 0, static_cast<cudaStream_t>(stream));
    if (status != 0) return status;
  }
  return 0;
}

// stack: [n_shards, m] contiguous, its rows the parts of one column;
// out: [m]. The launch of combine_parts over those parts.
extern "C" int combine_stack(const void* stack, int n_shards, long long m,
                             int dtype_code, int compensated, void* out,
                             void* stream) {
  if (!valid(n_shards, dtype_code, compensated) || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row = m * kElemBytes[dtype_code];
  long long in[kMaxShards];
  for (int s = 0; s < n_shards; ++s)
    in[s] = reinterpret_cast<long long>(stack) + s * row;
  const long long dst = reinterpret_cast<long long>(out);
  return launch_group(in, &dst, &m, n_shards, 1, 0, 1, dtype_code,
                      compensated != 0, static_cast<cudaStream_t>(stream));
}
