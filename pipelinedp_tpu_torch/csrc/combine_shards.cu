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
// kernels.py:369 sharded_sweep) take the same plain entry.
//
// The caller stacks the D shards' partials on one device as [D, M]
// (parallel/collectives.gather: on a mesh whose slots share a card the
// stack is one copy of each shard's columns, across cards a peer copy);
// one thread a column walks the D values.
//
//  * combine_shards: int32, int64, float32 or float64, folded in shard
//    order 0..D-1 ((p0 + p1) + p2 ...). Integer sums are exact (and wrap
//    as XLA's int32 psum wraps); float sums take the shard order, where
//    XLA's CPU all-reduce takes its own (the tests state the bound).
//  * combine_shards_compensated: float32 (hi, lo) pairs, starting from
//    (p_s, 0), combined in the association of associative_scan's last
//    element: pairs of neighbours, then the pairs' scan, an odd tail
//    folded on the right (segment_ops._associative_scan's tree), and
//    hi + lo rounded once. TwoSum is not associative in its low word, so
//    only this tree gives the JAX package's bits.
//
// Bound: bytes, (D + 1) * M * element size over 3.35 TB/s. At the main
// path's shapes (D = 4, M = 17,770 x 6 columns, 2.1 MB) that is under a
// microsecond: the kernel is launch-bound, and the design spends nothing
// on it beyond coalesced column reads (thread j reads column j of every
// shard: neighbouring threads, neighbouring addresses).
#include "common.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr int kBlock = 256;

template <typename T>
__global__ void fold_shards(const T* __restrict__ stack, int n_shards,
                            long long m, T* __restrict__ out) {
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < m; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    T acc = stack[j];
    for (int s = 1; s < n_shards; ++s) acc = acc + stack[s * m + j];
    out[j] = acc;
  }
}

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

__global__ void fold_shards_compensated(const float* __restrict__ stack,
                                        int n_shards, long long m,
                                        float* __restrict__ out) {
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < m; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    float hi[kMaxShards], lo[kMaxShards];
    float tail_hi[8], tail_lo[8];  // one odd tail a halving: log2(64) + 1
    for (int s = 0; s < n_shards; ++s) {
      hi[s] = stack[s * m + j];
      lo[s] = 0.0f;
    }
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
    out[j] = h + l;
  }
}

unsigned grid_for(long long m) {
  const long long blocks = (m + kBlock - 1) / kBlock;
  return static_cast<unsigned>(blocks < 65535 * 8 ? (blocks > 0 ? blocks : 1)
                                                  : 65535 * 8);
}

}  // namespace

// stack: [n_shards, m] of dtype_code (0 int32, 1 int64, 2 float32,
// 3 float64), contiguous; out: [m] of the same type.
extern "C" int combine_shards(const void* stack, int n_shards, long long m,
                              int dtype_code, void* out, void* stream) {
  if (m <= 0) return 0;
  if (n_shards < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(m);
  switch (dtype_code) {
    case 0:
      fold_shards<int32_t><<<grid, kBlock, 0, st>>>(
          static_cast<const int32_t*>(stack), n_shards, m,
          static_cast<int32_t*>(out));
      break;
    case 1:
      fold_shards<long long><<<grid, kBlock, 0, st>>>(
          static_cast<const long long*>(stack), n_shards, m,
          static_cast<long long*>(out));
      break;
    case 2:
      fold_shards<float><<<grid, kBlock, 0, st>>>(
          static_cast<const float*>(stack), n_shards, m,
          static_cast<float*>(out));
      break;
    case 3:
      fold_shards<double><<<grid, kBlock, 0, st>>>(
          static_cast<const double*>(stack), n_shards, m,
          static_cast<double*>(out));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// stack: float32 [n_shards, m] (n_shards <= 64); out: float32 [m].
extern "C" int combine_shards_compensated(const void* stack, int n_shards,
                                          long long m, void* out,
                                          void* stream) {
  if (m <= 0) return 0;
  if (n_shards < 1 || n_shards > kMaxShards)
    return static_cast<int>(cudaErrorInvalidValue);
  fold_shards_compensated<<<grid_for(m), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stack), n_shards, m,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
