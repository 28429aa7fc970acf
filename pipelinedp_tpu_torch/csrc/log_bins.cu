// C18 log_bins: the binning of the dataset histograms.
//
// Replaces the binning of K20, pipelinedp_tpu/dataset_histograms/
// device_histograms.py:
//   * log_bins_int: _bin_int_kernel (:66) with _log_bin_bounds (:45), the
//     3-leading-digit log histogram of an int32 stat over the rows its mask
//     selects: per bin lower, upper, count, sum and max, compacted to the
//     front in ascending lower, and the number of bins;
//   * log_bins_float: _bin_float_kernel (:108), the equal-width histogram of
//     10,000 buckets between the min and max of a float32 stat: lo, hi and
//     per bucket count, float32 sum and max.
//
// The JAX package sorts the rows once per integer histogram. Here no sort
// is needed: a value's bin follows from its bounds, computed in the same
// pure int32 arithmetic (power-of-ten table, the is_pow10 case, the
// decade-wide bin at an exact bound), and the bin's lower maps to a slot:
// lowers 1..1000 to slots 0..999, and above 1000 the lower m * 10^(e-2)
// (m in 100..999, e = floor(log10 lower)) to 1000 + (e - 3) * 900 + m - 101,
// ascending with the lower; 6,514 slots cover int32. Each block keeps the
// slots' count, int64 sum and max in shared memory, adds its non-empty
// slots into the global ones, and one block compacts the non-empty slots
// in slot order. Bin sums are exact int64 (the JAX package's device path
// sums float32 cumsum differences, exact while a bin's sum is below 2^24;
// its host path is exact).
//
// The float histogram's edges reproduce jnp.linspace(lo, hi, 10001) in
// float32 as XLA compiles it for the CPU: step_i = 1 - i * c and
// edge_i = i * (hi * c) + lo * step_i, each with one rounding (fused
// multiply-adds, c = float32(1 / 10000)), the last edge hi. A row's
// bucket is searchsorted(edges, v, side="right") - 1, clipped, by a
// binary search over the edges in shared memory; counts and maxes are
// exact. A bucket's sum is added in float64 (shared-memory, then global
// atomics) and rounded once to float32: the float32 of the bucket's sum up
// to float64 rounding in another order, where the JAX package adds the
// float32 values one at a time (which drifts once a sum passes 2^24).
//
// Bound: bytes. Each row's value and mask are read once (the float entry
// twice: one pass for the min and max); the outputs are a few thousand
// words. Same-bin atomics of skewed stats are absorbed in shared memory.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kSlots = 6514;
constexpr int kBinThreads = 1024;
constexpr int kBinBlocks = 132;  // one per SM of an H100 SXM

__constant__ int32_t kPow10[10] = {1,      10,      100,      1000,
                                   10000,  100000,  1000000,  10000000,
                                   100000000, 1000000000};

// (lower, upper) of the 3-leading-digit bin of v >= 1, as
// _log_bin_bounds computes them in int32 (the upper wraps as XLA's int32
// add does near 2^31).
__device__ __forceinline__ void bin_bounds(int32_t v, int32_t* lower,
                                           int32_t* upper) {
  int d = 0;
#pragma unroll
  for (int k = 0; k < 10; ++k) d += v >= kPow10[k] ? 1 : 0;
  const bool is_pow10 = v == kPow10[min(d - 1, 9)];
  int e = is_pow10 ? d - 1 : d;
  e = max(e, 3);
  const int32_t base = kPow10[min(e - 3, 7)];
  const int32_t lo = v / base * base;
  const bool at_bound = e <= 9 && v == kPow10[min(e, 9)];
  const int32_t size = at_bound ? base * 10 : base;
  *lower = lo;
  *upper = static_cast<int32_t>(static_cast<uint32_t>(lo) +
                                static_cast<uint32_t>(size));
}

__device__ __forceinline__ int slot_of(int32_t lower) {
  if (lower <= 1000) return lower - 1;
  int e = 3;
  while (e < 9 && lower >= kPow10[e + 1]) ++e;
  const int32_t m = lower / kPow10[e - 2];
  return 1000 + (e - 3) * 900 + m - 101;
}

__device__ __forceinline__ int32_t lower_of(int slot) {
  if (slot < 1000) return slot + 1;
  const int u = slot - 999;  // 1 ...
  const int e = 3 + u / 900;
  const int32_t m = u % 900 + 100;
  return m * kPow10[e - 2];
}

__global__ void init_int(unsigned long long* count, unsigned long long* sum,
                         int32_t* mx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kSlots) return;
  count[i] = 0ull;
  sum[i] = 0ull;
  mx[i] = INT32_MIN;
}

__global__ void bin_int(const int32_t* __restrict__ values,
                        const uint8_t* __restrict__ mask, long long n,
                        unsigned long long* __restrict__ g_count,
                        unsigned long long* __restrict__ g_sum,
                        int32_t* __restrict__ g_max) {
  extern __shared__ unsigned long long smem_int[];
  unsigned long long* s_sum = smem_int;
  unsigned* s_count = reinterpret_cast<unsigned*>(s_sum + kSlots);
  int32_t* s_max = reinterpret_cast<int32_t*>(s_count + kSlots);
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    s_sum[i] = 0ull;
    s_count[i] = 0u;
    s_max[i] = INT32_MIN;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    if (!mask[r]) continue;
    const int32_t v = values[r];
    int32_t lower, upper;
    bin_bounds(v > 1 ? v : 1, &lower, &upper);
    const int slot = slot_of(lower);
    atomicAdd(&s_count[slot], 1u);
    atomicAdd(&s_sum[slot],
              static_cast<unsigned long long>(static_cast<long long>(v)));
    atomicMax(&s_max[slot], v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    if (s_count[i] == 0u) continue;
    atomicAdd(&g_count[i], static_cast<unsigned long long>(s_count[i]));
    atomicAdd(&g_sum[i], s_sum[i]);
    atomicMax(&g_max[i], s_max[i]);
  }
}

// One block: the non-empty slots, in slot order, to the front of the
// outputs; zeros after them; the bin count to n_bins.
__global__ void compact_int(const unsigned long long* __restrict__ g_count,
                            const unsigned long long* __restrict__ g_sum,
                            const int32_t* __restrict__ g_max,
                            int32_t* __restrict__ lowers,
                            int32_t* __restrict__ uppers,
                            long long* __restrict__ counts,
                            long long* __restrict__ sums,
                            int32_t* __restrict__ maxes,
                            long long* __restrict__ n_bins) {
  __shared__ long long smem[32];
  long long carry = 0;
  for (int base = 0; base < kSlots; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool full = i < kSlots && g_count[i] > 0ull;
    long long chunk;
    const long long excl = pdp::block_exclusive_scan<pdp::SumOp<long long>>(
        full ? 1 : 0, smem, &chunk);
    if (full) {
      const long long o = carry + excl;
      int32_t lower, upper;
      bin_bounds(lower_of(i), &lower, &upper);
      lowers[o] = lower;
      uppers[o] = upper;
      counts[o] = static_cast<long long>(g_count[i]);
      sums[o] = static_cast<long long>(g_sum[i]);
      maxes[o] = g_max[i];
    }
    carry += chunk;
  }
  for (long long o = carry + threadIdx.x; o < kSlots; o += blockDim.x) {
    lowers[o] = 0;
    uppers[o] = 0;
    counts[o] = 0;
    sums[o] = 0;
    maxes[o] = 0;
  }
  if (threadIdx.x == 0) *n_bins = carry;
}

// Float atomics by the order of the bit patterns: non-negative floats
// order as signed ints, negative ones inversely as unsigned ints.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (v >= 0.0f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__global__ void init_float(int n_buckets, float* lo_hi, int32_t* counts,
                           double* sums64, float* maxes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    lo_hi[0] = FLT_MAX;
    lo_hi[1] = -FLT_MAX;
  }
  if (i >= n_buckets) return;
  counts[i] = 0;
  sums64[i] = 0.0;
  maxes[i] = -FLT_MAX;
}

__global__ void round_sums(int n_buckets, const double* __restrict__ sums64,
                           float* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_buckets) sums[i] = static_cast<float>(sums64[i]);
}

__global__ void min_max(const float* __restrict__ values,
                        const uint8_t* __restrict__ mask, long long n,
                        float* __restrict__ lo_hi) {
  float lo = FLT_MAX, hi = -FLT_MAX;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    if (!mask[r]) continue;
    const float v = values[r];
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  for (int d = 16; d > 0; d >>= 1) {
    lo = fminf(lo, __shfl_down_sync(pdp::kFullMask, lo, d));
    hi = fmaxf(hi, __shfl_down_sync(pdp::kFullMask, hi, d));
  }
  if ((threadIdx.x & 31) == 0) {
    atomic_min_float(&lo_hi[0], lo);
    atomic_max_float(&lo_hi[1], hi);
  }
}

// edges[i] for i < n_buckets as XLA's CPU code computes jnp.linspace in
// float32 (see the header); edges[n_buckets] = hi.
__device__ __forceinline__ float edge(int i, int n_buckets, float lo,
                                      float hi, float c) {
  if (i == n_buckets) return hi;
  const float fi = static_cast<float>(i);
  const float step = __fmaf_rn(-fi, c, 1.0f);
  return __fmaf_rn(fi, __fmul_rn(hi, c), __fmul_rn(lo, step));
}

__global__ void bin_float(const float* __restrict__ values,
                          const uint8_t* __restrict__ mask, long long n,
                          int n_buckets, float c,
                          const float* __restrict__ lo_hi,
                          float* __restrict__ edges_out,
                          int32_t* __restrict__ g_count,
                          double* __restrict__ g_sum,
                          float* __restrict__ g_max) {
  extern __shared__ double smem_f[];
  double* s_sum = smem_f;                                // n_buckets
  float* s_edges = reinterpret_cast<float*>(s_sum + n_buckets);  // + 1
  float* s_max = s_edges + n_buckets + 1;
  unsigned* s_count = reinterpret_cast<unsigned*>(s_max + n_buckets);
  const float lo = lo_hi[0], hi = lo_hi[1];
  for (int i = threadIdx.x; i <= n_buckets; i += blockDim.x) {
    s_edges[i] = edge(i, n_buckets, lo, hi, c);
    if (blockIdx.x == 0) edges_out[i] = s_edges[i];
    if (i < n_buckets) {
      s_sum[i] = 0.0;
      s_max[i] = -FLT_MAX;
      s_count[i] = 0u;
    }
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    if (!mask[r]) continue;
    const float v = values[r];
    int a = 0, b = n_buckets + 1;  // first edge > v
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (s_edges[mid] <= v)
        a = mid + 1;
      else
        b = mid;
    }
    const int idx = min(max(a - 1, 0), n_buckets - 1);
    atomicAdd(&s_count[idx], 1u);
    atomicAdd(&s_sum[idx], static_cast<double>(v));
    atomic_max_float(&s_max[idx], v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_buckets; i += blockDim.x) {
    if (s_count[i] == 0u) continue;
    atomicAdd(&g_count[i], static_cast<int32_t>(s_count[i]));
    atomicAdd(&g_sum[i], s_sum[i]);
    atomic_max_float(&g_max[i], s_max[i]);
  }
}

size_t float_smem(int n_buckets) {
  return static_cast<size_t>(n_buckets) * sizeof(double) +
         static_cast<size_t>(3 * n_buckets + 1) * sizeof(float);
}

}  // namespace

// Scratch: 2 * kSlots u64 + kSlots int32 (kSlots = kernels.LOG_BIN_SLOTS).
extern "C" long long log_bins_int_scratch_bytes() {
  return static_cast<long long>(kSlots) * (2 * 8 + 4);
}

// values: int32[n]; mask: u8[n]. Outputs of kSlots entries, the first
// *n_bins the bins in ascending lower, zeros after: lowers, uppers, maxes
// int32; counts, sums int64; n_bins: one int64.
extern "C" int log_bins_int(const void* values, const void* mask, long long n,
                            void* scratch, void* lowers, void* uppers,
                            void* counts, void* sums, void* maxes,
                            void* n_bins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* g_count = static_cast<unsigned long long*>(scratch);
  unsigned long long* g_sum = g_count + kSlots;
  int32_t* g_max = reinterpret_cast<int32_t*>(g_sum + kSlots);
  const size_t smem = static_cast<size_t>(kSlots) * (8 + 4 + 4);
  cudaError_t err = cudaFuncSetAttribute(
      bin_int, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  init_int<<<(kSlots + 255) / 256, 256, 0, s>>>(g_count, g_sum, g_max);
  if (n > 0) {
    bin_int<<<kBinBlocks, kBinThreads, smem, s>>>(
        static_cast<const int32_t*>(values), static_cast<const uint8_t*>(mask),
        n, g_count, g_sum, g_max);
  }
  compact_int<<<1, 1024, 0, s>>>(
      g_count, g_sum, g_max, static_cast<int32_t*>(lowers),
      static_cast<int32_t*>(uppers), static_cast<long long*>(counts),
      static_cast<long long*>(sums), static_cast<int32_t*>(maxes),
      static_cast<long long*>(n_bins));
  return static_cast<int>(cudaGetLastError());
}

// values: float32[n]; mask: u8[n]; c: float32(1 / n_buckets); scratch:
// float64[n_buckets]. Outputs: lo_hi float32[2]; edges float32[n_buckets +
// 1]; counts int32, sums and maxes float32 [n_buckets].
extern "C" int log_bins_float(const void* values, const void* mask,
                              long long n, int n_buckets, float c,
                              void* scratch, void* lo_hi, void* edges,
                              void* counts, void* sums, void* maxes,
                              void* stream) {
  if (n_buckets < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = float_smem(n_buckets);
  cudaError_t err = cudaFuncSetAttribute(
      bin_float, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* lh = static_cast<float*>(lo_hi);
  double* sums64 = static_cast<double*>(scratch);
  const unsigned grid = (n_buckets + 255) / 256;
  init_float<<<grid, 256, 0, s>>>(n_buckets, lh,
                                  static_cast<int32_t*>(counts), sums64,
                                  static_cast<float*>(maxes));
  const float* v = static_cast<const float*>(values);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (n > 0) {
    min_max<<<kBinBlocks * 4, 256, 0, s>>>(v, m, n, lh);
  }
  bin_float<<<kBinBlocks, kBinThreads, smem, s>>>(
      v, m, n, n_buckets, c, lh, static_cast<float*>(edges),
      static_cast<int32_t*>(counts), sums64, static_cast<float*>(maxes));
  round_sums<<<grid, 256, 0, s>>>(n_buckets, sums64,
                                  static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}
