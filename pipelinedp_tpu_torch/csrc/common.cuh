// Device helpers shared by the port's kernels (sm_90a, built with
// --fmad=false: no multiply-add contraction, so every float expression
// rounds where the JAX package's XLA program rounds it).
//
//  * threefry2x32 and JAX's uniform / normal / laplace transforms, bit-for-bit
//    on the random words (pipelinedp_tpu_torch/ops/threefry.py is the plain
//    twin; jax/_src/prng.py and jax/_src/random.py are the reference);
//  * jax.random.fold_in and jax.random.bits on the device;
//  * XLA's erf_inv polynomial (Giles);
//  * the secure-noise release (K13: snap to a power-of-two grid plus a
//    discrete atom found by a 64-bit inverse-CDF table search), shared by
//    release_epilogue.cu, quantile_descend.cu and vector_release.cu;
//  * NaN-propagating max / min (jnp.maximum / jnp.minimum), the release
//    sentinel's flag bits of a value and their block-wide OR;
//  * a block-wide exclusive scan over an associative operator and a
//    block's in-place scan of many values (reshard_count.cu's send
//    counts), with integer-sum and max operators;
//  * the decoupled look-back of the one-pass tile scans (tile aggregates
//    and inclusive prefixes published under release / acquire flags),
//    shared by reduce_partitions.cu, bound_rows.cu, group_stats.cu and
//    factorize_codes.cu, with the scan state the last three carve from
//    their scratch (Scan, claim_tile, tile_prefix).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pdp {

constexpr int kThreads = 256;   // threads per block of the tile scans
constexpr int kItems = 8;       // consecutive rows per thread
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, on the counter words (x0, x1). Also a host
// function, so a launch can derive a slot's keys once (secure_key).
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0,
                                                      uint32_t k1,
                                                      uint32_t& x0,
                                                      uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[s & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(s + 1) % 3];
    x1 += ks[(s + 2) % 3] + static_cast<uint32_t>(s + 1);
  }
}

// jax.random.fold_in(key, data): the key hashed on the counter (0, data).
__host__ __device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1,
                                                 uint32_t data, uint32_t& o0,
                                                 uint32_t& o1) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  o0 = x0;
  o1 = x1;
}

// Element i of jax.random.bits(key, shape, uint32): the partitionable
// layout hashes the counter pair (i >> 32, i & 0xffffffff); the word is
// x0 ^ x1.
__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1,
                                           uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// Floats in [0, 1) from element i of a draw under key (k0, k1): JAX's
// partitionable layout hashes the counter pair (i >> 32, i & 0xffffffff);
// a 32-bit word is x0 ^ x1, a 64-bit word x0 << 32 | x1. The mantissa is
// filled from the word's top bits under exponent 0, then 1 is subtracted.
template <typename F>
__device__ __forceinline__ F unit_float(uint32_t k0, uint32_t k1, uint64_t i);

template <>
__device__ __forceinline__ float unit_float<float>(uint32_t k0, uint32_t k1,
                                                   uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return __uint_as_float(bits) - 1.0f;
}

template <>
__device__ __forceinline__ double unit_float<double>(uint32_t k0, uint32_t k1,
                                                     uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  const uint64_t word = (static_cast<uint64_t>(x0) << 32) | x1;
  const uint64_t bits = (word >> 12) | 0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(bits)) - 1.0;
}

// jax.random.uniform(key, shape, F, lo, hi)[i]: max(lo, u * (hi - lo) + lo).
template <typename F>
__device__ __forceinline__ F uniform(uint32_t k0, uint32_t k1, uint64_t i,
                                     F lo, F hi) {
  const F u = unit_float<F>(k0, k1, i);
  const F r = u * (hi - lo) + lo;
  return r > lo ? r : lo;
}

// -1 + epsneg of F, the low end of JAX's normal and laplace uniforms (it
// equals nextafter(-1, 0) in both widths).
template <typename F> __device__ __forceinline__ F open_low();
template <> __device__ __forceinline__ float open_low<float>() {
  return -1.0f + 5.9604645e-08f;
}
template <> __device__ __forceinline__ double open_low<double>() {
  return -1.0 + 1.1102230246251565e-16;
}

__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// XLA's erf_inv (ErfInv32): Giles' single-precision polynomial.
__device__ __forceinline__ float erf_inv(float x) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                        -0.00417768164f, 0.246640727f, 1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f, 0.00573950773f, -0.0076224613f,
                        0.00943887047f, 1.00167406f, 2.83297682f};
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7f800000) : p * x;
}

// XLA's erf_inv (ErfInv64): Giles' double-precision polynomials.
__device__ __forceinline__ double erf_inv(double x) {
  const double a[23] = {
      -3.6444120640178196996e-21, -1.685059138182016589e-19,
      1.2858480715256400167e-18,  1.115787767802518096e-17,
      -1.333171662854620906e-16,  2.0972767875968561637e-17,
      6.6376381343583238325e-15,  -4.0545662729752068639e-14,
      -8.1519341976054721522e-14, 2.6335093153082322977e-12,
      -1.2975133253453532498e-11, -5.4154120542946279317e-11,
      1.051212273321532285e-09,   -4.1126339803469836976e-09,
      -2.9070369957882005086e-08, 4.2347877827932403518e-07,
      -1.3654692000834678645e-06, -1.3882523362786468719e-05,
      0.0001867342080340571352,   -0.00074070253416626697512,
      -0.0060336708714301490533,  0.24015818242558961693,
      1.6536545626831027356};
  const double b[19] = {
      2.2137376921775787049e-09,  9.0756561938885390979e-08,
      -2.7517406297064545428e-07, 1.8239629214389227755e-08,
      1.5027403968909827627e-06,  -4.013867526981545969e-06,
      2.9234449089955446044e-06,  1.2475304481671778723e-05,
      -4.7318229009055733981e-05, 6.8284851459573175448e-05,
      2.4031110387097893999e-05,  -0.0003550375203628474796,
      0.00095328937973738049703,  -0.0016882755560235047313,
      0.0024914420961078508066,   -0.0037512085075692412107,
      0.005370914553590063617,    1.0052589676941592334,
      3.0838856104922207635};
  const double c[17] = {
      -2.7109920616438573243e-11, -2.5556418169965252055e-10,
      1.5076572693500548083e-09,  -3.7894654401267369937e-09,
      7.6157012080783393804e-09,  -1.4960026627149240478e-08,
      2.9147953450901080826e-08,  -6.7711997758452339498e-08,
      2.2900482228026654717e-07,  -9.9298272942317002539e-07,
      4.5260625972231537039e-06,  -1.9681778105531670567e-05,
      7.5995277030017761139e-05,  -0.00021503011930044477347,
      -0.00013871931833623122026, 1.0103004648645343977,
      4.8499064014085844221};
  double w = -log1p(x * -x);
  const bool lt625 = w < 6.25, lt16 = w < 16.0;
  w = lt625 ? w - 3.125 : sqrt(w) - (lt16 ? 3.25 : 5.0);
  double p = lt625 ? a[0] : (lt16 ? b[0] : c[0]);
#pragma unroll
  for (int i = 1; i < 17; ++i)
    p = (lt625 ? a[i] : (lt16 ? b[i] : c[i])) + p * w;
#pragma unroll
  for (int i = 17; i < 19; ++i)
    if (lt16) p = (lt625 ? a[i] : b[i]) + p * w;
#pragma unroll
  for (int i = 19; i < 23; ++i)
    if (lt625) p = a[i] + p * w;
  return fabs(x) == 1.0 ? x * __longlong_as_double(0x7ff0000000000000ll)
                        : p * x;
}

// jax.random.normal(key, shape, F)[i] = sqrt(2) * erf_inv(u).
template <typename F>
__device__ __forceinline__ F normal(uint32_t k0, uint32_t k1, uint64_t i) {
  const F u = uniform<F>(k0, k1, i, open_low<F>(), F(1));
  return static_cast<F>(1.4142135623730951) * erf_inv(u);
}

// jax.random.laplace(key, shape, F)[i] = sign(u) * log1p(-|u|).
template <typename F>
__device__ __forceinline__ F laplace(uint32_t k0, uint32_t k1, uint64_t i) {
  const F u = uniform<F>(k0, k1, i, open_low<F>(), F(1));
  const F sign = u > F(0) ? F(1) : (u < F(0) ? F(-1) : F(0));
  return sign * log1p_(-(u < F(0) ? -u : u));
}

// Additive noise of std `std` is a draw times noise_scale: std for a
// normal draw, b = std / sqrt(2) for a laplace draw (ops/noise.py).
template <typename F>
__device__ __forceinline__ F noise_scale(double std, bool gaussian) {
  const F s = static_cast<F>(std);
  return gaussian ? s : s / sqrt_(F(2));
}

// Element i of jax.random.normal (gaussian) or jax.random.laplace.
template <typename F>
__device__ __forceinline__ F draw(uint32_t k0, uint32_t k1, uint64_t i,
                                  bool gaussian) {
  return gaussian ? normal<F>(k0, k1, i) : laplace<F>(k0, k1, i);
}

// ---------------------------------------------------------------------------
// Secure noise (K13): pipelinedp_tpu/ops/secure_noise.py _lex_search (:140)
// and snapped_release (:174).
//
// A slot's table holds 2K + 1 u64 thresholds thr[i] = cumsum(pmf)[i] *
// 2^64 (the host packs the JAX package's (hi, lo) u32 pairs as hi << 32 |
// lo, so the lexicographic pair compare is the u64 compare); the last
// entry is 2^64 - 1. The atom of the u64 word u is the first i with
// thr[i] > u, found by binary search over [0, 2K] (12-13 rounds for 4097
// entries; the JAX package's fixed 14 rounds end at the same index). The
// tables are a few 32 KB rows read through the read-only cache.
__device__ __forceinline__ int table_search(
    const unsigned long long* __restrict__ thr, int len,
    unsigned long long u) {
  int lo = 0, hi = len - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(thr + mid) <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return hi;
}

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }

// The keys of a secure draw: (k1, k2) = split(key), and split(key)[j] is
// fold_in(key, j) in JAX's partitionable layout. A launch whose key is
// fixed (a slot, a level, a vector entry) splits it once on the host; the
// lazy regime's per-node keys are split on the device, once a node.
struct SecureKey {
  uint32_t hi[2], lo[2];
};

__host__ __device__ __forceinline__ SecureKey secure_key(uint32_t k0,
                                                         uint32_t k1) {
  SecureKey s;
  fold_in(k0, k1, 0u, s.hi[0], s.hi[1]);
  fold_in(k0, k1, 1u, s.lo[0], s.lo[1]);
  return s;
}

// The words of a secure draw at element i: uhi = bits(k1)[i], ulo =
// bits(k2)[i].
__device__ __forceinline__ void secure_words(const SecureKey& k, uint64_t i,
                                             uint32_t& uhi, uint32_t& ulo) {
  uhi = bits32(k.hi[0], k.hi[1], i);
  ulo = bits32(k.lo[0], k.lo[1], i);
}

// snap(col) + (atom - K) * gran: col rounded half to even to the grid
// (jnp.round; gran is a power of two, so the division and the product are
// exact) plus the atom of the words (uhi, ulo) on the grid. gran is the
// slot's grid in the working type, as the JAX package casts it.
template <typename F>
__device__ __forceinline__ F snapped_release(
    F col, uint32_t uhi, uint32_t ulo,
    const unsigned long long* __restrict__ thr, int len, F gran) {
  const F snapped = rint_(col / gran) * gran;
  const int idx = table_search(
      thr, len, (static_cast<unsigned long long>(uhi) << 32) | ulo);
  return snapped + static_cast<F>(idx - (len - 1) / 2) * gran;
}

// jnp.maximum / jnp.minimum: a NaN operand propagates.
template <typename F>
__device__ __forceinline__ F max_nan(F a, F b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename F>
__device__ __forceinline__ F min_nan(F a, F b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// The release sentinel's bits of one released value (numeric.py): NaN 1,
// Inf 2, |x| >= half the type's maximum 4.
template <typename F>
__device__ __forceinline__ unsigned value_flags(F v) {
  const F limit = static_cast<F>(sizeof(F) == 4 ? 1.7014117331926443e38
                                                : 8.988465674311579e307);
  if (v != v) return 1u;
  const F a = v < F(0) ? -v : v;
  if (a == static_cast<F>(INFINITY)) return 2u;
  return a >= limit ? 4u : 0u;
}

// ORs every thread's flag bits into *flags: a warp reduction, one shared
// word per block and one integer atomicOr per block (order-free, so the
// word is deterministic). Every thread of the block must call it.
__device__ __forceinline__ void block_or_flags(unsigned f, unsigned* flags) {
  __shared__ unsigned block_flags;
  if (threadIdx.x == 0) block_flags = 0u;
  __syncthreads();
  f = __reduce_or_sync(kFullMask, f);
  if ((threadIdx.x & 31) == 0 && f) atomicOr(&block_flags, f);
  __syncthreads();
  if (threadIdx.x == 0 && block_flags) atomicOr(flags, block_flags);
}

// ---------------------------------------------------------------------------
// Block scan. Op provides: type T, T identity(), T combine(T a, T b) (a
// precedes b; need not commute) and T shfl_up(T v, int delta).

template <class Op>
__device__ __forceinline__ typename Op::T warp_inclusive_scan(
    typename Op::T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const typename Op::T t = Op::shfl_up(v, d);
    if (lane >= d) v = Op::combine(t, v);
  }
  return v;
}

// Exclusive scan of one value per thread over the block (blockDim.x a
// multiple of 32, at most 1024). smem holds 32 T. Returns the thread's
// exclusive prefix; *total receives the block aggregate. Starts and ends
// with a barrier, so consecutive calls may reuse smem.
template <class Op>
__device__ __forceinline__ typename Op::T block_exclusive_scan(
    typename Op::T v, typename Op::T* smem, typename Op::T* total) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();
  const T inc = warp_inclusive_scan<Op>(v);
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < n_warps ? smem[lane] : Op::identity();
    w = warp_inclusive_scan<Op>(w);
    if (lane < n_warps) smem[lane] = w;
  }
  __syncthreads();
  T excl = Op::shfl_up(inc, 1);
  if (lane == 0) excl = Op::identity();
  const T warp_prefix = warp > 0 ? smem[warp - 1] : Op::identity();
  *total = smem[n_warps - 1];
  __syncthreads();
  return Op::combine(warp_prefix, excl);
}

// One block turns n values into their exclusive prefixes, in place,
// walking them in order; *total (when not null) receives the aggregate of
// all n. smem holds 32 T.
template <class Op>
__device__ __forceinline__ void block_scan_in_place(typename Op::T* aggs,
                                                    long long n,
                                                    typename Op::T* smem,
                                                    typename Op::T* total) {
  using T = typename Op::T;
  T carry = Op::identity();
  for (long long base = 0; base < n; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const T v = i < n ? aggs[i] : Op::identity();
    T chunk;
    const T excl = block_exclusive_scan<Op>(v, smem, &chunk);
    if (i < n) aggs[i] = Op::combine(carry, excl);
    carry = Op::combine(carry, chunk);
  }
  if (total != nullptr && threadIdx.x == 0) *total = carry;
}

// Integer sum, for counting scans.
template <typename I>
struct SumOp {
  using T = I;
  static __device__ __forceinline__ T identity() { return T(0); }
  static __device__ __forceinline__ T combine(T a, T b) { return a + b; }
  static __device__ __forceinline__ T shfl_up(T v, int d) {
    return __shfl_up_sync(kFullMask, v, d);
  }
  static __device__ __forceinline__ T shfl(T v, int src) {
    return __shfl_sync(kFullMask, v, src);
  }
  // A sum's walk goes back to the nearest inclusive prefix.
  static __device__ __forceinline__ bool ends_walk(T) { return false; }
};

// Maximum, for the position of the last segment start (-1 = none).
struct MaxPosOp {
  using T = long long;
  static __device__ __forceinline__ T identity() { return -1; }
  static __device__ __forceinline__ T combine(T a, T b) {
    return a > b ? a : b;
  }
  static __device__ __forceinline__ T shfl_up(T v, int d) {
    return __shfl_up_sync(kFullMask, v, d);
  }
  static __device__ __forceinline__ T shfl(T v, int src) {
    return __shfl_sync(kFullMask, v, src);
  }
  // A segment start inside: nothing earlier changes the maximum.
  static __device__ __forceinline__ bool ends_walk(T v) { return v >= 0; }
};

inline long long n_tiles(long long n) { return (n + kTile - 1) / kTile; }

// ---------------------------------------------------------------------------
// Decoupled look-back (one-pass tile scans). A block claims its tile from
// an atomic counter, so every earlier tile belongs to a block that is
// already running and the walk below never waits on one that has not
// started. Tile j's status word is 0 until it publishes, 1 once aggs[j]
// holds its aggregate and 2 once incl[j] holds the inclusive prefix of
// tiles [0, j]; each is written, fenced, then flagged with a release store.

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// A published aggregate, read word by word from L2.
template <class T>
__device__ __forceinline__ T load_published(const T* p) {
  static_assert(sizeof(T) % 4 == 0, "aggregates are whole words");
  T out;
  const unsigned* src = reinterpret_cast<const unsigned*>(p);
  unsigned* dst = reinterpret_cast<unsigned*>(&out);
#pragma unroll
  for (int w = 0; w < static_cast<int>(sizeof(T) / 4); ++w)
    dst[w] = __ldcg(src + w);
  return out;
}

// Writes a tile's aggregate (flag 1) or inclusive prefix (flag 2) and
// flags it. One thread calls it.
template <class T>
__device__ __forceinline__ void publish(T* slot, int* status, const T& v,
                                        int flag) {
  *slot = v;
  __threadfence();
  store_release(status, flag);
}

// Warp 0's walk: the combined value of tiles [start, tile) of one scan,
// whose tile t sits at slot `first_slot + t` of aggs / incl / status.
// Tiles are taken 32 at a time, lane 31 the nearest, scanned in order and
// folded in front of what was gathered. A chunk ends the walk where one of
// its tiles has published an inclusive prefix (the lanes before the
// nearest such tile drop out), where Op::ends_walk holds for the chunk (a
// segment starts inside it) or at tile 0. incl may be null where no tile
// publishes a prefix: the walk then reads aggregates alone, and its
// association depends on the data and the tiling only.
template <class Op>
__device__ typename Op::T look_back(const typename Op::T* aggs,
                                    const typename Op::T* incl,
                                    const int* status, long long first_slot,
                                    long long tile) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  T acc = Op::identity();
  for (long long hi = tile;; hi -= 32) {
    const long long j = hi - 32 + lane;
    T a = Op::identity();
    int s = 0;
    if (j >= 0) {
      while ((s = load_acquire(status + first_slot + j)) == 0) {
      }
      a = load_published(s == 2 ? incl + first_slot + j
                                : aggs + first_slot + j);
    }
    const unsigned inclusive = __ballot_sync(kFullMask, s == 2);
    if (inclusive != 0u && lane < 31 - __clz(inclusive)) a = Op::identity();
    const T chunk = Op::shfl(warp_inclusive_scan<Op>(a), 31);
    acc = Op::combine(chunk, acc);
    if (inclusive != 0u || Op::ends_walk(chunk) || hi <= 32) break;
  }
  return acc;
}

// The state of one one-pass scan in a call's scratch: the tile counter and
// one status word per tile (reset by the call's memset), then the
// published aggregates and inclusive prefixes.
template <class T>
struct Scan {
  unsigned long long* counter;
  int* status;
  T* aggs;
  T* incl;
};

inline size_t align_up(size_t x) {
  return (x + 255) & ~static_cast<size_t>(255);
}

// Bytes the call's memset clears: the counter and the status words.
inline size_t scan_reset_bytes(long long tiles) {
  return align_up(8) + align_up(static_cast<size_t>(tiles) * 4);
}

// All of a scan's scratch, the reset bytes first.
template <class T>
inline size_t scan_bytes(long long tiles) {
  return scan_reset_bytes(tiles) +
         2 * align_up(static_cast<size_t>(tiles) * sizeof(T));
}

template <class T>
inline Scan<T> carve_scan(void* scratch, long long tiles) {
  char* p = static_cast<char*>(scratch);
  Scan<T> s;
  s.counter = reinterpret_cast<unsigned long long*>(p);
  s.status = reinterpret_cast<int*>(p + align_up(8));
  p += scan_reset_bytes(tiles);
  s.aggs = reinterpret_cast<T*>(p);
  s.incl = reinterpret_cast<T*>(p + align_up(tiles * sizeof(T)));
  return s;
}

// Claims the block's tile; every thread gets its number.
__device__ __forceinline__ long long claim_tile(unsigned long long* counter) {
  __shared__ long long tile;
  if (threadIdx.x == 0) tile = static_cast<long long>(atomicAdd(counter, 1ULL));
  __syncthreads();
  return tile;
}

// The tile's prefix (the combined value of all earlier tiles; identity
// where the tile needs none) after publishing its aggregate, and its own
// inclusive prefix published. self_contained: no row of the tile depends
// on an earlier tile, so the aggregate is the inclusive prefix. Every
// thread gets the prefix.
template <class Op>
__device__ typename Op::T tile_prefix(const Scan<typename Op::T>& s,
                                      long long tile, bool self_contained,
                                      const typename Op::T& total) {
  using T = typename Op::T;
  __shared__ T prefix;
  if (threadIdx.x == 0) {
    if (self_contained) {
      publish(s.incl + tile, s.status + tile, total, 2);
    } else {
      publish(s.aggs + tile, s.status + tile, total, 1);
    }
  }
  if (threadIdx.x < 32) {
    T before = Op::identity();
    if (!self_contained)
      before = look_back<Op>(s.aggs, s.incl, s.status, 0, tile);
    if (threadIdx.x == 0) {
      prefix = before;
      if (!self_contained)
        publish(s.incl + tile, s.status + tile, Op::combine(before, total),
                2);
    }
  }
  __syncthreads();
  return prefix;
}

}  // namespace pdp
