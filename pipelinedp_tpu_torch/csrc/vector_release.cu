// C9 vector_release: VECTOR_SUM's release, one thread per partition.
//
// Replaces K11, pipelinedp_tpu/executor.py _clip_rows_to_norm_ball
// (:537-548), with the vector entry of finalize (:612-616) and, for the
// release sentinel, the flag bits of its column (numeric.py:80, a row
// gated by its partition).
//
// Per partition p of the dense vector sums vsum[p, :] (C3's vector entry):
//   clip   L-inf: each coordinate clipped to [-max_norm, max_norm];
//          L1 / L2: scaled by min(1, max_norm / (norm > 0 ? norm : 1)),
//          the norm summed from 0 over the D coordinates in order (sum of
//          |x|, or the square root of the sum of x * x), as XLA reduces
//   noise  coordinate d draws element p * D + d of the vector entry's slot
//          key fold_in(fold_in(key_noise, entry), 0): the flat index of
//          additive_noise(key, (P, D)); Laplace b = std / sqrt(2)
//   secure with a table (K13, finalize's `noised` at :612-616 with
//          cfg.secure): each clipped coordinate is snapped to the grid and
//          takes the atom searched with the words bits(k1)[p * D + d],
//          bits(k2)[p * D + d] of (k1, k2) = split(slot key)
//   flags  NaN / Inf / saturation of the kept partitions' outputs, ORed
//          into the release's flag word (one atomicOr a block).
//
// Bound: operations at small D: each coordinate costs one threefry (~100
// integer operations) and an erf_inv or a log1p; it reads and writes D F
// values a partition.
#include "common.cuh"

namespace {

enum Norm { kLinf = 0, kL1 = 1, kL2 = 2 };

__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

template <typename F>
__global__ void vector_kernel(const F* __restrict__ vsum, long long n,
                              int dim, int norm_kind, double max_norm,
                              double std, unsigned k0, unsigned k1,
                              int gaussian, const uint8_t* __restrict__ keep,
                              F* __restrict__ out,
                              unsigned* __restrict__ flags,
                              const unsigned long long* __restrict__ table,
                              int table_len, double gran,
                              pdp::SecureKey skey) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned f = 0u;
  if (p < n) {
    const F* v = vsum + p * dim;
    F* o = out + p * dim;
    const F bound = static_cast<F>(max_norm);
    F scale = F(1);
    if (norm_kind != kLinf) {
      F acc = F(0);
      for (int d = 0; d < dim; ++d)
        acc = acc + (norm_kind == kL1 ? abs_(v[d]) : v[d] * v[d]);
      const F norm = norm_kind == kL1 ? acc : pdp::sqrt_(acc);
      scale = pdp::min_nan(F(1), bound / (norm > F(0) ? norm : F(1)));
    }
    const F noise = pdp::noise_scale<F>(std, gaussian);
    const bool kept = keep[p] != 0;
    for (int d = 0; d < dim; ++d) {
      const F clipped = norm_kind == kLinf
                            ? pdp::min_nan(pdp::max_nan(v[d], -bound), bound)
                            : v[d] * scale;
      const uint64_t i = static_cast<uint64_t>(p * dim + d);
      F r;
      if (table) {
        uint32_t uhi, ulo;
        pdp::secure_words(skey, i, uhi, ulo);
        r = pdp::snapped_release<F>(clipped, uhi, ulo, table, table_len,
                                    static_cast<F>(gran));
      } else {
        r = clipped + pdp::draw<F>(k0, k1, i, gaussian) * noise;
      }
      o[d] = r;
      if (kept) f |= pdp::value_flags(r);
    }
  }
  pdp::block_or_flags(f, flags);
}

}  // namespace

// vsum / out: F[n_partitions, dim]; norm_kind: 0 L-inf, 1 L1, 2 L2; (k0,
// k1): the slot key; keep: u8[n_partitions]; flags: the release's flag
// word. Secure noise: table u64[table_len] (null: continuous noise) and
// its grid.
extern "C" int vector_release(const void* vsum, long long n_partitions,
                              int dim, int norm_kind, double max_norm,
                              double std, unsigned k0, unsigned k1,
                              int gaussian, const void* keep, void* out,
                              void* flags, const void* table, int table_len,
                              double gran, int f64, void* stream) {
  if (norm_kind < kLinf || norm_kind > kL2 || dim < 1) return -1;
  if (table != nullptr && (table_len < 1 || table_len % 2 == 0)) return -1;
  const auto* thr = static_cast<const unsigned long long*>(table);
  if (n_partitions <= 0) return 0;
  const pdp::SecureKey sk =
      thr ? pdp::secure_key(k0, k1) : pdp::SecureKey{};
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((n_partitions + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* k = static_cast<const uint8_t*>(keep);
  unsigned* fl = static_cast<unsigned*>(flags);
  if (f64) {
    vector_kernel<double><<<blocks, threads, 0, s>>>(
        static_cast<const double*>(vsum), n_partitions, dim, norm_kind,
        max_norm, std, k0, k1, gaussian, k, static_cast<double*>(out), fl,
        thr, table_len, gran, sk);
  } else {
    vector_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(vsum), n_partitions, dim, norm_kind,
        max_norm, std, k0, k1, gaussian, k, static_cast<float*>(out), fl,
        thr, table_len, gran, sk);
  }
  return static_cast<int>(cudaGetLastError());
}
