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
// The lane entry, vector_release_lanes (K24: the megabatched service's
// vmap over job lanes, executor.py:984), releases L jobs' [L * P, D] sums:
// blockIdx.y is the lane, partition p of lane l draws at its solo counter
// p * D + d under the lane's slot key (a row of a u32 table on the
// device: the key, and with a secure table its split k1, k2), and ORs
// its flags into flags[l].
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
                              pdp::SecureKey skey,
                              const unsigned* __restrict__ lane_keys) {
  // Lane blockIdx.y (0 for one job): its rows start at lane * n, its key
  // is row `lane` of lane_keys, its flag word is flags[lane].
  const long long lane = blockIdx.y;
  if (lane_keys) {
    const unsigned* lk = lane_keys + lane * (table ? 6 : 2);
    k0 = lk[0];
    k1 = lk[1];
    if (table) {
      skey.hi[0] = lk[2];
      skey.hi[1] = lk[3];
      skey.lo[0] = lk[4];
      skey.lo[1] = lk[5];
    }
  }
  vsum += lane * n * dim;
  out += lane * n * dim;
  keep += lane * n;
  flags += lane;
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

template <typename F>
void launch(const void* vsum, long long n_partitions, int n_lanes, int dim,
            int norm_kind, double max_norm, double std, unsigned k0,
            unsigned k1, int gaussian, const void* keep, void* out,
            void* flags, const unsigned long long* thr, int table_len,
            double gran, const pdp::SecureKey& sk, const void* lane_keys,
            cudaStream_t s) {
  const int threads = 256;
  const dim3 grid(
      static_cast<unsigned>((n_partitions + threads - 1) / threads),
      static_cast<unsigned>(n_lanes));
  vector_kernel<F><<<grid, threads, 0, s>>>(
      static_cast<const F*>(vsum), n_partitions, dim, norm_kind, max_norm,
      std, k0, k1, gaussian, static_cast<const uint8_t*>(keep),
      static_cast<F*>(out), static_cast<unsigned*>(flags), thr, table_len,
      gran, sk, static_cast<const unsigned*>(lane_keys));
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(vsum, n_partitions, 1, dim, norm_kind, max_norm, std, k0,
                   k1, gaussian, keep, out, flags, thr, table_len, gran, sk,
                   nullptr, s);
  } else {
    launch<float>(vsum, n_partitions, 1, dim, norm_kind, max_norm, std, k0,
                  k1, gaussian, keep, out, flags, thr, table_len, gran, sk,
                  nullptr, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The lane entry: vsum / out F[n_lanes * n_partitions, dim], keep
// u8[n_lanes * n_partitions], flags n_lanes words; lane_keys: u32
// [n_lanes, 2] on the device (each lane's slot key; with a table [n_lanes,
// 6], the key and its split k1, k2). Otherwise as vector_release.
extern "C" int vector_release_lanes(const void* vsum, long long n_partitions,
                                    int n_lanes, int dim, int norm_kind,
                                    double max_norm, double std,
                                    int gaussian, const void* lane_keys,
                                    const void* keep, void* out, void* flags,
                                    const void* table, int table_len,
                                    double gran, int f64, void* stream) {
  if (norm_kind < kLinf || norm_kind > kL2 || dim < 1) return -1;
  if (table != nullptr && (table_len < 1 || table_len % 2 == 0)) return -1;
  if (n_lanes < 1 || n_lanes > 65535 || lane_keys == nullptr) return -1;
  if (n_partitions <= 0) return 0;
  const auto* thr = static_cast<const unsigned long long*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(vsum, n_partitions, n_lanes, dim, norm_kind, max_norm,
                   std, 0u, 0u, gaussian, keep, out, flags, thr, table_len,
                   gran, pdp::SecureKey{}, lane_keys, s);
  } else {
    launch<float>(vsum, n_partitions, n_lanes, dim, norm_kind, max_norm, std,
                  0u, 0u, gaussian, keep, out, flags, thr, table_len, gran,
                  pdp::SecureKey{}, lane_keys, s);
  }
  return static_cast<int>(cudaGetLastError());
}
