// C16 log_spectrum: the weighted log-domain product of the one-shot PLD
// composition.
//
// Replaces the body of K18 between its transforms,
// pipelinedp_tpu/accounting/compose.py _compose_spectra_device (:143):
//   total = sum_r w_r * log(S_r[j])      (complex128, w_r the multiplicity)
//   alive = isfinite(total.real)
//   spectrum = alive ? exp(total) : 0
// Two entries: `accumulate` adds one chunk of rows (C15's rfft output,
// [R, M] with M = L/2 + 1) into a complex128[M] accumulator, chunk after
// chunk; `finalize` turns the accumulator into the spectrum C15's irfft
// reads.
//
// One thread a bin. It walks the chunk's rows in order, summing
// w_r * log|S_r[j]| and w_r * arg S_r[j] (the complex log is
// (log(hypot(re, im)), atan2(im, re))) from 0, and adds the chunk's sums
// into the accumulator: the order of numpy's axis-0 sum in the host path.
// A zero spectral line gives log 0 = -inf in the real part, which kills
// the bin in `finalize`, as the JAX package does; rows are never padded
// with weight 0 (0 * log 0 would be NaN). Built with --fmad=false.
//
// Bound: bytes. The chunk's spectra are read once (16 B a bin a row) and
// the accumulator read and written once; the FP64 work (a hypot, a log and
// an atan2 a bin a row, tens of flops) stays under the card's FP64 peak at
// the card's memory rate.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void accumulate(const double2* __restrict__ spectra,
                           long long rows, long long m,
                           const double* __restrict__ weights,
                           double2* __restrict__ acc) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  double re = 0.0, im = 0.0;
  for (long long r = 0; r < rows; ++r) {
    const double2 s = spectra[r * m + j];
    const double w = weights[r];
    re += w * log(hypot(s.x, s.y));
    im += w * atan2(s.y, s.x);
  }
  double2 t = acc[j];
  t.x += re;
  t.y += im;
  acc[j] = t;
}

__global__ void finalize(const double2* __restrict__ acc, long long m,
                         double2* __restrict__ out) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const double2 t = acc[j];
  if (!isfinite(t.x)) {
    out[j] = make_double2(0.0, 0.0);
    return;
  }
  const double e = exp(t.x);
  double s, c;
  sincos(t.y, &s, &c);
  out[j] = make_double2(e * c, e * s);
}

unsigned blocks_for(long long count) {
  return static_cast<unsigned>((count + kBlock - 1) / kBlock);
}

}  // namespace

// spectra: complex128[rows, m]; weights: float64[rows]; acc:
// complex128[m], updated in place.
extern "C" int log_spectrum_accumulate(const void* spectra, long long rows,
                                       long long m, const void* weights,
                                       void* acc, void* stream) {
  if (m <= 0 || rows <= 0) return 0;
  accumulate<<<blocks_for(m), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(spectra), rows, m,
      static_cast<const double*>(weights), static_cast<double2*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// acc: complex128[m]; out: complex128[m].
extern "C" int log_spectrum_finalize(const void* acc, long long m, void* out,
                                     void* stream) {
  if (m <= 0) return 0;
  finalize<<<blocks_for(m), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(acc), m, static_cast<double2*>(out));
  return static_cast<int>(cudaGetLastError());
}
