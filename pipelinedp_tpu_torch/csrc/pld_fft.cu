// C15 pld_fft: the batched complex128 FFT of the one-shot PLD composition.
//
// Replaces the transforms of K18, pipelinedp_tpu/accounting/compose.py
// _compose_spectra_device (:143, called from _compose_pmfs_device :158):
// jnp.fft.rfft of the zero-padded loss pmfs [R, L] float64 along axis 1,
// and jnp.fft.irfft(spectrum, n=L) of the composed spectrum. L is a power
// of two (<= 2^21 after the accountant's coarsening), R <= 64 rows a call.
//
// Design:
//   * Real input goes through the usual half-length packing: the row's
//     float64[L] read as complex128[N], N = L / 2, z[n] = x[2n] + i x[2n+1]
//     (no copy: it is the same memory). One complex FFT of length N, then a
//     split pass that gives the L/2 + 1 bins rfft gives:
//       X[k] = E + W^k O,  X[N-k] = conj(E - W^k O),  W = exp(-2 pi i / L),
//       E = (Z[k] + conj Z[N-k]) / 2,  O = -i (Z[k] - conj Z[N-k]) / 2.
//     The inverse runs the same steps backwards (the imaginary parts of
//     bins 0 and N are dropped, as numpy's irfft drops them) and scales by
//     1 / N, a power of two, in its pre-pass.
//   * The complex FFT is a radix-2 Stockham autosort: one launch a stage
//     (log2 N stages), each thread one butterfly, rows on grid.y, ping-pong
//     between a scratch buffer and the output (whose rows are N + 1 long;
//     the stage takes row strides), so the result needs no bit reversal.
//   * Twiddles in double from one table per call, table[k] = W^k for
//     k < N, filled by sincospi(k / N): k / N is exact, so the table is
//     correctly rounded; the stages read W_N^m = table[2m].
//   * Built with --fmad=false and no fast-math: every complex product
//     rounds as written.
//
// Bound: bytes. A stage reads and writes every complex word once (16 B),
// so a forward call moves about 2 * 16 * R * N * (log2 N + 1) bytes against
// the function's 8 * R * L + 16 * R * (N + 1); the FP64 work (5 N log2 N
// flops a row) is far below the card's FP64 rate. Making it fast (a
// shared-memory radix-16 pass over the first stages) is later work.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 conjg(double2 a) {
  return make_double2(a.x, -a.y);
}

// table[k] = exp(-2 pi i k / L) = exp(-pi i k / N), k in [0, N).
__global__ void twiddle_table(long long n, double2* __restrict__ table) {
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  double s, c;
  sincospi(static_cast<double>(k) / static_cast<double>(n), &s, &c);
  table[k] = make_double2(c, -s);
}

// One radix-2 Stockham stage of length-n transforms, sub-transform length
// p (1, 2, ..., n / 2): butterfly i reads x[i] and x[i + n/2] and writes
// y[2i - k] and y[2i - k + p], k = i mod p, twiddle exp(-+ pi i k / p).
__global__ void stockham_stage(const double2* __restrict__ in,
                               long long in_stride, double2* __restrict__ out,
                               long long out_stride, long long n, long long p,
                               const double2* __restrict__ table,
                               int inverse) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long half = n >> 1;
  if (i >= half) return;
  const double2* x = in + static_cast<long long>(blockIdx.y) * in_stride;
  double2* y = out + static_cast<long long>(blockIdx.y) * out_stride;
  const long long k = i & (p - 1);
  double2 w = table[k * (n / p)];
  if (inverse) w.y = -w.y;
  const double2 u0 = x[i];
  const double2 u1 = cmul(x[i + half], w);
  const long long j = (i << 1) - k;
  y[j] = cadd(u0, u1);
  y[j + p] = csub(u0, u1);
}

// rfft's split pass: Z (the packed transform, row stride z_stride) into X
// (n + 1 bins a row, stride x_stride). Thread k in [0, n/2] reads Z[k] and
// Z[n-k] and writes X[k] and X[n-k] only, so Z may be X itself.
__global__ void split_forward(const double2* z_rows, long long z_stride,
                              double2* x_rows, long long x_stride,
                              long long n, const double2* __restrict__ table) {
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k > (n >> 1)) return;
  const double2* z = z_rows + static_cast<long long>(blockIdx.y) * z_stride;
  double2* x = x_rows + static_cast<long long>(blockIdx.y) * x_stride;
  if (k == 0) {
    const double2 z0 = z[0];
    x[0] = make_double2(z0.x + z0.y, 0.0);
    x[n] = make_double2(z0.x - z0.y, 0.0);
    return;
  }
  const double2 a = z[k];
  const double2 b = conjg(z[n - k]);
  const double2 e = make_double2((a.x + b.x) * 0.5, (a.y + b.y) * 0.5);
  const double2 d = make_double2((a.x - b.x) * 0.5, (a.y - b.y) * 0.5);
  const double2 o = make_double2(d.y, -d.x);  // -i d
  const double2 t = cmul(table[k], o);
  x[k] = cadd(e, t);
  if (n - k != k) x[n - k] = conjg(csub(e, t));
}

// irfft's pre-pass: X (n + 1 bins, stride x_stride) into the packed
// spectrum Z (stride z_stride), scaled by 1 / n. The imaginary parts of
// bins 0 and n are dropped.
__global__ void split_inverse(const double2* __restrict__ x_rows,
                              long long x_stride, double2* __restrict__ z_rows,
                              long long z_stride, long long n,
                              const double2* __restrict__ table) {
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k > (n >> 1)) return;
  const double2* x = x_rows + static_cast<long long>(blockIdx.y) * x_stride;
  double2* z = z_rows + static_cast<long long>(blockIdx.y) * z_stride;
  const double inv_n = 1.0 / static_cast<double>(n);
  if (k == 0) {
    const double a = x[0].x, b = x[n].x;
    z[0] = make_double2((a + b) * 0.5 * inv_n, (a - b) * 0.5 * inv_n);
    return;
  }
  const double2 a = x[k];
  const double2 b = conjg(x[n - k]);
  const double2 e = make_double2((a.x + b.x) * 0.5, (a.y + b.y) * 0.5);
  const double2 d = make_double2((a.x - b.x) * 0.5, (a.y - b.y) * 0.5);
  const double2 o = cmul(d, conjg(table[k]));
  // z = e + i o; its partner conj(e) + i conj(o).
  z[k] = make_double2((e.x - o.y) * inv_n, (e.y + o.x) * inv_n);
  if (n - k != k)
    z[n - k] = make_double2((e.x + o.y) * inv_n, (o.x - e.y) * inv_n);
}

unsigned blocks_for(long long count) {
  return static_cast<unsigned>((count + kBlock - 1) / kBlock);
}

bool valid_length(long long n) { return n >= 1 && (n & (n - 1)) == 0; }

int log2_of(long long n) {
  int s = 0;
  while ((1LL << s) < n) ++s;
  return s;
}

// The log2(n) Stockham stages over `rows` rows: stage s reads src and
// writes (s even ? even_dst : odd_dst); returns where the result is.
double2* run_stages(const double2* src, long long src_stride,
                    double2* even_dst, long long even_stride,
                    double2* odd_dst, long long odd_stride, long long n,
                    long long rows, const double2* table, int inverse,
                    cudaStream_t s, long long* result_stride) {
  const int stages = log2_of(n);
  const double2* cur = src;
  long long cur_stride = src_stride;
  for (int st = 0; st < stages; ++st) {
    double2* dst = (st % 2 == 0) ? even_dst : odd_dst;
    const long long dst_stride = (st % 2 == 0) ? even_stride : odd_stride;
    const dim3 grid(blocks_for(n >> 1), static_cast<unsigned>(rows));
    stockham_stage<<<grid, kBlock, 0, s>>>(cur, cur_stride, dst, dst_stride,
                                           n, 1LL << st, table, inverse);
    cur = dst;
    cur_stride = dst_stride;
  }
  *result_stride = cur_stride;
  return const_cast<double2*>(cur);
}

}  // namespace

// rfft of rows of real float64[2n] (x, contiguous) into complex128[rows,
// n + 1] (out); work: complex128[rows, n]; table: complex128[n].
extern "C" int pld_rfft(const void* x, long long rows, long long n, void* out,
                        void* work, void* table, void* stream) {
  if (!valid_length(n) || rows < 1 || rows > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double2* tab = static_cast<double2*>(table);
  twiddle_table<<<blocks_for(n), kBlock, 0, s>>>(n, tab);
  double2* o = static_cast<double2*>(out);
  long long z_stride = 0;
  const double2* z = run_stages(static_cast<const double2*>(x), n,
                                static_cast<double2*>(work), n, o, n + 1, n,
                                rows, tab, 0, s, &z_stride);
  const dim3 grid(blocks_for((n >> 1) + 1), static_cast<unsigned>(rows));
  split_forward<<<grid, kBlock, 0, s>>>(z, z_stride, o, n + 1, n, tab);
  return static_cast<int>(cudaGetLastError());
}

// irfft(n=2n) of rows of complex128[n + 1] (spec) into real float64[rows,
// 2n] (out, contiguous); work: complex128[rows, n]; table: complex128[n].
extern "C" int pld_irfft(const void* spec, long long rows, long long n,
                         void* out, void* work, void* table, void* stream) {
  if (!valid_length(n) || rows < 1 || rows > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double2* tab = static_cast<double2*>(table);
  twiddle_table<<<blocks_for(n), kBlock, 0, s>>>(n, tab);
  double2* o = static_cast<double2*>(out);
  double2* w = static_cast<double2*>(work);
  // The stages alternate from the pre-pass's buffer, so pick it to make
  // the last stage land in `out`.
  const bool even = log2_of(n) % 2 == 0;
  double2* first = even ? o : w;
  const dim3 grid(blocks_for((n >> 1) + 1), static_cast<unsigned>(rows));
  split_inverse<<<grid, kBlock, 0, s>>>(static_cast<const double2*>(spec),
                                        n + 1, first, n, n, tab);
  long long stride = 0;
  run_stages(first, n, even ? w : o, n, even ? o : w, n, n, rows, tab, 1, s,
             &stride);
  return static_cast<int>(cudaGetLastError());
}
