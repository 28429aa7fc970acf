// C15 pld_fft: the batched complex128 FFT of the one-shot PLD composition.
//
// Replaces the transforms of K18, pipelinedp_tpu/accounting/compose.py
// _compose_spectra_device (:143, called from _compose_pmfs_device :158):
// jnp.fft.rfft of the zero-padded loss pmfs [R, L] float64 along axis 1,
// and jnp.fft.irfft(spectrum, n=L) of the composed spectrum. L is a power
// of two (<= 2^21 after the accountant's coarsening), R <= 64 rows a call.
//
// Bound on this card: bytes. The function reads 8 R L bytes and writes
// 16 R (L / 2 + 1); at [64, 2^21] that is 2.15 GB, 0.64 ms at 3.35 TB/s.
// Its FP64 work (5 N log2 N a row, N = L / 2) is ~0.2 ms at the card's
// 34 TFLOP/s. A radix-2 FFT with one launch a stage moves every word
// through device memory log2 N times (20 passes, ~43 GB, at [64, 2^21]).
//
// Design: a multi-pass Stockham FFT whose passes each do one large radix
// in shared memory, so a forward call moves the data about three times.
//   * Real input goes through the usual half-length packing: the row's
//     float64[L] read as complex128[N], z[n] = x[2n] + i x[2n+1] (the same
//     memory, no copy). One complex FFT of length N, then a split pass
//     that gives the L/2 + 1 bins rfft gives:
//       X[k] = E + W^k O,  X[N-k] = conj(E - W^k O),  W = exp(-2 pi i / L),
//       E = (Z[k] + conj Z[N-k]) / 2,  O = -i (Z[k] - conj Z[N-k]) / 2.
//     The inverse runs the same steps backwards (the imaginary parts of
//     bins 0 and N are dropped, as numpy's irfft drops them) and scales by
//     1 / N, a power of two, in its pre-pass.
//   * The plan, N = R_1 R_2 ... (each factor a power of two <= 2048, one
//     pass for N <= 2048, two up to 2^22), is chosen in Python
//     (kernels.pld_fft_plan) and passed in. Pass p is one Stockham stage
//     of radix R_p over the whole transform (ns = R_1 ... R_{p-1}): line j
//     in [0, N / R_p) reads v[r] = d[j + r N / R_p], twiddles it by
//     W_{ns R_p}^{r (j mod ns)}, takes its R_p-point DFT and writes
//     d'[(j / ns) ns R_p + j mod ns + r ns]. The result is in natural
//     order, and the last pass reads and writes the same words, so it runs
//     in place; a two-pass forward call needs no buffer but its output.
//   * A block transforms G = 4096 / R_p lines in shared memory (64 KB of
//     data, skewed and padded so neither the strided loads nor the DFT's
//     stages conflict on banks): loads of G neighbouring lines are G x
//     16-byte segments, the first pass writes whole lines, and the
//     transposition the four-step order needs happens in shared memory,
//     never as a strided store of single words. The DFT is a Stockham FFT
//     in shared memory: radix-16 stages while four bits remain (a 4 x 4
//     DFT in registers), then one of radix 2, 4 or 8; each thread holds
//     its butterflies' 16 words in registers between two barriers, so the
//     stages run in place. The pass is a template of its factor, so the
//     index arithmetic is constant; 80 registers a thread let 3 blocks
//     share an SM.
//   * Twiddles in double: sincospi of an exact ratio (2e / m, m a power of
//     two), so each is the value of the old correctly rounded table; a
//     block's DFT twiddles W_R^e come from a quarter table (e < R / 4)
//     made once into shared memory, rotated by -i per quarter (exact).
//   * What is left: at R_p = 1024 a pass reads (and the last one writes)
//     64-byte segments 16 KB apart and runs at about half the split's
//     streaming rate; passes of smaller factors (longer segments) run
//     faster, but the extra pass costs more than they save.
//   * Built with --fmad=false and no fast-math: every complex product
//     rounds as written. kernels.pld_rfft_four_step / pld_irfft_four_step
//     repeat this arithmetic step by step in PyTorch.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;       // threads a block
constexpr int kLogElems = 12;     // complex words a pass's block transforms
constexpr int kElems = 1 << kLogElems;
constexpr int kMaxLogFactor = 11;  // factors of at most 2048
constexpr int kMaxPasses = 3;
constexpr int kMinBlocks = 3;  // resident blocks an SM the registers allow

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

// exp(-+ 2 pi i e / m) (+ for the inverse), m a power of two, 0 <= e < m:
// 2e / m is exact, so this is sincospi of an exact argument.
__device__ __forceinline__ double2 twiddle(long long e, long long m,
                                           bool inverse) {
  double s, c;
  sincospi(2.0 * static_cast<double>(e) / static_cast<double>(m), &s, &c);
  return make_double2(c, inverse ? s : -s);
}

// Multiplication by -i (forward) or +i (inverse): exact.
template <bool kInverse>
__device__ __forceinline__ double2 rot(double2 a) {
  return kInverse ? make_double2(-a.y, a.x) : make_double2(a.y, -a.x);
}

__device__ __forceinline__ double2 neg(double2 a) {
  return make_double2(-a.x, -a.y);
}

// W_R^e (conjugated for the inverse), 0 <= e < R, from the quarter table
// tw[e'] = W_R^e', e' < R / 4: W_R^(e' + q R / 4) = (-+i)^q W_R^e'.
template <bool kInverse, int kLogR>
__device__ __forceinline__ double2 tw_of(const double2* tw, int e) {
  const double2 w = tw[e & ((1 << (kLogR - 2)) - 1)];
  const int q = e >> (kLogR - 2);
  const double2 h = (q & 1) ? rot<kInverse>(w) : w;
  return (q & 2) ? neg(h) : h;
}

// The 4-point DFT in place.
template <bool kInverse>
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2,
                                     double2& a3) {
  const double2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const double2 t2 = cadd(a1, a3), t3 = rot<kInverse>(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// The Q-point DFT of a[0, Q) in place, natural order in and out; Q = 8 is
// 4 x 2 and Q = 16 is 4 x 4 (inner DFTs over a[q2 n1 + n2], twiddles
// W_Q^(n2 k1) from the table, outer DFTs giving X[k1 + 4 k2]).
template <bool kInverse, int kLogR, int kLogQ>
__device__ __forceinline__ void dft(double2* a, const double2* tw) {
  if constexpr (kLogQ == 1) {
    const double2 t = a[0];
    a[0] = cadd(t, a[1]);
    a[1] = csub(t, a[1]);
  } else if constexpr (kLogQ == 2) {
    dft4<kInverse>(a[0], a[1], a[2], a[3]);
  } else if constexpr (kLogQ == 3) {
    double2 y[2][4];
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int n1 = 0; n1 < 4; ++n1) y[n2][n1] = a[2 * n1 + n2];
      dft4<kInverse>(y[n2][0], y[n2][1], y[n2][2], y[n2][3]);
    }
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
      y[1][k1] = cmul(y[1][k1],
                      tw_of<kInverse, kLogR>(tw, k1 << (kLogR - 3)));
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      a[k1] = cadd(y[0][k1], y[1][k1]);
      a[k1 + 4] = csub(y[0][k1], y[1][k1]);
    }
  } else {
    static_assert(kLogQ == 4, "radix 2, 4, 8 or 16");
    double2 y[4][4];
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
#pragma unroll
      for (int n1 = 0; n1 < 4; ++n1) y[n2][n1] = a[4 * n1 + n2];
      dft4<kInverse>(y[n2][0], y[n2][1], y[n2][2], y[n2][3]);
    }
#pragma unroll
    for (int n2 = 1; n2 < 4; ++n2) {
#pragma unroll
      for (int k1 = 1; k1 < 4; ++k1)
        y[n2][k1] = cmul(y[n2][k1], tw_of<kInverse, kLogR>(
                                        tw, (n2 * k1) << (kLogR - 4)));
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      dft4<kInverse>(y[0][k1], y[1][k1], y[2][k1], y[3][k1]);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) a[k1 + 4 * k2] = y[k2][k1];
    }
  }
}

// The shared-memory block of a pass of radix R = 2^kLogR: G = 4096 / R
// lines of R words. Word r of line g sits at g L + r + r / 16: the skew
// keeps a radix-16 stage's stride-16 stores on distinct banks, and L's pad
// keeps the G words of one r (the strided loads and stores) apart too.
template <int kLogR>
struct Block {
  static constexpr int kR = 1 << kLogR;
  static constexpr int kLogG = kLogElems - kLogR;
  static constexpr int kG = 1 << kLogG;
  static constexpr int kRaw = kR + kR / 16;
  // G >= 8 lines: L odd; 2 or 4 (R of 2048 or 1024, kRaw a multiple of
  // 8): L = 8 / G mod 8.
  static constexpr int kLine = kLogG >= 3 ? (kRaw | 1) : kRaw + (8 >> kLogG);
  static constexpr int kTw = kR >= 4 ? kR / 4 : 1;
  static constexpr int kSmemBytes = (kG * kLine + kTw) * 16;
  static __device__ __forceinline__ int at(int g, int r) {
    return g * kLine + r + (r >> 4);
  }
};

// The radix of the in-block stage at sub-length 2^log_s: 16 while four
// bits remain, then what is left (2, 4 or 8).
__host__ __device__ constexpr int stage_log_q(int log_r, int log_s) {
  return log_r - log_s >= 4 ? 4 : log_r - log_s;
}

// One Stockham stage of every line's R-point DFT, then the next: radix
// Q = 2^kLogQ after sub-length s = 2^kLogS; butterfly jj of a line reads
// u[t] = line[jj + t R / Q], twiddles it by W_{Q s}^{t (jj mod s)} and
// writes its DFT to line[(jj / s) Q s + jj mod s + t s]. Each thread's
// butterflies stay in registers between the two barriers, so the stage
// runs in place.
template <bool kInverse, int kLogR, int kLogS>
__device__ __forceinline__ void block_stages(double2* smem,
                                             const double2* tw) {
  if constexpr (kLogS < kLogR) {
    using B = Block<kLogR>;
    constexpr int kLogQ = stage_log_q(kLogR, kLogS);
    constexpr int kQ = 1 << kLogQ;
    constexpr int kPer = kElems / kQ / kBlock;
    constexpr int kLogSpan = kLogR - kLogQ;  // butterflies a line: R / Q
    double2 u[kPer][kQ];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int b = threadIdx.x + i * kBlock;
      const int g = b >> kLogSpan, jj = b & ((1 << kLogSpan) - 1);
      const int k = jj & ((1 << kLogS) - 1);
#pragma unroll
      for (int t = 0; t < kQ; ++t) {
        u[i][t] = smem[B::at(g, jj + (t << kLogSpan))];
        if constexpr (kLogS > 0) {
          if (t > 0)
            u[i][t] = cmul(u[i][t], tw_of<kInverse, kLogR>(
                                        tw, (t * k) << (kLogSpan - kLogS)));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int b = threadIdx.x + i * kBlock;
      const int g = b >> kLogSpan, jj = b & ((1 << kLogSpan) - 1);
      dft<kInverse, kLogR, kLogQ>(u[i], tw);
      const int r0 = ((jj >> kLogS) << (kLogS + kLogQ)) +
                     (jj & ((1 << kLogS) - 1));
#pragma unroll
      for (int t = 0; t < kQ; ++t)
        smem[B::at(g, r0 + (t << kLogS))] = u[i][t];
    }
    __syncthreads();
    block_stages<kInverse, kLogR, kLogS + kLogQ>(smem, tw);
  }
}

// One pass: lines (row, j), j in [0, 2^log_m), of the radix-R stage after
// ns = 2^log_ns; line j of a row reads src[j + r 2^log_m] (r < R),
// twiddled by W_{ns R}^{r (j mod ns)}, and writes its DFT to dst[(j / ns)
// ns R + j mod ns + r ns]. Rows are src_stride / dst_stride words apart;
// src may be dst (the last pass reads and writes the same words, each
// block its own).
template <bool kInverse, int kLogR>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    fft_pass(const double2* src, long long src_stride, double2* dst,
             long long dst_stride, long long lines, int log_m, int log_ns) {
  using B = Block<kLogR>;
  extern __shared__ double2 smem[];
  double2* tw = smem + B::kG * B::kLine;  // W_R^e, e < R / 4
  for (int e = threadIdx.x; e < B::kTw; e += kBlock)
    tw[e] = twiddle(e, B::kR, kInverse);
  const long long line0 = static_cast<long long>(blockIdx.x) << B::kLogG;
  const long long m_mask = (1LL << log_m) - 1;
  const long long ns_mask = (1LL << log_ns) - 1;

#pragma unroll
  for (int i = 0; i < kElems / kBlock; ++i) {
    const int f = threadIdx.x + i * kBlock;
    const int r = f >> B::kLogG, g = f & (B::kG - 1);
    const long long line = line0 + g;
    if (line >= lines) continue;
    const long long row = line >> log_m, j = line & m_mask;
    double2 v =
        src[row * src_stride + j + (static_cast<long long>(r) << log_m)];
    if (log_ns > 0)
      v = cmul(v, twiddle(static_cast<long long>(r) * (j & ns_mask),
                          static_cast<long long>(B::kR) << log_ns, kInverse));
    smem[B::at(g, r)] = v;
  }
  __syncthreads();
  block_stages<kInverse, kLogR, 0>(smem, tw);

#pragma unroll
  for (int i = 0; i < kElems / kBlock; ++i) {
    // The first pass writes each line's R words contiguously; later ones
    // write the G lines' words of one r side by side.
    const int f = threadIdx.x + i * kBlock;
    const int g = log_ns == 0 ? f >> kLogR : f & (B::kG - 1);
    const int r = log_ns == 0 ? f & (B::kR - 1) : f >> B::kLogG;
    const long long line = line0 + g;
    if (line >= lines) continue;
    const long long row = line >> log_m, j = line & m_mask;
    dst[row * dst_stride + ((j >> log_ns) << (log_ns + kLogR)) +
        (j & ns_mask) + (static_cast<long long>(r) << log_ns)] =
        smem[B::at(g, r)];
  }
}

// rfft's split pass: Z (the packed transform, row stride z_stride) into X
// (n + 1 bins a row, stride x_stride). Thread k in [0, n/2] reads Z[k] and
// Z[n-k] and writes X[k] and X[n-k] only, so Z may be X itself.
__global__ void split_forward(const double2* z_rows, long long z_stride,
                              double2* x_rows, long long x_stride,
                              long long n) {
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
  const double2 t = cmul(twiddle(k, 2 * n, false), o);
  x[k] = cadd(e, t);
  if (n - k != k) x[n - k] = conjg(csub(e, t));
}

// irfft's pre-pass: X (n + 1 bins, stride x_stride) into the packed
// spectrum Z (stride z_stride), scaled by 1 / n. The imaginary parts of
// bins 0 and n are dropped.
__global__ void split_inverse(const double2* __restrict__ x_rows,
                              long long x_stride, double2* __restrict__ z_rows,
                              long long z_stride, long long n) {
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
  const double2 o = cmul(d, twiddle(k, 2 * n, true));
  // z = e + i o; its partner conj(e) + i conj(o).
  z[k] = make_double2((e.x - o.y) * inv_n, (e.y + o.x) * inv_n);
  if (n - k != k)
    z[n - k] = make_double2((e.x + o.y) * inv_n, (o.x - e.y) * inv_n);
}

unsigned blocks_for(long long count) {
  return static_cast<unsigned>((count + kBlock - 1) / kBlock);
}

int log2_of(long long n) {
  int s = 0;
  while ((1LL << s) < n) ++s;
  return s;
}

bool power_of_two(long long n) { return n >= 1 && (n & (n - 1)) == 0; }

struct Plan {
  int passes = 0;
  int log_n = 0;
  int log_r[kMaxPasses] = {0, 0, 0};
};

// The passes of factors (f1, f2, f3): each 1 (no pass) or a power of two
// <= 2048, their product n; false when they are not.
bool plan_of(long long n, long long rows, int f1, int f2, int f3, Plan* p) {
  if (!power_of_two(n) || rows < 1 || rows > 65535) return false;
  const int factors[kMaxPasses] = {f1, f2, f3};
  long long product = 1;
  for (int f : factors) {
    if (!power_of_two(f) || log2_of(f) > kMaxLogFactor) return false;
    product *= f;
    if (f > 1) p->log_r[p->passes++] = log2_of(f);
  }
  p->log_n = log2_of(n);
  return product == n;
}

template <bool kInverse, int kLogR>
cudaError_t launch_pass(const double2* src, long long src_stride,
                        double2* dst, long long dst_stride, long long lines,
                        int log_m, int log_ns, cudaStream_t s) {
  using B = Block<kLogR>;
  const cudaError_t err = cudaFuncSetAttribute(
      fft_pass<kInverse, kLogR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      B::kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      static_cast<unsigned>((lines + B::kG - 1) >> B::kLogG);
  fft_pass<kInverse, kLogR><<<grid, kBlock, B::kSmemBytes, s>>>(
      src, src_stride, dst, dst_stride, lines, log_m, log_ns);
  return cudaGetLastError();
}

template <bool kInverse>
cudaError_t dispatch_pass(int log_r, const double2* src, long long src_stride,
                          double2* dst, long long dst_stride, long long lines,
                          int log_m, int log_ns, cudaStream_t s) {
  switch (log_r) {
#define PDP_PASS(L)                                                       \
  case L:                                                                 \
    return launch_pass<kInverse, L>(src, src_stride, dst, dst_stride,     \
                                    lines, log_m, log_ns, s);
    PDP_PASS(1) PDP_PASS(2) PDP_PASS(3) PDP_PASS(4) PDP_PASS(5) PDP_PASS(6)
    PDP_PASS(7) PDP_PASS(8) PDP_PASS(9) PDP_PASS(10) PDP_PASS(11)
#undef PDP_PASS
    default:
      return cudaErrorInvalidValue;
  }
}

// The passes from src: pass i < last writes out or work, alternating so
// that the next-to-last lands in out; the last runs in out in place (or
// src -> out for a one-pass plan).
int run_passes(const double2* src, long long src_stride, double2* out,
               long long out_stride, double2* work, long long work_stride,
               long long rows, const Plan& p, bool inverse, cudaStream_t s) {
  int log_ns = 0;
  const double2* cur = src;
  long long cur_stride = src_stride;
  for (int i = 0; i < p.passes; ++i) {
    double2* dst = out;
    long long dst_stride = out_stride;
    if (i < p.passes - 1 && (p.passes - 2 - i) % 2 == 1) {
      if (work == nullptr) return -1;
      dst = work;
      dst_stride = work_stride;
    }
    const int log_r = p.log_r[i];
    const int log_m = p.log_n - log_r;
    const long long lines = rows << log_m;
    const cudaError_t err =
        inverse ? dispatch_pass<true>(log_r, cur, cur_stride, dst, dst_stride,
                                      lines, log_m, log_ns, s)
                : dispatch_pass<false>(log_r, cur, cur_stride, dst,
                                       dst_stride, lines, log_m, log_ns, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = dst;
    cur_stride = dst_stride;
    log_ns += log_r;
  }
  return 0;
}

}  // namespace

// rfft of rows of real float64[2n] (x, contiguous) into complex128[rows,
// n + 1] (out) by the plan (f1, f2, f3) (kernels.pld_fft_plan, padded with
// 1); work: complex128[rows, n], needed by plans of three passes only
// (nullable otherwise).
extern "C" int pld_rfft(const void* x, long long rows, long long n, int f1,
                        int f2, int f3, void* out, void* work, void* stream) {
  Plan p;
  if (!plan_of(n, rows, f1, f2, f3, &p)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double2* o = static_cast<double2*>(out);
  const double2* z = static_cast<const double2*>(x);
  long long z_stride = n;
  if (p.passes > 0) {
    const int status =
        run_passes(z, n, o, n + 1, static_cast<double2*>(work), n, rows, p,
                   false, s);
    if (status != 0) return status;
    z = o;
    z_stride = n + 1;
  }
  const dim3 grid(blocks_for((n >> 1) + 1), static_cast<unsigned>(rows));
  split_forward<<<grid, kBlock, 0, s>>>(z, z_stride, o, n + 1, n);
  return static_cast<int>(cudaGetLastError());
}

// irfft(n=2n) of rows of complex128[n + 1] (spec) into real float64[rows,
// 2n] (out, contiguous) by the plan (f1, f2, f3); work: complex128[rows,
// n], needed by plans of two passes or more (nullable otherwise).
extern "C" int pld_irfft(const void* spec, long long rows, long long n,
                         int f1, int f2, int f3, void* out, void* work,
                         void* stream) {
  Plan p;
  if (!plan_of(n, rows, f1, f2, f3, &p)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double2* o = static_cast<double2*>(out);
  double2* w = static_cast<double2*>(work);
  // The pre-pass writes the buffer the first pass does not write, so that
  // the passes end in `out`.
  double2* first = o;
  if (p.passes >= 2 && p.passes % 2 == 0) {
    if (w == nullptr) return -1;
    first = w;
  }
  const dim3 grid(blocks_for((n >> 1) + 1), static_cast<unsigned>(rows));
  split_inverse<<<grid, kBlock, 0, s>>>(static_cast<const double2*>(spec),
                                        n + 1, first, n, n);
  const int status = run_passes(first, n, o, n, w, n, rows, p, true, s);
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
