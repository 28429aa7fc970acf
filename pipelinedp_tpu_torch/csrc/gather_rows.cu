// C11 gather_rows: several columns gathered through one row index.
//
// Replaces the O(kept) survivor download of the host-staged regime, K15a,
// pipelinedp_tpu/parallel/large_p.py _bound_and_compact_host_staged
// (:670-676): there each chunk's compaction sort has already carried the
// payload columns, so the host fetches their first k rows. The port's
// pass 1 sorts only a permutation (C5), so a chunk's k survivors are
// gathered through it here, on the card, and only their O(kept) bytes
// cross to the host: pair_start (1 B), the C2 columns (4 or 8 B) and the
// bounding order's row index, then, through that index, the value rows
// (D elements of 4 or 8 B).
//
// out[c][i, d] = in[c][index[i], d] for up to kMaxColumns columns of 1-,
// 4- or 8-byte elements and width D (1 for a [n] column). One thread an
// output element; blockIdx.y picks the column, so every column's copy is
// one coalesced write stream and one gather read stream. A row's D
// elements are neighbours, so a wide row reads as one run.
//
// Bound: bytes. Reads the index (8 B a row) and each column's gathered
// elements once, writes each output element once.
#include "common.cuh"

namespace {

constexpr int kMaxColumns = 8;

struct Columns {
  const void* in[kMaxColumns];
  void* out[kMaxColumns];
  int bytes[kMaxColumns];
  int width[kMaxColumns];
};

template <typename T>
__device__ __forceinline__ void move(const void* in, void* out,
                                     long long src, long long dst) {
  static_cast<T*>(out)[dst] = static_cast<const T*>(in)[src];
}

__global__ void gather_kernel(const long long* __restrict__ index,
                              long long k, Columns cols) {
  const int c = blockIdx.y;
  const long long w = cols.width[c];
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= k * w) return;
  const long long row = e / w;
  const long long src = index[row] * w + (e - row * w);
  switch (cols.bytes[c]) {
    case 1:
      move<uint8_t>(cols.in[c], cols.out[c], src, e);
      break;
    case 4:
      move<uint32_t>(cols.in[c], cols.out[c], src, e);
      break;
    default:
      move<unsigned long long>(cols.in[c], cols.out[c], src, e);
      break;
  }
}

}  // namespace

// index: int64[k], each in [0, n) of every input column; in / out: n_cols
// device pointers (host arrays); bytes: 1, 4 or 8 a column; width: the
// elements of a row (1 for a [n] column). Returns cudaErrorInvalidValue
// for more than kMaxColumns columns or another element size.
extern "C" int gather_rows(const void* index, long long k,
                           const void* const* in, void* const* out,
                           const int* bytes, const int* width, int n_cols,
                           void* stream) {
  if (n_cols > kMaxColumns) return static_cast<int>(cudaErrorInvalidValue);
  Columns cols{};
  long long widest = 0;
  for (int c = 0; c < n_cols; ++c) {
    if (bytes[c] != 1 && bytes[c] != 4 && bytes[c] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.in[c] = in[c];
    cols.out[c] = out[c];
    cols.bytes[c] = bytes[c];
    cols.width[c] = width[c];
    if (width[c] > widest) widest = width[c];
  }
  if (k <= 0 || n_cols <= 0 || widest <= 0) return 0;
  constexpr int kBlock = 256;
  const dim3 grid(static_cast<unsigned>((k * widest + kBlock - 1) / kBlock),
                  static_cast<unsigned>(n_cols));
  gather_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(index), k, cols);
  return static_cast<int>(cudaGetLastError());
}
