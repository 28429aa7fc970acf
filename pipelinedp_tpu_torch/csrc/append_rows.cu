// C14 append_rows: the streamed ingest's device row buffers.
//
// Replaces K17, pipelinedp_tpu/runtime/pipeline.py _append_fn (:305) and
// _grow_fn (:325): the streaming accumulator keeps (pid, pk, values)
// columns in persistent power-of-two device buffers; a chunk lands at a
// row offset, and a buffer that is full grows to a larger power of two
// whose tail carries the pad values ((0, -1, 0) on the host-encoded route,
// the hash sentinel's bit pattern on the hash route), so the final buffers
// equal executor.pad_rows over the concatenated rows.
//
// The chunk rows themselves reach the buffer by an asynchronous copy from
// pinned host memory (runtime/pipeline.py); this source is what writes on
// the device, both entries one launch over up to three columns (grid.y a
// column, a grid-stride loop over its elements):
//   * fill_tail: every column's pad value over rows [start, cap);
//   * grow: every column copied into its new, larger buffer, whose rows
//     past the old capacity take the pad value.
// A column is [cap] or [cap, width] of 4- or 8-byte elements; a pad value
// arrives as its bit pattern.
//
// Bound: bytes. grow reads the old buffers and writes the new ones once;
// fill_tail writes the tail once.
#include "common.cuh"

namespace {

constexpr int kMaxColumns = 3;

struct Column {
  void* dst;
  const void* src;       // null: nothing copied
  long long copy_elems;  // elements [0, copy_elems) copied from src
  long long fill_begin;  // elements [fill_begin, fill_end) take the pad
  long long fill_end;
  unsigned long long fill;  // the pad value's bit pattern
  int elem_bytes;           // 4 or 8
};

struct Columns {
  Column c[kMaxColumns];
};

template <typename W>
__device__ __forceinline__ void write_column(const Column& col, long long t,
                                             long long stride) {
  W* dst = static_cast<W*>(col.dst);
  const W* src = static_cast<const W*>(col.src);
  for (long long i = t; i < col.copy_elems; i += stride) dst[i] = src[i];
  const W fill = static_cast<W>(col.fill);
  for (long long i = col.fill_begin + t; i < col.fill_end; i += stride)
    dst[i] = fill;
}

__global__ void write_columns(Columns cols) {
  const Column& col = cols.c[blockIdx.y];
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (col.elem_bytes == 8)
    write_column<uint64_t>(col, t, stride);
  else
    write_column<uint32_t>(col, t, stride);
}

int launch(const Columns& cols, int n_cols, cudaStream_t s) {
  long long most = 0;
  for (int j = 0; j < n_cols; ++j) {
    const Column& c = cols.c[j];
    if (c.elem_bytes != 4 && c.elem_bytes != 8) return -1;
    const long long fill = c.fill_end - c.fill_begin;
    most = c.copy_elems > most ? c.copy_elems : most;
    most = fill > most ? fill : most;
  }
  if (n_cols <= 0 || most <= 0) return 0;
  constexpr int kBlock = 256;
  constexpr long long kMaxBlocks = 132 * 16;  // enough to fill every SM
  long long blocks = (most + kBlock - 1) / kBlock;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  write_columns<<<dim3(static_cast<unsigned>(blocks),
                       static_cast<unsigned>(n_cols)),
                  kBlock, 0, s>>>(cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Column j (of n_cols <= 3): buffer bufs[j] of cap rows of widths[j]
// elements of elem_bytes[j] bytes; rows [start, cap) take fills[j].
extern "C" int append_rows_fill_tail(void* const* bufs, const int* widths,
                                     const int* elem_bytes,
                                     const unsigned long long* fills,
                                     int n_cols, long long start,
                                     long long cap, void* stream) {
  if (n_cols < 0 || n_cols > kMaxColumns || start < 0 || start > cap)
    return -1;
  Columns cols{};
  for (int j = 0; j < n_cols; ++j) {
    cols.c[j] = Column{bufs[j], nullptr, 0, start * widths[j],
                       cap * widths[j], fills[j], elem_bytes[j]};
  }
  return launch(cols, n_cols, static_cast<cudaStream_t>(stream));
}

// Column j: olds[j] of old_cap rows copied into news[j] of new_cap rows,
// whose rows [old_cap, new_cap) take fills[j].
extern "C" int append_rows_grow(const void* const* olds, void* const* news,
                                const int* widths, const int* elem_bytes,
                                const unsigned long long* fills, int n_cols,
                                long long old_cap, long long new_cap,
                                void* stream) {
  if (n_cols < 0 || n_cols > kMaxColumns || old_cap < 0 || old_cap > new_cap)
    return -1;
  Columns cols{};
  for (int j = 0; j < n_cols; ++j) {
    cols.c[j] = Column{news[j], olds[j], old_cap * widths[j],
                       old_cap * widths[j], new_cap * widths[j], fills[j],
                       elem_bytes[j]};
  }
  return launch(cols, n_cols, static_cast<cudaStream_t>(stream));
}
