// C23 reshard_exchange: every valid row of one source shard written
// straight to its final slot on its destination shard.
//
// Replaces K22's exchange, pipelinedp_tpu/parallel/reshard.py
// _exchange_kernel (:133): per shard an argsort by dest, [D, cap_send]
// invalid-padded buckets, one lax.all_to_all per column, then an argsort
// of the received [D * cap_send] rows valid-first, sliced to out_cap.
// That receive order is: source shard 0's rows for this destination in
// their row order, then source 1's, ... then the padding. So the row of
// source s with destination d and rank r (C22) lands at
// offset[s][d] + r, offset[s][d] = sum over s' < s of count[s'][d], and
// no sort runs. The launch for source s also fills its own shard's
// receive buffer past its received rows, [recv_s, out_cap), with the
// padding row (pid 0, pk -1, values 0, valid false), as the JAX buckets
// are filled.
//
// The caller passes one target a destination: the destination shard's
// output columns and offset[s][d] where that shard lies on the source's
// device (a mesh whose slots share a card: every target), or a staging
// slice of count[s][d] rows on the source's device at offset 0, which
// parallel/collectives.all_to_all then peer-copies into place. One entry
// serves pid, pk, values (float32 or float64, [n] or [n, V]; absent for
// the selection) and valid.
//
// Bound: bytes, each valid row read once (pid 4, pk 4, values 4V or 8V,
// valid 1, dest 4, rank 4) and written once (13 + value bytes), plus the
// padding written: about 2 x (13 + 4V) B a row in float32. Rows scatter
// across D destinations, so the writes are D interleaved streams; each
// thread copies one row, neighbouring threads reading neighbouring rows.
#include "common.cuh"

namespace {

constexpr int kMaxShards = 32;
constexpr int kBlock = 256;

struct Targets {
  int32_t* pid[kMaxShards];
  int32_t* pk[kMaxShards];
  void* values[kMaxShards];
  bool* valid[kMaxShards];
  long long offset[kMaxShards];
};

template <typename W>
__global__ void scatter_rows(const int32_t* __restrict__ pid,
                             const int32_t* __restrict__ pk,
                             const W* __restrict__ values, int width,
                             const int32_t* __restrict__ dest,
                             const int32_t* __restrict__ rank, long long n,
                             int n_shards, Targets t) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const int d = dest[i];
  if (d >= n_shards) return;  // an invalid row goes nowhere
  const long long pos = t.offset[d] + rank[i];
  t.pid[d][pos] = pid[i];
  t.pk[d][pos] = pk[i];
  t.valid[d][pos] = true;
  if (width > 0) {
    W* out = static_cast<W*>(t.values[d]) + pos * width;
    const W* in = values + i * width;
    for (int k = 0; k < width; ++k) out[k] = in[k];
  }
}

template <typename W>
__global__ void fill_padding(int32_t* __restrict__ pid,
                             int32_t* __restrict__ pk, W* __restrict__ values,
                             int width, bool* __restrict__ valid,
                             long long start, long long end) {
  const long long j = start + static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= end) return;
  pid[j] = 0;
  pk[j] = -1;
  valid[j] = false;
  for (int k = 0; k < width; ++k) values[j * width + k] = W(0);
}

template <typename W>
int launch(const void* pid, const void* pk, const void* values, int width,
           const void* dest, const void* rank, long long n, int n_shards,
           const Targets& t, void* fill_pid, void* fill_pk, void* fill_values,
           void* fill_valid, long long fill_start, long long fill_end,
           cudaStream_t st) {
  if (n > 0)
    scatter_rows<W><<<static_cast<unsigned>((n + kBlock - 1) / kBlock),
                      kBlock, 0, st>>>(
        static_cast<const int32_t*>(pid), static_cast<const int32_t*>(pk),
        static_cast<const W*>(values), width,
        static_cast<const int32_t*>(dest), static_cast<const int32_t*>(rank),
        n, n_shards, t);
  const long long pad = fill_end - fill_start;
  if (pad > 0)
    fill_padding<W><<<static_cast<unsigned>((pad + kBlock - 1) / kBlock),
                      kBlock, 0, st>>>(
        static_cast<int32_t*>(fill_pid), static_cast<int32_t*>(fill_pk),
        static_cast<W*>(fill_values), width, static_cast<bool*>(fill_valid),
        fill_start, fill_end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Source shard's rows: pid, pk int32[n], values [n, width] of value_bytes
// (4 or 8; width 0 and values null for none), dest, rank int32[n] (C22;
// dest sends an invalid row to bucket n_shards, which no target takes).
// Targets, one a destination d < n_shards <= 32: out_pid[d], out_pk[d],
// out_values[d], out_valid[d] and offset[d]. Fill: the source's own
// receive buffer, rows [fill_start, fill_end) set to the padding row.
extern "C" int reshard_exchange(const void* pid, const void* pk,
                                const void* values, int width,
                                int value_bytes, const void* dest,
                                const void* rank, long long n, int n_shards,
                                void* const* out_pid, void* const* out_pk,
                                void* const* out_values,
                                void* const* out_valid,
                                const long long* offset, void* fill_pid,
                                void* fill_pk, void* fill_values,
                                void* fill_valid, long long fill_start,
                                long long fill_end, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards)
    return static_cast<int>(cudaErrorInvalidValue);
  Targets t = {};
  for (int d = 0; d < n_shards; ++d) {
    t.pid[d] = static_cast<int32_t*>(out_pid[d]);
    t.pk[d] = static_cast<int32_t*>(out_pk[d]);
    t.values[d] = out_values[d];
    t.valid[d] = static_cast<bool*>(out_valid[d]);
    t.offset[d] = offset[d];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 0 || value_bytes == 4)
    return launch<uint32_t>(pid, pk, values, width, dest, rank, n, n_shards,
                            t, fill_pid, fill_pk, fill_values, fill_valid,
                            fill_start, fill_end, st);
  if (value_bytes == 8)
    return launch<unsigned long long>(pid, pk, values, width, dest, rank, n,
                                      n_shards, t, fill_pid, fill_pk,
                                      fill_values, fill_valid, fill_start,
                                      fill_end, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
