// C1 row_keys: the bounding sort's keys and the per-row uniform, one
// thread per row.
//
// Replaces, from pipelinedp_tpu/executor.py: the sentinel masking at
// :347-348, `_hash_mix` / `_pair_hash` (:277, :287, the salted murmur3 pair
// hash) and `jax.random.uniform(key_linf, (n,))` (:382, threefry K1).
//
// Output keys, sorted lexicographically, give the order of the JAX
// package's 5-key bounding sort (pid, hash0, hash1, pk, u):
//   k1 = pid << 32 | hash0                      (pid >= 0, so signed order)
//   k2 = (hash1 ^ 0x80000000) << 32 | pk        (signed order = unsigned)
//   u  = uniform(key_linf)[i]                   (F = float or double)
// Invalid rows take pid = INT32_MAX and pk = n_partitions, as in JAX.
// Standalone selection sorts by (k1, k2) alone and passes u = null.
//
// A second entry, total_keys, writes the total-bound sort key of
// executor.py:366-370 (max_contributions): pid (INT32_MAX where invalid)
// and uniform(key_total)[i], sorted by (pid, u) before the bounding sort.
//
// The lane entry, row_keys_lanes (K24, executor.py:984 and :1141, the
// megabatched service's vmap over job lanes): L jobs' rows as one stream
// of L * n, lane = i / n. Each lane has its own salts and key_linf (rows
// of a [L, 6] table: four salts, two key words), and the uniform's
// counter is the row's index within its lane, i % n, so lane l's keys
// and uniforms are its solo run's. It also writes the lane as an int32
// word, the most significant word of the bounding sort.
//
// Its total-bound form, total_keys_lanes (max_contributions a lane,
// executor.py:366-374 under vmap), writes lane << 32 | pid_sent as one
// int64 word and each lane's uniform(key_total) at the lane-local counter
// i % n: sorting by (that word, u) sorts every lane's rows as its solo run
// sorts them, within the lane's own block of n positions, and a run of
// equal words never crosses a lane start.
//
// Bound: bytes. Reads pid, pk (4 B each) and valid (1 B), writes k1, k2
// (8 B each) and u (sizeof(F)); the 20 threefry rounds and 8 hash mixes
// are ~150 integer operations a row, well under the card's integer rate at
// these bytes. Consecutive threads take consecutive rows, so every load
// and store is coalesced.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t hash_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <typename F>
__global__ void row_keys_kernel(const int32_t* __restrict__ pid,
                                const int32_t* __restrict__ pk,
                                const uint8_t* __restrict__ valid,
                                long long n, int32_t n_partitions,
                                uint4 salts, uint32_t key0, uint32_t key1,
                                long long* __restrict__ k1,
                                long long* __restrict__ k2,
                                F* __restrict__ u) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const bool v = valid[i] != 0;
    const uint32_t p = v ? static_cast<uint32_t>(pid[i]) : 0x7FFFFFFFu;
    const uint32_t q = v ? static_cast<uint32_t>(pk[i])
                         : static_cast<uint32_t>(n_partitions);
    const uint32_t h = hash_mix(p * 0x9E3779B9u + salts.x);
    const uint32_t lane0 = hash_mix(h ^ hash_mix(q + salts.y));
    const uint32_t h2 = hash_mix(p * 0x85EBCA6Bu + salts.z);
    const uint32_t lane1 = hash_mix(h2 ^ hash_mix(q + salts.w));
    k1[i] = static_cast<long long>((static_cast<uint64_t>(p) << 32) | lane0);
    k2[i] = static_cast<long long>(
        (static_cast<uint64_t>(lane1 ^ 0x80000000u) << 32) | q);
    if (u) u[i] = pdp::uniform<F>(key0, key1, static_cast<uint64_t>(i), F(0),
                                  F(1));
  }
}

template <typename F>
__global__ void total_keys_kernel(const int32_t* __restrict__ pid,
                                  const uint8_t* __restrict__ valid,
                                  long long n, uint32_t key0, uint32_t key1,
                                  int32_t* __restrict__ pid_sent,
                                  F* __restrict__ u) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    pid_sent[i] = valid[i] ? pid[i] : 0x7FFFFFFF;
    u[i] = pdp::uniform<F>(key0, key1, static_cast<uint64_t>(i), F(0), F(1));
  }
}

template <typename F>
__global__ void row_keys_lanes_kernel(const int32_t* __restrict__ pid,
                                      const int32_t* __restrict__ pk,
                                      const uint8_t* __restrict__ valid,
                                      long long n, long long lane_rows,
                                      int32_t n_partitions,
                                      const uint32_t* __restrict__ table,
                                      int32_t* __restrict__ lane_out,
                                      long long* __restrict__ k1,
                                      long long* __restrict__ k2,
                                      F* __restrict__ u) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long lane = i / lane_rows;
    const uint32_t* t = table + lane * 6;
    const bool v = valid[i] != 0;
    const uint32_t p = v ? static_cast<uint32_t>(pid[i]) : 0x7FFFFFFFu;
    const uint32_t q = v ? static_cast<uint32_t>(pk[i])
                         : static_cast<uint32_t>(n_partitions);
    const uint32_t h = hash_mix(p * 0x9E3779B9u + t[0]);
    const uint32_t lane0 = hash_mix(h ^ hash_mix(q + t[1]));
    const uint32_t h2 = hash_mix(p * 0x85EBCA6Bu + t[2]);
    const uint32_t lane1 = hash_mix(h2 ^ hash_mix(q + t[3]));
    lane_out[i] = static_cast<int32_t>(lane);
    k1[i] = static_cast<long long>((static_cast<uint64_t>(p) << 32) | lane0);
    k2[i] = static_cast<long long>(
        (static_cast<uint64_t>(lane1 ^ 0x80000000u) << 32) | q);
    if (u)
      u[i] = pdp::uniform<F>(t[4], t[5],
                             static_cast<uint64_t>(i - lane * lane_rows),
                             F(0), F(1));
  }
}

template <typename F>
__global__ void total_keys_lanes_kernel(const int32_t* __restrict__ pid,
                                        const uint8_t* __restrict__ valid,
                                        long long n, long long lane_rows,
                                        const uint32_t* __restrict__ keys,
                                        long long* __restrict__ lane_pid,
                                        F* __restrict__ u) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long lane = i / lane_rows;
    const uint32_t p = valid[i] ? static_cast<uint32_t>(pid[i]) : 0x7FFFFFFFu;
    lane_pid[i] = (lane << 32) | static_cast<long long>(p);
    u[i] = pdp::uniform<F>(keys[2 * lane], keys[2 * lane + 1],
                           static_cast<uint64_t>(i - lane * lane_rows), F(0),
                           F(1));
  }
}

unsigned blocks_for(long long n, int threads) {
  const long long want = (n + threads - 1) / threads;
  return static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
}

template <typename F>
int launch(const void* pid, const void* pk, const void* valid, long long n,
           int n_partitions, const unsigned* salts, unsigned key0,
           unsigned key1, void* k1, void* k2, void* u, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  row_keys_kernel<F><<<blocks_for(n, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(pk),
      static_cast<const uint8_t*>(valid), n, n_partitions,
      make_uint4(salts[0], salts[1], salts[2], salts[3]), key0, key1,
      static_cast<long long*>(k1), static_cast<long long*>(k2),
      static_cast<F*>(u));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_total(const void* pid, const void* valid, long long n,
                 unsigned key0, unsigned key1, void* pid_sent, void* u,
                 void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  total_keys_kernel<F><<<blocks_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pid), static_cast<const uint8_t*>(valid), n,
      key0, key1, static_cast<int32_t*>(pid_sent), static_cast<F*>(u));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_lanes(const void* pid, const void* pk, const void* valid,
                 long long n, long long lane_rows, int n_partitions,
                 const void* table, void* lane, void* k1, void* k2, void* u,
                 void* stream) {
  if (n <= 0) return 0;
  if (lane_rows <= 0 || n % lane_rows != 0) return -1;
  const int threads = 256;
  row_keys_lanes_kernel<F><<<blocks_for(n, threads), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(pk),
      static_cast<const uint8_t*>(valid), n, lane_rows, n_partitions,
      static_cast<const uint32_t*>(table), static_cast<int32_t*>(lane),
      static_cast<long long*>(k1), static_cast<long long*>(k2),
      static_cast<F*>(u));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_total_lanes(const void* pid, const void* valid, long long n,
                       long long lane_rows, const void* keys, void* lane_pid,
                       void* u, void* stream) {
  if (n <= 0) return 0;
  if (lane_rows <= 0 || n % lane_rows != 0) return -1;
  const int threads = 256;
  total_keys_lanes_kernel<F><<<blocks_for(n, threads), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pid), static_cast<const uint8_t*>(valid),
      n, lane_rows, static_cast<const uint32_t*>(keys),
      static_cast<long long*>(lane_pid), static_cast<F*>(u));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int row_keys(const void* pid, const void* pk, const void* valid,
                        long long n, int n_partitions, const unsigned* salts,
                        unsigned key0, unsigned key1, void* k1, void* k2,
                        void* u, int f64, void* stream) {
  return f64 ? launch<double>(pid, pk, valid, n, n_partitions, salts, key0,
                              key1, k1, k2, u, stream)
             : launch<float>(pid, pk, valid, n, n_partitions, salts, key0,
                             key1, k1, k2, u, stream);
}

// key = key_total; writes pid_sent (int32) and u (F = float or double).
extern "C" int total_keys(const void* pid, const void* valid, long long n,
                          unsigned key0, unsigned key1, void* pid_sent,
                          void* u, int f64, void* stream) {
  return f64 ? launch_total<double>(pid, valid, n, key0, key1, pid_sent, u,
                                    stream)
             : launch_total<float>(pid, valid, n, key0, key1, pid_sent, u,
                                   stream);
}

// n = L * lane_rows rows of L lanes; table: the lanes' [L, 6] u32 rows
// (salts[4], key_linf[2]) on the device; writes lane (int32), k1, k2 and
// u (null: no uniform, standalone selection).
extern "C" int row_keys_lanes(const void* pid, const void* pk,
                              const void* valid, long long n,
                              long long lane_rows, int n_partitions,
                              const void* table, void* lane, void* k1,
                              void* k2, void* u, int f64, void* stream) {
  return f64 ? launch_lanes<double>(pid, pk, valid, n, lane_rows,
                                    n_partitions, table, lane, k1, k2, u,
                                    stream)
             : launch_lanes<float>(pid, pk, valid, n, lane_rows,
                                   n_partitions, table, lane, k1, k2, u,
                                   stream);
}

// The total-bound lane entry: n = L * lane_rows rows; keys: the lanes'
// key_total, u32 [L, 2] on the device; writes lane_pid (int64, lane << 32
// | pid with INT32_MAX where invalid) and u (F).
extern "C" int total_keys_lanes(const void* pid, const void* valid,
                                long long n, long long lane_rows,
                                const void* keys, void* lane_pid, void* u,
                                int f64, void* stream) {
  return f64 ? launch_total_lanes<double>(pid, valid, n, lane_rows, keys,
                                          lane_pid, u, stream)
             : launch_total_lanes<float>(pid, valid, n, lane_rows, keys,
                                         lane_pid, u, stream);
}
