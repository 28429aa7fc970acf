// C4 release_epilogue: partition selection, noise, metric formulas and the
// release sentinel's flag word.
//
// Replaces, from pipelinedp_tpu: ops/selection_ops.py keep_probabilities /
// sample_keep_decisions (:69, :108, K6), executor.py finalize (:551-639,
// K7) with its jax.random draws (K1), the secure branch of finalize
// (:585-590, ops/secure_noise.py :174, :191, K13), the flag reduction of
// numeric.py _column_flags / _flags_from_kept (:80-107, K9), and their
// vmap over job lanes (executor.py:984, K24).
//
// Per partition p:
//   keep    private selection: est = ceil(row_count / max_rows), the keep
//           probability of the strategy, uniform(key_sel)[p] < probability;
//           public: 1
//   noise   slot s draws element p under its key (the host derives
//           fold_in(fold_in(key_noise, entry), sub) for each slot):
//           Laplace sign(u) * log1p(-|u|) * std / sqrt(2), Gaussian
//           sqrt(2) * erf_inv(u) * std. Secure noise: snap(col) + atom *
//           gran[s], the atom searched in slot s's table with the words
//           bits(k1)[p], bits(k2)[p] of (k1, k2) = split(slot key)
//   outputs count / privacy_id_count / sum / mean / variance with the
//           formulas and operation order of finalize
//   flags   NaN (1), Inf (2), |x| >= max/2 (4) over kept partitions, ORed
//           (order-free, so deterministic).
// The keys come as a lane table, row l [key_sel, then the slot keys] of
// u32 [L, 2 + 2 * n_slots]; the solo entry is one lane. The lane entry runs
// L jobs' partitions as one range of L * P: lane l's partition p draws at
// counter p under row l's keys, and each lane ORs its flags into its own
// word, so a lane's outputs are its solo run's.
//
// Where the time went in the first design (one thread a partition): the
// host.
// Every call built nine ctypes arrays, allocated up to seven tensors and
// zeroed the flag word with a memset of its own; the secure lane entry split
// every slot key in Python (threefry in numpy) and copied the table up
// pageable. On the device one thread ran up to four draws in a row, with a
// 12-13 step dependent table search each when secure, on 70 blocks at
// P = 17,770. So:
//   * the host hands one Plan (kernels._EpiloguePlan, this struct field for
//     field, cached for a release's calls), one packed pointer table and a
//     few scalars; the outputs are views of one allocation; a key table of
//     up to kLaneWords words rides in the launch's parameters, a larger
//     one in one pinned copy; the secure split of a slot key is made once
//     a block into shared memory (pdp::secure_key). A call is one device
//     operation.
//   * a block takes a tile of kTileP partitions; one thread makes each
//     (partition, draw) pair, the selection draw and each used slot's (a
//     warp's 32 draws are of one kind), the draws meet in shared memory,
//     and one thread a partition applies finalize's formulas. P = 17,770 is
//     278 blocks, two and more a card's 132 SMs. Where the tiles alone give
//     every SM kTilesPerSm blocks (the lane entry at 16 x 17,770), a block
//     has one thread a partition, which makes its draws in a row: 256
//     threads would idle three in four through the formulas.
//   * the flag word needs no memset: each block ORs its lanes' bits into a
//     per-stream accumulator (zeroed once, when the wrapper makes it), and
//     the last block to finish (a ticket from the same accumulator) moves
//     every lane's word to the output and zeroes the accumulator for the
//     stream's next call.
//
// Bound: bytes at P = 17,770 (up to 5 F columns read, keep and 5 written);
// each draw is one threefry (~100 integer operations) and a log1p or an
// erf_inv polynomial, a secure draw two threefry and a 12-13 round search
// of its slot's 32 KB table through the read-only cache.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxEntries = 8;
constexpr int kMaxSlots = 8;
constexpr int kTileP = 64;      // partitions a block
constexpr int kThreads = 256;   // a block's threads where the draws spread
// Tiles a card's SMs hold at 64 threads a block before the draws need
// spreading: 16 each (half of an SM's threads).
constexpr int kTilesPerSm = 16;
constexpr int kLaneWords = 512;  // lane key words carried by value

enum Kind { kCount = 0, kPidCount = 1, kSum = 2, kMean = 3, kVariance = 4 };
enum Out { oCount = 1, oPid = 2, oSum = 4, oMean = 8, oVariance = 16 };
// The columns a slot noises (and the pointer table's first five entries).
enum Col { cNone = -1, cCount = 0, cPid = 1, cSum = 2, cNsum = 3, cNsum2 = 4 };

// The host's plan, laid out as kernels._EpiloguePlan: doubles, then ints,
// so neither side pads between them. The keys are the call's, apart.
struct Plan {
  double std[kMaxSlots];
  double gran[kMaxSlots];  // secure noise: each slot's grid
  double sel[14];          // ops/selection_ops.selection_scalars order
  double mid, min_v, max_rows;
  int n_entries;
  int kind[kMaxEntries];
  int outputs[kMaxEntries];
  int offset[kMaxEntries];
  int n_slots;
  int gaussian, degenerate, private_selection;
};

// The launch's parameters: the plan, the call's pointers and what the C
// entry derives from them.
struct Params {
  Plan plan;
  const void* col[5];
  uint8_t* keep;
  void* out[5];  // count, privacy_id_count, sum, mean, variance
  unsigned* flags;
  unsigned* acc;  // [0]: block tickets; [1 + l]: lane l's flag bits
  const unsigned long long* table;
  const unsigned* lane_keys;  // device key table, or null: lane_words
  long long n_partitions;
  int table_len;
  int n_lanes;
  int row_words;
  int n_draws;
  int draw_slot[kMaxSlots + 1];  // -1: the selection draw
  int slot_col[kMaxSlots];
  unsigned lane_words[kLaneWords];
};

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float erfc_(float x) { return erfcf(x); }
__device__ __forceinline__ double erfc_(double x) { return erfc(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }

// ops/selection_ops.keep_probabilities for one privacy-id count estimate.
template <typename F>
__device__ F keep_probability(const Plan& P, F est) {
  const double* s = P.sel;
  const int kind = static_cast<int>(s[0]);
  const F n = est - static_cast<F>(s[1]);
  F prob;
  if (kind == 0) {
    const F eps1 = static_cast<F>(s[2]), n_cross = static_cast<F>(s[4]);
    const F n_eff = pdp::max_nan(n, F(1));
    const F n1 = pdp::min_nan(n_eff, n_cross);
    const F log_pi1 = static_cast<F>(s[6]) + (n1 - F(1)) * eps1 +
                      pdp::log1p_(-exp_(-n1 * eps1)) - static_cast<F>(s[7]);
    const F pi1 = exp_(pdp::min_nan(log_pi1, F(0)));
    const F k = pdp::max_nan(n_eff - n_cross, F(0));
    const F decay = exp_(-k * eps1);
    const F geo = s[10] != 0.0
                      ? static_cast<F>(s[8]) * (F(1) - decay) /
                            static_cast<F>(s[9])
                      : F(0);
    const F q = decay * static_cast<F>(s[13]) - static_cast<F>(s[3]) * geo;
    const F pi2 = F(1) - pdp::max_nan(q, F(0));
    prob = pdp::min_nan(pdp::max_nan(n_eff <= n_cross ? pi1 : pi2, F(0)),
                        F(1));
  } else if (kind == 1) {
    const F z = (n - static_cast<F>(s[11])) / static_cast<F>(s[12]);
    const F az = z < F(0) ? -z : z;
    prob = z >= F(0) ? F(1) - F(0.5) * exp_(-az) : F(0.5) * exp_(-az);
  } else {
    const F z = (static_cast<F>(s[11]) - n) / static_cast<F>(s[12]);
    prob = F(0.5) * erfc_(z / static_cast<F>(1.4142135623730951));
  }
  return n <= F(0) ? F(0) : prob;
}

// Slot s's noised value of col at counter p.
template <typename F>
__device__ __forceinline__ F noised(const Params& P,
                                    const pdp::SecureKey* skey,
                                    const unsigned* lane_key, F col, int s,
                                    uint64_t p) {
  if (P.table) {
    uint32_t uhi, ulo;
    pdp::secure_words(skey[s], p, uhi, ulo);
    return pdp::snapped_release<F>(
        col, uhi, ulo, P.table + static_cast<long long>(s) * P.table_len,
        P.table_len, static_cast<F>(P.plan.gran[s]));
  }
  const F std = static_cast<F>(P.plan.std[s]);
  const unsigned k0 = lane_key[2 + 2 * s], k1 = lane_key[3 + 2 * s];
  if (P.plan.gaussian) return col + pdp::normal<F>(k0, k1, p) * std;
  const F b = std / pdp::sqrt_(F(2));
  return col + pdp::laplace<F>(k0, k1, p) * b;
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const __grid_constant__ Params P) {
  __shared__ F drawn[kMaxSlots + 1][kTileP];  // [0]: selection, [1 + s]
  __shared__ pdp::SecureKey skey[kMaxSlots];
  __shared__ unsigned block_flags;
  __shared__ bool last;
  const Plan& pl = P.plan;
  const int lane = blockIdx.y;
  const long long at = lane * P.n_partitions;  // the lane's first element
  const unsigned* lane_key = (P.lane_keys ? P.lane_keys : P.lane_words) +
                             static_cast<long long>(lane) * P.row_words;
  if (threadIdx.x == 0) block_flags = 0u;
  if (P.table && threadIdx.x < pl.n_slots) {
    const int s = threadIdx.x;
    skey[s] = pdp::secure_key(lane_key[2 + 2 * s], lane_key[3 + 2 * s]);
  }
  __syncthreads();
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  const long long left = P.n_partitions - p0;
  const int np = left < kTileP ? static_cast<int>(left) : kTileP;
  // Every (draw, partition) pair of the tile, draw-major: a warp's 32
  // pairs share their draw.
  for (int d = threadIdx.x; d < P.n_draws * kTileP; d += blockDim.x) {
    const int j = d % kTileP;
    if (j >= np) continue;
    const int s = P.draw_slot[d / kTileP];
    const uint64_t p = static_cast<uint64_t>(p0 + j);
    if (s < 0) {
      drawn[0][j] = pdp::uniform<F>(lane_key[0], lane_key[1], p, F(0), F(1));
    } else {
      const F col = static_cast<const F*>(P.col[P.slot_col[s]])[at + p0 + j];
      drawn[1 + s][j] = noised<F>(P, skey, lane_key, col, s, p);
    }
  }
  __syncthreads();
  unsigned f = 0u;
  if (static_cast<int>(threadIdx.x) < np) {
    const int j = threadIdx.x;
    const long long e = at + p0 + j;
    bool keep = true;
    if (pl.private_selection) {
      const F pid = static_cast<const F*>(P.col[cPid])[e];
      const F est = static_cast<F>(static_cast<long long>(
          ceil_(pid / static_cast<F>(pl.max_rows))));
      keep = drawn[0][j] < keep_probability<F>(pl, est);
    }
    P.keep[e] = keep ? 1 : 0;
    const F mid = static_cast<F>(pl.mid);
    F r_count = 0, r_pid = 0, r_sum = 0, r_mean = 0, r_var = 0;
    for (int k = 0; k < pl.n_entries; ++k) {
      const int off = pl.offset[k];
      switch (pl.kind[k]) {
        case kCount:
          r_count = drawn[1 + off][j];
          break;
        case kPidCount:
          r_pid = drawn[1 + off][j];
          break;
        case kSum:
          r_sum = drawn[1 + off][j];
          break;
        case kMean: {
          const F dp_count = drawn[1 + off][j];
          const F dp_nsum = drawn[2 + off][j];
          const F denom = pdp::max_nan(dp_count, F(1));
          r_mean = mid + dp_nsum / denom;
          if (pl.outputs[k] & oCount) r_count = dp_count;
          if (pl.outputs[k] & oSum) r_sum = r_mean * dp_count;
          break;
        }
        case kVariance: {
          const F dp_count = drawn[1 + off][j];
          const F denom = pdp::max_nan(dp_count, F(1));
          F nmean, nsqmean;
          if (pl.degenerate) {
            nmean = static_cast<F>(pl.min_v);
            nsqmean = nmean * nmean;
          } else {
            nmean = drawn[2 + off][j] / denom;
            nsqmean = drawn[3 + off][j] / denom;
          }
          r_var = nsqmean - nmean * nmean;
          const F dp_mean = pl.degenerate ? nmean + F(0) : nmean + mid;
          if (pl.outputs[k] & oMean) r_mean = dp_mean;
          if (pl.outputs[k] & oCount) r_count = dp_count;
          if (pl.outputs[k] & oSum) r_sum = dp_mean * dp_count;
          break;
        }
      }
    }
    const F r[5] = {r_count, r_pid, r_sum, r_mean, r_var};
#pragma unroll
    for (int o = 0; o < 5; ++o) {
      if (!P.out[o]) continue;
      static_cast<F*>(P.out[o])[e] = r[o];
      if (keep) f |= pdp::value_flags(r[o]);
    }
  }
  f = __reduce_or_sync(pdp::kFullMask, f);
  if ((threadIdx.x & 31) == 0 && f) atomicOr(&block_flags, f);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_flags) atomicOr(P.acc + 1 + lane, block_flags);
    __threadfence();
    last = atomicAdd(P.acc, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  // Every other block has ORed its bits and taken its ticket.
  __threadfence();
  for (int l = threadIdx.x; l < P.n_lanes; l += blockDim.x)
    P.flags[l] = atomicExch(P.acc + 1 + l, 0u);
  if (threadIdx.x == 0) P.acc[0] = 0u;
}

// The slot s <- column c of an entry; false where the slot is outside the
// plan or already noises another column.
bool assign(Params* P, int s, int c) {
  if (s < 0 || s >= P->plan.n_slots) return false;
  if (P->slot_col[s] != cNone && P->slot_col[s] != c) return false;
  P->slot_col[s] = c;
  return true;
}

// The slots' columns and the draws from the plan; -1 on a bad plan.
int derive(Params* P) {
  const Plan& pl = P->plan;
  if (pl.n_entries < 0 || pl.n_entries > kMaxEntries || pl.n_slots < 0 ||
      pl.n_slots > kMaxSlots)
    return -1;
  for (int s = 0; s < kMaxSlots; ++s) P->slot_col[s] = cNone;
  for (int k = 0; k < pl.n_entries; ++k) {
    const int off = pl.offset[k];
    bool ok = true;
    switch (pl.kind[k]) {
      case kCount:
        ok = assign(P, off, cCount);
        break;
      case kPidCount:
        ok = assign(P, off, cPid);
        break;
      case kSum:
        ok = assign(P, off, cSum);
        break;
      case kMean:
        ok = assign(P, off, cCount) && assign(P, off + 1, cNsum);
        break;
      case kVariance:
        ok = assign(P, off, cCount) &&
             (pl.degenerate ||
              (assign(P, off + 1, cNsum) && assign(P, off + 2, cNsum2)));
        break;
      default:
        ok = false;
    }
    if (!ok) return -1;
  }
  P->n_draws = 0;
  if (pl.private_selection) {
    if (!P->col[cPid]) return -1;
    P->draw_slot[P->n_draws++] = -1;
  }
  for (int s = 0; s < pl.n_slots; ++s) {
    if (P->slot_col[s] == cNone) continue;
    if (!P->col[P->slot_col[s]]) return -1;
    P->draw_slot[P->n_draws++] = s;
  }
  return 0;
}

}  // namespace

// The bytes of a Plan (kernels._EpiloguePlan must match).
extern "C" long long release_epilogue_plan_bytes() { return sizeof(Plan); }

// plan: the host planner's Plan. io: int64 addresses, 0 where absent:
//   [0, 5)   the columns count, pid_count, sum, nsum, nsum2 (F[L * P])
//   5        keep (u8[L * P])
//   [6, 11)  the outputs count, privacy_id_count, sum, mean, variance
//   11       flags (u32[L]), written whole by the call
//   12       acc: the stream's accumulator, u32[1 + >= L], zero between
//            calls (the call leaves it so)
//   13       table: the slots' secure tables u64[n_slots, table_len] (0:
//            continuous noise)
//   14, 15   the key table u32[L, 2 + 2 * n_slots] (a lane's key_sel, then
//            its slot keys) in host memory (at most kLaneWords words,
//            copied into the launch) or on the device; the other 0
// n_lanes: L (1: the solo entry); lanes of n_partitions each. One launch;
// returns its status.
extern "C" int release_epilogue(const void* plan, const long long* io,
                                long long n_partitions, int n_lanes,
                                int table_len, int f64, void* stream) {
  static_assert(sizeof(Params) < 4000, "the launch's parameters");
  Params P;
  memset(&P, 0, sizeof(P));
  P.plan = *static_cast<const Plan*>(plan);
  for (int c = 0; c < 5; ++c) P.col[c] = reinterpret_cast<const void*>(io[c]);
  P.keep = reinterpret_cast<uint8_t*>(io[5]);
  for (int o = 0; o < 5; ++o) P.out[o] = reinterpret_cast<void*>(io[6 + o]);
  P.flags = reinterpret_cast<unsigned*>(io[11]);
  P.acc = reinterpret_cast<unsigned*>(io[12]);
  P.table = reinterpret_cast<const unsigned long long*>(io[13]);
  P.n_partitions = n_partitions;
  P.table_len = table_len;
  P.n_lanes = n_lanes;
  P.row_words = 2 + 2 * P.plan.n_slots;
  if (n_partitions < 0 || n_lanes < 1 || n_lanes > 65535 || !P.keep ||
      !P.flags || !P.acc || (io[14] == 0) == (io[15] == 0))
    return -1;
  if (P.table && (table_len < 1 || table_len % 2 == 0)) return -1;
  if (derive(&P) != 0) return -1;
  if (io[15] != 0) {
    P.lane_keys = reinterpret_cast<const unsigned*>(io[15]);
  } else {
    const long long words = static_cast<long long>(n_lanes) * P.row_words;
    if (words > kLaneWords) return -1;
    memcpy(P.lane_words, reinterpret_cast<const void*>(io[14]), words * 4);
  }
  const long long tiles = (n_partitions + kTileP - 1) / kTileP;
  const dim3 grid(static_cast<unsigned>(tiles > 0 ? tiles : 1), n_lanes);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads =
      tiles * n_lanes >= static_cast<long long>(kTilesPerSm) * sms
          ? kTileP
          : kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    epilogue_kernel<double><<<grid, threads, 0, s>>>(P);
  } else {
    epilogue_kernel<float><<<grid, threads, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}
