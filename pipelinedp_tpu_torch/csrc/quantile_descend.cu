// C8 quantile_descend: node noise and the root-to-leaf descent of every
// partition's quantile tree.
//
// Replaces the noise and descent half of K12, pipelinedp_tpu/executor.py:
// _descend_trees (:652-712) over the dense regime's noisy levels
// (quantile_outputs, :881-905) or the lazy regime's per-node keyed noise
// (_node_noise_keys, _noisy_node_counts, :729-764), with the monotone
// cummax over the quantiles (:708-712) and, for the release sentinel, the
// flag bits of the kept partitions' percentiles (numeric.py:80).
//
// One launch a call. A warp takes up to 32 walks (min(32, 512 / B)): the
// (partition, quantile) walks of whole partitions, each partition's on
// consecutive lanes in ascending quantile order (stable), or one
// partition's quantiles in runs of that many. At each level, the walks
// whose node differs from the previous walk's lead; the warp's lanes
// share the drawing of every child of every leading node (a node that
// several quantiles of a partition reach is drawn once: walks in
// ascending quantile order reach non-decreasing nodes) into shared
// memory, and each walk then descends on its own lane: it adds its node's
// B children and their running prefix from 0, left to right (XLA's
// reduce and reduce_window on the CPU), the dense regime's children
// noised once a node, the lazy regime's (whose counts are a walk's own)
// from the shared draws or secure atoms and the walk's counts, which the
// warp stages in shared memory first (each walk's B counts are
// contiguous, so the warp's loads are too). After the
// last level each walk takes the running maximum over its partition's
// quantiles in that order from its neighbour lane, writes quantile j's
// column to out[j, :] and ORs its flag bits, where the partition is
// kept, into the flag word.
//
// Noise is drawn on demand, for the visited nodes only:
//   dense regime  node j of level l at counter p * B^l + j under
//                 fold_in(fold_in(qkey, 0), l - 1): the words the JAX
//                 package draws for the whole level; all levels in one
//                 launch, from C7's level counts.
//   lazy regime   one launch per level, from C7's child counts: child
//                 node id c draws at counter 0 under fold_in(fold_in(
//                 level_key, p), c), the partition's key derived once a
//                 leading walk.
// Secure noise (K13, :748-758 and :885-893): a node's count is snapped to
// the quantile slot's grid plus the atom its table search gives, with the
// words of split(level key) at the dense counter, or of
// bits(fold_in(node key, 0)) and bits(fold_in(node key, 1)) in the lazy
// regime; the clamp at 0 and the descent are the same.
//
// The launch's parameters carry the quantiles and their order (up to
// PDP_DESCEND_VALUE_QUANTILES; more come as device arrays) and the keys:
// the solo entries' own, the lane entries' table up to
// PDP_DESCEND_LANE_WORDS words (a larger table is a device array), so a
// call uploads nothing itself.
//
// The lane entries (K24: the megabatched service's vmap over job lanes,
// executor.py:984) run L jobs' trees as one range of L * P partitions:
// blockIdx.y is the lane, partition p of lane l is row l * P + p of the
// counts, and it draws at its solo counters (p lane-local) under its
// lane's keys, rows of the u32 table: dense, the lane's h level keys (and
// with a secure table their splits, k1 and k2 a level); lazy, the lane's
// level key. Each lane ORs its flags into flags[l]. The regime is the solo
// run's, chosen by P, the same for every lane.
//
// Bound: operations. Each drawn node costs one threefry (~100 integer
// operations; the lazy regime one more for its key) and an erf_inv or a
// log1p, a secure node a table search; the counts read are B ints a walk
// and level.
#include <algorithm>

#include "common.cuh"

#ifndef PDP_DESCEND_VALUE_QUANTILES
#error "build with -DPDP_DESCEND_VALUE_QUANTILES (cuda_build.py)"
#endif
#ifndef PDP_DESCEND_LANE_WORDS
#error "build with -DPDP_DESCEND_LANE_WORDS (cuda_build.py)"
#endif

namespace {

constexpr int kMaxH = 8;
constexpr int kMaxB = 64;
constexpr int kThreads = 128;
// Children a warp holds at once in shared memory (a node's B each): a
// warp takes min(32, kSlots / B) walks at a time.
constexpr int kSlots = 512;
// Warps a dense launch aims at (a card holds ~132 x 36 of them at once).
constexpr long long kTargetWarps = 8192;
constexpr int kValueQ = PDP_DESCEND_VALUE_QUANTILES;
constexpr int kLaneWords = PDP_DESCEND_LANE_WORDS;

struct Params {
  long long n_partitions;  // a lane's
  long long out_stride;    // out's row stride (L * P; P for one job)
  int n_q, height, branching, gaussian;
  int level;      // lazy: the level of this call
  int n_lanes;
  int rows;  // partitions a warp takes (1 where n_q > its walks)
  int lane_words;  // u32 a lane's key row
  double std, min_v, max_v;
  // Secure noise: the quantile slot's packed table (null: continuous
  // noise) and its grid.
  const unsigned long long* table;
  int table_len;
  double gran;
  // Quantiles: q_dev / order_dev when n_q > kValueQ, else q / order.
  const double* q_dev;
  const int* order_dev;
  // Keys of one job: dense, each level's (and split with a table); lazy,
  // key[0] the level key.
  unsigned key[kMaxH][2];
  pdp::SecureKey skey[kMaxH];
  // Lanes: the key table on the device, or null: lane_host.
  const unsigned* lane_dev;
  // Data.
  const int* levels[kMaxH];  // dense: level l's counts int32[rows, B^l]
  const int* counts;         // lazy: int32[rows, n_q, B]
  int* node;                 // lazy state [rows, n_q]
  void* target;
  void* total;
  void* mass;
  const uint8_t* keep;
  void* out;        // F[n_q, out_stride] (lazy: the last level only)
  unsigned* flags;  // one word a lane
  int* leaves;      // dense, nullable: int32[rows, n_q]
  int order[kValueQ];
  double q[kValueQ];
  unsigned lane_host[kLaneWords];
};

// State of one (partition, quantile) walk.
template <typename F>
struct Walk {
  long long node;  // node reached, of the last level descended
  F target;        // remaining rank
  F total;         // the tree's noisy total (level 1)
  F mass;          // noisy count of the node reached
};

// One level of _descend_trees for the walk w, children(b) the noisy,
// clamped count of child b of w.node. The children's sum and the running
// prefix that picks the child are added from 0, left to right (XLA's
// reduce and reduce_window on the CPU). The children are max(x, 0) (NaN
// kept), so the prefix is non-decreasing up to its first NaN and NaN after
// it: the children whose prefix is below the target are a leading run,
// and one pass finds its length, the prefix before it and the child after
// it.
template <typename F, class Children>
__device__ __forceinline__ void descend(int B, int level, F q, Walk<F>& w,
                                        const Children& children) {
  F sum = F(0);
#pragma unroll 8
  for (int b = 0; b < B; ++b) sum = sum + children(b);
  if (level == 1) {
    w.total = sum;
    w.target = q * sum;
  } else {
    w.target = w.target / pdp::max_nan(w.mass, F(1e-12)) * sum;
  }
  F acc = F(0), before = F(0), mass = F(0), prev = F(0);
  int below = 0;
  bool open = true;  // every prefix so far below the target
#pragma unroll 8
  for (int b = 0; b < B; ++b) {
    const F c = children(b);
    prev = acc;
    acc = acc + c;
    if (open && acc < w.target) {
      ++below;
    } else if (open) {
      open = false;
      before = prev;
      mass = c;
    }
  }
  if (open) {  // every child below: the last one
    before = prev;
    mass = children(B - 1);
  }
  const int child = below < B - 1 ? below : B - 1;
  w.target = w.target - (child > 0 ? before : F(0));
  w.node = w.node * B + child;
  w.mass = mass;
}

// The percentile after the last level: leaf interpolation, or the range's
// middle where the noisy total is <= 0.
template <typename F>
__device__ F percentile(const Params& P, const Walk<F>& w, long long leaves) {
  const F lo = static_cast<F>(P.min_v), hi = static_cast<F>(P.max_v);
  const F width = (hi - lo) / static_cast<F>(leaves);
  const F mid = lo + (hi - lo) / F(2);
  const F leaf_count = pdp::max_nan(w.mass, F(1e-12));
  const F leaf_lo = lo + static_cast<F>(static_cast<int>(w.node)) * width;
  const F frac =
      pdp::min_nan(pdp::max_nan(w.target / leaf_count, F(0)), F(1));
  const F value = pdp::min_nan(pdp::max_nan(leaf_lo + frac * width, lo), hi);
  return w.total <= F(0) ? mid : value;
}

template <typename F>
__device__ __forceinline__ F noisy(int count, F draw, F scale) {
  return pdp::max_nan(static_cast<F>(count) + draw * scale, F(0));
}

// The atom of a secure draw's words: the table search of
// pdp::snapped_release, apart, so a node's atom can serve several walks.
__device__ __forceinline__ int secure_atom(const Params& P, uint32_t uhi,
                                           uint32_t ulo) {
  return pdp::table_search(
      P.table, P.table_len, (static_cast<unsigned long long>(uhi) << 32) |
                                ulo);
}

// Two tables searches in step (the atoms of two secure draws), each as
// pdp::table_search: their loads overlap.
__device__ __forceinline__ void secure_atoms2(const Params& P,
                                              const uint32_t (&hi)[2],
                                              const uint32_t (&lo)[2],
                                              int (&atom)[2]) {
  const unsigned long long u0 =
      (static_cast<unsigned long long>(hi[0]) << 32) | lo[0];
  const unsigned long long u1 =
      (static_cast<unsigned long long>(hi[1]) << 32) | lo[1];
  int lo0 = 0, hi0 = P.table_len - 1, lo1 = 0, hi1 = P.table_len - 1;
  while (lo0 < hi0 || lo1 < hi1) {
    if (lo0 < hi0) {
      const int mid = (lo0 + hi0) >> 1;
      if (__ldg(P.table + mid) <= u0) {
        lo0 = mid + 1;
      } else {
        hi0 = mid;
      }
    }
    if (lo1 < hi1) {
      const int mid = (lo1 + hi1) >> 1;
      if (__ldg(P.table + mid) <= u1) {
        lo1 = mid + 1;
      } else {
        hi1 = mid;
      }
    }
  }
  atom[0] = hi0;
  atom[1] = hi1;
}

// A secure node: max(snap(count) + atom * gran, 0), as
// pdp::snapped_release computes it.
template <typename F>
__device__ __forceinline__ F snapped(const Params& P, int count, int atom) {
  const F gran = static_cast<F>(P.gran);
  const F snap = pdp::rint_(static_cast<F>(count) / gran) * gran;
  return pdp::max_nan(
      snap + static_cast<F>(atom - (P.table_len - 1) / 2) * gran, F(0));
}

__device__ __forceinline__ double quantile_at(const Params& P, int j) {
  return P.q_dev ? P.q_dev[j] : P.q[j];
}

__device__ __forceinline__ int order_at(const Params& P, int k) {
  return P.order_dev ? P.order_dev[k] : P.order[k];
}

// The lane of the block's key row (null for one job).
__device__ __forceinline__ const unsigned* lane_row(const Params& P) {
  if (P.n_lanes == 0) return nullptr;
  return (P.lane_dev ? P.lane_dev : P.lane_host) +
         static_cast<long long>(blockIdx.y) * P.lane_words;
}

// Walks a warp takes at once: all 32 lanes, fewer where their nodes'
// children would not fit the warp's kSlots.
__host__ __device__ __forceinline__ int warp_walks(int B) {
  return kSlots / B < 32 ? kSlots / B : 32;
}

// A warp's walks: lane t takes walk k of the lane's partition p (row `row`
// of the counts), the walks of a partition on consecutive lanes in
// ascending quantile order (stable). With n_q <= the warp's walks a warp
// takes whole partitions; above, one partition in runs of `walks`
// quantiles from k0.
struct Slot {
  bool active;
  long long p, row;
  int k, j;
};

__device__ __forceinline__ Slot slot_of(const Params& P, int walks, int lane,
                                        long long warp_id, int k0) {
  Slot s;
  const int rows = P.rows;
  const int per_row = P.n_q <= walks ? P.n_q : walks;
  s.p = warp_id * rows + lane / per_row;
  s.k = k0 + lane % per_row;
  s.active = lane < rows * per_row && s.p < P.n_partitions && s.k < P.n_q;
  s.row = static_cast<long long>(blockIdx.y) * P.n_partitions + s.p;
  s.j = s.active ? order_at(P, s.k) : 0;
  return s;
}

// The warp's walks at distinct nodes: a walk leads where it is the first
// of its partition on the warp or its node differs from the last walk's
// (walks in ascending quantile order reach non-decreasing nodes, so equal
// nodes are neighbours). Returns the lanes that lead; *leader is the
// index, among them, of the walk's own node's leader.
__device__ __forceinline__ unsigned leaders(const Slot& s, long long node,
                                            int lane, int* leader) {
  const long long prev_node = __shfl_up_sync(pdp::kFullMask, node, 1);
  const long long prev_row = __shfl_up_sync(pdp::kFullMask, s.row, 1);
  const bool lead =
      s.active && (lane == 0 || prev_row != s.row || prev_node != node);
  const unsigned mask = __ballot_sync(pdp::kFullMask, lead);
  *leader = __popc(mask & (0xffffffffu >> (31 - lane))) - 1;
  return mask;
}

// The running maximum over a partition's walks in ascending quantile order
// (carry: the maximum before this run's first walk, where there is one),
// the column write and the walk's flag bits.
template <typename F>
__device__ __forceinline__ unsigned emit(const Params& P, const Slot& s,
                                         F v, int per_row, bool has_carry,
                                         F carry, F& run) {
  const int at = s.k % per_row;
  run = v;
  if (has_carry && at == 0) run = pdp::max_nan(carry, run);
  for (int step = 1; step < per_row; ++step) {
    const F before = __shfl_up_sync(pdp::kFullMask, run, 1);
    if (at == step) run = pdp::max_nan(before, run);
  }
  if (!s.active) return 0u;
  static_cast<F*>(P.out)[static_cast<long long>(s.j) * P.out_stride + s.row] =
      run;
  return P.keep[s.row] ? pdp::value_flags(run) : 0u;
}

// The warp's children (or draws, or atoms) of its walks' nodes, B + 1 a
// node (the padding keeps lanes reading one child of different nodes off
// one bank): walks x (B + 1) <= kPadded.
constexpr int kPadded = kSlots + 32;

template <typename F>
__device__ __forceinline__ F* warp_children() {
  __shared__ F children[kThreads / 32 * kPadded];
  return children + (threadIdx.x >> 5) * kPadded;
}

// 4 words a leading walk (its node and key or partition).
__device__ __forceinline__ unsigned* warp_leads() {
  __shared__ unsigned words[kThreads / 32 * 32 * 4];
  return words + (threadIdx.x >> 5) * 32 * 4;
}

// The lazy step's counts of the warp's walks, B + 1 a walk, and each
// walk's row of the counts.
__device__ __forceinline__ int* warp_counts() {
  __shared__ int counts[kThreads / 32 * kPadded];
  return counts + (threadIdx.x >> 5) * kPadded;
}

__device__ __forceinline__ long long* warp_rows() {
  __shared__ long long rows[kThreads];
  return rows + (threadIdx.x & ~31);
}

// x / B for x < 2^16 and B <= 64: the high word of x times
// floor(2^32 / B) + 1 (its error stays below 1 / B).
__device__ __forceinline__ int div_b(int x, unsigned magic) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(x), magic));
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const __grid_constant__ Params P) {
  const int lane = threadIdx.x & 31;
  const int B = P.branching;
  const int walks = warp_walks(B);
  const int per_row = P.n_q <= walks ? P.n_q : walks;
  const long long warp_id =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) +
      (threadIdx.x >> 5);
  const F scale = pdp::noise_scale<F>(P.std, P.gaussian);
  const unsigned* lk = lane_row(P);
  const unsigned magic = 0xffffffffu / B + 1;
  F* kids = warp_children<F>();
  unsigned* lead_words = warp_leads();
  long long leaves = 1;
  for (int l = 0; l < P.height; ++l) leaves *= B;
  unsigned f = 0u;
  F run = F(0), carry = F(0);
  const int runs = P.n_q <= walks ? 1 : (P.n_q + walks - 1) / walks;
  for (int r = 0; r < runs; ++r) {
    const Slot s = slot_of(P, walks, lane, warp_id, r * walks);
    const F q = static_cast<F>(quantile_at(P, s.j));
    Walk<F> w{0, F(0), F(0), F(0)};
    long long width = 1;  // B^level
    for (int level = 1; level <= P.height; ++level) {
      width *= B;
      const int l = level - 1;
      int leader;
      const unsigned lead = leaders(s, w.node, lane, &leader);
      const int n_lead = __popc(lead);
      // The leading walks' partitions and nodes, then every child of every
      // distinct node across the warp's lanes, noised with its count.
      if ((lead >> lane) & 1u) {
        unsigned* mine = lead_words + 4 * leader;
        mine[0] = static_cast<unsigned>(s.p);
        mine[1] = static_cast<unsigned>(s.p >> 32);
        mine[2] = static_cast<unsigned>(w.node);
        mine[3] = static_cast<unsigned>(w.node >> 32);
      }
      __syncwarp();
      pdp::SecureKey sk = P.skey[l];
      if (P.table && lk) {
        const unsigned* w4 = lk + 2 * P.height + 4 * l;
        sk.hi[0] = w4[0];
        sk.hi[1] = w4[1];
        sk.lo[0] = w4[2];
        sk.lo[1] = w4[3];
      }
      const unsigned k0 = lk ? lk[2 * l] : P.key[l][0];
      const unsigned k1 = lk ? lk[2 * l + 1] : P.key[l][1];
      for (int task = lane; task < n_lead * B; task += 32) {
        const int d = div_b(task, magic), b = task - d * B;
        const unsigned* words = lead_words + 4 * d;
        const long long p =
            static_cast<long long>(words[1]) << 32 | words[0];
        const long long node =
            (static_cast<long long>(words[3]) << 32 | words[2]) * B + b;
        const long long row =
            static_cast<long long>(blockIdx.y) * P.n_partitions + p;
        const int count = P.levels[l][row * width + node];
        const uint64_t i = static_cast<uint64_t>(p * width + node);
        if (P.table) {
          uint32_t uhi, ulo;
          pdp::secure_words(sk, i, uhi, ulo);
          kids[task + d] = snapped<F>(P, count, secure_atom(P, uhi, ulo));
        } else {
          kids[task + d] =
              noisy<F>(count, pdp::draw<F>(k0, k1, i, P.gaussian), scale);
        }
      }
      __syncwarp();
      if (s.active) {
        const F* mine = kids + leader * (B + 1);
        descend<F>(B, level, q, w, [&](int b) { return mine[b]; });
      }
      __syncwarp();  // the warp is done with this level's children
    }
    if (s.active && P.leaves)
      P.leaves[s.row * P.n_q + s.j] = static_cast<int>(w.node);
    f |= emit<F>(P, s, percentile<F>(P, w, leaves), per_row, r > 0, carry,
                 run);
    carry = __shfl_sync(pdp::kFullMask, run, per_row - 1);
  }
  pdp::block_or_flags(f, P.flags + blockIdx.y);
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    step_kernel(const __grid_constant__ Params P) {
  const int lane = threadIdx.x & 31;
  const int B = P.branching;
  const int walks = warp_walks(B);
  const int per_row = P.n_q <= walks ? P.n_q : walks;
  const long long warp_id =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) +
      (threadIdx.x >> 5);
  const bool last = P.out != nullptr;
  const F scale = pdp::noise_scale<F>(P.std, P.gaussian);
  const unsigned* lk = lane_row(P);
  const unsigned lk0 = lk ? lk[0] : P.key[0][0];
  const unsigned lk1 = lk ? lk[1] : P.key[0][1];
  const unsigned magic = 0xffffffffu / B + 1;
  F* draws = warp_children<F>();
  int* atoms = reinterpret_cast<int*>(draws);
  unsigned* lead_words = warp_leads();
  int* cnts = warp_counts();
  long long* rows = warp_rows();
  F* target = static_cast<F*>(P.target);
  F* total = static_cast<F*>(P.total);
  F* mass = static_cast<F*>(P.mass);
  long long leaves = 1;
  for (int l = 0; l < P.height; ++l) leaves *= B;
  unsigned f = 0u;
  F run = F(0), carry = F(0);
  const int runs = P.n_q <= walks ? 1 : (P.n_q + walks - 1) / walks;
  for (int r = 0; r < runs; ++r) {
    const Slot s = slot_of(P, walks, lane, warp_id, r * walks);
    const long long idx = s.row * P.n_q + s.j;
    Walk<F> w{-1, F(0), F(0), F(0)};
    if (s.active)
      w = Walk<F>{P.node[idx], target[idx], total[idx], mass[idx]};
    if (s.active) rows[lane] = idx;
    int leader;
    const unsigned lead = leaders(s, w.node, lane, &leader);
    const int n_lead = __popc(lead);
    // A leading walk derives its partition's key, fold_in(level key, p);
    // every child of every distinct node is drawn across the warp's lanes.
    // Walks at one node share the draws (or atoms) and noise them with
    // their own counts.
    if ((lead >> lane) & 1u) {
      unsigned* mine = lead_words + 4 * leader;
      pdp::fold_in(lk0, lk1, static_cast<uint32_t>(s.p), mine[0], mine[1]);
      mine[2] = static_cast<unsigned>(w.node);
      mine[3] = static_cast<unsigned>(w.node >> 32);
    }
    __syncwarp();
    // Two tasks a lane at a time (the second a copy of the first past the
    // last task), so their threefry chains and table searches overlap.
    const int n_tasks = n_lead * B;
    for (int t0 = lane; t0 < n_tasks; t0 += 64) {
      const bool two = t0 + 32 < n_tasks;
      uint32_t nk[2][2];
      int at[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int task = u && two ? t0 + 32 : t0;
        const int d = div_b(task, magic), b = task - d * B;
        const unsigned* words = lead_words + 4 * d;
        const long long node =
            static_cast<long long>(words[3]) << 32 | words[2];
        pdp::fold_in(words[0], words[1], static_cast<uint32_t>(node * B + b),
                     nk[u][0], nk[u][1]);
        at[u] = task + d;
      }
      if (P.table) {
        uint32_t uhi[2], ulo[2];
        int atom[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          pdp::secure_words(pdp::secure_key(nk[u][0], nk[u][1]), 0, uhi[u],
                            ulo[u]);
        secure_atoms2(P, uhi, ulo, atom);
        atoms[at[0]] = atom[0];
        if (two) atoms[at[1]] = atom[1];
      } else {
        const F d0 = pdp::draw<F>(nk[0][0], nk[0][1], 0, P.gaussian);
        const F d1 = pdp::draw<F>(nk[1][0], nk[1][1], 0, P.gaussian);
        draws[at[0]] = d0;
        if (two) draws[at[1]] = d1;
      }
    }
    // The walks' counts, coalesced: walk i's B counts are contiguous.
    const int n_active = __popc(__ballot_sync(pdp::kFullMask, s.active));
    for (int e = lane; e < n_active * B; e += 32) {
      const int i = div_b(e, magic), b = e - i * B;
      cnts[i * (B + 1) + b] = P.counts[rows[i] * B + b];
    }
    __syncwarp();
    if (s.active) {
      const int* cnt = cnts + lane * (B + 1);
      const int at = leader * (B + 1);
      const F q = static_cast<F>(quantile_at(P, s.j));
      if (P.table)
        descend<F>(B, P.level, q, w, [&](int b) {
          return snapped<F>(P, cnt[b], atoms[at + b]);
        });
      else
        descend<F>(B, P.level, q, w, [&](int b) {
          return noisy<F>(cnt[b], draws[at + b], scale);
        });
      P.node[idx] = static_cast<int>(w.node);
      target[idx] = w.target;
      total[idx] = w.total;
      mass[idx] = w.mass;
    }
    if (last) {
      f |= emit<F>(P, s, percentile<F>(P, w, leaves), per_row, r > 0, carry,
                   run);
      carry = __shfl_sync(pdp::kFullMask, run, per_row - 1);
    }
    __syncwarp();  // the warp is done with this run's draws
  }
  if (last) pdp::block_or_flags(f, P.flags + blockIdx.y);
}

// The launch's parameters shared by every entry; -1 for a shape it does
// not take.
int make_params(Params& P, long long n_partitions, int n_lanes,
                const double* q_host, const int* order_host,
                const void* q_dev, const void* order_dev, const double* scal,
                const int* dims, const void* table, int table_len,
                double gran) {
  P = Params{};
  P.n_partitions = n_partitions;
  P.n_lanes = n_lanes;
  P.out_stride = n_partitions * (n_lanes > 0 ? n_lanes : 1);
  P.n_q = dims[0];
  P.height = dims[1];
  P.branching = dims[2];
  P.gaussian = dims[3];
  P.std = scal[0];
  P.min_v = scal[1];
  P.max_v = scal[2];
  P.table = static_cast<const unsigned long long*>(table);
  P.table_len = table_len;
  P.gran = gran;
  if (P.n_q < 1 || P.height < 1 || P.height > kMaxH || P.branching < 2 ||
      P.branching > kMaxB || n_lanes < 0 || n_lanes > 65535 ||
      (table != nullptr && (table_len < 1 || table_len % 2 == 0)))
    return -1;
  if (P.n_q <= kValueQ) {
    for (int j = 0; j < P.n_q; ++j) {
      P.q[j] = q_host[j];
      P.order[j] = order_host[j];
    }
  } else {
    if (q_dev == nullptr || order_dev == nullptr) return -1;
    P.q_dev = static_cast<const double*>(q_dev);
    P.order_dev = static_cast<const int*>(order_dev);
  }
  return 0;
}

// Lane key rows by value (lane_host, n_lanes * words <= kLaneWords) or on
// the device (lane_dev).
int set_lane_keys(Params& P, int words, const unsigned* lane_host,
                  const void* lane_dev) {
  P.lane_words = words;
  if (lane_dev != nullptr) {
    P.lane_dev = static_cast<const unsigned*>(lane_dev);
    return 0;
  }
  if (lane_host == nullptr ||
      static_cast<long long>(P.n_lanes) * words > kLaneWords)
    return -1;
  for (int i = 0; i < P.n_lanes * words; ++i) P.lane_host[i] = lane_host[i];
  return 0;
}

// A warp's partitions: as many as its walks hold (n_q <= them; else one).
// The dense kernel takes fewer where its grid would have under
// kTargetWarps warps: its levels run one after another, each waiting on
// counts that the last level's nodes address, so a small launch wants
// more, shorter warps; a lazy step's one level is faster on full warps.
int rows_for(const Params& P, bool dense) {
  const int walks = warp_walks(P.branching);
  if (P.n_q > walks) return 1;
  if (!dense) return walks / P.n_q;
  const long long total = P.n_partitions * (P.n_lanes > 0 ? P.n_lanes : 1);
  const long long want = (total + kTargetWarps - 1) / kTargetWarps;
  return static_cast<int>(std::max(1LL, std::min<long long>(walks / P.n_q,
                                                             want)));
}

// A block's warps take P.rows partitions each.
dim3 grid_for(const Params& P) {
  const long long per_block = static_cast<long long>(P.rows) *
                              (kThreads / 32);
  return dim3(static_cast<unsigned>((P.n_partitions + per_block - 1) /
                                    per_block),
              static_cast<unsigned>(P.n_lanes > 0 ? P.n_lanes : 1));
}

int launch_dense(Params& P, int f64, cudaStream_t s) {
  P.rows = rows_for(P, true);
  if (f64)
    dense_kernel<double><<<grid_for(P), kThreads, 0, s>>>(P);
  else
    dense_kernel<float><<<grid_for(P), kThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

int launch_step(Params& P, int f64, cudaStream_t s) {
  P.rows = rows_for(P, false);
  if (f64)
    step_kernel<double><<<grid_for(P), kThreads, 0, s>>>(P);
  else
    step_kernel<float><<<grid_for(P), kThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry: quantiles and their stable ascending order as host arrays
// of n_q (read into the launch's parameters when n_q <=
// PDP_DESCEND_VALUE_QUANTILES) and as device arrays (q_dev float64, order_dev
// int32; required above it, else ignored); scal = (std, min_v, max_v);
// dims = (n_q, tree_height, branching, gaussian); keep: bool[rows]; out:
// F[n_q, rows], quantile j's column row j, the running maximum over the
// quantiles in ascending order; flags: the flag word (one a lane). Secure
// noise: table u64[table_len] (null: continuous noise) and its grid.

// levels: tree_height device pointers (host array) of C7's level counts;
// level_keys: 2 * tree_height words; leaves (nullable): int32
// [n_partitions, n_q], the leaf each walk ends at.
extern "C" int quantile_descend_dense(
    void* const* levels, long long n_partitions, const double* q_host,
    const int* order_host, const void* q_dev, const void* order_dev,
    const double* scal, const int* dims, const unsigned* level_keys,
    const void* keep, void* leaves, void* out, void* flags,
    const void* table, int table_len, double gran, int f64, void* stream) {
  Params P;
  if (make_params(P, n_partitions, 0, q_host, order_host, q_dev, order_dev,
                  scal, dims, table, table_len, gran))
    return -1;
  if (n_partitions <= 0) return 0;
  for (int l = 0; l < P.height; ++l) {
    P.levels[l] = static_cast<const int*>(levels[l]);
    P.key[l][0] = level_keys[2 * l];
    P.key[l][1] = level_keys[2 * l + 1];
    if (P.table) P.skey[l] = pdp::secure_key(P.key[l][0], P.key[l][1]);
  }
  P.keep = static_cast<const uint8_t*>(keep);
  P.leaves = static_cast<int*>(leaves);
  P.out = out;
  P.flags = static_cast<unsigned*>(flags);
  return launch_dense(P, f64, static_cast<cudaStream_t>(stream));
}

// One lazy level: counts int32[n_partitions, n_q, B] of C7's child counts;
// node / target / total / mass: the walks' state, updated in place;
// level_key = fold_in(qkey, level). At the last level (out not null)
// writes the percentiles to out and ORs their flag bits into flags.
extern "C" int quantile_descend_step(
    const void* counts, long long n_partitions, int level,
    const double* q_host, const int* order_host, const void* q_dev,
    const void* order_dev, const double* scal, const int* dims,
    unsigned level_key0, unsigned level_key1, void* node, void* target,
    void* total, void* mass, const void* keep, void* out, void* flags,
    const void* table, int table_len, double gran, int f64, void* stream) {
  Params P;
  if (make_params(P, n_partitions, 0, q_host, order_host, q_dev, order_dev,
                  scal, dims, table, table_len, gran) ||
      level < 1 || level > P.height)
    return -1;
  if (n_partitions <= 0) return 0;
  P.level = level;
  P.key[0][0] = level_key0;
  P.key[0][1] = level_key1;
  P.counts = static_cast<const int*>(counts);
  P.node = static_cast<int*>(node);
  P.target = target;
  P.total = total;
  P.mass = mass;
  P.keep = static_cast<const uint8_t*>(keep);
  P.out = out;
  P.flags = static_cast<unsigned*>(flags);
  return launch_step(P, f64, static_cast<cudaStream_t>(stream));
}

// The dense lane entry: n_partitions per lane, n_lanes lanes; levels[l -
// 1] = int32[n_lanes * n_partitions, B^l]; the key table u32 [n_lanes, 2 *
// tree_height] (each level's key; with a table [n_lanes, 6 *
// tree_height], each level's split k1, k2 after them) on the host
// (lane_host, at most PDP_DESCEND_LANE_WORDS words) or the device
// (lane_dev); out F[n_q, n_lanes * n_partitions]; flags: n_lanes words.
// Otherwise as quantile_descend_dense.
extern "C" int quantile_descend_dense_lanes(
    void* const* levels, long long n_partitions, int n_lanes,
    const double* q_host, const int* order_host, const void* q_dev,
    const void* order_dev, const double* scal, const int* dims,
    const unsigned* lane_host, const void* lane_dev, const void* keep,
    void* out, void* flags, const void* table, int table_len, double gran,
    int f64, void* stream) {
  Params P;
  if (n_lanes < 1 ||
      make_params(P, n_partitions, n_lanes, q_host, order_host, q_dev,
                  order_dev, scal, dims, table, table_len, gran) ||
      set_lane_keys(P, (table ? 6 : 2) * P.height, lane_host, lane_dev))
    return -1;
  if (n_partitions <= 0) return 0;
  for (int l = 0; l < P.height; ++l)
    P.levels[l] = static_cast<const int*>(levels[l]);
  P.keep = static_cast<const uint8_t*>(keep);
  P.out = out;
  P.flags = static_cast<unsigned*>(flags);
  return launch_dense(P, f64, static_cast<cudaStream_t>(stream));
}

// The lazy lane entry: n_partitions per lane, n_lanes lanes; counts
// int32[n_lanes * n_partitions, n_q, B] and the walks' state over the same
// rows; the key table u32 [n_lanes, 2], each lane's fold_in(qkey, level),
// on the host (lane_host) or the device (lane_dev); out F[n_q, n_lanes *
// n_partitions] at the last level; flags: n_lanes words. Otherwise as
// quantile_descend_step.
extern "C" int quantile_descend_step_lanes(
    const void* counts, long long n_partitions, int n_lanes, int level,
    const double* q_host, const int* order_host, const void* q_dev,
    const void* order_dev, const double* scal, const int* dims,
    const unsigned* lane_host, const void* lane_dev, void* node,
    void* target, void* total, void* mass, const void* keep, void* out,
    void* flags, const void* table, int table_len, double gran, int f64,
    void* stream) {
  Params P;
  if (n_lanes < 1 ||
      make_params(P, n_partitions, n_lanes, q_host, order_host, q_dev,
                  order_dev, scal, dims, table, table_len, gran) ||
      level < 1 || level > P.height ||
      set_lane_keys(P, 2, lane_host, lane_dev))
    return -1;
  if (n_partitions <= 0) return 0;
  P.level = level;
  P.counts = static_cast<const int*>(counts);
  P.node = static_cast<int*>(node);
  P.target = target;
  P.total = total;
  P.mass = mass;
  P.keep = static_cast<const uint8_t*>(keep);
  P.out = out;
  P.flags = static_cast<unsigned*>(flags);
  return launch_step(P, f64, static_cast<cudaStream_t>(stream));
}
