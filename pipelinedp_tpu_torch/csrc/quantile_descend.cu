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
// One thread per (partition, quantile) walks the tree: at each level it
// noises the B children of its node, clamps them at 0 and picks the child
// where the running count passes the target rank, with the arithmetic and
// operation order of _descend_trees. XLA sums the B children and their
// prefixes from 0, left to right (a reduce and a reduce_window on the
// CPU), and so do these loops.
//
// Noise is drawn on demand, for the visited nodes only:
//   dense regime  node j of level l at counter p * B^l + j under
//                 fold_in(fold_in(qkey, 0), l - 1): the words the JAX
//                 package draws for the whole level; all levels in one
//                 launch, from C7's level counts.
//   lazy regime   one launch per level, from C7's child counts: child
//                 node id c draws at counter 0 under fold_in(fold_in(
//                 level_key, p), c), derived here, so a node visited by
//                 several quantiles gets the same noise.
// Secure noise (K13, :748-758 and :885-893): a node's count is snapped to
// the quantile slot's grid plus the atom its table search gives, with the
// words of split(level key) at the dense counter, or of
// bits(fold_in(node key, 0)) and bits(fold_in(node key, 1)) in the lazy
// regime; the clamp at 0 and the descent are the same.
// A second kernel, one thread per partition, takes the running maximum
// over the quantiles in ascending order, writes quantile j's column to
// out[j, :] and ORs the flag bits of kept partitions into the flag word.
//
// The lane entries (K24: the megabatched service's vmap over job lanes,
// executor.py:984) run L jobs' trees as one range of L * P partitions:
// blockIdx.y is the lane, partition p of lane l is row l * P + p of the
// counts, and it draws at its solo counters (p lane-local) under its
// lane's keys, rows of a u32 table on the device: dense, the lane's h
// level keys (and with a secure table their splits, k1 and k2 a level);
// lazy, the lane's level key. Each lane ORs its flags into flags[l]. The
// regime is the solo run's, chosen by P, the same for every lane.
//
// Bound: operations. Each visited node costs one threefry (~100 integer
// operations; the lazy regime two more for the keys) and an erf_inv or a
// log1p; the counts read are B ints a level.
#include "common.cuh"

namespace {

constexpr int kMaxH = 8;
constexpr int kMaxB = 64;

struct Params {
  long long n_partitions;
  int n_q, height, branching, gaussian;
  const double* q;   // device, n_q quantiles
  const int* order;  // device, their indices in ascending order (stable)
  double std, min_v, max_v;
  unsigned key[kMaxH][2];  // dense: per-level keys; lazy: key[0]
  // Secure noise: the quantile slot's packed table (null: continuous
  // noise) and its grid.
  const unsigned long long* table;
  int table_len;
  double gran;
  pdp::SecureKey skey[kMaxH];  // dense: split(key[l]), derived at launch
  // Lanes: the keys a lane (null: key / skey above), lane_words u32 a row;
  // out's row stride (L * P; P for one job).
  const unsigned* lane_keys;
  int lane_words;
  long long out_stride;
};

// The lane of the block, and its row of lane_keys (null for one job).
__device__ __forceinline__ const unsigned* lane_key_row(const Params& P) {
  return P.lane_keys ? P.lane_keys + static_cast<long long>(blockIdx.y) *
                                         P.lane_words
                     : nullptr;
}

// State of one (partition, quantile) walk.
template <typename F>
struct Walk {
  long long node;  // node reached, of the last level descended
  F target;        // remaining rank
  F total;         // the tree's noisy total (level 1)
  F mass;          // noisy count of the node reached
};

// One level of _descend_trees on the noisy, clamped children of w.node.
template <typename F>
__device__ void descend(const F* children, int branching, int level, F q,
                        Walk<F>& w) {
  F sum = F(0);
  for (int b = 0; b < branching; ++b) sum = sum + children[b];
  if (level == 1) {
    w.total = sum;
    w.target = q * sum;
  } else {
    w.target = w.target / pdp::max_nan(w.mass, F(1e-12)) * sum;
  }
  F cum[kMaxB];
  F acc = F(0);
  int below = 0;
  for (int b = 0; b < branching; ++b) {
    acc = acc + children[b];
    cum[b] = acc;
    below += acc < w.target ? 1 : 0;
  }
  const int child = below < branching - 1 ? below : branching - 1;
  w.target = w.target - (child > 0 ? cum[child - 1] : F(0));
  w.node = w.node * branching + child;
  w.mass = children[child];
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

// A secure node: max(snap(count) + atom * gran, 0), the atom's words
// drawn at element i under the split key k.
template <typename F>
__device__ __forceinline__ F snapped_node(const Params& P, int count,
                                          const pdp::SecureKey& k,
                                          uint64_t i) {
  uint32_t uhi, ulo;
  pdp::secure_words(k, i, uhi, ulo);
  return pdp::max_nan(
      pdp::snapped_release<F>(static_cast<F>(count), uhi, ulo, P.table,
                              P.table_len, static_cast<F>(P.gran)),
      F(0));
}

struct Levels {
  const int* level[kMaxH];  // level[l - 1]: int32[P, B^l]
};

template <typename F>
__global__ void dense_kernel(Params P, Levels levels, F* __restrict__ vals,
                             int* __restrict__ leaves) {
  const long long local =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (local >= P.n_partitions * P.n_q) return;
  // Lane blockIdx.y's walks follow the lanes before it.
  const long long idx =
      static_cast<long long>(blockIdx.y) * P.n_partitions * P.n_q + local;
  const long long p = local / P.n_q;  // lane-local: the solo counters
  const long long row = idx / P.n_q;  // the row of the counts
  const int j = static_cast<int>(idx % P.n_q);
  const int B = P.branching;
  const F scale = pdp::noise_scale<F>(P.std, P.gaussian);
  const F q = static_cast<F>(P.q[j]);
  const unsigned* lk = lane_key_row(P);
  Walk<F> w{0, F(0), F(0), F(0)};
  long long width = 1;  // B^level
  F children[kMaxB];
  for (int level = 1; level <= P.height; ++level) {
    width *= B;
    const int* counts = levels.level[level - 1] + row * width;
    const unsigned k0 = lk ? lk[2 * (level - 1)] : P.key[level - 1][0];
    const unsigned k1 = lk ? lk[2 * (level - 1) + 1] : P.key[level - 1][1];
    pdp::SecureKey sk = P.skey[level - 1];
    if (P.table && lk) {
      const unsigned* w4 = lk + 2 * P.height + 4 * (level - 1);
      sk.hi[0] = w4[0];
      sk.hi[1] = w4[1];
      sk.lo[0] = w4[2];
      sk.lo[1] = w4[3];
    }
    for (int b = 0; b < B; ++b) {
      const long long node = w.node * B + b;
      const uint64_t i = static_cast<uint64_t>(p * width + node);
      children[b] =
          P.table ? snapped_node<F>(P, counts[node], sk, i)
                  : noisy<F>(counts[node], pdp::draw<F>(k0, k1, i, P.gaussian),
                             scale);
    }
    descend<F>(children, B, level, q, w);
  }
  vals[idx] = percentile<F>(P, w, width);
  if (leaves) leaves[idx] = static_cast<int>(w.node);
}

template <typename F>
__global__ void step_kernel(Params P, const int* __restrict__ counts,
                            int level, int* __restrict__ node,
                            F* __restrict__ target, F* __restrict__ total,
                            F* __restrict__ mass, F* __restrict__ vals) {
  const long long local =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (local >= P.n_partitions * P.n_q) return;
  const long long idx =
      static_cast<long long>(blockIdx.y) * P.n_partitions * P.n_q + local;
  const long long p = local / P.n_q;  // lane-local: the solo keys
  const int j = static_cast<int>(idx % P.n_q);
  const int B = P.branching;
  const F scale = pdp::noise_scale<F>(P.std, P.gaussian);
  const unsigned* lk = lane_key_row(P);
  uint32_t pk0, pk1;
  pdp::fold_in(lk ? lk[0] : P.key[0][0], lk ? lk[1] : P.key[0][1],
               static_cast<uint32_t>(p), pk0, pk1);
  Walk<F> w{node[idx], target[idx], total[idx], mass[idx]};
  F children[kMaxB];
  for (int b = 0; b < B; ++b) {
    uint32_t nk0, nk1;
    pdp::fold_in(pk0, pk1, static_cast<uint32_t>(w.node * B + b), nk0, nk1);
    const int count = counts[idx * B + b];
    children[b] =
        P.table ? snapped_node<F>(P, count, pdp::secure_key(nk0, nk1), 0)
                : noisy<F>(count, pdp::draw<F>(nk0, nk1, 0, P.gaussian),
                           scale);
  }
  descend<F>(children, B, level, static_cast<F>(P.q[j]), w);
  node[idx] = static_cast<int>(w.node);
  target[idx] = w.target;
  total[idx] = w.total;
  mass[idx] = w.mass;
  if (vals) {
    long long leaves = 1;
    for (int l = 0; l < P.height; ++l) leaves *= B;
    vals[idx] = percentile<F>(P, w, leaves);
  }
}

// cummax in ascending quantile order, the columns, the flag word.
template <typename F>
__global__ void finish_kernel(Params P, const F* __restrict__ vals,
                              const uint8_t* __restrict__ keep,
                              F* __restrict__ out,
                              unsigned* __restrict__ flags) {
  const long long local =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // Lane blockIdx.y: its rows follow the lanes before it; its flag word
  // is flags[lane].
  const long long p =
      static_cast<long long>(blockIdx.y) * P.n_partitions + local;
  unsigned f = 0u;
  if (local < P.n_partitions) {
    F run = F(0);
    for (int k = 0; k < P.n_q; ++k) {
      const int j = P.order[k];
      const F v = vals[p * P.n_q + j];
      run = k == 0 ? v : pdp::max_nan(run, v);
      out[static_cast<long long>(j) * P.out_stride + p] = run;
      if (keep[p]) f |= pdp::value_flags(run);
    }
  }
  pdp::block_or_flags(f, flags + blockIdx.y);
}

Params make_params(long long n_partitions, const double* quantiles,
                   const int* order, const double* scal, const int* dims,
                   const void* table, int table_len, double gran) {
  Params P{};
  P.table = static_cast<const unsigned long long*>(table);
  P.table_len = table_len;
  P.gran = gran;
  P.n_partitions = n_partitions;
  P.n_q = dims[0];
  P.height = dims[1];
  P.branching = dims[2];
  P.gaussian = dims[3];
  P.q = quantiles;
  P.order = order;
  P.std = scal[0];
  P.min_v = scal[1];
  P.max_v = scal[2];
  P.out_stride = n_partitions;
  return P;
}

bool valid(const Params& P) {
  return P.n_q >= 1 && P.height >= 1 &&
         P.height <= kMaxH && P.branching >= 2 && P.branching <= kMaxB &&
         (P.table == nullptr || (P.table_len >= 1 && P.table_len % 2 == 1));
}

// One lane's n work items a row of the grid, n_lanes rows.
dim3 grid_for(long long n, int threads, int n_lanes) {
  return dim3(static_cast<unsigned>((n + threads - 1) / threads),
              static_cast<unsigned>(n_lanes));
}

template <typename F>
void finish(const Params& P, int n_lanes, const F* vals, const void* keep,
            void* out, void* flags, cudaStream_t s) {
  finish_kernel<F><<<grid_for(P.n_partitions, 256, n_lanes), 256, 0, s>>>(
      P, vals, static_cast<const uint8_t*>(keep), static_cast<F*>(out),
      static_cast<unsigned*>(flags));
}

template <typename F>
int launch_dense(const Params& P, int n_lanes, const Levels& levels,
                 const void* keep, void* scratch, void* leaves, void* out,
                 void* flags, cudaStream_t s) {
  const long long threads = P.n_partitions * P.n_q;
  F* vals = static_cast<F*>(scratch);
  dense_kernel<F><<<grid_for(threads, 128, n_lanes), 128, 0, s>>>(
      P, levels, vals, static_cast<int*>(leaves));
  finish<F>(P, n_lanes, vals, keep, out, flags, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_step(const Params& P, int n_lanes, const void* counts, int level,
                void* node, void* target, void* total, void* mass,
                const void* keep, void* scratch, void* out, void* flags,
                cudaStream_t s) {
  const long long threads = P.n_partitions * P.n_q;
  F* vals = out ? static_cast<F*>(scratch) : nullptr;
  step_kernel<F><<<grid_for(threads, 128, n_lanes), 128, 0, s>>>(
      P, static_cast<const int*>(counts), level, static_cast<int*>(node),
      static_cast<F*>(target), static_cast<F*>(total), static_cast<F*>(mass),
      vals);
  if (out) finish<F>(P, n_lanes, vals, keep, out, flags, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// levels: tree_height device pointers (host array) of C7's level counts;
// quantiles / order: n_q each (device); scal = (std, min_v, max_v); dims =
// (n_q, tree_height, branching, gaussian); level_keys: 2 * tree_height
// words; scratch: F[n_partitions * n_q]; leaves (nullable): int32
// [n_partitions, n_q], the leaf each walk ends at; out: F[n_q,
// n_partitions]; flags: the release's flag word. Secure noise: table
// u64[table_len] (null: continuous noise) and its grid.
extern "C" int quantile_descend_dense(void* const* levels,
                                      long long n_partitions,
                                      const double* quantiles,
                                      const int* order, const double* scal,
                                      const int* dims,
                                      const unsigned* level_keys,
                                      const void* keep, void* scratch,
                                      void* leaves, void* out, void* flags,
                                      const void* table, int table_len,
                                      double gran, int f64, void* stream) {
  Params P = make_params(n_partitions, quantiles, order, scal, dims, table,
                         table_len, gran);
  if (!valid(P)) return -1;
  if (n_partitions <= 0) return 0;
  Levels lv{};
  for (int l = 0; l < P.height; ++l) {
    lv.level[l] = static_cast<const int*>(levels[l]);
    P.key[l][0] = level_keys[2 * l];
    P.key[l][1] = level_keys[2 * l + 1];
    if (P.table) P.skey[l] = pdp::secure_key(P.key[l][0], P.key[l][1]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_dense<double>(P, 1, lv, keep, scratch, leaves, out,
                                    flags, s)
             : launch_dense<float>(P, 1, lv, keep, scratch, leaves, out,
                                   flags, s);
}

// One lazy level: counts int32[n_partitions, n_q, B] of C7's child
// counts; node / target / total / mass: the walks' state, updated in
// place; level_key = fold_in(qkey, level). At the last level (out not
// null) writes the percentiles to out F[n_q, n_partitions], through
// scratch F[n_partitions * n_q], and ORs their flag bits into flags.
// Secure noise: table u64[table_len] (null: continuous noise) and its
// grid.
extern "C" int quantile_descend_step(const void* counts,
                                     long long n_partitions, int level,
                                     const double* quantiles,
                                     const int* order, const double* scal,
                                     const int* dims, unsigned level_key0,
                                     unsigned level_key1, void* node,
                                     void* target, void* total, void* mass,
                                     const void* keep, void* scratch,
                                     void* out, void* flags,
                                     const void* table, int table_len,
                                     double gran, int f64, void* stream) {
  Params P = make_params(n_partitions, quantiles, order, scal, dims, table,
                         table_len, gran);
  if (!valid(P) || level < 1 || level > P.height) return -1;
  if (n_partitions <= 0) return 0;
  P.key[0][0] = level_key0;
  P.key[0][1] = level_key1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_step<double>(P, 1, counts, level, node, target, total,
                                   mass, keep, scratch, out, flags, s)
             : launch_step<float>(P, 1, counts, level, node, target, total,
                                  mass, keep, scratch, out, flags, s);
}

// The dense lane entry: n_partitions per lane, n_lanes lanes; levels[l -
// 1] = int32[n_lanes * n_partitions, B^l]; lane_keys: u32 [n_lanes, 2 *
// tree_height] (each level's key; with a table [n_lanes, 6 *
// tree_height], each level's split k1, k2 after them) on the device;
// scratch F[n_lanes * n_partitions * n_q]; leaves (nullable) int32
// [n_lanes * n_partitions, n_q]; out F[n_q, n_lanes * n_partitions];
// flags: n_lanes words. Otherwise as quantile_descend_dense.
extern "C" int quantile_descend_dense_lanes(
    void* const* levels, long long n_partitions, int n_lanes,
    const double* quantiles, const int* order, const double* scal,
    const int* dims, const void* lane_keys, const void* keep, void* scratch,
    void* leaves, void* out, void* flags, const void* table, int table_len,
    double gran, int f64, void* stream) {
  Params P = make_params(n_partitions, quantiles, order, scal, dims, table,
                         table_len, gran);
  if (!valid(P) || n_lanes < 1 || n_lanes > 65535 || lane_keys == nullptr)
    return -1;
  if (n_partitions <= 0) return 0;
  P.lane_keys = static_cast<const unsigned*>(lane_keys);
  P.lane_words = (table ? 6 : 2) * P.height;
  P.out_stride = n_partitions * n_lanes;
  Levels lv{};
  for (int l = 0; l < P.height; ++l)
    lv.level[l] = static_cast<const int*>(levels[l]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_dense<double>(P, n_lanes, lv, keep, scratch, leaves,
                                    out, flags, s)
             : launch_dense<float>(P, n_lanes, lv, keep, scratch, leaves,
                                   out, flags, s);
}

// The lazy lane entry: n_partitions per lane, n_lanes lanes; counts
// int32[n_lanes * n_partitions, n_q, B] and the walks' state over the
// same rows; level_keys: u32 [n_lanes, 2] on the device, each lane's
// fold_in(qkey, level); out F[n_q, n_lanes * n_partitions] at the last
// level; flags: n_lanes words. Otherwise as quantile_descend_step.
extern "C" int quantile_descend_step_lanes(
    const void* counts, long long n_partitions, int n_lanes, int level,
    const double* quantiles, const int* order, const double* scal,
    const int* dims, const void* level_keys, void* node, void* target,
    void* total, void* mass, const void* keep, void* scratch, void* out,
    void* flags, const void* table, int table_len, double gran, int f64,
    void* stream) {
  Params P = make_params(n_partitions, quantiles, order, scal, dims, table,
                         table_len, gran);
  if (!valid(P) || level < 1 || level > P.height || n_lanes < 1 ||
      n_lanes > 65535 || level_keys == nullptr)
    return -1;
  if (n_partitions <= 0) return 0;
  P.lane_keys = static_cast<const unsigned*>(level_keys);
  P.lane_words = 2;
  P.out_stride = n_partitions * n_lanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_step<double>(P, n_lanes, counts, level, node, target,
                                   total, mass, keep, scratch, out, flags, s)
             : launch_step<float>(P, n_lanes, counts, level, node, target,
                                  total, mass, keep, scratch, out, flags, s);
}
