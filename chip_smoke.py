#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (pipelinedp_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build   every kernel of pipelinedp_tpu_torch/csrc with nvcc (sm_90a),
             one nvcc per source, all started together
  2. kernels C1-C6 each against its plain PyTorch version on the card,
             on a small input and at the main path's full-size shapes
             (C5 on the bounding, partition, total-bound and selection
             keys; C6 at 17,770 and 2^21 partitions); median time over
             warmed repeats (CUDA events). Then C7 (leaf histogram, level
             roll-ups, lazy child counts), C8 (dense and lazy descent),
             C9 (L1, L2, L-inf) and C3's vector entry, at 4096 rows and
             2^24 rows, with torch.bincount beside C7. Then the modes'
             entries: C3 compensated (rating x 1000: every sum equal to
             float32 of the exact int64 sum and, but for nsum2, whose
             difference is measured, to the plain version; the fast
             entry's error beside), C4 secure (1 and 3 slots), C9 secure,
             C8 secure (dense and lazy), exactly equal to their plain
             versions, and
             a chi-square test of 2^20 secure draws against the table
  3. parity  small aggregations (PERCENTILE in both regimes, VECTOR_SUM
             among them) and a small selection on the card in float64
             against the same on the CPU (the plain versions); the same
             for secure_noise=True (every metric, both quantile regimes)
             and numeric_mode="safe" (float64, and float32 with secure
             noise)
  4. main    DPEngine.aggregate on TorchBackend() (cuda, float32) at full
             size: 2^24 Netflix-Prize-shaped rows (480,189 privacy ids,
             17,770 movies, Zipf popularity, ratings 1-5), pre-encoded by
             columnar.encode_columns:
               (a) COUNT+SUM+MEAN+VARIANCE, Gaussian, public partitions
               (b) COUNT+SUM+PRIVACY_ID_COUNT, Laplace, private selection
               (c) epsilon = 1e6 with bounds at the data's true per-user
                   maxima, checked against a numpy group-by
               (d) COUNT+SUM+MEAN, Laplace, public, max_contributions = 64
               (e) as (d) with max_contributions = the data's largest
                   count per user at epsilon = 1e6, checked as (c)
               (f) PERCENTILE 10/50/90 + COUNT, Gaussian, public: the lazy
                   quantile regime (17,770 partitions)
               (g) as (f) at epsilon = 1e6 with the true maxima, each
                   percentile checked against the partition's order
                   statistics
               (h) PERCENTILE 50 + COUNT, Laplace, private selection,
                   grouped by a release year drawn per movie (1890-2005):
                   the dense quantile regime
               (i) VECTOR_SUM (one-hot rating, D = 5) + COUNT, Gaussian,
                   public, L2 norm ball of 1000: some partitions clipped
               (j) as (i) at epsilon = 1e6, norm 1e9 and the true maxima,
                   checked per coordinate against a numpy group-by
               (k)-(o) (b), (a), (f), (i), (c) with secure_noise=True: the
                   same kept set as (b), values on their grids, monotone
                   percentiles, (o) within 16 noise stds + a grid step of
                   numpy
               (p) numeric_mode="safe", float32, COUNT+SUM of rating x
                   1000 at epsilon 1e6 and 1e12 and the true maxima: sums
                   past 2^24 within 16 noise stds + 1 float32 ulp of the
                   numpy int64 group-by, and at 1e12 (noise std ~0.4)
                   every sum past 2^25 equal to float32 of the exact sum;
                   the fast mode's error beside it
  5. select  DPEngine.select_partitions at full size, l0 = 64, for the
             three selection strategies
             Each run of 4 and 5 starts with the launch counts at 0 and
             fails if a kernel of its path did not launch.
  6. stages  runs (a), (f), (i) and (l) with CUDA events around every kernel
             wrapper the executor calls: where their time goes.
  7. profile one run (a), one run (f) and one select under
             torch.profiler: the device's busy time (kernels and copies),
             its idle share of the release's wall time, and the largest
             device entries.
The blocked large-P route (pipelinedp_tpu_torch/parallel/
large_p.py) adds to these phases:
  2. kernels C10 block_offsets against torch.searchsorted over the full
             pass-1 stream of (q), C11 gather_rows against index_select
             at the first chunk of (w), and the windowed entries of C3
             (three float columns, vector D = 5, compensated) and C7 (a
             16-leaf histogram, the default tree's level-1 child counts)
             on block 1 of (q)'s stream, a full block of 2^20 partitions;
             then C3's edge windows (c3_edge_phase): a 300,000-row
             partition (586 tiles), a single row, an empty window, windows outside [0, C),
             runs at keys 0 and C - 1, the lane entries == their solo
             runs; every C3 entry here and at the main path's shapes is
             called twice and must give the same bits
  3. parity  blocked DPEngine.aggregate (public, private, PERCENTILE,
             VECTOR_SUM, secure, safe) and select_partitions on the card
             against the CPU, threshold 16, 8 partitions a block, P = 44
  4. main    (q) the JAX package's large-P benchmark shape
             (benchmarks/bench_large_p.py): 2^24 rows, 10^6 users,
             partition keys floor(u^6 * 10^7) (~4.5M partitions, 5 blocks
             of 2^20), values U[0, 5], COUNT+SUM, Laplace, private, l0 =
             4, linf = 8, eps 1, median of 3 with phase_times;
             (r) (q) at eps 1e6 with the true maxima against a numpy
             group-by; (s) PERCENTILE 50 + COUNT (lazy descents per
             block); (t) COUNT+MEAN+VARIANCE with secure noise, counts on
             their grid; (u) values x 1000, numeric_mode="safe", float32,
             eps 1e12: sums past 2^25 equal float32 of the exact sum (fast
             twin beside it); (v) = (c) on the blocked route (4096
             partitions a block); (w) = (r) through aggregate_blocked with
             row_chunk = 2^22, the host-staged regime
  5. select  blocked select_partitions on (q)'s data, three strategies
  6. stages  (q) and (v) with CUDA events around every kernel wrapper and
             a host clock around the key derivation, beside aggregate_blocked's
             phase_times (waits, drains) and the decode
The streamed ingest (DPEngine.aggregate / select_partitions of a
ChunkSource; ingest.py, runtime/pipeline.py) adds:
  2. kernels C12's and C17's edge cases (c12_c17_edge_phase: tile edges,
             adversarial hashes, a count hint too small raising through
             the ingest); C12 factorize_codes (its table sized by the
             distinct count, no C5 launch) and C13 lookup_codes on the hash
             rows of
             the Netflix users (2^24 rows, 480,189 distinct), movies
             (17,770) and (q)'s partitions (~4.7M): each equal to its
             plain version, to the other and to the host encoder's codes,
             beside torch.unique (not the same function) and
             torch.searchsorted; C14 append_rows' grow (2^23 -> 2^24 rows)
             and fill_tail on the host and hash routes' buffers, beside
             torch.cat + torch.full
  3. parity  small streamed aggregations and selections on the card in
             float64 against the CPU: both encode modes, encode_threads 0
             and 2, dense and blocked (threshold 16)
  4. main    (x) = (a), (y) = (b) and (z) = (q) through a ChunkSource of
             their raw columns in 16 chunks of 2^20 rows, encode_threads 4
             ((x) encode_mode "host", (y) and (z) "hash_device"), each
             release equal (==) to its pre-encoded twin's with the same
             seed; wall time, rows/s and the ingest's share
  6. stages  (a), (x) and (y) split: host encode (the workers' busy time),
             vocabulary merge, h2d copies, C14, C12, release kernels, the
             rest
PLD accounting and the dataset histograms add, after every earlier
phase 4 run (so the full-width composition's buffers and its host
composition do not share their conditions):
  2. kernels C15 pld_fft and C16 log_spectrum: compose_plds on the card
             (device=True; the full-width trail by default) on the four
             sample PLDs of tests/test_pld_compose.py and on a
             full-width trail (200 mechanisms: Gaussian sigma and Laplace b
             log-spaced in [0.5, 20], multiplicities 1-64, discretization
             1e-4, coarsened to DEFAULT_MAX_GRID, L = 2^21), each within
             1e-9 of the host path (every probability and the epsilon at
             delta 1e-6); both kernels against their plain versions at the
             trail's shapes; C15 against its step-by-step model
             (kernels.pld_rfft_four_step / pld_irfft_four_step on the
             CPU) within 1e-13 at one-pass plans (L = 2^11, 2^12) and the
             trail's two-pass plan; their times beside torch.fft.rfft /
             irfft and _compose_pmfs_host
  3. parity  small PLD aggregations on the card in float64 against the CPU
  4. main    DPEngine.aggregate under PLDBudgetAccountant(1.0, 1e-6, 1e-4):
             (a) COUNT+SUM+MEAN, Gaussian, public and (b), each release's
             noise stds equal to those of the accountant's specs and the
             composed epsilon within the budget; compute_budgets' host time
             and the release wall; the epsilon 1e6 twin of (a) at the true
             maxima against numpy;
             compute_dataset_histograms_device on the 2^24 Netflix rows and
             (q)'s rows: the integer histograms equal to the port's numpy
             host path, the float one's cumulative counts within the pair
             sums that lie within float32 rounding of each edge; C17
             group_stats (reading each sort's sorted key; pair sums bit for
             bit the CPU's row-order fold and a numpy fold)
             and C18 log_bins against their plain versions at these shapes;
             the C5 sorts', each kernel's and the whole call's time
Utility analysis and parameter tuning (analysis/, K19) add, after every
earlier phase including the profile:
  2. kernels C19 sweep_stats and C20 sweep_report (after C5 and C10)
             against their plain versions on the card, float64 and
             float32, at (A) bench.py's config-5 shape (2^21 rows, 2^14
             partitions, COUNT, the 64-configuration l0 x linf grid,
             Gaussian, private selection at (1, 1e-6), seed 11) and (B)
             the Netflix table's 2^24 pairs as preaggregated rows (COUNT +
             SUM, P = 17,770, the same grid): integer-valued columns
             equal, float64 within 1e-9, float32 within 1e-2 of float64;
             C20 at sigma = 0 with half-integer mu; times beside the plain
             versions and, for C19 at (A), index_add_ of the term tensor
  4. main    compute_dataset_histograms_device of the first 2^20 Netflix
             rows, then parameter_tuning.tune over them as Python tuples on
             TorchBackend() (COUNT, private, 64 candidates, epsilon 1,
             delta 1e-6), the host preaggregation timed apart from the
             sweep; perform_utility_analysis of 2^14 of those rows,
             private and public, card (float64, float32) against the CPU
The multi-tenant service and megabatched serving (service/, K24) add,
after every earlier phase:
  2. kernels the lane entries of C1, C2, C3, C4 and C6 (and C5 with the
             lane as its top word) against their plain versions at L = 3
             lanes of 1000 rows and at S2's 16 lanes of 2^20 Netflix rows
             (P = 17,770), and the lane-batched releases of (a), (b) and
             a selection against their solo releases, lane by lane, with
             ==; times at S2's shape. Then (spec_kernel_phase) the lane
             entries of every other spec at the same two shapes: the
             total bound (C1, C5, C2), C2 without keys, C3 compensated
             (columns x 1000: sums equal float32 of the exact sums) and
             vector (one-hot ratings), C4 secure, C8 lazy over 17,770
             movies and dense over movie mod 128, plain and secure, C9
             plain and secure; the batched releases of (f), (i), (d),
             bounds enforced, (a) secure, safe, (f) secure and (i)
             secure == their solo releases lane by lane; times at S2's
             shape
  4. service DPAggregationService(TorchBackend()), batching off and on:
             (S1) bench.py's _bench_megabatch load: 96 pre-encoded jobs of
             64 rows over 48 partitions, COUNT + SUM, Laplace, 16 workers,
             lanes of 16, a 100 ms window, best of 3: jobs/s, p50 / p99
             latency, release launches per 96 jobs, occupancy; (S2a) /
             (S2b) the Netflix rows as 16 jobs of 2^20 rows under
             TorchBackend(max_partitions=17,770), cells (a) and (b);
             (S3) their selection; (S1 secure) S1 with
             secure_noise=True; (S2f) / (S2i) cells (f) and (i) as 16
             jobs of 2^20 rows; (S4) (d), bounds enforced, safe, (f)
             secure and (i) secure as 16 jobs of 2^16 rows, solo and
             batched once: every batched job == its solo run (release,
             spent epsilon, ledger trail), a group of 16 lanes launching
             C1-C4 and C6 once each and C5 twice (C7 and C8 once a level)
The dense route over a device mesh (parallel/, K21, K22, K24c) adds, after
every earlier phase, on make_mesh([cuda:0] * 4) (four shard slots on the
one card):
  2. kernels C21 combine_shards (plain: float32 and int32; compensated)
             at D = 4 over 17,770 x 6 columns, 2^21 and 16 x 17,770,
             beside stack.sum(0), and combine_parts over the 6 columns
             where they lie; C22 reshard_count and C23
             reshard_exchange over the 2^24 Netflix rows on 4 shards,
             values scalar and one-hot (V = 5), the whole exchange == its
             plain twin, beside torch.bincount and an argsort +
             index_select chain
  3. parity  small meshed aggregations (public, private, PERCENTILE) and a
             selection in float64 on the card's mesh against a CPU mesh,
             reshard "host" and "device"
  4. mesh    (a), (b) and a selection with reshard="host" (host rows, the
             LPT permutation; one run) and "device" (rows on the card,
             the exchange; two runs); (c) through the mesh == the
             unmeshed (c) and within 16 noise stds of numpy; (p, eps
             1e12) safe float32 through the mesh (C21's compensated
             entry); (b) on make_mesh(); (a)'s stage split (staging, phase
             1 a shard, C21, release, decode) and its idle share under
             torch.profiler, both reshard modes
  4. service S2b's 16 jobs on TorchBackend(mesh=...), batching off and on:
             every batched job == its solo meshed run; one meshed lane-
             batched release of (f)'s spec, 4 lanes of 2^18 rows, each
             lane == its solo meshed release
The blocked route over the mesh (parallel/large_p.py
aggregate_blocked_sharded, select_partitions_blocked_sharded; K23a) adds,
last of all, on the same mesh:
  3. parity  small meshed blocked releases (COUNT+SUM+MEAN+VARIANCE
             Gaussian public, COUNT+SUM+PRIVACY_ID_COUNT Laplace private,
             PERCENTILE, VECTOR_SUM, secure_noise, numeric_mode="safe")
             and a selection in float64 on make_mesh([cuda:0] * D) against
             a CPU mesh, D = 2 (reshard "host") and 4 ("device"),
             threshold 16, 8 partitions a block, P = 20
  4. mesh    (v) through the mesh, rows on the card (reshard="device") and
             host rows ("host"): == the unmeshed blocked (v), value for
             value, and the dense (c)'s partitions; noise-free (stds 0),
             its integer COUNT / SUM == the unmeshed blocked == the dense
             release == numpy; (q) and its blocked select through the
             mesh in both staging modes (the device run under
             reshard.forbid_row_fetches), median of 3, beside the
             unmeshed (q), with aggregate_blocked_sharded's phase_times
             split (staging, pass 1, offsets, dispatch, combine, waits,
             drains, decode)
  2. kernels C21 at the block shape (D x [2^20] x 2 float32, int32 for
             selection) and C10 on one shard's pass-1 stream of (q) and on
             the D shards' streams in one launch, each == its plain
             version, beside stack.sum(0) / torch.searchsorted
The single-process mesh ingest (ingest.encode_local_shard_to_mesh; K23b on
C24 mesh_factorize) and the unfused release (fused_release=False) add,
last of all, on the same mesh:
  2. kernels C24's mesh_local_uniques, mesh_merge_ranks and
             mesh_remap_rows on the 2^24-row hash rows of the Netflix
             users, movies and (q)'s partitions over 4 slots, each == its
             plain version, the whole mesh_factorize_codes == its run on
             the plain versions == C12's codes == the host encoder's;
             beside torch.unique(return_inverse) (not the same function)
  4. ingest  (a), (b) and (q) through encode_local_shard_to_mesh of their
             raw columns in both encode modes: valid codes == the host
             encoder's, the two modes' releases on TorchBackend(mesh=)
             ==, the ingest split (encode or hash, exchange, merges,
             upload, mesh factorize) beside the same run through a
             ChunkSource onto the mesh; (c) over the ingest within 16
             noise stds of numpy; a simulated two-process exchange ==
             the one-process ingest
  4. unfused (a), (b) and a selection with fused_release=False == the
             fused release, one launch fewer (no C6), walls side by side
The rebuilt C10 (a warp's 32-way search; block_window_offsets, the
block boundaries of S streams made in one launch) and C21 (combine_parts,
the shards' columns read where they lie, every column in one launch; the
stack entries on the same kernel) add:
  2. kernels after C3's edges (c10_c21_edge_phase): C10's edge windows
             (streams of 0 to 2^20 + 7 rows, the sentinel, INT32_MAX,
             end below the last boundary, 1 to 64 streams) and C21 at
             D = 1-64 over every dtype, the compensated entry, parts at
             every alignment and past the parameter table, each == its
             plain version and giving the same bits twice; block_window_
             offsets over (q)'s stream, over the 4 shards of meshed (q) in
             one launch, block_offsets at the sweep's P + 1 starts, and
             combine_parts over (a)'s meshed release columns (D = 4, 6 x
             17,770 float32, plain and compensated), each == its plain
             version; for C10 and C21 at their rows' shapes three figures
             a call, in turns with torch.searchsorted / stack.sum(0):
             wrapper ms (CUDA events around one call), device ms (the
             kernels alone, torch.profiler) and host us (1000 enqueues
             without a synchronise), printed as split[...] lines
The rebuilt C5 (Onesweep: one histogram launch, then one launch a digit
pass with a look-back over per-digit tile counts) and C2 (one pass over
tiles of 2048 rows with a decoupled look-back; sorted k1 from C5's
sorted_top) add:
  2. kernels after C10's and C21's edges (c5_c2_edge_phase): C5 at 1,
             4095, 4097 and 2^16 + 7 rows, equal rows (no pass), a
             constant word 0, a word of six runs, negative and 64-bit
             keys, sorted / reversed / three-valued keys and four lanes;
             C2 over pairs and pids across tile edges, a pair of 5000
             rows (pair-sum clipping, linf off and at 3000), l0 cutting
             300 pairs, 1 and 2049 rows, selection, lanes of 2047 and 3000
             rows with two lanes alike, the keyless lanes, the total bound
             and its lanes: each output == its plain version and equal to
             itself over two calls; at the main path's shapes (kernel
             phase) the device operations of each C5 sort and split[...]
             lines for C5 (bounding, partition; beside the argsort chain)
             and C2 (solo; lanes in the service kernel phase)
The rebuilt C4 (one launch a call: tiles of 64 partitions, the draws
spread over the block's threads, the flag words folded by the last block)
and C24 (no sort: C12 runs a shard and over the gathered uniques, then
C24's remap) add:
  2. kernels after C12's and C17's edges (c4_c24_edge_phase): C4 at P = 1,
             63-65, 255-257, 17,770 and either side of its 64-thread
             blocks, float32 and float64, 1-8 slots,
             secure and not, selection keeping nothing and everything,
             NaN / Inf / huge columns, lanes of 1, 3, 257 and 4000
             partitions in 3 and 40 lanes (each == its solo run); C24 on a sentinel
             and an invalid shard, one hash everywhere, hashes first on a
             later shard, shards of 1 row, uniq_cap == n_new, with count
             hints exact, above and none, and hints too small raising:
             each == its plain version and equal to itself over two
             calls; then c4_c24_split_phase: split[...] lines and the
             device operations a call of C4's four entries and of the
             mesh factorize's steps on the Netflix user hashes
The rebuilt C6 (one cooperative launch a call: a run of tiles a block,
one grid barrier, no scratch of its own) and C7's child counts (the leaf
gathered once a release into a buffer the later levels read; a tile's
counts in shared memory) add:
  2. kernels after C4's and C24's edges (c6_c7_edge_phase): C6 at P = 1,
             a tile (2048) less one, a tile, a tile and one, 17,770, the
             grid's edge (as many tiles as the card holds blocks, and one
             more), 2^21 and 2^24, keep none / all / alternating /
             random, 0, 1, 32 and 33 columns, widths 1 and 5, 4- and
             8-byte columns, lanes 1 x 17,770, 16 x 17,770 and 40 x 4000;
             C7's child counts at every level with the leaf buffer (solo,
             windowed, the lanes' range, rows out of order, 49
             quantiles): each == its plain version and equal to itself
             over two calls (c6_c7_split_phase, under --splits: split[...]
             lines and the device operations a call of C6's entries and
             of C7's child counts at (f)'s shape, the windowed entry and
             the lanes' range, each level and the four together); the
             kernel phases give C7's child counts a line of their own
             (quantile_child_counts, counted apart from the histogram and
             roll-ups) and each level's time, and the profile checks that
             every C6 call is one device operation
The rebuilt C22 (one pass over tiles of 4096 rows, a look-back a bucket,
the tile's totals published as soon as its rows are loaded) and C23 (one
launch: a tile's rows laid out in shared memory bucket by bucket and
written as runs, the padding from blocks past the tiles) add:
  2. kernels after C6's and C7's edges (c22_c23_edge_phase): C22 at D = 1,
             2, 3, 4, 8, 32 and 64 on 0, 1, 4095-4097 and 614,477 rows
             (150 tiles), ids at random, no row valid, one destination,
             pid and valid views out of phase; C23 at D = 1-32 on C22's
             and its own tile edges, no values, float32 / float64 [n],
             [n, 5] and [n, 7], own columns and staged slices, the fill
             from 0, from the received rows and none: each == its plain
             version and equal to itself over two calls
             (c22_c23_split_phase, under --splits: split[...] lines and
             the device operations a call of C22 and C23 at one shard of
             2^24 rows on 4 slots, V = 1 and 5; C23 one operation a
             call, C22 at most two)
The rebuilt C20 (two launches: a tile's bucket sums in one pass over
(configuration, partition), each bucket's lanes in lane order and the
block's warps in warp order, then the tiles' sums in tile order) and C8
(one launch a call: a warp's lanes draw each distinct node's children
once, in parallel, and each walk descends on its own lane; the cummax,
columns and flags in the same launch; quantiles and lane keys in the
launch's parameters) add:
  2. kernels after C22's and C23's edges (c20_c8_edge_phase): C20 at P =
             0, 1, 255-257, 2^14 in one bucket and 3000 over every bucket
             but five, K = 1 and 64 (every selector kind), M = 1 and 2,
             public and private, float64 within SWEEP_F64_RTOL and
             float32 within SWEEP_F32_BOUND of the plain version, and K =
             1 over 2^20 + 300 partitions; C8 at 1, 3, 32, 33 and 49
             quantiles and unsorted ones with ties, heights 1-8, B = 2, 16
             and 64, both regimes, secure and not, lanes 1 x 17,770, 16 x
             17,770 and 40 x 4000, two releases in a row with other
             quantile tuples: every walk at the plain version's node,
             values within 1e-5, flags equal, the same bits twice, each
             case's first C8 call under torch.cuda.set_sync_debug_mode(
             "error") (c20_c8_split_phase, under --splits: split[...] lines
             and the device operations a call of C20 at (A) and (B),
             float32 and float64, and of C8's lazy step, four steps, dense
             entry and lane steps at the main path's shapes; C8 one
             operation a call, C20 at most two)
The rebuilt C18 (one cooperative launch a call: the five integer
histograms of a histogram call in one launch, a lane's run and cache of
slots in registers, the float bucket guessed and corrected against the
exact edges) and C14 (one launch: 16-byte copies and fills over one flat
grid of every column's regions) add:
  2. kernels after C20's and C8's edges (c18_c14_edge_phase): C18's
             integer entry on one slot, five values dense and sparse,
             every decade with the int32 extremes, negatives, an empty
             mask, 0, 1 and 16 rows and views one row in, alone and all in
             one batched launch; its float entry on five values, lo ==
             hi (and -0.0), -FLT_MAX to FLT_MAX, values on every edge, a
             range of a few ulps, negatives and -0.0, an empty mask and
             views one row in; C14 fill_tail and grow at unaligned
             starts and capacities, widths 1, 3 and 5, 4- and 8-byte
             columns, the hash sentinel and -0.0 pads and buffers one row
             into their allocation, each call one launch: each == its
             plain version (C18's float sums within check_float_hist's
             bound) (c18_c14_split_phase, under --splits: split[...]
             lines and the device operations a call of C18's entries on
             the histogram call's Netflix and (q) stats and of C14's grow
             and fill_tail on 2^24-row buffers, beside three fill_ calls;
             one operation a call; the histogram call's wall)
  4. main    the histogram call launches log_bins twice (the five
             integer histograms, the float one)
The failure semantics and elastic meshes of the meshed drivers
(runtime/retry.py, faults.py, entry.py) and K23c (parallel/mesh.py
collective_heartbeat on C21's int32 entry) add, last of all:
  2. kernels K23c's sum (kernels.heartbeat_sum) over card_mesh()'s 4 slots
             == its plain version, beside stack.sum(0), and the whole
             collective_heartbeat on the host clock
  4. elastic on card_mesh(), rows on the card: (a)-shaped COUNT + SUM +
             PRIVACY_ID_COUNT, public partitions, at the data's true
             maxima on the 2^24 Netflix rows (dense), the same with
             private selection on (q) with integer values (blocked) and
             (q)'s selection: a
             device_loss (block 2 on the blocked route) under elastic,
             two losses, a loss down to one slot (the unsharded driver),
             a grow 2 -> 4 (announce_join), dispatch / consume retries,
             each == its unfaulted twin, walls beside it; (q) with
             min_devices=3 past two losses raises MeshDegradationError
             (health FAILED); (q) grown onto slots naming process 1 (the
             admit's heartbeat launches C21); probe_live_devices over
             slots naming process 1 (the heartbeat's route); the OOM
             re-plan at 2^16 rows, card float64 against the CPU
`python3 chip_smoke.py --mesh-all-cards` runs the build and the mesh
phases alone on make_mesh(), one shard slot on every visible card, and
K23c's kernel check and route there; `python3 chip_smoke.py --elastic`
the build, the data and the failure-semantics phases alone;
`python3 chip_smoke.py --walls` the build, the data and the walls of
(a), (b), (f), (h), (q), (v), meshed (q), (x), (y), the histogram call,
S2b's 16 lanes and the hash_device pod ingest (with its mesh_factorize
stage) alone, so that one call can time two trees of the port in turns;
`python3 chip_smoke.py --splits` the build, c4_c24_split_phase,
c6_c7_split_phase, c22_c23_split_phase, c20_c8_split_phase and
c18_c14_split_phase alone (`--splits=c18_c14` that one), on
this tree or, for the same comparison, its parent's.
The last lines are the card's name and power limit (nvidia-smi), one JSON
line describing every kernel, and the result line.
"""

import contextlib
import dataclasses
import faulthandler
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

N_ROWS = 1 << 24
N_USERS = 480_189
N_MOVIES = 17_770
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
OPS_PER_S = 67e12  # float32 outside the tensor cores, NVIDIA data sheet
SEED = 20261017
# The kernels every aggregation and selection launches (C1-C6); the
# percentile and vector paths add theirs; secure noise and safe mode take
# the _secure / _compensated entries instead (secure_safe_main_phase).
BASE_KERNELS = ("row_keys", "bound_rows", "reduce_partitions",
                "release_epilogue", "radix_sort", "compact_kept")
# The dense quantile regime (C7's histogram and roll-ups), and the lazy
# one (C7's child counts, counted under their own name).
PERCENTILE_PATH = BASE_KERNELS + ("quantile_counts", "quantile_descend")
LAZY_PERCENTILE_PATH = BASE_KERNELS + ("quantile_child_counts",
                                       "quantile_descend")
VECTOR_PATH = BASE_KERNELS + ("vector_release",)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `repeats` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def netflix_rows(rng: np.random.Generator):
    """2^24 distinct (user, movie) ratings with Netflix Prize cardinalities:
    Zipf(0.6) movie popularity, Zipf(0.5) user activity, ratings 1-5."""
    def zipf_weights(n, s):
        w = np.arange(1, n + 1, dtype=np.float64)**-s
        return w / w.sum()

    draws = int(N_ROWS * 1.08)
    movies = rng.choice(N_MOVIES, draws, p=zipf_weights(N_MOVIES, 0.6))
    users = rng.choice(N_USERS, draws, p=zipf_weights(N_USERS, 0.5))
    pair = np.unique(users.astype(np.int64) * N_MOVIES + movies)
    if pair.size < N_ROWS:
        raise RuntimeError(f"only {pair.size} distinct ratings drawn")
    pair = rng.permutation(pair)[:N_ROWS]
    users, movies = pair // N_MOVIES, pair % N_MOVIES
    # Scramble the ids so popularity does not follow the id order.
    users = rng.permutation(N_USERS)[users]
    movies = rng.permutation(N_MOVIES)[movies]
    ratings = rng.choice(5, N_ROWS, p=[0.05, 0.1, 0.29, 0.34, 0.22]) + 1
    return users, movies, ratings.astype(np.float64)


def check_close(name, got, want, rtol, atol=0.0):
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        raise AssertionError(f"{name}: {int(bad.sum())} values differ, first "
                             f"at {i}: {float(got[i])} vs {float(want[i])}")
    return float(err.max()) if err.numel() else 0.0


def abs_diff(got, want) -> float:
    """The largest |got - want| over two tensors of one shape: NaN against
    NaN and equal infinities count 0, any other NaN or Inf difference
    inf."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)} differ")
    g, w = got.double(), want.double()
    same = (g == w) | (g.isnan() & w.isnan())
    d = torch.where(same, torch.zeros_like(g), (g - w).abs())
    d = torch.nan_to_num(d, nan=math.inf)
    return float(d.max()) if d.numel() else 0.0


def check_equal(name, got, want):
    """got equals want exactly; returns the largest difference measured."""
    import torch
    err = abs_diff(got, want)
    if not torch.equal(got, want):
        diff = int((got != want).sum())
        raise AssertionError(f"{name}: {diff} entries differ from the plain "
                             f"version (largest difference {err})")
    return err


def same_twice(label, fn, first=None):
    """A second call of fn gives the same bits as the first (`first`, or a
    call made here): C3's association is fixed by its inputs alone.
    Returns the first call's dict of tensors."""
    import torch
    first = fn() if first is None else first
    again = fn()
    for name, value in first.items():
        if not torch.equal(value, again[name]):
            raise AssertionError(f"{label} {name}: two calls on the same "
                                 f"inputs differ")
    return first


def main() -> int:
    import torch
    # A crash in native code prints every thread's Python stack.
    faulthandler.enable()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test "
              "needs one CUDA card.", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pipelinedp_tpu_torch as tdp
    from pipelinedp_tpu_torch import (columnar, cuda_build, device_encode,
                                      executor, ingest, kernels)
    from pipelinedp_tpu_torch.ops import threefry
    from pipelinedp_tpu_torch.parallel import large_p
    from pipelinedp_tpu_torch.runtime import pipeline as rt_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    if "--mesh-all-cards" in sys.argv[1:]:
        return mesh_all_cards(torch, tdp, cuda_build, columnar, kernels,
                              card, t0)
    if "--elastic" in sys.argv[1:]:
        return elastic_only(torch, tdp, cuda_build, columnar, kernels, card,
                            t0)
    if "--walls" in sys.argv[1:]:
        return walls_only(torch, tdp, cuda_build, columnar, card, t0)
    if any(a == "--splits" or a.startswith("--splits=")
           for a in sys.argv[1:]):
        return splits_only(torch, tdp, cuda_build, columnar, kernels,
                           executor, device_encode, ingest, card, t0)

    # 1. build -------------------------------------------------------------
    build_s = cuda_build.build_all()
    print(f"build: {len(cuda_build.SOURCES)} kernel sources in "
          f"{build_s:.1f} s ({card})", flush=True)

    # Data for the full-size phases.
    rng = np.random.default_rng(SEED)
    users, movies, ratings = netflix_rows(rng)
    enc_start = time.perf_counter()
    encoded = columnar.encode_columns(users, movies, ratings)
    encode_s = time.perf_counter() - enc_start
    print(f"data: {N_ROWS} rows, {encoded.n_privacy_ids} privacy ids, "
          f"{encoded.n_partitions} partitions, encoded in {encode_s:.1f} s",
          flush=True)
    if encoded.n_partitions != N_MOVIES:
        raise AssertionError(f"{encoded.n_partitions} movies drawn, "
                             f"expected {N_MOVIES}")

    years = by_release_year(encoded)
    onehot = one_hot_ratings(encoded)
    enc_start = time.perf_counter()
    qraw = zipfish_rows()
    qenc = columnar.encode_columns(*qraw)
    qmax = data_maxima(qenc.pid, qenc.pk, qenc.n_partitions)
    nmax = data_maxima(encoded.pid, encoded.pk, encoded.n_partitions)
    print(f"data (q): {qenc.n_rows} rows, {qenc.n_privacy_ids} privacy ids, "
          f"{qenc.n_partitions} partitions ({-(-qenc.n_partitions // LARGE_BLOCK)}"
          f" blocks of 2^20), {qmax[0]} partitions per id at most, {qmax[1]} "
          f"rows per (id, partition) at most; encoded in "
          f"{time.perf_counter() - enc_start:.1f} s", flush=True)

    def lap(label):
        # Where the script's time goes, for the next cut of its depth.
        print(f"elapsed after {label}: {time.perf_counter() - t0:.1f} s",
              flush=True)

    lap("the build and the data")

    # 2. kernels -----------------------------------------------------------
    report = kernel_phase(torch, dev, encoded, kernels, executor, threefry,
                          card)
    report += quantile_vector_kernel_phase(torch, dev, encoded, years,
                                           kernels, threefry)
    report += secure_safe_kernel_phase(torch, dev, encoded, years, kernels,
                                       executor, threefry)
    report += large_p_kernel_phase(torch, dev, qenc, qmax, kernels, large_p,
                                   threefry, tdp, card)
    c3_edge_phase(torch, dev, kernels)
    c10_c21_edge_phase(torch, dev, kernels)
    c5_c2_edge_phase(torch, dev, kernels)
    c12_c17_edge_phase(torch, dev, kernels, ingest)
    c4_c24_edge_phase(torch, dev, kernels, executor, device_encode,
                      cuda_build)
    c4_c24_split_phase(torch, dev, kernels, executor, device_encode, ingest,
                       users, card)
    c6_c7_edge_phase(torch, dev, kernels)
    c22_c23_edge_phase(torch, dev, kernels)
    c20_c8_edge_phase(torch, dev, tdp, kernels, executor)
    c18_c14_edge_phase(torch, dev, kernels)
    report += ingest_kernel_phase(
        torch, dev, {"users": (users, encoded.pid),
                     "movies": (movies, encoded.pk),
                     "q partitions": (qraw[1], qenc.pk)},
        kernels, device_encode, ingest, card)

    lap("the kernel phases")

    # 3. parity ------------------------------------------------------------
    parity_phase(torch, tdp, rng)
    quantile_vector_parity_phase(torch, tdp, rng)
    select_parity_phase(torch, tdp, rng)
    secure_safe_parity_phase(torch, tdp, kernels, rng)
    large_p_parity_phase(torch, tdp, rng)
    ingest_parity_phase(torch, tdp, rng)

    lap("the parity phases")

    # 4.-5. main paths -----------------------------------------------------
    streamed = {"netflix": ((users, movies, ratings), encoded),
                "q": (qraw, qenc)}
    launches = main_phase(torch, tdp, encoded, kernels, card)
    for phase in (quantile_vector_main_phase(torch, dev, tdp, encoded, years,
                                             onehot, kernels, executor,
                                             card),
                  secure_safe_main_phase(torch, tdp, encoded, years, onehot,
                                         kernels, card),
                  select_phase(torch, tdp, encoded, kernels, card),
                  large_p_main_phase(torch, tdp, qenc, qmax, encoded, nmax,
                                     kernels, large_p, card),
                  ingest_main_phase(torch, tdp, streamed, kernels, executor,
                                    card)):
        for name, count in phase.items():
            launches[name] += count
    lap("the main paths")
    # The PLD phases run after every earlier timed run: the full-width
    # composition's gigabyte buffers and its host composition stay out of
    # their conditions.
    pld_report, pld_launches = pld_kernel_phase(torch, dev, kernels, card)
    report += pld_report
    for phase in (pld_release_phase(torch, tdp, encoded, nmax, kernels,
                                    executor, rng, card), pld_launches):
        for name, count in phase.items():
            launches[name] += count
    hist_report, hist_launches = histogram_phase(
        torch, dev, {"netflix": (encoded.pid, encoded.pk, encoded.values,
                                 nmax[1]),
                     "q": (qenc.pid, qenc.pk, qenc.values, qmax[1])},
        kernels, card)
    report += hist_report
    for name, count in hist_launches.items():
        launches[name] += count
    lap("the PLD and histogram phases")
    kernel_stage_phase(torch, tdp, encoded, onehot, kernels, executor, card)
    large_p_stage_phase(torch, tdp, qenc, encoded, nmax, kernels, large_p,
                        threefry, card)
    ingest_stage_phase(torch, tdp, streamed, kernels, executor, ingest,
                       rt_pipeline, encode_s, card)
    profile_phase(torch, tdp, encoded, card)
    lap("the stages and the profile")
    # Utility analysis and tuning, after every earlier timed run.
    report += sweep_kernel_phase(torch, dev, sweep_shapes(tdp, encoded),
                                 kernels, card)
    for name, count in analysis_main_phase(torch, tdp, users, movies,
                                           ratings, kernels, card).items():
        launches[name] += count
    lap("the sweep and the analysis")
    # The multi-tenant service and megabatched serving (K24), last of all.
    report += service_kernel_phase(torch, dev, tdp, encoded, kernels,
                                   executor, card)
    report += spec_kernel_phase(torch, dev, tdp, encoded, kernels, executor,
                                card)
    for name, count in service_phase(torch, tdp, kernels, card, users,
                                     movies, ratings).items():
        launches[name] += count
    lap("the service")
    # The dense route over a device mesh (K21, K22, K24c), after every
    # earlier phase.
    report += mesh_kernel_phase(torch, dev, encoded, onehot, kernels, card)
    mesh_parity_phase(torch, tdp, rng)
    for phase in (mesh_phase(torch, tdp, encoded, kernels, card),
                  mesh_service_phase(torch, tdp, kernels, card, users, movies,
                                     ratings)):
        for name, count in phase.items():
            launches[name] += count
    # The blocked route over the mesh (K23a), last of all.
    mb_report, mb_launches = mesh_blocked_phase(
        torch, tdp, rng, qenc, encoded, nmax, kernels, large_p, card)
    report += mb_report
    for name, count in mb_launches.items():
        launches[name] += count
    # The single-process mesh ingest (K23b) and the unfused release, last.
    report += mesh_ingest_kernel_phase(
        torch, dev, {"users": (users, encoded.pid),
                     "movies": (movies, encoded.pk),
                     "q partitions": (qraw[1], qenc.pk)},
        kernels, device_encode, ingest, card)
    for phase in (mesh_ingest_main_phase(torch, tdp, streamed, nmax, kernels,
                                         ingest, device_encode, card),
                  unfused_phase(torch, tdp, encoded, kernels, card)):
        for name, count in phase.items():
            launches[name] += count
    lap("the mesh phases")
    # The failure semantics and elastic meshes, with K23c, last of all.
    report += heartbeat_kernel_phase(torch, kernels, card)
    for name, count in elastic_phase(torch, tdp, encoded, nmax, qenc, qmax,
                                     kernels, card).items():
        launches[name] += count
    for entry in report:
        entry["launches"] = launches[entry["name"]]
        print(f"kernel {entry['name']}: max_abs_err={entry['max_abs_err']} "
              f"ms={entry['ms']:.4f} launches over the main-path runs="
              f"{entry['launches']} ({card})", flush=True)

    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bound(nbytes: float, ops: float, ops_per_s: float = OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sort_passes(words) -> int:
    """8-bit passes C5 makes over these words (integers and non-negative
    floats): per word, the bits that differ from row 0, as runs of
    adjacent bits with the constant gaps between them dropped (the
    narrowest gaps kept where there are more than 4 runs)."""
    passes = 0
    for word in words:
        raw = word.cpu().numpy()
        raw = raw.view(np.uint64 if raw.itemsize == 8 else np.uint32)
        diff = int(np.bitwise_or.reduce(raw ^ raw[0])) if raw.size else 0
        bits = [b for b in range(64) if diff >> b & 1]
        runs = []
        for b in bits:
            if runs and runs[-1][1] == b:
                runs[-1][1] = b + 1
            else:
                runs.append([b, b + 1])
        while len(runs) > 4:
            j = min(range(1, len(runs)),
                    key=lambda r: runs[r][0] - runs[r - 1][1])
            runs[j - 1][1] = runs.pop(j)[1]
        passes += -(-sum(hi - lo for lo, hi in runs) // 8)
    return passes


def torch_sort_chain(torch, words):
    """The stable torch.argsort chain the port ran before C5 (library
    yardstick)."""
    perm = torch.argsort(words[-1], stable=True)
    for word in reversed(words[:-1]):
        perm = perm[torch.argsort(word[perm], stable=True)]
    return perm


def kernel_phase(torch, dev, encoded, kernels, executor, threefry,
                 card=None):
    """C1-C6 against their plain versions on the card, small then full;
    at full size the times, and for C5 and C2 the three_way splits and
    the device operations a sort issues."""
    card = card or card_line()
    f32 = torch.float32
    params_cfg = dict(linf=1, l0=64, clip_per_value=True,
                      clip_pair_sum=False)
    key = np.array([7, 11], dtype=np.uint32)
    rows_key, final_key = threefry.split(key, 2)
    key_total, key_linf, key_l0 = threefry.split(rows_key, 3)
    salts = threefry.bits(key_l0, 4)
    report = []

    def inputs(n_rows):
        sl = slice(0, n_rows)
        pid = torch.as_tensor(encoded.pid[sl]).to(dev)
        pk = torch.as_tensor(encoded.pk[sl]).to(dev)
        values = torch.as_tensor(encoded.values[sl]).to(dev, f32)
        valid = torch.as_tensor(encoded.valid[sl]).to(dev)
        return pid, pk, values, valid

    for label, n_rows in (("small", 4096), ("full", encoded.n_rows)):
        P = encoded.n_partitions
        pid, pk, values, valid = inputs(n_rows)
        n = pid.shape[0]
        # C1, both entries
        c1 = lambda: kernels.row_keys(pid, pk, valid, salts, key_linf, P,  # noqa: E731
                                      f32)
        c1p = lambda: kernels.row_keys_plain(pid, pk, valid, salts,  # noqa: E731
                                             key_linf, P, f32)
        k1, k2, u = c1()
        p1, p2, pu = c1p()
        pid_sent, u0 = kernels.total_bound_keys(pid, valid, key_total, f32)
        q_sent, q_u0 = kernels.total_bound_keys_plain(pid, valid, key_total,
                                                      f32)
        err1 = max(check_equal("row_keys k1", k1, p1),
                   check_equal("row_keys k2", k2, p2),
                   check_equal("row_keys u", u, pu),
                   check_equal("total_bound_keys pid", pid_sent, q_sent),
                   check_equal("total_bound_keys u", u0, q_u0))
        # C5 on the four key sets of the path: the same permutation (and
        # the bounding sort's sorted k1, which C2 reads on the main path).
        perm, sorted_k1 = kernels.radix_sort([k1, k2, u], sorted_top=True)
        perm0, spid0 = kernels.radix_sort([pid_sent, u0], sorted_top=True)
        q_perm0, q_spid0 = kernels.radix_sort_plain([pid_sent, u0], True)
        err5 = max(check_equal("radix_sort bounding", perm,
                               kernels.radix_sort_plain([k1, k2, u])),
                   check_equal("radix_sort bounding sorted k1", sorted_k1,
                               k1[perm]),
                   check_equal("radix_sort selection",
                               kernels.radix_sort([k1, k2]),
                               kernels.radix_sort_plain([k1, k2])),
                   check_equal("radix_sort total_bound", perm0, q_perm0),
                   check_equal("radix_sort total_bound sorted pid", spid0,
                               q_spid0))
        # C2, all three forms
        cols = ("sum", "nsum", "nsum2")
        c2_args = dict(n_partitions=P, scalars=(1.0, 5.0, 0.0, 0.0, 3.0),
                       columns=cols, **params_cfg)
        c2 = lambda: kernels.bound_rows(perm, k1, k2, pk, values, valid,  # noqa: E731
                                        sorted_k1=sorted_k1, **c2_args)
        c2p = lambda: kernels.bound_rows_plain(perm, k1, k2, pk, values,  # noqa: E731
                                               valid, **c2_args)
        key2, pair_start, row_cols = c2()
        q_key2, q_start, q_cols = c2p()
        sel_args = dict(n_partitions=P, linf=0, l0=64, clip_per_value=False,
                        clip_pair_sum=False, scalars=(0.0,) * 5, columns=())
        s_key2, s_start, _ = kernels.bound_rows(perm, k1, k2, pk, None,
                                                valid, sorted_k1=sorted_k1,
                                                **sel_args)
        qs_key2, qs_start, _ = kernels.bound_rows_plain(perm, k1, k2, pk,
                                                        None, valid,
                                                        **sel_args)
        total = kernels.total_bound_rows(perm0, spid0, pk, values, valid,
                                         total_bound=64, n_partitions=P)
        q_total = kernels.total_bound_rows_plain(perm0, spid0, pk, values,
                                                 valid, total_bound=64,
                                                 n_partitions=P)
        err2 = max([check_equal("bound_rows key2", key2, q_key2),
                    check_equal("bound_rows pair_start", pair_start,
                                q_start),
                    check_equal("bound_rows selection key2", s_key2,
                                qs_key2),
                    check_equal("bound_rows selection pair_start", s_start,
                                qs_start)] +
                   [check_equal(f"bound_rows {c}", row_cols[c], q_cols[c])
                    for c in cols] +
                   [check_equal(f"total_bound_rows {c}", a, b)
                    for c, a, b in zip(("pid", "pk", "values", "valid"),
                                       total, q_total)])
        perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
        q_perm2, q_skey2 = kernels.radix_sort_plain([key2], True)
        err5 = max(err5, check_equal("radix_sort partition", perm2, q_perm2),
                   check_equal("radix_sort partition sorted key2", skey2,
                               q_skey2))
        # C3: float sums are taken in another order than the plain
        # version's index_add_; tolerance 1e-5 of the partition's sum of
        # magnitudes.
        c3 = lambda: kernels.reduce_partitions(skey2, perm2, pair_start,  # noqa: E731
                                               row_cols, P, f32)
        c3p = lambda: kernels.reduce_partitions_plain(  # noqa: E731
            skey2, perm2, pair_start, row_cols, P, f32)
        dense = same_twice("reduce_partitions", c3)
        q_dense = c3p()
        abs_cols = {c: row_cols[c].abs() for c in cols}
        scale = kernels.reduce_partitions_plain(skey2, perm2, pair_start,
                                                abs_cols, P, f32)
        err3 = max(check_equal("reduce count", dense["count"],
                               q_dense["count"]),
                   check_equal("reduce pid_count", dense["pid_count"],
                               q_dense["pid_count"]))
        for c in cols:
            tol = 1e-5 * scale[c].double() + 1e-6
            diff = (dense[c].double() - q_dense[c].double()).abs()
            if bool((diff > tol).any()):
                raise AssertionError(f"reduce_partitions {c}: max diff "
                                     f"{float(diff.max())} over tolerance")
            err3 = max(err3, float(diff.max()))
        dense["row_count"] = dense["pid_count"]
        # C4 on the partition columns of C3, private selection, all five
        # outputs: the widest plan of the path.
        plan = [("variance", ("variance", "count", "sum", "mean"), 0),
                ("privacy_id_count", ("privacy_id_count",), 3)]
        stds = np.array([2.0, 5.0, 40.0, 1.5])
        key_sel, key_noise = threefry.split(final_key, 2)
        slot = np.stack([threefry.fold_in(threefry.fold_in(key_noise, i), j)
                         for i, n_j in ((0, 3), (1, 1)) for j in range(n_j)])
        from pipelinedp_tpu_torch.aggregate_params import (
            NoiseKind, PartitionSelectionStrategy)
        from pipelinedp_tpu_torch.ops import selection_ops
        sel = selection_ops.selection_params_from_host(
            PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-6, 64,
            None)
        c4_args = (dense, plan, stds, slot, NoiseKind.GAUSSIAN, False, 3.0,
                   1.0, sel, key_sel, 1)
        c4 = lambda: kernels.release_epilogue(*c4_args)  # noqa: E731
        c4p = lambda: kernels.release_epilogue_plain(*c4_args)  # noqa: E731
        keep, outs, flags = c4()
        q_keep, q_outs, q_flags = c4p()
        err4 = max(check_equal("release keep", keep, q_keep),
                   check_equal("release flags", flags, q_flags))
        for name in outs:
            # float32 libm (log1pf, erfcf, expf) against torch's: a few ulp.
            err4 = max(err4, check_close(f"release {name}", outs[name],
                                         q_outs[name], rtol=1e-5,
                                         atol=1e-5))
        # C6 at the main path's P (about half kept, the widest plan's five
        # columns) and at the dense route's largest P, 2^21.
        gen = torch.Generator(device=dev).manual_seed(n)
        err6 = 0.0
        compact_args = {}
        for n_parts in (P, 1 << 21):
            half = torch.rand(n_parts, device=dev, generator=gen) < 0.5
            ccols = {o: torch.randn(n_parts, device=dev, generator=gen)
                     for o in ("count", "privacy_id_count", "sum", "mean",
                               "variance")}
            got = kernels.compact_kept(half, ccols)
            want = kernels.compact_kept_plain(half, ccols)
            err6 = max([check_equal(f"compact_kept P={n_parts} n_kept",
                                    got[0], want[0]),
                        check_equal(f"compact_kept P={n_parts} order",
                                    got[1], want[1])] +
                       [check_equal(f"compact_kept P={n_parts} {o}",
                                    got[2][o], want[2][o]) for o in ccols])
            compact_args[n_parts] = (half, ccols)
        torch.cuda.synchronize()
        errors = {"row_keys": err1, "bound_rows": err2,
                  "reduce_partitions": err3, "release_epilogue": err4,
                  "radix_sort": err5, "compact_kept": err6}
        print(f"kernels[{label}, n={n}, P={P}]: all six agree with their "
              f"plain versions (C5 on the bounding, selection, total-bound "
              f"and partition keys; C6 at P={P} and 2^21), max abs err " +
              json.dumps(errors), flush=True)
        if label != "full":
            continue
        fsz = 4
        n_cols = len(cols)
        bounding = [k1, k2, u]
        half, ccols = compact_args[P]
        n_kept = int(half.sum())
        # Rows the bounding kept: the only rows whose columns C3 needs.
        kept_rows = int((skey2 < P).sum())
        print(f"bounded rows kept: {kept_rows} of {n} (l0 = 64, linf = 1)",
              flush=True)
        timing = {
            "row_keys": (c1, c1p, None,
                         bound(n * (4 + 4 + 1) + n * (8 + 8 + fsz),
                               n * 170)),
            "bound_rows": (c2, c2p, None,
                           bound(n * (8 + 8 + 8 + fsz + 1) +
                                 n * (4 + 1 + n_cols * fsz), n * 40)),
            "reduce_partitions": (c3, c3p, "index_add",
                                  bound(n * 4 + kept_rows *
                                        (8 + 1 + n_cols * fsz) +
                                        P * 5 * fsz, kept_rows * 8)),
            "release_epilogue": (c4, c4p, None,
                                 bound(P * 5 * fsz + P * (1 + 5 * fsz) + 4,
                                       P * 700)),
            # Each key word read once, the int64 permutation written once;
            # ~12 integer operations a row and pass (digit, count, rank,
            # address).
            "radix_sort": (lambda: kernels.radix_sort(bounding),
                           lambda: kernels.radix_sort_plain(bounding),
                           lambda: torch_sort_chain(torch, bounding),
                           bound(n * (8 + 8 + fsz) + n * 8,
                                 n * 12 * sort_passes(bounding))),
            "compact_kept": (lambda: kernels.compact_kept(half, ccols),
                             lambda: kernels.compact_kept_plain(half, ccols),
                             lambda: kernels.compact_kept_plain(half, ccols),
                             bound(P * (1 + 5 * fsz) + P * (8 + 5 * fsz) + 8,
                                   P * 10)),
        }
        src = torch.stack([torch.ones_like(values), pair_start.float()] +
                          [row_cols[c] for c in cols], 1)[perm2]
        key_long = skey2.long()

        def library_c3():
            out = torch.zeros(P + 1, src.shape[1], device=dev)
            return out.index_add_(0, key_long, src)

        sources = {"row_keys": "row_keys.cu", "bound_rows": "bound_rows.cu",
                   "reduce_partitions": "reduce_partitions.cu",
                   "release_epilogue": "release_epilogue.cu",
                   "radix_sort": "radix_sort.cu",
                   "compact_kept": "compact_kept.cu"}
        replaces = {
            "row_keys": "pipelinedp_tpu/executor.py:287",
            "bound_rows": "pipelinedp_tpu/executor.py:313",
            "reduce_partitions": "pipelinedp_tpu/executor.py:455",
            "release_epilogue": "pipelinedp_tpu/executor.py:551",
            "radix_sort": "pipelinedp_tpu/executor.py:307",
            "compact_kept": "pipelinedp_tpu/executor.py:936",
        }
        for name, (fn, plain, lib, (b_ms, b_by)) in timing.items():
            ms = cuda_ms(fn, repeats=10)
            plain_ms = cuda_ms(plain, repeats=3, warmup=1)
            if lib == "index_add":
                lib = library_c3
            lib_ms = cuda_ms(lib, repeats=10) if lib else None
            print(f"kernel {name}: max_abs_err={errors[name]} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) "
                  f"library_ms={lib_ms}", flush=True)
            report.append({
                "name": name, "route": "cuda",
                "source": f"pipelinedp_tpu_torch/csrc/{sources[name]}",
                "replaces": replaces[name], "launches": 0,
                "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        # The other shapes of C5 and C6 on the path, beside the torch chain.
        for kname, words in (("selection", [k1, k2]),
                             ("total_bound", [pid_sent, u0]),
                             ("partition", [key2])):
            b_ms, b_by = bound(n * sum(w.element_size() for w in words) +
                               n * 8, n * 12 * sort_passes(words))
            print(f"kernel radix_sort[{kname}]: ms="
                  f"{cuda_ms(lambda: kernels.radix_sort(words), 10):.4f} "
                  f"passes={sort_passes(words)} bound_ms={b_ms:.3g} ({b_by}) "
                  f"plain_ms="
                  f"{cuda_ms(lambda: kernels.radix_sort_plain(words), 3, 1):.4f}"
                  f" torch_chain_ms="
                  f"{cuda_ms(lambda: torch_sort_chain(torch, words), 10):.4f}",
                  flush=True)
        # C5 and C2 split (wrapper / device / host), in turns with the
        # argsort chain; the device operations of each sort (kernels,
        # memsets, the masks' copy) from torch.profiler.
        for kname, words in (("bounding", bounding), ("selection", [k1, k2]),
                             ("total_bound", [pid_sent, u0]),
                             ("partition", [key2])):
            print(f"radix_sort[{kname}]: {sort_passes(words)} passes, "
                  f"device operations a sort "
                  f"{json.dumps(device_ops(torch, lambda: kernels.radix_sort(words)))}",
                  flush=True)
        for kname, words in (("bounding", bounding), ("partition", [key2])):
            print_three_way(f"C5 {kname}, {n} rows", three_way(torch, {
                "radix_sort": lambda: kernels.radix_sort(words),
                "argsort chain": lambda: torch_sort_chain(torch, words)},
                host_calls=200), card)
        print_three_way(f"C2 solo, {n} rows, bound "
                        f"{timing['bound_rows'][3][0]:.3g} ms",
                        three_way(torch, {"bound_rows": c2}, host_calls=200),
                        card)
        big_keep, big_cols = compact_args[1 << 21]
        b_ms, b_by = bound((1 << 21) * (1 + 5 * fsz) +
                           (1 << 21) * (8 + 5 * fsz) + 8, (1 << 21) * 10)
        print(f"kernel compact_kept[P=2^21, {int(big_keep.sum())} kept]: ms="
              f"{cuda_ms(lambda: kernels.compact_kept(big_keep, big_cols), 10):.4f}"
              f" argsort_gather_ms="
              f"{cuda_ms(lambda: kernels.compact_kept_plain(big_keep, big_cols), 10):.4f}"
              f" bound_ms={b_ms:.3g} ({b_by}) (P={P}: {n_kept} kept)",
              flush=True)
    return report


def by_release_year(encoded):
    """The table grouped by a release year drawn per movie from the seed,
    over 1890-2005 (the range of the Netflix Prize's movie_titles.txt):
    at most 116 partitions, the dense quantile regime at full row count."""
    import dataclasses
    year = np.random.default_rng([SEED, 1]).integers(1890, 2006, N_MOVIES)
    vocab, code = np.unique(year, return_inverse=True)
    return dataclasses.replace(encoded, pk=code.astype(np.int32)[encoded.pk],
                               partition_vocab=[int(y) for y in vocab])


def one_hot_ratings(encoded):
    """The table with each rating as a one-hot vector (D = 5): a movie's
    vector sum is its rating histogram."""
    import dataclasses
    values = np.zeros((encoded.n_rows, 5))
    values[np.arange(encoded.n_rows), encoded.values.astype(np.int64) - 1] = 1
    return dataclasses.replace(encoded, values=values)


QUANTILES = (0.1, 0.5, 0.9)


def quantile_vector_kernel_phase(torch, dev, encoded, years, kernels,
                                 threefry):
    """C7, C8, C9 and C3's vector entry against their plain versions on the
    card, at 4096 rows and at 2^24, on the bounded rows of the main path
    (movies: the lazy regime and the vector sums; release years: the dense
    regime)."""
    from pipelinedp_tpu_torch.aggregate_params import NoiseKind
    from pipelinedp_tpu_torch.ops import quantile_tree
    f32 = torch.float32
    key = np.array([7, 11], dtype=np.uint32)
    rows_key, _ = threefry.split(key, 2)
    _, key_linf, key_l0 = threefry.split(rows_key, 3)
    salts = threefry.bits(key_l0, 4)
    qkey = threefry.fold_in(key, 7919)
    h, B = quantile_tree.DEFAULT_TREE_HEIGHT, \
        quantile_tree.DEFAULT_BRANCHING_FACTOR
    L = B**h
    n_q = len(QUANTILES)
    lo, hi = 1.0, 5.0
    std_lazy = quantile_tree.per_level_noise_std(0.5, 5e-7, 64, 1, h,
                                                 NoiseKind.GAUSSIAN)
    std_dense = quantile_tree.per_level_noise_std(0.5, 0.0, 16, 4, h,
                                                  NoiseKind.LAPLACE)
    report = []

    def bounded(enc, n_rows, l0, linf):
        sl = slice(0, n_rows)
        pid = torch.as_tensor(enc.pid[sl]).to(dev)
        pk = torch.as_tensor(enc.pk[sl]).to(dev)
        values = torch.as_tensor(enc.values[sl]).to(dev, f32)
        valid = torch.as_tensor(enc.valid[sl]).to(dev)
        P = enc.n_partitions
        k1, k2, u = kernels.row_keys(pid, pk, valid, salts, key_linf, P, f32)
        perm, sk1 = kernels.radix_sort([k1, k2, u], sorted_top=True)
        key2, pair_start, _ = kernels.bound_rows(
            perm, k1, k2, pk, None, valid, n_partitions=P, linf=linf, l0=l0,
            clip_per_value=False, clip_pair_sum=False, scalars=(0.0,) * 5,
            columns=(), sorted_k1=sk1)
        perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
        return P, values, perm, perm2, skey2, pair_start

    for label, n_rows in (("small", 4096), ("full", encoded.n_rows)):
        errors = {}
        # --- dense regime: release years -----------------------------------
        Py, yvals, yperm, yperm2, yskey2, _ = bounded(years, n_rows, 16, 4)
        c7a = lambda: kernels.quantile_leaf_counts(  # noqa: E731
            yskey2, yperm2, yperm, yvals, n_partitions=Py, n_leaves=L,
            min_v=lo, max_v=hi)
        c7a_plain = lambda: kernels.quantile_leaf_counts_plain(  # noqa: E731
            yskey2, yperm2, yperm, yvals, n_partitions=Py, n_leaves=L,
            min_v=lo, max_v=hi)
        hist = c7a()
        err7 = check_equal("quantile_leaf_counts", hist, c7a_plain())
        c7b = lambda: kernels.quantile_level_counts(  # noqa: E731
            hist, tree_height=h, branching=B)
        c7b_plain = lambda: kernels.quantile_level_counts_plain(  # noqa: E731
            hist, tree_height=h, branching=B)
        levels = c7b()
        for l, (a, b) in enumerate(zip(levels, c7b_plain()), 1):
            check_equal(f"quantile_level_counts level {l}", a, b)
        ckey = threefry.fold_in(qkey, 0)
        level_keys = np.stack([threefry.fold_in(ckey, l) for l in range(h)])
        ykeep = torch.ones(Py, dtype=torch.bool, device=dev)

        def c8_dense(plain=False, leaves=None):
            fn = (kernels.quantile_descend_dense_plain if plain else
                  kernels.quantile_descend_dense)
            flags = torch.zeros(1, dtype=torch.int32, device=dev)
            out = fn(levels, QUANTILES, std=std_dense, level_keys=level_keys,
                     gaussian=False, min_v=lo, max_v=hi, keep=ykeep,
                     flags=flags, dtype=f32, leaves=leaves)
            return out, flags

        leaves_k = torch.empty(Py, n_q, dtype=torch.int32, device=dev)
        leaves_p = torch.empty_like(leaves_k)
        out_k, flags_k = c8_dense(leaves=leaves_k)
        out_p, flags_p = c8_dense(plain=True, leaves=leaves_p)
        dense_mismatch = int((leaves_k != leaves_p).sum())
        print(f"kernels[{label}] quantile_descend dense (P={Py}): "
              f"{dense_mismatch} of {Py * n_q} walks end at another leaf "
              f"than the plain version's", flush=True)
        if dense_mismatch:
            raise AssertionError("quantile_descend dense: leaves differ")
        err8 = max(check_close("quantile_descend dense", out_k, out_p,
                               rtol=1e-5),
                   check_equal("quantile_descend dense flags", flags_k,
                               flags_p))
        # --- lazy regime and vector sums: movies -----------------------------
        P, values, perm, perm2, skey2, pair_start = bounded(encoded, n_rows,
                                                            64, 1)
        keep = torch.ones(P, dtype=torch.bool, device=dev)
        tree = dict(tree_height=h, branching=B, min_v=lo, max_v=hi)
        step_args = dict(tree_height=h, std=std_lazy, gaussian=True,
                         min_v=lo, max_v=hi, keep=keep)
        state = kernels.DescentState(P, n_q, f32, dev)
        flags_k = torch.zeros(1, dtype=torch.int32, device=dev)
        flags_p = torch.zeros(1, dtype=torch.int32, device=dev)
        counts_by_level, nodes_by_level = [], []
        # The leaf buffer of the descent's passes: level 1 fills it, levels
        # 2..h read it; each level also == the gather without a buffer.
        leaf_k = torch.empty(skey2.shape[0], dtype=torch.int32, device=dev)
        leaf_p = torch.empty_like(leaf_k)
        for level in range(1, h + 1):
            node = state.node.clone()
            counts = kernels.quantile_child_counts(skey2, perm2, perm, values,
                                                   node, level=level,
                                                   leaf=leaf_k, **tree)
            err7 = max(err7, check_equal(
                f"quantile_child_counts level {level}", counts,
                kernels.quantile_child_counts_plain(
                    skey2, perm2, perm, values, node, level=level,
                    leaf=leaf_p, **tree)),
                check_equal(f"quantile_child_counts level {level} vs the "
                            f"gather", counts, kernels.quantile_child_counts(
                                skey2, perm2, perm, values, node,
                                level=level, **tree)))
            if level == 1:
                err7 = max(err7, check_equal("quantile_child_counts leaf "
                                             "buffer", leaf_k, leaf_p))
            counts_by_level.append(counts)
            nodes_by_level.append(node)
            before = kernels.DescentState(P, n_q, f32, dev)
            for name in ("node", "target", "total", "mass"):
                setattr(before, name, getattr(state, name).clone())
            lkey = threefry.fold_in(qkey, level)
            out_k = kernels.quantile_descend_step(
                counts, state, QUANTILES, level=level, level_key=lkey,
                flags=flags_k, **step_args)
            out_p = kernels.quantile_descend_step_plain(
                counts, before, QUANTILES, level=level, level_key=lkey,
                flags=flags_p, **step_args)
            lazy_mismatch = int((state.node != before.node).sum())
            if lazy_mismatch:
                raise AssertionError(f"quantile_descend lazy level {level}: "
                                     f"{lazy_mismatch} walks at another node")
            err8 = max(err8, check_close(f"quantile_descend lazy level "
                                         f"{level} target", state.target,
                                         before.target, rtol=1e-5, atol=1e-3))
        print(f"kernels[{label}] quantile_descend lazy (P={P}): 0 of "
              f"{P * n_q} walks end at another leaf than the plain "
              f"version's", flush=True)
        err8 = max(err8, check_close("quantile_descend lazy", out_k, out_p,
                                     rtol=1e-5),
                   check_equal("quantile_descend lazy flags", flags_k,
                               flags_p))
        onehot = torch.nn.functional.one_hot(
            values.long() - 1, 5).to(f32).contiguous()
        c3v = lambda: kernels.reduce_partitions(  # noqa: E731
            skey2, perm2, pair_start, {}, P, f32, (perm, onehot))
        c3v_plain = lambda: kernels.reduce_partitions_plain(  # noqa: E731
            skey2, perm2, pair_start, {}, P, f32, (perm, onehot))
        vsum = same_twice("reduce_partitions vector", c3v)["vsum"]
        # Integer-valued coordinates below 2^24: exact in any order.
        err3 = check_equal("reduce_partitions vsum", vsum,
                           c3v_plain()["vsum"])
        err9 = 0.0
        vstd = 460.0
        c9 = {}
        for norm in ("l1", "l2", "linf"):
            args = dict(max_norm=1000.0, norm_kind=norm, std=vstd,
                        key=np.array([3, 4], np.uint32), gaussian=True)
            f_k = torch.zeros(1, dtype=torch.int32, device=dev)
            f_p = torch.zeros(1, dtype=torch.int32, device=dev)
            got = kernels.vector_release(vsum, keep, f_k, **args)
            want = kernels.vector_release_plain(vsum, keep, f_p, **args)
            # float32 noise words (log1p, erf_inv) a few ulp apart: 1e-5
            # of the value plus the noise scale.
            tol = 1e-5 * (want.abs() + vstd)
            err = float((got - want).abs().max())
            if bool(((got - want).abs() > tol).any()):
                raise AssertionError(f"vector_release {norm}: max diff {err}")
            err9 = max(err9, err, check_equal(f"vector_release {norm} flags",
                                              f_k, f_p))
            c9[norm] = (lambda a=args: kernels.vector_release(
                vsum, keep, torch.zeros(1, dtype=torch.int32, device=dev),
                **a), lambda a=args: kernels.vector_release_plain(
                vsum, keep, torch.zeros(1, dtype=torch.int32, device=dev),
                **a))
        torch.cuda.synchronize()
        errors = {"quantile_counts": err7, "quantile_child_counts": err7,
                  "quantile_descend": err8, "vector_release": err9,
                  "reduce_partitions vector": err3}
        print(f"kernels[{label}, n={n_rows}]: C7 (a)-(c), C8 dense "
              f"(P={Py}) and lazy (P={P}), C9 (l1, l2, linf) and C3's "
              f"vector entry agree with their plain versions, max abs err " +
              json.dumps(errors), flush=True)
        if label != "full":
            continue
        n = n_rows
        fsz = 4
        # C7 (a): every row's skey2 read once, and the perm, row_perm and
        # value of the rows the bounding kept (the only rows counted); the
        # histogram written once; ~20 operations a kept row.
        kept = yskey2 < Py
        ykept = int(kept.sum())
        mkept = int((skey2 < P).sum())
        print(f"bounded rows kept of {n}: {ykept} by release year (l0 = 16, "
              f"linf = 4), {mkept} by movie (l0 = 64, linf = 1); the bounds "
              f"of C7 and C3's vector entry count these", flush=True)
        leaf = kernels.leaf_indices(kernels.sorted_rows(yperm2, yperm, yvals),
                                    lo, hi, L)
        hist_keys = (yskey2.long() * L + leaf)[kept]
        lib7 = lambda: torch.bincount(hist_keys, minlength=Py * L)  # noqa: E731
        b7 = bound(n * 4 + ykept * (8 + 8 + fsz) + Py * L * 4, ykept * 20)

        level_keys_lazy = [threefry.fold_in(qkey, level)
                           for level in range(1, h + 1)]

        def lazy_descent(fn):
            st = kernels.DescentState(P, n_q, f32, dev)
            fl = torch.zeros(1, dtype=torch.int32, device=dev)
            for level, counts in enumerate(counts_by_level, 1):
                out = fn(counts, st, QUANTILES, level=level,
                         level_key=level_keys_lazy[level - 1], flags=fl,
                         **step_args)
            return out

        # C8 lazy: per visited node two fold_ins and a draw (three
        # threefry, ~100 operations each) and an erf_inv (~50); counts
        # and state read and written once a level.
        visits = P * n_q * B * h
        b8 = bound(visits * 4 + h * P * n_q * 2 * (4 + 3 * fsz) +
                   P * n_q * fsz, visits * 350)
        b9 = bound(P * 5 * fsz * 2 + P, P * 5 * 150)

        def child_levels(fn, leaf):
            # The descent's h child-count passes at their nodes.
            for level, node in enumerate(nodes_by_level, 1):
                fn(skey2, perm2, perm, values, node, level=level, leaf=leaf,
                   **tree)

        # C7 (c), a launch on average over the h levels: level 1 reads
        # every row's skey2 and the kept rows' perm, row_perm and value
        # and writes the leaf buffer; levels 2..h read skey2 and the
        # buffer; each level reads the nodes and writes its counts.
        b7c = bound((n * 4 + mkept * (8 + 8 + fsz) + n * 4 +
                     (h - 1) * n * 8 + h * P * n_q * (4 + B * 4)) / h,
                    mkept * (20 + 2 * n_q))
        timing = {
            "quantile_counts": (c7a, c7a_plain, lib7, b7,
                                "quantile_counts.cu",
                                "pipelinedp_tpu/executor.py:825"),
            "quantile_child_counts": (
                lambda: child_levels(kernels.quantile_child_counts, leaf_k),
                lambda: child_levels(kernels.quantile_child_counts_plain,
                                     leaf_p), None, b7c,
                "quantile_counts.cu", "pipelinedp_tpu/executor.py:796"),
            "quantile_descend": (lambda: lazy_descent(
                kernels.quantile_descend_step),
                lambda: lazy_descent(kernels.quantile_descend_step_plain),
                None, b8, "quantile_descend.cu",
                "pipelinedp_tpu/executor.py:652"),
            "vector_release": (c9["l2"][0], c9["l2"][1], None, b9,
                               "vector_release.cu",
                               "pipelinedp_tpu/executor.py:537"),
        }
        for name, (fn, plain, lib, (b_ms, b_by), src, repl) in \
                timing.items():
            ms = cuda_ms(fn, repeats=10)
            plain_ms = cuda_ms(plain, repeats=3, warmup=1)
            if name == "quantile_child_counts":  # h launches a call
                ms, plain_ms = ms / h, plain_ms / h
            lib_ms = cuda_ms(lib, repeats=10) if lib else None
            print(f"kernel {name}: max_abs_err={errors[name]} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) "
                  f"library_ms={lib_ms}", flush=True)
            report.append({
                "name": name, "route": "cuda",
                "source": f"pipelinedp_tpu_torch/csrc/{src}",
                "replaces": repl, "launches": 0,
                "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        # The other entries of C7, C8 and C3 on the path.
        b_ms, b_by = bound(sum(t.numel() for t in levels) * 4, Py * L)

        def library_c7b():
            # One reshape(P, -1, B).sum(-1) a level, as the JAX package
            # rolls the levels up.
            x, out = hist, []
            for _ in range(h - 1):
                x = x.reshape(Py, -1, B).sum(-1, dtype=torch.int32)
                out.append(x)
            return out

        print(f"kernel quantile_counts[level roll-ups, P={Py}]: ms="
              f"{cuda_ms(c7b, 10):.4f} plain_ms="
              f"{cuda_ms(c7b_plain, 3, 1):.4f} bound_ms={b_ms:.3g} ({b_by}) "
              f"library_ms (reshape(P, -1, B).sum(-1) a level)="
              f"{cuda_ms(library_c7b, 10):.4f}", flush=True)
        # Each level of the child counts: the gather without a buffer,
        # level 1 filling the buffer, levels 2..h reading it.
        node = torch.zeros(P, n_q, dtype=torch.int32, device=dev)
        b_ms, b_by = bound(n * 4 + mkept * (8 + 8 + fsz) +
                           P * n_q * (4 + B * 4), mkept * (20 + 2 * n_q))
        print(f"kernel quantile_counts[child counts, one level, gathered, "
              f"P={P}]: ms="
              f"{cuda_ms(lambda: kernels.quantile_child_counts(skey2, perm2, perm, values, node, level=1, **tree), 10):.4f}"
              f" plain_ms="
              f"{cuda_ms(lambda: kernels.quantile_child_counts_plain(skey2, perm2, perm, values, node, level=1, **tree), 3, 1):.4f}"
              f" bound_ms={b_ms:.3g} ({b_by})", flush=True)
        for level, lnode in enumerate(nodes_by_level, 1):
            lb_ms, lb_by = bound(
                n * 4 + (mkept * (8 + 8 + fsz) + n * 4 if level == 1 else
                         n * 4) + P * n_q * (4 + B * 4),
                mkept * (20 + 2 * n_q))
            lfn = lambda: kernels.quantile_child_counts(  # noqa: E731
                skey2, perm2, perm, values, lnode, level=level, leaf=leaf_k,
                **tree)
            print(f"kernel quantile_child_counts[level {level}, "
                  f"{'fills' if level == 1 else 'reads'} the leaf buffer, "
                  f"P={P}]: ms={cuda_ms(lfn, 10):.4f} device_ms="
                  f"{device_ms(torch, lfn, 20):.4f} (memset + kernel) "
                  f"bound_ms={lb_ms:.3g} ({lb_by})", flush=True)
        b_ms, b_by = bound(Py * n_q * (h * B * 4 + fsz), Py * n_q * B * h * 150)
        print(f"kernel quantile_descend[dense, P={Py}]: ms="
              f"{cuda_ms(lambda: c8_dense(), 10):.4f} plain_ms="
              f"{cuda_ms(lambda: c8_dense(plain=True), 3, 1):.4f} bound_ms="
              f"{b_ms:.3g} ({b_by})", flush=True)
        for norm in ("l1", "linf"):
            print(f"kernel vector_release[{norm}]: ms="
                  f"{cuda_ms(c9[norm][0], 10):.4f} plain_ms="
                  f"{cuda_ms(c9[norm][1], 3, 1):.4f}", flush=True)
        src = onehot[perm][perm2]
        key_long = skey2.long()

        def library_c3v():
            out = torch.zeros(P + 1, 5, device=dev)
            return out.index_add_(0, key_long, src)

        b_ms, b_by = bound(n * 4 + mkept * (8 + 1 + 8 + 5 * fsz) +
                           P * (2 + 5) * fsz, mkept * 13)
        print(f"kernel reduce_partitions[count, pid_count + vector D=5]: ms="
              f"{cuda_ms(c3v, 10):.4f} plain_ms={cuda_ms(c3v_plain, 3, 1):.4f}"
              f" bound_ms={b_ms:.3g} ({b_by}) library_ms (index_add_ of the "
              f"gathered rows)={cuda_ms(library_c3v, 10):.4f}", flush=True)
    return report


def quantile_vector_parity_phase(torch, tdp, rng):
    """PERCENTILE in the dense and the lazy regime and VECTOR_SUM on the
    card (float64) against the plain versions on the CPU: the same
    partitions, values within 1e-9 relative. The last case asks for 49
    percentiles (52 output columns), more than one C6 scatter takes."""
    n = 4096
    users = rng.integers(0, 300, n)
    ratings = rng.integers(1, 6, n).astype(np.float64)
    eight = rng.integers(0, 8, n)
    cases = (
        ("PERCENTILE dense", eight, ratings,
         lambda M: [M.PERCENTILE(10), M.PERCENTILE(50), M.PERCENTILE(90),
                    M.COUNT], dict(min_value=1.0, max_value=5.0), "GAUSSIAN",
         False),
        ("PERCENTILE lazy", rng.integers(0, 600, n), ratings,
         lambda M: [M.PERCENTILE(50), M.COUNT],
         dict(min_value=1.0, max_value=5.0), "LAPLACE", True),
        ("VECTOR_SUM", rng.integers(0, 8, n),
         np.eye(5)[ratings.astype(np.int64) - 1],
         lambda M: [M.VECTOR_SUM, M.COUNT],
         dict(vector_size=5, vector_max_norm=40.0,
              vector_norm_kind=tdp.NormKind.L2), "GAUSSIAN", False),
        ("PERCENTILE x49 + COUNT, SUM, PRIVACY_ID_COUNT", eight, ratings,
         lambda M: [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT] +
         [M.PERCENTILE(p) for p in range(2, 100, 2)],
         dict(min_value=1.0, max_value=5.0), "LAPLACE", False),
    )
    for label, parts, values, metrics, bounds, noise, public in cases:
        rows = list(zip(users.tolist(), parts.tolist(), list(values)))
        results = []
        for device in ("cuda", "cpu"):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=2.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(
                device=device, noise_seed=5, dtype=torch.float64))
            params = tdp.AggregateParams(
                metrics=metrics(tdp.Metrics),
                noise_kind=getattr(tdp.NoiseKind, noise),
                max_partitions_contributed=4,
                max_contributions_per_partition=2, **bounds)
            ex = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                    partition_extractor=lambda r: r[1],
                                    value_extractor=lambda r: r[2])
            res = engine.aggregate(rows, params, ex,
                                   sorted(set(parts.tolist()))
                                   if public else None)
            acc.compute_budgets()
            results.append(dict(res))
        gpu, cpu = results
        if set(gpu) != set(cpu) or not gpu:
            raise AssertionError(f"parity {label}: released partitions "
                                 f"differ ({len(gpu)} vs {len(cpu)})")
        worst = 0.0
        for k in cpu:
            for a, b in zip(gpu[k], cpu[k]):
                err = np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))
                worst = max(worst, float(np.max(err)))
        if worst > 1e-9:
            raise AssertionError(f"parity {label}: rel err {worst}")
        print(f"parity[{label}, {noise}, "
              f"{'public' if public else 'private'}]: {len(gpu)} partitions,"
              f" cuda float64 vs cpu float64 max rel err {worst:.3g}",
              flush=True)


def quantile_vector_main_phase(torch, dev, tdp, encoded, years, onehot,
                               kernels, executor, card):
    """Runs (f)-(j) through DPEngine.aggregate. Returns the launch counts
    summed over its runs."""
    total = dict.fromkeys(kernels.KERNELS, 0)
    pair_key = encoded.pid.astype(np.int64) * N_MOVIES + encoded.pk
    l0_true = int(np.bincount(np.unique(pair_key) // N_MOVIES).max())

    def aggregate(label, enc, metrics, noise, public, eps, seed, path, want,
                  **params):
        acc = tdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=seed))
        params = tdp.AggregateParams(metrics=metrics(tdp.Metrics),
                                     noise_kind=getattr(tdp.NoiseKind, noise),
                                     **params)
        kernels.reset_launch_counts()
        res = engine.aggregate(enc, params, tdp.DataExtractors(),
                               list(enc.partition_vocab) if public else None)
        acc.compute_budgets()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = dict(res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = dict(kernels.launch_counts)
        check_launches(f"run ({label})", counts, kernels, want, path)
        for name, n in counts.items():
            total[name] += n
        bad = [k for k, v in out.items()
               if not np.all(np.isfinite(np.hstack([np.ravel(x) for x in v])))]
        if bad or not out:
            raise AssertionError(f"run ({label}): {len(out)} partitions, "
                                 f"{len(bad)} with non-finite values")
        return out, seconds, counts

    percentiles = lambda M: [M.PERCENTILE(10), M.PERCENTILE(50),  # noqa: E731
                             M.PERCENTILE(90), M.COUNT]
    per_movie = dict(max_partitions_contributed=64,
                     max_contributions_per_partition=1)
    ratings = dict(min_value=1.0, max_value=5.0)
    vector = dict(vector_size=5, vector_norm_kind=tdp.NormKind.L2)
    # Lazy: C7's child counts and C8's step once a level (4 each); dense:
    # C7's histogram and roll-ups (2), one C8 launch.
    lazy = dict(row_keys=1, bound_rows=1, radix_sort=2,
                quantile_child_counts=4, quantile_descend=4,
                quantile_counts=0)
    dense = dict(row_keys=1, bound_rows=1, radix_sort=2, quantile_counts=2,
                 quantile_descend=1)
    vec = dict(row_keys=1, bound_rows=1, radix_sort=2, reduce_partitions=1,
               vector_release=1)
    runs = {
        "f": (encoded, percentiles, "GAUSSIAN", True, LAZY_PERCENTILE_PATH,
              lazy, dict(per_movie, **ratings)),
        "h": (years, lambda M: [M.PERCENTILE(50), M.COUNT], "LAPLACE", False,
              PERCENTILE_PATH, dense,
              dict(max_partitions_contributed=16,
                   max_contributions_per_partition=4, **ratings)),
        "i": (onehot, lambda M: [M.VECTOR_SUM, M.COUNT], "GAUSSIAN", True,
              VECTOR_PATH, vec,
              dict(per_movie, vector_max_norm=1000.0, **vector)),
    }
    for label, (enc, metrics, noise, public, path, want, params) in \
            runs.items():
        times = []
        for rep in range(3):
            out, seconds, counts = aggregate(label, enc, metrics, noise,
                                             public, 1.0, rep, path, want,
                                             **params)
            times.append(seconds)
        ms = statistics.median(times) * 1e3
        print(f"main ({label}) {noise} {'public' if public else 'private'} "
              f"P={enc.n_partitions}: {len(out)} partitions released, "
              f"{ms:.1f} ms, {N_ROWS / (ms / 1e3):.4g} rows/s (median of 3: "
              f"{[round(t * 1e3, 1) for t in times]} ms; {card}); launches "
              f"per aggregate {counts}", flush=True)
        if label == "f":
            lo_ok = all(1.0 <= getattr(v, f"percentile_{round(q * 100)}")
                        <= 5.0 for v in out.values() for q in QUANTILES)
            if not lo_ok or len(out) != N_MOVIES:
                raise AssertionError("run (f): percentiles outside [1, 5]")
        if label == "h" and not 0 < len(out) <= len(years.partition_vocab):
            raise AssertionError(f"run (h): {len(out)} years released")
        if label == "i":
            clipped = clipped_partitions(torch, dev, executor, enc, params,
                                         rep)
            print(f"main (i): {clipped} of {enc.n_partitions} partitions' "
                  f"bounded vector sums lie outside the L2 ball of 1000 and "
                  f"were clipped", flush=True)
            if not 0 < clipped < enc.n_partitions:
                raise AssertionError(f"run (i): {clipped} partitions clipped")

    # (g) order statistics at epsilon = 1e6 with the true maxima.
    out, seconds, _ = aggregate("g", encoded, percentiles, "GAUSSIAN", True,
                                1e6, 9, LAZY_PERCENTILE_PATH, lazy,
                                max_partitions_contributed=l0_true,
                                max_contributions_per_partition=1, **ratings)
    # The nodes' noise is not negligible even at epsilon = 1e6: a level
    # gets 1e6 / 2 / 4 of it with an L2 sensitivity of sqrt(7135), and the
    # analytic Gaussian sigma is then ~0.17 a node. A descent sums up to B
    # noisy siblings a level, and the zero-count siblings, clamped at 0,
    # add about 0.4 sigma each: so the released rank may move by k = 16
    # sigma sqrt(B h) + 0.4 sigma B h ranks. The bound is the order
    # statistics at ranks floor(q n) - 1 - k and ceil(q n) + k, widened by
    # one leaf; how many percentiles needed k > 0 is printed.
    from pipelinedp_tpu_torch.aggregate_params import NoiseKind
    from pipelinedp_tpu_torch.ops import quantile_tree
    h, B = quantile_tree.DEFAULT_TREE_HEIGHT, \
        quantile_tree.DEFAULT_BRANCHING_FACTOR
    sigma = quantile_tree.per_level_noise_std(1e6 / 2, 1e-6 / 2, l0_true, 1,
                                              h, NoiseKind.GAUSSIAN)
    k = int(math.ceil(16 * sigma * math.sqrt(B * h) + 0.4 * sigma * B * h))
    order = np.lexsort((encoded.values, encoded.pk))
    sorted_vals = encoded.values[order]
    sizes = np.bincount(encoded.pk, minlength=N_MOVIES)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    width = 4.0 / 16**4
    vocab = list(encoded.partition_vocab)
    beyond = 0
    for q in QUANTILES:
        got = np.array([getattr(out[m], f"percentile_{round(q * 100)}")
                        for m in vocab])
        for slack in (0, k):
            lo_rank = np.clip(np.floor(q * sizes).astype(np.int64) - 1 -
                              slack, 0, sizes - 1)
            hi_rank = np.clip(np.ceil(q * sizes).astype(np.int64) + slack, 0,
                              sizes - 1)
            lo_v = sorted_vals[starts + lo_rank] - width
            hi_v = sorted_vals[starts + hi_rank] + width
            bad = (got < lo_v) | (got > hi_v)
            if slack == 0:
                beyond += int(bad.sum())
        if bad.any():
            i = int(np.argmax(bad))
            raise AssertionError(f"run (g) q={q}: movie {vocab[i]} "
                                 f"{got[i]} outside [{lo_v[i]}, {hi_v[i]}]")
    print(f"main (g) epsilon=1e6, l0={l0_true}, linf=1: {len(out)} "
          f"partitions' percentiles 10/50/90 lie between their order "
          f"statistics at ranks floor(q n) - 1 - k and ceil(q n) + k, k = "
          f"{k} (node noise std {sigma:.4g}), widened by one leaf "
          f"({width:.3g}); {beyond} of {3 * len(out)} needed k > 0, in "
          f"{seconds * 1e3:.1f} ms", flush=True)

    # (j) exact rating histograms at epsilon = 1e6, no clipping.
    out, seconds, _ = aggregate("j", onehot, lambda M: [M.VECTOR_SUM,
                                                        M.COUNT],
                                "GAUSSIAN", True, 1e6, 11, VECTOR_PATH, vec,
                                max_partitions_contributed=l0_true,
                                max_contributions_per_partition=1,
                                vector_max_norm=1e9, **vector)
    truth = np.bincount(
        encoded.pk.astype(np.int64) * 5 + encoded.values.astype(np.int64) - 1,
        minlength=N_MOVIES * 5).reshape(N_MOVIES, 5).astype(np.float64)
    got = np.stack([out[m].vector_sum for m in vocab])
    from pipelinedp_tpu_torch import dp_computations
    sigma = dp_computations.gaussian_sigma(1e6 / 2 / 5, 1e-6 / 2 / 5,
                                           math.sqrt(l0_true))
    # 16 noise stds plus float32 rounding (the sums are exact integers).
    tol = 16 * sigma + 1e-6 * np.abs(truth)
    err = np.abs(got - truth)
    if (err > tol).any():
        i = np.unravel_index(int(np.argmax(err - tol)), err.shape)
        raise AssertionError(f"run (j): movie {vocab[i[0]]} coordinate "
                             f"{i[1]}: {got[i]} vs numpy {truth[i]}")
    print(f"main (j) epsilon=1e6, l0={l0_true}: {len(out)} rating "
          f"histograms match the numpy group-by per coordinate (max abs err "
          f"{float(err.max()):.4g}, noise std {sigma:.4g}) in "
          f"{seconds * 1e3:.1f} ms", flush=True)
    return total


def clipped_partitions(torch, dev, executor, enc, params, seed):
    """How many of run (i)'s partitions (the release with noise_seed=seed)
    had bounded vector sums outside the norm ball: the executor's bounding
    and reduction with the release's own keys."""
    import pipelinedp_tpu_torch as tdp
    from pipelinedp_tpu_torch import combiners
    from pipelinedp_tpu_torch.ops import noise as noise_ops
    from pipelinedp_tpu_torch.ops import threefry
    aparams = tdp.AggregateParams(metrics=[tdp.Metrics.VECTOR_SUM,
                                           tdp.Metrics.COUNT], **params)
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    compound = combiners.create_compound_combiner(aparams, acc)
    acc.compute_budgets()
    cfg = executor.make_kernel_config(aparams, compound, enc.n_partitions,
                                      False, None)
    pid, pk, values, valid = executor.to_device(enc, dev, torch.float32)
    rows_key, _ = threefry.split(noise_ops.make_noise_key(seed), 2)
    key2, pair_start, cols, rows = executor.bounded_row_columns(
        pid, pk, values, valid, *executor.kernel_scalars(aparams), rows_key,
        cfg)
    dense, _ = executor.reduce_rows_to_partitions(
        key2, pair_start, cols, cfg.n_partitions, torch.float32, rows)
    norms = torch.linalg.vector_norm(dense["vsum"].double(), dim=1)
    return int((norms > cfg.vector_max_norm).sum())


def kernel_stage_phase(torch, tdp, encoded, onehot, kernels, executor, card):
    """Runs (a), (f), (i) and (l) through DPEngine.aggregate with CUDA events
    around every kernel wrapper the executor calls: device time by kernel,
    beside the host-to-device copy and the host's share (setup and decode).
    radix_sort[1] is the bounding sort, radix_sort[2] the partition sort."""
    names = ("row_keys", "radix_sort", "bound_rows", "reduce_partitions",
             "release_epilogue", "vector_release", "quantile_leaf_counts",
             "quantile_level_counts", "quantile_child_counts",
             "quantile_descend_dense", "quantile_descend_step",
             "compact_kept")
    runs = {
        "a": (encoded, lambda M: [M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
              dict(min_value=1.0, max_value=5.0), {}),
        "f": (encoded, lambda M: [M.PERCENTILE(10), M.PERCENTILE(50),
                                  M.PERCENTILE(90), M.COUNT],
              dict(min_value=1.0, max_value=5.0), {}),
        "i": (onehot, lambda M: [M.VECTOR_SUM, M.COUNT],
              dict(vector_size=5, vector_norm_kind=tdp.NormKind.L2,
                   vector_max_norm=1000.0), {}),
        "l": (encoded, lambda M: [M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
              dict(min_value=1.0, max_value=5.0), dict(secure_noise=True)),
    }
    for label, (enc, metrics, bounds, mode) in runs.items():
        medians = {}
        for rep in range(4):
            records = []
            originals = {n: getattr(kernels, n) for n in names}

            sorts = []

            def timed(name, fn):
                def call(*args, **kwargs):
                    label = name
                    if name == "radix_sort":
                        sorts.append(None)
                        label = f"radix_sort[{len(sorts)}]"
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
                    records.append((label, start, end))
                    return out
                return call

            to_device = executor.padded_to_device
            for n in names:
                setattr(kernels, n, timed(n, originals[n]))
            executor.padded_to_device = timed("h2d", to_device)
            try:
                acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0,
                                                total_delta=1e-6)
                engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=rep,
                                                            **mode))
                res = engine.aggregate(
                    enc, tdp.AggregateParams(
                        metrics=metrics(tdp.Metrics),
                        noise_kind=tdp.NoiseKind.GAUSSIAN,
                        max_partitions_contributed=64,
                        max_contributions_per_partition=1, **bounds),
                    tdp.DataExtractors(), list(enc.partition_vocab))
                acc.compute_budgets()
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = list(res)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - start) * 1e3
            finally:
                for n in names:
                    setattr(kernels, n, originals[n])
                executor.padded_to_device = to_device
            if len(out) != enc.n_partitions:
                raise AssertionError(f"stages ({label}): {len(out)} "
                                     f"partitions decoded")
            stage = {}
            for name, s, e in records:
                stage[name] = stage.get(name, 0.0) + s.elapsed_time(e)
            stage["wall"] = wall
            for name, ms in stage.items():
                medians.setdefault(name, []).append(ms)
        # The first of the four runs warms the allocator.
        med = {name: round(statistics.median(t[1:]), 4)
               for name, t in medians.items()}
        device = sum(v for k, v in med.items() if k not in ("wall", "h2d"))
        print(f"stages ({label}) float32, ms by kernel wrapper, median of 3 "
              f"({card}): {json.dumps(med)}; kernels {device:.3f} ms, h2d "
              f"{med['h2d']:.3f} ms, the rest of the wall time (host setup "
              f"and decode) {med['wall'] - device - med['h2d']:.3f} ms",
              flush=True)


def parity_phase(torch, tdp, rng):
    """A small aggregation on the card (float64) against the plain versions
    on the CPU: same partitions, values within 1e-9 relative."""
    n = 4096
    users = rng.integers(0, 300, n)
    movies = (rng.integers(0, 40, n)**2) // 40
    ratings = rng.integers(1, 6, n).astype(np.float64)
    rows = list(zip(users.tolist(), movies.tolist(), ratings.tolist()))
    for metrics, noise, public in (
            (("COUNT", "SUM", "MEAN", "VARIANCE"), "GAUSSIAN", True),
            (("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE", False)):
        results = []
        for device in ("cuda", "cpu"):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=2.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(
                device=device, noise_seed=5, dtype=torch.float64))
            params = tdp.AggregateParams(
                metrics=[getattr(tdp.Metrics, m) for m in metrics],
                noise_kind=getattr(tdp.NoiseKind, noise),
                max_partitions_contributed=4,
                max_contributions_per_partition=2, min_value=1.0,
                max_value=5.0)
            ex = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                    partition_extractor=lambda r: r[1],
                                    value_extractor=lambda r: r[2])
            res = engine.aggregate(rows, params, ex,
                                   sorted(set(movies.tolist()))
                                   if public else None)
            acc.compute_budgets()
            results.append(dict(res))
        gpu, cpu = results
        if set(gpu) != set(cpu) or not gpu:
            raise AssertionError(f"parity {metrics}: released partitions "
                                 f"differ ({len(gpu)} vs {len(cpu)})")
        worst = 0.0
        for k in cpu:
            for a, b in zip(gpu[k], cpu[k]):
                worst = max(worst, abs(a - b) / max(1.0, abs(b)))
        if worst > 1e-9:
            raise AssertionError(f"parity {metrics}: rel err {worst}")
        print(f"parity[{'+'.join(metrics)}, {noise}, "
              f"{'public' if public else 'private'}]: {len(gpu)} partitions, "
              f"cuda float64 vs cpu float64 max rel err {worst:.3g}",
              flush=True)


def select_parity_phase(torch, tdp, rng):
    """A small selection on the card (float64) against the plain versions
    on the CPU: the identical list of kept partitions."""
    n = 4096
    users = rng.integers(0, 600, n)
    movies = (rng.integers(0, 60, n)**2) // 60
    rows = list(zip(users.tolist(), movies.tolist()))
    for strategy in ("TRUNCATED_GEOMETRIC", "LAPLACE_THRESHOLDING",
                     "GAUSSIAN_THRESHOLDING"):
        kept = []
        for device in ("cuda", "cpu"):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(
                device=device, noise_seed=5, dtype=torch.float64))
            params = tdp.SelectPartitionsParams(
                max_partitions_contributed=3,
                partition_selection_strategy=getattr(
                    tdp.PartitionSelectionStrategy, strategy))
            ex = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                    partition_extractor=lambda r: r[1])
            res = engine.select_partitions(rows, params, ex)
            acc.compute_budgets()
            kept.append(list(res))
        gpu, cpu = kept
        if gpu != cpu or not gpu or len(gpu) == len(set(movies.tolist())):
            raise AssertionError(f"select parity {strategy}: cuda kept "
                                 f"{len(gpu)}, cpu kept {len(cpu)}")
        print(f"parity[select_partitions, {strategy}]: {len(gpu)} of "
              f"{len(set(movies.tolist()))} partitions kept, cuda float64 "
              f"list identical to cpu float64", flush=True)


def table_stats(thr_row, gran):
    """The atoms' pmf of one packed secure table (host numpy) and the noise
    std it gives on its grid."""
    thr = thr_row.cpu().numpy().view(np.uint64)
    cdf = np.concatenate([[0.0], thr.astype(np.float64) * 2.0**-64])
    pmf = np.diff(cdf)
    k = (thr.size - 1) // 2
    atoms = np.arange(-k, k + 1, dtype=np.float64)
    return pmf, float(gran) * math.sqrt(float((pmf * atoms**2).sum()))


def secure_safe_kernel_phase(torch, dev, encoded, years, kernels, executor,
                             threefry):
    """The compensated entry of C3 and the secure entries of C4, C8 and C9
    against their plain versions on the card, at 4096 rows and at 2^24
    rows; a chi-square test of the secure draws against the table."""
    from scipy import stats
    from pipelinedp_tpu_torch.aggregate_params import NoiseKind
    from pipelinedp_tpu_torch.ops import quantile_tree
    f32 = torch.float32
    key = np.array([7, 11], dtype=np.uint32)
    rows_key, final_key = threefry.split(key, 2)
    _, key_linf, key_l0 = threefry.split(rows_key, 3)
    salts = threefry.bits(key_l0, 4)
    qkey = threefry.fold_in(key, 7919)
    h, B = quantile_tree.DEFAULT_TREE_HEIGHT, \
        quantile_tree.DEFAULT_BRANCHING_FACTOR
    n_q = len(QUANTILES)
    cols = ("sum", "nsum", "nsum2")
    report = []
    # Each entry's largest |kernel - plain| over every comparison it makes.
    errs = dict.fromkeys(("reduce_partitions_compensated",
                          "release_epilogue_secure", "quantile_descend_secure",
                          "vector_release_secure"), 0.0)

    def record(name, err):
        errs[name] = max(errs[name], err)

    def bounded(enc, n_rows, l0, linf, scale, columns):
        sl = slice(0, n_rows)
        pid = torch.as_tensor(enc.pid[sl]).to(dev)
        pk = torch.as_tensor(enc.pk[sl]).to(dev)
        values = torch.as_tensor(enc.values[sl] * scale).to(dev, f32)
        valid = torch.as_tensor(enc.valid[sl]).to(dev)
        P = enc.n_partitions
        k1, k2, u = kernels.row_keys(pid, pk, valid, salts, key_linf, P, f32)
        perm, sk1 = kernels.radix_sort([k1, k2, u], sorted_top=True)
        key2, pair_start, row_cols = kernels.bound_rows(
            perm, k1, k2, pk, values if columns else None, valid,
            n_partitions=P, linf=linf, l0=l0, clip_per_value=True,
            clip_pair_sum=False, scalars=(1000.0, 5000.0, 0.0, 0.0, 3000.0),
            columns=columns, sorted_k1=sk1)
        perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
        return P, values, perm, perm2, skey2, pair_start, row_cols

    def exact_sums(skey2, perm2, col, P):
        """int64 partition sums of an integer-valued column."""
        out = torch.zeros(P + 1, dtype=torch.int64, device=dev)
        out.index_add_(0, skey2.long().clamp(0, P), col[perm2].to(torch.int64))
        return out[:P]

    for label, n_rows in (("small", 4096), ("full", encoded.n_rows)):
        # --- C3 compensated: rating x 1000, three columns and the vector --
        P, values, perm, perm2, skey2, pair_start, row_cols = bounded(
            encoded, n_rows, 64, 1, 1000.0, cols)
        c3c = lambda: kernels.reduce_partitions(  # noqa: E731
            skey2, perm2, pair_start, row_cols, P, f32, compensated=True)
        c3c_plain = lambda: kernels.reduce_partitions_plain(  # noqa: E731
            skey2, perm2, pair_start, row_cols, P, f32, compensated=True)
        comp, comp_p = same_twice("reduce_partitions_compensated",
                                  c3c), c3c_plain()
        fast = kernels.reduce_partitions(skey2, perm2, pair_start, row_cols,
                                         P, f32)
        fast_err, top, plain_off, nsum2_err = {}, 0, 0, 0.0
        for c in cols:
            exact = exact_sums(skey2, perm2, row_cols[c], P)
            top = max(top, int(exact.abs().max()))
            check_equal(f"reduce_partitions compensated {c} vs float32("
                        f"exact sum)", comp[c], exact.to(f32))
            if c == "nsum2":
                # The plain version differences prefixes of the whole
                # column (the JAX package's scheme): past ~2^45 its low
                # word nears 2^24 and may round. The kernel is held to the
                # exact sum above; its distance from the plain version is
                # measured into max_abs_err.
                plain_off = int((comp_p[c] != comp[c]).sum())
                nsum2_err = abs_diff(comp[c], comp_p[c])
                record("reduce_partitions_compensated", nsum2_err)
            else:
                record("reduce_partitions_compensated", check_equal(
                    f"reduce_partitions compensated {c}", comp[c], comp_p[c]))
            fast_err[c] = float((fast[c].double() - exact.double()).abs()
                                .max())
        onehot = (torch.nn.functional.one_hot(
            (values / 1000.0).long() - 1, 5) * 1000).to(f32).contiguous()
        vargs = (skey2, perm2, pair_start, {}, P, f32, (perm, onehot))
        vcomp = same_twice(
            "reduce_partitions_compensated vector",
            lambda: kernels.reduce_partitions(*vargs, compensated=True))["vsum"]
        record("reduce_partitions_compensated", check_equal(
            "reduce_partitions compensated vsum", vcomp,
            kernels.reduce_partitions_plain(*vargs, compensated=True)["vsum"]))
        vexact = torch.zeros(P + 1, 5, dtype=torch.int64, device=dev)
        vexact.index_add_(0, skey2.long().clamp(0, P),
                          onehot[perm][perm2].to(torch.int64))
        check_equal("reduce_partitions compensated vsum vs float32(exact)",
                    vcomp, vexact[:P].to(f32))
        fast_err["vsum"] = float((kernels.reduce_partitions(*vargs)["vsum"]
                                  .double() - vexact[:P].double()).abs()
                                 .max())
        # An overflowing run is Inf (not the NaN of its residues), and the
        # runs after it keep their sums: each run is summed directly.
        ov = kernels.reduce_partitions(
            torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32, device=dev),
            torch.arange(6, device=dev), torch.ones(6, dtype=torch.bool,
                                                    device=dev),
            {"sum": torch.tensor([1.0, 2.0, 3e38, 3e38, 4.0, 5.0],
                                 device=dev)}, 3,
            f32, compensated=True)["sum"].tolist()
        if ov != [3.0, float("inf"), 9.0]:
            raise AssertionError(f"reduce_partitions compensated overflow: "
                                 f"{ov}")
        print(f"kernels[{label}, n={n_rows}] C3 compensated: every partition "
              f"sum of rating x 1000 (sum, nsum, nsum2, vector D=5; largest "
              f"|sum| {top}) equals float32(exact int64 sum) and the plain "
              f"version (nsum2: {plain_off} of {P} partitions where the "
              f"plain version's prefix differences are not exact, largest "
              f"difference {nsum2_err}); an "
              f"overflowing run is Inf, the next one's sum intact. The fast "
              f"entry on the same rows: "
              f"largest abs error {json.dumps(fast_err)}", flush=True)
        # --- C4 secure at P = 17,770, one slot and three ------------------
        dense = kernels.reduce_partitions(skey2, perm2, pair_start,
                                          row_cols, P, f32)
        dense["row_count"] = dense["pid_count"]
        key_sel, key_noise = threefry.split(final_key, 2)
        c4 = {}
        for n_slots, plan, stds, sens in (
                (1, [("count", ("count",), 0)], [2.0], [1.0]),
                (3, [("variance", ("variance", "count", "sum", "mean"), 0)],
                 [2.0, 900.0, 4.5e6], [1.0, 2000.0, 4e6])):
            stds = np.array(stds)
            tables = executor.build_secure_tables(
                stds, np.array(sens), NoiseKind.GAUSSIAN, None, dev)
            slot = np.stack([threefry.fold_in(threefry.fold_in(key_noise, 0),
                                              j) for j in range(n_slots)])
            args = (dense, plan, stds, slot, NoiseKind.GAUSSIAN, False,
                    3000.0, 1000.0, None, key_sel, 1)
            keep, outs, flags = kernels.release_epilogue(*args,
                                                         tables=tables)
            q_keep, q_outs, q_flags = kernels.release_epilogue_plain(
                *args, tables=tables)
            check_equal(f"release_epilogue secure ({n_slots} slots) flags",
                        flags, q_flags)
            check_equal(f"release_epilogue secure ({n_slots} slots) keep",
                        keep, q_keep)
            for name in outs:
                record("release_epilogue_secure", check_equal(
                    f"release_epilogue secure ({n_slots} slots) {name}",
                    outs[name], q_outs[name]))
            c4[n_slots] = (
                lambda a=args, t=tables: kernels.release_epilogue(
                    *a, tables=t),
                lambda a=args, t=tables: kernels.release_epilogue_plain(
                    *a, tables=t))
        # --- C9 secure, P x 5 ---------------------------------------------
        vsum = kernels.reduce_partitions(*vargs)["vsum"]
        vkeep = torch.ones(P, dtype=torch.bool, device=dev)
        vtables = executor.build_secure_tables(
            np.array([460.0]), np.array([8.0]), NoiseKind.GAUSSIAN, None, dev)
        vt = (vtables[0][0], float(vtables[1][0]))
        c9 = {}
        for plain in (False, True):
            fn = (kernels.vector_release_plain if plain else
                  kernels.vector_release)
            c9[plain] = lambda fn=fn: fn(
                vsum, vkeep, torch.zeros(1, dtype=torch.int32, device=dev),
                max_norm=1e5, norm_kind="l2", std=460.0,
                key=np.array([3, 4], np.uint32), gaussian=True, tables=vt)
        record("vector_release_secure", check_equal(
            "vector_release secure", c9[False](), c9[True]()))
        # --- C8 secure: dense (release years) and lazy (movies) ------------
        qtables = executor.build_secure_tables(
            np.array([3.1]), np.array([4.0]), NoiseKind.LAPLACE, None, dev)
        qt = (qtables[0][0], float(qtables[1][0]))
        Py, yvals, yperm, yperm2, yskey2, _, _ = bounded(years, n_rows, 16,
                                                         4, 1.0, ())
        hist = kernels.quantile_leaf_counts(yskey2, yperm2, yperm, yvals,
                                            n_partitions=Py,
                                            n_leaves=B**h, min_v=1.0,
                                            max_v=5.0)
        levels = kernels.quantile_level_counts(hist, tree_height=h,
                                               branching=B)
        ckey = threefry.fold_in(qkey, 0)
        level_keys = np.stack([threefry.fold_in(ckey, l) for l in range(h)])
        ykeep = torch.ones(Py, dtype=torch.bool, device=dev)

        def c8_dense(plain=False, leaves=None):
            fn = (kernels.quantile_descend_dense_plain if plain else
                  kernels.quantile_descend_dense)
            return fn(levels, QUANTILES, std=3.1, level_keys=level_keys,
                      gaussian=False, min_v=1.0, max_v=5.0, keep=ykeep,
                      flags=torch.zeros(1, dtype=torch.int32, device=dev),
                      dtype=f32, leaves=leaves, tables=qt)

        leaves_k = torch.empty(Py, n_q, dtype=torch.int32, device=dev)
        leaves_p = torch.empty_like(leaves_k)
        record("quantile_descend_secure", check_equal(
            "quantile_descend secure dense", c8_dense(False, leaves_k),
            c8_dense(True, leaves_p)))
        check_equal("quantile_descend secure dense leaves", leaves_k,
                    leaves_p)
        P, mvals, mperm, mperm2, mskey2, _, _ = bounded(encoded, n_rows, 64,
                                                        1, 1.0, ())
        keep = torch.ones(P, dtype=torch.bool, device=dev)
        tree = dict(tree_height=h, branching=B, min_v=1.0, max_v=5.0)
        step = dict(tree_height=h, std=3.1, gaussian=False, min_v=1.0,
                    max_v=5.0, keep=keep, tables=qt)
        state = kernels.DescentState(P, n_q, f32, dev)
        counts_by_level = []
        for level in range(1, h + 1):
            counts = kernels.quantile_child_counts(
                mskey2, mperm2, mperm, mvals, state.node.clone(),
                level=level, **tree)
            counts_by_level.append(counts)
            before = kernels.DescentState(P, n_q, f32, dev)
            for name in ("node", "target", "total", "mass"):
                setattr(before, name, getattr(state, name).clone())
            lkey = threefry.fold_in(qkey, level)
            fl_k = torch.zeros(1, dtype=torch.int32, device=dev)
            fl_p = torch.zeros(1, dtype=torch.int32, device=dev)
            out_k = kernels.quantile_descend_step(
                counts, state, QUANTILES, level=level, level_key=lkey,
                flags=fl_k, **step)
            out_p = kernels.quantile_descend_step_plain(
                counts, before, QUANTILES, level=level, level_key=lkey,
                flags=fl_p, **step)
            for name in ("node", "target", "total", "mass"):
                record("quantile_descend_secure", check_equal(
                    f"quantile_descend secure lazy level {level} {name}",
                    getattr(state, name), getattr(before, name)))
        record("quantile_descend_secure", check_equal(
            "quantile_descend secure lazy", out_k, out_p))
        check_equal("quantile_descend secure lazy flags", fl_k, fl_p)
        torch.cuda.synchronize()
        print(f"kernels[{label}, n={n_rows}] secure: C4 (1 and 3 slots, "
              f"P={P}), C9 (P={P} x 5), C8 dense (P={Py}) and lazy (P={P} x "
              f"{n_q} walks) equal their plain versions exactly (atoms, "
              f"leaves, released values)", flush=True)
        if label != "full":
            continue
        # --- chi-square of 2^20 secure draws from the kernel ---------------
        n_draw = 1 << 20
        zero = torch.zeros(n_draw, dtype=f32, device=dev)
        ctables = executor.build_secure_tables(
            np.array([3.0]), np.array([1.0]), NoiseKind.LAPLACE, None, dev)
        _, draws, _ = kernels.release_epilogue(
            {"count": zero, "pid_count": zero}, [("count", ("count",), 0)],
            np.array([3.0]), np.array([[5, 6]], np.uint32),
            NoiseKind.LAPLACE, False, 0.0, 0.0, None, None, 1,
            tables=ctables)
        gran = float(ctables[1][0])
        pmf, _ = table_stats(ctables[0][0], gran)
        k = (pmf.size - 1) // 2
        atoms = torch.round(draws["count"].double() / gran).long() + k
        observed = torch.bincount(atoms, minlength=pmf.size).cpu().numpy()
        expected = pmf * n_draw
        big = expected >= 5
        obs = np.append(observed[big], observed[~big].sum())
        exp = np.append(expected[big], expected[~big].sum())
        chi2 = float(((obs - exp)**2 / exp).sum())
        dof = int(big.sum())
        p_value = float(stats.chi2.sf(chi2, dof))
        print(f"kernels secure draws: {n_draw} Laplace draws (grid {gran}) "
              f"against the table's pmf: chi2 = {chi2:.1f} on {dof} degrees "
              f"of freedom, p = {p_value:.3g}", flush=True)
        if p_value < 1e-6:
            raise AssertionError(f"secure draws: chi-square p = {p_value}")
        # --- times ----------------------------------------------------------
        fsz = 4
        kept_rows = int((skey2 < P).sum())
        src64 = torch.stack([row_cols[c].double() for c in cols], 1)[perm2]
        key_long = skey2.long()

        def library_c3c():
            # index_add_ in float64, then float32: one rounding a sum.
            out = torch.zeros(P + 1, 3, dtype=torch.float64, device=dev)
            return out.index_add_(0, key_long, src64).float()

        level_keys_lazy = [threefry.fold_in(qkey, level)
                           for level in range(1, h + 1)]

        def lazy_descent(fn):
            st = kernels.DescentState(P, n_q, f32, dev)
            fl = torch.zeros(1, dtype=torch.int32, device=dev)
            for level, counts in enumerate(counts_by_level, 1):
                out = fn(counts, st, QUANTILES, level=level,
                         level_key=level_keys_lazy[level - 1], flags=fl,
                         **step)
            return out

        # C3 compensated: C3's bytes; ~30 operations a kept row (a TwoSum
        # of 6 and a low-word add per column). C4 secure: per slot two
        # threefry (~200 integer operations) and a 13-round search (~40),
        # ~100 for the formulas; the table rows read once. C8 secure
        # (lazy): per visited node four threefry (the node key, its split,
        # as JAX derives it) and a search (~450). C9 secure: per coordinate
        # two threefry and a search (~250).
        visits = P * n_q * B * h
        table_bytes = 4097 * 8
        timing = {
            "reduce_partitions_compensated": (
                c3c, c3c_plain, library_c3c,
                bound(n_rows * 4 + kept_rows * (8 + 1 + 3 * fsz) +
                      P * 5 * fsz, kept_rows * 30),
                "reduce_partitions.cu", "pipelinedp_tpu/ops/segment_ops.py:122"),
            "release_epilogue_secure": (
                c4[3][0], c4[3][1], None,
                bound(P * 5 * fsz + P * (1 + 4 * fsz) + 3 * table_bytes,
                      P * (3 * 240 + 100)),
                "release_epilogue.cu", "pipelinedp_tpu/ops/secure_noise.py:191"),
            "quantile_descend_secure": (
                lambda: lazy_descent(kernels.quantile_descend_step),
                lambda: lazy_descent(kernels.quantile_descend_step_plain),
                None,
                bound(visits * 4 + h * P * n_q * 2 * (4 + 3 * fsz) +
                      P * n_q * fsz + table_bytes, visits * 450),
                "quantile_descend.cu", "pipelinedp_tpu/ops/secure_noise.py:174"),
            "vector_release_secure": (
                c9[False], c9[True], None,
                bound(P * 5 * fsz * 2 + P + table_bytes, P * 5 * 250),
                "vector_release.cu", "pipelinedp_tpu/ops/secure_noise.py:191"),
        }
        for name, (fn, plain, lib, (b_ms, b_by), src, repl) in \
                timing.items():
            ms = cuda_ms(fn, repeats=10)
            plain_ms = cuda_ms(plain, repeats=3, warmup=1)
            lib_ms = cuda_ms(lib, repeats=10) if lib else None
            print(f"kernel {name}: max_abs_err={errs[name]} ms={ms:.4f} "
                  f"plain_ms="
                  f"{plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) library_ms="
                  f"{lib_ms}", flush=True)
            report.append({
                "name": name, "route": "cuda",
                "source": f"pipelinedp_tpu_torch/csrc/{src}",
                "replaces": repl, "launches": 0, "max_abs_err": errs[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms})
        b_ms, b_by = bound(P * 2 * fsz + P * (1 + fsz) + table_bytes,
                           P * 340)
        print(f"kernel release_epilogue_secure[1 slot, P={P}]: ms="
              f"{cuda_ms(c4[1][0], 10):.4f} plain_ms="
              f"{cuda_ms(c4[1][1], 3, 1):.4f} bound_ms={b_ms:.3g} ({b_by})",
              flush=True)
        b_ms, b_by = bound(Py * n_q * (h * B * 4 + fsz) + table_bytes,
                           Py * n_q * B * h * 250)
        print(f"kernel quantile_descend_secure[dense, P={Py}]: ms="
              f"{cuda_ms(lambda: c8_dense(), 10):.4f} plain_ms="
              f"{cuda_ms(lambda: c8_dense(plain=True), 3, 1):.4f} bound_ms="
              f"{b_ms:.3g} ({b_by})", flush=True)
        b_ms, b_by = bound(n_rows * 4 + kept_rows * (8 + 8 + 5 * fsz) +
                           P * 7 * fsz, kept_rows * 50)
        # Library yardstick: float64 index_add_ of the gathered
        # coordinates, then .float() (coordinates and count, pid_count).
        vsrc = torch.cat([torch.ones(n_rows, 1, device=dev),
                          pair_start[perm2].float()[:, None],
                          onehot[perm][perm2]], 1).double()
        vkey = skey2.long().clamp(0, P)

        def library_vcomp():
            out = torch.zeros(P + 1, vsrc.shape[1], dtype=torch.float64,
                              device=dev)
            return out.index_add_(0, vkey, vsrc)[:P].float()

        print(f"kernel reduce_partitions_compensated[count, pid_count + "
              f"vector D=5]: ms="
              f"{cuda_ms(lambda: kernels.reduce_partitions(*vargs, compensated=True), 10):.4f}"
              f" plain_ms="
              f"{cuda_ms(lambda: kernels.reduce_partitions_plain(*vargs, compensated=True), 3, 1):.4f}"
              f" library_ms={cuda_ms(library_vcomp, 10):.4f}"
              f" bound_ms={b_ms:.3g} ({b_by})", flush=True)
    return report


def secure_safe_parity_phase(torch, tdp, kernels, rng):
    """secure_noise=True and numeric_mode="safe" on the card against the
    same on the CPU: the same partitions, values within 1e-9 relative (in
    practice equal). float64 for every secure metric and for safe mode
    (whose float64 sums take the plain entry, as in the JAX package);
    float32 for safe mode with secure noise, where C3's compensated entry
    runs and the table draws leave no libm between card and CPU: equal."""
    n = 4096
    users = rng.integers(0, 300, n)
    ratings = rng.integers(1, 6, n).astype(np.float64)
    eight = rng.integers(0, 8, n)
    M = tdp.Metrics
    f64, f32 = torch.float64, torch.float32
    ratings_b = dict(min_value=1.0, max_value=5.0)
    secure = dict(secure_noise=True)
    cases = (
        ("secure COUNT+SUM+MEAN+VARIANCE+PRIVACY_ID_COUNT", eight, ratings,
         [M.COUNT, M.SUM, M.MEAN, M.VARIANCE, M.PRIVACY_ID_COUNT], ratings_b,
         "GAUSSIAN", True, secure, f64),
        ("secure COUNT+SUM+PRIVACY_ID_COUNT, snap_grid_bits=2", eight,
         ratings, [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT], ratings_b, "LAPLACE",
         False, dict(secure_noise=True, snap_grid_bits=2), f64),
        ("secure PERCENTILE dense", eight, ratings,
         [M.PERCENTILE(10), M.PERCENTILE(50), M.PERCENTILE(90), M.COUNT],
         ratings_b, "GAUSSIAN", True, secure, f64),
        ("secure PERCENTILE lazy", rng.integers(0, 600, n), ratings,
         [M.PERCENTILE(50), M.COUNT], ratings_b, "LAPLACE", True, secure,
         f64),
        ("secure VECTOR_SUM", eight, np.eye(5)[ratings.astype(np.int64) - 1],
         [M.VECTOR_SUM, M.COUNT],
         dict(vector_size=5, vector_max_norm=40.0,
              vector_norm_kind=tdp.NormKind.L2), "GAUSSIAN", True, secure,
         f64),
        ("safe COUNT+SUM+MEAN+VARIANCE", eight, ratings * 1000,
         [M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
         dict(min_value=1000.0, max_value=5000.0), "LAPLACE", True,
         dict(numeric_mode="safe"), f64),
        ("safe + secure COUNT+SUM+MEAN+VARIANCE", eight, ratings * 1000,
         [M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
         dict(min_value=1000.0, max_value=5000.0), "GAUSSIAN", True,
         dict(numeric_mode="safe", secure_noise=True), f32),
        ("safe + secure VECTOR_SUM", eight,
         np.eye(5)[ratings.astype(np.int64) - 1] * 1000,
         [M.VECTOR_SUM, M.COUNT],
         dict(vector_size=5, vector_max_norm=1e6,
              vector_norm_kind=tdp.NormKind.Linf), "LAPLACE", True,
         dict(numeric_mode="safe", secure_noise=True), f32),
    )
    for label, parts, values, metrics, bounds, noise, public, mode, dtype \
            in cases:
        rows = list(zip(users.tolist(), parts.tolist(), list(values)))
        want = ["release_epilogue_secure"] if mode.get("secure_noise") else []
        if mode.get("numeric_mode") == "safe" and dtype == f32:
            want.append("reduce_partitions_compensated")
        results = []
        for device in ("cuda", "cpu"):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=2.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(
                device=device, noise_seed=5, dtype=dtype, **mode))
            params = tdp.AggregateParams(
                metrics=metrics, noise_kind=getattr(tdp.NoiseKind, noise),
                max_partitions_contributed=4,
                max_contributions_per_partition=2, **bounds)
            ex = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                    partition_extractor=lambda r: r[1],
                                    value_extractor=lambda r: r[2])
            kernels.reset_launch_counts()
            res = engine.aggregate(rows, params, ex,
                                   sorted(set(parts.tolist()))
                                   if public else None)
            acc.compute_budgets()
            results.append(dict(res))
            if device == "cuda":
                check_launches(f"parity {label}", dict(kernels.launch_counts),
                               kernels, None, want)
        gpu, cpu = results
        if set(gpu) != set(cpu) or not gpu:
            raise AssertionError(f"parity {label}: released partitions "
                                 f"differ ({len(gpu)} vs {len(cpu)})")
        worst = 0.0
        for k in cpu:
            for a, b in zip(gpu[k], cpu[k]):
                err = np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))
                worst = max(worst, float(np.max(err)))
        if worst > 1e-9:
            raise AssertionError(f"parity {label}: rel err {worst}")
        print(f"parity[{label}, {noise}, "
              f"{'public' if public else 'private'}, {dtype}]: {len(gpu)} "
              f"partitions, cuda vs cpu max rel err {worst:.3g}", flush=True)


def slot_grids(tdp, params, eps, delta, snap_grid_bits=None):
    """The secure tables' grid and noise std of each plan entry's first
    slot, by output name (count, privacy_id_count, sum, vector_sum), as
    the release builds them."""
    from pipelinedp_tpu_torch import combiners, executor
    from pipelinedp_tpu_torch.ops import secure_noise
    acc = tdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    compound = combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    stds = executor.compute_noise_stds(compound)
    sens = executor.compute_noise_sensitivities(compound, params)
    thr_hi, thr_lo, gran = secure_noise.build_tables(
        stds, params.noise_kind, sensitivities=sens,
        grid_floor=None if snap_grid_bits is None else 2.0**snap_grid_bits)
    import torch
    thr = torch.as_tensor(secure_noise.pack_tables(thr_hi, thr_lo))
    grids, offset = {}, 0
    for entry in executor.build_plan(compound):
        name = {"count": "count", "privacy_id_count": "privacy_id_count",
                "sum": "sum", "vector_sum": "vector_sum",
                "variance": "count", "mean": "count"}.get(entry.kind)
        if name is not None and name not in grids:
            grids[name] = (float(gran[offset]),
                           table_stats(thr[offset], gran[offset])[1])
        offset += entry.n_stds
    return grids, stds


def on_grid(label, out, name, grid):
    got = np.array([np.ravel(getattr(v, name)) for v in out.values()])
    off = np.abs(got / grid - np.round(got / grid))
    if (off > 0).any():
        raise AssertionError(f"run ({label}) {name}: {int((off > 0).sum())} "
                             f"values off the grid {grid}")
    return got.size


def secure_safe_main_phase(torch, tdp, encoded, years, onehot, kernels,
                           card):
    """Runs (k)-(p) through DPEngine.aggregate at full size. Returns the
    launch counts summed over its runs."""
    import dataclasses
    total = dict.fromkeys(kernels.KERNELS, 0)
    pair_key = encoded.pid.astype(np.int64) * N_MOVIES + encoded.pk
    pairs, pair_rows = np.unique(pair_key, return_counts=True)
    l0_true = int(np.bincount(pairs // N_MOVIES).max())
    linf_true = int(pair_rows.max())
    P = encoded.n_partitions
    vocab = list(encoded.partition_vocab)
    secure_base = tuple(k for k in BASE_KERNELS if k != "release_epilogue") \
        + ("release_epilogue_secure",)

    def aggregate(label, enc, metrics, noise, public, eps, seed, path,
                  backend, reps=1, **bounds):
        """reps releases with seeds seed, seed + 1, ...: each checked,
        the median time printed; returns the first one's output."""
        params = tdp.AggregateParams(
            metrics=metrics(tdp.Metrics),
            noise_kind=getattr(tdp.NoiseKind, noise), **bounds)
        outs, times = [], []
        for rep in range(reps):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=eps,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(
                noise_seed=seed + rep, **backend))
            kernels.reset_launch_counts()
            res = engine.aggregate(enc, params, tdp.DataExtractors(),
                                   list(enc.partition_vocab) if public
                                   else None)
            acc.compute_budgets()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = dict(res)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            counts = dict(kernels.launch_counts)
            check_launches(f"run ({label})", counts, kernels, None, path)
            if backend.get("secure_noise") and counts["release_epilogue"] or \
                    backend.get("numeric_mode") == "safe" and \
                    counts["reduce_partitions"]:
                raise AssertionError(f"run ({label}) launched a plain "
                                     f"entry: {counts}")
            for name, n in counts.items():
                total[name] += n
            bad = [k for k, v in out.items() if not np.all(np.isfinite(
                np.hstack([np.ravel(x) for x in v])))]
            if bad or not out:
                raise AssertionError(f"run ({label}): {len(out)} "
                                     f"partitions, {len(bad)} with "
                                     f"non-finite values")
            outs.append(out)
        ms = statistics.median(times) * 1e3
        print(f"main ({label}) {noise} {'public' if public else 'private'} "
              f"{backend}: {len(outs[0])} partitions released, {ms:.1f} ms, "
              f"{N_ROWS / (ms / 1e3):.4g} rows/s (median of {reps}: "
              f"{[round(t * 1e3, 1) for t in times]} ms; {card}); launches "
              f"{counts}", flush=True)
        return outs[0], params

    secure = dict(secure_noise=True)
    per_movie = dict(max_partitions_contributed=64,
                     max_contributions_per_partition=1)
    ratings = dict(min_value=1.0, max_value=5.0)
    cps = lambda M: [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT]  # noqa: E731
    # (k) = (b) with secure noise: the same kept set (selection draws no
    # table noise), every released value on its grid.
    out_b, _ = aggregate("b, seed 0", encoded, cps, "LAPLACE", False, 1.0, 0,
                         BASE_KERNELS, {}, **per_movie, **ratings)
    out_k, params = aggregate("k", encoded, cps, "LAPLACE", False, 1.0, 0,
                              secure_base, secure, reps=3, **per_movie,
                              **ratings)
    if set(out_k) != set(out_b):
        raise AssertionError(f"run (k): kept {len(out_k)} partitions, (b) "
                             f"kept {len(out_b)}")
    grids, _ = slot_grids(tdp, params, 1.0, 1e-6)
    checked = sum(on_grid("k", out_k, name, grids[name][0])
                  for name in ("count", "sum", "privacy_id_count"))
    print(f"main (k): the same {len(out_k)} partitions as (b) kept; "
          f"{checked} released values on their grids "
          f"{ {n: g for n, (g, _) in grids.items()} }", flush=True)
    # (l) = (a) with secure noise: COUNT on its grid.
    out_l, params = aggregate(
        "l", encoded, lambda M: [M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
        "GAUSSIAN", True, 1.0, 0, secure_base, secure, reps=3, **per_movie,
        **ratings)
    grids, _ = slot_grids(tdp, params, 1.0, 1e-6)
    on_grid("l", out_l, "count", grids["count"][0])
    print(f"main (l): {len(out_l)} counts on their grid "
          f"{grids['count'][0]}", flush=True)
    # (m) = (f) with secure noise: lazy percentiles, monotone.
    secure_q = LAZY_PERCENTILE_PATH + ("release_epilogue_secure",
                                       "quantile_descend_secure")
    secure_q = tuple(k for k in secure_q
                     if k not in ("release_epilogue", "quantile_descend"))
    out_m, _ = aggregate(
        "m", encoded, lambda M: [M.PERCENTILE(10), M.PERCENTILE(50),
                                 M.PERCENTILE(90), M.COUNT],
        "GAUSSIAN", True, 1.0, 0, secure_q, secure, reps=3, **per_movie,
        **ratings)
    q = np.array([[v.percentile_10, v.percentile_50, v.percentile_90]
                  for v in out_m.values()])
    if len(out_m) != P or (np.diff(q, axis=1) < 0).any() or \
            (q < 1.0).any() or (q > 5.0).any():
        raise AssertionError("run (m): percentiles not monotone in [1, 5]")
    print(f"main (m): {len(out_m)} partitions' secure percentiles 10 <= 50 "
          f"<= 90 within [1, 5]", flush=True)
    # (n) = (i) with secure noise: vector coordinates on the grid.
    secure_v = tuple(k for k in VECTOR_PATH
                     if k not in ("release_epilogue", "vector_release")) + (
        "release_epilogue_secure", "vector_release_secure")
    out_n, params = aggregate(
        "n", onehot, lambda M: [M.VECTOR_SUM, M.COUNT], "GAUSSIAN", True,
        1.0, 0, secure_v, secure, reps=3, vector_size=5,
        vector_norm_kind=tdp.NormKind.L2, vector_max_norm=1000.0,
        **per_movie)
    grids, _ = slot_grids(tdp, params, 1.0, 1e-6)
    n_vec = on_grid("n", out_n, "vector_sum", grids["vector_sum"][0])
    print(f"main (n): {n_vec} vector coordinates on their grid "
          f"{grids['vector_sum'][0]}", flush=True)
    # (o) = (c) with secure noise at eps 1e6: the numpy group-by within 16
    # noise stds (the table's) plus one grid step.
    out_o, params = aggregate(
        "o", encoded, cps, "LAPLACE", True, 1e6, 9, secure_base, secure,
        max_partitions_contributed=l0_true,
        max_contributions_per_partition=linf_true, **ratings)
    grids, _ = slot_grids(tdp, params, 1e6, 1e-6)
    truth = {"count": np.bincount(encoded.pk, minlength=P).astype(float),
             "sum": np.bincount(encoded.pk, weights=encoded.values,
                                minlength=P),
             "privacy_id_count": np.bincount(pairs % N_MOVIES,
                                             minlength=P).astype(float)}
    worst = {}
    for name, want in truth.items():
        grid, std = grids[name]
        got = np.array([getattr(out_o[m], name) for m in vocab])
        err = np.abs(got - want)
        tol = 16 * std + grid + 1e-6 * np.abs(want)
        if (err > tol).any():
            i = int(np.argmax(err - tol))
            raise AssertionError(f"run (o) {name}: partition {vocab[i]} "
                                 f"{got[i]} vs numpy {want[i]}")
        worst[name] = [float(err.max()), grid, std]
    print(f"main (o) epsilon=1e6, secure: {len(out_o)} partitions match the "
          f"numpy group-by within 16 noise stds + one grid step ([max abs "
          f"err, grid, noise std] {json.dumps(worst)})", flush=True)
    # (p) numeric_mode="safe", float32, COUNT+SUM of rating x 1000, past the
    # 2^24 cliff; the same run in fast mode beside it (a record). At
    # epsilon 1e6 the sum's Gaussian noise (L2 sensitivity sqrt(7135) *
    # 5000) has a std of ~424, above the float32 ulp (32) of the largest
    # sums; at 1e12 it is ~0.4, so the accumulation error shows.
    scaled = dataclasses.replace(encoded, values=encoded.values * 1000)
    true_sum = np.bincount(encoded.pk, weights=encoded.values * 1000,
                           minlength=P)
    safe_base = tuple(k for k in BASE_KERNELS if k != "reduce_partitions") \
        + ("reduce_partitions_compensated",)
    bounds = dict(max_partitions_contributed=l0_true,
                  max_contributions_per_partition=linf_true,
                  min_value=1000.0, max_value=5000.0)
    cs = lambda M: [M.COUNT, M.SUM]  # noqa: E731
    ulp = np.spacing(np.abs(true_sum).astype(np.float32)).astype(np.float64)
    top = int(np.argmax(true_sum))
    for eps in (1e6, 1e12):
        label = "p" if eps == 1e6 else "p, eps 1e12"
        out_p, params = aggregate(label, scaled, cs, "GAUSSIAN", True, eps,
                                  13, safe_base, dict(numeric_mode="safe"),
                                  **bounds)
        _, stds = slot_grids(tdp, params, eps, 1e-6)
        sum_std = float(stds[1])
        err = np.abs(np.array([out_p[m].sum for m in vocab]) - true_sum)
        tol = 16 * sum_std + ulp
        if (err > tol).any():
            i = int(np.argmax(err - tol))
            raise AssertionError(f"run ({label}): partition {vocab[i]} sum "
                                 f"{true_sum[i] + err[i]} vs numpy int64 "
                                 f"{true_sum[i]} (tol {tol[i]})")
        out_f, _ = aggregate(f"{label}, fast", scaled, cs, "GAUSSIAN", True,
                             eps, 13, BASE_KERNELS, {}, **bounds)
        # The record: the sums past 2^25 (ulp >= 4, where noise of std
        # 0.4 rounds away) against float32 of the exact sum, in ulps.
        big = true_sum >= 2.0**25
        f32_sum = true_sum.astype(np.float32).astype(np.float64)
        off = {}
        for mode, out in (("safe", out_p), ("fast", out_f)):
            dev_ulps = np.abs(np.array([out[m].sum for m in vocab]) -
                              f32_sum)[big] / ulp[big]
            off[mode] = [int((dev_ulps > 0).sum()),
                         float(dev_ulps.max()) if dev_ulps.size else 0.0]
        print(f"main ({label}) safe, float32, rating x 1000, l0={l0_true}, "
              f"linf={linf_true}: {len(out_p)} sums within 16 noise stds "
              f"({sum_std:.4g}) + 1 float32 ulp of the numpy int64 group-by "
              f"(largest sum {true_sum[top]:.0f}, ulp {ulp[top]:.0f}; max "
              f"abs err {float(err.max()):.4g}). Of the {int(big.sum())} "
              f"sums past 2^25, [how many differ from float32(exact sum), "
              f"the largest difference in ulps]: safe {off['safe']}, fast "
              f"{off['fast']} (fast: a record, not a gate)", flush=True)
        if eps == 1e12:
            # Past 2^25 half an ulp is >= 2, about five noise stds (a
            # draw past it: ~2e-6 a sum): a sum that is float32(exact
            # sum) comes back unchanged, and one that rounded like the
            # fast entry's shows.
            if not big.any() or 2.0 / sum_std < 4.5:
                raise AssertionError(f"run ({label}): no sum past 2^25 or "
                                     f"noise std {sum_std} too large for "
                                     f"the exactness gate")
            if off["safe"][0]:
                raise AssertionError(f"run ({label}): {off['safe'][0]} safe "
                                     f"sums past 2^25 differ from float32("
                                     f"exact sum), by up to "
                                     f"{off['safe'][1]} ulps")
    return total


# ---------------------------------------------------------------------------
# The blocked large-P route

# (q)'s shape: the JAX package's large-P benchmark (benchmarks/
# bench_large_p.py, _common.zipfish_data): 2^24 rows, 10^6 users,
# partition keys floor(u^6 * 10^7), values U[0, 5].
LARGE_ROWS = 1 << 24
LARGE_USERS = 1_000_000
LARGE_SPACE = 10_000_000
LARGE_BLOCK = 1 << 20
# The kernels of every blocked aggregation and selection: the dense
# route's, with C3 through its windowed entry and C10 for the windows.
BLOCKED_KERNELS = ("row_keys", "bound_rows", "radix_sort",
                   "block_window_offsets", "reduce_partitions_windowed",
                   "release_epilogue", "compact_kept")


def zipfish_rows():
    """(q)'s rows, from the benchmark's own seed."""
    rng = np.random.default_rng(5)
    pid = rng.integers(0, LARGE_USERS, LARGE_ROWS).astype(np.int32)
    pk = (np.power(rng.random(LARGE_ROWS), 6.0) * LARGE_SPACE).astype(
        np.int32)
    return pid, pk, rng.uniform(0, 5, LARGE_ROWS)


def data_maxima(pid, pk, P):
    """(largest partitions per privacy id, largest rows per (id,
    partition), pair keys and their row counts) of encoded rows."""
    pairs, pair_rows = np.unique(pid.astype(np.int64) * P + pk,
                                 return_counts=True)
    return (int(np.bincount(pairs // P).max()), int(pair_rows.max()), pairs,
            pair_rows)


def release_spec(tdp, params, P, eps, private):
    """The port's (cfg, stds, scalars) of one blocked release, built as
    lazy_aggregate builds them (selection budget requested when private)."""
    from pipelinedp_tpu_torch import combiners, executor
    from pipelinedp_tpu_torch.ops import selection_ops
    acc = tdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    compound = combiners.create_compound_combiner(params, acc)
    budget = (acc.request_budget(tdp.MechanismType.GENERIC) if private else
              None)
    acc.compute_budgets()
    selection = (selection_ops.selection_params_from_host(
        params.partition_selection_strategy, budget.eps, budget.delta,
        params.max_partitions_contributed, params.pre_threshold)
        if private else None)
    cfg = executor.make_kernel_config(params, compound, P, private,
                                      selection)
    return cfg, executor.compute_noise_stds(compound), \
        executor.kernel_scalars(params)


def scan_tolerance(count, truth):
    """float32 rounding of a partition sum from C3's scan, an allowance of
    one ulp of the sum for each 2048 rows of the partition, plus 16. (C3
    adds in sequence about 12 levels inside a tile of 512 rows and, for a
    partition crossing tiles, a 5-level warp scan and one fold per 32
    tiles.)"""
    ulp = np.spacing(np.abs(truth).astype(np.float32)).astype(np.float64)
    return (count / 2048.0 + 16.0) * ulp


class PhaseProbe:
    """Hands a blocked driver of large_p (aggregate_blocked by default) a
    phase_times dict on every call the engine makes and notes when it
    returned (decode = the time after it)."""

    def __init__(self, large_p, name="aggregate_blocked"):
        self.large_p = large_p
        self.name = name
        self.records = []

    def __enter__(self):
        self.original = original = getattr(self.large_p, self.name)

        def probed(*args, **kwargs):
            phase_times = kwargs["phase_times"] = {}
            out = original(*args, **kwargs)
            phase_times["returned_at"] = time.perf_counter()
            self.records.append(phase_times)
            return out

        setattr(self.large_p, self.name, probed)
        return self

    def __exit__(self, *exc):
        setattr(self.large_p, self.name, self.original)


def std_by_output(cfg, stds):
    """Each plan entry's first noise std, by its first output's name."""
    out, offset = {}, 0
    for entry in cfg.plan:
        out[entry.outputs[0]] = float(stds[offset])
        offset += entry.n_stds
    return out


def large_p_kernel_phase(torch, dev, qenc, qmax, kernels, large_p, threefry,
                         tdp, card):
    """C10, C11 and the windowed entries of C3 and C7 against their plain
    versions on the card, at the main path's shapes: C10 over (q)'s full
    pass-1 stream, C11 at the first chunk of (w), C3 and C7 on block 1 of
    (q)'s stream (a full block of 2^20 partitions)."""
    f32 = torch.float32
    P = qenc.n_partitions
    key = np.array([7, 11], dtype=np.uint32)
    report = []
    M = tdp.Metrics
    params = tdp.AggregateParams(
        metrics=[M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
        noise_kind=tdp.NoiseKind.LAPLACE, max_partitions_contributed=4,
        max_contributions_per_partition=8, min_value=0.0, max_value=5.0)
    cfg, _, scalars = release_spec(tdp, params, P, 1.0, True)
    rows = large_p._device_rows(qenc.pid, qenc.pk, qenc.values, qenc.valid,
                                dev, f32)
    stream = large_p._bound_compact(*rows, scalars, key, cfg)
    n = stream.skey2.shape[0]
    n_blocks = -(-P // LARGE_BLOCK)
    bounds = kernels.block_window_boundaries(0, LARGE_BLOCK, n_blocks, P,
                                             dev)
    # C10 at the full stream.
    offsets = kernels.block_offsets(stream.skey2, bounds)
    err10 = check_equal("block_offsets", offsets,
                        kernels.block_offsets_plain(stream.skey2, bounds))
    m = bounds.shape[0]
    depth = max(1, int(n).bit_length())
    c10 = (lambda: kernels.block_offsets(stream.skey2, bounds),  # noqa: E731
           lambda: kernels.block_offsets_plain(stream.skey2, bounds),
           lambda: torch.searchsorted(stream.skey2, bounds),
           # Each boundary's search reads ~log2(n) stream words.
           bound(m * depth * 4 + m * 4 + m * 8, m * depth * 3))
    # The same windows with the boundaries made in the kernel (the
    # drivers' entry, large_p._offsets): nothing uploaded.
    window = ([stream.skey2], 0, LARGE_BLOCK, n_blocks, P)
    got10w = same_twice("block_window_offsets", lambda: {
        "offsets": kernels.block_window_offsets(*window)})["offsets"]
    err10w = max(check_equal("block_window_offsets", got10w,
                             kernels.block_window_offsets_plain(*window)),
                 check_equal("block_window_offsets vs block_offsets",
                             got10w[0], offsets))
    c10w = (lambda: kernels.block_window_offsets(*window),  # noqa: E731
            lambda: kernels.block_window_offsets_plain(*window),
            lambda: torch.searchsorted(stream.skey2, bounds),
            bound(m * depth * 4 + m * 8, m * depth * 3))
    # C3 windowed on block 1: three float columns, vector D = 5 (one-hot of
    # the value's integer part), compensated (values x 1000, integers).
    host_off = offsets.cpu().numpy()
    lo, hi = int(host_off[1]), int(host_off[2])
    base, C = LARGE_BLOCK, LARGE_BLOCK
    sk, pw = stream.skey2[lo:hi], stream.perm[lo:hi]
    cols = stream.cols
    c3 = lambda: kernels.reduce_partitions(  # noqa: E731
        sk, pw, stream.pair_start, cols, C, f32, base=base)
    c3p = lambda: kernels.reduce_partitions_plain(  # noqa: E731
        sk, pw, stream.pair_start, cols, C, f32, base=base)
    dense, q_dense = same_twice("reduce_partitions_windowed", c3), c3p()
    scale = kernels.reduce_partitions_plain(
        sk, pw, stream.pair_start, {c: v.abs() for c, v in cols.items()}, C,
        f32, base=base)
    err3 = max(check_equal("reduce windowed count", dense["count"],
                           q_dense["count"]),
               check_equal("reduce windowed pid_count", dense["pid_count"],
                           q_dense["pid_count"]))
    for c in cols:
        diff = (dense[c].double() - q_dense[c].double()).abs()
        if bool((diff > 1e-5 * scale[c].double() + 1e-6).any()):
            raise AssertionError(f"reduce_partitions windowed {c}: max diff "
                                 f"{float(diff.max())} over tolerance")
        err3 = max(err3, float(diff.max()))
    onehot = torch.nn.functional.one_hot(
        stream.values.long().clamp(0, 4), 5).to(f32).contiguous()
    vrows = (stream.row_perm, onehot)
    vec = same_twice(
        "reduce_partitions_windowed vector",
        lambda: kernels.reduce_partitions(sk, pw, stream.pair_start, {}, C,
                                          f32, vrows, base=base))["vsum"]
    err3 = max(err3, check_equal(
        "reduce windowed vsum", vec, kernels.reduce_partitions_plain(
            sk, pw, stream.pair_start, {}, C, f32, vrows, base=base)["vsum"]))
    w_rows = hi - lo
    window_cols = torch.stack([torch.ones(w_rows, device=dev),
                               stream.pair_start[pw].float()] +
                              [cols[c][pw] for c in cols], 1)
    rel = (sk.long() - base).clamp(0, C)

    def library_c3():
        out = torch.zeros(C + 1, window_cols.shape[1], device=dev)
        return out.index_add_(0, rel, window_cols)

    c3_entry = (c3, c3p, library_c3,
                bound(w_rows * (4 + 8 + 1 + 3 * 4) + C * 5 * 4, w_rows * 8))
    # Compensated: the sum column of values x 1000 rounded to integers.
    milli = dataclasses.replace(qenc, values=np.round(qenc.values * 1000.0))
    s_params = tdp.AggregateParams(
        metrics=[M.COUNT, M.SUM], noise_kind=tdp.NoiseKind.LAPLACE,
        max_partitions_contributed=4, max_contributions_per_partition=8,
        min_value=0.0, max_value=5000.0)
    s_cfg, _, s_scalars = release_spec(tdp, s_params, P, 1.0, True)
    s_stream = large_p._bound_compact(
        *large_p._device_rows(milli.pid, milli.pk, milli.values, milli.valid,
                              dev, f32), s_scalars, key, s_cfg)
    s_off = kernels.block_offsets(s_stream.skey2, bounds).cpu().numpy()
    slo, shi = int(s_off[1]), int(s_off[2])
    s_args = (s_stream.skey2[slo:shi], s_stream.perm[slo:shi],
              s_stream.pair_start, s_stream.cols, C, f32)
    c3c = lambda: kernels.reduce_partitions(  # noqa: E731
        *s_args, compensated=True, base=base)
    c3c_plain = lambda: kernels.reduce_partitions_plain(  # noqa: E731
        *s_args, compensated=True, base=base)
    comp = same_twice("reduce_partitions_compensated_windowed", c3c)
    err3c = check_equal("reduce windowed compensated sum", comp["sum"],
                        c3c_plain()["sum"])
    s_rel = (s_stream.skey2[slo:shi].long() - base).clamp(0, C)
    s_vals = s_stream.cols["sum"][s_stream.perm[slo:shi]]
    exact = torch.zeros(C + 1, dtype=torch.int64, device=dev).index_add_(
        0, s_rel, s_vals.to(torch.int64))[:C]
    check_equal("reduce windowed compensated sum vs float32(exact)",
                comp["sum"], exact.to(f32))
    fast_err = float((kernels.reduce_partitions(*s_args, base=base)["sum"]
                      .double() - exact.double()).abs().max())
    s_rows = shi - slo

    def library_c3c():
        out = torch.zeros(C + 1, dtype=torch.float64, device=dev)
        return out.index_add_(0, s_rel, s_vals.double())[:C].float()

    c3c_entry = (c3c, c3c_plain, library_c3c,
                 bound(s_rows * (4 + 8 + 1 + 4) + C * 3 * 4, s_rows * 30))
    print(f"kernels[windowed, block 1 of (q): {w_rows} rows, C={C}]: C3 "
          f"windowed (3 columns, vector D=5) and compensated agree with "
          f"their plain versions; compensated sums equal float32(exact), "
          f"the fast entry's largest error {fast_err}", flush=True)
    # C7 windowed: a 16-leaf histogram (height 1; the default tree's
    # 2^20 x 65536 leaf histogram does not fit the card) and the default
    # tree's level-1 child counts, as the lazy descent takes them.
    from pipelinedp_tpu_torch.ops import quantile_tree
    h, B = quantile_tree.DEFAULT_TREE_HEIGHT, \
        quantile_tree.DEFAULT_BRANCHING_FACTOR
    qargs = (sk, pw, stream.row_perm, stream.values)
    leaf = kernels.quantile_leaf_counts(*qargs, n_partitions=C, n_leaves=B,
                                        min_v=0.0, max_v=5.0, base=base)
    err7 = check_equal("quantile leaf counts windowed", leaf,
                       kernels.quantile_leaf_counts_plain(
                           *qargs, n_partitions=C, n_leaves=B, min_v=0.0,
                           max_v=5.0, base=base))
    node = torch.zeros(C, 1, dtype=torch.int32, device=dev)
    tree = dict(level=1, tree_height=h, branching=B, min_v=0.0, max_v=5.0,
                base=base)
    # Level 1 as the descent takes it: filling the window's leaf buffer.
    wleaf = torch.empty(sk.shape[0], dtype=torch.int32, device=dev)
    wleaf_p = torch.empty_like(wleaf)
    c7 = lambda: kernels.quantile_child_counts(*qargs, node,  # noqa: E731
                                               leaf=wleaf, **tree)
    c7p = lambda: kernels.quantile_child_counts_plain(  # noqa: E731
        *qargs, node, leaf=wleaf_p, **tree)
    err7 = max(err7, check_equal("quantile child counts windowed", c7(),
                                 c7p()),
               check_equal("quantile child counts windowed, leaf buffer",
                           wleaf, wleaf_p))
    slot = rel * B + kernels.leaf_indices(
        kernels.sorted_rows(pw, stream.row_perm, stream.values), 0.0, 5.0,
        B**h) // B**(h - 1)
    c7_entry = (c7, c7p,
                lambda: torch.bincount(slot, minlength=(C + 1) * B),
                bound(w_rows * (4 + 8 + 8 + 4) + C * B * 4, w_rows * 20))
    # C11 at the first chunk of (w): (r)'s bounds, chunks of 2^22 rows.
    order = np.argsort(qenc.pid, kind="stable")
    ends = large_p._chunk_ends(qenc.pid[order], 1 << 22)
    first = order[:ends[0]]
    l0_true, linf_true = qmax[:2]
    r_params = tdp.AggregateParams(
        metrics=[M.COUNT, M.SUM], noise_kind=tdp.NoiseKind.LAPLACE,
        max_partitions_contributed=l0_true,
        max_contributions_per_partition=linf_true, min_value=0.0,
        max_value=5.0)
    r_cfg, _, r_scalars = release_spec(tdp, r_params, P, 1e6, True)
    chunk = large_p._bound_compact(
        *large_p._device_rows(qenc.pid[first], qenc.pk[first],
                              qenc.values[first], qenc.valid[first], dev,
                              f32), r_scalars, threefry.fold_in(key, 0),
        r_cfg)
    k = int(kernels.block_offsets(
        chunk.skey2, torch.tensor([P], dtype=torch.int32, device=dev))[0])
    idx = chunk.perm[:k]
    gcols = [chunk.pair_start, chunk.cols["sum"]]
    err11 = max(check_equal(f"gather_rows column {j}", a, b) for j, (a, b)
                in enumerate(zip(kernels.gather_rows(idx, gcols),
                                 kernels.gather_rows_plain(idx, gcols))))
    # The value rows, through the gathered bounding order (row_perm o perm),
    # as the percentile and vector runs gather them.
    row_idx = kernels.gather_rows(idx, [chunk.row_perm])[0]
    err11 = max(err11, check_equal(
        "gather_rows value rows", kernels.gather_rows(row_idx,
                                                      [chunk.values])[0],
        chunk.values[chunk.row_perm[idx]]))
    c11_entry = (lambda: kernels.gather_rows(idx, gcols),
                 lambda: kernels.gather_rows_plain(idx, gcols), None,
                 bound(k * 8 + 2 * k * (1 + 4), k * 4))
    torch.cuda.synchronize()
    print(f"kernels[blocked, (q): n={n}, P={P}, {n_blocks} blocks; chunk 0 "
          f"of (w): {ends[0]} rows, {k} kept]: C10, C11 and the windowed C3 "
          f"/ C7 agree with their plain versions", flush=True)
    entries = {
        "block_offsets": (c10, err10, "block_offsets.cu",
                          "pipelinedp_tpu/parallel/large_p.py:1519"),
        "block_window_offsets": (c10w, err10w, "block_offsets.cu",
                                 "pipelinedp_tpu/parallel/large_p.py:1519"),
        "gather_rows": (c11_entry, err11, "gather_rows.cu",
                        "pipelinedp_tpu/parallel/large_p.py:671"),
        "reduce_partitions_windowed": (
            c3_entry, err3, "reduce_partitions.cu",
            "pipelinedp_tpu/parallel/large_p.py:183"),
        "reduce_partitions_compensated_windowed": (
            c3c_entry, err3c, "reduce_partitions.cu",
            "pipelinedp_tpu/parallel/large_p.py:183"),
        "quantile_child_counts_windowed": (
            c7_entry, err7, "quantile_counts.cu",
            "pipelinedp_tpu/parallel/large_p.py:205"),
    }
    for name, ((fn, plain, lib, (b_ms, b_by)), err, src, repl) in \
            entries.items():
        ms = cuda_ms(fn, repeats=10)
        plain_ms = cuda_ms(plain, repeats=3, warmup=1)
        lib_ms = cuda_ms(lib, repeats=10) if lib else None
        print(f"kernel {name}: max_abs_err={err} ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) library_ms="
              f"{lib_ms} ({card})", flush=True)
        report.append({
            "name": name, "route": "cuda",
            "source": f"pipelinedp_tpu_torch/csrc/{src}", "replaces": repl,
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
    vb_ms, vb_by = bound(w_rows * (4 + 8 + 8 + 5 * 4) + C * 5 * 4,
                         w_rows * 10)
    lb_ms, lb_by = bound(w_rows * (4 + 8 + 8 + 4) + C * B * 4, w_rows * 20)
    rb_ms, rb_by = bound(w_rows * 8 + C * (4 + B * 4), w_rows * 10)
    print(f"kernel quantile_child_counts_windowed[level 2, reads the leaf "
          f"buffer]: ms="
          f"{cuda_ms(lambda: kernels.quantile_child_counts(*qargs, node, leaf=wleaf, **dict(tree, level=2)), 10):.4f}"
          f" bound_ms={rb_ms:.3g} ({rb_by}) ({card})", flush=True)
    # Yardsticks: index_add_ of the gathered coordinates (with count and
    # pid_count), bincount of the precomputed (partition, leaf) slots.
    vsrc = torch.cat([torch.ones(w_rows, 1, device=dev),
                      stream.pair_start[pw].float()[:, None],
                      onehot[stream.row_perm[pw]]], 1)
    leaf_slot = rel * B + kernels.leaf_indices(
        kernels.sorted_rows(pw, stream.row_perm, stream.values), 0.0, 5.0, B)

    def library_vec():
        out = torch.zeros(C + 1, vsrc.shape[1], device=dev)
        return out.index_add_(0, rel, vsrc)

    print(f"kernel reduce_partitions_windowed[vector D=5]: ms="
          f"{cuda_ms(lambda: kernels.reduce_partitions(sk, pw, stream.pair_start, {}, C, f32, vrows, base=base), 10):.4f}"
          f" plain_ms="
          f"{cuda_ms(lambda: kernels.reduce_partitions_plain(sk, pw, stream.pair_start, {}, C, f32, vrows, base=base), 3, 1):.4f}"
          f" library_ms={cuda_ms(library_vec, 10):.4f}"
          f" bound_ms={vb_ms:.3g} ({vb_by}); quantile_counts_windowed[16-leaf"
          f" histogram]: ms="
          f"{cuda_ms(lambda: kernels.quantile_leaf_counts(*qargs, n_partitions=C, n_leaves=B, min_v=0.0, max_v=5.0, base=base), 10):.4f}"
          f" plain_ms="
          f"{cuda_ms(lambda: kernels.quantile_leaf_counts_plain(*qargs, n_partitions=C, n_leaves=B, min_v=0.0, max_v=5.0, base=base), 3, 1):.4f}"
          f" library_ms="
          f"{cuda_ms(lambda: torch.bincount(leaf_slot, minlength=(C + 1) * B), 10):.4f}"
          f" bound_ms={lb_ms:.3g} ({lb_by}) ({card})", flush=True)
    # C10's time split beside its yardstick's, in turns (the searchsorted
    # takes the boundaries uploaded before its timing starts).
    print_three_way(f"C10, {m} boundaries over (q)'s {n} rows", three_way(
        torch, {"block_offsets": c10[0], "block_window_offsets": c10w[0],
                "torch.searchsorted": c10[2]}), card)
    # The windowed C3's time split: the device's (its memset and kernel,
    # torch.profiler) against the CUDA events around the whole wrapper.
    print(f"kernel reduce_partitions_windowed[3 columns]: device_ms="
          f"{device_ms(torch, c3, 20):.4f} (memset + kernel, "
          f"torch.profiler) of ms={cuda_ms(c3, 10):.4f} (the wrapper, "
          f"CUDA events) ({card})", flush=True)
    return report


def device_ms(torch, fn, calls):
    """Device time a call of fn (kernels and memsets, torch.profiler) over
    `calls` calls, after one warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise AssertionError("device_ms: no device time traced")
    return sum(e.self_device_time_total for e in device) / 1e3 / calls


def host_us(torch, fn, calls=1000):
    """Microseconds of host time a call of fn over `calls` enqueues
    without a synchronise (the wrapper's host part), after a warm call."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def launches_ms(torch, fn, calls=100):
    """Milliseconds a call over `calls` back-to-back calls between two
    CUDA events: the device's time where the host keeps ahead of it."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ops(torch, fn, calls=3):
    """{name: [count, device us]} of the device operations (kernels,
    memsets, copies) one call of fn issues, and their total count, from
    torch.profiler over `calls` calls after a warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")[:40]
            count, us = ops.get(name, (0, 0.0))
            ops[name] = (count + e.count, us + e.self_device_time_total)
    if not ops:
        return "not traced"
    ops = {k: (c / calls, round(us / calls, 1)) for k, (c, us) in ops.items()}
    return dict(ops, total=sum(c for c, _ in ops.values()))


def three_way(torch, fns, host_calls=1000):
    """{name: (wrapper ms, device ms, host us)} of each fn, measured in
    turns (each figure over every fn before the next figure): wrapper ms
    as cuda_ms (CUDA events around one call, median of 50); device ms the
    kernels alone (torch.profiler, 100 calls), or where the trace shows no
    device time CUDA events around 100 back-to-back calls; host us over
    host_calls enqueues (host_us)."""
    out = {name: [cuda_ms(fn, 50)] for name, fn in fns.items()}
    for name, fn in fns.items():
        try:
            out[name].append(device_ms(torch, fn, 100))
        except AssertionError:
            out[name].append(launches_ms(torch, fn, 100))
    for name, fn in fns.items():
        out[name].append(host_us(torch, fn, host_calls))
    return out


def print_three_way(label, split, card):
    print(f"split[{label}]: " + "; ".join(
        f"{name} wrapper_ms={w:.4f} device_ms={d:.4f} host_us={h:.2f}"
        for name, (w, d, h) in split.items()) + f" ({card})", flush=True)


def c3_edge_phase(torch, dev, kernels):
    """C3's edge windows, each entry equal to its plain version and called
    twice with the same bits: a partition spanning >= 100 tiles of the
    look-back (300,000 rows) between short runs, a single row, an empty
    window, windows wholly above and below [0, C), runs at keys 0 and
    C - 1; the solo, windowed, compensated and vector entries, and the
    lane entries with each lane == its solo run. The sums are exact in
    any order, so every output is held to ==: "sum" is on a grid of 1/64
    (every partial sum below 2^18 is exact in float32), "nsum" holds
    integers to 1000 (sums past 2^24, exact only compensated) and goes
    to the compensated entry, the vectors are one-hot."""
    f32 = torch.float32
    rng = np.random.default_rng(SEED + 15)

    def on_card(a):
        return torch.as_tensor(a).to(dev)

    def rows(keys):
        n = len(keys)
        return (on_card(np.asarray(keys, dtype=np.int32)),
                on_card(rng.permutation(n).astype(np.int64)),
                on_card(rng.random(n) < 0.4),
                {"sum": on_card(rng.integers(0, 64, n).astype(np.float32)
                                / 64),
                 "nsum": on_card(rng.integers(0, 1001, n).astype(
                     np.float32))})

    def agree(label, P, skey2, perm, pair_start, cols, base=None, vec=None,
              compensated=False):
        cols = {c: cols[c] for c in (("nsum",) if compensated else ("sum",))}
        args = (skey2, perm, pair_start, cols, P, f32, vec)
        got = same_twice(label, lambda: kernels.reduce_partitions(
            *args, compensated=compensated, base=base))
        want = kernels.reduce_partitions_plain(*args, compensated, base)
        for name in want:
            check_equal(f"{label} {name}", got[name], want[name])
        return got

    hot = rows([0] * 7 + [5] * 300_000 + [6] * 1000 + [9] * 5)
    onehot = torch.nn.functional.one_hot(
        on_card(rng.integers(0, 5, hot[0].shape[0])), 5).to(f32).contiguous()
    agree("C3 one 300,000-row partition", 10, *hot)
    agree("C3 one 300,000-row partition, compensated", 10, *hot,
          compensated=True)
    agree("C3 one 300,000-row partition, vector", 10, *hot,
          vec=(None, onehot))
    agree("C3 one 300,000-row partition, windowed", 4, *hot, base=4)
    agree("C3 window above [0, C)", 4, *hot, base=100)
    agree("C3 window below [0, C)", 4, *hot, base=-50)
    single = rows([3])
    agree("C3 single row", 8, *single)
    agree("C3 single row, compensated", 8, *single, compensated=True)
    agree("C3 empty window", 8, hot[0][:0], hot[1][:0], *hot[2:])
    edges = rows([0] * 3000 + [7] * 2500)
    got = agree("C3 runs at keys 0 and C - 1", 8, *edges)
    if [int(c) for c in got["count"]] != [3000, 0, 0, 0, 0, 0, 0, 2500]:
        raise AssertionError(f"C3 keys 0 and C - 1: counts "
                             f"{got['count'].tolist()}")
    agree("C3 runs at keys 0 and C - 1, windowed", 8, *edges, base=0)
    # Lanes: 4 jobs of 2^16 rows over P = 1000, a tenth dropped.
    L, lane_rows, P = 4, 1 << 16, 1000
    lane = np.repeat(np.arange(L), lane_rows)
    key2 = np.where(rng.random(L * lane_rows) < 0.1, L * P,
                    lane * P + (rng.random(L * lane_rows) ** 3 * P).astype(
                        np.int64))
    order = np.argsort(key2, kind="stable")
    skey2, perm = on_card(key2[order].astype(np.int32)), on_card(order)
    pair_start = on_card(rng.random(L * lane_rows) < 0.4)
    cols = {"sum": on_card(np.round(rng.random(L * lane_rows) * 1000)
                           .astype(np.float32))}
    onehot = torch.nn.functional.one_hot(
        on_card(rng.integers(0, 5, L * lane_rows)), 5).to(f32).contiguous()
    edges_l = torch.searchsorted(
        skey2, torch.arange(L + 1, dtype=torch.int32, device=dev) * P
    ).tolist()
    for comp in (False, True):
        label = f"C3 lanes (compensated={comp})"
        got = same_twice(label, lambda: kernels.reduce_partitions_lanes(
            skey2, perm, pair_start, cols, lane_rows, P, f32,
            (None, onehot), compensated=comp))
        want = kernels.reduce_partitions_lanes_plain(
            skey2, perm, pair_start, cols, lane_rows, P, f32,
            (None, onehot), comp)
        for name in want:  # integer-valued: exact
            check_equal(f"{label} {name}", got[name], want[name])
        for l in range(L):
            a, b = edges_l[l], edges_l[l + 1]
            solo = kernels.reduce_partitions(
                skey2[a:b] - l * P, perm[a:b], pair_start, cols, P, f32,
                (None, onehot), compensated=comp)
            for name in solo:
                check_equal(f"{label} lane {l} {name} vs solo", solo[name],
                            got[name][l * P:(l + 1) * P])
    print("kernels[C3 edges]: a 300,000-row partition (586 tiles of 512 "
          "rows; 293 of the vector entry's 1024), a single row, an "
          "empty window, windows outside [0, C), keys 0 and C - 1, the "
          "lane entries: each entry == its plain version (sums exact in "
          "any order) and equal to itself run to run; each lane == its "
          "solo run", flush=True)


def c10_c21_edge_phase(torch, dev, kernels):
    """C10's and C21's edge cases on the card, every entry == its plain
    version and giving the same bits twice. C10: streams of 0, 1, 31, 32,
    33, 1023 and 2^20 + 7 rows (duplicates, the sentinel, every row at the
    sentinel), boundaries below every row, at INT32_MAX and `end` below
    the last boundary, 1, 3 and 64 streams in one launch, and
    block_offsets at P + 1 partition starts. C21: combine_parts at D in
    {1, 2, 3, 5, 8, 32, 64} over int32 (wrapping), int64, float32,
    float64 and compensated float32 columns of ragged lengths and [P, V]
    shapes, parts at every alignment modulo 16 bytes (the head, vector and
    tail slots and the all-scalar columns), 40 columns and D x C past the
    parameter table (launches counted per group); combine_shards and
    heartbeat_sum at small stacks."""
    rng = np.random.default_rng(SEED + 16)
    int32_max = np.iinfo(np.int32).max

    def on_card(a):
        return torch.as_tensor(a).to(dev)

    def twice(label, fn):
        return same_twice(label, lambda: {"out": fn()})["out"]

    # C10.
    P = 1000
    streams = []
    for n in (0, 1, 31, 32, 33, 1023, (1 << 20) + 7):
        keys = np.sort(np.where(rng.random(n) < 0.1, P,
                                (rng.random(n) ** 2 * P).astype(np.int64)))
        streams.append(on_card(keys.astype(np.int32)))
    streams.append(on_card(np.full(500, P, np.int32)))
    streams.append(on_card(np.array([0, 5, int32_max - 1, int32_max],
                                    np.int32)))
    cases = [(0, 128, 7, P), (0, 300, 3, 700), (5, 1, 0, P), (-40, 64, 20, P),
             (int32_max - 300, 128, 4, int32_max), (0, 1 << 20, 1, P)]
    for base, capacity, n_blocks, end in cases:
        label = (f"block_window_offsets[base={base}, capacity={capacity}, "
                 f"{n_blocks} blocks, end={end}]")
        for group in (streams[:1], streams[2:5], streams):
            got = twice(label, lambda: kernels.block_window_offsets(
                group, base, capacity, n_blocks, end))
            check_equal(label, got, kernels.block_window_offsets_plain(
                group, base, capacity, n_blocks, end))
        for j, t in enumerate(streams):
            bounds = kernels.block_window_boundaries(
                base, capacity, n_blocks, end, dev)
            check_equal(f"{label} stream {j} vs block_offsets", got[j],
                        kernels.block_offsets(t, bounds))
    many = [streams[j % len(streams)] for j in range(64)]
    got = twice("block_window_offsets[64 streams]",
                lambda: kernels.block_window_offsets(many, 0, 100, 11, P))
    check_equal("block_window_offsets[64 streams]", got,
                kernels.block_window_offsets_plain(many, 0, 100, 11, P))
    for t in streams:
        for bounds in (torch.arange(P + 1, dtype=torch.int32, device=dev),
                       on_card(np.array([-5, 0, P, P + 1, int32_max],
                                        np.int32))):
            check_equal("block_offsets[edges]",
                        twice("block_offsets[edges]",
                              lambda: kernels.block_offsets(t, bounds)),
                        kernels.block_offsets_plain(t, bounds))
    # C21: parts cut from one buffer a shard at an element offset, so
    # their addresses take every residue modulo 16 bytes.
    shapes = ((17_770,), (1,), (0,), (3,), (5, 2), (1000, 5), (17_771,),
              (4096,))
    dtypes = ((torch.int32, False), (torch.int64, False),
              (torch.float32, False), (torch.float64, False),
              (torch.float32, True))

    def values(dtype, n):
        if dtype == torch.int32:
            return on_card(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                           .astype(np.int32))
        if dtype == torch.int64:
            return on_card(rng.integers(-2**62, 2**62, n, dtype=np.int64))
        return on_card((rng.standard_normal(n) *
                        10.0**rng.integers(-3, 8, n))).to(dtype)

    def parts_of(d, dtype, shapes_, shift):
        out = []
        for s in range(d):
            sizes = [int(np.prod(sh)) for sh in shapes_]
            skew = (shift + s) % 4 if shift >= 0 else 0
            buf = values(dtype, sum(sizes) + skew)
            cols, at = [], skew
            for sh, size in zip(shapes_, sizes):
                cols.append(buf[at:at + size].view(sh))
                at += size
            out.append(cols)
        return out

    for d in (1, 2, 3, 5, 8, 32, 64):
        for dtype, comp in dtypes:
            # shift -1: every shard aligned alike (vector slots); 0: each
            # shard one element further (all-scalar columns).
            for shift in (-1, 0):
                parts = parts_of(d, dtype, shapes, shift)
                label = (f"combine_parts[D={d}, {str(dtype)[6:]}, "
                         f"compensated={comp}, shift={shift}]")
                got = same_twice(label, lambda: dict(enumerate(
                    kernels.combine_parts(parts, comp))))
                want = kernels.combine_parts_plain(parts, comp)
                for c, w in enumerate(want):
                    check_equal(f"{label} column {c}", got[c], w)
    # Alignment residues of shard 0's part against the output's, 40
    # columns (two groups at D = 4) and D x C past 256 (groups of 4
    # columns at D = 64).
    for d, n_cols in ((4, 40), (64, 9)):
        for skew in range(4):
            parts = parts_of(d, torch.float32, [(skew + 7 * c,)
                                                for c in range(n_cols)], -1)
            kernels.reset_launch_counts()
            got = kernels.combine_parts(parts)
            check_launches(f"combine_parts[D={d}, {n_cols} columns]",
                           dict(kernels.launch_counts), kernels,
                           dict(combine_parts=-(-n_cols // min(32, 256 // d))),
                           path=("combine_parts",))
            for c, w in enumerate(kernels.combine_parts_plain(parts)):
                check_equal(f"combine_parts[D={d}, {n_cols} columns] "
                            f"column {c}", got[c], w)
    for d in (1, 4, 64):
        for dtype, comp in dtypes:
            stack = values(dtype, d * 1001).view(d, 1001)
            check_equal(f"combine_shards[D={d}, {str(dtype)[6:]}, "
                        f"compensated={comp}]",
                        twice("combine_shards",
                              lambda: kernels.combine_shards(stack, comp)),
                        kernels.combine_shards_plain(stack, comp))
        ones = torch.ones(d, 1, dtype=torch.int32, device=dev)
        check_equal(f"heartbeat_sum[D={d}]", kernels.heartbeat_sum(ones),
                    kernels.combine_shards_plain(ones))
    torch.cuda.synchronize()
    print("kernels[C10 and C21 edges]: block_window_offsets over 1, 3, 9 "
          "and 64 streams of 0 to 2^20 + 7 rows (the sentinel, INT32_MAX, "
          "end below the last boundary, boundaries below every row), "
          "block_offsets at P + 1 starts; combine_parts at D = 1-64 over "
          "every dtype and the compensated entry, parts at every residue "
          "modulo 16 bytes, 40 columns and D x C past the table in groups; "
          "combine_shards and heartbeat_sum: each == its plain version and "
          "equal to itself run to run", flush=True)


def c5_c2_edge_phase(torch, dev, kernels):
    """C5's and C2's edge cases on the card, every output == its plain
    version and equal to itself over two calls (same_twice). C5, tiles of
    4096 rows: 1 row; 4095, 4097 and 2^16 + 7 rows; every row equal (no
    pass: the identity, sorted_top the word); a constant word 0 above
    varying words (sorted_top from row 0); a word whose varying bits make
    six runs (the narrowest gaps merged to 4); negative int32, int64,
    float32 and float64 keys over all their bits (sorted_top rebuilt from
    the packed key); sorted, reversed and three-valued keys (runs of equal
    digits in the histogram); four lanes under a lane word. C2, tiles of
    2048 rows, over random pid / pair runs: 1 row and 2049 rows; pairs and
    pids across tile edges; one pair of 5000 rows (past two tile edges)
    with pair-sum clipping, linf off and at 3000; a pid of 300 pairs cut
    by l0 = 64; selection (no columns); the lane entry at lanes of 2047
    and 3000 rows (lane starts inside tiles), two lanes holding the same
    keys side by side; the keyless lane entry; total_bound_rows and its
    lane entry over pids across tile edges and one pid of 5000 rows. Values
    are integers: every pair sum is exact in any order."""
    rng = np.random.default_rng(SEED + 17)
    m32 = 0xFFFFFFFF

    def on_card(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    # C5.
    passes = {}

    def sort_case(label, words):
        words = [on_card(w) for w in words]
        got = same_twice(label, lambda: dict(zip(
            ("perm", "top"), kernels.radix_sort(words, sorted_top=True))))
        want = kernels.radix_sort_plain(words, True)
        check_equal(f"{label} perm", got["perm"], want[0])
        check_equal(f"{label} sorted_top", got["top"], want[1])
        check_equal(f"{label} perm without sorted_top",
                    kernels.radix_sort(words), want[0])
        passes[label] = sort_passes(words)

    def keys64(n, bits=51):
        return rng.integers(0, 1 << bits, n, dtype=np.int64)

    def uniforms(n):
        return rng.random(n, dtype=np.float32)

    sort_case("1 row", [np.array([7], np.int32)])
    for n in (4095, 4097, (1 << 16) + 7):
        sort_case(f"{n} rows", [keys64(n), keys64(n, 47), uniforms(n)])
    sort_case("equal rows", [np.full(5000, 3, np.int32),
                             np.full(5000, 0.25, np.float32)])
    sort_case("constant word 0", [np.full(9000, -4, np.int64),
                                  rng.integers(-2**31, 2**31, 9000,
                                               dtype=np.int64).astype(
                                                   np.int32)])
    draw = rng.integers(0, 64, 20000)
    six = np.zeros(20000, np.int64)
    for j, b in enumerate((0, 3, 9, 20, 33, 50)):
        six |= ((draw >> j) & 1).astype(np.int64) << b
    sort_case("six runs", [six, uniforms(20000)])
    n = 10000
    signed = [rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32),
              rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
              (rng.standard_normal(n) * 1e3).astype(np.float32),
              rng.standard_normal(n)]
    sort_case("negative keys, int32 first", signed)
    sort_case("int64 first", signed[1:])
    sort_case("float32 first", signed[2:])
    sort_case("float64 first", signed[3:] + signed[:1])
    ordered = np.sort(rng.integers(0, 1 << 20, 50_000)).astype(np.int32)
    sort_case("sorted keys", [ordered])
    sort_case("reversed keys", [ordered[::-1]])
    sort_case("three values", [rng.integers(0, 3, 50_000).astype(np.int32),
                               uniforms(50_000)])
    lanes = np.repeat(np.arange(4, dtype=np.int32), 3000)
    sort_case("4 lanes", [lanes, keys64(12000), keys64(12000, 47),
                          uniforms(12000)])

    # C2: sorted streams of random (pid, pair) runs.
    P = 1000

    def runs(n_pids, long_pair=False, many_pairs=False, first_pid=0):
        pids, pks, lengths = [], [], []
        for pid in range(first_pid, first_pid + n_pids):
            n_pairs = int(rng.integers(1, 40))
            if many_pairs and pid == first_pid + 3:
                n_pairs = 300
            for pk in np.sort(rng.choice(P, n_pairs, replace=False)):
                pids.append(pid)
                pks.append(pk)
                lengths.append(int(rng.geometric(0.3)))
            if long_pair and pid == first_pid + 5:
                lengths[-1] = 5000
        return (np.repeat(pids, lengths).astype(np.int64),
                np.repeat(pks, lengths).astype(np.int64))

    def keyed(spid, spk):
        """(perm, k1, k2) whose rows in perm order carry the sorted keys;
        hash words zero, so a pair is its (pid, pk)."""
        n = len(spid)
        perm = rng.permutation(n)
        k1, k2 = np.empty(n, np.int64), np.empty(n, np.int64)
        k1[perm] = spid << 32
        k2[perm] = spk & m32
        return perm, k1, k2

    def row_data(n):
        return (rng.integers(0, 8, n).astype(np.float32),
                rng.random(n) < 0.9)

    cols = ("sum", "nsum", "nsum2")
    scal = (1.0, 6.0, 0.0, 9.0, 3.0)

    def outputs(out):
        key2, start, columns = out
        return {"key2": key2, "pair_start": start, **columns}

    def agree(label, fn, plain):
        got = same_twice(label, lambda: outputs(fn()))
        for name, want in outputs(plain()).items():
            check_equal(f"{label} {name}", got[name], want)

    def bound_case(label, keys, values, valid, **kw):
        perm, k1, k2 = (on_card(a) for a in keys)
        values, valid = on_card(values), on_card(valid)
        args = {"n_partitions": P, "scalars": scal, "columns": cols,
                "clip_per_value": True, **kw}
        if not args["columns"]:
            values = None
        agree(label,
              lambda: kernels.bound_rows(perm, k1, k2, None, values, valid,
                                         sorted_k1=k1[perm], **args),
              lambda: kernels.bound_rows_plain(perm, k1, k2, None, values,
                                               valid, **args))

    spid, spk = runs(600, long_pair=True, many_pairs=True)
    n = len(spid)
    keys = keyed(spid, spk)
    values, valid = row_data(n)
    for linf, l0, pair_sum in ((1, 64, False), (3, 64, True), (0, 0, True),
                               (3000, 64, True), (0, 64, False)):
        bound_case(f"bound_rows[{n} rows, linf={linf}, l0={l0}, "
                   f"pair_sum={pair_sum}]", keys, values, valid, linf=linf,
                   l0=l0, clip_pair_sum=pair_sum)
    bound_case(f"bound_rows[{n} rows, selection]", keys, values, valid,
               linf=0, l0=64, clip_pair_sum=False, columns=())
    for rows in (1, 2049):
        sub = keyed(spid[:rows], spk[:rows])
        bound_case(f"bound_rows[{rows} rows]", sub, values[:rows],
                   valid[:rows], linf=3, l0=4, clip_pair_sum=True)

    def lane_stream(lane_rows, n_lanes):
        """n_lanes lanes of lane_rows sorted rows; lane 1 repeats lane 0."""
        per = []
        while len(per) < n_lanes:
            s_pid, s_pk = runs(lane_rows // 16 + 10)
            lane = (s_pid[:lane_rows], s_pk[:lane_rows])
            per.append(lane)
            if len(per) == 1:
                per.append(lane)
        perm, k1, k2 = [], [], []
        for l, (a, b) in enumerate(per[:n_lanes]):
            p, x, y = keyed(a, b)
            perm.append(p + l * lane_rows)
            k1.append(x)
            k2.append(y)
        return tuple(np.concatenate(x) for x in (perm, k1, k2))

    for lane_rows in (2047, 3000):
        n_lanes = 4
        perm, k1, k2 = (on_card(a) for a in lane_stream(lane_rows, n_lanes))
        values, valid = (on_card(a) for a in row_data(lane_rows * n_lanes))
        pk = on_card(rng.integers(0, P, lane_rows * n_lanes).astype(np.int32))
        for keyless in (False, True):
            label = (f"bound_rows_lanes[{n_lanes} x {lane_rows}, "
                     f"keyless={keyless}]")
            ins = (None, None, None) if keyless else (perm, k1, k2)
            args = dict(lane_rows=lane_rows, n_partitions=P, linf=3, l0=4,
                        clip_per_value=True, clip_pair_sum=True,
                        scalars=scal, columns=cols,
                        pk=pk if keyless else None)
            agree(label,
                  lambda: kernels.bound_rows_lanes(*ins, values, valid,
                                                   **args),
                  lambda: kernels.bound_rows_lanes_plain(*ins, values, valid,
                                                         **args))

    # Total bound: sorted pid runs (one of 5000 rows), rows gathered
    # through a permutation.
    def pid_runs(n):
        lengths = rng.geometric(0.02, n // 40)
        lengths[7] = 5000
        spid = np.repeat(np.arange(len(lengths)), lengths)[:n]
        return np.pad(spid, (0, n - len(spid)),
                      constant_values=len(lengths)).astype(np.int32)

    n = 20000
    spid = on_card(pid_runs(n))
    perm = on_card(rng.permutation(n))
    pk = on_card(rng.integers(0, P, n).astype(np.int32))
    values, valid = (on_card(a) for a in row_data(n))
    for total_bound in (1, 64, 3000):
        label = f"total_bound_rows[{n} rows, K={total_bound}]"
        got = same_twice(label, lambda: dict(enumerate(
            kernels.total_bound_rows(perm, spid, pk, values, valid,
                                     total_bound=total_bound,
                                     n_partitions=P))))
        want = kernels.total_bound_rows_plain(perm, spid, pk, values, valid,
                                              total_bound=total_bound,
                                              n_partitions=P)
        for j, w in enumerate(want):
            check_equal(f"{label} output {j}", got[j], w)
    lane_rows, n_lanes = 5000, 4
    words = np.concatenate([(np.int64(l) << 32) | pid_runs(lane_rows)
                            for l in range(n_lanes)])
    words[lane_rows:2 * lane_rows] = words[:lane_rows] + (1 << 32)
    lperm = on_card(np.concatenate([rng.permutation(lane_rows) + l * lane_rows
                                    for l in range(n_lanes)]))
    lpk = on_card(rng.integers(0, P, lane_rows * n_lanes).astype(np.int32))
    lvalues, lvalid = (on_card(a) for a in row_data(lane_rows * n_lanes))
    label = f"total_bound_rows_lanes[{n_lanes} x {lane_rows}, K=64]"
    got = same_twice(label, lambda: dict(enumerate(
        kernels.total_bound_rows_lanes(
            lperm, on_card(words), lpk, lvalues, lvalid, lane_rows=lane_rows,
            total_bound=64, n_partitions=P))))
    want = kernels.total_bound_rows_lanes_plain(
        lperm, on_card(words), lpk, lvalues, lvalid, lane_rows=lane_rows,
        total_bound=64, n_partitions=P)
    for j, w in enumerate(want):
        check_equal(f"{label} output {j}", got[j], w)
    torch.cuda.synchronize()
    print("kernels[C5 and C2 edges]: C5 at 1, 4095, 4097 and 2^16 + 7 "
          "rows, equal rows, a constant word 0, six runs, negative and "
          "64-bit keys, sorted / reversed / three-valued keys, four lanes "
          f"(passes {json.dumps(passes)}); C2 over pairs and pids across "
          "tile edges, a pair of 5000 rows, l0 cutting 300 pairs, 1 and "
          "2049 rows, selection, lanes of 2047 and 3000 rows with two lanes "
          "alike, keyless lanes, the total bound and its lanes: each == its "
          "plain version and equal to itself run to run", flush=True)


def c12_c17_edge_phase(torch, dev, kernels, ingest):
    """C12's and C17's edge cases on the card, every output == its plain
    version and equal to itself over two calls (same_twice). C12 (blocks
    of 256 rows, scan tiles of 65,536 rows): 1 row (real, then the
    sentinel), 255 / 257 and 65,535 / 65,537 rows; one hash in every row;
    every row distinct, with the count hint exact, above it and absent; a
    hi lane of 0xffffffff with lo not, and the hash one below the
    sentinel, among sentinel rows; invalid rows claiming their slots;
    sentinel rows interleaved. A count hint too small for the table: the
    kernel's n_unique is -1, and ingest._finalize_hash_codes raises on it
    and on a count the table holds but that differs from the host's. C17
    (tiles of 2048 rows), from rows drawn in random order and sorted on the
    card (C5 with sorted_top): 1 and 7 rows, 2047 / 2048 / 2049 rows, pairs
    of 1-8 rows crossing tile edges, one pid of 12,000 rows over seven
    tiles, every row invalid, a valid row keyed (INT32_MAX, INT32_MAX)
    among the invalid ones; pair_sum bit for bit equal to the plain version
    on the CPU copy (torch's index_add_ there folds in row order) and to a
    numpy float32 fold in row order over every pair."""
    rng = np.random.default_rng(SEED + 18)
    m32, i32max = 0xFFFFFFFF, 2**31 - 1

    def on_card(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    def hash_rows(keys, valid=None):
        rows = np.empty((len(keys), 3), np.uint32)
        rows[:, 0] = keys >> np.uint64(32)
        rows[:, 1] = keys & np.uint64(m32)
        rows[:, 2] = 1 if valid is None else valid
        return rows

    def distinct(n):
        return rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2)

    def factorize_case(label, rows, hints=(None,)):
        rows = on_card(rows.view(np.int32))
        want, want_n = kernels.factorize_codes_plain(rows)
        for hint in hints:
            got = same_twice(f"{label}, hint {hint}", lambda: dict(zip(
                ("codes", "n_unique"),
                kernels.factorize_codes(rows, n_distinct=hint))))
            check_equal(f"factorize_codes ({label}, hint {hint})",
                        got["codes"], want)
            if int(got["n_unique"]) != int(want_n):
                raise AssertionError(f"factorize_codes ({label}, hint "
                                     f"{hint}): {int(got['n_unique'])} "
                                     f"distinct, plain {int(want_n)}")
        return int(want_n)

    sentinel = np.uint64(2**64 - 1)
    factorize_case("1 row", hash_rows(distinct(1)), (None, 1))
    factorize_case("1 sentinel row", hash_rows(np.array([sentinel])),
                   (None, 0))
    for n in (255, 257, 65535, 65537):
        keys = distinct(n // 3 + 1)[rng.integers(0, n // 3 + 1, n)]
        count = len(np.unique(keys))
        factorize_case(f"{n} rows", hash_rows(keys), (None, count))
    factorize_case("one hash", hash_rows(np.full(100_000, distinct(1)[0])),
                   (None, 1))
    keys = distinct(100_000)
    factorize_case("all distinct", hash_rows(keys), (None, 100_000, 150_000))
    edge = np.array([(np.uint64(m32) << np.uint64(32)) | np.uint64(5),
                     sentinel - np.uint64(1), sentinel, np.uint64(0)],
                    np.uint64)
    keys = edge[rng.integers(0, 4, 20_000)]
    keys[:4] = edge
    factorize_case("0xffffffff hi lane, sentinel - 1, 0", hash_rows(keys),
                   (None, 3))
    keys = distinct(5000)[rng.integers(0, 5000, 50_000)]
    keys[::7] = sentinel
    valid = (rng.random(50_000) < 0.7).astype(np.uint32)
    valid[::11] = 2
    count = factorize_case("invalid rows claim slots, sentinels interleaved",
                           hash_rows(keys, valid), (None,))
    factorize_case("invalid rows claim slots (hinted)",
                   hash_rows(keys, valid), (count, count + 1))
    # A count hint too small for the table: the kernel reports -1.
    rows = on_card(hash_rows(distinct(100_000)).view(np.int32))
    _, n_small = kernels.factorize_codes(rows, n_distinct=10)
    if int(n_small) != -1:
        raise AssertionError(f"factorize_codes with a hint of 10 for 100,000 "
                             f"distinct hashes gave n_unique "
                             f"{int(n_small)}, not -1")
    values = torch.zeros(rows.shape[0], device=dev)
    for host_count in (10, 100_001):
        try:
            ingest._finalize_hash_codes(rows, rows, values, True, [0],
                                        (None, None, host_count, None), None)
        except RuntimeError as err:
            print(f"kernels[C12 edges]: host count {host_count} for 100,000 "
                  f"distinct hashes raised: {err}", flush=True)
        else:
            raise AssertionError(f"_finalize_hash_codes with a host count "
                                 f"of {host_count} did not raise")

    # C17: rows in random order, sorted on the card.
    def pair_rows(n_pids, max_pair=8, long_pid=None):
        pids, pks, lengths = [], [], []
        for pid in range(n_pids):
            n_pairs = int(rng.integers(1, 12))
            if pid == long_pid:
                n_pairs = 2700
            for pk in rng.choice(5000, n_pairs, replace=False):
                pids.append(pid)
                pks.append(pk)
                lengths.append(int(rng.integers(1, max_pair + 1)))
        pid = np.repeat(pids, lengths).astype(np.int32)
        pk = np.repeat(pks, lengths).astype(np.int32)
        order = rng.permutation(len(pid))
        return pid[order], pk[order]

    folds = {"pairs": 0}

    def fold_check(label, pairs, perm, values):
        """pair_sum against a numpy float32 fold of each pair's rows in
        sorted order, from 0."""
        starts = np.nonzero(pairs["new_pair"].cpu().numpy())[0]
        lens = pairs["pair_len"].cpu().numpy()[starts]
        v = values.cpu().numpy()[perm.cpu().numpy()]
        got = pairs["pair_sum"].cpu().numpy()[starts]
        want = np.zeros(len(starts), np.float32)
        for k in range(int(lens.max(initial=0))):
            live = lens > k
            want[live] = want[live] + v[starts[live] + k]
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            raise AssertionError(f"group_stats_pairs ({label}) pair_sum: "
                                 f"{int((got != want).sum())} pairs differ "
                                 f"from a float32 fold in row order")
        folds["pairs"] += len(starts)

    def stats_case(label, pid, pk, valid):
        n = len(pid)
        values = (rng.standard_normal(n) * 100).astype(np.float32)
        pid, pk, values, valid = (on_card(a) for a in (pid, pk, values,
                                                        valid))
        sp, sk = kernels.sunk_keys(pid, valid), kernels.sunk_keys(pk, valid)
        perm, spid = kernels.radix_sort([sp, sk], sorted_top=True)
        got = same_twice(label, lambda: kernels.group_stats_pairs(
            pid, pk, values, valid, perm, sorted_pid=spid))
        cpu = [t.cpu() for t in (pid, pk, values, valid, perm)]
        want = kernels.group_stats_pairs_plain(*cpu)
        for name in kernels.PAIR_STATS:
            g, w = got[name].cpu(), want[name]
            if name == "pair_sum":  # bit for bit
                g, w = g.view(torch.int32), w.view(torch.int32)
            check_equal(f"group_stats_pairs ({label}) {name}", g, w)
        fold_check(label, got, perm, values)
        pair_pk, new_pair = got["pair_pk"], got["new_pair"]
        for what, keys, kvalid in (("pk", sk, valid),
                                   ("pair starts", pair_pk, new_pair)):
            kperm, skeys = kernels.radix_sort([keys], sorted_top=True)
            out = same_twice(f"{label} keys ({what})", lambda: dict(zip(
                ("new_seg", "seg_len"), kernels.group_stats_keys(
                    keys, kvalid, kperm, sorted_keys=skeys))))
            for name, w in zip(("new_seg", "seg_len"),
                               kernels.group_stats_keys_plain(
                                   keys, kvalid, kperm)):
                check_equal(f"group_stats_keys ({label}, {what}) {name}",
                            out[name], w)

    def some_invalid(n, p=0.1):
        return rng.random(n) >= p

    for n in (1, 7, 2047, 2048, 2049):
        pid, pk = pair_rows(n // 4 + 1)
        stats_case(f"{n} rows", pid[:n], pk[:n], some_invalid(n))
    pid, pk = pair_rows(3000)
    stats_case(f"{len(pid)} rows, pairs of 1-8 rows", pid, pk,
               some_invalid(len(pid)))
    pid, pk = pair_rows(40, long_pid=7)
    stats_case(f"{len(pid)} rows, one pid over many tiles", pid, pk,
               some_invalid(len(pid), 0.01))
    stats_case("every row invalid", pid[:5000], pk[:5000],
               np.zeros(5000, bool))
    pid, pk = pair_rows(600)
    pid[::97], pk[::97] = i32max, i32max
    stats_case("valid rows keyed INT32_MAX among invalid ones", pid, pk,
               some_invalid(len(pid), 0.2))
    # The card requires the sorted key.
    small = on_card(np.arange(8, dtype=np.int32))
    ok = on_card(np.ones(8, bool))
    sperm = on_card(np.arange(8))
    for fn in (lambda: kernels.group_stats_pairs(small, small, None, ok,
                                                 sperm),
               lambda: kernels.group_stats_keys(small, ok, sperm)):
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError("a C17 entry on the card ran without its "
                             "sorted key")
    torch.cuda.synchronize()
    print("kernels[C12 and C17 edges]: C12 at 1 row (real, sentinel), 255 / "
          "257 and 65,535 / 65,537 rows, one hash, every row distinct "
          "(hints exact, above, none), a 0xffffffff hi lane, the hash one "
          "below the sentinel, invalid rows claiming slots among "
          "sentinels; a too-small hint gives -1 and raises through "
          "_finalize_hash_codes, as does a wrong host count; C17 at 1, 7, "
          "2047, 2048, 2049 rows, pairs of 1-8 rows across tile edges, one "
          "pid over seven tiles, every row invalid, valid rows keyed "
          "INT32_MAX: each == its plain version and equal to itself run to "
          f"run, pair_sum bit-equal to a float32 fold in row order over "
          f"{folds['pairs']} pairs; both entries refuse the card without "
          "their sorted key", flush=True)


# ---------------------------------------------------------------------------
# C4 and C24: the three-way split of every entry, and their edge phase.

C4_LANES = 16
# (a)'s widest plan on the path: VARIANCE (count, sum, mean) on three slots
# and PRIVACY_ID_COUNT on the fourth, private selection.
C4_PLAN = [("variance", ("variance", "count", "sum", "mean"), 0),
           ("privacy_id_count", ("privacy_id_count",), 3)]
C4_STDS = (2.0, 5.0, 40.0, 1.5)
C4_SENS = (1.0, 2000.0, 4e6, 1.0)


def c4_columns(torch, dev, n, dtype, rng):
    """C3-shaped partition columns of n partitions: counts to 20,000,
    privacy-id counts at or below them, sums of ratings 1-5 on a grid of
    1/64, their normalised sums and squares."""
    count = rng.integers(0, 20000, n).astype(np.float64)
    pid = np.floor(count * rng.uniform(0.3, 1.0, n))
    total = np.round(count * rng.uniform(1.0, 5.0, n) * 64) / 64
    cols = {"count": count, "pid_count": pid, "sum": total,
            "nsum": total - 3.0 * count,
            "nsum2": np.round(count * rng.uniform(0.0, 4.0, n) * 64) / 64}
    out = {k: torch.as_tensor(v, dtype=dtype).to(dev)
           for k, v in cols.items()}
    out["row_count"] = out["pid_count"]
    return out


def c4_entries(torch, dev, kernels, executor, P=N_MOVIES, lanes=C4_LANES,
               dtype=None, seed=SEED + 19):
    """{entry: (kernel call, plain call, bytes, operations)} of C4's four
    entries at the main path's shapes: solo ((a)'s plan above, P = 17,770),
    secure (VARIANCE on three slots, public), lanes and secure lanes (the
    plan above in `lanes` lanes of P partitions, four slots + selection).
    Bytes: every column read once, keep and the outputs written once;
    operations: ~100 integer operations a threefry, two a secure draw."""
    from pipelinedp_tpu_torch.aggregate_params import (
        NoiseKind, PartitionSelectionStrategy)
    from pipelinedp_tpu_torch.ops import selection_ops
    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    sel = selection_ops.selection_params_from_host(
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-6, 64, None)
    G = NoiseKind.GAUSSIAN
    stds = np.array(C4_STDS)
    keys = rng.integers(0, 2**32, (4, 2), dtype=np.uint32)
    key_sel = rng.integers(0, 2**32, 2, dtype=np.uint32)
    lane_keys = rng.integers(0, 2**32, (lanes, 4, 2), dtype=np.uint32)
    lane_sel = rng.integers(0, 2**32, (lanes, 2), dtype=np.uint32)
    solo = c4_columns(torch, dev, P, dtype, rng)
    wide = c4_columns(torch, dev, lanes * P, dtype, rng)
    plan3 = [C4_PLAN[0]]
    stds3 = np.array([2.0, 900.0, 4.5e6])
    t3 = executor.build_secure_tables(stds3, np.array([1.0, 2000.0, 4e6]), G,
                                      None, dev)
    t4 = executor.build_secure_tables(stds, np.array(C4_SENS), G, None, dev)
    fsz = torch.tensor([], dtype=dtype).element_size()
    args = {
        "solo": ((solo, C4_PLAN, stds, keys, G, False, 3.0, 1.0, sel,
                  key_sel, 1), {}, P, 5 + 1),
        "secure": ((solo, plan3, stds3, keys[:3], G, False, 3000.0, 1000.0,
                    None, key_sel, 1), {"tables": t3}, P, 3 * 2),
        "lanes": ((wide, C4_PLAN, stds, lane_keys, G, False, 3.0, 1.0, sel,
                   lane_sel, 1, lanes), {}, lanes * P, 5 + 1),
        "secure lanes": ((wide, C4_PLAN, stds, lane_keys, G, False, 3.0,
                          1.0, sel, lane_sel, 1, lanes), {"tables": t4},
                         lanes * P, 4 * 2 + 1),
    }
    out = {}
    for name, (a, kw, n, draws) in args.items():
        fn = (kernels.release_epilogue if "lanes" not in name else
              kernels.release_epilogue_lanes)
        plain = (kernels.release_epilogue_plain if "lanes" not in name else
                 kernels.release_epilogue_lanes_plain)
        out[name] = (lambda f=fn, a=a, kw=kw: f(*a, **kw),
                     lambda f=plain, a=a, kw=kw: f(*a, **kw),
                     n * 5 * fsz + n * (1 + 5 * fsz), n * draws * 100)
    return out


def c24_inputs(torch, dev, users, device_encode, ingest):
    """The Netflix users' hash rows (2^24) split over card_mesh()'s four
    slots, their distinct count (the pod ingest's hint)."""
    mesh = card_mesh(torch)
    h1, _ = ingest.hash_key_column_pair(users)
    rows = torch.from_numpy(
        device_encode.pack_hash_rows(h1).view(np.int32)).to(dev)
    return mesh, sharded_hash_rows(mesh, rows), int(np.unique(users).size)


def c24_entries(torch, kernels, device_encode, mesh, hashes, hint):
    """{step: call} of the mesh factorize on shard 0 of `hashes`, and the
    whole mesh_factorize_codes call. This tree's steps: the local run
    (C12's table, no sort), the merge (C12 over the gathered
    [D x uniq_cap] slots) and the remap. A tree whose local phase sorts
    each shard with C5 (device_encode._sorted_shards, the parent tree's
    design) gives its steps instead: the shard's sort, the count-only and table runs of
    mesh_local_uniques, the merge with its two sorts and the remap, so the
    script compares the two trees in turns."""
    from pipelinedp_tpu_torch.parallel.mesh import round_capacity
    s0 = hashes.shards[0]
    local = s0.shape[0]
    if hasattr(device_encode, "_sorted_shards"):
        perms = device_encode._sorted_shards(hashes)
        cap = round_capacity(device_encode.mesh_unique_cap(mesh, hashes,
                                                           perms))
        p0 = perms[0]
        lseg = kernels.mesh_local_uniques(s0, p0, 0, cap)[0]
        tables = [kernels.mesh_local_uniques(sh, pm, s * local, cap)[2]
                  for s, (sh, pm) in enumerate(zip(hashes.shards, perms))]
        gathered = [torch.stack([t[j] for t in tables]).reshape(-1)
                    for j in range(3)]
        window = kernels.mesh_merge_ranks(*gathered)[0][:cap]
        words = [s0[:, 0].contiguous(), s0[:, 1].contiguous()]
        return cap, {
            "C5 shard sort": lambda: kernels.radix_sort(words),
            "mesh_local_uniques (count)":
                lambda: kernels.mesh_local_uniques(s0, p0, 0),
            "mesh_local_uniques (table)":
                lambda: kernels.mesh_local_uniques(s0, p0, 0, cap),
            "mesh_merge_ranks": lambda: kernels.mesh_merge_ranks(*gathered),
            "mesh_remap_rows":
                lambda: kernels.mesh_remap_rows(s0, p0, lseg, window),
            "mesh_factorize_codes":
                lambda: device_encode.mesh_factorize_codes(mesh, hashes)}
    runs = [kernels.mesh_local_uniques(sh, n_distinct=hint)
            for sh in hashes.shards]
    cap = round_capacity(max(int(r[1]) for r in runs))
    gathered = torch.cat([r[2][:cap] for r in runs])
    window = kernels.mesh_merge_ranks(gathered, n_distinct=hint)[0][:cap]
    lcode = runs[0][0]
    return cap, {
        "mesh_local_uniques":
            lambda: kernels.mesh_local_uniques(s0, n_distinct=hint),
        "mesh_merge_ranks":
            lambda: kernels.mesh_merge_ranks(gathered, n_distinct=hint),
        "mesh_remap_rows": lambda: kernels.mesh_remap_rows(lcode, window),
        "mesh_factorize_codes": lambda: device_encode.mesh_factorize_codes(
            mesh, hashes, n_distinct=hint)}


def c4_c24_split_phase(torch, dev, kernels, executor, device_encode, ingest,
                       users, card):
    """The three-way split (wrapper ms / device ms / host us, three_way) and
    the device operations a call (device_ops) of C4's four entries at the
    main path's shapes (c4_entries) and of the mesh factorize's steps on
    the Netflix user hashes over four slots (c24_entries; on a tree that
    still sorts its shards, its sort and two local runs). Runs on this
    tree and, for the comparison in turns, on its parent's package."""
    c4 = c4_entries(torch, dev, kernels, executor)
    for name, (fn, _, nbytes, ops) in c4.items():
        b_ms, b_by = bound(nbytes, ops)
        print(f"c4[{name}]: device operations a call "
              f"{json.dumps(device_ops(torch, fn))}, bound {b_ms:.3g} ms "
              f"({b_by})", flush=True)
    print_three_way("C4 entries at the main path's shapes", three_way(
        torch, {name: fn for name, (fn, *_) in c4.items()}, host_calls=200),
        card)
    mesh, hashes, hint = c24_inputs(torch, dev, users, device_encode, ingest)
    cap, steps = c24_entries(torch, kernels, device_encode, mesh, hashes,
                             hint)
    for name, fn in steps.items():
        if name != "mesh_factorize_codes":
            print(f"c24[{name}]: device operations a call "
                  f"{json.dumps(device_ops(torch, fn))}", flush=True)
    whole = steps.pop("mesh_factorize_codes")
    print_three_way(f"C24 steps on shard 0 of the Netflix user hashes "
                    f"(2^22 rows a slot, 4 slots, {hint} distinct, uniq_cap "
                    f"{cap})", three_way(torch, steps, host_calls=20), card)
    print(f"c24[mesh_factorize_codes]: {cuda_ms(whole, 5, 1):.4f} ms the "
          f"whole call (CUDA events, median of 5; its host fetches "
          f"included) ({card})", flush=True)
    del hashes, steps


def c4_edge_plan(n_slots):
    """A C4 plan of n_slots noise slots (1-8) with distinct outputs."""
    count = ("count", ("count",), 0)
    sum_ = ("sum", ("sum",), 1)
    pid = ("privacy_id_count", ("privacy_id_count",), 2)
    templates = {
        1: [count], 2: [count, sum_], 3: [("variance", ("variance",), 0)],
        4: [("variance", ("variance", "mean"), 0), ("privacy_id_count",
                                                    ("privacy_id_count",),
                                                    3)],
        5: [("mean", ("mean",), 0), ("variance", ("variance",), 2)],
        6: [count, ("mean", ("mean",), 1), ("variance", ("variance",), 3)],
        7: [count, sum_, ("mean", ("mean",), 2),
            ("variance", ("variance",), 4)],
        8: [count, sum_, pid, ("mean", ("mean",), 3),
            ("variance", ("variance",), 5)],
    }
    return templates[n_slots]


def c4_c24_edge_phase(torch, dev, kernels, executor, device_encode,
                      cuda_build):
    """C4's and C24's edge cases on the card, every output == its plain
    version and equal to itself over two calls (NaN equal to NaN). C4
    (tiles of 64 partitions): the Plan's size as the C entry states it; P
    = 1, 63, 64, 65, 255, 256, 257, 17,770, 135,104 and 135,169 (either
    side of the blocks of one thread a partition) in float32 and float64,
    with 1 to 8 noise slots, secure and not, Gaussian and Laplace, a
    degenerate variance, private selection that keeps nothing (no privacy
    ids) and one that keeps every partition (counts far past the
    threshold), NaN, Inf and huge columns (every flag bit); lanes of 1, 3,
    257 and 4000 partitions, 3 lanes (keys in the launch) and 40 lanes of
    8 slots (a key table past EPILOGUE_LANE_WORDS: one pinned copy), each
    lane == its solo run.
    C24 over card_mesh(): a shard of sentinel rows and one of invalid rows,
    one hash on every row, hashes first on a later shard, shards of 1 row,
    uniq_cap equal to every shard's n_new; each mesh_factorize_codes ==
    its plain versions == C12's codes, with the hint exact, above and
    absent, and a hint one too small raises."""
    from pipelinedp_tpu_torch.aggregate_params import (
        NoiseKind, PartitionSelectionStrategy)
    from pipelinedp_tpu_torch.ops import selection_ops
    from pipelinedp_tpu_torch.parallel.mesh import round_capacity
    import ctypes
    rng = np.random.default_rng(SEED + 19)
    plan_bytes = cuda_build.library(
        "release_epilogue").release_epilogue_plan_bytes()
    if plan_bytes != ctypes.sizeof(kernels._EpiloguePlan):
        raise AssertionError(f"release_epilogue: the C Plan has {plan_bytes} "
                             f"bytes, _EpiloguePlan "
                             f"{ctypes.sizeof(kernels._EpiloguePlan)}")
    geometric = selection_ops.selection_params_from_host(
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-6, 64, None)
    laplace_t = selection_ops.selection_params_from_host(
        PartitionSelectionStrategy.LAPLACE_THRESHOLDING, 1.0, 1e-6, 4, None)

    def as_dict(out):
        keep, outs, flags = out
        return dict(outs, keep=keep, flags=flags)

    def same(label, got, want):
        # == with NaN equal to NaN (a released NaN's payload is the
        # arithmetic's, not part of the function).
        if got.is_floating_point():
            if got.shape != want.shape or abs_diff(got, want) != 0.0 or \
                    not torch.equal(got.isnan(), want.isnan()):
                raise AssertionError(f"release_epilogue {label} differs")
        else:
            check_equal(f"release_epilogue {label}", got, want)

    def agree(label, fn, plain):
        got, again, want = as_dict(fn()), as_dict(fn()), as_dict(plain())
        if not set(got) == set(again) == set(want):
            raise AssertionError(f"release_epilogue {label}: outputs "
                                 f"{sorted(got)} vs {sorted(want)}")
        for name in want:
            same(f"{label} {name} (twice)", again[name], got[name])
            same(f"{label} {name}", got[name], want[name])
        return got

    cases = 0
    for dtype in (torch.float32, torch.float64):
        # 135,104 / 135,169 partitions: 2111 / 2113 tiles, either side of
        # the 64-thread blocks on a 132-SM card.
        for P in (1, 63, 64, 65, 255, 256, 257, N_MOVIES, 135_104, 135_169):
            for n_slots in range(1, 9):
                secure = n_slots % 2 == 0
                noise = (NoiseKind.GAUSSIAN if n_slots % 3 else
                         NoiseKind.LAPLACE)
                plan = c4_edge_plan(n_slots)
                cols = c4_columns(torch, dev, P, dtype, rng)
                stds = rng.uniform(0.5, 40.0, n_slots)
                keys = rng.integers(0, 2**32, (n_slots, 2), dtype=np.uint32)
                key_sel = rng.integers(0, 2**32, 2, dtype=np.uint32)
                sel = (None, geometric, laplace_t)[n_slots % 3]
                tables = (executor.build_secure_tables(
                    stds, np.ones(n_slots), noise, None, dev)
                    if secure else None)
                args = (cols, plan, stds, keys, noise, n_slots == 3, 2.5,
                        1.0, sel, key_sel, 1)
                agree(f"{dtype}, P={P}, {n_slots} slots, secure={secure}",
                      lambda: kernels.release_epilogue(*args, tables=tables),
                      lambda: kernels.release_epilogue_plain(
                          *args, tables=tables))
                cases += 1
        # Selection that keeps nothing, then every partition.
        plan = c4_edge_plan(4)
        stds = np.ones(4)
        keys = rng.integers(0, 2**32, (4, 2), dtype=np.uint32)
        for label, scale in (("keeps nothing", 0.0), ("keeps all", 1e7)):
            cols = c4_columns(torch, dev, N_MOVIES, dtype, rng)
            cols["pid_count"] = (cols["count"] + 1) * scale
            cols["row_count"] = cols["pid_count"]
            args = (cols, plan, stds, keys, NoiseKind.LAPLACE, False, 2.5,
                    1.0, laplace_t, keys[0], 1)
            keep = agree(f"{dtype} selection {label}",
                         lambda: kernels.release_epilogue(*args),
                         lambda: kernels.release_epilogue_plain(*args))["keep"]
            if int(keep.sum()) != (0 if scale == 0 else N_MOVIES):
                raise AssertionError(f"release_epilogue selection {label}: "
                                     f"{int(keep.sum())} kept")
        # NaN, Inf and huge columns: every flag bit, public partitions.
        cols = c4_columns(torch, dev, 300, dtype, rng)
        huge = torch.finfo(dtype).max / 1.5
        cols["count"][7] = float("nan")
        cols["pid_count"][100] = float("inf")
        cols["sum"][250] = huge
        args = (cols, c4_edge_plan(8), np.ones(8), rng.integers(
            0, 2**32, (8, 2), dtype=np.uint32), NoiseKind.LAPLACE, False,
            2.5, 1.0, None, None, 1)
        flags = agree(f"{dtype} non-finite columns",
                      lambda: kernels.release_epilogue(*args),
                      lambda: kernels.release_epilogue_plain(*args))["flags"]
        if int(flags[0]) != 7:
            raise AssertionError(f"release_epilogue flags {int(flags[0])}, "
                                 f"expected 7")
        # Lanes: 1 and 3 partitions a lane, 3 lanes (keys in the launch)
        # and 40 lanes of 8 slots (a pinned copy), secure and not.
        for n_lanes, P, n_slots in ((3, 1, 4), (3, 3, 5), (40, 3, 8),
                                    (40, 257, 8), (40, 4000, 8)):
            plan = c4_edge_plan(n_slots)
            stds = rng.uniform(0.5, 40.0, n_slots)
            lane_keys = rng.integers(0, 2**32, (n_lanes, n_slots, 2),
                                     dtype=np.uint32)
            lane_sel = rng.integers(0, 2**32, (n_lanes, 2), dtype=np.uint32)
            cols = c4_columns(torch, dev, n_lanes * P, dtype, rng)
            for secure in (False, True):
                tables = (executor.build_secure_tables(
                    stds, np.ones(n_slots), NoiseKind.GAUSSIAN, None, dev)
                    if secure else None)
                args = (cols, plan, stds, lane_keys, NoiseKind.GAUSSIAN,
                        False, 2.5, 1.0, geometric, lane_sel, 1, n_lanes)
                got = agree(f"{dtype} lanes {n_lanes} x {P}, {n_slots} "
                            f"slots, secure={secure}",
                            lambda: kernels.release_epilogue_lanes(
                                *args, tables=tables),
                            lambda: kernels.release_epilogue_lanes_plain(
                                *args, tables=tables))
                for l in (0, n_lanes - 1):
                    lane_cols = {k: c[l * P:(l + 1) * P]
                                 for k, c in cols.items()}
                    solo = as_dict(kernels.release_epilogue(
                        lane_cols, plan, stds, lane_keys[l],
                        NoiseKind.GAUSSIAN, False, 2.5, 1.0, geometric,
                        lane_sel[l], 1, tables=tables))
                    for name, value in solo.items():
                        part = (got[name][l:l + 1] if name == "flags" else
                                got[name][l * P:(l + 1) * P])
                        check_equal(f"release_epilogue lane {l} {name} vs "
                                    f"solo", part, value)
                cases += 1
    torch.cuda.synchronize()

    # C24 over card_mesh().
    mesh = card_mesh(torch)
    d = mesh.size
    m32 = 0xFFFFFFFF

    def rows_of(keys, valid=None):
        rows = np.empty((len(keys), 3), np.uint32)
        rows[:, 0] = keys >> np.uint64(32)
        rows[:, 1] = keys & np.uint64(m32)
        rows[:, 2] = 1 if valid is None else valid
        return rows

    local = 4096
    distinct = rng.integers(1, 2**63, 4 * local, dtype=np.uint64)
    sent_shard = np.full((local, 3), m32, np.uint32)
    mixed = rows_of(distinct[rng.integers(0, 900, 4 * local)])
    mixed[local:2 * local] = sent_shard
    mixed[2 * local:3 * local, 2] = 0
    later = rows_of(np.concatenate([
        distinct[rng.integers(0, 5, 2 * local)],
        distinct[rng.integers(0, 3000, 2 * local)]]))
    full_cap = rows_of(np.concatenate([distinct[s * 1000:s * 1000 + 24][
        rng.integers(0, 24, local)] for s in range(4)]))
    for s in range(4):  # every one of a shard's 24 hashes present
        full_cap[s * local:s * local + 24] = rows_of(
            distinct[s * 1000:s * 1000 + 24])
    c24_cases = {
        "a sentinel shard and an invalid shard": mixed,
        "one hash on every row": rows_of(np.full(4 * local, distinct[0])),
        "hashes first on a later shard": later,
        "shards of 1 row": rows_of(distinct[:4]),
        "uniq_cap equal to n_new": full_cap,
    }
    for label, rows in c24_cases.items():
        t = torch.from_numpy(rows.view(np.int32)).to(dev)
        hashes = sharded_hash_rows(mesh, t)
        want, n_want = kernels.factorize_codes_plain(t.cpu())
        n_want = int(n_want)
        if label == "uniq_cap equal to n_new":
            caps = [int(kernels.mesh_local_uniques(sh)[1])
                    for sh in hashes.shards]
            if caps != [24] * d or round_capacity(24) != 24:
                raise AssertionError(f"mesh factorize ({label}): shard "
                                     f"counts {caps}")
        with plain_mesh_factorize(kernels):
            plain, n_plain = device_encode.mesh_factorize_codes(
                mesh, hashes, n_distinct=n_want)
        def run(hint):
            codes, n = device_encode.mesh_factorize_codes(mesh, hashes,
                                                          n_distinct=hint)
            return {"codes": codes.global_rows(dev), "n": torch.tensor(n)}

        for hint in (n_want, n_want + 100, None):
            got = same_twice(f"mesh_factorize_codes ({label}, hint {hint})",
                             lambda h=hint: run(h))
            check_equal(f"mesh_factorize_codes ({label}, hint {hint}) vs "
                        f"its plain versions", got["codes"],
                        plain.global_rows(dev))
            check_equal(f"mesh_factorize_codes ({label}, hint {hint}) vs "
                        f"C12's plain version", got["codes"].cpu(), want)
            if int(got["n"]) != n_want or n_plain != n_want:
                raise AssertionError(f"mesh factorize ({label}): "
                                     f"{int(got['n'])} distinct, want "
                                     f"{n_want}")
        for sh in hashes.shards:
            for part, g, w in zip(("lcode", "n_new", "heads"),
                                  kernels.mesh_local_uniques(sh, n_want),
                                  kernels.mesh_local_uniques_plain(
                                      sh, n_want)):
                check_equal(f"mesh_local_uniques ({label}) {part}", g, w)
        # A hint one too small raises; so does one far too small, which
        # overflows the tables (C12's -1).
        for low in ({n_want - 1, n_want // 300} if n_want else ()):
            try:
                device_encode.mesh_factorize_codes(mesh, hashes,
                                                   n_distinct=low)
            except RuntimeError:
                continue
            raise AssertionError(f"mesh factorize ({label}): a hint of "
                                 f"{low} for {n_want} hashes did not raise")
        cases += 1
    torch.cuda.synchronize()
    print(f"kernels[C4 and C24 edges]: the Plan's {plan_bytes} bytes agree; "
          f"C4 at P = 1, 63, 64, 65, 255, 256, 257, 17,770, 135,104, 135,169 "
          f"(float32, float64) with 1-8 slots, secure and not, selection keeping "
          f"nothing and everything, NaN / Inf / huge columns (flags 7), "
          f"lanes of 1, 3, 257 and 4000 partitions in 3 and 40 lanes (each lane "
          f"== its solo run); C24 on {d} slots: a sentinel and an invalid "
          f"shard, one hash everywhere, hashes first on a later shard, "
          f"shards of 1 row, uniq_cap == n_new, hints exact / above / none, "
          f"a hint one too small raising: {cases} cases, each == its plain "
          f"version and equal to itself run to run", flush=True)


# ---------------------------------------------------------------------------
# C6 and C7: their edge phase and the three-way split of every entry.


def c6_columns(torch, dev, n, spec, gen):
    """Columns of n rows (a lane's rows first where n is L x P): spec is
    (count, dtype, widths), widths cycling over the columns."""
    count, dtype, widths = spec
    out = {}
    for j in range(count):
        w = widths[j % len(widths)]
        shape = (n,) if w == 1 else (n, w)
        out[f"c{j}"] = (torch.randn(shape, device=dev, generator=gen) *
                        1e4).to(dtype)
    return out


def c6_keep(torch, dev, n, pattern, gen):
    if pattern == "none":
        return torch.zeros(n, dtype=torch.bool, device=dev)
    if pattern == "all":
        return torch.ones(n, dtype=torch.bool, device=dev)
    if pattern == "alternating":
        return torch.arange(n, device=dev) % 2 == 0
    return torch.rand(n, device=dev, generator=gen) < 0.4


def c7_stream(torch, dev, rng, n, key_lo, key_hi, gathered=True,
              shuffled=False):
    """n partition-sorted rows (skey2 in [key_lo, key_hi)), their values
    reached through perm and row_perm (gathered) or in sorted order;
    shuffled: rows out of order (the kernel's fallback)."""
    key = np.sort(rng.integers(key_lo, key_hi, n)).astype(np.int32)
    if shuffled:
        key = rng.permutation(key)
    values = np.where(rng.random(n) < 0.6, rng.integers(1, 6, n) * 1.0,
                      rng.uniform(0.0, 6.0, n)).astype(np.float32)
    skey2 = torch.as_tensor(key).to(dev)
    if not gathered:
        return skey2, None, None, torch.as_tensor(values).to(dev)
    return (skey2, torch.as_tensor(rng.permutation(n)).to(dev),
            torch.as_tensor(rng.permutation(n)).to(dev),
            torch.as_tensor(values).to(dev))


def c7_descent(torch, kernels, stream, P, n_q, base, check, h=4, B=16,
               seed=0):
    """The h child-count levels of one stream with its leaf buffer, each
    level's node a populated child of the last (argmax, ties to the
    lowest); check(label, got, want) at every level against the plain
    version with its own buffer, the level called twice. Returns the
    kernel's counts of each level."""
    dev = stream[0].device
    n = stream[0].shape[0]
    tree = dict(tree_height=h, branching=B, min_v=0.0, max_v=6.0, base=base)
    node = torch.zeros(P, n_q, dtype=torch.int32, device=dev)
    leaf_k = torch.full((n,), 7, dtype=torch.int32, device=dev)
    leaf_p = torch.full((n,), 7, dtype=torch.int32, device=dev)
    out = []
    for level in range(1, h + 1):
        got = kernels.quantile_child_counts(*stream, node, level=level,
                                            leaf=leaf_k, **tree)
        again = kernels.quantile_child_counts(*stream, node, level=level,
                                              leaf=leaf_k, **tree)
        want = kernels.quantile_child_counts_plain(*stream, node,
                                                   level=level, leaf=leaf_p,
                                                   **tree)
        check(f"level {level}", got, want)
        check(f"level {level} twice", again, got)
        if level == 1:
            check("leaf buffer", leaf_k, leaf_p)
        out.append(got)
        node = (node * B + got.argmax(-1).to(torch.int32)).contiguous()
    return out


def c6_c7_edge_phase(torch, dev, kernels):
    """C6's and C7's edge cases on the card, every output == its plain
    version and equal to itself over two calls. C6 (one cooperative launch
    over tiles of 2048 partitions, a run of tiles a block): P = 1, a tile
    less one, a tile, a tile and one, 17,770, the grid's edge (as many
    tiles as the card holds blocks, and one more: runs of two), 2^21 and
    2^24 (runs past the 8 tiles whose ballots a block keeps); keep none,
    all, alternating and random; 0, 1, 32 and 33 columns, widths 1 and D =
    5, 4- and 8-byte columns; lanes 1 x 17,770, 16 x 17,770 and 40 x 4000.
    C7's child counts with the leaf buffer at every level (level 1 fills
    it, 2..4 read it): the solo entry (2^20 rows, 17,770 partitions, a
    tenth past them), the windowed entry (base 2^20, perm None, rows on
    both sides of the window), the lanes' single range (16 x 17,770) and
    rows out of order (the global fallback), 3 quantiles and 49 (tiles
    whose counts do not fit shared memory)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    rng = np.random.default_rng(SEED + 20)
    tile = kernels.COMPACT_TILE
    edge = kernels._compact_max_blocks(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        4) * tile
    f32, f64, i32, i64 = torch.float32, torch.float64, torch.int32, \
        torch.int64
    small = [(0, f32, (1,)), (1, f32, (1,)), (32, f32, (1,)),
             (33, f64, (1, 1, 5)), (2, i32, (1, 5)), (3, i64, (5,))]
    large = [(5, f32, (1,)), (1, f64, (5,))]
    cases = 0

    def agree(label, fn, plain):
        got, again, want = fn(), fn(), plain()
        for part, a, b, c in (("n_kept", got[0], again[0], want[0]),
                              ("order", got[1], again[1], want[1])):
            check_equal(f"compact_kept {label} {part}", a, c.to(a.dtype))
            check_equal(f"compact_kept {label} {part} twice", b, a)
        for name in want[2]:
            check_equal(f"compact_kept {label} {name}", got[2][name],
                        want[2][name])
            check_equal(f"compact_kept {label} {name} twice",
                        again[2][name], got[2][name])

    for P in (1, tile - 1, tile, tile + 1, N_MOVIES, edge, edge + tile,
              1 << 21, 1 << 24):
        specs = small if P <= N_MOVIES else large[:1 if P > 1 << 21 else 2]
        for pattern in ("none", "all", "alternating", "random"):
            if P > N_MOVIES and pattern in ("none", "all"):
                continue
            keep = c6_keep(torch, dev, P, pattern, gen)
            for spec in specs:
                cols = c6_columns(torch, dev, P, spec, gen)
                agree(f"P={P} keep {pattern} {spec[0]} x {spec[1]}",
                      lambda: kernels.compact_kept(keep, cols),
                      lambda: kernels.compact_kept_plain(keep, cols))
                cases += 1
                del cols
            del keep
    for L, P in ((1, N_MOVIES), (16, N_MOVIES), (40, 4000)):
        for pattern in ("random", "alternating", "none"):
            keep = c6_keep(torch, dev, L * P, pattern, gen).reshape(L, P)
            for spec in (small[0], large[0], small[3]):
                cols = {k: v.reshape(L, P, *v.shape[1:]) for k, v in
                        c6_columns(torch, dev, L * P, spec, gen).items()}
                agree(f"lanes {L} x {P} keep {pattern} {spec[0]} x "
                      f"{spec[1]}",
                      lambda: kernels.compact_kept_lanes(keep, cols, L),
                      lambda: kernels.compact_kept_lanes_plain(keep, cols,
                                                               L))
                cases += 1
    torch.cuda.synchronize()

    def check(label):
        return lambda what, got, want: check_equal(
            f"quantile_child_counts {label} {what}", got, want)

    n = 1 << 20
    c7_cases = {
        "solo": (c7_stream(torch, dev, rng, n, 0, N_MOVIES + N_MOVIES // 10),
                 N_MOVIES, 3, None),
        "windowed": (c7_stream(torch, dev, rng, n, (1 << 20) - 5000,
                               (1 << 21) + 5000, gathered=False),
                     1 << 20, 3, 1 << 20),
        "lanes 16 x 17,770": (c7_stream(torch, dev, rng, n, 0,
                                        16 * N_MOVIES + 1), 16 * N_MOVIES, 3,
                              None),
        "out of order": (c7_stream(torch, dev, rng, n, 0, N_MOVIES + 1,
                                   shuffled=True), N_MOVIES, 3, None),
        "49 quantiles": (c7_stream(torch, dev, rng, n, 0, N_MOVIES + 1),
                         N_MOVIES, 49, None),
    }
    for label, (stream, P, n_q, base) in c7_cases.items():
        c7_descent(torch, kernels, stream, P, n_q, base, check(label))
        cases += 1
    torch.cuda.synchronize()
    print(f"kernels[C6 and C7 edges]: C6 at P = 1, {tile - 1}, {tile}, "
          f"{tile + 1}, 17,770, {edge} and {edge + tile} (the grid's edge), "
          f"2^21 and 2^24, keep none / all / alternating / random, 0, 1, "
          f"32 and 33 columns, widths 1 and 5, 4- and 8-byte columns, "
          f"lanes 1 x 17,770, 16 x 17,770 and 40 x 4000; C7's child counts "
          f"at every level with the leaf buffer (solo, windowed, lanes, "
          f"rows out of order, 49 quantiles): {cases} cases, each == its "
          f"plain version and equal to itself run to run", flush=True)


def c6_c7_split_phase(torch, dev, kernels, card):
    """The three-way split (three_way) and the device operations a call
    (device_ops) of C6's entries at the main path's shapes (P = 17,770 and
    2^21 with (a)'s five float32 columns, half kept; lanes 16 x 17,770)
    and of C7's child counts at (f)'s shape (2^24 rows over 17,770 movies,
    a tenth bounded away, 3 quantiles, B = 16, h = 4), the windowed entry
    on a block of 2^20 partitions (3,355,443 rows) and the lanes' single
    range (16 x 17,770 partitions, 2^24 rows): each level and the
    descent's four passes together. On a tree whose C7 takes no leaf
    buffer (the parent's), every level gathers. Run by --splits."""
    import inspect
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rng = np.random.default_rng(SEED + 21)
    entries = {}
    for label, L, P in (("solo P=17,770", 1, N_MOVIES),
                        ("solo P=2^21", 1, 1 << 21),
                        ("lanes 16 x 17,770", 16, N_MOVIES)):
        keep = c6_keep(torch, dev, L * P, "random", gen)
        cols = c6_columns(torch, dev, L * P, (5, torch.float32, (1,)), gen)
        if L == 1:
            entries[label] = (lambda k=keep, c=cols:
                              kernels.compact_kept(k, c))
        else:
            keep = keep.reshape(L, P)
            cols = {k: v.reshape(L, P) for k, v in cols.items()}
            entries[label] = (lambda k=keep, c=cols, n=L:
                              kernels.compact_kept_lanes(k, c, n))
        b_ms, b_by = bound(L * P * (1 + 5 * 4) + L * P * (8 + 5 * 4) + 8 * L,
                           L * P * 10)
        # One device operation a call on this tree (a trace that comes
        # back empty is taken again, up to three times); a parent's tile
        # scan shows its launches and memsets.
        for _ in range(3):
            ops = device_ops(torch, entries[label])
            if ops != "not traced":
                break
        if hasattr(kernels, "compact_kept_grid") and ops != "not traced" \
                and ops["total"] != 1:
            raise AssertionError(f"compact_kept {label}: {ops}")
        print(f"c6[{label}]: device operations a call {json.dumps(ops)}, "
              f"bound {b_ms:.3g} ms ({b_by})", flush=True)
    print_three_way("C6 entries at the main path's shapes",
                    three_way(torch, entries, host_calls=200), card)
    del entries
    buffered = "leaf" in inspect.signature(
        kernels.quantile_child_counts).parameters
    n = N_ROWS
    shapes = {
        "(f)": (c7_stream(torch, dev, rng, n, 0, N_MOVIES + N_MOVIES // 9),
                N_MOVIES, None),
        "windowed block of 2^20": (c7_stream(
            torch, dev, rng, n // 5, (1 << 20) - 50, (1 << 21) + 50),
            1 << 20, 1 << 20),
        "lanes 16 x 17,770": (c7_stream(torch, dev, rng, n, 0,
                                        16 * N_MOVIES + 1), 16 * N_MOVIES,
                              None),
    }
    for label, (stream, P, base) in shapes.items():
        nodes = []
        counts = c7_descent(torch, kernels, stream, P, 3, base,
                            lambda *a: None) if buffered else None
        node = torch.zeros(P, 3, dtype=torch.int32, device=dev)
        for level in range(1, 5):
            nodes.append(node)
            if counts is None:
                got = kernels.quantile_child_counts(
                    *stream, node, level=level, tree_height=4, branching=16,
                    min_v=0.0, max_v=6.0, base=base)
            else:
                got = counts[level - 1]
            node = (node * 16 + got.argmax(-1).to(torch.int32)).contiguous()
        leaf = (torch.empty(stream[0].shape[0], dtype=torch.int32,
                            device=dev) if buffered else None)
        extra = {"leaf": leaf} if buffered else {}

        def level_fn(level, extra=extra, stream=stream, base=base,
                     nodes=nodes):
            return lambda: kernels.quantile_child_counts(
                *stream, nodes[level - 1], level=level, tree_height=4,
                branching=16, min_v=0.0, max_v=6.0, base=base, **extra)

        def descent(level_fn=level_fn):
            for level in range(1, 5):
                level_fn(level)()

        descent()  # level 1 fills the buffer the others read
        fns = {"4 levels": descent}
        fns.update({f"level {level}": level_fn(level)
                    for level in range(1, 5)})
        if label == "(f)":
            for level in (1, 2):
                print(f"c7[{label} level {level}]: device operations a call "
                      f"{json.dumps(device_ops(torch, level_fn(level)))}",
                      flush=True)
        print_three_way(f"C7 child counts, {label} ({stream[0].shape[0]} "
                        f"rows, {'leaf buffer' if buffered else 'gathered'})",
                        three_way(torch, fns, host_calls=50), card)
        del stream, nodes, leaf


def c22_one_destination_pids(torch, dev, kernels, n, d, gen):
    """n pids that C22 sends to destination 0 of d (salt 0)."""
    out = [torch.empty(0, dtype=torch.int32, device=dev)]
    while sum(t.shape[0] for t in out) < n:
        cand = torch.randint(0, 1 << 31, (4 * n + 64,), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
        out.append(cand[kernels.dest_shard(cand, d, 0) == 0])
    return torch.cat(out)[:n]


def c22_c23_rows(torch, dev, kernels, n, d, pattern, gen, pid_at=0,
                 valid_at=None):
    """pid and valid of n rows as views `pid_at` / `valid_at` elements into
    larger buffers: pattern "random" (ids over 2n + 1, 9 in 10 valid),
    "invalid" (no row valid) or "one" (every row valid, every id to
    destination 0)."""
    valid_at = pid_at if valid_at is None else valid_at
    if pattern == "one":
        pid = c22_one_destination_pids(torch, dev, kernels, n, d, gen)
    else:
        pid = torch.randint(0, 2 * n + 1, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    if pattern == "invalid":
        valid = torch.zeros(n, dtype=torch.bool, device=dev)
    elif pattern == "one":
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        valid = torch.rand(n, generator=gen, device=dev) < 0.9
    pid_buf = torch.empty(n + pid_at, dtype=torch.int32, device=dev)
    valid_buf = torch.empty(n + valid_at, dtype=torch.bool, device=dev)
    pid_buf[pid_at:] = pid
    valid_buf[valid_at:] = valid
    return pid_buf[pid_at:], valid_buf[valid_at:]


def c23_buffers(torch, dev, cap, values, at):
    """(pid, pk, values, valid) receive columns of cap rows, views `at`
    elements into their buffers, filled with a pattern the exchange must
    leave where it writes nothing."""
    def view(t):
        return t[at:]
    pid = view(torch.full((cap + at,), -7, dtype=torch.int32, device=dev))
    pk = view(torch.full((cap + at,), -9, dtype=torch.int32, device=dev))
    valid = view(torch.arange(cap + at, device=dev) % 3 == 0)
    vals = None
    if values is not None:
        vals = view(torch.full((cap + at,) + tuple(values.shape[1:]), -3.5,
                               dtype=values.dtype, device=dev))
    return pid, pk, vals, valid


def c23_case(torch, dev, kernels, pid, valid, d, values, kind, fill_at,
             target_at, gen, rng):
    """C23 on one source against its plain version, twice: the targets are
    the destinations' own columns (kind "own": rng offsets before the run,
    slack after it, the source's own receive buffer also its fill) or
    staged slices of count rows at offset 0 (kind "staged", a separate
    fill buffer); fill_at "start" fills from 0 (a buffer that receives
    nothing), "end" fills nothing, "recv" from the received rows on."""
    n = pid.shape[0]
    dest, rank, counts = kernels.reshard_count(pid, valid, d)
    counts = counts.cpu().numpy()
    pk = torch.randint(-5, 1 << 20, (n + 1,), generator=gen, device=dev,
                       dtype=torch.int32)[1:]
    before = rng.integers(0, 6, d) if kind == "own" else np.zeros(d, int)
    after = rng.integers(0, 9, d) if kind == "own" else np.zeros(d, int)
    caps = before + counts[:d] + after
    recv = int(before[0] + counts[0] + after[0])
    out_cap = recv + int(rng.integers(0, 7000))

    def build():
        outs = [c23_buffers(torch, dev, int(caps[t]) if (t or kind !=
                                                        "own") else out_cap,
                            values, target_at) for t in range(d)]
        if kind == "own":
            start = {"start": 0, "end": out_cap, "recv": recv}[fill_at]
            if fill_at == "start":
                fill = c23_buffers(torch, dev, out_cap, values, target_at)
            else:
                fill = outs[0]
        else:
            fill = c23_buffers(torch, dev, out_cap, values, target_at)
            start = {"start": 0, "end": out_cap, "recv": recv}[fill_at]
        targets = [outs[t] + (int(before[t]),) for t in range(d)]
        return targets, fill + (start,)

    runs = []
    for exchange in (kernels.reshard_exchange, kernels.reshard_exchange_plain,
                     kernels.reshard_exchange):
        targets, fill = build()
        exchange(pid, pk, values, dest, rank, targets, fill)
        runs.append([c for t in targets for c in t[:4]] + list(fill[:4]))
    torch.cuda.synchronize()
    for j, (got, want, again) in enumerate(zip(*runs)):
        if got is None:
            continue
        check_equal(f"reshard_exchange column {j}", got, want)
        check_equal(f"reshard_exchange column {j} twice", again, got)


def c22_c23_edge_phase(torch, dev, kernels):
    """C22's and C23's edge cases on the card, every output == its plain
    version and equal to itself over two calls. C22 (one pass over tiles
    of RESHARD_TILE rows, a look-back a bucket) at D = 1, 2, 3, 4, 8
    (ballots), 32 and 64 (__match_any_sync): 0 rows, 1, a tile less one,
    a tile, a tile and one and 150 tiles and 77 rows (a look-back over
    more than 100 tiles); ids at random, no row valid, every row to one
    destination; pid views 1, 2 and 3 rows into their buffers, and valid
    out of pid's phase. C23 (one launch: tiles of EXCHANGE_TILE rows staged
    in shared memory, the padding from blocks past them) at D = 1, 2, 3,
    4, 8 and 32 on the same sizes (but the long run: C23 has no
    look-back) and C23's own tile edges: no values,
    float32 and float64 [n] and [n, 5] (staged in shared memory) and
    float64 [n, 7] (read in place), the destinations' own columns and
    staged slices, views 1-3 elements into their buffers, the fill from
    0, from the received rows and none."""
    from pipelinedp_tpu_torch import cuda_build
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    rng = np.random.default_rng(SEED + 22)
    t22, t23 = cuda_build.RESHARD_TILE, cuda_build.EXCHANGE_TILE
    long_run = 150 * t22 + 77
    sizes = (0, 1, t22 - 1, t22, t22 + 1, long_run)
    c22 = c23 = 0

    def count_agrees(label, pid, valid, d):
        got, again = (kernels.reshard_count(pid, valid, d) for _ in
                      range(2))
        want = kernels.reshard_count_plain(pid, valid, d)
        for what, a, b, c in zip(("dest", "rank", "counts"), got, again,
                                 want):
            check_equal(f"reshard_count {label} {what}", a, c)
            check_equal(f"reshard_count {label} {what} twice", b, a)

    for d in (1, 2, 3, 4, 8, 32, 64):
        for n in sizes:
            views = [("random", 0, None), ("invalid", 0, None),
                     ("one", 0, None)]
            if n:
                views += [("random", 1, None), ("random", 2, None),
                          ("random", 3, None), ("random", 1, 2)]
            for pattern, pid_at, valid_at in views:
                pid, valid = c22_c23_rows(torch, dev, kernels, n, d, pattern,
                                          gen, pid_at, valid_at)
                count_agrees(f"D={d} n={n} {pattern} pid+{pid_at} valid+"
                             f"{pid_at if valid_at is None else valid_at}",
                             pid, valid, d)
                c22 += 1
    torch.cuda.synchronize()
    f32, f64 = torch.float32, torch.float64
    # [n, 7] float64 rows (56 B) are wider than C23 stages: read in place.
    value_kinds = (None, (f32, ()), (f64, ()), (f32, (5,)), (f64, (5,)),
                   (f64, (7,)))
    # C23 has no look-back: its own tile edges and C22's, no long run.
    for d in (1, 2, 3, 4, 8, 32):
        for n in sorted(set(sizes[:-1] + (t23 - 1, t23, t23 + 1))):
            for j, spec in enumerate(value_kinds):
                pattern = ("random", "random", "one", "invalid",
                           "random", "random")[j] if n else "random"
                pid, valid = c22_c23_rows(torch, dev, kernels, n, d, pattern,
                                          gen, j % 4)
                values = None
                if spec is not None:
                    values = torch.randn((n + 1,) + spec[1], generator=gen,
                                         device=dev, dtype=spec[0])[1:] \
                        if j % 2 else torch.randn(
                            (n,) + spec[1], generator=gen, device=dev,
                            dtype=spec[0])
                c23_case(torch, dev, kernels, pid, valid, d, values,
                         ("own", "staged")[j % 2],
                         ("recv", "start", "end")[(j + d) % 3], (j * 3) % 4,
                         gen, rng)
                c23 += 1
    torch.cuda.synchronize()
    print(f"kernels[C22 and C23 edges]: C22 at D = 1, 2, 3, 4, 8, 32 and "
          f"64, n = {', '.join(str(n) for n in sizes)} (tiles of {t22}), "
          f"ids at random / no row valid / one destination, views 1-3 "
          f"rows in and valid out of pid's phase: {c22} cases; C23 at D = "
          f"1, 2, 3, 4, 8 and 32 on those sizes but the last and "
          f"{t23 - 1}, {t23}, "
          f"{t23 + 1} (tiles of {t23}), no values / float32 / float64, "
          f"[n], [n, 5] and [n, 7], own columns and staged slices, views 0-3 "
          f"elements in, fill from 0 / from the received rows / none: "
          f"{c23} cases; each == its plain version and equal to itself run "
          f"to run", flush=True)


def c22_c23_split_phase(torch, dev, kernels, users, card):
    """The three-way split (three_way) and the device operations a call
    (device_ops) of C22 and C23 on one shard of the 2^24 Netflix rows on 4
    slots (2^22 rows, the users as pids, every row valid), V = 1 and 5
    float32, each held == its plain version first. On this tree C23 is one
    device operation a call and C22 at most two (the status words' memset
    and the kernel). Run by --splits."""
    n, d = N_ROWS // 4, 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    pid = torch.as_tensor(users[:n].astype(np.int32)).to(dev)
    pk = torch.randint(0, N_MOVIES, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    dest, rank, counts = kernels.reshard_count(pid, valid, d)
    for got, want in zip((dest, rank, counts),
                         kernels.reshard_count_plain(pid, valid, d)):
        check_equal("reshard_count split shard", got, want)
    counts = counts.cpu().numpy()
    out_cap = round_up(int(counts[:d].max()), 1 << 12)
    fns = {"C22 reshard_count": lambda: kernels.reshard_count(pid, valid,
                                                              d)}
    bounds = {"C22 reshard_count": bound(n * (4 + 1 + 4 + 4), n * 40)}
    for width in (1, 5):
        vals = torch.rand((n,) if width == 1 else (n, width), generator=gen,
                          device=dev)
        made = []
        for _ in range(2):
            outs = [reshard_rows(torch, dev, out_cap, vals) for _ in
                    range(d)]
            made.append(([o + (0,) for o in outs],
                         outs[0] + (int(counts[0]),)))
        kernels.reshard_exchange(pid, pk, vals, dest, rank, *made[0])
        kernels.reshard_exchange_plain(pid, pk, vals, dest, rank, *made[1])
        for j in range(d):
            for c in range(4):
                check_equal(f"reshard_exchange split V={width}",
                            made[0][0][j][c], made[1][0][j][c])
        pad = out_cap - int(counts[0])
        name = f"C23 reshard_exchange V={width}"
        fns[name] = (lambda v=vals, m=made[0]:
                     kernels.reshard_exchange(pid, pk, v, dest, rank, *m))
        bounds[name] = bound(n * 8 + n * (4 + 4 + 4 * width) * 2 + n +
                             pad * (4 + 4 + 4 * width + 1), n)
    rebuilt = hasattr(kernels, "reshard_count_plan")
    for name, fn in fns.items():
        for _ in range(3):
            ops = device_ops(torch, fn)
            if ops != "not traced":
                break
        most = 2 if name.startswith("C22") else 1
        if rebuilt and ops != "not traced" and ops["total"] > most:
            raise AssertionError(f"{name}: {ops}")
        b_ms, b_by = bounds[name]
        print(f"c22_c23[{name}, {n} rows, D={d}]: device operations a call "
              f"{json.dumps(ops)}, bound {b_ms:.4f} ms ({b_by})", flush=True)
    fns["torch.bincount (C22's yardstick)"] = lambda: torch.bincount(
        dest.long(), minlength=d + 1)
    print_three_way(f"C22 and C23, one shard of 2^24 rows on {d} slots",
                    three_way(torch, fns, host_calls=200), card)


def c20_edge_inputs(torch, dev, f, K, P, M, public, sizes, rng, sel_rows):
    """C20's arguments for one edge case (seeded numpy draws): n_users 1 to
    3000 privacy ids, sizes as given, statistics whose raw sums are at
    least 1, Poisson-binomial moments mu = n_users x a keep fraction (one
    partition in eight with var 0 and a half-integer mu: rint), noise stds
    1-50 and the selector rows sel_rows [8, >= K]."""
    from pipelinedp_tpu_torch.analysis import kernels as ak
    users = rng.integers(1, 3001, P).astype(np.float64)
    raw = users[None, :, None] * rng.uniform(1.0, 5.0, (K, P, M))
    stats = np.stack([np.round(raw), -0.1 * raw * rng.random((K, P, M)),
                      -0.1 * raw * rng.random((K, P, M)),
                      -0.2 * raw * rng.random((K, P, M)),
                      raw * rng.random((K, P, M))], -1)
    frac = rng.uniform(0.05, 1.0, (K, P))
    mu = users[None, :] * frac
    var = mu * (1.0 - frac) * rng.uniform(0.2, 1.0, (K, P))
    third = var * rng.uniform(-0.5, 0.5, (K, P))
    degenerate = rng.random((K, P)) < 0.125
    mu = np.where(degenerate, np.floor(mu) + 0.5, mu)
    var = np.where(degenerate, 0.0, var)
    sel = np.stack([mu, var, third], -1)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=f, device=dev)

    return (t(stats), None if public else t(sel), t(users),
            t(sizes), t(rng.uniform(1.0, 50.0, (K, M))),
            t(sel_rows[:, :K]),
            torch.tensor(ak.BUCKET_BOUNDS, dtype=f, device=dev))


def c20_selectors(tdp, K):
    """Selector rows [8, K] of the sweep's 64 configurations (truncated
    geometric at (1, 1e-6)), every third configuration from the second
    switched to Laplace thresholding and every third from the third to
    Gaussian thresholding (threshold 5-50, scale 1-10)."""
    cfg, _ = sweep_config(tdp, [tdp.Metrics.COUNT])
    rows = np.stack([np.asarray(x, np.float64) for x in cfg[4:]])[:, :K]
    rows = rows.copy()
    for k in range(K):
        if k % 3:
            rows[0, k] = float(k % 3)
            rows[6, k] = 5.0 + 45.0 * ((k * 7) % 11) / 10.0
            rows[7, k] = 1.0 + 9.0 * ((k * 5) % 7) / 6.0
    return rows


def c8_counts(torch, node, B, level, salt):
    """Child counts int32[rows, n_q, B] of the lazy regime that depend only
    on (row, node, child): walks at one node read the same counts, as C7
    gives them. 0-96, about one in ten 0."""
    rows = node.shape[0]
    r = torch.arange(rows, device=node.device, dtype=torch.int64)[:, None,
                                                                  None]
    b = torch.arange(B, device=node.device, dtype=torch.int64)
    x = (r * 1000003 + node.long()[..., None] * 7919 + b * 104729 +
         level * 31 + salt) % 2147483647
    x = (x * 48271) % 2147483647
    x = x % 107
    return torch.where(x < 10, 0, x - 10).to(torch.int32).contiguous()


def without_sync(torch, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): a call that
    synchronizes the stream raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def c20_c8_edge_phase(torch, dev, tdp, kernels, executor):
    """C20's and C8's edge cases on the card. C20 (a tile's sums in one
    pass, the tiles' in order): P = 0, 1, a round less one, a round, a
    round and one (255-257), 2^14 in one bucket, 3000 spread over every
    bucket but five (empty), K = 1 and 64 (selectors of every kind), M = 1
    and 2, public and private, float64 within SWEEP_F64_RTOL of the plain
    version and float32 within SWEEP_F32_BOUND of the float32 plain version
    on the reports' scales (sweep_f32_errors), buckets and the dataset
    partition counts equal, each call equal to itself over two calls; and
    K = 1 over 2^20 + 300 partitions (tiles of two rounds). C8: 1, 3, 32
    (the by-value limit), 33 and 49 quantiles and unsorted ones with ties,
    heights 1-8 and B = 2, 16 and 64, secure and not, the lazy regime over
    17,770 movies and 1000 partitions, the dense one over 116 years, the
    lane entries at 1 x 17,770, 16 x 17,770 and 40 x 4000 (their key table
    by value and, 40 secure dense lanes, past it), two releases in a row
    with different tuples of 49 quantiles; every walk ends at the plain
    version's node (each lazy level; the dense solo entry's leaves),
    values within 1e-5, flags equal, each call equal to itself over two
    calls, and each wrapper's first call of a case under
    torch.cuda.set_sync_debug_mode("error")."""
    from pipelinedp_tpu_torch.analysis import error_model as em
    from pipelinedp_tpu_torch.analysis import kernels as ak
    from pipelinedp_tpu_torch.aggregate_params import NoiseKind
    from pipelinedp_tpu_torch.ops import threefry
    rng = np.random.default_rng(SEED + 20)
    nb = len(ak.BUCKET_BOUNDS)
    bounds = np.asarray(ak.BUCKET_BOUNDS, np.float64)
    selectors = c20_selectors(tdp, 64)
    empty = {3, 7, 12, 20, nb - 1}
    spread = np.array([bounds[i] + (bounds[i + 1] - bounds[i]) * 0.5
                       if i + 1 < nb else bounds[i] * 2.0
                       for i in range(nb) if i not in empty])
    sizes = {0: np.zeros(0), 1: np.array([37.0]),
             255: rng.integers(1, 60, 255).astype(np.float64),
             256: rng.integers(1, 60, 256).astype(np.float64),
             257: rng.integers(1, 60, 257).astype(np.float64),
             1 << 14: np.full(1 << 14, 1024.0),
             3000: spread[rng.integers(0, len(spread), 3000)]}
    c20 = 0

    def c20_case(f, K, P, M, public, size):
        args = c20_edge_inputs(torch, dev, f, K, P, M, public, size, rng,
                               selectors)
        got, again = (kernels.sweep_report(*args, public=public)
                      for _ in range(2))
        want = kernels.sweep_report_plain(*args, public=public)
        tag = (f"sweep_report edge ({str(f)[6:]}, K={K}, P={P}, M={M}, "
               f"{'public' if public else 'private'})")
        for name, a, b in zip(("bucket", "keep_prob", "bucket_rows",
                               "bucket_info"), got, again):
            check_equal(f"{tag} {name} twice", a, b)
        check_equal(f"{tag} bucket", got[0], want[0])
        check_equal(f"{tag} dataset partitions", got[3][..., em.N_DATASET],
                    want[3][..., em.N_DATASET])
        if f == torch.float64:
            for name, g, w in zip(("keep_prob", "bucket_rows",
                                   "bucket_info"), got[1:], want[1:]):
                check_close(f"{tag} {name}", g.reshape(-1), w.reshape(-1),
                            SWEEP_F64_RTOL, SWEEP_F64_RTOL)
        else:
            same = (args[0], args[0] if args[1] is None else args[1])
            errs = sweep_f32_errors(em, same, got, same, want)
            bad = {k: v for k, v in errs.items() if not v <= SWEEP_F32_BOUND}
            if bad:
                raise AssertionError(f"{tag}: beyond {SWEEP_F32_BOUND} of "
                                     f"the plain version: {bad}")
        return 1

    for f in (torch.float64, torch.float32):
        for K, M, public in ((1, 1, False), (1, 2, True), (64, 1, False),
                             (64, 2, False), (64, 1, True), (64, 2, True)):
            for P, size in sizes.items():
                c20 += c20_case(f, K, P, M, public, size)
    c20 += c20_case(torch.float64, 1, (1 << 20) + 300, 1, False,
                    rng.integers(1, 5000, (1 << 20) + 300).astype(float))
    print(f"c20_c8_edge_phase: {c20} C20 cases == / within the gates of "
          f"their plain versions, the same bits twice", flush=True)

    # C8 ------------------------------------------------------------------
    f32 = torch.float32
    std = 4.5
    qkey = executor.quantile_key(np.array([3, 17], np.uint32))
    limit = kernels.DESCEND_VALUE_QUANTILES
    tuples = {
        "1 quantile": (0.5,),
        "3 quantiles": QUANTILES,
        f"{limit} quantiles": tuple((j + 1) / (limit + 1)
                                    for j in range(limit)),
        f"{limit + 1} quantiles": tuple((j + 1) / (limit + 2)
                                        for j in range(limit + 1)),
        "49 quantiles": tuple((j + 1) / 50 for j in range(49)),
        "unsorted with ties": (0.9, 0.1, 0.5, 0.5, 0.1, 0.99, 0.0, 1.0),
    }
    table_of = {}

    def table(secure):
        if not secure:
            return None
        if not table_of:
            thr, gran = executor.build_secure_tables(
                np.array([std]), np.array([64.0]), NoiseKind.GAUSSIAN, None,
                dev)
            table_of[True] = (thr[0], float(gran[0]))
        return table_of[True]

    c8 = 0

    def lazy_case(label, quantiles, rows, n_lanes, h, B, secure, salt):
        n_q = len(quantiles)
        keep = torch.rand(rows, device=dev) < 0.7
        states = [kernels.DescentState(rows, n_q, f32, dev) for _ in range(3)]
        flags = [torch.zeros(max(n_lanes, 1), dtype=torch.int32, device=dev)
                 for _ in range(3)]
        keys = [threefry.fold_in(qkey, level) for level in range(1, h + 1)]
        lane_keys = [np.stack([threefry.fold_in(np.array(
            [l + 1, salt], np.uint32), level) for l in range(n_lanes)])
            for level in range(1, h + 1)] if n_lanes else None
        common = dict(tree_height=h, std=std, gaussian=True, min_v=1.0,
                      max_v=5.0, keep=keep, tables=table(secure))
        outs = [None] * 3
        for level in range(1, h + 1):
            counts = c8_counts(torch, states[0].node, B, level, salt)
            for i in range(3):
                if n_lanes:
                    call = (kernels.quantile_descend_step_lanes_plain
                            if i == 2 else kernels.quantile_descend_step_lanes)
                    fn = (lambda call=call, i=i: call(
                        counts, states[i], quantiles, level=level,
                        level_keys=lane_keys[level - 1], flags=flags[i],
                        n_lanes=n_lanes, **common))
                else:
                    call = (kernels.quantile_descend_step_plain if i == 2
                            else kernels.quantile_descend_step)
                    fn = (lambda call=call, i=i: call(
                        counts, states[i], quantiles, level=level,
                        level_key=keys[level - 1], flags=flags[i], **common))
                outs[i] = without_sync(torch, fn) if i == 0 else fn()
            tag = f"quantile_descend lazy edge ({label}) level {level}"
            for name in ("node", "target", "total", "mass"):
                check_equal(f"{tag} {name} twice", getattr(states[1], name),
                            getattr(states[0], name))
            check_equal(f"{tag} node", states[0].node, states[2].node)
            check_close(f"{tag} target", states[0].target.reshape(-1),
                        states[2].target.reshape(-1), 1e-5, 1e-3)
        tag = f"quantile_descend lazy edge ({label})"
        check_equal(f"{tag} twice", outs[1], outs[0])
        check_equal(f"{tag} flags twice", flags[1], flags[0])
        check_close(tag, outs[0].reshape(-1), outs[2].reshape(-1), 1e-5)
        check_equal(f"{tag} flags", flags[0], flags[2])
        return 1

    def dense_case(label, quantiles, rows, n_lanes, h, B, secure, salt):
        n_q = len(quantiles)
        gen = torch.Generator(device=dev).manual_seed(SEED + salt)
        leaf = torch.randint(0, 30, (rows, B**h), generator=gen, device=dev,
                             dtype=torch.int32)
        leaf[torch.rand(leaf.shape, generator=gen, device=dev) < 0.3] = 0
        levels = kernels.quantile_level_counts_plain(leaf, tree_height=h,
                                                     branching=B)
        del leaf
        keep = torch.rand(rows, generator=gen, device=dev) < 0.7
        common = dict(std=std, gaussian=False, min_v=0.0, max_v=10.0,
                      keep=keep, dtype=f32, tables=table(secure))
        flags = [torch.zeros(max(n_lanes, 1), dtype=torch.int32, device=dev)
                 for _ in range(3)]
        leaves = [torch.full((rows, n_q), -1, dtype=torch.int32, device=dev)
                  for _ in range(3)]
        if n_lanes:
            keys = np.stack([executor._dense_level_keys(np.array(
                [l + 1, salt], np.uint32), h) for l in range(n_lanes)])
            outs = [(kernels.quantile_descend_dense_lanes_plain if i == 2 else
                     kernels.quantile_descend_dense_lanes)
                    for i in range(3)]
            fns = [lambda i=i: outs[i](levels, quantiles, level_keys=keys,
                                       flags=flags[i], n_lanes=n_lanes,
                                       **common) for i in range(3)]
        else:
            keys = executor._dense_level_keys(qkey, h)
            outs = [(kernels.quantile_descend_dense_plain if i == 2 else
                     kernels.quantile_descend_dense) for i in range(3)]
            fns = [lambda i=i: outs[i](levels, quantiles, level_keys=keys,
                                       flags=flags[i], leaves=leaves[i],
                                       **common) for i in range(3)]
        got = [without_sync(torch, fns[0]), fns[1](), fns[2]()]
        tag = f"quantile_descend dense edge ({label})"
        check_equal(f"{tag} twice", got[1], got[0])
        check_equal(f"{tag} flags twice", flags[1], flags[0])
        check_equal(f"{tag} leaves", leaves[0], leaves[2])
        check_equal(f"{tag} leaves twice", leaves[1], leaves[0])
        check_close(tag, got[0].reshape(-1), got[2].reshape(-1), 1e-5)
        check_equal(f"{tag} flags", flags[0], flags[2])
        return 1

    salt = 0
    for name, qs in tuples.items():
        for secure in ((False, True) if name in ("3 quantiles",
                                                 "49 quantiles")
                       else (False,)):
            salt += 1
            label = f"{name}{', secure' if secure else ''}"
            c8 += lazy_case(f"{label}, 17,770 x h=4 B=16", qs, N_MOVIES, 0,
                            4, 16, secure, salt)
            c8 += dense_case(f"{label}, 116 x h=4 B=16", qs, 116, 0, 4, 16,
                             secure, salt)
    for h, B in ((1, 16), (8, 16), (4, 2), (3, 64)):
        salt += 1
        c8 += lazy_case(f"3 quantiles, 1000 x h={h} B={B}", QUANTILES, 1000,
                        0, h, B, False, salt)
    for h, B in ((1, 2), (1, 64), (8, 2), (2, 64)):
        salt += 1
        c8 += dense_case(f"3 quantiles, 116 x h={h} B={B}", QUANTILES, 116,
                         0, h, B, salt % 2 == 0, salt)
    for n_lanes, per_lane in ((1, N_MOVIES), (16, N_MOVIES), (40, 4000)):
        for secure in (False, True):
            salt += 1
            label = (f"{n_lanes} x {per_lane} lanes"
                     f"{', secure' if secure else ''}")
            c8 += lazy_case(label, QUANTILES, n_lanes * per_lane, n_lanes, 4,
                            16, secure, salt)
            c8 += dense_case(label + ", h=3 B=8", QUANTILES,
                             n_lanes * per_lane, n_lanes, 3, 8, secure, salt)
    # Two releases in a row with other tuples of 49 quantiles: the device
    # arrays of each tuple are its own.
    for k, first in enumerate((0.0, 0.005)):
        qs = tuple(first + (j + 1) / 51 for j in range(49))
        c8 += lazy_case(f"49 quantiles, release {k + 1}", qs, N_MOVIES, 0, 4,
                        16, False, 100 + k)
        c8 += dense_case(f"49 quantiles, release {k + 1}", qs, 116, 0, 4, 16,
                         False, 100 + k)
    print(f"c20_c8_edge_phase: {c8} C8 cases agree with their plain "
          f"versions (every walk at the plain version's node, values within "
          f"1e-5, flags equal), the same bits twice, no call synchronizing",
          flush=True)


def c8_entries(torch, dev, kernels, executor, P=N_MOVIES, PD=116,
               n_lanes=16, seed=SEED + 22):
    """C8's entries at the main path's shapes, {name: (fn, bytes, ops)}:
    a lazy step at (f)'s shape (P = 17,770 movies x 3 quantiles, B = 16,
    h = 4; level 1, and the last level with its columns and flag word),
    (f)'s four steps from a fresh state (the `kernels` line's figure), the
    dense entry over (h)'s PD = 116 release years, and one lane step over
    16 x 17,770 partitions, plain and secure. Child counts follow the
    walks' nodes (c8_counts: walks at one node read the same counts, as
    C7 gives them), from a descent made once here; the level-1 steps start
    from a fresh state each call (four fills beside the launch), the last
    level's step advances its state in place."""
    from pipelinedp_tpu_torch.aggregate_params import NoiseKind
    from pipelinedp_tpu_torch.ops import quantile_tree, threefry
    f32 = torch.float32
    h, B = quantile_tree.DEFAULT_TREE_HEIGHT, \
        quantile_tree.DEFAULT_BRANCHING_FACTOR
    quantiles, n_q = QUANTILES, len(QUANTILES)
    gen = torch.Generator(device=dev).manual_seed(seed)
    std = quantile_tree.per_level_noise_std(0.5, 5e-7, 64, 1, h,
                                            NoiseKind.GAUSSIAN)
    qkey = executor.quantile_key(np.array([7, 11], np.uint32))
    thr, gran = executor.build_secure_tables(
        np.array([std]), np.array([64.0]), NoiseKind.GAUSSIAN, None, dev)
    table = (thr[0], float(gran[0]))
    common = dict(std=std, gaussian=True, min_v=1.0, max_v=5.0)

    keep = torch.ones(P, dtype=torch.bool, device=dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    lkeys = [threefry.fold_in(qkey, level) for level in range(1, h + 1)]
    level_counts = []
    walk = kernels.DescentState(P, n_q, f32, dev)
    for level in range(1, h + 1):
        if level == h:
            last = kernels.DescentState(P, n_q, f32, dev)
            for name in ("node", "target", "total", "mass"):
                getattr(last, name).copy_(getattr(walk, name))
        level_counts.append(c8_counts(torch, walk.node, B, level, seed))
        kernels.quantile_descend_step(
            level_counts[-1], walk, quantiles, level=level, tree_height=h,
            level_key=lkeys[level - 1], keep=keep,
            flags=torch.zeros(1, dtype=torch.int32, device=dev), **common)
    del walk

    def step(level, tables=None):
        # Level 1 from a fresh state each call (its walks share the root,
        # as in a release); the last level on the state it advances.
        return lambda: kernels.quantile_descend_step(
            level_counts[level - 1],
            kernels.DescentState(P, n_q, f32, dev) if level == 1 else
            last, quantiles, level=level, tree_height=h,
            level_key=lkeys[level - 1], keep=keep, flags=flags,
            tables=tables, **common)

    def four_steps():
        st = kernels.DescentState(P, n_q, f32, dev)
        fl = torch.zeros(1, dtype=torch.int32, device=dev)
        for level in range(1, h + 1):
            out = kernels.quantile_descend_step(
                level_counts[level - 1], st, quantiles, level=level,
                tree_height=h, level_key=lkeys[level - 1], keep=keep,
                flags=fl, **common)
        return out

    leaf = torch.randint(0, 40, (PD, B**h), generator=gen, device=dev,
                         dtype=torch.int32)
    levels = kernels.quantile_level_counts(leaf, tree_height=h, branching=B)
    keep_d = torch.ones(PD, dtype=torch.bool, device=dev)
    dense_keys = executor._dense_level_keys(qkey, h)

    def dense(tables=None):
        return lambda: kernels.quantile_descend_dense(
            levels, quantiles, level_keys=dense_keys, keep=keep_d,
            flags=flags, dtype=f32, tables=tables, **common)

    total = n_lanes * P
    lane_counts = c8_counts(torch, torch.zeros(
        (total, n_q), dtype=torch.int32, device=dev), B, 1, seed)
    lane_keep = torch.ones(total, dtype=torch.bool, device=dev)
    lane_flags = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    lane_keys = np.stack([threefry.fold_in(
        executor.quantile_key(np.array([l, 5], np.uint32)), 1)
        for l in range(n_lanes)])

    def lane_step(tables=None):
        return lambda: kernels.quantile_descend_step_lanes(
            lane_counts, kernels.DescentState(total, n_q, f32, dev),
            quantiles, level=1, tree_height=h,
            level_keys=lane_keys, keep=lane_keep, flags=lane_flags,
            n_lanes=n_lanes, tables=tables, **common)

    walks, lanes = P * n_q, total * n_q
    # A walk a step: its B counts read, its state read and written, B
    # nodes drawn (three threefry and an erf_inv, ~350 operations; a
    # secure node two more threefry and a table search, ~550).
    state = 4 + 3 * 4
    return {
        "lazy step, level 1": (step(1), walks * (B * 4 + 2 * state),
                               walks * B * 350),
        f"lazy step, level {h}": (step(h), walks * (B * 4 + 2 * state) +
                                  walks * 4, walks * B * 350),
        f"lazy, {h} steps": (four_steps, h * walks * (B * 4 + 2 * state),
                             h * walks * B * 350),
        f"dense, P={PD}": (dense(), PD * n_q * (h * B * 4 + 4),
                           PD * n_q * h * B * 350),
        f"dense secure, P={PD}": (dense(table), PD * n_q * (h * B * 4 + 4),
                                  PD * n_q * h * B * 550),
        f"lane step, {n_lanes} x {P}": (lane_step(), lanes * (B * 4 +
                                                              2 * state),
                                        lanes * B * 350),
        f"secure lane step, {n_lanes} x {P}": (
            lane_step(table), lanes * (B * 4 + 2 * state), lanes * B * 550),
    }


def c20_c8_split_phase(torch, dev, tdp, encoded, kernels, executor, card):
    """The three-way split (three_way) and the device operations a call
    (device_ops, each launch by name) of C20 at (A) and (B) (sweep_shapes;
    the statistics from C19 on the card), float32 and float64, and of C8's
    entries at the main path's shapes (c8_entries). On this tree C8 is one
    device operation a call and C20 at most two; a parent's C20 shows its
    four launches, its C8 the finish launch and the uploads. Run by
    --splits."""
    from pipelinedp_tpu_torch.analysis import kernels as ak
    rebuilt = hasattr(kernels, "DESCEND_VALUE_QUANTILES")

    def ops_of(fn):
        for _ in range(3):
            ops = device_ops(torch, fn)
            if ops != "not traced":
                return ops
        return ops

    for label, (counts, sums, contributed, pk, p, (cfg, codes)) in \
            sweep_shapes(tdp, encoded).items():
        k, m = len(cfg.l0), len(codes)
        fns = {}
        for f in (torch.float32, torch.float64):
            c, s, con = (torch.as_tensor(np.asarray(x), dtype=f, device=dev)
                         for x in (counts, sums, contributed))
            pkt = torch.as_tensor(pk, device=dev)
            perm, spk = kernels.radix_sort([pkt], sorted_top=True)
            offs = kernels.block_offsets(
                spk, torch.arange(p + 1, dtype=torch.int32, device=dev))
            cf = [torch.as_tensor(np.asarray(x), dtype=f,
                                  device=dev).contiguous() for x in cfg]
            sel_cfg = torch.stack(cf[4:]).contiguous()
            st = kernels.sweep_stats(c, s, con, perm, offs, *cf[:3],
                                     metric_codes=codes, private=True)
            args = (st[0], st[1], st[2], st[4], cf[3], sel_cfg,
                    torch.tensor(ak.BUCKET_BOUNDS, dtype=f, device=dev))
            name = f"C20 ({label}, {str(f)[6:]})"
            fns[name] = (lambda a=args: kernels.sweep_report(
                *a, public=False))
            del c, s, con, perm, spk, offs
            ops = ops_of(fns[name])
            if rebuilt and ops != "not traced" and ops["total"] > 2:
                raise AssertionError(f"{name}: {ops}")
            print(f"c20_c8[{name}, P={p} K={k} M={m}]: device operations a "
                  f"call {json.dumps(ops)}", flush=True)
        print_three_way(f"C20 sweep_report at ({label})",
                        three_way(torch, fns, host_calls=50), card)
        del fns
    entries = c8_entries(torch, dev, kernels, executor)
    for name, (fn, nbytes, ops_n) in entries.items():
        ops = ops_of(fn)
        # One operation a wrapper call; the four steps also make a fresh
        # state and flag word (five fills), a level-1 step its fresh state
        # (four); a trace may miss some.
        most = (4 + 5 if name.startswith("lazy, ") else
                1 + 4 if "level 1" in name or "lane step" in name else 1)
        if rebuilt and ops != "not traced" and ops["total"] > most:
            raise AssertionError(f"C8 {name}: {ops}")
        b_ms, b_by = bound(nbytes, ops_n)
        print(f"c20_c8[C8 {name}]: device operations a call "
              f"{json.dumps(ops)}, bound {b_ms:.4g} ms ({b_by})", flush=True)
    print_three_way("C8 entries at the main path's shapes", three_way(
        torch, {name: fn for name, (fn, *_) in entries.items()},
        host_calls=200), card)
    del entries


INT_STATS = ("l0", "l1", "linf", "count_per_pk", "pids_per_pk")
HIST_BUCKETS = 10000


def c14_buffers(torch, dev, rows, gen):
    """C14's row buffers of `rows` rows, random contents: ((the host
    route's pid, pk int32 and values float32), pads (0, -1, 0.0)) and
    ((the hash route's two int32[., 3] hash columns and the same values),
    pads (-1, -1, 0.0))."""
    host = [torch.randint(0, 1 << 30, (rows,), dtype=torch.int32,
                          device=dev, generator=gen),
            torch.randint(-1, N_MOVIES, (rows,), dtype=torch.int32,
                          device=dev, generator=gen),
            torch.rand(rows, device=dev, generator=gen)]
    hashed = [torch.randint(-(1 << 31), 1 << 31, (rows, 3), dtype=torch.int32,
                            device=dev, generator=gen)
              for _ in range(2)] + [host[2]]
    return (host, (0, -1, 0.0)), (hashed, (-1, -1, 0.0))


def c18_int_cases(torch, dev, rng, n=4099):
    """C18's integer edge inputs, {label: (values int32, mask bool)} on the
    card, n rows (not a multiple of 16) unless named."""
    pow10 = 10**np.arange(10, dtype=np.int64)
    edges = np.concatenate([pow10 - 1, pow10, pow10 + 1, [999, 1001, 0, -1,
                                                          -7, -(1 << 31),
                                                          (1 << 31) - 1]])
    decades = np.clip(np.concatenate([
        edges, (10.0**rng.uniform(0, 9.33, n - len(edges))).astype(np.int64)]),
        -(1 << 31), (1 << 31) - 1)
    dense, sparse = np.ones(n, bool), rng.random(n) < 0.03
    cases = {
        "one slot (Netflix pair lengths)": (np.ones(n), dense),
        "five values": (rng.integers(1, 6, n), dense),
        "five values, sparse mask": (rng.integers(1, 6, n), sparse),
        "every decade, edges, negatives, int32 extremes": (decades, dense),
        "every decade, half masked": (rng.permutation(decades),
                                      rng.random(n) < 0.5),
        "skew over 40 slots": (np.minimum(rng.zipf(1.3, n), 40), dense),
        "empty mask": (rng.integers(1, 5000, n), np.zeros(n, bool)),
        "no rows": (np.zeros(0), np.zeros(0, bool)),
        "one row": (np.array([123456]), np.ones(1, bool)),
        "16 rows": (rng.integers(0, 3000, 16), rng.random(16) < 0.7)}
    out = {k: (torch.as_tensor(v.astype(np.int32), device=dev),
               torch.as_tensor(m, device=dev)) for k, (v, m) in cases.items()}
    # Views one row in: 4-byte and 1-byte aligned, read row by row.
    v, m = out["every decade, half masked"]
    pad_v = torch.cat([v[:1], v])
    pad_m = torch.cat([m[:1], m])
    out["unaligned views"] = (pad_v[1:], pad_m[1:])
    return out


def c18_float_cases(torch, dev, rng, n=4099):
    """C18's float edge inputs, {label: (values float32, mask bool)}."""
    from pipelinedp_tpu_torch import kernels
    f32 = np.float32
    big = np.finfo(f32).max
    dense = np.ones(n, bool)
    lo, hi = f32(-3.7), f32(12.9)
    on_edges = kernels.linspace_edges_f32(
        torch.tensor(lo), torch.tensor(hi), HIST_BUCKETS).numpy()
    on_edges = np.concatenate([on_edges, rng.choice(on_edges, n)])
    mixed = np.concatenate([[-0.0, 0.0, -0.0], rng.normal(size=n - 3) * 40])
    cases = {
        "five values (Netflix pair sums)": (rng.integers(1, 6, n), dense),
        "lo == hi": (np.full(n, 0.1), dense),
        "lo == hi == -0.0": (np.full(n, -0.0), dense),
        "lo == hi, half masked": (np.where(rng.random(n) < 0.5, 7.25, -3.0),
                                  rng.random(n) < 0.5),
        "-FLT_MAX to FLT_MAX": (np.concatenate([[-big, big], rng.normal(
            size=n - 2) * 1e37]), dense),
        "values on every edge": (on_edges, np.ones(len(on_edges), bool)),
        "a range of a few ulps": (f32(1e6) + f32(0.0625) * rng.integers(
            0, 17, n), dense),
        "negatives and -0.0": (mixed, dense),
        "wide skew": (rng.standard_cauchy(n), rng.random(n) < 0.8),
        "empty mask": (rng.normal(size=n), np.zeros(n, bool)),
        "one row": (np.array([2.5]), np.ones(1, bool))}
    out = {k: (torch.as_tensor(v.astype(f32), device=dev),
               torch.as_tensor(m, device=dev)) for k, (v, m) in cases.items()}
    v, m = out["negatives and -0.0"]
    out["unaligned views"] = (torch.cat([v[:1], v])[1:],
                              torch.cat([m[:1], m])[1:])
    return out


def c14_cases(torch, dev, gen):
    """C14's edge layouts: (label, buffers of cap rows, pads), with widths
    1, 3 and 5, 4- and 8-byte columns, the hash route's sentinel and -0.0
    pads, and buffers that start one row into their allocation."""
    def col(cap, dtype, width=1, offset=0):
        shape = (cap + offset,) + ((width,) if width > 1 else ())
        if dtype.is_floating_point:
            t = torch.rand(shape, device=dev, generator=gen).to(dtype)
        else:
            t = torch.randint(-(1 << 30), 1 << 30, shape, device=dev,
                              generator=gen).to(dtype)
        return t[offset:]

    i32, i64, f32, f64 = torch.int32, torch.int64, torch.float32, \
        torch.float64
    out = []
    for cap in (64, 1000, 4099):
        out += [
            (f"host route, cap {cap}", [col(cap, i32), col(cap, i32),
                                        col(cap, f32)], (0, -1, 0.0)),
            (f"hash route, cap {cap}", [col(cap, i32, 3), col(cap, i32, 3),
                                        col(cap, f32)], (-1, -1, 0.0)),
            (f"8-byte, widths 1 and 5, cap {cap}",
             [col(cap, i64), col(cap, f64, 5), col(cap, i32, 5)],
             (-7, -0.0, 3)),
            (f"one row in, cap {cap}",
             [col(cap, i32, 1, 1), col(cap, f64, 5, 1), col(cap, i64, 1, 1)],
             (5, -0.0, -1))]
    return out


def c18_c14_edge_phase(torch, dev, kernels):
    """C18 and C14 at their edge inputs, each entry == its plain version:
    C18's integer entry (c18_int_cases, alone and all in one batched
    launch), its float entry (c18_float_cases; lo, hi, edges, counts and
    maxes ==, sums within check_float_hist's bound), C14's fill_tail at
    starts 0-3, 5, 7, 13, cap - 1 and cap (no launch) and grow to the same
    capacity, +1 row, the next power of two and 3 x + 5, on c14_cases'
    layouts; each C14 call one launch."""
    rng = np.random.default_rng(SEED + 18)
    ints = c18_int_cases(torch, dev, rng)
    for label, (v, m) in ints.items():
        for j, (g, w) in enumerate(zip(kernels.log_bins_int(v, m),
                                       kernels.log_bins_int_plain(v, m))):
            check_equal(f"log_bins_int ({label}) {j}", g, w)
    stats = list(ints.values())
    check_equal("log_bins_int_many (every case in one launch)",
                kernels.log_bins_int_many(stats),
                kernels.log_bins_int_many_plain(stats))
    floats = c18_float_cases(torch, dev, rng)
    for label, (v, m) in floats.items():
        check_float_hist(f"log_bins_float ({label})",
                         kernels.log_bins_float(v, m, HIST_BUCKETS),
                         kernels.log_bins_float_plain(v, m, HIST_BUCKETS),
                         v, m)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    layouts = c14_cases(torch, dev, gen)
    for label, bufs, fills in layouts:
        cap = bufs[0].shape[0]
        for start in sorted({0, 1, 2, 3, 5, 7, 13, cap - 1, cap}):
            got = [b.clone() for b in bufs]
            want = [b.clone() for b in bufs]
            before = kernels.launch_counts["append_rows"]
            kernels.fill_tail(got, start, fills)
            if kernels.launch_counts["append_rows"] - before != \
                    (start < cap):
                raise AssertionError(f"fill_tail ({label}, start {start}): "
                                     f"not one launch")
            kernels.fill_tail_plain(want, start, fills)
            for j, (g, w) in enumerate(zip(got, want)):
                check_equal(f"fill_tail ({label}, start {start}) column {j}",
                            g, w)
        for new_cap in sorted({cap, cap + 1, 1 << cap.bit_length(),
                               3 * cap + 5}):
            before = kernels.launch_counts["append_rows"]
            grown = kernels.grow_rows(bufs, new_cap, fills)
            if kernels.launch_counts["append_rows"] - before != 1:
                raise AssertionError(f"grow_rows ({label}, {new_cap}): not "
                                     f"one launch")
            for j, (g, w) in enumerate(zip(
                    grown, kernels.grow_rows_plain(bufs, new_cap, fills))):
                check_equal(f"grow_rows ({label}, {cap} -> {new_cap}) "
                            f"column {j}", g, w)
    torch.cuda.synchronize()
    print(f"c18_c14 edges: C18 integer entry on {len(ints)} cases (each "
          f"alone and all in one launch), float entry on {len(floats)}, "
          f"C14 fill_tail and grow on {len(layouts)} layouts: all equal "
          f"their plain versions", flush=True)


def c18_c14_split_phase(torch, dev, encoded, qenc, kernels, card):
    """The three-way split (three_way) and the device operations a call
    (device_ops) of C18's entries on the histogram call's stats (the five
    integer histograms of the 2^24 Netflix rows, the integer l1 alone, the
    float histogram of the Netflix and (q) pair sums) and of C14's grow
    (2^23 -> 2^24 rows) and fill_tail (2^24 - 1 rows) on the host route's
    buffers, beside three Tensor.fill_ calls and torch.cat + torch.full;
    and the wall of compute_dataset_histograms_device on the Netflix rows
    (median of 5). On this tree a C18 or C14 call is one device operation
    and the five integer histograms one launch (log_bins_int_many); a
    parent's five are five calls. Run by --splits."""
    from pipelinedp_tpu_torch.dataset_histograms import device_histograms \
        as dh
    batched = hasattr(kernels, "log_bins_int_many")
    stats = {}
    for label, enc in (("netflix", encoded), ("q", qenc)):
        stats[label] = dh.group_stats(*dh.device_columns(
            enc.pid, enc.pk, enc.values, dev))
    net = stats["netflix"]
    ints = [net[k] for k in INT_STATS]
    n = net["l1"][0].shape[0]
    fns = {
        "C18 int (l1)": lambda: kernels.log_bins_int(*net["l1"]),
        "C18 five ints": (
            (lambda: kernels.log_bins_int_many(ints)) if batched else
            (lambda: [kernels.log_bins_int(*s) for s in ints])),
        "C18 float (netflix)": lambda: kernels.log_bins_float(
            *net["linf_sum"], HIST_BUCKETS),
        "C18 float (q)": lambda: kernels.log_bins_float(
            *stats["q"]["linf_sum"], HIST_BUCKETS)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    (bufs, fills), _ = c14_buffers(torch, dev, N_ROWS // 2, gen)
    tail = kernels.grow_rows(bufs, N_ROWS, fills)

    def library_grow():
        return [torch.cat([b, torch.full((N_ROWS - b.shape[0],), f,
                                         dtype=b.dtype, device=dev)])
                for b, f in zip(bufs, fills)]

    fns14 = {
        "C14 grow": lambda: kernels.grow_rows(bufs, N_ROWS, fills),
        "C14 fill_tail": lambda: kernels.fill_tail(tail, 1, fills),
        "three fill_": lambda: kernels.fill_tail_plain(tail, 1, fills),
        "torch.cat + torch.full": library_grow}
    for name, fn in list(fns.items()) + list(fns14.items()):
        for _ in range(3):
            ops = device_ops(torch, fn)
            if ops != "not traced":
                break
        most = 5 if name == "C18 five ints" and not batched else 1
        if batched and name.startswith(("C18", "C14")) and \
                ops != "not traced" and ops["total"] > most:
            raise AssertionError(f"{name}: {ops}")
        print(f"c18_c14[{name}]: device operations a call "
              f"{json.dumps(ops)}", flush=True)
    b_int = bound(n * 5, 0)[0]
    b_float = bound(2 * n * 5, 0)[0]
    b_grow = bound(N_ROWS // 2 * 12 + N_ROWS * 12, 0)[0]
    b_fill = bound((N_ROWS - 1) * 12, 0)[0]
    print(f"c18_c14[bounds]: C18 int {b_int:.4g} ms a stat, five "
          f"{5 * b_int:.4g}, float {b_float:.4g} (values and mask read "
          f"twice); C14 grow {b_grow:.4g}, fill_tail {b_fill:.4g} (bytes)",
          flush=True)
    print_three_way("C18 log_bins at the histogram call's shapes",
                    three_way(torch, fns, host_calls=200), card)
    print_three_way("C14 append_rows, host route, 12 B a row",
                    three_way(torch, fns14, host_calls=200), card)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        dh.compute_dataset_histograms_device(encoded.pid, encoded.pk,
                                             encoded.values, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - start) * 1e3)
    print(f"c18_c14[histogram call, netflix]: compute_dataset_histograms_"
          f"device {statistics.median(walls):.4f} ms (median of 5: "
          f"{[round(w, 4) for w in walls]}) ({card})", flush=True)
    del stats, net, ints, bufs, tail, fns, fns14


def round_up(x, multiple):
    return -(-x // multiple) * multiple


def reshard_rows(torch, dev, cap, values):
    """Receive columns (pid, pk, values, valid) of cap rows, zeroed."""
    return (torch.zeros(cap, dtype=torch.int32, device=dev),
            torch.zeros(cap, dtype=torch.int32, device=dev),
            torch.zeros((cap,) + tuple(values.shape[1:]), dtype=values.dtype,
                        device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev))


def splits_only(torch, tdp, cuda_build, columnar, kernels, executor,
                device_encode, ingest, card, t0):
    """python3 chip_smoke.py --splits: the build, the Netflix rows,
    c4_c24_split_phase, c6_c7_split_phase, c22_c23_split_phase,
    c20_c8_split_phase and c18_c14_split_phase, nothing else (the same
    script on two trees in turns compares them); --splits=c18_c14 (names
    joined by commas) runs only the named ones."""
    print(f"build: {len(cuda_build.SOURCES)} kernel sources in "
          f"{cuda_build.build_all():.1f} s ({card})", flush=True)
    names = [a.split("=", 1)[1] for a in sys.argv[1:]
             if a.startswith("--splits=")]
    chosen = set(",".join(names).split(",")) if names else None
    users, movies, ratings = netflix_rows(np.random.default_rng(SEED))
    dev = torch.device("cuda")

    def wanted(name):
        return chosen is None or name in chosen

    if wanted("c4_c24"):
        c4_c24_split_phase(torch, dev, kernels, executor, device_encode,
                           ingest, users, card)
    if wanted("c6_c7"):
        c6_c7_split_phase(torch, dev, kernels, card)
    if wanted("c22_c23"):
        c22_c23_split_phase(torch, dev, kernels, users, card)
    encoded = (columnar.encode_columns(users, movies, ratings)
               if wanted("c20_c8") or wanted("c18_c14") else None)
    if wanted("c20_c8"):
        c20_c8_split_phase(torch, dev, tdp, encoded, kernels, executor, card)
    if wanted("c18_c14"):
        c18_c14_split_phase(torch, dev, encoded, columnar.encode_columns(
            *zipfish_rows()), kernels, card)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def large_p_parity_phase(torch, tdp, rng):
    """Small blocked releases and selections on the card (float64) against
    the same on the CPU, large_partition_threshold=16, block_partitions=8
    and 44 partitions (44 % 8 = 4): the same kept partitions, values within
    1e-9 relative (secure noise: equal)."""
    n = 4096
    users = rng.integers(0, 600, n).tolist()
    parts = (rng.random(n)**4 * 44).astype(int).tolist()
    values = rng.uniform(0, 5, n)
    scalar = list(zip(users, parts, values.tolist()))
    vector = list(zip(users, parts, [[v, 5.0 - v, 1.0] for v in values]))
    M = tdp.Metrics
    cases = {
        "public": (scalar, [M.COUNT, M.SUM, M.MEAN, M.VARIANCE], True, {},
                   dict(noise_kind=tdp.NoiseKind.GAUSSIAN)),
        "private": (scalar, [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT], False, {},
                    {}),
        "percentile": (scalar, [M.PERCENTILE(50), M.COUNT], False, {}, {}),
        "vector": (vector, [M.VECTOR_SUM, M.COUNT], False, {},
                   dict(vector_size=3, vector_max_norm=6.0,
                        vector_norm_kind=tdp.NormKind.L2, min_value=None,
                        max_value=None)),
        "secure": (scalar, [M.COUNT, M.SUM, M.MEAN], False,
                   dict(secure_noise=True), {}),
        "safe": (scalar, [M.COUNT, M.SUM], True, dict(numeric_mode="safe"),
                 {}),
    }
    blocked = dict(large_partition_threshold=16, block_partitions=8)
    for label, (rows, metrics, public, backend, extra) in cases.items():
        results = []
        for device in ("cuda", "cpu"):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=4.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(
                device=device, noise_seed=5, dtype=torch.float64, **blocked,
                **backend))
            bounds = dict(max_partitions_contributed=3,
                          max_contributions_per_partition=2, min_value=0.0,
                          max_value=5.0)
            bounds.update(extra)
            res = engine.aggregate(
                rows, tdp.AggregateParams(metrics=metrics, **bounds),
                tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                   partition_extractor=lambda r: r[1],
                                   value_extractor=lambda r: r[2]),
                list(range(44)) if public else None)
            acc.compute_budgets()
            results.append(dict(res))
        gpu, cpu = results
        if sorted(gpu) != sorted(cpu) or not gpu:
            raise AssertionError(f"blocked parity {label}: kept partitions "
                                 f"differ ({len(gpu)} vs {len(cpu)})")
        worst = 0.0
        for k in cpu:
            for a, b in zip(gpu[k], cpu[k]):
                d = np.abs(np.asarray(a) - np.asarray(b)) / np.maximum(
                    1.0, np.abs(np.asarray(b)))
                worst = max(worst, float(np.max(d)))
        limit = 0.0 if backend.get("secure_noise") else 1e-9
        if worst > limit:
            raise AssertionError(f"blocked parity {label}: rel err {worst}")
        print(f"parity[blocked {label}, threshold 16, block 8, P=44]: "
              f"{len(gpu)} partitions, cuda float64 vs cpu float64 max rel "
              f"err {worst:.3g}", flush=True)
    for strategy in ("TRUNCATED_GEOMETRIC", "LAPLACE_THRESHOLDING",
                     "GAUSSIAN_THRESHOLDING"):
        kept = []
        for device in ("cuda", "cpu"):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(
                device=device, noise_seed=5, dtype=torch.float64, **blocked))
            res = engine.select_partitions(
                scalar, tdp.SelectPartitionsParams(
                    max_partitions_contributed=3,
                    partition_selection_strategy=getattr(
                        tdp.PartitionSelectionStrategy, strategy)),
                tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                   partition_extractor=lambda r: r[1]))
            acc.compute_budgets()
            kept.append(list(res))
        if kept[0] != kept[1] or not kept[0] or len(kept[0]) == 44:
            raise AssertionError(f"blocked select parity {strategy}: cuda "
                                 f"kept {len(kept[0])}, cpu {len(kept[1])}")
        print(f"parity[blocked select_partitions, {strategy}]: {len(kept[0])}"
              f" of 44 kept, cuda list identical to cpu", flush=True)


def large_p_main_phase(torch, tdp, qenc, qmax, netflix, nmax, kernels,
                       large_p, card):
    """Runs (q)-(w) and the blocked selects at full size. Returns the
    launch counts summed over the runs that go through DPEngine."""
    from pipelinedp_tpu_torch.ops import noise as noise_ops
    total = dict.fromkeys(kernels.KERNELS, 0)
    P = qenc.n_partitions
    n_blocks = -(-P // LARGE_BLOCK)
    vocab = np.asarray(qenc.partition_vocab)
    vocab_order = np.argsort(vocab, kind="stable")
    M = tdp.Metrics

    def ids_of(out):
        keys = np.fromiter(out.keys(), dtype=vocab.dtype, count=len(out))
        return vocab_order[np.searchsorted(vocab[vocab_order], keys)]

    def aggregate(label, enc, metrics, public, eps, seed, path, backend,
                  bounds, reps=1, noise="LAPLACE", want=None):
        params = tdp.AggregateParams(
            metrics=metrics, noise_kind=getattr(tdp.NoiseKind, noise),
            **bounds)
        outs, times, phases = [], [], []
        for rep in range(reps):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=eps,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(
                noise_seed=seed + rep, **backend))
            kernels.reset_launch_counts()
            res = engine.aggregate(enc, params, tdp.DataExtractors(),
                                   list(enc.partition_vocab) if public
                                   else None)
            acc.compute_budgets()
            torch.cuda.synchronize()
            with PhaseProbe(large_p) as probe:
                start = time.perf_counter()
                out = dict(res)
                torch.cuda.synchronize()
                end = time.perf_counter()
            counts = dict(kernels.launch_counts)
            check_launches(f"run ({label})", counts, kernels, want, path)
            if counts["reduce_partitions"] or counts[
                    "reduce_partitions_compensated"]:
                raise AssertionError(f"run ({label}) ran the dense C3 entry: "
                                     f"{counts}")
            for name, c in counts.items():
                total[name] += c
            bad = [k for k, v in out.items() if not np.all(np.isfinite(
                np.hstack([np.ravel(x) for x in v])))]
            if bad or not out:
                raise AssertionError(f"run ({label}): {len(out)} partitions, "
                                     f"{len(bad)} with non-finite values")
            pt = dict(probe.records[-1])
            pt["decode"] = end - pt.pop("returned_at")
            outs.append(out)
            times.append(end - start)
            phases.append(pt)
        ms = statistics.median(times) * 1e3
        pt = phases[int(np.argsort(times)[len(times) // 2])]
        print(f"main ({label}) {noise} {'public' if public else 'private'} "
              f"{backend} {bounds}: P={enc.n_partitions}, "
              f"{pt['blocks_dispatched']} blocks dispatched, {len(outs[0])} "
              f"partitions released, {ms:.1f} ms, "
              f"{enc.n_rows / (ms / 1e3):.4g} rows/s (median of {reps}: "
              f"{[round(t * 1e3, 1) for t in times]} ms; {card}); "
              f"phase_times (s) of the median run "
              f"{json.dumps({k: round(v, 4) for k, v in pt.items()})}; "
              f"launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
        return outs[0], params, pt

    priv = dict(max_partitions_contributed=4,
                max_contributions_per_partition=8, min_value=0.0,
                max_value=5.0)
    blocks = dict(block_window_offsets=1, reduce_partitions_windowed=n_blocks,
                  release_epilogue=n_blocks, compact_kept=n_blocks)
    # (q) COUNT+SUM, Laplace, private selection, eps 1.
    out_q, _, pt = aggregate("q", qenc, [M.COUNT, M.SUM], False, 1.0, 0,
                             BLOCKED_KERNELS, {}, priv, reps=3, want=blocks)
    if pt["blocks_dispatched"] != n_blocks:
        raise AssertionError(f"run (q): {pt['blocks_dispatched']} blocks "
                             f"dispatched, expected {n_blocks}")
    # (r) eps 1e6 with the true maxima: a numpy group-by.
    l0_true, linf_true = qmax[:2]
    exact_bounds = dict(max_partitions_contributed=l0_true,
                        max_contributions_per_partition=linf_true,
                        min_value=0.0, max_value=5.0)
    out_r, params_r, _ = aggregate("r", qenc, [M.COUNT, M.SUM], False, 1e6,
                                   9, BLOCKED_KERNELS, {}, exact_bounds)
    cfg_r, stds_r, scalars_r = release_spec(tdp, params_r, P, 1e6, True)
    std_r = std_by_output(cfg_r, stds_r)
    true_count = np.bincount(qenc.pk, minlength=P).astype(np.float64)
    true_sum = np.bincount(qenc.pk, weights=qenc.values, minlength=P)

    def check_group_by(label, ids, got):
        worst = {}
        for name, truth in (("count", true_count), ("sum", true_sum)):
            std = std_r[name]
            want = truth[ids]
            err = np.abs(got[name] - want)
            tol = 16 * std + scan_tolerance(true_count[ids], want)
            if (err > tol).any():
                i = int(np.argmax(err - tol))
                raise AssertionError(f"run ({label}) {name}: partition id "
                                     f"{ids[i]} {got[name][i]} vs numpy "
                                     f"{want[i]} (tol {tol[i]})")
            worst[name] = float((err / np.maximum(1.0, want)).max())
        return worst

    ids_r = ids_of(out_r)
    got_r = {name: np.array([getattr(v, name) for v in out_r.values()])
             for name in ("count", "sum")}
    worst = check_group_by("r", ids_r, got_r)
    print(f"main (r) epsilon=1e6, l0={l0_true}, linf={linf_true}: "
          f"{len(out_r)} kept partitions match the numpy group-by within 16 "
          f"noise stds + float32 scan rounding (max rel err "
          f"{json.dumps(worst)})", flush=True)
    # (s) PERCENTILE 50 + COUNT: lazy descents per block.
    q_path = BLOCKED_KERNELS + ("quantile_child_counts_windowed",
                                "quantile_descend")
    out_s, _, _ = aggregate("s", qenc, [M.PERCENTILE(50), M.COUNT], False,
                            1.0, 0, q_path, {}, priv)
    pct = np.array([v.percentile_50 for v in out_s.values()])
    if (pct < 0.0).any() or (pct > 5.0).any():
        raise AssertionError("run (s): percentiles outside [0, 5]")
    print(f"main (s): {len(out_s)} partitions' percentile 50 within [0, 5] "
          f"(median {float(np.median(pct)):.4f})", flush=True)
    # (t) MEAN + VARIANCE (+ COUNT) with secure noise: the count on its
    # grid (mean and variance are formulas of grid values).
    secure_path = tuple(k for k in BLOCKED_KERNELS
                        if k != "release_epilogue") + (
        "release_epilogue_secure",)
    out_t, params_t, _ = aggregate("t", qenc, [M.COUNT, M.MEAN, M.VARIANCE],
                                   False, 1.0, 0, secure_path,
                                   dict(secure_noise=True), priv)
    grids, _ = slot_grids(tdp, params_t, 1.0, 1e-6)
    on_grid("t", out_t, "count", grids["count"][0])
    print(f"main (t): {len(out_t)} secure counts on their grid "
          f"{grids['count'][0]}", flush=True)
    # (u) values x 1000 (integers), numeric_mode="safe", float32, eps 1e12
    # and the true maxima: sums past 2^25 equal float32 of the exact sum;
    # the fast mode beside it (a record).
    milli = dataclasses.replace(qenc, values=np.round(qenc.values * 1000.0))
    exact_milli = np.bincount(qenc.pk, weights=milli.values, minlength=P)
    safe_path = tuple(k for k in BLOCKED_KERNELS
                      if k != "reduce_partitions_windowed") + (
        "reduce_partitions_compensated_windowed",)
    u_bounds = dict(exact_bounds, max_value=5000.0)
    off = {}
    for mode, path in (("safe", safe_path), ("fast", BLOCKED_KERNELS)):
        out_u, _, _ = aggregate(f"u, {mode}", milli, [M.COUNT, M.SUM], False,
                                1e12, 13, path, dict(numeric_mode=mode),
                                u_bounds)
        ids_u = ids_of(out_u)
        sums = np.array([v.sum for v in out_u.values()])
        big = exact_milli[ids_u] >= 2.0**25
        f32 = exact_milli[ids_u].astype(np.float32).astype(np.float64)
        ulp = np.spacing(np.abs(exact_milli[ids_u]).astype(
            np.float32)).astype(np.float64)
        dev_ulps = np.abs(sums - f32)[big] / ulp[big]
        off[mode] = [int(big.sum()), int((dev_ulps > 0).sum()),
                     float(dev_ulps.max()) if dev_ulps.size else 0.0]
    if not off["safe"][0] or off["safe"][1]:
        raise AssertionError(f"run (u): safe sums past 2^25 [count, "
                             f"differing from float32(exact), largest ulps] "
                             f"{off['safe']}")
    print(f"main (u) safe, float32, values x 1000, eps 1e12: of the "
          f"{off['safe'][0]} kept sums past 2^25, [count, how many differ "
          f"from float32(exact sum), the largest difference in ulps]: safe "
          f"{off['safe']}, fast {off['fast']} (fast: a record, not a gate)",
          flush=True)
    # (v) = (c) on the blocked route: Netflix, public, 4096 partitions a
    # block (17,770 = 4 x 4096 + 1386), eps 1e6 and the true maxima.
    nP = netflix.n_partitions
    nl0, nlinf, npairs, _ = nmax
    v_bounds = dict(max_partitions_contributed=nl0,
                    max_contributions_per_partition=nlinf, min_value=1.0,
                    max_value=5.0)
    v_blocks = -(-nP // 4096)
    out_v, params_v, pt = aggregate(
        "v", netflix, [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT], True, 1e6, 9,
        BLOCKED_KERNELS, dict(large_partition_threshold=4096,
                              block_partitions=4096), v_bounds,
        want=dict(block_window_offsets=1, reduce_partitions_windowed=v_blocks,
                  compact_kept=v_blocks))
    if pt["blocks_dispatched"] != v_blocks or len(out_v) != nP:
        raise AssertionError(f"run (v): {pt['blocks_dispatched']} blocks, "
                             f"{len(out_v)} partitions")
    cfg_v, stds_v, _ = release_spec(tdp, params_v, nP, 1e6, False)
    std_v = std_by_output(cfg_v, stds_v)
    nvocab = list(netflix.partition_vocab)
    truths = {"count": np.bincount(netflix.pk, minlength=nP).astype(float),
              "sum": np.bincount(netflix.pk, weights=netflix.values,
                                 minlength=nP),
              "privacy_id_count": np.bincount(npairs % nP,
                                              minlength=nP).astype(float)}
    worst = {}
    for name, truth in truths.items():
        std = std_v[name]
        got = np.array([getattr(out_v[m], name) for m in nvocab])
        err = np.abs(got - truth)
        tol = 16 * std + scan_tolerance(truths["count"], truth)
        if (err > tol).any():
            i = int(np.argmax(err - tol))
            raise AssertionError(f"run (v) {name}: partition {nvocab[i]} "
                                 f"{got[i]} vs numpy {truth[i]}")
        worst[name] = float((err / np.maximum(1.0, np.abs(truth))).max())
    print(f"main (v) the Netflix exactness run on the blocked route, "
          f"{v_blocks} blocks of 4096: {len(out_v)} partitions match the "
          f"numpy group-by (max rel err {json.dumps(worst)})", flush=True)
    # (w) = (r) through aggregate_blocked with row_chunk = 2^22: the
    # host-staged regime (C11 gathers each chunk's survivors).
    kernels.reset_launch_counts()
    phase_w = {}
    torch.cuda.synchronize()
    start = time.perf_counter()
    kept_w, outs_w = large_p.aggregate_blocked(
        qenc.pid, qenc.pk, qenc.values, qenc.valid, *scalars_r, stds_r,
        noise_ops.make_noise_key(9), cfg_r, block_partitions=LARGE_BLOCK,
        row_chunk=1 << 22, phase_times=phase_w, device="cuda",
        dtype=torch.float32)
    torch.cuda.synchronize()
    w_s = time.perf_counter() - start
    counts = dict(kernels.launch_counts)
    n_chunks = len(large_p._chunk_ends(np.sort(qenc.pid), 1 << 22))
    check_launches("run (w)", counts, kernels,
                   dict(gather_rows=n_chunks, block_offsets=n_chunks,
                        block_window_offsets=1),
                   BLOCKED_KERNELS + ("gather_rows", "block_offsets"))
    for name, c in counts.items():
        total[name] += c
    if not np.array_equal(kept_w, np.sort(ids_r)):
        raise AssertionError(f"run (w): kept {len(kept_w)} partitions, (r) "
                             f"kept {len(ids_r)}, or another set")
    worst = check_group_by("w", kept_w, outs_w)
    print(f"main (w) host-staged, row_chunk=2^22 ({n_chunks} chunks): the "
          f"same {len(kept_w)} partitions as (r), matching the numpy "
          f"group-by (max rel err {json.dumps(worst)}) in {w_s * 1e3:.1f} ms "
          f"({card}); phase_times (s) "
          f"{json.dumps({k: round(v, 4) for k, v in phase_w.items()})}; "
          f"launches { {k: v for k, v in counts.items() if v} }", flush=True)
    # Blocked selects on (q)'s data.
    for strategy in ("TRUNCATED_GEOMETRIC", "LAPLACE_THRESHOLDING",
                     "GAUSSIAN_THRESHOLDING"):
        times, kept_n = [], []
        for rep in range(3):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=rep))
            kernels.reset_launch_counts()
            res = engine.select_partitions(
                qenc, tdp.SelectPartitionsParams(
                    max_partitions_contributed=4,
                    partition_selection_strategy=getattr(
                        tdp.PartitionSelectionStrategy, strategy)),
                tdp.DataExtractors())
            acc.compute_budgets()
            torch.cuda.synchronize()
            start = time.perf_counter()
            kept = list(res)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            counts = dict(kernels.launch_counts)
            check_launches(f"blocked select ({strategy})", counts, kernels,
                           dict(block_window_offsets=1, reduce_partitions=0),
                           BLOCKED_KERNELS)
            for name, c in counts.items():
                total[name] += c
            if not kept or len(set(kept)) != len(kept) or len(kept) >= P:
                raise AssertionError(f"blocked select ({strategy}): "
                                     f"{len(kept)} partitions kept")
            kept_n.append(len(kept))
        ms = statistics.median(times) * 1e3
        print(f"select blocked {strategy} l0=4 eps=1 on (q)'s data: {kept_n} "
              f"of {P} partitions kept, {ms:.1f} ms, "
              f"{qenc.n_rows / (ms / 1e3):.4g} rows/s (median of 3: "
              f"{[round(t * 1e3, 1) for t in times]} ms; {card}); launches "
              f"per select { {k: v for k, v in counts.items() if v} }",
              flush=True)
    return total


def large_p_stage_phase(torch, tdp, qenc, netflix, nmax, kernels, large_p,
                        threefry, card):
    """Runs (q) and (v) with CUDA events around every kernel wrapper and a
    host clock around the host key derivation (threefry's fold_in, split
    and bits): pass 1 (C1, C5 bounding, C2, C5 partition, C10), the
    blocks' kernels, the host's key work, waits, drains and the decode."""
    names = ("row_keys", "radix_sort", "bound_rows", "block_window_offsets",
             "reduce_partitions", "release_epilogue", "compact_kept")
    M = tdp.Metrics
    runs = {
        "q": (qenc, [M.COUNT, M.SUM], None, {},
              dict(max_partitions_contributed=4,
                   max_contributions_per_partition=8, min_value=0.0,
                   max_value=5.0)),
        "v": (netflix, [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT],
              list(netflix.partition_vocab),
              dict(large_partition_threshold=4096, block_partitions=4096),
              dict(max_partitions_contributed=nmax[0],
                   max_contributions_per_partition=nmax[1], min_value=1.0,
                   max_value=5.0)),
    }
    key_fns = ("fold_in", "split", "bits")
    for label, (enc, metrics, public, backend, bounds) in runs.items():
        medians = {}
        for rep in range(4):
            records, sorts = [], []
            host = {"host_keys": 0.0}
            depth = [0]
            originals = {n: getattr(kernels, n) for n in names}
            key_originals = {n: getattr(threefry, n) for n in key_fns}

            def timed(name, fn):
                def call(*args, **kwargs):
                    tag = name
                    if name == "radix_sort":
                        sorts.append(None)
                        tag = ("radix_sort[bounding]" if len(sorts) == 1
                               else "radix_sort[partition]")
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
                    records.append((tag, start, end))
                    return out
                return call

            def host_timed(fn):
                def call(*args, **kwargs):
                    depth[0] += 1
                    t = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        depth[0] -= 1
                        if depth[0] == 0:
                            host["host_keys"] += time.perf_counter() - t
                return call

            for n in names:
                setattr(kernels, n, timed(n, originals[n]))
            for n in key_fns:
                setattr(threefry, n, host_timed(key_originals[n]))
            try:
                acc = tdp.NaiveBudgetAccountant(
                    total_epsilon=1.0 if label == "q" else 1e6,
                    total_delta=1e-6)
                engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=rep,
                                                            **backend))
                res = engine.aggregate(enc, tdp.AggregateParams(
                    metrics=metrics, noise_kind=tdp.NoiseKind.LAPLACE,
                    **bounds), tdp.DataExtractors(), public)
                acc.compute_budgets()
                host["host_keys"] = 0.0
                torch.cuda.synchronize()
                with PhaseProbe(large_p) as probe:
                    start = time.perf_counter()
                    out = list(res)
                    torch.cuda.synchronize()
                    end = time.perf_counter()
            finally:
                for n in names:
                    setattr(kernels, n, originals[n])
                for n in key_fns:
                    setattr(threefry, n, key_originals[n])
            if not out:
                raise AssertionError(f"stages ({label}): nothing released")
            pt = probe.records[-1]
            stage = {}
            for name, s, e in records:
                stage[name] = stage.get(name, 0.0) + s.elapsed_time(e)
            stage.update({
                "host_keys": host["host_keys"] * 1e3,
                "p1_bound_compact (wall)": pt["p1_bound_compact"] * 1e3,
                "block_offsets (wall)": pt["block_offsets"] * 1e3,
                "p2_dispatch (wall)": pt["p2_dispatch"] * 1e3,
                "p2_sync_wait (wall)": pt["p2_sync_wait"] * 1e3,
                "p2_drain (wall)": pt["p2_drain"] * 1e3,
                "decode (wall)": (end - pt["returned_at"]) * 1e3,
                "wall": (end - start) * 1e3})
            for name, ms in stage.items():
                medians.setdefault(name, []).append(ms)
        med = {name: round(statistics.median(t[1:]), 4)
               for name, t in medians.items()}
        device = sum(v for k, v in med.items()
                     if "(wall)" not in k and k not in ("wall", "host_keys"))
        print(f"stages ({label}) blocked, float32, ms, median of 3 ({card}): "
              f"{json.dumps(med)}; kernels {device:.3f} ms of {med['wall']:.3f}"
              f" ms wall", flush=True)


def check_launches(label, counts, kernels, want=None, path=BASE_KERNELS):
    """Every kernel of the path launched (and, where given, as often as
    `want` says)."""
    missing = [k for k in path if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label} did not launch {missing}")
    for name, n in (want or {}).items():
        if counts[name] != n:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, expected {n}")


def main_phase(torch, tdp, encoded, kernels, card):
    """The full-size aggregations through DPEngine.aggregate. Returns the
    launch counts summed over its runs."""
    # True per-user maxima, for runs (c) and (e).
    pair_key = encoded.pid.astype(np.int64) * N_MOVIES + encoded.pk
    pairs, pair_rows = np.unique(pair_key, return_counts=True)
    l0_true = int(np.bincount(pairs // N_MOVIES).max())
    linf_true = int(pair_rows.max())
    rows_true = int(np.bincount(encoded.pid).max())
    print(f"data maxima: {l0_true} movies per user, {linf_true} ratings per "
          f"(user, movie), {rows_true} ratings per user", flush=True)
    total = dict.fromkeys(kernels.KERNELS, 0)

    def aggregate(label, metrics, noise, public, eps, seed, **bounds):
        acc = tdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=seed))
        params = tdp.AggregateParams(
            metrics=[getattr(tdp.Metrics, m) for m in metrics],
            noise_kind=getattr(tdp.NoiseKind, noise), min_value=1.0,
            max_value=5.0, **bounds)
        ex = tdp.DataExtractors()
        kernels.reset_launch_counts()
        res = engine.aggregate(encoded, params, ex,
                               list(encoded.partition_vocab)
                               if public else None)
        acc.compute_budgets()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = dict(res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = dict(kernels.launch_counts)
        # With max_contributions, C1 and C2 run their total-bound entries
        # too and C5 sorts by (pid, u0) first.
        check_launches(f"run ({label})", counts, kernels,
                       dict(row_keys=2, bound_rows=2, radix_sort=3)
                       if "max_contributions" in bounds else
                       dict(row_keys=1, bound_rows=1, radix_sort=2))
        for name, n in counts.items():
            total[name] += n
        return out, seconds, counts

    per_partition = dict(max_partitions_contributed=64,
                         max_contributions_per_partition=1)
    runs = {
        "a": (("COUNT", "SUM", "MEAN", "VARIANCE"), "GAUSSIAN", True,
              per_partition),
        "b": (("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE", False,
              per_partition),
        "d": (("COUNT", "SUM", "MEAN"), "LAPLACE", True,
              dict(max_contributions=64)),
    }
    for label, (metrics, noise, public, bounds) in runs.items():
        times = []
        for rep in range(3):
            out, seconds, counts = aggregate(label, metrics, noise, public,
                                             1.0, rep, **bounds)
            times.append(seconds)
            bad = [k for k, v in out.items()
                   if not all(math.isfinite(x) for x in v)]
            if bad or not out:
                raise AssertionError(f"run ({label}): {len(out)} partitions, "
                                     f"{len(bad)} with non-finite values")
        ms = statistics.median(times) * 1e3
        print(f"main ({label}) {'+'.join(metrics)} {noise} "
              f"{'public' if public else 'private'} {bounds}: {len(out)} "
              f"partitions released, {ms:.1f} ms, "
              f"{N_ROWS / (ms / 1e3):.4g} rows/s (median of 3: "
              f"{[round(t * 1e3, 1) for t in times]} ms; {card}); launches "
              f"per aggregate {counts}", flush=True)

    P = encoded.n_partitions
    vocab = list(encoded.partition_vocab)
    true_count = np.bincount(encoded.pk, minlength=P).astype(np.float64)
    true_sum = np.bincount(encoded.pk, weights=encoded.values, minlength=P)
    true_pid = np.bincount(pairs % N_MOVIES, minlength=P)

    def check(label, out, name, truth, tol):
        got = np.array([getattr(out[m], name) for m in vocab])
        err = np.abs(got - truth)
        if (err > tol).any():
            i = int(np.argmax(err - tol))
            raise AssertionError(f"run ({label}) {name}: partition "
                                 f"{vocab[i]} {got[i]} vs numpy {truth[i]}")
        return float((err / np.maximum(1.0, np.abs(truth))).max())

    # (c) exactness at epsilon = 1e6 against a numpy group-by.
    out, seconds, _ = aggregate("c", ("COUNT", "SUM", "PRIVACY_ID_COUNT"),
                                "LAPLACE", True, 1e6, 9,
                                max_partitions_contributed=l0_true,
                                max_contributions_per_partition=linf_true)
    # Laplace noise std of each of the three mechanisms: sqrt(2) l1 / eps.
    eps_each = 1e6 / 3
    std = {"count": math.sqrt(2) * l0_true * linf_true / eps_each,
           "sum": math.sqrt(2) * l0_true * linf_true * 5.0 / eps_each,
           "privacy_id_count": math.sqrt(2) * l0_true / eps_each}
    # 16 noise stds (a false alarm below 1e-5 over all partitions) plus
    # float32 rounding of sums past 2^24.
    worst = {name: check("c", out, name, truth,
                         16 * std[name] + 1e-6 * np.abs(truth))
             for name, truth in (("count", true_count), ("sum", true_sum),
                                 ("privacy_id_count", true_pid))}
    print(f"main (c) epsilon=1e6, l0={l0_true}, linf={linf_true}: "
          f"{len(out)} partitions match the numpy group-by (max rel err "
          f"{json.dumps(worst)}) in {seconds * 1e3:.1f} ms", flush=True)

    # (e) the total bound at the data's largest count per user keeps every
    # row: exact at epsilon = 1e6. MEAN releases count, sum and mean from
    # two Laplace mechanisms (count and the centred sum, mid = 3).
    bounds = dict(max_contributions=rows_true)
    out, seconds, _ = aggregate("e", ("COUNT", "SUM", "MEAN"), "LAPLACE",
                                True, 1e6, 11, **bounds)
    from pipelinedp_tpu_torch import combiners, executor
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1e6, total_delta=1e-6)
    compound = combiners.create_compound_combiner(tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM, tdp.Metrics.MEAN],
        noise_kind=tdp.NoiseKind.LAPLACE, min_value=1.0, max_value=5.0,
        **bounds), acc)
    acc.compute_budgets()
    if [e.kind for e in executor.build_plan(compound)] != ["mean"]:
        raise AssertionError("run (e): expected one MEAN plan entry")
    std_count, std_nsum = executor.compute_noise_stds(compound)
    worst = {
        "count": check("e", out, "count", true_count,
                       16 * std_count + 1e-6 * true_count),
        # sum = mid * dp_count + dp_nsum where dp_count >= 1
        "sum": check("e", out, "sum", true_sum,
                     16 * (3 * std_count + std_nsum) +
                     1e-6 * np.abs(true_sum)),
        # mean = mid + dp_nsum / dp_count, |nsum / count| <= 2
        "mean": check("e", out, "mean", true_sum / true_count,
                      16 * (std_nsum + 2 * std_count) /
                      np.maximum(true_count - 16 * std_count, 1.0) + 1e-5),
    }
    print(f"main (e) epsilon=1e6, max_contributions={rows_true}: "
          f"{len(out)} partitions match the numpy group-by (max rel err "
          f"{json.dumps(worst)}; noise stds count {std_count:.4g}, nsum "
          f"{std_nsum:.4g}) in {seconds * 1e3:.1f} ms", flush=True)
    return total


def select_phase(torch, tdp, encoded, kernels, card):
    """DPEngine.select_partitions at full size for the three strategies.
    Returns the launch counts summed over its runs."""
    total = dict.fromkeys(kernels.KERNELS, 0)
    vocab = set(encoded.partition_vocab)
    for strategy in ("TRUNCATED_GEOMETRIC", "LAPLACE_THRESHOLDING",
                     "GAUSSIAN_THRESHOLDING"):
        times, kept_n = [], []
        for rep in range(3):
            acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=rep))
            params = tdp.SelectPartitionsParams(
                max_partitions_contributed=64,
                partition_selection_strategy=getattr(
                    tdp.PartitionSelectionStrategy, strategy))
            kernels.reset_launch_counts()
            res = engine.select_partitions(encoded, params,
                                           tdp.DataExtractors())
            acc.compute_budgets()
            torch.cuda.synchronize()
            start = time.perf_counter()
            kept = list(res)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            counts = dict(kernels.launch_counts)
            check_launches(f"select ({strategy})", counts, kernels,
                           dict(row_keys=1, bound_rows=1, radix_sort=2))
            for name, n in counts.items():
                total[name] += n
            if not kept or len(set(kept)) != len(kept) or \
                    not set(kept) <= vocab:
                raise AssertionError(f"select ({strategy}): {len(kept)} "
                                     f"partitions kept")
            kept_n.append(len(kept))
        ms = statistics.median(times) * 1e3
        print(f"select {strategy} l0=64 eps=1 delta=1e-6: {kept_n} of "
              f"{len(vocab)} partitions kept, {ms:.1f} ms, "
              f"{N_ROWS / (ms / 1e3):.4g} rows/s (median of 3: "
              f"{[round(t * 1e3, 1) for t in times]} ms; {card}); launches "
              f"per select {counts}", flush=True)
    return total


def profile_phase(torch, tdp, encoded, card):
    """Runs (a), (f) and a select under torch.profiler (graph build and
    budgets outside the window): device busy time = the sum of device
    entries (one stream, so they do not overlap), idle share = 1 - busy /
    wall."""
    from torch.profiler import ProfilerActivity, profile

    from pipelinedp_tpu_torch import kernels

    def run_a():
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=21))
        res = engine.aggregate(encoded, tdp.AggregateParams(
            metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM, tdp.Metrics.MEAN,
                     tdp.Metrics.VARIANCE],
            noise_kind=tdp.NoiseKind.GAUSSIAN, max_partitions_contributed=64,
            max_contributions_per_partition=1, min_value=1.0, max_value=5.0),
            tdp.DataExtractors(), list(encoded.partition_vocab))
        acc.compute_budgets()
        return res

    def run_f():
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=21))
        res = engine.aggregate(encoded, tdp.AggregateParams(
            metrics=[tdp.Metrics.PERCENTILE(10), tdp.Metrics.PERCENTILE(50),
                     tdp.Metrics.PERCENTILE(90), tdp.Metrics.COUNT],
            noise_kind=tdp.NoiseKind.GAUSSIAN, max_partitions_contributed=64,
            max_contributions_per_partition=1, min_value=1.0, max_value=5.0),
            tdp.DataExtractors(), list(encoded.partition_vocab))
        acc.compute_budgets()
        return res

    def run_select():
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=21))
        res = engine.select_partitions(
            encoded, tdp.SelectPartitionsParams(max_partitions_contributed=64),
            tdp.DataExtractors())
        acc.compute_budgets()
        return res

    for label, setup in (("aggregate (a)", run_a), ("aggregate (f)", run_f),
                         ("select", run_select)):
        # C6 is one device operation a call: its cooperative kernel, as
        # many times as the wrapper launched it, and no other C6 kernel.
        # A trace can come back without some of the window's kernels (a
        # whole window empty, or its last kernels missing): the release
        # is run again, up to three times, until the trace holds them.
        for attempt in range(1, 4):
            res = setup()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                list(res)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - start) * 1e3
            device = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            c6_ops = {short_kernel_name(e.key): e.count for e in device
                      if "compact" in e.key or "kept" in e.key}
            c6_calls = kernels.launch_counts["compact_kept"]
            if device and c6_calls >= 1 and \
                    sum(c6_ops.values()) == c6_calls and \
                    all(k.startswith("compact_kernel") for k in c6_ops):
                break
            if attempt == 3:
                raise AssertionError(
                    f"profile {label}: {c6_calls} C6 calls ran the device "
                    f"operations {c6_ops} in each of 3 traces")
        print(f"profile {label}: C6 one device operation a call "
              f"({c6_calls} calls, {json.dumps(c6_ops)}; trace {attempt} "
              f"of 3)", flush=True)
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:12]
        print(f"profile {label}: wall {wall_ms:.1f} ms under the profiler, "
              f"device busy {busy_ms:.2f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f} ({card}); largest [name, ms, "
              f"calls]: " +
              json.dumps([[short_kernel_name(e.key),
                           round(e.self_device_time_total / 1e3, 4), e.count]
                          for e in top]), flush=True)


def short_kernel_name(key: str) -> str:
    """A kernel's name without its parameter list (copies keep theirs)."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return key if key.startswith("Memcpy") else key.split("(")[0]


# --- The streamed ingest (ChunkSource; C12-C14) ------------------------------

INGEST_CHUNK = 1 << 20  # rows a chunk of (x), (y) and (z): 16 chunks
INGEST_THREADS = 4
# The kernels the release kernels' stage wrappers time (kernel_stage_phase
# and ingest_stage_phase).
RELEASE_WRAPPERS = ("row_keys", "radix_sort", "bound_rows",
                    "reduce_partitions", "release_epilogue", "compact_kept")


def stream_chunks(pid, pk, values, rows=None):
    """Raw columns as a list of (pid, pk, values) chunks of `rows` rows
    (default INGEST_CHUNK), views of the columns."""
    rows = rows or INGEST_CHUNK
    return [(pid[i:i + rows], pk[i:i + rows], values[i:i + rows])
            for i in range(0, len(pid), rows)]


def ingest_kernel_phase(torch, dev, key_sets, kernels, device_encode, ingest,
                        card):
    """C12 factorize_codes and C13 lookup_codes on the full-size hash rows
    of three key columns (Netflix users: 480,189 distinct; movies: 17,770;
    (q)'s partitions: ~4.7M), each equal to its plain version, C12 equal to
    C13 and to the host encoder's first-occurrence codes; C12 with the
    distinct count as the ingest passes it (its table sized by it) and
    without it, no C5 launch inside it (its device operations, by name),
    beside torch.unique (not the same function) in turns (three_way);
    C14's grow and fill_tail on 2^24-row buffers, equal to their plain
    versions. Returns the report rows (C12 and C13 on the user hashes, C14
    grow on the host route's buffers)."""
    report = []
    for label, (raw, host_codes) in key_sets.items():
        h1, h2 = ingest.hash_key_column_pair(raw)
        rows = torch.from_numpy(
            device_encode.pack_hash_rows(h1).view(np.int32)).to(dev)
        # The merged table of one chunk: distinct hashes ascending, their
        # first positions.
        s1, _, _, first = ingest._hash_uniques(h1, h2, None)
        n = rows.shape[0]
        hint = len(s1)
        kernels.reset_launch_counts()
        codes, n_unique = kernels.factorize_codes(rows, n_distinct=hint)
        torch.cuda.synchronize()
        if kernels.launch_counts["radix_sort"] != 0:
            raise AssertionError(f"factorize_codes ({label}) launched C5")
        plain_codes, plain_n = kernels.factorize_codes_plain(rows)
        err12 = check_equal(f"factorize_codes ({label})", codes,
                            plain_codes)
        check_equal(f"factorize_codes ({label}) vs the host encoder", codes,
                    torch.from_numpy(host_codes).to(dev))
        unhinted, n_unhinted = kernels.factorize_codes(rows)
        check_equal(f"factorize_codes ({label}) without the count",
                    unhinted, plain_codes)
        if not int(n_unique) == int(n_unhinted) == int(plain_n) == len(s1):
            raise AssertionError(f"factorize_codes ({label}): {n_unique} / "
                                 f"{n_unhinted} / {plain_n} distinct, host "
                                 f"{len(s1)}")
        ops = device_ops(torch, lambda: kernels.factorize_codes(
            rows, n_distinct=hint))
        sort_ops = [k for k in (ops if isinstance(ops, dict) else {})
                    if any(s in k for s in ("sweep_pass", "digit_starts",
                                            "varying_bits"))]
        if sort_ops:
            raise AssertionError(f"factorize_codes ({label}) ran C5's "
                                 f"{sort_ops}")
        table, table_codes = device_encode.build_lookup_table(s1, first, dev)
        looked = kernels.lookup_codes(rows, table, table_codes)
        err13 = check_equal(f"lookup_codes ({label})", looked,
                            kernels.lookup_codes_plain(rows, table,
                                                       table_codes))
        check_equal(f"lookup_codes ({label}) vs factorize_codes", looked,
                    codes)
        key64 = kernels.joined_hash_order(rows[:, 0], rows[:, 1])
        table64 = kernels.joined_hash_order(table[:, 0], table[:, 1])
        v_cap = table.shape[0]
        c12 = (lambda: kernels.factorize_codes(  # noqa: E731
                   rows, n_distinct=hint),
               lambda: kernels.factorize_codes_plain(rows), None,
               # Rows read once, codes written once; one compare a row.
               bound(n * 12 + n * 4 + 4, n))
        c13 = (lambda: kernels.lookup_codes(rows, table,  # noqa: E731
                                            table_codes),
               lambda: kernels.lookup_codes_plain(rows, table, table_codes),
               lambda: torch.searchsorted(table64, key64),
               bound(n * 12 + n * 4 + v_cap * 12,
                     n * 3 * max(1, v_cap.bit_length())))
        ms = {}
        for name, (fn, plain, lib, _) in (("factorize_codes", c12),
                                          ("lookup_codes", c13)):
            ms[name] = (cuda_ms(fn, repeats=10),
                        cuda_ms(plain, repeats=3, warmup=1),
                        cuda_ms(lib, repeats=10) if lib else None)
        unique_ms = cuda_ms(lambda: torch.unique(key64, return_inverse=True),
                            repeats=10)
        unhinted_ms = cuda_ms(lambda: kernels.factorize_codes(rows), 10)
        split = three_way(torch, {
            "C12": c12[0],
            "torch.unique": lambda: torch.unique(key64,
                                                 return_inverse=True)},
            host_calls=200)
        print_three_way(f"ingest, {label}", split, card)
        if ms["factorize_codes"][0] >= unique_ms:
            print(f"kernels[ingest, {label}]: C12 {ms['factorize_codes'][0]:.4f}"
                  f" ms is not below torch.unique's {unique_ms:.4f}",
                  flush=True)
        print(f"kernels[ingest, {label}: {n} rows, {len(s1)} distinct "
              f"hashes]: C12 factorize_codes ms={ms['factorize_codes'][0]:.4f}"
              f" (table of {kernels.factorize_table_plan(n, hint)[0]} slots "
              f"from the count; {unhinted_ms:.4f} ms sized from the rows, "
              f"{kernels.factorize_table_plan(n)[0]} slots) plain_ms="
              f"{ms['factorize_codes'][1]:.4f} bound_ms={c12[3][0]:.3g} "
              f"({c12[3][1]}); device operations {json.dumps(ops)}; "
              f"torch.unique(return_inverse) {unique_ms:.4f} ms (not the same"
              f" function: sorted-order codes); C13 lookup_codes ms="
              f"{ms['lookup_codes'][0]:.4f} plain_ms="
              f"{ms['lookup_codes'][1]:.4f} torch.searchsorted "
              f"{ms['lookup_codes'][2]:.4f} ms bound_ms={c13[3][0]:.3g} "
              f"({c13[3][1]}); both equal their plain versions, each other "
              f"and the host encoder's codes ({card})", flush=True)
        if label == "users":
            for name, entry, err, src, repl in (
                    ("factorize_codes", c12, err12, "factorize_codes.cu",
                     "pipelinedp_tpu/device_encode.py:181"),
                    ("lookup_codes", c13, err13, "lookup_codes.cu",
                     "pipelinedp_tpu/device_encode.py:272")):
                report.append({
                    "name": name, "route": "cuda",
                    "source": f"pipelinedp_tpu_torch/csrc/{src}",
                    "replaces": repl, "launches": 0, "max_abs_err": err,
                    "ms": ms[name][0], "plain_ms": ms[name][1],
                    "bound_ms": entry[3][0], "bound_by": entry[3][1],
                    "library_ms": ms[name][2]})
        del rows, codes, plain_codes, unhinted, looked, key64
    # C14 on the host route's buffers (pid, pk int32; values float32) and
    # the hash route's (two int32[., 3] hash columns).
    n, half = N_ROWS, N_ROWS // 2
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for label, (bufs, fills) in zip(("host route", "hash route"),
                                    c14_buffers(torch, dev, half, gen)):
        row_bytes = sum(b[0].numel() * b.element_size() for b in bufs)
        grown = kernels.grow_rows(bufs, n, fills)
        err_g = max(check_equal(f"grow_rows ({label}) column {j}", g, p)
                    for j, (g, p) in enumerate(zip(
                        grown, kernels.grow_rows_plain(bufs, n, fills))))
        tail = [b.clone() for b in grown]
        kernels.fill_tail(tail, 1, fills)
        want = [b.clone() for b in grown]
        kernels.fill_tail_plain(want, 1, fills)
        err_f = max(check_equal(f"fill_tail ({label}) column {j}", t, w)
                    for j, (t, w) in enumerate(zip(tail, want)))

        def library_grow(bufs=bufs, fills=fills):
            return [torch.cat([b, torch.full((n - half,) + tuple(b.shape[1:]),
                                             f, dtype=b.dtype, device=dev)])
                    for b, f in zip(bufs, fills)]

        grow = (cuda_ms(lambda: kernels.grow_rows(bufs, n, fills), 10),
                cuda_ms(lambda: kernels.grow_rows_plain(bufs, n, fills), 3,
                        1), cuda_ms(library_grow, 10),
                bound(half * row_bytes + n * row_bytes, 0))
        fill = (cuda_ms(lambda: kernels.fill_tail(tail, 1, fills), 10),
                cuda_ms(lambda: kernels.fill_tail_plain(tail, 1, fills), 3,
                        1), bound((n - 1) * row_bytes, 0))
        out[label] = (grow, err_g)
        print(f"kernels[ingest, C14 append_rows, {label}, {row_bytes} B a "
              f"row]: grow {half} -> {n} rows ms={grow[0]:.4f} plain_ms="
              f"{grow[1]:.4f} torch.cat+torch.full {grow[2]:.4f} ms "
              f"bound_ms={grow[3][0]:.3g} ({grow[3][1]}); fill_tail of "
              f"{n - 1} rows ms={fill[0]:.4f} plain_ms={fill[1]:.4f} "
              f"(three Tensor.fill_ calls; no one library call) bound_ms="
              f"{fill[2][0]:.3g} ({fill[2][1]}); both equal their plain "
              f"versions ({card})", flush=True)
        del grown, tail, want
    grow, err_g = out["host route"]
    report.append({
        "name": "append_rows", "route": "cuda",
        "source": "pipelinedp_tpu_torch/csrc/append_rows.cu",
        "replaces": "pipelinedp_tpu/runtime/pipeline.py:325",
        "launches": 0, "max_abs_err": err_g, "ms": grow[0],
        "plain_ms": grow[1], "bound_ms": grow[3][0], "bound_by": grow[3][1],
        "library_ms": grow[2]})
    return report


def ingest_parity_phase(torch, tdp, rng):
    """Small streamed aggregations and selections on the card (float64)
    against the same on the CPU: both encode modes, encode_threads 0 and
    2, the dense route and the blocked one (threshold 16, 8 partitions a
    block): the same kept partitions, values within 1e-9 relative."""
    n = 20000
    users = rng.integers(0, 3000, n)
    movies = (rng.integers(0, 60, n)**2) // 60
    ratings = rng.integers(1, 6, n).astype(np.float64)
    chunks = stream_chunks(users, movies, ratings, 3000)
    M = tdp.Metrics
    for mode in ("host", "hash_device"):
        for threads in (0, 2):
            for route, knobs in (("dense", {}), ("blocked", dict(
                    large_partition_threshold=16, block_partitions=8))):
                released, kept = [], []
                for device in ("cuda", "cpu"):
                    backend = dict(device=device, noise_seed=5,
                                   dtype=torch.float64,
                                   encode_threads=threads, **knobs)
                    acc = tdp.NaiveBudgetAccountant(total_epsilon=2.0,
                                                    total_delta=1e-6)
                    res = tdp.DPEngine(acc, tdp.TorchBackend(
                        **backend)).aggregate(
                            tdp.ChunkSource(chunks, encode_mode=mode),
                            tdp.AggregateParams(
                                metrics=[M.COUNT, M.SUM, M.MEAN],
                                noise_kind=tdp.NoiseKind.LAPLACE,
                                max_partitions_contributed=4,
                                max_contributions_per_partition=2,
                                min_value=1.0, max_value=5.0),
                            tdp.DataExtractors())
                    acc.compute_budgets()
                    released.append(dict(res))
                    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0,
                                                    total_delta=1e-6)
                    res = tdp.DPEngine(acc, tdp.TorchBackend(
                        **backend)).select_partitions(
                            tdp.ChunkSource(chunks, encode_mode=mode),
                            tdp.SelectPartitionsParams(
                                max_partitions_contributed=4),
                            tdp.DataExtractors())
                    acc.compute_budgets()
                    kept.append(list(res))
                gpu, cpu = released
                if set(gpu) != set(cpu) or not gpu:
                    raise AssertionError(
                        f"streamed parity {mode} {threads} {route}: "
                        f"released partitions differ ({len(gpu)} vs "
                        f"{len(cpu)})")
                worst = max(abs(a - b) / max(1.0, abs(b)) for k in cpu
                            for a, b in zip(gpu[k], cpu[k]))
                if worst > 1e-9:
                    raise AssertionError(f"streamed parity {mode} {threads} "
                                         f"{route}: rel err {worst}")
                if kept[0] != kept[1] or not kept[0]:
                    raise AssertionError(
                        f"streamed select parity {mode} {threads} {route}: "
                        f"cuda kept {len(kept[0])}, cpu {len(kept[1])}")
                print(f"parity[streamed {mode}, encode_threads {threads}, "
                      f"{route}]: {len(gpu)} partitions, cuda float64 vs "
                      f"cpu float64 max rel err {worst:.3g}; select: "
                      f"{len(kept[0])} kept, identical lists", flush=True)


class IngestClock:
    """Host seconds inside executor.stream_chunk_source (with a device
    synchronisation at its end): the ingest's share of a streamed run."""

    def __init__(self, torch, executor):
        self.torch, self.executor = torch, executor
        self.seconds = 0.0

    def __enter__(self):
        self.original = original = self.executor.stream_chunk_source

        def timed(*args, **kwargs):
            start = time.perf_counter()
            out = original(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - start
            return out

        self.executor.stream_chunk_source = timed
        return self

    def __exit__(self, *exc):
        self.executor.stream_chunk_source = self.original


# (label, baseline run, encode mode, metrics, noise, public, bounds, path)
STREAMED_RUNS = {
    "x": ("a", "host", ("COUNT", "SUM", "MEAN", "VARIANCE"), "GAUSSIAN",
          True, "netflix", BASE_KERNELS + ("append_rows",)),
    "y": ("b", "hash_device", ("COUNT", "SUM", "PRIVACY_ID_COUNT"),
          "LAPLACE", False, "netflix",
          BASE_KERNELS + ("factorize_codes", "append_rows")),
    "z": ("q", "hash_device", ("COUNT", "SUM"), "LAPLACE", False, "q",
          BLOCKED_KERNELS + ("factorize_codes", "append_rows")),
}


def streamed_release(torch, tdp, kernels, executor, label, col, vocab, seed,
                     backend):
    """One aggregate of a STREAMED_RUNS run (col: the pre-encoded baseline
    or a ChunkSource): (released dict, wall seconds, ingest seconds, launch
    counts)."""
    _, _, metrics, noise, public, data, _ = STREAMED_RUNS[label]
    bounds = (dict(max_partitions_contributed=64,
                   max_contributions_per_partition=1, min_value=1.0,
                   max_value=5.0) if data == "netflix" else
              dict(max_partitions_contributed=4,
                   max_contributions_per_partition=8, min_value=0.0,
                   max_value=5.0))
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=seed, **backend))
    kernels.reset_launch_counts()
    res = engine.aggregate(
        col, tdp.AggregateParams(
            metrics=[getattr(tdp.Metrics, m) for m in metrics],
            noise_kind=getattr(tdp.NoiseKind, noise), **bounds),
        tdp.DataExtractors(), list(vocab) if public else None)
    acc.compute_budgets()
    torch.cuda.synchronize()
    with IngestClock(torch, executor) as clock:
        start = time.perf_counter()
        out = dict(res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    return out, seconds, clock.seconds, dict(kernels.launch_counts)


def ingest_main_phase(torch, tdp, data, kernels, executor, card):
    """(x), (y) and (z): (a), (b) and (q) through DPEngine.aggregate of a
    ChunkSource of their raw columns (16 chunks of 2^20 rows,
    encode_threads 4; (x) encode_mode "host", (y) and (z) "hash_device"),
    each release equal (==) to its baseline's with the same seed, run just
    before it on the pre-encoded data. Returns the launch counts summed
    over the streamed runs."""
    total = dict.fromkeys(kernels.KERNELS, 0)
    for label, (base, mode, metrics, noise, public, which, path) in \
            STREAMED_RUNS.items():
        raw, encoded = data[which]
        chunks = stream_chunks(*raw)
        times, base_times, shares = [], [], []
        for seed in range(3):
            want, base_s, _, _ = streamed_release(
                torch, tdp, kernels, executor, label, encoded,
                encoded.partition_vocab, seed, {})
            got, seconds, ingest_s, counts = streamed_release(
                torch, tdp, kernels, executor, label,
                tdp.ChunkSource(chunks, encode_mode=mode),
                encoded.partition_vocab, seed,
                dict(encode_threads=INGEST_THREADS))
            check_launches(f"run ({label})", counts, kernels, path=path)
            if got != want or not got:
                diff = [k for k in want if got.get(k) != want[k]]
                raise AssertionError(
                    f"run ({label}) seed {seed}: {len(got)} partitions "
                    f"released, ({base}) {len(want)}; {len(diff)} differ")
            for name, c in counts.items():
                total[name] += c
            times.append(seconds)
            base_times.append(base_s)
            shares.append(ingest_s / seconds)
        ms = statistics.median(times) * 1e3
        n_rows = len(raw[0])
        print(f"main ({label}) = ({base}) through ChunkSource, {len(chunks)}"
              f" chunks, encode_threads {INGEST_THREADS}, encode_mode "
              f"{mode}: {len(got)} partitions released, equal (==) to ("
              f"{base})'s for seeds 0-2; {ms:.1f} ms, "
              f"{n_rows / (ms / 1e3):.4g} rows/s (median of 3: "
              f"{[round(t * 1e3, 1) for t in times]} ms), ingest share "
              f"{statistics.median(shares):.3f} "
              f"({[round(s, 3) for s in shares]}); ({base}) pre-encoded in "
              f"the same call: {[round(t * 1e3, 1) for t in base_times]} ms "
              f"({card}); launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
    return total


class StageClock:
    """CUDA events around kernel wrappers and host clocks around host
    functions, by stage; a wrapper called inside another timed one is part
    of the outer stage."""

    def __init__(self, torch):
        self.torch = torch
        self.events, self.host = [], {}
        self.active = 0

    def device(self, stage, fn, stream_arg=None):
        def call(*args, **kwargs):
            if self.active:
                return fn(*args, **kwargs)
            stream = args[stream_arg] if stream_arg is not None else None
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self.active += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.active -= 1
            end.record(stream)
            self.events.append((stage, start, end))
            return out
        return call

    def host_fn(self, stage, fn):
        def call(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(stage, time.perf_counter() - start)
        return call

    def add(self, stage, seconds):
        # The encode workers add concurrently: list.append is atomic.
        self.host.setdefault(stage, []).append(seconds * 1e3)

    def stages(self):
        out = {k: sum(v) for k, v in self.host.items()}
        for stage, s, e in self.events:
            out[stage] = out.get(stage, 0.0) + s.elapsed_time(e)
        return out


def ingest_stage_phase(torch, tdp, data, kernels, executor, ingest,
                       rt_pipeline, encode_s, card):
    """(a) pre-encoded, (x) and (y) with their wall time split: the host
    encode (the workers' busy time, summed over threads; the consumer's
    vocabulary merge), the host-to-device copies (CUDA events on the copy
    stream; for (a) around executor.padded_to_device), C14, C12 / C13, the
    release kernels, and the rest (the host's release setup and decode)."""
    raw, encoded = data["netflix"]
    chunks = stream_chunks(*raw)
    patches = [
        (kernels, n, "release kernels") for n in RELEASE_WRAPPERS] + [
        (kernels, "factorize_codes", "C12 factorize_codes"),
        (kernels, "lookup_codes", "C13 lookup_codes"),
        (kernels, "fill_tail", "C14 append_rows"),
        (kernels, "grow_rows", "C14 append_rows")]
    for label in ("a", "x", "y"):
        medians = {}
        for rep in range(4):
            clock = StageClock(torch)
            saved = []

            def patch(obj, name, wrapped):
                saved.append((obj, name, getattr(obj, name)))
                setattr(obj, name, wrapped)

            for obj, name, stage in patches:
                patch(obj, name, clock.device(stage, getattr(obj, name)))
            patch(executor, "padded_to_device",
                  clock.device("h2d", executor.padded_to_device))
            patch(rt_pipeline, "upload_rows",
                  clock.device("h2d", rt_pipeline.upload_rows, 2))
            for name in ("_prepare_chunk", "_prepare_hash_chunk"):
                patch(ingest, name,
                      clock.host_fn("host encode busy", getattr(ingest,
                                                                name)))
            patch(ingest.ChunkedVocabEncoder, "merge",
                  clock.host_fn("vocabulary merge",
                                ingest.ChunkedVocabEncoder.merge))
            try:
                if label == "a":
                    col, backend = encoded, {}
                else:
                    col = tdp.ChunkSource(chunks, encode_mode=(
                        "host" if label == "x" else "hash_device"))
                    backend = dict(encode_threads=INGEST_THREADS)
                _, wall, ingest_s, _ = streamed_release(
                    torch, tdp, kernels, executor,
                    {"a": "x", "x": "x", "y": "y"}[label], col,
                    encoded.partition_vocab, rep, backend)
            finally:
                for obj, name, original in reversed(saved):
                    setattr(obj, name, original)
            stage = clock.stages()
            stage["wall"] = wall * 1e3
            if label != "a":
                stage["ingest wall"] = ingest_s * 1e3
            for name, ms in stage.items():
                medians.setdefault(name, []).append(ms)
        # The first of the four runs warms the allocator.
        med = {name: round(statistics.median(t[1:]), 4)
               for name, t in medians.items()}
        front = med.get("ingest wall", med.get("h2d", 0.0))
        rest = med["wall"] - front - med.get("release kernels", 0.0)
        extra = (f"; host encode before the window (columnar.encode_columns "
                 f"of the raw columns) {encode_s * 1e3:.1f} ms"
                 if label == "a" else "")
        print(f"stages ({label}) ms, median of 3 ({card}): {json.dumps(med)};"
              f" the rest (wall - {'ingest wall' if label != 'a' else 'h2d'}"
              f" - release kernels) {rest:.3f} ms{extra}", flush=True)


# --- PLD accounting (C15, C16) and dataset histograms (C17, C18) -------------

FP64_OPS_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores, data sheet
PLD_D = 1e-4  # the accountant's default discretization
PLD_EPS, PLD_DELTA = 1.0, 1e-6


def pld_trail(pld, rng):
    """A tenant trail of 200 distinct mechanisms: Gaussian sigma and
    Laplace b log-spaced in [0.5, 20] (100 each), multiplicities 1-64."""
    plds, counts = [], []
    for scale in np.geomspace(0.5, 20.0, 100):
        for build in (pld.from_gaussian_mechanism,
                      pld.from_laplace_mechanism):
            plds.append(build(float(scale), PLD_D))
            counts.append(int(rng.integers(1, 65)))
    return plds, counts


def check_pld_close(label, card, host):
    """The 1e-9 gate of tests/test_pld_compose.py: every composed
    probability and the epsilon at delta = 1e-6."""
    if len(card.probs) != len(host.probs) or \
            card._lower_index != host._lower_index:
        raise AssertionError(f"{label}: grids differ")
    err = float(np.max(np.abs(card.probs - host.probs)))
    eps_card = card.get_epsilon_for_delta(1e-6)
    eps_host = host.get_epsilon_for_delta(1e-6)
    if not err <= 1e-9 or not abs(eps_card - eps_host) <= 1e-9:
        raise AssertionError(f"{label}: max |card - host| {err}, epsilon "
                             f"{eps_card} vs {eps_host}")
    return err, eps_card, eps_host


def complex_diff(got, want, what, tol):
    """max |got - want| of two complex128 tensors, held to tol."""
    err = float((got - want).abs().max())
    if not err <= tol:
        raise AssertionError(f"{what}: max |kernel - plain| {err} > {tol}")
    return err


def pld_kernel_phase(torch, dev, kernels, card):
    """C15 pld_fft and C16 log_spectrum: compose_plds on the card on the
    four sample PLDs and on a full-width trail (200 mechanisms, 1e-4,
    coarsened to DEFAULT_MAX_GRID, L = 2^21), each within 1e-9 of the host
    path; both kernels against their plain versions at the trail's shapes;
    their times beside torch.fft and _compose_pmfs_host. Returns the report
    rows and the launch counts of the full-width compose_plds run."""
    from pipelinedp_tpu_torch.accounting import compose, pld
    sample = [pld.from_gaussian_mechanism(1.0, 1e-3),
              pld.from_gaussian_mechanism(4.0, 1e-3),
              pld.from_laplace_mechanism(1.0, 1e-3),
              pld.from_laplace_mechanism(0.5, 1e-3)]
    err4 = check_pld_close(
        "compose_plds(device=True), 4 sample PLDs",
        compose.compose_plds(sample, [2, 3, 1, 2], device=True),
        compose.compose_plds(sample, [2, 3, 1, 2], device=False))
    print(f"pld[4 sample PLDs, counts 2/3/1/2]: card vs host max abs err "
          f"{err4[0]:.3g}, epsilon(1e-6) {err4[1]!r} vs {err4[2]!r}",
          flush=True)

    rng = np.random.default_rng(SEED)
    start = time.perf_counter()
    plds, counts = pld_trail(pld, rng)
    build_s = time.perf_counter() - start
    start = time.perf_counter()
    coarse = compose.coarsen_to_fit(plds, counts, compose.DEFAULT_MAX_GRID)
    coarsen_s = time.perf_counter() - start
    total_len = compose._projected_len(coarse, counts)
    length = compose._next_fast_len(total_len)
    if length != compose.DEFAULT_MAX_GRID:
        raise AssertionError(f"full-width trail: L = {length}, expected "
                             f"{compose.DEFAULT_MAX_GRID}")
    pmfs = [p.probs for p in coarse]
    start = time.perf_counter()
    host_probs = compose._compose_pmfs_host(pmfs, counts, total_len)
    host_s = time.perf_counter() - start

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    # No device given: the default runs C15 / C16 on the card.
    got = compose.compose_plds(plds, counts,
                               max_grid=compose.DEFAULT_MAX_GRID)
    wall_s = time.perf_counter() - start
    launches = dict(kernels.launch_counts)
    check_launches("compose_plds(), full width", launches,
                   kernels, path=("pld_fft", "log_spectrum"))
    host = pld.PrivacyLossDistribution(host_probs, got._lower_index,
                                       got.interval, got.infinity_mass)
    err, eps_card, eps_host = check_pld_close(
        "compose_plds(), full width", got, host)
    print(f"pld[full width: {len(plds)} mechanisms, {sum(counts)} "
          f"compositions, interval {got.interval:.4g} after coarsening, L = "
          f"{length}]: card vs host max abs err {err:.3g}, epsilon(1e-6) "
          f"{eps_card!r} vs {eps_host!r}; compose_plds() on the card "
          f"{wall_s * 1e3:.1f} ms wall (coarsening included, "
          f"{coarsen_s * 1e3:.1f} ms alone), _compose_pmfs_host "
          f"{host_s * 1e3:.1f} ms, PLD construction {build_s * 1e3:.1f} ms; "
          f"launches { {k: v for k, v in launches.items() if v} } ({card})",
          flush=True)

    # The kernels against their plain versions at the trail's shapes:
    # chunk 0 (64 rows), the accumulator over every chunk, the inverse.
    f64, c128 = torch.float64, torch.complex128
    rows = compose._SPECTRUM_ROWS

    def block_of(chunk):
        block = torch.zeros((len(chunk), length), dtype=f64, device=dev)
        for i, pmf in enumerate(chunk):
            block[i, :len(pmf)] = torch.from_numpy(pmf).to(dev)
        return block

    m = length // 2 + 1
    acc = torch.zeros(m, dtype=c128, device=dev)
    acc_plain = torch.zeros(m, dtype=c128, device=dev)
    err15 = err16 = 0.0
    for first in range(0, len(pmfs), rows):
        block = block_of(pmfs[first:first + rows])
        spec = kernels.pld_rfft(block)
        # Rows sum to at most 1, so every bin is at most 1 in magnitude.
        err15 = max(err15, complex_diff(spec, kernels.pld_rfft_plain(block),
                                        "pld_rfft", 1e-12))
        w = torch.tensor(counts[first:first + rows], dtype=f64, device=dev)
        kernels.log_spectrum_accumulate(spec, w, acc)
        kernels.log_spectrum_accumulate_plain(spec, w, acc_plain)
        if first == 0:
            block0, spec0, w0 = block, spec, w
        del block, spec
    alive = torch.isfinite(acc.real)
    if not torch.equal(alive, torch.isfinite(acc_plain.real)):
        raise AssertionError("log_spectrum_accumulate: dead bins differ")
    # Sums of up to 200 weighted logs: 1e-12 relative to their size.
    rel = ((acc - acc_plain).abs()[alive] /
           (1.0 + acc_plain.abs()[alive])).max()
    if not float(rel) <= 1e-12:
        raise AssertionError(f"log_spectrum_accumulate: rel err {float(rel)}")
    err16 = float((acc - acc_plain).abs()[alive].max())
    spectrum = kernels.log_spectrum_finalize(acc)
    err16 = max(err16, complex_diff(
        spectrum, kernels.log_spectrum_finalize_plain(acc),
        "log_spectrum_finalize", 1e-12))
    inv = kernels.pld_irfft(spectrum[None, :], length)
    err15i = float((inv - kernels.pld_irfft_plain(spectrum[None, :],
                                                  length)).abs().max())
    if not err15i <= 1e-12:
        raise AssertionError(f"pld_irfft: max |kernel - plain| {err15i}")
    # The kernel against its step-by-step model (kernels.pld_rfft_four_step
    # / pld_irfft_four_step, on the CPU) within 1e-13: one-pass plans (L =
    # 2^11 and 2^12: one block pass of 1024 / 2048 points) on three pmf
    # rows, and the trail's two-pass plan on three rows of chunk 0.
    err_model = 0.0
    mrng = np.random.default_rng(SEED + 7)
    for m_len, m_block in ((1 << 11, None), (1 << 12, None),
                           (length, block0[:3])):
        if m_block is None:
            m_rows = mrng.random((3, m_len))
            m_block = torch.from_numpy(
                m_rows / m_rows.sum(axis=1, keepdims=True)).to(dev)
        m_block = m_block.contiguous()
        m_spec = kernels.pld_rfft(m_block)
        err_model = max(err_model, complex_diff(
            m_spec.cpu(), kernels.pld_rfft_four_step(m_block.cpu()),
            f"pld_rfft vs its model, L = {m_len}", 1e-13))
        m_inv = kernels.pld_irfft(m_spec, m_len).cpu()
        m_err = float((m_inv - kernels.pld_irfft_four_step(
            m_spec.cpu(), m_len)).abs().max())
        if not m_err <= 1e-13:
            raise AssertionError(f"pld_irfft vs its model, L = {m_len}: "
                                 f"max diff {m_err}")
        err_model = max(err_model, m_err)

    r0 = block0.shape[0]
    scratch_acc = torch.zeros(m, dtype=c128, device=dev)
    times = {
        "rfft": (cuda_ms(lambda: kernels.pld_rfft(block0), 5),
                 cuda_ms(lambda: kernels.pld_rfft_plain(block0), 5)),
        "irfft": (cuda_ms(lambda: kernels.pld_irfft(spectrum[None, :],
                                                    length), 5),
                  cuda_ms(lambda: kernels.pld_irfft_plain(
                      spectrum[None, :], length), 5)),
        "accumulate": (
            cuda_ms(lambda: kernels.log_spectrum_accumulate(
                spec0, w0, scratch_acc), 5),
            cuda_ms(lambda: kernels.log_spectrum_accumulate_plain(
                spec0, w0, scratch_acc), 3, 1)),
        "finalize": (cuda_ms(lambda: kernels.log_spectrum_finalize(acc), 5),
                     cuda_ms(lambda: kernels.log_spectrum_finalize_plain(
                         acc), 3, 1)),
    }
    log2 = length.bit_length() - 1
    b15 = bound(8 * r0 * length + 16 * r0 * m,
                  2.5 * r0 * length * log2, FP64_OPS_PER_S)
    b15i = bound(16 * m + 8 * length, 2.5 * length * log2, FP64_OPS_PER_S)
    # A weighted complex log a bin a row: two multiplies and two adds
    # counted (the log, hypot and atan2 are not).
    b16 = bound(16 * r0 * m + 32 * m + 8 * r0, 4 * r0 * m, FP64_OPS_PER_S)
    b16f = bound(32 * m, 4 * m, FP64_OPS_PER_S)
    print(f"kernels[pld, L = {length}, {r0} rows a chunk]: C15 rfft "
          f"ms={times['rfft'][0]:.4f} (torch.fft.rfft, the plain version and "
          f"the library call, {times['rfft'][1]:.4f}) bound_ms={b15[0]:.3g} "
          f"({b15[1]}, FP64 non-tensor {FP64_OPS_PER_S:.3g} flop/s); C15 "
          f"irfft ms={times['irfft'][0]:.4f} (torch.fft.irfft "
          f"{times['irfft'][1]:.4f}) bound_ms={b15i[0]:.3g} ({b15i[1]}); C16 "
          f"accumulate ms={times['accumulate'][0]:.4f} plain_ms="
          f"{times['accumulate'][1]:.4f} bound_ms={b16[0]:.3g} ({b16[1]}); "
          f"C16 finalize ms={times['finalize'][0]:.4f} plain_ms="
          f"{times['finalize'][1]:.4f} bound_ms={b16f[0]:.3g} ({b16f[1]}); "
          f"max |kernel - plain| rfft {err15:.3g}, irfft {err15i:.3g}, "
          f"log_spectrum {err16:.3g}; C15 vs its four-step model (plans "
          f"{kernels.pld_fft_plan(1 << 10)}, {kernels.pld_fft_plan(1 << 11)},"
          f" {kernels.pld_fft_plan(length // 2)}) {err_model:.3g} ({card})",
          flush=True)
    report = [
        {"name": "pld_fft", "route": "cuda",
         "source": "pipelinedp_tpu_torch/csrc/pld_fft.cu",
         "replaces": "pipelinedp_tpu/accounting/compose.py:143",
         "launches": 0, "max_abs_err": max(err15, err15i),
         "ms": times["rfft"][0], "plain_ms": times["rfft"][1],
         "bound_ms": b15[0], "bound_by": b15[1],
         "library_ms": times["rfft"][1]},
        {"name": "log_spectrum", "route": "cuda",
         "source": "pipelinedp_tpu_torch/csrc/log_spectrum.cu",
         "replaces": "pipelinedp_tpu/accounting/compose.py:143",
         "launches": 0, "max_abs_err": err16,
         "ms": times["accumulate"][0], "plain_ms": times["accumulate"][1],
         "bound_ms": b16[0], "bound_by": b16[1], "library_ms": None},
    ]
    return report, launches


class StdsProbe:
    """Records the noise stds executor.compute_noise_stds hands the
    kernels."""

    def __init__(self, executor):
        self.executor = executor
        self.stds = []

    def __enter__(self):
        self.original = original = self.executor.compute_noise_stds

        def probed(*args, **kwargs):
            out = original(*args, **kwargs)
            self.stds.append(np.array(out))
            return out

        self.executor.compute_noise_stds = probed
        return self

    def __exit__(self, *exc):
        self.executor.compute_noise_stds = self.original


PLD_RUNS = {
    "a": (("COUNT", "SUM", "MEAN"), "GAUSSIAN", True),
    "b": (("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE", False),
}


def pld_expected_stds(tdp, acc, params):
    """The slot stds the accountant's specs give on the host, in plan
    order: MEAN's (count, normalized sum) or each metric's own mechanism."""
    from pipelinedp_tpu_torch import dp_computations as dpc
    specs = [m.mechanism_spec for m in acc._mechanisms
             if m.mechanism_spec.mechanism_type != tdp.MechanismType.GENERIC]
    if tdp.Metrics.MEAN in params.metrics:
        sens = [dpc.compute_sensitivities_for_count(params),
                dpc.compute_sensitivities_for_normalized_sum(params)]
    else:
        by_metric = {
            tdp.Metrics.COUNT: dpc.compute_sensitivities_for_count,
            tdp.Metrics.SUM: dpc.compute_sensitivities_for_sum,
            tdp.Metrics.PRIVACY_ID_COUNT:
                dpc.compute_sensitivities_for_privacy_id_count}
        sens = [by_metric[m](params) for m in params.metrics]
    return np.array([dpc.create_additive_mechanism(spec, s).std
                     for spec, s in zip(specs, sens)])


def pld_release_phase(torch, tdp, encoded, nmax, kernels, executor, rng,
                      card):
    """DPEngine.aggregate under PLDBudgetAccountant(1.0, 1e-6, 1e-4) on the
    card: (a) COUNT+SUM+MEAN, Gaussian, public and (b) COUNT+SUM+
    PRIVACY_ID_COUNT, Laplace, private at 2^24 Netflix rows (float32), the
    kernels' stds equal to those of the accountant's specs and the composed
    epsilon within the budget; card = CPU (float64) on a small input; the
    epsilon = 1e6 twin of (a) at the true maxima against numpy. Returns the
    launch counts summed over its runs."""
    total = dict.fromkeys(kernels.KERNELS, 0)
    vocab = list(encoded.partition_vocab)
    for label, (metrics, noise, public) in PLD_RUNS.items():
        walls, budget_s = [], []
        for rep in range(3):
            params = tdp.AggregateParams(
                metrics=[getattr(tdp.Metrics, m) for m in metrics],
                noise_kind=getattr(tdp.NoiseKind, noise),
                max_partitions_contributed=64,
                max_contributions_per_partition=1, min_value=1.0,
                max_value=5.0)
            acc = tdp.PLDBudgetAccountant(PLD_EPS, PLD_DELTA, PLD_D)
            engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=rep))
            kernels.reset_launch_counts()
            res = engine.aggregate(encoded, params, tdp.DataExtractors(),
                                   vocab if public else None)
            start = time.perf_counter()
            acc.compute_budgets()
            budget_s.append(time.perf_counter() - start)
            torch.cuda.synchronize()
            with StdsProbe(executor) as probe:
                start = time.perf_counter()
                out = dict(res)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - start)
            counts = dict(kernels.launch_counts)
            check_launches(f"PLD run ({label})", counts, kernels)
            for name, c in counts.items():
                total[name] += c
            want = pld_expected_stds(tdp, acc, params)
            if len(probe.stds) != 1 or not np.array_equal(probe.stds[0],
                                                          want):
                raise AssertionError(f"PLD run ({label}): kernel stds "
                                     f"{probe.stds} vs the accountant's "
                                     f"{want}")
            eps = acc._compose_distributions(
                acc.minimum_noise_std).get_epsilon_for_delta(PLD_DELTA)
            if not eps <= PLD_EPS:
                raise AssertionError(f"PLD run ({label}): composed epsilon "
                                     f"{eps} > {PLD_EPS}")
            bad = [k for k, v in out.items()
                   if not all(math.isfinite(x) for x in v)]
            if bad or not out:
                raise AssertionError(f"PLD run ({label}): {len(out)} "
                                     f"partitions, {len(bad)} non-finite")
        ms = statistics.median(walls) * 1e3
        print(f"pld main ({label}) {'+'.join(metrics)} {noise} "
              f"{'public' if public else 'private'}, PLDBudgetAccountant("
              f"{PLD_EPS}, {PLD_DELTA}, {PLD_D}): {len(out)} partitions; "
              f"minimum_noise_std {acc.minimum_noise_std!r}, slot stds "
              f"{want.tolist()} equal the accountant's, composed epsilon "
              f"{eps!r}; compute_budgets host "
              f"{[round(t * 1e3, 1) for t in budget_s]} ms (first: empty "
              f"spectrum cache); release {ms:.1f} ms, "
              f"{N_ROWS / (ms / 1e3):.4g} rows/s (median of 3: "
              f"{[round(t * 1e3, 1) for t in walls]} ms; {card}); launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)

    # Card = CPU at a small size, float64.
    n = 20000
    users = rng.integers(0, 3000, n)
    movies = (rng.integers(0, 60, n)**2) // 60
    ratings = rng.integers(1, 6, n).astype(np.float64)
    rows = list(zip(users.tolist(), movies.tolist(), ratings.tolist()))
    for label, (metrics, noise, public) in PLD_RUNS.items():
        results = []
        for device in ("cuda", "cpu"):
            acc = tdp.PLDBudgetAccountant(2.0, 1e-6, 1e-3)
            res = tdp.DPEngine(acc, tdp.TorchBackend(
                device=device, noise_seed=5, dtype=torch.float64)).aggregate(
                    rows, tdp.AggregateParams(
                        metrics=[getattr(tdp.Metrics, m) for m in metrics],
                        noise_kind=getattr(tdp.NoiseKind, noise),
                        max_partitions_contributed=4,
                        max_contributions_per_partition=2, min_value=1.0,
                        max_value=5.0),
                    tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                       partition_extractor=lambda r: r[1],
                                       value_extractor=lambda r: r[2]),
                    sorted(set(movies.tolist())) if public else None)
            acc.compute_budgets()
            results.append(dict(res))
        gpu, cpu = results
        if set(gpu) != set(cpu) or not gpu:
            raise AssertionError(f"PLD parity ({label}): partitions differ "
                                 f"({len(gpu)} vs {len(cpu)})")
        worst = max(abs(a - b) / max(1.0, abs(b)) for k in cpu
                    for a, b in zip(gpu[k], cpu[k]))
        if worst > 1e-9:
            raise AssertionError(f"PLD parity ({label}): rel err {worst}")
        print(f"parity[PLD ({label})]: {len(gpu)} partitions, cuda float64 "
              f"vs cpu float64 max rel err {worst:.3g}", flush=True)

    # The epsilon = 1e6 twin of (a): the accountant's naive fallback; exact
    # aggregates within 16 noise stds and float32 rounding.
    l0_true, linf_true = nmax[:2]
    params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM, tdp.Metrics.MEAN],
        noise_kind=tdp.NoiseKind.GAUSSIAN, max_partitions_contributed=l0_true,
        max_contributions_per_partition=linf_true, min_value=1.0,
        max_value=5.0)
    acc = tdp.PLDBudgetAccountant(1e6, PLD_DELTA, PLD_D)
    kernels.reset_launch_counts()
    res = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=3)).aggregate(
        encoded, params, tdp.DataExtractors(), vocab)
    acc.compute_budgets()
    with StdsProbe(executor) as probe:
        out = dict(res)
    counts = dict(kernels.launch_counts)
    check_launches("PLD run (a) at epsilon 1e6", counts, kernels)
    for name, c in counts.items():
        total[name] += c
    std_count, std_nsum = probe.stds[0]
    P = encoded.n_partitions
    true_count = np.bincount(encoded.pk, minlength=P).astype(np.float64)
    true_sum = np.bincount(encoded.pk, weights=encoded.values, minlength=P)
    worst = {}
    for name, truth, tol in (
            ("count", true_count, 16 * std_count + 1e-6 * true_count),
            ("sum", true_sum, 16 * (3 * std_count + std_nsum) +
             1e-6 * np.abs(true_sum))):
        got = np.array([getattr(out[m], name) for m in vocab])
        err = np.abs(got - truth)
        if (err > tol).any():
            i = int(np.argmax(err - tol))
            raise AssertionError(f"PLD run (a) at epsilon 1e6 {name}: "
                                 f"{vocab[i]} {got[i]} vs numpy {truth[i]}")
        worst[name] = float((err / np.maximum(1.0, truth)).max())
    print(f"pld main (a) at epsilon 1e6, l0 = {l0_true}, linf = {linf_true}: "
          f"{len(out)} "
          f"partitions match the numpy group-by (max rel err "
          f"{json.dumps(worst)}; stds {std_count:.4g}, {std_nsum:.4g})",
          flush=True)
    return total


def check_float_hist(label, got, want, values, mask):
    """C18's float entry against its plain version: lo, hi, edges, counts
    and maxes equal; each bucket's sum (the float32 of a float64 sum, added
    in another order on the card) within 1e-5 of the sum of its |v|.
    Returns the largest |kernel - plain| of the sums."""
    import torch
    from pipelinedp_tpu_torch import kernels
    for j, name in ((0, "lo_hi"), (1, "edges"), (2, "counts"), (4, "maxes")):
        check_equal(f"{label} {name}", got[j], want[j])
    edges, counts = want[1], want[2]
    v = values[mask]
    idx = kernels.float_buckets(edges, v)
    mag = torch.zeros(counts.shape[0], dtype=torch.float64,
                      device=v.device).index_add_(0, idx, v.abs().double())
    err = (got[3].double() - want[3].double()).abs()
    if bool((err > 1e-5 * mag).any()):
        raise AssertionError(f"{label} sums: max |kernel - plain| "
                             f"{float(err.max())}")
    return float(err.max())


def host_pair_sums(pids, pks, values):
    """Each (pid, pk) pair's value sum in float64 on the host, as the numpy
    host path forms them (integer codes)."""
    key = (pids.astype(np.int64) << 32) + pks.astype(np.int64)
    _, inverse = np.unique(key, return_inverse=True)
    return np.bincount(inverse.reshape(-1), weights=values)


def histogram_fields_agree(label, got, host, pair_sums, linf_max):
    """The port's device histograms against its numpy host path: the five
    integer histograms equal. The float histogram bins float32 pair sums on
    float32 edges, the host float64 ones on float64 edges, so a pair sum
    within float32 rounding of an edge may land one bucket over: the total
    count is equal, the total sum within 1e-5 of sum |v|, and at every
    inner edge the device's count of values below it differs from the
    host's by at most the host values within delta of that edge, delta =
    (2 linf_max + 8) 2^-24 max(|lo|, |hi|) (the float32 error of a pair
    sum of linf_max non-negative rows, their casts and adds, plus that of
    the edge). Returns (values counted on the
    other side of some edge, the most values near one edge)."""
    from pipelinedp_tpu_torch import convert
    g, h = convert.histograms_fields(got), convert.histograms_fields(host)
    for i in (0, 1, 2, 4, 5):
        if g[i] != h[i]:
            raise AssertionError(f"histograms ({label}): {h[i][0]} differs "
                                 f"from the host path")
    v = np.sort(pair_sums)
    lo, hi, buckets = float(v[0]), float(v[-1]), 10000
    edges = np.linspace(lo, hi, buckets + 1)
    width = (hi - lo) / buckets
    dev = np.zeros(buckets, dtype=np.int64)
    dev_sum = 0.0
    for lower, _, count, total, _ in g[3][1]:
        dev[min(buckets - 1, max(0, int(round((lower - lo) / width))))] += \
            count
        dev_sum += total
    if int(dev.sum()) != len(v):
        raise AssertionError(f"histograms ({label}): {int(dev.sum())} pair "
                             f"sums binned, host {len(v)}")
    if abs(dev_sum - float(v.sum())) > 1e-5 * float(np.abs(v).sum()):
        raise AssertionError(f"histograms ({label}): float sums total "
                             f"{dev_sum} vs {float(v.sum())}")
    inner = edges[1:-1]
    delta = (2 * linf_max + 8) * 2.0**-24 * max(abs(lo), abs(hi))
    near = (np.searchsorted(v, inner + delta, "right") -
            np.searchsorted(v, inner - delta, "left"))
    moved = np.abs(np.cumsum(dev)[:-1] - np.searchsorted(v, inner, "left"))
    if bool((moved > near).any()):
        i = int(np.argmax(moved - near))
        raise AssertionError(f"histograms ({label}): {int(moved[i])} values "
                             f"on the other side of edge {inner[i]!r}, "
                             f"{int(near[i])} within {delta:.3g} of it")
    return int(moved.max()), int(near.max())


def histogram_phase(torch, dev, data, kernels, card):
    """compute_dataset_histograms_device on the card over the 2^24 Netflix
    rows (pid user, pk movie, value rating) and (q)'s rows (4,725,413
    partitions): the result against the port's numpy host path
    (histogram_fields_agree); C17 and
    C18 against their plain versions on the card at these shapes (C18's
    five integer histograms in one launch and one by one); each stage's
    time. Returns the report rows (on the Netflix rows) and the
    launch counts of the two calls."""
    from pipelinedp_tpu_torch.dataset_histograms import (
        computing_histograms as ch, device_histograms as dh)
    report, total = [], dict.fromkeys(kernels.KERNELS, 0)
    for label, (pids, pks, values, linf_max) in data.items():
        start = time.perf_counter()
        host = ch.compute_dataset_histograms_columnar(pids, pks, values)
        host_s = time.perf_counter() - start
        walls = []
        for rep in range(3):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            got = dh.compute_dataset_histograms_device(pids, pks, values)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            counts = dict(kernels.launch_counts)
            check_launches(f"histograms ({label})", counts, kernels,
                           # One launch for the five integer histograms,
                           # one for the float histogram.
                           dict(radix_sort=3, group_stats=3, log_bins=2),
                           path=("radix_sort", "group_stats", "log_bins"))
            for name, c in counts.items():
                total[name] += c
        moved = histogram_fields_agree(
            label, got, host, host_pair_sums(pids, pks, values), linf_max)

        # The stages at these shapes, each kernel against its plain version.
        pid, pk, vals, valid = dh.device_columns(pids, pks, values, dev)
        n = pid.shape[0]
        sp = kernels.sunk_keys(pid, valid)
        sk = kernels.sunk_keys(pk, valid)
        perm, spid = kernels.radix_sort([sp, sk], sorted_top=True)
        pairs = kernels.group_stats_pairs(pid, pk, vals, valid, perm,
                                          sorted_pid=spid)
        plain = kernels.group_stats_pairs_plain(pid, pk, vals, valid, perm)
        for name in kernels.PAIR_STATS:
            if name != "pair_sum":
                check_equal(f"group_stats ({label}) {name}", pairs[name],
                            plain[name])
        # torch's index_add_ adds a pair's rows on the card by atomics; on
        # the CPU it folds them in row order, as C17 does: bit for bit.
        cpu_sum = kernels.group_stats_pairs_plain(
            *[t.cpu() for t in (pid, pk, vals, valid, perm)])["pair_sum"]
        check_equal(f"group_stats ({label}) pair_sum bits",
                    pairs["pair_sum"].cpu().view(torch.int32),
                    cpu_sum.view(torch.int32))
        err17 = abs_diff(pairs["pair_sum"].cpu(), cpu_sum)
        atomics_err = abs_diff(pairs["pair_sum"], plain["pair_sum"])
        # And a numpy float32 fold over the first 2^16 pairs.
        starts = torch.nonzero(pairs["new_pair"])[:1 << 16, 0].cpu().numpy()
        lens = pairs["pair_len"].cpu().numpy()[starts]
        sv = vals[perm].cpu().numpy()
        fold = np.zeros(len(starts), np.float32)
        for k in range(int(lens.max(initial=0))):
            live = lens > k
            fold[live] = fold[live] + sv[starts[live] + k]
        if not np.array_equal(
                pairs["pair_sum"].cpu().numpy()[starts].view(np.int32),
                fold.view(np.int32)):
            raise AssertionError(f"group_stats ({label}) pair_sum: not a "
                                 f"float32 fold in row order")
        perm2, spk = kernels.radix_sort([sk], sorted_top=True)
        pair_pk = pairs["pair_pk"]
        perm3, spk3 = kernels.radix_sort([pair_pk], sorted_top=True)
        for what, args, top in (("pk", (sk, valid, perm2), spk),
                                ("pair starts", (pair_pk, pairs["new_pair"],
                                                 perm3), spk3)):
            for g, w in zip(kernels.group_stats_keys(*args, sorted_keys=top),
                            kernels.group_stats_keys_plain(*args)):
                check_equal(f"group_stats keys ({label}, {what})", g, w)
        stats = dh.group_stats(pid, pk, vals, valid)
        ints = [stats[key] for key in INT_STATS]
        err18 = check_equal(f"log_bins_int_many ({label})",
                            kernels.log_bins_int_many(ints),
                            kernels.log_bins_int_many_plain(ints))
        for key in INT_STATS:
            for j, (g, w) in enumerate(zip(
                    kernels.log_bins_int(*stats[key]),
                    kernels.log_bins_int_plain(*stats[key]))):
                check_equal(f"log_bins_int ({label}, {key}) {j}", g, w)
        err18f = check_float_hist(
            f"log_bins_float ({label})",
            kernels.log_bins_float(*stats["linf_sum"], 10000),
            kernels.log_bins_float_plain(*stats["linf_sum"], 10000),
            *stats["linf_sum"])
        l1, new_pid = stats["l1"]
        psum, new_pair = stats["linf_sum"]
        ms = {
            "C5 (pid, pk)": (cuda_ms(lambda: kernels.radix_sort([sp, sk]),
                                     5), None),
            "C5 pk": (cuda_ms(lambda: kernels.radix_sort([sk]), 5), None),
            "C5 pair starts": (cuda_ms(lambda: kernels.radix_sort([pair_pk]),
                                       5), None),
            "C17 pairs": (cuda_ms(lambda: kernels.group_stats_pairs(
                pid, pk, vals, valid, perm, sorted_pid=spid), 10), cuda_ms(
                lambda: kernels.group_stats_pairs_plain(pid, pk, vals, valid,
                                                        perm), 3, 1)),
            "C17 keys (pk)": (cuda_ms(lambda: kernels.group_stats_keys(
                sk, valid, perm2, sorted_keys=spk), 10), cuda_ms(
                lambda: kernels.group_stats_keys_plain(sk, valid, perm2), 3,
                1)),
            "C17 keys (pair starts)": (cuda_ms(
                lambda: kernels.group_stats_keys(
                    pair_pk, pairs["new_pair"], perm3, sorted_keys=spk3), 10),
                cuda_ms(lambda: kernels.group_stats_keys_plain(
                    pair_pk, pairs["new_pair"], perm3), 3, 1)),
            "C18 int (l1)": (cuda_ms(lambda: kernels.log_bins_int(
                l1, new_pid), 5), cuda_ms(
                lambda: kernels.log_bins_int_plain(l1, new_pid), 3, 1)),
            "C18 five ints": (cuda_ms(lambda: kernels.log_bins_int_many(
                ints), 5), cuda_ms(
                lambda: kernels.log_bins_int_many_plain(ints), 3, 1)),
            "C18 float": (cuda_ms(lambda: kernels.log_bins_float(
                psum, new_pair, 10000), 5), cuda_ms(
                lambda: kernels.log_bins_float_plain(psum, new_pair, 10000),
                3, 1)),
        }
        stage_ms = {k: [round(v[0], 4), v[1] and round(v[1], 4)]
                    for k, v in ms.items()}
        histc_ms = cuda_ms(lambda: torch.histc(
            psum[new_pair], bins=10000), 5)
        split = three_way(torch, {
            "C17 pairs": lambda: kernels.group_stats_pairs(
                pid, pk, vals, valid, perm, sorted_pid=spid),
            "C17 keys (pk)": lambda: kernels.group_stats_keys(
                sk, valid, perm2, sorted_keys=spk)}, host_calls=200)
        print_three_way(f"histograms, {label}", split, card)
        # Inputs read once (perm, the sorted key, the gathered columns),
        # outputs written once.
        b17 = bound(n * (4 + 4 + 4 + 1 + 8) + n * (1 + 1 + 4 + 4 + 4 + 4 + 4),
                    n * 8)
        b17k = bound(n * (8 + 4 + 1) + n * (1 + 4), n * 4)
        b18 = bound(n * (4 + 1) + kernels.LOG_BIN_SLOTS * 28, n * 16)
        print(f"histograms ({label}: {len(pids)} rows padded to {n}): "
              f"compute_dataset_histograms_device "
              f"{statistics.median(walls) * 1e3:.1f} ms (median of 3: "
              f"{[round(t * 1e3, 1) for t in walls]} ms, the h2d copy of the "
              f"columns included), numpy host path {host_s * 1e3:.1f} ms; "
              f"integer histograms equal the host path, the float one's "
              f"cumulative counts within the values near each edge (at most "
              f"{moved[0]} moved, {moved[1]} near one edge); "
              f"stage ms (kernel / plain): {json.dumps(stage_ms)}"
              f"; torch.histc of the pair sums (counts only, other edges) "
              f"{histc_ms:.4f} ms; C17 pairs bound_ms={b17[0]:.3g} "
              f"({b17[1]}), keys bound_ms={b17k[0]:.3g} ({b17k[1]}), C18 "
              f"int bound_ms={b18[0]:.3g} ({b18[1]}); C17 and C18 equal "
              f"their plain versions (pair sums bit for bit the CPU's row-"
              f"order fold, within {atomics_err:.3g} of the card's "
              f"index_add_; "
              f"float bucket sums within {err18f:.3g}) ({card})", flush=True)
        if label == "netflix":
            report += [
                {"name": "group_stats", "route": "cuda",
                 "source": "pipelinedp_tpu_torch/csrc/group_stats.cu",
                 "replaces": "pipelinedp_tpu/dataset_histograms/"
                             "device_histograms.py:130",
                 "launches": 0, "max_abs_err": err17,
                 "ms": ms["C17 pairs"][0], "plain_ms": ms["C17 pairs"][1],
                 "bound_ms": b17[0], "bound_by": b17[1], "library_ms": None},
                {"name": "log_bins", "route": "cuda",
                 "source": "pipelinedp_tpu_torch/csrc/log_bins.cu",
                 "replaces": "pipelinedp_tpu/dataset_histograms/"
                             "device_histograms.py:66",
                 "launches": 0, "max_abs_err": max(err18, err18f),
                 "ms": ms["C18 int (l1)"][0],
                 "plain_ms": ms["C18 int (l1)"][1], "bound_ms": b18[0],
                 "bound_by": b18[1], "library_ms": None}]
        del pid, pk, vals, valid, perm, pairs, plain, stats, ints, cpu_sum, sv
    return report, total


# ---------------------------------------------------------------------------
# Utility analysis and parameter tuning (K19): C19 sweep_stats and C20
# sweep_report, after C5 radix_sort and C10 block_offsets.

SWEEP_GRID = (1, 2, 4, 8, 16, 32, 64, 128)
SWEEP_EPS, SWEEP_DELTA = 1.0, 1e-6
SWEEP_PATH = ("radix_sort", "block_offsets", "sweep_stats", "sweep_report")
SWEEP_A_ROWS, SWEEP_A_PARTS = 1 << 21, 1 << 14
ANALYSIS_ROWS = 1 << 20
ANALYSIS_PARITY_ROWS = 1 << 14
# Stated bounds of the sweep checks: float64 kernels against their plain
# versions (index_add_ adds by atomics on the card, in another order);
# float32 kernels against the float64 kernels, each output on the scale a
# report reads it at (sweep_f32_errors): a float32 sum of n same-signed
# terms added in order is within n 2^-24 of its magnitude, 8.3e-3 for
# (B)'s largest partition (~1.4e5 rows); reports of the card in float64
# against the CPU, and in float32 (2^14 rows).
SWEEP_F64_RTOL = 1e-9
SWEEP_F32_BOUND = 1e-2
REPORT_F32_RTOL = 1e-3


def sweep_grid_params(tdp, metrics):
    """bench.py config 5's 64 configurations: l0 x linf over SWEEP_GRID,
    Gaussian noise; a SUM clipped to [0, 5 linf] (ratings 1-5)."""
    params = []
    for l0 in SWEEP_GRID:
        for linf in SWEEP_GRID:
            extra = ({"min_sum_per_partition": 0.0,
                      "max_sum_per_partition": 5.0 * linf}
                     if tdp.Metrics.SUM in metrics else {})
            params.append(tdp.AggregateParams(
                metrics=list(metrics), noise_kind=tdp.NoiseKind.GAUSSIAN,
                max_partitions_contributed=l0,
                max_contributions_per_partition=linf, **extra))
    return params


def sweep_config(tdp, metrics):
    """(SweepConfigArrays, metric codes) of the 64-configuration grid,
    private selection at (SWEEP_EPS, SWEEP_DELTA)."""
    from pipelinedp_tpu_torch.analysis import error_model as em
    from pipelinedp_tpu_torch.analysis import kernels as ak
    params = sweep_grid_params(tdp, metrics)
    ordered = em.ordered_metrics(params[0])
    stds = np.array([[em.config_noise_std(p, m, SWEEP_EPS, SWEEP_DELTA)
                      for m in ordered] for p in params])
    return (ak.build_config_arrays(params, ordered, stds,
                                   (SWEEP_EPS, SWEEP_DELTA)),
            tuple(ak.METRIC_CODES[m] for m in ordered))


def sweep_shapes(tdp, encoded):
    """(A) bench.py config 5 at its accelerator size (:157-192): 2^21 rows,
    2^14 partitions, COUNT, seed 11; (B) the Netflix table's 2^24 distinct
    (user, movie) pairs as preaggregated rows: count 1, sum the rating,
    contributed the user's movie count, pk the movie; COUNT + SUM. Both
    over the 64-configuration grid, Gaussian, private selection."""
    rng = np.random.default_rng(11)
    n, p = SWEEP_A_ROWS, SWEEP_A_PARTS
    shape_a = (rng.integers(1, 16, n).astype(np.float64),
               rng.random(n) * 5.0,
               rng.integers(1, 256, n).astype(np.float64),
               rng.integers(0, p, n).astype(np.int32), p,
               sweep_config(tdp, [tdp.Metrics.COUNT]))
    per_user = np.bincount(encoded.pid)
    shape_b = (np.ones(encoded.pid.shape[0]), encoded.values,
               per_user[encoded.pid].astype(np.float64),
               encoded.pk.astype(np.int32), encoded.n_partitions,
               sweep_config(tdp, [tdp.Metrics.SUM, tdp.Metrics.COUNT]))
    return {"A": shape_a, "B": shape_b}


def rel_to_one(got, want, scale=None) -> float:
    """max |got - want| / max(1, |scale|) (scale: want; 0 for empty
    tensors)."""
    import torch
    if got.numel() == 0:
        return 0.0
    g, w = got.double(), want.double()
    scale = w if scale is None else scale.double()
    return float(((g - w).abs() / torch.clamp(scale.abs(), min=1.0)).max())


def sweep_f32_errors(em, s32, r32, s64, r64):
    """Float32 sweep outputs against float64 on the scales the reports
    read them at (error_model.finalize_*): the statistics, moments and
    weighted error fields relative to max(1, |x|); keep_prob absolute (a
    float32 probability's error is absolute: the window's pmf sums to 1
    within ~window ulps, and mu's float32 sum moves it along the
    selector's slope); so the fields that carry (1 - keep_prob) |raw|,
    the dropped data and ABS_RMSE_DROP, relative to the bucket's raw sum
    (the dropped-data ratios' denominator), REL_RMSE_DROP, whose term is
    (1 - keep_prob) weight, and the info fields relative to the bucket's
    partition count."""
    rows, info = r64[2], r64[3]
    parts = (info[..., em.N_DATASET] + info[..., em.N_EMPTY])[..., None]
    rows_scale = rows.clone()
    for field in (em.DROP_L0, em.DROP_LINF, em.DROP_PS, em.ABS_RMSE_DROP):
        rows_scale[..., field] = rows[..., em.SUM_ACTUAL]
    rows_scale[..., em.REL_RMSE_DROP] = parts
    info_scale = parts.expand_as(info)
    return {"stats": rel_to_one(s32[0], s64[0]),
            "sel": rel_to_one(s32[1], s64[1]),
            "keep_prob": abs_diff(r32[1], r64[1]),
            "bucket_rows": rel_to_one(r32[2], r64[2], rows_scale),
            "bucket_info": rel_to_one(r32[3], r64[3], info_scale)}


def sweep_ops(k, n, m, points, fields_parts):
    """Operations of C19 and C20 on these inputs. C19: per row and
    configuration the keep fraction (5: max, compare, divide, min, 1 - q),
    13 a metric (value, clip 2, error, 5 adds, 2 compares, 3 products)
    and 7 for the moments. C20: per window point two skew-corrected CDFs
    (an erfc, an exp and 10 arithmetic operations each), the truncated
    geometric keep probability (6 transcendental, 22 arithmetic) and 12
    more; per (configuration, partition, field) of the bucket sums ~12.
    A transcendental function counts as one operation: a lower bound."""
    return (n * k * (5 + 13 * m + 7),
            points * (2 * 12 + 28 + 12) + fields_parts * 12)


def sweep_kernel_phase(torch, dev, shapes, kernels, card):
    """C19 and C20 against their plain versions on the card at (A) and (B),
    float64 and float32: integer-valued columns (n_users, n_rows, size,
    the raw sums, bucket, the dataset-partition counts) equal, the other
    float64 columns within SWEEP_F64_RTOL of the plain versions, float32
    within SWEEP_F32_BOUND of the float64 kernels; C20 at sigma = 0 with
    half-integer mu (rint) equal to the plain version. Times: median of 10
    warmed calls (CUDA events), plain versions median of 3, index_add_ of
    the [N, K x 8] term tensor at (A) as C19's library figure. Returns the
    report rows (at (A), float32: TorchBackend's working type)."""
    from pipelinedp_tpu_torch.analysis import error_model as em
    from pipelinedp_tpu_torch.analysis import kernels as ak
    tdp_metric_of = {code: metric for metric, code in
                     ak.METRIC_CODES.items()}
    report = []
    for label, (counts, sums, contributed, pk, p, (cfg, codes)) in \
            shapes.items():
        n, m, k = len(counts), len(codes), len(cfg.l0)
        kernel_out = {}
        for f in (torch.float64, torch.float32):
            c, s, con = (torch.as_tensor(np.asarray(x), dtype=f, device=dev)
                         for x in (counts, sums, contributed))
            pkt = torch.as_tensor(pk, device=dev)
            perm, spk = kernels.radix_sort([pkt], sorted_top=True)
            starts = torch.arange(p + 1, dtype=torch.int32, device=dev)
            offs = kernels.block_offsets(spk, starts)
            if f == torch.float32:
                # C10 at the sweep's P + 1 partition starts.
                check_equal(f"block_offsets[sweep ({label})]", same_twice(
                    "block_offsets[sweep]", lambda: {
                        "o": kernels.block_offsets(spk, starts)})["o"],
                    kernels.block_offsets_plain(spk, starts))
                print_three_way(
                    f"C10, sweep ({label}): {p + 1} boundaries over "
                    f"{spk.shape[0]} rows", three_way(torch, {
                        "block_offsets":
                            lambda: kernels.block_offsets(spk, starts),
                        "torch.searchsorted":
                            lambda: torch.searchsorted(spk, starts)}), card)
            cf = [torch.as_tensor(np.asarray(x), dtype=f,
                                  device=dev).contiguous() for x in cfg]
            l0, lo, hi, ns = cf[:4]
            sel_cfg = torch.stack(cf[4:]).contiguous()
            bounds_t = torch.tensor(ak.BUCKET_BOUNDS, dtype=f, device=dev)
            args19 = (c, s, con, perm, offs, l0, lo, hi)
            kw19 = dict(metric_codes=codes, private=True)
            st = kernels.sweep_stats(*args19, **kw19)
            args20 = (st[0], st[1], st[2], st[4], ns, sel_cfg, bounds_t)
            rp = kernels.sweep_report(*args20, public=False)
            torch.cuda.synchronize()
            stp = kernels.sweep_stats_plain(*args19, **kw19)
            rpp = kernels.sweep_report_plain(*args20, public=False)
            tag = f"sweep ({label}, {str(f)[6:]})"
            for name, g, w in (("n_users", st[2], stp[2]),
                               ("n_rows", st[3], stp[3]),
                               ("size", st[4], stp[4]),
                               ("raw sums", st[0][..., em.RAW],
                                stp[0][..., em.RAW]),
                               ("bucket", rp[0], rpp[0]),
                               ("dataset partitions",
                                rp[3][..., em.N_DATASET],
                                rpp[3][..., em.N_DATASET])):
                check_equal(f"{tag} {name}", g, w)
            errs = {}
            if f == torch.float64:
                for name, g, w in (("stats", st[0], stp[0]),
                                   ("sel", st[1], stp[1]),
                                   ("keep_prob", rp[1], rpp[1]),
                                   ("bucket_rows", rp[2], rpp[2]),
                                   ("bucket_info", rp[3], rpp[3])):
                    errs[name] = check_close(f"{tag} {name}", g, w,
                                             SWEEP_F64_RTOL, SWEEP_F64_RTOL)
                # sigma = 0 at half-integer mu: rint, not round-half-away.
                mu = torch.tensor([0.5, 1.5, 2.5, 3.5, 2.0], dtype=f,
                                  device=dev)
                sel0 = torch.stack([mu, torch.zeros_like(mu),
                                    torch.zeros_like(mu)], -1)
                sel0 = sel0[None].expand(k, -1, -1).contiguous()
                users0 = torch.full((5,), 4.0, dtype=f, device=dev)
                stats0 = torch.zeros((k, 5, m, em.STAT_WIDTH), dtype=f,
                                     device=dev)
                a0 = (stats0, sel0, users0, users0, ns, sel_cfg, bounds_t)
                check_close(f"{tag} keep_prob at rint(mu)",
                            kernels.sweep_report(*a0, public=False)[1],
                            kernels.sweep_report_plain(*a0, public=False)[1],
                            1e-12, 1e-15)
            kernel_out[f] = (st, rp)
            rows_p = (offs[1:] - offs[:-1])
            hot = int(rows_p.max())
            ms19 = cuda_ms(lambda: kernels.sweep_stats(*args19, **kw19), 10)
            ms20 = cuda_ms(lambda: kernels.sweep_report(*args20,
                                                        public=False), 10)
            plain19 = cuda_ms(lambda: kernels.sweep_stats_plain(
                *args19, **kw19), 3, 1)
            plain20 = cuda_ms(lambda: kernels.sweep_report_plain(
                *args20, public=False), 3, 1)
            library19 = None
            if label == "A":
                # The [N, K, 8] term tensor (5 metric terms, 3 moments)
                # built once; one index_add_ sums it per partition.
                terms = torch.empty((n, k, 8), dtype=f, device=dev)
                q = em.keep_fraction(con[:, None], l0[None, :],
                                     xp=em.TORCH_XP)
                vals = em.metric_values(tdp_metric_of[codes[0]], c, s,
                                        xp=em.TORCH_XP)
                terms[..., :5] = em.metric_stat_terms(
                    vals[:, None], lo[None, :, 0], hi[None, :, 0], q,
                    xp=em.TORCH_XP)
                terms[..., 5:] = em.selection_moment_terms(q, xp=em.TORCH_XP)
                flat = terms.reshape(n, k * 8)
                pk64 = pkt.long()
                library19 = cuda_ms(lambda: torch.zeros(
                    (p, k * 8), dtype=f, device=dev).index_add_(
                        0, pk64, flat), 10)
                del terms, flat, q
            t_size = 8 if f == torch.float64 else 4
            rate = FP64_OPS_PER_S if f == torch.float64 else OPS_PER_S
            sigma_pos = int((st[1][..., em.SEL_VAR] > 0).sum())
            ops19, ops20 = sweep_ops(k, n, m, sigma_pos * 64,
                                     k * p * (m * em.REPORT_WIDTH +
                                              em.INFO_WIDTH))
            b19 = bound(n * (3 * t_size + 4 + 8) + (p + 1) * 8 +
                        k * (1 + 2 * lo.shape[1]) * t_size +
                        k * p * (5 * m + 3) * t_size + 3 * p * t_size,
                        ops19, rate)
            nb = len(ak.BUCKET_BOUNDS)
            b20 = bound(k * p * (5 * m + 3) * t_size + 2 * p * t_size +
                        k * (8 + lo.shape[1]) * t_size + p * 4 +
                        k * p * t_size +
                        k * nb * (m * em.REPORT_WIDTH + em.INFO_WIDTH) *
                        t_size, ops20, rate)
            lib = "none" if library19 is None else f"{library19:.4f}"
            print(f"{tag}: N={n} P={p} K={k} M={m}, largest partition "
                  f"{hot} rows, {sigma_pos} (config, partition) windows; "
                  f"C19 ms={ms19:.4f} plain_ms={plain19:.4f} library_ms="
                  f"{lib} (index_add_ of the [N, K x 8] terms) bound_ms="
                  f"{b19[0]:.3g} ({b19[1]}); C20 ms={ms20:.4f} plain_ms="
                  f"{plain20:.4f} bound_ms={b20[0]:.3g} ({b20[1]}); "
                  f"against the plain versions: integer columns equal"
                  + ("" if not errs else ", " + ", ".join(
                      f"{key} {v:.3g}" for key, v in errs.items())) +
                  f" ({card})", flush=True)
            if label == "A" and f == torch.float32:
                err = max(abs_diff(g, w) for g, w in zip(rp, rpp))
                report += [
                    {"name": "sweep_stats", "route": "cuda",
                     "source": "pipelinedp_tpu_torch/csrc/sweep_stats.cu",
                     "replaces": "pipelinedp_tpu/analysis/kernels.py:220",
                     "launches": 0, "max_abs_err": abs_diff(st[0], stp[0]),
                     "ms": ms19, "plain_ms": plain19, "bound_ms": b19[0],
                     "bound_by": b19[1], "library_ms": library19},
                    {"name": "sweep_report", "route": "cuda",
                     "source": "pipelinedp_tpu_torch/csrc/sweep_report.cu",
                     "replaces": "pipelinedp_tpu/analysis/kernels.py:167",
                     "launches": 0, "max_abs_err": err,
                     "ms": ms20, "plain_ms": plain20, "bound_ms": b20[0],
                     "bound_by": b20[1], "library_ms": None}]
            del stp, rpp, args19, args20, c, s, con, perm, offs
        (s64, r64), (s32, r32) = (kernel_out[torch.float64],
                                  kernel_out[torch.float32])
        f32 = sweep_f32_errors(em, s32, r32, s64, r64)
        bad = {key: v for key, v in f32.items() if not v <= SWEEP_F32_BOUND}
        if bad:
            raise AssertionError(f"sweep ({label}): float32 beyond "
                                 f"{SWEEP_F32_BOUND} of float64: {bad}")
        print(f"sweep ({label}): float32 kernels against float64 (on the "
              f"reports' scales, sweep_f32_errors): "
              f"{ {key: float(f'{v:.3g}') for key, v in f32.items()} } "
              f"(bound {SWEEP_F32_BOUND})", flush=True)
        del kernel_out, s64, r64, s32, r32
    return report


def report_leaves(obj, path="r"):
    """(path, value) of every leaf of a utility-analysis result: enums by
    name, lists with their length."""
    import enum
    if dataclasses.is_dataclass(obj):
        for fld in dataclasses.fields(obj):
            yield from report_leaves(getattr(obj, fld.name),
                                     f"{path}.{fld.name}")
    elif isinstance(obj, (list, tuple)):
        yield f"{path}#len", len(obj)
        for i, x in enumerate(obj):
            yield from report_leaves(x, f"{path}[{i}]")
    elif isinstance(obj, enum.Enum):
        yield path, obj.name
    else:
        yield path, obj


def reports_agree(label, got, want, rtol, atol):
    """Every leaf of the reports: floats within rtol (+ atol), the rest
    equal. Returns the largest relative difference."""
    g, w = list(report_leaves(got)), list(report_leaves(want))
    if [p for p, _ in g] != [p for p, _ in w]:
        raise AssertionError(f"{label}: the reports differ in shape")
    worst = 0.0
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, float):
            d = abs(a - b)
            if not d <= atol + rtol * abs(b):
                raise AssertionError(f"{label} {path}: {a!r} vs {b!r}")
            worst = max(worst, d / max(abs(b), 1e-300) if d else 0.0)
        elif a != b:
            raise AssertionError(f"{label} {path}: {a!r} vs {b!r}")
    return worst


def best_index(reports):
    return int(np.argmin([r.metric_errors[0].absolute_error.rmse
                          for r in reports]))


def analysis_main_phase(torch, tdp, users, movies, ratings, kernels, card):
    """The normal entry points on TorchBackend(): the dataset histograms
    (K20) of the first ANALYSIS_ROWS Netflix rows, then
    parameter_tuning.tune over the same rows as Python tuples (COUNT,
    private, 64 candidates, epsilon 1, delta 1e-6), twice; the host
    pipeline (generic-backend preaggregation) timed apart from the sweep;
    then perform_utility_analysis of ANALYSIS_PARITY_ROWS of those rows,
    private and public, on the card (float64 and float32) against the CPU.
    Returns the launch counts of the histogram and tune runs."""
    from pipelinedp_tpu_torch.analysis import data_structures as ds
    from pipelinedp_tpu_torch.analysis import kernels as ak
    from pipelinedp_tpu_torch.analysis import parameter_tuning as pt
    from pipelinedp_tpu_torch.analysis import utility_analysis as ua
    from pipelinedp_tpu_torch.analysis import utility_analysis_engine as uae
    from pipelinedp_tpu_torch.dataset_histograms import device_histograms
    n = ANALYSIS_ROWS
    pids, pks, vals = users[:n], movies[:n], ratings[:n]
    rows = list(zip(pids.tolist(), pks.tolist(), vals.tolist()))
    ext = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                             partition_extractor=lambda r: r[1],
                             value_extractor=lambda r: r[2])
    total = dict.fromkeys(kernels.KERNELS, 0)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    hist = device_histograms.compute_dataset_histograms_device(pids, pks,
                                                               vals)
    torch.cuda.synchronize()
    hist_s = time.perf_counter() - start
    counts = dict(kernels.launch_counts)
    check_launches("tune histograms", counts, kernels,
                   path=("radix_sort", "group_stats", "log_bins"))
    for name, c in counts.items():
        total[name] += c
    count_params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT], noise_kind=tdp.NoiseKind.GAUSSIAN,
        max_partitions_contributed=1, max_contributions_per_partition=1)
    options = pt.TuneOptions(
        epsilon=SWEEP_EPS, delta=SWEEP_DELTA, aggregate_params=count_params,
        function_to_minimize=pt.MinimizingFunction.ABSOLUTE_ERROR,
        parameters_to_tune=pt.ParametersToTune(
            max_partitions_contributed=True,
            max_contributions_per_partition=True),
        number_of_parameter_candidates=64)
    backend = tdp.TorchBackend()
    walls, splits = [], []
    sweep_kernel = ua.kernels.sweep_kernel

    def timed_sweep(*args, **kwargs):
        # The tune's own sweep call, timed where the dense route makes it.
        marks.append(time.perf_counter())
        out = sweep_kernel(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out

    for _ in range(2):
        kernels.reset_launch_counts()
        marks = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        ua.kernels.sweep_kernel = timed_sweep
        try:
            result_col, per_partition = pt.tune(rows, backend, hist,
                                                options, ext)
            result = list(result_col)[0]
        finally:
            ua.kernels.sweep_kernel = sweep_kernel
        torch.cuda.synchronize()
        end = time.perf_counter()
        walls.append(end - start)
        splits.append((marks[0] - start, marks[1] - marks[0],
                       end - marks[1]))
        counts = dict(kernels.launch_counts)
        check_launches("tune", counts, kernels,
                       dict(sweep_stats=1, sweep_report=1), path=SWEEP_PATH)
        for name, c in counts.items():
            total[name] += c
    reports = result.utility_reports
    cand = result.utility_analysis_parameters
    if len(reports) != cand.size or not 0 <= result.index_best < cand.size:
        raise AssertionError(f"tune: {len(reports)} reports, {cand.size} "
                             f"candidates, index_best {result.index_best}")
    rmse = [r.metric_errors[0].absolute_error.rmse for r in reports]
    if not all(math.isfinite(x) and x >= 0 for x in rmse) or \
            result.index_best != best_index(reports):
        raise AssertionError(f"tune: index_best {result.index_best} is not "
                             f"the finite argmin of {rmse}")

    # The host part split, in separate runs of the same steps: the
    # generic-backend preaggregation, then the columns and config arrays.
    analysis_options = ds.UtilityAnalysisOptions(
        epsilon=SWEEP_EPS, delta=SWEEP_DELTA, aggregate_params=count_params,
        multi_param_configuration=cand)
    accountant = tdp.NaiveBudgetAccountant(total_epsilon=SWEEP_EPS,
                                           total_delta=SWEEP_DELTA)
    engine = uae.UtilityAnalysisEngine(accountant, backend)
    analyzer = engine.request_budgets(analysis_options, None)
    start = time.perf_counter()
    pre = list(engine.preaggregated_rows(rows, analysis_options, ext, None))
    host_s = time.perf_counter() - start
    accountant.compute_budgets()
    start = time.perf_counter()
    keys = list(dict.fromkeys(pk for pk, _ in pre))
    index = {pk: i for i, pk in enumerate(keys)}
    cols = [np.fromiter((r[j] for _, r in pre), dtype=np.float64,
                        count=len(pre)) for j in range(3)]
    pk_idx = np.fromiter((index[pk] for pk, _ in pre), dtype=np.int32,
                         count=len(pre))
    noise_stds, _ = analyzer.resolve_mechanisms()
    cfg = ak.build_config_arrays(analyzer.config_params,
                                 analyzer.metric_list, noise_stds,
                                 analyzer.selection_budget())
    arrays_s = time.perf_counter() - start
    del pre, cols, pk_idx
    best = result.index_best
    ms = [[round(t * 1e3, 1) for t in split] for split in splits]
    print(f"tune[{n} Netflix rows as tuples, {len(keys)} partitions, "
          f"{cand.size} distinct candidates of "
          f"{options.number_of_parameter_candidates} asked, COUNT, private, "
          f"epsilon {SWEEP_EPS}, delta {SWEEP_DELTA}, TorchBackend() "
          f"float32]: histograms (K20) {hist_s * 1e3:.1f} ms; tune wall "
          f"{[round(w * 1e3, 1) for w in walls]} ms, split (host: "
          f"preaggregation, budgets, columns / sweep: h2d, C5, C10, C19, "
          f"C20 / outputs to the host, reports) {ms} ms; the host part "
          f"alone, separate runs: preaggregation {host_s * 1e3:.1f} ms, "
          f"columns and config arrays {arrays_s * 1e3:.1f} ms; chosen "
          f"candidate {best}: max_partitions_contributed "
          f"{cand.max_partitions_contributed[best]}, "
          f"max_contributions_per_partition "
          f"{cand.max_contributions_per_partition[best]}, rmse "
          f"{rmse[best]:.6g} ({card})", flush=True)
    del per_partition

    # Card against CPU on the first ANALYSIS_PARITY_ROWS rows.
    small = rows[:ANALYSIS_PARITY_ROWS]
    movies_small = sorted({r[1] for r in small})
    grid = sweep_grid_params(tdp, [tdp.Metrics.COUNT])
    multi = ds.MultiParameterConfiguration(
        max_partitions_contributed=[p.max_partitions_contributed
                                    for p in grid],
        max_contributions_per_partition=[
            p.max_contributions_per_partition for p in grid])
    opts = ds.UtilityAnalysisOptions(
        epsilon=SWEEP_EPS, delta=SWEEP_DELTA, aggregate_params=count_params,
        multi_param_configuration=multi)
    for public in (None, movies_small[::3] + [-1, -2]):
        label = "private" if public is None else "public"

        def analyze(backend_):
            reps, _ = ua.perform_utility_analysis(small, backend_, opts, ext,
                                                  public_partitions=public)
            torch.cuda.synchronize()
            return list(reps)

        start = time.perf_counter()
        cpu = analyze(tdp.TorchBackend(device="cpu", dtype=torch.float64))
        cpu_s = time.perf_counter() - start
        start = time.perf_counter()
        card64 = analyze(tdp.TorchBackend(dtype=torch.float64))
        card64_s = time.perf_counter() - start
        start = time.perf_counter()
        card32 = analyze(tdp.TorchBackend())
        card32_s = time.perf_counter() - start
        e64 = reports_agree(f"analysis {label} float64, card vs cpu", card64,
                            cpu, SWEEP_F64_RTOL, 1e-12)
        if best_index(card64) != best_index(cpu):
            raise AssertionError(f"analysis {label}: best config "
                                 f"{best_index(card64)} on the card, "
                                 f"{best_index(cpu)} on the CPU")
        e32 = reports_agree(f"analysis {label} float32, card vs cpu", card32,
                            cpu, REPORT_F32_RTOL, 1e-6)
        print(f"analysis parity [{label}, {len(small)} rows, "
              f"{len(cpu)} configurations]: card float64 within {e64:.3g} "
              f"relative of the CPU (bound {SWEEP_F64_RTOL}), same best "
              f"config {best_index(cpu)}; card float32 within {e32:.3g} "
              f"(bound {REPORT_F32_RTOL}), best config "
              f"{best_index(card32)}; walls cpu {cpu_s * 1e3:.1f}, card "
              f"float64 {card64_s * 1e3:.1f}, float32 {card32_s * 1e3:.1f} "
              f"ms ({card})", flush=True)
    return total



# ---------------------------------------------------------------------------
# The multi-tenant service and megabatched serving (service/, K24).

# The lane entries and C5: the kernels of every lane-batched release.
SERVICE_PATH = ("row_keys_lanes", "bound_rows_lanes", "radix_sort",
                "reduce_partitions_lanes", "release_epilogue_lanes",
                "compact_kept_lanes")
SOLO_OF_LANE = {"row_keys_lanes": "row_keys", "bound_rows_lanes": "bound_rows",
                "reduce_partitions_lanes": "reduce_partitions",
                "release_epilogue_lanes": "release_epilogue",
                "compact_kept_lanes": "compact_kept"}
S2_JOBS = 16  # jobs of 2^20 rows cut from the 2^24 Netflix rows
# bench.py's _bench_megabatch load (S1).
MICRO_JOBS, MICRO_ROWS, MICRO_WORKERS, MICRO_LANES, MICRO_TRIALS = (96, 64, 16,
                                                                   16, 3)
LANE_SHAPES = ((3, 1000), (S2_JOBS, N_ROWS // S2_JOBS))


def lane_keys(n_lanes, base):
    return np.array([[0, base + l] for l in range(n_lanes)], np.uint32)


def release_cfg(tdp, executor, P, metrics, noise, private, l0=64, linf=1):
    """(cfg, stds, scalars) of one dense release spec, budgets computed
    at eps 1, delta 1e-6."""
    from pipelinedp_tpu_torch import combiners
    from pipelinedp_tpu_torch.ops import selection_ops
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    params = tdp.AggregateParams(
        metrics=[getattr(tdp.Metrics, m) for m in metrics],
        noise_kind=getattr(tdp.NoiseKind, noise), min_value=1.0,
        max_value=5.0, max_partitions_contributed=l0,
        max_contributions_per_partition=linf)
    compound = combiners.create_compound_combiner(params, acc)
    budget = (acc.request_budget(tdp.MechanismType.GENERIC) if private
              else None)
    acc.compute_budgets()
    sel = (selection_ops.selection_params_from_host(
        params.partition_selection_strategy, budget.eps, budget.delta, l0,
        None) if private else None)
    cfg = executor.make_kernel_config(params, compound, P, private, sel)
    return cfg, executor.compute_noise_stds(compound), \
        executor.kernel_scalars(params)


def lanes_equal_solo(torch, label, batched, solo_fn, n_lanes):
    """Lane l of a batched release equals its solo release with ==
    (n_kept, the whole order, every output, flags)."""
    for l in range(n_lanes):
        solo = solo_fn(l)
        if int(batched[0][l]) != int(solo[0]) or \
                not torch.equal(batched[1][l], solo[1]):
            raise AssertionError(f"{label}: lane {l}'s kept ids differ from "
                                 f"its solo release")
        if len(batched) > 2:
            for name, col in solo[2].items():
                if not torch.equal(batched[2][name][l], col):
                    raise AssertionError(f"{label}: lane {l}'s {name} "
                                         f"differs from its solo release")
            if int(batched[3][l]) != int(solo[3].reshape(())):
                raise AssertionError(f"{label}: lane {l}'s flags differ")


def service_kernel_phase(torch, dev, tdp, encoded, kernels, executor, card,
                         shapes=LANE_SHAPES):
    """The lane entries of C1, C2, C3, C4 and C6 (and C5 on the lane
    word) against their plain versions on the card, at L = 3 lanes of
    1000 rows and at S2's 16 lanes of 2^20 Netflix rows (P = 17,770); the
    batched releases against their solo releases lane by lane (==); times
    at S2's shape."""
    f32 = torch.float32
    P = N_MOVIES
    report = []
    from pipelinedp_tpu_torch.aggregate_params import (
        NoiseKind, PartitionSelectionStrategy)
    from pipelinedp_tpu_torch.ops import selection_ops
    for n_lanes, lane_rows in shapes:
        total = n_lanes * lane_rows
        sl = slice(0, total)
        pid = torch.as_tensor(encoded.pid[sl]).to(dev).reshape(n_lanes, -1)
        pk = torch.as_tensor(encoded.pk[sl]).to(dev).reshape(n_lanes, -1)
        values = torch.as_tensor(encoded.values[sl]).to(dev, f32).reshape(
            n_lanes, -1)
        valid = torch.as_tensor(encoded.valid[sl]).to(dev).reshape(n_lanes,
                                                                 -1)
        # Two lanes with the same key: identical keys side by side; at the
        # small shape the last lane keeps no row at all.
        keys = lane_keys(n_lanes, 500)
        keys[1] = keys[0]
        if n_lanes == LANE_SHAPES[0][0]:
            valid[-1] = False
        # C4's plan below: a variance entry (three noise slots) and a
        # privacy_id_count entry (one).
        metric_plan = (
            executor.MetricPlanEntry("variance",
                                     ("variance", "count", "sum", "mean"), 3),
            executor.MetricPlanEntry("privacy_id_count",
                                     ("privacy_id_count",), 1))
        salts, keys_linf, key_sel, slots = executor.lane_release_keys(
            keys, metric_plan)
        fp, fk, fv, fvalid = (pid.reshape(-1), pk.reshape(-1),
                              values.reshape(-1), valid.reshape(-1))
        c1_args = (fp, fk, fvalid, lane_rows, salts, keys_linf, P, f32)
        c1 = lambda: kernels.row_keys_lanes(*c1_args)  # noqa: E731
        lane, k1, k2, u = c1()
        q = kernels.row_keys_lanes_plain(fp, fk, fvalid, lane_rows, salts,
                                         keys_linf, P, f32)
        err1 = max(check_equal(f"row_keys_lanes {w}", a, b)
                   for w, a, b in zip(("lane", "k1", "k2", "u"), (lane, k1,
                                                                   k2, u), q))
        words = [lane, k1, k2, u]
        perm = kernels.radix_sort(words)
        err5 = check_equal("radix_sort (lane, k1, k2, u)", perm,
                           kernels.radix_sort_plain(words))
        cols = ("sum", "nsum", "nsum2")
        c2_args = dict(lane_rows=lane_rows, n_partitions=P, linf=1, l0=64,
                       clip_per_value=True, clip_pair_sum=False,
                       scalars=(1.0, 5.0, 0.0, 0.0, 3.0), columns=cols)
        c2 = lambda: kernels.bound_rows_lanes(perm, k1, k2, fv, fvalid,  # noqa: E731
                                              **c2_args)
        key2, pair_start, row_cols = c2()
        q2 = kernels.bound_rows_lanes_plain(perm, k1, k2, fv, fvalid,
                                            **c2_args)
        err2 = max([check_equal("bound_rows_lanes key2", key2, q2[0]),
                    check_equal("bound_rows_lanes pair_start", pair_start,
                                q2[1])] +
                   [check_equal(f"bound_rows_lanes {c}", row_cols[c],
                                q2[2][c]) for c in cols])
        perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
        qp2, qs2 = kernels.radix_sort_plain([key2], True)
        err5 = max(err5, check_equal("radix_sort lane key2", perm2, qp2),
                   check_equal("radix_sort lane key2 sorted", skey2, qs2))
        c3 = lambda: kernels.reduce_partitions_lanes(  # noqa: E731
            skey2, perm2, pair_start, row_cols, lane_rows, P, f32)
        dense = same_twice("reduce_partitions_lanes", c3)
        q3 = kernels.reduce_partitions_lanes_plain(skey2, perm2, pair_start,
                                                   row_cols, lane_rows, P,
                                                   f32)
        scale = kernels.reduce_partitions_lanes_plain(
            skey2, perm2, pair_start, {c: row_cols[c].abs() for c in cols},
            lane_rows, P, f32)
        err3 = max(check_equal("reduce_partitions_lanes count",
                               dense["count"], q3["count"]),
                   check_equal("reduce_partitions_lanes pid_count",
                               dense["pid_count"], q3["pid_count"]))
        for c in cols:
            # Sums in another order than the plain version's index_add_:
            # 1e-5 of the partition's sum of magnitudes.
            tol = 1e-5 * scale[c].double() + 1e-6
            diff = (dense[c].double() - q3[c].double()).abs()
            if bool((diff > tol).any()):
                raise AssertionError(f"reduce_partitions_lanes {c}: max diff "
                                     f"{float(diff.max())} over tolerance")
            err3 = max(err3, float(diff.max()))
        stds = np.array([2.0, 5.0, 40.0, 1.5])
        sel = selection_ops.selection_params_from_host(
            PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-6, 64,
            None)
        c4_args = (dense, executor.epilogue_plan(metric_plan), stds, slots, NoiseKind.GAUSSIAN, False, 3.0,
                   1.0, sel, key_sel, 1, n_lanes)
        c4 = lambda: kernels.release_epilogue_lanes(*c4_args)  # noqa: E731
        keep, outs, flags = c4()
        q4 = kernels.release_epilogue_lanes_plain(*c4_args)
        err4 = max(check_equal("release_epilogue_lanes keep", keep, q4[0]),
                   check_equal("release_epilogue_lanes flags", flags, q4[2]))
        for name in outs:
            err4 = max(err4, check_close(f"release_epilogue_lanes {name}",
                                         outs[name], q4[1][name], rtol=1e-5,
                                         atol=1e-5))
        gen = torch.Generator(device=dev).manual_seed(total)
        half = torch.rand(n_lanes * P, device=dev, generator=gen) < 0.5
        ccols = {o: torch.randn(n_lanes * P, device=dev, generator=gen)
                 for o in ("count", "privacy_id_count", "sum", "mean",
                           "variance")}
        c6 = lambda: kernels.compact_kept_lanes(half, ccols, n_lanes)  # noqa: E731
        got, want = c6(), kernels.compact_kept_lanes_plain(half, ccols,
                                                           n_lanes)
        err6 = max([check_equal("compact_kept_lanes n_kept", got[0], want[0]),
                    check_equal("compact_kept_lanes order", got[1], want[1])] +
                   [check_equal(f"compact_kept_lanes {o}", got[2][o],
                                want[2][o]) for o in ccols])
        # The batched releases against the solo ones, lane by lane (==).
        for label, spec in (("S2a", (("COUNT", "SUM", "MEAN", "VARIANCE"),
                                     "GAUSSIAN", False)),
                            ("S2b", (("COUNT", "SUM", "PRIVACY_ID_COUNT"),
                                     "LAPLACE", True))):
            cfg, cstds, sc = release_cfg(tdp, executor, P, *spec)
            batched = executor.batched_aggregate_release_kernel(
                pid, pk, values, valid, *sc, cstds, keys, cfg)
            lanes_equal_solo(torch, f"batched {label}", batched,
                             lambda l: executor.aggregate_release_kernel(
                                 pid[l], pk[l], values[l], valid[l], *sc,
                                 cstds, keys[l], cfg), n_lanes)
        batched = executor.batched_select_partitions_release_kernel(
            pid, pk, valid, keys, 64, P, sel, f32)
        lanes_equal_solo(torch, "batched select", batched,
                         lambda l: executor.select_partitions_release_kernel(
                             pid[l], pk[l], valid[l], keys[l], 64, P, sel,
                             f32), n_lanes)
        torch.cuda.synchronize()
        errors = {"row_keys_lanes": err1, "bound_rows_lanes": err2,
                  "reduce_partitions_lanes": err3,
                  "release_epilogue_lanes": err4, "radix_sort (lanes)": err5,
                  "compact_kept_lanes": err6}
        print(f"lane kernels[L={n_lanes}, n={lane_rows}, P={P}]: every lane "
              f"entry agrees with its plain version; every lane of the "
              f"batched (a), (b) and select releases equals its solo "
              f"release (==); max abs err {json.dumps(errors)} ({card})",
              flush=True)
        if (n_lanes, lane_rows) != LANE_SHAPES[-1]:
            continue
        fsz = 4
        kept_rows = int((skey2 < n_lanes * P).sum())
        PP = n_lanes * P
        src = torch.stack([torch.ones_like(fv), pair_start.float()] +
                          [row_cols[c] for c in cols], 1)[perm2]
        key_long = skey2.long()

        def library_c3():
            out = torch.zeros(PP + 1, src.shape[1], device=dev)
            return out.index_add_(0, key_long, src)

        timing = {
            "row_keys_lanes": (c1, lambda: kernels.row_keys_lanes_plain(
                fp, fk, fvalid, lane_rows, salts, keys_linf, P, f32), None,
                bound(total * (4 + 4 + 1) + total * (4 + 8 + 8 + fsz),
                      total * 170)),
            "bound_rows_lanes": (c2, lambda: kernels.bound_rows_lanes_plain(
                perm, k1, k2, fv, fvalid, **c2_args), None,
                bound(total * (8 + 8 + 8 + fsz + 1) +
                      total * (4 + 1 + len(cols) * fsz), total * 40)),
            "reduce_partitions_lanes": (
                c3, lambda: kernels.reduce_partitions_lanes_plain(
                    skey2, perm2, pair_start, row_cols, lane_rows, P, f32),
                library_c3,
                bound(total * 4 + kept_rows * (8 + 1 + len(cols) * fsz) +
                      PP * 5 * fsz, kept_rows * 8)),
            "release_epilogue_lanes": (
                c4, lambda: kernels.release_epilogue_lanes_plain(*c4_args),
                None, bound(PP * 5 * fsz + PP * (1 + 5 * fsz) + 4 * n_lanes,
                            PP * 700)),
            "compact_kept_lanes": (
                c6, lambda: kernels.compact_kept_lanes_plain(half, ccols,
                                                             n_lanes),
                None, bound(PP * (1 + 5 * fsz) + PP * (8 + 5 * fsz) +
                            8 * n_lanes, PP * 10)),
        }
        sources = {"row_keys_lanes": "row_keys.cu",
                   "bound_rows_lanes": "bound_rows.cu",
                   "reduce_partitions_lanes": "reduce_partitions.cu",
                   "release_epilogue_lanes": "release_epilogue.cu",
                   "compact_kept_lanes": "compact_kept.cu"}
        for name, (fn, plain, lib, (b_ms, b_by)) in timing.items():
            ms = cuda_ms(fn, repeats=10)
            plain_ms = cuda_ms(plain, repeats=3, warmup=1)
            lib_ms = cuda_ms(lib, repeats=10) if lib else None
            print(f"kernel {name}: max_abs_err={errors[name]} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) "
                  f"library_ms={lib_ms} (L={n_lanes} x {lane_rows} rows, "
                  f"P={P}; {card})", flush=True)
            report.append({
                "name": name, "route": "cuda",
                "source": f"pipelinedp_tpu_torch/csrc/{sources[name]}",
                "replaces": "pipelinedp_tpu/executor.py:984",
                "launches": 0, "max_abs_err": errors[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms})
        lane_ops = device_ops(torch, lambda: kernels.radix_sort(words),
                              calls=1)
        print(f"radix_sort[(lane, k1, k2, u), L={n_lanes}]: device "
              f"operations a sort {json.dumps(lane_ops)}", flush=True)
        print_three_way(f"C2 lanes, L={n_lanes} x {lane_rows} rows, bound "
                        f"{timing['bound_rows_lanes'][3][0]:.3g} ms",
                        three_way(torch, {"bound_rows_lanes": c2},
                                  host_calls=200), card)
        b_ms, b_by = bound(total * (4 + 8 + 8 + fsz) + total * 8,
                           total * 12 * sort_passes(words))
        print(f"kernel radix_sort[(lane, k1, k2, u), L={n_lanes}]: ms="
              f"{cuda_ms(lambda: kernels.radix_sort(words), 10):.4f} "
              f"passes={sort_passes(words)} bound_ms={b_ms:.3g} ({b_by}) "
              f"plain_ms="
              f"{cuda_ms(lambda: kernels.radix_sort_plain(words), 3, 1):.4f}"
              f" torch_chain_ms="
              f"{cuda_ms(lambda: torch_sort_chain(torch, words), 10):.4f}",
              flush=True)
    return report


# The lane entries of every other dense spec: the total bound, pre-bounded
# rows, safe mode, VECTOR_SUM, PERCENTILE and secure noise.
SPEC_ENTRIES = {
    "total_bound_keys_lanes": ("row_keys.cu",
                               "pipelinedp_tpu/executor.py:984"),
    "total_bound_rows_lanes": ("bound_rows.cu",
                               "pipelinedp_tpu/executor.py:984"),
    "bound_rows_keyless_lanes": ("bound_rows.cu",
                                 "pipelinedp_tpu/executor.py:984"),
    "reduce_partitions_compensated_lanes": (
        "reduce_partitions.cu", "pipelinedp_tpu/executor.py:984"),
    "reduce_partitions_vector_lanes": ("reduce_partitions.cu",
                                       "pipelinedp_tpu/executor.py:984"),
    "release_epilogue_secure_lanes": ("release_epilogue.cu",
                                      "pipelinedp_tpu/executor.py:984"),
    "quantile_descend_lanes": ("quantile_descend.cu",
                               "pipelinedp_tpu/executor.py:984"),
    "quantile_descend_secure_lanes": ("quantile_descend.cu",
                                      "pipelinedp_tpu/executor.py:984"),
    "vector_release_lanes": ("vector_release.cu",
                             "pipelinedp_tpu/executor.py:984"),
    "vector_release_secure_lanes": ("vector_release.cu",
                                    "pipelinedp_tpu/executor.py:984"),
}
PER_MOVIE = dict(max_partitions_contributed=64,
                 max_contributions_per_partition=1)
RATING_BOUNDS = dict(min_value=1.0, max_value=5.0)
# name: (metrics, noise, values, params' bounds, backend options); values
# "rating", "onehot" (cell (i)'s D = 5) or "x1000" (cell (p)'s).
LANE_SPECS = {
    "f": (lambda M: [M.PERCENTILE(10), M.PERCENTILE(50), M.PERCENTILE(90),
                     M.COUNT], "GAUSSIAN", "rating",
          dict(PER_MOVIE, **RATING_BOUNDS), {}),
    "i": (lambda M: [M.VECTOR_SUM, M.COUNT], "GAUSSIAN", "onehot",
          dict(PER_MOVIE, vector_size=5, vector_max_norm=1000.0,
               vector_norm_kind="L2"), {}),
    "d": (lambda M: [M.COUNT, M.SUM, M.MEAN], "LAPLACE", "rating",
          dict(max_contributions=64, **RATING_BOUNDS), {}),
    "enforced": (lambda M: [M.COUNT, M.SUM], "LAPLACE", "rating",
                 dict(PER_MOVIE, contribution_bounds_already_enforced=True,
                      **RATING_BOUNDS), {}),
    "secure": (lambda M: [M.COUNT, M.SUM, M.MEAN, M.VARIANCE], "GAUSSIAN",
               "rating", dict(PER_MOVIE, **RATING_BOUNDS),
               {"secure_noise": True}),
    "safe": (lambda M: [M.COUNT, M.SUM], "LAPLACE", "x1000",
             dict(PER_MOVIE, min_value=1000.0, max_value=5000.0),
             {"numeric_mode": "safe"}),
    "secure f": (lambda M: [M.PERCENTILE(50), M.COUNT], "LAPLACE", "rating",
                 dict(PER_MOVIE, **RATING_BOUNDS), {"secure_noise": True}),
    "secure i": (lambda M: [M.VECTOR_SUM], "GAUSSIAN", "onehot",
                 dict(PER_MOVIE, vector_size=5, vector_max_norm=1000.0,
                      vector_norm_kind="L2"), {"secure_noise": True}),
}


def spec_params(tdp, name):
    metrics, noise, _, bounds, _ = LANE_SPECS[name]
    bounds = dict(bounds)
    if "vector_norm_kind" in bounds:
        bounds["vector_norm_kind"] = getattr(tdp.NormKind,
                                             bounds["vector_norm_kind"])
    return tdp.AggregateParams(metrics=metrics(tdp.Metrics),
                               noise_kind=getattr(tdp.NoiseKind, noise),
                               **bounds)


def spec_values(np_or_torch, values, kind):
    """A spec's value column from the ratings (1-5): as they are, one-hot
    (D = 5) or x 1000."""
    if kind == "onehot":
        if isinstance(values, np.ndarray):
            out = np.zeros(values.shape + (5,))
            out[..., :] = (np.arange(1, 6) == values[..., None])
            return out
        torch = np_or_torch
        return torch.nn.functional.one_hot(values.long() - 1, 5).to(
            values.dtype).contiguous()
    return values * 1000.0 if kind == "x1000" else values


def spec_release_cfg(tdp, executor, P, name, dev):
    """(cfg, stds, scalars, secure tables on dev or None) of a LANE_SPECS
    spec, public partitions, budgets at eps 1, delta 1e-6."""
    from pipelinedp_tpu_torch import combiners
    params = spec_params(tdp, name)
    options = LANE_SPECS[name][4]
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    compound = combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    secure = bool(options.get("secure_noise"))
    cfg = executor.make_kernel_config(
        params, compound, P, False, None, secure=secure,
        numeric_mode=options.get("numeric_mode", "fast"))
    stds = executor.compute_noise_stds(compound)
    tables = (executor.build_secure_tables(
        stds, executor.compute_noise_sensitivities(compound, params),
        params.noise_kind, None, dev) if secure else None)
    return cfg, stds, executor.kernel_scalars(params), tables


def spec_kernel_phase(torch, dev, tdp, encoded, kernels, executor, card,
                      shapes=LANE_SHAPES):
    """The lane entries of the total bound (C1, C2), pre-bounded rows (C2),
    safe mode and VECTOR_SUM (C3), secure noise (C4, C8, C9), PERCENTILE
    (C8, both regimes) and VECTOR_SUM's release (C9) against their plain
    versions on the card, at L = 3 lanes of 1000 rows and S2's 16 lanes of
    2^20 Netflix rows (P = 17,770; the dense quantile regime on 128
    partitions, movie mod 128); each spec's batched release == its solo
    release lane by lane; times at S2's shape."""
    from pipelinedp_tpu_torch.aggregate_params import NoiseKind
    from pipelinedp_tpu_torch.ops import quantile_tree
    from pipelinedp_tpu_torch.ops import threefry
    f32, i32 = torch.float32, torch.int32
    P, PD = N_MOVIES, 128
    h, B = quantile_tree.DEFAULT_TREE_HEIGHT, \
        quantile_tree.DEFAULT_BRANCHING_FACTOR
    n_q = len(QUANTILES)
    report = []
    metric_plan = (
        executor.MetricPlanEntry("variance",
                                 ("variance", "count", "sum", "mean"), 3),
        executor.MetricPlanEntry("privacy_id_count", ("privacy_id_count",),
                                 1))
    stds = np.array([2.0, 5.0, 40.0, 1.5])
    tables = executor.build_secure_tables(
        stds, np.array([64.0, 128.0, 256.0, 64.0]), NoiseKind.GAUSSIAN, None,
        dev)
    std_lazy = quantile_tree.per_level_noise_std(0.5, 5e-7, 64, 1, h,
                                                 NoiseKind.GAUSSIAN)
    qthr, qgran = executor.build_secure_tables(
        np.array([std_lazy]), np.array([64.0]), NoiseKind.GAUSSIAN, None, dev)
    qtable = (qthr[0], float(qgran[0]))
    vstd = 460.0
    vthr, vgran = executor.build_secure_tables(
        np.array([vstd]), np.array([1000.0]), NoiseKind.GAUSSIAN, None, dev)
    vtable = (vthr[0], float(vgran[0]))
    for n_lanes, lane_rows in shapes:
        total = n_lanes * lane_rows
        PP = n_lanes * P
        sl = slice(0, total)
        pid = torch.as_tensor(encoded.pid[sl]).to(dev).reshape(n_lanes, -1)
        pk = torch.as_tensor(encoded.pk[sl]).to(dev).reshape(n_lanes, -1)
        values = torch.as_tensor(encoded.values[sl]).to(dev, f32).reshape(
            n_lanes, -1)
        valid = torch.as_tensor(encoded.valid[sl]).to(dev).reshape(n_lanes,
                                                                 -1)
        keys = lane_keys(n_lanes, 700)
        keys[1] = keys[0]
        if n_lanes == LANE_SHAPES[0][0]:
            valid[-1] = False
        fp, fk, fv, fvalid = (pid.reshape(-1), pk.reshape(-1),
                              values.reshape(-1), valid.reshape(-1))
        errors, timing = {}, {}
        zeros = lambda: torch.zeros(n_lanes, dtype=i32,  # noqa: E731
                                    device=dev)

        # C1 / C5 / C2: the total bound, max_contributions = 64.
        ktot = executor.lane_total_keys(keys)
        t1 = lambda: kernels.total_bound_keys_lanes(  # noqa: E731
            fp, fvalid, lane_rows, ktot, f32)
        t1_plain = lambda: kernels.total_bound_keys_lanes_plain(  # noqa: E731
            fp, fvalid, lane_rows, ktot, f32)
        lane_pid, u0 = t1()
        q1 = t1_plain()
        errors["total_bound_keys_lanes"] = max(
            check_equal("total_bound_keys_lanes lane_pid", lane_pid, q1[0]),
            check_equal("total_bound_keys_lanes u", u0, q1[1]))
        perm0, slane_pid = kernels.radix_sort([lane_pid, u0], sorted_top=True)
        check_equal("radix_sort (lane_pid, u)", perm0,
                    kernels.radix_sort_plain([lane_pid, u0]))
        tb_args = dict(lane_rows=lane_rows, total_bound=64, n_partitions=P)
        t2 = lambda: kernels.total_bound_rows_lanes(  # noqa: E731
            perm0, slane_pid, fk, fv, fvalid, **tb_args)
        t2_plain = lambda: kernels.total_bound_rows_lanes_plain(  # noqa: E731
            perm0, slane_pid, fk, fv, fvalid, **tb_args)
        errors["total_bound_rows_lanes"] = max(
            check_equal(f"total_bound_rows_lanes {w}", a, b)
            for w, a, b in zip(("pid", "pk", "values", "valid"), t2(),
                               t2_plain()))
        # C2's keyless lane entry: contribution bounds already enforced.
        cols = ("sum", "nsum", "nsum2")
        kl_args = dict(lane_rows=lane_rows, n_partitions=P, linf=0, l0=0,
                       clip_per_value=True, clip_pair_sum=False,
                       scalars=(1.0, 5.0, 0.0, 0.0, 3.0), columns=cols,
                       pk=fk)
        t3 = lambda: kernels.bound_rows_lanes(  # noqa: E731
            None, None, None, fv, fvalid, **kl_args)
        t3_plain = lambda: kernels.bound_rows_lanes_plain(  # noqa: E731
            None, None, None, fv, fvalid, **kl_args)
        got, want = t3(), t3_plain()
        errors["bound_rows_keyless_lanes"] = max(
            [check_equal("bound_rows_keyless_lanes key2", got[0], want[0]),
             check_equal("bound_rows_keyless_lanes pair_start", got[1],
                         want[1])] +
            [check_equal(f"bound_rows_keyless_lanes {c}", got[2][c],
                         want[2][c]) for c in cols])

        # The keyed lane entries' bounded, partition-sorted rows (S2's).
        salts, keys_linf, key_sel, slots = executor.lane_release_keys(
            keys, metric_plan)
        lane, k1, k2, u = kernels.row_keys_lanes(fp, fk, fvalid, lane_rows,
                                                 salts, keys_linf, P, f32)
        perm = kernels.radix_sort([lane, k1, k2, u])
        key2, pair_start, row_cols = kernels.bound_rows_lanes(
            perm, k1, k2, fv, fvalid, lane_rows=lane_rows, n_partitions=P,
            linf=1, l0=64, clip_per_value=True, clip_pair_sum=False,
            scalars=(1.0, 5.0, 0.0, 0.0, 3.0), columns=cols)
        perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
        kept_rows = int((skey2 < PP).sum())

        # C3 compensated: the columns x 1000 (integer-valued, sums past
        # 2^24): sum and nsum equal float32 of the exact sums.
        big = {c: row_cols[c] * 1000.0 for c in cols}
        t4 = lambda: kernels.reduce_partitions_lanes(  # noqa: E731
            skey2, perm2, pair_start, big, lane_rows, P, f32,
            compensated=True)
        t4_plain = lambda: kernels.reduce_partitions_lanes_plain(  # noqa: E731
            skey2, perm2, pair_start, big, lane_rows, P, f32,
            compensated=True)
        comp, q4 = same_twice("reduce_partitions_compensated_lanes",
                              t4), t4_plain()
        exact = kernels.reduce_partitions_lanes_plain(
            skey2, perm2, pair_start, {c: big[c].double() for c in cols},
            lane_rows, P, torch.float64)
        err = max(check_equal("reduce_partitions_compensated_lanes count",
                              comp["count"], q4["count"]),
                  check_equal("reduce_partitions_compensated_lanes "
                              "pid_count", comp["pid_count"],
                              q4["pid_count"]))
        for c in ("sum", "nsum"):
            err = max(err, check_equal(
                f"reduce_partitions_compensated_lanes {c} (exact)", comp[c],
                exact[c].float()))
        diff2 = float((comp["nsum2"].double() - exact["nsum2"]).abs().max())
        errors["reduce_partitions_compensated_lanes"] = err
        # C3's vector lane entry: the one-hot ratings (D = 5).
        onehot = spec_values(torch, fv, "onehot")
        t5 = lambda: kernels.reduce_partitions_lanes(  # noqa: E731
            skey2, perm2, pair_start, {}, lane_rows, P, f32, (perm, onehot))
        t5_plain = lambda: kernels.reduce_partitions_lanes_plain(  # noqa: E731
            skey2, perm2, pair_start, {}, lane_rows, P, f32, (perm, onehot))
        vcols = same_twice("reduce_partitions_vector_lanes", t5)
        # Integer-valued coordinates below 2^24: exact in any order.
        errors["reduce_partitions_vector_lanes"] = check_equal(
            "reduce_partitions_vector_lanes vsum", vcols["vsum"],
            t5_plain()["vsum"])
        vsum = vcols["vsum"]

        # C4 secure: the plan's four slots, private selection.
        from pipelinedp_tpu_torch.aggregate_params import (
            PartitionSelectionStrategy)
        from pipelinedp_tpu_torch.ops import selection_ops
        sel = selection_ops.selection_params_from_host(
            PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-6, 64,
            None)
        dense = kernels.reduce_partitions_lanes(skey2, perm2, pair_start,
                                                row_cols, lane_rows, P, f32)
        c4_args = (dense, executor.epilogue_plan(metric_plan), stds, slots,
                   NoiseKind.GAUSSIAN, False, 3.0, 1.0, sel, key_sel, 1,
                   n_lanes, tables)
        t6 = lambda: kernels.release_epilogue_lanes(*c4_args)  # noqa: E731
        t6_plain = lambda: kernels.release_epilogue_lanes_plain(  # noqa: E731
            *c4_args)
        keep, outs, flags = t6()
        q6 = t6_plain()
        err = max(check_equal("release_epilogue_secure_lanes keep", keep,
                              q6[0]),
                  check_equal("release_epilogue_secure_lanes flags", flags,
                              q6[2]))
        for name in outs:
            err = max(err, check_close(
                f"release_epilogue_secure_lanes {name}", outs[name],
                q6[1][name], rtol=1e-5, atol=1e-5))
        errors["release_epilogue_secure_lanes"] = err

        # C9: the one-hot sums, each lane under its slot key.
        keep_all = torch.ones(PP, dtype=torch.bool, device=dev)
        v_args = dict(max_norm=1000.0, norm_kind="l2", std=vstd,
                      keys=slots[:, 0], gaussian=True, n_lanes=n_lanes)
        t7 = lambda: kernels.vector_release_lanes(  # noqa: E731
            vsum, keep_all, zeros(), **v_args)
        t7_plain = lambda: kernels.vector_release_lanes_plain(  # noqa: E731
            vsum, keep_all, zeros(), **v_args)
        f_k, f_p = zeros(), zeros()
        got = kernels.vector_release_lanes(vsum, keep_all, f_k, **v_args)
        want = kernels.vector_release_lanes_plain(vsum, keep_all, f_p,
                                                  **v_args)
        # float32 noise words a few ulp apart: 1e-5 of the value plus the
        # noise scale (the solo C9 check's bound).
        vdiff = (got - want).abs()
        if bool((vdiff > 1e-5 * (want.abs() + vstd)).any()):
            raise AssertionError(f"vector_release_lanes: max diff "
                                 f"{float(vdiff.max())}")
        errors["vector_release_lanes"] = max(
            float(vdiff.max()),
            check_equal("vector_release_lanes flags", f_k, f_p))
        t8 = lambda: kernels.vector_release_lanes(  # noqa: E731
            vsum, keep_all, zeros(), tables=vtable, **v_args)
        t8_plain = lambda: kernels.vector_release_lanes_plain(  # noqa: E731
            vsum, keep_all, zeros(), tables=vtable, **v_args)
        f_k, f_p = zeros(), zeros()
        errors["vector_release_secure_lanes"] = max(
            check_equal("vector_release_secure_lanes", kernels.
                        vector_release_lanes(vsum, keep_all, f_k,
                                             tables=vtable, **v_args),
                        kernels.vector_release_lanes_plain(
                            vsum, keep_all, f_p, tables=vtable, **v_args)),
            check_equal("vector_release_secure_lanes flags", f_k, f_p))

        # C8: the lazy regime over the lanes' 17,770 movies (C7's child
        # counts a level), plain and secure.
        qkeys = np.stack([executor.quantile_key(k) for k in keys])
        tree = dict(tree_height=h, branching=B, min_v=1.0, max_v=5.0)
        err8 = {False: 0.0, True: 0.0}
        step_fns = {}
        for secure in (False, True):
            qt = qtable if secure else None
            state_k = kernels.DescentState(PP, n_q, f32, dev)
            state_p = kernels.DescentState(PP, n_q, f32, dev)
            f_k, f_p = zeros(), zeros()
            for level in range(1, h + 1):
                counts = kernels.quantile_child_counts(
                    skey2, perm2, perm, fv, state_k.node.clone(),
                    level=level, **tree)
                args = dict(level=level, tree_height=h, std=std_lazy,
                            level_keys=np.stack([threefry.fold_in(k, level)
                                                 for k in qkeys]),
                            gaussian=True, min_v=1.0, max_v=5.0,
                            keep=keep_all, n_lanes=n_lanes, tables=qt)
                if level == 1:
                    step_fns[secure] = (
                        lambda c=counts, a=args: kernels.
                        quantile_descend_step_lanes(
                            c, kernels.DescentState(PP, n_q, f32, dev),
                            QUANTILES, flags=zeros(), **a),
                        lambda c=counts, a=args: kernels.
                        quantile_descend_step_lanes_plain(
                            c, kernels.DescentState(PP, n_q, f32, dev),
                            QUANTILES, flags=zeros(), **a))
                out_k = kernels.quantile_descend_step_lanes(
                    counts, state_k, QUANTILES, flags=f_k, **args)
                out_p = kernels.quantile_descend_step_lanes_plain(
                    counts, state_p, QUANTILES, flags=f_p, **args)
                mismatch = int((state_k.node != state_p.node).sum())
                if mismatch:
                    raise AssertionError(
                        f"quantile_descend lanes (secure={secure}) level "
                        f"{level}: {mismatch} walks at another node")
            name = ("quantile_descend_secure_lanes" if secure else
                    "quantile_descend_lanes")
            err8[secure] = max(check_close(f"{name} lazy", out_k, out_p,
                                           rtol=1e-5),
                               check_equal(f"{name} lazy flags", f_k, f_p))
        # ... and the dense regime on movie mod 128 (P <= quantile_chunk).
        skey_d = torch.where(skey2 < PP, (skey2 // P) * PD + (skey2 % P) % PD,
                             n_lanes * PD).to(i32).contiguous()
        leaf = kernels.quantile_leaf_counts(skey_d, perm2, perm, fv,
                                            n_partitions=n_lanes * PD,
                                            n_leaves=B**h, min_v=1.0,
                                            max_v=5.0)
        levels = kernels.quantile_level_counts(leaf, tree_height=h,
                                               branching=B)
        del leaf
        dense_keys = np.stack([executor._dense_level_keys(k, h)
                               for k in qkeys])
        keep_d = torch.ones(n_lanes * PD, dtype=torch.bool, device=dev)
        for secure in (False, True):
            args = dict(std=std_lazy, level_keys=dense_keys, gaussian=True,
                        min_v=1.0, max_v=5.0, keep=keep_d, dtype=f32,
                        n_lanes=n_lanes, tables=qtable if secure else None)
            f_k, f_p = zeros(), zeros()
            out_k = kernels.quantile_descend_dense_lanes(
                levels, QUANTILES, flags=f_k, **args)
            out_p = kernels.quantile_descend_dense_lanes_plain(
                levels, QUANTILES, flags=f_p, **args)
            name = ("quantile_descend_secure_lanes" if secure else
                    "quantile_descend_lanes")
            err8[secure] = max(err8[secure],
                               check_close(f"{name} dense", out_k, out_p,
                                           rtol=1e-5),
                               check_equal(f"{name} dense flags", f_k, f_p))
        del levels
        errors["quantile_descend_lanes"] = err8[False]
        errors["quantile_descend_secure_lanes"] = err8[True]

        # Each spec's batched release == its solo release, lane by lane.
        for spec in LANE_SPECS:
            kind = LANE_SPECS[spec][2]
            cfg, cstds, sc, ctables = spec_release_cfg(tdp, executor, P, spec,
                                                       dev)
            svals = spec_values(torch, values, kind)
            batched = executor.batched_aggregate_release_kernel(
                pid, pk, svals, valid, *sc, cstds, keys, cfg, ctables)
            lanes_equal_solo(torch, f"batched ({spec})", batched,
                             lambda l: executor.aggregate_release_kernel(
                                 pid[l], pk[l], svals[l], valid[l], *sc,
                                 cstds, keys[l], cfg, ctables), n_lanes)
        torch.cuda.synchronize()
        print(f"spec lane kernels[L={n_lanes}, n={lane_rows}, P={P}]: every "
              f"new lane entry agrees with its plain version; the "
              f"compensated sums equal float32 of the exact sums (nsum2 "
              f"within {diff2}); every lane of the batched "
              f"{', '.join(LANE_SPECS)} releases equals its solo release "
              f"(==); max abs err {json.dumps(errors)} ({card})", flush=True)
        if (n_lanes, lane_rows) != LANE_SHAPES[-1]:
            continue
        fsz = 4
        src = torch.stack([torch.ones_like(fv), pair_start.float()], 1)
        vsrc = torch.cat([src, onehot], 1)[perm2]
        key_long = skey2.long()

        def library_c3v():
            out = torch.zeros(PP + 1, vsrc.shape[1], device=dev)
            return out.index_add_(0, key_long, vsrc)

        timing = {
            "total_bound_keys_lanes": (
                t1, t1_plain, None,
                bound(total * (4 + 1) + total * (8 + fsz), total * 110)),
            "total_bound_rows_lanes": (
                t2, t2_plain, None,
                bound(total * (8 + 8 + 4 + fsz + 1) +
                      total * (4 + 4 + fsz + 1), total * 20)),
            "bound_rows_keyless_lanes": (
                t3, t3_plain, None,
                bound(total * (4 + fsz + 1) + total * (4 + 1 + 3 * fsz),
                      total * 12)),
            "reduce_partitions_compensated_lanes": (
                t4, t4_plain, None,
                bound(total * 4 + kept_rows * (8 + 1 + 3 * fsz) +
                      PP * 5 * fsz, kept_rows * 3 * 8)),
            "reduce_partitions_vector_lanes": (
                t5, t5_plain, library_c3v,
                bound(total * 4 + kept_rows * (8 + 8 + 1 + 5 * fsz) +
                      PP * 7 * fsz, kept_rows * 7)),
            "release_epilogue_secure_lanes": (
                t6, t6_plain, None,
                bound(PP * 5 * fsz + PP * (1 + 5 * fsz) + 4 * n_lanes,
                      PP * 4 * 260)),
            "quantile_descend_lanes": (
                step_fns[False][0], step_fns[False][1], None,
                bound(PP * n_q * (B * 4 + 2 * (4 + 3 * fsz)),
                      PP * n_q * B * 250)),
            "quantile_descend_secure_lanes": (
                step_fns[True][0], step_fns[True][1], None,
                bound(PP * n_q * (B * 4 + 2 * (4 + 3 * fsz)),
                      PP * n_q * B * 400)),
            "vector_release_lanes": (
                t7, t7_plain, None,
                bound(PP * (2 * 5 * fsz + 1), PP * 5 * 150)),
            "vector_release_secure_lanes": (
                t8, t8_plain, None,
                bound(PP * (2 * 5 * fsz + 1), PP * 5 * 260)),
        }
        for name, (fn, plain, lib, (b_ms, b_by)) in timing.items():
            ms = cuda_ms(fn, repeats=10)
            plain_ms = cuda_ms(plain, repeats=3, warmup=1)
            lib_ms = cuda_ms(lib, repeats=10) if lib else None
            print(f"kernel {name}: max_abs_err={errors[name]} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) "
                  f"library_ms={lib_ms} (L={n_lanes} x {lane_rows} rows, "
                  f"P={P}; {card})", flush=True)
            source, replaces = SPEC_ENTRIES[name]
            report.append({
                "name": name, "route": "cuda",
                "source": f"pipelinedp_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": 0,
                "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return report


def micro_job_cols(columnar, seed):
    """One S1 micro-job as bench.py builds it: 64 pre-encoded rows over the
    same 48 partitions (and a random tail), 200 users, values U[0, 5]."""
    r = np.random.default_rng(seed)
    pk = np.concatenate([np.arange(48), r.integers(0, 48, MICRO_ROWS - 48)])
    pid = np.concatenate([np.arange(48) % 200,
                          r.integers(0, 200, MICRO_ROWS - 48)])
    return columnar.encode_columns(pid, pk, r.uniform(0.0, 5.0, MICRO_ROWS))


def release_launches(counts):
    """C4's launches, solo and lane entries, plain and secure."""
    return sum(counts[k] for k in (
        "release_epilogue", "release_epilogue_lanes",
        "release_epilogue_secure", "release_epilogue_secure_lanes"))


# S2f / S2i: the C8 and C9 lane entries beside S2's path (C7 counts every
# lane's partitions as one job's, under its solo name).
S2_PATHS = {
    "S2f": (SERVICE_PATH + ("quantile_child_counts",
                            "quantile_descend_lanes"),
            {"quantile_descend_lanes": "quantile_descend"}),
    "S2i": (SERVICE_PATH + ("reduce_partitions_vector_lanes",
                            "vector_release_lanes"),
            {"vector_release_lanes": "vector_release"}),
}
# S4: every other spec as 16 jobs of 2^16 rows, with the lane entries its
# batched group must launch.
S4_ROWS = 1 << 16
S4_SPECS = {
    "d": ("total_bound_keys_lanes", "total_bound_rows_lanes"),
    "enforced": ("bound_rows_keyless_lanes",),
    "safe": ("reduce_partitions_compensated_lanes",),
    "secure f": ("release_epilogue_secure_lanes",
                 "quantile_descend_secure_lanes"),
    "secure i": ("release_epilogue_secure_lanes",
                 "vector_release_secure_lanes"),
}


def service_phase(torch, tdp, kernels, card, users, movies, ratings,
                  micro_trials=MICRO_TRIALS, s2_jobs=S2_JOBS,
                  s2_rows=N_ROWS // S2_JOBS):
    """S1 (bench.py's micro-job load), S2a / S2b (the Netflix rows as 16
    jobs of 2^20 rows, cells (a) and (b)) and S3 (their selection) through
    DPAggregationService(TorchBackend()), batching off and on: every
    batched job equal to its solo run (results, spent epsilon, ledger
    trail), a batched group's launches those of one solo job. Returns the
    launch counts of the batched runs."""
    from pipelinedp_tpu_torch import columnar
    from pipelinedp_tpu_torch.runtime import telemetry
    from pipelinedp_tpu_torch.service import DPAggregationService, JobSpec
    total = dict.fromkeys(kernels.KERNELS, 0)

    # S1: 96 micro-jobs, 16 workers, lanes of 16, a 100 ms window.
    micro_params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM],
        noise_kind=tdp.NoiseKind.LAPLACE, max_partitions_contributed=4,
        max_contributions_per_partition=8, min_value=0.0, max_value=5.0)
    data = {i: micro_job_cols(columnar, i) for i in range(MICRO_JOBS)}
    warm = {i: micro_job_cols(columnar, 10_000 + i)
            for i in range(MICRO_WORKERS)}

    def micro_spec(seed):
        return JobSpec(params=micro_params, epsilon=1.0, delta=1e-6,
                       noise_seed=seed)

    # A solo micro-job's release through DPEngine, one thread at a time
    # and from several threads at once (the service's workers share the
    # GIL and the card's stream).
    def solo_job(i):
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=i))
        res = engine.aggregate(data[i % MICRO_JOBS], micro_params,
                               tdp.DataExtractors())
        acc.compute_budgets()
        return dict(res)

    for i in range(4):
        solo_job(i)
    start = time.perf_counter()
    lat = []
    for i in range(MICRO_JOBS // 2):
        t = time.perf_counter()
        solo_job(i)
        lat.append(time.perf_counter() - t)
    probe = [f"serial {statistics.median(lat) * 1e3:.2f} ms a job"]
    for n_threads in (2, 4, MICRO_WORKERS):
        def worker(first, n_threads=n_threads):
            for i in range(first, MICRO_JOBS, n_threads):
                solo_job(i)
        start = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        probe.append(f"{n_threads} threads "
                     f"{MICRO_JOBS / (time.perf_counter() - start):.1f} "
                     f"jobs/s")
    print(f"service S1 probe: solo micro-jobs through DPEngine without the "
          f"service: {', '.join(probe)} ({card})", flush=True)

    def run_s1(secure):
        """S1 through the service, batching off and on (secure: every
        release with secure noise); prints and checks as S1."""
        label = "S1 secure" if secure else "S1"
        s1 = {}
        for batching in (False, True):
            with DPAggregationService(
                    tdp.TorchBackend(secure_noise=secure),
                    max_concurrent_jobs=MICRO_WORKERS, queue_timeout_s=600.0,
                    batching=batching, batch_window_ms=100.0,
                    max_batch_jobs=MICRO_LANES) as svc:
                handles = [svc.submit(f"w{i}", micro_spec(900 + i), warm[i])
                           for i in range(MICRO_WORKERS)]
                for h in handles:
                    h.result(timeout=600)
                trials = []
                for trial in range(micro_trials):
                    kernels.reset_launch_counts()
                    before = telemetry.snapshot()
                    start = time.perf_counter()
                    handles = [svc.submit(f"tenant-{i % 3}",
                                          micro_spec(trial * 1000 + i),
                                          data[i])
                               for i in range(MICRO_JOBS)]
                    results = [h.result(timeout=600) for h in handles]
                    elapsed = time.perf_counter() - start
                    counts = dict(kernels.launch_counts)
                    delta = telemetry.delta(before)
                    latencies = sorted(h.latency_s for h in handles)
                    trials.append((MICRO_JOBS / elapsed, counts, delta,
                                   latencies, results))
                    if batching:
                        for name, n in counts.items():
                            total[name] += n
                if not svc.ledgers_reconciled():
                    raise AssertionError(f"{label} batching={batching}: "
                                         f"ledgers do not reconcile")
            s1[batching] = trials
        for trial, (solo, batched) in enumerate(zip(s1[False], s1[True])):
            if solo[4] != batched[4]:
                raise AssertionError(f"{label} trial {trial}: a batched job's "
                                     f"release differs from its solo run")
        for batching, trials in s1.items():
            jps, counts, delta, lat, _ = max(trials, key=lambda t: t[0])
            launches = delta.get("service_batch_launches", 0)
            occupancy = (delta.get("service_jobs_batched", 0) / launches
                         if launches else 0.0)
            p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
            lone = counts["release_epilogue"] + \
                counts["release_epilogue_secure"]
            print(f"service {label} batching={batching}: {MICRO_JOBS} jobs "
                  f"of {MICRO_ROWS} rows, {MICRO_WORKERS} workers: "
                  f"{jps:.1f} jobs/s (best of {len(trials)}: "
                  f"{[round(t[0], 1) for t in trials]}), latency p50 "
                  f"{lat[len(lat) // 2] * 1e3:.2f} ms p99 {p99 * 1e3:.2f} "
                  f"ms, release launches per {MICRO_JOBS} jobs "
                  f"{release_launches(counts)}, batched launches {launches}, "
                  f"mean occupancy {occupancy:.2f}, lone-window solo "
                  f"releases {lone} ({card})", flush=True)
        best = max(s1[True], key=lambda t: t[0])
        if release_launches(best[1]) > MICRO_JOBS // 4:
            raise AssertionError(f"{label}: {release_launches(best[1])} "
                                 f"release launches for {MICRO_JOBS} batched "
                                 f"jobs")

    run_s1(False)
    run_s1(True)

    # S2 / S3: 16 jobs of 2^20 Netflix rows, P = 17,770 in every lane.
    rows = s2_rows
    chunks = [slice(i * rows, (i + 1) * rows) for i in range(s2_jobs)]
    public = list(range(N_MOVIES))
    enc_public = [columnar.encode_columns(users[c], movies[c], ratings[c],
                                          public_partitions=public)
                  for c in chunks]
    enc_private = [columnar.encode_columns(users[c], movies[c], ratings[c])
                   for c in chunks]
    enc_onehot = [dataclasses.replace(
        enc, values=spec_values(np, enc.values, "onehot"))
        for enc in enc_public]

    def lane_spec(name, seed, n_public=N_MOVIES):
        return JobSpec(params=spec_params(tdp, name), epsilon=1.0,
                       delta=1e-6, noise_seed=seed,
                       public_partitions=list(range(n_public)))

    def agg_spec(metrics, noise, is_public, seed):
        params = tdp.AggregateParams(
            metrics=[getattr(tdp.Metrics, m) for m in metrics],
            noise_kind=getattr(tdp.NoiseKind, noise), min_value=1.0,
            max_value=5.0, max_partitions_contributed=64,
            max_contributions_per_partition=1)
        return JobSpec(params=params, epsilon=1.0, delta=1e-6,
                       noise_seed=seed,
                       public_partitions=public if is_public else None)

    def select_spec(seed):
        return JobSpec(params=tdp.SelectPartitionsParams(
            max_partitions_contributed=64), epsilon=1.0, delta=1e-6,
            noise_seed=seed)

    cells = {
        "S2a": ([agg_spec(("COUNT", "SUM", "MEAN", "VARIANCE"), "GAUSSIAN",
                          True, 300 + i) for i in range(s2_jobs)],
                enc_public),
        "S2b": ([agg_spec(("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE",
                          False, 400 + i) for i in range(s2_jobs)],
                enc_private),
        "S3": ([select_spec(500 + i) for i in range(s2_jobs)], enc_private),
        "S2f": ([lane_spec("f", 600 + i) for i in range(s2_jobs)],
                enc_public),
        "S2i": ([lane_spec("i", 700 + i) for i in range(s2_jobs)],
                enc_onehot),
    }
    for label, (specs, encs) in cells.items():
        path, extra = S2_PATHS.get(label, (SERVICE_PATH, {}))
        runs, walls = {}, {False: [], True: []}
        for batching in (False, True, False, True):
            with DPAggregationService(
                    tdp.TorchBackend(max_partitions=N_MOVIES),
                    max_concurrent_jobs=s2_jobs, queue_timeout_s=600.0,
                    batching=batching, batch_window_ms=60_000.0,
                    max_batch_jobs=s2_jobs) as svc:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                start = time.perf_counter()
                handles = [svc.submit(f"t{i}", spec, enc)
                           for i, (spec, enc) in enumerate(zip(specs, encs))]
                results = [h.result(timeout=600) for h in handles]
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
                counts = dict(kernels.launch_counts)
                if not svc.ledgers_reconciled():
                    raise AssertionError(f"{label} batching={batching}: "
                                         f"ledgers do not reconcile")
                trails = [svc.tenant_ledger(f"t{i}").records()
                          for i in range(s2_jobs)]
                spent = [h.spent_epsilon for h in handles]
            results = [plain_release(r) for r in results]
            if batching in runs and runs[batching][:3] != (results, spent,
                                                           trails):
                raise AssertionError(f"{label} batching={batching}: a "
                                     f"repeated run released otherwise")
            runs[batching] = (results, spent, trails, counts, wall)
            walls[batching].append(wall)
            if batching:
                for name, n in counts.items():
                    total[name] += n
        solo, batched = runs[False], runs[True]
        for i in range(s2_jobs):
            if solo[0][i] != batched[0][i] or solo[1][i] != batched[1][i] \
                    or solo[2][i] != batched[2][i]:
                raise AssertionError(f"{label} job {i}: the batched lane's "
                                     f"release, spent epsilon or ledger "
                                     f"trail differs from its solo run")
            if not solo[0][i]:
                raise AssertionError(f"{label} job {i} released nothing")
        check_launches(f"{label} batched", batched[3], kernels, path=path)
        for lane_name, solo_name in dict(SOLO_OF_LANE, **extra).items():
            if batched[3][lane_name] * s2_jobs != solo[3][solo_name] or \
                    batched[3][solo_name]:
                raise AssertionError(
                    f"{label}: {lane_name} launched {batched[3][lane_name]} "
                    f"times for {s2_jobs} lanes, {solo_name} "
                    f"{solo[3][solo_name]} times for {s2_jobs} solo jobs")
        if batched[3]["radix_sort"] * s2_jobs != solo[3]["radix_sort"]:
            raise AssertionError(f"{label}: radix_sort launched "
                                 f"{batched[3]['radix_sort']} times batched")
        kept = [len(r) for r in batched[0]]
        print(f"service {label}: {s2_jobs} jobs of {rows} rows, P = "
              f"{N_MOVIES}: every lane == its solo run (release, spent "
              f"epsilon {batched[1][0]}, ledger trail); kept "
              f"{min(kept)}-{max(kept)}; wall of {s2_jobs} solo jobs "
              f"{[round(w * 1e3, 1) for w in walls[False]]} ms, of one "
              f"batched group {[round(w * 1e3, 1) for w in walls[True]]} ms "
              f"(two runs each); release launches for {s2_jobs} jobs solo "
              f"{release_launches(solo[3])}, batched "
              f"{release_launches(batched[3])}; launches a group "
              f"{dict((k, batched[3][k]) for k in path)} ({card})",
              flush=True)

    # S4: the other specs' lane entries through the service, 16 jobs of
    # 2^16 Netflix rows each, solo and batched once.
    s4_chunks = [slice(i * S4_ROWS, (i + 1) * S4_ROWS)
                 for i in range(s2_jobs)]
    for label, entries in S4_SPECS.items():
        kind, options = LANE_SPECS[label][2], LANE_SPECS[label][4]
        encs = [columnar.encode_columns(
            users[c], movies[c], spec_values(np, ratings[c], kind),
            public_partitions=public) for c in s4_chunks]
        # Pre-bounded rows come without a privacy id extractor.
        extractors = (tdp.DataExtractors() if label == "enforced" else None)
        specs = [dataclasses.replace(lane_spec(label, 800 + i),
                                     data_extractors=extractors)
                 for i in range(s2_jobs)]
        runs = {}
        for batching in (False, True):
            with DPAggregationService(
                    tdp.TorchBackend(max_partitions=N_MOVIES, **options),
                    max_concurrent_jobs=s2_jobs, queue_timeout_s=600.0,
                    batching=batching, batch_window_ms=60_000.0,
                    max_batch_jobs=s2_jobs) as svc:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                start = time.perf_counter()
                handles = [svc.submit(f"t{i}", spec, enc)
                           for i, (spec, enc) in enumerate(zip(specs, encs))]
                results = [h.result(timeout=600) for h in handles]
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
                counts = dict(kernels.launch_counts)
                if not svc.ledgers_reconciled():
                    raise AssertionError(f"S4 ({label}) batching={batching}: "
                                         f"ledgers do not reconcile")
                trails = [svc.tenant_ledger(f"t{i}").records()
                          for i in range(s2_jobs)]
                spent = [h.spent_epsilon for h in handles]
            runs[batching] = ([plain_release(r) for r in results], spent,
                              trails, counts, wall)
        solo, batched = runs[False], runs[True]
        if solo[:3] != batched[:3] or not all(solo[0]):
            raise AssertionError(f"S4 ({label}): a batched lane's release, "
                                 f"spent epsilon or ledger trail differs "
                                 f"from its solo run, or a job released "
                                 f"nothing")
        check_launches(f"S4 ({label}) batched", batched[3], kernels,
                       path=entries + ("radix_sort", "compact_kept_lanes"))
        for name, n in batched[3].items():
            total[name] += n
        print(f"service S4 ({label}): {s2_jobs} jobs of {S4_ROWS} rows, P = "
              f"{N_MOVIES}: every lane == its solo run (release, spent "
              f"epsilon, ledger trail); wall solo {solo[4] * 1e3:.1f} ms, "
              f"batched {batched[4] * 1e3:.1f} ms; release launches solo "
              f"{release_launches(solo[3])}, batched "
              f"{release_launches(batched[3])}; "
              f"{dict((k, batched[3][k]) for k in entries)} ({card})",
              flush=True)
    return total


def plain_release(release):
    """A decoded release with its vector sums as lists (comparable with
    ==); a selection's list of keys as it is."""
    if not isinstance(release, dict):
        return release
    return {key: tuple(np.asarray(v).tolist() for v in metrics)
            for key, metrics in release.items()}


# ---------------------------------------------------------------------------
# The dense route over a device mesh (parallel/, K21, K22, K24c).

MESH_SHARDS = 4  # four shard slots on the one card
# The meshed dense path: C1-C6 a shard, C21 over the shards' columns; a
# device-resident input adds the exchange (C22, C23).
MESH_PATH = BASE_KERNELS + ("combine_parts",)
EXCHANGE_PATH = MESH_PATH + ("reshard_count", "reshard_exchange")
SOURCES = {"combine_shards": "combine_shards.cu",
           "combine_shards_compensated": "combine_shards.cu",
           "combine_parts": "combine_shards.cu",
           "combine_parts_compensated": "combine_shards.cu",
           "reshard_count": "reshard_count.cu",
           "reshard_exchange": "reshard_exchange.cu"}
REPLACES = {
    "combine_shards": "pipelinedp_tpu/parallel/sharded.py:161",
    "combine_shards_compensated": "pipelinedp_tpu/ops/segment_ops.py:160",
    "combine_parts": "pipelinedp_tpu/parallel/sharded.py:161",
    "combine_parts_compensated": "pipelinedp_tpu/ops/segment_ops.py:160",
    "reshard_count": "pipelinedp_tpu/parallel/reshard.py:106",
    "reshard_exchange": "pipelinedp_tpu/parallel/reshard.py:133"}


# None: four shard slots on cuda:0; "all": make_mesh(), one slot on every
# visible card (the --mesh-all-cards run).
MESH_CARDS = None


def card_mesh(torch, n_shards=MESH_SHARDS):
    from pipelinedp_tpu_torch.parallel.mesh import make_mesh
    if MESH_CARDS == "all":
        return make_mesh()
    return make_mesh([torch.device("cuda", 0)] * n_shards)


def mesh_all_cards(torch, tdp, cuda_build, columnar, kernels, card, t0):
    """python3 chip_smoke.py --mesh-all-cards: the mesh phases alone on
    make_mesh() over every visible card (shard s on cuda:s; the combine
    and the exchange cross cards by peer copy), the meshed blocked
    route's among them."""
    from pipelinedp_tpu_torch.parallel import large_p
    global MESH_CARDS
    MESH_CARDS = "all"
    print(f"build: {len(cuda_build.SOURCES)} kernel sources in "
          f"{cuda_build.build_all():.1f} s; {torch.cuda.device_count()} "
          f"cards ({card})", flush=True)
    rng = np.random.default_rng(SEED)
    users, movies, ratings = netflix_rows(rng)
    encoded = columnar.encode_columns(users, movies, ratings)
    report = mesh_kernel_phase(torch, torch.device("cuda", 0), encoded,
                               one_hot_ratings(encoded), kernels, card)
    mesh_parity_phase(torch, tdp, rng)
    launches = dict.fromkeys(kernels.KERNELS, 0)
    for phase in (mesh_phase(torch, tdp, encoded, kernels, card),
                  mesh_service_phase(torch, tdp, kernels, card, users, movies,
                                     ratings)):
        for name, count in phase.items():
            launches[name] += count
    qenc = columnar.encode_columns(*zipfish_rows())
    nmax = data_maxima(encoded.pid, encoded.pk, encoded.n_partitions)
    mb_report, mb_launches = mesh_blocked_phase(
        torch, tdp, rng, qenc, encoded, nmax, kernels, large_p, card)
    report += mb_report
    for name, count in mb_launches.items():
        launches[name] += count
    report += heartbeat_kernel_phase(torch, kernels, card)
    for name, count in heartbeat_route(torch, kernels, card).items():
        launches[name] += count
    for entry in report:
        entry["launches"] = launches[entry["name"]]
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def elastic_only(torch, tdp, cuda_build, columnar, kernels, card, t0):
    """python3 chip_smoke.py --elastic: the build, the Netflix and (q)
    data, and the failure-semantics phases alone (K23c's kernel check,
    elastic_phase) on card_mesh()."""
    print(f"build: {len(cuda_build.SOURCES)} kernel sources in "
          f"{cuda_build.build_all():.1f} s ({card})", flush=True)
    rng = np.random.default_rng(SEED)
    encoded = columnar.encode_columns(*netflix_rows(rng))
    nmax = data_maxima(encoded.pid, encoded.pk, encoded.n_partitions)
    qenc = columnar.encode_columns(*zipfish_rows())
    qmax = data_maxima(qenc.pid, qenc.pk, qenc.n_partitions)
    report = heartbeat_kernel_phase(torch, kernels, card)
    launches = elastic_phase(torch, tdp, encoded, nmax, qenc, qmax, kernels,
                             card)
    for entry in report:
        entry["launches"] = launches[entry["name"]]
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def walls_only(torch, tdp, cuda_build, columnar, card, t0, reps=5):
    """python3 chip_smoke.py --walls: the build, the data and the walls of
    (a), (b), (f), (h), (q), (v), meshed (q) (card_mesh(), rows on the card,
    reshard="device"), the streamed (x) and (y) (16 chunks, encode_threads
    4; (y) factorizes on the card, C12) and the histogram call on the
    Netflix rows (C5, C17, C18), each the median of `reps` runs timed as
    the main phases time them; then S2b's 16 lanes of 2^20 rows in one
    batched release (median of `reps`) and the pod ingest in hash_device
    mode onto card_mesh() with its mesh_factorize stage (median of 3),
    and nothing else. It drives the public
    entry points alone, so the same script compares two trees of the port
    in one call: run it from each tree's root in turns."""
    from pipelinedp_tpu_torch.dataset_histograms import (
        device_histograms as dh)
    print(f"build: {len(cuda_build.SOURCES)} kernel sources in "
          f"{cuda_build.build_all():.1f} s ({card})", flush=True)
    rng = np.random.default_rng(SEED)
    raw = netflix_rows(rng)
    encoded = columnar.encode_columns(*raw)
    chunks = stream_chunks(*raw)
    nmax = data_maxima(encoded.pid, encoded.pk, encoded.n_partitions)
    qenc = columnar.encode_columns(*zipfish_rows())
    mesh = card_mesh(torch)
    q_card = dataclasses.replace(
        qenc, pid=torch.as_tensor(qenc.pid).to(mesh.device),
        pk=torch.as_tensor(qenc.pk).to(mesh.device),
        values=torch.as_tensor(qenc.values).to(mesh.device, torch.float32))
    M, N = tdp.Metrics, tdp.NoiseKind
    netflix_bounds = dict(max_partitions_contributed=64,
                          max_contributions_per_partition=1, min_value=1.0,
                          max_value=5.0)
    q_bounds = dict(max_partitions_contributed=4,
                    max_contributions_per_partition=8, min_value=0.0,
                    max_value=5.0)
    v_bounds = dict(max_partitions_contributed=nmax[0],
                    max_contributions_per_partition=nmax[1], min_value=1.0,
                    max_value=5.0)
    cells = {
        "a": (encoded, [M.COUNT, M.SUM, M.MEAN, M.VARIANCE], N.GAUSSIAN,
              True, 1.0, netflix_bounds, {}),
        "b": (encoded, [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT], N.LAPLACE,
              False, 1.0, netflix_bounds, {}),
        "f": (encoded, [M.PERCENTILE(10), M.PERCENTILE(50),
                        M.PERCENTILE(90), M.COUNT], N.GAUSSIAN, True, 1.0,
              netflix_bounds, {}),
        "h": (by_release_year(encoded), [M.PERCENTILE(50), M.COUNT],
              N.LAPLACE, False, 1.0,
              dict(netflix_bounds, max_partitions_contributed=16,
                   max_contributions_per_partition=4), {}),
        "q": (qenc, [M.COUNT, M.SUM], N.LAPLACE, False, 1.0, q_bounds, {}),
        "v": (encoded, [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT], N.LAPLACE, True,
              1e6, v_bounds, dict(large_partition_threshold=4096,
                                  block_partitions=4096)),
        "meshed q": (q_card, [M.COUNT, M.SUM], N.LAPLACE, False, 1.0,
                     q_bounds, dict(mesh=mesh, reshard="device")),
        "x": ("host", [M.COUNT, M.SUM, M.MEAN, M.VARIANCE], N.GAUSSIAN,
              True, 1.0, netflix_bounds, dict(encode_threads=INGEST_THREADS)),
        "y": ("hash_device", [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT],
              N.LAPLACE, False, 1.0, netflix_bounds,
              dict(encode_threads=INGEST_THREADS)),
    }
    for label, (data, metrics, noise, public, eps, bounds, backend) in \
            cells.items():
        times = []
        for rep in range(reps):
            # A streamed run names its encode mode.
            streamed = isinstance(data, str)
            src = (tdp.ChunkSource(chunks, encode_mode=data) if streamed
                   else data)
            vocab = (encoded if streamed else data).partition_vocab
            acc = tdp.NaiveBudgetAccountant(total_epsilon=eps,
                                            total_delta=1e-6)
            res = tdp.DPEngine(acc, tdp.TorchBackend(
                noise_seed=rep, **backend)).aggregate(
                    src, tdp.AggregateParams(metrics=metrics,
                                              noise_kind=noise, **bounds),
                    tdp.DataExtractors(), list(vocab) if public else None)
            acc.compute_budgets()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = dict(res)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            if not out:
                raise AssertionError(f"wall ({label}): nothing released")
        print(f"wall ({label}): {statistics.median(times) * 1e3:.1f} ms, "
              f"median of {reps}: {[round(t * 1e3, 1) for t in times]} ms "
              f"({card})", flush=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        dh.compute_dataset_histograms_device(encoded.pid, encoded.pk,
                                             encoded.values)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    print(f"wall (histograms): {statistics.median(times) * 1e3:.1f} ms, "
          f"median of {reps}: {[round(t * 1e3, 1) for t in times]} ms "
          f"({card})", flush=True)
    # The lane wall: S2b's 16 lanes of 2^20 Netflix rows in one batched
    # release (the lane entries of C1-C6).
    from pipelinedp_tpu_torch import device_encode, executor, ingest
    n_lanes = 16
    lanes = [torch.as_tensor(c).to(mesh.device).reshape(n_lanes, -1) for c in (
        encoded.pid, encoded.pk, encoded.values.astype(np.float32),
        encoded.valid)]
    cfg, cstds, sc = release_cfg(tdp, executor, encoded.n_partitions,
                                 ("COUNT", "SUM", "PRIVACY_ID_COUNT"),
                                 "LAPLACE", True)
    keys = lane_keys(n_lanes, 500)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        executor.batched_aggregate_release_kernel(*lanes, *sc, cstds, keys,
                                                  cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    print(f"wall (lanes, S2b's 16 x 2^20 rows): "
          f"{statistics.median(times) * 1e3:.1f} ms, median of {reps}: "
          f"{[round(t * 1e3, 1) for t in times]} ms ({card})", flush=True)
    del lanes
    # The pod ingest of the Netflix rows onto card_mesh() in hash_device
    # mode, and its mesh_factorize stage (two factorize calls: the
    # privacy ids and the partitions).
    walls, stages = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        with IngestSplit(torch, ingest, device_encode) as split:
            start = time.perf_counter()
            enc = ingest.encode_local_shard_to_mesh(
                chunks, mesh, encode_mode="hash_device")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        stages.append(split.ms["mesh_factorize"])
        del enc
    print(f"wall (pod ingest, hash_device, {mesh.size} slots): "
          f"{statistics.median(walls) * 1e3:.1f} ms, median of 3: "
          f"{[round(t * 1e3, 1) for t in walls]} ms; its mesh_factorize "
          f"stage {statistics.median(stages):.2f} ms, median of 3: "
          f"{[round(t, 2) for t in stages]} ms ({card})", flush=True)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class plain_exchange:
    """Scope in which the reshard takes C22's and C23's plain versions
    (torch on the card): the twin a kernel run is held against."""

    def __init__(self, kernels):
        self.kernels = kernels

    def __enter__(self):
        k = self.kernels
        self.saved = (k.reshard_count, k.reshard_exchange)
        k.reshard_count = k.reshard_count_plain
        k.reshard_exchange = k.reshard_exchange_plain

    def __exit__(self, *exc):
        self.kernels.reshard_count, self.kernels.reshard_exchange = self.saved


def mesh_kernel_phase(torch, dev, encoded, onehot, kernels, card):
    """C21 (plain and compensated) at D = 4 over the release's 17,770 x 6
    columns, 2^21 and the 16-lane stack (16 x 17,770); C22 and C23 over
    the 2^24 Netflix rows split evenly over 4 shards, values scalar
    (V = 1) and one-hot (V = 5): each == its plain version on the card;
    times at the main path's shapes (C21: 17,770 x 6; C22 / C23: one
    shard's 2^22 rows, V = 1)."""
    from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
    from pipelinedp_tpu_torch.parallel import reshard
    mesh = card_mesh(torch)
    d = mesh.size
    report = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, m in (("17,770 x 6", N_MOVIES * 6), ("2^21", 1 << 21),
                     ("16 x 17,770", 16 * N_MOVIES)):
        # Ragged magnitudes and a 2^24 head with unit tails: the fold
        # order shows in the low bits.
        stack = (torch.randn(d, m, device=dev, generator=gen) *
                 10.0**torch.randint(-3, 8, (d, m), device=dev,
                                     generator=gen))
        stack[0, :1024] = 2.0**24
        stack[1:, :1024] = 1.0
        istack = torch.randint(-2**30, 2**30, (d, m), device=dev,
                               generator=gen, dtype=torch.int32)
        err = {
            "combine_shards": max(
                check_equal(f"combine_shards[{label}] float32",
                            kernels.combine_shards(stack),
                            kernels.combine_shards_plain(stack)),
                check_equal(f"combine_shards[{label}] int32",
                            kernels.combine_shards(istack),
                            kernels.combine_shards_plain(istack))),
            "combine_shards_compensated": check_equal(
                f"combine_shards_compensated[{label}]",
                kernels.combine_shards(stack, compensated=True),
                kernels.combine_shards_plain(stack, compensated=True)),
        }
        exact = stack.double().sum(0)
        fold_err = float((kernels.combine_shards(stack).double() -
                          exact).abs().max())
        comp_err = float((kernels.combine_shards(stack, True).double() -
                          exact).abs().max())
        b_ms, b_by = bound((d + 1) * m * 4, (d - 1) * m)
        for name, compensated in (("combine_shards", False),
                                  ("combine_shards_compensated", True)):
            ms = cuda_ms(lambda: kernels.combine_shards(stack, compensated),
                         50)
            plain_ms = cuda_ms(lambda: kernels.combine_shards_plain(
                stack, compensated), 10)
            lib_ms = cuda_ms(lambda: stack.sum(0), 50)
            print(f"kernel {name}[D={d}, M={label}]: == plain; ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) "
                  f"library_ms(stack.sum(0))={lib_ms:.4f}; largest "
                  f"difference from the float64 sum: shard-order fold "
                  f"{fold_err:.4g}, compensated {comp_err:.4g} ({card})",
                  flush=True)
            if label == "17,770 x 6":
                report.append(dict(
                    name=name, route="cuda",
                    source=f"pipelinedp_tpu_torch/csrc/{SOURCES[name]}",
                    replaces=REPLACES[name], launches=0,
                    max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        for compensated in (False, True):
            same_twice(f"combine_shards[{label}, compensated={compensated}]",
                       lambda: {"sum": kernels.combine_shards(stack,
                                                              compensated)})
        print_three_way(f"C21 stack, D={d}, M={label} float32", three_way(
            torch, {"combine_shards": lambda: kernels.combine_shards(stack),
                    "combine_shards_compensated":
                        lambda: kernels.combine_shards(stack, True),
                    "stack.sum(0)": lambda: stack.sum(0)}), card)
        if label != "17,770 x 6":
            continue
        # combine_parts over (a)'s meshed release columns: 6 columns of
        # 17,770 a shard, laid out as C3 lays them (one [6, P] block a
        # shard: every other column 8 bytes off a 16-byte boundary).
        parts = [list(stack[s].view(6, N_MOVIES).unbind(0))
                 for s in range(d)]
        for name, compensated in (("combine_parts", False),
                                  ("combine_parts_compensated", True)):
            got = same_twice(name, lambda: dict(enumerate(
                kernels.combine_parts(parts, compensated))))
            err_p = max(check_equal(f"{name}[(a)'s columns] column {c}",
                                    got[c], want)
                        for c, want in enumerate(kernels.combine_parts_plain(
                            parts, compensated)))
            whole = kernels.combine_shards(stack, compensated).view(
                6, N_MOVIES)
            for c in range(6):
                check_equal(f"{name} column {c} vs combine_shards", got[c],
                            whole[c])
            fn = lambda: kernels.combine_parts(  # noqa: E731
                parts, compensated)
            ms = cuda_ms(fn, 50)
            plain_ms = cuda_ms(lambda: kernels.combine_parts_plain(
                parts, compensated), 10)
            split = three_way(torch, {
                name: fn, "torch.stack(parts).sum(0), two calls":
                    lambda: torch.stack([stack[s] for s in range(d)]).sum(0)})
            print(f"kernel {name}[D={d}, 6 columns x 17,770 float32, (a)'s "
                  f"meshed release]: == plain, == combine_shards of the "
                  f"stack; ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
                  f"{b_ms:.3g} ({b_by}) library_ms=None (no one call "
                  f"computes it: the yardstick stacks each shard's block, "
                  f"then sums, two calls) ({card})", flush=True)
            print_three_way(f"C21 parts, D={d}, 6 x 17,770 float32", split,
                            card)
            report.append(dict(
                name=name, route="cuda",
                source="pipelinedp_tpu_torch/csrc/combine_shards.cu",
                replaces=REPLACES[name],
                launches=0, max_abs_err=err_p, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # C22 and C23 over the Netflix rows on 4 shards.
    pid = torch.as_tensor(encoded.pid).to(dev)
    pk = torch.as_tensor(encoded.pk).to(dev)
    valid = torch.as_tensor(encoded.valid).to(dev)
    per_in = mesh_lib.rows_per_shard(encoded.n_rows, d)
    for width, vals in ((1, torch.as_tensor(encoded.values).to(
            dev, torch.float32)), (5, torch.as_tensor(onehot.values).to(
                dev, torch.float32))):
        reshard.reset_capacity_cache()
        shards = reshard._pad_and_shard(mesh, per_in, pid, pk, vals, valid)
        counted = []
        for s in shards:
            with mesh_lib.on_device(s[0].device):
                counted.append(kernels.reshard_count(s[0], s[3], d))
        err22 = 0.0
        for s, got in zip(shards, counted):
            want = kernels.reshard_count_plain(s[0], s[3], d)
            err22 = max([err22] + [check_equal(f"reshard_count {w}", a, b)
                                   for w, a, b in zip(("dest", "rank",
                                                       "counts"), got, want)])
        got = reshard.device_reshard_rows_by_pid(mesh, pid, pk, vals, valid)
        reshard.reset_capacity_cache()
        with plain_exchange(kernels):
            want = reshard.device_reshard_rows_by_pid(mesh, pid, pk, vals,
                                                      valid)
        err23 = max(check_equal(f"reshard_exchange shard {s} column {j}",
                                g[j], w[j])
                    for s, (g, w) in enumerate(zip(got, want))
                    for j in range(4))
        table = np.stack([c[2][:d].cpu().numpy() for c in counted]).astype(
            np.int64)
        recv = table.sum(axis=0)
        out_cap = got[0][0].shape[0]
        kept = sum(int(s[3].sum()) for s in got)
        if kept != int(valid.sum()) or table.sum() != kept:
            raise AssertionError(f"reshard V={width}: {kept} rows arrived "
                                 f"of {int(valid.sum())}")
        owner = torch.full((int(pid.max()) + 1,), -1, dtype=torch.int64,
                           device=dev)
        for s, (s_pid, _, _, s_valid) in enumerate(got):
            owner[s_pid[s_valid].long().to(dev)] = s
        for s, (s_pid, _, _, s_valid) in enumerate(got):
            if bool((owner[s_pid[s_valid].long().to(dev)] != s).any()):
                raise AssertionError(f"reshard V={width}: a privacy id's "
                                     f"rows lie on two shards")
        print(f"reshard[2^24 rows, D={d}, V={width}]: C22 on every shard "
              f"and the C22 + C23 exchange == their plain versions; every "
              f"id on one shard; send table {table.tolist()}, out_cap "
              f"{out_cap} (max receive {int(recv.max())}) ({card})",
              flush=True)
        if width != 1:
            continue
        s_pid, s_pk, s_vals, s_valid = shards[0]
        dest, rank, _ = counted[0]
        n = s_pid.shape[0]
        n_valid = int(s_valid.sum())
        offsets = np.cumsum(table, axis=0) - table
        outs = [reshard._empty_rows(dev, out_cap, vals) for _ in range(d)]
        targets = [outs[t] + (int(offsets[0, t]),) for t in range(d)]
        fill = outs[0] + (int(recv[0]),)
        pad = out_cap - int(recv[0])
        timing = {
            "reshard_count": (
                lambda: kernels.reshard_count(s_pid, s_valid, d),
                lambda: kernels.reshard_count_plain(s_pid, s_valid, d),
                lambda: torch.bincount(dest.long(), minlength=d + 1),
                bound(n * (4 + 1 + 4 + 4), n * 40), err22),
            "reshard_exchange": (
                lambda: kernels.reshard_exchange(s_pid, s_pk, s_vals, dest,
                                                 rank, targets, fill),
                lambda: kernels.reshard_exchange_plain(
                    s_pid, s_pk, s_vals, dest, rank, targets, fill),
                lambda: [c.index_select(0, torch.argsort(dest, stable=True))
                         for c in (s_pid, s_pk, s_vals, s_valid)],
                bound(n * 8 + n_valid * (4 + 4 + 4) * 2 + n_valid +
                      pad * (4 + 4 + 4 + 1), n), err23),
        }
        for name, (fn, plain, lib, (b_ms, b_by), err) in timing.items():
            ms = cuda_ms(fn, 20)
            plain_ms = cuda_ms(plain, 3, 1)
            lib_ms = cuda_ms(lib, 10)
            print(f"kernel {name}[one shard: {n} rows, {n_valid} valid, "
                  f"D={d}]: == plain; ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={b_ms:.3g} ({b_by}) library_ms={lib_ms:.4f} "
                  f"({card})", flush=True)
            report.append(dict(
                name=name, route="cuda",
                source=f"pipelinedp_tpu_torch/csrc/{SOURCES[name]}",
                replaces=REPLACES[name], launches=0, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms))
    return report


def mesh_parity_phase(torch, tdp, rng, devices=("cuda", "cpu")):
    """Small meshed aggregations and a selection in float64 on
    make_mesh([cuda:0] * 4) against the same on make_mesh(["cpu"] * 4)
    (the plain versions), both reshard modes: the same partitions, values
    within 1e-9 relative."""
    from pipelinedp_tpu_torch.parallel.mesh import make_mesh
    n = 4096
    users = rng.integers(0, 300, n)
    movies = (rng.integers(0, 40, n)**2) // 40
    ratings = rng.integers(1, 6, n).astype(np.float64)
    rows = list(zip(users.tolist(), movies.tolist(), ratings.tolist()))
    public = sorted(set(movies.tolist()))
    M = tdp.Metrics
    cases = (
        ("count-sum-mean-variance", [M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
         "GAUSSIAN", True),
        ("count-sum-pid, private", [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT],
         "LAPLACE", False),
        ("percentile", [M.PERCENTILE(50), M.COUNT], "LAPLACE", True),
        ("select", None, None, False))
    for mode in ("host", "device"):
        for label, metrics, noise, is_public in cases:
            results = []
            for device in devices:
                mesh = make_mesh([torch.device(device)] * MESH_SHARDS)
                acc = tdp.NaiveBudgetAccountant(total_epsilon=4.0,
                                                total_delta=1e-6)
                engine = tdp.DPEngine(acc, tdp.TorchBackend(
                    device=device, noise_seed=5, dtype=torch.float64,
                    mesh=mesh, reshard=mode))
                ex = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                        partition_extractor=lambda r: r[1],
                                        value_extractor=lambda r: r[2])
                if metrics is None:
                    res = engine.select_partitions(
                        rows, tdp.SelectPartitionsParams(
                            max_partitions_contributed=3), ex)
                else:
                    res = engine.aggregate(rows, tdp.AggregateParams(
                        metrics=metrics,
                        noise_kind=getattr(tdp.NoiseKind, noise),
                        max_partitions_contributed=4,
                        max_contributions_per_partition=2, min_value=1.0,
                        max_value=5.0), ex, public if is_public else None)
                acc.compute_budgets()
                results.append(list(res) if metrics is None else dict(res))
            gpu, cpu = results
            if metrics is None:
                if gpu != cpu or not gpu:
                    raise AssertionError(f"mesh parity select {mode}: cuda "
                                         f"kept {len(gpu)}, cpu {len(cpu)}")
                worst = 0.0
            else:
                if set(gpu) != set(cpu) or not gpu:
                    raise AssertionError(f"mesh parity {label} {mode}: "
                                         f"released partitions differ")
                worst = max(abs(a - b) / max(1.0, abs(b))
                            for k in cpu for a, b in zip(gpu[k], cpu[k]))
                if worst > 1e-9:
                    raise AssertionError(f"mesh parity {label} {mode}: rel "
                                         f"err {worst}")
            print(f"mesh parity[{label}, reshard={mode}, D={MESH_SHARDS}]: "
                  f"{len(gpu)} partitions, cuda float64 vs cpu float64 max "
                  f"rel err {worst:.3g}", flush=True)


def mesh_phase(torch, tdp, encoded, kernels, card):
    """The dense route over make_mesh([cuda:0] * 4) at full size (the 2^24
    Netflix rows): runs (a), (b) and a selection with reshard="host"
    (host numpy, the LPT permutation; one run) and "device" (the rows
    uploaded first, the C22 + C23 exchange; two runs); (c) through the mesh == the unmeshed
    (c) and within 16 noise stds of the numpy group-by; (p, eps 1e12)
    through the mesh (C21's compensated entry); (b) on make_mesh() (one
    slot on the one card); the stage split and the device's idle share
    of (a). Returns the launch counts summed over its runs."""
    import dataclasses
    from pipelinedp_tpu_torch.parallel.mesh import make_mesh
    total = dict.fromkeys(kernels.KERNELS, 0)
    mesh = card_mesh(torch)
    dev = mesh.device
    d = mesh.size
    vocab = list(encoded.partition_vocab)
    P = len(vocab)
    on_card = dataclasses.replace(
        encoded, pid=torch.as_tensor(encoded.pid).to(dev),
        pk=torch.as_tensor(encoded.pk).to(dev),
        values=torch.as_tensor(encoded.values).to(dev, torch.float32))
    pair_key = encoded.pid.astype(np.int64) * N_MOVIES + encoded.pk
    pairs, pair_rows = np.unique(pair_key, return_counts=True)
    l0_true = int(np.bincount(pairs // N_MOVIES).max())
    linf_true = int(pair_rows.max())

    def params(metrics, noise, **bounds):
        return tdp.AggregateParams(
            metrics=[getattr(tdp.Metrics, m) for m in metrics],
            noise_kind=getattr(tdp.NoiseKind, noise), min_value=1.0,
            max_value=5.0, **bounds)

    def release(label, backend, data, metrics, noise, public, eps, path,
                want=None, **bounds):
        acc = tdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
        engine = tdp.DPEngine(acc, backend)
        kernels.reset_launch_counts()
        if metrics is None:
            res = engine.select_partitions(data, tdp.SelectPartitionsParams(
                max_partitions_contributed=64), tdp.DataExtractors())
        else:
            res = engine.aggregate(data, params(metrics, noise, **bounds),
                                   tdp.DataExtractors(),
                                   vocab if public else None)
        acc.compute_budgets()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = list(res) if metrics is None else dict(res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = dict(kernels.launch_counts)
        check_launches(f"mesh ({label})", counts, kernels, want, path)
        for name, n in counts.items():
            total[name] += n
        if not out or (metrics is not None and not all(
                math.isfinite(x) for v in out.values() for x in v)):
            raise AssertionError(f"mesh ({label}): {len(out)} partitions or "
                                 f"a non-finite value")
        return out, seconds, counts

    shard_launches = dict(row_keys=d, bound_rows=d, radix_sort=2 * d,
                          combine_parts=1)
    per_partition = dict(max_partitions_contributed=64,
                         max_contributions_per_partition=1)
    runs = {"a": (("COUNT", "SUM", "MEAN", "VARIANCE"), "GAUSSIAN", True),
            "b": (("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE", False),
            "select": (None, None, False)}
    for label, (metrics, noise, public) in runs.items():
        for mode, data, path in (("host", encoded, MESH_PATH),
                                 ("device", on_card, EXCHANGE_PATH)):
            times = []
            # The host permutation's seconds dwarf the kernels: one run.
            for rep in range(1 if mode == "host" else 2):
                out, seconds, counts = release(
                    f"{label}, {mode}", tdp.TorchBackend(
                        noise_seed=rep, mesh=mesh, reshard=mode), data,
                    metrics, noise, public, 1.0, path,
                    dict(shard_launches, **(dict(reshard_count=d,
                                                 reshard_exchange=d)
                                            if mode == "device" else {})),
                    **({} if metrics is None else per_partition))
                times.append(seconds)
            print(f"mesh ({label}) reshard={mode} D={d}: {len(out)} "
                  f"partitions, {[round(t * 1e3, 1) for t in times]} ms "
                  f"(wall; {N_ROWS / min(times):.4g} rows/s at the "
                  f"faster; {card}); launches {dict((k, counts[k]) for k in path)}",
                  flush=True)

    # (c): eps 1e6 and the true maxima, meshed == unmeshed.
    bounds = dict(max_partitions_contributed=l0_true,
                  max_contributions_per_partition=linf_true)
    solo, _, _ = release("c, unmeshed", tdp.TorchBackend(noise_seed=9),
                         encoded, ("COUNT", "SUM", "PRIVACY_ID_COUNT"),
                         "LAPLACE", True, 1e6, BASE_KERNELS, **bounds)
    true_count = np.bincount(encoded.pk, minlength=P).astype(np.float64)
    true_sum = np.bincount(encoded.pk, weights=encoded.values, minlength=P)
    true_pid = np.bincount(pairs % N_MOVIES, minlength=P)
    eps_each = 1e6 / 3
    std = {"count": math.sqrt(2) * l0_true * linf_true / eps_each,
           "sum": math.sqrt(2) * l0_true * linf_true * 5.0 / eps_each,
           "privacy_id_count": math.sqrt(2) * l0_true / eps_each}
    for mode, data, path in (("host", encoded, MESH_PATH),
                             ("device", on_card, EXCHANGE_PATH)):
        out, seconds, _ = release(
            f"c, {mode}", tdp.TorchBackend(noise_seed=9, mesh=mesh,
                                           reshard=mode), data,
            ("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE", True, 1e6, path,
            **bounds)
        if out != solo:
            bad = [m for m in vocab if out[m] != solo[m]]
            raise AssertionError(f"mesh (c, {mode}): {len(bad)} partitions "
                                 f"differ from the unmeshed (c), first "
                                 f"{bad[:1]}: {out[bad[0]]} vs "
                                 f"{solo[bad[0]]}")
        for name, truth in (("count", true_count), ("sum", true_sum),
                            ("privacy_id_count", true_pid)):
            got = np.array([getattr(out[m], name) for m in vocab])
            if (np.abs(got - truth) > 16 * std[name] + 1e-6 *
                    np.abs(truth)).any():
                raise AssertionError(f"mesh (c, {mode}) {name}: off the "
                                     f"numpy group-by")
        print(f"mesh (c) reshard={mode} D={d} epsilon=1e6, l0={l0_true}, "
              f"linf={linf_true}: {len(out)} partitions == the unmeshed "
              f"(c) and within 16 noise stds of the numpy group-by, in "
              f"{seconds * 1e3:.1f} ms", flush=True)

    # (p, eps 1e12) through the mesh: C21's compensated entry.
    scaled = dataclasses.replace(encoded, values=encoded.values * 1000)
    true_k = np.bincount(encoded.pk, weights=encoded.values * 1000,
                         minlength=P)
    safe_path = tuple(k for k in MESH_PATH if k not in (
        "reduce_partitions", "combine_parts")) + (
            "reduce_partitions_compensated", "combine_parts_compensated")
    acc_p = tdp.NaiveBudgetAccountant(total_epsilon=1e12, total_delta=1e-6)
    from pipelinedp_tpu_torch import combiners, executor
    p_params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM],
        noise_kind=tdp.NoiseKind.GAUSSIAN, min_value=1000.0,
        max_value=5000.0, **bounds)
    compound = combiners.create_compound_combiner(p_params, acc_p)
    acc_p.compute_budgets()
    sum_std = float(executor.compute_noise_stds(compound)[1])
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1e12, total_delta=1e-6)
    kernels.reset_launch_counts()
    res = tdp.DPEngine(acc, tdp.TorchBackend(
        noise_seed=13, mesh=mesh, numeric_mode="safe")).aggregate(
            scaled, p_params, tdp.DataExtractors(), vocab)
    acc.compute_budgets()
    out = dict(res)
    counts = dict(kernels.launch_counts)
    check_launches("mesh (p, eps 1e12)", counts, kernels, path=safe_path)
    for name, n in counts.items():
        total[name] += n
    got = np.array([out[m].sum for m in vocab])
    ulp = np.spacing(np.abs(true_k).astype(np.float32)).astype(np.float64)
    # Each shard's compensated partial is rounded to float32 once before
    # the compensated combine (as the JAX package's are): D ulps.
    tol = 16 * sum_std + d * ulp
    if (np.abs(got - true_k) > tol).any():
        raise AssertionError("mesh (p, eps 1e12): a sum off the numpy int64 "
                             "group-by by more than 16 stds + D ulps")
    exact = int((got == true_k.astype(np.float32).astype(np.float64)).sum())
    print(f"mesh (p, eps 1e12) safe float32 D={d}, rating x 1000: {len(out)} "
          f"sums within 16 noise stds ({sum_std:.3g}) + {d} float32 ulps of "
          f"the numpy int64 group-by; {exact} equal float32(exact sum) "
          f"(a record); launches "
          f"{dict((k, counts[k]) for k in safe_path)} ({card})", flush=True)

    # (b) on the default mesh: every visible card, one slot each.
    default = make_mesh()
    out, seconds, counts = release(
        "b, make_mesh()", tdp.TorchBackend(noise_seed=3, mesh=default),
        encoded, ("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE", False, 1.0,
        MESH_PATH, None, **per_partition)
    print(f"mesh (b) on make_mesh() = {default}: {len(out)} partitions in "
          f"{seconds * 1e3:.1f} ms ({card})", flush=True)
    mesh_stage_phase(torch, tdp, encoded, on_card, kernels, mesh, card)
    return total


def mesh_stage_phase(torch, tdp, encoded, on_card, kernels, mesh, card):
    """Run (a)'s meshed release split into its stages, host clock around
    work that ends in a synchronize: the staging (the host LPT
    permutation and upload, or the C22 + C23 exchange), each shard's
    phase 1, the C21 combine, the release (C4, C6) and the decode; then
    the device's idle share of a meshed (a) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from pipelinedp_tpu_torch import combiners, executor
    from pipelinedp_tpu_torch.ops import threefry
    from pipelinedp_tpu_torch.parallel import reshard, sharded
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM, tdp.Metrics.MEAN,
                 tdp.Metrics.VARIANCE], noise_kind=tdp.NoiseKind.GAUSSIAN,
        min_value=1.0, max_value=5.0, max_partitions_contributed=64,
        max_contributions_per_partition=1)
    compound = combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    P = encoded.n_partitions
    cfg = executor.make_kernel_config(params, compound, P, False, None)
    stds = executor.compute_noise_stds(compound)
    scalars = executor.kernel_scalars(params)
    key = np.array([0, 21], np.uint32)
    f32 = torch.float32

    def clock(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - start) * 1e3

    for mode, data in (("host", encoded), ("device", on_card)):
        split = {}
        # The device mode's second run is the one printed.
        for _ in range(1 if mode == "host" else 2):
            rows = executor.pad_rows(data)
            shards, split["staging"] = clock(
                lambda: reshard.stage_rows_to_mesh(mesh, *rows, mode, f32))
            rows_key, _ = executor.release_key_halves(key)
            parts, split["phase 1, all shards"] = clock(lambda: [
                executor.partial_columns(
                    *s, *scalars, threefry.fold_in(rows_key, i), cfg)[0]
                for i, s in enumerate(shards)])
            cols, split["combine (C21)"] = clock(
                lambda: sharded._combine_partials(parts, mesh.device))
            result, split["release (C4, C6)"] = clock(
                lambda: executor.release_columns(cols, None, *scalars[:2],
                                                 scalars[4], stds, key, cfg,
                                                 f32))
            _, split["decode"] = clock(lambda: list(
                executor.decode_release_results(
                    *result, encoded.partition_vocab, compound)))
        total_ms = sum(split.values())
        print(f"mesh stages (a) reshard={mode} D={mesh.size}: "
              f"{json.dumps({k: round(v, 2) for k, v in split.items()})} ms,"
              f" {total_ms:.1f} ms in all ({card})", flush=True)

    for mode, data in (("host", encoded), ("device", on_card)):
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        res = tdp.DPEngine(acc, tdp.TorchBackend(
            noise_seed=21, mesh=mesh, reshard=mode)).aggregate(
                data, params, tdp.DataExtractors(),
                list(encoded.partition_vocab))
        acc.compute_budgets()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            list(res)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not device:
            raise AssertionError("mesh profile: no device time traced")
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
        print(f"mesh profile (a) reshard={mode} D={mesh.size}: wall "
              f"{wall_ms:.1f} ms under the profiler, device busy "
              f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f} "
              f"({card}); largest [name, ms, calls]: " +
              json.dumps([[short_kernel_name(e.key),
                           round(e.self_device_time_total / 1e3, 4), e.count]
                          for e in top]), flush=True)


def mesh_service_phase(torch, tdp, kernels, card, users, movies, ratings,
                       s2_jobs=S2_JOBS, s2_rows=N_ROWS // S2_JOBS):
    """S2b's 16 jobs of 2^20 Netflix rows (COUNT + SUM + PRIVACY_ID_COUNT,
    Laplace, private) on TorchBackend(max_partitions=17,770,
    mesh=make_mesh([cuda:0] * 4)), batching off and on: every batched job
    == its solo meshed run (release, spent epsilon, ledger trail). Returns
    the batched run's launch counts."""
    from pipelinedp_tpu_torch import columnar
    from pipelinedp_tpu_torch.runtime import telemetry
    from pipelinedp_tpu_torch.service import DPAggregationService, JobSpec
    total = dict.fromkeys(kernels.KERNELS, 0)
    mesh = card_mesh(torch)
    chunks = [slice(i * s2_rows, (i + 1) * s2_rows) for i in range(s2_jobs)]
    encs = [columnar.encode_columns(users[c], movies[c], ratings[c])
            for c in chunks]
    params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM,
                 tdp.Metrics.PRIVACY_ID_COUNT],
        noise_kind=tdp.NoiseKind.LAPLACE, min_value=1.0, max_value=5.0,
        max_partitions_contributed=64, max_contributions_per_partition=1)
    specs = [JobSpec(params=params, epsilon=1.0, delta=1e-6,
                     noise_seed=400 + i) for i in range(s2_jobs)]
    runs = {}
    for batching in (False, True):
        with DPAggregationService(
                tdp.TorchBackend(max_partitions=N_MOVIES, mesh=mesh),
                max_concurrent_jobs=s2_jobs, queue_timeout_s=600.0,
                batching=batching, batch_window_ms=60_000.0,
                max_batch_jobs=s2_jobs) as svc:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            before = telemetry.snapshot()
            start = time.perf_counter()
            handles = [svc.submit(f"t{i}", spec, enc)
                       for i, (spec, enc) in enumerate(zip(specs, encs))]
            results = [h.result(timeout=600) for h in handles]
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            counts = dict(kernels.launch_counts)
            delta = telemetry.delta(before)
            if not svc.ledgers_reconciled():
                raise AssertionError(f"mesh S2b batching={batching}: ledgers "
                                     f"do not reconcile")
            trails = [svc.tenant_ledger(f"t{i}").records()
                      for i in range(s2_jobs)]
            spent = [h.spent_epsilon for h in handles]
        runs[batching] = (results, spent, trails, counts, wall, delta)
    solo, batched = runs[False], runs[True]
    for i in range(s2_jobs):
        if solo[0][i] != batched[0][i] or solo[1][i] != batched[1][i] or \
                solo[2][i] != batched[2][i]:
            raise AssertionError(f"mesh S2b job {i}: the batched lane's "
                                 f"release, spent epsilon or ledger trail "
                                 f"differs from its solo meshed run")
        if not solo[0][i]:
            raise AssertionError(f"mesh S2b job {i} released nothing")
    lanes = batched[5].get("service_jobs_batched", 0)
    if not lanes:
        raise AssertionError("mesh S2b: no job ran as a meshed lane")
    check_launches("mesh S2b batched", batched[3], kernels,
                   path=SERVICE_PATH + ("combine_parts",))
    for name, n in batched[3].items():
        total[name] += n
    print(f"mesh service S2b D={mesh.size}: {s2_jobs} jobs of {s2_rows} rows: "
          f"every batched job == its solo meshed run (release, spent "
          f"epsilon, ledger trail); {lanes} jobs ran as lanes of "
          f"{batched[5].get('service_batch_launches', 0)} meshed launches; "
          f"wall solo {solo[4] * 1e3:.1f} ms, batched "
          f"{batched[4] * 1e3:.1f} ms; batched launches "
          f"{dict((k, batched[3][k]) for k in SERVICE_PATH + ('combine_parts',))}"
          f" ({card})", flush=True)
    mesh_batched_percentile(torch, tdp, kernels, card, mesh, users, movies,
                            ratings)
    return total


def mesh_batched_percentile(torch, tdp, kernels, card, mesh, users, movies,
                            ratings, n_lanes=4, n=1 << 18):
    """One meshed lane-batched release of cell (f)'s spec (PERCENTILE 10 /
    50 / 90 + COUNT, the lazy regime over 17,770 movies): 4 lanes of 2^18
    Netflix rows sharing one privacy-id column (one staged layout), each
    lane == its solo meshed release (sharded_aggregate_arrays)."""
    from pipelinedp_tpu_torch import columnar, executor
    from pipelinedp_tpu_torch.parallel import sharded
    enc = columnar.encode_columns(users[:n_lanes * n], movies[:n_lanes * n],
                                  ratings[:n_lanes * n],
                                  public_partitions=list(range(N_MOVIES)))
    pid = enc.pid[:n]
    lanes = [(enc.pk[l * n:(l + 1) * n], enc.values[l * n:(l + 1) * n],
              enc.valid[l * n:(l + 1) * n]) for l in range(n_lanes)]
    cfg, stds, sc, _ = spec_release_cfg(tdp, executor, N_MOVIES, "f",
                                        mesh.device)
    keys = lane_keys(n_lanes, 900)
    staged = [sharded.shard_rows_by_pid(pid, pk, values, valid, mesh.size)
              for pk, values, valid in lanes]
    shards = sharded.stage_lanes(mesh, staged, torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    batched = sharded.sharded_batched_release(mesh, shards, *sc, stds, keys,
                                              cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = dict(kernels.launch_counts)
    check_launches("mesh batched (f)", counts, kernels,
                   path=("row_keys_lanes", "bound_rows_lanes",
                         "reduce_partitions_lanes", "combine_parts",
                         "quantile_child_counts", "quantile_descend_lanes",
                         "compact_kept_lanes"))
    lanes_equal_solo(torch, "mesh batched (f)", batched,
                     lambda l: sharded.sharded_aggregate_arrays(
                         mesh, pid, *lanes[l][:2], lanes[l][2], *sc, stds,
                         keys[l], cfg, dtype=torch.float32), n_lanes)
    print(f"mesh batched (f) D={mesh.size}: {n_lanes} lanes of {n} rows, "
          f"PERCENTILE 10 / 50 / 90 + COUNT: every lane == its solo meshed "
          f"release; {int(batched[0].sum())} partitions kept; batched wall "
          f"{wall * 1e3:.1f} ms; launches "
          f"{dict((k, v) for k, v in counts.items() if v)} ({card})",
          flush=True)


# The meshed blocked route (K23a): pass 1 a shard (C1, C5, C2, C5, C10),
# each block's windows a shard (C3 windowed), C21, the block's release once
# (C4, C6); device staging adds the exchange.
MESH_BLOCKED_PATH = BLOCKED_KERNELS + ("combine_parts",)
MESH_BLOCKED_EXCHANGE = MESH_BLOCKED_PATH + ("reshard_count",
                                             "reshard_exchange")
MESH_BLOCKED_SPLIT = ("staging", "p1_bound_compact", "block_offsets",
                      "p2_dispatch", "p2_combine", "p2_sync_wait",
                      "p2_drain", "decode")


def mesh_blocked_parity(torch, tdp, rng, devices=("cuda", "cpu")):
    """Small meshed blocked releases in float64 on make_mesh([cuda:0] * D)
    against the same on make_mesh(["cpu"] * D) (the plain versions),
    D = 2 (reshard "host") and 4 ("device"), threshold 16, 8 partitions a
    block, P = 20: the same partitions, values within 1e-9 relative
    (secure noise: equal)."""
    from pipelinedp_tpu_torch.parallel.mesh import make_mesh
    n = 4096
    users = rng.integers(0, 300, n).tolist()
    parts = ((rng.integers(0, 20, n)**2) // 20).tolist()
    values = rng.integers(1, 6, n).astype(np.float64)
    scalar = list(zip(users, parts, values.tolist()))
    vector = list(zip(users, parts, [[v, 5.0 - v, 1.0] for v in values]))
    M = tdp.Metrics
    cases = {
        "count-sum-mean-variance, gaussian, public": (
            scalar, [M.COUNT, M.SUM, M.MEAN, M.VARIANCE], True, {},
            dict(noise_kind=tdp.NoiseKind.GAUSSIAN)),
        "count-sum-pid, laplace, private": (
            scalar, [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT], False, {}, {}),
        "percentile": (scalar, [M.PERCENTILE(50), M.COUNT], False, {}, {}),
        "vector_sum": (vector, [M.VECTOR_SUM, M.COUNT], False, {},
                       dict(vector_size=3, vector_max_norm=6.0,
                            vector_norm_kind=tdp.NormKind.L2,
                            min_value=None, max_value=None)),
        "secure": (scalar, [M.COUNT, M.SUM, M.MEAN], False,
                   dict(secure_noise=True), {}),
        "safe": (scalar, [M.COUNT, M.SUM], True, dict(numeric_mode="safe"),
                 {}),
        "select": (scalar, None, False, {}, {}),
    }
    ex = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                            partition_extractor=lambda r: r[1],
                            value_extractor=lambda r: r[2])
    for d, mode in ((2, "host"), (4, "device")):
        for label, (rows, metrics, public, backend, extra) in cases.items():
            results = []
            for device in devices:
                acc = tdp.NaiveBudgetAccountant(total_epsilon=4.0,
                                                total_delta=1e-6)
                engine = tdp.DPEngine(acc, tdp.TorchBackend(
                    device=device, noise_seed=5, dtype=torch.float64,
                    mesh=make_mesh([torch.device(device)] * d),
                    reshard=mode, large_partition_threshold=16,
                    block_partitions=8, **backend))
                if metrics is None:
                    res = engine.select_partitions(
                        rows, tdp.SelectPartitionsParams(
                            max_partitions_contributed=3), ex)
                else:
                    bounds = dict(max_partitions_contributed=3,
                                  max_contributions_per_partition=2,
                                  min_value=0.0, max_value=5.0)
                    bounds.update(extra)
                    res = engine.aggregate(
                        rows, tdp.AggregateParams(metrics=metrics, **bounds),
                        ex, list(range(20)) if public else None)
                acc.compute_budgets()
                results.append(list(res) if metrics is None else dict(res))
            gpu, cpu = results
            worst = 0.0
            if metrics is None:
                if gpu != cpu or not gpu or len(gpu) == 20:
                    raise AssertionError(f"mesh blocked parity select D={d}: "
                                         f"cuda kept {len(gpu)}, cpu "
                                         f"{len(cpu)}")
            else:
                if sorted(gpu) != sorted(cpu) or not gpu:
                    raise AssertionError(f"mesh blocked parity {label} D={d}"
                                         f": kept partitions differ")
                for k in cpu:
                    for a, b in zip(gpu[k], cpu[k]):
                        diff = np.abs(np.asarray(a) - np.asarray(b))
                        worst = max(worst, float(np.max(diff / np.maximum(
                            1.0, np.abs(np.asarray(b))))))
                limit = 0.0 if backend.get("secure_noise") else 1e-9
                if worst > limit:
                    raise AssertionError(f"mesh blocked parity {label} D={d}:"
                                         f" rel err {worst}")
            print(f"mesh blocked parity[{label}, D={d}, reshard={mode}, "
                  f"threshold 16, block 8, P=20]: {len(gpu)} partitions, "
                  f"cuda float64 vs cpu float64 max rel err {worst:.3g}",
                  flush=True)


def mesh_blocked_kernels(torch, tdp, mesh, qenc, kernels, large_p, card):
    """C21 at the blocked route's block shape (D shards, [2^20] x 2 float32
    columns, and int32 [2^20] for selection) and C10 on one shard's pass-1
    stream of (q), each == its plain version on the card, timed beside
    stack.sum(0) / torch.searchsorted. Returns their kernels entries."""
    from pipelinedp_tpu_torch.ops import threefry
    from pipelinedp_tpu_torch.parallel import reshard
    from pipelinedp_tpu_torch.parallel.mesh import on_device
    dev, d = mesh.device, mesh.size
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    m = 2 * LARGE_BLOCK
    stack = torch.randint(0, 9, (d, m), device=dev,
                          generator=gen).to(torch.float32) * 0.5
    istack = torch.randint(0, 1 << 20, (d, LARGE_BLOCK), device=dev,
                           generator=gen, dtype=torch.int32)
    report = []
    for label, st in (("block 2^20 x 2 float32", stack),
                      ("block 2^20 int32 (selection)", istack)):
        err = check_equal(f"combine_shards[{label}]",
                          kernels.combine_shards(st),
                          kernels.combine_shards_plain(st))
        ms = cuda_ms(lambda: kernels.combine_shards(st), 50)
        plain_ms = cuda_ms(lambda: kernels.combine_shards_plain(st), 10)
        lib_ms = cuda_ms(lambda: st.sum(0), 50)
        width = st.shape[1]
        b_ms, b_by = bound((d + 1) * width * 4, (d - 1) * width)
        print(f"kernel combine_shards[D={d}, {label}]: == plain; "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} "
              f"({b_by}) library_ms(stack.sum(0))={lib_ms:.4f} ({card})",
              flush=True)
        report.append(dict(
            name="combine_shards", shape=f"D={d}, {label}", route="cuda",
            source="pipelinedp_tpu_torch/csrc/combine_shards.cu",
            replaces="pipelinedp_tpu/parallel/large_p.py:743", launches=0,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms))
        print_three_way(f"C21 stack, D={d}, {label}", three_way(
            torch, {"combine_shards": lambda: kernels.combine_shards(st),
                    "stack.sum(0)": lambda: st.sum(0)}), card)
    # C10 on shard 0's pass-1 stream of (q), its 5 blocks' boundaries.
    cfg, _, scalars = release_spec(tdp, tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT], min_value=0.0, max_value=5.0,
        max_partitions_contributed=4, max_contributions_per_partition=8),
        qenc.n_partitions, 1.0, True)
    shards = reshard.stage_rows_to_mesh(
        mesh, torch.as_tensor(qenc.pid).to(dev),
        torch.as_tensor(qenc.pk).to(dev),
        torch.as_tensor(qenc.values).to(dev, torch.float32),
        torch.as_tensor(qenc.valid).to(dev), "device", torch.float32)
    P = qenc.n_partitions
    n_blocks = -(-P // LARGE_BLOCK)
    streams = []
    for s, rows in enumerate(shards):
        with on_device(mesh.devices[s]):
            streams.append(large_p._bound_compact(
                *rows, scalars, threefry.fold_in(np.array([0, 1], np.uint32),
                                                 s), cfg))
    stream = streams[0]
    bounds = kernels.block_window_boundaries(0, LARGE_BLOCK, n_blocks, P,
                                             stream.skey2.device)
    got = kernels.block_offsets(stream.skey2, bounds)
    err = check_equal("block_offsets[one shard of (q)]", got,
                      kernels.block_offsets_plain(stream.skey2, bounds))
    ms = cuda_ms(lambda: kernels.block_offsets(stream.skey2, bounds), 50)
    plain_ms = cuda_ms(lambda: kernels.block_offsets_plain(stream.skey2,
                                                           bounds), 20)
    lib_ms = cuda_ms(lambda: torch.searchsorted(stream.skey2, bounds), 50)
    n_rows = stream.skey2.shape[0]
    reads = (n_blocks + 1) * max(1, math.ceil(math.log2(max(n_rows, 2))))
    b_ms, b_by = bound((n_blocks + 1) * (4 + 8) + reads * 4, reads)
    print(f"kernel block_offsets[one shard of (q): {n_rows} rows, "
          f"{n_blocks + 1} boundaries, D={d}]: == plain; ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.3g} ({b_by}) "
          f"library_ms(torch.searchsorted)={lib_ms:.4f} ({card})",
          flush=True)
    print_three_way(f"C10, one shard of (q): {n_rows} rows x {n_blocks + 1} "
                    f"boundaries", three_way(torch, {
                        "block_offsets":
                            lambda: kernels.block_offsets(stream.skey2,
                                                          bounds),
                        "torch.searchsorted":
                            lambda: torch.searchsorted(stream.skey2,
                                                       bounds)}), card)
    report.append(dict(
        name="block_offsets", shape=f"one shard of (q), D={d}",
        route="cuda", source="pipelinedp_tpu_torch/csrc/block_offsets.cu",
        replaces="pipelinedp_tpu/parallel/large_p.py:696", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms))
    # The D shards' windows as the meshed drivers take them
    # (_sharded_block_offsets): one launch a distinct device.
    if len(set(mesh.devices)) == 1:
        window = ([t.skey2 for t in streams], 0, LARGE_BLOCK, n_blocks, P)
        got = same_twice("block_window_offsets[meshed (q)]", lambda: {
            "offsets": kernels.block_window_offsets(*window)})["offsets"]
        check_equal("block_window_offsets[meshed (q)]", got,
                    kernels.block_window_offsets_plain(*window))
        for s, t in enumerate(streams):
            check_equal(f"block_window_offsets[meshed (q)] shard {s} vs "
                        f"block_offsets", got[s], kernels.block_offsets(
                            t.skey2, bounds.to(t.skey2.device)))
        print_three_way(f"C10, {d} shards of (q) x {n_blocks + 1} "
                        f"boundaries", three_way(torch, {
                            "block_window_offsets, one launch":
                                lambda: kernels.block_window_offsets(*window),
                            f"torch.searchsorted x {d}": lambda: [
                                torch.searchsorted(t.skey2, bounds)
                                for t in streams]}), card)
    return report


def mesh_blocked_phase(torch, tdp, rng, qenc, netflix, nmax, kernels,
                       large_p, card, parity_devices=("cuda", "cpu"),
                       reps=3):
    """The blocked route over card_mesh(): parity card vs CPU
    (mesh_blocked_parity); (v) through the mesh with rows on the card
    (reshard "device") and host rows ("host") == the unmeshed (v), and,
    noise-free, its integer COUNT / SUM == the unmeshed blocked == the
    dense release == numpy; (q) and its blocked select through the mesh,
    both staging modes, median of `reps`, beside the unmeshed (q), with
    the phase_times split; C21 and C10 at the block shapes. Returns
    (kernels entries, launch counts summed over the DPEngine runs)."""
    import dataclasses
    from pipelinedp_tpu_torch import executor
    from pipelinedp_tpu_torch.parallel import reshard
    total = dict.fromkeys(kernels.KERNELS, 0)
    mesh = card_mesh(torch)
    dev, d = mesh.device, mesh.size
    cards = len(set(mesh.devices))  # C10's launches: one a distinct card
    mesh_blocked_parity(torch, tdp, rng, parity_devices)
    M = tdp.Metrics

    def on_card(enc):
        return dataclasses.replace(
            enc, pid=torch.as_tensor(enc.pid).to(dev),
            pk=torch.as_tensor(enc.pk).to(dev),
            values=torch.as_tensor(enc.values).to(dev, torch.float32))

    def run(label, backend, data, metrics, public, eps, bounds, path,
            want=None, select=False, probe=None, guard=False):
        acc = tdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
        engine = tdp.DPEngine(acc, backend)
        kernels.reset_launch_counts()
        if select:
            res = engine.select_partitions(data, tdp.SelectPartitionsParams(
                max_partitions_contributed=4), tdp.DataExtractors())
        else:
            res = engine.aggregate(
                data, tdp.AggregateParams(metrics=metrics,
                                          noise_kind=tdp.NoiseKind.LAPLACE,
                                          **bounds),
                tdp.DataExtractors(),
                list(data.partition_vocab) if public else None)
        acc.compute_budgets()
        torch.cuda.synchronize()
        with PhaseProbe(large_p, probe or "aggregate_blocked_sharded") as \
                prober, (reshard.forbid_row_fetches() if guard else
                         contextlib.nullcontext()):
            start = time.perf_counter()
            out = list(res) if select else dict(res)
            torch.cuda.synchronize()
            end = time.perf_counter()
        records = prober.records
        counts = dict(kernels.launch_counts)
        check_launches(f"mesh blocked ({label})", counts, kernels, want,
                       path)
        if path != BASE_KERNELS and (counts["reduce_partitions"] or counts[
                "reduce_partitions_compensated"]):
            raise AssertionError(f"mesh blocked ({label}) ran the dense C3 "
                                 f"entry")
        for name, c in counts.items():
            total[name] += c
        if not out or (not select and not all(
                np.all(np.isfinite(np.hstack([np.ravel(x) for x in v])))
                for v in out.values())):
            raise AssertionError(f"mesh blocked ({label}): {len(out)} "
                                 f"partitions or a non-finite value")
        pt = dict(records[-1]) if records else {}
        if pt:
            pt["decode"] = end - pt.pop("returned_at")
        return out, end - start, pt

    # (v) = (c) on the blocked route through the mesh.
    nP = netflix.n_partitions
    v_bounds = dict(max_partitions_contributed=nmax[0],
                    max_contributions_per_partition=nmax[1], min_value=1.0,
                    max_value=5.0)
    v_backend = dict(large_partition_threshold=4096, block_partitions=4096)
    v_blocks = -(-nP // 4096)
    v_metrics = [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT]
    net_card = on_card(netflix)
    solo_v, _, _ = run("v, unmeshed", tdp.TorchBackend(noise_seed=9,
                                                       **v_backend),
                       netflix, v_metrics, True, 1e6, v_bounds,
                       BLOCKED_KERNELS, probe="aggregate_blocked")
    dense_c, _, _ = run("c, dense", tdp.TorchBackend(noise_seed=9), netflix,
                        v_metrics, True, 1e6, v_bounds, BASE_KERNELS,
                        probe="aggregate_blocked")
    if set(solo_v) != set(dense_c) or len(solo_v) != nP:
        raise AssertionError("mesh blocked (v): the unmeshed (v) and the "
                             "dense (c) release other partitions")
    for mode, data, path in (("device", net_card, MESH_BLOCKED_EXCHANGE),
                             ("host", netflix, MESH_BLOCKED_PATH)):
        out, seconds, pt = run(
            f"v, {mode}", tdp.TorchBackend(noise_seed=9, mesh=mesh,
                                           reshard=mode, **v_backend),
            data, v_metrics, True, 1e6, v_bounds, path,
            dict(combine_parts=v_blocks, block_window_offsets=cards))
        if out != solo_v:
            bad = [m for m in solo_v if out[m] != solo_v[m]]
            raise AssertionError(f"mesh blocked (v, {mode}): {len(bad)} "
                                 f"partitions differ from the unmeshed (v), "
                                 f"first {bad[:1]}")
        print(f"mesh blocked (v) reshard={mode} D={d}, {v_blocks} blocks of "
              f"4096: {len(out)} partitions == the unmeshed blocked (v) "
              f"(every value), the dense (c)'s partitions, in "
              f"{seconds * 1e3:.1f} ms ({card}); phase_times (s) "
              f"{json.dumps({k: round(v, 4) for k, v in pt.items()})}",
              flush=True)
    # Noise-free (stds 0): the integer COUNT / SUM of the meshed blocked
    # release == the unmeshed blocked == the dense release == numpy.
    params_v = tdp.AggregateParams(metrics=[M.COUNT, M.SUM],
                                   noise_kind=tdp.NoiseKind.LAPLACE,
                                   **v_bounds)
    cfg_v, stds_v, scalars_v = release_spec(tdp, params_v, nP, 1e6, False)
    zeros = np.zeros_like(stds_v)
    key = np.array([0, 9], np.uint32)
    rows_card = (net_card.pid, net_card.pk, net_card.values,
                 torch.as_tensor(netflix.valid).to(dev))
    exact = {"count": np.bincount(netflix.pk, minlength=nP),
             "sum": np.bincount(netflix.pk, weights=netflix.values,
                                minlength=nP)}
    kept_m, out_m = large_p.aggregate_blocked_sharded(
        mesh, *rows_card, *scalars_v, zeros, key, cfg_v,
        block_partitions=4096, reshard="device", dtype=torch.float32)
    kept_s, out_s = large_p.aggregate_blocked(
        *rows_card, *scalars_v, zeros, key, cfg_v, block_partitions=4096,
        device=dev, dtype=torch.float32)
    n_kept, order, out_d, _ = executor.aggregate_release_kernel(
        *executor.padded_to_device(*executor.pad_rows(netflix), dev,
                                   torch.float32),
        *scalars_v, zeros, key, cfg_v)
    k = int(n_kept)
    dense_ids = order[:k].cpu().numpy()
    for name, truth in exact.items():
        for label, ids, got in (
                ("meshed blocked", kept_m, out_m[name]),
                ("unmeshed blocked", kept_s, out_s[name]),
                ("dense", dense_ids, out_d[name][:k].cpu().numpy())):
            if not np.array_equal(ids, np.arange(nP)) or \
                    not np.array_equal(np.asarray(got, np.float64), truth):
                raise AssertionError(f"mesh blocked (v) noise-free: the "
                                     f"{label} {name} is not the numpy "
                                     f"group-by")
    print(f"mesh blocked (v) noise-free, D={d}: COUNT and SUM of all {nP} "
          f"partitions == the unmeshed blocked == the dense release == "
          f"numpy (integers)", flush=True)

    # (q) through the mesh, beside the unmeshed (q).
    P = qenc.n_partitions
    n_blocks = -(-P // LARGE_BLOCK)
    q_card = on_card(qenc)
    priv = dict(max_partitions_contributed=4,
                max_contributions_per_partition=8, min_value=0.0,
                max_value=5.0)
    runs = (("unmeshed", {}, qenc, BLOCKED_KERNELS, "aggregate_blocked",
             False),
            ("device", dict(mesh=mesh, reshard="device"), q_card,
             MESH_BLOCKED_EXCHANGE, None, True),
            ("host", dict(mesh=mesh, reshard="host"), qenc,
             MESH_BLOCKED_PATH, None, False))
    for mode, backend, data, path, probe, guard in runs:
        times, splits, kept = [], [], []
        for rep in range(reps):
            out, seconds, pt = run(
                f"q, {mode}", tdp.TorchBackend(noise_seed=rep, **backend),
                data, [M.COUNT, M.SUM], False, 1.0, priv, path,
                None if mode == "unmeshed" else
                dict(block_window_offsets=cards),
                probe=probe, guard=guard)
            if pt["blocks_dispatched"] != n_blocks:
                raise AssertionError(f"mesh blocked (q, {mode}): "
                                     f"{pt['blocks_dispatched']} blocks")
            times.append(seconds)
            splits.append(pt)
            kept.append(len(out))
        med = int(np.argsort(times)[len(times) // 2])
        split = {k: round(splits[med].get(k, 0.0) * 1e3, 3)
                 for k in MESH_BLOCKED_SPLIT}
        print(f"mesh blocked (q) {mode}{'' if mode == 'unmeshed' else f' D={d}'}"
              f": P={P}, {n_blocks} blocks, kept {kept}, wall "
              f"{statistics.median(times) * 1e3:.1f} ms (median of {reps}: "
              f"{[round(t * 1e3, 1) for t in times]} ms; "
              f"{qenc.n_rows / statistics.median(times):.4g} rows/s; "
              f"{card}); split of the median run, ms {json.dumps(split)}"
              f"{'; under forbid_row_fetches' if guard else ''}",
              flush=True)
    for mode, data, path in (("device", q_card, MESH_BLOCKED_EXCHANGE),
                             ("host", qenc, MESH_BLOCKED_PATH)):
        times, kept = [], []
        for rep in range(reps if mode == "device" else 1):
            out, seconds, _ = run(
                f"select q, {mode}", tdp.TorchBackend(
                    noise_seed=rep, mesh=mesh, reshard=mode), data, None,
                False, 1.0, None, path, dict(block_window_offsets=cards),
                select=True)
            if len(out) >= P or len(set(out)) != len(out):
                raise AssertionError(f"mesh blocked select (q, {mode}): "
                                     f"{len(out)} kept")
            times.append(seconds)
            kept.append(len(out))
        print(f"mesh blocked select (q) reshard={mode} D={d}: kept {kept} of "
              f"{P}, {statistics.median(times) * 1e3:.1f} ms "
              f"({[round(t * 1e3, 1) for t in times]} ms; {card})",
              flush=True)
    report = mesh_blocked_kernels(torch, tdp, mesh, qenc, kernels, large_p,
                                  card)
    return report, total


# ---------------------------------------------------------------------------
# The single-process mesh ingest (K23b, C24) and the unfused release.

MESH_FACTORIZE = ("mesh_local_uniques", "mesh_merge_ranks", "mesh_remap_rows")
MESH_FACTORIZE_REPLACES = {
    "mesh_local_uniques": "pipelinedp_tpu/device_encode.py:302",
    "mesh_merge_ranks": "pipelinedp_tpu/device_encode.py:322",
    "mesh_remap_rows": "pipelinedp_tpu/device_encode.py:322"}
# The local phase and the merge are C12 runs (the local one with its heads
# table); the remap is C24's own kernel.
MESH_FACTORIZE_SOURCES = {"mesh_local_uniques": "factorize_codes.cu",
                          "mesh_merge_ranks": "factorize_codes.cu",
                          "mesh_remap_rows": "mesh_factorize.cu"}
# (data, metrics, noise, public partitions, bounds) of the mesh-ingest runs.
PER_MOVIE_RATING = dict(max_partitions_contributed=64,
                        max_contributions_per_partition=1, min_value=1.0,
                        max_value=5.0)
MESH_INGEST_RUNS = {
    "a": ("netflix", ("COUNT", "SUM", "MEAN", "VARIANCE"), "GAUSSIAN", True,
          PER_MOVIE_RATING),
    "b": ("netflix", ("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE", False,
          PER_MOVIE_RATING),
    "q": ("q", ("COUNT", "SUM"), "LAPLACE", False,
          dict(max_partitions_contributed=4,
               max_contributions_per_partition=8, min_value=0.0,
               max_value=5.0)),
}
INGEST_MODES = ("host", "hash_device")


class plain_mesh_factorize:
    """Scope in which the mesh factorize takes C24's plain versions (torch
    on the card): the twin the kernels are held against."""

    def __init__(self, kernels):
        self.kernels = kernels

    def __enter__(self):
        k = self.kernels
        self.saved = {name: getattr(k, name) for name in MESH_FACTORIZE}
        for name in MESH_FACTORIZE:
            setattr(k, name, getattr(k, name + "_plain"))

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.kernels, name, fn)


def sharded_hash_rows(mesh, rows):
    """(n, 3) hash rows on the card split evenly over the mesh's slots."""
    from pipelinedp_tpu_torch.parallel.mesh import ShardedColumn
    local = rows.shape[0] // mesh.size
    return ShardedColumn([rows[s * local:(s + 1) * local].to(dev)
                          for s, dev in enumerate(mesh.devices)], mesh)


def mesh_ingest_kernel_phase(torch, dev, key_sets, kernels, device_encode,
                             ingest, card):
    """C24 at full width on card_mesh(): the hash rows of the Netflix users
    (480,189 distinct), movies (17,770) and (q)'s partitions (~4.7M), 2^24
    rows split over 4 shard slots, with the distinct count as the hint (as
    the pod ingest passes it). mesh_factorize_codes == its run on the
    plain versions == its run without the hint == C12's codes == the host
    encoder's, and launches no C5 sort; each step == its plain version on
    the factorize's own inputs (shard 0's local run, the gathered
    [4 x uniq_cap] slots for the merge, shard 0's window for the remap),
    timed there, torch.unique(return_inverse) of shard 0's hashes beside
    (not the same function: sorted-order codes). Returns the report rows
    of the user hashes."""
    from pipelinedp_tpu_torch.parallel.mesh import round_capacity
    mesh = card_mesh(torch)
    d = mesh.size
    report = []
    for label, (raw, host_codes) in key_sets.items():
        h1, _ = ingest.hash_key_column_pair(raw)
        rows = torch.from_numpy(
            device_encode.pack_hash_rows(h1).view(np.int32)).to(dev)
        n = rows.shape[0]
        local = n // d
        hint = int(host_codes.max()) + 1
        hashes = sharded_hash_rows(mesh, rows)
        kernels.reset_launch_counts()
        codes, n_unique = device_encode.mesh_factorize_codes(
            mesh, hashes, n_distinct=hint)
        counts = dict(kernels.launch_counts)
        want = dict(mesh_local_uniques=d, mesh_merge_ranks=1,
                    mesh_remap_rows=d, radix_sort=0, factorize_codes=0)
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"mesh_factorize_codes ({label}): launches "
                                 f"{ {k: counts[k] for k in want} }, "
                                 f"expected {want}")
        got = codes.global_rows(dev)
        c12, n12 = kernels.factorize_codes(rows)
        err = check_equal(f"mesh_factorize_codes ({label}) vs C12", got, c12)
        check_equal(f"mesh_factorize_codes ({label}) vs the host encoder",
                    got, torch.from_numpy(host_codes).to(dev))
        with plain_mesh_factorize(kernels):
            plain_codes, plain_n = device_encode.mesh_factorize_codes(
                mesh, hashes, n_distinct=hint)
        check_equal(f"mesh_factorize_codes ({label}) vs its plain versions",
                    got, plain_codes.global_rows(dev))
        no_hint, no_hint_n = device_encode.mesh_factorize_codes(mesh, hashes)
        check_equal(f"mesh_factorize_codes ({label}) without the hint", got,
                    no_hint.global_rows(dev))
        if not n_unique == plain_n == int(n12) == no_hint_n == hint:
            raise AssertionError(f"mesh_factorize_codes ({label}): "
                                 f"{n_unique} / {plain_n} / {no_hint_n} "
                                 f"distinct, C12 {int(n12)}, hint {hint}")
        runs = [kernels.mesh_local_uniques(sh, hint) for sh in hashes.shards]
        cap = round_capacity(max(int(r[1]) for r in runs))
        s0 = hashes.shards[0]
        local_plain = kernels.mesh_local_uniques_plain(s0, hint)
        errs = {"mesh_local_uniques": max(
            check_equal(f"mesh_local_uniques ({label}) {part}", g, w)
            for part, g, w in zip(("lcode", "n_new", "heads"), runs[0],
                                  local_plain))}
        gathered = torch.cat([r[2][:cap] for r in runs])
        merged = kernels.mesh_merge_ranks(gathered, hint)
        merged_plain = kernels.mesh_merge_ranks_plain(gathered)
        errs["mesh_merge_ranks"] = max(
            check_equal(f"mesh_merge_ranks ({label}) {part}", g, w)
            for part, g, w in zip(("remap", "n_unique"), merged,
                                  merged_plain))
        lcode, window = runs[0][0], merged[0][:cap]
        remapped = kernels.mesh_remap_rows(lcode, window)
        errs["mesh_remap_rows"] = check_equal(
            f"mesh_remap_rows ({label})", remapped,
            kernels.mesh_remap_rows_plain(lcode, window))
        check_equal(f"mesh_remap_rows ({label}) vs the factorize's shard 0",
                    remapped, codes.shards[0])
        m = gathered.shape[0]
        entries = {
            # The shard's rows read once (12 B), its local codes and heads
            # table written once; a probe a row.
            "mesh_local_uniques": (
                lambda: kernels.mesh_local_uniques(s0, hint),
                lambda: kernels.mesh_local_uniques_plain(s0, hint),
                bound(local * 16 + runs[0][2].shape[0] * 12, local)),
            # The gathered slots read once, their codes written once.
            "mesh_merge_ranks": (
                lambda: kernels.mesh_merge_ranks(gathered, hint),
                lambda: kernels.mesh_merge_ranks_plain(gathered),
                bound(m * 16 + 4, m)),
            # A local code read and a code written a row, the window read.
            "mesh_remap_rows": (
                lambda: kernels.mesh_remap_rows(lcode, window),
                lambda: kernels.mesh_remap_rows_plain(lcode, window),
                bound(local * 8 + cap * 4, local)),
        }
        ms = {name: (cuda_ms(fn, repeats=10),
                     cuda_ms(plain, repeats=3, warmup=1))
              for name, (fn, plain, _) in entries.items()}
        key64 = kernels.joined_hash_order(s0[:, 0], s0[:, 1])
        unique_ms = cuda_ms(lambda: torch.unique(key64, return_inverse=True),
                            repeats=10)
        whole_ms = cuda_ms(lambda: device_encode.mesh_factorize_codes(
            mesh, hashes, n_distinct=hint), repeats=3, warmup=1)
        print(f"kernels[mesh ingest, {label}: {n} rows over {d} slots, "
              f"{n_unique} distinct (the hint), uniq_cap {cap}]: " +
              "; ".join(
                  f"C24 {name} ms={ms[name][0]:.4f} plain_ms="
                  f"{ms[name][1]:.4f} bound_ms={entries[name][2][0]:.3g} "
                  f"({entries[name][2][1]})" for name in MESH_FACTORIZE) +
              f"; torch.unique(return_inverse) of shard 0 {unique_ms:.4f} ms"
              f" (not the same function); mesh_factorize_codes whole "
              f"{whole_ms:.4f} ms (its two fetches; no C5 sort); every "
              f"entry == its plain version, the codes == C12's == the host "
              f"encoder's, with the hint and without ({card})", flush=True)
        if label == "users":
            for name in MESH_FACTORIZE:
                report.append({
                    "name": name, "route": "cuda",
                    "source": "pipelinedp_tpu_torch/csrc/" +
                              MESH_FACTORIZE_SOURCES[name],
                    "replaces": MESH_FACTORIZE_REPLACES[name],
                    "launches": 0, "max_abs_err": max(errs[name], err),
                    "ms": ms[name][0], "plain_ms": ms[name][1],
                    "bound_ms": entries[name][2][0],
                    "bound_by": entries[name][2][1], "library_ms": None})
        del rows, hashes, codes, got, c12, plain_codes, no_hint, runs
        del gathered, merged, merged_plain, key64
    return report


class IngestSplit:
    """Host seconds of the pod ingest's stages: the host encode or hash,
    the byte exchange, the host merges, the upload to the mesh and the
    mesh factorize (the last two end with a device synchronisation)."""

    STAGES = {"encode": ("ingest", ("encode_shard", "_hash_encode_shard")),
              "exchange": ("ingest", ("_exchanged_metas",)),
              "merge": ("ingest", ("merge_shard_metas",)),
              "merge_hash": ("device_encode", ("merge_hash_uniques",)),
              "upload": ("ingest", ("_to_mesh",)),
              "mesh_factorize": ("device_encode",
                                 ("mesh_factorize_codes",))}

    def __init__(self, torch, ingest, device_encode):
        self.torch = torch
        self.modules = {"ingest": ingest, "device_encode": device_encode}
        self.ms = {}

    def __enter__(self):
        self.saved = []
        for stage, (mod_name, names) in self.STAGES.items():
            mod = self.modules[mod_name]
            for name in names:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, self.timed(
                    "merge" if stage == "merge_hash" else stage, fn,
                    stage in ("upload", "mesh_factorize")))
        return self

    def timed(self, stage, fn, sync):
        def call(*args, **kwargs):
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                self.torch.cuda.synchronize()
            self.ms[stage] = self.ms.get(stage, 0.0) + (
                time.perf_counter() - start) * 1e3
            return out
        return call

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)


def mesh_ingest_release(torch, tdp, kernels, mesh, data, spec, seed,
                        eps=1.0, backend=None):
    """One aggregate over `data` (the pod ingest's EncodedData or a
    ChunkSource) on TorchBackend(mesh=), spec = (metrics, noise, public
    partitions or None, bounds): (the release, wall seconds, launch counts
    since the last reset)."""
    metrics, noise, public, bounds = spec
    acc = tdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=seed, mesh=mesh,
                                                **(backend or {})))
    res = engine.aggregate(
        data, tdp.AggregateParams(
            metrics=[getattr(tdp.Metrics, m) for m in metrics],
            noise_kind=getattr(tdp.NoiseKind, noise), **bounds),
        tdp.DataExtractors(), public)
    acc.compute_budgets()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = dict(res)
    torch.cuda.synchronize()
    return out, time.perf_counter() - start, dict(kernels.launch_counts)


def check_ingested(label, torch, enc, encoded, full_vocab):
    """The pod ingest's valid rows carry the host encoder's codes and
    values, its vocabulary and privacy-id count are the encoder's."""
    pk = enc.pk.global_rows("cpu").numpy()
    valid = pk >= 0
    if int(valid.sum()) != encoded.n_rows:
        raise AssertionError(f"mesh ingest ({label}): {int(valid.sum())} "
                             f"valid rows, {encoded.n_rows} encoded")
    for name, want in (("pid", encoded.pid), ("pk", encoded.pk)):
        got = getattr(enc, name).global_rows("cpu").numpy()[valid]
        if not np.array_equal(got, want):
            raise AssertionError(f"mesh ingest ({label}): {name} codes "
                                 f"differ from the host encoder's")
    values = enc.values.global_rows("cpu").numpy()[valid]
    if not np.array_equal(values, encoded.values.astype(np.float32)):
        raise AssertionError(f"mesh ingest ({label}): values differ")
    vocab = enc.partition_vocab
    if len(vocab) != encoded.n_partitions or \
            enc.n_privacy_ids != encoded.n_privacy_ids:
        raise AssertionError(f"mesh ingest ({label}): {len(vocab)} "
                             f"partitions, {enc.n_privacy_ids} ids")
    want_vocab = list(encoded.partition_vocab)
    probe = (range(len(want_vocab)) if full_vocab else
             np.random.default_rng(0).choice(len(want_vocab), 4096,
                                             replace=False))
    if hasattr(vocab, "prefetch"):
        vocab.prefetch(probe)
    if any(vocab[int(i)] != want_vocab[int(i)] for i in probe):
        raise AssertionError(f"mesh ingest ({label}): the vocabulary "
                             f"differs from the host encoder's")


def mesh_ingest_main_phase(torch, tdp, data, nmax, kernels, ingest,
                           device_encode, card):
    """The pod ingest in one process onto card_mesh(): for (a), (b) and
    (q), encode_local_shard_to_mesh of their raw columns (16 chunks of
    2^20 rows) in both encode modes, each ingest's valid rows == the host
    encoder's codes, its wall split by IngestSplit, then DPEngine.aggregate
    on TorchBackend(mesh=) over it: the host and hash_device releases ==
    (the same global rows); beside each, the same run through a
    ChunkSource onto the same mesh (wall only: another row layout, other
    noise; (b)'s ingest being (a)'s, (a) and (q) only). (c) over (a)'s
    host ingest: within 16 noise stds of the numpy group-by. A simulated
    two-process exchange over the first 2^22 rows: process 0's ingest of
    the first half == the one-process ingest's first half, with its
    vocabulary and id count. Returns the launch counts summed over the
    runs."""
    import pickle
    total = dict.fromkeys(kernels.KERNELS, 0)
    mesh = card_mesh(torch)
    d = mesh.size
    shard_paths = {"netflix": EXCHANGE_PATH, "q": MESH_BLOCKED_EXCHANGE}
    kept = {}
    for run, (which, metrics, noise, public, bounds) in \
            MESH_INGEST_RUNS.items():
        raw, encoded = data[which]
        chunks = stream_chunks(*raw)
        vocab = list(encoded.partition_vocab) if public else None
        spec = (metrics, noise, vocab, bounds)
        n_factorize = 1 if public else 2
        releases = {}
        for mode in INGEST_MODES:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            with IngestSplit(torch, ingest, device_encode) as split:
                start = time.perf_counter()
                enc = ingest.encode_local_shard_to_mesh(
                    chunks, mesh, public_partitions=vocab, encode_mode=mode)
                torch.cuda.synchronize()
                ingest_s = time.perf_counter() - start
            ingest_counts = dict(kernels.launch_counts)
            check_ingested(f"{run}, {mode}", torch, enc, encoded,
                           which == "netflix")
            out, seconds, counts = mesh_ingest_release(
                torch, tdp, kernels, mesh, enc, spec, 0)
            path = shard_paths[which] + (
                MESH_FACTORIZE if mode == "hash_device" else ())
            # A factorize: one local run a shard, one merge, a remap a
            # shard, and no C5 sort in the ingest.
            want = dict(mesh_local_uniques=d * n_factorize,
                        mesh_merge_ranks=n_factorize,
                        mesh_remap_rows=d * n_factorize) \
                if mode == "hash_device" else dict(mesh_local_uniques=0)
            if ingest_counts["radix_sort"]:
                raise AssertionError(f"mesh ingest ({run}, {mode}): "
                                     f"{ingest_counts['radix_sort']} C5 "
                                     f"sorts in the ingest")
            check_launches(f"mesh ingest ({run}, {mode})", counts, kernels,
                           want, path)
            for name, c in counts.items():
                total[name] += c
            if not out or not all(math.isfinite(x) for v in out.values()
                                  for x in v):
                raise AssertionError(f"mesh ingest ({run}, {mode}): "
                                     f"{len(out)} partitions or a "
                                     f"non-finite value")
            releases[mode] = out
            if run == "a" and mode == "host":
                kept["a"] = enc
            del enc
            beside = ""
            if run != "b":  # (b)'s ingest is (a)'s
                stream_out, stream_s, _ = mesh_ingest_release(
                    torch, tdp, kernels, mesh,
                    tdp.ChunkSource(chunks, encode_mode=mode), spec, 0,
                    backend=dict(encode_threads=INGEST_THREADS))
                beside = (f"; the same run through a ChunkSource "
                          f"(encode_threads {INGEST_THREADS}) onto the "
                          f"mesh: {len(stream_out)} partitions, "
                          f"{stream_s * 1e3:.1f} ms")
            split_ms = {k: round(v, 1) for k, v in split.ms.items()}
            print(f"mesh ingest ({run}) encode_mode={mode} D={d}: "
                  f"{len(out)} partitions; ingest {ingest_s * 1e3:.1f} ms "
                  f"(split, ms {json.dumps(split_ms)}), release "
                  f"{seconds * 1e3:.1f} ms, wall "
                  f"{(ingest_s + seconds) * 1e3:.1f} ms{beside} ({card}); "
                  f"launches { {k: v for k, v in counts.items() if v} }",
                  flush=True)
        if releases["host"] != releases["hash_device"]:
            diff = [k for k in releases["host"]
                    if releases["hash_device"].get(k) != releases["host"][k]]
            raise AssertionError(f"mesh ingest ({run}): the host and "
                                 f"hash_device releases differ at "
                                 f"{len(diff)} partitions")
        print(f"mesh ingest ({run}): the host and hash_device ingests "
              f"release == results ({len(releases['host'])} partitions)",
              flush=True)

    # (c) over (a)'s host ingest: epsilon 1e6 at the data's true maxima.
    raw, encoded = data["netflix"]
    l0_true, linf_true = nmax[0], nmax[1]
    P = encoded.n_partitions
    vocab = list(encoded.partition_vocab)
    kernels.reset_launch_counts()
    out, seconds, counts = mesh_ingest_release(
        torch, tdp, kernels, mesh, kept.pop("a"),
        (("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE", vocab,
         dict(max_partitions_contributed=l0_true,
              max_contributions_per_partition=linf_true, min_value=1.0,
              max_value=5.0)), 9, eps=1e6)
    for name, n in counts.items():
        total[name] += n
    pairs = nmax[2]
    truths = {"count": np.bincount(encoded.pk, minlength=P),
              "sum": np.bincount(encoded.pk, weights=encoded.values,
                                 minlength=P),
              "privacy_id_count": np.bincount(pairs % P, minlength=P)}
    eps_each = 1e6 / 3
    std = {"count": math.sqrt(2) * l0_true * linf_true / eps_each,
           "sum": math.sqrt(2) * l0_true * linf_true * 5.0 / eps_each,
           "privacy_id_count": math.sqrt(2) * l0_true / eps_each}
    worst = {}
    for name, truth in truths.items():
        got = np.array([getattr(out[m], name) if m in out else np.nan
                        for m in vocab])
        err = np.abs(got - truth)
        tol = 16 * std[name] + 1e-6 * np.abs(truth)
        if not (err <= tol).all():
            raise AssertionError(f"mesh ingest (c) {name}: not within 16 "
                                 f"noise stds of the numpy group-by")
        worst[name] = float((err / np.maximum(1.0, truth)).max())
    print(f"mesh ingest (c) epsilon=1e6 over (a)'s ingest, l0={l0_true}, "
          f"linf={linf_true}: all {P} partitions within 16 noise stds of "
          f"the numpy group-by (max rel err {json.dumps(worst)}) in "
          f"{seconds * 1e3:.1f} ms", flush=True)

    # A simulated two-process exchange == the one-process ingest, on the
    # first 2^22 rows.
    chunks = stream_chunks(*raw)[:4]
    half = len(chunks) // 2
    n_half = sum(len(c[0]) for c in chunks[:half])
    for mode in INGEST_MODES:
        whole = ingest.encode_local_shard_to_mesh(chunks, mesh,
                                                  encode_mode=mode)
        payloads = []
        for part in (chunks[:half], chunks[half:]):
            if mode == "host":
                shard = ingest.encode_shard(part)
                meta = ingest._ShardMeta(len(shard.pid), shard.pid_vocab,
                                         shard.pk_vocab)
            else:
                meta = ingest._hash_encode_shard(part, None, "error",
                                                 np.float32).meta
            payloads.append(pickle.dumps(meta))
        kernels.reset_launch_counts()
        enc0 = ingest.encode_local_shard_to_mesh(
            chunks[:half], mesh, encode_mode=mode,
            exchange=lambda payload: list(payloads))
        for name, n in kernels.launch_counts.items():
            total[name] += n
        codes = {}
        for label, enc in (("one process", whole), ("process 0", enc0)):
            pk = enc.pk.global_rows("cpu").numpy()
            valid = pk >= 0
            codes[label] = (pk[valid][:n_half], enc.pid.global_rows(
                "cpu").numpy()[valid][:n_half], int(valid.sum()))
        if codes["process 0"][2] != n_half or any(
                not np.array_equal(a, b) for a, b in zip(
                    codes["process 0"][:2], codes["one process"][:2])):
            raise AssertionError(f"mesh ingest, simulated two processes "
                                 f"({mode}): process 0's codes differ from "
                                 f"the one-process ingest's first half")
        if enc0.n_privacy_ids != whole.n_privacy_ids or \
                list(enc0.partition_vocab) != list(whole.partition_vocab):
            raise AssertionError(f"mesh ingest, simulated two processes "
                                 f"({mode}): not the global vocabulary")
        print(f"mesh ingest, simulated two-process exchange ({mode}), "
              f"{n_half} rows a process: process 0's rows carry the "
              f"one-process ingest's codes, its vocabulary "
              f"({len(whole.partition_vocab)} partitions) and id count "
              f"({whole.n_privacy_ids})", flush=True)
        del enc0, whole
    return total


UNFUSED_PATH = tuple(k for k in BASE_KERNELS if k != "compact_kept")


def unfused_phase(torch, tdp, encoded, kernels, card, reps=3):
    """(a), (b) and a selection on TorchBackend(fused_release=False) against
    the fused release, alternating, `reps` seeds: the same release (==)
    and the same launches but C6's (none). Returns the launch counts of
    the unfused runs."""
    total = dict.fromkeys(kernels.KERNELS, 0)
    vocab = list(encoded.partition_vocab)

    def run(label, fused, seed):
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=seed,
                                                    fused_release=fused))
        kernels.reset_launch_counts()
        if label == "select":
            res = engine.select_partitions(encoded, tdp.SelectPartitionsParams(
                max_partitions_contributed=64), tdp.DataExtractors())
        else:
            _, metrics, noise, public, bounds = MESH_INGEST_RUNS[label]
            res = engine.aggregate(encoded, tdp.AggregateParams(
                metrics=[getattr(tdp.Metrics, m) for m in metrics],
                noise_kind=getattr(tdp.NoiseKind, noise), **bounds),
                tdp.DataExtractors(), vocab if public else None)
        acc.compute_budgets()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = list(res) if label == "select" else dict(res)
        torch.cuda.synchronize()
        return out, time.perf_counter() - start, dict(kernels.launch_counts)

    for label in ("a", "b", "select"):
        walls = {True: [], False: []}
        for seed in range(reps):
            fused_out, fused_s, fused_counts = run(label, True, seed)
            out, seconds, counts = run(label, False, seed)
            walls[True].append(fused_s)
            walls[False].append(seconds)
            if out != fused_out or not out:
                raise AssertionError(f"unfused ({label}) seed {seed}: "
                                     f"{len(out)} partitions, fused "
                                     f"{len(fused_out)}; not ==")
            # Every launch of the fused release but C6's.
            check_launches(f"fused ({label})", fused_counts, kernels,
                           dict(compact_kept=1))
            check_launches(f"unfused ({label})", counts, kernels,
                           dict(fused_counts, compact_kept=0),
                           UNFUSED_PATH)
            for name, c in counts.items():
                total[name] += c
        print(f"unfused ({label}) fused_release=False: {len(out)} "
              f"partitions == the fused release's for seeds 0-{reps - 1}, "
              f"one launch fewer (no compact_kept); wall "
              f"{statistics.median(walls[False]) * 1e3:.1f} ms against "
              f"fused {statistics.median(walls[True]) * 1e3:.1f} ms "
              f"(medians of {reps}: "
              f"{[round(t * 1e3, 1) for t in walls[False]]} / "
              f"{[round(t * 1e3, 1) for t in walls[True]]} ms; {card})",
              flush=True)
    return total



# ---------------------------------------------------------------------------
# Failure semantics and elastic meshes (runtime/retry.py, faults.py,
# entry.py) with K23c, parallel/mesh.collective_heartbeat on C21's int32
# entry.

HEARTBEAT_REPLACES = "pipelinedp_tpu/parallel/mesh.py:150"
# (q) with integer values (floor of U[0, 5)): every partial sum is exact, so
# a run on any mesh geometry releases bit for bit what the fixed one does.
ELASTIC_RUNS = ("a", "q", "select q")


def remote_slots(torch, mesh):
    """The mesh's slots with the upper half naming process 1: the
    heartbeat's route (probe_live_devices learns another process's slots
    through collective_heartbeat)."""
    from pipelinedp_tpu_torch.parallel.mesh import Slot
    half = (mesh.size + 1) // 2
    return [Slot(s.id, s.device, 0 if i < half else 1)
            for i, s in enumerate(mesh.slots)]


def heartbeat_kernel_phase(torch, kernels, card):
    """K23c on card_mesh(): kernels.heartbeat_sum (C21's int32 entry over
    the [D, 1] stack of ones) == its plain version on the card, its time
    beside stack.sum(0), and the whole collective_heartbeat (D one-element
    tensors, the gather, the launch, one scalar fetch) on the host clock.
    Returns its kernels entry."""
    from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
    mesh = card_mesh(torch)
    d, dev = mesh.size, mesh.device
    stack = torch.ones(d, 1, dtype=torch.int32, device=dev)
    got = kernels.heartbeat_sum(stack)
    err = check_equal("heartbeat_sum", got,
                      kernels.combine_shards_plain(stack))
    if int(got[0]) != d:
        raise AssertionError(f"heartbeat_sum: {int(got[0])}, expected {d}")
    ms = cuda_ms(lambda: kernels.heartbeat_sum(stack), 50)
    plain_ms = cuda_ms(lambda: kernels.combine_shards_plain(stack), 20)
    lib_ms = cuda_ms(lambda: stack.sum(0), 50)
    b_ms, b_by = bound((d + 1) * 4, d - 1)
    walls = []
    for _ in range(20):
        start = time.perf_counter()
        live = mesh_lib.collective_heartbeat(list(mesh.slots))
        walls.append((time.perf_counter() - start) * 1e3)
    if {s.id for s in live} != set(mesh.ids):
        raise AssertionError("collective_heartbeat: not every slot")
    print(f"kernel collective_heartbeat[D={d}, int32 [{d}, 1], C21's int32 "
          f"entry]: == plain; ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.3g} ({b_by}) library_ms(stack.sum(0))="
          f"{lib_ms:.4f}; the whole heartbeat (tensors, gather, launch, "
          f"fetch) {statistics.median(walls):.4f} ms host clock, median of "
          f"20 ({card})", flush=True)
    print_three_way(f"C21 heartbeat, D={d}, int32 [{d}, 1]", three_way(
        torch, {"heartbeat_sum": lambda: kernels.heartbeat_sum(stack),
                "stack.sum(0)": lambda: stack.sum(0)}), card)
    return [dict(
        name="collective_heartbeat", shape=f"D={d}, int32 [{d}, 1]",
        route="cuda", source="pipelinedp_tpu_torch/csrc/combine_shards.cu",
        replaces=HEARTBEAT_REPLACES, launches=0, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)]


def heartbeat_route(torch, kernels, card):
    """The heartbeat's route through probe_live_devices: card_mesh()'s
    slots, the upper half naming process 1, no fault schedule and no
    override, so collective_heartbeat launches C21. Returns the launch
    counts."""
    from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
    slots = remote_slots(torch, card_mesh(torch))
    kernels.reset_launch_counts()
    start = time.perf_counter()
    live = mesh_lib.probe_live_devices(slots)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = dict(kernels.launch_counts)
    check_launches("heartbeat route", counts, kernels,
                   dict(collective_heartbeat=1), ("collective_heartbeat",))
    if live != slots:
        raise AssertionError(f"probe_live_devices: {live} of {slots}")
    print(f"elastic: probe_live_devices over {len(slots)} slots "
          f"({sum(s.process_index == 1 for s in slots)} naming process 1), "
          f"no schedule: all live, collective_heartbeat launched once, "
          f"{seconds * 1e3:.3f} ms ({card})", flush=True)
    return counts


def elastic_phase(torch, tdp, netflix, nmax, qenc, qmax, kernels, card):
    """The meshed drivers' failure semantics at full width, device staging
    on card_mesh(): (a)-shaped COUNT+SUM+PRIVACY_ID_COUNT over (a)'s
    public partitions at the data's true per-user maxima (so pass 1 drops
    no row and every geometry bounds alike) on the 2^24 Netflix rows
    (dense), the same spec with private selection on (q) with integer
    values (blocked) and (q)'s selection at l0 = its largest partitions
    per id: a device_loss (block 2 on the
    blocked route) under elastic=True, two losses, a loss down to one slot
    (the unsharded driver on the card), min_devices=3 past two losses
    (MeshDegradationError, health FAILED), an announce_join grow from 2
    slots to 4 (and onto slots naming process 1: the admit's heartbeat),
    dispatch / consume retries: each == its unfaulted twin (==), walls
    side by side. Then the heartbeat's route and the OOM re-plan at a
    small size against TorchBackend(device="cpu"). Returns the launch
    counts summed over the runs."""
    import dataclasses
    from pipelinedp_tpu_torch.parallel.mesh import Slot
    from pipelinedp_tpu_torch.runtime import faults, health, retry
    from pipelinedp_tpu_torch.runtime import telemetry
    total = dict.fromkeys(kernels.KERNELS, 0)
    mesh = card_mesh(torch)
    dev, d = mesh.device, mesh.size
    fast = retry.RetryPolicy(base_delay=0.0, max_delay=0.0)
    M = tdp.Metrics

    def on_card(enc, values=None):
        return dataclasses.replace(
            enc, pid=torch.as_tensor(enc.pid).to(dev),
            pk=torch.as_tensor(enc.pk).to(dev),
            values=torch.as_tensor(enc.values if values is None else
                                   values).to(dev, torch.float32))

    q_card = on_card(qenc, np.floor(qenc.values))
    data = {"a": (on_card(netflix), nmax, False),
            "q": (q_card, qmax, True),
            "select q": (q_card, qmax, True)}

    def run(label, mesh_, schedule=(), announce=None, want_error=None,
            **backend):
        enc, maxima, blocked = data[label]
        kw = dict(large_partition_threshold=1 << 21, block_partitions=1 << 20)
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(
            noise_seed=14, mesh=mesh_, reshard="device", **kw, **backend))
        if label == "select q":
            res = engine.select_partitions(enc, tdp.SelectPartitionsParams(
                max_partitions_contributed=maxima[0]), tdp.DataExtractors())
        else:
            res = engine.aggregate(enc, tdp.AggregateParams(
                metrics=[M.COUNT, M.SUM, M.PRIVACY_ID_COUNT],
                noise_kind=tdp.NoiseKind.LAPLACE,
                max_partitions_contributed=maxima[0],
                max_contributions_per_partition=maxima[1], min_value=0.0,
                max_value=5.0), tdp.DataExtractors(),
                None if blocked else list(enc.partition_vocab))
        acc.compute_budgets()
        sched = faults.FaultSchedule([faults.Fault(**f) for f in schedule])
        if announce is not None:
            retry.announce_join(**announce)
        kernels.reset_launch_counts()
        before = telemetry.snapshot()
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            # An active schedule, even an empty one, is the probe's oracle
            # of other processes' slots: none without faults.
            with (faults.inject(sched) if schedule else
                  contextlib.nullcontext()):
                out = sorted(res) if label == "select q" else dict(res)
        except Exception as e:  # noqa: BLE001 - the check names the class
            if want_error is None or not isinstance(e, want_error):
                raise
            out = e
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        if sched.pending() or (announce is not None and
                               retry.pending_joins()):
            raise AssertionError(f"elastic ({label}): a fault or a join "
                                 f"ticket did not fire")
        if want_error is not None and not isinstance(out, want_error):
            raise AssertionError(f"elastic ({label}): no "
                                 f"{want_error.__name__}")
        counts = dict(kernels.launch_counts)
        for name, c in counts.items():
            total[name] += c
        if want_error is None and (not out or (label != "select q" and not all(
                np.all(np.isfinite(v)) for v in out.values()))):
            raise AssertionError(f"elastic ({label}): {len(out)} partitions "
                                 f"or a non-finite value")
        return out, seconds, telemetry.delta(before), counts

    retry.clear_joins()
    for label in ELASTIC_RUNS:
        blocked = data[label][2]
        # Twice: the second, warm, run is the unfaulted wall.
        base, _, _, counts = run(label, mesh)
        again, base_s, _, _ = run(label, mesh)
        if again != base:
            raise AssertionError(f"elastic ({label}): two unfaulted runs "
                                 f"differ")
        check_launches(f"elastic ({label}) unfaulted", counts, kernels,
                       None, MESH_BLOCKED_EXCHANGE if blocked else
                       EXCHANGE_PATH)
        loss_block = 2 if blocked else None
        cases = [
            ("device_loss", mesh, [dict(kind="device_loss", point="dispatch",
                                        block=loss_block)],
             dict(elastic=True, retry=fast, job_id=f"elastic-{label}"),
             dict(device_losses=1, mesh_degradations=1), (d, d - 1)),
            ("two losses", mesh, [dict(kind="device_loss", point="dispatch",
                                       times=2)],
             dict(elastic=True, retry=fast, job_id=f"elastic2-{label}"),
             dict(device_losses=2, mesh_degradations=2), (d, d - 2)),
            ("loss to one slot", card_mesh(torch, 2),
             [dict(kind="device_loss", point="dispatch")],
             dict(elastic=True, retry=fast, job_id=f"elastic1-{label}"),
             dict(device_losses=1, mesh_degradations=1), (2, 1)),
            ("grow 2 -> 4", card_mesh(torch, 2), [],
             dict(elastic_grow=True, retry=fast, job_id=f"grow-{label}"),
             dict(mesh_expansions=1), (4, 4)),
            ("retries", mesh, [dict(kind="dispatch", block=1 if blocked
                                    else None, times=2)] + (
                [dict(kind="consume", block=3)] if blocked else []),
             dict(retry=fast, job_id=f"retry-{label}"),
             dict(block_retries=3 if blocked else 2), None),
        ]
        for name, mesh_, schedule, backend, want, devices in cases:
            announce = (dict(n_devices=4, block=2 if blocked else 0)
                        if name.startswith("grow") else None)
            out, seconds, delta, _ = run(label, mesh_, schedule, announce,
                                         **backend)
            if out != base:
                raise AssertionError(f"elastic ({label}, {name}): the "
                                     f"release differs from the unfaulted "
                                     f"run")
            for key, n in want.items():
                if delta.get(key, 0) != n:
                    raise AssertionError(f"elastic ({label}, {name}): {key} "
                                         f"{delta.get(key, 0)}, expected {n}")
            snap = health.for_job(backend["job_id"]).snapshot()
            if devices is not None and (snap["planned_devices"],
                                        snap["live_devices"]) != devices:
                raise AssertionError(f"elastic ({label}, {name}): health "
                                     f"{snap}")
            print(f"elastic ({label}) {name}: {len(out)} partitions == the "
                  f"unfaulted run; wall {seconds * 1e3:.1f} ms against "
                  f"{base_s * 1e3:.1f} ms unfaulted; health "
                  f"{snap['state']}, planned {snap['planned_devices']}, "
                  f"live {snap['live_devices']}; telemetry "
                  f"{json.dumps({k: delta[k] for k in sorted(delta)})} "
                  f"({card})", flush=True)
        if label == "q":
            job = "elastic-floor-q"
            err, seconds, _, _ = run(
                label, mesh, [dict(kind="device_loss", point="dispatch",
                                   times=2)],
                want_error=retry.MeshDegradationError, elastic=True,
                min_devices=3, retry=fast, job_id=job)
            snap = health.for_job(job).snapshot()
            if job not in str(err) or snap["state"] != "FAILED":
                raise AssertionError(f"elastic (q, min_devices=3): {err}; "
                                     f"health {snap['state']}")
            print(f"elastic (q) min_devices=3, two losses: "
                  f"MeshDegradationError naming {job!r}, health FAILED "
                  f"(live {snap['live_devices']}), in {seconds * 1e3:.1f} ms "
                  f"({card})", flush=True)
            two = card_mesh(torch, 2)
            joiners = [Slot(2, dev, 1), Slot(3, dev, 1)]
            out, seconds, delta, counts = run(
                label, two, announce=dict(devices=joiners, block=2),
                elastic_grow=True, retry=fast, job_id="grow-remote-q")
            if out != base or counts["collective_heartbeat"] != 1 or \
                    delta.get("mesh_expansions") != 1:
                raise AssertionError(f"elastic (q) grow onto process-1 "
                                     f"slots: == {out == base}, heartbeat "
                                     f"{counts['collective_heartbeat']}")
            print(f"elastic (q) grow 2 -> 4 onto slots naming process 1: "
                  f"the admit's probe ran collective_heartbeat (C21 once); "
                  f"== the unfaulted run; wall {seconds * 1e3:.1f} ms "
                  f"({card})", flush=True)
    for name, count in heartbeat_route(torch, kernels, card).items():
        total[name] += count
    elastic_oom_parity(torch, tdp, card)
    return total


def elastic_oom_parity(torch, tdp, card):
    """The OOM re-plan at a small size: a blocked aggregation and a
    selection (2^16 rows, P ~ 4000, blocks of 512) with Fault("oom",
    block=2) on the card in float64 against TorchBackend(device="cpu")
    with the same seed and schedule: the same partitions, values within
    1e-9 of max(1, |x|), one block_oom_degradations each. (The re-planned
    blocks draw fresh keys, so the faulted release is not the unfaulted
    one.)"""
    from pipelinedp_tpu_torch.runtime import faults, telemetry
    rng = np.random.default_rng(SEED + 14)
    n = 1 << 16
    rows = list(zip(rng.integers(0, 3000, n).tolist(),
                    (rng.random(n)**3 * 4000).astype(int).tolist(),
                    rng.integers(0, 6, n).astype(float).tolist()))
    ex = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                            partition_extractor=lambda r: r[1],
                            value_extractor=lambda r: r[2])
    outs = {}
    for device in ("cuda", "cpu"):
        for kind in ("aggregate", "select"):
            backend = tdp.TorchBackend(
                device=device, dtype=torch.float64, noise_seed=3,
                large_partition_threshold=1024, block_partitions=512)
            acc = tdp.NaiveBudgetAccountant(total_epsilon=4.0,
                                            total_delta=1e-6)
            engine = tdp.DPEngine(acc, backend)
            if kind == "aggregate":
                res = engine.aggregate(rows, tdp.AggregateParams(
                    metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM],
                    noise_kind=tdp.NoiseKind.LAPLACE,
                    max_partitions_contributed=4,
                    max_contributions_per_partition=2, min_value=0.0,
                    max_value=5.0), ex)
            else:
                res = engine.select_partitions(
                    rows, tdp.SelectPartitionsParams(
                        max_partitions_contributed=4), ex)
            acc.compute_budgets()
            sched = faults.FaultSchedule([faults.Fault("oom", block=2)])
            before = telemetry.snapshot()
            with faults.inject(sched):
                out = dict(res) if kind == "aggregate" else sorted(res)
            got = telemetry.delta(before).get("block_oom_degradations",
                                              0)
            if got != 1 or sched.pending():
                raise AssertionError(f"elastic OOM ({device}, {kind}): "
                                     f"{got} degradations")
            outs[device, kind] = out
    for kind in ("aggregate", "select"):
        card_out, cpu_out = outs["cuda", kind], outs["cpu", kind]
        if kind == "select":
            same = card_out == cpu_out
        else:
            same = set(card_out) == set(cpu_out) and all(
                abs(a - b) <= 1e-9 * max(1.0, abs(b))
                for k in card_out for a, b in zip(card_out[k], cpu_out[k]))
        if not same or not card_out:
            raise AssertionError(f"elastic OOM re-plan ({kind}): the card "
                                 f"and the CPU differ")
        print(f"elastic OOM re-plan ({kind}, 2^16 rows, blocks of 512 -> "
              f"256 from block 2): card float64 == CPU within 1e-9, "
              f"{len(card_out)} partitions ({card})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
