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
             on block 1 of (q)'s stream, a full block of 2^20 partitions
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
  2. kernels C12 factorize_codes and C13 lookup_codes on the hash rows of
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
             trail's shapes; their times beside torch.fft.rfft / irfft and
             _compose_pmfs_host
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
             group_stats
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
The last lines are the card's name and power limit (nvidia-smi), one JSON
line describing every kernel, and the result line.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
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
PERCENTILE_PATH = BASE_KERNELS + ("quantile_counts", "quantile_descend")
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


def main() -> int:
    import torch
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

    # 2. kernels -----------------------------------------------------------
    report = kernel_phase(torch, dev, encoded, kernels, executor, threefry)
    report += quantile_vector_kernel_phase(torch, dev, encoded, years,
                                           kernels, threefry)
    report += secure_safe_kernel_phase(torch, dev, encoded, years, kernels,
                                       executor, threefry)
    report += large_p_kernel_phase(torch, dev, qenc, qmax, kernels, large_p,
                                   threefry, tdp, card)
    report += ingest_kernel_phase(
        torch, dev, {"users": (users, encoded.pid),
                     "movies": (movies, encoded.pk),
                     "q partitions": (qraw[1], qenc.pk)},
        kernels, device_encode, ingest, card)

    # 3. parity ------------------------------------------------------------
    parity_phase(torch, tdp, rng)
    quantile_vector_parity_phase(torch, tdp, rng)
    select_parity_phase(torch, tdp, rng)
    secure_safe_parity_phase(torch, tdp, kernels, rng)
    large_p_parity_phase(torch, tdp, rng)
    ingest_parity_phase(torch, tdp, rng)

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
    kernel_stage_phase(torch, tdp, encoded, onehot, kernels, executor, card)
    large_p_stage_phase(torch, tdp, qenc, encoded, nmax, kernels, large_p,
                        threefry, card)
    ingest_stage_phase(torch, tdp, streamed, kernels, executor, ingest,
                       rt_pipeline, encode_s, card)
    profile_phase(torch, tdp, encoded, card)
    # Utility analysis and tuning, after every earlier timed run.
    report += sweep_kernel_phase(torch, dev, sweep_shapes(tdp, encoded),
                                 kernels, card)
    for name, count in analysis_main_phase(torch, tdp, users, movies,
                                           ratings, kernels, card).items():
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


def kernel_phase(torch, dev, encoded, kernels, executor, threefry):
    """C1-C6 against their plain versions on the card, small then full."""
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
        # C5 on the four key sets of the path: the same permutation.
        perm = kernels.radix_sort([k1, k2, u])
        perm0, spid0 = kernels.radix_sort([pid_sent, u0], sorted_top=True)
        q_perm0, q_spid0 = kernels.radix_sort_plain([pid_sent, u0], True)
        err5 = max(check_equal("radix_sort bounding", perm,
                               kernels.radix_sort_plain([k1, k2, u])),
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
                                        **c2_args)
        c2p = lambda: kernels.bound_rows_plain(perm, k1, k2, pk, values,  # noqa: E731
                                               valid, **c2_args)
        key2, pair_start, row_cols = c2()
        q_key2, q_start, q_cols = c2p()
        sel_args = dict(n_partitions=P, linf=0, l0=64, clip_per_value=False,
                        clip_pair_sum=False, scalars=(0.0,) * 5, columns=())
        s_key2, s_start, _ = kernels.bound_rows(perm, k1, k2, pk, None,
                                                valid, **sel_args)
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
        dense = c3()
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
        perm = kernels.radix_sort([k1, k2, u])
        key2, pair_start, _ = kernels.bound_rows(
            perm, k1, k2, pk, None, valid, n_partitions=P, linf=linf, l0=l0,
            clip_per_value=False, clip_pair_sum=False, scalars=(0.0,) * 5,
            columns=())
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
        counts_by_level = []
        for level in range(1, h + 1):
            node = state.node.clone()
            counts = kernels.quantile_child_counts(skey2, perm2, perm, values,
                                                   node, level=level, **tree)
            err7 = max(err7, check_equal(
                f"quantile_child_counts level {level}", counts,
                kernels.quantile_child_counts_plain(
                    skey2, perm2, perm, values, node, level=level, **tree)))
            counts_by_level.append(counts)
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
        vsum = c3v()["vsum"]
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
        errors = {"quantile_counts": err7, "quantile_descend": err8,
                  "vector_release": err9, "reduce_partitions vector": err3}
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
        timing = {
            "quantile_counts": (c7a, c7a_plain, lib7, b7,
                                "quantile_counts.cu",
                                "pipelinedp_tpu/executor.py:825"),
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
        node = torch.zeros(P, n_q, dtype=torch.int32, device=dev)
        b_ms, b_by = bound(n * 4 + mkept * (8 + 8 + fsz) +
                           P * n_q * (4 + B * 4), mkept * (20 + 2 * n_q))
        print(f"kernel quantile_counts[child counts, one level, P={P}]: ms="
              f"{cuda_ms(lambda: kernels.quantile_child_counts(skey2, perm2, perm, values, node, level=1, **tree), 10):.4f}"
              f" plain_ms="
              f"{cuda_ms(lambda: kernels.quantile_child_counts_plain(skey2, perm2, perm, values, node, level=1, **tree), 3, 1):.4f}"
              f" bound_ms={b_ms:.3g} ({b_by})", flush=True)
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
    lazy = dict(row_keys=1, bound_rows=1, radix_sort=2, quantile_counts=4,
                quantile_descend=4)
    dense = dict(row_keys=1, bound_rows=1, radix_sort=2, quantile_counts=2,
                 quantile_descend=1)
    vec = dict(row_keys=1, bound_rows=1, radix_sort=2, reduce_partitions=1,
               vector_release=1)
    runs = {
        "f": (encoded, percentiles, "GAUSSIAN", True, PERCENTILE_PATH, lazy,
              dict(per_movie, **ratings)),
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
                                1e6, 9, PERCENTILE_PATH, lazy,
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

            to_device = executor.to_device
            for n in names:
                setattr(kernels, n, timed(n, originals[n]))
            executor.to_device = timed("h2d", to_device)
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
                executor.to_device = to_device
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
        perm = kernels.radix_sort([k1, k2, u])
        key2, pair_start, row_cols = kernels.bound_rows(
            perm, k1, k2, pk, values if columns else None, valid,
            n_partitions=P, linf=linf, l0=l0, clip_per_value=True,
            clip_pair_sum=False, scalars=(1000.0, 5000.0, 0.0, 0.0, 3000.0),
            columns=columns)
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
        comp, comp_p = c3c(), c3c_plain()
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
        vcomp = kernels.reduce_partitions(*vargs, compensated=True)["vsum"]
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
    secure_q = PERCENTILE_PATH + ("release_epilogue_secure",
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
BLOCKED_KERNELS = ("row_keys", "bound_rows", "radix_sort", "block_offsets",
                   "reduce_partitions_windowed", "release_epilogue",
                   "compact_kept")


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
    """float32 rounding of a partition sum from C3's tile scan: one ulp of
    the sum for each sequential addition (the tiles of 2048 rows the
    partition spans, plus 16 inside a tile)."""
    ulp = np.spacing(np.abs(truth).astype(np.float32)).astype(np.float64)
    return (count / 2048.0 + 16.0) * ulp


class PhaseProbe:
    """Hands aggregate_blocked a phase_times dict on every call the engine
    makes and notes when it returned (decode = the time after it)."""

    def __init__(self, large_p):
        self.large_p = large_p
        self.records = []

    def __enter__(self):
        self.original = original = self.large_p.aggregate_blocked

        def probed(*args, **kwargs):
            phase_times = kwargs["phase_times"] = {}
            out = original(*args, **kwargs)
            phase_times["returned_at"] = time.perf_counter()
            self.records.append(phase_times)
            return out

        self.large_p.aggregate_blocked = probed
        return self

    def __exit__(self, *exc):
        self.large_p.aggregate_blocked = self.original


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
    bounds = torch.as_tensor(np.minimum(
        large_p._block_boundaries(0, LARGE_BLOCK, n_blocks), P)).to(dev)
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
    dense, q_dense = c3(), c3p()
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
    vec = kernels.reduce_partitions(sk, pw, stream.pair_start, {}, C, f32,
                                    vrows, base=base)["vsum"]
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
    comp = c3c()
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
    c7 = lambda: kernels.quantile_child_counts(*qargs, node,  # noqa: E731
                                               **tree)
    c7p = lambda: kernels.quantile_child_counts_plain(  # noqa: E731
        *qargs, node, **tree)
    err7 = max(err7, check_equal("quantile child counts windowed", c7(),
                                 c7p()))
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
        "gather_rows": (c11_entry, err11, "gather_rows.cu",
                        "pipelinedp_tpu/parallel/large_p.py:671"),
        "reduce_partitions_windowed": (
            c3_entry, err3, "reduce_partitions.cu",
            "pipelinedp_tpu/parallel/large_p.py:183"),
        "reduce_partitions_compensated_windowed": (
            c3c_entry, err3c, "reduce_partitions.cu",
            "pipelinedp_tpu/parallel/large_p.py:183"),
        "quantile_counts_windowed": (
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
    return report


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
    blocks = dict(block_offsets=1, reduce_partitions_windowed=n_blocks,
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
    q_path = BLOCKED_KERNELS + ("quantile_counts_windowed",
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
        want=dict(block_offsets=1, reduce_partitions_windowed=v_blocks,
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
                   dict(gather_rows=n_chunks, block_offsets=n_chunks + 1),
                   BLOCKED_KERNELS + ("gather_rows",))
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
                           dict(block_offsets=1, reduce_partitions=0),
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
    names = ("row_keys", "radix_sort", "bound_rows", "block_offsets",
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
        res = setup()
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
            raise AssertionError(f"profile {label}: no device time traced")
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
    C13 and to the host encoder's first-occurrence codes; C14's grow and
    fill_tail on 2^24-row buffers, equal to their plain versions. Returns
    the report rows (C12 and C13 on the user hashes, C14 grow on the host
    route's buffers)."""
    report = []
    for label, (raw, host_codes) in key_sets.items():
        h1, h2 = ingest.hash_key_column_pair(raw)
        rows = torch.from_numpy(
            device_encode.pack_hash_rows(h1).view(np.int32)).to(dev)
        # The merged table of one chunk: distinct hashes ascending, their
        # first positions.
        s1, _, _, first = ingest._hash_uniques(h1, h2, None)
        n = rows.shape[0]
        codes, n_unique = kernels.factorize_codes(rows)
        plain_codes, plain_n = kernels.factorize_codes_plain(rows)
        err12 = check_equal(f"factorize_codes ({label})", codes,
                            plain_codes)
        check_equal(f"factorize_codes ({label}) vs the host encoder", codes,
                    torch.from_numpy(host_codes).to(dev))
        if not int(n_unique) == int(plain_n) == len(s1):
            raise AssertionError(f"factorize_codes ({label}): {n_unique} / "
                                 f"{plain_n} distinct, host {len(s1)}")
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
        c12 = (lambda: kernels.factorize_codes(rows),  # noqa: E731
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
        print(f"kernels[ingest, {label}: {n} rows, {len(s1)} distinct "
              f"hashes]: C12 factorize_codes ms={ms['factorize_codes'][0]:.4f}"
              f" (its C5 sort included) plain_ms={ms['factorize_codes'][1]:.4f}"
              f" bound_ms={c12[3][0]:.3g} ({c12[3][1]}); torch.unique("
              f"return_inverse) {unique_ms:.4f} ms (not the same function: "
              f"sorted-order codes); C13 lookup_codes ms="
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
        del rows, codes, plain_codes, looked, key64
    # C14 on the host route's buffers (pid, pk int32; values float32) and
    # the hash route's (two int32[., 3] hash columns).
    n, half = N_ROWS, N_ROWS // 2
    gen = torch.Generator(device=dev).manual_seed(SEED)
    host_bufs = [torch.randint(0, 1 << 30, (half,), dtype=torch.int32,
                               device=dev, generator=gen),
                 torch.randint(-1, 17770, (half,), dtype=torch.int32,
                               device=dev, generator=gen),
                 torch.rand(half, device=dev, generator=gen)]
    hash_bufs = [torch.randint(-(1 << 31), 1 << 31, (half, 3),
                               dtype=torch.int32, device=dev, generator=gen)
                 for _ in range(2)] + [host_bufs[2]]
    out = {}
    for label, bufs, fills in (("host route", host_bufs, (0, -1, 0.0)),
                               ("hash route", hash_bufs, (-1, -1, 0.0))):
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
    functions, by stage; a wrapper called inside another timed one (C12's
    C5 sort) is part of the outer stage."""

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
    stream; for (a) around executor.to_device), C14, C12 / C13, the release
    kernels, and the rest (the host's release setup and decode)."""
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
            patch(executor, "to_device",
                  clock.device("h2d", executor.to_device))
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
          f"log_spectrum {err16:.3g} ({card})", flush=True)
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
    for j, name in ((0, "lo_hi"), (1, "edges"), (2, "counts"), (4, "maxes")):
        check_equal(f"{label} {name}", got[j], want[j])
    edges, counts = want[1], want[2]
    v = values[mask]
    idx = (torch.searchsorted(edges, v, right=True) - 1).clamp(
        0, counts.shape[0] - 1)
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
    C18 against their plain versions on the card at these shapes; each
    stage's time. Returns the report rows (on the Netflix rows) and the
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
                           dict(radix_sort=3, group_stats=3, log_bins=6),
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
        perm = kernels.radix_sort([sp, sk])
        pairs = kernels.group_stats_pairs(pid, pk, vals, valid, perm)
        plain = kernels.group_stats_pairs_plain(pid, pk, vals, valid, perm)
        err17 = 0.0
        for name in kernels.PAIR_STATS:
            if name == "pair_sum":
                # torch's index_add_ adds a pair's rows on the card by
                # atomics, in another order than C17's walk.
                d = (pairs[name] - plain[name]).abs()
                if bool((d > 1e-5 * plain[name].abs()).any()):
                    raise AssertionError(f"group_stats ({label}) pair_sum: "
                                         f"max err {float(d.max())}")
                err17 = max(err17, float(d.max()))
            else:
                check_equal(f"group_stats ({label}) {name}", pairs[name],
                            plain[name])
        perm2 = kernels.radix_sort([sk])
        pair_pk = pairs["pair_pk"]
        perm3 = kernels.radix_sort([pair_pk])
        for what, args in (("pk", (sk, valid, perm2)),
                           ("pair starts", (pair_pk, pairs["new_pair"],
                                            perm3))):
            for g, w in zip(kernels.group_stats_keys(*args),
                            kernels.group_stats_keys_plain(*args)):
                check_equal(f"group_stats keys ({label}, {what})", g, w)
        stats = dh.group_stats(pid, pk, vals, valid)
        err18 = 0.0
        for key in ("l0", "l1", "linf", "count_per_pk", "pids_per_pk"):
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
                pid, pk, vals, valid, perm), 5), cuda_ms(
                lambda: kernels.group_stats_pairs_plain(pid, pk, vals, valid,
                                                        perm), 3, 1)),
            "C17 keys (pk)": (cuda_ms(lambda: kernels.group_stats_keys(
                sk, valid, perm2), 5), cuda_ms(
                lambda: kernels.group_stats_keys_plain(sk, valid, perm2), 3,
                1)),
            "C18 int (l1)": (cuda_ms(lambda: kernels.log_bins_int(
                l1, new_pid), 5), cuda_ms(
                lambda: kernels.log_bins_int_plain(l1, new_pid), 3, 1)),
            "C18 float": (cuda_ms(lambda: kernels.log_bins_float(
                psum, new_pair, 10000), 5), cuda_ms(
                lambda: kernels.log_bins_float_plain(psum, new_pair, 10000),
                3, 1)),
        }
        stage_ms = {k: [round(v[0], 4), v[1] and round(v[1], 4)]
                    for k, v in ms.items()}
        histc_ms = cuda_ms(lambda: torch.histc(
            psum[new_pair], bins=10000), 5)
        # Inputs read once (through the permutation), outputs written once.
        b17 = bound(n * (4 + 4 + 4 + 1 + 8) + n * (1 + 1 + 4 + 4 + 4 + 4 + 4),
                    n * 8)
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
              f"{histc_ms:.4f} ms; C17 bound_ms={b17[0]:.3g} ({b17[1]}), C18 "
              f"int bound_ms={b18[0]:.3g} ({b18[1]}); C17 and C18 equal "
              f"their plain versions (pair sums within {err17:.3g}, float "
              f"bucket sums within {err18f:.3g}) ({card})", flush=True)
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
        del pid, pk, vals, valid, perm, pairs, plain, stats
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
            offs = kernels.block_offsets(
                spk, torch.arange(p + 1, dtype=torch.int32, device=dev))
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


if __name__ == "__main__":
    sys.exit(main())
