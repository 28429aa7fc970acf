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
             warmed repeats (CUDA events)
  3. parity  a small aggregation and a small selection on the card in
             float64 against the same on the CPU (the plain versions)
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
  5. select  DPEngine.select_partitions at full size, l0 = 64, for the
             three selection strategies
             Each run of 4 and 5 starts with the launch counts at 0 and
             fails if a kernel of its path did not launch.
  6. stages  run (a)'s release step by step with CUDA events between the
             stages: where its time goes.
  7. profile one run (a) and one select under torch.profiler: the
             device's busy time (kernels and copies), its idle share of
             the release's wall time, and the largest device entries.
The last lines are the card's name and power limit (nvidia-smi), one JSON
line describing every kernel, and the result line.
"""

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


def check_equal(name, got, want):
    import torch
    if not torch.equal(got, want):
        diff = int((got != want).sum())
        raise AssertionError(f"{name}: {diff} entries differ from the plain "
                             f"version")
    return 0.0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test "
              "needs one CUDA card.", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pipelinedp_tpu_torch as tdp
    from pipelinedp_tpu_torch import columnar, cuda_build, executor, kernels
    from pipelinedp_tpu_torch.ops import threefry

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
    print(f"data: {N_ROWS} rows, {encoded.n_privacy_ids} privacy ids, "
          f"{encoded.n_partitions} partitions, encoded in "
          f"{time.perf_counter() - enc_start:.1f} s", flush=True)
    if encoded.n_partitions != N_MOVIES:
        raise AssertionError(f"{encoded.n_partitions} movies drawn, "
                             f"expected {N_MOVIES}")

    # 2. kernels -----------------------------------------------------------
    report = kernel_phase(torch, dev, encoded, kernels, executor, threefry)

    # 3. parity ------------------------------------------------------------
    parity_phase(torch, tdp, rng)
    select_parity_phase(torch, tdp, rng)

    # 4.-5. main paths -----------------------------------------------------
    launches = main_phase(torch, tdp, encoded, kernels, card)
    for name, count in select_phase(torch, tdp, encoded, kernels,
                                    card).items():
        launches[name] += count
    stage_phase(torch, dev, encoded, executor, card)
    profile_phase(torch, tdp, encoded, card)
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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
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
        timing = {
            "row_keys": (c1, c1p, None,
                         bound(n * (4 + 4 + 1) + n * (8 + 8 + fsz),
                               n * 170)),
            "bound_rows": (c2, c2p, None,
                           bound(n * (8 + 8 + 8 + fsz + 1) +
                                 n * (4 + 1 + n_cols * fsz), n * 40)),
            "reduce_partitions": (c3, c3p, "index_add",
                                  bound(n * (4 + 8 + 1 + n_cols * fsz) +
                                        P * 5 * fsz, n * 8)),
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
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
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
                  f"passes={sort_passes(words)} bound_ms={b_ms:.4f} ({b_by}) "
                  f"torch_chain_ms="
                  f"{cuda_ms(lambda: torch_sort_chain(torch, words), 10):.4f}",
                  flush=True)
        big_keep, big_cols = compact_args[1 << 21]
        print(f"kernel compact_kept[P=2^21, {int(big_keep.sum())} kept]: ms="
              f"{cuda_ms(lambda: kernels.compact_kept(big_keep, big_cols), 10):.4f}"
              f" argsort_gather_ms="
              f"{cuda_ms(lambda: kernels.compact_kept_plain(big_keep, big_cols), 10):.4f}"
              f" (P={P}: {n_kept} kept)", flush=True)
    return report


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


def check_launches(label, counts, kernels, want=None):
    """Every kernel of the path launched (and, where given, as often as
    `want` says)."""
    missing = [k for k in kernels.KERNELS if counts[k] == 0]
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


def stage_phase(torch, dev, encoded, executor, card):
    """Run (a)'s release stage by stage, CUDA events between stages."""
    import pipelinedp_tpu_torch as tdp
    from pipelinedp_tpu_torch import combiners, kernels
    from pipelinedp_tpu_torch.ops import threefry
    params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM, tdp.Metrics.MEAN,
                 tdp.Metrics.VARIANCE], noise_kind=tdp.NoiseKind.GAUSSIAN,
        max_partitions_contributed=64, max_contributions_per_partition=1,
        min_value=1.0, max_value=5.0)
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    compound = combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    cfg = executor.make_kernel_config(params, compound, encoded.n_partitions,
                                      False, None)
    stds = executor.compute_noise_stds(compound)
    scal = executor.kernel_scalars(params)
    rows_key, final_key = threefry.split(np.array([0, 3], np.uint32), 2)
    _, key_linf, key_l0 = threefry.split(rows_key, 3)
    salts = threefry.bits(key_l0, 4)
    names = ("h2d", "row_keys", "bounding_sort", "bound_rows",
             "partition_sort", "reduce_partitions", "release_epilogue",
             "compaction")
    totals = {name: [] for name in names}
    decode_ms = []
    for _ in range(4):
        events = [torch.cuda.Event(enable_timing=True) for _ in names]
        events.append(torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        events[0].record()
        pid, pk, values, valid = executor.to_device(encoded, dev,
                                                    torch.float32)
        events[1].record()
        k1, k2, u = kernels.row_keys(pid, pk, valid, salts, key_linf,
                                     cfg.n_partitions, torch.float32)
        events[2].record()
        perm = executor.sort_rows(k1, k2, u)
        events[3].record()
        key2, pair_start, row_cols = kernels.bound_rows(
            perm, k1, k2, pk, values, valid, n_partitions=cfg.n_partitions,
            linf=cfg.linf, l0=cfg.l0, clip_per_value=cfg.clip_per_value,
            clip_pair_sum=cfg.clip_pair_sum, scalars=scal,
            columns=executor.reduce_column_names(cfg))
        events[4].record()
        perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
        events[5].record()
        cols = kernels.reduce_partitions(skey2, perm2, pair_start, row_cols,
                                         cfg.n_partitions, torch.float32)
        cols["row_count"] = cols["pid_count"]
        events[6].record()
        outputs, keep, flags = executor.finalize(cols, scal[0], scal[4],
                                                 stds, final_key, cfg)
        events[7].record()
        n_kept, order, compacted = executor.compact_release(outputs, keep)
        events[8].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name].append(events[i].elapsed_time(events[i + 1]))
        start = time.perf_counter()
        released = list(executor.decode_release_results(
            n_kept, order, compacted, flags, encoded.partition_vocab,
            compound))
        decode_ms.append((time.perf_counter() - start) * 1e3)
        if len(released) != cfg.n_partitions:
            raise AssertionError(f"stages: {len(released)} partitions "
                                 f"decoded")
    # The first of the four runs warms the allocator; report the median of
    # the other three.
    med = {name: round(statistics.median(t[1:]), 4)
           for name, t in totals.items()}
    med["decode_host"] = round(statistics.median(decode_ms[1:]), 4)
    print(f"stages (a) float32, ms, median of 3 ({card}): "
          f"{json.dumps(med)} sum {sum(med.values()):.3f}", flush=True)



def profile_phase(torch, tdp, encoded, card):
    """Run (a) and a select under torch.profiler (graph build and budgets
    outside the window): device busy time = the sum of device entries
    (one stream, so they do not overlap), idle share = 1 - busy / wall."""
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

    def run_select():
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        engine = tdp.DPEngine(acc, tdp.TorchBackend(noise_seed=21))
        res = engine.select_partitions(
            encoded, tdp.SelectPartitionsParams(max_partitions_contributed=64),
            tdp.DataExtractors())
        acc.compute_budgets()
        return res

    for label, setup in (("aggregate (a)", run_a), ("select", run_select)):
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
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
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


if __name__ == "__main__":
    sys.exit(main())
