"""DPEngine.select_partitions on the port's TorchBackend (CPU, float64)
against the JAX package's TPUBackend on the same rows and seed: the
scenarios of tests/test_dp_engine.py::TestSelectPartitions that take the
dense route.

Bound stated here: the identical list of released partition keys, in the
same order (the kept-first compaction's ascending partition ids), and the
identical Explain Computation report.
"""

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu_torch import columnar
from pipelinedp_tpu_torch import kernels

pytestmark = pytest.mark.torch_port

HUGE_EPS = 1e7


def backend(mod, seed, **kwargs):
    if mod is pdp:
        return pdp.TPUBackend(noise_seed=seed, **kwargs)
    return tdp.TorchBackend(device="cpu", noise_seed=seed,
                            dtype=torch.float64, **kwargs)


def extractors(mod):
    return mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                              partition_extractor=lambda r: r[1],
                              value_extractor=lambda r: r[2])


def select(mod, rows, seed=7, eps=HUGE_EPS, delta=1e-5, strategy=None,
           **params):
    if strategy is not None:
        params["partition_selection_strategy"] = getattr(
            mod.PartitionSelectionStrategy, strategy)
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = mod.DPEngine(acc, backend(mod, seed))
    result = engine.select_partitions(rows,
                                      mod.SelectPartitionsParams(**params),
                                      extractors(mod))
    acc.compute_budgets()
    return list(result), engine.explain_computations_report()


def assert_same_selection(rows, **kwargs):
    want, want_report = select(pdp, rows, **kwargs)
    got, got_report = select(tdp, rows, **kwargs)
    assert got == want
    assert got_report == want_report
    return got


BIG_SMALL = [(f"u{i}", "big", 0) for i in range(1000)] + [("solo", "small",
                                                            0)]
STRATEGIES = ["TRUNCATED_GEOMETRIC", "LAPLACE_THRESHOLDING",
              "GAUSSIAN_THRESHOLDING"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_select_partitions_big_kept_small_dropped(strategy):
    got = assert_same_selection(BIG_SMALL, strategy=strategy,
                                max_partitions_contributed=2)
    assert got == ["big"]


def random_rows(seed: int, n: int = 2000):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 400, n)
    parts = (rng.integers(0, 30, n)**2) // 30  # skewed partition sizes
    return [(f"u{u}", f"pk{p}", 0) for u, p in zip(users, parts)]


@pytest.mark.parametrize("pre_threshold", [None, 4],
                         ids=["no_pre_threshold", "pre_threshold"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_noisy_selection_matches_tpu_backend(strategy, pre_threshold):
    rows = random_rows(11)
    got = assert_same_selection(rows, eps=1.0, delta=1e-6, strategy=strategy,
                                max_partitions_contributed=2,
                                pre_threshold=pre_threshold)
    # Selection keeps the big partitions and drops the small ones.
    assert 0 < len(got) < len({r[1] for r in rows})


def test_pre_threshold_drops_partitions_below_it():
    rows = BIG_SMALL[:-1] + [(f"m{i}", "mid", 0) for i in range(15)]
    got = assert_same_selection(rows, max_partitions_contributed=1,
                                pre_threshold=20)
    assert got == ["big"]


def test_small_max_partitions_contributed_samples_each_users_partitions():
    # 150 users each touch all 12 partitions and keep 1: each partition
    # counts ~12 users instead of 150, near the selection threshold, so the
    # L0 sample decides which partitions survive.
    rows = [(f"u{i}", f"pk{j}", 0) for i in range(150) for j in range(12)]
    got = assert_same_selection(rows, seed=3, eps=1.0, delta=1e-6,
                                max_partitions_contributed=1)
    assert 0 < len(got) < 12


def test_huge_epsilon_selection_keeps_every_populated_partition():
    rng = np.random.default_rng(3)
    rows = [(f"u{i % 90}", f"pk{k}", 0)
            for i, k in enumerate(rng.integers(0, 25, size=3000))]
    got = assert_same_selection(rows, seed=0, max_partitions_contributed=30)
    assert sorted(got) == sorted({r[1] for r in rows})


def test_pre_encoded_columns_select_like_rows():
    rows = random_rows(5)
    encoded = columnar.encode_columns([r[0] for r in rows],
                                      [r[1] for r in rows], None)
    assert encoded.values is None
    from_rows, _ = select(tdp, rows, eps=1.0, delta=1e-6,
                          max_partitions_contributed=2)
    from_columns, _ = select(tdp, encoded, eps=1.0, delta=1e-6,
                             max_partitions_contributed=2)
    assert from_columns == from_rows


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_budget_misuse_raises_as_in_jax(mod):
    params = mod.SelectPartitionsParams(max_partitions_contributed=1)
    # Reading the selection before compute_budgets().
    acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    result = mod.DPEngine(acc, backend(mod, 1)).select_partitions(
        BIG_SMALL, params, extractors(mod))
    with pytest.raises(AssertionError, match="not calculated yet"):
        list(result)
    # Requesting budget after compute_budgets().
    acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = mod.DPEngine(acc, backend(mod, 1))
    engine.select_partitions(BIG_SMALL, params, extractors(mod))
    acc.compute_budgets()
    with pytest.raises(Exception, match="after compute_budgets"):
        engine.select_partitions(BIG_SMALL, params, extractors(mod))


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_invalid_arguments_raise_as_in_jax(mod):
    acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = mod.DPEngine(acc, backend(mod, 1))
    ex = extractors(mod)
    with pytest.raises(ValueError, match="max_partitions_contributed"):
        engine.select_partitions(
            BIG_SMALL, mod.SelectPartitionsParams(max_partitions_contributed=0),
            ex)
    with pytest.raises(TypeError, match="SelectPartitionsParams"):
        engine.select_partitions(
            BIG_SMALL,
            mod.AggregateParams(metrics=[mod.Metrics.COUNT],
                                max_partitions_contributed=1,
                                max_contributions_per_partition=1), ex)
    with pytest.raises(ValueError, match="non-empty"):
        engine.select_partitions(
            [], mod.SelectPartitionsParams(max_partitions_contributed=1), ex)
    with pytest.raises(ValueError, match="pre_threshold"):
        mod.SelectPartitionsParams(max_partitions_contributed=1,
                                   pre_threshold=0)


def test_blocked_route_size_raises_not_implemented():
    # Above large_partition_threshold the blocked route selects (it raised
    # NotImplementedError before the route was ported): the same list as
    # TPUBackend's blocked route.
    kept = []
    for mod, backend in (
            (tdp, tdp.TorchBackend(device="cpu", noise_seed=3,
                                   dtype=torch.float64,
                                   large_partition_threshold=1)),
            (pdp, pdp.TPUBackend(noise_seed=3,
                                 large_partition_threshold=1))):
        acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        result = mod.DPEngine(acc, backend).select_partitions(
            BIG_SMALL,
            mod.SelectPartitionsParams(max_partitions_contributed=1),
            extractors(mod))
        acc.compute_budgets()
        kept.append(list(result))
    assert kept[0] == kept[1] == ["big"]


def test_selection_runs_the_kernels_path_in_order(monkeypatch):
    # The CPU run goes through every wrapper of the selection path.
    called = []
    for name in ("row_keys", "radix_sort", "bound_rows", "reduce_partitions",
                 "release_epilogue", "compact_kept"):
        original = getattr(kernels, name)

        def spy(*args, _name=name, _original=original, **kwargs):
            called.append(_name)
            return _original(*args, **kwargs)

        monkeypatch.setattr(kernels, name, spy)
    got, _ = select(tdp, BIG_SMALL, max_partitions_contributed=2)
    assert got == ["big"]
    assert called == ["row_keys", "radix_sort", "bound_rows", "radix_sort",
                      "reduce_partitions", "release_epilogue",
                      "compact_kept"]
