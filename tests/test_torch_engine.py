"""DPEngine.aggregate on the port's TorchBackend (CPU, float64) against the
JAX package's TPUBackend on the same rows and seed.

Bounds stated here:
  * released partitions: identical sets.
  * released values: within 1e-9 relative (max(1, |x|)) of TPUBackend's;
    the float64 noise words agree to the ulp bounds of
    test_torch_threefry.
  * at epsilon = 1e6+ and bounds the data respects: exact aggregates
    within 1e-2, as tests/test_dp_engine.py and test_property_parity.py
    check the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import columnar as jax_columnar
from pipelinedp_tpu import numeric as jax_numeric
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import numeric

pytestmark = pytest.mark.torch_port

HUGE_EPS = 1e7
SEED = 42


def run(mod, rows, params_kwargs, public=None, eps=HUGE_EPS, delta=1e-5,
        extractors=None, seed=SEED):
    if mod is pdp:
        backend = pdp.TPUBackend(noise_seed=seed)
    else:
        backend = tdp.TorchBackend(device="cpu", noise_seed=seed,
                                   dtype=torch.float64)
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = mod.DPEngine(acc, backend)
    if extractors is None:
        extractors = mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                        partition_extractor=lambda r: r[1],
                                        value_extractor=lambda r: r[2])
    else:
        extractors = mod.DataExtractors(**extractors)
    kwargs = dict(params_kwargs)
    for field, enum in (("noise_kind", "NoiseKind"),
                        ("partition_selection_strategy",
                         "PartitionSelectionStrategy")):
        if field in kwargs:
            kwargs[field] = getattr(getattr(mod, enum), kwargs[field])
    kwargs["metrics"] = [getattr(mod.Metrics, m) for m in kwargs["metrics"]]
    report = mod.ExplainComputationReport()
    result = engine.aggregate(rows, mod.AggregateParams(**kwargs),
                              extractors, public,
                              out_explain_computation_report=report)
    acc.compute_budgets()
    released = dict(result)
    assert engine.explain_computations_report() == [report.text()]
    return released, report.text()


def assert_same_release(rows, params_kwargs, **kw):
    want, want_report = run(pdp, rows, params_kwargs, **kw)
    got, got_report = run(tdp, rows, params_kwargs, **kw)
    assert set(got) == set(want)
    for key, metrics in want.items():
        assert got[key]._fields == metrics._fields
        for a, b in zip(got[key], metrics):
            assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)
    assert got_report == want_report
    return got


SIMPLE_ROWS = [
    ("u1", "A", 1.0),
    ("u1", "A", 2.0),
    ("u1", "B", 3.0),
    ("u2", "A", 4.0),
    ("u2", "B", 1.0),
    ("u3", "A", 2.0),
]

# The in-scope scenarios of tests/test_dp_engine.py
# TestAggregatePublicPartitions, with their exact expectations at huge eps.
PUBLIC_SCENARIOS = {
    "count_sum": (SIMPLE_ROWS, dict(metrics=["COUNT", "SUM"],
                                    noise_kind="LAPLACE",
                                    max_partitions_contributed=2,
                                    max_contributions_per_partition=2,
                                    min_value=0.0, max_value=5.0),
                  ["A", "B", "C"], {("A", "count"): 4, ("A", "sum"): 9.0,
                                    ("B", "count"): 2, ("B", "sum"): 4.0,
                                    ("C", "count"): 0}),
    "value_clipping": (SIMPLE_ROWS, dict(metrics=["SUM"],
                                         max_partitions_contributed=2,
                                         max_contributions_per_partition=3,
                                         min_value=0.0, max_value=1.0),
                       ["A", "B"], {("A", "sum"): 4.0, ("B", "sum"): 2.0}),
    "partition_sum_clipping": (SIMPLE_ROWS, dict(
        metrics=["SUM"], max_partitions_contributed=2,
        max_contributions_per_partition=5, min_sum_per_partition=0.0,
        max_sum_per_partition=2.5), ["A", "B"], {("A", "sum"): 7.0,
                                                 ("B", "sum"): 3.5}),
    "privacy_id_count": (SIMPLE_ROWS, dict(
        metrics=["PRIVACY_ID_COUNT"], max_partitions_contributed=2,
        max_contributions_per_partition=2), ["A", "B"],
        {("A", "privacy_id_count"): 3, ("B", "privacy_id_count"): 2}),
    "mean": (SIMPLE_ROWS, dict(metrics=["MEAN", "COUNT", "SUM"],
                               max_partitions_contributed=2,
                               max_contributions_per_partition=3,
                               min_value=0.0, max_value=5.0), ["A", "B"],
             {("A", "mean"): 9.0 / 4, ("A", "count"): 4, ("A", "sum"): 9.0}),
    "variance": (SIMPLE_ROWS, dict(metrics=["VARIANCE", "MEAN"],
                                   max_partitions_contributed=2,
                                   max_contributions_per_partition=3,
                                   min_value=0.0, max_value=5.0), ["A"],
                 {("A", "variance"): float(np.var([1.0, 2.0, 4.0, 2.0])),
                  ("A", "mean"): 2.25}),
    "linf_bounding": ([("u1", "A", 1.0)] * 10, dict(
        metrics=["COUNT"], max_partitions_contributed=1,
        max_contributions_per_partition=3), ["A"], {("A", "count"): 3}),
}


@pytest.mark.parametrize("name", sorted(PUBLIC_SCENARIOS))
def test_public_scenarios_match_tpu_backend_and_raw(name):
    rows, params, public, expected = PUBLIC_SCENARIOS[name]
    got = assert_same_release(rows, params, public=public)
    assert set(got) == set(public)
    for (pk, metric), value in expected.items():
        assert getattr(got[pk], metric) == pytest.approx(value, abs=5e-2)


def test_l0_bounding_caps_partitions():
    rows = [("u1", pk, 1.0) for pk in "ABCDEFGH"]
    got = assert_same_release(
        rows, dict(metrics=["COUNT"], max_partitions_contributed=3,
                   max_contributions_per_partition=1),
        public=list("ABCDEFGH"))
    assert sum(got[pk].count for pk in "ABCDEFGH") == pytest.approx(3, abs=0.05)


def test_contribution_bounds_already_enforced():
    rows = [("A", 1.0), ("A", 2.0), ("B", 3.0)]
    got = assert_same_release(
        rows, dict(metrics=["COUNT", "SUM"], max_partitions_contributed=1,
                   max_contributions_per_partition=1, min_value=0.0,
                   max_value=5.0, contribution_bounds_already_enforced=True),
        public=["A", "B"],
        extractors=dict(partition_extractor=lambda r: r[0],
                        value_extractor=lambda r: r[1]))
    assert got["A"].count == pytest.approx(2, abs=1e-2)
    assert got["A"].sum == pytest.approx(3.0, abs=1e-2)
    assert got["B"].sum == pytest.approx(3.0, abs=1e-2)


@pytest.mark.parametrize("strategy", ["TRUNCATED_GEOMETRIC",
                                      "LAPLACE_THRESHOLDING",
                                      "GAUSSIAN_THRESHOLDING"])
def test_small_partitions_dropped_large_kept(strategy):
    rows = [("lonely", "small", 1.0)]
    rows += [(f"u{i}", "big", 1.0) for i in range(1000)]
    got = assert_same_release(
        rows, dict(metrics=["COUNT"], max_partitions_contributed=1,
                   max_contributions_per_partition=1,
                   partition_selection_strategy=strategy))
    assert set(got) == {"big"}
    assert got["big"].count == pytest.approx(1000, abs=0.1)


def random_rows(seed: int, n: int = 1500):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 150, n)
    parts = (rng.integers(0, 16, n)**2) // 16  # skewed partition sizes
    values = rng.uniform(-1.0, 6.0, n)
    return [(int(u), f"p{int(p)}", float(v))
            for u, p, v in zip(users, parts, values)]


METRIC_SETS = {
    "count_sum_pid": ["COUNT", "SUM", "PRIVACY_ID_COUNT"],
    "mean": ["MEAN", "COUNT", "SUM"],
    "variance": ["VARIANCE", "MEAN", "COUNT", "SUM"],
}
SELECTIONS = [None, "TRUNCATED_GEOMETRIC", "LAPLACE_THRESHOLDING",
              "GAUSSIAN_THRESHOLDING"]


@pytest.mark.parametrize("metrics", sorted(METRIC_SETS))
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("selection", SELECTIONS,
                         ids=["public", "geometric", "laplace_thr",
                              "gaussian_thr"])
def test_noisy_release_matches_tpu_backend(metrics, noise, selection):
    rows = random_rows(7)
    params = dict(metrics=METRIC_SETS[metrics], noise_kind=noise,
                  max_partitions_contributed=3,
                  max_contributions_per_partition=2, min_value=0.0,
                  max_value=5.0)
    public = None
    if selection is None:
        public = [f"p{i}" for i in range(20)]  # 4 of them empty
    else:
        params["partition_selection_strategy"] = selection
    got = assert_same_release(rows, params, public=public, eps=3.0,
                              delta=1e-6)
    if selection is not None:
        # Selection keeps the big partitions and drops the small ones.
        assert 0 < len(got) < len({r[1] for r in rows})


def test_huge_epsilon_release_is_exact():
    rows = random_rows(3, 800)
    users = {}
    for u, p, _ in rows:
        users.setdefault(u, {}).setdefault(p, 0)
        users[u][p] += 1
    l0 = max(len(v) for v in users.values())
    linf = max(c for v in users.values() for c in v.values())
    params = dict(metrics=["COUNT", "SUM", "PRIVACY_ID_COUNT"],
                  noise_kind="LAPLACE", max_partitions_contributed=l0,
                  max_contributions_per_partition=linf, min_value=-1.0,
                  max_value=6.0)
    public = sorted({r[1] for r in rows})
    got, _ = run(tdp, rows, params, public=public, eps=1e9)
    for p in public:
        mine = [r for r in rows if r[1] == p]
        assert got[p].count == pytest.approx(len(mine), abs=1e-2)
        assert got[p].sum == pytest.approx(sum(r[2] for r in mine), abs=1e-2)
        assert got[p].privacy_id_count == pytest.approx(
            len({r[0] for r in mine}), abs=1e-2)


def test_max_contributions_total_bound():
    # tests/test_dp_engine.py::test_max_contributions_total_bound.
    rows = [("u1", "A", 1.0)] * 6 + [("u1", "B", 1.0)] * 6
    got = assert_same_release(rows, dict(metrics=["COUNT"],
                                         max_contributions=4),
                              public=["A", "B"])
    assert got["A"].count + got["B"].count == pytest.approx(4, abs=0.05)


MAX_CONTRIBUTIONS_METRICS = {
    "count": ["COUNT"],
    "privacy_id_count": ["PRIVACY_ID_COUNT"],
    "sum": ["SUM"],
    "mean": ["MEAN", "COUNT", "SUM"],
}


@pytest.mark.parametrize("metrics", sorted(MAX_CONTRIBUTIONS_METRICS))
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_max_contributions_matches_tpu_backend(metrics, noise):
    rows = random_rows(9)  # ~10 rows a user: a bound of 6 bites
    params = dict(metrics=MAX_CONTRIBUTIONS_METRICS[metrics],
                  noise_kind=noise, max_contributions=6, min_value=0.0,
                  max_value=5.0)
    assert_same_release(rows, params, public=[f"p{i}" for i in range(20)],
                        eps=3.0, delta=1e-6)


def test_max_contributions_at_huge_epsilon_is_exact():
    rows = random_rows(4, 600)
    per_user = {}
    for u, _, _ in rows:
        per_user[u] = per_user.get(u, 0) + 1
    params = dict(metrics=["COUNT", "SUM", "PRIVACY_ID_COUNT"],
                  noise_kind="LAPLACE",
                  max_contributions=max(per_user.values()), min_value=-1.0,
                  max_value=6.0)
    public = sorted({r[1] for r in rows})
    got = assert_same_release(rows, params, public=public, eps=1e9)
    for p in public:
        mine = [r for r in rows if r[1] == p]
        assert got[p].count == pytest.approx(len(mine), abs=1e-2)
        assert got[p].sum == pytest.approx(sum(r[2] for r in mine), abs=1e-2)
        assert got[p].privacy_id_count == pytest.approx(
            len({r[0] for r in mine}), abs=1e-2)


def test_max_contributions_with_private_selection_is_refused():
    # The JAX package fails here with a TypeError (its selection reads the
    # unset max_partitions_contributed); the port refuses up front.
    params = dict(metrics=["COUNT"], max_contributions=3)
    with pytest.raises(TypeError):
        run(pdp, SIMPLE_ROWS, params)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 3"):
        run(tdp, SIMPLE_ROWS, params)


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_max_contributions_variance_raises_as_in_jax(mod):
    with pytest.raises(NotImplementedError,
                       match="max_contributions is not supported"):
        run(mod, SIMPLE_ROWS, dict(metrics=["VARIANCE"], max_contributions=3,
                                   min_value=0.0, max_value=5.0),
            public=["A"])


@pytest.mark.parametrize("public", [True, False], ids=["public", "private"])
def test_pre_encoded_columns_carried_across(public):
    # The JAX package's encoded columns, carried across by
    # convert.encoded_data, release what the JAX package releases from them.
    rows = random_rows(5)
    vocab = sorted({r[1] for r in rows}) if public else None
    encoded = jax_columnar.encode_columns([r[0] for r in rows],
                                          [r[1] for r in rows],
                                          [r[2] for r in rows], vocab)
    ported = convert.encoded_data(encoded.pid, encoded.pk, encoded.values,
                                  encoded.partition_vocab,
                                  encoded.n_privacy_ids,
                                  encoded.public_encoded)
    params = dict(metrics=["COUNT", "MEAN"], noise_kind="GAUSSIAN",
                  max_partitions_contributed=2,
                  max_contributions_per_partition=2, min_value=0.0,
                  max_value=5.0)
    want, want_report = run(pdp, encoded, params, public=vocab, eps=3.0,
                            delta=1e-6, extractors={})
    got, got_report = run(tdp, ported, params, public=vocab, eps=3.0,
                          delta=1e-6, extractors={})
    assert want and set(got) == set(want)
    for key, metrics in want.items():
        for a, b in zip(got[key], metrics):
            assert abs(a - b) <= 1e-9 * max(1.0, abs(b))
    assert got_report == want_report


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_budget_misuse_raises_as_in_jax(mod):
    backend = (pdp.TPUBackend(noise_seed=1) if mod is pdp else
               tdp.TorchBackend(device="cpu", noise_seed=1))
    extractors = mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                    partition_extractor=lambda r: r[1],
                                    value_extractor=lambda r: r[2])
    params = mod.AggregateParams(metrics=[mod.Metrics.COUNT],
                                 max_partitions_contributed=1,
                                 max_contributions_per_partition=1)
    # Reading the release before compute_budgets().
    acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    result = mod.DPEngine(acc, backend).aggregate(SIMPLE_ROWS, params,
                                                  extractors, ["A"])
    with pytest.raises(AssertionError, match="not calculated yet"):
        list(result)
    # Requesting budget after compute_budgets().
    acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = mod.DPEngine(acc, backend)
    engine.aggregate(SIMPLE_ROWS, params, extractors, ["A"])
    acc.compute_budgets()
    with pytest.raises(Exception, match="after compute_budgets"):
        engine.aggregate(SIMPLE_ROWS, params, extractors, ["A"])
    with pytest.raises(Exception, match="can not be called twice"):
        acc.compute_budgets()
    # Gaussian noise without delta.
    acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=0.0)
    gauss = mod.AggregateParams(metrics=[mod.Metrics.COUNT],
                                noise_kind=mod.NoiseKind.GAUSSIAN,
                                max_partitions_contributed=1,
                                max_contributions_per_partition=1)
    with pytest.raises(ValueError, match="delta is greater than 0"):
        mod.DPEngine(acc, backend).aggregate(SIMPLE_ROWS, gauss, extractors,
                                             ["A"])
    with pytest.raises(ValueError, match="non-empty"):
        mod.DPEngine(acc, backend).aggregate([], params, extractors)


OUT_OF_SCOPE = {
    "max_contributions": dict(metrics=[tdp.Metrics.COUNT],
                              max_contributions=3),
    # The JAX package takes this pair off its columnar path.
    "vector_sum_with_percentile": dict(
        metrics=[tdp.Metrics.VECTOR_SUM, tdp.Metrics.PERCENTILE(50)],
        max_partitions_contributed=1, max_contributions_per_partition=1,
        vector_size=2, vector_max_norm=1.0,
        vector_norm_kind=tdp.NormKind.L2),
    "custom_combiners": dict(metrics=[],
                             max_partitions_contributed=1,
                             max_contributions_per_partition=1,
                             custom_combiners=[object()]),
}


@pytest.mark.parametrize("name", sorted(OUT_OF_SCOPE))
def test_out_of_scope_params_raise_not_implemented(name):
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = tdp.DPEngine(acc, tdp.TorchBackend(device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.aggregate(SIMPLE_ROWS, tdp.AggregateParams(**OUT_OF_SCOPE[name]),
                         tdp.DataExtractors(lambda r: r[0], lambda r: r[1],
                                            lambda r: r[2]))


@pytest.mark.parametrize("metric", ["PERCENTILE", "VECTOR_SUM"])
@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_max_contributions_new_metrics_raise_as_in_jax(mod, metric):
    if metric == "PERCENTILE":
        params = mod.AggregateParams(metrics=[mod.Metrics.PERCENTILE(50)],
                                     max_contributions=3, min_value=0.0,
                                     max_value=5.0)
    else:
        params = mod.AggregateParams(metrics=[mod.Metrics.VECTOR_SUM],
                                     max_contributions=3, vector_size=1,
                                     vector_max_norm=1.0,
                                     vector_norm_kind=mod.NormKind.L2)
    acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    backend = (pdp.TPUBackend(noise_seed=1) if mod is pdp else
               tdp.TorchBackend(device="cpu", noise_seed=1))
    with pytest.raises(NotImplementedError,
                       match="max_contributions is not supported"):
        mod.DPEngine(acc, backend).aggregate(
            SIMPLE_ROWS, params,
            mod.DataExtractors(lambda r: r[0], lambda r: r[1],
                               lambda r: r[2]), ["A"])


def test_release_sentinel_gates_2d_columns_by_rows():
    # A vector column's row belongs to its partition: a NaN in a dropped
    # partition's row trips nothing, in a kept one it trips NaN.
    col = torch.tensor([[1.0, 2.0], [float("nan"), 0.0], [3.0, float("inf")]],
                       dtype=torch.float64)
    keep = torch.tensor([True, False, False])
    assert numeric.column_flags(col, keep) == 0
    keep = torch.tensor([True, True, False])
    assert numeric.column_flags(col, keep) == numeric.FLAG_NAN
    assert numeric.flags_from_kept({"v": col}, 3) == (
        numeric.FLAG_NAN | numeric.FLAG_INF)
    for n_kept in range(4):
        assert numeric.flags_from_kept({"v": col}, n_kept) == int(
            jax_numeric._flags_from_kept({"v": jnp.asarray(col.numpy())},
                                         jnp.asarray(n_kept)))


def test_out_of_scope_backend_options_and_large_p_raise():
    # secure_noise and numeric_mode="safe" are ported: accepted, kept on
    # the backend and validated as TPUBackend validates them.
    backend = tdp.TorchBackend(device="cpu", secure_noise=True,
                               numeric_mode="safe", snap_grid_bits=-3)
    assert (backend.secure_noise, backend.numeric_mode,
            backend.snap_grid_bits) == (True, "safe", -3)
    for kwargs in (dict(numeric_mode="exact"), dict(snap_grid_bits=0.5)):
        with pytest.raises(ValueError, match="TorchBackend"):
            tdp.TorchBackend(device="cpu", **kwargs)
    # Above large_partition_threshold the blocked large-P route runs (it
    # raised NotImplementedError before the route was ported): the same
    # release as TPUBackend's blocked route, no refusal.
    released = []
    for mod, backend in (
            (tdp, tdp.TorchBackend(device="cpu", noise_seed=SEED,
                                   dtype=torch.float64,
                                   large_partition_threshold=1)),
            (pdp, pdp.TPUBackend(noise_seed=SEED,
                                 large_partition_threshold=1))):
        acc = mod.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        result = mod.DPEngine(acc, backend).aggregate(
            SIMPLE_ROWS, mod.AggregateParams(
                metrics=[mod.Metrics.COUNT], max_partitions_contributed=1,
                max_contributions_per_partition=1),
            mod.DataExtractors(lambda r: r[0], lambda r: r[1]), ["A", "B"])
        acc.compute_budgets()
        released.append(dict(result))
    got, want = released
    assert set(got) == set(want) == {"A", "B"}
    for key in want:
        assert abs(got[key].count - want[key].count) <= 1e-9 * max(
            1.0, abs(want[key].count))
