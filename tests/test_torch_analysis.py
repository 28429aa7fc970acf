"""Utility analysis and parameter tuning on the port's TorchBackend (CPU,
float64: the sweep through C5, C10 and the plain versions of C19 / C20)
against the JAX package on LocalBackend(), with the cases of
tests/test_analysis.py TestUtilityAnalysisE2E and TestParameterTuning;
the host modules of the analysis package; the compose_plds default.

Bounds stated here:
  * reports: every field of every UtilityReport (its partitions info,
    metric errors and size-bucket histogram) within 1e-9 relative (+1e-12
    absolute), counts and enums equal; the same number of reports and of
    histogram bins.
  * per-partition metrics: the same (partition key, configuration) keys in
    the same order, raw statistics equal, every other field within 1e-9.
  * tuning: the same candidates, the same index_best, reports as above.
  * host modules (preaggregate, dataset summary, Poisson binomial,
    probability computations, candidate grids): equal.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import analysis as jax_analysis
from pipelinedp_tpu import aggregate_params as jax_agg
from pipelinedp_tpu.accounting import compose as jax_compose
from pipelinedp_tpu.accounting import pld as jax_pld
from pipelinedp_tpu.analysis import data_structures as jax_ds
from pipelinedp_tpu.analysis import parameter_tuning as jax_pt
from pipelinedp_tpu.analysis import poisson_binomial as jax_pb
from pipelinedp_tpu.analysis import probability_computations as jax_pc
from pipelinedp_tpu.dataset_histograms import computing_histograms as jax_ch
from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import analysis
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch.accounting import compose
from pipelinedp_tpu_torch.accounting import pld
from pipelinedp_tpu_torch.analysis import data_structures as ds
from pipelinedp_tpu_torch.analysis import parameter_tuning as pt
from pipelinedp_tpu_torch.analysis import poisson_binomial as pb
from pipelinedp_tpu_torch.analysis import probability_computations as pc
from pipelinedp_tpu_torch.dataset_histograms import computing_histograms as ch

pytestmark = pytest.mark.torch_port

# tests/test_analysis.py's DATA and EXTRACTORS.
DATA = [(uid, f"pk{uid % 3}", 1.0 + (uid % 5)) for uid in range(30)
        for _ in range(1 + uid % 2)]
# A wider set: 120 ids over 9 partitions, some contributing to several.
WIDE = [(uid, f"pk{(uid * 7 + j) % 9}", float((uid + j) % 6))
        for uid in range(120) for j in range(1 + uid % 4)]
PUBLIC = ["pk0", "pk1", "pk2"]


def extractors(mod):
    return mod.DataExtractors(privacy_id_extractor=lambda x: x[0],
                              partition_extractor=lambda x: x[1],
                              value_extractor=lambda x: x[2])


def port_backend():
    return tdp.TorchBackend(device="cpu", dtype=torch.float64)


def params(metrics=("COUNT",), **kwargs):
    fields = dict(noise_kind="GAUSSIAN", metrics=list(metrics),
                  max_partitions_contributed=1,
                  max_contributions_per_partition=1)
    if "SUM" in metrics:
        fields.update(min_sum_per_partition=0.0, max_sum_per_partition=5.0)
    fields.update(kwargs)
    return fields


def both_options(**kw):
    return (convert.utility_analysis_options(jax_agg, jax_ds, **kw),
            convert.utility_analysis_options(agg, ds, **kw))


def leaves(obj, path="r"):
    """(path, value) of every leaf of a result dataclass: enums by name."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, (list, tuple)):
        yield (f"{path}#len", len(obj))
        for i, x in enumerate(obj):
            yield from leaves(x, f"{path}[{i}]")
    elif isinstance(obj, enum.Enum):
        yield (path, obj.name)
    else:
        yield (path, obj)


def assert_same_result(got, want, rtol=1e-9):
    g, w = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, float) and not isinstance(b, bool):
            assert a == pytest.approx(b, rel=rtol, abs=1e-12), path
        else:
            assert a == b, path


def run_analysis(options_kw, data=DATA, public=None, pre_extract=False):
    jax_opts, port_opts = both_options(**options_kw)
    if pre_extract:
        jax_data = list(jax_analysis.preaggregate(data, pdp.LocalBackend(),
                                                  extractors(pdp)))
        port_data = list(analysis.preaggregate(data, port_backend(),
                                               extractors(tdp)))
        assert port_data == jax_data
        jax_ext = pdp.PreAggregateExtractors(lambda r: r[0], lambda r: r[1])
        port_ext = tdp.PreAggregateExtractors(lambda r: r[0], lambda r: r[1])
    else:
        jax_data = port_data = data
        jax_ext, port_ext = extractors(pdp), extractors(tdp)
    want_reports, want_pp = jax_analysis.perform_utility_analysis(
        jax_data, pdp.LocalBackend(), jax_opts, jax_ext,
        public_partitions=public)
    got_reports, got_pp = analysis.perform_utility_analysis(
        port_data, port_backend(), port_opts, port_ext,
        public_partitions=public)
    want_reports, got_reports = list(want_reports), list(got_reports)
    assert len(got_reports) == len(want_reports) == port_opts.n_configurations
    for g, w in zip(got_reports, want_reports):
        assert_same_result(g, w)
    want_pp, got_pp = list(want_pp), list(got_pp)
    assert [k for k, _ in got_pp] == [k for k, _ in want_pp]
    for (_, g), (_, w) in zip(got_pp, want_pp):
        assert_same_result(g, w)
    return got_reports, got_pp


ANALYSIS_CASES = {
    # TestUtilityAnalysisE2E
    "public_single_config": (dict(
        epsilon=1e3, delta=1e-5,
        params=params(max_partitions_contributed=10,
                      max_contributions_per_partition=10)), PUBLIC, DATA),
    "empty_public_partition": (dict(epsilon=1e3, delta=1e-5,
                                    params=params()),
                               PUBLIC + ["pk_unused"], DATA),
    "private_multi_config": (dict(
        epsilon=10, delta=1e-5, params=params(),
        multi=dict(max_partitions_contributed=[1, 5],
                   max_contributions_per_partition=[1, 5])), None, DATA),
    "strategy_sweep": (dict(
        epsilon=10, delta=1e-5, params=params(),
        multi=dict(partition_selection_strategy=[
            "TRUNCATED_GEOMETRIC", "GAUSSIAN_THRESHOLDING",
            "LAPLACE_THRESHOLDING"])), None, DATA),
    "sum_public": (dict(epsilon=1e3, delta=1e-5,
                        params=params(["SUM"],
                                      max_partitions_contributed=10)),
                   PUBLIC, DATA),
    "select_partitions": (dict(epsilon=1e3, delta=1e-5,
                               params=params([])), None, DATA),
    # Wider: several metrics, pre_threshold, Laplace noise, sampling.
    "wide_private_three_metrics": (dict(
        epsilon=2.0, delta=1e-6,
        params=params(["SUM", "COUNT", "PRIVACY_ID_COUNT"],
                      max_partitions_contributed=2,
                      max_contributions_per_partition=2, pre_threshold=2),
        multi=dict(max_partitions_contributed=[1, 2, 3, 4],
                   max_contributions_per_partition=[1, 2, 1, 3],
                   min_sum_per_partition=[0.0, 0.0, 1.0, 0.0],
                   max_sum_per_partition=[5.0, 3.0, 4.0, 9.0])), None,
                                   WIDE),
    "wide_public_laplace": (dict(
        epsilon=1.0, delta=1e-6,
        params=params(["COUNT", "PRIVACY_ID_COUNT"], noise_kind="LAPLACE",
                      max_partitions_contributed=3)),
                            [f"pk{i}" for i in range(0, 12, 2)], WIDE),
    "partitions_sampling": (dict(
        epsilon=1.0, delta=1e-6, params=params(["COUNT"]),
        multi=dict(max_partitions_contributed=[1, 3]),
        partitions_sampling_prob=0.5), None, WIDE),
}


@pytest.mark.parametrize("name", sorted(ANALYSIS_CASES))
def test_utility_analysis_matches_jax(name):
    options_kw, public, data = ANALYSIS_CASES[name]
    reports, per_partition = run_analysis(options_kw, data, public)
    if name == "empty_public_partition":
        assert reports[0].partitions_info.num_empty_partitions == 1
        assert len(per_partition) == 4
    if name == "select_partitions":
        assert reports[0].metric_errors is None
    if name == "partitions_sampling":
        assert reports[0].partitions_info.num_dataset_partitions < 9


def test_pre_aggregated_analysis_matches_jax():
    options_kw = dict(epsilon=1e3, delta=1e-5,
                      params=params(max_partitions_contributed=10,
                                    max_contributions_per_partition=10),
                      pre_aggregated_data=True)
    reports, _ = run_analysis(options_kw, DATA, PUBLIC, pre_extract=True)
    raw_kw = dict(options_kw, pre_aggregated_data=False)
    raw, _ = run_analysis(raw_kw, DATA, PUBLIC)
    assert reports[0].metric_errors[0].absolute_error.rmse == pytest.approx(
        raw[0].metric_errors[0].absolute_error.rmse)


def histograms_both(data):
    jax_hist = list(jax_ch.compute_dataset_histograms(
        data, extractors(pdp), pdp.LocalBackend()))[0]
    keys = {pk: i for i, pk in enumerate(sorted({r[1] for r in data}))}
    port_hist = ch.compute_dataset_histograms_columnar(
        np.array([r[0] for r in data]), np.array([keys[r[1]] for r in data]),
        np.array([r[2] for r in data]))
    # The histograms the candidates come from agree.
    assert convert.histograms_fields(port_hist)[:3] == \
        convert.histograms_fields(jax_hist)[:3]
    return jax_hist, port_hist


TUNE_CASES = {
    "count_public": (dict(
        epsilon=10, delta=1e-5, params=params(),
        parameters_to_tune=dict(max_partitions_contributed=True,
                                max_contributions_per_partition=True),
        number_of_parameter_candidates=9), PUBLIC, DATA),
    "select_partitions": (dict(
        epsilon=10, delta=1e-5, params=params([]),
        parameters_to_tune=dict(max_partitions_contributed=True),
        number_of_parameter_candidates=4), None, DATA),
    "count_private_wide": (dict(
        epsilon=1.0, delta=1e-6, params=params(),
        parameters_to_tune=dict(max_partitions_contributed=True,
                                max_contributions_per_partition=True),
        number_of_parameter_candidates=16), None, WIDE),
    "privacy_id_count_sampled": (dict(
        epsilon=1.0, delta=1e-6, params=params(["PRIVACY_ID_COUNT"]),
        parameters_to_tune=dict(max_partitions_contributed=True),
        number_of_parameter_candidates=5, partitions_sampling_prob=0.7),
                                 None, WIDE),
}


@pytest.mark.parametrize("name", sorted(TUNE_CASES))
def test_tune_matches_jax(name):
    kw, public, data = TUNE_CASES[name]
    jax_hist, port_hist = histograms_both(data)
    jax_opts = convert.tune_options(jax_agg, jax_pt, **kw)
    port_opts = convert.tune_options(agg, pt, **kw)
    want_col, want_pp = jax_pt.tune(data, pdp.LocalBackend(), jax_hist,
                                    jax_opts, extractors(pdp),
                                    public_partitions=public)
    got_col, got_pp = pt.tune(data, port_backend(), port_hist, port_opts,
                              extractors(tdp), public_partitions=public)
    want, got = list(want_col)[0], list(got_col)[0]
    assert isinstance(got, pt.TuneResult)
    assert got.index_best == want.index_best
    assert_same_result(got.utility_analysis_parameters,
                       want.utility_analysis_parameters)
    assert len(got.utility_reports) == len(want.utility_reports)
    for g, w in zip(got.utility_reports, want.utility_reports):
        assert_same_result(g, w)
    assert len(list(got_pp)) == len(list(want_pp))
    if name == "select_partitions":
        assert got.index_best == -1


def test_candidate_grids_as_jax():
    assert pt.geometric_candidates(100, 5) == \
        jax_pt.geometric_candidates(100, 5)
    for args in ((1, 10), (5, 1), (3, 100), (7135, 64)):
        assert pt.geometric_candidates(*args) == \
            jax_pt.geometric_candidates(*args)
    jax_hist, port_hist = histograms_both(WIDE)
    assert pt.quantile_candidates(port_hist.linf_sum_contributions_histogram,
                                  4) == jax_pt.quantile_candidates(
        jax_hist.linf_sum_contributions_histogram, 4)
    assert pt.cross_product_candidates(
        lambda n: pt.geometric_candidates(1, n),
        lambda n: pt.geometric_candidates(10**6, n), 9) == \
        jax_pt.cross_product_candidates(
            lambda n: jax_pt.geometric_candidates(1, n),
            lambda n: jax_pt.geometric_candidates(10**6, n), 9)


def test_tune_rejects_two_metrics():
    opts = convert.tune_options(
        agg, pt, epsilon=1, delta=1e-5,
        params=params(["COUNT", "PRIVACY_ID_COUNT"]),
        parameters_to_tune=dict(max_partitions_contributed=True))
    with pytest.raises(ValueError, match="only one metric"):
        pt._check_tune_args(opts, True)


def test_engine_rejects_aggregate():
    accountant = tdp.NaiveBudgetAccountant(total_epsilon=1, total_delta=1e-6)
    engine = analysis.UtilityAnalysisEngine(accountant, port_backend())
    with pytest.raises(ValueError, match="can't be called"):
        engine.aggregate(DATA, None, extractors(tdp))


def test_plain_local_backend_sweeps_on_cuda_and_raises_without(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, opts = both_options(epsilon=1.0, delta=1e-6, params=params())
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis.perform_utility_analysis(DATA, pipeline_backend.LocalBackend(),
                                          opts, extractors(tdp))


def test_other_backends_raise_naming_item_14():

    class Elsewhere(pipeline_backend.PipelineBackend):
        map = map_with_side_inputs = flat_map = map_tuple = None
        map_values = group_by_key = filter = filter_by_key = keys = None
        values = sample_fixed_per_key = count_per_element = None
        sum_per_key = combine_accumulators_per_key = reduce_per_key = None
        flatten = distinct = to_list = None

    _, opts = both_options(epsilon=1.0, delta=1e-6, params=params())
    with pytest.raises(NotImplementedError, match="item 14"):
        analysis.perform_utility_analysis(DATA, Elsewhere(), opts,
                                          extractors(tdp))


def test_dataset_summary_as_jax():
    public = ["pk0", "pk1", "pk7", "pk_none"]
    got = list(analysis.compute_public_partitions_summary(
        WIDE, port_backend(), extractors(tdp), public))[0]
    want = list(jax_analysis.compute_public_partitions_summary(
        WIDE, pdp.LocalBackend(), extractors(pdp), public))[0]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_poisson_binomial_and_probability_computations_as_jax():
    ps = [0.1, 0.5, 0.9, 0.33, 0.75]
    np.testing.assert_array_equal(pb.compute_pmf(ps).probabilities,
                                  jax_pb.compute_pmf(ps).probabilities)
    assert pb.compute_exp_std_skewness(ps) == \
        jax_pb.compute_exp_std_skewness(ps)
    got = pb.compute_pmf_approximation(40.0, 3.0, 0.1, 100)
    want = jax_pb.compute_pmf_approximation(40.0, 3.0, 0.1, 100)
    assert got.start == want.start
    np.testing.assert_array_equal(got.probabilities, want.probabilities)
    np.testing.assert_array_equal(
        pc.compute_sum_laplace_gaussian_quantiles(1.5, 2.0, [0.1, 0.9], 0),
        jax_pc.compute_sum_laplace_gaussian_quantiles(1.5, 2.0, [0.1, 0.9],
                                                      0))


def test_compose_plds_runs_on_the_card_unless_asked(monkeypatch):
    plds = [pld.from_gaussian_mechanism(1.0, 1e-3),
            pld.from_laplace_mechanism(2.0, 1e-3)]
    jax_plds = [jax_pld.from_gaussian_mechanism(1.0, 1e-3),
                jax_pld.from_laplace_mechanism(2.0, 1e-3)]
    host = compose.compose_plds(plds, [3, 2], device=False)
    want = jax_compose.compose_plds(jax_plds, [3, 2])
    np.testing.assert_array_equal(host.probs, want.probs)
    assert host._lower_index == want._lower_index
    assert host.get_epsilon_for_delta(1e-6) == \
        want.get_epsilon_for_delta(1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compose.compose_plds(plds, [3, 2])
    # The accountant reads the host path explicitly: unaffected.
    eps, _ = compose.composed_epsilon_from_records(
        [{"mechanism_kind": "MechanismType.GAUSSIAN", "eps": 1.0,
          "delta": 1e-6, "noise_std": 2.0, "count": 3}], target_delta=1e-6)
    assert eps > 0
