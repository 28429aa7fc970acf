"""Parameter tuning from dataset histograms + utility analysis.

Capability parity with the reference ``analysis/parameter_tuning.py``:
candidate bounds generated from contribution histograms, a utility-analysis
sweep over every candidate, and argmin-RMSE selection. Re-designed around
numpy grid construction (geomspace / CDF-quantile subsampling / meshgrid
cross products) instead of per-candidate accumulation loops, and the sweep
itself runs through the dense analysis path on local backends
(``analysis/kernels.sweep_kernel``: C19 / C20 on the card).

Port of pipelinedp_tpu/analysis/parameter_tuning.py; it reads the port's
dataset_histograms.histograms.
"""

import dataclasses
import logging
import math
from dataclasses import dataclass
from enum import Enum
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import data_extractors as extractors
from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch.dataset_histograms import histograms
from pipelinedp_tpu_torch.analysis import data_structures
from pipelinedp_tpu_torch.analysis import metrics
from pipelinedp_tpu_torch.analysis import utility_analysis


class MinimizingFunction(Enum):
    ABSOLUTE_ERROR = 'absolute_error'
    RELATIVE_ERROR = 'relative_error'


@dataclass
class ParametersToTune:
    """Which parameters to tune."""
    max_partitions_contributed: bool = False
    max_contributions_per_partition: bool = False
    min_sum_per_partition: bool = False
    max_sum_per_partition: bool = False

    def __post_init__(self):
        if not any(dataclasses.asdict(self).values()):
            raise ValueError("ParametersToTune must have at least 1 parameter "
                             "to tune.")


@dataclass
class TuneOptions:
    """Options for the tuning process.

    Attributes not being tuned are taken from aggregate_params
    (reference ``parameter_tuning.py:52-89``).
    """
    epsilon: float
    delta: float
    aggregate_params: agg.AggregateParams
    function_to_minimize: Union[MinimizingFunction, Callable]
    parameters_to_tune: ParametersToTune
    partitions_sampling_prob: float = 1
    pre_aggregated_data: bool = False
    number_of_parameter_candidates: int = 100

    def __post_init__(self):
        input_validators.validate_epsilon_delta(self.epsilon, self.delta,
                                                "TuneOptions")


@dataclass
class TuneResult:
    """Tuning results (reference ``parameter_tuning.py:92-112``)."""
    options: TuneOptions
    contribution_histograms: histograms.DatasetHistograms
    utility_analysis_parameters: 'data_structures.MultiParameterConfiguration'
    index_best: int
    utility_reports: List[metrics.UtilityReport]


# ---------------------------------------------------------------------------
# Candidate grids.
# ---------------------------------------------------------------------------


def geometric_candidates(max_value: int, n: int) -> List[int]:
    """<= n integer candidates covering [1, max_value] at near-constant ratio.

    Built as a deduplicated ceil(geomspace) — always contains 1 and
    max_value. Replaces the reference's accumulate-and-round loop
    (``parameter_tuning.py:236-264``) with one vectorized construction.
    """
    max_value = max(int(max_value), 1)
    n = max(1, min(n, max_value))
    if n == 1 or max_value == 1:
        return [1]
    grid = np.unique(
        np.ceil(np.geomspace(1.0, float(max_value),
                             num=n)).astype(np.int64).clip(1, max_value))
    return grid.tolist()


def quantile_candidates(histogram: histograms.Histogram,
                        n: int) -> List[float]:
    """<= n float candidates at evenly spaced mass quantiles of a histogram.

    Uses each selected bin's max value, so candidates are attainable bounds;
    the distribution's maximum is always included. Mass-quantile spacing
    (instead of the reference's even bin-index subsampling,
    ``parameter_tuning.py:267-275``) concentrates candidates where the data
    actually lives.
    """
    counts = np.fromiter((b.count for b in histogram.bins),
                         dtype=np.float64,
                         count=len(histogram.bins))
    maxes = np.fromiter((b.max for b in histogram.bins),
                        dtype=np.float64,
                        count=len(histogram.bins))
    n = max(1, min(n, len(maxes)))
    cum = np.cumsum(counts)
    targets = np.linspace(0.0, 1.0, num=n) * cum[-1]
    ids = np.minimum(np.searchsorted(cum, targets, side="left"),
                     len(maxes) - 1)
    values = np.unique(maxes[ids])
    if values[-1] != maxes[-1]:
        values = np.append(values, maxes[-1])
    return values.tolist()


def cross_product_candidates(
        gen1: Callable[[int], Sequence], gen2: Callable[[int], Sequence],
        budget: int) -> Tuple[List, List]:
    """2-D candidate grid under a total-candidate budget.

    Each axis starts with sqrt(budget) candidates; if one distribution
    saturates early (fewer distinct values than asked), the spare budget is
    re-spent on the other axis. The cross product is flattened via meshgrid.
    """
    per_axis = max(1, math.isqrt(budget))
    c1, c2 = gen1(per_axis), gen2(per_axis)
    if len(c1) < per_axis:
        c2 = gen2(max(1, budget // len(c1)))
    elif len(c2) < per_axis:
        c1 = gen1(max(1, budget // len(c2)))
    g1, g2 = np.meshgrid(np.asarray(c1), np.asarray(c2), indexing="ij")
    return g1.ravel().tolist(), g2.ravel().tolist()


def _find_candidate_parameters(
        hist: histograms.DatasetHistograms,
        parameters_to_tune: ParametersToTune, metric: Optional[agg.Metric],
        max_candidates: int) -> 'data_structures.MultiParameterConfiguration':
    """Candidate bounds for l0 / linf / max_sum_per_partition."""
    tune_l0 = parameters_to_tune.max_partitions_contributed
    tune_linf = (parameters_to_tune.max_contributions_per_partition and
                 metric == agg.Metrics.COUNT)
    tune_sum = (parameters_to_tune.max_sum_per_partition and
                metric == agg.Metrics.SUM)
    if tune_sum and hist.linf_sum_contributions_histogram.bins and (
            hist.linf_sum_contributions_histogram.bins[0].lower < 0):
        logging.warning(
            "max_sum_per_partition candidates might be negative; "
            "min_sum_per_partition tuning is not supported yet, so "
            "max_sum_per_partition tuning works best when "
            "linf_sum_contributions_histogram has no negative sums")

    gen_l0 = lambda n: geometric_candidates(
        hist.l0_contributions_histogram.max_value(), n)
    gen_linf = lambda n: geometric_candidates(
        hist.linf_contributions_histogram.max_value(), n)
    gen_sum = lambda n: quantile_candidates(
        hist.linf_sum_contributions_histogram, n)

    l0 = linf = sum_max = sum_min = None
    if tune_l0 and tune_linf:
        l0, linf = cross_product_candidates(gen_l0, gen_linf, max_candidates)
    elif tune_l0 and tune_sum:
        l0, sum_max = cross_product_candidates(gen_l0, gen_sum,
                                               max_candidates)
    elif tune_l0:
        l0 = gen_l0(max_candidates)
    elif tune_linf:
        linf = gen_linf(max_candidates)
    elif tune_sum:
        sum_max = gen_sum(max_candidates)
    else:
        raise ValueError("Nothing to tune.")
    if sum_max is not None:
        sum_min = [0.0] * len(sum_max)
    return data_structures.MultiParameterConfiguration(
        max_partitions_contributed=l0,
        max_contributions_per_partition=linf,
        min_sum_per_partition=sum_min,
        max_sum_per_partition=sum_max)


# ---------------------------------------------------------------------------
# Tuning driver.
# ---------------------------------------------------------------------------


def tune(col,
         backend: pipeline_backend.PipelineBackend,
         contribution_histograms: histograms.DatasetHistograms,
         options: TuneOptions,
         data_extractors: Union[extractors.DataExtractors,
                                extractors.PreAggregateExtractors],
         public_partitions=None):
    """Tunes parameters: candidate grid -> utility sweep -> argmin RMSE.

    For tuning select_partitions set options.aggregate_params.metrics = [].

    Returns:
        (1-element collection with TuneResult, collection of per-partition
        utility results).
    """
    _check_tune_args(options, public_partitions is not None)
    metric = (options.aggregate_params.metrics[0]
              if options.aggregate_params.metrics else None)
    candidates = _find_candidate_parameters(
        contribution_histograms, options.parameters_to_tune, metric,
        options.number_of_parameter_candidates)
    analysis_options = data_structures.UtilityAnalysisOptions(
        epsilon=options.epsilon,
        delta=options.delta,
        aggregate_params=options.aggregate_params,
        multi_param_configuration=candidates,
        partitions_sampling_prob=options.partitions_sampling_prob,
        pre_aggregated_data=options.pre_aggregated_data)
    reports, per_partition = utility_analysis.perform_utility_analysis(
        col, backend, analysis_options, data_extractors, public_partitions)
    reports_list = backend.to_list(reports, "Collect utility reports")
    result = backend.map(
        reports_list, lambda rs: _to_tune_result(
            list(rs), options, candidates, contribution_histograms),
        "To TuneResult")
    return result, per_partition


def _to_tune_result(
        reports: List[metrics.UtilityReport], options: TuneOptions,
        candidates: 'data_structures.MultiParameterConfiguration',
        hist: histograms.DatasetHistograms) -> TuneResult:
    assert len(reports) == candidates.size
    reports.sort(key=lambda r: r.configuration_index)
    index_best = -1  # select-partitions analysis has no RMSE to rank
    if options.aggregate_params.metrics:
        index_best = int(
            np.argmin([
                r.metric_errors[0].absolute_error.rmse for r in reports
            ]))
    return TuneResult(options, hist, candidates, index_best, reports)


def _check_tune_args(options: TuneOptions, is_public_partitions: bool):
    tune_metrics = options.aggregate_params.metrics
    if not tune_metrics:
        # Empty metrics means tuning for select_partitions.
        if is_public_partitions:
            raise ValueError("Empty metrics means tuning of partition "
                             "selection but public partitions were provided.")
    elif len(tune_metrics) > 1:
        raise ValueError(
            f"Tuning supports only one metric, but {tune_metrics} given.")
    elif tune_metrics[0] not in [
            agg.Metrics.COUNT, agg.Metrics.PRIVACY_ID_COUNT, agg.Metrics.SUM
    ]:
        raise ValueError("Tuning is supported only for Count, Privacy id "
                         f"count and Sum, but {tune_metrics[0]} given.")
    if options.parameters_to_tune.min_sum_per_partition:
        raise ValueError(
            "Tuning of min_sum_per_partition is not supported yet.")
    if options.function_to_minimize != MinimizingFunction.ABSOLUTE_ERROR:
        raise NotImplementedError(
            f"Only {MinimizingFunction.ABSOLUTE_ERROR} is implemented.")
