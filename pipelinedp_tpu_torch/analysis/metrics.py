"""Dataclasses with utility-analysis result metrics.

Capability parity with the reference ``analysis/metrics.py:23-283``.

Port of pipelinedp_tpu/analysis/metrics.py.
"""

from dataclasses import dataclass
from typing import List, Optional

from pipelinedp_tpu_torch import aggregate_params as agg


@dataclass
class SumMetrics:
    """Per-partition error breakdown for SUM/COUNT/PRIVACY_ID_COUNT analysis.

    Invariant (reference ``metrics.py:48-51``):
    E(sum_after_contribution_bounding) = sum + E(error), with
    E(error) = clipping_to_min_error + clipping_to_max_error +
               expected_l0_bounding_error.
    """
    aggregation: agg.Metric
    sum: float
    clipping_to_min_error: float
    clipping_to_max_error: float
    expected_l0_bounding_error: float
    std_l0_bounding_error: float
    std_noise: float
    noise_kind: agg.NoiseKind


@dataclass
class RawStatistics:
    """Raw (non-DP) per-partition statistics."""
    privacy_id_count: int
    count: int


@dataclass
class PerPartitionMetrics:
    partition_selection_probability_to_keep: float
    raw_statistics: RawStatistics
    metric_errors: Optional[List[SumMetrics]] = None


@dataclass
class MeanVariance:
    mean: float
    var: float


@dataclass
class ContributionBoundingErrors:
    """Error breakdown by contribution-bounding type (reference ``:82-103``)."""
    l0: MeanVariance
    linf_min: float
    linf_max: float

    def to_relative(self, value: float) -> 'ContributionBoundingErrors':
        l0_rel = MeanVariance(self.l0.mean / value, self.l0.var / value**2)
        return ContributionBoundingErrors(l0=l0_rel,
                                          linf_min=self.linf_min / value,
                                          linf_max=self.linf_max / value)


@dataclass
class ValueErrors:
    """Errors between actual and DP value, averaged across partitions.

    rmse_with_dropped_partitions folds in partition-selection drop:
    p*rmse + (1-p)*|actual| (reference ``:107-169``).
    """
    bounding_errors: ContributionBoundingErrors
    mean: float
    variance: float
    rmse: float
    l1: float
    rmse_with_dropped_partitions: float
    l1_with_dropped_partitions: float

    def to_relative(self, value: float) -> 'ValueErrors':
        if value == 0:
            # Relative error undefined at 0; contribute 0 to the aggregate.
            empty_bounding = ContributionBoundingErrors(l0=MeanVariance(0, 0),
                                                        linf_min=0,
                                                        linf_max=0)
            return ValueErrors(bounding_errors=empty_bounding,
                               mean=0,
                               variance=0,
                               rmse=0,
                               l1=0,
                               rmse_with_dropped_partitions=0,
                               l1_with_dropped_partitions=0)
        return ValueErrors(
            self.bounding_errors.to_relative(value),
            mean=self.mean / value,
            variance=self.variance / value**2,
            rmse=self.rmse / value,
            l1=self.l1 / value,
            rmse_with_dropped_partitions=(self.rmse_with_dropped_partitions /
                                          value),
            l1_with_dropped_partitions=(self.l1_with_dropped_partitions /
                                        value))


@dataclass
class DataDropInfo:
    """Ratio of data dropped per DP stage (reference ``:173-188``)."""
    l0: float
    linf: float
    partition_selection: float


@dataclass
class MetricUtility:
    """Cross-partition utility for one DP metric (reference ``:192-216``)."""
    metric: agg.Metric
    noise_std: float
    noise_kind: agg.NoiseKind
    ratio_data_dropped: Optional[DataDropInfo]
    absolute_error: ValueErrors
    relative_error: ValueErrors


@dataclass
class PartitionsInfo:
    """Aggregate partition-selection metrics (reference ``:220-245``)."""
    public_partitions: bool
    num_dataset_partitions: int
    num_non_public_partitions: Optional[int] = None
    num_empty_partitions: Optional[int] = None
    strategy: Optional[agg.PartitionSelectionStrategy] = None
    kept_partitions: Optional[MeanVariance] = None


@dataclass
class UtilityReport:
    """Utility-analysis result for one parameter configuration."""
    configuration_index: int
    partitions_info: PartitionsInfo
    metric_errors: Optional[List[MetricUtility]] = None
    utility_report_histogram: Optional[List['UtilityReportBin']] = None


@dataclass
class UtilityReportBin:
    """UtilityReport for partitions of size [from, to) (reference ``:268-283``)."""
    partition_size_from: int
    partition_size_to: int
    report: UtilityReport
