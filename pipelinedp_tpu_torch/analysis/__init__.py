"""Utility analysis & parameter tuning for DP aggregations.

Port of pipelinedp_tpu/analysis/: utility analysis (closed-form
per-partition error modeling swept over many parameter configurations at
once, on C19 / C20), cross-partition report aggregation, parameter tuning,
pre-aggregation and dataset summaries, with the same exports as the JAX
package's analysis/__init__.py.
"""

from pipelinedp_tpu_torch.analysis.data_structures import (
    MultiParameterConfiguration,
    UtilityAnalysisOptions,
    get_aggregate_params,
    get_partition_selection_strategy,
)
from pipelinedp_tpu_torch.analysis.metrics import (
    ContributionBoundingErrors,
    DataDropInfo,
    MeanVariance,
    MetricUtility,
    PartitionsInfo,
    PerPartitionMetrics,
    RawStatistics,
    SumMetrics,
    UtilityReport,
    UtilityReportBin,
    ValueErrors,
)
from pipelinedp_tpu_torch.analysis.utility_analysis import perform_utility_analysis
from pipelinedp_tpu_torch.analysis.utility_analysis_engine import (
    UtilityAnalysisEngine)
from pipelinedp_tpu_torch.analysis.parameter_tuning import (
    MinimizingFunction,
    ParametersToTune,
    TuneOptions,
    TuneResult,
    tune,
)
from pipelinedp_tpu_torch.analysis.pre_aggregation import preaggregate
from pipelinedp_tpu_torch.analysis.dataset_summary import (
    PublicPartitionsSummary,
    compute_public_partitions_summary,
)
