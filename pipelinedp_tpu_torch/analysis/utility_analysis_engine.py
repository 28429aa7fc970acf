"""Utility-analysis engine: builds the per-partition analysis pipeline.

Capability parity with the reference ``analysis/utility_analysis_engine.py``
(analyze() returns a lazy collection of (partition_key, flat per-config
results); budget requests mirror the real aggregation's split). Re-designed:
the reference subclasses DPEngine and swaps graph nodes (combiners, bounders,
selection) to bend the DP dataflow into an analysis dataflow; here the
analysis pipeline is built directly — extract -> public filter ->
preaggregate -> group by partition -> one vectorized
``PerPartitionAnalyzer`` pass — since none of the DP stages (noising,
thresholding, selection) actually run during analysis.

The dense path (``utility_analysis.perform_utility_analysis`` on a
LocalBackend or TorchBackend) takes only ``request_budgets`` and
``preaggregated_rows`` from here and lowers the same math to
``analysis/kernels.sweep_kernel``.

Port of pipelinedp_tpu/analysis/utility_analysis_engine.py.
"""

from typing import Optional, Union

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch import data_extractors as extractors
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch.analysis import contribution_bounders as analysis_bounders
from pipelinedp_tpu_torch.analysis import data_structures
from pipelinedp_tpu_torch.analysis import error_model as em
from pipelinedp_tpu_torch.analysis import per_partition_combiners


class UtilityAnalysisEngine:
    """Performs utility analysis for DP aggregations."""

    def __init__(self, budget_accountant: budget_accounting.BudgetAccountant,
                 backend: pipeline_backend.PipelineBackend):
        self._budget_accountant = budget_accountant
        self._backend = backend

    def aggregate(self, col, params, data_extractors, public_partitions=None):
        raise ValueError("UtilityAnalysisEngine.aggregate can't be called.\n"
                         "If you'd like to perform utility analysis, use "
                         "UtilityAnalysisEngine.analyze.\n"
                         "If you'd like to perform DP computations, use "
                         "DPEngine.aggregate.")

    def request_budgets(
            self, options: 'data_structures.UtilityAnalysisOptions',
            public_partitions) -> per_partition_combiners.PerPartitionAnalyzer:
        """Requests the budget split the real aggregation would make and
        returns the analyzer bound to the (lazily finalized) specs.

        One GENERIC request models private partition selection, one request
        per metric models its noise mechanism; all configurations share these
        specs (the sweep varies sensitivities, not the budget split).
        """
        params = options.aggregate_params
        metric_list = em.ordered_metrics(params)
        with self._budget_accountant.scope(weight=params.budget_weight):
            selection_spec = None
            if public_partitions is None:
                selection_spec = self._budget_accountant.request_budget(
                    agg.MechanismType.GENERIC, weight=params.budget_weight)
            mechanism_type = params.noise_kind.convert_to_mechanism_type()
            metric_specs = [
                self._budget_accountant.request_budget(
                    mechanism_type, weight=params.budget_weight)
                for _ in metric_list
            ]
        return per_partition_combiners.PerPartitionAnalyzer(
            config_params=list(data_structures.get_aggregate_params(options)),
            metric_list=metric_list,
            metric_specs=metric_specs,
            selection_spec=selection_spec)

    def preaggregated_rows(
            self, col, options: 'data_structures.UtilityAnalysisOptions',
            data_extractors: Union[extractors.DataExtractors,
                                   extractors.PreAggregateExtractors],
            public_partitions):
        """(partition_key, (count, sum, n_partitions, n_contributions)) rows.

        Public filtering happens before cross-partition statistics are taken
        (matching DPEngine._aggregate's stage order), so n_partitions counts
        only partitions that survive the public filter.
        """
        backend = self._backend
        if options.pre_aggregated_data:
            col = backend.map(
                col, lambda row: (data_extractors.partition_extractor(row),
                                  data_extractors.preaggregate_extractor(row)),
                "Extract (partition_key, preaggregate_data)")
            if public_partitions is not None:
                col = backend.filter_by_key(
                    col, public_partitions,
                    "Filter out non-public partitions")
            return col
        col = backend.map(
            col, lambda row: (data_extractors.privacy_id_extractor(row),
                              data_extractors.partition_extractor(row),
                              data_extractors.value_extractor(row)),
            "Extract (privacy_id, partition_key, value)")
        if public_partitions is not None:
            col = backend.map(col, lambda row: (row[1], row),
                              "Key by partition")
            col = backend.filter_by_key(col, public_partitions,
                                        "Filter out non-public partitions")
            col = backend.values(col, "Drop key")
        bounder = analysis_bounders.AnalysisContributionBounder(
            options.partitions_sampling_prob)
        col = bounder.bound_contributions(col,
                                          params=None,
                                          backend=backend,
                                          report_generator=None,
                                          aggregate_fn=lambda x: x)
        # ((privacy_id, partition_key), preaggregated row)
        return backend.map(col, lambda row: (row[0][1], row[1]),
                           "Drop privacy id")

    def analyze(self,
                col,
                options: 'data_structures.UtilityAnalysisOptions',
                data_extractors: Union[extractors.DataExtractors,
                                       extractors.PreAggregateExtractors],
                public_partitions=None,
                analyzer: Optional[
                    per_partition_combiners.PerPartitionAnalyzer] = None):
        """Per-partition utility analysis.

        Returns a lazy collection of (partition_key, flat results tuple) —
        see PerPartitionAnalyzer.analyze_rows for the tuple layout. Iterate
        only after BudgetAccountant.compute_budgets().
        """
        _check_utility_analysis_params(options, data_extractors)
        backend = self._backend
        if analyzer is None:
            analyzer = self.request_budgets(options, public_partitions)
        col = self.preaggregated_rows(col, options, data_extractors,
                                      public_partitions)
        if public_partitions is not None:
            # Empty-partition markers so missing public partitions surface.
            publics = backend.to_collection(public_partitions, col,
                                            "Public partitions to collection")
            markers = backend.map(publics, lambda pk: (pk, None),
                                  "Empty public partition markers")
            col = backend.flatten((col, markers),
                                  "Join markers with dataset rows")
        # Mergeable bounded accumulators (sparse rows -> dense moments above
        # SPARSE_CAP) so hot partitions reduce incrementally on distributed
        # backends instead of materializing every row on one worker.
        col = backend.map_values(col, analyzer.create_accumulator,
                                 "Wrap rows into analysis accumulators")
        col = backend.combine_accumulators_per_key(
            col, analyzer, "Merge analysis accumulators per partition")
        return backend.map_values(col, analyzer.compute,
                                  "Per-partition utility analysis")


def _check_utility_analysis_params(
        options: 'data_structures.UtilityAnalysisOptions',
        data_extractors: Union[extractors.DataExtractors,
                               extractors.PreAggregateExtractors]):
    if options.pre_aggregated_data:
        if not isinstance(data_extractors, extractors.PreAggregateExtractors):
            raise ValueError(
                "options.pre_aggregated_data is set to true but "
                "PreAggregateExtractors aren't provided. "
                "PreAggregateExtractors should be specified for "
                "pre-aggregated data.")
    elif not isinstance(data_extractors, extractors.DataExtractors):
        raise ValueError("DataExtractors should be specified for raw data.")

    params = options.aggregate_params
    if params.custom_combiners is not None:
        raise NotImplementedError("custom combiners are not supported")
    supported = {
        agg.Metrics.COUNT, agg.Metrics.SUM, agg.Metrics.PRIVACY_ID_COUNT
    }
    if not set(params.metrics).issubset(supported):
        not_supported = list(set(params.metrics) - supported)
        raise NotImplementedError(
            f"unsupported metric in metrics={not_supported}")
    if params.contribution_bounds_already_enforced:
        raise NotImplementedError(
            "utility analysis when contribution bounds are already enforced "
            "is not supported")
