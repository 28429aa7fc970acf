"""DPEngine: the DP aggregation entry point of the port.

Port of pipelinedp_tpu/dp_engine.py's aggregate and select_partitions on
the columnar route (:121-138, :207-246): parameter and budget-accountant
checks, then the call lowers to the port's executor, which requests every
budget at graph-build time and runs the kernels when the returned
collection is first iterated, after BudgetAccountant.compute_budgets().

Streamed input: a runtime.pipeline.ChunkSource (an iterable of (pid_raw,
pk_raw, values) column chunks) as `col` is encoded chunk by chunk on a host
thread pool while earlier chunks land on the device (ingest.py), under the
backend's encode_threads / pipeline_depth / encode_mode.
"""

from typing import Optional, Sequence

from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch import report_generator
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams, Metric,
                                                   Metrics,
                                                   SelectPartitionsParams)
from pipelinedp_tpu_torch.data_extractors import DataExtractors


class DPEngine:
    """Performs DP aggregations on a TorchBackend."""

    def __init__(self, budget_accountant: budget_accounting.BudgetAccountant,
                 backend: pipeline_backend.TorchBackend):
        if not isinstance(backend, pipeline_backend.TorchBackend):
            raise TypeError("The port's DPEngine runs on a TorchBackend; "
                            "the generic backends are ROADMAP.md Queue 1 "
                            "item 14.")
        self._budget_accountant = budget_accountant
        self._backend = backend
        self._report_generators = []

    @property
    def _current_report_generator(self):
        return self._report_generators[-1]

    def explain_computations_report(self):
        return [generator.report() for generator in self._report_generators]

    def aggregate(self,
                  col,
                  params: AggregateParams,
                  data_extractors: DataExtractors,
                  public_partitions=None,
                  out_explain_computation_report: Optional[
                      report_generator.ExplainComputationReport] = None):
        """Computes DP aggregate metrics.

        Args:
          col: collection of same-typed elements, a pre-encoded
            columnar.EncodedData, or a runtime.pipeline.ChunkSource of raw
            column chunks, streamed to the device (extractors are not
            consulted for either).
          params: metrics to compute and computation parameters.
          data_extractors: how to obtain (privacy_id, partition_key, value)
            from an element.
          public_partitions: optional collection of partition keys that appear
            in the result; if absent, partitions are selected DP-ly.
          out_explain_computation_report: out-param capturing this
            aggregation's Explain Computation report.

        Returns:
          Lazy collection of (partition_key, MetricsTuple).
        """
        self._check_aggregate_params(col, params, data_extractors)
        self._check_budget_accountant_compatibility(
            public_partitions is not None, params.metrics,
            params.custom_combiners is not None)
        executor.check_supported(params, public_partitions)
        with self._budget_accountant.scope(weight=params.budget_weight):
            self._report_generators.append(
                report_generator.ReportGenerator(params, "aggregate",
                                                 public_partitions is not None))
            if out_explain_computation_report is not None:
                out_explain_computation_report._set_report_generator(
                    self._current_report_generator)
            col = executor.lazy_aggregate(
                backend=self._backend,
                col=col,
                params=params,
                data_extractors=data_extractors,
                public_partitions=public_partitions,
                budget_accountant=self._budget_accountant,
                report_generator=self._current_report_generator)
            self._budget_accountant._compute_budget_for_aggregation(
                params.budget_weight)
        return self._guard_lazy_execution(col)

    def select_partitions(self, col, params: SelectPartitionsParams,
                          data_extractors: DataExtractors):
        """Returns a lazy collection of DP-selected partition keys.

        Args:
          col: collection of same-typed elements, a pre-encoded
            columnar.EncodedData, or a runtime.pipeline.ChunkSource.
          params: the L0 bound, strategy, pre_threshold and budget weight.
          data_extractors: how to obtain (privacy_id, partition_key) from an
            element; values are never read.
        """
        self._check_select_private_partitions(col, params, data_extractors)
        self._check_budget_accountant_compatibility(False, [], False)
        with self._budget_accountant.scope(weight=params.budget_weight):
            self._report_generators.append(
                report_generator.ReportGenerator(params, "select_partitions"))
            col = executor.lazy_select_partitions(
                backend=self._backend,
                col=col,
                params=params,
                data_extractors=data_extractors,
                budget_accountant=self._budget_accountant,
                report_generator=self._current_report_generator)
            self._budget_accountant._compute_budget_for_aggregation(
                params.budget_weight)
        return self._guard_lazy_execution(col)

    def _check_select_private_partitions(
            self, col, params: SelectPartitionsParams,
            data_extractors: DataExtractors):
        if col is None or _is_empty(col):
            raise ValueError("col must be non-empty")
        if params is None:
            raise ValueError(
                "params must be set to a valid SelectPartitionsParams")
        if not isinstance(params, SelectPartitionsParams):
            raise TypeError(
                "params must be set to a valid SelectPartitionsParams")
        if (not isinstance(params.max_partitions_contributed, int) or
                params.max_partitions_contributed <= 0):
            raise ValueError("params.max_partitions_contributed must be set "
                             "(to a positive integer)")
        if data_extractors is None:
            raise ValueError("data_extractors must be set to a DataExtractors")
        if not isinstance(data_extractors, DataExtractors):
            raise TypeError("data_extractors must be set to a DataExtractors")

    def _check_aggregate_params(self, col, params: AggregateParams,
                                data_extractors: DataExtractors):
        if col is None or _is_empty(col):
            raise ValueError("col must be non-empty")
        if params is None:
            raise ValueError("params must be set to a valid AggregateParams")
        if not isinstance(params, AggregateParams):
            raise TypeError("params must be set to a valid AggregateParams")
        if params.max_contributions is not None:
            supported = [
                Metrics.PRIVACY_ID_COUNT, Metrics.COUNT, Metrics.SUM,
                Metrics.MEAN
            ]
            not_supported = set(params.metrics).difference(supported)
            if not_supported:
                raise NotImplementedError(
                    f"max_contributions is not supported for {not_supported}")
        if data_extractors is None:
            raise ValueError("data_extractors must be set to a DataExtractors")
        if not isinstance(data_extractors, DataExtractors):
            raise TypeError("data_extractors must be set to a DataExtractors")
        if params.contribution_bounds_already_enforced:
            if data_extractors.privacy_id_extractor:
                raise ValueError("privacy_id_extractor should be set iff "
                                 "contribution_bounds_already_enforced is "
                                 "False")
            if Metrics.PRIVACY_ID_COUNT in params.metrics:
                raise ValueError(
                    "PRIVACY_ID_COUNT cannot be computed when "
                    "contribution_bounds_already_enforced is True.")

    def _check_budget_accountant_compatibility(
            self, is_public_partition: bool, metrics: Sequence[Metric],
            custom_combiner: bool):
        """pipelinedp_tpu/dp_engine.py:468: under a non-naive (PLD)
        accountant only COUNT, PRIVACY_ID_COUNT, SUM and MEAN, with or
        without private partition selection (its GENERIC mechanism composes
        through the loss distribution)."""
        if isinstance(self._budget_accountant,
                      budget_accounting.NaiveBudgetAccountant):
            return
        del is_public_partition
        supported = [
            Metrics.COUNT, Metrics.PRIVACY_ID_COUNT, Metrics.SUM, Metrics.MEAN
        ]
        non_supported = set(metrics) - set(supported)
        if non_supported:
            raise NotImplementedError(f"Metrics {non_supported} do not "
                                      f"support PLD budget accounting")
        if custom_combiner:
            raise ValueError("PLD budget accounting does not support custom "
                             "combiners")

    def _guard_lazy_execution(self, col):
        """Wraps the lazy result so that iterating it cannot grow the budget
        ledger: mechanisms register at graph-build time only."""
        accountant = self._budget_accountant

        def guarded():
            before = accountant.mechanism_count
            yield from col
            grew = accountant.mechanism_count - before
            if grew:
                raise AssertionError(
                    f"{grew} mechanism(s) registered with the "
                    f"BudgetAccountant while iterating a lazy "
                    f"result: mechanisms must register at graph-build "
                    f"time, never during execution — this would "
                    f"double-spend the privacy budget.")

        return guarded()


def _is_empty(col) -> bool:
    if isinstance(col, (list, tuple)):
        return not col
    return False
