"""Public API for performing utility analysis.

Port of the dense route of pipelinedp_tpu/analysis/utility_analysis.py
(:38-205): per-partition analysis, then cross-partition UtilityReports plus
a histogram of reports by partition-size bucket. The rows are
preaggregated through the backend's generic operations on the host
(utility_analysis_engine.preaggregated_rows), gathered into columns, and
the whole sweep, every parameter configuration x every partition with the
report-histogram reduction, runs as C5 + C10 + C19 + C20 on the device
(analysis/kernels.sweep_kernel): on a TorchBackend on backend.device in
backend.dtype (over its mesh where it has one: kernels.sharded_sweep), on
a plain LocalBackend on CUDA in float64.

Every backend of the port is a LocalBackend. The JAX package's
distributed route (:240-300, cross_partition_combiners.py) runs on
MultiProcLocalBackend, Beam and Spark, which the port does not have yet:
any other backend raises NotImplementedError (ROADMAP.md Queue 1 item 14).
"""

import functools
from typing import List, Union

import numpy as np
import torch

from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch import data_extractors as extractors
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch.analysis import data_structures
from pipelinedp_tpu_torch.analysis import error_model as em
from pipelinedp_tpu_torch.analysis import kernels
from pipelinedp_tpu_torch.analysis import metrics
from pipelinedp_tpu_torch.analysis import utility_analysis_engine

# Partition-size histogram bucket lower bounds: [0, 1] + [1, 2, 5] * 10^i.
BUCKET_BOUNDS = kernels.BUCKET_BOUNDS


def perform_utility_analysis(
        col,
        backend: pipeline_backend.PipelineBackend,
        options: 'data_structures.UtilityAnalysisOptions',
        data_extractors: Union[extractors.DataExtractors,
                               extractors.PreAggregateExtractors],
        public_partitions=None):
    """Performs utility analysis for DP aggregations.

    Returns:
        A tuple: (collection of metrics.UtilityReport — one per input
        configuration; collection of ((partition_key, configuration_index),
        metrics.PerPartitionMetrics)).
    """
    if not isinstance(backend, pipeline_backend.LocalBackend):
        raise NotImplementedError(
            f"perform_utility_analysis on {type(backend).__name__}: the "
            f"port analyzes on a LocalBackend or TorchBackend; the "
            f"distributed route waits for the generic backends (ROADMAP.md "
            f"Queue 1 item 14).")
    budget_accountant = budget_accounting.NaiveBudgetAccountant(
        total_epsilon=options.epsilon, total_delta=options.delta)
    engine = utility_analysis_engine.UtilityAnalysisEngine(
        budget_accountant=budget_accountant, backend=backend)
    device, dtype = _sweep_device(backend)
    return _perform_dense(col, engine, budget_accountant, options,
                          data_extractors, public_partitions, device, dtype,
                          mesh=getattr(backend, "mesh", None))


def _sweep_device(backend: pipeline_backend.LocalBackend):
    """(device, dtype) of the sweep: a TorchBackend's own; CUDA (raising
    without it) in float64 for a plain LocalBackend."""
    if isinstance(backend, pipeline_backend.TorchBackend):
        return backend.device, backend.dtype
    return kernels.resolve_device(None), torch.float64


def _perform_dense(col, engine, budget_accountant, options, data_extractors,
                   public_partitions, device, dtype, mesh=None):
    utility_analysis_engine._check_utility_analysis_params(
        options, data_extractors)
    analyzer = engine.request_budgets(options, public_partitions)
    rows_col = engine.preaggregated_rows(col, options, data_extractors,
                                         public_partitions)
    budget_accountant.compute_budgets()
    rows = list(rows_col)
    public = public_partitions is not None

    # Dense partition index space: the public keys (order-preserving) for
    # public analysis — so missing publics become empty partitions — or the
    # dataset keys otherwise.
    if public:
        keys = list(dict.fromkeys(public_partitions))
    else:
        keys = list(dict.fromkeys(pk for pk, _ in rows))
    index = {pk: i for i, pk in enumerate(keys)}
    n = len(rows)
    counts = np.fromiter((r[0] for _, r in rows), dtype=np.float64, count=n)
    sums = np.fromiter((r[1] for _, r in rows), dtype=np.float64, count=n)
    contributed = np.fromiter((r[2] for _, r in rows),
                              dtype=np.float64,
                              count=n)
    pk_idx = np.fromiter((index[pk] for pk, _ in rows),
                         dtype=np.int32,
                         count=n)

    metric_list = analyzer.metric_list
    noise_stds, _ = analyzer.resolve_mechanisms()
    cfg = kernels.build_config_arrays(analyzer.config_params, metric_list,
                                      noise_stds,
                                      analyzer.selection_budget())
    if not keys:
        k = len(analyzer.config_params)
        out = {
            "bucket_rows":
                np.zeros((k, kernels.N_BUCKETS, len(metric_list),
                          em.REPORT_WIDTH)),
            "bucket_info": np.zeros((k, kernels.N_BUCKETS, em.INFO_WIDTH)),
        }
        per_partition = []
    else:
        # The sweep over the backend's mesh when it has one: rows split
        # over it, the statistics combined by C21 (one call site for both
        # paths, as in the JAX package).
        sweep = (functools.partial(kernels.sweep_kernel, device=device)
                 if mesh is None else
                 functools.partial(kernels.sharded_sweep, mesh))
        out = sweep(counts,
                    sums,
                    contributed,
                    pk_idx,
                    cfg,
                    n_partitions_total=len(keys),
                    metric_codes=tuple(kernels.METRIC_CODES[m]
                                       for m in metric_list),
                    public=public,
                    dtype=dtype)
        out = {name: _host(t) for name, t in out.items()}
        per_partition = _dense_per_partition(out, keys, analyzer, public)
    reports = _build_reports(
        np.asarray(out["bucket_rows"], dtype=np.float64),
        np.asarray(out["bucket_info"], dtype=np.float64), analyzer, options,
        public)
    return reports, per_partition


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class _LazyCollection:
    """Re-iterable lazy collection (LocalBackend collection semantics):
    Python objects are only built when (and each time) iterated."""

    def __init__(self, gen_fn):
        self._gen_fn = gen_fn

    def __iter__(self):
        return self._gen_fn()


def _dense_per_partition(out, keys, analyzer, public):
    """((pk, config_index), PerPartitionMetrics) rows from kernel outputs.

    Lazy: a 64-config x 10^5-partition sweep would otherwise materialize
    millions of dataclasses that callers like parameter_tuning never read.
    """

    def gen():
        stats = np.asarray(out["stats"], dtype=np.float64)
        keep_prob = np.asarray(out["keep_prob"], dtype=np.float64)
        n_users = np.asarray(out["n_users"])
        n_rows = np.asarray(out["n_rows"])
        noise_stds, _ = analyzer.resolve_mechanisms()
        for pi, pk in enumerate(keys):
            raw = metrics.RawStatistics(
                privacy_id_count=int(round(n_users[pi])),
                count=int(round(n_rows[pi])))
            for ki, params in enumerate(analyzer.config_params):
                errors = [
                    em.stats_to_sum_metrics(stats[ki, pi, mi], metric,
                                            float(noise_stds[ki, mi]),
                                            params.noise_kind)
                    for mi, metric in enumerate(analyzer.metric_list)
                ]
                prob = 1.0 if public else float(keep_prob[ki, pi])
                yield ((pk, ki), metrics.PerPartitionMetrics(
                    prob, raw, errors))

    return _LazyCollection(gen)


def _build_reports(bucket_rows, bucket_info, analyzer, options,
                   public) -> List[metrics.UtilityReport]:
    """Per-config UtilityReports (global + per-size-bucket histogram)."""
    noise_stds, _ = analyzer.resolve_mechanisms()
    metric_list = analyzer.metric_list
    strategies = (None if public else
                  data_structures.get_partition_selection_strategy(options))
    reports = []
    for ki, params in enumerate(analyzer.config_params):
        report = em.finalize_utility_report(bucket_rows[ki].sum(axis=0),
                                            bucket_info[ki].sum(axis=0),
                                            metric_list, noise_stds[ki],
                                            params.noise_kind, public, ki)
        if strategies is not None:
            report.partitions_info.strategy = strategies[ki]
        if metric_list:
            bins = []
            for b in range(kernels.N_BUCKETS):
                info_b = bucket_info[ki, b]
                if info_b[em.N_DATASET] + info_b[em.N_EMPTY] < 0.5:
                    continue
                sub = em.finalize_utility_report(bucket_rows[ki, b], info_b,
                                                 metric_list, noise_stds[ki],
                                                 params.noise_kind, public,
                                                 ki)
                if strategies is not None:
                    sub.partitions_info.strategy = strategies[ki]
                bins.append(
                    metrics.UtilityReportBin(
                        partition_size_from=BUCKET_BOUNDS[b],
                        partition_size_to=(BUCKET_BOUNDS[b + 1]
                                           if b + 1 < len(BUCKET_BOUNDS) else
                                           -1),
                        report=sub))
            report.utility_report_histogram = bins
        reports.append(report)
    return reports
