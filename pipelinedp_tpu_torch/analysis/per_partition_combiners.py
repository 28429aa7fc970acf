"""Per-partition utility analysis for distributed backends.

Capability parity with the reference ``analysis/per_partition_combiners.py``
(closed-form keep probability, clipping and l0-bounding error moments,
hundreds of parameter configurations analyzed at once), re-designed around
the flat-array error model in ``analysis/error_model.py``:

* The reference assembles ~4 combiner objects per configuration and threads
  tuple accumulators through create/merge; here ONE ``PerPartitionAnalyzer``
  evaluates every configuration in a single broadcasted numpy pass over the
  partition's rows ([K, n_metrics, STAT_WIDTH] at once).
* There is no accumulator-merge protocol: the engine groups rows by partition
  first, so each partition is analyzed exactly once. (The dense path
  reads only its budget specs — ``analysis/kernels.sweep_kernel`` computes
  the same statistics on the device.)

Port of pipelinedp_tpu/analysis/per_partition_combiners.py.

Budget laziness: noise stddevs and selection strategies derive from
MechanismSpecs whose eps/delta are finalized by
``BudgetAccountant.compute_budgets()``; they are resolved on first use, which
happens when the lazy pipeline is first iterated.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch.analysis import error_model as em
from pipelinedp_tpu_torch.analysis import metrics as metrics_dc

# A preaggregated row: (count, sum, n_partitions_contributed,
# n_contributions) for one (privacy_id, partition_key) pair.
PreaggregatedRow = Tuple[int, float, int, int]

# Rows kept raw in a sparse accumulator before switching to fixed-size dense
# statistics; also the exact-Poisson-binomial cutoff (mirrors the reference's
# MAX_PROBABILITIES_IN_ACCUMULATOR cap, ``per_partition_combiners.py:40``).
SPARSE_CAP = em.EXACT_PMF_LIMIT


class PerPartitionAnalyzer:
    """Analyzes one partition's rows under every parameter configuration.

    The output contract (the JAX package's ``utility_analysis.pack_metrics``
    reads it on its distributed route, not yet ported) is a
    flat tuple: ``(RawStatistics, *per config: [keep probability if private]
    + [SumMetrics per metric in error_model.ordered_metrics order])``.
    """

    def __init__(self,
                 config_params: Sequence[agg.AggregateParams],
                 metric_list: Sequence[agg.Metric],
                 metric_specs: Sequence[budget_accounting.MechanismSpec],
                 selection_spec: Optional[
                     budget_accounting.MechanismSpec] = None):
        self._config_params = list(config_params)
        self._metric_list = list(metric_list)
        self._metric_specs = list(metric_specs)
        self._selection_spec = selection_spec
        self._noise_stds = None
        self._selectors = None

    @property
    def private(self) -> bool:
        return self._selection_spec is not None

    @property
    def config_params(self) -> List[agg.AggregateParams]:
        return self._config_params

    @property
    def metric_list(self) -> List[agg.Metric]:
        return self._metric_list

    def selection_budget(self) -> Optional[Tuple[float, float]]:
        """(eps, delta) of the selection mechanism; None for public."""
        if not self.private:
            return None
        return self._selection_spec.eps, self._selection_spec.delta

    def results_per_config(self) -> int:
        return len(self._metric_list) + (1 if self.private else 0)

    def resolve_mechanisms(self):
        """Noise stds [K, n_metrics] and per-config selectors (lazy)."""
        if self._noise_stds is None:
            self._noise_stds = np.array(
                [[
                    em.config_noise_std(p, metric, spec.eps, spec.delta)
                    for metric, spec in zip(self._metric_list,
                                            self._metric_specs)
                ]
                 for p in self._config_params]).reshape(
                     len(self._config_params), len(self._metric_list))
        if self._selectors is None and self.private:
            self._selectors = [
                em.config_selector(p, self._selection_spec.eps,
                                   self._selection_spec.delta)
                for p in self._config_params
            ]
        return self._noise_stds, self._selectors

    def __getstate__(self):
        # Mechanism caches may hold unpicklable native state; workers rebuild
        # them from the finalized specs.
        state = self.__dict__.copy()
        state["_noise_stds"] = None
        state["_selectors"] = None
        return state

    def analyze_rows(self, rows: List[Optional[PreaggregatedRow]]) -> Tuple:
        """Analyzes one partition's full row list. ``None`` rows
        (empty-public markers) are ignored."""
        rows = [r for r in rows if r is not None]
        if len(rows) <= SPARSE_CAP:
            return self._compute_sparse(rows)
        return self._compute_dense(self._densify(rows))

    # --- Mergeable accumulator protocol (distributed combine_per_key). ---
    #
    # Accumulators stay SPARSE (the raw row list) up to SPARSE_CAP rows —
    # preserving the exact Poisson-binomial keep probability for small
    # partitions — then switch to DENSE fixed-size sufficient statistics
    # ([K, n_metrics, STAT_WIDTH] + [K, SEL_WIDTH] selection moments), so a
    # hot partition costs O(K) memory per worker, never O(rows).

    def create_accumulator(self, row: Optional[PreaggregatedRow]):
        return "s", ([] if row is None else [row])

    def _densify(self, rows: List[PreaggregatedRow]):
        counts = np.array([r[0] for r in rows], dtype=np.float64)
        sums = np.array([r[1] for r in rows], dtype=np.float64)
        contributed = np.array([r[2] for r in rows], dtype=np.float64)
        stats = em.partition_stats(counts, sums, contributed,
                                   self._config_params, self._metric_list)
        sel = np.zeros((len(self._config_params), em.SEL_WIDTH))
        if self.private and len(rows):
            l0 = np.array([[p.max_partitions_contributed]
                           for p in self._config_params], dtype=np.float64)
            q = em.keep_fraction(contributed[None, :], l0)
            sel = em.selection_moment_terms(q).sum(axis=-2)
        return "d", stats, sel, len(rows), int(counts.sum())

    def merge_accumulators(self, acc1, acc2):
        if acc1[0] == "s" and acc2[0] == "s":
            if len(acc1[1]) + len(acc2[1]) <= SPARSE_CAP:
                return "s", acc1[1] + acc2[1]
        if acc1[0] == "s":
            acc1 = self._densify(acc1[1])
        if acc2[0] == "s":
            acc2 = self._densify(acc2[1])
        return ("d", acc1[1] + acc2[1], acc1[2] + acc2[2], acc1[3] + acc2[3],
                acc1[4] + acc2[4])

    def compute(self, acc) -> Tuple:
        """Finalizes an accumulator into the flat results tuple."""
        if acc[0] == "s":
            return self._compute_sparse(acc[1])
        return self._compute_dense(acc)

    def _compute_sparse(self, rows: List[PreaggregatedRow]) -> Tuple:
        noise_stds, selectors = self.resolve_mechanisms()
        counts = np.array([r[0] for r in rows], dtype=np.float64)
        sums = np.array([r[1] for r in rows], dtype=np.float64)
        contributed = np.array([r[2] for r in rows], dtype=np.float64)
        stats = em.partition_stats(counts, sums, contributed,
                                   self._config_params, self._metric_list)
        result = [
            metrics_dc.RawStatistics(privacy_id_count=len(rows),
                                     count=int(counts.sum()))
        ]
        for ki, params in enumerate(self._config_params):
            if self.private:
                q = em.keep_fraction(contributed,
                                     float(params.max_partitions_contributed))
                result.append(em.host_keep_probability(q, selectors[ki]))
            for mi, metric in enumerate(self._metric_list):
                result.append(
                    em.stats_to_sum_metrics(stats[ki, mi], metric,
                                            float(noise_stds[ki, mi]),
                                            params.noise_kind))
        return tuple(result)

    def _compute_dense(self, acc) -> Tuple:
        _, stats, sel, n_users, n_rows = acc
        noise_stds, selectors = self.resolve_mechanisms()
        result = [
            metrics_dc.RawStatistics(privacy_id_count=n_users, count=n_rows)
        ]
        for ki, params in enumerate(self._config_params):
            if self.private:
                result.append(
                    em.host_keep_probability_from_moments(
                        sel[ki, em.SEL_MU], sel[ki, em.SEL_VAR],
                        sel[ki, em.SEL_SKEW3], n_users, selectors[ki]))
            for mi, metric in enumerate(self._metric_list):
                result.append(
                    em.stats_to_sum_metrics(stats[ki, mi], metric,
                                            float(noise_stds[ki, mi]),
                                            params.noise_kind))
        return tuple(result)

    # Backend combiner-protocol stubs (combine_accumulators_per_key only
    # calls merge_accumulators; these satisfy isinstance-free duck typing).
    def metrics_names(self) -> List[str]:
        return []

    def explain_computation(self):
        return None
