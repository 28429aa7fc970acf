"""Combiners: the metric plan of the port's dense aggregation.

Port of pipelinedp_tpu/combiners.py:176-721 (Count, PrivacyIdCount, Sum,
Mean, Variance, Quantile, VectorSum, Compound, create_compound_combiner).
The port has no
generic element-wise backend, so a combiner here carries what the fused
release needs: its budget requests (made at graph-build time), its metric
names in output order, its mechanism calibration (read after
compute_budgets) and its Explain Computation text. executor.build_plan
lowers each child to a MetricPlanEntry evaluated on dense partition
columns.
"""

import abc
import collections
import copy
import threading
from typing import Callable, Iterable, List, Tuple, Union

from pipelinedp_tpu_torch import aggregate_params
from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch import dp_computations
from pipelinedp_tpu_torch.aggregate_params import Metrics
from pipelinedp_tpu_torch.ops import quantile_tree

ExplainComputationReport = Union[Callable, str, List[Union[Callable, str]]]


class Combiner(abc.ABC):
    """Base class of the port's combiners."""

    @abc.abstractmethod
    def metrics_names(self) -> List[str]:
        pass

    @abc.abstractmethod
    def explain_computation(self) -> ExplainComputationReport:
        pass

    def expects_per_partition_sampling(self) -> bool:
        """Whether rows are sampled per partition down to
        max_contributions_per_partition before accumulation."""
        return True


class CombinerParams:
    """Budget spec + aggregation params bundled for a combiner."""

    def __init__(self, spec: budget_accounting.MechanismSpec,
                 params: aggregate_params.AggregateParams):
        self._mechanism_spec = spec
        self.aggregate_params = copy.copy(params)

    @property
    def eps(self):
        return self._mechanism_spec.eps

    @property
    def delta(self):
        return self._mechanism_spec.delta

    @property
    def mechanism_spec(self) -> budget_accounting.MechanismSpec:
        return self._mechanism_spec

    @property
    def additive_vector_noise_params(
            self) -> dp_computations.AdditiveVectorNoiseParams:
        p = self.aggregate_params
        return dp_computations.AdditiveVectorNoiseParams(
            eps_per_coordinate=self.eps / p.vector_size,
            delta_per_coordinate=self.delta / p.vector_size,
            max_norm=p.vector_max_norm,
            l0_sensitivity=p.max_partitions_contributed,
            linf_sensitivity=p.max_contributions_per_partition,
            norm_kind=p.vector_norm_kind,
            noise_kind=p.noise_kind)


class MechanismContainerMixin(abc.ABC):
    """Lazily creates and caches a DP mechanism from the finalized spec."""

    @abc.abstractmethod
    def create_mechanism(self):
        pass

    def get_mechanism(self):
        if not hasattr(self, "_mechanism"):
            self._mechanism = self.create_mechanism()
        return self._mechanism


class AdditiveMechanismMixin(MechanismContainerMixin):
    """MechanismContainerMixin for additive (Laplace/Gaussian) mechanisms."""

    def create_mechanism(self) -> dp_computations.AdditiveMechanism:
        return dp_computations.create_additive_mechanism(
            self._mechanism_spec, self._sensitivities)


class CountCombiner(Combiner, AdditiveMechanismMixin):
    """DP count of contributions."""

    def __init__(self, mechanism_spec: budget_accounting.MechanismSpec,
                 params: aggregate_params.AggregateParams):
        self._mechanism_spec = mechanism_spec
        self._sensitivities = dp_computations.compute_sensitivities_for_count(
            params)

    def metrics_names(self) -> List[str]:
        return ['count']

    def explain_computation(self) -> ExplainComputationReport:
        return lambda: (f"Computed DP count with\n"
                        f"     {self.get_mechanism().describe()}")


class PrivacyIdCountCombiner(Combiner, AdditiveMechanismMixin):
    """DP count of contributing privacy ids."""

    def __init__(self, mechanism_spec: budget_accounting.MechanismSpec,
                 params: aggregate_params.AggregateParams):
        self._mechanism_spec = mechanism_spec
        self._sensitivities = (
            dp_computations.compute_sensitivities_for_privacy_id_count(params))

    def metrics_names(self) -> List[str]:
        return ['privacy_id_count']

    def explain_computation(self) -> ExplainComputationReport:
        return lambda: (f"Computed DP privacy_id_count with\n"
                        f"     {self.get_mechanism().describe()}")

    def expects_per_partition_sampling(self) -> bool:
        return False


class SumCombiner(Combiner, AdditiveMechanismMixin):
    """DP sum: per-contribution clipping (min_value/max_value) or
    per-(privacy_id, partition) sum clipping (min/max_sum_per_partition)."""

    def __init__(self, mechanism_spec: budget_accounting.MechanismSpec,
                 params: aggregate_params.AggregateParams):
        self._mechanism_spec = mechanism_spec
        self._sensitivities = dp_computations.compute_sensitivities_for_sum(
            params)
        self._bounding_per_partition = params.bounds_per_partition_are_set

    def metrics_names(self) -> List[str]:
        return ['sum']

    def expects_per_partition_sampling(self) -> bool:
        return not self._bounding_per_partition

    def explain_computation(self) -> ExplainComputationReport:
        return lambda: (f"Computed DP sum with\n"
                        f"     {self.get_mechanism().describe()}")


class MeanCombiner(Combiner, MechanismContainerMixin):
    """DP mean via the normalized-sum trick; optionally also count and sum."""

    def __init__(self, count_spec: budget_accounting.MechanismSpec,
                 sum_spec: budget_accounting.MechanismSpec,
                 params: aggregate_params.AggregateParams,
                 metrics_to_compute: Iterable[str]):
        metrics_to_compute = list(metrics_to_compute)
        if len(metrics_to_compute) != len(set(metrics_to_compute)):
            raise ValueError(f"{metrics_to_compute} cannot contain duplicates")
        for metric in metrics_to_compute:
            if metric not in ('count', 'sum', 'mean'):
                raise ValueError(
                    f"{metric} should be one of ['count', 'sum', 'mean']")
        if 'mean' not in metrics_to_compute:
            raise ValueError(
                f"one of the {metrics_to_compute} should be 'mean'")
        self._count_spec = count_spec
        self._sum_spec = sum_spec
        self._metrics_to_compute = metrics_to_compute
        self._min_value = params.min_value
        self._max_value = params.max_value
        self._count_sensitivities = (
            dp_computations.compute_sensitivities_for_count(params))
        self._sum_sensitivities = (
            dp_computations.compute_sensitivities_for_normalized_sum(params))

    def metrics_names(self) -> List[str]:
        return self._metrics_to_compute

    def explain_computation(self) -> ExplainComputationReport:
        return lambda: "DP mean computation:\n" + self.get_mechanism().describe(
        )

    def create_mechanism(self) -> dp_computations.MeanMechanism:
        middle = dp_computations.compute_middle(self._min_value,
                                                self._max_value)
        return dp_computations.create_mean_mechanism(middle, self._count_spec,
                                                     self._count_sensitivities,
                                                     self._sum_spec,
                                                     self._sum_sensitivities)


class VarianceCombiner(Combiner):
    """DP variance (+ optionally mean/sum/count)."""

    def __init__(self, params: CombinerParams,
                 metrics_to_compute: Iterable[str]):
        self._params = params
        metrics_to_compute = list(metrics_to_compute)
        if len(metrics_to_compute) != len(set(metrics_to_compute)):
            raise ValueError(f"{metrics_to_compute} cannot contain duplicates")
        for metric in metrics_to_compute:
            if metric not in ('count', 'sum', 'mean', 'variance'):
                raise ValueError(f"{metric} should be one of "
                                 f"['count', 'sum', 'mean', 'variance']")
        if 'variance' not in metrics_to_compute:
            raise ValueError(
                f"one of the {metrics_to_compute} should be 'variance'")
        self._metrics_to_compute = metrics_to_compute

    def metrics_names(self) -> List[str]:
        return self._metrics_to_compute

    def explain_computation(self) -> ExplainComputationReport:
        return lambda: (f"Computed variance with (eps={self._params.eps} "
                        f"delta={self._params.delta})")

    def noise_stds(self) -> Tuple[float, float, float]:
        """The (count, normalized sum, normalized sum of squares) stds."""
        p = self._params.aggregate_params
        return dp_computations.compute_dp_var_noise_stds(
            self._params.eps, self._params.delta,
            p.max_partitions_contributed, p.max_contributions_per_partition,
            p.min_value, p.max_value, p.noise_kind)


class QuantileCombiner(Combiner):
    """DP percentiles from a quantile tree per partition: B^h leaves over
    [min_value, max_value], noise on every node with the budget split
    equally across the h levels, and a root-to-leaf descent."""

    def __init__(self,
                 params: CombinerParams,
                 percentiles_to_compute: List[float],
                 tree_height: int = quantile_tree.DEFAULT_TREE_HEIGHT,
                 branching_factor: int = (
                     quantile_tree.DEFAULT_BRANCHING_FACTOR)):
        self._params = params
        self._percentiles = percentiles_to_compute
        self._quantiles_to_compute = [p / 100 for p in percentiles_to_compute]
        self._tree_height = tree_height
        self._branching_factor = branching_factor

    def metrics_names(self) -> List[str]:

        def format_metric_name(p: float):
            int_p = int(round(p))
            p_str = str(int_p) if int_p == p else str(p).replace('.', '_')
            return f"percentile_{p_str}"

        return list(map(format_metric_name, self._percentiles))

    def explain_computation(self) -> ExplainComputationReport:
        return lambda: (f"Computed percentiles {self._percentiles} with "
                        f"(eps={self._params.eps} delta={self._params.delta})")

    def mechanism_spec(self) -> budget_accounting.MechanismSpec:
        return self._params.mechanism_spec

    def noise_std(self) -> float:
        """The per-node noise stddev of every tree level."""
        p = self._params.aggregate_params
        return quantile_tree.per_level_noise_std(
            self._params.eps, self._params.delta,
            p.max_partitions_contributed, p.max_contributions_per_partition,
            self._tree_height, p.noise_kind)


class VectorSumCombiner(Combiner):
    """DP elementwise sum of fixed-size vectors: the partition's sum is
    clipped to the norm ball, then noised per coordinate."""

    def __init__(self, params: CombinerParams):
        self._params = params

    def metrics_names(self) -> List[str]:
        return ['vector_sum']

    def explain_computation(self) -> ExplainComputationReport:
        return lambda: (f"Computed vector sum with (eps={self._params.eps} "
                        f"delta={self._params.delta})")

    def mechanism_spec(self) -> budget_accounting.MechanismSpec:
        return self._params.mechanism_spec

    def noise_std(self) -> float:
        """The per-coordinate noise stddev."""
        return dp_computations.vector_noise_std(
            self._params.additive_vector_noise_params)


# Cache for namedtuple result types, guarded against concurrent creation
# of two distinct classes for one key.
_named_tuple_cache_lock = threading.Lock()
_named_tuple_cache = {}


def _get_or_create_named_tuple(type_name: str, field_names: tuple):
    cache_key = (type_name, field_names)
    with _named_tuple_cache_lock:
        named_tuple = _named_tuple_cache.get(cache_key)
        if named_tuple is None:
            named_tuple = collections.namedtuple(type_name, field_names)
            named_tuple.__reduce__ = lambda self: (
                _create_named_tuple_instance,
                (type_name, field_names, tuple(self)))
            _named_tuple_cache[cache_key] = named_tuple
    return named_tuple


def _create_named_tuple_instance(type_name: str, field_names: tuple, values):
    return _get_or_create_named_tuple(type_name, field_names)(*values)


class CompoundCombiner(Combiner):
    """Combiner of combiners: computes several metrics in one pass; the
    release is a MetricsTuple namedtuple over the children's metrics."""

    def __init__(self, combiners: Iterable[Combiner]):
        self._combiners = list(combiners)
        names = []
        for combiner in self._combiners:
            names.extend(combiner.metrics_names())
        if len(names) != len(set(names)):
            raise ValueError(
                f"two combiners in {combiners} cannot compute the same metrics")
        self._metrics_to_compute = tuple(names)

    @property
    def combiners(self) -> List[Combiner]:
        return self._combiners

    def metrics_names(self) -> List[str]:
        return list(self._metrics_to_compute)

    def explain_computation(self) -> ExplainComputationReport:
        return [combiner.explain_computation() for combiner in self._combiners]

    def expects_per_partition_sampling(self) -> bool:
        return any(c.expects_per_partition_sampling() for c in self._combiners)


def create_compound_combiner(
        params: aggregate_params.AggregateParams,
        budget_accountant: budget_accounting.BudgetAccountant
) -> CompoundCombiner:
    """Builds the CompoundCombiner for the requested metrics, requesting one
    budget per mechanism (pipelinedp_tpu/combiners.py:656). Each request
    is labelled with the metric it serves, for the budget odometer's
    records (runtime/observability.mechanism_label)."""
    from pipelinedp_tpu_torch.runtime import observability
    combiners = []
    mechanism_type = params.noise_kind.convert_to_mechanism_type()

    def request(metric_label: str):
        with observability.mechanism_label(metric_label):
            return budget_accountant.request_budget(
                mechanism_type, weight=params.budget_weight)

    if Metrics.VARIANCE in params.metrics:
        budget_variance = request('variance')
        metrics_to_compute = ['variance']
        if Metrics.MEAN in params.metrics:
            metrics_to_compute.append('mean')
        if Metrics.COUNT in params.metrics:
            metrics_to_compute.append('count')
        if Metrics.SUM in params.metrics:
            metrics_to_compute.append('sum')
        combiners.append(
            VarianceCombiner(CombinerParams(budget_variance, params),
                             metrics_to_compute))
    elif Metrics.MEAN in params.metrics:
        budget_count = request('count')
        budget_sum = request('sum')
        metrics_to_compute = ['mean']
        if Metrics.COUNT in params.metrics:
            metrics_to_compute.append('count')
        if Metrics.SUM in params.metrics:
            metrics_to_compute.append('sum')
        combiners.append(
            MeanCombiner(budget_count, budget_sum, params, metrics_to_compute))
    else:
        if Metrics.COUNT in params.metrics:
            combiners.append(CountCombiner(request('count'), params))
        if Metrics.SUM in params.metrics:
            combiners.append(SumCombiner(request('sum'), params))
    if Metrics.PRIVACY_ID_COUNT in params.metrics:
        combiners.append(
            PrivacyIdCountCombiner(request('privacy_id_count'), params))
    if Metrics.VECTOR_SUM in params.metrics:
        combiners.append(
            VectorSumCombiner(CombinerParams(request('vector_sum'), params)))
    percentiles_to_compute = [
        metric.parameter for metric in params.metrics if metric.is_percentile
    ]
    if percentiles_to_compute:
        combiners.append(
            QuantileCombiner(CombinerParams(request('percentile'), params),
                             percentiles_to_compute))
    return CompoundCombiner(combiners)
