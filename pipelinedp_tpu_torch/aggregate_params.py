"""Declarative DP aggregation parameters, metric registry and enums.

Port of pipelinedp_tpu/aggregate_params.py: the same metrics, noise kinds,
mechanism types, partition-selection strategies, AggregateParams and its
`__post_init__` validation rules. The convenience parameter classes and
the contribution-bounds parameters belong to later slices of the port.
"""

import logging
import math
from dataclasses import dataclass
from enum import Enum
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclass
class Metric:
    """A DP metric, optionally parameterized (e.g. PERCENTILE(90)).

    Reference parity: pipeline_dp/aggregate_params.py:29-58.
    """
    name: str
    parameter: Optional[float] = None

    def __eq__(self, other: 'Metric') -> bool:
        if not isinstance(other, Metric):
            return False
        return self.name == other.name and self.parameter == other.parameter

    def __str__(self):
        if self.parameter is None:
            return self.name
        return f'{self.name}({self.parameter})'

    def __repr__(self):
        return self.__str__()

    def __hash__(self):
        return hash(str(self))

    @property
    def is_percentile(self):
        return self.name == 'PERCENTILE'


class Metrics:
    """Registry of the supported DP metrics (reference :61-72)."""
    COUNT = Metric('COUNT')
    PRIVACY_ID_COUNT = Metric('PRIVACY_ID_COUNT')
    SUM = Metric('SUM')
    MEAN = Metric('MEAN')
    VARIANCE = Metric('VARIANCE')
    VECTOR_SUM = Metric('VECTOR_SUM')

    @classmethod
    def PERCENTILE(cls, percentile_to_compute: float):
        return Metric('PERCENTILE', percentile_to_compute)


class NoiseKind(Enum):
    LAPLACE = 'laplace'
    GAUSSIAN = 'gaussian'

    def convert_to_mechanism_type(self) -> 'MechanismType':
        if self == NoiseKind.LAPLACE:
            return MechanismType.LAPLACE
        return MechanismType.GAUSSIAN


class MechanismType(Enum):
    LAPLACE = 'Laplace'
    GAUSSIAN = 'Gaussian'
    GENERIC = 'Generic'

    def to_noise_kind(self) -> NoiseKind:
        if self == MechanismType.LAPLACE:
            return NoiseKind.LAPLACE
        if self == MechanismType.GAUSSIAN:
            return NoiseKind.GAUSSIAN
        raise ValueError(f"MechanismType {self.value} can not be converted to "
                         f"NoiseKind")


class NormKind(Enum):
    Linf = "linf"
    L0 = "l0"
    L1 = "l1"
    L2 = "l2"


class PartitionSelectionStrategy(Enum):
    TRUNCATED_GEOMETRIC = 'Truncated Geometric'
    LAPLACE_THRESHOLDING = 'Laplace Thresholding'
    GAUSSIAN_THRESHOLDING = 'Gaussian Thresholding'


@dataclass
class AggregateParams:
    """Parameters of DPEngine.aggregate().

    Validation rules replicate the reference semantics
    (pipeline_dp/aggregate_params.py:166-365):
      - min_value/max_value and min_sum_per_partition/max_sum_per_partition
        must each be both-set-or-both-unset, and are mutually exclusive;
      - metrics requiring value bounds are rejected without them;
      - VECTOR_SUM is incompatible with scalar value metrics;
      - either max_contributions XOR both (max_partitions_contributed,
        max_contributions_per_partition) must be set.
    """
    metrics: List[Metric]
    noise_kind: NoiseKind = NoiseKind.LAPLACE
    max_partitions_contributed: Optional[int] = None
    max_contributions_per_partition: Optional[int] = None
    max_contributions: Optional[int] = None
    budget_weight: float = 1
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    min_sum_per_partition: Optional[float] = None
    max_sum_per_partition: Optional[float] = None
    custom_combiners: Sequence[Any] = None
    vector_norm_kind: Optional[NormKind] = None
    vector_max_norm: Optional[float] = None
    vector_size: Optional[int] = None
    contribution_bounds_already_enforced: bool = False
    public_partitions_already_filtered: bool = False
    partition_selection_strategy: PartitionSelectionStrategy = (
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC)
    pre_threshold: Optional[int] = None

    @property
    def metrics_str(self) -> str:
        if self.custom_combiners:
            return (f"custom combiners="
                    f"{[c.metrics_names() for c in self.custom_combiners]}")
        if self.metrics:
            return f"metrics={[str(m) for m in self.metrics]}"
        return "metrics=[]"

    @property
    def bounds_per_contribution_are_set(self) -> bool:
        return self.min_value is not None and self.max_value is not None

    @property
    def bounds_per_partition_are_set(self) -> bool:
        return (self.min_sum_per_partition is not None and
                self.max_sum_per_partition is not None)

    def __post_init__(self):
        self._check_both_set_or_unset("min_value", "max_value")
        self._check_both_set_or_unset("min_sum_per_partition",
                                      "max_sum_per_partition")

        value_bound = self.min_value is not None
        partition_bound = self.min_sum_per_partition is not None

        if value_bound and partition_bound:
            raise ValueError(
                "min_value and min_sum_per_partition can not be both set.")

        if value_bound:
            self._check_range("min_value", "max_value")
        if partition_bound:
            self._check_range("min_sum_per_partition", "max_sum_per_partition")

        if self.metrics:
            if Metrics.VECTOR_SUM in self.metrics:
                if (Metrics.SUM in self.metrics or
                        Metrics.MEAN in self.metrics or
                        Metrics.VARIANCE in self.metrics):
                    raise ValueError(
                        "AggregateParams: vector sum can not be computed "
                        "together with scalar metrics such as sum, mean etc")
            elif partition_bound:
                allowed = {Metrics.SUM, Metrics.PRIVACY_ID_COUNT,
                           Metrics.COUNT}
                not_allowed = set(self.metrics).difference(allowed)
                if not_allowed:
                    raise ValueError(
                        f"AggregateParams: min_sum_per_partition is not "
                        f"compatible with metrics {not_allowed}. Please"
                        f"use min_value/max_value.")
            elif not partition_bound and not value_bound:
                allowed = {Metrics.PRIVACY_ID_COUNT, Metrics.COUNT}
                not_allowed = set(self.metrics).difference(allowed)
                if not_allowed:
                    raise ValueError(
                        f"AggregateParams: for metrics {not_allowed} "
                        f"bounds per partition are required (e.g. min_value,"
                        f"max_value).")

            if (self.contribution_bounds_already_enforced and
                    Metrics.PRIVACY_ID_COUNT in self.metrics):
                raise ValueError(
                    "AggregateParams: Cannot calculate PRIVACY_ID_COUNT when "
                    "contribution_bounds_already_enforced is set to True.")
        if self.custom_combiners:
            logging.warning("Warning: custom combiners are used. This is an "
                            "experimental feature. It might not work properly "
                            "and it might be changed or removed without any "
                            "notifications.")
        if self.metrics and self.custom_combiners:
            raise ValueError(
                "Custom combiners can not be used with standard metrics")
        if self.max_contributions is not None:
            _check_is_positive_int(self.max_contributions, "max_contributions")
            if ((self.max_partitions_contributed is not None) or
                    (self.max_contributions_per_partition is not None)):
                raise ValueError(
                    "AggregateParams: only one in max_contributions or "
                    "both max_partitions_contributed and "
                    "max_contributions_per_partition must be set")
        else:
            n_set = _count_not_none(self.max_partitions_contributed,
                                    self.max_contributions_per_partition)
            if n_set == 0:
                raise ValueError(
                    "AggregateParams: either max_contributions must be set or "
                    "both max_partitions_contributed and "
                    "max_contributions_per_partition must be set.")
            elif n_set == 1:
                raise ValueError("AggregateParams: either none or both "
                                 "max_partitions_contributed and "
                                 "max_contributions_per_partition must be set.")
            _check_is_positive_int(self.max_partitions_contributed,
                                   "max_partitions_contributed")
            _check_is_positive_int(self.max_contributions_per_partition,
                                   "max_contributions_per_partition")
        if self.pre_threshold is not None:
            _check_is_positive_int(self.pre_threshold, "pre_threshold")

    def _check_both_set_or_unset(self, name1: str, name2: str):
        v1, v2 = getattr(self, name1), getattr(self, name2)
        if (v1 is None) != (v2 is None):
            raise ValueError(
                f"AggregateParams: {name1} and {name2} should"
                f" be both set or both None.")

    def _check_range(self, min_name: str, max_name: str):
        for name in (min_name, max_name):
            value = getattr(self, name)
            if _not_a_proper_number(value):
                raise ValueError(
                    f"AggregateParams: {name} must be a finite number")
        if getattr(self, min_name) > getattr(self, max_name):
            raise ValueError(
                f"AggregateParams: {max_name} must be equal to or "
                f"greater than {min_name}")

    def __str__(self):
        return parameters_to_readable_string(self)


@dataclass
class SelectPartitionsParams:
    """Parameters of DPEngine.select_partitions() (reference :368-395)."""
    max_partitions_contributed: int
    budget_weight: float = 1
    partition_selection_strategy: PartitionSelectionStrategy = (
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC)
    pre_threshold: Optional[int] = None

    def __post_init__(self):
        if self.pre_threshold is not None:
            _check_is_positive_int(self.pre_threshold, "pre_threshold")

    def __str__(self):
        return "Private Partitions"


def _not_a_proper_number(num: Any) -> bool:
    return math.isnan(num) or math.isinf(num)


def _check_is_positive_int(num: Any, field_name: str) -> None:
    if not (_is_int(num) and num > 0):
        raise ValueError(
            f"{field_name} has to be positive integer, but {num} given.")


def _count_not_none(*args):
    return sum(1 for arg in args if arg is not None)


def _is_int(value: Any) -> bool:
    return isinstance(value, (int, np.integer))


def _append_if_present(obj: Any, property_name: str, n_spaces: int,
                       res: List[str]):
    if not hasattr(obj, property_name):
        return
    value = getattr(obj, property_name)
    if value is None:
        return
    res.append(" " * n_spaces + f"{property_name}={value}")


def parameters_to_readable_string(params,
                                  is_public_partition: Optional[bool] = None
                                 ) -> str:
    """Human-readable rendering used in Explain Computation reports
    (reference :594-625)."""
    result = [f"{type(params).__name__}:"]
    if hasattr(params, "metrics_str"):
        result.append(f" {params.metrics_str}")
    if hasattr(params, "noise_kind"):
        result.append(f" noise_kind={params.noise_kind.value}")
    if hasattr(params, "budget_weight"):
        result.append(f" budget_weight={params.budget_weight}")
    result.append(" Contribution bounding:")
    for name in ("max_partitions_contributed",
                 "max_contributions_per_partition", "max_contributions",
                 "min_value", "max_value", "min_sum_per_partition",
                 "max_sum_per_partition"):
        _append_if_present(params, name, 2, result)
    if getattr(params, "contribution_bounds_already_enforced", False):
        result.append("  contribution_bounds_already_enforced=True")
    for name in ("vector_max_norm", "vector_size", "vector_norm_kind"):
        _append_if_present(params, name, 2, result)

    if is_public_partition is not None:
        type_str = ("public"
                    if is_public_partition else "private") + " partitions"
        result.append(f" Partition selection: {type_str}")

    return "\n".join(result)
