"""API dataclasses for utility analysis.

Capability parity with the reference ``analysis/data_structures.py:25-151``.

Port of pipelinedp_tpu/analysis/data_structures.py.
"""

import copy
import dataclasses
from typing import Iterable, Optional, Sequence

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import input_validators


@dataclasses.dataclass
class MultiParameterConfiguration:
    """Parameter sweeps for multi-parameter utility analysis.

    Each attribute mirrors one in AggregateParams and holds a sequence of
    values; all non-None attributes must have the same length N, defining N
    parameter configurations analyzed simultaneously
    (reference ``data_structures.py:25-96``).
    """
    max_partitions_contributed: Sequence[int] = None
    max_contributions_per_partition: Sequence[int] = None
    min_sum_per_partition: Sequence[float] = None
    max_sum_per_partition: Sequence[float] = None
    noise_kind: Sequence[agg.NoiseKind] = None
    partition_selection_strategy: Sequence[
        agg.PartitionSelectionStrategy] = None

    def __post_init__(self):
        attributes = dataclasses.asdict(self)
        sizes = [len(value) for value in attributes.values() if value]
        if not sizes:
            raise ValueError("MultiParameterConfiguration must have at least 1"
                             " non-empty attribute.")
        if min(sizes) != max(sizes):
            raise ValueError(
                "All set attributes in MultiParameterConfiguration must have "
                "the same length.")
        if (self.min_sum_per_partition is None) != (self.max_sum_per_partition
                                                    is None):
            raise ValueError(
                "MultiParameterConfiguration: min_sum_per_partition and "
                "max_sum_per_partition must be both set or both None.")
        self._size = sizes[0]

    @property
    def size(self):
        return self._size

    def get_aggregate_params(self, params: agg.AggregateParams,
                             index: int) -> agg.AggregateParams:
        """Returns AggregateParams with the index-th parameters applied."""
        params = copy.copy(params)
        if self.max_partitions_contributed:
            params.max_partitions_contributed = (
                self.max_partitions_contributed[index])
        if self.max_contributions_per_partition:
            params.max_contributions_per_partition = (
                self.max_contributions_per_partition[index])
        if self.min_sum_per_partition:
            params.min_sum_per_partition = self.min_sum_per_partition[index]
        if self.max_sum_per_partition:
            params.max_sum_per_partition = self.max_sum_per_partition[index]
        if self.noise_kind:
            params.noise_kind = self.noise_kind[index]
        if self.partition_selection_strategy:
            params.partition_selection_strategy = (
                self.partition_selection_strategy[index])
        return params


@dataclasses.dataclass
class UtilityAnalysisOptions:
    """Options for the utility analysis (reference ``:100-121``)."""
    epsilon: float
    delta: float
    aggregate_params: agg.AggregateParams
    multi_param_configuration: Optional[MultiParameterConfiguration] = None
    partitions_sampling_prob: float = 1
    pre_aggregated_data: bool = False

    def __post_init__(self):
        input_validators.validate_epsilon_delta(self.epsilon, self.delta,
                                                "UtilityAnalysisOptions")
        if (self.partitions_sampling_prob <= 0 or
                self.partitions_sampling_prob > 1):
            raise ValueError(
                "partitions_sampling_prob must be in the interval"
                f" (0, 1], but {self.partitions_sampling_prob} given.")

    @property
    def n_configurations(self):
        if self.multi_param_configuration is None:
            return 1
        return self.multi_param_configuration.size


def get_aggregate_params(
        options: UtilityAnalysisOptions) -> Iterable[agg.AggregateParams]:
    """Yields the AggregateParams of every configuration in the options."""
    multi_param = options.multi_param_configuration
    if multi_param is None:
        yield options.aggregate_params
    else:
        for i in range(multi_param.size):
            yield multi_param.get_aggregate_params(options.aggregate_params, i)


def get_partition_selection_strategy(
    options: UtilityAnalysisOptions
) -> Sequence[agg.PartitionSelectionStrategy]:
    """Partition selection strategy per configuration (reference ``:137-151``)."""
    multi_configuration = options.multi_param_configuration
    n_configurations = 1
    if multi_configuration is not None:
        if multi_configuration.partition_selection_strategy is not None:
            return multi_configuration.partition_selection_strategy
        n_configurations = multi_configuration.size
    return [options.aggregate_params.partition_selection_strategy
           ] * n_configurations
