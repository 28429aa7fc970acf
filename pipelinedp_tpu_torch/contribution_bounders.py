"""Contribution bounders over the generic backend vocabulary.

Port of pipelinedp_tpu/contribution_bounders.py: the ContributionBounder
interface and collect_values_per_partition_key_per_privacy_id, which the
utility analysis's bounder (analysis/contribution_bounders.py) calls. The
DP sampling bounders of that module are ROADMAP.md Queue 1 item 14; the
port's DPEngine bounds contributions on the card (C1, C2).
"""

import abc
import collections
from typing import Callable, Iterable


class ContributionBounder(abc.ABC):
    """Interface for contribution-bounding strategies."""

    @abc.abstractmethod
    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn: Callable):
        """Bounds contributions and aggregates per (privacy_id, partition_key).

        Args:
          col: collection of (privacy_id, partition_key, value).
          params: AggregateParams with the bounds.
          backend: PipelineBackend.
          report_generator: ReportGenerator to narrate the stages.
          aggregate_fn: list-of-values -> accumulator.

        Returns:
          collection of ((privacy_id, partition_key), accumulator).
        """


def collect_values_per_partition_key_per_privacy_id(col, backend):
    """(privacy_id, [(pk, value)]) -> (privacy_id, [(pk, [values])])."""

    def collect_fn(pk_value_pairs: Iterable):
        d = collections.defaultdict(list)
        for pk, value in pk_value_pairs:
            d[pk].append(value)
        return list(d.items())

    return backend.map_values(
        col, collect_fn, "Collect values per privacy_id and partition_key")
