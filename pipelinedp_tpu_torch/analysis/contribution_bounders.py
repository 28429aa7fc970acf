"""Contribution bounders for utility analysis.

Capability parity with the reference ``analysis/contribution_bounders.py``:
no actual bounding — emits per-(privacy_id, partition) aggregates
(count, sum, n_partitions, n_contributions) plus deterministic partition
sampling, so downstream combiners can model what bounding WOULD drop.

Port of pipelinedp_tpu/analysis/contribution_bounders.py.
"""

from pipelinedp_tpu_torch import contribution_bounders
from pipelinedp_tpu_torch import sampling_utils


class AnalysisContributionBounder(contribution_bounders.ContributionBounder):
    """Tracks (not enforces) per/cross-partition contribution statistics.

    Emits ((pid, pk), aggregate_fn((count, sum, n_partitions,
    n_contributions))) per contributed pair. When partitions_sampling_prob <
    1, partitions are dropped deterministically by key hash
    (reference ``analysis/contribution_bounders.py:19-77``).
    """

    def __init__(self, partitions_sampling_prob: float):
        super().__init__()
        self._sampling_probability = partitions_sampling_prob

    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn):
        col = backend.map_tuple(
            col, lambda pid, pk, v: (pid, (pk, v)),
            "Rekey to (privacy_id, (partition_key, value))")
        col = backend.group_by_key(
            col, "Group by privacy_id")
        # (privacy_id, [(partition_key, value)])
        col = (contribution_bounders.
               collect_values_per_partition_key_per_privacy_id(col, backend))
        # (privacy_id, [(partition_key, [value])])

        sampler = sampling_utils.ValueSampler(
            self._sampling_probability
        ) if self._sampling_probability < 1 else None

        def unnest_and_rekey(pid_pk_v_values):
            privacy_id, partition_values = pid_pk_v_values
            num_partitions_contributed = len(partition_values)
            num_contributions = sum(
                len(values) for _, values in partition_values)
            for partition_key, values in partition_values:
                if sampler is not None and not sampler.keep(partition_key):
                    continue
                yield (privacy_id, partition_key), (len(values), sum(values),
                                                    num_partitions_contributed,
                                                    num_contributions)

        col = backend.flat_map(col, unnest_and_rekey, "Unnest per-privacy_id")
        return backend.map_values(col, aggregate_fn, "Apply aggregate_fn")


class NoOpContributionBounder(contribution_bounders.ContributionBounder):
    """Passes pre-aggregated rows straight through (reference ``:80-88``)."""

    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn):
        return backend.map_tuple(
            col, lambda pid, pk, val: ((pid, pk), aggregate_fn(val)),
            "Apply aggregate_fn")
