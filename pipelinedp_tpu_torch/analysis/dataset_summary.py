"""Dataset summary: public-partition coverage statistics.

Capability parity with the reference ``analysis/dataset_summary.py:21-108``.

Port of pipelinedp_tpu/analysis/dataset_summary.py.
"""

import dataclasses
from typing import Iterable

from pipelinedp_tpu_torch import data_extractors as extractors
from pipelinedp_tpu_torch import pipeline_backend


@dataclasses.dataclass
class PublicPartitionsSummary:
    num_dataset_public_partitions: int
    num_dataset_non_public_partitions: int
    num_empty_public_partitions: int


_DATASET_PUBLIC = 1
_EMPTY_PUBLIC = 2
_DATASET_NONPUBLIC = 3


def compute_public_partitions_summary(
        col, backend: pipeline_backend.PipelineBackend,
        data_extractors: extractors.DataExtractors, public_partitions):
    """Counts dataset∩public, dataset∖public, and empty public partitions.

    Returns a 1-element collection with a PublicPartitionsSummary.
    """
    dataset_partitions = backend.map(col, data_extractors.partition_extractor,
                                     "Extract partitions")
    dataset_partitions = backend.distinct(dataset_partitions, "Distinct")
    dataset_partitions = backend.map(dataset_partitions, lambda x: (x, True),
                                     "Keyed by partition")
    public_partitions = backend.map(public_partitions, lambda x: (x, False),
                                    "Keyed by partition")
    partitions = backend.flatten([dataset_partitions, public_partitions],
                                 "flatten")
    col = backend.group_by_key(partitions, "Group by Key")

    def process_fn(_, flags: Iterable[bool]) -> int:
        flags = list(flags)
        if len(flags) == 2:
            return _DATASET_PUBLIC
        if flags[0]:
            return _DATASET_NONPUBLIC
        return _EMPTY_PUBLIC

    col = backend.map_tuple(col, process_fn, "Get Partition Type")
    col = backend.count_per_element(col, "Count partition types")
    col = backend.to_list(col, "To list")

    def to_summary(partition_types_count: list) -> PublicPartitionsSummary:
        num_dataset_public = num_dataset_non_public = num_empty_public = 0
        for partition_type, count in partition_types_count:
            if partition_type == _DATASET_PUBLIC:
                num_dataset_public = count
            elif partition_type == _DATASET_NONPUBLIC:
                num_dataset_non_public = count
            else:
                num_empty_public = count
        return PublicPartitionsSummary(num_dataset_public,
                                       num_dataset_non_public,
                                       num_empty_public)

    return backend.map(col, to_summary, "ToSummary")
