"""Data extractors: how to pull (privacy_id, partition_key, value) out of rows.

Port of pipelinedp_tpu/data_extractors.py (DataExtractors and
PreAggregateExtractors). The callables run on the host during columnar
encoding (columnar.py) and in the generic backend pipelines of the utility
analysis; the device sees only columns.
"""

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class DataExtractors:
    """Functions that extract the needed pieces of information from a row."""
    privacy_id_extractor: Optional[Callable] = None
    partition_extractor: Optional[Callable] = None
    value_extractor: Optional[Callable] = None


@dataclass
class PreAggregateExtractors:
    """Extractors for pre-aggregated data.

    Pre-aggregated rows have form (partition_key, preaggregate_data), where
    preaggregate_data = (count, sum, n_partitions, n_contributions) describes
    one privacy unit's contributions to that partition.
    """
    partition_extractor: Callable
    preaggregate_extractor: Callable
