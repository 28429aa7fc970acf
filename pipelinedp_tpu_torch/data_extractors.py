"""Data extractors: how to pull (privacy_id, partition_key, value) out of rows.

Port of pipelinedp_tpu/data_extractors.py. The callables run on the host
during columnar encoding (columnar.py); the device sees only columns.
"""

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class DataExtractors:
    """Functions that extract the needed pieces of information from a row."""
    privacy_id_extractor: Optional[Callable] = None
    partition_extractor: Optional[Callable] = None
    value_extractor: Optional[Callable] = None
