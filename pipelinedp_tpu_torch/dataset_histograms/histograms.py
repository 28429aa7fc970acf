"""Histogram dataclasses for dataset contribution statistics.

Port of pipelinedp_tpu/dataset_histograms/histograms.py: FrequencyBin,
HistogramType, Histogram (with its quantile and total queries),
DatasetHistograms and ``compute_ratio_dropped``, vectorized with numpy.
"""

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass
class FrequencyBin:
    """One histogram bin over ``[lower, upper)`` (last float bin is closed).

    Reference semantics: ``histograms.py:21-57``.

    Attributes:
        lower: lower bound of the bin (inclusive).
        upper: upper bound of the bin (exclusive, except the last bin of a
            floating histogram where it is inclusive).
        count: number of elements in the bin.
        sum: sum of elements in the bin.
        max: maximum element in the bin (<= upper).
    """
    lower: Union[int, float]
    upper: Union[int, float]
    count: int
    sum: Union[int, float]
    max: Union[int, float]

    def __add__(self, other: 'FrequencyBin') -> 'FrequencyBin':
        assert self.lower == other.lower
        assert self.upper == other.upper
        return FrequencyBin(self.lower, self.upper, self.count + other.count,
                            self.sum + other.sum, max(self.max, other.max))

    def __eq__(self, other) -> bool:
        return (self.lower == other.lower and self.count == other.count and
                self.sum == other.sum and self.max == other.max)


class HistogramType(enum.Enum):
    """Reference: ``histograms.py:60-75``."""
    # 'count' = number of privacy units contributing to [lower, upper)
    # partitions; 'sum' = total (privacy_unit, partition) pairs for them.
    L0_CONTRIBUTIONS = 'l0_contributions'
    L1_CONTRIBUTIONS = 'l1_contributions'
    # 'count' = number of (privacy_unit, partition) pairs with [lower, upper)
    # contributions; 'sum' = total contributions for those pairs.
    LINF_CONTRIBUTIONS = 'linf_contributions'
    LINF_SUM_CONTRIBUTIONS = 'linf_sum_contributions'
    COUNT_PER_PARTITION = 'count_per_partition'
    COUNT_PRIVACY_ID_PER_PARTITION = 'privacy_id_per_partition_count'


@dataclasses.dataclass
class Histogram:
    """Histogram over numbers; integer (log-binned) or floating (equal bins).

    Reference: ``histograms.py:78-158``.
    """
    name: HistogramType
    bins: List[FrequencyBin]
    lower: Union[None, int, float] = dataclasses.field(init=False)
    upper: Union[None, float] = dataclasses.field(init=False)

    def __post_init__(self):
        if len(self.bins) == 0:
            self.lower = self.upper = None
        else:
            self.lower = 1 if self.is_integer else self.bins[0].lower
            self.upper = None if self.is_integer else self.bins[-1].upper

    @property
    def is_integer(self) -> bool:
        return self.name != HistogramType.LINF_SUM_CONTRIBUTIONS

    def total_count(self) -> int:
        return int(sum(b.count for b in self.bins))

    def total_sum(self):
        return sum(b.sum for b in self.bins)

    def max_value(self):
        return self.bins[-1].max

    def quantiles(self, q: Sequence[float]) -> List[int]:
        """Approximate quantiles: bin lowers such that the mass strictly left
        of the bin is <= q. Vectorized equivalent of ``histograms.py:126-158``.
        """
        assert sorted(q) == list(q), "Quantiles to compute must be sorted."
        counts = np.array([b.count for b in self.bins], dtype=np.float64)
        total = counts.sum()
        if total == 0:
            raise ValueError("Cannot compute quantiles of an empty histogram")
        # ratio of data strictly left of each bin
        left_ratio = (np.cumsum(counts) - counts) / total
        lowers = [b.lower for b in self.bins]
        # for each q: the LAST bin whose left_ratio <= q
        idx = np.searchsorted(left_ratio, np.asarray(q), side='right') - 1
        idx = np.clip(idx, 0, len(lowers) - 1)
        return [lowers[i] for i in idx]


def compute_ratio_dropped(
        contribution_histogram: Histogram) -> Sequence[Tuple[int, float]]:
    """Ratio of data dropped per candidate bounding threshold.

    For each bin lower L of the contribution histogram: the fraction of total
    contributions that would be dropped if L were used as the bounding
    threshold (sum over elements of max(0, x - L) / total_sum). ``(0, 1)`` is
    prepended; the histogram max is appended with ratio 0 when it is not a bin
    lower. Vectorized equivalent of the reference's reverse scan
    (``histograms.py:161-200``).
    """
    bins = contribution_histogram.bins
    if not bins:
        return []
    lowers = np.array([b.lower for b in bins], dtype=np.float64)
    counts = np.array([b.count for b in bins], dtype=np.float64)
    sums = np.array([b.sum for b in bins], dtype=np.float64)
    total_sum = sums.sum()

    thresholds = list(lowers)
    max_value = contribution_histogram.max_value()
    append_max = (max_value != bins[-1].lower)

    # Reverse-cumulative machinery: for threshold t = lowers[i],
    # dropped(t) = sum_{j>=i} (sums[j] - counts[j]*clip_at_t) where elements
    # in bin j are approximated as sitting at their bin values. The reference
    # computes it with an exact reverse scan using bin sums/counts; replicate
    # that recurrence vectorized.
    n = len(bins)
    # elements_larger[i] = count of elements in bins strictly above i
    elements_larger = np.concatenate(
        [np.cumsum(counts[::-1])[::-1][1:], [0.0]])
    # Recurrence (histograms.py:192-198), scanning high→low:
    #   dropped += elements_larger*(previous_value-current) + (bin.sum -
    #              bin.count*current)
    # n is small (log-binned), so a host scan is fine.
    per_bin_term = (sums - counts * lowers)
    acc = 0.0
    out = []
    prev = lowers[-1]
    for i in range(n - 1, -1, -1):
        cur = lowers[i]
        acc += (elements_larger[i] * (prev - cur)) + per_bin_term[i]
        out.append((thresholds[i], acc / total_sum))
        prev = cur
    result = []
    if append_max:
        result.append((max_value, 0.0))
    result.extend(out)
    result.append((0, 1))
    return result[::-1]


@dataclasses.dataclass
class DatasetHistograms:
    """Histograms useful for parameter tuning (``histograms.py:203-211``)."""
    l0_contributions_histogram: Optional[Histogram]
    l1_contributions_histogram: Optional[Histogram]
    linf_contributions_histogram: Optional[Histogram]
    linf_sum_contributions_histogram: Optional[Histogram]
    count_per_partition_histogram: Optional[Histogram]
    count_privacy_id_per_partition: Optional[Histogram]
