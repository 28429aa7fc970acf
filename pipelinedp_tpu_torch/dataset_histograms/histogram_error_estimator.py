"""Estimation of DP-pipeline error from DatasetHistograms.

Port of pipelinedp_tpu/dataset_histograms/histogram_error_estimator.py
(COUNT / PRIVACY_ID_COUNT only; partition-selection error not modeled),
numpy.
"""

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch.dataset_histograms import histograms as hist


class CountErrorEstimator:
    """Estimates contribution-bounding + noise RMSE from histograms.

    Create with :func:`create_error_estimator`.
    """

    def __init__(self, base_std: float, metric: agg.Metric,
                 noise: agg.NoiseKind,
                 l0_ratios_dropped: Sequence[Tuple[int, float]],
                 linf_ratios_dropped: Sequence[Tuple[int, float]],
                 partition_histogram: hist.Histogram):
        self._base_std = base_std
        self._metric = metric
        self._noise = noise
        self._l0_ratios_dropped = l0_ratios_dropped
        self._linf_ratios_dropped = linf_ratios_dropped
        self._partition_histogram = partition_histogram

    def estimate_rmse(self,
                      l0_bound: int,
                      linf_bound: Optional[int] = None) -> float:
        """RMSE estimate for given l0/linf bounds.

        Assumes contribution bounding drops data uniformly over partitions:
        per partition of size n, rmse = sqrt((n*ratio_dropped)^2 + std^2),
        averaged over partitions (reference ``:44-81``).
        """
        if self._metric == agg.Metrics.COUNT and linf_bound is None:
            raise ValueError("linf must be given for COUNT")
        ratio_dropped_l0 = self.get_ratio_dropped_l0(l0_bound)
        ratio_dropped_linf = 0.0
        if self._metric == agg.Metrics.COUNT:
            ratio_dropped_linf = self.get_ratio_dropped_linf(linf_bound)
        ratio_dropped = 1 - (1 - ratio_dropped_l0) * (1 - ratio_dropped_linf)
        stddev = self._get_stddev(l0_bound, linf_bound)
        return _estimate_rmse_impl(ratio_dropped, stddev,
                                   self._partition_histogram)

    def get_ratio_dropped_l0(self, l0_bound: int) -> float:
        return self._get_ratio_dropped(self._l0_ratios_dropped, l0_bound)

    def get_ratio_dropped_linf(self, linf_bound: int) -> float:
        return self._get_ratio_dropped(self._linf_ratios_dropped, linf_bound)

    def _get_ratio_dropped(self, ratios_dropped: Sequence[Tuple[int, float]],
                           bound: int) -> float:
        """Linear interpolation in the (threshold, ratio) table."""
        if bound <= 0:
            return 1.0
        xs = np.array([x for x, _ in ratios_dropped], dtype=np.float64)
        ys = np.array([y for _, y in ratios_dropped], dtype=np.float64)
        if bound > xs[-1]:
            return 0.0
        return float(np.interp(bound, xs, ys))

    def _get_stddev(self,
                    l0_bound: int,
                    linf_bound: Optional[int] = None) -> float:
        if self._metric == agg.Metrics.PRIVACY_ID_COUNT:
            linf_bound = 1
        if self._noise == agg.NoiseKind.LAPLACE:
            return self._base_std * l0_bound * linf_bound
        return self._base_std * math.sqrt(l0_bound) * linf_bound


def create_error_estimator(histograms: hist.DatasetHistograms, base_std: float,
                           metric: agg.Metric,
                           noise: agg.NoiseKind) -> CountErrorEstimator:
    """Creates the estimator for COUNT or PRIVACY_ID_COUNT.

    base_std: noise std when l0 = linf = 1.
    """
    if metric not in [agg.Metrics.COUNT, agg.Metrics.PRIVACY_ID_COUNT]:
        raise ValueError("Only COUNT and PRIVACY_ID_COUNT are supported, "
                         f"but metric={metric}")
    l0_ratios_dropped = hist.compute_ratio_dropped(
        histograms.l0_contributions_histogram)
    linf_ratios_dropped = hist.compute_ratio_dropped(
        histograms.linf_contributions_histogram)
    if metric == agg.Metrics.COUNT:
        partition_histogram = histograms.count_per_partition_histogram
    else:
        partition_histogram = histograms.count_privacy_id_per_partition
    return CountErrorEstimator(base_std, metric, noise, l0_ratios_dropped,
                               linf_ratios_dropped, partition_histogram)


def _estimate_rmse_impl(ratio_dropped: float, std: float,
                        partition_histogram: hist.Histogram) -> float:
    counts = np.array([b.count for b in partition_histogram.bins],
                      dtype=np.float64)
    sums = np.array([b.sum for b in partition_histogram.bins],
                    dtype=np.float64)
    avg_sizes = sums / counts
    rmse = np.sqrt((ratio_dropped * avg_sizes)**2 + std**2)
    return float(np.sum(counts * rmse) / counts.sum())
