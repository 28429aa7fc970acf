"""Differentially-private partition selection strategies (host side).

Port of pipelinedp_tpu/partition_selection.py: the closed forms of the
three strategies. The release kernel evaluates them per partition on the
device from the scalars these objects precompute
(ops/selection_ops.selection_params_from_host); `probability_of_keep`
stays here as the host reference.

  * TRUNCATED_GEOMETRIC — the optimal partition selection of Desfontaines,
    Voss, Gipson & Mandayam (2020), closed form of its recurrence with
    eps' = eps / l0, delta' = delta / l0.
  * LAPLACE_THRESHOLDING — count + Laplace(l0/eps) against a threshold
    calibrated so the total delta is respected.
  * GAUSSIAN_THRESHOLDING — count + N(0, sigma^2) with analytic sigma at
    (eps, delta/2) and a threshold calibrated with the remaining delta/2.
"""

import abc
import functools
import math
from typing import Optional

import numpy as np
from scipy import special

from pipelinedp_tpu_torch.aggregate_params import PartitionSelectionStrategy
from pipelinedp_tpu_torch import dp_computations


class PartitionSelector(abc.ABC):
    """DP partition-selection strategy built from privacy-id counts."""

    def __init__(self, epsilon: float, delta: float,
                 max_partitions_contributed: int,
                 pre_threshold: Optional[int]):
        if epsilon <= 0:
            raise ValueError(f"epsilon must be positive, got {epsilon}")
        if delta <= 0 or delta >= 1:
            raise ValueError(
                f"Partition selection requires delta in (0, 1), got {delta}")
        if max_partitions_contributed <= 0:
            raise ValueError("max_partitions_contributed must be positive")
        if pre_threshold is not None and pre_threshold <= 0:
            raise ValueError("pre_threshold must be positive")
        self._epsilon = epsilon
        self._delta = delta
        self._l0 = max_partitions_contributed
        self._pre_threshold = pre_threshold

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @property
    def delta(self) -> float:
        return self._delta

    @property
    def max_partitions_contributed(self) -> int:
        return self._l0

    @property
    def pre_threshold(self) -> Optional[int]:
        return self._pre_threshold

    def _apply_pre_threshold(self, n):
        """Shifts counts by the pre-threshold: counts below it never keep;
        the DP decision sees n - (pre_threshold - 1)."""
        if self._pre_threshold is None:
            return n
        return n - (self._pre_threshold - 1)

    def probability_of_keep(self, num_privacy_ids: int) -> float:
        """Exact keep probability for a partition with the given number of
        contributing privacy units."""
        n = self._apply_pre_threshold(num_privacy_ids)
        if n <= 0:
            return 0.0
        return float(self._probability_of_keep_shifted(np.asarray([n]))[0])

    @abc.abstractmethod
    def _probability_of_keep_shifted(self, n: np.ndarray) -> np.ndarray:
        """probability of keep on pre-threshold-shifted counts n >= 1."""


class TruncatedGeometricPartitionSelector(PartitionSelector):
    """Optimal partition selection (truncated geometric), closed form.

    Phase 1 (n <= n_cross):  pi_n = delta' (e^{n eps'} - 1)/(e^{eps'} - 1)
    Phase 2 (n > n_cross):   1 - pi_n decays geometrically with rate e^{-eps'}
    The crossover is the largest n with pi_{n-1} <= (1 - delta')/(1 + e^{eps'}).
    """

    def __init__(self, epsilon, delta, max_partitions_contributed,
                 pre_threshold=None):
        super().__init__(epsilon, delta, max_partitions_contributed,
                         pre_threshold)
        self._eps1 = self._epsilon / self._l0
        self._delta1 = self._delta / self._l0
        d1 = self._delta1
        # Largest n such that phase-1 still applies to step n (i.e.
        # pi_{n-1} <= (1 - d1)/(1 + e^eps1)). The ratio is computed via
        # tanh(eps1/2) = (e-1)/(e+1), which never overflows for huge eps.
        t = math.tanh(self._eps1 / 2)
        self._n_cross = 1 + int(
            math.floor(math.log1p(t * (1.0 - d1) / d1) / self._eps1))
        self._pi_cross = float(self._phase1(self._n_cross))

    def _phase1(self, n):
        # pi_n = d1 * (e^{n eps1} - 1) / (e^{eps1} - 1) evaluated in log
        # space (overflow-safe for huge eps):
        # log pi_n = log d1 + (n-1) eps1 + log1p(-e^{-n eps1})
        #            - log1p(-e^{-eps1}).
        n = np.asarray(n, dtype=np.float64)
        log_pi = (math.log(self._delta1) + (n - 1.0) * self._eps1 +
                  np.log1p(-np.exp(-n * self._eps1)) -
                  math.log1p(-math.exp(-self._eps1)))
        return np.exp(np.minimum(log_pi, 0.0))

    def _probability_of_keep_shifted(self, n: np.ndarray) -> np.ndarray:
        n = np.asarray(n, dtype=np.float64)
        pi1 = np.minimum(self._phase1(np.minimum(n, self._n_cross)), 1.0)
        # Phase 2: q_{n_cross + k} = e^{-k eps1} q_cross
        #          - d1 e^{-eps1}(1 - e^{-k eps1})/(1 - e^{-eps1})
        k = np.maximum(n - self._n_cross, 0.0)
        q_cross = 1.0 - self._pi_cross
        decay = np.exp(-k * self._eps1)
        geo = (math.exp(-self._eps1) * (1.0 - decay) /
               (1.0 - math.exp(-self._eps1)))
        q = decay * q_cross - self._delta1 * geo
        pi2 = 1.0 - np.maximum(q, 0.0)
        return np.clip(np.where(n <= self._n_cross, pi1, pi2), 0.0, 1.0)


class LaplaceThresholdingPartitionSelector(PartitionSelector):
    """Laplace noisy-threshold partition selection.

    Noise scale b = l0 / eps (count of one user changes by 1 in each of at
    most l0 partitions). Per-partition delta is 1 - (1 - delta)^(1/l0); the
    threshold t solves P(1 + Lap(b) >= t) = delta_p, giving
    t = 1 - b ln(2 delta_p) for delta_p <= 1/2.
    """

    def __init__(self, epsilon, delta, max_partitions_contributed,
                 pre_threshold=None):
        super().__init__(epsilon, delta, max_partitions_contributed,
                         pre_threshold)
        self._b = self._l0 / self._epsilon
        delta_p = -math.expm1(math.log1p(-self._delta) / self._l0)
        if delta_p <= 0.5:
            self._threshold = 1.0 - self._b * math.log(2 * delta_p)
        else:
            self._threshold = 1.0 + self._b * math.log(2 - 2 * delta_p)

    @property
    def threshold(self) -> float:
        return self._threshold

    def _probability_of_keep_shifted(self, n: np.ndarray) -> np.ndarray:
        # P(n + Lap(b) >= t) — Laplace survival function. np.where
        # evaluates BOTH branches, so each exp sees only the half-line it
        # is selected on (clipped z): exp of a large positive z in the
        # dead branch would overflow-warn even though its value is never
        # used.
        z = (np.asarray(n, dtype=np.float64) - self._threshold) / self._b
        return np.where(z >= 0, 1.0 - 0.5 * np.exp(-np.maximum(z, 0.0)),
                        0.5 * np.exp(np.minimum(z, 0.0)))


class GaussianThresholdingPartitionSelector(PartitionSelector):
    """Gaussian noisy-threshold partition selection.

    Budget split: delta/2 to calibrate sigma at (eps, delta/2) with l2
    sensitivity sqrt(l0); delta/2 (adjusted per partition) to set the
    threshold t = 1 + sigma * Phi^{-1}(1 - delta_p).
    """

    def __init__(self, epsilon, delta, max_partitions_contributed,
                 pre_threshold=None):
        super().__init__(epsilon, delta, max_partitions_contributed,
                         pre_threshold)
        noise_delta = self._delta / 2
        threshold_delta = self._delta - noise_delta
        self._sigma = dp_computations.gaussian_sigma(self._epsilon,
                                                     noise_delta,
                                                     math.sqrt(self._l0))
        delta_p = -math.expm1(math.log1p(-threshold_delta) / self._l0)
        # Phi^{-1}(1 - delta_p) via erfcinv: Phi^{-1}(p)=-sqrt(2)erfcinv(2p).
        quantile = -math.sqrt(2) * special.erfcinv(2 * (1 - delta_p))
        self._threshold = 1.0 + self._sigma * quantile

    @property
    def sigma(self) -> float:
        return self._sigma

    @property
    def threshold(self) -> float:
        return self._threshold

    def _probability_of_keep_shifted(self, n: np.ndarray) -> np.ndarray:
        z = (self._threshold - np.asarray(n, dtype=np.float64)) / self._sigma
        return 0.5 * special.erfc(z / math.sqrt(2))


_STRATEGY_TO_CLASS = {
    PartitionSelectionStrategy.TRUNCATED_GEOMETRIC:
        TruncatedGeometricPartitionSelector,
    PartitionSelectionStrategy.LAPLACE_THRESHOLDING:
        LaplaceThresholdingPartitionSelector,
    PartitionSelectionStrategy.GAUSSIAN_THRESHOLDING:
        GaussianThresholdingPartitionSelector,
}


@functools.lru_cache(maxsize=256)
def create_partition_selection_strategy(
        strategy: PartitionSelectionStrategy,
        epsilon: float,
        delta: float,
        max_partitions_contributed: int,
        pre_threshold: Optional[int] = None) -> PartitionSelector:
    """Creates a partition-selection strategy object
    (reference-parity factory: pipeline_dp/partition_selection.py:29-44).

    Cached: selectors are deterministic in their parameters, and the engine's
    per-partition filter would otherwise re-run the (bisection-heavy)
    calibration once per partition.
    """
    cls = _STRATEGY_TO_CLASS.get(strategy)
    if cls is None:
        raise ValueError(f"Unknown partition selection strategy {strategy}")
    return cls(epsilon, delta, max_partitions_contributed, pre_threshold)
