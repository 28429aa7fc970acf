"""Host-side DP calibration of the port.

Port of the host calibration in pipelinedp_tpu/dp_computations.py: the
analytic Gaussian sigma (`gaussian_sigma`, :159), the variance noise stds
(`compute_dp_var_noise_stds`, :378), VECTOR_SUM's per-coordinate noise
(`AdditiveVectorNoiseParams`, `vector_noise_std`, :232-270), the
mechanisms' standard deviations and descriptions, and the
`compute_sensitivities_*` functions (:1133 on).
numpy/scipy only; the noise itself is drawn on the device by the release
kernel, so these mechanisms carry no host sampler.
"""

import abc
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from scipy.special import log_ndtr

from pipelinedp_tpu_torch import aggregate_params
from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch.aggregate_params import NoiseKind


def compute_squares_interval(min_value: float,
                             max_value: float) -> Tuple[float, float]:
    """Bounds of {x^2 : x in [min_value, max_value]}."""
    if min_value < 0 < max_value:
        return 0, max(min_value**2, max_value**2)
    return min_value**2, max_value**2


def compute_middle(min_value: float, max_value: float) -> float:
    """Overflow-safe midpoint of [min_value, max_value]."""
    return min_value + (max_value - min_value) / 2


def compute_l1_sensitivity(l0_sensitivity: float,
                           linf_sensitivity: float) -> float:
    return l0_sensitivity * linf_sensitivity


def compute_l2_sensitivity(l0_sensitivity: float,
                           linf_sensitivity: float) -> float:
    return math.sqrt(l0_sensitivity) * linf_sensitivity


def _norm_cdf(z: float) -> float:
    return 0.5 * math.erfc(-z / math.sqrt(2))


def gaussian_delta(sigma: float, eps: float, l2_sensitivity: float) -> float:
    """Exact delta of the Gaussian mechanism (Balle & Wang 2018, Thm. 8)."""
    d = l2_sensitivity
    a = d / (2 * sigma) - eps * sigma / d
    b = -d / (2 * sigma) - eps * sigma / d
    # e^eps * Phi(b) in log space: math.exp overflows for large eps.
    log_term = eps + log_ndtr(b)
    second = math.exp(log_term) if log_term < 700 else math.inf
    return _norm_cdf(a) - second


def gaussian_sigma(eps: float,
                   delta: float,
                   l2_sensitivity: float,
                   tol: float = 1e-12) -> float:
    """Minimal sigma s.t. the Gaussian mechanism is (eps, delta)-DP
    (bisection on the monotone-decreasing gaussian_delta)."""
    if delta <= 0:
        raise ValueError("Gaussian mechanism requires delta > 0.")
    if delta >= 1:
        raise ValueError("delta must be < 1.")
    hi = l2_sensitivity * math.sqrt(2 * math.log(1.25 / delta)) / eps + 1e-12
    while gaussian_delta(hi, eps, l2_sensitivity) > delta:
        hi *= 2
    lo = hi
    while gaussian_delta(lo, eps, l2_sensitivity) < delta and lo > 1e-300:
        lo /= 2
    for _ in range(200):
        mid = (lo + hi) / 2
        if gaussian_delta(mid, eps, l2_sensitivity) > delta:
            lo = mid
        else:
            hi = mid
        if hi - lo <= tol * hi:
            break
    return hi


def equally_split_budget(eps: float, delta: float, no_mechanisms: int):
    """Splits (eps, delta) into no_mechanisms shares that sum exactly."""
    if no_mechanisms <= 0:
        raise ValueError("The number of mechanisms must be a positive integer.")
    eps_used = delta_used = 0
    budgets = []
    for _ in range(no_mechanisms - 1):
        budget = (eps / no_mechanisms, delta / no_mechanisms)
        eps_used += budget[0]
        delta_used += budget[1]
        budgets.append(budget)
    budgets.append((eps - eps_used, delta - delta_used))
    return budgets


def noise_std(eps: float, delta: float, l0_sensitivity: float,
              linf_sensitivity: float, noise_kind: NoiseKind) -> float:
    """Noise stddev of the additive mechanism with the given budget and
    (l0, linf) sensitivities."""
    if linf_sensitivity == 0:
        return 0.0
    if noise_kind == NoiseKind.LAPLACE:
        b = compute_l1_sensitivity(l0_sensitivity, linf_sensitivity) / eps
        return b * math.sqrt(2)
    if noise_kind == NoiseKind.GAUSSIAN:
        l2 = compute_l2_sensitivity(l0_sensitivity, linf_sensitivity)
        return gaussian_sigma(eps, delta, l2)
    raise ValueError("Only Laplace and Gaussian noise is supported.")


def compute_dp_var_noise_stds(eps: float, delta: float, l0: int, linf: int,
                              min_value: float, max_value: float,
                              noise_kind: NoiseKind) -> Tuple[float, float,
                                                              float]:
    """The three noise stddevs of the variance budget split (count,
    normalized sum, normalized sum of squares)."""
    (e1, d1), (e2, d2), (e3, d3) = equally_split_budget(eps, delta, 3)
    count_std = noise_std(e1, d1, l0, linf, noise_kind)
    mid = compute_middle(min_value, max_value)
    nsum_std = noise_std(e2, d2, l0, linf * abs(mid - min_value), noise_kind)
    sq_lo, sq_hi = compute_squares_interval(min_value, max_value)
    mid2 = compute_middle(sq_lo, sq_hi)
    nsum2_std = noise_std(e3, d3, l0, linf * abs(mid2 - sq_lo), noise_kind)
    return count_std, nsum_std, nsum2_std


@dataclass
class AdditiveVectorNoiseParams:
    """Calibration of VECTOR_SUM's per-coordinate noise
    (pipelinedp_tpu/dp_computations.py:232)."""
    eps_per_coordinate: float
    delta_per_coordinate: float
    max_norm: float
    l0_sensitivity: float
    linf_sensitivity: float
    norm_kind: aggregate_params.NormKind
    noise_kind: NoiseKind


def vector_noise_std(noise_params: AdditiveVectorNoiseParams) -> float:
    """Per-coordinate noise stddev of the vector sum."""
    if noise_params.noise_kind == NoiseKind.LAPLACE:
        l1 = compute_l1_sensitivity(noise_params.l0_sensitivity,
                                    noise_params.linf_sensitivity)
        return math.sqrt(2.0) * l1 / noise_params.eps_per_coordinate
    if noise_params.noise_kind == NoiseKind.GAUSSIAN:
        l2 = compute_l2_sensitivity(noise_params.l0_sensitivity,
                                    noise_params.linf_sensitivity)
        return gaussian_sigma(noise_params.eps_per_coordinate,
                              noise_params.delta_per_coordinate, l2)
    raise ValueError("Noise kind must be either Laplace or Gaussian.")


class AdditiveMechanism(abc.ABC):
    """Calibration of an additive DP mechanism (Laplace, Gaussian)."""

    @property
    @abc.abstractmethod
    def noise_parameter(self) -> float:
        """Noise distribution parameter (b for Laplace, sigma for Gauss)."""

    @property
    @abc.abstractmethod
    def std(self) -> float:
        """Noise standard deviation."""

    @property
    @abc.abstractmethod
    def sensitivity(self) -> float:
        """Mechanism sensitivity."""

    @abc.abstractmethod
    def describe(self) -> str:
        """Description for explain computation reports."""


class LaplaceMechanism(AdditiveMechanism):
    """Laplace mechanism: noise b = l1_sensitivity / eps."""

    def __init__(self, epsilon: float, l1_sensitivity: float):
        self._epsilon = epsilon
        self._l1_sensitivity = l1_sensitivity

    @property
    def noise_parameter(self) -> float:
        return self._l1_sensitivity / self._epsilon

    @property
    def std(self) -> float:
        return self.noise_parameter * math.sqrt(2)

    @property
    def sensitivity(self) -> float:
        return self._l1_sensitivity

    def describe(self) -> str:
        return (f"Laplace mechanism:  parameter={self.noise_parameter}  eps="
                f"{self._epsilon}  l1_sensitivity={self.sensitivity}")


class GaussianMechanism(AdditiveMechanism):
    """Gaussian mechanism with analytic (optimal) sigma calibration."""

    def __init__(self, epsilon: float, delta: float, l2_sensitivity: float):
        self._sigma = gaussian_sigma(epsilon, delta, l2_sensitivity)
        self._l2_sensitivity = l2_sensitivity
        self._epsilon = epsilon
        self._delta = delta

    @property
    def noise_parameter(self) -> float:
        return self._sigma

    @property
    def std(self) -> float:
        return self._sigma

    @property
    def sensitivity(self) -> float:
        return self._l2_sensitivity

    def describe(self) -> str:
        return (f"Gaussian mechanism:  parameter={self.noise_parameter}"
                f"  eps={self._epsilon}  delta={self._delta}  "
                f"l2_sensitivity={self.sensitivity}")


class MeanMechanism:
    """DP mean as DP(normalized sum) / DP(count) + mid."""

    def __init__(self, range_middle: float, count_mechanism: AdditiveMechanism,
                 sum_mechanism: AdditiveMechanism):
        self._range_middle = range_middle
        self._count_mechanism = count_mechanism
        self._sum_mechanism = sum_mechanism

    @property
    def count_mechanism(self) -> AdditiveMechanism:
        return self._count_mechanism

    @property
    def sum_mechanism(self) -> AdditiveMechanism:
        return self._sum_mechanism

    def describe(self) -> str:
        return (f"    a. Computed 'normalized_sum' = sum of (value - "
                f"{self._range_middle})\n"
                f"    b. Applied to 'count' {self._count_mechanism.describe()}\n"
                f"    c. Applied to 'normalized_sum' "
                f"{self._sum_mechanism.describe()}")


@dataclass
class Sensitivities:
    """Sensitivities of an additive DP mechanism, with consistency checks."""
    l0: Optional[int] = None
    linf: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None

    def __post_init__(self):

        def check_is_positive(num: Any, name: str):
            if num is not None and num <= 0:
                raise ValueError(f"{name} must be positive, but {num} given.")

        check_is_positive(self.l0, "L0")
        check_is_positive(self.linf, "Linf")
        check_is_positive(self.l1, "L1")
        check_is_positive(self.l2, "L2")

        if (self.l0 is None) != (self.linf is None):
            raise ValueError("l0 and linf sensitivities must be either both set"
                             " or both unset.")

        if self.l0 is not None and self.linf is not None:
            l1 = compute_l1_sensitivity(self.l0, self.linf)
            if self.l1 is None:
                self.l1 = l1
            elif abs(l1 - self.l1) > 1e-12:
                raise ValueError(f"L1={self.l1} != L0*Linf={l1}")

            l2 = compute_l2_sensitivity(self.l0, self.linf)
            if self.l2 is None:
                self.l2 = l2
            elif abs(l2 - self.l2) > 1e-12:
                raise ValueError(f"L2={self.l2} != sqrt(L0)*Linf={l2}")


def create_additive_mechanism(mechanism_spec: budget_accounting.MechanismSpec,
                              sensitivities: Sensitivities
                             ) -> AdditiveMechanism:
    """AdditiveMechanism from a (budget-finalized) spec."""
    noise_kind = mechanism_spec.mechanism_type.to_noise_kind()
    if noise_kind == NoiseKind.LAPLACE:
        if sensitivities.l1 is None:
            raise ValueError("L1 or (L0 and Linf) sensitivities must be set for"
                             " Laplace mechanism.")
        return LaplaceMechanism(mechanism_spec.eps, sensitivities.l1)
    if noise_kind == NoiseKind.GAUSSIAN:
        if sensitivities.l2 is None:
            raise ValueError("L2 or (L0 and Linf) sensitivities must be set for"
                             " Gaussian mechanism.")
        return GaussianMechanism(mechanism_spec.eps, mechanism_spec.delta,
                                 sensitivities.l2)
    raise AssertionError(f"{noise_kind} not supported.")


def create_mean_mechanism(
        range_middle: float, count_spec: budget_accounting.MechanismSpec,
        count_sensitivities: Sensitivities,
        normalized_sum_spec: budget_accounting.MechanismSpec,
        normalized_sum_sensitivities: Sensitivities) -> MeanMechanism:
    return MeanMechanism(
        range_middle,
        create_additive_mechanism(count_spec, count_sensitivities),
        create_additive_mechanism(normalized_sum_spec,
                                  normalized_sum_sensitivities))


def compute_sensitivities_for_count(
        params: aggregate_params.AggregateParams) -> Sensitivities:
    if params.max_contributions is not None:
        return Sensitivities(l1=params.max_contributions,
                             l2=params.max_contributions)
    return Sensitivities(l0=params.max_partitions_contributed,
                         linf=params.max_contributions_per_partition)


def compute_sensitivities_for_privacy_id_count(
        params: aggregate_params.AggregateParams) -> Sensitivities:
    if params.max_contributions is not None:
        return Sensitivities(l1=params.max_contributions,
                             l2=math.sqrt(params.max_contributions))
    return Sensitivities(l0=params.max_partitions_contributed, linf=1)


def compute_sensitivities_for_sum(
        params: aggregate_params.AggregateParams) -> Sensitivities:
    l0_sensitivity = params.max_partitions_contributed
    if params.bounds_per_contribution_are_set:
        max_abs_val = max(abs(params.min_value), abs(params.max_value))
        if params.max_contributions:
            l1_l2 = max_abs_val * params.max_contributions
            return Sensitivities(l1=l1_l2, l2=l1_l2)
        linf_sensitivity = max_abs_val * params.max_contributions_per_partition
    else:
        linf_sensitivity = max(abs(params.min_sum_per_partition),
                               abs(params.max_sum_per_partition))
    return Sensitivities(l0=l0_sensitivity, linf=linf_sensitivity)


def compute_sensitivities_for_normalized_sum(
        params: aggregate_params.AggregateParams) -> Sensitivities:
    max_abs_value = (params.max_value - params.min_value) / 2
    if params.max_contributions:
        l1_l2 = max_abs_value * params.max_contributions
        return Sensitivities(l1=l1_l2, l2=l1_l2)
    return Sensitivities(l0=params.max_partitions_contributed,
                         linf=max_abs_value *
                         params.max_contributions_per_partition)
