"""Host-side DP calibration of the port.

Port of the host calibration in pipelinedp_tpu/dp_computations.py: the
analytic Gaussian sigma (`gaussian_sigma`, :159), the variance noise stds
(`compute_dp_var_noise_stds`, :378), VECTOR_SUM's per-coordinate noise
(`AdditiveVectorNoiseParams`, `vector_noise_std`, :232-270), the
mechanisms' standard deviations and descriptions, and the
`compute_sensitivities_*` functions (:1133 on), and `ScalarNoiseParams`
with `compute_dp_count_noise_std` (:81, :426), which the utility
analysis's error model calibrates with. numpy/scipy only; the
noise of a release is drawn on the device by the release kernels, so the
continuous mechanisms carry no host sampler.

The discrete mechanisms (:711-1075: GeometricMechanism,
SnappedLaplaceMechanism, SnappedGaussianMechanism,
create_discrete_mechanism) do sample on the host: bound to a threefry key,
their uniforms come from the port's threefry (`_threefry_uniforms`), so a
key gives the JAX package's draws bit for bit.
"""

import abc
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import numpy as np
from scipy.special import log_ndtr

from pipelinedp_tpu_torch import aggregate_params
from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch.aggregate_params import NoiseKind
from pipelinedp_tpu_torch.ops import threefry


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


@dataclass
class ScalarNoiseParams:
    """Parameters for computing DP sum, count, mean, variance."""

    eps: float
    delta: float
    min_value: Optional[float]
    max_value: Optional[float]
    min_sum_per_partition: Optional[float]
    max_sum_per_partition: Optional[float]
    max_partitions_contributed: int
    max_contributions_per_partition: Optional[int]
    noise_kind: NoiseKind

    def __post_init__(self):
        if (self.min_value is None) != (self.max_value is None):
            raise ValueError(
                "min_value and max_value should be both set or both None.")
        if (self.min_sum_per_partition is None) != (
                self.max_sum_per_partition is None):
            raise ValueError("min_sum_per_partition and "
                             "max_sum_per_partition should be both set or "
                             "both None.")

    def l0_sensitivity(self) -> int:
        return self.max_partitions_contributed


def compute_dp_count_noise_std(dp_params: ScalarNoiseParams) -> float:
    """Noise std of a DP count with these parameters (linf sensitivity
    max_contributions_per_partition)."""
    return noise_std(dp_params.eps, dp_params.delta,
                     dp_params.l0_sensitivity(),
                     dp_params.max_contributions_per_partition,
                     dp_params.noise_kind)


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


def noise_sensitivity(l0_sensitivity: float, linf_sensitivity: float,
                      noise_kind: NoiseKind) -> float:
    """The norm sensitivity matching `noise_std`'s mechanism: l1 for
    Laplace, l2 for Gaussian (the secure-noise grid calibration reads
    it)."""
    if noise_kind == NoiseKind.LAPLACE:
        return compute_l1_sensitivity(l0_sensitivity, linf_sensitivity)
    if noise_kind == NoiseKind.GAUSSIAN:
        return compute_l2_sensitivity(l0_sensitivity, linf_sensitivity)
    raise ValueError("Only Laplace and Gaussian noise is supported.")


def compute_dp_var_noise_sensitivities(
        l0: int, linf: int, min_value: float, max_value: float,
        noise_kind: NoiseKind) -> Tuple[float, float, float]:
    """Per-slot norm sensitivities matching compute_dp_var_noise_stds."""
    mid = compute_middle(min_value, max_value)
    sq_lo, sq_hi = compute_squares_interval(min_value, max_value)
    mid2 = compute_middle(sq_lo, sq_hi)
    return (noise_sensitivity(l0, linf, noise_kind),
            noise_sensitivity(l0, linf * abs(mid - min_value), noise_kind),
            noise_sensitivity(l0, linf * abs(mid2 - sq_lo), noise_kind))


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


def vector_noise_sensitivity(
        noise_params: AdditiveVectorNoiseParams) -> float:
    """Per-coordinate norm sensitivity matching vector_noise_std."""
    return noise_sensitivity(noise_params.l0_sensitivity,
                             noise_params.linf_sensitivity,
                             noise_params.noise_kind)


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

    @classmethod
    def create_from_std_deviation(cls, normalized_stddev: float,
                                  l1_sensitivity: float) -> 'LaplaceMechanism':
        """normalized_stddev = stddev / l1_sensitivity (PLD accounting)."""
        b = normalized_stddev / math.sqrt(2)
        return LaplaceMechanism(1 / b, l1_sensitivity)

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

    @classmethod
    def create_from_std_deviation(
            cls, normalized_stddev: float,
            l2_sensitivity: float) -> 'GaussianMechanism':
        """normalized_stddev = stddev / l2_sensitivity (PLD accounting); eps
        and delta read 0, as in the JAX package."""
        mech = cls.__new__(cls)
        mech._sigma = normalized_stddev * l2_sensitivity
        mech._l2_sensitivity = l2_sensitivity
        mech._epsilon = 0.0
        mech._delta = 0.0
        return mech

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
    """AdditiveMechanism from a (budget-finalized) spec: by its noise
    standard deviation where PLD accounting set one, else by (eps, delta)."""
    noise_kind = mechanism_spec.mechanism_type.to_noise_kind()
    if noise_kind == NoiseKind.LAPLACE:
        if sensitivities.l1 is None:
            raise ValueError("L1 or (L0 and Linf) sensitivities must be set for"
                             " Laplace mechanism.")
        if mechanism_spec.standard_deviation_is_set:
            return LaplaceMechanism.create_from_std_deviation(
                mechanism_spec.noise_standard_deviation, sensitivities.l1)
        return LaplaceMechanism(mechanism_spec.eps, sensitivities.l1)
    if noise_kind == NoiseKind.GAUSSIAN:
        if sensitivities.l2 is None:
            raise ValueError("L2 or (L0 and Linf) sensitivities must be set for"
                             " Gaussian mechanism.")
        if mechanism_spec.standard_deviation_is_set:
            return GaussianMechanism.create_from_std_deviation(
                mechanism_spec.noise_standard_deviation, sensitivities.l2)
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


# ---------------------------------------------------------------------------
# Discrete / snapped mechanisms: floating-point-safe host noise.
#
# Continuous samplers of IEEE doubles leak through the uneven value grid
# (Mironov, CCS 2012). These mechanisms release only values on a declared
# grid: GeometricMechanism (the discrete Laplace, integers) for counts;
# SnappedLaplaceMechanism / SnappedGaussianMechanism (clamp -> noise ->
# round to a power-of-two grid g) for real values, calibrated against the
# widened sensitivity Delta + g, so the granted epsilon stays a sound bound.

# Default snapping grid: pow2_ceil(noise scale) * 2**-_SNAP_FRACTION_BITS.
_SNAP_FRACTION_BITS = 16

# Clamp bound for snapped releases: the largest magnitude at which
# round-to-grid is still exact in float64 (53-bit significand).
_SNAP_CLAMP_GRID_UNITS = float(1 << 52)

_rng: Optional[np.random.Generator] = None


def seed_mechanism_rng(
        seed: "Union[None, int, np.random.Generator]") -> None:
    """Seeds (or injects) the host generator of unbound mechanisms."""
    global _rng
    _rng = (seed if isinstance(seed, np.random.Generator) else
            np.random.default_rng(seed))


def mechanism_rng() -> np.random.Generator:
    """The host generator of unbound mechanisms, created on first use from
    a fresh SeedSequence when no seed was injected."""
    global _rng
    if _rng is None:
        _rng = np.random.default_rng(np.random.SeedSequence())
    return _rng


def _pow2_round_up(x: float) -> float:
    return 2.0**math.ceil(math.log2(x))


def _threefry_uniforms(key, n: int, draw_index: int) -> np.ndarray:
    """n uniforms in (0, 1) from a threefry key and a draw counter: 64 bits
    each, assembled from two u32 words of bits(fold_in(key, draw_index),
    (2n,)); the +0.5 offset keeps draws strictly inside (0, 1)."""
    sub = threefry.fold_in(key, draw_index)
    words = threefry.bits(sub, 2 * n).astype(np.uint64)
    u64 = (words[0::2] << np.uint64(32)) | words[1::2]
    return (u64.astype(np.float64) + 0.5) * (2.0**-64)


class _KeyedDrawMixin:
    """Counter-folded deterministic uniforms: bind_key() makes every later
    draw a pure function of (key, draw index); unbound, draws come from
    mechanism_rng()."""

    _key = None
    _draws = 0

    def bind_key(self, key) -> None:
        self._key = key
        self._draws = 0

    def _uniforms(self, n: int) -> np.ndarray:
        if self._key is not None:
            u = _threefry_uniforms(self._key, n, self._draws)
            self._draws += 1
            return u
        return mechanism_rng().random(n)


class GeometricMechanism(_KeyedDrawMixin, AdditiveMechanism):
    """Two-sided geometric (discrete Laplace) mechanism for counts.

    P(Z = z) proportional to alpha**|z| with alpha = exp(-eps / Delta),
    sampled as the difference of two geometric variables by exact inverse
    CDF: every release is an exact integer, grid step 1.
    """

    def __init__(self, epsilon: float, l1_sensitivity: float, key=None):
        self._epsilon = epsilon
        # A fractional l1 is rounded up: over-noise, never under-noise.
        self._l1_sensitivity = float(math.ceil(l1_sensitivity))
        if key is not None:
            self.bind_key(key)

    @classmethod
    def create_from_epsilon(cls, epsilon: float, l1_sensitivity: float,
                            key=None) -> 'GeometricMechanism':
        return GeometricMechanism(epsilon, l1_sensitivity, key=key)

    @property
    def alpha(self) -> float:
        return math.exp(-self._epsilon / self._l1_sensitivity)

    def add_noise(self, value: Union[int, float]) -> float:
        a = self.alpha
        u1, u2 = self._uniforms(2)
        if a <= 0.0:
            g1 = g2 = 0  # eps/Delta past exp underflow: noise is 0 w.p. ~1
        else:
            log_a = math.log(a)
            g1 = int(math.floor(math.log(u1) / log_a))
            g2 = int(math.floor(math.log(u2) / log_a))
        return float(int(round(value)) + g1 - g2)

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @property
    def grid(self) -> float:
        return 1.0

    @property
    def noise_kind(self) -> NoiseKind:
        return NoiseKind.LAPLACE

    @property
    def noise_parameter(self) -> float:
        return self.alpha

    @property
    def std(self) -> float:
        a = self.alpha
        return math.sqrt(2.0 * a) / (1.0 - a)

    @property
    def sensitivity(self) -> float:
        return self._l1_sensitivity

    def describe(self) -> str:
        return (f"Geometric (discrete Laplace) mechanism:  alpha="
                f"{self.alpha}  eps={self._epsilon}  l1_sensitivity="
                f"{self.sensitivity}  grid=1")


class _SnappedMechanism(_KeyedDrawMixin, AdditiveMechanism):
    """Shared clamp -> noise -> round-to-grid release path."""

    _grid: float

    def _snap(self, noisy: float) -> float:
        g = self._grid
        bound = _SNAP_CLAMP_GRID_UNITS * g
        clamped = min(max(noisy, -bound), bound)
        # g is a power of two: x / g and the product are exact, so the
        # release lands exactly on the grid.
        return round(clamped / g) * g

    @property
    def grid(self) -> float:
        return self._grid


class SnappedLaplaceMechanism(_SnappedMechanism):
    """Snapped Laplace: grid g = pow2_ceil(b) * 2**-16 (floored at
    2**snap_grid_bits when given), scale calibrated against Delta + g."""

    def __init__(self, epsilon: float, l1_sensitivity: float,
                 snap_grid_bits: Optional[int] = None, key=None):
        self._epsilon = epsilon
        self._raw_sensitivity = l1_sensitivity
        base_b = l1_sensitivity / epsilon
        g = _pow2_round_up(base_b) * 2.0**-_SNAP_FRACTION_BITS
        if snap_grid_bits is not None:
            g = max(g, 2.0**int(snap_grid_bits))
        self._grid = g
        self._l1_sensitivity = l1_sensitivity + g  # snap widening
        self._b = self._l1_sensitivity / epsilon
        if key is not None:
            self.bind_key(key)

    def add_noise(self, value: Union[int, float]) -> float:
        (u,) = self._uniforms(1)
        # Laplace inverse CDF on one uniform in (0, 1).
        if u < 0.5:
            noise = self._b * math.log(2.0 * u)
        else:
            noise = -self._b * math.log(2.0 * (1.0 - u))
        return self._snap(float(value) + noise)

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @property
    def noise_kind(self) -> NoiseKind:
        return NoiseKind.LAPLACE

    @property
    def noise_parameter(self) -> float:
        return self._b

    @property
    def std(self) -> float:
        return self._b * math.sqrt(2)

    @property
    def sensitivity(self) -> float:
        return self._l1_sensitivity

    def describe(self) -> str:
        return (f"Snapped Laplace mechanism:  parameter={self._b}  eps="
                f"{self._epsilon}  l1_sensitivity={self._l1_sensitivity} "
                f"(raw {self._raw_sensitivity} + grid)  grid={self._grid}")


class SnappedGaussianMechanism(_SnappedMechanism):
    """Snapped Gaussian: sigma (analytic Gaussian mechanism) calibrated
    against the widened sensitivity Delta + g."""

    def __init__(self, epsilon: float, delta: float, l2_sensitivity: float,
                 snap_grid_bits: Optional[int] = None, key=None):
        self._epsilon = epsilon
        self._delta = delta
        self._raw_sensitivity = l2_sensitivity
        base_sigma = gaussian_sigma(epsilon, delta, l2_sensitivity)
        g = _pow2_round_up(base_sigma) * 2.0**-_SNAP_FRACTION_BITS
        if snap_grid_bits is not None:
            g = max(g, 2.0**int(snap_grid_bits))
        self._grid = g
        self._l2_sensitivity = l2_sensitivity + g  # snap widening
        self._sigma = gaussian_sigma(epsilon, delta, self._l2_sensitivity)
        if key is not None:
            self.bind_key(key)

    @classmethod
    def create_from_std_deviation(cls, normalized_stddev: float,
                                  l2_sensitivity: float,
                                  snap_grid_bits: Optional[int] = None,
                                  key=None) -> 'SnappedGaussianMechanism':
        """normalized_stddev = stddev / l2_sensitivity; sigma is widened by
        the same Delta -> Delta + g factor as the eps / delta path."""
        sigma = normalized_stddev * l2_sensitivity
        mech = cls.__new__(cls)
        mech._epsilon = 0.0
        mech._delta = 0.0
        mech._raw_sensitivity = l2_sensitivity
        g = _pow2_round_up(sigma) * 2.0**-_SNAP_FRACTION_BITS
        if snap_grid_bits is not None:
            g = max(g, 2.0**int(snap_grid_bits))
        mech._grid = g
        mech._l2_sensitivity = l2_sensitivity + g
        mech._sigma = sigma * mech._l2_sensitivity / l2_sensitivity
        if key is not None:
            mech.bind_key(key)
        return mech

    def add_noise(self, value: Union[int, float]) -> float:
        u1, u2 = self._uniforms(2)
        # Box-Muller on two uniforms in (0, 1).
        z = math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)
        return self._snap(float(value) + self._sigma * z)

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @property
    def delta(self) -> float:
        return self._delta

    @property
    def noise_kind(self) -> NoiseKind:
        return NoiseKind.GAUSSIAN

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
        return (f"Snapped Gaussian mechanism:  parameter={self._sigma}  eps="
                f"{self._epsilon}  delta={self._delta}  l2_sensitivity="
                f"{self._l2_sensitivity} (raw {self._raw_sensitivity} + "
                f"grid)  grid={self._grid}")


def create_discrete_mechanism(mechanism_spec: budget_accounting.MechanismSpec,
                              sensitivities: Sensitivities,
                              *,
                              value_is_integer: bool = False,
                              snap_grid_bits: Optional[int] = None,
                              key=None) -> AdditiveMechanism:
    """Floating-point-safe AdditiveMechanism from a budget-finalized spec:
    integer-valued Laplace queries (value_is_integer, e.g. COUNT) get the
    geometric mechanism on grid 1, real-valued ones the snapped mechanism
    of the spec's noise kind. `key` (a threefry key) makes the draws
    deterministic; snap_grid_bits floors the grid at 2**snap_grid_bits.
    A spec given by a noise standard deviation (PLD accounting) is
    calibrated from it: Laplace as eps = sqrt(2) / normalized stddev,
    Gaussian through SnappedGaussianMechanism.create_from_std_deviation."""
    noise_kind = mechanism_spec.mechanism_type.to_noise_kind()
    if noise_kind == NoiseKind.LAPLACE:
        if sensitivities.l1 is None:
            raise ValueError("L1 or (L0 and Linf) sensitivities must be set "
                             "for the geometric/snapped Laplace mechanism.")
        if mechanism_spec.standard_deviation_is_set:
            # normalized_stddev = std / Delta and b = Delta / eps (the
            # inversion of LaplaceMechanism.create_from_std_deviation).
            eps = math.sqrt(2.0) / mechanism_spec.noise_standard_deviation
        else:
            eps = mechanism_spec.eps
        if value_is_integer:
            return GeometricMechanism(eps, sensitivities.l1, key=key)
        return SnappedLaplaceMechanism(eps, sensitivities.l1,
                                       snap_grid_bits=snap_grid_bits, key=key)
    if noise_kind == NoiseKind.GAUSSIAN:
        if sensitivities.l2 is None:
            raise ValueError("L2 or (L0 and Linf) sensitivities must be set "
                             "for the snapped Gaussian mechanism.")
        if mechanism_spec.standard_deviation_is_set:
            return SnappedGaussianMechanism.create_from_std_deviation(
                mechanism_spec.noise_standard_deviation, sensitivities.l2,
                snap_grid_bits=snap_grid_bits, key=key)
        return SnappedGaussianMechanism(mechanism_spec.eps,
                                        mechanism_spec.delta,
                                        sensitivities.l2,
                                        snap_grid_bits=snap_grid_bits,
                                        key=key)
    raise AssertionError(f"{noise_kind} not supported.")
