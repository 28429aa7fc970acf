"""Native privacy-loss-distribution (PLD) accounting.

Port of pipelinedp_tpu/accounting/pld.py: host math in numpy and scipy,
bit for bit the JAX package's (the suffix-sum delta query keeps its
np.longdouble arithmetic; torch has no extended precision).

  * A PLD is the distribution of the privacy loss L(x) = ln(P(x)/Q(x)) with
    x ~ P, for the worst-case neighboring output distributions (P, Q) of a
    mechanism, discretized on a uniform grid with *pessimistic* (ceiling)
    rounding so every derived (eps, delta) claim is an upper bound.
  * Composition of mechanisms = convolution of their loss distributions
    (FFT-based, scipy.signal.fftconvolve).
  * delta(eps) follows from the standard hockey-stick divergence formula
      delta = inf_mass + sum_{l_i > eps} p_i * (1 - e^(eps - l_i)).

Closed-form loss CDFs used for construction:
  Gaussian(sigma), sensitivity 1:  L ~ N(1/(2 sigma^2), 1/sigma)  (exact).
  Laplace(b), sensitivity 1:       L in [-1/b, 1/b] with atoms at both ends,
      CDF(l) = exp(-(1 - b*l)/(2b))/2 on the interior.
  Generic (eps0, delta0) mechanism: three-point worst-case distribution
      {+eps0, -eps0, +infinity} (same as dp_accounting from_privacy_parameters).
"""

import math

import numpy as np
from scipy import signal, special

# Mass below this, per tail, is truncated when discretizing (upper-tail mass
# is moved to the infinity atom, which is pessimistic).
_TAIL_MASS = 1e-15

# Losses above this are represented as the infinity atom (pessimistic: the
# hockey-stick contribution of mass at loss L is p*(1 - e^(eps-L)) <= p, and
# at L=80, e^(eps-L) < 2e-35 for any meaningful eps, so the bound is tight).
# Keeps the discretization grid bounded (~1.6M cells at interval 1e-4) even
# for privacy-meaningless parameters like the huge-eps determinism trick:
# without the cap, eps0=1e4 would need a 1e8-cell grid and overflow exp().
_MAX_FINITE_LOSS = 80.0

# The suffix-sum delta query computes e^eps in extended precision, which
# overflows past ~11356; queries beyond this (privacy-meaningless, only
# reachable on huge composed grids) take the direct-scan path instead.
_FAST_QUERY_MAX_EPS = 11000.0

# e^{-l} for grid losses below this saturates even extended precision;
# the suffix weights treat such cells as unqueryable and the (equally
# privacy-meaningless) queries that would land there take the scan path.
_FAST_QUERY_MIN_LOSS = -700.0


def _norm_cdf(z):
    return 0.5 * special.erfc(-np.asarray(z, dtype=np.float64) / math.sqrt(2))


class PrivacyLossDistribution:
    """Discretized privacy loss distribution.

    probs[i] is the probability of privacy loss (lower_index + i) * interval;
    infinity_mass is the probability of infinite loss.
    """

    def __init__(self, probs: np.ndarray, lower_index: int, interval: float,
                 infinity_mass: float):
        self._probs = np.asarray(probs, dtype=np.float64)
        self._lower_index = lower_index
        self._interval = interval
        self._infinity_mass = float(infinity_mass)
        # Lazily computed suffix tail-sums (see _tail_sums). Lock-free
        # lazy publish: concurrent computes derive identical arrays from
        # the immutable pmf and the single reference assignment is
        # atomic.
        self._tails = None

    @property
    def interval(self) -> float:
        return self._interval

    @property
    def infinity_mass(self) -> float:
        return self._infinity_mass

    @property
    def losses(self) -> np.ndarray:
        """Grid of finite loss values carrying mass."""
        n = len(self._probs)
        return (np.arange(self._lower_index, self._lower_index + n) *
                self._interval)

    @property
    def probs(self) -> np.ndarray:
        return self._probs

    def compose(self,
                other: 'PrivacyLossDistribution') -> 'PrivacyLossDistribution':
        """Composition of two mechanisms: convolution of loss pmfs."""
        if abs(self._interval - other._interval) > 1e-12:
            raise ValueError(
                f"Cannot compose PLDs with different discretization intervals:"
                f" {self._interval} != {other._interval}")
        probs = signal.fftconvolve(self._probs, other._probs)
        np.clip(probs, 0.0, None, out=probs)
        infinity_mass = 1.0 - (1.0 - self._infinity_mass) * (
            1.0 - other._infinity_mass)
        return PrivacyLossDistribution(
            probs, self._lower_index + other._lower_index, self._interval,
            infinity_mass)

    def self_compose(self, num_times: int) -> 'PrivacyLossDistribution':
        """Composes `self` with itself num_times (repeated squaring)."""
        if num_times < 1:
            raise ValueError("num_times must be >= 1")
        result = None
        base = self
        n = num_times
        while n:
            if n & 1:
                result = base if result is None else result.compose(base)
            n >>= 1
            if n:
                base = base.compose(base)
        return result

    def _tail_sums(self):
        """Suffix tail-sums powering the O(log L) delta query.

        With A[j] = sum_{i>=j} p_i and B[j] = sum_{i>=j} p_i * e^{-l_i},
        the hockey-stick divergence collapses to
            delta(eps) = inf_mass + A[j] - e^eps * B[j]
        where j is the first grid index whose loss exceeds eps — an O(1)
        arithmetic index on the uniform grid plus two lookups, instead
        of a full-grid mask + sum per probe. Accumulated in extended
        precision (np.longdouble: 80-bit on x86-64) so the collapsed
        form agrees with the direct scan well past 1e-9 even on
        million-cell composed grids. Returns (A, B, exact_from): cells
        below ``exact_from`` carry losses so negative that e^{-l}
        saturates — queries landing there fall back to the scan.
        """
        tails = self._tails
        if tails is None:
            losses = self.losses
            probs = self._probs.astype(np.longdouble)
            finite = losses > _FAST_QUERY_MIN_LOSS
            weights = np.zeros(len(probs), dtype=np.longdouble)
            weights[finite] = probs[finite] * np.exp(
                -losses[finite].astype(np.longdouble))
            tail_p = np.cumsum(probs[::-1])[::-1]
            tail_w = np.cumsum(weights[::-1])[::-1]
            exact_from = (int(np.argmax(finite)) if finite.any()
                          else len(probs))
            tails = (tail_p, tail_w, exact_from)
            self._tails = tails
        return tails

    def _get_delta_for_epsilon_scan(self, epsilon: float) -> float:
        """Direct full-grid evaluation of the hockey-stick divergence —
        the reference the fast path is tested against, and the fallback
        for extreme queries outside the suffix sums' exact range."""
        losses = self.losses
        mask = losses > epsilon
        if not mask.any():
            return min(1.0, self._infinity_mass)
        delta = self._infinity_mass + np.sum(
            self._probs[mask] * (-np.expm1(epsilon - losses[mask])))
        return float(min(1.0, max(0.0, delta)))

    def get_delta_for_epsilon(self, epsilon: float) -> float:
        """Hockey-stick divergence at the given epsilon (O(log L) via
        suffix tail-sums; see _tail_sums)."""
        epsilon = float(epsilon)
        n = len(self._probs)
        lo, d = self._lower_index, self._interval
        if n == 0 or epsilon >= (lo + n - 1) * d:
            # No grid loss exceeds epsilon.
            return min(1.0, self._infinity_mass)
        # First index with (lo + j) * d > epsilon: O(1) on the uniform
        # grid, with float fixups so the boundary matches the scan's
        # `losses > epsilon` mask exactly.
        j = min(max(int(math.floor(epsilon / d - lo)) + 1, 0), n)
        while j > 0 and (lo + j - 1) * d > epsilon:
            j -= 1
        while j < n and (lo + j) * d <= epsilon:
            j += 1
        if j >= n:
            return min(1.0, self._infinity_mass)
        tail_p, tail_w, exact_from = self._tail_sums()
        if j < exact_from or epsilon > _FAST_QUERY_MAX_EPS:
            return self._get_delta_for_epsilon_scan(epsilon)
        delta = (np.longdouble(self._infinity_mass) + tail_p[j] -
                 np.exp(np.longdouble(epsilon)) * tail_w[j])
        return float(min(1.0, max(0.0, float(delta))))

    def get_epsilon_for_delta(self, delta: float) -> float:
        """Smallest epsilon such that the mechanism is (epsilon, delta)-DP."""
        if self._infinity_mass > delta:
            return math.inf
        if self.get_delta_for_epsilon(0.0) <= delta:
            # Maybe even a negative epsilon would do, but by convention the
            # accountant only needs eps >= 0.
            return 0.0
        n = len(self._probs)
        high = (float((self._lower_index + n - 1) * self._interval)
                if n else 0.0)
        low = 0.0
        # delta(eps) is non-increasing in eps; bisect. Each probe is an
        # O(log L) suffix-sum query, not a full-grid scan.
        for _ in range(100):
            mid = (low + high) / 2
            if self.get_delta_for_epsilon(mid) <= delta:
                high = mid
            else:
                low = mid
            if high - low < 1e-9 * max(1.0, high):
                break
        return high


def _discretize_from_cdf(cdf, lower_loss: float, upper_loss: float,
                         value_discretization_interval: float,
                         infinity_mass: float) -> PrivacyLossDistribution:
    """Buckets a loss CDF onto the grid with ceiling (pessimistic) rounding.

    Bucket i holds mass CDF(i*d) - CDF((i-1)*d), represented as loss i*d.
    """
    d = value_discretization_interval
    lo_idx = math.ceil(lower_loss / d)
    hi_idx = math.ceil(upper_loss / d)
    edges = np.arange(lo_idx - 1, hi_idx + 1) * d
    cdf_vals = cdf(edges)
    probs = np.diff(cdf_vals)
    # Mass below the lowest edge is collapsed into the first bucket
    # (pessimistic: its represented loss is an upper bound for that mass).
    probs[0] += cdf_vals[0]
    np.clip(probs, 0.0, None, out=probs)
    return PrivacyLossDistribution(probs, lo_idx, d, infinity_mass)


def from_gaussian_mechanism(
        standard_deviation: float,
        value_discretization_interval: float = 1e-4,
        sensitivity: float = 1.0) -> PrivacyLossDistribution:
    """PLD of the Gaussian mechanism with the given (normalized) stddev.

    With sigma = standard_deviation / sensitivity, the loss is exactly
    L ~ N(1/(2 sigma^2), 1/sigma).
    """
    if standard_deviation <= 0:
        raise ValueError("standard_deviation must be positive")
    sigma = standard_deviation / sensitivity
    mu = 1.0 / (2 * sigma * sigma)
    sd = 1.0 / sigma
    # 8 sds of range keeps per-tail truncation under ~1e-15.
    z_tail = special.erfcinv(2 * _TAIL_MASS) * math.sqrt(2)
    lower, upper = mu - z_tail * sd, mu + z_tail * sd

    def cdf(l):
        return _norm_cdf((np.asarray(l) - mu) / sd)

    # Upper tail beyond `upper` goes to the infinity atom (pessimistic);
    # the finite-loss cap bounds the grid for very small sigmas.
    infinity_mass = _TAIL_MASS
    if upper > _MAX_FINITE_LOSS:
        upper = _MAX_FINITE_LOSS
        infinity_mass = float(1.0 - cdf(upper))
        if lower > upper:
            # Essentially all mass is past the cap: one saturated atom.
            return PrivacyLossDistribution(
                np.zeros(1),
                math.ceil(upper / value_discretization_interval),
                value_discretization_interval, 1.0)
    return _discretize_from_cdf(cdf, lower, upper,
                                value_discretization_interval,
                                infinity_mass=infinity_mass)


def from_laplace_mechanism(
        parameter: float,
        value_discretization_interval: float = 1e-4,
        sensitivity: float = 1.0) -> PrivacyLossDistribution:
    """PLD of the Laplace mechanism with the given scale parameter b."""
    if parameter <= 0:
        raise ValueError("parameter must be positive")
    b = parameter / sensitivity
    max_loss = 1.0 / b

    def cdf(l):
        l = np.asarray(l, dtype=np.float64)
        out = np.where(
            l >= max_loss, 1.0,
            np.where(l < -max_loss, 0.0,
                     0.5 * np.exp(-(1.0 - b * np.minimum(l, max_loss)) /
                                  (2 * b))))
        return out

    # Finite-loss cap for very small b (huge-eps regime): the atom mass at
    # +1/b and interior mass above the cap become infinity mass
    # (pessimistic), keeping the grid bounded.
    infinity_mass = 0.0
    upper = max_loss
    lower = -max_loss
    if max_loss > _MAX_FINITE_LOSS:
        upper = _MAX_FINITE_LOSS
        infinity_mass = float(1.0 - cdf(upper - 1e-12))
        lower = max(lower, -_MAX_FINITE_LOSS)
    return _discretize_from_cdf(cdf, lower, upper,
                                value_discretization_interval,
                                infinity_mass=infinity_mass)


def from_privacy_parameters(
        eps: float,
        delta: float,
        value_discretization_interval: float = 1e-4
) -> PrivacyLossDistribution:
    """PLD of the worst-case mechanism that is exactly (eps, delta)-DP."""
    d = value_discretization_interval
    if eps < 0 or delta < 0 or delta >= 1:
        raise ValueError(f"Invalid privacy parameters ({eps}, {delta})")
    # Log-safe sigmoid forms (exp(eps) overflows beyond ~709).
    p_plus = (1 - delta) / (1 + math.exp(-eps))
    p_minus = (1 - delta) * math.exp(-eps) / (1 + math.exp(-eps))
    infinity_mass = delta
    eps_eff = min(eps, _MAX_FINITE_LOSS)
    if eps > _MAX_FINITE_LOSS:
        # The +eps atom is beyond the finite-loss cap: count it as infinite
        # loss (pessimistic) instead of materializing a huge grid. The only
        # remaining finite mass is the (negligible) -eps atom, so the grid
        # collapses to one cell.
        infinity_mass += p_plus
        p_plus = 0.0
        idx_plus = idx_minus = math.ceil(-eps_eff / d)
    else:
        idx_plus = math.ceil(eps_eff / d)
        idx_minus = math.ceil(-eps_eff / d)
    probs = np.zeros(idx_plus - idx_minus + 1, dtype=np.float64)
    probs[idx_plus - idx_minus] += p_plus
    probs[0] += p_minus
    return PrivacyLossDistribution(probs, idx_minus, d,
                                   infinity_mass=infinity_mass)
