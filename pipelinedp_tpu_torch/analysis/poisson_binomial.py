"""Exact and approximate Poisson-binomial PMFs.

Capability parity with the reference ``analysis/poisson_binomial.py:25-83``.
The exact PMF uses an FFT-free PGF convolution, vectorized so the whole
product of (1-p + p*x) polynomials runs as numpy shifts rather than a Python
inner loop per coefficient; the approximation is the refined normal
approximation (skew-corrected), identical to the reference.

Port of pipelinedp_tpu/analysis/poisson_binomial.py.
"""

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
from scipy.stats import norm


@dataclass
class PMF:
    """PMF of a finite integer distribution: value i+start has probability
    probabilities[i]."""
    start: int
    probabilities: np.ndarray


def compute_pmf(probabilities: Sequence[float]) -> PMF:
    """Exact Poisson-binomial PMF by PGF convolution (reference ``:39-50``)."""
    pgf = np.array([1.0])
    for p in probabilities:
        nxt = np.zeros(len(pgf) + 1)
        nxt[:-1] = pgf * (1 - p)
        nxt[1:] += pgf * p
        pgf = nxt
    return PMF(0, pgf)


def compute_exp_std_skewness(
        probabilities: Sequence[float]) -> Tuple[float, float, float]:
    ps = np.asarray(probabilities, dtype=np.float64)
    exp = float(ps.sum())
    var = float((ps * (1 - ps)).sum())
    std = float(np.sqrt(var))
    skewness = 0.0 if std == 0 else float(
        (ps * (1 - ps) * (1 - 2 * ps)).sum() / std**3)
    return exp, std, skewness


def compute_pmf_approximation(mean: float, sigma: float, skewness: float,
                              n: int) -> PMF:
    """Refined-normal-approximation PMF (reference ``:62-83``).

    Skew-corrected normal CDF differences; tails below ~1e-15 (outside
    mean±8σ) are dropped.
    """
    if sigma == 0:
        return PMF(int(round(mean)), np.array([1.0]))
    start = max(0, int(np.floor(mean - 8 * sigma)))
    end = min(n, int(np.round(mean + 8 * sigma)))
    xs = np.arange(start - 1, end + 1)
    zs = (xs + 0.5 - mean) / sigma
    cdf_values = norm.cdf(zs) + skewness * (1 - zs * zs) * norm.pdf(zs) / 6
    cdf_values = np.clip(cdf_values, 0, 1)
    return PMF(start, np.diff(cdf_values))
