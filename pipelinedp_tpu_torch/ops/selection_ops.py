"""Vectorized partition selection: the plain version of the release
kernel's keep decisions.

Port of pipelinedp_tpu/ops/selection_ops.py:23-111. The host precomputes a
handful of strategy scalars (SelectionParams); the keep probability of
every partition and its Bernoulli draw run over the partition axis at
once. The CUDA release kernel (csrc/release_epilogue.cu) evaluates the
same expressions in the same order from `selection_scalars`.
"""

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from pipelinedp_tpu_torch import partition_selection as host_ps
from pipelinedp_tpu_torch.aggregate_params import PartitionSelectionStrategy
from pipelinedp_tpu_torch.ops import threefry


@dataclass(frozen=True)
class SelectionParams:
    """Host-precomputed scalars driving the selection.

    kind: 0 = truncated geometric, 1 = laplace thresholding,
          2 = gaussian thresholding.
    """
    kind: int
    pre_shift: int  # pre_threshold - 1 (0 if unset)
    # Truncated geometric:
    eps1: float = 0.0
    delta1: float = 0.0
    n_cross: int = 0
    pi_cross: float = 0.0
    # Thresholding:
    threshold: float = 0.0
    scale: float = 1.0  # Laplace b or Gaussian sigma


def selection_params_from_host(
        strategy: PartitionSelectionStrategy, eps: float, delta: float,
        max_partitions_contributed: int,
        pre_threshold: Optional[int]) -> SelectionParams:
    """Builds SelectionParams from the host strategy object."""
    selector = host_ps.create_partition_selection_strategy(
        strategy, eps, delta, max_partitions_contributed, pre_threshold)
    pre_shift = (pre_threshold - 1) if pre_threshold else 0
    if isinstance(selector, host_ps.TruncatedGeometricPartitionSelector):
        return SelectionParams(kind=0,
                               pre_shift=pre_shift,
                               eps1=selector._eps1,
                               delta1=selector._delta1,
                               n_cross=selector._n_cross,
                               pi_cross=selector._pi_cross)
    if isinstance(selector, host_ps.LaplaceThresholdingPartitionSelector):
        return SelectionParams(kind=1,
                               pre_shift=pre_shift,
                               threshold=selector.threshold,
                               scale=selector._b)
    if isinstance(selector, host_ps.GaussianThresholdingPartitionSelector):
        return SelectionParams(kind=2,
                               pre_shift=pre_shift,
                               threshold=selector.threshold,
                               scale=selector.sigma)
    raise ValueError(f"Unknown selector {type(selector)}")


def selection_scalars(params: SelectionParams) -> Tuple[float, ...]:
    """The 14 float64 scalars the release kernel reads, in its order:
    kind, pre_shift, eps1, delta1, n_cross, pi_cross, log(delta1),
    log1p(-exp(-eps1)), exp(-eps1), 1 - exp(-eps1), eps1 < 700,
    threshold, scale, 1 - pi_cross. Each is a Python float computed here
    exactly as keep_probabilities computes it, then rounded to the
    working dtype on the device."""
    s = [float(params.kind), float(params.pre_shift), params.eps1,
         params.delta1, float(params.n_cross), params.pi_cross, 0.0, 0.0,
         0.0, 0.0, 0.0, params.threshold, params.scale,
         1.0 - params.pi_cross]
    if params.kind == 0:
        e = math.exp(-params.eps1)
        s[6] = math.log(params.delta1)
        s[7] = math.log1p(-e)
        s[8] = e
        s[9] = 1.0 - e
        s[10] = float(params.eps1 < 700)
    return tuple(s)


def keep_probabilities(counts: torch.Tensor, params: SelectionParams,
                       dtype: torch.dtype) -> torch.Tensor:
    """probability_of_keep for a tensor of privacy-id counts (port of
    selection_ops.keep_probabilities; Python floats enter as scalars of
    `dtype`, as JAX's weak types do)."""

    def c(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=dtype, device=counts.device)

    n = counts.to(dtype) - c(params.pre_shift)
    if params.kind == 0:
        s = selection_scalars(params)
        eps1, n_cross = c(params.eps1), c(params.n_cross)
        n_eff = torch.maximum(n, c(1.0))
        n1 = torch.minimum(n_eff, n_cross)
        log_pi1 = (c(s[6]) + (n1 - 1.0) * eps1 +
                   torch.log1p(-torch.exp(-n1 * eps1)) - c(s[7]))
        pi1 = torch.exp(torch.minimum(log_pi1, c(0.0)))
        k = torch.maximum(n_eff - n_cross, c(0.0))
        decay = torch.exp(-k * eps1)
        geo = (c(s[8]) * (1.0 - decay) / c(s[9])
               if s[10] else torch.zeros_like(decay))
        q = decay * c(s[13]) - c(params.delta1) * geo
        pi2 = 1.0 - torch.maximum(q, c(0.0))
        probs = torch.clamp(torch.where(n_eff <= n_cross, pi1, pi2), 0.0,
                            1.0)
    elif params.kind == 1:
        z = (n - c(params.threshold)) / c(params.scale)
        probs = torch.where(z >= 0, 1.0 - 0.5 * torch.exp(-torch.abs(z)),
                            0.5 * torch.exp(-torch.abs(z)))
    elif params.kind == 2:
        z = (c(params.threshold) - n) / c(params.scale)
        probs = 0.5 * torch.special.erfc(z / c(math.sqrt(2)))
    else:
        raise ValueError(f"Unknown selection kind {params.kind}")
    return torch.where(n <= 0, c(0.0), probs)


def sample_keep_decisions(key, counts: torch.Tensor, params: SelectionParams,
                          dtype: torch.dtype) -> torch.Tensor:
    """Bernoulli keep decision per partition: uniform(key) < probability."""
    probs = keep_probabilities(counts, params, dtype)
    u = threefry.uniform(key, counts.shape[0], dtype, device=counts.device)
    return u < probs
