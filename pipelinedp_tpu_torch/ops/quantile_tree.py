"""Quantile-tree defaults and the per-level noise calibration.

Port of pipelinedp_tpu/ops/quantile_tree.py:27-53. The tree of a
partition's values has height h and branching B (the Google library's
defaults, 4 and 16): B^h leaves over [min_value, max_value]. The dense
release builds the trees on the device (csrc/quantile_counts.cu) and
descends them (csrc/quantile_descend.cu); the host DenseQuantileTree of the
JAX package belongs to the generic backends, which are not ported.
"""

import math

from pipelinedp_tpu_torch import dp_computations
from pipelinedp_tpu_torch.aggregate_params import NoiseKind

DEFAULT_TREE_HEIGHT = 4
DEFAULT_BRANCHING_FACTOR = 16


def per_level_noise_std(eps: float, delta: float, l0: int, linf: int,
                        height: int, noise_kind: NoiseKind) -> float:
    """Per-node noise stddev with the (eps, delta) budget split equally
    across the `height` tree levels."""
    eps_level = eps / height
    if noise_kind == NoiseKind.LAPLACE:
        b = (l0 * linf) / eps_level
        return math.sqrt(2.0) * b
    if noise_kind == NoiseKind.GAUSSIAN:
        delta_level = delta / height
        return dp_computations.gaussian_sigma(eps_level, delta_level,
                                              math.sqrt(l0) * linf)
    raise ValueError(f"Unsupported noise kind {noise_kind}")
