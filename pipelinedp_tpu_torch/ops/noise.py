"""Additive noise from threefry keys: the plain version of the release
kernel's draws (port of pipelinedp_tpu/ops/noise.py:21-55).

Noise scale (stddev) is an argument, never baked into a kernel, so
BudgetAccountant.compute_budgets() may run after the graph is built.
"""

import secrets
from typing import Optional

import numpy as np
import torch

from pipelinedp_tpu_torch.aggregate_params import NoiseKind
from pipelinedp_tpu_torch.ops import threefry


def laplace_noise(key, n: int, std: torch.Tensor) -> torch.Tensor:
    """Laplace noise with the given *standard deviation* (b = std/sqrt(2))."""
    two = torch.tensor(2.0, dtype=std.dtype, device=std.device)
    b = std / torch.sqrt(two)
    return threefry.laplace(key, n, std.dtype, std.device) * b


def gaussian_noise(key, n: int, std: torch.Tensor) -> torch.Tensor:
    return threefry.normal(key, n, std.dtype, std.device) * std


def additive_noise(key, n: int, std: torch.Tensor,
                   noise_kind: NoiseKind) -> torch.Tensor:
    """n draws of noise with standard deviation `std` (a 0-d tensor of the
    working dtype) of the given kind."""
    if noise_kind == NoiseKind.LAPLACE:
        return laplace_noise(key, n, std)
    if noise_kind == NoiseKind.GAUSSIAN:
        return gaussian_noise(key, n, std)
    raise ValueError(f"Unsupported noise kind {noise_kind}")


def make_noise_key(seed: Optional[int]) -> np.ndarray:
    """Base threefry key for one aggregation: the uint32[2] halves of the
    seed, as jax.random.PRNGKey(seed) builds it; a fresh nondeterministic
    seed when None."""
    if seed is None:
        seed = secrets.randbits(63)
    return np.array([(seed >> 32) & 0xffffffff, seed & 0xffffffff],
                    dtype=np.uint32)
