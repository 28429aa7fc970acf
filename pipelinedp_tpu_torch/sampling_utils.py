"""Sampling helpers (host side).

Port of pipelinedp_tpu/sampling_utils.py: uniform choice without
replacement that preserves native Python element types, Bernoulli keep
decisions from an injectable np.random.Generator, and the deterministic
hash-based ValueSampler (sha1 of repr, so its keep decisions are the JAX
package's). The utility analysis's partition sampling uses ValueSampler.
"""

import hashlib
from typing import Optional

import numpy as np

# Lazily created with explicit entropy (staticcheck host-rng: no
# module-global RNG instances, no draws from numpy's process-global
# state). Every helper below takes an injectable Generator and falls
# back to this one.
_rng: Optional[np.random.Generator] = None


def seed_sampling_rng(seed) -> None:
    """Seeds (or injects a np.random.Generator as) the sampling RNG."""
    global _rng
    _rng = (seed if isinstance(seed, np.random.Generator) else
            np.random.default_rng(seed))


def sampling_rng() -> np.random.Generator:
    """The host-side sampling generator, created on first use from an
    explicit fresh SeedSequence when no seed was injected."""
    global _rng
    if _rng is None:
        _rng = np.random.default_rng(np.random.SeedSequence())
    return _rng


def keep_with_probability(probability: float,
                          rng: Optional[np.random.Generator] = None) -> bool:
    """One Bernoulli(probability) keep decision from an injectable
    generator (the sampled L0-bounding filters use this instead of the
    process-global np.random state)."""
    gen = rng if rng is not None else sampling_rng()
    return bool(gen.uniform() < probability)


def choose_from_list_without_replacement(a: list,
                                         size: int,
                                         rng: Optional[
                                             np.random.Generator] = None
                                        ) -> list:
    """Uniformly samples `size` elements of `a` without replacement.

    Returns `a` unchanged when it already has <= size elements. Indices (not
    elements) are sampled so arbitrary Python objects survive unconverted.
    """
    if len(a) <= size:
        return a
    gen = rng if rng is not None else sampling_rng()
    sampled = gen.choice(np.arange(len(a)), size, replace=False)
    return [a[i] for i in sampled]


def _compute_64bit_hash(v) -> int:
    m = hashlib.sha1()
    m.update(repr(v).encode())
    return int(m.hexdigest()[:16], 16)


class ValueSampler:
    """Deterministic value sampler.

    keep(value) is deterministic per value; over random values it keeps with
    probability sampling_rate.
    """

    def __init__(self, sampling_rate: float):
        self._sample_bound = int(round(2**64 * sampling_rate))

    def keep(self, value) -> bool:
        return _compute_64bit_hash(value) < self._sample_bound
