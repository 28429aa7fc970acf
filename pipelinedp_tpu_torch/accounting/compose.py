"""Batched frequency-domain PLD composition.

Port of pipelinedp_tpu/accounting/compose.py. The base library (pld.py)
composes one pair at a time; this module composes k mechanisms in ONE shot,
the recipe of "Computing DP Guarantees for Heterogeneous Compositions Using
FFT" (arXiv:2102.12412) plus the evolving-discretization coarsening of
arXiv:2207.04381:

  * zero-pad every loss pmf to the final composed grid,
  * one batched real FFT over the mechanism axis,
  * a LOG-DOMAIN sum of spectra weighted by multiplicity (a plain product
    of thousands of factors of magnitude <= 1 underflows float64; summing
    complex logs and exponentiating once does not), so k identical
    mechanisms cost the same as one (a spectrum POWER),
  * one inverse FFT.

Two execution paths share the math:

  * the HOST path (numpy, float64), bit for bit the JAX package's host
    path: the default and the number every accountant reads;
  * the DEVICE path (`device=True` or a torch device): C15 pld_fft
    (csrc/pld_fft.cu, the batched complex128 transforms) and C16
    log_spectrum (csrc/log_spectrum.cu, the weighted log-sum and its exp)
    on the card; with device="cpu" their plain PyTorch versions. It agrees
    with the host path to float64 FFT tolerance (the 1e-9 gate) and is
    never the number an accountant reads.

The SpectrumCache keeps discretized mechanism pmfs keyed by (mechanism
kind, normalized scale, sensitivity, discretization), so binary-search
probes and repeated trails reuse them; ``composed_epsilon_from_records``
rebuilds the PLD-composed spend of a record trail through it.
"""

import collections
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.accounting import pld as pldlib

# Composed-grid cell bound. When the projected one-shot grid exceeds it,
# every input pmf is pessimistically rebucketed onto a 2x coarser grid
# until the projection fits: ceiling rebucketing only moves mass to LARGER
# represented losses, so every (eps, delta) claim stays an upper bound.
DEFAULT_MAX_GRID = 1 << 21

# Rows per batched rfft block on both paths: bounds the padded [rows, L]
# float64 workspace (1 GiB at L = 2^21).
_SPECTRUM_ROWS = 64


def _next_fast_len(n: int) -> int:
    """Next power of two >= n (host and device paths transform on the same
    length, so they can be compared)."""
    return 1 << max(0, int(n - 1).bit_length())


def _projected_len(plds: Sequence[pldlib.PrivacyLossDistribution],
                   counts: Sequence[int]) -> int:
    """Finite-grid length of the composed pmf (linear convolution)."""
    return 1 + sum(c * (len(p.probs) - 1) for p, c in zip(plds, counts))


def coarsen_pld(pld: pldlib.PrivacyLossDistribution,
                factor: int) -> pldlib.PrivacyLossDistribution:
    """Pessimistically rebuckets a PLD onto a ``factor``x coarser grid.

    Mass at loss ``i * d`` moves to ``ceil(i / factor) * (factor * d)`` —
    never down, so the coarsened PLD's hockey-stick divergence dominates
    the original's at every epsilon.
    """
    if factor <= 1:
        return pld
    probs = pld.probs
    lower = pld._lower_index
    idx = -(-(lower + np.arange(len(probs), dtype=np.int64)) // factor)
    new_lo = int(idx[0])
    out = np.zeros(int(idx[-1]) - new_lo + 1, dtype=np.float64)
    np.add.at(out, idx - new_lo, probs)
    return pldlib.PrivacyLossDistribution(out, new_lo,
                                          pld.interval * factor,
                                          pld.infinity_mass)


def coarsen_to_fit(plds: Sequence[pldlib.PrivacyLossDistribution],
                   counts: Sequence[int],
                   max_grid: int) -> list:
    """Evolving discretization: halves the grid resolution of every PLD
    (pessimistic ceiling rebucketing) until the one-shot composed grid
    fits max_grid, or stops shrinking."""
    plds = list(plds)
    while _projected_len(plds, counts) > max_grid:
        shrunk = [coarsen_pld(p, 2) for p in plds]
        if _projected_len(shrunk, counts) >= _projected_len(plds, counts):
            break
        plds = shrunk
    return plds


def _pad_block(pmfs: Sequence[np.ndarray], length: int) -> np.ndarray:
    block = np.zeros((len(pmfs), length), dtype=np.float64)
    for i, pmf in enumerate(pmfs):
        block[i, :len(pmf)] = pmf
    return block


def _compose_pmfs_host(pmfs: Sequence[np.ndarray], counts: Sequence[int],
                       total_len: int) -> np.ndarray:
    """One-shot composition on the host: batched rfft, log-domain sum of
    spectra weighted by multiplicity, one irfft; numpy float64."""
    fft_len = _next_fast_len(total_len)
    total = np.zeros(fft_len // 2 + 1, dtype=np.complex128)
    for start in range(0, len(pmfs), _SPECTRUM_ROWS):
        chunk = pmfs[start:start + _SPECTRUM_ROWS]
        spectra = np.fft.rfft(_pad_block(chunk, fft_len), axis=1)
        # log of an exactly-zero spectral line is -inf (+ nan phase); the
        # bin is zeroed after the exp below, which is the correct product.
        with np.errstate(divide="ignore", invalid="ignore"):
            log_spec = np.log(spectra)
        weights = np.asarray(counts[start:start + _SPECTRUM_ROWS],
                             dtype=np.float64)
        with np.errstate(invalid="ignore"):
            total += (weights[:, None] * log_spec).sum(axis=0)
    with np.errstate(invalid="ignore"):
        spectrum = np.exp(total)
    dead = ~np.isfinite(total.real)
    if dead.any():
        spectrum[dead] = 0.0
    probs = np.fft.irfft(spectrum, n=fft_len)[:total_len]
    np.clip(probs, 0.0, None, out=probs)
    return probs


def _compose_pmfs_device(pmfs: Sequence[np.ndarray], counts: Sequence[int],
                         total_len: int, device: torch.device) -> np.ndarray:
    """The same composition through C15 and C16 (their plain versions on
    the CPU). The transform length is at least 2: C15 packs sample pairs
    into complex words."""
    fft_len = max(2, _next_fast_len(total_len))
    f64 = torch.float64
    total = torch.zeros(fft_len // 2 + 1, dtype=torch.complex128,
                        device=device)
    for start in range(0, len(pmfs), _SPECTRUM_ROWS):
        chunk = pmfs[start:start + _SPECTRUM_ROWS]
        block = torch.zeros((len(chunk), fft_len), dtype=f64, device=device)
        for i, pmf in enumerate(chunk):
            block[i, :len(pmf)] = torch.from_numpy(
                np.ascontiguousarray(pmf, dtype=np.float64)).to(device)
        weights = torch.tensor(counts[start:start + _SPECTRUM_ROWS],
                               dtype=f64, device=device)
        kernels.log_spectrum_accumulate(kernels.pld_rfft(block), weights,
                                        total)
        del block
    spectrum = kernels.log_spectrum_finalize(total)
    probs = kernels.pld_irfft(spectrum[None, :], fft_len)[0, :total_len]
    probs = probs.cpu().numpy()
    np.clip(probs, 0.0, None, out=probs)
    return probs


def _resolve_device(device) -> Optional[torch.device]:
    """None for the host path; else the torch device of the C15 / C16
    path (True is CUDA, which must be present)."""
    if device is False or device is None:
        return None
    dev = torch.device("cuda" if device is True else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "compose_plds(device=...) runs C15 / C16 on a CUDA device and "
            "none is available; pass device='cpu' for their plain versions "
            "or leave device unset for the host path.")
    return dev


def compose_plds(plds: Sequence[pldlib.PrivacyLossDistribution],
                 counts: Optional[Sequence[int]] = None,
                 *,
                 max_grid: int = DEFAULT_MAX_GRID,
                 device: Union[bool, str, torch.device] = False
                 ) -> pldlib.PrivacyLossDistribution:
    """Composes ``plds[i]`` repeated ``counts[i]`` times, in ONE shot.

    ``device`` False (the default) runs the host numpy path, the number
    every accountant reads; True or a CUDA device runs C15 / C16 on the
    card (raising without CUDA); "cpu" runs their plain versions.
    """
    plds = list(plds)
    if not plds:
        raise ValueError("compose_plds: at least one PLD is required.")
    counts = [1] * len(plds) if counts is None else [int(c) for c in counts]
    if len(counts) != len(plds):
        raise ValueError(
            f"compose_plds: {len(plds)} PLDs but {len(counts)} counts.")
    if any(c < 1 for c in counts):
        raise ValueError(f"compose_plds: counts must be >= 1: {counts}")
    interval = plds[0].interval
    for p in plds[1:]:
        if abs(p.interval - interval) > 1e-12:
            raise ValueError(
                f"compose_plds: cannot compose PLDs with different "
                f"discretization intervals: {p.interval} != {interval}")
    dev = _resolve_device(device)
    plds = coarsen_to_fit(plds, counts, max_grid)
    total_len = _projected_len(plds, counts)
    pmfs = [p.probs for p in plds]
    if len(plds) == 1 and counts[0] == 1:
        probs = np.array(pmfs[0], dtype=np.float64)
    elif dev is not None:
        probs = _compose_pmfs_device(pmfs, counts, total_len, dev)
    else:
        probs = _compose_pmfs_host(pmfs, counts, total_len)
    lower = sum(c * p._lower_index for p, c in zip(plds, counts))
    # Infinity mass composes as 1 - prod_i (1 - m_i)^c_i; log1p/expm1
    # keeps thousands of tiny atoms from rounding to zero.
    log_keep = 0.0
    for p, c in zip(plds, counts):
        if p.infinity_mass >= 1.0:
            log_keep = -math.inf
            break
        log_keep += c * math.log1p(-p.infinity_mass)
    infinity_mass = 1.0 if log_keep == -math.inf else -math.expm1(log_keep)
    return pldlib.PrivacyLossDistribution(probs, lower, plds[0].interval,
                                          infinity_mass)


# ---------------------------------------------------------------------------
# Spectrum cache
# ---------------------------------------------------------------------------


class SpectrumCache:
    """Bounded process-wide cache of discretized mechanism loss pmfs.

    Keyed by (mechanism kind, normalized scale, sensitivity,
    discretization). ``scale`` is sigma/sens for Gaussian, b/sens for
    Laplace, the (eps0, delta0) pair for generic and unknown kinds.
    LRU-evicted past ``max_entries``; thread-safe (one lock guards the
    entries).
    """

    def __init__(self, max_entries: int = 256):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, Any]" = (
            collections.OrderedDict())
        self._max_entries = int(max_entries)

    @staticmethod
    def _key(mechanism_kind: str, scale, sensitivity: float,
             discretization: float) -> tuple:
        scale_key = (tuple(float(s) for s in scale)
                     if isinstance(scale, (tuple, list)) else float(scale))
        return (str(mechanism_kind), scale_key, float(sensitivity),
                float(discretization))

    def get(self, mechanism_kind: str, scale, sensitivity: float,
            discretization: float) -> pldlib.PrivacyLossDistribution:
        """The discretized PLD for the key, built on first use."""
        key = self._key(mechanism_kind, scale, sensitivity, discretization)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                return hit
        built = self._build(mechanism_kind, scale, discretization)
        with self._lock:
            self._entries[key] = built
            while len(self._entries) > self._max_entries:
                self._entries.popitem(last=False)
        return built

    @staticmethod
    def _build(mechanism_kind: str, scale,
               discretization: float) -> pldlib.PrivacyLossDistribution:
        kind = str(mechanism_kind).rsplit(".", 1)[-1].strip().upper()
        if kind == "GAUSSIAN" and not isinstance(scale, (tuple, list)):
            return pldlib.from_gaussian_mechanism(
                float(scale), value_discretization_interval=discretization)
        if kind == "LAPLACE" and not isinstance(scale, (tuple, list)):
            return pldlib.from_laplace_mechanism(
                float(scale), value_discretization_interval=discretization)
        # GENERIC, forfeits and unknown kinds: the worst-case three-point
        # PLD of an (eps0, delta0)-DP mechanism dominates every mechanism
        # with that guarantee, so composing with it is a sound upper bound.
        eps0, delta0 = (scale if isinstance(scale, (tuple, list))
                        else (float(scale), 0.0))
        return pldlib.from_privacy_parameters(
            max(float(eps0), 0.0), min(max(float(delta0), 0.0), 1.0 - 1e-15),
            value_discretization_interval=discretization)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# The process-wide default cache (PLDBudgetAccountant probes and trail
# rebuilds share it; tests construct their own).
CACHE = SpectrumCache()


# ---------------------------------------------------------------------------
# Record trail -> composed epsilon
# ---------------------------------------------------------------------------


def mechanism_key_for_record(record: Dict[str, Any]) -> Tuple[str, Any]:
    """(mechanism kind, normalized scale) of one odometer / ledger record.

    Prefers the record's ``noise_std`` (the calibrated mechanism) and falls
    back to the scale of its (eps, delta) share — for Gaussian the exact
    single-mechanism calibration. Records no closed form models map to the
    dominating three-point (eps, delta) PLD.
    """
    kind = str(record.get("mechanism_kind") or "")
    short = kind.rsplit(".", 1)[-1].strip().upper()
    sensitivity = float(record.get("sensitivity") or 1.0)
    if sensitivity <= 0:
        sensitivity = 1.0
    noise_std = record.get("noise_std")
    eps = record.get("eps")
    delta = float(record.get("delta") or 0.0)
    if short == "GAUSSIAN":
        if noise_std:
            return kind, float(noise_std) / sensitivity
        if eps and delta > 0:
            from pipelinedp_tpu_torch import dp_computations
            return kind, float(
                dp_computations.gaussian_sigma(float(eps), delta, 1.0))
    elif short == "LAPLACE":
        if noise_std:
            return kind, float(noise_std) / (sensitivity * math.sqrt(2.0))
        if eps:
            return kind, 1.0 / float(eps)
    return kind, (float(eps or 0.0), delta)


def composed_epsilon_from_records(
        records: Sequence[Dict[str, Any]],
        *,
        discretization: float = 1e-4,
        target_delta: Optional[float] = None,
        cache: Optional[SpectrumCache] = None,
        max_grid: int = DEFAULT_MAX_GRID) -> Tuple[float, float]:
    """PLD-composed total epsilon of a record trail.

    Groups identical mechanisms into spectrum powers, fetches their pmfs
    through the cache, composes on the host and queries epsilon at
    ``target_delta`` (default: the trail's naive delta spend). Records whose
    budget is pending (eps None) are skipped. Returns (epsilon,
    target_delta); epsilon is +inf when target_delta is below the composed
    infinity mass.
    """
    if cache is None:
        cache = CACHE
    groups: "collections.OrderedDict[tuple, int]" = collections.OrderedDict()
    naive_delta = 0.0
    for record in records:
        if record.get("eps") is None:
            continue
        count = int(record.get("count") or 1)
        key = mechanism_key_for_record(record)
        groups[key] = groups.get(key, 0) + count
        naive_delta += float(record.get("delta") or 0.0) * count
    if target_delta is None:
        target_delta = min(naive_delta, 1.0 - 1e-12)
    if not groups:
        return 0.0, target_delta
    plds = [
        cache.get(kind, scale, 1.0, discretization)
        for kind, scale in groups
    ]
    composed = compose_plds(plds, list(groups.values()), max_grid=max_grid)
    return composed.get_epsilon_for_delta(target_delta), target_delta
