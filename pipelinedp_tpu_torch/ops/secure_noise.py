"""Secure discrete noise: snapped, integer-grid DP release.

Port of pipelinedp_tpu/ops/secure_noise.py. Released values live on a
power-of-two grid g: the value snapped to g (round half to even) plus
g * X, where X is an integer atom in [-K, K] drawn by inverse CDF from a
table of 64-bit fixed-point thresholds (a discrete Laplace or discrete
Gaussian). Continuous float noise leaks through its low-order bits
(Mironov 2012); a grid release has none to leak.

`build_table` / `build_tables` are host numpy, run after the budgets are
final (the noise scale is a launch argument, never baked into a kernel);
this module keeps its own copy of them. The rest are the plain tensor
versions of the sampler: `lex_search` is the search the CUDA kernels run
per noised value (`pdp::snapped_release` in csrc/common.cuh, called by
release_epilogue.cu, quantile_descend.cu and vector_release.cu), and
`snapped_release` / `snapped_noisy` the release discipline around it.

On the device a table is one int64 row per slot holding the u64 threshold
hi << 32 | lo (`pack_tables`); the search compares it as unsigned, which is
the JAX package's lexicographic compare of (hi, lo) u32 pairs.
"""

import math
from typing import Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch.aggregate_params import NoiseKind
from pipelinedp_tpu_torch.ops import threefry

# Number of atoms per side of the table (table length = 2K+1). 4096 atoms
# with the granularity rule below keeps tail mass < e^-44 per draw.
DEFAULT_MAX_ATOMS = 2048

# Laplace scales / Gaussian sigmas the table must span for negligible tails.
_LAPLACE_SPAN = 44.0
_GAUSSIAN_SPAN = 10.0

_M32 = 0xFFFFFFFF


def _pow2_ceil(x: float) -> float:
    return 2.0**math.ceil(math.log2(x))


def build_table(std: float, noise_kind: NoiseKind,
                max_atoms: int = DEFAULT_MAX_ATOMS,
                sensitivity: float = None,
                grid_floor: float = None
                ) -> Tuple[np.ndarray, np.ndarray, float]:
    """The 64-bit fixed-point inverse-CDF table of one noise slot.

    Returns (thr_hi, thr_lo, granularity): u32 arrays of length 2K+1 with
    thr = cumsum(pmf) * 2^64 split into high/low words, and the grid step g.
    The represented noise is g * atom with atom in [-K, K].

    When `sensitivity` (the mechanism's norm sensitivity Delta: l1 for
    Laplace, l2 for Gaussian) is given, the grid-unit noise scale is widened
    from Delta/g to floor(Delta/g)+1 sensitivity units: rounding x to the
    g-grid maps neighbors at distance <= Delta up to floor(Delta/g)+1 grid
    steps apart. Without `sensitivity` the raw calibration is used (pure
    distribution sampling; not privacy-correct for snapped releases).
    """
    if std <= 0:
        # Degenerate slot (e.g. unused std entry): identity table.
        k = np.zeros(2 * max_atoms + 1, dtype=np.uint64)
        k[max_atoms:] = np.uint64(0xFFFFFFFFFFFFFFFF)
        return ((k >> np.uint64(32)).astype(np.uint32),
                (k & np.uint64(0xFFFFFFFF)).astype(np.uint32), 1.0)
    K = max_atoms
    scale = std / math.sqrt(2.0) if noise_kind == NoiseKind.LAPLACE else std
    span = (_LAPLACE_SPAN
            if noise_kind == NoiseKind.LAPLACE else _GAUSSIAN_SPAN)
    if noise_kind not in (NoiseKind.LAPLACE, NoiseKind.GAUSSIAN):
        raise ValueError(f"Unsupported noise kind {noise_kind}")
    g = _pow2_ceil(span * scale / K)
    if grid_floor is not None and grid_floor > g:
        # snap_grid_bits: a declared power-of-two floor on the grid; a
        # coarser grid is allowed (the compensation below re-widens the
        # scale), a finer one is ignored (the tail-span rule is a
        # soundness bound).
        g = _pow2_ceil(grid_floor)
    t = scale / g  # noise scale in grid units
    if sensitivity is not None and sensitivity > 0:
        # Snapping-compensated calibration; if the widened scale no longer
        # fits the tail span, coarsen the grid and retry (terminates: g
        # doubling shrinks floor(Delta/g)+1 toward 1).
        while True:
            t = (math.floor(sensitivity / g) + 1) * scale / sensitivity
            if t * span <= K or math.floor(sensitivity / g) == 0:
                break
            g *= 2.0
    atoms = np.arange(-K, K + 1, dtype=np.float64)
    if noise_kind == NoiseKind.LAPLACE:
        logw = -np.abs(atoms) / t
    else:
        logw = -(atoms * atoms) / (2.0 * t * t)
    w = np.exp(logw - logw.max())
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    # float64 cannot represent 2^64 - 1; clamp to the largest float64 below
    # 2^64 before casting.
    top = np.nextafter(float(2**64), 0.0)
    thr = np.minimum(cdf * float(2**64), top)
    thr_u = thr.astype(np.uint64)
    thr_u[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return ((thr_u >> np.uint64(32)).astype(np.uint32),
            (thr_u & np.uint64(0xFFFFFFFF)).astype(np.uint32), float(g))


def build_tables(stds, noise_kind: NoiseKind,
                 max_atoms: int = DEFAULT_MAX_ATOMS, sensitivities=None,
                 grid_floor: float = None):
    """Stacked tables for all noise slots: (S, 2K+1) u32 x2 and (S,) f64."""
    stds = np.asarray(stds, dtype=np.float64)
    if sensitivities is None:
        sensitivities = [None] * len(stds)
    his, los, grans = [], [], []
    for std, sens in zip(stds, sensitivities):
        hi, lo, g = build_table(float(std), noise_kind, max_atoms,
                                sensitivity=sens, grid_floor=grid_floor)
        his.append(hi)
        los.append(lo)
        grans.append(g)
    return (np.stack(his), np.stack(los), np.asarray(grans,
                                                     dtype=np.float64))


def pack_tables(thr_hi: np.ndarray, thr_lo: np.ndarray) -> np.ndarray:
    """The u64 thresholds hi << 32 | lo as int64 bit patterns (the kernels'
    layout: one row per slot)."""
    packed = (thr_hi.astype(np.uint64) << np.uint64(32)) | \
        thr_lo.astype(np.uint64)
    return packed.view(np.int64)


def unpack(thr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) u32 words, as int64 tensors, of packed thresholds."""
    return (thr >> 32) & _M32, thr & _M32


def lex_search(thr_hi: torch.Tensor, thr_lo: torch.Tensor,
               uhi: torch.Tensor, ulo: torch.Tensor) -> torch.Tensor:
    """First index i with thr[i] > u, comparing (hi, lo) u32 pairs as u64
    (int64 tensors of u32 words; thr 1-D, u any shape).

    P(result = i) = (thr[i] - thr[i-1]) * 2^-64 for u uniform on u64: exact
    inverse-CDF sampling. The invariant range is [0, len - 1]: the last
    entry is 2^64 - 1 >= u.
    """
    n_table = thr_hi.shape[0]
    lo = torch.zeros(uhi.shape, dtype=torch.int64, device=uhi.device)
    hi = torch.full(uhi.shape, n_table - 1, dtype=torch.int64,
                    device=uhi.device)
    for _ in range(int(math.ceil(math.log2(n_table))) + 1):
        mid = (lo + hi) // 2
        mh = thr_hi[mid]
        ml = thr_lo[mid]
        le = (mh < uhi) | ((mh == uhi) & (ml <= ulo))
        lo = torch.where(le, mid + 1, lo)
        hi = torch.where(le, hi, mid)
    return hi


def sample_discrete(key, n: int, thr_hi: torch.Tensor,
                    thr_lo: torch.Tensor) -> torch.Tensor:
    """n integer noise atoms in [-K, K] from one slot's table (the JAX
    package's sample_discrete with shape (n,))."""
    k1, k2 = threefry.split(key, 2)
    counters = torch.arange(n, dtype=torch.int64, device=thr_hi.device)
    idx = lex_search(thr_hi, thr_lo, threefry.bits_at(k1, counters),
                     threefry.bits_at(k2, counters))
    return idx - (thr_hi.shape[0] - 1) // 2


def snapped_release(col: torch.Tensor, uhi: torch.Tensor, ulo: torch.Tensor,
                    thr: torch.Tensor, gran: float) -> torch.Tensor:
    """Snap `col` to the grid (round half to even) and add grid-integer
    discrete noise drawn from the uniform u64 words (uhi, ulo). thr: one
    slot's packed table; gran is cast to col's dtype, as the JAX package
    casts it."""
    f = col.dtype
    g = torch.tensor(gran, dtype=f).to(col.device)
    snapped = torch.round(col / g) * g
    idx = lex_search(*unpack(thr), uhi, ulo)
    return snapped + (idx - (thr.shape[0] - 1) // 2).to(f) * g


def split_words(key, counters: torch.Tensor):
    """(uhi, ulo) at `counters` for a draw under `key`: the words of
    bits(k1, shape) and bits(k2, shape) with (k1, k2) = split(key), as
    snapped_noisy draws them."""
    k1, k2 = threefry.split(key, 2)
    return threefry.bits_at(k1, counters), threefry.bits_at(k2, counters)


def snapped_noisy(col: torch.Tensor, key, thr: torch.Tensor,
                  gran: float) -> torch.Tensor:
    """snapped_release with randomness from one threefry key: element i of
    the column draws at flat counter i."""
    counters = torch.arange(col.numel(), dtype=torch.int64,
                            device=col.device).reshape(col.shape)
    return snapped_release(col, *split_words(key, counters), thr, gran)
