"""The fail-closed release sentinel and its typed errors.

Port of pipelinedp_tpu/numeric.py:53-180. A released column that carries
NaN, Inf or a magnitude at half the dtype maximum is a numerically wrong
release that every replay gate would pass, so the release fails closed:
nothing is decoded and the job raises a typed error.

The flag word (NaN = 1, Inf = 2, saturation = 4) over the kept partitions
is reduced on the device by the release kernels (csrc/release_epilogue.cu,
and for percentiles and vector sums csrc/quantile_descend.cu and
csrc/vector_release.cu, which OR their bits into the same word);
`flags_from_kept` is its plain version. `check_release` classifies the
word on the host.
"""

from typing import Dict, Iterable

import torch


class ReleaseIntegrityError(RuntimeError):
    """A released column failed the numeric release sentinel.

    Fail closed: nothing was released for this job; the budget grant is
    forfeited conservatively (mechanisms were registered at graph time).
    """


class NumericOverflowError(ReleaseIntegrityError):
    """An accumulator overflowed (Inf) or saturated near the dtype max."""


FLAG_NAN = 1
FLAG_INF = 2
FLAG_SAT = 4


def column_flags(col: torch.Tensor, gate: torch.Tensor) -> int:
    """Flag word of one released column ([P] or [P, D]) under a bool[P]
    gate; a row of a 2-D column is gated by its partition."""
    if col.dim() > 1:
        gate = gate[:, None]
    limit = torch.finfo(col.dtype).max / 2
    flags = 0
    if bool((torch.isnan(col) & gate).any()):
        flags |= FLAG_NAN
    if bool((torch.isinf(col) & gate).any()):
        flags |= FLAG_INF
    if bool((torch.isfinite(col) & (col.abs() >= limit) & gate).any()):
        flags |= FLAG_SAT
    return flags


def flags_from_mask(cols: Dict[str, torch.Tensor], keep: torch.Tensor) -> int:
    """Flag word over dense columns under a bool keep mask."""
    flags = 0
    for name in sorted(cols):
        flags |= column_flags(cols[name], keep)
    return flags


def flags_from_kept(cols: Dict[str, torch.Tensor], n_kept: int) -> int:
    """Flag word over kept-first compacted columns ([:n_kept] live)."""
    p = next(iter(cols.values())).shape[0]
    gate = torch.arange(p, device=next(iter(cols.values())).device) < n_kept
    return flags_from_mask(cols, gate)


def release_flag_bits(flags: int):
    """Human-readable names of the tripped sentinel bits."""
    names = []
    if flags & FLAG_NAN:
        names.append("NaN")
    if flags & FLAG_INF:
        names.append("Inf")
    if flags & FLAG_SAT:
        names.append("saturation")
    return names


def check_release(flags: int, columns: Iterable[str],
                  context: str = "release") -> None:
    """Raises ReleaseIntegrityError when the flag word of the released
    columns holds NaN or Inf (numeric_mode="fast": saturation alone is
    advisory, as in the JAX package)."""
    if not flags & (FLAG_NAN | FLAG_INF):
        return
    bits = ", ".join(release_flag_bits(flags))
    raise ReleaseIntegrityError(
        f"release sentinel tripped at {context}: released columns carry "
        f"{bits} (numeric_mode='fast'). Failing closed: nothing released, "
        f"budget forfeited conservatively. Columns checked: "
        f"{sorted(columns)}.")
