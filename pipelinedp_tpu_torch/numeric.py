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
word on the host, by numeric_mode:

  * "fast" (default): NaN or Inf raises ReleaseIntegrityError; the
    saturation bit alone is advisory.
  * "safe": Inf or saturation raises NumericOverflowError, NaN
    ReleaseIntegrityError: overflow is refused before it rounds to a
    finite but wrong release.
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
                  context: str = "release",
                  numeric_mode: str = "fast") -> None:
    """Raises on a tripped flag word of the released columns, classified
    as the JAX package's check_release classifies it (numeric.py:158-182):
    NumericOverflowError for Inf or saturation in numeric_mode="safe",
    ReleaseIntegrityError for NaN, and for Inf in "fast" mode."""
    overflow = bool(flags & (FLAG_INF | FLAG_SAT))
    poisoned = bool(flags & FLAG_NAN)
    if numeric_mode == "safe":
        tripped = overflow or poisoned
    else:
        tripped = bool(flags & FLAG_INF) or poisoned
    if not tripped:
        return
    bits = ", ".join(release_flag_bits(flags))
    msg = (f"release sentinel tripped at {context}: released columns carry "
           f"{bits} (numeric_mode={numeric_mode!r}). Failing closed: "
           f"nothing released, budget forfeited conservatively. Columns "
           f"checked: {sorted(columns)}.")
    if numeric_mode == "safe" and overflow and not poisoned:
        raise NumericOverflowError(
            msg + " Overflow-safe accumulation detected saturation/Inf "
            "before release; reduce input magnitude or clip bounds.")
    raise ReleaseIntegrityError(msg)
