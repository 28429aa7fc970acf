"""Sorted-segment primitives: the plain versions of the bounding scans and
of the compensated sums.

Port of pipelinedp_tpu/ops/segment_ops.py:16-76 (the fast-mode scans) and
:100-157 (numeric_mode="safe"). On a sorted row stream, keyed grouping
becomes boundary flags, cumulative sums and cumulative maxima. The CUDA
kernel bound_rows (csrc/bound_rows.cu) computes the same ranks in one tile
scan; the compensated entry of reduce_partitions.cu carries the TwoSum
(hi, lo) pairs below through its segmented scan. These functions are
their plain twins.
"""

from typing import Callable, Sequence, Tuple

import torch


def boundary_mask(*sorted_keys: torch.Tensor) -> torch.Tensor:
    """True where any of the (already sorted) key columns changes."""
    n = sorted_keys[0].shape[0]
    mask = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    if n:
        mask[0] = True
    for key in sorted_keys:
        mask[1:] |= key[1:] != key[:-1]
    return mask


def segment_start_positions(new_segment: torch.Tensor) -> torch.Tensor:
    """Per row, the index of its segment's first row (cummax fill)."""
    idx = torch.arange(new_segment.shape[0], device=new_segment.device)
    return torch.cummax(torch.where(new_segment, idx, 0), 0).values


def segment_starts_and_ids(new_segment: torch.Tensor):
    """(segment_id, rank) per row of a sorted stream: 0-based dense segment
    index and 0-based position inside the segment."""
    idx = torch.arange(new_segment.shape[0], device=new_segment.device)
    segment_id = torch.cumsum(new_segment.to(torch.int64), 0) - 1
    return segment_id, idx - segment_start_positions(new_segment)


def segment_rank_of_segments(new_segment: torch.Tensor,
                             new_group: torch.Tensor) -> torch.Tensor:
    """0-based rank of each row's segment within its enclosing group (every
    group boundary is also a segment boundary)."""
    seg_ordinal = torch.cumsum(new_segment.to(torch.int64), 0)  # 1-based
    group_base = torch.cummax(torch.where(new_group, seg_ordinal, 0),
                              0).values
    return seg_ordinal - group_base


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b), e the residue)."""
    s = a + b
    bv = s - a
    av = s - bv
    e = (a - av) + (b - bv)
    return s, e


def _comp_combine(x, y):
    """Associative combiner over compensated (hi, lo) partial sums: the
    residue of the high-word addition goes into the low word; the low
    words add in plain float (second-order rounding)."""
    h1, l1 = x
    h2, l2 = y
    h, e = _two_sum(h1, h2)
    return h, e + (l1 + l2)


def _associative_scan(fn: Callable, elems: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of 1-D tensors under `fn`, combining elements in the
    order of jax.lax.associative_scan (pairs, a recursive scan of the pair
    sums, then the even elements), so rounding matches the JAX package's."""
    n = elems[0].shape[0]
    if n < 2:
        return tuple(elems)
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        res = torch.empty_like(e)
        res[0] = e[0]
        res[2::2] = ev
        res[1::2] = od
        out.append(res)
    return tuple(out)


def compensated_cumsum(x: torch.Tensor):
    """Compensated (double-word) cumulative sum: (hi, lo) prefix tensors.

    hi[i] + lo[i] tracks sum(x[:i+1]) to ~2 ulps of a double-precision
    accumulation: exact for integer-valued float32 inputs up to ~2^48 per
    prefix, where a plain float32 cumsum loses low-order contributions past
    2^24. Integer and float64 columns take the plain cumsum and a zero low
    word, as in the JAX package.
    """
    if not x.is_floating_point() or x.dtype == torch.float64:
        return torch.cumsum(x, 0, dtype=x.dtype), torch.zeros_like(x)
    return _associative_scan(_comp_combine, (x, torch.zeros_like(x)))


def compensated_segment_diff(hi: torch.Tensor, lo: torch.Tensor,
                             starts: torch.Tensor) -> torch.Tensor:
    """Segment sums from compensated prefixes at the `starts` boundaries
    (segment j is rows starts[j] .. starts[j + 1] - 1).

    TwoSum of (hi_end, -hi_start) recovers the high-word difference
    exactly; adding the residue and the low-word difference keeps segment
    sums exact wherever the prefixes were. An overflowed prefix turns the
    residues into Inf - Inf = NaN: there the plain high-word difference
    is taken, so overflow reaches the release sentinel as Inf, not NaN.
    """
    zero = torch.zeros((1,), dtype=hi.dtype, device=hi.device)
    hp = torch.cat([zero, hi])
    lp = torch.cat([zero, lo])
    h_end, h_start = hp[starts[1:]], hp[starts[:-1]]
    d, e = _two_sum(h_end, -h_start)
    comp = d + (e + (lp[starts[1:]] - lp[starts[:-1]]))
    plain = h_end - h_start
    return torch.where(torch.isfinite(comp), comp, plain)
