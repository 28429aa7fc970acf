"""Sorted-segment primitives: the plain versions of the bounding scans.

Port of pipelinedp_tpu/ops/segment_ops.py:16-76 (the fast-mode scans). On
a sorted row stream, keyed grouping becomes boundary flags, cumulative
sums and cumulative maxima. The CUDA kernel bound_rows (csrc/bound_rows.cu)
computes the same ranks in one tile scan; these functions are its plain
twin and run on CPU tensors.
"""

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
