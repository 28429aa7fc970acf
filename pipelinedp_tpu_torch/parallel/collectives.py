"""Cross-shard data movement of the single-controller mesh.

The counterparts of the collectives the JAX package's meshed programs run
inside shard_map (lax.psum, lax.all_gather, lax.all_to_all), for a
parallel/mesh.Mesh whose D shard slots one process drives:

  * gather(parts, device): the D per-shard tensors stacked [D, ...] on one
    device. A shard already on that device is read where it lies; a shard
    on another card comes over by peer copy.
  * psum(parts, device, compensated) and psum_columns: C21
    (kernels.combine_parts) over the shards' tensors where they lie, one
    launch for every column: the shards' sum, in shard order, or for
    float32 in numeric_mode="safe" through the TwoSum fold of the JAX
    package's compensated_psum. Nothing is concatenated or stacked; a
    part on another card comes over by peer copy first. The result lies
    on `device` only: the replicated release runs there once, not once a
    shard.
  * all_to_all(copies): the exchange's slices staged on a source shard's
    device for a destination on another card, copied into the
    destination's receive buffer.

On a mesh whose slots share one device, gather is one stack of the
shards' tensors, psum copies nothing and all_to_all has nothing to copy. Nothing here catches
a failure: a failed copy or launch raises to the caller.
"""

from typing import Sequence, Tuple

import torch

from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel.mesh import on_device


def gather(parts: Sequence[torch.Tensor],
           device: torch.device) -> torch.Tensor:
    """The per-shard tensors (one shape and dtype) stacked [D, ...] on
    `device`."""
    return torch.stack([p.to(device, non_blocking=True) for p in parts])


def psum(parts: Sequence[torch.Tensor], device: torch.device,
         compensated: bool = False) -> torch.Tensor:
    """The sum of the per-shard tensors (one shape and dtype, contiguous)
    on `device` (C21). compensated applies to float32 only, as
    compensated_psum's: integer and float64 partials take the plain
    sum."""
    compensated = compensated and parts[0].dtype == torch.float32
    with on_device(device):
        return kernels.combine_parts(
            [[p.to(device, non_blocking=True)] for p in parts],
            compensated)[0]


def psum_columns(parts: Sequence[dict], device: torch.device,
                 compensated: bool = False) -> dict:
    """psum of every column of the shards' column dicts (one key set, one
    dtype, each column contiguous), as one C21 launch over the columns
    where they lie: the [P] and [P, V] partial columns of a release, or
    the analysis sweep's statistics. Each summed column is a new tensor in
    its shape."""
    names = list(parts[0])
    if not names:
        return {}
    compensated = compensated and parts[0][names[0]].dtype == torch.float32
    with on_device(device):
        total = kernels.combine_parts(
            [[cols[k].to(device, non_blocking=True) for k in names]
             for cols in parts], compensated)
    return dict(zip(names, total))


def all_to_all(copies: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Copies each staged slice into its place on another device:
    copies[i] = (destination view, source slice). PyTorch orders a
    cross-device copy after the work queued on both devices' current
    streams."""
    for dst, src in copies:
        dst.copy_(src, non_blocking=True)
