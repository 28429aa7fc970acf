"""The utility-analysis sweep on the port's kernels.

Port of pipelinedp_tpu/analysis/kernels.py (K19): the whole
multi-configuration utility analysis (l0 keep fractions, clipping error
statistics, partition-selection keep probabilities and the report
reduction by partition-size bucket) over columnar row arrays, with the
parameter-configuration axis K as an array dimension, so a 64-budget
epsilon sweep is one pass over the rows, not 64 pipeline passes.

On the card it runs four kernels: C5 radix_sort orders the rows by
partition, C10 block_offsets finds each partition's run, C19 sweep_stats
walks every (configuration, partition) run in row order into the
sufficient statistics, and C20 sweep_report turns them into keep
probabilities, report rows and their bucket sums (kernels.py,
csrc/sweep_stats.cu, csrc/sweep_report.cu). On the CPU the wrappers take
their plain versions, for the tests.

sharded_sweep (the JAX package's, :369) runs the sweep over a device mesh
(parallel/mesh.py): the rows are split evenly over the shards (they need
no co-location: each row's keep fraction depends only on its own
preaggregated columns), each shard runs C5, C10 and C19 on its rows, one
C21 combine sums the statistics onto the mesh's first device, and C20
runs there once.
"""

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.analysis import error_model as em
from pipelinedp_tpu_torch.ops import selection_ops


def _generate_bucket_bounds() -> Tuple[int, ...]:
    """Partition-size histogram buckets: [0, 1] + [1, 2, 5] * 10^i."""
    result = [0, 1]
    for i in range(1, 10):
        result += [10**i, 2 * 10**i, 5 * 10**i]
    return tuple(result)


BUCKET_BOUNDS = _generate_bucket_bounds()
N_BUCKETS = len(BUCKET_BOUNDS)

# Metric codes of the sweep (stand-ins for the enum).
METRIC_CODES = {
    agg.Metrics.SUM: 0,
    agg.Metrics.COUNT: 1,
    agg.Metrics.PRIVACY_ID_COUNT: 2,
}


class SweepConfigArrays(NamedTuple):
    """Per-configuration parameter arrays (all shape [K] or [K, n_metrics])."""
    l0: np.ndarray  # max_partitions_contributed
    lo: np.ndarray  # [K, n_metrics] clip lower bounds
    hi: np.ndarray  # [K, n_metrics] clip upper bounds
    noise_std: np.ndarray  # [K, n_metrics]
    # Partition-selection scalars (see ops/selection_ops.SelectionParams):
    sel_kind: np.ndarray
    sel_pre_shift: np.ndarray
    sel_eps1: np.ndarray
    sel_delta1: np.ndarray
    sel_n_cross: np.ndarray
    sel_pi_cross: np.ndarray
    sel_threshold: np.ndarray
    sel_scale: np.ndarray


def build_config_arrays(
        config_params: Sequence[agg.AggregateParams],
        metric_list: Sequence[agg.Metric],
        noise_stds: np.ndarray,
        selection_budget: Optional[Tuple[float, float]]) -> SweepConfigArrays:
    """Packs per-config AggregateParams into kernel input arrays.

    noise_stds: [K, n_metrics] precomputed DP noise stddevs.
    selection_budget: (eps, delta) of the partition-selection mechanism, or
      None for public partitions.
    """
    k = len(config_params)
    n_metrics = max(len(metric_list), 1)
    lo = np.zeros((k, n_metrics))
    hi = np.zeros((k, n_metrics))
    for ki, params in enumerate(config_params):
        for mi, metric in enumerate(metric_list):
            lo[ki, mi], hi[ki, mi] = em.metric_bounds(params, metric)
    sel = np.zeros((8, k))
    # Benign defaults (Laplace thresholding with scale 1) so public entries
    # never produce NaNs inside unused where-branches.
    sel[0, :] = 1
    sel[7, :] = 1.0
    if selection_budget is not None:
        eps, delta = selection_budget
        for ki, params in enumerate(config_params):
            sp = selection_ops.selection_params_from_host(
                params.partition_selection_strategy, eps, delta,
                params.max_partitions_contributed, params.pre_threshold)
            sel[:, ki] = (sp.kind, sp.pre_shift, sp.eps1, sp.delta1,
                          sp.n_cross, sp.pi_cross, sp.threshold, sp.scale)
    return SweepConfigArrays(
        l0=np.array([p.max_partitions_contributed for p in config_params],
                    dtype=np.float64),
        lo=lo,
        hi=hi,
        noise_std=np.asarray(noise_stds, dtype=np.float64),
        sel_kind=sel[0],
        sel_pre_shift=sel[1],
        sel_eps1=sel[2],
        sel_delta1=sel[3],
        sel_n_cross=sel[4],
        sel_pi_cross=sel[5],
        sel_threshold=sel[6],
        sel_scale=sel[7])


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The sweep's device: CUDA unless the caller names another; CUDA
    must then be present (the sweep never moves to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the utility-analysis sweep runs on a CUDA device unless asked "
            "otherwise, and none is available; analyze on "
            "TorchBackend(device='cpu') or pass device='cpu' for the "
            "kernels' plain versions.")
    return dev


def _as(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device=dev, dtype=dtype).contiguous()


def sweep_kernel(counts,
                 sums,
                 contributed,
                 pk_idx,
                 cfg: SweepConfigArrays,
                 *,
                 n_partitions_total: int,
                 metric_codes: Tuple[int, ...],
                 public: bool,
                 config_chunk: int = 8,
                 window: int = 64,
                 partition_chunk: int = 4096,
                 return_per_partition: bool = True,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.float64):
    """The analysis sweep.

    Args:
      counts/sums/contributed: per-(privacy_id, partition) row arrays [N]
        (contribution count, value sum, partitions contributed by the id),
        numpy or torch.
      pk_idx: dense partition index per row [N], in [0, n_partitions_total);
        out-of-range indices (padding) contribute nothing.
      cfg: SweepConfigArrays with leading config axis K.
      metric_codes: tuple of METRIC_CODES values, canonical order.
      public: public-partition analysis (keep probability 1, empty-partition
        bookkeeping) vs private selection modeling.
      config_chunk, partition_chunk: bound the plain versions' working
        tensors (the kernels need no chunking).
      device: where the sweep runs (None: CUDA, raising without it).
      dtype: the working float (torch.float64, or torch.float32 as the JAX
        sweep runs with x64 off); cfg is cast to it.

    Returns dict with:
      bucket_rows: [K, N_BUCKETS, n_metrics, REPORT_WIDTH]
      bucket_info: [K, N_BUCKETS, INFO_WIDTH]
      n_users [P], n_rows [P], bucket [P] (int32),
      and, when return_per_partition: stats [K, P, n_metrics, STAT_WIDTH],
      keep_prob [K, P].
    """
    dev = resolve_device(device)
    stats = _sweep_statistics(counts, sums, contributed, pk_idx, cfg,
                              int(n_partitions_total), metric_codes, public,
                              config_chunk, dev, dtype)
    return _sweep_report(stats, cfg, public, window, partition_chunk,
                         return_per_partition, dev, dtype)


def _sweep_statistics(counts, sums, contributed, pk_idx,
                      cfg: SweepConfigArrays, p: int,
                      metric_codes: Tuple[int, ...], public: bool,
                      config_chunk: int, dev: torch.device,
                      f: torch.dtype) -> dict:
    """C5, C10 and C19 over these rows on `dev`: the per-partition
    sufficient statistics {stats, [sel], n_users, n_rows, size}."""
    counts, sums, contributed = (_as(x, f, dev)
                                 for x in (counts, sums, contributed))
    pk = _as(pk_idx, torch.int32, dev)
    if pk.shape[0]:
        perm, sorted_pk = kernels.radix_sort([pk], sorted_top=True)
        offsets = kernels.block_offsets(
            sorted_pk, torch.arange(p + 1, dtype=torch.int32, device=dev))
    else:
        perm = torch.zeros(0, dtype=torch.int64, device=dev)
        offsets = torch.zeros(p + 1, dtype=torch.int64, device=dev)
    l0, lo, hi = (_as(x, f, dev) for x in cfg[:3])
    stats, sel, n_users, n_rows, size = kernels.sweep_stats(
        counts, sums, contributed, perm, offsets, l0, lo, hi,
        metric_codes=metric_codes, private=not public,
        config_chunk=config_chunk)
    out = dict(stats=stats, n_users=n_users, n_rows=n_rows, size=size)
    if sel is not None:
        out["sel"] = sel
    return out


def _sweep_report(stats: dict, cfg: SweepConfigArrays, public: bool,
                  window: int, partition_chunk: int,
                  return_per_partition: bool, dev: torch.device,
                  f: torch.dtype) -> dict:
    """C20 over the (combined) statistics on `dev`: the sweep's result
    dict."""
    cfg_t = [_as(x, f, dev) for x in cfg]
    noise_std = cfg_t[3]
    sel_cfg = torch.stack(cfg_t[4:]).contiguous()
    n_users = stats["n_users"]
    bounds = torch.tensor(BUCKET_BOUNDS, dtype=f, device=dev)
    bucket, keep_prob, bucket_rows, bucket_info = kernels.sweep_report(
        stats["stats"], stats.get("sel"), n_users, stats["size"], noise_std,
        sel_cfg, bounds, public=public, window=window,
        partition_chunk=partition_chunk)
    result = {
        "bucket_rows": bucket_rows,
        "bucket_info": bucket_info,
        "n_users": n_users,
        "n_rows": stats["n_rows"],
        "bucket": bucket,
    }
    if return_per_partition:
        result["stats"] = stats["stats"]
        result["keep_prob"] = keep_prob
    return result


def sharded_sweep(mesh,
                  counts,
                  sums,
                  contributed,
                  pk_idx,
                  cfg: SweepConfigArrays,
                  *,
                  n_partitions_total: int,
                  metric_codes: Tuple[int, ...],
                  public: bool,
                  return_per_partition: bool = True,
                  config_chunk: int = 8,
                  window: int = 64,
                  partition_chunk: int = 4096,
                  dtype: torch.dtype = torch.float64):
    """The analysis sweep over a device mesh (the JAX package's
    sharded_sweep, :369): the rows (numpy) padded to a multiple of D with
    rows of partition n_partitions_total, which count nowhere, and split
    evenly; each shard's statistics on its device (C5, C10, C19); one C21
    combine of every statistic onto mesh.devices[0]; C20 there. Arguments
    and result as sweep_kernel's."""
    from pipelinedp_tpu_torch.parallel import collectives
    from pipelinedp_tpu_torch.parallel.mesh import on_device

    n_shards = mesh.size
    pad = (-len(counts)) % n_shards

    def padded(a, fill=0):
        return np.pad(np.asarray(a), (0, pad), constant_values=fill)

    counts, sums, contributed = (padded(a) for a in (counts, sums,
                                                     contributed))
    pk_idx = padded(pk_idx, n_partitions_total)
    per = len(counts) // n_shards
    parts = []
    for s, dev in enumerate(mesh.devices):
        rows = slice(s * per, (s + 1) * per)
        with on_device(dev):
            parts.append(_sweep_statistics(
                counts[rows], sums[rows], contributed[rows], pk_idx[rows],
                cfg, int(n_partitions_total), metric_codes, public,
                config_chunk, dev, dtype))
    stats = collectives.psum_columns(parts, mesh.device)
    with on_device(mesh.device):
        return _sweep_report(stats, cfg, public, window, partition_chunk,
                             return_per_partition, mesh.device, dtype)
