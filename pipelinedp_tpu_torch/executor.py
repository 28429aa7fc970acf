"""Fused columnar DP aggregation executor, dense route.

Port of the dense route of pipelinedp_tpu/executor.py. Contribution
bounding, the per-partition reduction, private partition selection, noise
and kept-first compaction run over columnar tensors on one device:

    rows (pid, pk, value)
      [max_contributions: C1 total_bound_keys -> C5 sort by (pid, u0)
       -> C2 total_bound_rows: first K rows of each pid, reordered]
      -> C1 row_keys: sort keys (pid|hash0, hash1|pk) + row uniform u
      -> C5 radix_sort by (k1, k2, u)
      -> C2 bound_rows: Linf rank < linf, L0 pair rank < l0, clipping
      -> C5 radix_sort by kept partition
      -> C3 reduce_partitions: dense count/pid_count/sum/nsum/nsum2
         [VECTOR_SUM: the D-column sums, gathered through both sorts]
      -> C4 release_epilogue: selection, noise, metric formulas, flags
      [VECTOR_SUM: C9 vector_release: norm-ball clip, noise, flags]
      [PERCENTILE, P <= quantile_chunk: C7 leaf histogram + level roll-ups
       -> C8 descent through every level; else per level: C7 child counts
       -> C8 one descent step]
      -> C6 compact_kept: kept-first compaction

Standalone partition selection (lazy_select_partitions) runs the same
kernels without values: C1 (no u), C5 by (k1, k2), C2 with linf = 0, C5
by kept partition, C3's pid_count, C4 with an empty plan, C6.

Above the backend's large_partition_threshold both entry points take the
blocked route instead (parallel/large_p.py): pass 1 bounds and sorts the
rows once, and every block of partitions runs C3 (and C7) on its window
of the sorted stream, then C4 / C8 / C9 and C6 on its own partitions.

On a TorchBackend with a mesh (parallel/mesh.py) the dense route runs
over it (parallel/sharded.py): each shard of privacy-id-co-located rows
runs phase 1 (partial_columns: C1 through C3, and C7's counts) under its
own rows key, C21 sums the shards' columns (and the quantile counts) onto
the mesh's first device, and phase 2 (release_columns: C4, C9, C8, C6)
runs there once. Selection counts a shard (select_partition_counts) and
selects once (select_release); the lane-batched releases split the same
way (batched_partial_columns, batched_release_columns). Above the
threshold the blocked route runs over the mesh too
(large_p.aggregate_blocked_sharded, select_partitions_blocked_sharded):
pass 1 a shard, each block's windows a shard, C21, the block's release
once.

TorchBackend(fused_release=False) runs the unfused release
(aggregate_kernel, select_partitions_kernel): the same kernels but C6, the
dense [P] outputs and keep vector decoded on the host by np.nonzero
(decode_results), as TPUBackend(fused_release=False).

Input is rows (columnar.encode), a pre-encoded EncodedData, or a
runtime.pipeline.ChunkSource of column chunks (stream_chunk_source: the
streamed ingest of ingest.py, whose columns arrive on the device already
padded, C12-C14). An EncodedData of ShardedColumns (the pod ingest,
ingest.encode_local_shard_to_mesh) goes to the mesh where it lies, or in
its global row order to one device.

The multi-tenant service (service/) offers each job's dense release to a
per-thread launch interceptor (launch_interceptor, ReleaseLaunch): its
coalescer runs identical-spec jobs as lanes of one lane-batched release
(batched_aggregate_release_kernel, batched_select_partitions_release_kernel:
the lane entries of C1, C2, C3, C4, C6, C8 and C9, C5 with the lane as its
top word, C7 over the lanes' partitions as one range), each lane equal to
its solo run bit for bit. Every spec the dense release runs batches: the
total bound, pre-bounded rows, VECTOR_SUM, PERCENTILE, secure noise and
safe mode each have their lane entries.

Random choices come from the JAX package's threefry keys (ops/threefry.py),
derived on the host in the same order, so one seed gives the same bounded
rows, keep decisions and noise words on both packages. Noise stddevs and
selection budgets are launch arguments read when the lazy result is first
iterated, after BudgetAccountant.compute_budgets().

The working float width is the backend's `dtype`: float64 is the parity
mode the tests compare with the JAX package run under x64; float32 is the
card's mode, as the TPU's was.

Two backend options change the release, as in the JAX package:
secure_noise=True releases every noised column (metric slots, vector
coordinates, quantile-tree nodes) on a power-of-two grid with discrete
noise from 64-bit inverse-CDF tables built on the host after the budgets
(ops/secure_noise.py; the C4, C8 and C9 entries with tables=), and
numeric_mode="safe" sums float32 partition columns through compensated
(TwoSum) pairs (C3's compensated entry) and makes the release sentinel
refuse Inf and saturation with NumericOverflowError.
"""

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import columnar
from pipelinedp_tpu_torch import combiners as dp_combiners
from pipelinedp_tpu_torch import dp_computations
from pipelinedp_tpu_torch import ingest
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch import numeric
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams,
                                                   MechanismType, Metrics,
                                                   NoiseKind, NormKind)
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.ops import secure_noise
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry
from pipelinedp_tpu_torch.parallel.mesh import (ShardedColumn, on_device,
                                                resplit, rows_per_shard)
from pipelinedp_tpu_torch.runtime import observability as rt_observability
from pipelinedp_tpu_torch.runtime import pipeline as rt_pipeline

# Out-of-scope features name the ROADMAP item that ports them.
_LATER = {
    "custom": "ROADMAP.md Queue 1 item 14 (custom combiners on the generic "
              "backends)",
    "vector_percentile": "ROADMAP.md Queue 1 item 14 (VECTOR_SUM together "
                         "with a percentile leaves the columnar path for "
                         "the generic backends)",
}


@dataclass(frozen=True)
class MetricPlanEntry:
    """Static description of one child combiner's device computation."""
    kind: str  # count | privacy_id_count | sum | mean | variance |
    #            vector_sum | quantiles
    outputs: Tuple[str, ...]  # metric names in the child's output order
    n_stds: int  # number of noise stddevs the entry consumes


@dataclass(frozen=True)
class KernelConfig:
    """Static configuration of one dense release."""
    n_partitions: int
    linf: int  # 0 = no per-partition row sampling
    l0: int  # 0 = no cross-partition bound (max_contributions)
    total_bound: int  # max_contributions; 0 = none
    sample_per_partition: bool
    clip_per_value: bool
    clip_pair_sum: bool
    bounds_enforced: bool
    noise_kind: NoiseKind
    private_selection: bool
    selection: Optional[selection_ops.SelectionParams]
    max_rows_per_privacy_id: int
    plan: Tuple[MetricPlanEntry, ...]
    degenerate_range: bool  # min_value == max_value
    # VECTOR_SUM: values are [n, vector_size] rows; each partition's sum is
    # clipped to the norm ball and noised per coordinate (C9).
    vector_size: int = 0  # 0 = scalar values
    vector_max_norm: float = 0.0
    vector_norm_kind: Optional[NormKind] = None
    # PERCENTILE: a quantile tree of height tree_height and branching
    # `branching` per partition (C7, C8); quantile_chunk partitions fit one
    # leaf histogram of ~2^25 cells, and more partitions than that take the
    # lazy descent, as in the JAX package.
    quantiles: Tuple[float, ...] = ()
    tree_height: int = 0
    branching: int = 0
    quantile_chunk: int = 0
    # secure_noise: snapped discrete noise from the slots' tables on every
    # noised column (C4, C8, C9 with tables=).
    secure: bool = False
    # "fast", or "safe": compensated float32 partition sums (C3) and the
    # sentinel's overflow classification.
    numeric_mode: str = "fast"


def check_supported(params: AggregateParams, public_partitions) -> None:
    """Raises NotImplementedError for what this slice of the port does not
    run yet."""
    if params.custom_combiners:
        raise NotImplementedError(
            f"custom combiners are not ported yet: {_LATER['custom']}")
    if params.max_contributions is not None and public_partitions is None:
        raise NotImplementedError(
            "max_contributions with private partition selection: the JAX "
            "package fails there (its selection takes "
            "max_partitions_contributed, which is unset), so the port has "
            "no reference to match; see ROADMAP.md Queue 3. Pass "
            "public_partitions.")
    metrics = params.metrics or []
    if Metrics.VECTOR_SUM in metrics and any(m.is_percentile
                                            for m in metrics):
        raise NotImplementedError(
            f"VECTOR_SUM with PERCENTILE: {_LATER['vector_percentile']}")


def build_plan(
        compound: dp_combiners.CompoundCombiner
) -> Tuple[MetricPlanEntry, ...]:
    """Builds the static metric plan from a CompoundCombiner's children."""
    plan = []
    for child in compound.combiners:
        if isinstance(child, dp_combiners.CountCombiner):
            plan.append(MetricPlanEntry('count', ('count',), 1))
        elif isinstance(child, dp_combiners.PrivacyIdCountCombiner):
            plan.append(
                MetricPlanEntry('privacy_id_count', ('privacy_id_count',), 1))
        elif isinstance(child, dp_combiners.SumCombiner):
            plan.append(MetricPlanEntry('sum', ('sum',), 1))
        elif isinstance(child, dp_combiners.MeanCombiner):
            names = child.metrics_names()
            outputs = ['mean'] + [m for m in ('count', 'sum') if m in names]
            plan.append(MetricPlanEntry('mean', tuple(outputs), 2))
        elif isinstance(child, dp_combiners.VarianceCombiner):
            # True output order = the variance combiner's metric order
            # (variance, then count/sum/mean as requested).
            names = child.metrics_names()
            outputs = ['variance'] + [
                m for m in ('count', 'sum', 'mean') if m in names
            ]
            plan.append(MetricPlanEntry('variance', tuple(outputs), 3))
        elif isinstance(child, dp_combiners.VectorSumCombiner):
            plan.append(MetricPlanEntry('vector_sum', ('vector_sum',), 1))
        elif isinstance(child, dp_combiners.QuantileCombiner):
            plan.append(
                MetricPlanEntry('quantiles', tuple(child.metrics_names()), 1))
        else:
            raise NotImplementedError(
                f"Combiner {type(child).__name__} has no columnar lowering")
    return tuple(plan)


def compute_noise_stds(compound: dp_combiners.CompoundCombiner) -> np.ndarray:
    """Noise stddevs for every plan entry, in plan order. Call after
    BudgetAccountant.compute_budgets()."""
    stds: List[float] = []
    for child in compound.combiners:
        if isinstance(
                child,
            (dp_combiners.CountCombiner, dp_combiners.PrivacyIdCountCombiner,
             dp_combiners.SumCombiner)):
            stds.append(child.get_mechanism().std)
        elif isinstance(child, dp_combiners.MeanCombiner):
            mech = child.get_mechanism()
            stds.append(mech.count_mechanism.std)
            stds.append(mech.sum_mechanism.std)
        elif isinstance(child, dp_combiners.VarianceCombiner):
            stds.extend(child.noise_stds())
        elif isinstance(child, (dp_combiners.VectorSumCombiner,
                                dp_combiners.QuantileCombiner)):
            stds.append(child.noise_std())
        else:
            raise NotImplementedError(type(child))
    return np.asarray(stds, dtype=np.float64)


def compute_noise_sensitivities(compound: dp_combiners.CompoundCombiner,
                                params: AggregateParams) -> np.ndarray:
    """Per-slot norm sensitivities, in the order of compute_noise_stds (l1
    for Laplace slots, l2 for Gaussian): the secure-noise tables widen
    each slot's grid-unit scale by the +1 grid unit snapping adds."""
    sens: List[float] = []
    l0 = params.max_partitions_contributed
    linf = params.max_contributions_per_partition
    for child in compound.combiners:
        if isinstance(
                child,
            (dp_combiners.CountCombiner, dp_combiners.PrivacyIdCountCombiner,
             dp_combiners.SumCombiner)):
            sens.append(child.get_mechanism().sensitivity)
        elif isinstance(child, dp_combiners.MeanCombiner):
            mech = child.get_mechanism()
            sens.append(mech.count_mechanism.sensitivity)
            sens.append(mech.sum_mechanism.sensitivity)
        elif isinstance(child, dp_combiners.VarianceCombiner):
            sens.extend(dp_computations.compute_dp_var_noise_sensitivities(
                l0, linf, params.min_value, params.max_value,
                params.noise_kind))
        elif isinstance(child, dp_combiners.VectorSumCombiner):
            sens.append(dp_computations.vector_noise_sensitivity(
                child._params.additive_vector_noise_params))
        elif isinstance(child, dp_combiners.QuantileCombiner):
            # Per tree level each privacy id touches <= l0 partitions x
            # linf rows, one node per row.
            sens.append(float(l0 * linf) if params.noise_kind ==
                        NoiseKind.LAPLACE else np.sqrt(l0) * linf)
        else:
            raise NotImplementedError(type(child))
    return np.asarray(sens, dtype=np.float64)


def build_secure_tables(stds: np.ndarray, sensitivities: np.ndarray,
                        noise_kind: NoiseKind, snap_grid_bits,
                        device) -> Tuple[torch.Tensor, np.ndarray]:
    """The slots' secure-noise tables on the device: (thr int64[S, 2K+1],
    the packed u64 thresholds, and gran float64[S], each slot's grid),
    with the grid floored at 2**snap_grid_bits where it is set."""
    thr_hi, thr_lo, gran = secure_noise.build_tables(
        stds, noise_kind, sensitivities=sensitivities,
        grid_floor=(None if snap_grid_bits is None else
                    2.0**int(snap_grid_bits)))
    thr = torch.as_tensor(secure_noise.pack_tables(thr_hi, thr_lo))
    return thr.to(device), gran


def make_kernel_config(
        params: AggregateParams, compound: dp_combiners.CompoundCombiner,
        n_partitions: int, private_selection: bool,
        selection_params: Optional[selection_ops.SelectionParams],
        secure: bool = False, numeric_mode: str = "fast") -> KernelConfig:
    """Builds the release config from aggregation parameters."""
    vector = Metrics.VECTOR_SUM in (params.metrics or [])
    max_rows = 1
    if params.contribution_bounds_already_enforced:
        max_rows = (params.max_contributions or
                    params.max_contributions_per_partition or 1)
    degenerate = (params.min_value is not None and
                  params.min_value == params.max_value)
    quantiles: Tuple[float, ...] = ()
    tree_height = branching = quantile_chunk = 0
    qc = next((c for c in compound.combiners
               if isinstance(c, dp_combiners.QuantileCombiner)), None)
    if qc is not None:
        if degenerate:
            raise ValueError("max_value must be > min_value")
        quantiles = tuple(qc._quantiles_to_compute)
        tree_height = qc._tree_height
        branching = qc._branching_factor
        quantile_chunk = max(1, min(n_partitions,
                                    (1 << 25) // branching**tree_height))
    return KernelConfig(
        n_partitions=n_partitions,
        linf=params.max_contributions_per_partition or 0,
        l0=(0 if params.max_contributions else
            (params.max_partitions_contributed or 0)),
        total_bound=params.max_contributions or 0,
        sample_per_partition=compound.expects_per_partition_sampling(),
        clip_per_value=params.bounds_per_contribution_are_set and not vector,
        clip_pair_sum=params.bounds_per_partition_are_set and not vector,
        bounds_enforced=params.contribution_bounds_already_enforced,
        noise_kind=params.noise_kind,
        private_selection=private_selection,
        selection=selection_params,
        max_rows_per_privacy_id=max_rows,
        plan=build_plan(compound),
        degenerate_range=degenerate,
        vector_size=(params.vector_size or 0) if vector else 0,
        vector_max_norm=(params.vector_max_norm or 0.0) if vector else 0.0,
        vector_norm_kind=params.vector_norm_kind if vector else None,
        quantiles=quantiles,
        tree_height=tree_height,
        branching=branching,
        quantile_chunk=quantile_chunk,
        secure=secure,
        numeric_mode=numeric_mode)


def kernel_scalars(params: AggregateParams):
    """Clipping scalars (0.0 placeholders when unused)."""
    min_v = params.min_value if params.min_value is not None else 0.0
    max_v = params.max_value if params.max_value is not None else 0.0
    min_s = (params.min_sum_per_partition
             if params.min_sum_per_partition is not None else 0.0)
    max_s = (params.max_sum_per_partition
             if params.max_sum_per_partition is not None else 0.0)
    mid = (dp_computations.compute_middle(min_v, max_v)
           if params.min_value is not None else 0.0)
    return min_v, max_v, min_s, max_s, mid


def row_bucket(n: int) -> int:
    """Power-of-two row-count bucket (floor 8), as the JAX package pads."""
    return max(8, 1 << max(0, (n - 1).bit_length()))


def pad_rows(encoded: columnar.EncodedData):
    """Row arrays padded to the power-of-two row bucket with invalid rows,
    so a dataset enters the kernels at the JAX package's row count (an
    invalid row changes no output; row i draws counter i either way).

    Tensor columns (the streamed ingest's) pad where they lie; the
    accumulator already pads them to this bucket, so they pass through.
    ShardedColumns (the pod ingest's) keep their global row order, padded
    to the bucket and split evenly over their mesh again, row for row the
    JAX package's padded global array in the layout its meshed release
    stages (executor.py:1627-1650, reshard._pad_and_shard there)."""
    n = encoded.n_rows
    pad = row_bucket(n) - n
    if isinstance(encoded.pid, ShardedColumn):
        return _pad_sharded(encoded, row_bucket(n))
    if pad == 0:
        return encoded.pid, encoded.pk, encoded.values, encoded.valid
    if isinstance(encoded.pid, torch.Tensor):
        values = encoded.values
        return (torch.cat([encoded.pid, encoded.pid.new_zeros(pad)]),
                torch.cat([encoded.pk, encoded.pk.new_full((pad,), -1)]),
                None if values is None else torch.cat([
                    values, values.new_zeros((pad,) + tuple(values.shape[1:]))
                ]), torch.cat([encoded.valid, encoded.valid.new_zeros(pad)]))
    values = (None if encoded.values is None else np.concatenate([
        encoded.values,
        np.zeros((pad,) + encoded.values.shape[1:], np.float64)]))
    return (np.concatenate([encoded.pid, np.zeros(pad, np.int32)]),
            np.concatenate([encoded.pk, np.full(pad, -1, np.int32)]),
            values, np.concatenate([encoded.valid, np.zeros(pad, bool)]))


def _pad_sharded(encoded: columnar.EncodedData, n_padded: int):
    """pad_rows of ShardedColumns: n_padded global rows, split evenly over
    the mesh at rows_per_shard(n_padded, D) a shard (the pads of the even
    split past n_padded)."""
    mesh = encoded.pid.mesh
    per = rows_per_shard(n_padded, mesh.size)

    def split(col, fill):
        return None if col is None else resplit(col, mesh, per, fill,
                                                n_padded)

    return (split(encoded.pid, 0), split(encoded.pk, -1),
            split(encoded.values, 0), split(encoded.valid, False))


def reduce_column_names(cfg: KernelConfig) -> List[str]:
    """The row columns bounded_row_columns emits for this config (none
    for vector sums: C3 gathers their coordinates itself)."""
    if cfg.vector_size:
        return []
    names = []
    if any(e.kind == 'sum' for e in cfg.plan):
        names.append('sum')
    if any(e.kind in ('mean', 'variance') for e in cfg.plan):
        names.append('nsum')
    if any(e.kind == 'variance' for e in cfg.plan):
        names.append('nsum2')
    return names


def sort_rows(k1: torch.Tensor, k2: torch.Tensor, u: torch.Tensor):
    """Permutation sorting rows by (k1, k2, u), stable (C5; the JAX
    package's lax.sort over 5 keys), and k1 in that order (C5's
    sorted_top, which C2 reads in place of a gather)."""
    return kernels.radix_sort([k1, k2, u], sorted_top=True)


def bound_total_contributions(pid: torch.Tensor, pk: torch.Tensor,
                              values: torch.Tensor, valid: torch.Tensor,
                              key_total, total_bound: int,
                              n_partitions: int):
    """The total contribution bound (max_contributions): a uniform subset
    of at most total_bound rows of each pid, ranked by one stable sort over
    (pid, uniform(key_total)). Returns (pid, pk, values, valid) in that
    order with the dropped rows invalid; the bounding sort's row uniforms
    are drawn by position in this order, as in the JAX package."""
    pid_sent, u0 = kernels.total_bound_keys(pid, valid, key_total,
                                            values.dtype)
    perm0, spid0 = kernels.radix_sort([pid_sent, u0], sorted_top=True)
    return kernels.total_bound_rows(perm0, spid0, pk, values, valid,
                                    total_bound=total_bound,
                                    n_partitions=n_partitions)


def bounded_row_columns(pid: torch.Tensor, pk: torch.Tensor,
                        values: torch.Tensor, valid: torch.Tensor, min_v,
                        max_v, min_s, max_s, mid, rows_key,
                        cfg: KernelConfig):
    """Phase 1a: contribution bounding -> per-row reduction columns.

    Returns (key2, pair_start, reduce_cols, rows) in the bounding-sort order
    of the JAX package's bounded_row_columns: key2 is the row's partition
    where it is kept (keep_row = key2 < n_partitions) and n_partitions
    elsewhere. rows = (row_perm, values): the value of bounded row r is
    values[row_perm[r]] (values[r] when row_perm is None), unclipped; the
    vector sums and the quantile trees read it through this permutation.
    """
    P = cfg.n_partitions
    key_total, key_linf, salts = row_key_schedule(rows_key)
    scalars = (min_v, max_v, min_s, max_s, mid)
    columns = reduce_column_names(cfg)
    # Vector rows reach no C2 column: C2 reads values only for columns.
    row_values = None if cfg.vector_size else values
    common = dict(n_partitions=P, l0=cfg.l0,
                  clip_per_value=cfg.clip_per_value,
                  clip_pair_sum=cfg.clip_pair_sum, scalars=scalars,
                  columns=columns)
    if cfg.bounds_enforced:
        # Each row is its own contribution group: no bounding sort.
        key2, pair_start, cols = kernels.bound_rows(
            None, None, None, pk, row_values, valid, linf=0, **common)
        return key2, pair_start, cols, (None, values)
    if cfg.total_bound:
        pid, pk, values, valid = bound_total_contributions(
            pid, pk, values, valid, key_total, cfg.total_bound, P)
        row_values = values
    k1, k2, u = kernels.row_keys(pid, pk, valid, salts, key_linf, P,
                                 values.dtype)
    perm, sorted_k1 = sort_rows(k1, k2, u)
    linf = cfg.linf if cfg.sample_per_partition else 0
    key2, pair_start, cols = kernels.bound_rows(perm, k1, k2, pk, row_values,
                                                valid, linf=linf,
                                                sorted_k1=sorted_k1, **common)
    return key2, pair_start, cols, (perm, values)


def reduce_rows_to_partitions(key2: torch.Tensor, pair_start: torch.Tensor,
                              reduce_cols: Dict[str, torch.Tensor],
                              n_partitions: int, dtype: torch.dtype,
                              vector_rows=None, numeric_mode: str = "fast"):
    """Phase 1b: dense [0, n_partitions) partition columns from the bounded
    row stream (one stable sort by kept partition, then C3; vector_rows =
    bounded_row_columns' rows for VECTOR_SUM; numeric_mode "safe" takes
    C3's compensated entry). Returns (cols, (perm, skey2)): the columns and
    the partition-sorted row order."""
    perm, skey2 = kernels.radix_sort([key2], sorted_top=True)
    cols = kernels.reduce_partitions(skey2, perm, pair_start, reduce_cols,
                                     n_partitions, dtype, vector_rows,
                                     compensated=numeric_mode == "safe")
    cols['row_count'] = cols['pid_count']
    return cols, (perm, skey2)


def slot_keys(key_noise, plan: Sequence[MetricPlanEntry]) -> np.ndarray:
    """The threefry key of every noise slot: slot offset+j of plan entry i
    draws under fold_in(fold_in(key_noise, i), j), as finalize does."""
    keys = []
    for i, entry in enumerate(plan):
        ekey = threefry.fold_in(key_noise, i)
        keys.extend(threefry.fold_in(ekey, j) for j in range(entry.n_stds))
    return np.asarray(keys, dtype=np.uint32).reshape(-1, 2)


# The dense release's key schedule (the JAX package's _aggregate_trace and
# _select_partitions_trace). The solo and the lane-batched releases both
# derive their keys here: a lane equals its solo run bit for bit only while
# they do.


def release_key_halves(rng_key):
    """(rows_key, final_key): the bounding phase's and the release's."""
    return threefry.split(rng_key, 2)


def row_salts(key_l0) -> np.ndarray:
    """C1's four salt words under the L0 key."""
    return threefry.bits(key_l0, 4)


def row_key_schedule(rows_key):
    """(key_total, key_linf, salts) of the bounding phase."""
    key_total, key_linf, key_l0 = threefry.split(rows_key, 3)
    return key_total, key_linf, row_salts(key_l0)


def noise_key_schedule(final_key, plan: Sequence[MetricPlanEntry]):
    """(key_sel, slot keys [S, 2]) of the release."""
    key_sel, key_noise = threefry.split(final_key, 2)
    return key_sel, slot_keys(key_noise, plan)


def select_key_schedule(rng_key):
    """(key_l0, key_sel) of standalone selection."""
    return threefry.split(rng_key, 2)


def _lane_keys(rng_keys) -> np.ndarray:
    return np.asarray(rng_keys, dtype=np.uint32).reshape(-1, 2)


def lane_release_keys(rng_keys, plan: Sequence[MetricPlanEntry],
                      shard: Optional[int] = None):
    """Each lane's dense release keys, stacked: (salts [L, 4], key_linf
    [L, 2], key_sel [L, 2], slot keys [L, S, 2]), as aggregate_release_kernel
    derives them from the lane's base key. shard (the mesh): the bounding
    keys are shard s's, under fold_in(rows_key, s); the release keys are
    every shard's."""
    salts, keys_linf, keys_sel, slots = [], [], [], []
    for key in _lane_keys(rng_keys):
        rows_key, final_key = release_key_halves(key)
        if shard is not None:
            rows_key = threefry.fold_in(rows_key, shard)
        _, key_linf, lane_salts = row_key_schedule(rows_key)
        key_sel, lane_slots = noise_key_schedule(final_key, plan)
        salts.append(lane_salts)
        keys_linf.append(key_linf)
        keys_sel.append(key_sel)
        slots.append(lane_slots)
    return (np.stack(salts), np.stack(keys_linf), np.stack(keys_sel),
            np.stack(slots))


def lane_total_keys(rng_keys, shard: Optional[int] = None) -> np.ndarray:
    """Each lane's key_total (the total bound's key), stacked [L, 2]; shard
    (the mesh): shard s's, under fold_in(rows_key, s)."""
    keys = []
    for key in _lane_keys(rng_keys):
        rows_key, _ = release_key_halves(key)
        if shard is not None:
            rows_key = threefry.fold_in(rows_key, shard)
        keys.append(row_key_schedule(rows_key)[0])
    return np.stack(keys)


def quantile_key(rng_key):
    """The percentiles' key, fold_in(rng_key, 7919): every shard's."""
    return threefry.fold_in(rng_key, 7919)


def lane_select_keys(rng_keys, shard: Optional[int] = None):
    """Each lane's standalone-selection keys, stacked: (salts [L, 4],
    key_sel [L, 2]), as select_partitions_release_kernel derives them.
    shard (the mesh): the salts are shard s's, under fold_in(key_l0, s)."""
    pairs = [select_key_schedule(key) for key in _lane_keys(rng_keys)]
    return (np.stack([row_salts(key_l0 if shard is None else
                                threefry.fold_in(key_l0, shard))
                      for key_l0, _ in pairs]),
            np.stack([key_sel for _, key_sel in pairs]))


def epilogue_plan(plan: Sequence[MetricPlanEntry]):
    """C4's plan: (kind, outputs, offset of its first noise slot) per
    entry."""
    out = []
    offset = 0
    for entry in plan:
        out.append((entry.kind, entry.outputs, offset))
        offset += entry.n_stds
    return out


def _require_tables(cfg: KernelConfig, secure_tables) -> None:
    if cfg.secure and secure_tables is None:
        raise ValueError("cfg.secure requires secure_tables "
                         "(executor.build_secure_tables)")


def finalize(cols: Dict[str, torch.Tensor], min_v, mid, stds: np.ndarray,
             final_key, cfg: KernelConfig, secure_tables=None):
    """Phase 2: DP partition selection + noise + metric formulas + the
    sentinel flag word (C4; a vector_sum entry's release is C9's, after
    C4, ORing its bits into the same word). secure_tables: (thr, gran) of
    build_secure_tables, required when cfg.secure. Returns (outputs, keep,
    flags)."""
    _require_tables(cfg, secure_tables)
    tables = secure_tables if cfg.secure else None
    key_sel, keys = noise_key_schedule(final_key, cfg.plan)
    plan = epilogue_plan(cfg.plan)
    keep, outputs, flags = kernels.release_epilogue(
        cols, plan, stds, keys, cfg.noise_kind, cfg.degenerate_range, mid,
        min_v, cfg.selection if cfg.private_selection else None, key_sel,
        cfg.max_rows_per_privacy_id, tables)
    for kind, _, off in plan:
        if kind == 'vector_sum':
            outputs['vector_sum'] = kernels.vector_release(
                cols['vsum'], keep, flags, max_norm=cfg.vector_max_norm,
                norm_kind=cfg.vector_norm_kind.value, std=stds[off],
                key=keys[off],
                gaussian=cfg.noise_kind == NoiseKind.GAUSSIAN,
                tables=_slot_table(tables, off))
    return outputs, keep, flags


def _slot_table(tables, slot: int):
    """One slot's (thr row, grid) of the secure tables (None stays None)."""
    return None if tables is None else (tables[0][slot],
                                        float(tables[1][slot]))


def quantile_std_index(plan: Sequence[MetricPlanEntry]) -> int:
    """Index of the quantile entry's noise std within the stds array."""
    offset = 0
    for entry in plan:
        if entry.kind == 'quantiles':
            return offset
        offset += entry.n_stds
    raise ValueError("plan has no quantiles entry")


def dense_quantiles(cfg: KernelConfig) -> bool:
    """One leaf-histogram chunk covers every partition (P <=
    quantile_chunk): the dense regime, else the lazy descent. The lanes of
    a batched release take their solo run's regime, chosen by P."""
    return -(-cfg.n_partitions // max(cfg.quantile_chunk, 1)) <= 1


def _dense_level_keys(qkey, tree_height: int) -> np.ndarray:
    """The dense regime's level keys: fold_in(fold_in(qkey, 0), l)."""
    ckey = threefry.fold_in(qkey, 0)
    return np.stack([threefry.fold_in(ckey, l) for l in range(tree_height)])


def quantile_outputs(sorted_rows, values_rows, min_v, max_v,
                     stds: np.ndarray, qkey, keep: torch.Tensor,
                     flags: torch.Tensor, cfg: KernelConfig,
                     dtype: torch.dtype, secure_tables=None,
                     base: Optional[int] = None,
                     combine=None,
                     n_lanes: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Per-partition DP percentiles (the JAX package's quantile_outputs,
    :825): sorted_rows = (perm, skey2), the partition-sorted order of the
    bounded rows; values_rows = (row_perm, values) from
    bounded_row_columns (partial_columns' qrows are the pair). Flag bits
    of the kept partitions' percentiles are ORed into flags.

    With one leaf-histogram chunk covering every partition (P <=
    quantile_chunk), C7 builds the whole tree's counts and C8 descends
    every level in one launch, noising node j of level l at counter
    p * B^l + j under fold_in(fold_in(qkey, 0), l - 1). Above that, each
    level's child counts (C7) and one descent step (C8) alternate: h
    passes over the rows for every quantile together, the first gathering
    each row's leaf into a buffer the other h - 1 read. With cfg.secure the
    nodes take the quantile slot's secure table (secure_tables).

    combine (the mesh): sorted_rows and values_rows are sequences, one
    entry a shard, and combine(parts) sums the shards' int32 counts onto
    keep's device (C21,
    the JAX package's psums at :807 and :875): the leaf histogram before
    the level roll-ups, each level's child counts before its descent
    step. The descent itself runs once, on keep's device.

    base (a block of the blocked route): sorted_rows is the block's window
    of the sorted stream, its partitions rebased by base (C7's windowed
    entries); perm may be None there (the host-staged stream).

    n_lanes (the lane-batched release): the rows are L lanes' with key2 =
    lane * P + partition, qkey is the lanes' [L, 2] stack, C7 counts the L
    * P partitions as one range and C8's lane entries descend each lane
    under its own keys, in its solo run's regime; keep, flags and the
    outputs are the lanes' ([L * P], [L]).
    """
    _require_tables(cfg, secure_tables)
    shards = (list(zip(sorted_rows, values_rows)) if combine is not None
              else [(sorted_rows, values_rows)])
    total = combine if combine is not None else (lambda parts: parts[0])
    P, h, B = cfg.n_partitions, cfg.tree_height, cfg.branching
    rows_p = P * (n_lanes or 1)  # the partitions the counts span
    lane_qkeys = None if n_lanes is None else _lane_keys(qkey)
    qidx = quantile_std_index(cfg.plan)
    gaussian = cfg.noise_kind == NoiseKind.GAUSSIAN
    tree = dict(tree_height=h, branching=B, min_v=min_v, max_v=max_v)
    descent = dict(std=float(stds[qidx]), gaussian=gaussian, min_v=min_v,
                   max_v=max_v, keep=keep, flags=flags,
                   tables=_slot_table(secure_tables if cfg.secure else None,
                                      qidx))
    if n_lanes is not None:
        descent["n_lanes"] = n_lanes

    def counted(count, per_shard=None):
        """count(skey2, perm, row_perm, values[, per_shard[s]]) of every
        shard s, each under its own device, summed by total."""
        parts = []
        for s, ((perm, skey2), (row_perm, values)) in enumerate(shards):
            extra = () if per_shard is None else (per_shard[s],)
            with on_device(skey2.device):
                parts.append(count(skey2, perm, row_perm, values, *extra))
        return total(parts)

    if dense_quantiles(cfg):
        leaf_counts = counted(
            lambda skey2, perm, row_perm, values:
            kernels.quantile_leaf_counts(
                skey2, perm, row_perm, values, n_partitions=rows_p,
                n_leaves=B**h, min_v=min_v, max_v=max_v, base=base))
        levels = kernels.quantile_level_counts(leaf_counts, tree_height=h,
                                               branching=B)
        if n_lanes is None:
            per_quantile = kernels.quantile_descend_dense(
                levels, cfg.quantiles, level_keys=_dense_level_keys(qkey, h),
                dtype=dtype, **descent)
        else:
            per_quantile = kernels.quantile_descend_dense_lanes(
                levels, cfg.quantiles, level_keys=np.stack(
                    [_dense_level_keys(k, h) for k in lane_qkeys]),
                dtype=dtype, **descent)
    else:
        state = kernels.DescentState(rows_p, len(cfg.quantiles), dtype,
                                     keep.device)
        # Each shard's sorted rows get their leaf once (the level-1 pass
        # fills the buffer, levels 2..h read it), as the JAX package's
        # row_leaf (:403-405) serves every level (:800).
        leaves = [torch.empty(skey2.shape[0], dtype=torch.int32,
                              device=skey2.device)
                  for (_, skey2), _ in shards]
        for level in range(1, h + 1):
            counts = counted(
                lambda skey2, perm, row_perm, values, leaf, level=level:
                kernels.quantile_child_counts(
                    skey2, perm, row_perm, values,
                    state.node.to(skey2.device), level=level, base=base,
                    leaf=leaf, **tree), leaves)
            if n_lanes is None:
                per_quantile = kernels.quantile_descend_step(
                    counts, state, cfg.quantiles, level=level, tree_height=h,
                    level_key=threefry.fold_in(qkey, level), **descent)
            else:
                per_quantile = kernels.quantile_descend_step_lanes(
                    counts, state, cfg.quantiles, level=level, tree_height=h,
                    level_keys=np.stack([threefry.fold_in(k, level)
                                         for k in lane_qkeys]), **descent)
    names = next(e.outputs for e in cfg.plan if e.kind == 'quantiles')
    return {name: per_quantile[j] for j, name in enumerate(names)}


def compact_release(outputs: Dict[str, torch.Tensor], keep: torch.Tensor):
    """Kept-first compaction (C6): kept partitions first in ascending id
    order (exactly nonzero(keep)). Returns (n_kept, order int64[P],
    outputs in that order)."""
    return kernels.compact_kept(keep, outputs)


def partial_columns(pid, pk, values, valid, min_v, max_v, min_s, max_s,
                    mid, rows_key, cfg: KernelConfig):
    """Phase 1 of the dense release (the JAX package's partial_columns,
    :517): contribution bounding and the dense partition columns of these
    rows. On the mesh it runs once a shard, under the shard's rows key.
    Returns (cols, qrows): the columns (reduce_rows_to_partitions') and
    qrows = (sorted_rows, values_rows), the row streams quantile_outputs
    reads."""
    key2, pair_start, reduce_cols, rows = bounded_row_columns(
        pid, pk, values, valid, min_v, max_v, min_s, max_s, mid, rows_key,
        cfg)
    cols, sorted_rows = reduce_rows_to_partitions(
        key2, pair_start, reduce_cols, cfg.n_partitions, values.dtype,
        rows if cfg.vector_size else None, cfg.numeric_mode)
    return cols, (sorted_rows, rows)


def release_dense(cols, qrows, min_v, max_v, mid, stds: np.ndarray,
                  rng_key, cfg: KernelConfig, dtype: torch.dtype,
                  secure_tables=None, combine=None):
    """Phase 2 of the dense release from the (combined) partition columns,
    without compaction: selection, noise, percentiles under the
    replicated half of rng_key's split (finalize) and fold_in(rng_key,
    7919) (the percentiles). qrows: partial_columns' (on the mesh a list,
    one a shard, and combine the cross-shard sum of their quantile
    counts). Returns (outputs [P], keep bool[P], flags): the JAX package's
    unfused (outputs, keep) and the sentinel word over the kept
    partitions."""
    _, final_key = release_key_halves(rng_key)
    outputs, keep, flags = finalize(cols, min_v, mid, stds, final_key, cfg,
                                    secure_tables)
    if cfg.quantiles:
        sorted_rows, values_rows = (zip(*qrows) if combine is not None
                                    else qrows)
        outputs.update(quantile_outputs(
            sorted_rows, values_rows, min_v, max_v, stds,
            quantile_key(rng_key), keep, flags, cfg, dtype,
            secure_tables, combine=combine))
    return outputs, keep, flags


def release_columns(cols, qrows, min_v, max_v, mid, stds: np.ndarray,
                    rng_key, cfg: KernelConfig, dtype: torch.dtype,
                    secure_tables=None, combine=None):
    """release_dense, then kept-first compaction (C6). Returns (n_kept,
    order, outputs kept-first, flags)."""
    outputs, keep, flags = release_dense(cols, qrows, min_v, max_v, mid,
                                         stds, rng_key, cfg, dtype,
                                         secure_tables, combine)
    n_kept, order, outputs_sorted = compact_release(outputs, keep)
    return n_kept, order, outputs_sorted, flags


def aggregate_release_kernel(pid, pk, values, valid, min_v, max_v, min_s,
                             max_s, mid, stds: np.ndarray, rng_key,
                             cfg: KernelConfig, secure_tables=None):
    """The dense release: bounding, partition columns, selection, noise,
    percentiles, compaction. Key derivation follows the JAX package's
    _aggregate_trace. Returns (n_kept, order, outputs kept-first, flags)."""
    rows_key, _ = release_key_halves(rng_key)
    cols, qrows = partial_columns(pid, pk, values, valid, min_v, max_v,
                                  min_s, max_s, mid, rows_key, cfg)
    return release_columns(cols, qrows, min_v, max_v, mid, stds, rng_key,
                           cfg, values.dtype, secure_tables)


def aggregate_kernel(pid, pk, values, valid, min_v, max_v, min_s, max_s,
                     mid, stds: np.ndarray, rng_key, cfg: KernelConfig,
                     secure_tables=None):
    """The unfused dense release (the JAX package's aggregate_kernel,
    :928): aggregate_release_kernel without the compaction (C1-C5, C4 and
    the percentile and vector kernels; no C6). Returns (outputs [P], keep
    bool[P], flags), decoded by decode_results."""
    rows_key, _ = release_key_halves(rng_key)
    cols, qrows = partial_columns(pid, pk, values, valid, min_v, max_v,
                                  min_s, max_s, mid, rows_key, cfg)
    return release_dense(cols, qrows, min_v, max_v, mid, stds, rng_key,
                         cfg, values.dtype, secure_tables)


def batched_lane_capacity(cfg: KernelConfig, lane_rows: int) -> int:
    """The most lanes of lane_rows rows one batched release of cfg takes
    (kernels.lane_capacity): a lane's largest partition table is the dense
    quantile regime's P x B^h leaf histogram or VECTOR_SUM's P x V sums."""
    P = cfg.n_partitions
    cells = 0
    if cfg.quantiles and dense_quantiles(cfg):
        cells = P * cfg.branching**cfg.tree_height
    if cfg.vector_size:
        cells = max(cells, P * cfg.vector_size)
    return kernels.lane_capacity(lane_rows, P, cells)


def _check_lanes(cfg: KernelConfig, n_lanes: int, lane_rows: int) -> None:
    cap = batched_lane_capacity(cfg, lane_rows)
    if n_lanes > cap:
        raise ValueError(f"batched release: {n_lanes} lanes of {lane_rows} "
                         f"rows exceed this spec's {cap} (int32 keys and "
                         f"tables, grid)")


def batched_aggregate_release_kernel(pid, pk, values, valid, min_v, max_v,
                                     min_s, max_s, mid, stds: np.ndarray,
                                     rng_keys, cfg: KernelConfig,
                                     secure_tables=None):
    """The dense release of L jobs in one launch a stage (the JAX package's
    batched_aggregate_release_kernel, :984, a vmap over job lanes).

    pid / pk / valid: [L, n] and values [L, n] ([L, n, V] for VECTOR_SUM)
    on one device, each lane its job's rows padded to the same n; rng_keys:
    [L, 2], each lane's own base key; scalars, stds, cfg and secure_tables
    (build_secure_tables', required when cfg.secure) are shared. The L * n
    rows run as one stream: C1's lane entry keys them under each lane's
    keys (after the total bound's lane entries of C1, C5 and C2 for
    max_contributions; none for pre-bounded rows), C5 sorts by (lane, k1,
    k2, u), C2 bounds them with runs broken at lane starts and writes key2
    = lane * P + partition, C5 sorts by key2, C3 sums each lane's
    partitions from the lane's own first row (compensated in safe mode,
    the vectors too), C4 releases L * P partitions under each lane's slot
    keys, C9 each lane's vector sums, C7 and C8 each lane's percentiles
    under fold_in(key_l, 7919), and C6 compacts each lane. Returns (n_kept
    int64[L], order int64[L, P], {output: F[L, P] or F[L, P, V]}
    kept-first, flags int32[L]); lane l equals aggregate_release_kernel on
    its rows and key alone, bit for bit.
    """
    _require_tables(cfg, secure_tables)
    n_lanes, lane_rows = pid.shape[0], pid.shape[1]
    _check_lanes(cfg, n_lanes, lane_rows)
    cols, qrows = batched_partial_columns(pid, pk, values, valid, min_v,
                                          max_v, min_s, max_s, mid,
                                          rng_keys, cfg)
    return batched_release_columns(cols, qrows, min_v, max_v, mid, stds,
                                   rng_keys, cfg, n_lanes, values.dtype,
                                   secure_tables)


def bound_total_contributions_lanes(pid, pk, values, valid, keys_total,
                                    total_bound: int, n_partitions: int,
                                    lane_rows: int):
    """bound_total_contributions a lane: C1's total-bound lane entry, one
    sort by (lane << 32 | pid_sent, u0), C2's total-bound lane entry. Lane
    l's rows stay in its block of lane_rows, in its solo order, so the
    bounding sort's uniforms draw at its solo counters."""
    lane_pid, u0 = kernels.total_bound_keys_lanes(pid, valid, lane_rows,
                                                  keys_total, values.dtype)
    perm0, slane_pid = kernels.radix_sort([lane_pid, u0], sorted_top=True)
    return kernels.total_bound_rows_lanes(
        perm0, slane_pid, pk, values, valid, lane_rows=lane_rows,
        total_bound=total_bound, n_partitions=n_partitions)


def batched_partial_columns(pid, pk, values, valid, min_v, max_v, min_s,
                            max_s, mid, rng_keys, cfg: KernelConfig,
                            shard: Optional[int] = None):
    """Phase 1 of the lane-batched release: the lane entries of C1-C3 over
    the [L, n] rows under each lane's bounding keys (shard s's on the mesh,
    lane_release_keys(..., shard=s)), as bounded_row_columns and
    reduce_rows_to_partitions run one job. Returns (cols, qrows): the
    lanes' dense columns, {name: dtype[L * P]} (vsum [L * P, V]), partition
    p of lane l at l * P + p, and qrows = ((perm2, skey2), (row_perm,
    values)) over the L * n rows, what quantile_outputs reads."""
    n_lanes, lane_rows = pid.shape[0], pid.shape[1]
    n = n_lanes * lane_rows
    P = cfg.n_partitions
    dtype = values.dtype
    pid, pk, valid = pid.reshape(n), pk.reshape(n), valid.reshape(n)
    values = values.reshape((n,) + tuple(values.shape[2:]))
    salts, keys_linf, _, _ = lane_release_keys(rng_keys, cfg.plan, shard)
    # Vector rows reach no C2 column: C2 reads values only for columns.
    row_values = None if cfg.vector_size else values
    common = dict(lane_rows=lane_rows, n_partitions=P, l0=cfg.l0,
                  clip_per_value=cfg.clip_per_value,
                  clip_pair_sum=cfg.clip_pair_sum,
                  scalars=(min_v, max_v, min_s, max_s, mid),
                  columns=reduce_column_names(cfg))
    if cfg.bounds_enforced:
        # Each row is its own contribution group: no bounding sort.
        key2, pair_start, row_cols = kernels.bound_rows_lanes(
            None, None, None, row_values, valid, linf=0, pk=pk, **common)
        rows = (None, values)
    else:
        if cfg.total_bound:
            pid, pk, values, valid = bound_total_contributions_lanes(
                pid, pk, values, valid, lane_total_keys(rng_keys, shard),
                cfg.total_bound, P, lane_rows)
            row_values = values
        lane, k1, k2, u = kernels.row_keys_lanes(pid, pk, valid, lane_rows,
                                                 salts, keys_linf, P, dtype)
        perm = kernels.radix_sort([lane, k1, k2, u])
        key2, pair_start, row_cols = kernels.bound_rows_lanes(
            perm, k1, k2, row_values, valid,
            linf=cfg.linf if cfg.sample_per_partition else 0, **common)
        rows = (perm, values)
    perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
    cols = kernels.reduce_partitions_lanes(
        skey2, perm2, pair_start, row_cols, lane_rows, P, dtype,
        rows if cfg.vector_size else None,
        compensated=cfg.numeric_mode == "safe")
    return cols, ((perm2, skey2), rows)


def batched_release_columns(cols, qrows, min_v, max_v, mid,
                            stds: np.ndarray, rng_keys, cfg: KernelConfig,
                            n_lanes: int, dtype: torch.dtype,
                            secure_tables=None, combine=None):
    """Phase 2 of the lane-batched release from the lanes' (combined)
    columns, as release_columns runs one job: C4's lane entry under each
    lane's key_sel and slot keys, C9's for VECTOR_SUM, C7 and C8's for
    PERCENTILE (qrows: batched_partial_columns', a list a shard with
    combine on the mesh), C6's. Returns (n_kept int64[L], order int64[L,
    P], {output: F[L, P] or F[L, P, V]} kept-first, flags int32[L])."""
    _require_tables(cfg, secure_tables)
    tables = secure_tables if cfg.secure else None
    _, _, key_sel, slots = lane_release_keys(rng_keys, cfg.plan)
    plan = epilogue_plan(cfg.plan)
    keep, outputs, flags = kernels.release_epilogue_lanes(
        cols, plan, stds, slots, cfg.noise_kind, cfg.degenerate_range, mid,
        min_v, cfg.selection if cfg.private_selection else None, key_sel,
        cfg.max_rows_per_privacy_id, n_lanes, tables)
    for kind, _, off in plan:
        if kind == 'vector_sum':
            outputs['vector_sum'] = kernels.vector_release_lanes(
                cols['vsum'], keep, flags, max_norm=cfg.vector_max_norm,
                norm_kind=cfg.vector_norm_kind.value, std=stds[off],
                keys=slots[:, off],
                gaussian=cfg.noise_kind == NoiseKind.GAUSSIAN,
                n_lanes=n_lanes, tables=_slot_table(tables, off))
    if cfg.quantiles:
        sorted_rows, values_rows = (zip(*qrows) if combine is not None
                                    else qrows)
        outputs.update(quantile_outputs(
            sorted_rows, values_rows, min_v, max_v, stds,
            np.stack([quantile_key(k) for k in _lane_keys(rng_keys)]), keep,
            flags, cfg, dtype, secure_tables, combine=combine,
            n_lanes=n_lanes))
    n_kept, order, outputs = kernels.compact_kept_lanes(keep, outputs,
                                                        n_lanes)
    return n_kept, order, outputs, flags


@dataclass
class ReleaseLaunch:
    """One job's dense release, offered to the thread's launch interceptor
    (the service's coalescer) before it runs solo.

    Carries what the solo release gets: the host rows (pad_rows-padded,
    but for a meshed selection's, which the meshed dispatcher stages
    unpadded as the solo meshed selection does), the job's own base key,
    and for kind "aggregate" the clipping scalars, noise stds and cfg, for
    kind "select" (l0, n_partitions, selection); device, dtype, mesh and
    reshard are the job's backend's; secure_tables the job's
    build_secure_tables (kind "aggregate" with cfg.secure) and tables_key
    what they are built from beside stds and cfg.noise_kind (the slots'
    sensitivities and snap_grid_bits, on the host). Lanes keep their solo
    keys, which is what makes a batched lane's release its solo run's."""
    kind: str  # "aggregate" | "select"
    pid: Any
    pk: Any
    valid: Any
    key: Any
    device: Any
    dtype: Any
    mesh: Any = None
    reshard: str = "auto"
    staged: Any = None  # a meshed lane's host-staged rows (batching)
    values: Any = None
    scalars: Optional[Tuple[float, ...]] = None
    stds: Any = None
    cfg: Optional[KernelConfig] = None
    l0: int = 0
    n_partitions: int = 0
    selection: Any = None
    secure_tables: Any = None
    tables_key: Any = None


# Per-thread launch interceptor: the service's coalescer is installed
# around a job's execution; the dense release sites offer their
# ReleaseLaunch to it. It returns the lane's result (the job ran as one
# lane of a lane-batched release), None (run solo), or raises (the
# batched release failed: the job fails with it).
_LAUNCH_INTERCEPTOR = threading.local()


def _active_launch_interceptor():
    return getattr(_LAUNCH_INTERCEPTOR, "fn", None)


@contextlib.contextmanager
def launch_interceptor(fn):
    """Installs `fn` as this thread's release-launch interceptor for the
    scope; the previous one is restored on exit."""
    prev = getattr(_LAUNCH_INTERCEPTOR, "fn", None)
    _LAUNCH_INTERCEPTOR.fn = fn
    try:
        yield
    finally:
        _LAUNCH_INTERCEPTOR.fn = prev


def _offerable(interceptor, pid, backend) -> bool:
    """A release may join a batch when an interceptor is active, the fused
    release is on (the unfused one stays the solo comparison baseline),
    its rows are host numpy (a streamed input's device columns and the
    pod ingest's ShardedColumns run solo) and a meshed backend is not
    forced onto the device exchange (the meshed dispatcher stages lanes
    through the host LPT permutation, as a solo host-row run does)."""
    return (interceptor is not None and backend.fused_release and
            isinstance(pid, np.ndarray) and
            (backend.mesh is None or backend.reshard != "device"))


def to_device(encoded: columnar.EncodedData, device: torch.device,
              dtype: torch.dtype):
    """pad_rows + one host-to-device copy per host column (values None when
    the encoding has none); columns already on `device` stay there."""
    return padded_to_device(*pad_rows(encoded), device, dtype)


def padded_to_device(pid, pk, values, valid, device: torch.device,
                     dtype: torch.dtype):
    """One host-to-device copy per padded host column (pad_rows'). A
    ShardedColumn runs on its global row order on `device`, as an
    unmeshed TPUBackend runs a mesh-sharded global array."""
    if isinstance(pid, ShardedColumn):
        pid, pk, values, valid = (None if c is None else c.global_rows(device)
                                  for c in (pid, pk, values, valid))
    return (torch.as_tensor(pid, dtype=torch.int32).to(device),
            torch.as_tensor(pk, dtype=torch.int32).to(device),
            None if values is None else
            torch.as_tensor(values).to(device=device, dtype=dtype),
            torch.as_tensor(valid).to(device))


def lazy_aggregate(backend, col, params: AggregateParams, data_extractors,
                   public_partitions, budget_accountant, report_generator):
    """Graph-time setup + lazily executed dense release.

    Budgets are requested NOW (graph time); the kernels run when the
    returned generator is first iterated — after compute_budgets().
    """
    compound = dp_combiners.create_compound_combiner(params,
                                                     budget_accountant)
    private = public_partitions is None
    selection_budget = None
    if private:
        with rt_observability.mechanism_label("partition_selection"):
            selection_budget = budget_accountant.request_budget(
                mechanism_type=MechanismType.GENERIC)

    if not private:
        report_generator.add_stage(
            "Public partition selection: dropped non public partitions")
    if not params.contribution_bounds_already_enforced:
        if params.max_contributions:
            report_generator.add_stage(
                f"User contribution bounding: randomly selected not "
                f"more than {params.max_contributions} contributions")
        else:
            if compound.expects_per_partition_sampling():
                report_generator.add_stage(
                    f"Per-partition contribution bounding: for each "
                    f"privacy_id and each partition, randomly select "
                    f"max(actual_contributions_per_partition, "
                    f"{params.max_contributions_per_partition}) "
                    f"contributions.")
            report_generator.add_stage(
                f"Cross-partition contribution bounding: for each privacy_id "
                f"randomly select max(actual_partition_contributed, "
                f"{params.max_partitions_contributed}) partitions")
    if private:
        strategy = params.partition_selection_strategy
        pre_threshold_str = (f", pre_threshold={params.pre_threshold}"
                             if params.pre_threshold else "")
        report_generator.add_stage(
            lambda: f"Private Partition selection: using {strategy.value} "
            f"method with (eps={selection_budget.eps}, "
            f"delta={selection_budget.delta}{pre_threshold_str})")
    for stage in compound.explain_computation():
        report_generator.add_stage(stage)

    public_list = (list(public_partitions)
                   if public_partitions is not None else None)

    def generator():
        encoded = _encode_input(backend, col, data_extractors, public_list)
        if Metrics.VECTOR_SUM in (params.metrics or []):
            expected = (params.vector_size,)
            got = encoded.values.shape[1:]
            if got != expected:
                raise TypeError(f"Shape mismatch: {got} != {expected}")
        selection_params = None
        if private:
            selection_params = selection_ops.selection_params_from_host(
                params.partition_selection_strategy, selection_budget.eps,
                selection_budget.delta, params.max_partitions_contributed,
                params.pre_threshold)
        n_partitions = resolve_n_partitions(backend, encoded.n_partitions)
        cfg = make_kernel_config(params, compound, n_partitions, private,
                                 selection_params,
                                 secure=backend.secure_noise,
                                 numeric_mode=backend.numeric_mode)
        stds = compute_noise_stds(compound)
        secure_tables = tables_key = None
        if cfg.secure:
            sens = compute_noise_sensitivities(compound, params)
            # On a mesh the release runs on its first device.
            secure_tables = build_secure_tables(
                stds, sens, params.noise_kind, backend.snap_grid_bits,
                backend.device if backend.mesh is None else
                backend.mesh.device)
            tables_key = (sens.tobytes(), backend.snap_grid_bits)
        key = noise_ops.make_noise_key(backend.noise_seed)
        min_v, max_v, min_s, max_s, mid = kernel_scalars(params)
        if _blocked(backend, n_partitions):
            # The blocked route: the raw encoded columns go in (it pads to
            # its own row capacity) and only kept partitions come back;
            # over a mesh, rows shard by privacy id and each block's
            # partial columns are combined (C21).
            from pipelinedp_tpu_torch.parallel import large_p
            rows = (encoded.pid, encoded.pk, encoded.values, encoded.valid,
                    min_v, max_v, min_s, max_s, mid, stds, key, cfg)
            with budget_accountant.no_new_mechanisms(
                    "blocked aggregation execution"):
                if backend.mesh is not None:
                    kept_ids, outputs = large_p.aggregate_blocked_sharded(
                        backend.mesh, *rows, secure_tables=secure_tables,
                        reshard=backend.reshard, **blocked_kwargs(backend))
                else:
                    kept_ids, outputs = large_p.aggregate_blocked(
                        *rows, secure_tables=secure_tables,
                        **blocked_kwargs(backend))
            yield from decode_blocked_results(kept_ids, outputs,
                                              encoded.partition_vocab,
                                              compound)
            return
        rows = pad_rows(encoded)
        with budget_accountant.no_new_mechanisms("dense release execution"):
            result = None
            interceptor = _active_launch_interceptor()
            if _offerable(interceptor, rows[0], backend):
                # The megabatched service: this job may run as one lane of
                # a lane-batched release (None: run solo).
                result = interceptor(ReleaseLaunch(
                    kind="aggregate", pid=rows[0], pk=rows[1],
                    values=rows[2], valid=rows[3], key=key,
                    scalars=(min_v, max_v, min_s, max_s, mid),
                    stds=np.asarray(stds), cfg=cfg, device=backend.device,
                    dtype=backend.dtype, mesh=backend.mesh,
                    reshard=backend.reshard, secure_tables=secure_tables,
                    tables_key=tables_key))
            if result is None and backend.mesh is not None:
                from pipelinedp_tpu_torch.parallel import sharded
                result = sharded.sharded_aggregate_arrays(
                    backend.mesh, *rows, min_v, max_v, min_s, max_s, mid,
                    stds, key, cfg, secure_tables, reshard=backend.reshard,
                    dtype=backend.dtype, fused=backend.fused_release,
                    **runtime_kwargs(backend))
            elif result is None:
                pid, pk, values, valid = padded_to_device(
                    *rows, backend.device, backend.dtype)
                kernel = (aggregate_release_kernel if backend.fused_release
                          else aggregate_kernel)
                result = kernel(pid, pk, values, valid, min_v, max_v, min_s,
                                max_s, mid, stds, key, cfg, secure_tables)
        if backend.fused_release:
            n_kept, order, outputs, flags = result
            yield from decode_release_results(
                n_kept, order, outputs, flags, encoded.partition_vocab,
                compound, cfg.numeric_mode)
        else:
            yield from decode_results(*result, encoded.partition_vocab,
                                      compound, cfg.numeric_mode)

    return generator()


def resolve_n_partitions(backend, n_partitions: int) -> int:
    """Honors TorchBackend(max_partitions=...), as the JAX package's
    resolve_n_partitions: a fixed result width at least the data's."""
    if backend.max_partitions is not None:
        if backend.max_partitions < n_partitions:
            raise ValueError(
                f"TorchBackend(max_partitions={backend.max_partitions}) is "
                f"smaller than the {n_partitions} partitions in the data.")
        return backend.max_partitions
    return n_partitions


def _blocked(backend, n_partitions: int) -> bool:
    """The blocked route above large_partition_threshold (None: never)."""
    threshold = backend.large_partition_threshold
    return threshold is not None and n_partitions > threshold


def stream_chunk_source(backend, source: rt_pipeline.ChunkSource,
                        public_list=None) -> columnar.EncodedData:
    """Encodes a ChunkSource through the streamed ingest under the
    backend's encode_threads / pipeline_depth / encode_mode knobs (the
    source's encode_mode, where set, wins), onto the backend's device in
    its working dtype (the JAX package's stream_chunk_source, :1277; its
    watchdog is ROADMAP.md Queue 1 item 13)."""
    threads = backend.encode_threads
    if threads is None:
        threads = rt_pipeline.default_encode_threads()
    encode_mode = source.encode_mode or backend.encode_mode
    return ingest.stream_encode_columns(
        source.chunks, public_partitions=public_list,
        nonfinite=source.nonfinite, encode_threads=threads,
        pipeline_depth=backend.pipeline_depth, encode_mode=encode_mode,
        device=backend.device, dtype=backend.dtype)


def _encode_input(backend, col, data_extractors, public_list=None,
                  with_values: bool = True) -> columnar.EncodedData:
    """The encode stage of both entry points: a ChunkSource streams through
    the ingest, anything else takes columnar.encode."""
    if isinstance(col, rt_pipeline.ChunkSource):
        return stream_chunk_source(backend, col, public_list)
    return columnar.encode(col, data_extractors, public_list, with_values)


def decode_release_results(n_kept, order, outputs, flags,
                           partition_vocab: Sequence[Any],
                           compound: dp_combiners.CompoundCombiner,
                           numeric_mode: str = "fast"):
    """Compacted release -> [(partition_key, MetricsTuple)]. One host copy
    of (n_kept, flags) gates the release: the sentinel raises, as
    numeric_mode classifies the flag word, before any value is decoded;
    then O(kept) ids and values are copied."""
    gate = torch.stack([n_kept.to(torch.int64),
                        flags.reshape(()).to(torch.int64)]).cpu()
    k, flag_word = int(gate[0]), int(gate[1]) & 0xFFFFFFFF
    numeric.check_release(flag_word, outputs, context="dense release",
                          numeric_mode=numeric_mode)
    ids = order[:k].cpu().numpy()
    cols = {name: col[:k].cpu().numpy() for name, col in outputs.items()}
    return _decode_rows(ids, cols, partition_vocab, compound)


def decode_results(outputs, keep, flags, partition_vocab: Sequence[Any],
                   compound: dp_combiners.CompoundCombiner,
                   numeric_mode: str = "fast"):
    """Unfused release (dense [P] outputs, keep bool[P], flags) ->
    [(partition_key, MetricsTuple)] (the JAX package's decode_results,
    :1905): the flag word gates the release as in decode_release_results,
    then the dense columns come to the host and the kept partitions are
    np.nonzero(keep), the order the fused release compacts them in."""
    flag_word = int(flags.reshape(()).to(torch.int64).cpu()) & 0xFFFFFFFF
    numeric.check_release(flag_word, outputs,
                          context="dense release (unfused)",
                          numeric_mode=numeric_mode)
    ids = np.nonzero(keep.cpu().numpy())[0]
    cols = {name: col.cpu().numpy()[ids] for name, col in outputs.items()}
    return _decode_rows(ids, cols, partition_vocab, compound)


def decode_blocked_results(kept_ids: np.ndarray, outputs: Dict[str,
                                                               np.ndarray],
                           partition_vocab: Sequence[Any],
                           compound: dp_combiners.CompoundCombiner):
    """Blocked route output (kept ids ascending + their host columns, the
    sentinel already checked per block) -> [(partition_key,
    MetricsTuple)]."""
    return _decode_rows(np.asarray(kept_ids), outputs, partition_vocab,
                        compound)


def _decode_rows(ids: np.ndarray, cols: Dict[str, np.ndarray],
                 partition_vocab: Sequence[Any],
                 compound: dp_combiners.CompoundCombiner):
    """Kept partition ids + their host columns (row j of every column
    belongs to ids[j]) -> [(partition_key, MetricsTuple)]; ids past the
    vocabulary (padding partitions) are skipped."""
    field_order = tuple(
        name for entry in build_plan(compound) for name in entry.outputs)
    # The result type is looked up once a release, not once a partition:
    # the lookup takes a lock, which concurrent jobs of the service would
    # otherwise queue on per partition.
    metrics_tuple = dp_combiners._get_or_create_named_tuple(
        "MetricsTuple", field_order)
    n_real = len(partition_vocab)
    _prefetch(partition_vocab, ids)
    # Scalar columns as Python floats once (the same values float() of
    # each element gives); a vector column (vector_sum) decodes a row to a
    # float64 ndarray.
    columns = [cols[name].tolist() if cols[name].ndim == 1 else cols[name]
               for name in field_order]
    for row, idx in enumerate(ids):
        if idx >= n_real:
            continue
        values = tuple(col[row] if isinstance(col, list) else
                       np.asarray(col[row], dtype=np.float64)
                       for col in columns)
        yield partition_vocab[idx], metrics_tuple(*values)


def _prefetch(partition_vocab, ids) -> None:
    """A hash-encoded vocabulary (device_encode.HashVocab) decodes exactly
    the kept ids in one batch before they are indexed."""
    if hasattr(partition_vocab, "prefetch"):
        n_real = len(partition_vocab)
        partition_vocab.prefetch(idx for idx in ids if idx < n_real)


def select_partitions_release_kernel(pid: torch.Tensor, pk: torch.Tensor,
                                     valid: torch.Tensor, rng_key, l0: int,
                                     n_partitions: int,
                                     selection: selection_ops.SelectionParams,
                                     dtype: torch.dtype):
    """Standalone DP partition selection with kept-first compaction (the
    JAX package's select_partitions_release_kernel, :1107).

    Pairs are deduplicated and each pid's partitions L0-sampled by the
    bounding machinery without values: C1 keys (no uniform), C5 by
    (k1, k2), C2 with no row cap; the kept pair starts per partition (C5
    by kept partition, C3's pid_count, exact integers) are the privacy-id
    counts the JAX package scatter-adds; C4 draws the keep decisions with
    an empty metric plan and C6 compacts. Returns (n_kept, order).
    """
    key_l0, key_sel = select_key_schedule(rng_key)
    cols = select_partition_counts(pid, pk, valid, key_l0, l0, n_partitions,
                                   dtype)
    return select_release(cols, selection, key_sel)


def select_partitions_kernel(pid: torch.Tensor, pk: torch.Tensor,
                             valid: torch.Tensor, rng_key, l0: int,
                             n_partitions: int,
                             selection: selection_ops.SelectionParams,
                             dtype: torch.dtype) -> torch.Tensor:
    """The unfused standalone selection (the JAX package's
    select_partitions_kernel, :1095): select_partitions_release_kernel
    without the compaction. Returns keep bool[n_partitions]."""
    key_l0, key_sel = select_key_schedule(rng_key)
    cols = select_partition_counts(pid, pk, valid, key_l0, l0, n_partitions,
                                   dtype)
    return select_keep(cols, selection, key_sel)


def select_partition_counts(pid: torch.Tensor, pk: torch.Tensor,
                            valid: torch.Tensor, key_l0, l0: int,
                            n_partitions: int, dtype: torch.dtype):
    """The counting stage of standalone selection (the JAX package's
    select_partition_counts, :1013): the partitions' privacy-id counts
    after pair dedupe and L0 sampling, as C3's count / pid_count columns
    (exact integers). On the mesh it runs once a shard, under the shard's
    L0 key."""
    key2, pair_start = select_bounded_pairs(pid, pk, valid, key_l0, l0,
                                            n_partitions)
    cols, _ = reduce_rows_to_partitions(key2, pair_start, {}, n_partitions,
                                        dtype)
    return cols


def select_bounded_pairs(pid: torch.Tensor, pk: torch.Tensor,
                         valid: torch.Tensor, key_l0, l0: int,
                         n_partitions: int):
    """The deduplicated, L0-sampled (pid, partition) pairs of standalone
    selection, in bounding order: C1 keys without a uniform, C5 by
    (k1, k2), C2 with no row cap. Returns (key2, pair_start): key2 is the
    row's partition where its pair is kept (n_partitions elsewhere), and
    pair_start marks the first row of each kept pair."""
    k1, k2, _ = kernels.row_keys(pid, pk, valid, row_salts(key_l0), None,
                                 n_partitions, None)
    perm, sorted_k1 = kernels.radix_sort([k1, k2], sorted_top=True)
    key2, pair_start, _ = kernels.bound_rows(
        perm, k1, k2, pk, None, valid, n_partitions=n_partitions, linf=0,
        l0=l0, clip_per_value=False, clip_pair_sum=False,
        scalars=(0.0,) * 5, columns=(), sorted_k1=sorted_k1)
    return key2, pair_start


def select_keep(cols: Dict[str, torch.Tensor],
                selection: selection_ops.SelectionParams,
                key_sel) -> torch.Tensor:
    """Keep decisions from the partitions' privacy-id counts (C4 with an
    empty metric plan): bool[P]."""
    keep, _, _ = kernels.release_epilogue(
        cols, [], np.zeros(0), np.zeros((0, 2), np.uint32), NoiseKind.LAPLACE,
        False, 0.0, 0.0, selection, key_sel, 1)
    return keep


def select_release(cols: Dict[str, torch.Tensor],
                   selection: selection_ops.SelectionParams, key_sel):
    """select_keep and the kept-first order (C6): (n_kept, order)."""
    n_kept, order, _ = kernels.compact_kept(
        select_keep(cols, selection, key_sel), {})
    return n_kept, order


def batched_select_partitions_release_kernel(
        pid, pk, valid, rng_keys, l0: int, n_partitions: int,
        selection: selection_ops.SelectionParams, dtype: torch.dtype):
    """Standalone selection of L jobs in one launch a stage (the JAX
    package's batched_select_partitions_release_kernel, :1141): pid / pk /
    valid [L, n], rng_keys [L, 2]. C1's lane entry without a uniform, C5 by
    (lane, k1, k2), C2's lane entry with no row cap, C5 by key2, C3's lane
    entry (pid_count), C4's with an empty plan, C6's. Returns (n_kept
    int64[L], order int64[L, P]); lane l equals
    select_partitions_release_kernel on its rows and key alone."""
    salts, key_sel = lane_select_keys(rng_keys)
    cols = batched_select_counts(pid, pk, valid, salts, l0, n_partitions,
                                 dtype)
    return batched_select_release(cols, selection, key_sel, pid.shape[0])


def batched_select_counts(pid, pk, valid, salts, l0: int, n_partitions: int,
                          dtype: torch.dtype):
    """The counting stage of L standalone selections (C1, C2 and C3's lane
    entries): the lanes' count / pid_count columns, [L * P]. On the mesh
    it runs once a shard, under the shard's salts."""
    lane_rows = pid.shape[1]
    flat_valid = valid.reshape(-1)
    lane, k1, k2, _ = kernels.row_keys_lanes(
        pid.reshape(-1), pk.reshape(-1), flat_valid, lane_rows,
        salts, None, n_partitions, None)
    perm = kernels.radix_sort([lane, k1, k2])
    key2, pair_start, _ = kernels.bound_rows_lanes(
        perm, k1, k2, None, flat_valid, lane_rows=lane_rows,
        n_partitions=n_partitions, linf=0, l0=l0, clip_per_value=False,
        clip_pair_sum=False, scalars=(0.0,) * 5, columns=())
    perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
    return kernels.reduce_partitions_lanes(skey2, perm2, pair_start, {},
                                           lane_rows, n_partitions, dtype)


def batched_select_release(cols, selection: selection_ops.SelectionParams,
                           key_sel, n_lanes: int):
    """The lanes' keep decisions (C4's lane entry with an empty plan) and
    kept-first order (C6's): (n_kept int64[L], order int64[L, P])."""
    keep, _, _ = kernels.release_epilogue_lanes(
        cols, [], np.zeros(0), np.zeros((n_lanes, 0, 2), np.uint32),
        NoiseKind.LAPLACE, False, 0.0, 0.0, selection, key_sel, 1, n_lanes)
    n_kept, order, _ = kernels.compact_kept_lanes(keep, {}, n_lanes)
    return n_kept, order


def select_kept_pair_stream(pid: torch.Tensor, pk: torch.Tensor,
                            valid: torch.Tensor, rng_key, l0: int,
                            n_partitions: int):
    """Pass 1 of the blocked selection (the JAX package's
    select_kept_pair_stream, :1068): the bounded pairs' rows sorted by
    kept partition, the dropped rows (key2 = n_partitions) at the tail.
    rng_key is the L0 key (key_l0 of select_partitions_blocked).

    Where the JAX package keeps one row a kept pair, the port keeps every
    row of a kept pair and marks the first (pair_start): C3's pid_count of
    a window counts the pairs. Returns (skey2 int32[n] ascending, perm
    int64[n] into the bounding order, pair_start bool[n] in bounding
    order); the survivor count comes from C10 over skey2.
    """
    key2, pair_start = select_bounded_pairs(pid, pk, valid, rng_key, l0,
                                            n_partitions)
    perm, skey2 = kernels.radix_sort([key2], sorted_top=True)
    return skey2, perm, pair_start


def lazy_select_partitions(backend, col, params, data_extractors,
                           budget_accountant, report_generator):
    """Graph-time setup + lazily executed partition selection (dense,
    single-device route of the JAX package's lazy_select_partitions).

    The budget is requested NOW (graph time); the kernels run when the
    returned generator is first iterated, after compute_budgets().
    """
    with rt_observability.mechanism_label("partition_selection"):
        budget = budget_accountant.request_budget(
            mechanism_type=MechanismType.GENERIC)
    strategy = params.partition_selection_strategy
    pre_threshold_str = (f", pre_threshold={params.pre_threshold}"
                         if params.pre_threshold else "")
    report_generator.add_stage(
        lambda: f"Private Partition selection: using {strategy.value} "
        f"method with (eps={budget.eps}, delta={budget.delta}"
        f"{pre_threshold_str})")

    def generator():
        # Selection never reads values: rows' are not extracted, and an
        # encoded or streamed input's go no further than this.
        encoded = dataclasses.replace(
            _encode_input(backend, col, data_extractors, with_values=False),
            values=None)
        selection = selection_ops.selection_params_from_host(
            strategy, budget.eps, budget.delta,
            params.max_partitions_contributed, params.pre_threshold)
        n_partitions = resolve_n_partitions(backend, encoded.n_partitions)
        key = noise_ops.make_noise_key(backend.noise_seed)
        if _blocked(backend, n_partitions):
            from pipelinedp_tpu_torch.parallel import large_p
            rows = (encoded.pid, encoded.pk, encoded.valid, key,
                    params.max_partitions_contributed, n_partitions,
                    selection)
            with budget_accountant.no_new_mechanisms(
                    "blocked partition selection execution"):
                if backend.mesh is not None:
                    kept_ids = large_p.select_partitions_blocked_sharded(
                        backend.mesh, *rows, reshard=backend.reshard,
                        **blocked_kwargs(backend))
                else:
                    kept_ids = large_p.select_partitions_blocked(
                        *rows, **blocked_kwargs(backend))
            yield from _decode_keys(kept_ids, encoded.partition_vocab)
            return
        # The meshed selection stages the unpadded rows, as the JAX
        # package's does.
        rows = (pad_rows(encoded) if backend.mesh is None else
                (encoded.pid, encoded.pk, None, encoded.valid))
        with budget_accountant.no_new_mechanisms(
                "partition selection execution"):
            result = None
            interceptor = _active_launch_interceptor()
            if _offerable(interceptor, rows[0], backend):
                result = interceptor(ReleaseLaunch(
                    kind="select", pid=rows[0], pk=rows[1], valid=rows[3],
                    key=key, l0=params.max_partitions_contributed,
                    n_partitions=n_partitions, selection=selection,
                    device=backend.device, dtype=backend.dtype,
                    mesh=backend.mesh, reshard=backend.reshard))
            if result is None and backend.mesh is not None:
                from pipelinedp_tpu_torch.parallel import sharded
                result = sharded.sharded_select_partitions(
                    backend.mesh, rows[0], rows[1], rows[3], key,
                    params.max_partitions_contributed, n_partitions,
                    selection, reshard=backend.reshard, dtype=backend.dtype,
                    fused=backend.fused_release, **runtime_kwargs(backend))
            elif result is None:
                pid, pk, _, valid = padded_to_device(*rows, backend.device,
                                                     backend.dtype)
                kernel = (select_partitions_release_kernel
                          if backend.fused_release else
                          select_partitions_kernel)
                result = kernel(pid, pk, valid, key,
                                params.max_partitions_contributed,
                                n_partitions, selection, backend.dtype)
        if backend.fused_release:
            yield from decode_selected_partitions(*result,
                                                  encoded.partition_vocab)
        else:
            # The unfused drain: the dense keep vector, then np.nonzero.
            yield from _decode_keys(np.nonzero(result.cpu().numpy())[0],
                                    encoded.partition_vocab)

    return generator()


def runtime_kwargs(backend) -> Dict[str, Any]:
    """The runtime knobs a TorchBackend threads into the meshed and
    blocked drivers (runtime/entry.py), as the JAX package's
    _blocked_runtime_kwargs / _dense_runtime_kwargs do: retry and job_id,
    and on a mesh elastic, elastic_grow and min_devices (the unsharded
    drivers already run at the one-device floor)."""
    kwargs = dict(retry=getattr(backend, "retry", None))
    job_id = getattr(backend, "job_id", None)
    if job_id is not None:
        kwargs["job_id"] = job_id
    if getattr(backend, "mesh", None) is not None:
        if getattr(backend, "elastic", False):
            kwargs["elastic"] = True
        if getattr(backend, "elastic_grow", False):
            kwargs["elastic_grow"] = True
        min_devices = getattr(backend, "min_devices", 1)
        if min_devices != 1:
            kwargs["min_devices"] = min_devices
    return kwargs


def blocked_kwargs(backend) -> Dict[str, Any]:
    """The blocked entry points' keyword arguments from a TorchBackend: its
    working dtype, its device (a meshed backend's devices are its mesh's),
    block_partitions where set, and the runtime knobs (runtime_kwargs)."""
    kwargs = dict(dtype=backend.dtype, **runtime_kwargs(backend))
    if backend.mesh is None:
        kwargs["device"] = backend.device
    if backend.block_partitions is not None:
        kwargs["block_partitions"] = backend.block_partitions
    return kwargs


def decode_selected_partitions(n_kept, order, partition_vocab):
    """Kept partition keys: one host copy of n_kept, then O(kept) ids."""
    return _decode_keys(order[:int(n_kept.cpu())].cpu().numpy(),
                        partition_vocab)


def _decode_keys(ids, partition_vocab):
    """The keys of kept partition ids; ids past the vocabulary (the
    padding partitions of max_partitions) are skipped."""
    _prefetch(partition_vocab, ids)
    n_real = len(partition_vocab)
    for idx in ids:
        if idx < n_real:
            yield partition_vocab[idx]
