"""Fused columnar DP aggregation executor, dense route.

Port of the dense route of pipelinedp_tpu/executor.py. Contribution
bounding, the per-partition reduction, private partition selection, noise
and kept-first compaction run over columnar tensors on one device:

    rows (pid, pk, value)
      -> C1 row_keys: sort keys (pid|hash0, hash1|pk) + row uniform u
      -> sort by (k1, k2, u)               # torch.sort, stable, LSD
      -> C2 bound_rows: Linf rank < linf, L0 pair rank < l0, clipping
      -> sort by kept partition            # torch.sort, stable
      -> C3 reduce_partitions: dense count/pid_count/sum/nsum/nsum2
      -> C4 release_epilogue: selection, noise, metric formulas, flags
      -> kept-first compaction             # torch.argsort, stable

Random choices come from the JAX package's threefry keys (ops/threefry.py),
derived on the host in the same order, so one seed gives the same bounded
rows, keep decisions and noise words on both packages. Noise stddevs and
selection budgets are launch arguments read when the lazy result is first
iterated, after BudgetAccountant.compute_budgets().

The working float width is the backend's `dtype`: float64 is the parity
mode the tests compare with the JAX package run under x64; float32 is the
card's mode, as the TPU's was.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import columnar
from pipelinedp_tpu_torch import combiners as dp_combiners
from pipelinedp_tpu_torch import dp_computations
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch import numeric
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams,
                                                   MechanismType, Metrics,
                                                   NoiseKind)
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry

# Out-of-scope features name the ROADMAP item that ports them.
_LATER = {
    "max_contributions": "ROADMAP.md Queue 1: the total contribution bound "
                         "(max_contributions)",
    "metric": "ROADMAP.md Queue 1 item 7 (metric and mode breadth)",
    "custom": "ROADMAP.md Queue 1 item 14 (custom combiners on the generic "
              "backends)",
    "large_p": "ROADMAP.md Queue 1 item 8 (parallel/large_p.py, the blocked "
               "route above large_partition_threshold)",
}


@dataclass(frozen=True)
class MetricPlanEntry:
    """Static description of one child combiner's device computation."""
    kind: str  # count | privacy_id_count | sum | mean | variance
    outputs: Tuple[str, ...]  # metric names in the child's output order
    n_stds: int  # number of noise stddevs the entry consumes


@dataclass(frozen=True)
class KernelConfig:
    """Static configuration of one dense release."""
    n_partitions: int
    linf: int  # 0 = no per-partition row sampling
    l0: int
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


def check_supported(params: AggregateParams) -> None:
    """Raises NotImplementedError for what this slice of the port does not
    run yet."""
    if params.custom_combiners:
        raise NotImplementedError(
            f"custom combiners are not ported yet: {_LATER['custom']}")
    if params.max_contributions is not None:
        raise NotImplementedError(
            f"max_contributions is not ported yet: "
            f"{_LATER['max_contributions']}")
    for metric in params.metrics or []:
        if metric == Metrics.VECTOR_SUM or metric.is_percentile:
            raise NotImplementedError(
                f"{metric} is not ported yet: {_LATER['metric']}")


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
        else:
            raise NotImplementedError(type(child))
    return np.asarray(stds, dtype=np.float64)


def make_kernel_config(
        params: AggregateParams, compound: dp_combiners.CompoundCombiner,
        n_partitions: int, private_selection: bool,
        selection_params: Optional[selection_ops.SelectionParams]
) -> KernelConfig:
    """Builds the release config from aggregation parameters."""
    max_rows = 1
    if params.contribution_bounds_already_enforced:
        max_rows = params.max_contributions_per_partition or 1
    return KernelConfig(
        n_partitions=n_partitions,
        linf=params.max_contributions_per_partition or 0,
        l0=params.max_partitions_contributed or 0,
        sample_per_partition=compound.expects_per_partition_sampling(),
        clip_per_value=params.bounds_per_contribution_are_set,
        clip_pair_sum=params.bounds_per_partition_are_set,
        bounds_enforced=params.contribution_bounds_already_enforced,
        noise_kind=params.noise_kind,
        private_selection=private_selection,
        selection=selection_params,
        max_rows_per_privacy_id=max_rows,
        plan=build_plan(compound),
        degenerate_range=(params.min_value is not None and
                          params.min_value == params.max_value))


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
    invalid row changes no output; row i draws counter i either way)."""
    n = encoded.n_rows
    pad = row_bucket(n) - n
    if pad == 0:
        return encoded.pid, encoded.pk, encoded.values, encoded.valid
    return (np.concatenate([encoded.pid, np.zeros(pad, np.int32)]),
            np.concatenate([encoded.pk, np.full(pad, -1, np.int32)]),
            np.concatenate([encoded.values, np.zeros(pad, np.float64)]),
            np.concatenate([encoded.valid, np.zeros(pad, bool)]))


def reduce_column_names(cfg: KernelConfig) -> List[str]:
    """The row columns bounded_row_columns emits for this config."""
    names = []
    if any(e.kind == 'sum' for e in cfg.plan):
        names.append('sum')
    if any(e.kind in ('mean', 'variance') for e in cfg.plan):
        names.append('nsum')
    if any(e.kind == 'variance' for e in cfg.plan):
        names.append('nsum2')
    return names


def sort_rows(k1: torch.Tensor, k2: torch.Tensor,
              u: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows by (k1, k2, u): stable sorts from the least
    significant key up (the JAX package's lax.sort over 5 keys)."""
    perm = torch.argsort(u, stable=True)
    perm = perm[torch.argsort(k2[perm], stable=True)]
    return perm[torch.argsort(k1[perm], stable=True)]


def bounded_row_columns(pid: torch.Tensor, pk: torch.Tensor,
                        values: torch.Tensor, valid: torch.Tensor, min_v,
                        max_v, min_s, max_s, mid, rows_key,
                        cfg: KernelConfig):
    """Phase 1a: contribution bounding -> per-row reduction columns.

    Returns (key2, pair_start, reduce_cols) in the bounding-sort order of
    the JAX package's bounded_row_columns: key2 is the row's partition
    where it is kept (keep_row = key2 < n_partitions) and n_partitions
    elsewhere.
    """
    P = cfg.n_partitions
    _, key_linf, key_l0 = threefry.split(rows_key, 3)
    scalars = (min_v, max_v, min_s, max_s, mid)
    common = dict(n_partitions=P, l0=cfg.l0,
                  clip_per_value=cfg.clip_per_value,
                  clip_pair_sum=cfg.clip_pair_sum, scalars=scalars,
                  columns=reduce_column_names(cfg))
    if cfg.bounds_enforced:
        # Each row is its own contribution group: no bounding sort.
        return kernels.bound_rows(None, None, None, pk, values, valid,
                                  linf=0, **common)
    k1, k2, u = kernels.row_keys(pid, pk, valid, threefry.bits(key_l0, 4),
                                 key_linf, P, values.dtype)
    perm = sort_rows(k1, k2, u)
    linf = cfg.linf if cfg.sample_per_partition else 0
    return kernels.bound_rows(perm, k1, k2, pk, values, valid, linf=linf,
                              **common)


def reduce_rows_to_partitions(key2: torch.Tensor, pair_start: torch.Tensor,
                              reduce_cols: Dict[str, torch.Tensor],
                              n_partitions: int,
                              dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Phase 1b: dense [0, n_partitions) partition columns from the bounded
    row stream (one stable sort by kept partition, then C3)."""
    skey2, perm = torch.sort(key2, stable=True)
    cols = kernels.reduce_partitions(skey2, perm, pair_start, reduce_cols,
                                     n_partitions, dtype)
    cols['row_count'] = cols['pid_count']
    return cols


def slot_keys(key_noise, plan: Sequence[MetricPlanEntry]) -> np.ndarray:
    """The threefry key of every noise slot: slot offset+j of plan entry i
    draws under fold_in(fold_in(key_noise, i), j), as finalize does."""
    keys = []
    for i, entry in enumerate(plan):
        ekey = threefry.fold_in(key_noise, i)
        keys.extend(threefry.fold_in(ekey, j) for j in range(entry.n_stds))
    return np.asarray(keys, dtype=np.uint32).reshape(-1, 2)


def finalize(cols: Dict[str, torch.Tensor], min_v, mid, stds: np.ndarray,
             final_key, cfg: KernelConfig):
    """Phase 2: DP partition selection + noise + metric formulas + the
    sentinel flag word (C4). Returns (outputs, keep, flags)."""
    key_sel, key_noise = threefry.split(final_key, 2)
    plan = []
    offset = 0
    for entry in cfg.plan:
        plan.append((entry.kind, entry.outputs, offset))
        offset += entry.n_stds
    keep, outputs, flags = kernels.release_epilogue(
        cols, plan, stds, slot_keys(key_noise, cfg.plan), cfg.noise_kind,
        cfg.degenerate_range, mid, min_v,
        cfg.selection if cfg.private_selection else None, key_sel,
        cfg.max_rows_per_privacy_id)
    return outputs, keep, flags


def compact_release(outputs: Dict[str, torch.Tensor], keep: torch.Tensor):
    """Kept-first compaction: a stable argsort of ~keep puts kept partitions
    first in ascending id order (exactly nonzero(keep)). Returns (n_kept,
    order int64[P], outputs in that order)."""
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    return keep.sum(), order, {n: c[order] for n, c in outputs.items()}


def aggregate_release_kernel(pid, pk, values, valid, min_v, max_v, min_s,
                             max_s, mid, stds: np.ndarray, rng_key,
                             cfg: KernelConfig):
    """The dense release: bounding, partition columns, selection, noise,
    compaction. Key derivation follows the JAX package's _aggregate_trace.
    Returns (n_kept, order, outputs kept-first, flags)."""
    rows_key, final_key = threefry.split(rng_key, 2)
    key2, pair_start, reduce_cols = bounded_row_columns(
        pid, pk, values, valid, min_v, max_v, min_s, max_s, mid, rows_key,
        cfg)
    cols = reduce_rows_to_partitions(key2, pair_start, reduce_cols,
                                     cfg.n_partitions, values.dtype)
    outputs, keep, flags = finalize(cols, min_v, mid, stds, final_key, cfg)
    n_kept, order, outputs_sorted = compact_release(outputs, keep)
    return n_kept, order, outputs_sorted, flags


def to_device(encoded: columnar.EncodedData, device: torch.device,
              dtype: torch.dtype):
    """pad_rows + one host-to-device copy per column."""
    pid, pk, values, valid = pad_rows(encoded)
    return (torch.as_tensor(pid, dtype=torch.int32).to(device),
            torch.as_tensor(pk, dtype=torch.int32).to(device),
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
        selection_budget = budget_accountant.request_budget(
            mechanism_type=MechanismType.GENERIC)

    if not private:
        report_generator.add_stage(
            "Public partition selection: dropped non public partitions")
    if not params.contribution_bounds_already_enforced:
        if compound.expects_per_partition_sampling():
            report_generator.add_stage(
                f"Per-partition contribution bounding: for each privacy_id "
                f"and each partition, randomly select "
                f"max(actual_contributions_per_partition, "
                f"{params.max_contributions_per_partition}) contributions.")
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
        encoded = columnar.encode(col, data_extractors, public_list)
        selection_params = None
        if private:
            selection_params = selection_ops.selection_params_from_host(
                params.partition_selection_strategy, selection_budget.eps,
                selection_budget.delta, params.max_partitions_contributed,
                params.pre_threshold)
        n_partitions = encoded.n_partitions
        if n_partitions > backend.large_partition_threshold:
            raise NotImplementedError(
                f"{n_partitions} partitions exceed large_partition_threshold="
                f"{backend.large_partition_threshold}: {_LATER['large_p']}")
        cfg = make_kernel_config(params, compound, n_partitions, private,
                                 selection_params)
        stds = compute_noise_stds(compound)
        key = noise_ops.make_noise_key(backend.noise_seed)
        min_v, max_v, min_s, max_s, mid = kernel_scalars(params)
        pid, pk, values, valid = to_device(encoded, backend.device,
                                           backend.dtype)
        with budget_accountant.no_new_mechanisms("dense release execution"):
            n_kept, order, outputs, flags = aggregate_release_kernel(
                pid, pk, values, valid, min_v, max_v, min_s, max_s, mid,
                stds, key, cfg)
        yield from decode_release_results(n_kept, order, outputs, flags,
                                          encoded.partition_vocab, compound)

    return generator()


def decode_release_results(n_kept, order, outputs, flags,
                           partition_vocab: Sequence[Any],
                           compound: dp_combiners.CompoundCombiner):
    """Compacted release -> [(partition_key, MetricsTuple)]. One host copy
    of (n_kept, flags) gates the release: the sentinel raises before any
    value is decoded; then O(kept) ids and values are copied."""
    gate = torch.stack([n_kept.to(torch.int64),
                        flags.reshape(()).to(torch.int64)]).cpu()
    k, flag_word = int(gate[0]), int(gate[1]) & 0xFFFFFFFF
    numeric.check_release(flag_word, outputs, context="dense release")
    ids = order[:k].cpu().numpy()
    cols = {name: col[:k].cpu().numpy() for name, col in outputs.items()}
    field_order = tuple(
        name for entry in build_plan(compound) for name in entry.outputs)
    n_real = len(partition_vocab)
    for row, idx in enumerate(ids):
        if idx >= n_real:
            continue
        values = tuple(float(cols[name][row]) for name in field_order)
        yield (partition_vocab[idx],
               dp_combiners._create_named_tuple_instance(
                   "MetricsTuple", field_order, values))
