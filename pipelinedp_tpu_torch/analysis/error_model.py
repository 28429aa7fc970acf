"""Closed-form DP error model over flat statistic vectors.

Port of pipelinedp_tpu/analysis/error_model.py, the single source of truth
for the utility-analysis math. Every quantity lives in a fixed-width float
vector (a "stats row" per partition, a "report row" per metric); a merge is
vector addition, so the same formulas run as numpy on the host and as
torch in the sweep's plain versions (kernels.sweep_stats_plain,
sweep_report_plain), which the CUDA kernels C19 / C20 repeat expression for
expression. All per-row formulas broadcast over a leading
parameter-configuration axis K.

The term functions take ``xp``: numpy (the default) or TORCH_XP, a small
namespace that maps the numpy spellings these formulas use (``axis=``,
scalar operands of maximum / minimum) onto torch, so one formula text
serves both.
"""

import math
from typing import List, Sequence

import numpy as np
import torch

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import dp_computations
from pipelinedp_tpu_torch import partition_selection
from pipelinedp_tpu_torch.analysis import metrics as metrics_dc
from pipelinedp_tpu_torch.analysis import poisson_binomial

# ---------------------------------------------------------------------------
# Stats-row schema (per metric, per config, per partition): sufficient
# statistics accumulated additively over a partition's per-privacy-id rows.
# ---------------------------------------------------------------------------
RAW, CLIP_MIN, CLIP_MAX, L0_MEAN, L0_VAR = range(5)
STAT_WIDTH = 5

# Selection-moment schema (per config, per partition): moments of the
# post-l0-bounding privacy-id count (sum of independent Bernoullis).
SEL_MU, SEL_VAR, SEL_SKEW3 = range(3)
SEL_WIDTH = 3

# ---------------------------------------------------------------------------
# Report-row schema (per metric, per config): cross-partition accumulands.
# ABS_* fields are weighted absolute errors; REL_* the same divided by the
# partition's raw value (variances by its square); DROP_* unweighted dropped
# data amounts. Finalization divides ABS/REL by total weight and DROP by the
# metric's total raw sum — replacing the reference's recursive
# dataclass-multiply (``cross_partition_combiners.py:117-150``).
# ---------------------------------------------------------------------------
(ABS_MEAN, ABS_VAR, ABS_RMSE, ABS_RMSE_DROP, ABS_L1, ABS_L1_DROP, ABS_L0_MEAN,
 ABS_L0_VAR, ABS_LINF_MIN, ABS_LINF_MAX, REL_MEAN, REL_VAR, REL_RMSE,
 REL_RMSE_DROP, REL_L1, REL_L1_DROP, REL_L0_MEAN, REL_L0_VAR, REL_LINF_MIN,
 REL_LINF_MAX, DROP_L0, DROP_LINF, DROP_PS, SUM_ACTUAL) = range(24)
REPORT_WIDTH = 24

# Partition-info schema (per config): additive partition bookkeeping.
N_DATASET, N_EMPTY, KEEP_MEAN, KEEP_VAR, WEIGHT = range(5)
INFO_WIDTH = 5

# Beyond this many privacy ids per partition the exact Poisson-binomial PMF
# is replaced by the skew-corrected normal approximation (host path; the
# sweep always approximates). Matches the reference's accumulator size cap
# (``per_partition_combiners.py:40``).
EXACT_PMF_LIMIT = 100


def _tensor_pair(a, b):
    """a and b as tensors, a Python scalar taking the other's dtype and
    device (numpy's and jnp's weak scalars)."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    if not torch.is_tensor(b):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return a, b


class TORCH_XP:
    """The numpy functions of the term formulas, on torch tensors."""
    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)
    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)
    ones_like = staticmethod(torch.ones_like)
    broadcast_to = staticmethod(torch.broadcast_to)

    @staticmethod
    def maximum(a, b):
        return torch.maximum(*_tensor_pair(a, b))

    @staticmethod
    def minimum(a, b):
        return torch.minimum(*_tensor_pair(a, b))

    @staticmethod
    def clip(x, lo, hi):
        """jnp.clip: minimum(maximum(x, lo), hi)."""
        return TORCH_XP.minimum(TORCH_XP.maximum(x, lo), hi)

    @staticmethod
    def stack(arrays, axis=0):
        return torch.stack(list(arrays), dim=axis)


def keep_fraction(n_partitions, l0, xp=np):
    """P(a contribution survives l0 bounding) = min(1, l0 / n_partitions).

    Broadcasts: ``n_partitions`` is per-row, ``l0`` per-config.
    """
    safe_n = xp.maximum(n_partitions, 1)
    return xp.where(n_partitions > 0, xp.minimum(1.0, l0 / safe_n), 0.0)


def metric_stat_terms(values, lo, hi, keep_q, xp=np):
    """Per-row contributions to the 5 metric sufficient statistics.

    Args:
      values: per-row metric values (count / indicator / sum), shape [..., N].
      lo, hi: clipping bounds, broadcastable (e.g. [K, 1] against [N]).
      keep_q: per-row l0 keep fraction, same broadcast shape as the output.

    Returns:
      Array [..., N, STAT_WIDTH]; summing over N (or segment-summing over a
      partition index) yields the partition's stats row.
    """
    clipped = xp.clip(values, lo, hi)
    err = clipped - values
    raw = xp.broadcast_to(values, clipped.shape)
    return xp.stack(
        [
            raw,
            xp.where(values < lo, err, xp.zeros_like(err)),
            xp.where(values > hi, err, xp.zeros_like(err)),
            -clipped * (1.0 - keep_q),
            clipped * clipped * keep_q * (1.0 - keep_q),
        ],
        axis=-1,
    )


def selection_moment_terms(keep_q, xp=np):
    """Per-row Bernoulli moment contributions [..., N, SEL_WIDTH]."""
    centered = keep_q * (1.0 - keep_q)
    return xp.stack([keep_q, centered, centered * (1.0 - 2.0 * keep_q)],
                    axis=-1)


def metric_report_terms(stats, keep_prob, weight, noise_std, xp=np):
    """Per-partition report row [..., REPORT_WIDTH] from a stats row.

    Args:
      stats: [..., STAT_WIDTH] per-partition metric statistics.
      keep_prob: partition keep probability, broadcastable to stats[..., 0].
      weight: cross-partition averaging weight (same broadcast).
      noise_std: DP noise stddev (per-config scalar or broadcastable array).
    """
    raw = stats[..., RAW]
    mn = stats[..., CLIP_MIN]
    mx = stats[..., CLIP_MAX]
    l0m = stats[..., L0_MEAN]
    l0v = stats[..., L0_VAR]
    mean = l0m + mn + mx
    var = l0v + noise_std * noise_std
    rmse = xp.sqrt(mean * mean + var)
    rmse_drop = keep_prob * rmse + (1.0 - keep_prob) * xp.abs(raw)
    zero = xp.zeros_like(raw)
    # Relative errors divide by the raw value (variances by its square);
    # raw == 0 contributes zeros (metrics_dc.ValueErrors.to_relative).
    inv = xp.where(raw != 0, 1.0 / xp.where(raw != 0, raw, 1.0), 0.0)
    inv2 = inv * inv
    abs_fields = [mean, var, rmse, rmse_drop, zero, zero, l0m, l0v, mn, mx]
    rel_fields = [
        mean * inv, var * inv2, rmse * inv, rmse_drop * inv, zero, zero,
        l0m * inv, l0v * inv2, mn * inv, mx * inv
    ]
    drop_l0 = -l0m
    drop_linf = mn - mx
    drop_ps = (raw - drop_l0 - drop_linf) * (1.0 - keep_prob)
    weighted = [f * weight for f in abs_fields + rel_fields]
    return xp.stack(weighted + [drop_l0, drop_linf, drop_ps, raw], axis=-1)


def info_terms(n_users, keep_prob, weight, public: bool, xp=np):
    """Per-partition info row [..., INFO_WIDTH].

    All inputs broadcast against ``keep_prob``'s shape.
    """
    one = xp.ones_like(keep_prob)
    zero = xp.zeros_like(one)
    if public:
        non_empty = xp.where(n_users > 0, one, zero)
        return xp.stack(
            [non_empty, 1.0 - non_empty, zero, zero, one * weight], axis=-1)
    return xp.stack(
        [one, zero, keep_prob, keep_prob * (1.0 - keep_prob), weight * one],
        axis=-1)


# ---------------------------------------------------------------------------
# Host-side keep probability (exact for small partitions).
# ---------------------------------------------------------------------------


def _pmf_keep_probability(pmf, selector) -> float:
    """Integrates the selector's keep probability over an id-count PMF —
    one vectorized dot product instead of per-integer strategy calls."""
    counts = np.arange(pmf.start, pmf.start + len(pmf.probabilities))
    keep = selector.probability_of_keep_vec(counts)
    return float(np.clip(np.dot(pmf.probabilities, keep), 0.0, 1.0))


def host_keep_probability(per_row_q: np.ndarray,
                          selector) -> float:
    """P(partition kept) for one partition and one config.

    per_row_q: [M] keep fraction per contributing privacy id. Uses the exact
    Poisson-binomial PMF for at most EXACT_PMF_LIMIT ids, the refined-normal
    approximation beyond (reference ``per_partition_combiners.py:96-150``).
    """
    m = len(per_row_q)
    if m == 0:
        return 0.0
    if m <= EXACT_PMF_LIMIT:
        pmf = poisson_binomial.compute_pmf(list(per_row_q))
    else:
        exp, std, skew = poisson_binomial.compute_exp_std_skewness(
            list(per_row_q))
        pmf = poisson_binomial.compute_pmf_approximation(exp, std, skew, m)
    return _pmf_keep_probability(pmf, selector)


def host_keep_probability_from_moments(mu: float, var: float, third: float,
                                       n_users: int, selector) -> float:
    """P(partition kept) from accumulated Bernoulli moments (the dense
    accumulator path — per-row keep fractions no longer available)."""
    if n_users == 0:
        return 0.0
    std = math.sqrt(max(var, 0.0))
    skew = 0.0 if std == 0 else third / std**3
    pmf = poisson_binomial.compute_pmf_approximation(mu, std, skew, n_users)
    return _pmf_keep_probability(pmf, selector)


# ---------------------------------------------------------------------------
# Config plumbing: noise stds, selectors and metric bounds per configuration.
# ---------------------------------------------------------------------------

# Canonical metric order inside stats/report matrices.
ANALYSIS_METRICS = (agg.Metrics.SUM, agg.Metrics.COUNT,
                    agg.Metrics.PRIVACY_ID_COUNT)


def ordered_metrics(params: agg.AggregateParams) -> List[agg.Metric]:
    """The analyzed metrics in canonical matrix order."""
    return [m for m in ANALYSIS_METRICS if m in params.metrics]


def metric_bounds(params: agg.AggregateParams, metric: agg.Metric):
    """(lo, hi) clipping bounds applied to the metric's per-row value."""
    if metric == agg.Metrics.SUM:
        return params.min_sum_per_partition, params.max_sum_per_partition
    if metric == agg.Metrics.COUNT:
        return 0.0, float(params.max_contributions_per_partition)
    if metric == agg.Metrics.PRIVACY_ID_COUNT:
        return 0.0, 1.0
    raise ValueError(f"Unsupported analysis metric {metric}")


def metric_values(metric: agg.Metric, counts: np.ndarray, sums: np.ndarray,
                  xp=np):
    """The per-row value the metric aggregates."""
    if metric == agg.Metrics.SUM:
        return sums
    if metric == agg.Metrics.COUNT:
        return counts
    if metric == agg.Metrics.PRIVACY_ID_COUNT:
        return xp.where(counts > 0, xp.ones_like(counts),
                        xp.zeros_like(counts))
    raise ValueError(f"Unsupported analysis metric {metric}")


def config_noise_std(params: agg.AggregateParams, metric: agg.Metric,
                     eps: float, delta: float) -> float:
    """DP noise stddev for one (config, metric).

    All analysis metrics behave as bounded sums with l0 = l0 bound and linf =
    max contributions (reference ``per_partition_combiners.py:270``: the
    count-noise formula is used for SUM analysis as well).
    """
    linf = params.max_contributions_per_partition
    if metric == agg.Metrics.PRIVACY_ID_COUNT:
        linf = 1
    scalar = dp_computations.ScalarNoiseParams(
        eps, delta, params.min_value, params.max_value,
        params.min_sum_per_partition, params.max_sum_per_partition,
        params.max_partitions_contributed, linf, params.noise_kind)
    return dp_computations.compute_dp_count_noise_std(scalar)


def config_selector(params: agg.AggregateParams, eps: float, delta: float):
    """The host partition-selection strategy for one configuration."""
    return partition_selection.create_partition_selection_strategy(
        params.partition_selection_strategy, eps, delta,
        params.max_partitions_contributed, params.pre_threshold)


# ---------------------------------------------------------------------------
# Per-partition analysis (host path): arrays in, flat result tuple out.
# ---------------------------------------------------------------------------


def partition_stats(counts: np.ndarray, sums: np.ndarray,
                    n_partitions: np.ndarray,
                    config_params: Sequence[agg.AggregateParams],
                    metric_list: Sequence[agg.Metric]) -> np.ndarray:
    """Stats matrix [K, n_metrics, STAT_WIDTH] for one partition's rows."""
    k = len(config_params)
    n_metrics = len(metric_list)
    out = np.zeros((k, n_metrics, STAT_WIDTH))
    if len(counts) == 0:
        return out
    l0 = np.array([[p.max_partitions_contributed] for p in config_params],
                  dtype=np.float64)
    q = keep_fraction(np.asarray(n_partitions, dtype=np.float64)[None, :], l0)
    for mi, metric in enumerate(metric_list):
        values = metric_values(metric, np.asarray(counts, dtype=np.float64),
                               np.asarray(sums, dtype=np.float64))
        lo = np.array([[metric_bounds(p, metric)[0]] for p in config_params])
        hi = np.array([[metric_bounds(p, metric)[1]] for p in config_params])
        out[:, mi, :] = metric_stat_terms(values[None, :], lo, hi,
                                          q).sum(axis=-2)
    return out


def stats_to_sum_metrics(stats_row: np.ndarray, metric: agg.Metric,
                         noise_std: float,
                         noise_kind: agg.NoiseKind) -> metrics_dc.SumMetrics:
    """One metric's per-partition SumMetrics from its stats row."""
    return metrics_dc.SumMetrics(
        aggregation=metric,
        sum=float(stats_row[RAW]),
        clipping_to_min_error=float(stats_row[CLIP_MIN]),
        clipping_to_max_error=float(stats_row[CLIP_MAX]),
        expected_l0_bounding_error=float(stats_row[L0_MEAN]),
        std_l0_bounding_error=math.sqrt(max(float(stats_row[L0_VAR]), 0.0)),
        std_noise=noise_std,
        noise_kind=noise_kind)


# ---------------------------------------------------------------------------
# Report finalization: summed report/info rows -> result dataclasses.
# ---------------------------------------------------------------------------


def finalize_value_errors(fields: np.ndarray,
                          total_weight: float) -> metrics_dc.ValueErrors:
    """ValueErrors from 10 accumulated (weighted) fields."""
    scale = 0.0 if total_weight == 0 else 1.0 / total_weight
    (mean, var, rmse, rmse_drop, l1, l1_drop, l0_mean, l0_var, linf_min,
     linf_max) = (float(f) * scale for f in fields)
    return metrics_dc.ValueErrors(
        bounding_errors=metrics_dc.ContributionBoundingErrors(
            l0=metrics_dc.MeanVariance(l0_mean, l0_var),
            linf_min=linf_min,
            linf_max=linf_max),
        mean=mean,
        variance=var,
        rmse=rmse,
        l1=l1,
        rmse_with_dropped_partitions=rmse_drop,
        l1_with_dropped_partitions=l1_drop)


def finalize_metric_utility(report_row: np.ndarray, metric: agg.Metric,
                            noise_std: float, noise_kind: agg.NoiseKind,
                            total_weight: float) -> metrics_dc.MetricUtility:
    """MetricUtility from one metric's accumulated report row."""
    sum_actual = float(report_row[SUM_ACTUAL])
    drop_scale = 1.0 if sum_actual == 0 else 1.0 / sum_actual
    data_dropped = metrics_dc.DataDropInfo(
        l0=float(report_row[DROP_L0]) * drop_scale,
        linf=float(report_row[DROP_LINF]) * drop_scale,
        partition_selection=float(report_row[DROP_PS]) * drop_scale)
    return metrics_dc.MetricUtility(
        metric=metric,
        noise_std=noise_std,
        noise_kind=noise_kind,
        ratio_data_dropped=data_dropped,
        absolute_error=finalize_value_errors(
            report_row[ABS_MEAN:ABS_LINF_MAX + 1], total_weight),
        relative_error=finalize_value_errors(
            report_row[REL_MEAN:REL_LINF_MAX + 1], total_weight))


def finalize_partitions_info(info_row: np.ndarray,
                             public: bool) -> metrics_dc.PartitionsInfo:
    """PartitionsInfo from an accumulated info row."""
    if public:
        return metrics_dc.PartitionsInfo(
            public_partitions=True,
            num_dataset_partitions=int(round(float(info_row[N_DATASET]))),
            num_non_public_partitions=0,
            num_empty_partitions=int(round(float(info_row[N_EMPTY]))))
    return metrics_dc.PartitionsInfo(
        public_partitions=False,
        num_dataset_partitions=int(round(float(info_row[N_DATASET]))),
        kept_partitions=metrics_dc.MeanVariance(float(info_row[KEEP_MEAN]),
                                                float(info_row[KEEP_VAR])))


def finalize_utility_report(
        report_rows: np.ndarray, info_row: np.ndarray,
        metric_list: Sequence[agg.Metric], noise_stds: Sequence[float],
        noise_kind: agg.NoiseKind, public: bool,
        configuration_index: int = -1) -> metrics_dc.UtilityReport:
    """UtilityReport from accumulated [n_metrics, REPORT_WIDTH] + info rows."""
    total_weight = float(info_row[WEIGHT])
    metric_errors = None
    if len(metric_list):
        metric_errors = [
            finalize_metric_utility(report_rows[mi], metric, noise_stds[mi],
                                    noise_kind, total_weight)
            for mi, metric in enumerate(metric_list)
        ]
    return metrics_dc.UtilityReport(
        configuration_index=configuration_index,
        partitions_info=finalize_partitions_info(info_row, public),
        metric_errors=metric_errors)
