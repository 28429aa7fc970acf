"""The plain versions of the port's kernels against the JAX package's
jitted programs, on the CPU, in float64 (the JAX tests run with x64).

Each test feeds both packages the same state through
pipelinedp_tpu_torch.convert. Bounds stated here:
  * pair hash, keep_row, pair_start, spk, keep mask, counts: bit-identical.
  * bounded row columns and dense partition columns on integer-valued
    float64 values: bit-identical (both sides are exact there). On
    non-integer values the port sums a pair or a partition directly where
    JAX takes cumsum differences: within 1e-12 of the column's sum of
    magnitudes.
  * finalize outputs: within 1e-12 relative (max(1, |x|)), the log1p /
    erf_inv ulp bound of test_torch_threefry carried through the metric
    formulas.
  * the release sentinel's flag word: identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
from pipelinedp_tpu import combiners as jax_combiners
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu import numeric as jax_numeric
from pipelinedp_tpu.ops import selection_ops as jax_selection
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch import numeric
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry

pytestmark = pytest.mark.torch_port

F64 = torch.float64
N_ROWS = 512
N_PARTITIONS = 12


def make_rows(seed: int, integer_values: bool):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 40, N_ROWS).astype(np.int32)
    pk = rng.integers(0, N_PARTITIONS, N_ROWS).astype(np.int32)
    pk[rng.random(N_ROWS) < 0.1] = -1  # rows outside the partitions
    values = (rng.integers(-2, 8, N_ROWS).astype(np.float64)
              if integer_values else rng.uniform(-2.0, 7.5, N_ROWS))
    return pid, pk, values, pk >= 0


PARAMS = {
    "clip_values": dict(metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM,
                                 pdp.Metrics.VARIANCE],
                        max_partitions_contributed=3,
                        max_contributions_per_partition=2, min_value=0.0,
                        max_value=5.0),
    "clip_pair_sums": dict(metrics=[pdp.Metrics.SUM,
                                    pdp.Metrics.PRIVACY_ID_COUNT],
                           max_partitions_contributed=2,
                           max_contributions_per_partition=3,
                           min_sum_per_partition=-1.0,
                           max_sum_per_partition=6.0),
    "bounds_enforced": dict(metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM],
                            max_partitions_contributed=1,
                            max_contributions_per_partition=2,
                            min_sum_per_partition=0.0,
                            max_sum_per_partition=4.0,
                            contribution_bounds_already_enforced=True),
}


def jax_config(name, private=False, noise=pdp.NoiseKind.LAPLACE,
               strategy=pdp.PartitionSelectionStrategy.TRUNCATED_GEOMETRIC):
    """The JAX package's KernelConfig and stds for PARAMS[name]."""
    params = pdp.AggregateParams(noise_kind=noise,
                                 partition_selection_strategy=strategy,
                                 **PARAMS[name])
    acc = pdp.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
    compound = jax_combiners.create_compound_combiner(params, acc)
    budget = acc.request_budget(pdp.MechanismType.GENERIC) if private \
        else None
    acc.compute_budgets()
    selection = (jax_selection.selection_params_from_host(
        strategy, budget.eps, budget.delta,
        params.max_partitions_contributed, None) if private else None)
    cfg = jax_executor.make_kernel_config(params, compound, N_PARTITIONS,
                                          private, selection)
    return params, cfg, jax_executor.compute_noise_stds(compound, params)


def scalars(params):
    return jax_executor.kernel_scalars(params)


def run_bounding(name, integer_values, seed=3):
    params, jcfg, _ = jax_config(name)
    cfg = convert.kernel_config(dataclasses.asdict(jcfg))
    pid, pk, values, valid = make_rows(seed, integer_values)
    key = np.array([0, 1234 + seed], np.uint32)
    rows_key = threefry.split(key, 2)[0]
    j_rows_key = jax.random.split(key, 2)[0]
    spk, keep, pair_start, jcols, _ = jax_executor.bounded_row_columns(
        jnp.asarray(pid), jnp.asarray(pk), jnp.asarray(values),
        jnp.asarray(valid), *scalars(params), j_rows_key, jcfg)
    tensors = convert.row_tensors(pid, pk, values, valid, "cpu", F64)
    key2, t_start, tcols, _ = executor.bounded_row_columns(
        *tensors, *scalars(params), convert.threefry_key(rows_key), cfg)
    return (params, jcfg, cfg, (np.asarray(spk), np.asarray(keep),
                                np.asarray(pair_start), jcols),
            (key2, t_start, tcols))


def assert_columns_match(got: torch.Tensor, want, exact: bool, where=None):
    got = got.numpy()
    want = np.asarray(want)
    if where is not None:
        got, want = got[where], want[where]
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).sum()))
        assert np.abs(got - want).max() <= 1e-12 * scale


def test_pair_hash_is_bit_identical():
    rng = np.random.default_rng(0)
    pid = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    pk = rng.integers(0, 2**20, 4096).astype(np.int32)
    key = np.array([5, 99], np.uint32)
    want0, want1 = jax_executor._pair_hash(jnp.asarray(pid), jnp.asarray(pk),
                                           key)
    got0, got1 = kernels.pair_hash(torch.as_tensor(pid).long(),
                                   torch.as_tensor(pk).long(),
                                   threefry.bits(key, 4))
    np.testing.assert_array_equal(got0.numpy(), np.asarray(want0))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("integer_values", [True, False],
                         ids=["integers", "floats"])
def test_bounded_row_columns_match_jax(name, integer_values):
    _, _, cfg, (spk, keep, pair_start, jcols), (key2, t_start, tcols) = \
        run_bounding(name, integer_values)
    t_keep = (key2 < cfg.n_partitions).numpy()
    np.testing.assert_array_equal(t_keep, keep)
    if not cfg.bounds_enforced:
        # The bounds bite: some valid rows are dropped.
        assert 0 < keep.sum() < (make_rows(3, integer_values)[1] >= 0).sum()
    np.testing.assert_array_equal(t_start.numpy(), pair_start)
    np.testing.assert_array_equal(key2.numpy()[keep], spk[keep])
    assert sorted(tcols) == sorted(jcols)
    exact = integer_values or name != "clip_pair_sums"
    for col in jcols:
        # Rows outside the kept set never reach a partition; JAX leaves
        # clip(0) there in the enforced-bounds regime, the port 0.
        assert_columns_match(tcols[col], jcols[col], exact, where=keep)


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("integer_values", [True, False],
                         ids=["integers", "floats"])
def test_reduce_rows_to_partitions_matches_jax(name, integer_values):
    _, jcfg, cfg, (spk, keep, pair_start, jcols), (key2, t_start, tcols) = \
        run_bounding(name, integer_values, seed=11)
    want = jax_executor.reduce_rows_to_partitions(
        jnp.asarray(spk), jnp.asarray(keep), jnp.asarray(pair_start), jcols,
        N_PARTITIONS, 0)
    got, _ = executor.reduce_rows_to_partitions(key2, t_start, tcols,
                                                N_PARTITIONS, F64)
    for col in ("count", "pid_count", "row_count"):
        np.testing.assert_array_equal(got[col].numpy(), np.asarray(want[col]))
    for col in jcols:
        assert_columns_match(got[col], want[col], integer_values)


def dense_columns(seed: int):
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 400, N_PARTITIONS).astype(np.float64)
    count[:3] = [0.0, 1.0, 2.0]
    cols = {"count": count, "pid_count": np.floor(count / 2),
            "sum": rng.uniform(-50, 900, N_PARTITIONS),
            "nsum": rng.uniform(-90, 90, N_PARTITIONS),
            "nsum2": rng.uniform(0, 3000, N_PARTITIONS)}
    cols["row_count"] = cols["pid_count"]
    return cols


FINALIZE_CASES = [
    ("clip_values", False, pdp.NoiseKind.LAPLACE, None),
    ("clip_values", False, pdp.NoiseKind.GAUSSIAN, None),
    ("clip_pair_sums", True, pdp.NoiseKind.LAPLACE,
     pdp.PartitionSelectionStrategy.TRUNCATED_GEOMETRIC),
    ("clip_pair_sums", True, pdp.NoiseKind.GAUSSIAN,
     pdp.PartitionSelectionStrategy.LAPLACE_THRESHOLDING),
    ("clip_values", True, pdp.NoiseKind.GAUSSIAN,
     pdp.PartitionSelectionStrategy.GAUSSIAN_THRESHOLDING),
]


@pytest.mark.parametrize("name,private,noise,strategy", FINALIZE_CASES)
def test_finalize_matches_jax(name, private, noise, strategy):
    kwargs = {} if strategy is None else {"strategy": strategy}
    params, jcfg, stds = jax_config(name, private, noise, **kwargs)
    cfg = convert.kernel_config(dataclasses.asdict(jcfg))
    cols = dense_columns(5)
    key = np.array([77, 3], np.uint32)
    min_v, _, _, _, mid = scalars(params)
    jout, jkeep, _ = jax_executor.finalize(
        {k: jnp.asarray(v) for k, v in cols.items()}, min_v, mid,
        jnp.asarray(stds), key, jcfg)
    tout, tkeep, flags = executor.finalize(
        {k: torch.as_tensor(v) for k, v in cols.items()}, min_v, mid,
        convert.noise_stds(stds), convert.threefry_key(key), cfg)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if private:
        assert 0 < int(tkeep.sum()) < N_PARTITIONS
    assert sorted(tout) == sorted(jout)
    for name_ in jout:
        want = np.asarray(jout[name_])
        got = tout[name_].numpy()
        assert np.all(np.abs(got - want) <=
                      1e-12 * np.maximum(1.0, np.abs(want)))
    assert int(flags[0]) == 0


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_keep_probabilities_match_jax(kind):
    strategy = list(pdp.PartitionSelectionStrategy)[kind]
    jparams = jax_selection.selection_params_from_host(strategy, 1.5, 1e-5,
                                                       3, 2)
    tparams = convert.selection_params(dataclasses.asdict(jparams))
    assert tparams == selection_ops.selection_params_from_host(
        getattr(selection_ops.PartitionSelectionStrategy, strategy.name),
        1.5, 1e-5, 3, 2)
    counts = np.arange(0, 200)
    want = np.asarray(jax_selection.keep_probabilities(jnp.asarray(counts),
                                                        jparams))
    got = selection_ops.keep_probabilities(torch.as_tensor(counts), tparams,
                                           F64).numpy()
    assert np.all(np.abs(got - want) <= 1e-13 * np.maximum(1e-300, want)
                  + 1e-300)


def sentinel_columns():
    base = np.linspace(-3.0, 3.0, 8)
    big = float(np.finfo(np.float64).max) / 2
    return {
        "clean": base.copy(),
        "nan": np.where(np.arange(8) == 5, np.nan, base),
        "inf": np.where(np.arange(8) == 1, -np.inf, base),
        "sat": np.where(np.arange(8) == 2, big, base),
    }


@pytest.mark.parametrize("n_kept", [0, 1, 2, 3, 6, 8])
@pytest.mark.parametrize("subset", [("clean",), ("nan",), ("inf", "sat"),
                                    ("clean", "nan", "inf", "sat")])
def test_flags_from_kept_match_jax(n_kept, subset):
    cols = {k: v for k, v in sentinel_columns().items() if k in subset}
    want = int(jax_numeric._flags_from_kept(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(n_kept)))
    got = numeric.flags_from_kept(
        {k: torch.as_tensor(v) for k, v in cols.items()}, n_kept)
    assert got == want


def test_release_epilogue_flags_poisoned_partition():
    # A NaN in a kept partition's column trips the flag word the release
    # kernel's plain version returns, exactly as the sentinel would.
    params, jcfg, stds = jax_config("clip_values")
    cfg = convert.kernel_config(dataclasses.asdict(jcfg))
    cols = {k: torch.as_tensor(v) for k, v in dense_columns(2).items()}
    cols["count"][4] = float("inf")
    cols["nsum"][7] = float("nan")
    outputs, keep, flags = executor.finalize(cols, 0.0, 2.5,
                                             convert.noise_stds(stds),
                                             np.array([1, 2], np.uint32),
                                             cfg)
    want = int(jax_numeric._flags_from_kept(
        {k: jnp.asarray(v.numpy()) for k, v in outputs.items()},
        jnp.asarray(N_PARTITIONS)))
    assert int(flags[0]) == want == numeric.FLAG_NAN | numeric.FLAG_INF
    with pytest.raises(numeric.ReleaseIntegrityError):
        numeric.check_release(int(flags[0]), outputs)
