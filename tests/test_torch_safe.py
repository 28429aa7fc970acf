"""numeric_mode="safe" on the port against the JAX package on the CPU, in
float32: JAX runs with jax_enable_x64 off for each test's duration (the
f32_compute discipline of tests/test_numeric_armor.py), the port with
TorchBackend(dtype=torch.float32).

Bounds stated here:
  * the plain compensated sums (segment_ops.compensated_cumsum,
    compensated_segment_diff): bit-identical to the JAX package's; the
    port's scan combines in jax.lax.associative_scan's order.
  * C3's compensated entry (its plain version) on integer-valued float32
    columns: every partition sum equals float32(exact int64 sum), the
    JAX package's safe-mode columns bit for bit; the fast entry misses on
    the same rows.
  * DPEngine.aggregate at epsilon 1e7 (noise far below half a float32 ulp
    of the sums): released sums equal float32(exact sum) and lie within 1
    float32 ulp of TPUBackend(numeric_mode="safe"), vector sums included.
  * the sentinel: safe mode raises NumericOverflowError on Inf and
    saturation, fast mode ReleaseIntegrityError on Inf only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu import numeric as jax_numeric
from pipelinedp_tpu.ops import segment_ops as jax_segment_ops
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch import numeric
from pipelinedp_tpu_torch.ops import segment_ops

pytestmark = pytest.mark.torch_port

F32 = torch.float32
F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture
def f32_compute():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def cliff_column():
    """2^24 then ones: a float32 prefix sum stalls at 2^24."""
    return np.concatenate([[2.0**24], np.ones(300)]).astype(np.float32)


def big_integer_column(seed, n=3000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 60000, n).astype(np.float32)


@pytest.mark.parametrize("column", ["cliff", "random"])
def test_compensated_cumsum_and_diff_equal_jax(f32_compute, column):
    x = cliff_column() if column == "cliff" else big_integer_column(1)
    hi, lo = segment_ops.compensated_cumsum(torch.as_tensor(x))
    jhi, jlo = jax_segment_ops.compensated_cumsum(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    starts = np.array([0, 1, 7, 7, 150, x.size // 2, x.size], np.int32)
    got = segment_ops.compensated_segment_diff(hi, lo,
                                               torch.as_tensor(starts).long())
    want = jax_segment_ops.compensated_segment_diff(jhi, jlo,
                                                    jnp.asarray(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = np.add.reduceat(x.astype(np.int64), starts[:-1])
    exact[np.diff(starts) == 0] = 0
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    # Integer and float64 columns pass through plainly, as in JAX.
    for t in (torch.as_tensor(x).to(torch.float64),
              torch.arange(5, dtype=torch.int32)):
        h, l = segment_ops.compensated_cumsum(t)
        np.testing.assert_array_equal(h.numpy(), np.cumsum(t.numpy()))
        assert not l.any()


def test_compensated_segment_diff_overflow_is_inf(f32_compute):
    # An overflowed prefix: the last segment's sum is Inf, not NaN.
    x = np.array([1.0, 2.0, 3e38, 3e38], np.float32)
    hi, lo = segment_ops.compensated_cumsum(torch.as_tensor(x))
    starts = torch.tensor([0, 2, 4])
    got = segment_ops.compensated_segment_diff(hi, lo, starts).numpy()
    assert got[0] == 3.0 and got[1] == np.inf
    want = np.asarray(jax_segment_ops.compensated_segment_diff(
        *jax_segment_ops.compensated_cumsum(jnp.asarray(x)),
        jnp.asarray(starts.numpy())))
    np.testing.assert_array_equal(got, want)


def partition_rows(seed, n_rows=4000, n_partitions=6):
    """Sorted-free bounded rows: key2, pair_start and integer-valued
    float32 columns whose partition sums pass 2^24."""
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, n_partitions + 1, n_rows).astype(np.int32)
    keep = pk < n_partitions
    cols = {c: np.where(keep, rng.integers(0, 200000, n_rows),
                        0).astype(np.float32)
            for c in ("sum", "nsum", "nsum2")}
    cols["nsum"] -= 30000 * keep  # centred values, mostly positive
    start = keep & (rng.random(n_rows) < 0.6)
    return pk, keep, start, cols


def test_reduce_partitions_compensated_equals_exact_and_jax(f32_compute):
    P = 6
    pk, keep, start, cols = partition_rows(3, n_partitions=P)
    want = jax_executor.reduce_rows_to_partitions(
        jnp.asarray(pk), jnp.asarray(keep), jnp.asarray(start),
        {k: jnp.asarray(v) for k, v in cols.items()}, P, 0,
        numeric_mode="safe")
    key2 = torch.as_tensor(np.where(keep, pk, P).astype(np.int32))
    tcols = {k: torch.as_tensor(v) for k, v in cols.items()}
    got, _ = executor.reduce_rows_to_partitions(
        key2, torch.as_tensor(start), tcols, P, F32, numeric_mode="safe")
    fast, _ = executor.reduce_rows_to_partitions(
        key2, torch.as_tensor(start), tcols, P, F32)
    missed = 0
    for name in ("sum", "nsum", "nsum2"):
        exact = np.zeros(P, np.int64)
        np.add.at(exact, pk[keep], cols[name][keep].astype(np.int64))
        assert np.abs(exact).max() > 2**24  # past the float32 cliff
        np.testing.assert_array_equal(got[name].numpy(),
                                      exact.astype(np.float32))
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        missed += int((fast[name].numpy() != exact.astype(np.float32)).sum())
    assert missed > 0  # the fast entry drops low-order bits here
    for name in ("count", "pid_count"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_vector_sums_compensated_equal_exact(f32_compute):
    P, D = 4, 3
    rng = np.random.default_rng(4)
    n = 3000
    skey2 = np.sort(rng.integers(0, P + 1, n)).astype(np.int32)
    perm = rng.permutation(n)
    vec = rng.integers(0, 200000, (n, D)).astype(np.float32)
    args = (torch.as_tensor(skey2), torch.as_tensor(perm),
            torch.ones(n, dtype=torch.bool), {}, P, F32,
            (None, torch.as_tensor(vec)))
    got = kernels.reduce_partitions(*args, compensated=True)["vsum"]
    fast = kernels.reduce_partitions(*args)["vsum"]
    rows = vec[perm].astype(np.int64)
    exact = np.zeros((P, D), np.int64)
    np.add.at(exact, np.minimum(skey2, P)[skey2 < P], rows[skey2 < P])
    assert exact.max() > 2**24
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    assert (fast.numpy() != exact.astype(np.float32)).any()


def release(mod, rows, metrics, mode, public, eps=1e7, seed=5, **bounds):
    backend = (pdp.TPUBackend(noise_seed=seed, numeric_mode=mode)
               if mod is pdp else
               tdp.TorchBackend(device="cpu", noise_seed=seed, dtype=F32,
                                numeric_mode=mode))
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-5)
    params = mod.AggregateParams(metrics=metrics(mod.Metrics), **bounds)
    result = mod.DPEngine(acc, backend).aggregate(
        rows, params, mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                         partition_extractor=lambda r: r[1],
                                         value_extractor=lambda r: r[2]),
        public)
    acc.compute_budgets()
    return dict(result)


def ulp32(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.spacing(x).astype(np.float64)


def test_safe_release_sums_are_exact_past_the_cliff(f32_compute):
    # One row per user: every row is kept, so the released sums are the
    # exact group-by sums plus noise far below half an ulp.
    rng = np.random.default_rng(9)
    n = 3000
    values = rng.integers(0, 60000, n).astype(np.float64)
    parts = rng.integers(0, 5, n)
    rows = [(i, int(p), float(v)) for i, (p, v) in enumerate(zip(parts,
                                                                 values))]
    exact = np.bincount(parts, weights=values, minlength=5)
    assert exact.min() > 2**24
    bounds = dict(max_partitions_contributed=1,
                  max_contributions_per_partition=1, min_value=0.0,
                  max_value=60000.0)
    metrics = lambda M: [M.SUM, M.COUNT]  # noqa: E731
    got = release(tdp, rows, metrics, "safe", list(range(5)), **bounds)
    jax_safe = release(pdp, rows, metrics, "safe", list(range(5)), **bounds)
    fast = release(tdp, rows, metrics, "fast", list(range(5)), **bounds)
    sums = np.array([got[p].sum for p in range(5)])
    np.testing.assert_array_equal(sums, exact.astype(np.float32))
    jsums = np.array([jax_safe[p].sum for p in range(5)])
    assert np.all(np.abs(sums - jsums) <= ulp32(exact))
    fsums = np.array([fast[p].sum for p in range(5)])
    assert (fsums != exact.astype(np.float32)).any()


def test_safe_vector_sums_are_exact_past_the_cliff(f32_compute):
    rng = np.random.default_rng(10)
    n = 2500
    vecs = rng.integers(0, 150000, (n, 3)).astype(np.float64)
    parts = rng.integers(0, 4, n)
    rows = [(i, int(p), v) for i, (p, v) in enumerate(zip(parts, vecs))]
    exact = np.zeros((4, 3))
    np.add.at(exact, parts, vecs)
    assert exact.min() > 2**24
    bounds = dict(max_partitions_contributed=1,
                  max_contributions_per_partition=1, vector_size=3,
                  vector_max_norm=1e12, vector_norm_kind=pdp.NormKind.Linf)
    metrics = lambda M: [M.VECTOR_SUM]  # noqa: E731
    got = release(tdp, rows, metrics, "safe", list(range(4)), **bounds)
    jax_safe = release(pdp, rows, metrics, "safe", list(range(4)), **bounds)
    fast = release(tdp, rows, metrics, "fast", list(range(4)), **bounds)
    sums = np.stack([got[p].vector_sum for p in range(4)])
    np.testing.assert_array_equal(sums, exact.astype(np.float32))
    jsums = np.stack([jax_safe[p].vector_sum for p in range(4)])
    assert np.all(np.abs(sums - jsums) <= ulp32(exact))
    fsums = np.stack([fast[p].vector_sum for p in range(4)])
    assert (fsums != exact.astype(np.float32)).any()


OVERFLOW = dict(max_partitions_contributed=1,
                max_contributions_per_partition=1, min_value=0.0,
                max_value=F32_MAX)


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_safe_mode_overflow_raises_numeric_overflow(f32_compute, mod):
    # tests/test_numeric_armor.py::TestExtremeInputs: the f32 sum overflows.
    rows = [("u1", "A", 3e38), ("u2", "A", 3e38), ("u3", "A", 3e38)]
    metrics = lambda M: [M.SUM]  # noqa: E731
    err = jax_numeric.NumericOverflowError if mod is pdp else \
        numeric.NumericOverflowError
    with pytest.raises(err, match="Inf"):
        release(mod, rows, metrics, "safe", ["A"], eps=1e6, **OVERFLOW)
    # Fast mode refuses Inf too, but not as an overflow.
    integrity = jax_numeric.ReleaseIntegrityError if mod is pdp else \
        numeric.ReleaseIntegrityError
    with pytest.raises(integrity) as info:
        release(mod, rows, metrics, "fast", ["A"], eps=1e6, **OVERFLOW)
    assert not isinstance(info.value, err)


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_safe_mode_saturation_raises_fast_mode_is_advisory(f32_compute,
                                                            mod):
    # A finite sum at 2e38 >= finfo(float32).max / 2: saturation.
    rows = [("u1", "A", 1e38), ("u2", "A", 1e38)]
    metrics = lambda M: [M.SUM]  # noqa: E731
    err = jax_numeric.NumericOverflowError if mod is pdp else \
        numeric.NumericOverflowError
    with pytest.raises(err, match="saturation"):
        release(mod, rows, metrics, "safe", ["A"], eps=1e6, **OVERFLOW)
    out = release(mod, rows, metrics, "fast", ["A"], eps=1e6, **OVERFLOW)
    assert np.isfinite(out["A"].sum) and out["A"].sum >= F32_MAX / 2


def test_check_release_classifies_as_jax():
    for flags in range(8):
        for mode in ("fast", "safe"):
            outcome = []
            for check in (
                    lambda: numeric.check_release(flags, ["sum"],
                                                  numeric_mode=mode),
                    lambda: jax_numeric.check_release(
                        {"sum": jnp.asarray(
                            [[0.0, np.nan][flags & 1],
                             [0.0, np.inf][flags >> 1 & 1],
                             [0.0, 3e38][flags >> 2 & 1]],
                            dtype=jnp.float32)},
                        keep=jnp.ones(3, bool), numeric_mode=mode)):
                try:
                    check()
                    outcome.append(None)
                except jax_numeric.NumericOverflowError:
                    outcome.append("overflow")
                except numeric.NumericOverflowError:
                    outcome.append("overflow")
                except (jax_numeric.ReleaseIntegrityError,
                        numeric.ReleaseIntegrityError):
                    outcome.append("integrity")
            assert outcome[0] == outcome[1], (flags, mode, outcome)


@pytest.mark.parametrize("kwargs", [
    dict(numeric_mode="exact"), dict(numeric_mode=None),
    dict(snap_grid_bits=1.5), dict(snap_grid_bits=True),
    dict(snap_grid_bits=65), dict(snap_grid_bits="3")])
def test_bad_knobs_raise_the_jax_messages(kwargs):
    with pytest.raises(ValueError) as want:
        pdp.TPUBackend(**kwargs)
    with pytest.raises(ValueError) as got:
        tdp.TorchBackend(device="cpu", **kwargs)
    assert str(got.value) == str(want.value).replace("TPUBackend",
                                                     "TorchBackend")
