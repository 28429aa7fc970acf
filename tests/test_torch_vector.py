"""VECTOR_SUM on the port (C3's vector entry, C9 vector_release, C6 on
[P, D] columns) against the JAX package on the CPU, in float64.

Bounds stated here:
  * dense vector sums: bit-identical on integer-valued float64 data; on
    other data the port sums a partition's rows directly where JAX takes
    cumsum differences: within 1e-12 of the coordinate's sum of
    magnitudes.
  * released vectors (clip + noise): within 1e-12 relative (max(1, |x|)),
    the noise words' ulp bound of test_torch_threefry; the flag word
    identical. Without noise the L1 and L-inf clips are bit-identical to
    _clip_rows_to_norm_ball; the L2 clip within 4 ulp, because XLA on the
    CPU contracts the norm's x * x into its sum with fused multiply-adds
    for some widths (D = 2, 3) and not others (D = 5, 8), while the port
    sums x * x in order without contraction.
  * DPEngine.aggregate against TPUBackend with the same noise_seed: the
    same partitions, values within 1e-9 relative; at epsilon = 1e6 the
    expectations of tests/test_dp_engine.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import combiners as jax_combiners
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu import numeric as jax_numeric
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.ops import threefry

pytestmark = pytest.mark.torch_port

F64 = torch.float64
DIM = 3
N_PARTITIONS = 9


def jax_config(norm_kind=pdp.NormKind.L2, noise=pdp.NoiseKind.LAPLACE,
               bounds_enforced=False, max_norm=6.0):
    params = pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT, pdp.Metrics.VECTOR_SUM],
        noise_kind=noise, max_partitions_contributed=2,
        max_contributions_per_partition=1 if bounds_enforced else 2,
        vector_size=DIM, vector_max_norm=max_norm, vector_norm_kind=norm_kind,
        contribution_bounds_already_enforced=bounds_enforced)
    acc = pdp.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
    compound = jax_combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    cfg = jax_executor.make_kernel_config(params, compound, N_PARTITIONS,
                                          False, None)
    return params, cfg, jax_executor.compute_noise_stds(compound, params)


def make_rows(seed: int, integer_values: bool, n_rows: int = 600):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 60, n_rows).astype(np.int32)
    pk = rng.integers(0, N_PARTITIONS, n_rows).astype(np.int32)
    pk[rng.random(n_rows) < 0.1] = -1
    values = (rng.integers(-3, 5, (n_rows, DIM)).astype(np.float64)
              if integer_values else rng.normal(0.5, 2.0, (n_rows, DIM)))
    return pid, pk, values, pk >= 0


@pytest.mark.parametrize("bounds_enforced", [False, True],
                         ids=["bounded", "bounds_enforced"])
@pytest.mark.parametrize("integer_values", [True, False],
                         ids=["integers", "floats"])
def test_vector_sums_match_jax(bounds_enforced, integer_values):
    params, jcfg, _ = jax_config(bounds_enforced=bounds_enforced)
    cfg = convert.kernel_config(dataclasses.asdict(jcfg))
    assert not cfg.clip_per_value and not cfg.clip_pair_sum
    pid, pk, values, valid = make_rows(4, integer_values)
    key = np.array([8, 15], np.uint32)
    scal = jax_executor.kernel_scalars(params)
    jcols, _ = jax_executor.partial_columns(
        jnp.asarray(pid), jnp.asarray(pk), jnp.asarray(values),
        jnp.asarray(valid), *scal, jax.random.split(key, 2)[0], jcfg)
    key2, pair_start, tcols, rows = executor.bounded_row_columns(
        *convert.row_tensors(pid, pk, values, valid, "cpu", F64), *scal,
        threefry.split(key, 2)[0], cfg)
    assert tcols == {}
    got, _ = executor.reduce_rows_to_partitions(key2, pair_start, tcols,
                                                N_PARTITIONS, F64, rows)
    want = np.asarray(jcols["vsum"])
    assert got["vsum"].shape == (N_PARTITIONS, DIM)
    if integer_values:
        np.testing.assert_array_equal(got["vsum"].numpy(), want)
    else:
        scale = np.zeros_like(want)
        kept = (key2 < N_PARTITIONS).numpy()
        sorted_vals = kernels.sorted_rows(torch.arange(len(kept)),
                                          *rows).numpy()
        np.add.at(scale, key2.numpy()[kept], np.abs(sorted_vals[kept]))
        assert np.all(np.abs(got["vsum"].numpy() - want) <=
                      1e-12 * np.maximum(1.0, scale))
    for col in ("count", "pid_count"):
        np.testing.assert_array_equal(got[col].numpy(),
                                      np.asarray(jcols[col]))


def dense_vectors(seed: int):
    rng = np.random.default_rng(seed)
    vsum = rng.normal(0.0, 8.0, (N_PARTITIONS, DIM))
    vsum[0] = 0.0  # a zero vector: the norm's where(norm > 0) branch
    vsum[1] = [1e-3, -2e-3, 0.0]  # inside every ball
    count = rng.integers(0, 50, N_PARTITIONS).astype(np.float64)
    return {"count": count, "pid_count": count, "row_count": count,
            "vsum": vsum}


@pytest.mark.parametrize("norm_kind", [pdp.NormKind.L1, pdp.NormKind.L2,
                                       pdp.NormKind.Linf])
@pytest.mark.parametrize("noise", [pdp.NoiseKind.LAPLACE,
                                   pdp.NoiseKind.GAUSSIAN])
def test_vector_release_matches_jax_finalize(norm_kind, noise):
    params, jcfg, stds = jax_config(norm_kind, noise)
    cfg = convert.kernel_config(dataclasses.asdict(jcfg))
    cols = dense_vectors(6)
    key = np.array([1, 2024], np.uint32)
    jout, jkeep, _ = jax_executor.finalize(
        {k: jnp.asarray(v) for k, v in cols.items()}, 0.0, 0.0,
        jnp.asarray(stds), key, jcfg)
    tout, tkeep, flags = executor.finalize(
        {k: torch.as_tensor(v) for k, v in cols.items()}, 0.0, 0.0,
        convert.noise_stds(stds), convert.threefry_key(key), cfg)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert sorted(tout) == sorted(jout) == ["count", "vector_sum"]
    for name in jout:
        want = np.asarray(jout[name])
        got = tout[name].numpy()
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <=
                      1e-12 * np.maximum(1.0, np.abs(want))), name
    assert int(flags[0]) == int(jax_numeric._flags_from_mask(jout, jkeep))


@pytest.mark.parametrize("norm_kind", ["l1", "l2", "linf"])
def test_vector_clipping_is_jax_norm_ball(norm_kind):
    # Noise-free (std 0): C9's plain version is _clip_rows_to_norm_ball,
    # zero vectors included.
    vsum = dense_vectors(7)["vsum"]
    want = np.asarray(jax_executor._clip_rows_to_norm_ball(
        jnp.asarray(vsum), 5.0, pdp.NormKind(norm_kind)))
    flags = torch.zeros(1, dtype=torch.int32)
    got = kernels.vector_release(
        torch.as_tensor(vsum), torch.ones(N_PARTITIONS, dtype=torch.bool),
        flags, max_norm=5.0, norm_kind=norm_kind, std=0.0,
        key=np.array([0, 1], np.uint32), gaussian=True)
    if norm_kind == "l2":
        np.testing.assert_allclose(got.numpy(), want, rtol=4 * 2.0**-52,
                                   atol=0.0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got[0].numpy() == 0.0)
    assert int(flags[0]) == 0


def test_vector_release_flags_kept_rows_only():
    # An unbounded L-inf ball keeps Inf; NaN passes any clip.
    vsum = torch.tensor([[1.0, float("inf")], [float("nan"), 0.0]],
                        dtype=F64)
    for keep, want in (([False, False], 0), ([True, False], 2),
                       ([False, True], 1), ([True, True], 3)):
        flags = torch.zeros(1, dtype=torch.int32)
        kernels.vector_release(vsum, torch.tensor(keep), flags,
                               max_norm=float("inf"), norm_kind="linf",
                               std=1.0, key=np.array([0, 1], np.uint32),
                               gaussian=False)
        assert int(flags[0]) == want


def test_compaction_of_vector_columns_matches_jax():
    rng = np.random.default_rng(3)
    keep = rng.random(N_PARTITIONS) < 0.5
    cols = {"count": rng.normal(size=N_PARTITIONS),
            "vector_sum": rng.normal(size=(N_PARTITIONS, DIM))}
    n_kept, order, out = kernels.compact_kept(
        torch.as_tensor(keep), {k: torch.as_tensor(v) for k, v in
                                cols.items()})
    j_kept, j_order, j_out = jax_executor.compact_release(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(keep))
    assert int(n_kept) == int(j_kept)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    for name in cols:
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(j_out[name]))


def release(mod, rows, metrics, public=None, eps=1e6, delta=1e-5, seed=42,
            **params):
    backend = (pdp.TPUBackend(noise_seed=seed) if mod is pdp else
               tdp.TorchBackend(device="cpu", noise_seed=seed, dtype=F64))
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = mod.DPEngine(acc, backend)
    for field, enum in (("noise_kind", "NoiseKind"),
                        ("vector_norm_kind", "NormKind")):
        if field in params:
            params[field] = getattr(mod, enum)[params[field]]
    report = mod.ExplainComputationReport()
    result = engine.aggregate(
        rows, mod.AggregateParams(metrics=metrics(mod.Metrics), **params),
        mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                           partition_extractor=lambda r: r[1],
                           value_extractor=lambda r: r[2]), public,
        out_explain_computation_report=report)
    acc.compute_budgets()
    return dict(result), report.text()


def assert_same_release(rows, metrics, **kw):
    want, want_report = release(pdp, rows, metrics, **kw)
    got, got_report = release(tdp, rows, metrics, **kw)
    assert want and set(got) == set(want)
    for key, values in want.items():
        assert got[key]._fields == values._fields
        for a, b in zip(got[key], values):
            assert np.shape(a) == np.shape(b)
            assert np.all(np.abs(np.asarray(a) - b) <=
                          1e-9 * np.maximum(1.0, np.abs(b))), (key, a, b)
    assert got_report == want_report
    return got


VECTOR = dict(max_partitions_contributed=1, max_contributions_per_partition=1)


def test_vector_sum():
    # tests/test_dp_engine.py::test_vector_sum.
    rows = [("u1", "A", np.array([1.0, 2.0])),
            ("u2", "A", np.array([3.0, 4.0]))]
    got = assert_same_release(rows, lambda M: [M.VECTOR_SUM], public=["A"],
                              vector_norm_kind="Linf", vector_max_norm=10.0,
                              vector_size=2, **VECTOR)
    assert isinstance(got["A"].vector_sum, np.ndarray)
    assert got["A"].vector_sum.dtype == np.float64
    np.testing.assert_allclose(got["A"].vector_sum, [4.0, 6.0], atol=0.1)


@pytest.mark.parametrize("norm_kind,expected", [
    ("Linf", [2.0, -2.0]),
    ("L1", [5.0 * 4 / 10, -5.0 * 6 / 10]),
    ("L2", [5.0 * 4 / math.sqrt(52), -5.0 * 6 / math.sqrt(52)]),
])
def test_vector_sum_norm_clipping(norm_kind, expected):
    # tests/test_dp_engine.py::test_vector_sum_norm_clipping: the
    # partition's vector [4, -6] is projected onto each ball.
    rows = [("u1", "A", np.array([1.0, -2.0])),
            ("u2", "A", np.array([3.0, -4.0]))]
    got = assert_same_release(
        rows, lambda M: [M.VECTOR_SUM], public=["A"],
        vector_norm_kind=norm_kind,
        vector_max_norm=2.0 if norm_kind == "Linf" else 5.0, vector_size=2,
        **VECTOR)
    np.testing.assert_allclose(got["A"].vector_sum, expected, atol=0.1)


def test_vector_sum_with_count_and_private_selection():
    rows = [(f"u{i}", "big", np.array([1.0, 2.0, 3.0])) for i in range(1000)]
    rows += [("lonely", "small", np.array([1.0, 1.0, 1.0]))]
    got = assert_same_release(
        rows, lambda M: [M.VECTOR_SUM, M.COUNT], vector_norm_kind="Linf",
        vector_max_norm=5000.0, vector_size=3, **VECTOR)
    assert "small" not in got
    np.testing.assert_allclose(got["big"].vector_sum, [1000.0, 2000.0,
                                                       3000.0], rtol=1e-3)
    assert got["big"].count == pytest.approx(1000, abs=0.1)


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_vector_sum_shape_mismatch(mod):
    with pytest.raises(TypeError, match="Shape mismatch"):
        release(mod, [("u1", "A", np.array([1.0, 2.0, 3.0]))],
                lambda M: [M.VECTOR_SUM], public=["A"],
                vector_norm_kind="Linf", vector_max_norm=10.0,
                vector_size=2, **VECTOR)


def random_vector_rows(seed: int, n: int = 1500):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 150, n)
    parts = (rng.integers(0, 16, n)**2) // 16
    return [(int(u), f"p{int(p)}", rng.normal(0.3, 1.5, DIM))
            for u, p in zip(users, parts)]


@pytest.mark.parametrize("norm_kind", ["L1", "L2", "Linf"])
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("public", [True, False], ids=["public", "private"])
def test_noisy_release_matches_tpu_backend(norm_kind, noise, public):
    rows = random_vector_rows(8)
    got = assert_same_release(
        rows, lambda M: [M.PRIVACY_ID_COUNT, M.VECTOR_SUM, M.COUNT],
        public=[f"p{i}" for i in range(20)] if public else None, eps=3.0,
        delta=1e-6, noise_kind=noise, vector_norm_kind=norm_kind,
        vector_max_norm=12.0, vector_size=DIM,
        max_partitions_contributed=3, max_contributions_per_partition=2)
    if not public:
        assert 0 < len(got) < len({r[1] for r in rows})
