"""secure_noise=True on the port against the JAX package on the CPU, in
float64 (the JAX tests run with x64).

Bounds stated here:
  * tables (build_tables): identical arrays.
  * the table search (lex_search): identical indices.
  * snapped columns (COUNT, PRIVACY_ID_COUNT, SUM, the MEAN / VARIANCE
    entries' noised count, nsum and nsum2, vector coordinates, quantile
    node counts): bit-identical on integer-valued data. The port sums a
    partition directly where JAX differences cumsums, which is exact on
    integer values, and then both snap the same column with the same
    words and table.
  * values derived from snapped columns (MEAN, VARIANCE, percentiles):
    within 1e-9 relative (max(1, |x|)), the engine bound of the port's
    other tests; XLA on the CPU may contract the formulas into fused
    multiply-adds.
  * real-valued data: the unsnapped columns of the two packages differ by
    rounding (1e-12 of the column's magnitude), so a snapped value is
    equal, or exactly one grid step away where the unsnapped column lies
    within 1e-9 relative of a half-grid point (where rounding to the grid
    can go either way).
  * every released COUNT, PRIVACY_ID_COUNT, SUM and vector coordinate is
    an integer multiple of its slot's grid.
  * the discrete mechanisms of dp_computations: bit-identical draws for
    the same key.
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
from pipelinedp_tpu import dp_computations as jax_dp
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu.ops import secure_noise as jax_secure
from pipelinedp_tpu_torch import columnar
from pipelinedp_tpu_torch import combiners
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import dp_computations
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.aggregate_params import NoiseKind
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.ops import secure_noise
from pipelinedp_tpu_torch.ops import threefry

pytestmark = pytest.mark.torch_port

F64 = torch.float64
KINDS = [(NoiseKind.LAPLACE, pdp.NoiseKind.LAPLACE),
         (NoiseKind.GAUSSIAN, pdp.NoiseKind.GAUSSIAN)]


# --- tables and the search ------------------------------------------------


@pytest.mark.parametrize("kinds", KINDS, ids=["laplace", "gaussian"])
@pytest.mark.parametrize("sens,grid_floor", [
    (None, None), ([2.0, 6.0, 1.0, 40.0], None),
    ([2.0, 6.0, 1.0, 40.0], 2.0**3), ([2.0, 6.0, 1.0, 40.0], 2.0**-9)])
def test_build_tables_equal_jax(kinds, sens, grid_floor):
    stds = [0.7, 12.5, 0.0, 310.0]
    got = secure_noise.build_tables(stds, kinds[0], sensitivities=sens,
                                    grid_floor=grid_floor)
    want = jax_secure.build_tables(stds, kinds[1], sensitivities=sens,
                                   grid_floor=grid_floor)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # std = 0: the identity table (every atom 0) on grid 1.
    assert got[2][2] == 1.0
    packed = secure_noise.pack_tables(got[0], got[1])
    hi, lo = secure_noise.unpack(torch.as_tensor(packed))
    np.testing.assert_array_equal(hi.numpy(), got[0])
    np.testing.assert_array_equal(lo.numpy(), got[1])


def test_lex_search_equals_jax_on_random_words_and_every_threshold():
    thr_hi, thr_lo, _ = jax_secure.build_table(3.0, pdp.NoiseKind.GAUSSIAN)
    thr = (thr_hi.astype(np.uint64) << np.uint64(32)) | thr_lo
    rng = np.random.default_rng(0)
    words = [rng.integers(0, 2**64, 20000, dtype=np.uint64, endpoint=False)]
    for delta in (-1, 0, 1):
        # Every threshold +- 1 (wrapping at the ends of the u64 range).
        words.append(thr + np.uint64(delta % 2**64))
    words.append(np.array([0, 2**64 - 1], dtype=np.uint64))
    u = np.concatenate(words)
    uhi = (u >> np.uint64(32)).astype(np.uint32)
    ulo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = np.asarray(jax_secure._lex_search(
        jnp.asarray(thr_hi), jnp.asarray(thr_lo), jnp.asarray(uhi),
        jnp.asarray(ulo)))
    t = lambda a: torch.as_tensor(a.astype(np.int64))  # noqa: E731
    got = secure_noise.lex_search(t(thr_hi), t(thr_lo), t(uhi), t(ulo))
    np.testing.assert_array_equal(got.numpy(), want)
    # The inverse CDF: thr[i-1] <= u < thr[i] for the index found (u =
    # 2^64 - 1 takes the last atom, whose threshold it equals).
    idx = got.numpy()
    assert np.all((u < thr[idx]) | (idx == thr.size - 1))
    assert np.all((idx == 0) | (thr[idx - 1] <= u))


@pytest.mark.parametrize("kinds", KINDS, ids=["laplace", "gaussian"])
def test_sample_discrete_and_snapped_noisy_equal_jax(kinds):
    hi, lo, gran = jax_secure.build_table(5.0, kinds[1], sensitivity=2.0)
    key = np.array([9, 4], np.uint32)
    want = np.asarray(jax_secure.sample_discrete(
        key, (1000,), jnp.asarray(hi), jnp.asarray(lo)))
    t = lambda a: torch.as_tensor(a.astype(np.int64))  # noqa: E731
    got = secure_noise.sample_discrete(key, 1000, t(hi), t(lo))
    np.testing.assert_array_equal(got.numpy(), want)
    col = np.random.default_rng(1).uniform(-500, 500, (40, 3))
    col[0, :] = [0.5 * gran, 1.5 * gran, -2.5 * gran]  # half-grid ties
    want = np.asarray(jax_secure.snapped_noisy(
        jnp.asarray(col), key, jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(gran)))
    thr = torch.as_tensor(secure_noise.pack_tables(hi, lo))
    got = secure_noise.snapped_noisy(torch.as_tensor(col), key, thr, gran)
    np.testing.assert_array_equal(got.numpy(), want)


# --- the kernels' plain versions (C4, C8, C9 with tables) ------------------


def jax_tables(stds, sens, kind, snap_bits=None):
    hi, lo, gran = jax_secure.build_tables(
        stds, kind, sensitivities=sens,
        grid_floor=None if snap_bits is None else 2.0**snap_bits)
    return (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(gran)), (
        torch.as_tensor(secure_noise.pack_tables(hi, lo)), gran)


def engine_config(metrics, noise, n_partitions, private=False, **bounds):
    """Both packages' KernelConfig (secure), stds and sensitivities."""
    params = pdp.AggregateParams(metrics=metrics, noise_kind=noise, **bounds)
    acc = pdp.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
    compound = jax_combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    jcfg = jax_executor.make_kernel_config(params, compound, n_partitions,
                                           private, None, secure=True)
    stds = jax_executor.compute_noise_stds(compound, params)
    sens = jax_executor.compute_noise_sensitivities(compound, params)
    return params, jcfg, convert.kernel_config(dataclasses.asdict(jcfg)), \
        stds, sens


@pytest.mark.parametrize("kinds", KINDS, ids=["laplace", "gaussian"])
@pytest.mark.parametrize("snap_bits", [None, 2])
def test_finalize_secure_matches_jax(kinds, snap_bits):
    M = pdp.Metrics
    params, jcfg, cfg, stds, sens = engine_config(
        [M.COUNT, M.PRIVACY_ID_COUNT, M.SUM, M.MEAN, M.VARIANCE], kinds[1],
        12, max_partitions_contributed=3, max_contributions_per_partition=2,
        min_value=0.0, max_value=5.0)
    assert cfg.secure
    rng = np.random.default_rng(7)
    count = rng.integers(0, 400, 12).astype(np.float64)
    cols = {"count": count, "pid_count": np.floor(count / 2),
            "sum": rng.integers(0, 2000, 12).astype(np.float64),
            "nsum": rng.integers(-800, 800, 12).astype(np.float64),
            "nsum2": rng.integers(0, 9000, 12).astype(np.float64)}
    cols["row_count"] = cols["pid_count"]
    jt, tt = jax_tables(stds, sens, kinds[1], snap_bits)
    key = np.array([77, 3], np.uint32)
    min_v, _, _, _, mid = jax_executor.kernel_scalars(params)
    jout, _, _ = jax_executor.finalize(
        {k: jnp.asarray(v) for k, v in cols.items()}, min_v, mid,
        jnp.asarray(stds), key, jcfg, jt)
    tout, _, flags = executor.finalize(
        {k: torch.as_tensor(v) for k, v in cols.items()}, min_v, mid,
        convert.noise_stds(stds), key, cfg, tt)
    assert sorted(tout) == sorted(jout)
    for name in ("count", "privacy_id_count"):
        np.testing.assert_array_equal(tout[name].numpy(),
                                      np.asarray(jout[name]))
    for name in ("sum", "mean", "variance"):
        want = np.asarray(jout[name])
        assert np.all(np.abs(tout[name].numpy() - want) <=
                      1e-9 * np.maximum(1.0, np.abs(want)))
    assert int(flags[0]) == 0
    # The snapped slots one by one: the MEAN entry's count and nsum, the
    # VARIANCE entry's count, nsum and nsum2, bit for bit.
    _, key_noise = threefry.split(key, 2)
    slot_keys = executor.slot_keys(key_noise, cfg.plan)
    slot_cols = {"count": ["count"], "privacy_id_count": ["pid_count"],
                 "sum": ["sum"], "mean": ["count", "nsum"],
                 "variance": ["count", "nsum", "nsum2"]}
    col_of = [c for e in cfg.plan for c in slot_cols[e.kind]]
    assert len(col_of) == len(stds) and "nsum2" in col_of
    for slot, name in enumerate(col_of):
        want = jax_secure.snapped_noisy(
            jnp.asarray(cols[name]), slot_keys[slot], jt[0][slot],
            jt[1][slot], jt[2][slot])
        got = secure_noise.snapped_noisy(torch.as_tensor(cols[name]),
                                         slot_keys[slot], tt[0][slot],
                                         tt[1][slot])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert np.all(np.mod(got.numpy(), tt[1][slot]) == 0)


@pytest.mark.parametrize("norm", ["l2", "linf"])
def test_vector_release_secure_matches_jax(norm):
    M = pdp.Metrics
    norm_kind = {"l2": pdp.NormKind.L2, "linf": pdp.NormKind.Linf}[norm]
    params, jcfg, cfg, stds, sens = engine_config(
        [M.VECTOR_SUM, M.COUNT], pdp.NoiseKind.GAUSSIAN, 10,
        max_partitions_contributed=2, max_contributions_per_partition=2,
        vector_size=5, vector_max_norm=300.0, vector_norm_kind=norm_kind)
    rng = np.random.default_rng(3)
    vsum = rng.integers(-200, 200, (10, 5)).astype(np.float64)
    cols = {"count": np.full(10, 4.0), "pid_count": np.full(10, 2.0),
            "vsum": vsum}
    cols["row_count"] = cols["pid_count"]
    jt, tt = jax_tables(stds, sens, pdp.NoiseKind.GAUSSIAN)
    key = np.array([5, 8], np.uint32)
    jout, _, _ = jax_executor.finalize(
        {k: jnp.asarray(v) for k, v in cols.items()}, 0.0, 0.0,
        jnp.asarray(stds), key, jcfg, jt)
    tout, _, _ = executor.finalize(
        {k: torch.as_tensor(v) for k, v in cols.items()}, 0.0, 0.0,
        convert.noise_stds(stds), key, cfg, tt)
    got = tout["vector_sum"].numpy()
    np.testing.assert_array_equal(got, np.asarray(jout["vector_sum"]))
    assert np.all(np.mod(got, tt[1][0]) == 0)


def quantile_setup(n_partitions, noise):
    M = pdp.Metrics
    return engine_config(
        [M.PERCENTILE(90), M.PERCENTILE(10), M.PERCENTILE(50), M.COUNT],
        noise, n_partitions, max_partitions_contributed=3,
        max_contributions_per_partition=2, min_value=0.0, max_value=6.0)


@pytest.mark.parametrize("kinds", KINDS, ids=["laplace", "gaussian"])
def test_dense_quantile_nodes_secure_match_jax(kinds):
    # The dense regime's noisy levels: node j of level l snapped and
    # noised with the words of split(fold_in(fold_in(qkey, 0), l - 1)) at
    # counter p * B^l + j, bit for bit; the descents end at the same
    # leaves and percentiles.
    P = 9
    params, jcfg, cfg, stds, sens = quantile_setup(P, kinds[1])
    # A tree of height 2 (256 leaves) keeps the full levels small.
    jcfg = dataclasses.replace(jcfg, tree_height=2)
    cfg = dataclasses.replace(cfg, tree_height=2)
    B, h = cfg.branching, cfg.tree_height
    jt, tt = jax_tables(stds, sens, kinds[1])
    qidx = executor.quantile_std_index(cfg.plan)
    rng = np.random.default_rng(11)
    leaf = torch.as_tensor(rng.integers(0, 3, (P, B**h)).astype(np.int32))
    levels = kernels.quantile_level_counts_plain(leaf, tree_height=h,
                                                 branching=B)
    qkey = np.array([21, 4], np.uint32)
    ckey = threefry.fold_in(qkey, 0)
    level_keys = np.stack([threefry.fold_in(ckey, l) for l in range(h)])
    for l, counts in enumerate(levels):
        want = jax_secure.snapped_noisy(
            jnp.asarray(counts.numpy().astype(np.float64)),
            jax.random.fold_in(jax.random.fold_in(qkey, 0), l),
            jt[0][qidx], jt[1][qidx], jt[2][qidx])
        counter = torch.arange(counts.numel()).reshape(counts.shape)
        got = secure_noise.snapped_release(
            counts.to(F64), *secure_noise.split_words(level_keys[l], counter),
            tt[0][qidx], tt[1][qidx])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keep = torch.ones(P, dtype=torch.bool)
    flags = torch.zeros(1, dtype=torch.int32)
    leaves = torch.empty(P, 3, dtype=torch.int32)
    got = kernels.quantile_descend_dense(
        levels, cfg.quantiles, std=float(stds[qidx]), level_keys=level_keys,
        gaussian=kinds[0] == NoiseKind.GAUSSIAN, min_v=0.0, max_v=6.0,
        keep=keep, flags=flags, dtype=F64, leaves=leaves,
        tables=(tt[0][qidx], float(tt[1][qidx])))
    # JAX's dense regime on the same histogram (quantile_outputs, :877-905).
    hist = jnp.asarray(leaf.numpy())
    jcounts = [hist]
    for lev in range(h - 1, 0, -1):
        jcounts.append(jcounts[-1].reshape(P, B**lev, B).sum(axis=-1))
    jcounts.reverse()
    noisy = [jax_secure.snapped_noisy(
        jcounts[l].astype(jnp.float64),
        jax.random.fold_in(jax.random.fold_in(qkey, 0), l), jt[0][qidx],
        jt[1][qidx], jt[2][qidx]) for l in range(h)]
    want = np.asarray(jax_executor._descend_quantiles(noisy, 0.0, 6.0, jcfg))
    np.testing.assert_allclose(got.numpy().T, want, rtol=1e-9, atol=1e-9)


# --- DPEngine.aggregate -------------------------------------------------------


def release(mod, rows, metrics, public, noise, seed=42, eps=3.0, bits=None,
            dtype=F64, **bounds):
    if mod is pdp:
        backend = pdp.TPUBackend(noise_seed=seed, secure_noise=True,
                                 snap_grid_bits=bits)
    else:
        backend = tdp.TorchBackend(device="cpu", noise_seed=seed,
                                   dtype=dtype, secure_noise=True,
                                   snap_grid_bits=bits)
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    params = mod.AggregateParams(metrics=metrics(mod.Metrics),
                                 noise_kind=getattr(mod.NoiseKind, noise),
                                 **bounds)
    result = mod.DPEngine(acc, backend).aggregate(
        rows, params, mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                         partition_extractor=lambda r: r[1],
                                         value_extractor=lambda r: r[2]),
        public)
    acc.compute_budgets()
    return dict(result)


EXACT = ("count", "privacy_id_count", "sum", "vector_sum")


def assert_same_secure_release(rows, metrics, public, noise, **kw):
    want = release(pdp, rows, metrics, public, noise, **kw)
    got = release(tdp, rows, metrics, public, noise, **kw)
    assert want and set(got) == set(want)
    for key, values in want.items():
        assert got[key]._fields == values._fields
        for name, a, b in zip(values._fields, got[key], values):
            if name in EXACT:
                np.testing.assert_array_equal(a, b)
            else:
                assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, name)
    return got


def int_rows(seed, n=900, n_partitions=10, n_users=200):
    rng = np.random.default_rng(seed)
    return [(int(u), int(p), float(v)) for u, p, v in zip(
        rng.integers(0, n_users, n), rng.integers(0, n_partitions, n),
        rng.integers(0, 6, n))]


SCALARS = {
    "count_pid_sum": lambda M: [M.COUNT, M.PRIVACY_ID_COUNT, M.SUM],
    "mean_variance": lambda M: [M.MEAN, M.VARIANCE, M.COUNT, M.SUM],
    "dense_percentiles": lambda M: [M.PERCENTILE(50), M.COUNT,
                                    M.PERCENTILE(10)],
}


@pytest.mark.parametrize("metrics", sorted(SCALARS))
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("public", [True, False], ids=["public", "private"])
def test_secure_release_matches_tpu_backend(metrics, noise, public):
    rows = int_rows(1, n=2500, n_users=500)
    got = assert_same_secure_release(
        rows, SCALARS[metrics], list(range(10)) if public else None, noise,
        eps=4.0, max_partitions_contributed=3,
        max_contributions_per_partition=2, min_value=0.0, max_value=5.0)
    assert len(got) >= 5


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_snap_grid_bits_release_matches_tpu_backend_on_its_grid(noise):
    rows = int_rows(2)
    bounds = dict(max_partitions_contributed=3,
                  max_contributions_per_partition=2, min_value=0.0,
                  max_value=5.0)
    got = assert_same_secure_release(
        rows, SCALARS["count_pid_sum"], list(range(10)), noise, bits=3,
        **bounds)
    for values in got.values():
        for v in values:
            assert v % 8.0 == 0.0  # the grid is floored at 2**3


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("public", [True, False], ids=["public", "private"])
def test_lazy_percentiles_secure_match_tpu_backend(noise, public):
    # 600 partitions: the lazy regime (more than 512).
    rng = np.random.default_rng(4)
    rows = [(int(u), int(p), float(v)) for u, p, v in zip(
        rng.integers(0, 700, 4000), rng.integers(0, 600, 4000),
        rng.integers(1, 6, 4000))]
    assert len({p for _, p, _ in rows}) > 512
    got = assert_same_secure_release(
        rows, lambda M: [M.COUNT, M.PERCENTILE(75), M.PERCENTILE(25)],
        list(range(600)) if public else None, noise,
        eps=3.0 if public else 300.0, max_partitions_contributed=3,
        max_contributions_per_partition=2, min_value=0.0, max_value=6.0)
    assert 400 < len(got) <= 600


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_vector_sum_secure_matches_tpu_backend(noise):
    rng = np.random.default_rng(6)
    rows = [(int(u), int(p), rng.integers(-3, 4, 5).astype(np.float64))
            for u, p in zip(rng.integers(0, 150, 700),
                            rng.integers(0, 6, 700))]
    got = assert_same_secure_release(
        rows, lambda M: [M.VECTOR_SUM, M.COUNT], list(range(6)), noise,
        max_partitions_contributed=2, max_contributions_per_partition=2,
        vector_size=5, vector_max_norm=12.0,
        vector_norm_kind=pdp.NormKind.Linf)
    assert len(got) == 6


def port_grids(rows, metrics, noise, **bounds):
    """The port's per-slot grids for a release (the tables' gran)."""
    params = tdp.AggregateParams(metrics=metrics(tdp.Metrics),
                                 noise_kind=getattr(tdp.NoiseKind, noise),
                                 **bounds)
    acc = tdp.NaiveBudgetAccountant(total_epsilon=3.0, total_delta=1e-6)
    compound = combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    _, _, gran = secure_noise.build_tables(
        executor.compute_noise_stds(compound), params.noise_kind,
        sensitivities=executor.compute_noise_sensitivities(compound, params))
    return params, compound, gran


def test_real_valued_release_is_equal_or_one_grid_step_apart():
    # Real values: the two packages' unsnapped SUM columns differ by
    # rounding. Rule: equal, or exactly one grid step apart where the
    # port's unsnapped sum lies within 1e-9 relative of a half-grid point.
    rng = np.random.default_rng(8)
    rows = [(int(u), int(p), float(v)) for u, p, v in zip(
        rng.integers(0, 300, 1500), rng.integers(0, 12, 1500),
        rng.uniform(0.0, 5.0, 1500))]
    metrics = lambda M: [M.SUM, M.COUNT]  # noqa: E731
    bounds = dict(max_partitions_contributed=3,
                  max_contributions_per_partition=2, min_value=0.0,
                  max_value=5.0)
    public = list(range(12))
    want = release(pdp, rows, metrics, public, "LAPLACE", **bounds)
    got = release(tdp, rows, metrics, public, "LAPLACE", **bounds)
    params, compound, gran = port_grids(rows, metrics, "LAPLACE", **bounds)
    # The port's unsnapped partition sums, by its own kernels and keys.
    encoded = columnar.encode(rows, tdp.DataExtractors(
        privacy_id_extractor=lambda r: r[0],
        partition_extractor=lambda r: r[1], value_extractor=lambda r: r[2]),
        public)
    cfg = executor.make_kernel_config(params, compound, len(public), False,
                                      None, secure=True)
    rows_key, _ = threefry.split(noise_ops.make_noise_key(42), 2)
    key2, start, cols, _ = executor.bounded_row_columns(
        *executor.to_device(encoded, "cpu", F64),
        *executor.kernel_scalars(params), rows_key, cfg)
    dense, _ = executor.reduce_rows_to_partitions(key2, start, cols,
                                                  len(public), F64)
    g = gran[0]
    for i, pkey in enumerate(encoded.partition_vocab):
        a, b = got[pkey].sum, want[pkey].sum
        assert a % g == 0 and b % g == 0
        if a != b:
            assert abs(a - b) == g, (pkey, a, b)
            x = float(dense["sum"][i]) / g
            assert abs(abs(x - math.floor(x)) - 0.5) <= 1e-9 * max(1, abs(x))
        assert got[pkey].count == want[pkey].count


# --- the discrete mechanisms ---------------------------------------------------


def test_discrete_mechanisms_draw_as_jax():
    key = np.array([12, 34], np.uint32)
    for n, draw in ((3, 0), (1, 5)):
        np.testing.assert_array_equal(
            dp_computations._threefry_uniforms(key, n, draw),
            jax_dp._threefry_uniforms(key, n, draw))
    pairs = [
        (dp_computations.GeometricMechanism(0.7, 3.0, key=key),
         jax_dp.GeometricMechanism(0.7, 3.0, key=key)),
        (dp_computations.SnappedLaplaceMechanism(1.3, 2.0, key=key),
         jax_dp.SnappedLaplaceMechanism(1.3, 2.0, key=key)),
        (dp_computations.SnappedLaplaceMechanism(1.3, 2.0, snap_grid_bits=-2,
                                                 key=key),
         jax_dp.SnappedLaplaceMechanism(1.3, 2.0, snap_grid_bits=-2,
                                        key=key)),
        (dp_computations.SnappedGaussianMechanism(0.9, 1e-6, 3.0, key=key),
         jax_dp.SnappedGaussianMechanism(0.9, 1e-6, 3.0, key=key)),
        (dp_computations.SnappedGaussianMechanism.create_from_std_deviation(
            2.5, 3.0, key=key),
         jax_dp.SnappedGaussianMechanism.create_from_std_deviation(
             2.5, 3.0, key=key)),
    ]
    for ours, theirs in pairs:
        assert ours.std == theirs.std and ours.grid == theirs.grid
        assert ours.sensitivity == theirs.sensitivity
        assert ours.describe() == theirs.describe()
        for value in (0.0, 10.0, -3.3, 1e6):
            a, b = ours.add_noise(value), theirs.add_noise(value)
            assert a == b and a % ours.grid == 0


@pytest.mark.parametrize("spec_kind,integer", [
    (pdp.MechanismType.LAPLACE, True), (pdp.MechanismType.LAPLACE, False),
    (pdp.MechanismType.GAUSSIAN, False)])
def test_create_discrete_mechanism_matches_jax(spec_kind, integer):
    from pipelinedp_tpu import budget_accounting as jax_budget
    from pipelinedp_tpu_torch import budget_accounting
    from pipelinedp_tpu_torch.aggregate_params import MechanismType
    key = np.array([1, 2], np.uint32)
    ours_spec = budget_accounting.MechanismSpec(
        MechanismType[spec_kind.name])
    ours_spec.set_eps_delta(0.8, 1e-6)
    theirs_spec = jax_budget.MechanismSpec(spec_kind)
    theirs_spec.set_eps_delta(0.8, 1e-6)
    ours = dp_computations.create_discrete_mechanism(
        ours_spec, dp_computations.Sensitivities(l0=2, linf=1.5),
        value_is_integer=integer, snap_grid_bits=-3, key=key)
    theirs = jax_dp.create_discrete_mechanism(
        theirs_spec, jax_dp.Sensitivities(l0=2, linf=1.5),
        value_is_integer=integer, snap_grid_bits=-3, key=key)
    assert type(ours).__name__ == type(theirs).__name__
    assert [ours.add_noise(7.0) for _ in range(4)] == \
        [theirs.add_noise(7.0) for _ in range(4)]
