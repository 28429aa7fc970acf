"""PERCENTILE on the port (C7 quantile_counts, C8 quantile_descend) against
the JAX package on the CPU, in float64 (the JAX tests run with x64).

Both packages get the same rows, config and keys (through
pipelinedp_tpu_torch.convert). Bounds stated here:
  * leaf histogram, level roll-ups, lazy child counts: identical integers.
  * percentiles from the same noisy trees: within 1e-9 relative
    (max(1, |x|)). A leaf is 1/65,536 of the range wide, so this also
    says every partition descends to the same leaf: the port sums the
    children and their prefixes from 0, left to right, as XLA does on the
    CPU.
  * DPEngine.aggregate on TorchBackend(device="cpu", dtype=float64)
    against TPUBackend with the same noise_seed: the same partitions,
    values within 1e-9 relative; at epsilon = 1e6 near the true
    percentiles, as tests/test_dp_engine.py checks the JAX package.
"""

import dataclasses

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
MIN_V, MAX_V = -1.0, 9.0
PERCENTILES = (90, 10, 50, 37.5)  # unsorted: the cummax order matters


def make_rows(seed: int, n_rows: int, n_partitions: int):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_rows // 6, n_rows).astype(np.int32)
    pk = rng.integers(0, n_partitions, n_rows).astype(np.int32)
    pk[rng.random(n_rows) < 0.05] = -1  # rows outside the partitions
    # Ratings-like integers, a continuous range and values off the tree's
    # range (below, above, far above): every branch of the leaf index.
    values = np.where(rng.random(n_rows) < 0.5,
                      rng.integers(1, 6, n_rows).astype(np.float64),
                      rng.uniform(MIN_V, MAX_V, n_rows))
    values[rng.random(n_rows) < 0.03] = -7.0
    values[rng.random(n_rows) < 0.03] = 12.0
    values[rng.random(n_rows) < 0.01] = 1e300
    return pid, pk, values, pk >= 0


def jax_config(n_partitions: int, noise=pdp.NoiseKind.LAPLACE, eps=2.0):
    params = pdp.AggregateParams(
        metrics=[pdp.Metrics.PERCENTILE(p) for p in PERCENTILES] +
        [pdp.Metrics.COUNT], noise_kind=noise, max_partitions_contributed=3,
        max_contributions_per_partition=2, min_value=MIN_V, max_value=MAX_V)
    acc = pdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    compound = jax_combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    cfg = jax_executor.make_kernel_config(params, compound, n_partitions,
                                          False, None)
    return params, cfg, jax_executor.compute_noise_stds(compound, params)


def bounded_rows(seed: int, n_rows: int, n_partitions: int, noise):
    """The bounded rows of both packages: JAX's qrows (spk, leaf, keep)
    and the port's partition-sorted order and value rows."""
    params, jcfg, stds = jax_config(n_partitions, noise)
    cfg = convert.kernel_config(dataclasses.asdict(jcfg))
    pid, pk, values, valid = make_rows(seed, n_rows, n_partitions)
    key = np.array([3, 1000 + seed], np.uint32)
    scal = jax_executor.kernel_scalars(params)
    _, _, _, _, qrows = jax_executor.bounded_row_columns(
        jnp.asarray(pid), jnp.asarray(pk), jnp.asarray(values),
        jnp.asarray(valid), *scal, jax.random.split(key, 2)[0], jcfg)
    key2, pair_start, cols, rows = executor.bounded_row_columns(
        *convert.row_tensors(pid, pk, values, valid, "cpu", F64), *scal,
        threefry.split(key, 2)[0], cfg)
    _, sorted_rows = executor.reduce_rows_to_partitions(
        key2, pair_start, cols, n_partitions, F64)
    return cfg, jcfg, stds, [np.asarray(a) for a in qrows], sorted_rows, rows


def jax_leaf_hist(qrows, n_partitions, n_leaves):
    """The dense chunk's leaf histogram (executor.py:859-867)."""
    row_pk, row_leaf, row_keep = (jnp.asarray(a) for a in qrows)
    in_chunk = row_keep & (row_pk >= 0) & (row_pk < n_partitions)
    idx = jnp.where(in_chunk, row_pk * n_leaves + row_leaf,
                    n_partitions * n_leaves)
    hist = jax.ops.segment_sum(in_chunk.astype(jnp.int32), idx,
                               num_segments=n_partitions * n_leaves + 1)
    return np.asarray(hist[:-1]).reshape(n_partitions, n_leaves)


def jax_child_counts(qrows, parent, level, cfg):
    """The lazy descent's child counts of one level (executor.py:796-806)."""
    row_pk, row_leaf, row_keep = (jnp.asarray(a) for a in qrows)
    B, h, P = cfg.branching, cfg.tree_height, cfg.n_partitions
    row_node = (row_leaf // B**(h - level)).astype(jnp.int32)
    par = jnp.asarray(parent)[jnp.minimum(row_pk, P - 1)]
    in_path = row_keep & (row_node // B == par) & (row_pk < P)
    seg = jnp.where(in_path, row_pk * B + (row_node % B), P * B)
    counts = jax.ops.segment_sum(in_path.astype(jnp.int32), seg,
                                 num_segments=P * B + 1)[:P * B]
    return np.asarray(counts).reshape(P, B)


def test_leaf_histogram_and_roll_ups_equal_jax():
    P = 5
    cfg, _, _, qrows, (perm, skey2), (row_perm, values) = bounded_rows(
        1, 3000, P, pdp.NoiseKind.LAPLACE)
    L = cfg.branching**cfg.tree_height
    hist = kernels.quantile_leaf_counts(skey2, perm, row_perm, values,
                                        n_partitions=P, n_leaves=L,
                                        min_v=MIN_V, max_v=MAX_V)
    want = jax_leaf_hist(qrows, P, L)
    np.testing.assert_array_equal(hist.numpy(), want)
    assert hist[:, 0].sum() > 0 and hist[:, -1].sum() > 0  # clipped leaves
    levels = kernels.quantile_level_counts(hist, tree_height=cfg.tree_height,
                                           branching=cfg.branching)
    # The JAX package's roll-ups (executor.py:877-880).
    counts = [jnp.asarray(want)]
    for level in range(cfg.tree_height - 1, 0, -1):
        counts.append(counts[-1].reshape(P, cfg.branching**level,
                                         cfg.branching).sum(axis=-1))
    for got, exp in zip(levels, counts[::-1]):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_lazy_child_counts_equal_jax_per_quantile_passes():
    P = 40
    cfg, _, _, qrows, (perm, skey2), (row_perm, values) = bounded_rows(
        2, 4000, P, pdp.NoiseKind.LAPLACE)
    rng = np.random.default_rng(0)
    n_q = len(cfg.quantiles)
    B = cfg.branching
    node = np.zeros((P, n_q), np.int32)
    hist = jax_leaf_hist(qrows, P, B**cfg.tree_height)
    for level in range(1, cfg.tree_height + 1):
        got = kernels.quantile_child_counts(
            skey2, perm, row_perm, values, torch.as_tensor(node),
            level=level, tree_height=cfg.tree_height, branching=B,
            min_v=MIN_V, max_v=MAX_V)
        assert got.shape == (P, n_q, B)
        for q in range(n_q):
            np.testing.assert_array_equal(
                got[:, q].numpy(), jax_child_counts(qrows, node[:, q],
                                                    level, cfg))
        # Descend to a populated child where there is one, so the next
        # level's counts are not all zero.
        for p in range(P):
            for q in range(n_q):
                c = got[p, q].numpy()
                pick = (rng.choice(np.flatnonzero(c)) if c.any() else
                        rng.integers(B))
                node[p, q] = node[p, q] * B + pick
    assert hist.sum() > 0


@pytest.mark.parametrize("noise", [pdp.NoiseKind.LAPLACE,
                                   pdp.NoiseKind.GAUSSIAN])
@pytest.mark.parametrize("n_partitions", [6, 600], ids=["dense", "lazy"])
def test_descent_matches_jax_quantile_outputs(noise, n_partitions):
    cfg, jcfg, stds, qrows, sorted_rows, rows = bounded_rows(
        3, 6000, n_partitions, noise)
    lazy = -(-n_partitions // cfg.quantile_chunk) > 1
    assert lazy == (n_partitions > 512)
    qkey = np.array([11, 22], np.uint32)
    want = jax_executor.quantile_outputs(
        tuple(jnp.asarray(a) for a in qrows), MIN_V, MAX_V,
        jnp.asarray(stds), qkey, jcfg)
    keep = torch.rand(n_partitions, generator=torch.Generator().manual_seed(
        1)) < 0.7
    flags = torch.zeros(1, dtype=torch.int32)
    got = executor.quantile_outputs(sorted_rows, rows, MIN_V, MAX_V,
                                    convert.noise_stds(stds), qkey, keep,
                                    flags, cfg, F64)
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        g = got[name].numpy()
        assert np.all(np.abs(g - w) <= 1e-9 * np.maximum(1.0, np.abs(w))), \
            name
        assert np.all((g >= MIN_V) & (g <= MAX_V))
    names = sorted(want, key=lambda n: float(n.split("_", 1)[1]
                                             .replace("_", ".")))
    for lo, hi in zip(names, names[1:]):  # monotone in the quantile
        assert torch.all(got[lo] <= got[hi])
    assert int(flags[0]) == int(jax_numeric._flags_from_mask(
        want, jnp.asarray(keep.numpy())))


def test_descent_flags_nan_of_kept_partitions_only():
    # A NaN noise std poisons every node: the sentinel sees it only where
    # the partition is kept.
    P, n_q = 3, 2
    levels = [torch.zeros(P, 4**l, dtype=torch.int32) for l in (1, 2)]
    keys = np.stack([threefry.fold_in(np.array([0, 1], np.uint32), l)
                     for l in range(2)])
    for kept, want in ((False, 0), (True, 1)):
        flags = torch.zeros(1, dtype=torch.int32)
        keep = torch.tensor([False, kept, False])
        out = kernels.quantile_descend_dense(
            levels, (0.5, 0.9), std=float("nan"), level_keys=keys,
            gaussian=True, min_v=0.0, max_v=1.0, keep=keep, flags=flags,
            dtype=F64)
        assert out.shape == (n_q, P)
        assert int(flags[0]) == want


def release(mod, rows, metrics, public=None, eps=1e6, delta=1e-5, seed=42,
            **params):
    backend = (pdp.TPUBackend(noise_seed=seed) if mod is pdp else
               tdp.TorchBackend(device="cpu", noise_seed=seed, dtype=F64))
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = mod.DPEngine(acc, backend)
    if "noise_kind" in params:
        params["noise_kind"] = getattr(mod.NoiseKind, params["noise_kind"])
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
            assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)
    assert got_report == want_report
    return got


PARITY_ROWS = [("u%d" % i, "pk%d" % (i % 3), float(i % 100))
               for i in range(600)]


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_percentile_parity(noise):
    # tests/test_dp_engine.py::test_percentile_parity.
    got = assert_same_release(
        PARITY_ROWS,
        lambda M: [M.PERCENTILE(10), M.PERCENTILE(50), M.PERCENTILE(90)],
        public=["pk0", "pk1", "pk2"], noise_kind=noise,
        max_partitions_contributed=1, max_contributions_per_partition=1,
        min_value=0.0, max_value=100.0)
    for r in got.values():
        assert r.percentile_10 == pytest.approx(10.0, abs=2.0)
        assert r.percentile_50 == pytest.approx(50.0, abs=2.0)
        assert r.percentile_90 == pytest.approx(90.0, abs=2.0)


def test_percentile_with_sum_and_private_selection():
    # tests/test_dp_engine.py::test_percentile_with_sum_and_private_...
    rows = [("u%d" % i, "big", float(i % 10)) for i in range(1000)]
    rows += [("lonely", "small", 3.0)]
    got = assert_same_release(
        rows, lambda M: [M.PERCENTILE(50), M.SUM],
        max_partitions_contributed=1, max_contributions_per_partition=1,
        min_value=0.0, max_value=10.0)
    assert "small" not in got
    assert got["big"].percentile_50 == pytest.approx(4.5, abs=1.0)
    assert got["big"].sum == pytest.approx(4500.0, abs=1.0)


def test_many_percentiles_with_scalar_metrics():
    # 49 percentiles beside COUNT, SUM and PRIVACY_ID_COUNT: 52 output
    # columns, more than C6 scatters at once; C8 reads any number of
    # quantiles. The JAX package serves this request, and so does the port.
    got = assert_same_release(
        PARITY_ROWS,
        lambda M: [M.COUNT, M.SUM, M.PRIVACY_ID_COUNT] +
        [M.PERCENTILE(p) for p in range(2, 100, 2)],
        public=["pk0", "pk1", "pk2"], max_partitions_contributed=1,
        max_contributions_per_partition=1, min_value=0.0, max_value=100.0)
    for r in got.values():
        assert len(r) == 52
        values = [getattr(r, f"percentile_{p}") for p in range(2, 100, 2)]
        assert values == sorted(values)


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_percentile_degenerate_range_raises(mod):
    with pytest.raises(ValueError, match="max_value must be > min_value"):
        release(mod, [("u1", "A", 1.0)], lambda M: [M.PERCENTILE(50)],
                public=["A"], max_partitions_contributed=1,
                max_contributions_per_partition=1, min_value=1.0,
                max_value=1.0)


def wide_rows(seed: int, n: int = 6000, n_partitions: int = 700):
    rng = np.random.default_rng(seed)
    return [(int(u), f"p{int(p)}", float(v)) for u, p, v in zip(
        rng.integers(0, 900, n), rng.integers(0, n_partitions, n),
        rng.integers(1, 6, n))]


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("public", [True, False], ids=["public", "private"])
def test_noisy_release_matches_tpu_backend(noise, public):
    # 700 partitions: the lazy regime (more than 512), with COUNT and
    # MEAN beside the percentiles so the quantile entry's slot sits
    # between others in the key tree.
    rows = wide_rows(5)
    metrics = lambda M: [M.COUNT, M.PERCENTILE(75), M.MEAN,  # noqa: E731
                         M.PERCENTILE(25)]
    if public:
        got = assert_same_release(
            rows, metrics, public=[f"p{i}" for i in range(700)], eps=3.0,
            noise_kind=noise, max_partitions_contributed=3,
            max_contributions_per_partition=2, min_value=0.0, max_value=6.0)
        assert len(got) == 700
    else:
        # A large epsilon keeps most partitions of ~9 rows.
        got = assert_same_release(
            rows, metrics, eps=300.0, noise_kind=noise,
            max_partitions_contributed=3, max_contributions_per_partition=2,
            min_value=0.0, max_value=6.0)
        assert 512 < len(got) < 700


def test_huge_epsilon_percentiles_are_order_statistics():
    rows = wide_rows(6, n=4000, n_partitions=8)
    got, _ = release(tdp, rows, lambda M: [M.PERCENTILE(10), M.PERCENTILE(50),
                                           M.PERCENTILE(90)],
                     public=[f"p{i}" for i in range(8)], eps=1e9,
                     max_partitions_contributed=8,
                     max_contributions_per_partition=50, min_value=0.0,
                     max_value=6.0)
    width = 6.0 / 16**4
    for key, r in got.items():
        vals = np.sort([v for _, p, v in rows if p == key])
        n = len(vals)
        for q, value in ((0.1, r.percentile_10), (0.5, r.percentile_50),
                         (0.9, r.percentile_90)):
            lo = vals[max(0, int(np.floor(q * n)) - 1)]
            hi = vals[min(n - 1, int(np.ceil(q * n)))]
            assert lo - width <= value <= hi + width, (key, q, value)
