"""The port's blocked large-P route (pipelinedp_tpu_torch/parallel/large_p.py)
against the JAX package's (pipelinedp_tpu/parallel/large_p.py) on the CPU:
the same numpy-seeded rows and seeds through both, float64 (JAX under x64),
with the partitions per block small and P % block_partitions != 0.

Bounds stated here:
  * host helpers (_block_noise_key, round_capacity, _chunk_ends, and
    kernels.block_window_boundaries) and integer results (C10 offsets, C11 gathers, counts,
    leaf and child counts, kept ids): identical.
  * float sums of C3's windowed entry: within 1e-12 of the partition's
    sum of magnitudes (the port adds in another order than the JAX
    package's cumsum differences); the compensated float32 entry: equal.
  * releases (aggregate_blocked and DPEngine on TorchBackend against
    TPUBackend with the same large_partition_threshold, block_partitions
    and seed): the same kept partitions, values within 1e-9 relative
    (max(1, |x|)), the dense route's bound of test_torch_engine (the
    float64 noise words agree to the ulp bounds of test_torch_threefry);
    secure noise: equal.
"""

import functools

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
from pipelinedp_tpu.aggregate_params import MechanismType as JaxMechanismType
from pipelinedp_tpu.ops import segment_ops as jax_segment_ops
from pipelinedp_tpu.ops import selection_ops as jax_selection_ops
from pipelinedp_tpu.parallel import large_p as jax_large_p
from pipelinedp_tpu.parallel import mesh as jax_mesh
from pipelinedp_tpu_torch import combiners, executor, kernels, numeric
from pipelinedp_tpu_torch.aggregate_params import MechanismType
from pipelinedp_tpu_torch.ops import selection_ops, threefry
from pipelinedp_tpu_torch.parallel import large_p

pytestmark = pytest.mark.torch_port

F64 = torch.float64
THRESHOLD = 16
BLOCK = 8
N_PARTS = 20  # 20 % 8 = 4: the last block is partial


@pytest.fixture
def f32_compute():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def close(got, want, rel=1e-9):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rel * np.maximum(1.0, np.abs(want))), \
        np.max(np.abs(got - want))


# --- host helpers ----------------------------------------------------------


@pytest.mark.parametrize("generation", [0, 1, 2])
def test_block_noise_key_matches_jax(generation):
    final_key = jax.random.split(jax.random.PRNGKey(17))[1]
    for block in (0, 1, 7, 4095):
        want = np.asarray(jax_large_p._block_noise_key(final_key, generation,
                                                       block))
        got = large_p._block_noise_key(np.asarray(final_key), generation,
                                       block)
        np.testing.assert_array_equal(got, want)


def test_round_capacity_matches_jax():
    for x in (0, 1, 7, 8, 9, 100, 1000, 12345, 1 << 20, (1 << 20) + 1,
              (1 << 24) - 3):
        assert large_p.round_capacity(x) == jax_mesh.round_capacity(x)


@pytest.mark.parametrize("base,capacity,n_blocks",
                         [(0, 8, 6), (40, 8, 1), (0, 1 << 20, 5),
                          ((1 << 31) - 100, 64, 4)])
def test_block_boundaries_match_jax(base, capacity, n_blocks):
    got = kernels.block_window_boundaries(base, capacity, n_blocks,
                                          np.iinfo(np.int32).max).numpy()
    want = jax_large_p._block_boundaries(base, capacity, n_blocks)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("row_chunk", [1, 7, 50, 1000, 5000])
def test_chunk_ends_match_jax(row_chunk):
    rng = np.random.default_rng(row_chunk)
    pid = np.sort(rng.integers(0, 300, 3000)).astype(np.int32)
    pid[1000:1500] = pid[1000]  # one privacy id spanning many rows
    pid = np.sort(pid)
    np.testing.assert_array_equal(large_p._chunk_ends(pid, row_chunk),
                                  jax_large_p._chunk_ends(pid, row_chunk))


# --- plain versions of C10, C11 and the windowed C3 / C7 entries -----------


def sorted_stream(seed, n=3000, P=N_PARTS):
    """A partition-sorted row stream with dropped rows at the sentinel P,
    and a permutation into bounded-row order."""
    rng = np.random.default_rng(seed)
    key2 = rng.integers(0, P + 1, n).astype(np.int32)
    key2[rng.random(n) < 0.2] = P
    perm = np.argsort(key2, kind="stable")
    return key2[perm], perm


def test_block_offsets_plain_matches_searchsorted():
    skey2, _ = sorted_stream(0)
    bounds = kernels.block_window_boundaries(0, BLOCK, 3, N_PARTS).numpy()
    got = kernels.block_offsets(torch.as_tensor(skey2), torch.as_tensor(bounds))
    want = jnp.searchsorted(jnp.asarray(skey2), jnp.asarray(bounds),
                            side="left")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The last offset is the survivor count: the sentinel rows fall in no
    # block, though the unclamped last boundary (24) lies past P.
    assert int(got[-1]) == int((skey2 < N_PARTS).sum())


def test_gather_rows_plain_matches_take():
    rng = np.random.default_rng(1)
    n = 500
    index = rng.integers(0, n, 123)
    columns = [rng.random(n) < 0.5, rng.random(n).astype(np.float32),
               rng.random(n), rng.integers(0, 1 << 40, n),
               rng.random((n, 5))]
    got = kernels.gather_rows(torch.as_tensor(index),
                              [torch.as_tensor(c) for c in columns])
    for g, c in zip(got, columns):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jnp.take(jnp.asarray(c), index, axis=0)))


BASE = BLOCK  # block 1's window in the plain-version tests


def window_case(seed, vector=False):
    """Sorted stream, bounded-row columns and block 1's window, as the
    blocked route's block sees them."""
    rng = np.random.default_rng(seed)
    skey2, perm = sorted_stream(seed)
    n = len(perm)
    pair = rng.random(n) < 0.6
    cols = {"sum": rng.uniform(-5, 5, n), "nsum": rng.uniform(-2, 2, n)}
    cols["nsum2"] = cols["nsum"]**2
    values = rng.uniform(0, 5, (n, 3)) if vector else rng.uniform(0, 5, n)
    row_perm = rng.permutation(n)
    offs = np.searchsorted(skey2, [BASE, BASE + BLOCK])
    return skey2, perm, pair, cols, values, row_perm, int(offs[0]), \
        int(offs[1])


def jax_window_reduce(skey2, perm, pair, cols, lo, hi, base, C,
                      vector_rows=None, numeric_mode="fast"):
    """reduce_rows_to_partitions(presorted=True) of the JAX package on the
    window [lo, hi), rebased as _block_trace rebases it."""
    w = perm[lo:hi]
    rel = jnp.asarray(skey2[lo:hi].astype(np.int64) - base, jnp.int32)
    valid = jnp.ones(hi - lo, bool)
    reduce_cols = {m: jnp.asarray(c[w]) for m, c in cols.items()}
    vsize = 0
    if vector_rows is not None:
        row_perm, values = vector_rows
        vals = values[row_perm[w]]
        vsize = vals.shape[1]
        reduce_cols = {f"v{d}": jnp.asarray(vals[:, d]) for d in range(vsize)}
    return jax_executor.reduce_rows_to_partitions(
        rel, valid, jnp.asarray(pair[w]), reduce_cols, C, vsize,
        presorted=True, numeric_mode=numeric_mode)


@pytest.mark.parametrize("with_perm", [True, False], ids=["perm", "in_order"])
def test_windowed_reduce_matches_presorted_jax(with_perm):
    skey2, perm, pair, cols, _, _, lo, hi = window_case(2)
    t = {m: torch.as_tensor(c) for m, c in cols.items()}
    if with_perm:
        got = kernels.reduce_partitions(
            torch.as_tensor(skey2[lo:hi]), torch.as_tensor(perm[lo:hi]),
            torch.as_tensor(pair), t, BLOCK, F64, base=BASE)
    else:
        w = perm[lo:hi]
        got = kernels.reduce_partitions(
            torch.as_tensor(skey2[lo:hi]), None, torch.as_tensor(pair[w]),
            {m: c[torch.as_tensor(w)] for m, c in t.items()}, BLOCK, F64,
            base=BASE)
    want = jax_window_reduce(skey2, perm, pair, cols, lo, hi, BASE,
                             BLOCK)
    np.testing.assert_array_equal(got["count"].numpy(), want["count"])
    np.testing.assert_array_equal(got["pid_count"].numpy(),
                                  want["pid_count"])
    for m, c in cols.items():
        scale = jax_window_reduce(skey2, perm, pair, {m: np.abs(c)}, lo, hi,
                                  BASE, BLOCK)[m]
        assert np.all(np.abs(got[m].numpy() - np.asarray(want[m])) <=
                      1e-12 * np.asarray(scale))


def test_windowed_vector_reduce_matches_presorted_jax():
    skey2, perm, pair, _, values, row_perm, lo, hi = window_case(3, True)
    got = kernels.reduce_partitions(
        torch.as_tensor(skey2[lo:hi]), torch.as_tensor(perm[lo:hi]),
        torch.as_tensor(pair), {}, BLOCK, F64,
        (torch.as_tensor(row_perm), torch.as_tensor(values)), base=BASE)
    want = jax_window_reduce(skey2, perm, pair, {}, lo, hi, BASE, BLOCK,
                             vector_rows=(row_perm, values))
    close(got["vsum"].numpy(), want["vsum"], rel=1e-12)
    np.testing.assert_array_equal(got["count"].numpy(), want["count"])


def test_windowed_compensated_reduce_matches_jax(f32_compute):
    skey2, perm, pair, _, _, _, lo, hi = window_case(4)
    rng = np.random.default_rng(4)
    big = rng.integers(0, 60000, len(perm)).astype(np.float32) + 2.0**24
    got = kernels.reduce_partitions(
        torch.as_tensor(skey2[lo:hi]), torch.as_tensor(perm[lo:hi]),
        torch.as_tensor(pair), {"sum": torch.as_tensor(big)}, BLOCK,
        torch.float32, compensated=True, base=BASE)
    want = jax_window_reduce(skey2, perm, pair, {"sum": big}, lo, hi,
                             BASE, BLOCK, numeric_mode="safe")
    np.testing.assert_array_equal(got["sum"].numpy(), np.asarray(want["sum"]))
    assert kernels.launch_counts["reduce_partitions_compensated_windowed"] \
        == 0  # the CPU runs the plain version and counts no launch


def test_windowed_quantile_counts_match_jax_leaves():
    skey2, perm, _, _, values, row_perm, lo, hi = window_case(5)
    h, B = 3, 4
    L = B**h
    base = BASE
    leaf_j = np.asarray(jax_executor._leaf_indices(
        jnp.asarray(values), 0.0, 5.0, L))[row_perm[perm[lo:hi]]]
    rel = skey2[lo:hi].astype(np.int64) - base
    inside = (rel >= 0) & (rel < BLOCK)
    want = np.bincount(rel[inside] * L + leaf_j[inside],
                       minlength=BLOCK * L).reshape(BLOCK, L)
    args = (torch.as_tensor(skey2[lo:hi]), torch.as_tensor(perm[lo:hi]),
            torch.as_tensor(row_perm), torch.as_tensor(values))
    got = kernels.quantile_leaf_counts(*args, n_partitions=BLOCK,
                                       n_leaves=L, min_v=0.0, max_v=5.0,
                                       base=base)
    np.testing.assert_array_equal(got.numpy(), want)
    # Child counts of level 2 under each partition's level-1 node.
    node = np.random.default_rng(5).integers(0, B, (BLOCK, 2)).astype(
        np.int32)
    got = kernels.quantile_child_counts(*args, torch.as_tensor(node),
                                        level=2, tree_height=h, branching=B,
                                        min_v=0.0, max_v=5.0, base=base)
    row_node = leaf_j // B**(h - 2)
    want = np.zeros((BLOCK, 2, B), np.int64)
    for p, r in zip(rel[inside], row_node[inside]):
        for q in range(2):
            if node[p, q] == r // B:
                want[p, q, r % B] += 1
    np.testing.assert_array_equal(got.numpy(), want)


# --- aggregate_blocked and select_partitions_blocked -----------------------


def specs(P, private, metrics, eps=2.0, l0=3, linf=2, **extra):
    """(JAX cfg, stds, scalars) and (port cfg, stds, scalars) of one
    aggregation, budgets computed on each package's own accountant."""
    out = []
    for mod, comb, ex, sel_ops, mech in (
            (pdp, jax_combiners, jax_executor, jax_selection_ops,
             JaxMechanismType),
            (tdp, combiners, executor, selection_ops, MechanismType)):
        params = mod.AggregateParams(
            metrics=metrics(mod.Metrics), noise_kind=mod.NoiseKind.LAPLACE,
            max_partitions_contributed=l0,
            max_contributions_per_partition=linf, min_value=0.0,
            max_value=5.0, **extra)
        acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
        compound = comb.create_compound_combiner(params, acc)
        budget = acc.request_budget(mech.GENERIC) if private else None
        acc.compute_budgets()
        selection = (sel_ops.selection_params_from_host(
            params.partition_selection_strategy, budget.eps, budget.delta,
            l0, None) if private else None)
        cfg = ex.make_kernel_config(params, compound, P, private, selection)
        stds = (ex.compute_noise_stds(compound, params) if mod is pdp else
                ex.compute_noise_stds(compound))
        out.append((cfg, np.asarray(stds), ex.kernel_scalars(params)))
    return out


def skewed_partitions(rng, n, P):
    """Partition ids with falling popularity: selection keeps the head and
    drops the tail."""
    return (rng.random(n)**4 * P).astype(np.int32)


def blocked_rows(seed=0, n=3000, n_ids=400, P=N_PARTS):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_ids, n).astype(np.int32),
            skewed_partitions(rng, n, P), rng.uniform(0, 5, n),
            rng.random(n) < 0.95)


@functools.lru_cache(maxsize=None)
def jax_blocked(row_chunk):
    jax_spec, _ = specs(N_PARTS, True, lambda M: [M.COUNT, M.SUM, M.MEAN],
                        eps=3.0)
    cfg, stds, scalars = jax_spec
    return jax_large_p.aggregate_blocked(
        *blocked_rows(), *scalars, stds, jax.random.PRNGKey(5), cfg,
        block_partitions=BLOCK, row_chunk=row_chunk)


@pytest.mark.parametrize("row_chunk", [1 << 24, 700],
                         ids=["device_resident", "host_staged"])
def test_aggregate_blocked_matches_jax(row_chunk):
    _, (cfg, stds, scalars) = specs(N_PARTS, True,
                                    lambda M: [M.COUNT, M.SUM, M.MEAN],
                                    eps=3.0)
    pid = blocked_rows()[0]
    # The host-staged case runs several chunks, each under its own key.
    n_chunks = len(large_p._chunk_ends(np.sort(pid), row_chunk))
    assert (n_chunks > 1) == (row_chunk < len(pid))
    want_ids, want = jax_blocked(row_chunk)
    phase_times = {}
    got_ids, got = large_p.aggregate_blocked(
        *blocked_rows(), *scalars, stds,
        np.asarray(jax.random.PRNGKey(5)), cfg, block_partitions=BLOCK,
        row_chunk=row_chunk, phase_times=phase_times, device="cpu",
        dtype=F64)
    assert got_ids.dtype == np.int64
    assert 0 < len(got_ids) < N_PARTS
    np.testing.assert_array_equal(got_ids, want_ids)
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name])
    assert phase_times["blocks_dispatched"] <= 3
    assert {"p1_bound_compact", "block_offsets", "p2_blocks_total",
            "p2_sync_wait", "p2_drain", "total"} <= set(phase_times)


@pytest.mark.parametrize("strategy", ["TRUNCATED_GEOMETRIC",
                                      "LAPLACE_THRESHOLDING",
                                      "GAUSSIAN_THRESHOLDING"])
def test_select_partitions_blocked_matches_jax(strategy):
    pid, pk, _, valid = blocked_rows(1)
    kept = []
    for mod, sel_ops, blocked, key in (
            (pdp, jax_selection_ops, jax_large_p, jax.random.PRNGKey(9)),
            (tdp, selection_ops, large_p,
             np.asarray(jax.random.PRNGKey(9)))):
        sel = sel_ops.selection_params_from_host(
            getattr(mod.PartitionSelectionStrategy, strategy), 2.0, 1e-6, 3,
            None)
        kw = dict(device="cpu", dtype=F64) if blocked is large_p else {}
        kept.append(blocked.select_partitions_blocked(
            pid, pk, valid, key, 3, N_PARTS, sel, block_partitions=BLOCK,
            **kw))
    assert 0 < len(kept[0]) < N_PARTS
    assert kept[1].dtype == np.int64
    np.testing.assert_array_equal(kept[1], kept[0])


# --- mirrors of tests/test_blocked_edge_cases.py ---------------------------

EDGE_P = 300
EDGE_BLOCK = 64


def edge_empty():
    return (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0),
            np.zeros(0, bool))


def edge_all_invalid(n=500):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 100, n).astype(np.int32),
            rng.integers(0, EDGE_P, n).astype(np.int32),
            rng.uniform(0, 5, n), np.zeros(n, bool))


@pytest.mark.parametrize("data", [edge_empty(), edge_all_invalid()],
                         ids=["empty", "all_invalid"])
def test_aggregate_blocked_zero_kept(data):
    _, (cfg, stds, scalars) = specs(EDGE_P, True,
                                    lambda M: [M.COUNT, M.SUM], eps=1.0,
                                    l0=4, linf=8)
    kept, outputs = large_p.aggregate_blocked(
        *data, *scalars, stds, np.asarray(jax.random.PRNGKey(0)), cfg,
        block_partitions=EDGE_BLOCK, device="cpu", dtype=F64)
    assert kept.shape == (0,) and kept.dtype == np.int64
    assert set(outputs) == {"count", "sum"}
    assert all(len(col) == 0 for col in outputs.values())


@pytest.mark.parametrize("data", [edge_empty(), edge_all_invalid()],
                         ids=["empty", "all_invalid"])
def test_select_partitions_blocked_zero_kept(data):
    pid, pk, _, valid = data
    sel = selection_ops.selection_params_from_host(
        tdp.PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-6, 4,
        None)
    kept = large_p.select_partitions_blocked(
        pid, pk, valid, np.asarray(jax.random.PRNGKey(0)), 4, EDGE_P, sel,
        block_partitions=EDGE_BLOCK, device="cpu", dtype=F64)
    assert kept.shape == (0,) and kept.dtype == np.int64


@pytest.mark.parametrize("private", [True, False])
def test_sparse_blocks_skipped_only_under_private_selection(private):
    # Rows in 2 of the 16 blocks: private selection dispatches those two,
    # public partitions release every block, rows or not.
    P = 16 * EDGE_BLOCK
    rng = np.random.default_rng(6)
    n = 400
    pk = np.where(rng.random(n) < 0.5, 5, 3 * EDGE_BLOCK + 7).astype(
        np.int32)
    data = (rng.integers(0, 300, n).astype(np.int32), pk,
            rng.uniform(0, 5, n), np.ones(n, bool))
    _, (cfg, stds, scalars) = specs(P, private, lambda M: [M.COUNT],
                                    eps=5.0)
    phase_times = {}
    kept, _ = large_p.aggregate_blocked(
        *data, *scalars, stds, np.asarray(jax.random.PRNGKey(1)), cfg,
        block_partitions=EDGE_BLOCK, phase_times=phase_times, device="cpu",
        dtype=F64)
    assert phase_times["blocks_dispatched"] == (2 if private else 16)
    if private:
        np.testing.assert_array_equal(kept, [5, 3 * EDGE_BLOCK + 7])
    else:
        np.testing.assert_array_equal(kept, np.arange(P))


# --- DPEngine on TorchBackend against TPUBackend ---------------------------


def engine_rows(seed=0, n=1500, n_ids=500, P=N_PARTS, vector=False):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_ids, n).tolist()
    parts = skewed_partitions(rng, n, P).tolist()
    if vector:
        values = [list(v) for v in rng.uniform(-2, 3, (n, 3))]
    else:
        values = rng.uniform(0, 5, n).tolist()
    return list(zip(users, parts, values))


ROWS = engine_rows()
VECTOR_ROWS = engine_rows(vector=True)
LAZY_ROWS = engine_rows(1, n=6000, n_ids=3000, P=1100)


def release(mod, rows, metrics, public, eps, backend_kw, block=BLOCK,
            **params_kw):
    kw = dict(noise_seed=11, large_partition_threshold=THRESHOLD,
              block_partitions=block, **backend_kw)
    backend = (pdp.TPUBackend(**kw) if mod is pdp else
               tdp.TorchBackend(device="cpu", dtype=F64, **kw))
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    bounds = dict(max_partitions_contributed=3,
                  max_contributions_per_partition=2, min_value=0.0,
                  max_value=5.0)
    bounds.update(params_kw)
    for field, enum in (("noise_kind", mod.NoiseKind),
                        ("vector_norm_kind", mod.NormKind)):
        if field in bounds:
            bounds[field] = getattr(enum, bounds[field])
    params = mod.AggregateParams(metrics=metrics(mod.Metrics), **bounds)
    res = mod.DPEngine(acc, backend).aggregate(
        rows, params, mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                         partition_extractor=lambda r: r[1],
                                         value_extractor=lambda r: r[2]),
        public)
    acc.compute_budgets()
    return dict(res)


CASES = {
    "public_gaussian": (ROWS, lambda M: [M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
                        True, 2.0, {}, dict(noise_kind="GAUSSIAN")),
    "private_laplace": (ROWS, lambda M: [M.COUNT, M.SUM,
                                         M.PRIVACY_ID_COUNT],
                        False, 2.0, {}, {}),
    "percentile": (ROWS, lambda M: [M.PERCENTILE(25), M.PERCENTILE(75),
                                    M.COUNT], False, 4.0, {}, {}),
    "vector_sum": (VECTOR_ROWS, lambda M: [M.VECTOR_SUM, M.COUNT], False,
                   4.0, {}, dict(vector_size=3, vector_max_norm=4.0,
                                 vector_norm_kind="L2", min_value=None,
                                 max_value=None)),
    "secure_public": (ROWS, lambda M: [M.COUNT, M.SUM, M.MEAN], True, 2.0,
                      dict(secure_noise=True), {}),
    "secure_private": (ROWS, lambda M: [M.COUNT, M.SUM, M.MEAN], False,
                       4.0, dict(secure_noise=True), {}),
    "safe": (ROWS, lambda M: [M.COUNT, M.SUM, M.VARIANCE], False, 2.0,
             dict(numeric_mode="safe"), {}),
    "max_contributions": (ROWS, lambda M: [M.COUNT, M.SUM], True, 2.0, {},
                          dict(max_contributions=4,
                               max_partitions_contributed=None,
                               max_contributions_per_partition=None)),
}


@functools.lru_cache(maxsize=None)
def jax_release(case):
    rows, metrics, public, eps, backend_kw, params_kw = CASES[case]
    return release(pdp, rows, metrics,
                   list(range(N_PARTS)) if public else None, eps, backend_kw,
                   **params_kw)


def assert_same(got, want, exact=False):
    assert set(got) == set(want)
    for key, metrics in want.items():
        assert got[key]._fields == metrics._fields
        for a, b in zip(got[key], metrics):
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                close(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_aggregate_blocked_matches_tpu_backend(case):
    rows, metrics, public, eps, backend_kw, params_kw = CASES[case]
    got = release(tdp, rows, metrics, list(range(N_PARTS)) if public else None,
                  eps, backend_kw, **params_kw)
    want = jax_release(case)
    assert 0 < len(want) <= N_PARTS
    if not public:
        assert len(want) < N_PARTS  # selection dropped some partitions
    assert_same(got, want, exact=bool(backend_kw.get("secure_noise")))


def test_engine_percentile_lazy_regime_per_block():
    # Blocks of 600 partitions exceed the default tree's quantile_chunk
    # (512): the first block takes the lazy descent, the partial last
    # (500) the dense one.
    metrics = lambda M: [M.PERCENTILE(50), M.COUNT]  # noqa: E731
    args = (LAZY_ROWS, metrics, list(range(1100)), 1e3, {})
    got = release(tdp, *args, block=600)
    want = release(pdp, *args, block=600)
    assert len(want) == 1100
    assert_same(got, want)


def test_engine_safe_float32_sums_exact_on_blocks(f32_compute):
    # One row per user, sums past 2^24: the compensated windowed entry
    # releases float32 of the exact sum, as TPUBackend(numeric_mode="safe")
    # does on its blocked route.
    rng = np.random.default_rng(9)
    n = 12000
    values = rng.integers(0, 120000, n).astype(np.float64)
    parts = rng.integers(0, 20, n)
    rows = [(i, int(p), float(v)) for i, (p, v) in enumerate(zip(parts,
                                                                 values))]
    exact = np.bincount(parts, weights=values, minlength=20)
    assert exact.min() > 2**24
    bounds = dict(max_partitions_contributed=1,
                  max_contributions_per_partition=1, max_value=120000.0)
    out = []
    for mod in (tdp, pdp):
        kw = dict(noise_seed=3, large_partition_threshold=THRESHOLD,
                  block_partitions=BLOCK, numeric_mode="safe")
        backend = (pdp.TPUBackend(**kw) if mod is pdp else
                   tdp.TorchBackend(device="cpu", dtype=torch.float32, **kw))
        acc = mod.NaiveBudgetAccountant(total_epsilon=1e7, total_delta=1e-6)
        res = mod.DPEngine(acc, backend).aggregate(
            rows, mod.AggregateParams(metrics=[mod.Metrics.SUM],
                                      min_value=0.0, **bounds),
            mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                               partition_extractor=lambda r: r[1],
                               value_extractor=lambda r: r[2]),
            list(range(20)))
        acc.compute_budgets()
        out.append(dict(res))
    sums = np.array([out[0][p].sum for p in range(20)])
    np.testing.assert_array_equal(sums, exact.astype(np.float32))
    jsums = np.array([out[1][p].sum for p in range(20)])
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(sums - jsums) <= ulp)


@functools.lru_cache(maxsize=None)
def jax_selection(strategy):
    return select(pdp, strategy)


def select(mod, strategy):
    backend_kw = dict(noise_seed=13, large_partition_threshold=THRESHOLD,
                      block_partitions=BLOCK)
    backend = (pdp.TPUBackend(**backend_kw) if mod is pdp else
               tdp.TorchBackend(device="cpu", dtype=F64, **backend_kw))
    acc = mod.NaiveBudgetAccountant(total_epsilon=1.5, total_delta=1e-6)
    res = mod.DPEngine(acc, backend).select_partitions(
        ROWS, mod.SelectPartitionsParams(
            max_partitions_contributed=3,
            partition_selection_strategy=getattr(
                mod.PartitionSelectionStrategy, strategy)),
        mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                           partition_extractor=lambda r: r[1]))
    acc.compute_budgets()
    return list(res)


@pytest.mark.parametrize("strategy", ["TRUNCATED_GEOMETRIC",
                                      "LAPLACE_THRESHOLDING",
                                      "GAUSSIAN_THRESHOLDING"])
def test_engine_select_partitions_blocked_matches_tpu_backend(strategy):
    want = jax_selection(strategy)
    assert 0 < len(want) < N_PARTS
    assert select(tdp, strategy) == want


def test_engine_blocked_route_runs_the_windowed_entries(monkeypatch):
    # Above the threshold the dense route's kernels run per block through
    # the windowed entries, and the block windows come from C10.
    called = []
    for name in ("block_window_offsets", "reduce_partitions",
                 "release_epilogue", "compact_kept", "gather_rows"):
        original = getattr(kernels, name)

        def spy(*args, _name=name, _original=original, **kwargs):
            called.append((_name, kwargs.get("base")))
            return _original(*args, **kwargs)

        monkeypatch.setattr(kernels, name, spy)
    release(tdp, ROWS, lambda M: [M.COUNT], list(range(N_PARTS)), 2.0, {})
    n_blocks = -(-N_PARTS // BLOCK)
    assert called[0] == ("block_window_offsets", None)
    reduces = [base for name, base in called if name == "reduce_partitions"]
    assert reduces == [j * BLOCK for j in range(n_blocks)]
    assert sum(name == "compact_kept" for name, _ in called) == n_blocks
    assert not any(name == "gather_rows" for name, _ in called)


@pytest.mark.parametrize("mod", [pdp, tdp], ids=["jax", "torch"])
def test_blocked_sentinel_fails_closed(f32_compute, mod):
    # Partition 0's sum, 2e38 >= finfo(float32).max / 2, saturates (the
    # other partitions' sums stay small, so no prefix overflows): the safe-mode
    # sentinel of its block refuses the release before any value of it is
    # decoded, on both packages' blocked routes.
    rows = [(i, i % 20, 1e38 if i % 20 == 0 else 1.0) for i in range(40)]
    kw = dict(large_partition_threshold=THRESHOLD, block_partitions=BLOCK,
              numeric_mode="safe")
    backend = (pdp.TPUBackend(**kw) if mod is pdp else
               tdp.TorchBackend(device="cpu", dtype=torch.float32, **kw))
    acc = mod.NaiveBudgetAccountant(total_epsilon=1e6, total_delta=1e-6)
    res = mod.DPEngine(acc, backend).aggregate(
        rows, mod.AggregateParams(metrics=[mod.Metrics.SUM],
                                  max_partitions_contributed=1,
                                  max_contributions_per_partition=1,
                                  min_value=0.0,
                                  max_value=float(np.finfo(np.float32).max)),
        mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                           partition_extractor=lambda r: r[1],
                           value_extractor=lambda r: r[2]),
        list(range(20)))
    acc.compute_budgets()
    err = (jax_numeric.NumericOverflowError if mod is pdp else
           numeric.NumericOverflowError)
    with pytest.raises(err, match="blocked release"):
        list(res)


def test_block_partitions_validated():
    assert tdp.TorchBackend(device="cpu").block_partitions is None
    assert tdp.TorchBackend(device="cpu",
                            block_partitions=64).block_partitions == 64
    for bad in (0, -8, 2.5, True, "64"):
        with pytest.raises(ValueError, match="block_partitions"):
            tdp.TorchBackend(device="cpu", block_partitions=bad)
