"""The blocked large-P route over a device mesh (K23a): the port's
aggregate_blocked_sharded and select_partitions_blocked_sharded
(pipelinedp_tpu_torch/parallel/large_p.py) on TorchBackend(device="cpu",
mesh=make_mesh(["cpu"] * D)) against the JAX package's on
TPUBackend(mesh=make_mesh(n_devices=D)), D in {2, 8} of the 8 CPU devices,
float64 (JAX under x64) unless stated. One shape throughout, so the JAX
shard_map programs compile once a case: P = 20 partitions,
large_partition_threshold 16, 8 partitions a block (the last block
partial).

Every parity case keeps each shard's load above 56 rows: below that the
JAX reference's device reshard asserts (pipelinedp_tpu/parallel/
reshard.py:302; its 12.5% padding bound does not allow round_capacity's
8-row step), which test_reference_reshard_assert_and_the_port_release
shows.

Bounds stated here:
  * pass 1's offsets tables and each shard's kept stream: identical
    (integers);
  * kept partitions: identical sets (selection decisions are integer
    counts against replicated keys);
  * released values: within 1e-9 of max(1, |x|) of the JAX mesh's (the
    bound of tests/test_torch_sharded.py: the float64 noise words agree to
    the ulp bounds of tests/test_torch_threefry.py, and the shards'
    partials are summed in shard order where XLA's all-reduce takes its
    own); secure noise: equal;
  * numeric_mode="safe" in float32 (JAX with x64 off) at epsilon 1e7:
    every released sum equals float32 of the exact integer sum on both
    packages;
  * a D = 1 mesh: equal (==) to the unmeshed blocked release; noise-free
    integer-valued rows: the meshed blocked release == the meshed dense
    release == the JAX meshed blocked release.
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
from pipelinedp_tpu.parallel import large_p as jax_large_p
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.parallel import reshard as jax_reshard
from pipelinedp_tpu_torch import combiners, executor, kernels
from pipelinedp_tpu_torch.parallel import large_p, reshard, sharded
from pipelinedp_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.torch_port

F64 = torch.float64
SEED = 11
THRESHOLD = 16
BLOCK = 8
N_PARTS = 20  # 20 % 8 = 4: the last block is partial
PUBLIC = list(range(N_PARTS))
SHARDS = (2, 8)
BLOCKED = dict(large_partition_threshold=THRESHOLD, block_partitions=BLOCK)


@pytest.fixture(autouse=True)
def _fresh():
    reshard.reset_capacity_cache()
    jax_reshard.reset_capacity_cache()
    yield


@pytest.fixture
def f32_compute():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def make_rows(seed=0, n=1600, users=500, vector=False, integer=False):
    """Rows over N_PARTS partitions with falling popularity: private
    selection keeps the head and drops the tail."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.random(n)**3 * N_PARTS).astype(int)
    if vector:
        values = [list(v) for v in rng.uniform(-2, 3, (n, 3))]
    elif integer:
        values = rng.integers(0, 6, n).astype(float).tolist()
    else:
        values = rng.uniform(0, 5, n).tolist()
    return list(zip(pid.tolist(), pk.tolist(), values))


ROWS = make_rows()
VECTOR_ROWS = make_rows(1, vector=True)


def backend(mod, n_shards, **kw):
    kw = dict(BLOCKED, noise_seed=SEED, **kw)
    if mod is pdp:
        return pdp.TPUBackend(mesh=jax_make_mesh(n_devices=n_shards), **kw)
    kw.setdefault("dtype", F64)
    return tdp.TorchBackend(device="cpu", mesh=make_mesh(["cpu"] * n_shards),
                            **kw)


def extractors(mod):
    return mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                              partition_extractor=lambda r: r[1],
                              value_extractor=lambda r: r[2])


def aggregate(mod, bk, rows, metrics, public, eps=4.0, **params_kw):
    fields = dict(max_partitions_contributed=3,
                  max_contributions_per_partition=2, min_value=0.0,
                  max_value=5.0)
    fields.update(params_kw)
    for name, enum in (("noise_kind", "NoiseKind"),
                       ("vector_norm_kind", "NormKind")):
        if name in fields:
            fields[name] = getattr(getattr(mod, enum), fields[name])
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    res = mod.DPEngine(acc, bk).aggregate(
        rows, mod.AggregateParams(metrics=metrics(mod.Metrics), **fields),
        extractors(mod), public)
    acc.compute_budgets()
    return dict(res)


def select(mod, bk, rows, strategy="TRUNCATED_GEOMETRIC", eps=2.0):
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    res = mod.DPEngine(acc, bk).select_partitions(
        rows, mod.SelectPartitionsParams(
            max_partitions_contributed=3,
            partition_selection_strategy=getattr(
                mod.PartitionSelectionStrategy, strategy)),
        extractors(mod))
    acc.compute_budgets()
    return sorted(res)


def assert_close(got, want, exact=False):
    assert set(got) == set(want)
    for key, metrics in want.items():
        assert got[key]._fields == metrics._fields
        for a, b in zip(got[key], metrics):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                assert np.all(np.abs(a - b) <= 1e-9 * np.maximum(
                    1.0, np.abs(b))), (key, a, b)


# ---------------------------------------------------------------------------
# The port's pass-1 functions against the JAX package's


def kernel_specs(private, metrics=lambda M: [M.COUNT, M.SUM, M.MEAN]):
    """(cfg, stds, scalars) of one release on each package: JAX first."""
    out = []
    for mod, comb, ex in ((pdp, jax_combiners, jax_executor),
                          (tdp, combiners, executor)):
        params = mod.AggregateParams(
            metrics=metrics(mod.Metrics), max_partitions_contributed=3,
            max_contributions_per_partition=2, min_value=0.0, max_value=5.0)
        acc = mod.NaiveBudgetAccountant(total_epsilon=4.0, total_delta=1e-6)
        compound = comb.create_compound_combiner(params, acc)
        acc.compute_budgets()
        cfg = ex.make_kernel_config(params, compound, N_PARTS, private, None)
        stds = (ex.compute_noise_stds(compound, params) if mod is pdp else
                ex.compute_noise_stds(compound))
        out.append((cfg, np.asarray(stds), ex.kernel_scalars(params)))
    return out


def encoded_rows(rows=ROWS):
    enc = tdp.columnar.encode(rows, extractors(tdp), PUBLIC)
    return enc.pid, enc.pk, enc.values, enc.valid


RNG_KEY = np.array([0, 23], np.uint32)


@functools.lru_cache(maxsize=None)
def bound_compact_pair(n_shards):
    """Pass 1 on both packages over the same host-staged rows."""
    (jcfg, _, jscalars), (cfg, _, scalars) = kernel_specs(False)
    rows = encoded_rows()
    jmesh = jax_make_mesh(n_devices=n_shards)
    staged = jax_reshard.stage_rows_to_mesh(jmesh, *rows, "host",
                                            values_dtype=np.float64)
    rows_key, _ = executor.release_key_halves(RNG_KEY)
    n_blocks = -(-N_PARTS // BLOCK)
    jout = jax_large_p._sharded_bound_compact(
        *staged, *jscalars, jnp.asarray(rows_key),
        jnp.asarray(jax_large_p._block_boundaries(0, BLOCK, n_blocks)),
        jcfg, jmesh)
    mesh = make_mesh(["cpu"] * n_shards)
    shards = reshard.stage_rows_to_mesh(mesh, *rows, "host", F64)
    streams, table = large_p._sharded_bound_compact(
        mesh, shards, scalars, rows_key, cfg, BLOCK, n_blocks)
    return jmesh, jout, mesh, streams, table


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_bound_compact_matches_jax(n_shards):
    _, (spk, pair, cols, _, starts), _, streams, table = \
        bound_compact_pair(n_shards)
    np.testing.assert_array_equal(
        table, np.asarray(starts).reshape(n_shards, -1))
    assert len(streams) == n_shards and table[:, -1].sum() > 0
    spk = np.asarray(spk).reshape(n_shards, -1)
    pair = np.asarray(pair).reshape(n_shards, -1)
    cols = {m: np.asarray(c).reshape(n_shards, -1) for m, c in cols.items()}
    for s, stream in enumerate(streams):
        k = int(table[s, -1])
        perm = stream.perm[:k]
        np.testing.assert_array_equal(stream.skey2[:k].numpy(), spk[s, :k])
        np.testing.assert_array_equal(stream.pair_start[perm].numpy(),
                                      pair[s, :k])
        assert set(stream.cols) == set(cols)
        for m, col in stream.cols.items():
            np.testing.assert_array_equal(col[perm].numpy(), cols[m][s, :k])


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_block_offsets_match_jax(n_shards):
    # Another plan (the OOM re-plan's): partitions [4, 20) in blocks of 4.
    jmesh, (spk, *_), mesh, streams, _ = bound_compact_pair(n_shards)
    got = large_p._sharded_block_offsets(mesh, streams, 4, 4, 4, N_PARTS)
    want = jax_large_p._sharded_block_offsets(
        spk, jnp.asarray(jax_large_p._block_boundaries(4, 4, 4)), jmesh)
    assert got.dtype == np.int64 and got.shape == (n_shards, 5)
    np.testing.assert_array_equal(got,
                                  np.asarray(want).reshape(n_shards, -1))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_select_compact_matches_jax(n_shards):
    # JAX keeps one row a kept pair, the port every row of it with the
    # first marked (pair_start): the port's marked rows are the JAX
    # stream, and its windows hold as many as the JAX windows' lengths.
    pid, pk, _, valid = encoded_rows()
    n_blocks = -(-N_PARTS // BLOCK)
    key_l0, _ = executor.select_key_schedule(RNG_KEY)
    jmesh = jax_make_mesh(n_devices=n_shards)
    jpid, jpk, _, jvalid = jax_reshard.stage_rows_to_mesh(
        jmesh, pid, pk, np.zeros((len(pid), 0), np.float32), valid, "host")
    spk, starts = jax_large_p._sharded_select_compact(
        jpid, jpk, jvalid, jnp.asarray(key_l0),
        jnp.asarray(jax_large_p._block_boundaries(0, BLOCK, n_blocks)), 3,
        N_PARTS, jmesh)
    spk = np.asarray(spk).reshape(n_shards, -1)
    starts = np.asarray(starts).reshape(n_shards, -1)
    mesh = make_mesh(["cpu"] * n_shards)
    shards = reshard.stage_rows_to_mesh(mesh, pid, pk, None, valid, "host")
    streams, table = large_p._sharded_select_compact(
        mesh, shards, key_l0, 3, N_PARTS, BLOCK, n_blocks)
    assert table.shape == starts.shape
    for s, stream in enumerate(streams):
        marked = stream.pair_start[stream.perm].numpy()
        k = int(table[s, -1])
        np.testing.assert_array_equal(stream.skey2[:k].numpy()[marked[:k]],
                                      spk[s, :starts[s, -1]])
        pairs_before = np.concatenate([[0], np.cumsum(marked)])
        np.testing.assert_array_equal(pairs_before[table[s]], starts[s])


# ---------------------------------------------------------------------------
# DPEngine over the mesh above the threshold against TPUBackend(mesh=)

CASES = {
    "public_gaussian": (ROWS, lambda M: [M.COUNT, M.SUM, M.MEAN, M.VARIANCE],
                        True, {}, dict(noise_kind="GAUSSIAN")),
    "private_laplace": (ROWS, lambda M: [M.COUNT, M.SUM,
                                         M.PRIVACY_ID_COUNT], False, {}, {}),
    "percentile": (ROWS, lambda M: [M.PERCENTILE(25), M.PERCENTILE(75),
                                    M.COUNT], False, {}, {}),
    "vector_sum": (VECTOR_ROWS, lambda M: [M.VECTOR_SUM, M.COUNT], False, {},
                   dict(vector_size=3, vector_max_norm=4.0,
                        vector_norm_kind="L2", min_value=None,
                        max_value=None)),
    "secure": (ROWS, lambda M: [M.COUNT, M.SUM, M.MEAN], False,
               dict(secure_noise=True), {}),
    "max_contributions": (ROWS, lambda M: [M.COUNT, M.SUM], True, {},
                          dict(max_contributions=4,
                               max_partitions_contributed=None,
                               max_contributions_per_partition=None)),
}


@pytest.mark.parametrize("case,n_shards", [
    (case, 2) for case in sorted(CASES)] + [("percentile", 8),
                                            ("public_gaussian", 8)])
def test_engine_aggregate_matches_the_jax_mesh(case, n_shards):
    rows, metrics, public, backend_kw, params_kw = CASES[case]
    public = PUBLIC if public else None
    want = aggregate(pdp, backend(pdp, n_shards, **backend_kw), rows,
                     metrics, public, **params_kw)
    got = aggregate(tdp, backend(tdp, n_shards, **backend_kw), rows,
                    metrics, public, **params_kw)
    assert 0 < len(want) <= N_PARTS
    if public is None:
        assert len(want) < N_PARTS  # selection dropped some partitions
    assert_close(got, want, exact=bool(backend_kw.get("secure_noise")))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_safe_mode_float32_sums_exact(n_shards, f32_compute):
    # One row a privacy id: bounds of 1 bind nothing. Every sum lies past
    # 2^24 and every shard's partial of it below (each partial exact in
    # float32, as both packages round a shard's compensated partial once),
    # so only the cross-shard combine can round; the sum's noise
    # (sensitivity 80000 at epsilon 1e7) stays far below half a float32
    # ulp of the ~2.4 x 10^7 sums.
    rng = np.random.default_rng(4)
    n = 12000
    parts = rng.integers(0, N_PARTS, n)
    values = rng.integers(0, 80000, n)
    rows = [(i, int(p), float(v)) for i, (p, v) in enumerate(zip(parts,
                                                                 values))]
    kw = dict(max_partitions_contributed=1,
              max_contributions_per_partition=1, max_value=80000.0)
    metrics = lambda M: [M.COUNT, M.SUM]  # noqa: E731
    want = aggregate(pdp, backend(pdp, n_shards, numeric_mode="safe"), rows,
                     metrics, PUBLIC, eps=1e7, **kw)
    got = aggregate(tdp, backend(tdp, n_shards, numeric_mode="safe",
                                 dtype=torch.float32), rows, metrics, PUBLIC,
                    eps=1e7, **kw)
    exact = np.bincount(parts, weights=values, minlength=N_PARTS)
    assert exact.min() > 2**24
    assert set(got) == set(want) == set(PUBLIC)
    for p in PUBLIC:
        assert np.float32(got[p].sum) == np.float32(exact[p])
        assert np.float32(want[p].sum) == np.float32(exact[p])


@pytest.mark.parametrize("strategy,n_shards", [
    ("TRUNCATED_GEOMETRIC", 2), ("LAPLACE_THRESHOLDING", 8),
    ("GAUSSIAN_THRESHOLDING", 2)])
def test_select_partitions_matches_the_jax_mesh(strategy, n_shards):
    want = select(pdp, backend(pdp, n_shards), ROWS, strategy)
    got = select(tdp, backend(tdp, n_shards), ROWS, strategy)
    assert 0 < len(want) < N_PARTS
    assert got == want


# ---------------------------------------------------------------------------
# Staging: reshard modes, streamed input, device-resident rows

COUNT_SUM = lambda M: [M.COUNT, M.SUM, M.MEAN]  # noqa: E731


@functools.lru_cache(maxsize=None)
def jax_private(n_shards, mode):
    return aggregate(pdp, backend(pdp, n_shards, reshard=mode), ROWS,
                     COUNT_SUM, None)


@pytest.mark.parametrize("mode,n_shards", [("auto", 2), ("host", 2),
                                           ("device", 2), ("device", 8)])
def test_reshard_modes_equal_the_jax_mesh(mode, n_shards):
    got = aggregate(tdp, backend(tdp, n_shards, reshard=mode), ROWS,
                    COUNT_SUM, None)
    assert got
    assert_close(got, jax_private(n_shards, mode))
    assert select(tdp, backend(tdp, n_shards, reshard=mode), ROWS) == \
        select(pdp, backend(pdp, n_shards, reshard=mode), ROWS)


def chunks(rows, size=500):
    cols = list(zip(*rows))
    return [(np.array(cols[0][i:i + size]), np.array(cols[1][i:i + size]),
             np.array(cols[2][i:i + size])) for i in range(0, len(rows), size)]


def test_streamed_input_above_the_threshold():
    """A ChunkSource's device-resident columns take the device exchange
    (reshard="auto", C22 / C23), as TPUBackend(mesh=) stages its stream."""
    want = aggregate(pdp, backend(pdp, 2), pdp.ChunkSource(chunks(ROWS)),
                     COUNT_SUM, None)
    got = aggregate(tdp, backend(tdp, 2, encode_threads=0),
                    tdp.ChunkSource(chunks(ROWS)), COUNT_SUM, None)
    assert got
    assert_close(got, want)
    assert select(tdp, backend(tdp, 2, encode_threads=0),
                  tdp.ChunkSource(chunks(ROWS))) == \
        select(pdp, backend(pdp, 2), pdp.ChunkSource(chunks(ROWS)))


def test_device_resident_rows_never_visit_the_host():
    """Rows given as tensors reshard and release under the transfer guard:
    only the [D, D] send table, the [D, n_blocks + 1] offsets table and
    the O(kept) results cross to the host."""
    (_, _, _), (cfg, stds, scalars) = kernel_specs(True)
    pid, pk, values, valid = (torch.as_tensor(c) for c in encoded_rows())
    mesh = make_mesh(["cpu"] * 2)
    want = large_p.aggregate_blocked_sharded(
        mesh, pid, pk, values.to(F64), valid, *scalars, stds, RNG_KEY, cfg,
        block_partitions=BLOCK, reshard="device", dtype=F64)
    with reshard.forbid_row_fetches(max_elements=64):
        got = large_p.aggregate_blocked_sharded(
            mesh, pid, pk, values.to(F64), valid, *scalars, stds, RNG_KEY,
            cfg, block_partitions=BLOCK, reshard="device", dtype=F64)
    assert len(got[0]) and set(got[1]) == set(want[1])
    np.testing.assert_array_equal(got[0], want[0])
    for name in want[1]:
        np.testing.assert_array_equal(got[1][name], want[1][name])


# ---------------------------------------------------------------------------
# The mesh against the port's own routes


def test_one_shard_mesh_equals_the_unmeshed_release():
    """Shard 0's rows key is fold_in(rows_key, 0), the unmeshed route's:
    a D = 1 mesh releases the same bits. (Selection is not so: its meshed
    pass 1 draws under fold_in(key_l0, shard), the unmeshed one under
    key_l0 itself, in both packages.)"""
    for metrics, public in ((COUNT_SUM, None),
                            (CASES["percentile"][1], None),
                            (CASES["public_gaussian"][1], PUBLIC)):
        meshed = aggregate(tdp, backend(tdp, 1), ROWS, metrics, public)
        solo = aggregate(tdp, tdp.TorchBackend(device="cpu", dtype=F64,
                                               noise_seed=SEED, **BLOCKED),
                         ROWS, metrics, public)
        assert meshed and meshed == solo


@pytest.mark.parametrize("n_shards", SHARDS)
def test_noise_free_integer_rows_are_exact(n_shards):
    """stds 0 on integer-valued rows and bounds no row exceeds: the meshed
    blocked release == the meshed dense release == the JAX meshed
    blocked release (==)."""
    rows = make_rows(2, integer=True)
    pid, pk, values, valid = encoded_rows(rows)
    loose = dict(max_partitions_contributed=N_PARTS,
                 max_contributions_per_partition=len(rows))
    specs = []
    for mod, comb, ex in ((pdp, jax_combiners, jax_executor),
                          (tdp, combiners, executor)):
        params = mod.AggregateParams(
            metrics=[mod.Metrics.COUNT, mod.Metrics.SUM], min_value=0.0,
            max_value=5.0, **loose)
        compound = comb.create_compound_combiner(
            params, mod.NaiveBudgetAccountant(total_epsilon=1.0,
                                              total_delta=1e-6))
        specs.append((ex.make_kernel_config(params, compound, N_PARTS, False,
                                            None),
                      ex.kernel_scalars(params)))
    (jcfg, scalars), (cfg, _) = specs
    stds = np.zeros(2)
    mesh = make_mesh(["cpu"] * n_shards)
    kept, blocked = large_p.aggregate_blocked_sharded(
        mesh, pid, pk, values, valid, *scalars, stds, RNG_KEY, cfg,
        block_partitions=BLOCK, dtype=F64)
    n_kept, order, dense, _ = sharded.sharded_aggregate_arrays(
        mesh, *executor.pad_rows(tdp.columnar.encode(rows, extractors(tdp),
                                                     PUBLIC)),
        *scalars, stds, RNG_KEY, cfg, dtype=F64)
    jkept, jout = jax_large_p.aggregate_blocked_sharded(
        jax_make_mesh(n_devices=n_shards), pid, pk, values, valid, *scalars,
        stds, jnp.asarray(RNG_KEY), jcfg, block_partitions=BLOCK)
    np.testing.assert_array_equal(kept, np.arange(N_PARTS))
    np.testing.assert_array_equal(order[:int(n_kept)].numpy(), kept)
    np.testing.assert_array_equal(np.asarray(jkept), kept)
    truth = {"count": np.bincount(pk, minlength=N_PARTS),
             "sum": np.bincount(pk, weights=values, minlength=N_PARTS)}
    for name in ("count", "sum"):
        np.testing.assert_array_equal(blocked[name], truth[name])
        np.testing.assert_array_equal(dense[name][:int(n_kept)].numpy(),
                                      truth[name])
        np.testing.assert_array_equal(np.asarray(jout[name]), truth[name])


def test_driver_phase_times_and_launch_plan(monkeypatch):
    """The driver's phase_times keys, and what a block runs: C3's windowed
    entry once a shard, one C21 launch, C4 and C6 once; pass 1's windows
    come from one C10 launch over the shards of the mesh's one device."""
    _, (cfg, stds, scalars) = kernel_specs(False)
    called = []
    for name in ("block_window_offsets", "reduce_partitions",
                 "combine_parts", "release_epilogue", "compact_kept"):
        original = getattr(kernels, name)

        def spy(*args, _name=name, _original=original, **kwargs):
            called.append(_name)
            return _original(*args, **kwargs)

        monkeypatch.setattr(kernels, name, spy)
    phase_times = {}
    kept, _ = large_p.aggregate_blocked_sharded(
        make_mesh(["cpu"] * 2), *encoded_rows(), *scalars, stds, RNG_KEY,
        cfg, block_partitions=BLOCK, phase_times=phase_times, dtype=F64)
    n_blocks = -(-N_PARTS // BLOCK)
    assert len(kept) == N_PARTS
    assert {"staging", "p1_bound_compact", "block_offsets", "p2_dispatch",
            "p2_combine", "p2_sync_wait", "p2_drain", "p2_blocks_total",
            "total"} <= set(phase_times)
    assert phase_times["blocks_dispatched"] == n_blocks
    assert called.count("block_window_offsets") == 1  # both shards, pass 1
    assert called.count("reduce_partitions") == 2 * n_blocks
    for name in ("combine_parts", "release_epilogue", "compact_kept"):
        assert called.count(name) == n_blocks


# ---------------------------------------------------------------------------
# Faults: PERCENTILE with no partition, the reference's reshard assert


@pytest.mark.parametrize("route", ["dense", "mesh_dense", "mesh_blocked"])
def test_percentile_without_public_partitions_releases_nothing(route):
    """public_partitions=[]: the JAX package releases {}, and so does the
    port (C8's plain version at P = 0, as its CUDA entry). The blocked
    route is reached with max_partitions=20: every partition a padding
    one, no row in any window."""
    kw = {"dense": {}, "mesh_dense": dict(large_partition_threshold=None),
          "mesh_blocked": dict(max_partitions=N_PARTS)}[route]
    metrics = lambda M: [M.PERCENTILE(50), M.COUNT]  # noqa: E731
    out = []
    for mod in (pdp, tdp):
        if route == "dense":
            bk = (pdp.TPUBackend(noise_seed=SEED) if mod is pdp else
                  tdp.TorchBackend(device="cpu", dtype=F64, noise_seed=SEED))
        else:
            bk = backend(mod, 2, **kw)
        out.append(aggregate(mod, bk, ROWS, metrics, []))
    assert out == [{}, {}]


def test_reference_reshard_assert_and_the_port_release():
    """22 rows on 2 shards: the JAX device reshard's most loaded shard
    receives 9-14 rows, where round_capacity's 8-row step exceeds the
    12.5% its assert allows (pipelinedp_tpu/parallel/reshard.py:302), and
    TPUBackend(mesh=, reshard="device") raises AssertionError. The port's
    exchange has no such assert and releases; at huge epsilon on rows
    inside their bounds it agrees with the JAX reshard="host" release,
    whatever the shard placement."""
    rows = [(u, u % N_PARTS, float(u % 5)) for u in range(22)]
    metrics = lambda M: [M.COUNT, M.SUM]  # noqa: E731
    bounds = dict(max_partitions_contributed=1,
                  max_contributions_per_partition=1)
    with pytest.raises(AssertionError):
        aggregate(pdp, backend(pdp, 2, reshard="device"), rows, metrics,
                  PUBLIC, eps=1e6, **bounds)
    want = aggregate(pdp, backend(pdp, 2, reshard="host"), rows, metrics,
                     PUBLIC, eps=1e6, **bounds)
    got = aggregate(tdp, backend(tdp, 2, reshard="device"), rows, metrics,
                    PUBLIC, eps=1e6, **bounds)
    assert set(got) == set(want) == set(PUBLIC)
    truth = np.bincount([r[1] for r in rows], minlength=N_PARTS)
    for p in PUBLIC:
        assert abs(got[p].count - want[p].count) <= 1e-9 * max(1, truth[p])
        assert abs(got[p].sum - want[p].sum) <= 1e-9 * max(1, truth[p])
        assert abs(got[p].count - truth[p]) < 1e-3
