"""DPEngine on the port's meshed TorchBackend (CPU, float64 unless stated)
against the JAX package's TPUBackend(mesh=make_mesh(D)) on the same rows
and seed, D in {2, 8} of the 8 CPU devices; the meshed service and the
meshed analysis sweep.

Bounds stated here:
  * kept partitions: identical sets (selection decisions are integer
    counts against replicated keys: bit-identical);
  * released values: within 1e-9 of max(1, |x|) of the JAX mesh's, the
    bound of tests/test_torch_engine.py: the float64 noise words agree to
    the ulp bounds of tests/test_torch_threefry.py, and the port sums the
    shards' partial columns in shard order where XLA's CPU all-reduce
    takes its own (tests/test_torch_mesh.py bounds that difference by
    D * 2^-52 of the largest partial);
  * noise-free (stds 0) on integer-valued rows: the meshed release equals
    the unmeshed one and the JAX mesh's exactly (==);
  * numeric_mode="safe" in float32 (JAX with x64 off) at epsilon 1e7:
    every released sum equals float32 of the exact integer sum on both
    packages, the cross-shard combine being the compensated fold of
    tests/test_torch_mesh.py, bit for bit;
  * the meshed service: every batched job == its solo meshed run
    (release, spent epsilon, ledger trail);
  * the meshed utility analysis: every report field within 1e-9 of the
    JAX meshed sweep's (tests/test_torch_analysis.py's bound);
  * above large_partition_threshold, the meshed blocked route: as the
    dense route (tests/test_torch_large_p_mesh.py holds it in full).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import analysis as jax_analysis
from pipelinedp_tpu import aggregate_params as jax_agg
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu.analysis import data_structures as jax_ds
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.parallel import reshard as jax_reshard
from pipelinedp_tpu.parallel import sharded as jax_sharded
from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import analysis
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch.analysis import data_structures as ds
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.parallel import reshard
from pipelinedp_tpu_torch.parallel import sharded
from pipelinedp_tpu_torch.parallel.mesh import make_mesh
from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.service import DPAggregationService, JobSpec

pytestmark = pytest.mark.torch_port

F64 = torch.float64
SEED = 17
SHARDS = (2, 8)
N_PARTITIONS = 10
PUBLIC = list(range(N_PARTITIONS))


@pytest.fixture(autouse=True)
def _fresh():
    reshard.reset_capacity_cache()
    jax_reshard.reset_capacity_cache()
    telemetry.reset()
    yield
    telemetry.reset()


def make_rows(seed=0, n=2400, users=300, integer=False, vector=0):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = rng.integers(0, N_PARTITIONS, n)
    if vector:
        values = rng.uniform(-2, 2, (n, vector))
        return [(int(u), int(p), v) for u, p, v in zip(pid, pk, values)]
    values = (rng.integers(0, 6, n).astype(float) if integer else
              rng.uniform(0, 5, n))
    return [(int(u), int(p), float(v)) for u, p, v in zip(pid, pk, values)]


ROWS = make_rows()


def backend(mod, n_shards, **kw):
    kw.setdefault("noise_seed", SEED)
    if mod is pdp:
        return pdp.TPUBackend(mesh=jax_make_mesh(n_devices=n_shards), **kw)
    kw.setdefault("dtype", F64)
    return tdp.TorchBackend(device="cpu",
                            mesh=make_mesh(["cpu"] * n_shards), **kw)


def extractors(mod, pid=True):
    """The rows' extractors (without the privacy id, for bounds already
    enforced)."""
    return mod.DataExtractors(
        privacy_id_extractor=(lambda r: r[0]) if pid else None,
        partition_extractor=lambda r: r[1], value_extractor=lambda r: r[2])


def params(mod, metrics, **kw):
    fields = dict(max_partitions_contributed=3,
                  max_contributions_per_partition=2, min_value=0.0,
                  max_value=5.0)
    fields.update(kw)
    for name, enum in (("noise_kind", "NoiseKind"),
                       ("vector_norm_kind", "NormKind")):
        if name in fields:
            fields[name] = getattr(getattr(mod, enum), fields[name])
    return mod.AggregateParams(
        metrics=[m if not isinstance(m, str) else getattr(mod.Metrics, m)
                 for m in metrics], **fields)


def aggregate(mod, bk, col, metrics, public=PUBLIC, eps=2.0, **kw):
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-5)
    res = mod.DPEngine(acc, bk).aggregate(
        col, params(mod, metrics, **kw),
        extractors(mod, not kw.get("contribution_bounds_already_enforced")),
        public)
    acc.compute_budgets()
    return dict(res)


def select(mod, bk, col, eps=2.0):
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-5)
    res = mod.DPEngine(acc, bk).select_partitions(
        col, mod.SelectPartitionsParams(max_partitions_contributed=3),
        extractors(mod))
    acc.compute_budgets()
    return sorted(res)


def assert_close(got, want):
    assert got and set(got) == set(want)
    for key, metrics in want.items():
        assert got[key]._fields == metrics._fields
        for a, b in zip(got[key], metrics):
            assert np.all(np.abs(np.asarray(a) - np.asarray(b)) <=
                          1e-9 * np.maximum(1.0, np.abs(b))), (key, a, b)


def both(n_shards, metrics, public=PUBLIC, rows=ROWS, backend_kw=None,
         **kw):
    backend_kw = backend_kw or {}
    want = aggregate(pdp, backend(pdp, n_shards, **backend_kw), rows,
                     metrics, public, **kw)
    got = aggregate(tdp, backend(tdp, n_shards, **backend_kw), rows,
                    metrics, public, **kw)
    assert_close(got, want)
    return got


# ---------------------------------------------------------------------------
# DPEngine.aggregate


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("case", [
    (("COUNT", "SUM"), True, {}),
    (("COUNT", "SUM", "PRIVACY_ID_COUNT"), False, {}),
    (("MEAN", "COUNT"), True, dict(noise_kind="GAUSSIAN")),
    (("VARIANCE", "MEAN"), False, {}),
    (("COUNT", "SUM", "MEAN"), True,
     dict(max_contributions=6, max_partitions_contributed=None,
          max_contributions_per_partition=None)),
], ids=["count_sum", "private", "mean", "variance", "max_contributions"])
def test_aggregate_equals_the_jax_mesh(n_shards, case):
    metrics, public, kw = case
    both(n_shards, metrics, PUBLIC if public else None, **kw)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_bounds_already_enforced_equals_the_jax_mesh(n_shards):
    """No privacy id: every row stages to one shard, each its own
    contribution group."""
    both(n_shards, ["COUNT", "SUM"], contribution_bounds_already_enforced=True)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_noise_free_release_is_exact(n_shards):
    """stds 0 on integer-valued rows and bounds no row exceeds (as
    __graft_entry__.dryrun_multichip): meshed == unmeshed == JAX mesh."""
    rows = make_rows(1, integer=True)
    enc = tdp.columnar.encode(rows, extractors(tdp), PUBLIC)
    loose = dict(max_partitions_contributed=N_PARTITIONS,
                 max_contributions_per_partition=len(rows))
    tparams = params(tdp, ["COUNT", "SUM"], **loose)
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-5)
    compound = tdp.combiners.create_compound_combiner(tparams, acc)
    acc.compute_budgets()
    cfg = executor.make_kernel_config(tparams, compound, N_PARTITIONS, False,
                                      None)
    scalars = executor.kernel_scalars(tparams)
    stds = np.zeros(2)
    key = np.array([0, 3], np.uint32)
    pid, pk, values, valid = executor.pad_rows(enc)
    meshed = sharded.sharded_aggregate_arrays(
        make_mesh(["cpu"] * n_shards), pid, pk, values, valid, *scalars,
        stds, key, cfg, dtype=F64)
    solo = executor.aggregate_release_kernel(
        *executor.padded_to_device(pid, pk, values, valid, "cpu", F64),
        *scalars, stds, key, cfg)
    for g, w in zip(meshed[:2], solo[:2]):
        assert torch.equal(g, w)
    for name in ("count", "sum"):
        assert torch.equal(meshed[2][name], solo[2][name])
    jcfg = jax_executor.make_kernel_config(
        params(pdp, ["COUNT", "SUM"], **loose),
        pdp.combiners.create_compound_combiner(
            params(pdp, ["COUNT", "SUM"], **loose),
            pdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-5)),
        N_PARTITIONS, False, None)
    jout = jax_sharded.sharded_aggregate_arrays(
        jax_make_mesh(n_devices=n_shards), pid, pk, values, valid, *scalars,
        stds, key, jcfg, fused=True)
    k = int(meshed[0])
    assert int(jout[0]) == k
    np.testing.assert_array_equal(meshed[1][:k].numpy(),
                                  np.asarray(jout[1])[:k])
    for name in ("count", "sum"):
        np.testing.assert_array_equal(meshed[2][name][:k].numpy(),
                                      np.asarray(jout[2][name])[:k])


def force_lazy(monkeypatch):
    """quantile_chunk = 2 on both packages: the lazy descent, each level's
    child counts combined across the shards."""
    for module in (jax_executor, executor):
        orig = module.make_kernel_config
        monkeypatch.setattr(
            module, "make_kernel_config",
            lambda *a, _orig=orig, **k: dataclasses.replace(
                _orig(*a, **k), quantile_chunk=2))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("regime", ["dense", "lazy"])
def test_percentile_equals_the_jax_mesh(n_shards, regime, monkeypatch):
    if regime == "lazy":
        force_lazy(monkeypatch)
    rows = make_rows(2, n=1500, users=400)
    want = aggregate(pdp, backend(pdp, n_shards), rows,
                     [pdp.Metrics.PERCENTILE(50), pdp.Metrics.PERCENTILE(90),
                      pdp.Metrics.COUNT], eps=20.0)
    got = aggregate(tdp, backend(tdp, n_shards), rows,
                    [tdp.Metrics.PERCENTILE(50), tdp.Metrics.PERCENTILE(90),
                     tdp.Metrics.COUNT], eps=20.0)
    assert_close(got, want)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_vector_sum_equals_the_jax_mesh(n_shards):
    rows = make_rows(3, vector=3)
    both(n_shards, ["VECTOR_SUM", "COUNT"], rows=rows, vector_size=3,
         vector_max_norm=4.0, vector_norm_kind="L2", min_value=None,
         max_value=None)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_secure_noise_equals_the_jax_mesh(n_shards):
    both(n_shards, ["COUNT", "SUM", "MEAN"], None,
         backend_kw=dict(secure_noise=True), eps=20.0)


@pytest.fixture
def f32_compute():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_safe_mode_float32_equals_the_exact_sums(n_shards, f32_compute):
    rng = np.random.default_rng(4)
    n = 3000
    # One row a privacy id: bounds of 1 bind nothing, and the sum's noise
    # (sensitivity 60000 at epsilon 1e7) stays far below half a float32
    # ulp of the ~10^7 sums.
    rows = [(i, int(p), float(v)) for i, (p, v) in enumerate(zip(
        rng.integers(0, N_PARTITIONS, n), rng.integers(0, 60000, n)))]
    kw = dict(max_partitions_contributed=1,
              max_contributions_per_partition=1, min_value=0.0,
              max_value=60000.0)
    want = aggregate(pdp, backend(pdp, n_shards, numeric_mode="safe"), rows,
                     ["COUNT", "SUM"], eps=1e7, **kw)
    got = aggregate(tdp, backend(tdp, n_shards, numeric_mode="safe",
                                 dtype=torch.float32), rows,
                    ["COUNT", "SUM"], eps=1e7, **kw)
    exact = np.zeros(N_PARTITIONS, np.int64)
    for _, p, v in rows:
        exact[p] += int(v)
    assert set(got) == set(want) == set(PUBLIC)
    for p in PUBLIC:
        assert np.float32(got[p].sum) == np.float32(exact[p])
        assert np.float32(want[p].sum) == np.float32(exact[p])


# ---------------------------------------------------------------------------
# reshard modes and streamed input


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("mode", ["host", "device"])
def test_reshard_modes_equal_the_jax_mesh(n_shards, mode):
    got = both(n_shards, ["COUNT", "SUM"], None,
               backend_kw=dict(reshard=mode), eps=20.0)
    assert got


def chunks(rows, size=700):
    cols = list(zip(*rows))
    return [(np.array(cols[0][i:i + size]), np.array(cols[1][i:i + size]),
             np.array(cols[2][i:i + size])) for i in range(0, len(rows), size)]


@pytest.mark.parametrize("n_shards", SHARDS)
def test_streamed_input_through_the_mesh(n_shards):
    """A ChunkSource's device columns take the device exchange (auto)."""
    want = aggregate(pdp, backend(pdp, n_shards),
                     pdp.ChunkSource(chunks(ROWS)), ["COUNT", "SUM", "MEAN"],
                     None, eps=20.0)
    got = aggregate(tdp, backend(tdp, n_shards, encode_threads=0),
                    tdp.ChunkSource(chunks(ROWS)), ["COUNT", "SUM", "MEAN"],
                    None, eps=20.0)
    assert_close(got, want)
    assert select(tdp, backend(tdp, n_shards, encode_threads=0),
                  tdp.ChunkSource(chunks(ROWS))) == \
        select(pdp, backend(pdp, n_shards), pdp.ChunkSource(chunks(ROWS)))


# ---------------------------------------------------------------------------
# select_partitions


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("mode", ["auto", "device"])
def test_select_partitions_equals_the_jax_mesh(n_shards, mode):
    got = select(tdp, backend(tdp, n_shards, reshard=mode), ROWS)
    want = select(pdp, backend(pdp, n_shards, reshard=mode), ROWS)
    assert got == want and got


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_select_equals_the_jax_keep_mask(n_shards):
    enc = tdp.columnar.encode(ROWS, extractors(tdp), None, False)
    sel = selection_ops.selection_params_from_host(
        agg.PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-5, 3,
        None)
    key = np.array([0, 9], np.uint32)
    n_kept, order = sharded.sharded_select_partitions(
        make_mesh(["cpu"] * n_shards), enc.pid, enc.pk, enc.valid, key, 3,
        enc.n_partitions, sel, dtype=F64)
    from pipelinedp_tpu.ops import selection_ops as jax_selection_ops
    jsel = jax_selection_ops.selection_params_from_host(
        jax_agg.PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-5, 3,
        None)
    keep = np.asarray(jax_sharded.sharded_select_partitions(
        jax_make_mesh(n_devices=n_shards), enc.pid, enc.pk, enc.valid, key,
        3, enc.n_partitions, jsel))
    assert order[:int(n_kept)].tolist() == np.nonzero(keep)[0].tolist()


# ---------------------------------------------------------------------------
# The backend


def test_meshed_backend_knobs():
    m = make_mesh(["cpu"] * 2)
    bk = tdp.TorchBackend(device="cpu", mesh=m, reshard="host")
    job = bk.for_job(noise_seed=3)
    assert job.mesh == m and job.reshard == "host" and job.noise_seed == 3
    with pytest.raises(ValueError, match="reshard must be auto"):
        tdp.TorchBackend(device="cpu", mesh=m, reshard="collective")
    assert tdp.TorchBackend(device="cpu").mesh is None


def test_meshed_blocked_route_equals_the_jax_mesh():
    """Above large_partition_threshold a meshed backend takes the blocked
    route over the mesh (parallel/large_p.aggregate_blocked_sharded), as
    TPUBackend(mesh=) does."""
    kw = dict(large_partition_threshold=4)
    both(2, ["COUNT"], backend_kw=kw)
    got = select(tdp, backend(tdp, 2, **kw), ROWS)
    assert got and got == select(pdp, backend(pdp, 2, **kw), ROWS)


# ---------------------------------------------------------------------------
# The service on a meshed backend


def job_rows(seed, n=600):
    """Rows sharing one privacy-id column: every job's host LPT layout is
    the same, so the meshed lanes group."""
    rng = np.random.default_rng(seed)
    pid = np.random.default_rng(0).integers(0, 200, n)
    return [(int(u), int(p), float(v)) for u, p, v in zip(
        pid, rng.integers(0, N_PARTITIONS, n), rng.uniform(0, 5, n))]


def run_service(jobs, batching, n_shards):
    with DPAggregationService(
            backend(tdp, n_shards), max_concurrent_jobs=len(jobs),
            batching=batching, batch_window_ms=30_000.0,
            max_batch_jobs=2) as svc:
        handles = [svc.submit(t, s, r) for t, s, r in jobs]
        results = [h.result(timeout=120) for h in handles]
        spent = [h.spent_epsilon for h in handles]
        trails = {t: svc.tenant_ledger(t).records() for t, _, _ in jobs}
        assert svc.ledgers_reconciled()
    return results, spent, trails


@pytest.mark.hard_timeout(180)
@pytest.mark.parametrize("n_shards", SHARDS)
def test_meshed_service_lanes_equal_their_solo_runs(n_shards):
    p = params(tdp, ["COUNT", "SUM", "MEAN"])
    jobs = [(f"t{i}", JobSpec(params=p, epsilon=10.0, delta=1e-5,
                              noise_seed=40 + i,
                              public_partitions=PUBLIC if i % 2 else None),
             job_rows(i)) for i in range(4)]
    jobs += [(f"s{i}", JobSpec(
        params=tdp.SelectPartitionsParams(max_partitions_contributed=3),
        epsilon=2.0, delta=1e-5, noise_seed=60 + i), job_rows(10 + i))
             for i in range(2)]
    solo = run_service(jobs, False, n_shards)
    assert telemetry.snapshot().get("service_batch_launches", 0) == 0
    batched = run_service(jobs, True, n_shards)
    snap = telemetry.snapshot()
    # Aggregations split public / private (two specs) and the selections
    # make a third group: three meshed lane-batched launches of 2 lanes.
    assert snap.get("service_batch_launches", 0) == 3
    assert snap.get("service_jobs_batched", 0) == 6
    assert solo == batched
    assert all(solo[0])


# ---------------------------------------------------------------------------
# Utility analysis on a meshed backend


def leaves(obj, path="r"):
    """(path, value) of every leaf of a result dataclass: enums by name."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, (list, tuple)):
        yield (f"{path}#len", len(obj))
        for i, x in enumerate(obj):
            yield from leaves(x, f"{path}[{i}]")
    elif hasattr(obj, "name") and hasattr(obj, "value"):
        yield (path, obj.name)
    else:
        yield (path, obj)


def assert_same_result(got, want, rtol=1e-9):
    g, w = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, float) and not isinstance(b, bool):
            assert a == pytest.approx(b, rel=rtol, abs=1e-12), path
        else:
            assert a == b, path


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("public", [False, True])
def test_meshed_utility_analysis_equals_the_jax_mesh(n_shards, public):
    data = [(uid, f"pk{(uid * 7 + j) % 9}", float((uid + j) % 6))
            for uid in range(120) for j in range(1 + uid % 4)]
    kw = dict(epsilon=2.0, delta=1e-5, params=dict(
        noise_kind="GAUSSIAN", metrics=["COUNT", "SUM"],
        max_partitions_contributed=2, max_contributions_per_partition=1,
        min_sum_per_partition=0.0, max_sum_per_partition=5.0),
        multi=dict(max_partitions_contributed=[1, 2, 3]))
    jax_opts = convert.utility_analysis_options(jax_agg, jax_ds, **kw)
    port_opts = convert.utility_analysis_options(agg, ds, **kw)
    pub = [f"pk{i}" for i in range(9)] if public else None
    want, want_pp = jax_analysis.perform_utility_analysis(
        data, backend(pdp, n_shards), jax_opts, extractors(pdp),
        public_partitions=pub)
    got, got_pp = analysis.perform_utility_analysis(
        data, backend(tdp, n_shards), port_opts, extractors(tdp),
        public_partitions=pub)
    want, got = list(want), list(got)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same_result(g, w)
    want_pp, got_pp = list(want_pp), list(got_pp)
    assert [k for k, _ in got_pp] == [k for k, _ in want_pp]
    for (_, g), (_, w) in zip(got_pp, want_pp):
        assert_same_result(g, w)
