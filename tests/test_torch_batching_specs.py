"""Megabatched serving of every dense spec on the port, on the CPU: the
lane entries of the total bound, pre-bounded rows, safe mode, VECTOR_SUM,
PERCENTILE and secure noise (the plain versions), the meshed lane-batched
release, and the service with batching on. The single-device batched
release of each spec against its solo release and against the JAX
package's batched kernel is in tests/test_torch_batching.py (SPECS).

Bounds stated here:
  * each new lane entry's plain version equals the solo plain kernels on
    each lane's slice, exactly (torch.equal, flags included);
  * sharded_batched_release on make_mesh(["cpu"] * 2): lane l equals the
    solo meshed release of its rows and key (sharded_aggregate_arrays),
    exactly, for PERCENTILE (both regimes), VECTOR_SUM, safe mode and
    secure noise;
  * DPAggregationService(batching=True) on TorchBackend(device="cpu"):
    jobs of each spec coalesce into one batched launch, every job equals
    its solo run (release, spent epsilon, ledger trail) and the JAX
    service's job with the same seed within the spec's solo bounds:
    1e-9 of max(1, |x|) (tests/test_torch_engine.py), secure count / sum
    / vector_sum exact (tests/test_torch_secure.py), safe float32 sums
    within one float32 ulp at epsilon 1e7 (tests/test_torch_safe.py, JAX
    with x64 off);
  * the coalescer's group key holds what the secure tables are built
    from: equal inputs group, another snap_grid_bits or other
    sensitivities do not; snapped jobs coalesce and release on their
    grid.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu.runtime import telemetry as jax_telemetry
from pipelinedp_tpu.service import DPAggregationService as JaxService
from pipelinedp_tpu.service import JobSpec as JaxJobSpec
from pipelinedp_tpu_torch import combiners
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.ops import secure_noise
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry
from pipelinedp_tpu_torch.parallel import sharded
from pipelinedp_tpu_torch.parallel.mesh import make_mesh
from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.service import DPAggregationService, JobSpec
from pipelinedp_tpu_torch.service import batching

pytestmark = pytest.mark.torch_port

F64, F32 = torch.float64, torch.float32
LANES, LANE_ROWS, P, V = 3, 300, 12, 3


@pytest.fixture(autouse=True)
def _epoch():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture
def x64_off():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def lane_rows(seed, vector=0, dtype=F64):
    """[L, n] integer-valued rows (values [L, n, V] with vector); lanes 0
    and 1 share their privacy ids, lane 2 keeps no row."""
    r = np.random.default_rng(seed)
    pid = torch.as_tensor(r.integers(0, 200, (LANES, LANE_ROWS)),
                          dtype=torch.int32)
    pid[1] = pid[0]
    pk = torch.as_tensor(r.integers(0, P, (LANES, LANE_ROWS)),
                         dtype=torch.int32)
    shape = (LANES, LANE_ROWS, vector) if vector else (LANES, LANE_ROWS)
    values = torch.as_tensor(r.integers(-3 if vector else 0, 6, shape),
                             dtype=dtype)
    valid = torch.as_tensor(r.uniform(size=(LANES, LANE_ROWS)) < 0.95)
    valid[2] = False
    return pid, pk, values, valid


def lane_keys():
    keys = np.array([[0, 40 + l] for l in range(LANES)], np.uint32)
    keys[1] = keys[0]
    return keys


def lanes(n=LANE_ROWS):
    return [slice(l * n, (l + 1) * n) for l in range(LANES)]


# ---------------------------------------------------------------------------
# The new lane entries' plain versions against the solo plain kernels.


def test_total_bound_lanes_plain_are_each_lanes_total_bound():
    pid, pk, values, valid = lane_rows(1)
    valid[2] = True
    fp, fk, fv, fvalid = (t.reshape(-1) for t in (pid, pk, values, valid))
    keys = lane_keys() + 3
    lane_pid, u = kernels.total_bound_keys_lanes(fp, fvalid, LANE_ROWS, keys,
                                                 F64)
    perm, slane_pid = kernels.radix_sort([lane_pid, u], sorted_top=True)
    got = kernels.total_bound_rows_lanes(perm, slane_pid, fk, fv, fvalid,
                                         lane_rows=LANE_ROWS, total_bound=3,
                                         n_partitions=P)
    for l, sl in enumerate(lanes()):
        pid_sent, want_u = kernels.total_bound_keys_plain(pid[l], valid[l],
                                                          keys[l], F64)
        assert torch.equal(u[sl], want_u)
        assert torch.equal(lane_pid[sl], (l << 32) | pid_sent.long())
        solo_perm, spid = kernels.radix_sort_plain([pid_sent, want_u], True)
        assert torch.equal(perm[sl] - l * LANE_ROWS, solo_perm)
        want = kernels.total_bound_rows_plain(solo_perm, spid, pk[l],
                                              values[l], valid[l],
                                              total_bound=3, n_partitions=P)
        for a, b in zip(got, want):
            assert torch.equal(a[sl], b)
    assert int(got[3].sum()) < int(valid.sum())


def test_keyless_bound_rows_lanes_plain_is_each_lanes_bound_rows():
    _, pk, values, valid = lane_rows(2)
    cols = ("sum", "nsum", "nsum2")
    args = dict(n_partitions=P, linf=0, l0=0, clip_per_value=True,
                clip_pair_sum=True, scalars=(0.0, 4.0, 0.0, 3.0, 2.0),
                columns=cols)
    key2, start, got = kernels.bound_rows_lanes(
        None, None, None, values.reshape(-1), valid.reshape(-1),
        lane_rows=LANE_ROWS, pk=pk.reshape(-1), **args)
    for l, sl in enumerate(lanes()):
        w2, ws, wc = kernels.bound_rows_plain(None, None, None, pk[l],
                                              values[l], valid[l], **args)
        assert torch.equal(key2[sl], torch.where(w2 < P, w2 + l * P,
                                                 LANES * P).int())
        assert torch.equal(start[sl], ws)
        for c in cols:
            assert torch.equal(got[c][sl], wc[c])
    with pytest.raises(ValueError, match="pk"):
        kernels.bound_rows_lanes(None, None, None, None, valid.reshape(-1),
                                 lane_rows=LANE_ROWS, **dict(args,
                                                             columns=()))


def sorted_lanes(vector, dtype):
    """The lanes' bounded, partition-sorted rows (the lane entries of C1,
    C2 and C5, as batched_partial_columns runs them)."""
    pid, pk, values, valid = lane_rows(3, vector, dtype)
    valid[2] = True
    flat = [t.reshape((LANES * LANE_ROWS,) + tuple(t.shape[2:]))
            for t in (pid, pk, values, valid)]
    salts, linf, _, _ = executor.lane_release_keys(lane_keys(), ())
    lane, k1, k2, u = kernels.row_keys_lanes(flat[0], flat[1], flat[3],
                                             LANE_ROWS, salts, linf, P, dtype)
    perm = kernels.radix_sort([lane, k1, k2, u])
    cols = () if vector else ("sum", "nsum", "nsum2")
    key2, start, row_cols = kernels.bound_rows_lanes(
        perm, k1, k2, None if vector else flat[2], flat[3],
        lane_rows=LANE_ROWS, n_partitions=P, linf=2, l0=3,
        clip_per_value=not vector, clip_pair_sum=False,
        scalars=(0.0, 5.0, 0.0, 0.0, 2.5), columns=cols)
    perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
    return skey2, perm2, start, row_cols, (perm, flat[2])


@pytest.mark.parametrize("vector,compensated", [(V, False), (0, True),
                                                (V, True)],
                         ids=["vector", "compensated", "vector_compensated"])
def test_reduce_partitions_lanes_plain_is_each_lanes_reduction(vector,
                                                               compensated):
    dtype = F32 if compensated else F64
    skey2, perm2, start, row_cols, rows = sorted_lanes(vector, dtype)
    vrows = rows if vector else None
    got = kernels.reduce_partitions_lanes(skey2, perm2, start, row_cols,
                                          LANE_ROWS, P, dtype, vrows,
                                          compensated=compensated)
    assert ("vsum" in got) == bool(vector)
    for l in range(LANES):
        lo, hi = (int(torch.searchsorted(skey2, torch.tensor(
            v, dtype=torch.int32))) for v in (l * P, (l + 1) * P))
        want = kernels.reduce_partitions_plain(
            skey2[lo:hi], perm2[lo:hi], start, row_cols, P, dtype, vrows,
            compensated, base=l * P)
        for name, col in want.items():
            assert torch.equal(got[name][l * P:(l + 1) * P], col), name


def lane_tables(stds, noise=tdp.NoiseKind.LAPLACE):
    thr_hi, thr_lo, gran = secure_noise.build_tables(
        stds, noise, sensitivities=np.ones(len(stds)))
    return torch.as_tensor(secure_noise.pack_tables(thr_hi, thr_lo)), gran


def test_release_epilogue_secure_lanes_plain_is_each_lanes_epilogue():
    skey2, perm2, start, row_cols, _ = sorted_lanes(0, F64)
    cols = kernels.reduce_partitions_lanes(skey2, perm2, start, row_cols,
                                           LANE_ROWS, P, F64)
    plan = [("variance", ("variance", "count", "sum", "mean"), 0),
            ("privacy_id_count", ("privacy_id_count",), 3)]
    stds = np.array([2.0, 5.0, 40.0, 1.5])
    tables = lane_tables(stds)
    slots = np.stack([[threefry.fold_in(k, s) for s in range(4)]
                      for k in lane_keys()])
    sel = selection_ops.selection_params_from_host(
        tdp.PartitionSelectionStrategy.LAPLACE_THRESHOLDING, 5.0, 1e-3, 3,
        None)
    keep, outs, flags = kernels.release_epilogue_lanes(
        cols, plan, stds, slots, tdp.NoiseKind.LAPLACE, False, 2.5, 0.0, sel,
        lane_keys() + 7, 1, LANES, tables)
    for l in range(LANES):
        sl = slice(l * P, (l + 1) * P)
        wk, wo, wf = kernels.release_epilogue_plain(
            {k: c[sl] for k, c in cols.items()}, plan, stds, slots[l],
            tdp.NoiseKind.LAPLACE, False, 2.5, 0.0, sel, lane_keys()[l] + 7,
            1, tables)
        assert torch.equal(keep[sl], wk)
        assert int(flags[l]) == int(wf[0])
        for name, col in wo.items():
            assert torch.equal(outs[name][sl], col)
    # The directly noised slot lies on its grid.
    pid_grid = float(tables[1][3])
    assert bool((torch.remainder(outs["privacy_id_count"], pid_grid) == 0)
                .all())


def quantile_rows():
    """[L * P] leaf histograms of a height-2, branching-4 tree."""
    gen = torch.Generator().manual_seed(5)
    return torch.randint(0, 9, (LANES * P, 16), generator=gen,
                         dtype=torch.int32)


@pytest.mark.parametrize("secure", [False, True], ids=["plain", "secure"])
@pytest.mark.parametrize("regime", ["dense", "lazy"])
def test_quantile_descend_lanes_plain_is_each_lanes_descent(regime, secure):
    leaves = quantile_rows()
    quantiles = (0.9, 0.1, 0.5)
    tables = None
    if secure:
        thr, gran = lane_tables(np.array([3.0]))
        tables = (thr[0], float(gran[0]))
    keep = torch.rand(LANES * P, generator=torch.Generator().manual_seed(2)
                      ) < 0.7
    common = dict(std=3.0, gaussian=False, min_v=0.0, max_v=8.0)
    qkeys = lane_keys() + 11
    flags = torch.zeros(LANES, dtype=torch.int32)
    if regime == "dense":
        levels = kernels.quantile_level_counts(leaves, tree_height=2,
                                               branching=4)
        level_keys = np.stack([[threefry.fold_in(k, j) for j in range(2)]
                               for k in qkeys])
        got = kernels.quantile_descend_dense_lanes(
            levels, quantiles, level_keys=level_keys, keep=keep, flags=flags,
            dtype=F64, n_lanes=LANES, tables=tables, **common)
    else:
        state = kernels.DescentState(LANES * P, 3, F64, "cpu")
        for level in (1, 2):
            counts = torch.stack([torch.stack([
                leaves[p].reshape(4, 4).sum(1, dtype=torch.int32)
                if level == 1 else leaves[p].reshape(4, 4)[int(n)]
                for n in state.node[p]]) for p in range(LANES * P)])
            got = kernels.quantile_descend_step_lanes(
                counts.contiguous(), state, quantiles, level=level,
                tree_height=2, level_keys=np.stack(
                    [threefry.fold_in(k, level) for k in qkeys]),
                keep=keep, flags=flags, n_lanes=LANES, tables=tables,
                **common)
    assert got.shape == (3, LANES * P)
    for l in range(LANES):
        sl = slice(l * P, (l + 1) * P)
        lane_flags = torch.zeros(1, dtype=torch.int32)
        if regime == "dense":
            want = kernels.quantile_descend_dense_plain(
                [t[sl] for t in levels], quantiles,
                level_keys=level_keys[l], keep=keep[sl], flags=lane_flags,
                dtype=F64, tables=tables, **common)
        else:
            lane = kernels.DescentState(P, 3, F64, "cpu")
            for level in (1, 2):
                counts = torch.stack([torch.stack([
                    leaves[l * P + p].reshape(4, 4).sum(1, dtype=torch.int32)
                    if level == 1 else
                    leaves[l * P + p].reshape(4, 4)[int(n)]
                    for n in lane.node[p]]) for p in range(P)])
                want = kernels.quantile_descend_step_plain(
                    counts.contiguous(), lane, quantiles, level=level,
                    tree_height=2, level_key=threefry.fold_in(qkeys[l],
                                                              level),
                    keep=keep[sl], flags=lane_flags, tables=tables,
                    **common)
            assert torch.equal(state.node[sl], lane.node)
        assert torch.equal(got[:, sl], want)
        assert int(flags[l]) == int(lane_flags[0])


@pytest.mark.parametrize("secure", [False, True], ids=["plain", "secure"])
def test_vector_release_lanes_plain_is_each_lanes_release(secure):
    gen = torch.Generator().manual_seed(8)
    vsum = torch.randint(-40, 40, (LANES * P, V), generator=gen).double()
    vsum[0, 0] = float("nan")
    keep = torch.ones(LANES * P, dtype=torch.bool)
    flags = torch.zeros(LANES, dtype=torch.int32)
    tables = None
    if secure:
        thr, gran = lane_tables(np.array([4.0]), tdp.NoiseKind.GAUSSIAN)
        tables = (thr[0], float(gran[0]))
    keys = lane_keys() + 21
    args = dict(max_norm=30.0, norm_kind="l2", std=4.0, gaussian=True,
                tables=tables)
    got = kernels.vector_release_lanes(vsum, keep, flags, keys=keys,
                                       n_lanes=LANES, **args)
    for l in range(LANES):
        sl = slice(l * P, (l + 1) * P)
        lane_flags = torch.zeros(1, dtype=torch.int32)
        want = kernels.vector_release_plain(vsum[sl], keep[sl], lane_flags,
                                            key=keys[l], **args)
        assert torch.equal(got[sl].nan_to_num(7.0), want.nan_to_num(7.0))
        assert int(flags[l]) == int(lane_flags[0])
    assert int(flags[0]) != 0 and int(flags[1]) == 0


def test_compact_kept_lanes_moves_vector_rows_whole():
    gen = torch.Generator().manual_seed(4)
    keep = torch.rand(LANES * P, generator=gen) < 0.5
    cols = {"vector_sum": torch.randn(LANES * P, V, generator=gen,
                                      dtype=F64),
            "count": torch.randn(LANES * P, generator=gen, dtype=F64)}
    n_kept, order, out = kernels.compact_kept_lanes(keep, cols, LANES)
    assert out["vector_sum"].shape == (LANES, P, V)
    assert out["count"].shape == (LANES, P)
    for l in range(LANES):
        sl = slice(l * P, (l + 1) * P)
        wn, wo, wc = kernels.compact_kept_plain(
            keep[sl], {k: c[sl] for k, c in cols.items()})
        assert int(n_kept[l]) == int(wn) and torch.equal(order[l], wo)
        for k in cols:
            assert torch.equal(out[k][l], wc[k])


def test_lane_capacity_caps_the_percentile_and_vector_tables():
    # The dense quantile regime at the Netflix width: 512 partitions of
    # 16^4 leaves lets 63 lanes through (2^31 / 2^25), VECTOR_SUM's P x V
    # sums cap lanes as the partitions do.
    assert kernels.lane_capacity(1 << 20, 512, 512 * 16**4) == 63
    assert kernels.lane_capacity(1 << 10, 17_770, 17_770 * 8) == \
        (2**31 - 1) // (17_770 * 8)
    assert kernels.lane_capacity(1 << 20, 17_770) == 2047


# ---------------------------------------------------------------------------
# The meshed lane-batched release (K24c) against the solo meshed release.


def spec_config(metrics, noise, opts, n_partitions=P):
    """(cfg, stds, scalars, secure tables or None) of a spec on the port
    (public partitions, epsilon 20 or opts["eps"])."""
    M = tdp.Metrics
    ms = []
    for m in metrics:
        ms += ([M.PERCENTILE(q) for q in (10, 50, 90)] if m == "PERCENTILE"
               else [getattr(M, m)])
    bounds = dict(max_partitions_contributed=3,
                  max_contributions_per_partition=2)
    if opts.get("vector"):
        bounds.update(vector_size=V, vector_max_norm=6.0,
                      vector_norm_kind=tdp.NormKind.L2)
    else:
        bounds.update(min_value=0.0, max_value=5.0)
    params = tdp.AggregateParams(metrics=ms,
                                 noise_kind=getattr(tdp.NoiseKind, noise),
                                 **bounds)
    acc = tdp.NaiveBudgetAccountant(total_epsilon=opts.get("eps", 20.0),
                                    total_delta=1e-5)
    compound = combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    secure = bool(opts.get("secure"))
    cfg = executor.make_kernel_config(
        params, compound, n_partitions, False, None, secure=secure,
        numeric_mode="safe" if opts.get("safe") else "fast")
    if "tree" in opts:
        cfg = dataclasses.replace(cfg, tree_height=3, branching=4)
    if "chunk" in opts:
        cfg = dataclasses.replace(cfg, quantile_chunk=opts["chunk"])
    stds = executor.compute_noise_stds(compound)
    tables = (executor.build_secure_tables(
        stds, executor.compute_noise_sensitivities(compound, params),
        params.noise_kind, None, "cpu") if secure else None)
    return cfg, stds, executor.kernel_scalars(params), tables


MESH_SPECS = {
    "percentile_dense": (("PERCENTILE", "COUNT"), "LAPLACE", {"tree": 3}),
    "percentile_lazy": (("PERCENTILE",), "GAUSSIAN",
                        {"tree": 3, "chunk": 4}),
    "vector_sum": (("VECTOR_SUM", "COUNT"), "GAUSSIAN", {"vector": True}),
    "safe": (("COUNT", "SUM"), "LAPLACE", {"safe": True, "eps": 1e7}),
    "secure_percentile": (("PERCENTILE", "SUM"), "LAPLACE",
                          {"secure": True, "tree": 3}),
}


@pytest.mark.parametrize("name", sorted(MESH_SPECS))
def test_meshed_batched_lanes_equal_their_solo_meshed_releases(name):
    metrics, noise, opts = MESH_SPECS[name]
    cfg, stds, sc, tables = spec_config(metrics, noise, opts)
    dtype = F32 if opts.get("safe") else F64
    pid, pk, values, valid = lane_rows(6, V if opts.get("vector") else 0,
                                       dtype)
    pid[2] = pid[0]  # one staged layout for every lane
    mesh = make_mesh(["cpu"] * 2)
    staged = [sharded.shard_rows_by_pid(pid[l].numpy(), pk[l].numpy(),
                                        values[l].numpy(), valid[l].numpy(),
                                        mesh.size) for l in range(LANES)]
    shards = sharded.stage_lanes(mesh, staged, dtype)
    keys = lane_keys()
    n_kept, order, outputs, flags = sharded.sharded_batched_release(
        mesh, shards, *sc, stds, keys, cfg, tables)
    assert int(n_kept[0]) > 0
    for l in range(LANES):
        want = sharded.sharded_aggregate_arrays(
            mesh, pid[l].numpy(), pk[l].numpy(), values[l].numpy(),
            valid[l].numpy(), *sc, stds, keys[l], cfg, tables, dtype=dtype)
        assert int(n_kept[l]) == int(want[0])
        assert torch.equal(order[l], want[1])
        assert set(outputs) == set(want[2])
        for col, exp in want[2].items():
            assert torch.equal(outputs[col][l], exp), col
        assert int(flags[l]) == int(want[3].reshape(()))


# ---------------------------------------------------------------------------
# The service: every spec coalesces, each job equal to its solo run and to
# the JAX service's job.


def rows(seed, n=240, users=120, vector=0):
    r = np.random.default_rng(seed)
    pid = r.integers(0, users, n)
    pk = r.integers(0, 8, n)
    if vector:
        values = r.integers(-3, 4, (n, vector)).astype(float)
        return [(int(u), f"p{int(p)}", v) for u, p, v in zip(pid, pk,
                                                             values)]
    values = r.integers(0, 6, n).astype(float)
    return [(int(u), f"p{int(p)}", float(v)) for u, p, v in zip(pid, pk,
                                                               values)]


PUBLIC = [f"p{i}" for i in range(8)]
# name: (metrics, noise, params' bounds, backend options, epsilon)
SERVICE_SPECS = {
    "percentile": (("COUNT", "PERCENTILE"), "LAPLACE", {}, {}, 5.0),
    "vector_sum": (("VECTOR_SUM",), "GAUSSIAN",
                   {"vector_size": V, "vector_max_norm": 5.0}, {}, 5.0),
    "max_contributions": (("COUNT", "SUM"), "LAPLACE",
                          {"max_contributions": 3}, {}, 5.0),
    "bounds_enforced": (("COUNT", "SUM"), "GAUSSIAN",
                        {"contribution_bounds_already_enforced": True}, {},
                        5.0),
    "secure_noise": (("COUNT", "SUM", "MEAN"), "LAPLACE", {},
                     {"secure_noise": True}, 5.0),
    "safe": (("COUNT", "SUM"), "LAPLACE", {}, {"numeric_mode": "safe"},
             1e7),
}


def service_params(mod, name):
    metrics, noise, bounds, _, _ = SERVICE_SPECS[name]
    fields = dict(min_value=0.0, max_value=5.0)
    if "max_contributions" not in bounds:
        fields.update(max_partitions_contributed=2,
                      max_contributions_per_partition=2)
    if "vector_size" in bounds:
        del fields["min_value"], fields["max_value"]
        fields["vector_norm_kind"] = mod.NormKind.Linf
    fields.update(bounds)
    ms = []
    for m in metrics:
        ms += ([mod.Metrics.PERCENTILE(q) for q in (25, 75)]
               if m == "PERCENTILE" else [getattr(mod.Metrics, m)])
    return mod.AggregateParams(metrics=ms,
                               noise_kind=getattr(mod.NoiseKind, noise),
                               **fields)


def service_jobs(mod, name, spec_cls):
    eps = SERVICE_SPECS[name][4]
    vector = V if name == "vector_sum" else 0
    # Pre-bounded rows come without a privacy id extractor.
    extractors = (mod.DataExtractors(partition_extractor=lambda r: r[1],
                                     value_extractor=lambda r: r[2])
                  if name == "bounds_enforced" else None)
    return [(f"tenant{i}", spec_cls(params=service_params(mod, name),
                                    epsilon=eps, delta=1e-5,
                                    noise_seed=70 + i,
                                    public_partitions=PUBLIC,
                                    data_extractors=extractors),
             rows(90 + i, vector=vector)) for i in range(3)]


def plain(results):
    """Releases with their vector sums as lists, comparable with ==."""
    return [{key: {field: np.asarray(v).tolist()
                   for field, v in metrics._asdict().items()}
             for key, metrics in release.items()} for release in results]


def run_port_service(name, batching):
    options = dict(SERVICE_SPECS[name][3])
    dtype = F32 if options.get("numeric_mode") == "safe" else F64
    jobs = service_jobs(tdp, name, JobSpec)
    with DPAggregationService(
            tdp.TorchBackend(device="cpu", dtype=dtype, **options),
            max_concurrent_jobs=len(jobs), batching=batching,
            batch_window_ms=30_000.0, max_batch_jobs=len(jobs)) as svc:
        handles = [svc.submit(t, s, r) for t, s, r in jobs]
        results = [h.result(timeout=120) for h in handles]
        spent = [h.spent_epsilon for h in handles]
        trails = {t: svc.tenant_ledger(t).records() for t, _, _ in jobs}
        assert svc.ledgers_reconciled()
    return plain(results), spent, trails


def run_jax_service(name):
    jobs = service_jobs(pdp, name, JaxJobSpec)
    jax_telemetry.reset()
    try:
        with JaxService(pdp.TPUBackend(**SERVICE_SPECS[name][3]),
                        max_concurrent_jobs=len(jobs), batching=False) as svc:
            handles = [svc.submit(t, s, r) for t, s, r in jobs]
            results = [h.result(timeout=120) for h in handles]
            spent = [svc.tenant_ledger(t).job_spent_epsilon(h.job_id)
                     for (t, _, _), h in zip(jobs, handles)]
    finally:
        jax_telemetry.reset()
    return results, spent


def assert_close_to_jax(name, got, want):
    safe = SERVICE_SPECS[name][3].get("numeric_mode") == "safe"
    secure = SERVICE_SPECS[name][3].get("secure_noise")
    assert set(got) == set(want) and got
    for key, metrics in want.items():
        assert list(got[key]) == list(metrics._fields)
        for field, b in metrics._asdict().items():
            a = np.asarray(got[key][field], np.float64)
            b = np.asarray(b, np.float64)
            if safe:
                ulp = np.spacing(np.abs(b).astype(np.float32))
                assert np.all(np.abs(a - b) <= ulp), (key, field)
            elif secure and field in ("count", "sum"):
                np.testing.assert_array_equal(a, b)
            else:
                assert np.all(np.abs(a - b) <= 1e-9 * np.maximum(
                    1.0, np.abs(b))), (key, field)


@pytest.mark.hard_timeout(180)
@pytest.mark.parametrize("name", sorted(SERVICE_SPECS))
def test_every_spec_coalesces_and_equals_solo_and_jax(name, request):
    if SERVICE_SPECS[name][3].get("numeric_mode") == "safe":
        request.getfixturevalue("x64_off")
    solo = run_port_service(name, batching=False)
    snap = telemetry.snapshot()
    assert snap.get("service_batch_launches", 0) == 0
    batched = run_port_service(name, batching=True)
    snap = telemetry.snapshot()
    assert snap.get("service_batch_launches", 0) == 1
    assert snap.get("service_jobs_batched", 0) == 3
    assert solo == batched
    want, want_spent = run_jax_service(name)
    assert batched[1] == want_spent
    for got, exp in zip(batched[0], want):
        assert_close_to_jax(name, got, exp)


def secure_launch(snap_bits, sens=np.ones(2), stds=np.array([2.0, 3.0])):
    """A secure launch as lazy_aggregate offers it: the device tables and
    what they are built from beside stds and the noise kind."""
    tables = executor.build_secure_tables(stds, sens, tdp.NoiseKind.LAPLACE,
                                          snap_bits, "cpu")
    return executor.ReleaseLaunch(
        kind="aggregate", pid=np.zeros(8, np.int32),
        pk=np.zeros(8, np.int32), valid=np.ones(8, bool),
        key=np.zeros(2, np.uint32), device=torch.device("cpu"), dtype=F64,
        values=np.zeros(8), scalars=(0.0,) * 5, stds=stds, cfg=None,
        secure_tables=tables, tables_key=(sens.tobytes(), snap_bits))


def test_group_key_holds_what_the_secure_tables_are_built_from():
    # Equal cfg, scalars and stds on two backends whose snap_grid_bits
    # differ build different tables: a presence flag would group them and
    # one lane would draw from the other job's table. The key holds the
    # tables' inputs, read on the host: equal inputs, equal tables.
    a, b = secure_launch(None), secure_launch(None)
    assert a.secure_tables[0] is not b.secure_tables[0]
    assert torch.equal(a.secure_tables[0], b.secure_tables[0])
    assert batching._group_key(a) == batching._group_key(b)
    for other in (secure_launch(6), secure_launch(None, sens=np.full(2, 3.0))):
        assert not torch.equal(other.secure_tables[0], a.secure_tables[0]) \
            or not np.array_equal(other.secure_tables[1], a.secure_tables[1])
        assert batching._group_key(a) != batching._group_key(other)
    plain = dataclasses.replace(a, secure_tables=None, tables_key=None)
    assert batching._group_key(a) != batching._group_key(plain)


@pytest.mark.hard_timeout(120)
def test_snapped_secure_jobs_coalesce_on_their_grid():
    jobs = service_jobs(tdp, "secure_noise", JobSpec)[:2]
    results = []
    for bits in (None, 6):
        with DPAggregationService(
                tdp.TorchBackend(device="cpu", dtype=F64, secure_noise=True,
                                 snap_grid_bits=bits),
                max_concurrent_jobs=2, batching=True,
                batch_window_ms=30_000.0, max_batch_jobs=2) as svc:
            handles = [svc.submit(t, s, r) for t, s, r in jobs]
            results.append([h.result(timeout=120) for h in handles])
    snap = telemetry.snapshot()
    assert snap.get("service_batch_launches", 0) == 2
    assert results[0] != results[1]
    grid = 2.0**6
    for release in results[1]:
        for metrics in release.values():
            assert metrics.count % grid == 0
