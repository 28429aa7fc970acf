"""Megabatched serving on the port (pipelinedp_tpu_torch/service/batching.py
and the lane entries of kernels.py), on the CPU: the plain versions.

Bounds stated here:
  * each lane entry's plain version equals the solo plain kernels on each
    lane's slice, exactly (integers and floats);
  * a lane of the port's batched release equals the port's solo release on
    its rows and key alone, exactly (every output column, order, flags);
  * the port's batched release against the JAX package's
    batched_aggregate_release_kernel / batched_select_partitions_release_kernel
    (x64, CPU) on the same rows and keys: n_kept, the kept ids and their
    order exact; the directly noised columns (count, sum,
    privacy_id_count) within 256 ulp of max(1, |x|) under Laplace noise and
    64 ulp under Gaussian noise (tests/test_torch_threefry.py), the
    derived mean and variance within 1e-9 of max(1, |x|), the bound of
    tests/test_torch_engine.py;
  * the service: every batched job equals its solo run (release, spent
    epsilon, ledger), and equals the JAX service's job with the same seed
    within the bounds of tests/test_torch_engine.py.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu import combiners as jax_combiners
from pipelinedp_tpu.ops import selection_ops as jax_selection_ops
from pipelinedp_tpu.runtime import telemetry as jax_telemetry
from pipelinedp_tpu.service import DPAggregationService as JaxService
from pipelinedp_tpu.service import JobSpec as JaxJobSpec
from pipelinedp_tpu_torch import combiners
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry
from pipelinedp_tpu_torch.runtime import observability as obs
from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.runtime import trace
from pipelinedp_tpu_torch.service import (DPAggregationService, JobSpec,
                                          JobStatus)
from pipelinedp_tpu_torch.service import batching

pytestmark = pytest.mark.torch_port

F64 = torch.float64
LANES, LANE_ROWS, P = 3, 300, 12


@pytest.fixture(autouse=True)
def _epoch():
    telemetry.reset()
    yield
    trace.disable()
    telemetry.reset()


def lane_rows(seed, n_lanes=LANES, n=LANE_ROWS, users=60, partitions=P):
    """[L, n] rows; lanes 0 and 1 share their privacy ids (equal keys may
    sit side by side across the lane boundary)."""
    r = np.random.default_rng(seed)
    pid = torch.as_tensor(r.integers(0, users, (n_lanes, n)),
                          dtype=torch.int32)
    pid[1] = pid[0]
    pk = torch.as_tensor(r.integers(0, partitions, (n_lanes, n)),
                         dtype=torch.int32)
    values = torch.as_tensor(r.uniform(0.0, 5.0, (n_lanes, n)), dtype=F64)
    valid = torch.as_tensor(r.uniform(size=(n_lanes, n)) < 0.95)
    return pid, pk, values, valid


def lane_keys(n_lanes=LANES):
    keys = np.array([[0, 40 + l] for l in range(n_lanes)], np.uint32)
    keys[1] = keys[0]  # two lanes with one key
    return keys


def lane_salts(keys):
    salts, linf, _, _ = executor.lane_release_keys(keys, ())
    return salts, linf


# ---------------------------------------------------------------------------
# Each lane entry's plain version against the solo plain kernels.


def sorted_lane_rows():
    pid, pk, values, valid = lane_rows(1)
    salts, linf = lane_salts(lane_keys())
    flat = [t.reshape(-1) for t in (pid, pk, values, valid)]
    lane, k1, k2, u = kernels.row_keys_lanes(flat[0], flat[1], flat[3],
                                             LANE_ROWS, salts, linf, P, F64)
    perm = kernels.radix_sort([lane, k1, k2, u])
    return (pid, pk, values, valid), flat, (lane, k1, k2, u), perm, salts, \
        linf


def test_row_keys_lanes_plain_is_each_lanes_row_keys():
    (pid, pk, _, valid), _, (lane, k1, k2, u), _, salts, linf = \
        sorted_lane_rows()
    for l in range(LANES):
        sl = slice(l * LANE_ROWS, (l + 1) * LANE_ROWS)
        want = kernels.row_keys_plain(pid[l], pk[l], valid[l], salts[l],
                                      linf[l], P, F64)
        for got, exp in zip((k1[sl], k2[sl], u[sl]), want):
            assert torch.equal(got, exp)
        assert bool((lane[sl] == l).all())
    no_u = kernels.row_keys_lanes(pid.reshape(-1), pk.reshape(-1),
                                  valid.reshape(-1), LANE_ROWS, salts, None,
                                  P, None)
    assert no_u[3] is None and torch.equal(no_u[1], k1)


def test_sort_with_the_lane_word_sorts_each_lane_as_alone():
    _, _, (lane, k1, k2, u), perm, _, _ = sorted_lane_rows()
    for l in range(LANES):
        sl = slice(l * LANE_ROWS, (l + 1) * LANE_ROWS)
        solo = kernels.radix_sort_plain([k1[sl], k2[sl], u[sl]])
        assert torch.equal(perm[sl] - l * LANE_ROWS, solo)


@pytest.mark.parametrize("clip_pair_sum", [False, True])
@pytest.mark.parametrize("linf", [0, 2])
def test_bound_rows_lanes_plain_is_each_lanes_bound_rows(linf, clip_pair_sum):
    _, flat, (_, k1, k2, _), perm, _, _ = sorted_lane_rows()
    cols = ("sum", "nsum", "nsum2")
    args = dict(n_partitions=P, linf=linf, l0=3, clip_per_value=True,
                clip_pair_sum=clip_pair_sum,
                scalars=(0.0, 5.0, 0.0, 6.0, 2.5), columns=cols)
    key2, start, got = kernels.bound_rows_lanes(perm, k1, k2, flat[2],
                                                flat[3], lane_rows=LANE_ROWS,
                                                **args)
    for l in range(LANES):
        sl = slice(l * LANE_ROWS, (l + 1) * LANE_ROWS)
        w2, ws, wc = kernels.bound_rows_plain(perm[sl] - l * LANE_ROWS,
                                              k1[sl], k2[sl], None,
                                              flat[2][sl], flat[3][sl],
                                              **args)
        assert torch.equal(key2[sl], torch.where(w2 < P, w2 + l * P,
                                                 LANES * P).int())
        assert torch.equal(start[sl], ws)
        for c in cols:
            assert torch.equal(got[c][sl], wc[c])


def lane_partitions():
    _, flat, (_, k1, k2, _), perm, _, _ = sorted_lane_rows()
    cols = ("sum", "nsum", "nsum2")
    key2, start, row_cols = kernels.bound_rows_lanes(
        perm, k1, k2, flat[2], flat[3], lane_rows=LANE_ROWS, n_partitions=P,
        linf=2, l0=3, clip_per_value=True, clip_pair_sum=False,
        scalars=(0.0, 5.0, 0.0, 0.0, 2.5), columns=cols)
    perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
    return skey2, perm2, start, row_cols


def test_reduce_partitions_lanes_plain_is_each_lanes_reduction():
    skey2, perm2, start, row_cols = lane_partitions()
    got = kernels.reduce_partitions_lanes(skey2, perm2, start, row_cols,
                                          LANE_ROWS, P, F64)
    for l in range(LANES):
        lo, hi = (int(torch.searchsorted(skey2, torch.tensor(v, dtype=
                                                             torch.int32)))
                  for v in (l * P, (l + 1) * P))
        want = kernels.reduce_partitions_plain(skey2[lo:hi], perm2[lo:hi],
                                               start, row_cols, P, F64,
                                               base=l * P)
        for name, col in want.items():
            assert torch.equal(got[name][l * P:(l + 1) * P], col), name


@pytest.mark.parametrize("private", [False, True])
def test_release_epilogue_lanes_plain_is_each_lanes_epilogue(private):
    skey2, perm2, start, row_cols = lane_partitions()
    cols = kernels.reduce_partitions_lanes(skey2, perm2, start, row_cols,
                                           LANE_ROWS, P, F64)
    plan = [("variance", ("variance", "count", "sum", "mean"), 0),
            ("privacy_id_count", ("privacy_id_count",), 3)]
    stds = np.array([2.0, 5.0, 40.0, 1.5])
    slots = np.stack([[threefry.fold_in(k, s) for s in range(4)]
                      for k in lane_keys()])
    key_sel = lane_keys() + 7
    sel = (selection_ops.selection_params_from_host(
        tdp.PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 5.0, 1e-3, 3,
        None) if private else None)
    keep, outs, flags = kernels.release_epilogue_lanes(
        cols, plan, stds, slots, tdp.NoiseKind.GAUSSIAN, False, 2.5, 0.0,
        sel, key_sel, 1, LANES)
    assert flags.shape == (LANES,)
    for l in range(LANES):
        sl = slice(l * P, (l + 1) * P)
        wk, wo, wf = kernels.release_epilogue_plain(
            {k: c[sl] for k, c in cols.items()}, plan, stds, slots[l],
            tdp.NoiseKind.GAUSSIAN, False, 2.5, 0.0, sel,
            key_sel[l] if private else None, 1)
        assert torch.equal(keep[sl], wk)
        assert int(flags[l]) == int(wf[0])
        for name, col in wo.items():
            assert torch.equal(outs[name][sl], col)


def test_compact_kept_lanes_plain_compacts_each_lane():
    gen = torch.Generator().manual_seed(3)
    keep = torch.rand(LANES * P, generator=gen) < 0.5
    cols = {"a": torch.randn(LANES * P, generator=gen, dtype=F64),
            "b": torch.randn(LANES * P, generator=gen, dtype=F64)}
    n_kept, order, out = kernels.compact_kept_lanes(keep, cols, LANES)
    assert order.shape == (LANES, P)
    for l in range(LANES):
        sl = slice(l * P, (l + 1) * P)
        wn, wo, wc = kernels.compact_kept_plain(keep[sl],
                                                {k: c[sl] for k, c in
                                                 cols.items()})
        assert int(n_kept[l]) == int(wn) and torch.equal(order[l], wo)
        for k in cols:
            assert torch.equal(out[k][l], wc[k])


def test_lane_capacity_bounds_the_int32_keys():
    assert kernels.lane_capacity(1 << 20, 17_770) == 2047  # 2^31 rows
    assert kernels.lane_capacity(64, 48) == 65535
    pid = torch.zeros(2 * 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        kernels.row_keys_lanes(pid, pid, pid.bool(), 8,
                               np.zeros((2, 4), np.uint32), None,
                               (1 << 30), None)


# ---------------------------------------------------------------------------
# The batched release against the solo release, and against the JAX
# package's batched kernels.

SPECS = {
    "count_sum_laplace_private": (("COUNT", "SUM"), "LAPLACE", True),
    "pid_count_laplace_public": (("COUNT", "PRIVACY_ID_COUNT"), "LAPLACE",
                                 False),
    "mean_variance_gaussian_public": (("VARIANCE", "MEAN", "COUNT", "SUM"),
                                      "GAUSSIAN", False),
    "mean_gaussian_private": (("MEAN",), "GAUSSIAN", True),
}


def release_config(mod, comb, exe, sel_ops, metrics, noise, private, eps=50.0):
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-3)
    params = mod.AggregateParams(
        metrics=[getattr(mod.Metrics, m) for m in metrics],
        noise_kind=getattr(mod.NoiseKind, noise),
        max_partitions_contributed=3, max_contributions_per_partition=2,
        min_value=0.0, max_value=5.0)
    compound = comb.create_compound_combiner(params, acc)
    budget = (acc.request_budget(mod.MechanismType.GENERIC) if private
              else None)
    acc.compute_budgets()
    sel = (sel_ops.selection_params_from_host(
        params.partition_selection_strategy, budget.eps, budget.delta, 3,
        None) if private else None)
    cfg = exe.make_kernel_config(params, compound, P, private, sel)
    if mod is pdp:
        stds = exe.compute_noise_stds(compound, params)
    else:
        stds = exe.compute_noise_stds(compound)
    return cfg, np.asarray(stds), exe.kernel_scalars(params)


def port_release(name):
    cfg, stds, sc = release_config(tdp, combiners, executor, selection_ops,
                                   *SPECS[name])
    pid, pk, values, valid = lane_rows(5, users=400)
    keys = lane_keys()
    return (pid, pk, values, valid, keys, cfg, stds, sc,
            executor.batched_aggregate_release_kernel(
                pid, pk, values, valid, *sc, stds, keys, cfg))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_batched_lane_equals_its_solo_release(name):
    pid, pk, values, valid, keys, cfg, stds, sc, got = port_release(name)
    n_kept, order, outputs, flags = got
    assert int(n_kept.sum()) > 0
    for l in range(LANES):
        want = executor.aggregate_release_kernel(
            pid[l], pk[l], values[l], valid[l], *sc, stds, keys[l], cfg)
        assert int(n_kept[l]) == int(want[0])
        assert torch.equal(order[l], want[1])
        assert set(outputs) == set(want[2])
        for col, exp in want[2].items():
            assert torch.equal(outputs[col][l], exp), col
        assert int(flags[l]) == int(want[3].reshape(()))


def test_a_lane_without_rows_equals_its_solo_release():
    cfg, stds, sc = release_config(tdp, combiners, executor, selection_ops,
                                   *SPECS["count_sum_laplace_private"])
    pid, pk, values, valid = lane_rows(6, users=400)
    valid[0] = False
    keys = lane_keys()
    n_kept, order, outputs, flags = executor.batched_aggregate_release_kernel(
        pid, pk, values, valid, *sc, stds, keys, cfg)
    for l in range(LANES):
        want = executor.aggregate_release_kernel(
            pid[l], pk[l], values[l], valid[l], *sc, stds, keys[l], cfg)
        assert int(n_kept[l]) == int(want[0])
        assert torch.equal(order[l], want[1])
        for col, exp in want[2].items():
            assert torch.equal(outputs[col][l], exp), col
    assert int(n_kept[0]) == 0


def ulp_bound(noise, name):
    if name in ("mean", "variance"):
        return None
    return 256 if noise == "LAPLACE" else 64


@pytest.mark.parametrize("name", sorted(SPECS))
def test_batched_release_matches_the_jax_batched_kernel(name):
    pid, pk, values, valid, keys, _, _, _, got = port_release(name)
    cfg, stds, sc = release_config(pdp, jax_combiners, jax_executor,
                                   jax_selection_ops, *SPECS[name])
    want = jax_executor.batched_aggregate_release_kernel(
        jnp.asarray(pid.numpy()), jnp.asarray(pk.numpy()),
        jnp.asarray(values.numpy()), jnp.asarray(valid.numpy()), *sc,
        jnp.asarray(stds), jnp.asarray(keys), cfg)
    n_kept, order, outputs, _ = got
    noise = SPECS[name][1]
    for l in range(LANES):
        k = int(want[0][l])
        assert int(n_kept[l]) == k
        assert np.array_equal(order[l][:k].numpy(),
                              np.asarray(want[1][l][:k]))
        for col, exp in want[2].items():
            a = outputs[col][l][:k].numpy()
            b = np.asarray(exp[l][:k], np.float64)
            scale = np.maximum(1.0, np.abs(b))
            bound = ulp_bound(noise, col)
            if bound is None:
                assert np.all(np.abs(a - b) <= 1e-9 * scale), col
            else:
                assert np.all(np.abs(a - b) <= bound * np.spacing(scale)), col


@pytest.mark.parametrize("strategy", ["TRUNCATED_GEOMETRIC",
                                      "LAPLACE_THRESHOLDING",
                                      "GAUSSIAN_THRESHOLDING"])
def test_batched_selection_matches_solo_and_jax(strategy):
    pid, pk, _, valid = lane_rows(9, users=2000, n=3000)
    keys = lane_keys()
    sel = selection_ops.selection_params_from_host(
        getattr(tdp.PartitionSelectionStrategy, strategy), 3.0, 1e-3, 2,
        None)
    n_kept, order = executor.batched_select_partitions_release_kernel(
        pid, pk, valid, keys, 2, P, sel, F64)
    assert int(n_kept.sum()) > 0
    jsel = jax_selection_ops.selection_params_from_host(
        getattr(pdp.PartitionSelectionStrategy, strategy), 3.0, 1e-3, 2,
        None)
    jn, jorder = jax_executor.batched_select_partitions_release_kernel(
        jnp.asarray(pid.numpy()), jnp.asarray(pk.numpy()),
        jnp.asarray(valid.numpy()), jnp.asarray(keys), 2, P, jsel)
    for l in range(LANES):
        solo = executor.select_partitions_release_kernel(
            pid[l], pk[l], valid[l], keys[l], 2, P, sel, F64)
        assert int(n_kept[l]) == int(solo[0]) == int(jn[l])
        assert torch.equal(order[l], solo[1])
        k = int(jn[l])
        assert np.array_equal(order[l][:k].numpy(), np.asarray(jorder[l][:k]))


def test_unported_specs_are_named():
    def cfg_of(**kw):
        params = tdp.AggregateParams(
            metrics=kw.pop("metrics", [tdp.Metrics.COUNT]), min_value=0.0,
            max_value=1.0, max_partitions_contributed=1,
            max_contributions_per_partition=1, **kw)
        acc = tdp.NaiveBudgetAccountant(1.0, 1e-6)
        compound = combiners.create_compound_combiner(params, acc)
        return params, compound

    params, compound = cfg_of()
    assert executor.lanes_unported(executor.make_kernel_config(
        params, compound, 4, False, None)) is None
    assert executor.lanes_unported(executor.make_kernel_config(
        params, compound, 4, False, None, secure=True)) == "secure_noise"
    assert "safe" in executor.lanes_unported(executor.make_kernel_config(
        params, compound, 4, False, None, numeric_mode="safe"))
    params, compound = cfg_of(metrics=[tdp.Metrics.PERCENTILE(50)])
    assert executor.lanes_unported(executor.make_kernel_config(
        params, compound, 4, False, None)) == "PERCENTILE"
    with pytest.raises(NotImplementedError, match="PERCENTILE"):
        executor.batched_aggregate_release_kernel(
            *lane_rows(1), 0.0, 1.0, 0.0, 0.0, 0.5, np.ones(1), lane_keys(),
            executor.make_kernel_config(params, compound, P, False, None))


# ---------------------------------------------------------------------------
# The service with batching on.


def rows(seed, n=200, users=40, partitions=10):
    r = np.random.default_rng(seed)
    return [(int(r.integers(0, users)), f"p{int(r.integers(0, partitions))}",
             float(r.uniform(0, 5))) for _ in range(n)]


PUBLIC = [f"p{i}" for i in range(10)]


def agg_spec(mod, seed, metrics=("COUNT", "SUM"), priority=0, public=True,
             spec_cls=JobSpec, noise="LAPLACE", epsilon=1.0):
    params = mod.AggregateParams(
        metrics=[getattr(mod.Metrics, m) for m in metrics],
        noise_kind=getattr(mod.NoiseKind, noise),
        max_partitions_contributed=2, max_contributions_per_partition=3,
        min_value=0.0, max_value=5.0)
    return spec_cls(params=params, epsilon=epsilon, delta=1e-3,
                    noise_seed=seed, priority=priority,
                    public_partitions=PUBLIC if public else None)


def select_spec(mod, seed, spec_cls=JobSpec):
    return spec_cls(params=mod.SelectPartitionsParams(
        max_partitions_contributed=2), epsilon=3.0, delta=1e-3,
        noise_seed=seed)


def torch_backend():
    return tdp.TorchBackend(device="cpu", dtype=F64)


def run_service(jobs, batching, window_ms=30_000.0, **kwargs):
    """Runs (tenant, spec, rows) jobs at once; returns results, spent
    epsilons, the reconciliation verdict and each tenant's ledger trail."""
    service_kwargs = dict(max_concurrent_jobs=len(jobs), batching=batching,
                          batch_window_ms=window_ms,
                          max_batch_jobs=max(2, len(jobs)))
    service_kwargs.update(kwargs)
    with DPAggregationService(torch_backend(), **service_kwargs) as svc:
        handles = [svc.submit(t, s, r) for t, s, r in jobs]
        results = [h.result(timeout=120) for h in handles]
        spent = [h.spent_epsilon for h in handles]
        trails = {t: svc.tenant_ledger(t).records() for t, _, _ in jobs}
        reconciled = svc.ledgers_reconciled()
    return results, spent, reconciled, trails


def batch_counters():
    snap = telemetry.snapshot()
    return (snap.get("service_batch_launches", 0),
            snap.get("service_jobs_batched", 0))


@pytest.mark.hard_timeout(120)
@pytest.mark.parametrize("metrics,public", [
    (("COUNT", "SUM"), True), (("MEAN",), True),
    (("COUNT", "PRIVACY_ID_COUNT"), False)],
    ids=["count_sum", "mean", "pid_count_private"])
def test_batched_jobs_equal_their_solo_runs(metrics, public):
    jobs = [(f"tenant{i}", agg_spec(tdp, 50 + i, metrics, public=public,
                                    epsilon=1.0 if public else 20.0),
             rows(7 + i, users=400)) for i in range(4)]
    solo = run_service(jobs, batching=False)
    assert batch_counters() == (0, 0)
    batched = run_service(jobs, batching=True)
    assert batch_counters() == (1, 4)
    assert solo[2] and batched[2]
    assert solo[1] == batched[1]
    assert solo[3] == batched[3]
    assert solo[0] == batched[0]
    assert any(solo[0])


@pytest.mark.hard_timeout(120)
def test_batched_selection_jobs_equal_their_solo_runs():
    jobs = [(f"tenant{i}", select_spec(tdp, 70 + i),
             rows(19 + i, n=300, users=300)) for i in range(3)]
    solo = run_service(jobs, batching=False)
    batched = run_service(jobs, batching=True)
    assert batch_counters() == (1, 3)
    assert solo[0] == batched[0] and any(solo[0])
    assert solo[1] == batched[1] and solo[3] == batched[3]


@pytest.mark.hard_timeout(180)
@pytest.mark.parametrize("batching", [False, True])
def test_service_equals_the_jax_service_job_by_job(batching):
    jobs = [(f"tenant{i}", i, rows(31 + i, users=400)) for i in range(3)]
    port = run_service([(t, agg_spec(tdp, 90 + s, ("COUNT", "SUM", "MEAN")),
                         r) for t, s, r in jobs], batching=batching)
    jax_telemetry.reset()
    with JaxService(pdp.TPUBackend(), max_concurrent_jobs=3,
                    batching=batching, batch_window_ms=30_000.0,
                    max_batch_jobs=3) as svc:
        handles = [svc.submit(t, agg_spec(pdp, 90 + s, ("COUNT", "SUM",
                                                         "MEAN"),
                                          spec_cls=JaxJobSpec), r)
                   for t, s, r in jobs]
        want = [h.result(timeout=120) for h in handles]
        want_spent = [svc.tenant_ledger(t).job_spent_epsilon(h.job_id)
                      for (t, _, _), h in zip(jobs, handles)]
    jax_telemetry.reset()
    assert port[1] == want_spent
    for got, exp in zip(port[0], want):
        assert set(got) == set(exp) and got
        for key, metrics in exp.items():
            assert got[key]._fields == metrics._fields
            for a, b in zip(got[key], metrics):
                assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)


@pytest.mark.hard_timeout(120)
def test_mixed_specs_never_coalesce():
    jobs = [("ta", agg_spec(tdp, 1, ("COUNT",)), rows(1)),
            ("tb", agg_spec(tdp, 2, ("SUM",)), rows(2))]
    solo = run_service(jobs, batching=False, window_ms=200.0)
    batched = run_service(jobs, batching=True, window_ms=200.0)
    assert batch_counters() == (0, 0)
    assert batched[2] and solo[0] == batched[0]


@pytest.mark.hard_timeout(120)
def test_lone_window_runs_solo():
    job = [("t0", agg_spec(tdp, 5), rows(5))]
    solo = run_service(job, batching=False, window_ms=100.0)
    batched = run_service(job, batching=True, window_ms=100.0)
    assert batch_counters() == (0, 0)
    assert solo[0] == batched[0]


@pytest.mark.hard_timeout(120)
def test_unported_specs_run_solo_and_are_counted():
    params = tdp.AggregateParams(
        metrics=[tdp.Metrics.PERCENTILE(50)], max_partitions_contributed=2,
        max_contributions_per_partition=3, min_value=0.0, max_value=5.0)
    jobs = [(f"t{i}", JobSpec(params=params, epsilon=1.0, delta=1e-6,
                              noise_seed=60 + i, public_partitions=PUBLIC),
             rows(60 + i)) for i in range(2)]
    solo = run_service(jobs, batching=False)
    batched = run_service(jobs, batching=True)
    assert batch_counters() == (0, 0)
    assert telemetry.snapshot().get("service_jobs_solo_unported") == 2
    assert solo[0] == batched[0]


@pytest.mark.hard_timeout(120)
def test_priority_is_kept_with_batching():
    with DPAggregationService(torch_backend(), max_concurrent_jobs=1,
                              batching=True, batch_window_ms=50.0,
                              max_batch_jobs=4,
                              queue_timeout_s=300.0) as svc:
        first = svc.submit("t0", agg_spec(tdp, 10), rows(3))
        late = svc.submit("t1", agg_spec(tdp, 11, priority=5), rows(3))
        urgent = svc.submit("t2", agg_spec(tdp, 12, priority=1), rows(3))
        for h in (first, late, urgent):
            h.result(timeout=120)
        assert urgent._started_at < late._started_at


@pytest.mark.hard_timeout(120)
def test_stop_wakes_a_pending_window():
    jobs = [(f"tenant{i}", agg_spec(tdp, 110 + i), rows(41 + i))
            for i in range(2)]
    solo = run_service(jobs, batching=False)
    telemetry.reset()
    with DPAggregationService(torch_backend(), max_concurrent_jobs=2,
                              batching=True, batch_window_ms=120_000.0,
                              max_batch_jobs=8) as svc:
        handles = [svc.submit(t, s, r) for t, s, r in jobs]
        deadline = time.monotonic() + 60.0
        while (not all(h.status == JobStatus.RUNNING for h in handles)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        time.sleep(0.5)
        svc.stop()
        results = [h.result(timeout=60) for h in handles]
        assert svc.ledgers_reconciled()
    assert batch_counters() == (1, 2)
    assert results == solo[0]


@pytest.mark.hard_timeout(120)
def test_batch_metrics_export_and_span():
    trace.enable()
    jobs = [(f"tenant{i}", agg_spec(tdp, 150 + i), rows(61 + i))
            for i in range(3)]
    run_service(jobs, batching=True)
    assert batch_counters() == (1, 3)
    assert telemetry.gauge_snapshot()["service_batch_occupancy"][""] == 3.0
    parsed = obs.parse_prometheus(obs.render_prometheus())
    assert parsed["pdp_service_batch_launches"]["type"] == "counter"
    assert parsed["pdp_service_batch_launches"]["samples"][""] == 1.0
    assert parsed["pdp_service_jobs_batched"]["samples"][""] == 3.0
    assert parsed["pdp_service_batch_occupancy"]["samples"][""] == 3.0
    spans = [e for e in trace.to_trace_events()["traceEvents"]
             if e["name"] == "batch_dispatch"]
    assert len(spans) == 1
    assert spans[0]["args"]["lanes"] == 3
    assert spans[0]["args"]["lane_bucket"] == 3
    assert trace.trace_summary()["spans"]["batch_dispatch"]["count"] == 1


@pytest.mark.hard_timeout(120)
def test_a_failed_batched_release_fails_every_lane(monkeypatch):
    calls = []

    def broken(*args, **kwargs):
        calls.append(threading.current_thread().name)
        raise RuntimeError("injected lane-entry launch failure")

    monkeypatch.setattr(executor, "batched_aggregate_release_kernel", broken)
    solo_calls = []
    original = executor.aggregate_release_kernel

    def solo(*args, **kwargs):
        solo_calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(executor, "aggregate_release_kernel", solo)
    jobs = [(f"tenant{i}", agg_spec(tdp, 170 + i), rows(71 + i))
            for i in range(3)]
    with DPAggregationService(torch_backend(), max_concurrent_jobs=3,
                              batching=True, batch_window_ms=30_000.0,
                              max_batch_jobs=3) as svc:
        handles = [svc.submit(t, s, r) for t, s, r in jobs]
        for h in handles:
            with pytest.raises(RuntimeError, match="injected lane-entry"):
                h.result(timeout=60)
            assert h.status == JobStatus.FAILED
            # Mechanisms had registered: the whole grant is forfeit.
            ledger = svc.tenant_ledger(h.tenant_id)
            assert ledger.job_spent_epsilon(h.job_id) == 1.0
            assert ledger.records()[0]["metric"] == "admission_grant_forfeit"
    assert len(calls) == 1
    assert not solo_calls, "a failed batched release never falls back"
    assert batch_counters() == (0, 0)


def test_group_key_splits_what_a_lane_cannot_share():
    base = dict(kind="aggregate", pid=np.zeros(8, np.int32),
                pk=np.zeros(8, np.int32), valid=np.ones(8, bool),
                key=np.zeros(2, np.uint32), device=torch.device("cpu"),
                dtype=F64, values=np.zeros(8), scalars=(0.0,) * 5,
                stds=np.ones(2), cfg=None)
    a = executor.ReleaseLaunch(**base)
    assert batching._group_key(a) == batching._group_key(
        executor.ReleaseLaunch(**dict(base, key=np.ones(2, np.uint32))))
    for change in (dict(stds=np.full(2, 2.0)), dict(dtype=torch.float32),
                   dict(pid=np.zeros(16, np.int32),
                        values=np.zeros(16))):
        assert batching._group_key(a) != batching._group_key(
            executor.ReleaseLaunch(**dict(base, **change)))


@pytest.mark.hard_timeout(60)
def test_launch_counts_survive_concurrent_workers():
    """The service's workers count launches from many threads at once: no
    increment is lost (more threads than cores, a short switch
    interval)."""
    import sys
    kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernels._count("row_keys_lanes")
                            for _ in range(2000)]) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts["row_keys_lanes"] == 32 * 2000
    kernels.reset_launch_counts()
