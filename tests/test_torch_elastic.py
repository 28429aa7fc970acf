"""Elastic meshes of the port: device-loss shrink and scale-up of the four
meshed drivers (pipelinedp_tpu_torch/runtime/retry.py
run_with_mesh_degradation / run_with_mesh_elasticity through
runtime/entry.py), held against the JAX package's (tests/test_elastic.py,
tests/test_fleet.py TestScaleUp) with the same seed, the same rows and
the same FaultSchedule.

The rows are tests/test_elastic.py's _data(): every privacy id holds one
row in one partition and every value is an integer, so which shard an id
lands on cannot change a bound row or a partial sum. Bounds stated here:
  * the port's faulted or grown run == its fixed-geometry run, noise
    included (block keys do not depend on the mesh);
  * against the JAX package, noise-free (stds 0): kept sets, counts and
    sums identical (integers), on the CPU mesh make_mesh(["cpu"] * D)
    against the JAX one over D host devices;
  * the telemetry deltas of the runtime's counters and the job's health
    snapshot (state, planned / live devices, fleet events, counters)
    equal the JAX package's.
One JAX mesh shape family per driver (D = 4 shrinking to 3 or 2, growing
to 8), so the JAX compiles stay few.
"""

import logging

import jax
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import combiners as jax_combiners
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu.aggregate_params import MechanismType as JaxMechanismType
from pipelinedp_tpu.ops import selection_ops as jax_selection_ops
from pipelinedp_tpu.parallel import large_p as jax_large_p
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.parallel import sharded as jax_sharded
from pipelinedp_tpu.runtime import faults as jax_faults
from pipelinedp_tpu.runtime import health as jax_health
from pipelinedp_tpu.runtime import retry as jax_retry
from pipelinedp_tpu.runtime import telemetry as jax_telemetry
from pipelinedp_tpu_torch import combiners, executor
from pipelinedp_tpu_torch.aggregate_params import MechanismType
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.parallel import large_p, sharded
from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
from pipelinedp_tpu_torch.parallel.mesh import make_mesh
from pipelinedp_tpu_torch.runtime import faults
from pipelinedp_tpu_torch.runtime import health
from pipelinedp_tpu_torch.runtime import retry
from pipelinedp_tpu_torch.runtime import telemetry

pytestmark = pytest.mark.torch_port

P = 1 << 12
BLOCK = 1 << 10  # 4 blocks
L0 = 2
FAST = retry.RetryPolicy(max_retries=2, base_delay=0.0, max_delay=0.0)
JAX_FAST = jax_retry.RetryPolicy(max_retries=2, base_delay=0.0,
                                 max_delay=0.0)
F64 = torch.float64
# The runtime's counters both packages record on these paths.
COUNTERS = ("device_losses", "mesh_degradations", "mesh_expansions",
            "host_losses", "injected_faults", "block_retries",
            "release_dispatches", "block_oom_degradations")


@pytest.fixture(autouse=True)
def _no_tickets():
    """Join tickets are process-wide: one left pending would grow the
    next elastic run."""
    retry.clear_joins()
    jax_retry.clear_joins()
    yield
    retry.clear_joins()
    jax_retry.clear_joins()


def _spec(mod, noise_free=False):
    """(cfg, stds, scalars, selection) of test_elastic.py's release on
    package `mod`."""
    jax_side = mod is pdp
    comb, ex, sel, mech = ((jax_combiners, jax_executor, jax_selection_ops,
                            JaxMechanismType) if jax_side else
                           (combiners, executor, selection_ops,
                            MechanismType))
    params = mod.AggregateParams(metrics=[mod.Metrics.COUNT,
                                          mod.Metrics.SUM],
                                 noise_kind=mod.NoiseKind.LAPLACE,
                                 max_partitions_contributed=L0,
                                 max_contributions_per_partition=3,
                                 min_value=0.0,
                                 max_value=5.0)
    accountant = mod.NaiveBudgetAccountant(total_epsilon=1.0,
                                           total_delta=1e-6)
    compound = comb.create_compound_combiner(params, accountant)
    budget = accountant.request_budget(mech.GENERIC)
    accountant.compute_budgets()
    selection = sel.selection_params_from_host(
        params.partition_selection_strategy, budget.eps, budget.delta, L0,
        None)
    cfg = ex.make_kernel_config(params, compound, P, private_selection=True,
                                selection_params=selection)
    stds = np.asarray(ex.compute_noise_stds(compound, params) if jax_side
                      else ex.compute_noise_stds(compound))
    if noise_free:
        stds = np.zeros_like(stds)
    return cfg, stds, ex.kernel_scalars(params), selection


def _data():
    """tests/test_elastic.py's placement-independent rows: 12 dense
    partitions of 120 ids, one row each, integer values, and 5 single-id
    partitions."""
    dense_parts = (np.arange(12, dtype=np.int64) * 239 + 57) % P
    n_per = 120
    pid = (np.repeat(np.arange(n_per), 12) * 1_000_003 +
           np.tile(np.arange(12), n_per)).astype(np.int32)
    pk = np.tile(dense_parts, n_per).astype(np.int32)
    rng = np.random.default_rng(7)
    values = rng.integers(0, 6, len(pk)).astype(np.float64)
    pid = np.concatenate([pid,
                          2_000_000_000 + np.arange(5, dtype=np.int32)])
    sparse_parts = (np.arange(5, dtype=np.int64) * 911 + 13) % P
    pk = np.concatenate([pk, sparse_parts.astype(np.int32)])
    values = np.concatenate([values, np.ones(5)])
    return pid, pk, values, np.ones(len(pid), bool), np.sort(dense_parts)


def _key(seed):
    return np.array([0, seed], np.uint32)


def _jax_mesh(mesh):
    return jax_make_mesh(n_devices=mesh.size)


# Runners: (mesh, key, noise_free, **runtime knobs) -> (kept, values). The
# port's take a port mesh; the JAX ones a JAX mesh.


def _blocked_agg(mesh, key, noise_free=False, **kw):
    cfg, stds, scalars, _ = _spec(tdp, noise_free)
    pid, pk, values, valid, _ = _data()
    kept, out = large_p.aggregate_blocked_sharded(
        mesh, pid, pk, values, valid, *scalars, stds, key, cfg,
        block_partitions=BLOCK, dtype=F64, **kw)
    return kept, out["sum"]


def _jax_blocked_agg(mesh, key, noise_free=False, **kw):
    cfg, stds, scalars, _ = _spec(pdp, noise_free)
    pid, pk, values, valid, _ = _data()
    kept, out = jax_large_p.aggregate_blocked_sharded(
        mesh, pid, pk, values, valid, *scalars, stds, jax.numpy.asarray(key),
        cfg, block_partitions=BLOCK, **kw)
    return kept, np.asarray(out["sum"])


def _blocked_select(mesh, key, noise_free=False, **kw):
    _, _, _, selection = _spec(tdp)
    pid, pk, _, valid, _ = _data()
    kept = large_p.select_partitions_blocked_sharded(
        mesh, pid, pk, valid, key, L0, P, selection,
        block_partitions=BLOCK, dtype=F64, **kw)
    return kept, kept


def _jax_blocked_select(mesh, key, noise_free=False, **kw):
    _, _, _, selection = _spec(pdp)
    pid, pk, _, valid, _ = _data()
    kept = jax_large_p.select_partitions_blocked_sharded(
        mesh, pid, pk, valid, jax.numpy.asarray(key), L0, P, selection,
        block_partitions=BLOCK, **kw)
    return kept, kept


def _dense_agg(mesh, key, noise_free=False, **kw):
    cfg, stds, scalars, _ = _spec(tdp, noise_free)
    pid, pk, values, valid, _ = _data()
    out, keep, _ = sharded.sharded_aggregate_arrays(
        mesh, pid, pk, values, valid, *scalars, stds, key, cfg, dtype=F64,
        fused=False, **kw)
    return keep.numpy(), out["sum"].numpy()


def _jax_dense_agg(mesh, key, noise_free=False, **kw):
    cfg, stds, scalars, _ = _spec(pdp, noise_free)
    pid, pk, values, valid, _ = _data()
    out, keep, _ = jax_sharded.sharded_aggregate_arrays(
        mesh, pid, pk, values, valid, *scalars, stds,
        jax.numpy.asarray(key), cfg, **kw)
    return np.asarray(keep), np.asarray(out["sum"])


def _dense_select(mesh, key, noise_free=False, **kw):
    _, _, _, selection = _spec(tdp)
    pid, pk, _, valid, _ = _data()
    keep = sharded.sharded_select_partitions(
        mesh, pid, pk, valid, key, L0, P, selection, dtype=F64, fused=False,
        **kw)
    return keep.numpy(), keep.numpy()


def _jax_dense_select(mesh, key, noise_free=False, **kw):
    _, _, _, selection = _spec(pdp)
    pid, pk, _, valid, _ = _data()
    keep = jax_sharded.sharded_select_partitions(
        mesh, pid, pk, valid, jax.numpy.asarray(key), L0, P, selection,
        **kw)
    return np.asarray(keep), np.asarray(keep)


# name -> (port runner, JAX runner).
DRIVERS = {
    "blocked_aggregate": (_blocked_agg, _jax_blocked_agg),
    "blocked_select": (_blocked_select, _jax_blocked_select),
    "dense_aggregate": (_dense_agg, _jax_dense_agg),
    "dense_select": (_dense_select, _jax_dense_select),
}
NAMES = list(DRIVERS)
BLOCKED = ["blocked_aggregate", "blocked_select"]


def cpu_mesh(d):
    return make_mesh(["cpu"] * d)


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def counters(delta):
    return {k: delta.get(k, 0) for k in COUNTERS}


def health_view(snap):
    """The snapshot fields both packages keep, counters restricted to the
    ones the port tracks."""
    tracked = {"block_retries", "block_oom_degradations",
               "host_fetch_retries", "device_losses", "host_losses",
               "mesh_degradations", "block_timeouts", "mesh_expansions"}
    return {
        "state": snap["state"],
        "planned_devices": snap["planned_devices"],
        "live_devices": snap["live_devices"],
        "fleet_events": [e["kind"] for e in snap["fleet_events"]],
        "counters": {k: v for k, v in snap["counters"].items()
                     if k in tracked},
        "completed_runs": snap["completed_runs"],
    }


def both(name, mesh, seed, schedule=None, announce=None, job_id=None,
         **kw):
    """The port's and the JAX package's noise-free runs of driver `name`
    under fault schedules built from `schedule` (a list of Fault kwargs)
    and a join ticket `announce`: ((kept, values), counter delta,
    health view) for each package, the port first."""
    out = []
    for side, runner, fmod, rmod, tmod, hmod, fast in (
            ("port", DRIVERS[name][0], faults, retry, telemetry, health,
             FAST),
            ("jax", DRIVERS[name][1], jax_faults, jax_retry, jax_telemetry,
             jax_health, JAX_FAST)):
        sched = fmod.FaultSchedule([fmod.Fault(**f)
                                    for f in (schedule or [])])
        if announce is not None:
            rmod.announce_join(**announce)
        job = job_id or name
        m = mesh if side == "port" else _jax_mesh(mesh)
        before = tmod.snapshot()
        with fmod.inject(sched):
            got = runner(m, _key(seed), noise_free=True, retry=fast,
                         job_id=job, **kw)
        assert sched.pending() == 0, side
        out.append((got, counters(tmod.delta(before)),
                    health_view(hmod.for_job(job).snapshot())))
    return out


class TestDeviceLoss:

    @pytest.mark.parametrize("name", NAMES)
    def test_shrink_four_to_three_equals_fixed_and_jax(self, name):
        port = DRIVERS[name][0]
        base = port(cpu_mesh(4), _key(21))
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", point="dispatch")])
        with faults.inject(sched):
            got = port(cpu_mesh(4), _key(21), retry=FAST, elastic=True,
                       job_id=f"t-shrink-{name}")
        assert_same(got, base)
        (p_out, p_delta, p_health), (j_out, j_delta, j_health) = both(
            name, cpu_mesh(4), 21,
            [dict(kind="device_loss", point="dispatch")], elastic=True,
            job_id=f"t-shrink-nf-{name}")
        assert_same(p_out, j_out)
        assert p_delta == j_delta
        assert p_delta["device_losses"] == 1
        assert p_delta["mesh_degradations"] == 1
        assert p_health == j_health
        assert p_health["state"] == "DEGRADED"
        assert (p_health["planned_devices"], p_health["live_devices"]) == \
            (4, 3)

    def test_repeated_losses_keep_degrading(self):
        base = _blocked_agg(cpu_mesh(4), _key(31))
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", point="dispatch", times=2)])
        with faults.inject(sched):
            got = _blocked_agg(cpu_mesh(4), _key(31), retry=FAST,
                               elastic=True, job_id="t-twice")
        assert_same(got, base)
        (p_out, p_delta, p_health), (j_out, j_delta, j_health) = both(
            "blocked_aggregate", cpu_mesh(4), 31,
            [dict(kind="device_loss", point="dispatch", times=2)],
            elastic=True, job_id="t-twice-nf")
        assert_same(p_out, j_out)
        assert p_delta == j_delta and p_delta["mesh_degradations"] == 2
        assert p_health == j_health and p_health["live_devices"] == 2

    def test_loss_at_block_two_and_a_named_slot(self):
        """A named slot (device=0, the gathering slot) lost at block 0 is
        the one dropped, the survivors keep their ids, and a later unnamed
        loss (block 2 of the re-entered run) drops the highest id."""
        base = _blocked_agg(cpu_mesh(4), _key(23))
        seen = []
        real = mesh_lib.make_mesh

        def spy(devices=None, n_devices=None):
            mesh = real(devices, n_devices)
            seen.append(mesh.ids)
            return mesh

        sched = faults.FaultSchedule([
            faults.Fault("device_loss", block=2, point="dispatch"),
            faults.Fault("device_loss", block=0, point="dispatch",
                         device=0)])
        with faults.inject(sched), pytest.MonkeyPatch.context() as mp:
            mp.setattr(mesh_lib, "make_mesh", spy)
            got = _blocked_agg(cpu_mesh(4), _key(23), retry=FAST,
                               elastic=True, job_id="t-named")
        assert_same(got, base)
        assert seen == [(1, 2, 3), (1, 2)]
        (p_out, p_delta, _), (j_out, j_delta, _) = both(
            "blocked_aggregate", cpu_mesh(4), 23,
            [dict(kind="device_loss", block=2, point="dispatch")],
            elastic=True, job_id="t-block2")
        assert_same(p_out, j_out)
        assert p_delta == j_delta

    def test_collective_point_loss_recovers(self):
        """A slot lost during the device exchange raises to the elastic
        loop, which stages the rows again for the smaller mesh."""
        cfg, stds, scalars, _ = _spec(tdp)
        pid, pk, values, valid, _ = _data()
        base = large_p.aggregate_blocked_sharded(
            cpu_mesh(4), pid, pk, values, valid, *scalars, stds, _key(29),
            cfg, block_partitions=BLOCK, dtype=F64)
        cols = [torch.as_tensor(c) for c in (pid, pk, values, valid)]
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", point="collective")])
        before = telemetry.snapshot()
        with faults.inject(sched):
            kept, out = large_p.aggregate_blocked_sharded(
                cpu_mesh(4), *cols, *scalars, stds, _key(29), cfg,
                block_partitions=BLOCK, dtype=F64, retry=FAST, elastic=True)
        assert sched.pending() == 0
        np.testing.assert_array_equal(kept, base[0])
        np.testing.assert_array_equal(out["sum"], base[1]["sum"])
        assert telemetry.delta(before).get("mesh_degradations") == 1

    @pytest.mark.parametrize("mod", ["port", "jax"])
    def test_without_elastic_a_loss_is_fatal(self, mod):
        fmod, hmod, runner, mesh = (
            (faults, health, _blocked_agg, cpu_mesh(4)) if mod == "port"
            else (jax_faults, jax_health, _jax_blocked_agg,
                  jax_make_mesh(n_devices=4)))
        sched = fmod.FaultSchedule(
            [fmod.Fault("device_loss", point="dispatch")])
        with fmod.inject(sched):
            with pytest.raises(fmod.InjectedDeviceLossError):
                runner(mesh, _key(33), retry=FAST if mod == "port" else
                       JAX_FAST, job_id="t-elastic-off")
        assert hmod.for_job("t-elastic-off").snapshot()["state"] == "FAILED"


class TestFloor:

    @pytest.mark.parametrize("name", NAMES)
    def test_one_slot_mesh_runs_the_unsharded_driver(self, name, caplog):
        port = DRIVERS[name][0]
        base = port(cpu_mesh(2), _key(41))
        with caplog.at_level(logging.WARNING):
            got = port(cpu_mesh(1), _key(41), elastic=True)
        assert_same(got, base)
        warnings = [r for r in caplog.records
                    if "unsharded driver" in r.getMessage()]
        assert len(warnings) == 1

    def test_shrink_to_one_slot_runs_the_fallback(self):
        base = _dense_agg(cpu_mesh(2), _key(42))
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", point="dispatch")])
        with faults.inject(sched):
            got = _dense_agg(cpu_mesh(2), _key(42), retry=FAST,
                             elastic=True, job_id="t-floor-one")
        assert_same(got, base)
        assert health.for_job("t-floor-one").snapshot()["live_devices"] == 1

    @pytest.mark.parametrize("name", NAMES)
    def test_losses_past_min_devices_raise(self, name):
        port = DRIVERS[name][0]
        job = f"t-floor-{name}"
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", point="dispatch")])
        with faults.inject(sched):
            with pytest.raises(retry.MeshDegradationError) as err:
                port(cpu_mesh(2), _key(43), retry=FAST, elastic=True,
                     min_devices=2, job_id=job)
        msg = str(err.value)
        assert job in msg and "no journal configured" in msg
        snap = health.for_job(job).snapshot()
        assert snap["state"] == "FAILED"
        assert (snap["planned_devices"], snap["live_devices"]) == (2, 1)

    def test_losing_the_last_slot_exhausts_the_floor(self):
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", point="dispatch", times=2)])
        with faults.inject(sched):
            with pytest.raises(retry.MeshDegradationError):
                _blocked_agg(cpu_mesh(2), _key(47), retry=FAST,
                             elastic=True, job_id="t-floor-last")


class TestScaleUp:

    @pytest.mark.parametrize("name", NAMES)
    def test_grow_four_to_eight_equals_fixed_and_jax(self, name):
        port = DRIVERS[name][0]
        block = 2 if name in BLOCKED else 0
        base = port(cpu_mesh(4), _key(61))
        retry.announce_join(n_devices=8, block=block)
        got = port(cpu_mesh(4), _key(61), retry=FAST, elastic_grow=True,
                   job_id=f"t-grow-{name}")
        assert retry.pending_joins() == 0
        assert_same(got, base)
        (p_out, p_delta, p_health), (j_out, j_delta, j_health) = both(
            name, cpu_mesh(4), 61, announce=dict(n_devices=8, block=block),
            elastic_grow=True, job_id=f"t-grow-nf-{name}")
        assert_same(p_out, j_out)
        assert p_delta == j_delta
        assert p_delta["mesh_expansions"] == 1
        assert p_delta["mesh_degradations"] == 0
        assert p_health == j_health
        assert "REJOINING" in p_health["fleet_events"]
        gauges = telemetry.gauge_snapshot().get("mesh_target_devices", {})
        assert 8.0 in gauges.values()

    def test_join_failure_aborts_back_to_the_old_mesh(self):
        base = _blocked_agg(cpu_mesh(4), _key(71))
        (p_out, p_delta, p_health), (j_out, j_delta, j_health) = both(
            "blocked_aggregate", cpu_mesh(4), 71,
            [dict(kind="host_join_failure")],
            announce=dict(n_devices=8, block=2), elastic_grow=True,
            job_id="t-grow-abort")
        assert retry.pending_joins() == 0
        assert p_delta == j_delta
        assert p_delta["mesh_expansions"] == 0
        assert p_delta["injected_faults"] == 1
        assert_same(p_out, j_out)
        assert p_health == j_health
        snap = health.for_job("t-grow-abort").snapshot()
        assert any(e["kind"] == "REJOINING" and "abort" in e["detail"]
                   for e in snap["fleet_events"])
        sched = faults.FaultSchedule([faults.Fault("host_join_failure")])
        retry.announce_join(n_devices=8, block=2)
        with faults.inject(sched):
            got = _blocked_agg(cpu_mesh(4), _key(71), retry=FAST,
                               elastic_grow=True, job_id="t-grow-abort2")
        assert_same(got, base)

    def test_announce_is_ignored_without_elastic_grow(self):
        base = _blocked_agg(cpu_mesh(4), _key(73))
        retry.announce_join(n_devices=8, block=2)
        assert_same(_blocked_agg(cpu_mesh(4), _key(73)), base)
        assert retry.pending_joins() == 1
        assert_same(_blocked_agg(cpu_mesh(4), _key(73), retry=FAST,
                                 elastic=True), base)
        assert retry.pending_joins() == 1

    def test_grow_then_lose_a_joiner(self):
        """Growth and shrink compose: a slot admitted at block 1 is the
        highest id, the one an unnamed loss at block 3 drops."""
        base = _blocked_agg(cpu_mesh(2), _key(79))
        retry.announce_join(n_devices=4, block=1)
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", block=3, point="dispatch")])
        before = telemetry.snapshot()
        with faults.inject(sched):
            got = _blocked_agg(cpu_mesh(2), _key(79), retry=FAST,
                               elastic_grow=True, job_id="t-grow-lose")
        assert_same(got, base)
        delta = telemetry.delta(before)
        assert delta.get("mesh_expansions") == 1
        assert delta.get("mesh_degradations") == 1
        snap = health.for_job("t-grow-lose").snapshot()
        assert (snap["planned_devices"], snap["live_devices"]) == (4, 3)


# ---------------------------------------------------------------------------
# Through DPEngine on TorchBackend


def _rows(seed=3, users=1500, parts=40):
    """Rows whose bounding drops nothing (each id in at most 3 partitions,
    at most 2 rows in each) and integer values: pass 1 samples under a
    shard's own key, so only such rows release the same on every mesh
    geometry, in both packages (tests/test_elastic.py's _data())."""
    rng = np.random.default_rng(seed)
    rows = []
    for user in range(users):
        for part in rng.choice(parts, rng.integers(1, 4), replace=False,
                               p=np.linspace(2, 0.1, parts) /
                               np.linspace(2, 0.1, parts).sum()):
            for _ in range(rng.integers(1, 3)):
                rows.append((user, int(part), float(rng.integers(0, 6))))
    return rows


ROWS = _rows()


def _engine(kind, threshold, **kw):
    backend = tdp.TorchBackend(device="cpu", dtype=F64, noise_seed=5,
                               mesh=cpu_mesh(4),
                               large_partition_threshold=threshold,
                               block_partitions=8, **kw)
    acc = tdp.NaiveBudgetAccountant(total_epsilon=8.0, total_delta=1e-6)
    engine = tdp.DPEngine(acc, backend)
    extractors = tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                    partition_extractor=lambda r: r[1],
                                    value_extractor=lambda r: r[2])
    if kind == "aggregate":
        res = engine.aggregate(ROWS, tdp.AggregateParams(
            metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM],
            noise_kind=tdp.NoiseKind.LAPLACE, max_partitions_contributed=3,
            max_contributions_per_partition=2, min_value=0.0,
            max_value=5.0), extractors)
    else:
        res = engine.select_partitions(ROWS, tdp.SelectPartitionsParams(
            max_partitions_contributed=3), extractors)
    acc.compute_budgets()
    return dict(res) if kind == "aggregate" else sorted(res)


@pytest.mark.parametrize("kind", ["aggregate", "select"])
@pytest.mark.parametrize("route,threshold", [("dense", None),
                                             ("blocked", 16)])
def test_engine_loss_and_grow_release_the_fixed_run(kind, route, threshold):
    base = _engine(kind, threshold)
    assert base
    job = f"t-engine-{kind}-{route}"
    sched = faults.FaultSchedule(
        [faults.Fault("device_loss", point="dispatch",
                      block=2 if route == "blocked" else None)])
    with faults.inject(sched):
        lost = _engine(kind, threshold, elastic=True, retry=FAST,
                       job_id=job)
    assert sched.pending() == 0
    assert lost == base
    assert health.for_job(job).snapshot()["live_devices"] == 3
    retry.announce_join(n_devices=6, block=2 if route == "blocked" else 0)
    before = telemetry.snapshot()
    grown = _engine(kind, threshold, elastic_grow=True)
    assert retry.pending_joins() == 0
    assert telemetry.delta(before).get("mesh_expansions") == 1
    assert grown == base


def test_for_job_carries_the_runtime_knobs():
    parent = tdp.TorchBackend(device="cpu", mesh=cpu_mesh(2), retry=FAST,
                              job_id="parent", elastic=True, min_devices=2)
    view = parent.for_job(noise_seed=3)
    assert (view.retry, view.job_id, view.elastic, view.elastic_grow,
            view.min_devices) == (FAST, "parent", True, False, 2)
    assert parent.for_job(job_id="child").job_id == "child"
    assert executor.runtime_kwargs(view) == dict(
        retry=FAST, job_id="parent", elastic=True, min_devices=2)
    unmeshed = tdp.TorchBackend(device="cpu", elastic=True)
    assert executor.runtime_kwargs(unmeshed) == dict(retry=None)
