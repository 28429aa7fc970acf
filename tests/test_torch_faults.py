"""Fault injection, retry and the OOM re-plan of the port
(pipelinedp_tpu_torch/runtime/faults.py, retry.py, entry.py, and the
blocked drivers' dispatch loop in parallel/large_p.py) against the JAX
package's (tests/test_runtime_faults.py TestFaultSchedule,
TestRetryClassification, TestRetryDeterminism, TestOOMDegradation,
TestBlockedSelectionFaults, TestMeshedFaults; tests/test_elastic.py
TestHostFetchRetryKnobs), with the same seed, rows and FaultSchedule.

Bounds stated here:
  * a faulted run of the port == its fault-free run, noise included (a
    retried block re-derives its key);
  * against the JAX package: kept sets identical; noisy values within
    1e-9 of max(1, |x|) (float64 Laplace noise agrees to the ulp bounds
    of tests/test_torch_threefry.py); noise-free values (stds 0) of
    integer counts identical, float sums within 1e-9;
  * the injected_faults, block_retries, release_dispatches and
    block_oom_degradations deltas equal the JAX package's;
  * the knob validators' messages equal the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import combiners as jax_combiners
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu import input_validators as jax_validators
from pipelinedp_tpu.aggregate_params import MechanismType as JaxMechanismType
from pipelinedp_tpu.ops import selection_ops as jax_selection_ops
from pipelinedp_tpu.parallel import large_p as jax_large_p
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.parallel import mesh as jax_mesh_lib
from pipelinedp_tpu.runtime import faults as jax_faults
from pipelinedp_tpu.runtime import retry as jax_retry
from pipelinedp_tpu.runtime import telemetry as jax_telemetry
from pipelinedp_tpu_torch import combiners, executor, input_validators
from pipelinedp_tpu_torch.aggregate_params import MechanismType
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.parallel import large_p, sharded
from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
from pipelinedp_tpu_torch.parallel.mesh import make_mesh
from pipelinedp_tpu_torch.runtime import faults
from pipelinedp_tpu_torch.runtime import retry
from pipelinedp_tpu_torch.runtime import telemetry

pytestmark = pytest.mark.torch_port

F64 = torch.float64
FAST = retry.RetryPolicy(max_retries=3, base_delay=0.0, max_delay=0.0)
JAX_FAST = jax_retry.RetryPolicy(max_retries=3, base_delay=0.0,
                                 max_delay=0.0)
COUNTERS = ("injected_faults", "block_retries", "release_dispatches",
            "block_oom_degradations")
SIDES = {
    "port": (faults, telemetry, FAST),
    "jax": (jax_faults, jax_telemetry, JAX_FAST),
}


def _spec(mod, P, eps=1.0, l0=4, linf=8, noise_free=False):
    """tests/test_runtime_faults.py's _spec on package `mod`: (cfg, stds,
    scalars)."""
    jax_side = mod is pdp
    comb, ex, sel, mech = ((jax_combiners, jax_executor, jax_selection_ops,
                            JaxMechanismType) if jax_side else
                           (combiners, executor, selection_ops,
                            MechanismType))
    params = mod.AggregateParams(metrics=[mod.Metrics.COUNT,
                                          mod.Metrics.SUM],
                                 noise_kind=mod.NoiseKind.LAPLACE,
                                 max_partitions_contributed=l0,
                                 max_contributions_per_partition=linf,
                                 min_value=0.0,
                                 max_value=5.0)
    accountant = mod.NaiveBudgetAccountant(total_epsilon=eps,
                                           total_delta=1e-6)
    compound = comb.create_compound_combiner(params, accountant)
    budget = accountant.request_budget(mech.GENERIC)
    accountant.compute_budgets()
    selection = sel.selection_params_from_host(
        params.partition_selection_strategy, budget.eps, budget.delta, l0,
        None)
    cfg = ex.make_kernel_config(params, compound, P, private_selection=True,
                                selection_params=selection)
    stds = np.asarray(ex.compute_noise_stds(compound, params) if jax_side
                      else ex.compute_noise_stds(compound))
    if noise_free:
        stds = np.zeros_like(stds)
    return cfg, stds, ex.kernel_scalars(params)


def _data(n=20_000, n_ids=500, P=1000, seed=0):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_ids, n).astype(np.int32)
    pk = rng.integers(0, P, n).astype(np.int32)
    values = rng.uniform(0, 5, n)
    return pid, pk, values, np.ones(n, bool)


def _dense_rows(P=1000, dense=((np.arange(12) * 77 + 5) % 1000)):
    """TestOOMDegradation's rows: dense partitions of 120 distinct ids
    (keep probability ~1 at eps 30) and single-id ones (~0), so every
    keep decision is key-independent and an OOM re-plan's fresh keys keep
    the same set."""
    n_per = 120
    pid = (np.repeat(np.arange(n_per), len(dense)) * 1003 +
           np.tile(np.arange(len(dense)), n_per)).astype(np.int32)
    pk = np.tile(dense, n_per).astype(np.int32)
    rng = np.random.default_rng(4)
    values = rng.integers(0, 6, len(pk)).astype(np.float64)
    pid = np.concatenate([pid, 900_000 + np.arange(5, dtype=np.int32)])
    pk = np.concatenate(
        [pk, ((np.arange(5) * 311 + 9) % P).astype(np.int32)])
    values = np.concatenate([values, np.ones(5)])
    return pid, pk, values, np.ones(len(pid), bool)


def _blocked(side, rows, key, P, block, noise_free=False, eps=1.0, linf=8,
             mesh=None, **kw):
    """aggregate_blocked (or, with a mesh size, aggregate_blocked_sharded)
    of `side` over host rows: (kept, {count, sum} as numpy)."""
    mod = pdp if side == "jax" else tdp
    cfg, stds, scalars = _spec(mod, P, eps=eps, linf=linf,
                               noise_free=noise_free)
    key = np.asarray(key, np.uint32)
    if side == "jax":
        args = (*rows, *scalars, stds, jax.numpy.asarray(key), cfg)
        if mesh is None:
            kept, out = jax_large_p.aggregate_blocked(
                *args, block_partitions=block, **kw)
        else:
            kept, out = jax_large_p.aggregate_blocked_sharded(
                jax_make_mesh(n_devices=mesh), *args,
                block_partitions=block, **kw)
    else:
        args = (*rows, *scalars, stds, key, cfg)
        if mesh is None:
            kept, out = large_p.aggregate_blocked(
                *args, block_partitions=block, device="cpu", dtype=F64,
                **kw)
        else:
            kept, out = large_p.aggregate_blocked_sharded(
                make_mesh(["cpu"] * mesh), *args, block_partitions=block,
                dtype=F64, **kw)
    return kept, {k: np.asarray(out[k]) for k in ("count", "sum")}


def _faulted(side, schedule, fn):
    """fn() under the FaultSchedule built from `schedule` (Fault kwargs)
    on `side`: (result, the runtime counters' delta)."""
    fmod, tmod, _ = SIDES[side]
    sched = fmod.FaultSchedule([fmod.Fault(**f) for f in schedule])
    before = tmod.snapshot()
    with fmod.inject(sched):
        got = fn()
    assert sched.pending() == 0, side
    delta = tmod.delta(before)
    return got, {k: delta.get(k, 0) for k in COUNTERS}


def assert_equal_release(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for name in want[1]:
        np.testing.assert_array_equal(got[1][name], want[1][name])


def assert_close_release(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for name in want[1]:
        a, b = got[1][name], want[1][name]
        assert np.all(np.abs(a - b) <= 1e-9 * np.maximum(1.0, np.abs(b)))


class TestFaultSchedule:

    def test_take_consumes_and_matches(self):
        for fmod in (faults, jax_faults):
            sched = fmod.FaultSchedule([
                fmod.Fault("dispatch", block=2, times=2),
                fmod.Fault("oom"),
            ])
            assert sched.take("dispatch", 0) is None
            assert sched.take("dispatch", 2) is not None
            assert sched.take("dispatch", 2) is not None
            assert sched.take("dispatch", 2) is None
            assert sched.take("oom", 7) is not None
            assert sched.pending() == 0

    @pytest.mark.parametrize("scope", ["thread", "process"])
    def test_inject_scopes_and_raises(self, scope):
        with faults.inject(faults.FaultSchedule([faults.Fault("oom")]),
                           scope=scope):
            assert faults.active() is not None
            with pytest.raises(faults.InjectedOOMError):
                faults.maybe_fail("oom", 0)
        assert faults.active() is None
        faults.maybe_fail("oom", 0)
        with pytest.raises(ValueError, match="unknown inject scope"):
            with faults.inject(faults.FaultSchedule([]), scope="global"):
                pass

    @pytest.mark.parametrize("fields", [
        dict(kind="meteor"),
        dict(kind="dispatch", times=0),
        dict(kind="device_loss", point="drain"),
        dict(kind="disk_full", point="dispatch"),
        dict(kind="corrupt", mode="nan"),
        dict(kind="extreme_values", mode="truncate"),
        dict(kind="oom", process=1),
        dict(kind="device_loss", device=3, process=1),
    ])
    def test_validation_matches_jax(self, fields):
        with pytest.raises(ValueError) as port_err:
            faults.Fault(**fields)
        with pytest.raises(ValueError) as jax_err:
            jax_faults.Fault(**fields)
        assert str(port_err.value) == str(jax_err.value)

    @pytest.mark.parametrize("fields", [
        dict(kind="slow", delay=0.5), dict(kind="hang", point="drain"),
        dict(kind="corrupt", mode="truncate"),
        dict(kind="extreme_values"), dict(kind="io_error", point="block"),
        dict(kind="restart_during_persist", point="odometer"),
        dict(kind="device_loss", point="collective", device=2),
        dict(kind="device_loss", process=1),
        dict(kind="host_join_failure", block=3),
    ])
    def test_every_kind_validates_as_jax(self, fields):
        port, ref = faults.Fault(**fields), jax_faults.Fault(**fields)
        assert (port.kind, port.point, port.mode, port.device,
                port.process) == (ref.kind, ref.point, ref.mode,
                                  ref.device, ref.process)

    def test_typed_errors_and_storage_errnos(self):
        for kind in faults._RAISES:
            port = faults._RAISES[kind]("x")
            ref = jax_faults._RAISES[kind]("x")
            assert type(port).__name__ == type(ref).__name__
            assert isinstance(port, faults.InjectedFault)
            assert getattr(port, "errno", None) == getattr(ref, "errno",
                                                           None)

    def test_lost_device_assignment_matches_jax(self):
        results = []
        for fmod in (faults, jax_faults):
            sched = fmod.FaultSchedule(
                [fmod.Fault("device_loss", times=2)])
            sched.note_device_loss(fmod.Fault("device_loss"))
            got = [sched.assign_lost([0, 1, 2, 3])]
            sched.note_device_loss(fmod.Fault("device_loss"))
            got += [sched.assign_lost([0, 1, 2]),
                    sched.assign_lost([0, 1, 2, 3])]
            sched.note_device_loss(fmod.Fault("device_loss", device=0))
            got.append(sched.assign_lost([0, 1]))
            results.append(got)
        assert results[0] == results[1] == [{3}, {2}, {2, 3}, {0}]


class TestClassification:

    @pytest.mark.parametrize("make", [
        lambda f: RuntimeError("RESOURCE_EXHAUSTED: hbm"),
        lambda f: RuntimeError("UNAVAILABLE: socket"),
        lambda f: ValueError("shape mismatch"),
        lambda f: RuntimeError("INTERNAL: DEVICE_LOST: core dumped"),
        lambda f: RuntimeError("UNAVAILABLE: device is lost (chip 3)"),
        lambda f: RuntimeError("UNAVAILABLE: socket closed"),
        lambda f: RuntimeError("DEADLINE_EXCEEDED: slow"),
        lambda f: MemoryError(),
        lambda f: f.InjectedOOMError("x"),
        lambda f: f.InjectedFatalError("x"),
        lambda f: f.InjectedDeviceLossError("x"),
        lambda f: f.InjectedDispatchError("x"),
        lambda f: f.InjectedConsumeError("x"),
        lambda f: f.InjectedCollectiveError("x"),
        lambda f: f.InjectedHostJoinError("x"),
    ])
    def test_classes_match_jax(self, make):
        port, ref = make(faults), make(jax_faults)
        for name in ("is_transient", "is_oom", "is_device_fatal",
                     "is_timeout"):
            assert getattr(retry, name)(port) == \
                getattr(jax_retry, name)(ref), name

    @pytest.mark.parametrize("text", [
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: unspecified launch failure",
        "CUDA error: misaligned address",
        "CUDA error: uncorrectable ECC error encountered",
        "CUDA error: device-side assert triggered",
        "kernel failed: cudaErrorIllegalAddress (DEVICE_LOST?)",
    ])
    def test_sticky_cuda_errors_raise(self, text):
        """A sticky CUDA error poisons the process's context: neither a
        loss to rebuild on, nor transient, nor an OOM."""
        err = RuntimeError(text)
        assert retry.poisons_context(err)
        assert not retry.is_device_fatal(err)
        assert not retry.is_transient(err)
        assert not retry.is_oom(err)
        with pytest.raises(RuntimeError, match="CUDA error|cudaError"):
            retry.retry_call(lambda: (_ for _ in ()).throw(err), FAST)

    def test_cuda_out_of_memory_is_an_oom(self):
        assert retry.is_oom(torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB"))
        assert not retry.is_transient(torch.cuda.OutOfMemoryError("x"))

    def test_growth_signal_is_no_error_class(self):
        sig = retry.MeshGrowthSignal(n_devices=8, block=2)
        assert not (retry.is_transient(sig) or retry.is_oom(sig) or
                    retry.is_device_fatal(sig))
        assert issubclass(retry.HostEvacuatedError,
                          retry.MeshDegradationError)


class TestRetryCall:

    def test_bounded(self):
        calls = []

        def fn():
            calls.append(1)
            raise RuntimeError("UNAVAILABLE: flaky")

        with pytest.raises(RuntimeError):
            retry.retry_call(fn, FAST, sleep=lambda _: None)
        assert len(calls) == FAST.max_retries + 1

    def test_backoff_matches_jax(self):
        delays = {}
        for side, rmod in (("port", retry), ("jax", jax_retry)):
            policy = rmod.RetryPolicy(max_retries=4, base_delay=0.1,
                                      max_delay=0.5)
            got = []
            calls = iter([RuntimeError("ABORTED")] * 4 + [None])

            def fn():
                err = next(calls)
                if err is not None:
                    raise err
                return 7

            assert rmod.retry_call(fn, policy, sleep=got.append) == 7
            delays[side] = got
        assert delays["port"] == delays["jax"] == [0.1, 0.2, 0.4, 0.5]

    def test_job_budget_caps_every_seam(self):
        before = telemetry.snapshot()
        sched = faults.FaultSchedule([faults.Fault("dispatch", times=3)])
        with retry.retry_budget_scope(1), faults.inject(sched):
            with pytest.raises(retry.RetryBudgetExhaustedError):
                retry.retry_call(lambda: 1, FAST, sleep=lambda _: None)
        assert telemetry.delta(before).get("retry_budget_exhausted") == 1
        with pytest.raises(ValueError):
            with retry.retry_budget_scope(-1):
                pass

    def test_policy_budget_through_a_driver(self):
        pid, pk, values, valid = _dense_rows()
        with faults.inject(faults.FaultSchedule(
                [faults.Fault("dispatch", block=0, times=2)])):
            with pytest.raises(retry.RetryBudgetExhaustedError):
                _blocked("port", (pid, pk, values, valid), [0, 5], 1000,
                         128, retry=retry.RetryPolicy(
                             max_retries=3, base_delay=0.0, max_delay=0.0,
                             max_total_retries=1))


class TestRetryDeterminism:
    """A retried block redraws bit-identical noise: the faulted run's
    outputs equal the fault-free run's exactly."""

    SCHEDULE = [dict(kind="dispatch", block=0, times=2),
                dict(kind="consume", block=2)]

    def _run(self, side, **kw):
        return _blocked(side, _data(), [0, 7], 1000, 128,
                        retry=SIDES[side][2], **kw)

    def test_killed_dispatches_bit_identical_with_noise(self):
        base = self._run("port")
        got, delta = _faulted("port", self.SCHEDULE,
                              lambda: self._run("port"))
        assert_equal_release(got, base)
        ref, ref_delta = _faulted("jax", self.SCHEDULE,
                                  lambda: self._run("jax"))
        assert_close_release(got, ref)
        assert delta == ref_delta
        assert delta["block_retries"] == 3 and delta["injected_faults"] == 3

    @pytest.mark.parametrize("side", ["port", "jax"])
    def test_retries_exhaust_then_raise(self, side):
        fmod = SIDES[side][0]
        sched = fmod.FaultSchedule([
            fmod.Fault("dispatch", block=1, times=FAST.max_retries + 1)])
        with fmod.inject(sched):
            with pytest.raises(fmod.InjectedDispatchError):
                self._run(side)
        assert sched.pending() == 0

    def test_a_fatal_fault_is_never_retried(self):
        with faults.inject(faults.FaultSchedule([faults.Fault("fatal")])):
            with pytest.raises(faults.InjectedFatalError):
                self._run("port")


class TestOOMDegradation:
    """An OOM halves the partition block capacity and re-plans the rest of
    the range; consumed blocks keep their results. Noise-free, on rows
    whose keep decisions do not depend on the key."""

    def _run(self, side, block=128, **kw):
        return _blocked(side, _dense_rows(), [0, 5], 1000, block,
                        noise_free=True, eps=30, linf=64,
                        retry=SIDES[side][2], **kw)

    @pytest.mark.parametrize("schedule", [
        [dict(kind="oom", block=3)],
        [dict(kind="oom", block=2), dict(kind="oom", block=0)],
    ], ids=["once", "twice"])
    def test_oom_halves_and_completes_as_jax(self, schedule):
        base = self._run("port")
        np.testing.assert_array_equal(
            base[0], np.sort((np.arange(12) * 77 + 5) % 1000))
        got, delta = _faulted("port", schedule, lambda: self._run("port"))
        assert_equal_release(got, base)
        ref, ref_delta = _faulted("jax", schedule, lambda: self._run("jax"))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1]["count"], ref[1]["count"])
        np.testing.assert_array_equal(got[1]["sum"], ref[1]["sum"])
        assert delta == ref_delta
        assert delta["block_oom_degradations"] == len(schedule)

    def test_oom_below_floor_propagates(self):
        with faults.inject(faults.FaultSchedule(
                [faults.Fault("oom", times=64)])):
            with pytest.raises(retry.BlockOOMError):
                self._run("port", block=16)

    def test_oom_at_the_sync_point(self):
        """An allocation failure that surfaces at the block's host sync is
        re-planned as one at dispatch is."""
        base = self._run("port")
        calls = []
        real = large_p._HostCopy.wait

        def wait(copy):
            if len(calls) == 2:
                calls.append("oom")
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            calls.append("ok")
            return real(copy)

        before = telemetry.snapshot()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(large_p._HostCopy, "wait", wait)
            got = self._run("port")
        assert "oom" in calls
        assert_equal_release(got, base)
        assert telemetry.delta(before).get("block_oom_degradations") == 1

    def test_run_with_degradation_plans(self):
        seen = []

        def run_range(base, capacity, generation, end):
            seen.append((base, capacity, generation, end))
            if len(seen) == 1:
                raise retry.BlockOOMError(3, MemoryError())

        assert retry.run_with_degradation(run_range, 1000, 128) == 64
        assert seen == [(0, 128, 0, 1000), (384, 64, 1, 1000)]
        with pytest.raises(NotImplementedError, match="Queue 1 step 4"):
            retry.run_with_degradation(run_range, 1000, 128,
                                       journal=object())


class TestBlockedSelectionFaults:

    def test_selection_faulted_matches(self):
        P, l0 = 300, 30
        rows = []
        for p in list(range(10)) + list(range(290, 300)):
            for u in range(200):
                rows.append((u * 100_003 + p, p))
        for p in range(100, 110):
            rows.append((10_000_000 + p, p))
        pid = np.array([r[0] for r in rows], np.int64)
        pk = np.array([r[1] for r in rows], np.int32)
        valid = np.ones(len(rows), bool)
        out = {}
        for side, mod, sel, call in (
                ("port", tdp, selection_ops,
                 lambda *a, **k: large_p.select_partitions_blocked(
                     *a, device="cpu", dtype=F64, **k)),
                ("jax", pdp, jax_selection_ops,
                 jax_large_p.select_partitions_blocked)):
            selection = sel.selection_params_from_host(
                mod.PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1e7,
                1e-5, l0, None)
            key = np.array([0, 5], np.uint32)
            if side == "jax":
                key = jax.numpy.asarray(key)
            base = call(pid, pk, valid, key, l0, P, selection,
                        block_partitions=64)
            got, delta = _faulted(
                side, [dict(kind="dispatch", block=0),
                       dict(kind="oom", block=4)],
                lambda: call(pid, pk, valid, key, l0, P, selection,
                             block_partitions=64, retry=SIDES[side][2],
                             job_id="sel"))
            np.testing.assert_array_equal(base, got)
            out[side] = (got, delta)
        np.testing.assert_array_equal(out["port"][0], out["jax"][0])
        assert out["port"][1] == out["jax"][1]


class TestMeshedFaults:

    SCHEDULE = [dict(kind="dispatch", block=0, times=2),
                dict(kind="consume", block=1),
                dict(kind="oom", block=3)]

    def test_full_schedule_blocked_sharded(self):
        P = 1 << 12
        dense = (np.arange(12) * 331 + 17) % P
        rows = _dense_rows(P, dense)
        rows_t = tuple(torch.as_tensor(c) for c in rows)
        key = [0, 11]

        def run(side, cols, **kw):
            return _blocked(side, cols, key, P, 1 << 9, noise_free=True,
                            eps=30, linf=64, mesh=8, **kw)

        base = run("port", rows)
        got, delta = _faulted("port", self.SCHEDULE,
                              lambda: run("port", rows_t, retry=FAST))
        assert_equal_release(got, base)
        ref, ref_delta = _faulted("jax", self.SCHEDULE,
                                  lambda: run("jax", rows, retry=JAX_FAST))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1]["count"], ref[1]["count"])
        np.testing.assert_array_equal(got[1]["sum"], ref[1]["sum"])
        assert delta == ref_delta
        assert delta["block_oom_degradations"] == 1
        assert delta["block_retries"] == 3

    @pytest.mark.parametrize("fused", [True, False])
    def test_dense_meshed_dispatch_retries(self, fused):
        cfg, stds, scalars = _spec(tdp, 1000)
        rows = _data(n=4000)
        mesh = make_mesh(["cpu"] * 4)

        def run(**kw):
            out = sharded.sharded_aggregate_arrays(
                mesh, *rows, *scalars, stds, np.array([0, 3], np.uint32),
                cfg, dtype=F64, fused=fused, **kw)
            if fused:
                n_kept, order, outputs, _ = out
                return [order[:int(n_kept)].numpy(),
                        outputs["sum"][:int(n_kept)].numpy()]
            outputs, keep, _ = out
            return [keep.numpy(), outputs["sum"].numpy()]

        base = run()
        got, delta = _faulted(
            "port", [dict(kind="dispatch", times=2)],
            lambda: run(retry=FAST, job_id="t-dense-retry"))
        for a, b in zip(got, base):
            np.testing.assert_array_equal(a, b)
        assert delta["block_retries"] == 2


class TestKnobs:

    @pytest.mark.parametrize("name,value", [
        ("validate_elastic", 1), ("validate_elastic", None),
        ("validate_elastic_grow", "yes"), ("validate_min_devices", 0),
        ("validate_min_devices", 1.5), ("validate_min_devices", True),
        ("validate_job_id", ""), ("validate_job_id", "a/b"),
        ("validate_job_id", 7), ("validate_job_id", "x" * 201),
        ("validate_retry_policy",
         retry.RetryPolicy(max_retries=-1)),
        ("validate_retry_policy",
         retry.RetryPolicy(base_delay=float("nan"))),
        ("validate_retry_policy",
         retry.RetryPolicy(max_total_retries=-2)),
    ])
    def test_messages_match_jax(self, name, value):
        with pytest.raises(ValueError) as port_err:
            getattr(input_validators, name)(value, "Backend")
        with pytest.raises(ValueError) as jax_err:
            getattr(jax_validators, name)(value, "Backend")
        assert str(port_err.value) == str(jax_err.value)

    @pytest.mark.parametrize("knob", [
        dict(elastic=1), dict(elastic_grow="yes"), dict(min_devices=0),
        dict(job_id="a/b"), dict(retry=retry.RetryPolicy(max_retries=-1))])
    def test_backend_and_drivers_validate(self, knob):
        with pytest.raises(ValueError):
            tdp.TorchBackend(device="cpu", **knob)
        pid, pk, values, valid = _dense_rows()
        with pytest.raises(ValueError):
            _blocked("port", (pid, pk, values, valid), [0, 1], 1000, 128,
                     **knob)

    @pytest.mark.parametrize("knob", [
        dict(journal=object()), dict(timeout_s=5.0),
        dict(watchdog=object()), dict(overlap=True)])
    def test_unported_knobs_name_their_step(self, knob):
        pid, pk, values, valid = _dense_rows()
        with pytest.raises(NotImplementedError, match="Queue 1 step 4"):
            _blocked("port", (pid, pk, values, valid), [0, 1], 1000, 128,
                     **knob)


class TestHostFetchRetry:
    """host_fetch retries transient failures with jittered backoff, its
    budget threaded from the RetryPolicy (fetch_retry_scope)."""

    class _Flaky:
        def __init__(self, failures):
            self.left = failures
            self.calls = 0

        def __array__(self, dtype=None, copy=None):
            self.calls += 1
            if self.left > 0:
                self.left -= 1
                raise RuntimeError("UNAVAILABLE: tunnel hiccup")
            return np.zeros(1)

    @pytest.mark.parametrize("side", ["port", "jax"])
    def test_fetch_retry_scope_threads_budget(self, side, monkeypatch):
        lib = mesh_lib if side == "port" else jax_mesh_lib
        monkeypatch.setattr(lib.time, "sleep", lambda _: None)
        flaky = self._Flaky(failures=4)
        with pytest.raises(RuntimeError):
            lib.host_fetch(self._Flaky(failures=4))
        with lib.fetch_retry_scope(6):
            assert lib.host_fetch(flaky) is not None
        assert flaky.calls == 5

    def test_backoff_is_jittered(self, monkeypatch):
        delays = []
        monkeypatch.setattr(mesh_lib.time, "sleep", delays.append)
        before = telemetry.snapshot()
        with mesh_lib.fetch_retry_scope(6):
            mesh_lib.host_fetch(self._Flaky(failures=6))
        assert telemetry.delta(before).get("host_fetch_retries") == 6
        pure = [min(0.05 * 2**a, 1.0) for a in range(6)]
        assert len(delays) == 6
        for d, p in zip(delays, pure):
            assert 0.5 * p <= d < p + 1e-12
        assert any(abs(d - p) > 1e-9 for d, p in zip(delays, pure))

    def test_a_tensor_fetch_and_a_hard_failure(self):
        np.testing.assert_array_equal(
            mesh_lib.host_fetch(torch.arange(3)), [0, 1, 2])

        class Broken:
            calls = 0

            def __array__(self, dtype=None, copy=None):
                Broken.calls += 1
                raise ValueError("shape mismatch")

        with pytest.raises(ValueError):
            mesh_lib.host_fetch(Broken())
        assert Broken.calls == 1


def test_engine_faulted_run_identical_ledger_stable():
    """A faulted blocked DPEngine run on TorchBackend(retry=) releases the
    fault-free run's partitions and registers no extra mechanism."""
    rng = np.random.default_rng(1)
    rows = list(zip(rng.integers(0, 300, 8000).tolist(),
                    rng.integers(0, 3000, 8000).tolist(),
                    rng.uniform(0, 5, 8000).tolist()))

    def aggregate():
        backend = tdp.TorchBackend(device="cpu", dtype=F64, noise_seed=13,
                                   large_partition_threshold=1 << 10,
                                   block_partitions=1 << 10, retry=FAST)
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        res = tdp.DPEngine(acc, backend).aggregate(
            rows, tdp.AggregateParams(
                metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM],
                noise_kind=tdp.NoiseKind.LAPLACE,
                max_partitions_contributed=4,
                max_contributions_per_partition=8, min_value=0.0,
                max_value=5.0),
            tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                               partition_extractor=lambda r: r[1],
                               value_extractor=lambda r: r[2]))
        acc.compute_budgets()
        registered = acc.mechanism_count
        out = dict(res)
        assert acc.mechanism_count == registered
        return out, registered

    base, n_base = aggregate()
    sched = faults.FaultSchedule([faults.Fault("dispatch", block=0, times=2),
                                  faults.Fault("consume", block=1)])
    with faults.inject(sched):
        faulted, n_faulted = aggregate()
    assert sched.pending() == 0
    assert n_base == n_faulted
    assert faulted == base
