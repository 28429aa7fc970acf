"""The port's multi-tenant service (pipelinedp_tpu_torch/service/) on the
CPU, held against its own serial runs and against the JAX package's
service: the cases of tests/test_service.py and tests/test_chaos.py's
deadline / cancel cases that need no jit, AOT or mesh, the runtime pieces
the service runs on (journal, odometer, watchdog, health, telemetry,
trace), the ledger directory format both packages share, and the fold
order of the epsilon totals.

Bounds stated here: a job's release equals its serial service-less run
exactly (the same seed on the same backend); ledger and accountant spends
agree exactly (==), in both packages' record layout.
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu.runtime import journal as jax_journal
from pipelinedp_tpu.runtime import telemetry as jax_telemetry
from pipelinedp_tpu.service import DPAggregationService as JaxService
from pipelinedp_tpu.service import JobSpec as JaxJobSpec
from pipelinedp_tpu.service import TenantLedger as JaxLedger
from pipelinedp_tpu_torch.runtime import health as rt_health
from pipelinedp_tpu_torch.runtime import journal as rt_journal
from pipelinedp_tpu_torch.runtime import observability as obs
from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.runtime import trace
from pipelinedp_tpu_torch.runtime import watchdog as rt_watchdog
from pipelinedp_tpu_torch.service import (
    AdmissionRejectedError,
    DPAggregationService,
    JobCancelledError,
    JobSpec,
    JobStatus,
    TenantBudgetExceededError,
    TenantLedger,
)
from pipelinedp_tpu_torch.service import service as service_module

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _service_epoch():
    telemetry.reset()
    yield
    trace.disable()
    telemetry.reset()


ROWS_A = [("u1", "A", 1.0), ("u1", "A", 2.0), ("u2", "A", 1.0),
          ("u2", "B", 3.0), ("u3", "A", 2.0), ("u3", "B", 1.0)]
ROWS_B = [("v1", "X", 4.0), ("v1", "Y", 1.0), ("v2", "X", 2.0),
          ("v2", "Y", 2.0), ("v3", "X", 1.0)]


def backend():
    return tdp.TorchBackend(device="cpu", dtype=torch.float64)


def _params(mod=tdp):
    return mod.AggregateParams(metrics=[mod.Metrics.COUNT, mod.Metrics.SUM],
                               max_partitions_contributed=2,
                               max_contributions_per_partition=3,
                               min_value=0.0, max_value=5.0)


def _spec(seed, public, epsilon=1.0, mod=tdp, spec_cls=JobSpec):
    return spec_cls(params=_params(mod), epsilon=epsilon, delta=1e-6,
                    noise_seed=seed, public_partitions=public)


def _extractors(mod=tdp):
    return mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                              partition_extractor=lambda r: r[1],
                              value_extractor=lambda r: r[2])


def _reference_run(spec, rows):
    """The serial, service-less run of the same spec."""
    accountant = tdp.NaiveBudgetAccountant(total_epsilon=spec.epsilon,
                                           total_delta=spec.delta)
    engine = tdp.DPEngine(accountant, tdp.TorchBackend(
        device="cpu", dtype=torch.float64, noise_seed=spec.noise_seed))
    lazy = engine.aggregate(rows, spec.params, _extractors(),
                            spec.public_partitions)
    accountant.compute_budgets()
    return dict(lazy), accountant


class _SlowRows:
    def __init__(self, rows, delay_s):
        self._rows = rows
        self._delay_s = delay_s

    def __iter__(self):
        time.sleep(self._delay_s)
        return iter(self._rows)


class _PoisonRows:
    def __iter__(self):
        raise RuntimeError("injected source failure")


class _EmptyMsgPoison:
    def __iter__(self):
        raise ValueError()


class _Recorder:
    def __init__(self, order, name):
        self._order = order
        self._name = name

    def __iter__(self):
        self._order.append(self._name)
        return iter(ROWS_A)


# ---------------------------------------------------------------------------
# Concurrency and the ledger of record.


@pytest.mark.hard_timeout(120)
def test_two_tenants_concurrent_equal_serial():
    spec_a = _spec(11, ["A", "B"])
    spec_b = _spec(23, ["X", "Y"])
    want_a, acc_a = _reference_run(spec_a, ROWS_A)
    want_b, acc_b = _reference_run(spec_b, ROWS_B)
    with DPAggregationService(backend(), max_concurrent_jobs=2,
                              tenant_budget_epsilon=10.0) as svc:
        ha = svc.submit("tenant-a", spec_a, ROWS_A)
        hb = svc.submit("tenant-b", spec_b, ROWS_B)
        assert ha.result(timeout=60) == want_a
        assert hb.result(timeout=60) == want_b
        led_a = svc.tenant_ledger("tenant-a")
        led_b = svc.tenant_ledger("tenant-b")
        assert led_a.job_spent_epsilon(ha.job_id) == acc_a.spent_epsilon()
        assert led_b.job_spent_epsilon(hb.job_id) == acc_b.spent_epsilon()
        assert led_a.job_spent_epsilon(hb.job_id) == 0.0
        assert svc.ledgers_reconciled()
        assert ha.spent_epsilon == acc_a.spent_epsilon()
        # torch has no jit cache: no job compiles anything of its own.
        assert ha.jit_cache_misses == 0


@pytest.mark.hard_timeout(120)
def test_select_partitions_job():
    params = tdp.SelectPartitionsParams(max_partitions_contributed=2)
    rows = [(f"u{i}", "P", 0.0) for i in range(200)] + \
           [(f"u{i}", "Q", 0.0) for i in range(200)]
    spec = JobSpec(params=params, epsilon=5.0, delta=1e-4, noise_seed=3)
    with DPAggregationService(backend()) as svc:
        handle = svc.submit("tenant-s", spec, rows)
        assert sorted(handle.result(timeout=60)) == ["P", "Q"]
        assert handle.spent_epsilon == pytest.approx(5.0)
        assert svc.ledgers_reconciled()


@pytest.mark.hard_timeout(180)
def test_service_matches_the_jax_service_and_ledger_format(tmp_path):
    """The same jobs through both services, each over its own ledger
    directory: the same releases (the port's engine bound, 1e-9), the
    same per-job ledger spend, and each directory reloads in the other
    package's ledger."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    jobs = [("tenant-a", 11, ["A", "B"], ROWS_A),
            ("tenant-b", 23, ["X", "Y"], ROWS_B)]
    with DPAggregationService(backend(), port_dir,
                              max_concurrent_jobs=2) as svc:
        port = [svc.submit(t, _spec(s, pub), rows) for t, s, pub, rows in
                jobs]
        port_results = [h.result(timeout=60) for h in port]
    jax_telemetry.reset()
    with JaxService(pdp.TPUBackend(), jax_dir, max_concurrent_jobs=2) as svc:
        ref = [svc.submit(t, _spec(s, pub, mod=pdp, spec_cls=JaxJobSpec),
                          rows) for t, s, pub, rows in jobs]
        ref_results = [h.result(timeout=60) for h in ref]
    jax_telemetry.reset()
    for got, want in zip(port_results, ref_results):
        assert set(got) == set(want)
        for key, metrics in want.items():
            for a, b in zip(got[key], metrics):
                assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)
    for (tenant, _, _, _), hp, hj in zip(jobs, port, ref):
        assert hp.job_id == hj.job_id
        # The JAX directory in the port's ledger, and the other way round.
        mine = TenantLedger(tenant, math.inf,
                            rt_journal.BlockJournal(jax_dir))
        theirs = JaxLedger(tenant, math.inf,
                           jax_journal.BlockJournal(port_dir))
        assert mine.job_spent_epsilon(hj.job_id) == hj.spent_epsilon
        assert theirs.job_spent_epsilon(hp.job_id) == hp.spent_epsilon
        assert hp.spent_epsilon == hj.spent_epsilon
        ported = TenantLedger(tenant, math.inf,
                              rt_journal.BlockJournal(port_dir)).records()
        assert [{k: r[k] for k in ("metric", "mechanism_kind", "eps",
                                   "delta", "count")} for r in ported] == \
            [{k: r[k] for k in ("metric", "mechanism_kind", "eps", "delta",
                                "count")} for r in mine.records()]


# ---------------------------------------------------------------------------
# The epsilon totals fold left to right (Python 3.12's sum() does not).


def _charges(ledger, eps, n):
    for i in range(n):
        ledger.reserve(f"t--j{i + 1:05d}", eps)
        ledger.charge(f"t--j{i + 1:05d}", [{
            "seq": 0, "job_id": "", "metric": "count",
            "mechanism_kind": "MechanismType.LAPLACE", "weight": 1.0,
            "sensitivity": 1.0, "count": 1, "process_index": 0,
            "eps": eps, "delta": 0.0}])


def test_reference_ledger_total_is_compensated():
    """The JAX package's TenantLedger.spent_epsilon() sums its per-job
    totals with the builtin sum(), which Python 3.12 compensates: ten
    charges of 0.1 total 1.0, where the left-to-right fold its docstring
    promises gives 0.9999999999999999 (the cause of the two reference
    TestDualSpendLedger failures)."""
    ledger = JaxLedger("t", math.inf, jax_journal.BlockJournal())
    _charges(ledger, 0.1, 10)
    assert ledger.spent_epsilon() == sum([0.1] * 10)
    assert ledger.spent_epsilon() == 1.0


def test_port_ledger_total_is_the_left_to_right_fold():
    ledger = TenantLedger("t", math.inf, rt_journal.BlockJournal())
    _charges(ledger, 0.1, 10)
    fold = 0.0
    for _ in range(10):
        fold += 0.1
    assert fold == 0.9999999999999999
    assert ledger.spent_epsilon() == fold
    assert ledger.snapshot()["spent_epsilon"] == fold
    for i in range(10):
        ledger.reserve(f"r{i}", 0.1)
    assert ledger.reserved_epsilon() == fold


@pytest.mark.hard_timeout(120)
def test_ledgers_reconcile_with_non_dyadic_mechanism_epsilons():
    """A job of seven mechanisms whose eps shares are not dyadic: the
    ledger's per-job fold, the accountant's spent_epsilon() and the
    handle agree exactly."""
    params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM,
                 tdp.Metrics.PRIVACY_ID_COUNT, tdp.Metrics.MEAN,
                 tdp.Metrics.VARIANCE], max_partitions_contributed=2,
        max_contributions_per_partition=3, min_value=0.0, max_value=5.0)
    spec = JobSpec(params=params, epsilon=0.7, delta=1e-6, noise_seed=5)
    with DPAggregationService(backend()) as svc:
        handle = svc.submit("tenant-n", spec, ROWS_A)
        handle.result(timeout=60)
        ledger = svc.tenant_ledger("tenant-n")
        eps = [r["eps"] for r in ledger.records()]
        assert len(eps) >= 3 and len(set(eps)) >= 1
        assert svc.ledgers_reconciled()
        fold = 0.0
        for e in eps:
            fold += e
        assert ledger.job_spent_epsilon(handle.job_id) == fold == \
            handle.spent_epsilon


def test_accountant_spent_epsilon_is_the_fold_and_odometer_reconciles():
    acc = tdp.NaiveBudgetAccountant(total_epsilon=0.3, total_delta=1e-6)
    for _ in range(7):
        acc.request_budget(tdp.MechanismType.LAPLACE)
    acc.compute_budgets()
    fold = 0.0
    for m in acc._mechanisms:
        fold += m.mechanism_spec.eps
    assert acc.spent_epsilon() == fold
    report = obs.odometer_report(accountant=acc)
    assert report["reconciled"] and report["mechanisms"] == 7
    assert report["spent_epsilon"] == fold


# ---------------------------------------------------------------------------
# Tenant budgets.


@pytest.mark.hard_timeout(120)
def test_exhausted_tenant_rejected_before_any_registration():
    with DPAggregationService(backend(), tenant_budget_epsilon=1.0) as svc:
        first = svc.submit("tenant-x", _spec(7, ["A", "B"], 0.8), ROWS_A)
        assert first.result(timeout=60) is not None
        before = telemetry.snapshot().get("budget_registrations", 0)
        mechanisms = obs.odometer_report()["mechanisms"]
        with pytest.raises(TenantBudgetExceededError) as exc:
            svc.submit("tenant-x", _spec(8, ["A", "B"], 0.5), ROWS_A)
        assert exc.value.retry_after_s is None
        assert telemetry.snapshot().get("budget_registrations",
                                        0) == before
        assert obs.odometer_report()["mechanisms"] == mechanisms
        ok = svc.submit("tenant-x", _spec(9, ["A", "B"], 0.2), ROWS_A)
        assert ok.result(timeout=60) is not None


@pytest.mark.hard_timeout(120)
def test_reservations_count_against_concurrent_submissions():
    with DPAggregationService(backend(), max_concurrent_jobs=1,
                              tenant_budget_epsilon=1.0) as svc:
        h1 = svc.submit("tenant-r", _spec(1, ["A", "B"], 0.7),
                        _SlowRows(ROWS_A, 0.3))
        with pytest.raises(TenantBudgetExceededError):
            svc.submit("tenant-r", _spec(2, ["A", "B"], 0.7), ROWS_A)
        assert h1.result(timeout=60) is not None


@pytest.mark.hard_timeout(120)
def test_failed_before_registration_releases_grant():
    with DPAggregationService(backend(), tenant_budget_epsilon=1.0) as svc:
        bad = JobSpec(params=_params(), epsilon=0.9, delta=1e-6,
                      noise_seed=1, public_partitions=["A"])
        handle = svc.submit("tenant-f", bad, None)
        with pytest.raises(Exception):
            handle.result(timeout=60)
        assert handle.status == JobStatus.FAILED
        ledger = svc.tenant_ledger("tenant-f")
        assert ledger.spent_epsilon() == 0.0
        assert ledger.reserved_epsilon() == 0.0


@pytest.mark.hard_timeout(120)
def test_empty_message_failure_keeps_worker_alive():
    with DPAggregationService(backend(), max_concurrent_jobs=1,
                              tenant_budget_epsilon=5.0) as svc:
        bad = svc.submit("tenant-w", _spec(1, ["A"]), _EmptyMsgPoison())
        with pytest.raises(ValueError):
            bad.result(timeout=60)
        assert bad.status == JobStatus.FAILED
        ok = svc.submit("tenant-w", _spec(2, ["A", "B"]), ROWS_A)
        assert ok.result(timeout=60) is not None
        assert svc.tenant_ledger("tenant-w").reserved_epsilon() == 0.0


@pytest.mark.hard_timeout(120)
def test_failed_after_registration_forfeits_grant():
    with DPAggregationService(backend(), tenant_budget_epsilon=1.0) as svc:
        handle = svc.submit("tenant-g", _spec(1, ["A"], 0.9), _PoisonRows())
        with pytest.raises(RuntimeError, match="injected source"):
            handle.result(timeout=60)
        ledger = svc.tenant_ledger("tenant-g")
        assert ledger.spent_epsilon() == 0.9
        assert ledger.records()[-1]["metric"] == "admission_grant_forfeit"
        assert obs.odometer_report()["mechanisms"] == 0


# ---------------------------------------------------------------------------
# Ledger persistence.


@pytest.mark.hard_timeout(120)
def test_ledger_survives_service_restart(tmp_path):
    ledger_dir = str(tmp_path)
    with DPAggregationService(backend(), ledger_dir,
                              tenant_budget_epsilon=1.0) as svc:
        handle = svc.submit("tenant-p", _spec(5, ["A", "B"], 0.6), ROWS_A)
        handle.result(timeout=60)
        spent = handle.spent_epsilon
        assert spent == 0.6
    with DPAggregationService(backend(), ledger_dir,
                              tenant_budget_epsilon=1.0) as svc2:
        ledger = svc2.tenant_ledger("tenant-p")
        assert ledger.spent_epsilon() == spent
        assert ledger.job_spent_epsilon(handle.job_id) == spent
        with pytest.raises(TenantBudgetExceededError):
            svc2.submit("tenant-p", _spec(6, ["A", "B"], 0.5), ROWS_A)
        ok = svc2.submit("tenant-p", _spec(7, ["A", "B"], 0.3), ROWS_A)
        assert ok.result(timeout=60) is not None
        assert ok.job_id != handle.job_id
        assert svc2.ledgers_reconciled()


def test_ledger_records_ride_the_odometer_format(tmp_path):
    ledger = TenantLedger("tenant-o", 2.0,
                          rt_journal.BlockJournal(str(tmp_path)))
    ledger.reserve("job-1", 1.0)
    ledger.charge("job-1", [{
        "seq": 0, "job_id": "job-1", "metric": "count",
        "mechanism_kind": "MechanismType.LAPLACE", "weight": 1.0,
        "sensitivity": 1.0, "count": 1, "process_index": 0, "eps": 1.0,
        "delta": 0.0}])
    loaded = obs.load_odometer(rt_journal.BlockJournal(str(tmp_path)),
                               "tenant-o")
    assert len(loaded) == 1 and loaded[0]["eps"] == 1.0
    assert loaded[0]["metric"] == "count"


def test_journal_quarantines_a_corrupt_record(tmp_path):
    journal = rt_journal.BlockJournal(str(tmp_path))
    obs.persist_odometer(journal, "tenant-c", records=[{
        "seq": 0, "job_id": "j", "metric": "sum", "mechanism_kind": "k",
        "weight": 1.0, "sensitivity": 1.0, "count": 1, "process_index": 0,
        "eps": 0.5, "delta": None}])
    (path,) = tmp_path.glob("*.npz")
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    fresh = rt_journal.BlockJournal(str(tmp_path))
    assert obs.load_odometer(fresh, "tenant-c") == []
    assert list(tmp_path.glob("*.corrupt"))
    assert telemetry.snapshot()["journal_quarantined"] == 1
    assert rt_health.for_job("tenant-c").state == \
        rt_health.HealthState.DEGRADED


def test_storage_failure_is_typed(tmp_path, monkeypatch):
    journal = rt_journal.BlockJournal(str(tmp_path))

    def no_space(*args, **kwargs):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(np, "savez", no_space)
    with pytest.raises(rt_journal.StorageUnavailableError):
        obs.persist_odometer(journal, "tenant-s", records=[])
    assert telemetry.snapshot()["storage_disk_full"] == 1
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# Admission control.


@pytest.mark.hard_timeout(120)
def test_watermark_shed_with_injected_squeeze(monkeypatch):
    monkeypatch.setattr(obs, "memory_watermark",
                        lambda: {"live_bytes": 9_000, "peak_bytes": 9_000,
                                 "source": "accounted"})
    with DPAggregationService(backend(), shed_watermark_fraction=0.5,
                              memory_limit_bytes=10_000) as svc:
        with pytest.raises(AdmissionRejectedError) as exc:
            svc.submit("tenant-m", _spec(1, ["A"]), ROWS_A)
        assert exc.value.retry_after_s is not None
        assert not isinstance(exc.value, TenantBudgetExceededError)
        assert telemetry.snapshot()["service_jobs_shed"] == 1
        monkeypatch.setattr(obs, "memory_watermark",
                            lambda: {"live_bytes": 100, "peak_bytes": 9_000,
                                     "source": "accounted"})
        handle = svc.submit("tenant-m", _spec(1, ["A", "B"]), ROWS_A)
        assert handle.result(timeout=60) is not None


def test_memory_watermark_is_accounted_on_the_cpu():
    obs.account_bytes(1000)
    obs.release_bytes(400)
    wm = obs.memory_watermark()
    assert wm == {"live_bytes": 600, "peak_bytes": 1000,
                  "source": "accounted"}
    assert service_module._device_bytes_limit(backend()) is None


@pytest.mark.hard_timeout(120)
def test_queue_timeout_sheds_and_releases_reservation():
    with DPAggregationService(backend(), max_concurrent_jobs=1,
                              tenant_budget_epsilon=2.0,
                              queue_timeout_s=0.05) as svc:
        h1 = svc.submit("tenant-q", _spec(1, ["A", "B"]),
                        _SlowRows(ROWS_A, 0.5))
        h2 = svc.submit("tenant-q", _spec(2, ["A", "B"]), ROWS_A)
        with pytest.raises(AdmissionRejectedError) as exc:
            h2.result(timeout=60)
        assert exc.value.retry_after_s == pytest.approx(0.05)
        assert h2.status == JobStatus.SHED
        assert h1.result(timeout=60) is not None
        ledger = svc.tenant_ledger("tenant-q")
        assert ledger.reserved_epsilon() == 0.0
        assert ledger.spent_epsilon() == h1.spent_epsilon


@pytest.mark.hard_timeout(120)
def test_stop_cancels_queued_jobs_and_releases_grants():
    svc = DPAggregationService(backend(), max_concurrent_jobs=1,
                               tenant_budget_epsilon=5.0)
    h1 = svc.submit("tenant-z", _spec(1, ["A", "B"]), _SlowRows(ROWS_A, 0.3))
    h2 = svc.submit("tenant-z", _spec(2, ["A", "B"]), ROWS_A)
    deadline = time.monotonic() + 10
    while h1.status == JobStatus.QUEUED and time.monotonic() < deadline:
        time.sleep(0.01)
    svc.stop()
    assert h1.status == JobStatus.DONE
    with pytest.raises(AdmissionRejectedError, match="stopped"):
        h2.result(timeout=1)
    assert svc.tenant_ledger("tenant-z").reserved_epsilon() == 0.0
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit("tenant-z", _spec(3, ["A"]), ROWS_A)


@pytest.mark.hard_timeout(120)
def test_submit_racing_stop_releases_reservation(monkeypatch):
    svc = DPAggregationService(backend(), tenant_budget_epsilon=1.0)
    orig = svc._shed_check

    def shed_check_then_stop():
        orig()
        svc.stop()

    monkeypatch.setattr(svc, "_shed_check", shed_check_then_stop)
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit("tenant-race", _spec(1, ["A"]), ROWS_A)
    assert svc.tenant_ledger("tenant-race").reserved_epsilon() == 0.0


@pytest.mark.hard_timeout(120)
def test_priority_orders_the_queue():
    with DPAggregationService(backend(), max_concurrent_jobs=1,
                              queue_timeout_s=60.0) as svc:
        order = []
        h0 = svc.submit("t", _spec(1, ["A", "B"]), _SlowRows(ROWS_A, 0.2))
        lazy = _spec(2, ["A", "B"])
        lazy.priority = 5
        urgent = _spec(3, ["A", "B"])
        urgent.priority = 1
        h_lazy = svc.submit("t", lazy, _Recorder(order, "lazy"))
        h_urgent = svc.submit("t", urgent, _Recorder(order, "urgent"))
        for h in (h0, h_lazy, h_urgent):
            h.result(timeout=60)
        assert order == ["urgent", "lazy"]


@pytest.mark.hard_timeout(120)
def test_drain_counts_jobs():
    svc = DPAggregationService(backend(), max_concurrent_jobs=1)
    done = svc.submit("t", _spec(1, ["A", "B"]), ROWS_A)
    done.result(timeout=60)
    counts = svc.drain()
    assert counts == {"completed": 1, "cancelled": 0, "failed": 0, "shed": 0}


# ---------------------------------------------------------------------------
# Deadlines and cancellation (tests/test_chaos.py::TestDeadlineAndCancel).


@pytest.mark.hard_timeout(120)
def test_expired_deadline_settles_cancelled_charges_nothing(tmp_path):
    with DPAggregationService(backend(), str(tmp_path),
                              max_concurrent_jobs=1) as svc:
        handle = svc.submit("acme", _spec(1, ["A", "B"]), ROWS_A,
                            deadline_s=1e-6)
        assert handle.wait(60)
        assert handle.status == JobStatus.CANCELLED
        error = handle.exception(timeout=0)
        assert isinstance(error, JobCancelledError)
        assert error.reason == "deadline"
        assert handle.spent_epsilon is None
        good = svc.submit("acme", _spec(2, ["A", "B"]), ROWS_A)
        assert good.wait(60) and good.status == JobStatus.DONE
        records = svc.tenant_ledger("acme").records()
        assert {r["job_id"] for r in records} == {good.job_id}
    assert telemetry.snapshot()["service_jobs_cancelled"] == 1


@pytest.mark.hard_timeout(120)
def test_cancel_of_a_queued_job_settles_cancelled():
    with DPAggregationService(backend(), max_concurrent_jobs=1) as svc:
        busy = svc.submit("acme", _spec(1, ["A", "B"]),
                          _SlowRows(ROWS_A, 0.3))
        queued = svc.submit("acme", _spec(2, ["A", "B"]), ROWS_A)
        assert queued.cancel()
        assert queued.wait(60)
        assert queued.status == JobStatus.CANCELLED
        assert queued.exception(timeout=0).reason == "cancelled"
        assert busy.result(timeout=60) is not None
        assert busy.cancel() is False
        assert svc.tenant_ledger("acme").reserved_epsilon() == 0.0


def test_watchdog_cancel_all_expires_guards():
    wd = rt_watchdog.Watchdog(timeout_s=30.0)
    with rt_watchdog.activate(wd):
        with rt_watchdog.guard("dispatch", 3) as g:
            assert wd.cancel_all() == 1
            assert g.cancelled
            with pytest.raises(rt_watchdog.BlockTimeoutError):
                wd.check(g)
    wd.close()
    with pytest.raises(ValueError, match="timeout_s"):
        rt_watchdog.Watchdog(timeout_s=0)


@pytest.mark.hard_timeout(60)
def test_watchdog_monitor_marks_the_job_stalled():
    wd = rt_watchdog.Watchdog(timeout_s=0.05, poll_interval_s=0.005)
    with rt_health.job_scope("slow-job"):
        with wd.guard("drain") as g:
            deadline = time.monotonic() + 10
            while not g.cancelled and time.monotonic() < deadline:
                time.sleep(0.01)
    wd.close()
    assert g.expired
    snap = rt_health.for_job("slow-job").snapshot()
    assert snap["counters"]["watchdog_timeouts"] == 1
    assert snap["state"] == "DEGRADED"  # late completion after the stall
    assert telemetry.snapshot()["watchdog_late_completions"] == 1


# ---------------------------------------------------------------------------
# Resident growth bounds, metrics, validation, the reset guard.


@pytest.mark.hard_timeout(120)
def test_completed_jobs_prune_their_odometer_records():
    with DPAggregationService(backend()) as svc:
        svc.submit("tenant-1", _spec(1, ["A", "B"]), ROWS_A).result(60)
        svc.submit("tenant-2", _spec(2, ["A", "B"]), ROWS_A).result(60)
        assert obs.odometer_report()["mechanisms"] == 0
        assert svc.ledgers_reconciled()
        assert svc.tenant_ledger("tenant-1").records()


@pytest.mark.hard_timeout(120)
def test_handle_retention_is_bounded(monkeypatch):
    monkeypatch.setattr(service_module, "_MAX_RETAINED_HANDLES", 3)
    with DPAggregationService(backend()) as svc:
        for i in range(6):
            svc.submit("tenant-h", _spec(i + 1, ["A", "B"]),
                       ROWS_A).result(timeout=60)
        retained = svc.handles()
        assert len(retained) == 3
        assert all(h.status == JobStatus.DONE for h in retained)
        assert len(svc.tenant_ledger("tenant-h").snapshot()["jobs"]) == 6


@pytest.mark.hard_timeout(120)
def test_service_counters_export_through_strict_parser():
    with DPAggregationService(backend()) as svc:
        svc.submit("tenant-e", _spec(1, ["A", "B"]), ROWS_A).result(60)
        stats = svc.stats()
    parsed = obs.parse_prometheus(obs.render_prometheus())
    assert parsed["pdp_service_jobs_queued"]["samples"][""] == 1.0
    assert parsed["pdp_service_jobs_admitted"]["samples"][""] == 1.0
    assert parsed["pdp_service_jobs_shed"]["samples"][""] == 0.0
    assert parsed["pdp_service_active_jobs"]["type"] == "gauge"
    assert parsed["pdp_service_active_jobs"]["samples"][""] == 0.0
    assert parsed["pdp_service_queue_depth"]["samples"][""] == 0.0
    assert parsed["pdp_budget_registrations"]["samples"][""] == 2.0
    assert stats["jobs_by_status"][JobStatus.DONE] == 1
    assert stats["ledgers_reconciled"] and "tenant-e" in stats["ledgers"]
    assert stats["compile_reuse"][_spec(1, ["A", "B"]).cache_key] == {
        "jobs": 1, "jit_cache_misses": 0}
    with pytest.raises(ValueError, match="grammar"):
        obs.parse_prometheus("# TYPE pdp_x counter\nnot a sample line")


def test_telemetry_rejects_undeclared_metrics():
    with pytest.raises(ValueError, match="not a declared metric"):
        telemetry.record("no_such_counter")
    with pytest.raises(ValueError, match="not a counter"):
        telemetry.record("service_active_jobs")
    with pytest.raises(ValueError, match="not a gauge"):
        telemetry.set_gauge("service_jobs_queued", 1)
    before = telemetry.snapshot()
    telemetry.record("service_jobs_queued", 2)
    assert telemetry.delta(before) == {"service_jobs_queued": 2}


def test_trace_spans_nest_and_dump(tmp_path):
    trace.enable()
    with rt_health.job_scope("job-t"):
        with trace.span("outer", bytes=8):
            with trace.span("inner") as sp:
                sp.set(lanes=2)
            telemetry.record("service_jobs_queued")
    summary = trace.trace_summary(job_id="job-t")
    assert summary["spans"]["outer"]["count"] == 1
    assert summary["spans"]["outer"]["exclusive_s"] <= \
        summary["spans"]["outer"]["inclusive_s"]
    assert summary["instants"] == {"service_jobs_queued": 1}
    assert summary["transfer_bytes"] == 8
    path = trace.dump(str(tmp_path / "t.json"), job_id="job-t")
    import json
    events = json.load(open(path))["traceEvents"]
    inner = [e for e in events if e["name"] == "inner"]
    assert inner[0]["args"] == {"lanes": 2, "job": "job-t",
                                "exclusive_us": inner[0]["args"][
                                    "exclusive_us"]}
    trace.disable()
    assert trace.span("x") is trace.span("y")


@pytest.mark.hard_timeout(60)
def test_bad_knobs_rejected():
    with pytest.raises(ValueError, match="max_concurrent_jobs"):
        DPAggregationService(backend(), max_concurrent_jobs=0)
    with pytest.raises(ValueError, match="tenant_budget_epsilon"):
        DPAggregationService(backend(), tenant_budget_epsilon=-1.0)
    with pytest.raises(ValueError, match="queue_timeout_s"):
        DPAggregationService(backend(), queue_timeout_s=0)
    with pytest.raises(ValueError, match="shed_watermark_fraction"):
        DPAggregationService(backend(), shed_watermark_fraction=1.5)
    with pytest.raises(ValueError, match="TorchBackend"):
        DPAggregationService(tdp.LocalBackend())
    with pytest.raises(ValueError, match="batching must be a bool"):
        DPAggregationService(backend(), batching=1)
    with pytest.raises(ValueError, match="batch_window_ms"):
        DPAggregationService(backend(), batching=True, batch_window_ms=0)
    with pytest.raises(ValueError, match="max_batch_jobs"):
        DPAggregationService(backend(), batching=True, max_batch_jobs=1)
    with pytest.raises(ValueError, match="tenant_accounting"):
        DPAggregationService(backend(), tenant_accounting="exact")


@pytest.mark.hard_timeout(60)
def test_the_service_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DPAggregationService(tdp.TorchBackend())


def test_for_job_view_shares_the_parent_knobs():
    parent = tdp.TorchBackend(device="cpu", dtype=torch.float64,
                              noise_seed=3, max_partitions=40,
                              large_partition_threshold=None)
    view = parent.for_job(job_id="t--j00001", noise_seed=9)
    assert (view.device, view.dtype, view.max_partitions,
            view.large_partition_threshold) == (parent.device, parent.dtype,
                                                40, None)
    assert view.noise_seed == 9
    assert parent.for_job().noise_seed == 3


@pytest.mark.hard_timeout(120)
def test_path_unsafe_tenant_and_bad_spec_rejected():
    with DPAggregationService(backend()) as svc:
        with pytest.raises(ValueError, match="path"):
            svc.submit("ten/ant", _spec(1, ["A"]), ROWS_A)
        with pytest.raises(ValueError, match="JobSpec"):
            svc.submit("tenant", _params(), ROWS_A)
        with pytest.raises(ValueError, match="epsilon"):
            svc.submit("tenant", _spec(1, ["A"], epsilon=-1.0), ROWS_A)


@pytest.mark.hard_timeout(60)
def test_reset_refuses_while_job_scope_active():
    started = threading.Event()
    release = threading.Event()

    def hold():
        with rt_health.job_scope("live-job"):
            telemetry.record("service_jobs_queued")
            started.set()
            release.wait(20)

    worker = threading.Thread(target=hold)
    worker.start()
    try:
        assert started.wait(10)
        assert rt_health.active_job_scopes() == 1
        telemetry.reset()
        assert telemetry.snapshot().get("service_jobs_queued") == 1
        assert rt_health.snapshot_all().get("live-job") is not None
        telemetry.reset(force=True)
        assert telemetry.snapshot() == {}
    finally:
        release.set()
        worker.join(timeout=20)
    assert rt_health.active_job_scopes() == 0


@pytest.mark.hard_timeout(120)
def test_pld_accounting_admits_against_the_composed_spend():
    with DPAggregationService(backend(), tenant_accounting="pld",
                              tenant_budget_epsilon=100.0) as svc:
        for seed in range(3):
            svc.submit("tenant-pld", _spec(seed, ["A", "B"], 1.0),
                       ROWS_A).result(timeout=60)
        ledger = svc.tenant_ledger("tenant-pld")
        snap = ledger.snapshot()
        assert snap["spent_epsilon"] == 3.0
        assert snap["admission_spent_epsilon"] <= snap["spent_epsilon"]
        assert math.isfinite(snap["pld_spent_epsilon"])
        assert svc.ledgers_reconciled()
