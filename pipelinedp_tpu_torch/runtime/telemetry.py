"""Process-wide metrics registry: counters, gauges and phase timings.

Port of pipelinedp_tpu/runtime/telemetry.py, for the metrics the port
records: the budget registrations, the journal's storage incidents, the
watchdog's verdicts and the multi-tenant service's counters and gauges
(service/). Every metric is declared in REGISTRY (name, kind, help);
record() increments a declared counter and set_gauge() sets a declared
gauge, and both raise on an undeclared name or the wrong kind. Gauges are
keyed by (name, job_id): set under a job_scope they belong to that job,
and render_prometheus (runtime/observability.py) labels them with it.

Counters are monotonic per process; callers snapshot() before a run and
delta() after. Every record() also lands as an instant event on the trace
timeline when tracing is on, and is forwarded to the current job's health
record (runtime/health.py). Since the failure semantics of the meshed
drivers (runtime/retry.py) the retry, OOM re-plan and elastic-mesh
counters are here too; the JAX package's jit, AOT and chaos counters have
no counterpart in the port yet (ROADMAP.md Queue 1 steps 5 and 9).
"""

import collections
import logging
import threading
from typing import Dict

from pipelinedp_tpu_torch.runtime import trace
from pipelinedp_tpu_torch.runtime.concurrency import guarded_by

Metric = collections.namedtuple("Metric", ["name", "kind", "help"])


def _counter(name: str, help_text: str) -> Metric:
    return Metric(name, "counter", help_text)


def _gauge(name: str, help_text: str) -> Metric:
    return Metric(name, "gauge", help_text)


REGISTRY: Dict[str, Metric] = {
    m.name: m
    for m in (
        _counter("budget_registrations",
                 "mechanisms registered with a BudgetAccountant ledger "
                 "(graph-build time only)"),
        _counter("journal_quarantined",
                 "corrupt/truncated journal records renamed aside and "
                 "never replayed"),
        _counter("watchdog_timeouts",
                 "deadline expiries observed by the watchdog monitor"),
        _counter("watchdog_late_completions",
                 "guarded operations that completed after their deadline "
                 "had already expired"),
        _counter("trace_dropped_events",
                 "trace events dropped because the bounded trace buffer "
                 "was full"),
        _counter("storage_disk_full",
                 "journal persists refused with ENOSPC (disk full)"),
        _counter("storage_fsync_failures",
                 "journal fsyncs the kernel refused (the tmp is unlinked "
                 "and rewritten once on a fresh fd)"),
        _counter("storage_io_errors",
                 "EIO-class I/O failures at the journal's storage seams"),
        _counter("storage_unavailable",
                 "journal persists that failed closed after the storage "
                 "discipline was exhausted (StorageUnavailableError)"),
        _counter("service_jobs_admitted",
                 "jobs a DPAggregationService worker picked up and "
                 "started executing"),
        _counter("service_jobs_queued",
                 "jobs accepted by DPAggregationService.submit into the "
                 "admission queue"),
        _counter("service_batch_launches",
                 "megabatched release launches dispatched by the "
                 "service's coalescing tier (one lane-batched release "
                 "per >= 2-lane group)"),
        _counter("service_jobs_batched",
                 "jobs whose release ran as one lane of a megabatched "
                 "launch (increments by the lane count per batch)"),
        _counter("service_jobs_shed",
                 "service submissions refused by load shedding (memory "
                 "watermark at submit, queue_timeout_s on dequeue, a "
                 "ledger store that cannot persist) or refused by the "
                 "release sentinel"),
        _counter("service_jobs_cancelled",
                 "jobs settled CANCELLED (JobHandle.cancel() or a "
                 "deadline_s expiry): reservation released, nothing "
                 "charged, result withheld"),
        _counter("pipeline_device_encode_chunks",
                 "pod shards encoded through the hash-device route (keys "
                 "hashed on the host, codes assigned on the device by "
                 "device_encode.mesh_factorize_codes)"),
        _counter("ingest_hash_collisions",
                 "64-bit key-hash collisions the hash-device pod ingest's "
                 "detector caught (each fell back to the exact host "
                 "encoder or raised HashCollisionError)"),
        _counter("reshard_capacity_reuse",
                 "device reshards whose measured loads fit the cached "
                 "exchange capacities of their geometry "
                 "(parallel/reshard.py)"),
        _counter("injected_faults",
                 "faults raised by the injection harness "
                 "(runtime/faults.py)"),
        _counter("block_retries",
                 "transient dispatch/sync failures retried"),
        _counter("block_timeouts",
                 "blocks whose deadline expired (a deadline error "
                 "surfaced at dispatch or at the sync)"),
        _counter("block_oom_degradations",
                 "partition block capacity halvings after OOM (or after "
                 "repeated deadline expiries)"),
        _counter("release_dispatches",
                 "blocks dispatched by the blocked drivers "
                 "(large_p._dispatch_blocks), re-dispatches included"),
        _counter("host_fetch_retries",
                 "transient control-table fetch failures retried"),
        _counter("retry_budget_exhausted",
                 "jobs whose total transient-retry budget "
                 "(RetryPolicy.max_total_retries) ran out"),
        _counter("device_losses",
                 "device-fatal failures observed (a slot dropped out of "
                 "the mesh)"),
        _counter("host_losses",
                 "whole-host losses observed (a process lost every one of "
                 "its slots at once)"),
        _counter("mesh_degradations",
                 "elastic mesh rebuilds onto fewer slots after a device "
                 "loss"),
        _counter("mesh_expansions",
                 "elastic mesh rebuilds onto more slots after admitting "
                 "joining slots at a block boundary "
                 "(run_with_mesh_elasticity scale-up)"),
        _gauge("live_devices",
               "slots currently live in the elastic mesh of the gauge's "
               "job (== planned until a device loss shrinks it)"),
        _gauge("mesh_target_devices",
               "slot count the elastic runtime currently targets for the "
               "gauge's job (== planned at entry; grows on scale-up "
               "admissions, shrinks on degradations)"),
        _gauge("job_health_state",
               "numeric health state of a job (0 HEALTHY, 1 DEGRADED, "
               "2 STALLED, 3 FAILED - runtime/health.HealthState)"),
        _gauge("budget_epsilon_remaining",
               "total_epsilon minus the epsilon already apportioned to "
               "registered mechanisms"),
        _gauge("device_memory_live_bytes",
               "bytes currently allocated on the card "
               "(torch.cuda.memory_allocated; the byte-accounted fallback "
               "on the CPU)"),
        _gauge("device_memory_peak_bytes",
               "peak bytes allocated on the card "
               "(torch.cuda.max_memory_allocated; the accounted peak on "
               "the CPU)"),
        _gauge("service_active_jobs",
               "jobs currently executing on the DPAggregationService "
               "worker pool"),
        _gauge("service_queue_depth",
               "jobs waiting in the service admission queue"),
        _gauge("tenant_pld_epsilon_saved",
               "naive-composition spend minus PLD-composed spend for the "
               "gauge's tenant (job_id label = tenant id)"),
        _gauge("service_batch_occupancy",
               "lane count of the most recent megabatched launch"),
    )
}


_lock = threading.Lock()
counters: "collections.Counter[str]" = collections.Counter()
# name -> [count, min, max, sum] of recorded durations.
_timings: Dict[str, list] = {}
_job_timings: Dict[str, Dict[str, list]] = {}
# (gauge name, job_id or None) -> last set value.
_gauges: Dict[tuple, float] = {}
_GUARDED_BY = guarded_by("_lock", "counters", "_timings", "_job_timings",
                         "_gauges")

# "No job_id passed" (the current job scope) apart from job_id=None (a
# process-level gauge).
_CURRENT_JOB = object()


def record(name: str, n: int = 1, **attrs) -> None:
    """Increments a declared counter. Keyword attributes go to the trace
    timeline's instant event only."""
    if name not in REGISTRY:
        raise ValueError(
            f"telemetry.record({name!r}): not a declared metric. Declare "
            f"it in telemetry.REGISTRY (name, kind, help) first. "
            f"Declared: {sorted(REGISTRY)}")
    if REGISTRY[name].kind != "counter":
        raise ValueError(
            f"telemetry.record({name!r}): declared as a "
            f"{REGISTRY[name].kind}, not a counter - levels are set with "
            f"set_gauge().")
    with _lock:
        counters[name] += n
    if trace.enabled():
        trace.instant(name, **attrs)
    # Lazy import: health imports telemetry.
    from pipelinedp_tpu_torch.runtime import health
    health.observe_counter(name, n)


def set_gauge(name: str, value, job_id=_CURRENT_JOB) -> None:
    """Sets a declared gauge. With the default job_id the current job
    scope owns the value; job_id=None is a process-level gauge."""
    metric = REGISTRY.get(name)
    if metric is None:
        raise ValueError(
            f"telemetry.set_gauge({name!r}): not a declared metric. "
            f"Declared gauges: "
            f"{sorted(m.name for m in REGISTRY.values() if m.kind == 'gauge')}"
        )
    if metric.kind != "gauge":
        raise ValueError(
            f"telemetry.set_gauge({name!r}): declared as a "
            f"{metric.kind}, not a gauge - counters increment via "
            f"record().")
    if job_id is _CURRENT_JOB:
        from pipelinedp_tpu_torch.runtime import health
        h = health.current()
        job_id = h.job_id if h is not None else None
    with _lock:
        _gauges[(name, job_id)] = float(value)


def gauge_snapshot() -> Dict[str, Dict[str, float]]:
    """{gauge name: {job_id or "": value}} for every gauge set this
    epoch ("" is the process-level value)."""
    with _lock:
        items = list(_gauges.items())
    out: Dict[str, Dict[str, float]] = {}
    for (name, job), value in items:
        out.setdefault(name, {})[job if job is not None else ""] = value
    return out


def _fold_timing(store: Dict[str, list], name: str, seconds: float) -> None:
    entry = store.get(name)
    if entry is None:
        store[name] = [1, seconds, seconds, seconds]
    else:
        entry[0] += 1
        entry[1] = min(entry[1], seconds)
        entry[2] = max(entry[2], seconds)
        entry[3] += seconds


def record_duration(name: str, seconds: float) -> None:
    """Aggregates one phase wall time (count, min, max, sum), process-wide
    and under the current job's id."""
    seconds = float(seconds)
    from pipelinedp_tpu_torch.runtime import health
    h = health.current()
    job = h.job_id if h is not None else None
    with _lock:
        _fold_timing(_timings, name, seconds)
        if job is not None:
            _fold_timing(_job_timings.setdefault(job, {}), name, seconds)
    health.observe_duration(name, seconds)


def _stats(store: Dict[str, list]) -> Dict[str, Dict[str, float]]:
    return {
        name: {"count": e[0], "min": e[1], "max": e[2], "sum": e[3]}
        for name, e in store.items()
    }


def timing_snapshot(
        job_id: "str | None" = None) -> Dict[str, Dict[str, float]]:
    """Per-phase wall-time stats, process-wide or of one job."""
    with _lock:
        if job_id is None:
            return _stats(_timings)
        return _stats(_job_timings.get(job_id, {}))


def snapshot() -> Dict[str, int]:
    """Counter values only, a flat {name: int} for delta()."""
    with _lock:
        return dict(counters)


def delta(before: Dict[str, int]) -> Dict[str, int]:
    """Counter increments since a snapshot() (zero-valued keys omitted)."""
    now = snapshot()
    out = {k: now.get(k, 0) - before.get(k, 0)
           for k in set(now) | set(before)}
    return {k: v for k, v in out.items() if v}


def reset(force: bool = False) -> None:
    """Coordinated epoch reset: counters, gauges, timings, trace buffers,
    health records, the memory accounting and the budget odometer clear
    together. While any job_scope is active (a resident service's running
    job) it warns and does nothing, unless force=True."""
    from pipelinedp_tpu_torch.runtime import health
    from pipelinedp_tpu_torch.runtime import observability
    if not force:
        active = health.active_job_scopes()
        if active:
            logging.warning(
                "telemetry.reset(): %d job_scope(s) are active - a "
                "process-wide epoch reset would corrupt live jobs' "
                "health/odometer state, so the reset is skipped.", active)
            return
    with _lock:
        counters.clear()
        _timings.clear()
        _job_timings.clear()
        _gauges.clear()
    health.reset()
    trace.reset()
    observability.reset_epoch()
