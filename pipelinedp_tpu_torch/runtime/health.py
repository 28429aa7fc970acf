"""Per-job health state machine (pipelinedp_tpu/runtime/health.py).

A JobHealth aggregates watchdog verdicts, the runtime's telemetry and
per-phase wall time into four states:

    HEALTHY   no anomaly observed.
    DEGRADED  the job recovered from adversity (a retry, an OOM capacity
              halving, a quarantined journal record, a late completion,
              an elastic mesh shrink after a device loss). Meshed elastic
              runs also report planned and live slot counts, and fleet
              events (REJOINING) are notes beside the state.
    STALLED   a deadline expired on an operation that has not completed;
              demoted to DEGRADED when it completes.
    FAILED    the job raised. A later completed run of the same job
              demotes it to DEGRADED.

Severity only escalates (but for the STALLED -> DEGRADED demotion). A
job_scope(job_id) makes the job's record the thread's current one;
telemetry.record() and record_duration() forward to it. The process index
is 0: the port runs one process until the multi-GPU slice (ROADMAP item
12).
"""

import contextlib
import enum
import threading
import time
from typing import Dict, Optional

from pipelinedp_tpu_torch.runtime.concurrency import guarded_by


class HealthState(enum.IntEnum):
    HEALTHY = 0
    DEGRADED = 1
    STALLED = 2
    FAILED = 3


_DEGRADING_COUNTERS = frozenset({"journal_quarantined",
                                 "watchdog_late_completions",
                                 "block_retries", "block_oom_degradations",
                                 "host_fetch_retries", "device_losses",
                                 "host_losses", "mesh_degradations"})
_STALLING_COUNTERS = frozenset({"watchdog_timeouts", "block_timeouts"})
# A scale-up admission is planned work with the same results, not
# adversity: tracked, but it never moves the state.
_TRACKED_COUNTERS = (_DEGRADING_COUNTERS | _STALLING_COUNTERS |
                     frozenset({"mesh_expansions"}))

# Bound on the per-job fleet-event notes: an audit trail, not a log.
_MAX_FLEET_EVENTS = 32


def _process_index() -> int:
    """This process's index in a multi-process job: 0, the port's meshes
    being single-controller, until the multi-process mesh over
    torch.distributed (ROADMAP.md Queue 1 step 9) is ported."""
    return 0


class JobHealth:
    """Thread-safe health record of one job."""

    _GUARDED_BY = guarded_by("_lock", "_state", "_counters",
                             "_phase_seconds", "_last_error", "_last_beat",
                             "_planned_devices", "_live_devices",
                             "_completed_runs", "_fleet_events")

    def __init__(self, job_id: str):
        self.job_id = job_id
        self.process_index = _process_index()
        self._lock = threading.Lock()
        self._state = HealthState.HEALTHY
        self._counters: Dict[str, int] = {}
        self._phase_seconds: Dict[str, float] = {}
        self._last_error: Optional[str] = None
        self._last_beat: Optional[float] = None
        self._completed_runs = 0
        # Elastic mesh state: the slot count the job entered on and the
        # count still live (None until a meshed elastic run reports).
        self._planned_devices: Optional[int] = None
        self._live_devices: Optional[int] = None
        self._fleet_events: list = []

    def _escalate(self, state: HealthState) -> None:  # caller holds _lock
        if self._state is not HealthState.FAILED and state > self._state:
            self._state = state

    def observe_counter(self, name: str, n: int = 1) -> None:
        if name not in _TRACKED_COUNTERS:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
            if name in _STALLING_COUNTERS:
                self._escalate(HealthState.STALLED)
            elif name in _DEGRADING_COUNTERS:
                self._escalate(HealthState.DEGRADED)

    def observe_duration(self, name: str, seconds: float) -> None:
        with self._lock:
            self._phase_seconds[name] = (self._phase_seconds.get(name, 0.0) +
                                         float(seconds))

    def note_timeout(self, phase: str, block: int) -> None:
        """A deadline expired on an in-flight operation (the watchdog
        monitor posts this directly)."""
        with self._lock:
            self._counters["watchdog_timeouts"] = (
                self._counters.get("watchdog_timeouts", 0) + 1)
            self._escalate(HealthState.STALLED)
            self._last_error = f"deadline expired: {phase} block {block}"

    def note_mesh(self, planned_devices: int, live_devices: int) -> None:
        """Elastic mesh report (runtime/retry.py's elastic loop): the slot
        count the job was planned on and the count still live. A shrink
        is DEGRADED; losses past the floor fail the job through
        note_failed."""
        with self._lock:
            self._planned_devices = int(planned_devices)
            self._live_devices = int(live_devices)
            if live_devices < planned_devices:
                self._escalate(HealthState.DEGRADED)
        # Outside the lock: set_gauge takes telemetry's lock.
        from pipelinedp_tpu_torch.runtime import telemetry
        telemetry.set_gauge("live_devices", int(live_devices),
                            job_id=self.job_id)

    def note_fleet_event(self, kind: str, detail: str) -> None:
        """Notes a fleet operation on the job's record: REJOINING (a
        scale-up admitted, or aborted admitting, joining slots) or
        MIGRATING. Notes, not states: the health state is untouched."""
        if kind not in ("REJOINING", "MIGRATING"):
            raise ValueError(f"unknown fleet event kind {kind!r}")
        with self._lock:
            if len(self._fleet_events) < _MAX_FLEET_EVENTS:
                self._fleet_events.append((kind, str(detail)))

    def note_recovered(self) -> None:
        with self._lock:
            if self._state is HealthState.STALLED:
                self._state = HealthState.DEGRADED

    def note_failed(self, exc: BaseException) -> None:
        with self._lock:
            self._state = HealthState.FAILED
            self._last_error = f"{type(exc).__name__}: {exc}"

    def note_complete(self) -> None:
        with self._lock:
            self._completed_runs += 1
            if self._state in (HealthState.STALLED, HealthState.FAILED):
                self._state = HealthState.DEGRADED

    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()

    @property
    def state(self) -> HealthState:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            age = (None if self._last_beat is None else
                   round(time.monotonic() - self._last_beat, 3))
            return {
                "job_id": self.job_id,
                "process_index": self.process_index,
                "state": self._state.name,
                "counters": dict(self._counters),
                "journal_quarantined":
                    self._counters.get("journal_quarantined", 0),
                "planned_devices": self._planned_devices,
                "live_devices": self._live_devices,
                "fleet_events": [
                    {"kind": k, "detail": d} for k, d in self._fleet_events
                ],
                "phase_seconds": {
                    k: round(v, 6) for k, v in self._phase_seconds.items()
                },
                "completed_runs": self._completed_runs,
                "last_error": self._last_error,
                "seconds_since_heartbeat": age,
            }


_registry_lock = threading.Lock()
_registry: Dict[str, JobHealth] = {}
_current = threading.local()
# Live track()/job_scope entries across every thread: telemetry.reset()
# refuses to run while a job is mid-flight.
_active_scopes = 0
_GUARDED_BY = guarded_by("_registry_lock", "_registry", "_active_scopes")


def for_job(job_id: str) -> JobHealth:
    """The process-wide JobHealth of a job, created on first use."""
    with _registry_lock:
        h = _registry.get(job_id)
        if h is None:
            h = _registry[job_id] = JobHealth(job_id)
        return h


def current() -> Optional[JobHealth]:
    stack = getattr(_current, "stack", None)
    return stack[-1] if stack else None


def active_job_scopes() -> int:
    with _registry_lock:
        return _active_scopes


@contextlib.contextmanager
def track(health: Optional[JobHealth]):
    """Makes `health` the thread's current job for telemetry forwarding."""
    global _active_scopes
    if health is None:
        yield None
        return
    stack = getattr(_current, "stack", None)
    if stack is None:
        stack = _current.stack = []
    stack.append(health)
    with _registry_lock:
        _active_scopes += 1
    try:
        yield health
    finally:
        stack.pop()
        with _registry_lock:
            _active_scopes -= 1


@contextlib.contextmanager
def job_scope(job_id: str):
    """Tracks the job and records its completion or failure."""
    h = for_job(job_id)
    h.beat()
    with track(h):
        try:
            yield h
        except BaseException as e:
            h.note_failed(e)
            raise
    h.note_complete()


def observe_counter(name: str, n: int) -> None:
    h = current()
    if h is not None:
        h.observe_counter(name, n)


def observe_duration(name: str, seconds: float) -> None:
    h = current()
    if h is not None:
        h.observe_duration(name, seconds)


def snapshot_all() -> Dict[str, dict]:
    with _registry_lock:
        jobs = list(_registry.values())
    return {h.job_id: h.snapshot() for h in jobs}


def reset() -> None:
    """Drops all job records."""
    with _registry_lock:
        _registry.clear()
