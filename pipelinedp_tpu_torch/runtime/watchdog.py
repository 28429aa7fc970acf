"""Deadline watchdog (pipelinedp_tpu/runtime/watchdog.py).

A monitored operation runs inside ``Watchdog.guard(phase, block)`` with a
deadline (``timeout_s``, or a multiple of the longest observed operation).
A background monitor thread scans the guards in flight; on expiry it sets
the guard's cancel event (cooperative points raise BlockTimeoutError),
records ``watchdog_timeouts`` and posts a STALLED verdict on the job's
health record. ``cancel_all()`` cancels every guard in flight at once:
the service's JobHandle.cancel() and ``deadline_s`` ride it.

Python cannot preempt a running kernel or host call: a cancelled job
settles at the service's next cooperative checkpoint. An operation that
completes after its deadline is kept and counted as
``watchdog_late_completions``.
"""

import contextlib
import logging
import math
import threading
import time
from typing import Dict, Optional

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.runtime.concurrency import guarded_by


class BlockTimeoutError(RuntimeError):
    """An operation exceeded its watchdog deadline (or was cancelled)."""

    def __init__(self, phase: str, block: int, timeout_s: float,
                 detail: str = ""):
        super().__init__(
            f"{phase} for block {block} exceeded its "
            f"{timeout_s:.3f}s deadline"
            f"{(': ' + detail) if detail else ''}")
        self.phase = phase
        self.block = block
        self.timeout_s = timeout_s


class _Guard:
    """One monitored in-flight operation."""

    __slots__ = ("phase", "block", "started", "deadline", "timeout_s",
                 "cancel", "expired", "health")

    def __init__(self, phase: str, block: int, timeout_s: float, health):
        self.phase = phase
        self.block = block
        self.started = time.monotonic()
        self.timeout_s = timeout_s
        self.deadline = (self.started + timeout_s
                         if math.isfinite(timeout_s) else math.inf)
        self.cancel = threading.Event()
        self.expired = False
        self.health = health

    @property
    def cancelled(self) -> bool:
        return self.cancel.is_set()

    def raise_if_expired(self) -> None:
        if self.expired:
            raise BlockTimeoutError(self.phase, self.block, self.timeout_s)


class Watchdog:
    """Deadline monitor shared by one job's guarded steps.

    timeout_s: one deadline for every guarded operation. None derives
        deadlines from the profile (multiplier x the longest observed
        operation, at least min_timeout_s); with neither, no deadline.
    poll_interval_s: the monitor thread's scan period.
    """

    _GUARDED_BY = guarded_by("_lock", "_guards", "_profile", "_next_id",
                             "_monitor")

    def __init__(self,
                 timeout_s: Optional[float] = None,
                 multiplier: float = 8.0,
                 min_timeout_s: float = 0.25,
                 poll_interval_s: float = 0.02):
        if timeout_s is not None:
            input_validators.validate_timeout_s(timeout_s, "Watchdog")
        if multiplier <= 0:
            raise ValueError(f"Watchdog: multiplier must be positive, "
                             f"got {multiplier}")
        self.timeout_s = timeout_s
        self.multiplier = multiplier
        self.min_timeout_s = min_timeout_s
        self.poll_interval_s = poll_interval_s
        self._lock = threading.Lock()
        self._guards: Dict[int, _Guard] = {}
        self._profile: Dict[str, float] = {}
        self._next_id = 0
        self._monitor: Optional[threading.Thread] = None
        self._closed = False

    def observe(self, phase: str, seconds: float) -> None:
        """Feeds one completed-operation time into the auto profile."""
        with self._lock:
            self._profile[phase] = max(self._profile.get(phase, 0.0),
                                       float(seconds))

    def resolved_timeout(self, phase: str,
                         timeout_s: Optional[float] = None) -> float:
        if timeout_s is not None:
            return float(timeout_s)
        if self.timeout_s is not None:
            return float(self.timeout_s)
        with self._lock:
            profiled = self._profile.get(phase, self._profile.get("*"))
        if profiled is None:
            return math.inf
        return max(self.multiplier * profiled, self.min_timeout_s)

    @contextlib.contextmanager
    def guard(self, phase: str, block: int = 0,
              timeout_s: Optional[float] = None):
        """Monitors one operation; yields the guard token."""
        from pipelinedp_tpu_torch.runtime import health as rt_health
        g = _Guard(phase, block, self.resolved_timeout(phase, timeout_s),
                   rt_health.current())
        with self._lock:
            gid = self._next_id
            self._next_id += 1
            self._guards[gid] = g
            start_monitor = self._ensure_monitor()
        if start_monitor is not None:
            # Started outside the lock: the monitor's first act takes it.
            start_monitor.start()
        failed = False
        try:
            yield g
        except BaseException:
            failed = True
            raise
        finally:
            with self._lock:
                self._guards.pop(gid, None)
            dt = time.monotonic() - g.started
            telemetry.record_duration(f"watchdog_{phase}", dt)
            self.observe(phase, dt)
            if g.expired and not failed:
                telemetry.record("watchdog_late_completions")
                if g.health is not None:
                    g.health.note_recovered()
                logging.warning(
                    "%s for block %d completed %.3fs after its %.3fs "
                    "deadline; the result is kept.", phase, block,
                    dt - g.timeout_s, g.timeout_s)

    def check(self, g: Optional[_Guard]) -> None:
        """Cooperative cancellation point: raises if the guard expired."""
        if g is not None:
            g.raise_if_expired()

    def _ensure_monitor(self) -> "Optional[threading.Thread]":
        # The caller holds self._lock.
        m = self._monitor
        if m is None or (m.ident is not None and not m.is_alive()):
            m = threading.Thread(target=self._run_monitor,
                                 name="pdp-watchdog", daemon=True)
            self._monitor = m
            return m
        return None

    def _run_monitor(self) -> None:
        while not self._closed:
            now = time.monotonic()
            with self._lock:
                expiring = [g for g in self._guards.values()
                            if not g.expired and now >= g.deadline]
            for g in expiring:
                g.expired = True
                g.cancel.set()
                telemetry.record("watchdog_timeouts")
                if g.health is not None:
                    g.health.note_timeout(g.phase, g.block)
                logging.warning(
                    "watchdog: %s for block %d has been in flight %.3fs "
                    "(> %.3fs deadline); cancelling at the next "
                    "cooperative point.", g.phase, g.block, now - g.started,
                    g.timeout_s)
            time.sleep(self.poll_interval_s)

    def cancel_all(self, detail: str = "cancelled") -> int:
        """Cancels every guard in flight now (each raises at its next
        cooperative point). Returns how many."""
        with self._lock:
            guards = list(self._guards.values())
        for g in guards:
            g.expired = True
            g.cancel.set()
        if guards:
            logging.info("watchdog: cancel_all (%s) cancelled %d in-flight "
                         "guard(s).", detail, len(guards))
        return len(guards)

    def close(self) -> None:
        self._closed = True


_tls = threading.local()


def active() -> Optional[Watchdog]:
    """The watchdog activated for the current thread, if any."""
    stack = getattr(_tls, "watchdogs", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def activate(wd: Optional[Watchdog]):
    """Scopes `wd` as the thread's active watchdog (None: no-op)."""
    if wd is None:
        yield None
        return
    stack = getattr(_tls, "watchdogs", None)
    if stack is None:
        stack = _tls.watchdogs = []
    stack.append(wd)
    try:
        yield wd
    finally:
        stack.pop()


def guard(phase: str, block: int = 0):
    """Guard under the thread's active watchdog; a no-op without one."""
    wd = active()
    if wd is None:
        return contextlib.nullcontext()
    return wd.guard(phase, block)
