"""Span-based tracing: where a run's wall clock goes.

Port of pipelinedp_tpu/runtime/trace.py without its jit probe (torch has
no jit cache to probe: probe_jit and the compile counters wait, ROADMAP
item 13).

  * ``with trace.span("batch_dispatch", lanes=16):`` records one timed,
    nested, thread- and job-scoped interval with attributes; exclusive
    time (inclusive minus children) is accounted at close. Disabled, it
    returns a shared no-op token.
  * ``trace.instant(name, **attrs)`` marks a point event;
    telemetry.record() forwards every counter increment here.
  * ``dump(path)`` writes Chrome/Perfetto trace-event JSON;
    ``trace_summary()`` is the in-memory rollup (top spans by inclusive
    and exclusive time, instant counts, the sum of ``bytes=`` attributes).

Buffers are process-wide and bounded (``buffer_limit`` events; the excess
is counted in trace_dropped_events); telemetry.reset() clears them.
"""

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from pipelinedp_tpu_torch.runtime.concurrency import guarded_by

_enabled = False

_lock = threading.Lock()
_events: list = []
_buffer_limit = 1_000_000
_dropped = 0
_t0 = time.perf_counter()
_PID = os.getpid()

_local = threading.local()

_GUARDED_BY = guarded_by("_lock", "_events", "_dropped", "_buffer_limit")


def enabled() -> bool:
    return _enabled


def enable(buffer_limit: int = 1_000_000) -> None:
    """Turns span/instant recording on (process-wide)."""
    global _enabled, _buffer_limit, _t0
    with _lock:
        _buffer_limit = int(buffer_limit)
        if not _events:
            _t0 = time.perf_counter()
    _enabled = True


def disable() -> None:
    """Stops recording; buffered events stay exportable until reset()."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drops all buffered events (epoch boundary)."""
    global _dropped, _t0
    with _lock:
        _events.clear()
        _dropped = 0
        _t0 = time.perf_counter()


def _current_job() -> Optional[str]:
    from pipelinedp_tpu_torch.runtime import health
    h = health.current()
    return h.job_id if h is not None else None


def _append(event: tuple) -> None:
    global _dropped
    with _lock:
        if len(_events) >= _buffer_limit:
            _dropped += 1
            first_drop = _dropped == 1
            limit = _buffer_limit
        else:
            _events.append(event)
            return
    # The drop is counted; the flag keeps the counter's own instant event
    # from re-entering the full buffer.
    if getattr(_local, "noting_drop", False):
        return
    _local.noting_drop = True
    try:
        if first_drop:
            logging.warning(
                "trace: event buffer full (%d events) - further events "
                "are dropped and counted in trace_dropped_events.", limit)
        from pipelinedp_tpu_torch.runtime import telemetry
        telemetry.record("trace_dropped_events")
    finally:
        _local.noting_drop = False


class _NullSpan:
    """Shared no-op token returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One open span on the current thread (returned by span())."""

    __slots__ = ("name", "attrs", "_start", "_child_s", "_job", "_tid")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs or None

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._job = _current_job()
        self._tid = threading.get_ident()
        self._child_s = 0.0
        stack.append(self)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._start
        stack = getattr(_local, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1]._child_s += dur
        exclusive = max(dur - self._child_s, 0.0)
        _append(("X", self.name, self._tid, self._job, self._start, dur,
                 exclusive, self.attrs))
        return False


def span(name: str, **attrs):
    """Context manager timing one nested, attributed interval."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, attrs or None)


def instant(name: str, **attrs) -> None:
    """Records a point event on the timeline."""
    if not _enabled:
        return
    if getattr(_local, "noting_drop", False):
        return
    _append(("i", name, threading.get_ident(), _current_job(),
             time.perf_counter(), attrs or None))


def _snapshot_events(job_id: Optional[str] = None) -> list:
    with _lock:
        events = list(_events)
    if job_id is None:
        return events
    return [ev for ev in events if ev[3] == job_id]


def trace_summary(job_id: Optional[str] = None) -> Dict[str, Any]:
    """In-memory rollup: {"spans": {name: {count, inclusive_s,
    exclusive_s, max_s}} by inclusive time, "instants": {name: count},
    "transfer_bytes", "n_events", "dropped_events", "truncated"}; with a
    job_id, that job's events only."""
    spans: Dict[str, list] = {}
    instants: Dict[str, int] = {}
    transfer_bytes = 0
    events = _snapshot_events(job_id)
    for ev in events:
        if ev[0] == "X":
            _, name, _tid, _job, _start, dur, excl, attrs = ev
            entry = spans.setdefault(name, [0, 0.0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += dur
            entry[2] += excl
            entry[3] = max(entry[3], dur)
        else:
            _, name, _tid, _job, _ts, attrs = ev
            instants[name] = instants.get(name, 0) + 1
        if attrs and isinstance(attrs.get("bytes"), int):
            transfer_bytes += attrs["bytes"]
    ordered = dict(sorted(spans.items(), key=lambda kv: -kv[1][1]))
    with _lock:
        dropped = _dropped
    return {
        "spans": {
            name: {"count": e[0], "inclusive_s": round(e[1], 6),
                   "exclusive_s": round(e[2], 6), "max_s": round(e[3], 6)}
            for name, e in ordered.items()
        },
        "instants": dict(sorted(instants.items())),
        "transfer_bytes": transfer_bytes,
        "n_events": len(events),
        "dropped_events": dropped,
        "truncated": dropped > 0,
    }


def to_trace_events(job_id: Optional[str] = None) -> Dict[str, Any]:
    """The buffered events as Chrome/Perfetto trace-event JSON."""
    out = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "ts": 0, "args": {"name": "pipelinedp-tpu-torch"}}]
    for ev in _snapshot_events(job_id):
        if ev[0] == "X":
            _, name, tid, job, start, dur, excl, attrs = ev
            args = dict(attrs) if attrs else {}
            if job is not None:
                args["job"] = job
            args["exclusive_us"] = round(excl * 1e6, 3)
            out.append({"name": name, "cat": "span", "ph": "X", "pid": _PID,
                        "tid": tid, "ts": round((start - _t0) * 1e6, 3),
                        "dur": round(dur * 1e6, 3), "args": args})
        else:
            _, name, tid, job, ts, attrs = ev
            args = dict(attrs) if attrs else {}
            if job is not None:
                args["job"] = job
            out.append({"name": name, "cat": "instant", "ph": "i", "s": "t",
                        "pid": _PID, "tid": tid,
                        "ts": round((ts - _t0) * 1e6, 3), "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def dump(path: str, job_id: Optional[str] = None) -> str:
    """Writes the buffered trace as Chrome/Perfetto trace-event JSON
    (write, then rename). Returns the path."""
    payload = to_trace_events(job_id)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path

