"""Deterministic fault injection for the meshed and blocked drivers.

Port of pipelinedp_tpu/runtime/faults.py. Real failures (a preempted
dispatch, an allocation that does not fit the card, a device that drops
out of the mesh) cannot be provoked on demand, so the retry, OOM re-plan
and elastic-mesh machinery (runtime/retry.py) is tested against the same
failure classes injected by SCHEDULE: a FaultSchedule lists (kind, block,
times) entries, and the runtime's hook points consult the active schedule
and raise the matching typed exception. Each fault fires `times` attempts
and is then spent, so a retried block succeeds: the schedule scripts the
adversity, the assertions are on the recovery.

    with faults.inject(faults.FaultSchedule([
            faults.Fault("dispatch", block=2, times=2),
            faults.Fault("oom", block=5),
            faults.Fault("device_loss", point="dispatch"),
    ])):
        ... run a meshed or blocked release ...

The hook sites of the port and what each kind raises there:
  dispatch    InjectedDispatchError   retry.retry_call, before every block
                                      dispatch and every dense meshed
                                      launch; transient, retried
  consume     InjectedConsumeError    the blocked drivers' consume side
                                      (large_p._dispatch_blocks), at the
                                      block's host sync; re-dispatched
                                      under the same block key
  oom         InjectedOOMError        retry.retry_call; never retried at
                                      the same shape: the blocked drivers
                                      halve the block capacity
  fatal       InjectedFatalError      retry.retry_call; never retried
  device_loss InjectedDeviceLossError device-fatal, `point` dispatch
                                      (retry.retry_call) or collective
                                      (reshard.stage_rows_to_mesh, before
                                      the device exchange). The elastic
                                      loop rebuilds a smaller mesh;
                                      `device` names the lost slot's id,
                                      `process` a whole process's slots,
                                      and without either the liveness
                                      probe marks the highest-id live
                                      slot lost. The schedule remembers
                                      every loss, so every probe of the
                                      run sees one dead set.
  host_join_failure
              InjectedHostJoinError   retry._admit_joiners: a joining slot
                                      dies mid-admit; the grow aborts
                                      back to the old mesh.

The kinds collective, slow, hang, corrupt, restart_during_persist,
disk_full, fsync_failure, io_error and extreme_values are validated as
the JAX package validates them, but no hook of the port fires them yet:
their seams (the reshard's host fallback, the watchdog, the block
journal, the ingest's poison seam) are ROADMAP.md Queue 1 step 4.

Schedules are thread-local (inject()), or process-wide with
scope="process" for hooks that run on other threads.
"""

import contextlib
import dataclasses
import errno as errno_lib
import threading
from typing import List, Optional

from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.runtime.concurrency import guarded_by


class InjectedFault(RuntimeError):
    """Base of all injected failures (never raised itself)."""


class InjectedDispatchError(InjectedFault):
    """Transient dispatch failure (preemption / runtime hiccup)."""


class InjectedConsumeError(InjectedFault):
    """Transient failure surfacing at the block's host sync point."""


class InjectedOOMError(InjectedFault):
    """The block's launches did not fit device memory."""


class InjectedCollectiveError(InjectedFault):
    """A mesh collective (the exchange, a combine) failed."""


class InjectedFatalError(InjectedFault):
    """Unrecoverable failure: the run must abort."""


class InjectedDeviceLossError(InjectedFault):
    """Device-fatal: a slot dropped out of the mesh mid-run. The mesh
    must shrink (retry.is_device_fatal classifies this, never transient:
    re-launching onto a dead device cannot succeed)."""


class InjectedHostJoinError(InjectedFault):
    """A joining slot died mid-admit during an elastic scale-up. The grow
    aborts back to the old, still fully live, mesh: nothing was launched
    on the joiners, so nothing needs recovery beyond dropping the
    ticket."""


class InjectedRestartError(InjectedFault):
    """A process restart between a journal record's fsync and its
    rename."""


# The storage faults subclass OSError too, with their errno pinned, as
# the JAX package's do.


class InjectedDiskFullError(InjectedFault, OSError):
    """ENOSPC from the journal's tmp-file write."""

    def __init__(self, *args):
        super().__init__(*args)
        self.errno = errno_lib.ENOSPC


class InjectedFsyncError(InjectedFault, OSError):
    """os.fsync failed on the journal's tmp fd."""

    def __init__(self, *args):
        super().__init__(*args)
        self.errno = errno_lib.EIO


class InjectedIOError(InjectedFault, OSError):
    """EIO on a journal record read."""

    def __init__(self, *args):
        super().__init__(*args)
        self.errno = errno_lib.EIO


_RAISES = {
    "dispatch": InjectedDispatchError,
    "consume": InjectedConsumeError,
    "oom": InjectedOOMError,
    "collective": InjectedCollectiveError,
    "fatal": InjectedFatalError,
    "device_loss": InjectedDeviceLossError,
    "host_join_failure": InjectedHostJoinError,
    "restart_during_persist": InjectedRestartError,
    "disk_full": InjectedDiskFullError,
    "fsync_failure": InjectedFsyncError,
    "io_error": InjectedIOError,
}


@dataclasses.dataclass
class Fault:
    """One scheduled fault: fires on `kind` hooks for block `block` (None:
    the first block that reaches the hook), `times` attempts in a row.

    delay: seconds, for "slow" and "hang" (validated only).
    point: restricts "hang" (dispatch | drain | collective),
        "device_loss" (dispatch | collective), "restart_during_persist"
        and the storage kinds (odometer | block) to one hook site; None
        fires at whichever site reaches it first.
    mode: "corrupt": "flip" (default) or "truncate"; "extreme_values":
        "nan" (default) or "magnitude" (validated only).
    device: "device_loss" only: the id of the lost mesh slot
        (parallel/mesh.Slot.id). None: the liveness probe marks the
        highest-id live slot of the probed mesh lost.
    process: "device_loss" only: the process index whose every slot drops
        together (a whole-host loss). Exclusive with `device`.
    """
    kind: str
    block: Optional[int] = None
    times: int = 1
    delay: float = 0.0
    point: Optional[str] = None
    mode: str = "flip"
    device: Optional[int] = None
    process: Optional[int] = None

    def __post_init__(self):
        if self.kind not in set(_RAISES) | {"slow", "hang", "corrupt",
                                            "extreme_values"}:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.times <= 0:
            raise ValueError("times must be positive")
        if self.kind == "extreme_values" and self.mode == "flip":
            # The shared default belongs to corrupt; this kind's own
            # default poison is NaN.
            self.mode = "nan"
        allowed_points = {
            "device_loss": ("dispatch", "collective"),
            "restart_during_persist": ("odometer", "block"),
            "disk_full": ("odometer", "block"),
            "fsync_failure": ("odometer", "block"),
            "io_error": ("odometer", "block"),
        }.get(self.kind, ("dispatch", "drain", "collective"))
        if self.point is not None and self.point not in allowed_points:
            raise ValueError(f"unknown {self.kind} point {self.point!r}")
        allowed_modes = (("nan", "magnitude")
                         if self.kind == "extreme_values" else
                         ("flip", "truncate"))
        if self.mode not in allowed_modes:
            raise ValueError(f"unknown {self.kind} mode {self.mode!r}")
        if self.process is not None:
            if self.kind != "device_loss":
                raise ValueError("process= is a device_loss field")
            if self.device is not None:
                raise ValueError(
                    "device= and process= are mutually exclusive: a "
                    "whole-host loss already names every device of the "
                    "process")


class FaultSchedule:
    """An ordered, consumable list of Faults.

    Fired device_loss faults also accumulate a dead set (named slot ids,
    whole processes, and a count of unassigned losses the liveness probe
    resolves against the slots it probes), so a lost slot stays lost
    across every probe and mesh re-entry of the faulted run.
    """

    def __init__(self, faults: List[Fault]):
        self._remaining = [[f, f.times] for f in faults]
        self._lost_ids = set()
        self._lost_processes = set()
        self._unassigned_losses = 0

    def note_device_loss(self, fault: Fault) -> None:
        """Records one fired device_loss fault's victim (a named slot, a
        whole process's slots, or one to be assigned at the probe)."""
        if fault.process is not None:
            self._lost_processes.add(int(fault.process))
        elif fault.device is not None:
            self._lost_ids.add(fault.device)
        else:
            self._unassigned_losses += 1

    def assign_lost(self, devices) -> set:
        """The ids of `devices` (mesh slots, objects with an `id`, or ids)
        the schedule considers dead: named ids, every slot of a lost
        process (by its process_index), and one highest-id live slot per
        unassigned loss (assigned for good, so later probes agree)."""
        if self._lost_processes:
            for d in devices:
                if int(getattr(d, "process_index", 0)) in \
                        self._lost_processes:
                    self._lost_ids.add(getattr(d, "id", d))
        ids = [getattr(d, "id", d) for d in devices]
        for id_ in sorted(set(ids) - self._lost_ids, reverse=True):
            if self._unassigned_losses <= 0:
                break
            self._lost_ids.add(id_)
            self._unassigned_losses -= 1
        return {i for i in ids if i in self._lost_ids}

    def take(self, kind: str, block: int,
             point: Optional[str] = None) -> Optional[Fault]:
        """Consumes and returns the first pending fault matching (kind,
        block[, point]); None if nothing is scheduled for this hook."""
        for entry in self._remaining:
            fault, left = entry
            if left <= 0 or fault.kind != kind:
                continue
            if fault.block is not None and fault.block != block:
                continue
            if fault.point is not None and fault.point != point:
                continue
            entry[1] -= 1
            return fault
        return None

    def pending(self, kind: Optional[str] = None) -> int:
        """Fault firings not yet consumed (optionally of one kind)."""
        return sum(left for fault, left in self._remaining
                   if kind is None or fault.kind == kind)


_active = threading.local()


class _ProcessSchedule:
    """Process-wide schedule slot (inject(scope="process")); the
    thread-local slot wins when set. FaultSchedule itself is not
    thread-safe: one consumer at a time."""

    _GUARDED_BY = guarded_by("_lock", "_schedule")

    def __init__(self):
        self._lock = threading.Lock()
        self._schedule: Optional[FaultSchedule] = None

    def get(self) -> Optional[FaultSchedule]:
        with self._lock:
            return self._schedule

    def swap(self,
             schedule: Optional[FaultSchedule]) -> Optional[FaultSchedule]:
        with self._lock:
            prev = self._schedule
            self._schedule = schedule
            return prev


_process = _ProcessSchedule()


def active() -> Optional[FaultSchedule]:
    local = getattr(_active, "schedule", None)
    if local is not None:
        return local
    return _process.get()


@contextlib.contextmanager
def inject(schedule: FaultSchedule, scope: str = "thread"):
    """Activates `schedule` within the context: for the current thread
    (scope="thread", the default) or as the process-wide fallback every
    thread without its own schedule consults (scope="process")."""
    if scope not in ("thread", "process"):
        raise ValueError(f"unknown inject scope {scope!r}")
    if scope == "process":
        prev = _process.swap(schedule)
        try:
            yield schedule
        finally:
            _process.swap(prev)
        return
    prev = getattr(_active, "schedule", None)
    _active.schedule = schedule
    try:
        yield schedule
    finally:
        _active.schedule = prev


def maybe_fail(kind: str, block: int = 0,
               point: Optional[str] = None) -> None:
    """Hook point: raises the scheduled exception if a fault is pending."""
    schedule = active()
    if schedule is None:
        return
    fault = schedule.take(kind, block, point)
    if fault is not None:
        telemetry.record("injected_faults")
        if kind == "device_loss":
            schedule.note_device_loss(fault)
        raise _RAISES[kind](
            f"injected {kind} fault at block {block} "
            f"(attempt schedule: {fault.times} firing(s))")


def injected_lost_device_ids(devices) -> set:
    """Ids of `devices` the active schedule considers lost (empty without
    a schedule). The liveness probe (mesh.probe_live_devices) consults
    it: injected losses are how the elastic loop is tested, on the CPU
    and on the card alike."""
    schedule = active()
    if schedule is None:
        return set()
    return schedule.assign_lost(devices)
