"""Bounded-backoff retry, the OOM re-plan and elastic meshes.

Port of pipelinedp_tpu/runtime/retry.py. Re-running a failed release
naively would draw fresh noise for partitions whose noisy values were
already computed: a second DP release of the same statistics. So:

  * retry_call re-invokes the same launch closure. Every blocked driver
    derives its block key as a pure function of the run key, the plan
    generation and the block index (large_p._block_noise_key), and the
    dense meshed drivers reuse the run key, so a retried launch redraws
    bit-identical noise: the retry replays the same release.
  * OOM-classified failures are never retried at the same shape; they
    surface as BlockOOMError, and run_with_degradation halves the block
    capacity and re-plans the remaining partition range under the next
    generation. Re-planned blocks draw fresh keys, which is sound because
    the failed block released nothing.
  * A device-fatal failure (a slot dropped out of the mesh) goes to the
    elastic loop (run_with_mesh_degradation / run_with_mesh_elasticity):
    it probes the mesh's slots (parallel/mesh.probe_live_devices),
    rebuilds a smaller mesh over the survivors and re-enters the driver.
    Block keys do not depend on the mesh, so the degraded run releases
    what the fixed-geometry run releases; at one slot the unsharded driver
    runs on that slot's device. Scale-up works the same way in reverse:
    join tickets (announce_join) are admitted at block boundaries.

What counts as device-fatal on CUDA. A sticky CUDA error (an illegal
address, an unspecified launch failure, a misaligned address, an
uncorrectable ECC error, a device-side assert) poisons the process's CUDA
context: every later launch in the process fails, on every slot of the
card. Rebuilding the mesh over the "survivors" cannot help, so these are
neither device-fatal nor transient nor OOM here: they raise to the caller.
Only the runtime's own loss reports count as losses (the injected
device_loss fault, or a status text naming DEVICE_LOST). So on the card
only injected losses are survivable; a real loss of a card is survived
only once a process per card carries the mesh (ROADMAP.md Queue 1 step
9), where the other processes' contexts are untouched.

Classification otherwise follows the JAX package: marker substrings over
the exception text plus the injection harness's typed exceptions; CUDA's
allocator failure ("CUDA out of memory", torch.cuda.OutOfMemoryError) is
an OOM. Journaled plans (journal=) are not ported (ROADMAP.md Queue 1
step 4): run_with_degradation takes journal=None only.
"""

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Callable, List, Optional

import torch

from pipelinedp_tpu_torch.runtime import faults
from pipelinedp_tpu_torch.runtime import health as health_lib
from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.runtime import watchdog as watchdog_lib
from pipelinedp_tpu_torch.runtime.concurrency import guarded_by

# Status markers of failures worth re-dispatching: the runtime came back
# (or will), the program itself is fine.
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "connection reset",
    "socket closed",
    "Broken pipe",
    "preempted",
)

# Markers of allocation failure: retrying the identical shape re-fails.
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Resource exhausted",
    "out of memory",
    "OOM",
    "Out of memory",
)

# Markers of a lost device the mesh can be rebuilt without: the runtime's
# own loss reports.
_DEVICE_FATAL_MARKERS = (
    "DEVICE_LOST",
    "device is lost",
    "Device lost",
)

# Sticky CUDA errors: the process's context is poisoned, so no retry, no
# re-plan and no smaller mesh in this process can succeed. They raise.
_CONTEXT_POISON_MARKERS = (
    "illegal memory access",
    "illegal address",
    "illegal instruction",
    "unspecified launch failure",
    "misaligned address",
    "uncorrectable ECC",
    "hardware stack error",
    "device-side assert",
    "cudaErrorIllegalAddress",
    "cudaErrorLaunchFailure",
)


def poisons_context(exc: BaseException) -> bool:
    """Whether the failure is a sticky CUDA error that poisons the
    process's CUDA context (see the module docstring)."""
    if isinstance(exc, faults.InjectedFault):
        return False
    msg = str(exc)
    return any(marker in msg for marker in _CONTEXT_POISON_MARKERS)


class BlockOOMError(RuntimeError):
    """A block needs re-planning at a smaller capacity: it exceeded device
    memory, or its deadline through the whole retry budget.

    `block` is the index of the failed block within the current plan; all
    earlier blocks of the plan were consumed before this was raised, so
    the driver re-plans from exactly this block's base partition.
    """

    def __init__(self, block: int, cause: BaseException):
        super().__init__(f"block {block} kernel needs re-planning at a "
                         f"smaller capacity: "
                         f"{type(cause).__name__}: {cause}")
        self.block = block
        self.cause = cause


class MeshDegradationError(RuntimeError):
    """Device losses exhausted the elastic floor: fewer live slots remain
    than `min_devices` allows. The message names the job_id a resume
    needs."""


class HostEvacuatedError(MeshDegradationError):
    """A whole-host loss left this process with no slot of the rebuilt
    mesh: the surviving processes carry the run."""


class MeshGrowthSignal(RuntimeError):
    """Control flow of an elastic scale-up: a join announcement matched
    the current block boundary, so the running driver unwinds and
    run_with_mesh_elasticity rebuilds the mesh over the larger slot set.
    Never an error: is_transient, is_oom and is_device_fatal all say no.
    The grown run re-derives the same block keys, so it releases what the
    fixed-geometry run releases."""

    def __init__(self, devices=None, n_devices: Optional[int] = None,
                 block: int = 0):
        super().__init__(
            f"mesh growth admitted at block boundary {block} "
            f"(join announcement matched)")
        self.devices = devices
        self.n_devices = n_devices
        self.block = block


class _JoinRegistry:
    """Process-wide registry of announced join candidates, polled by the
    driver at block boundaries (maybe_grow, in retry_call). A ticket is
    consumed once, at the first dispatched block >= its block (None: the
    next boundary)."""

    _GUARDED_BY = guarded_by("_lock", "_tickets")

    def __init__(self):
        self._lock = threading.Lock()
        self._tickets: List[dict] = []

    def announce(self, devices=None, n_devices: Optional[int] = None,
                 block: Optional[int] = None) -> None:
        if devices is None and n_devices is None:
            raise ValueError(
                "announce_join needs devices= (explicit joining slots) or "
                "n_devices= (a target total, resolved against the port's "
                "slot enumeration at admit time)")
        with self._lock:
            self._tickets.append({
                "devices": None if devices is None else list(devices),
                "n_devices": None if n_devices is None else int(n_devices),
                "block": None if block is None else int(block),
            })

    def take(self, block: int) -> Optional[dict]:
        with self._lock:
            for i, t in enumerate(self._tickets):
                if t["block"] is None or block >= t["block"]:
                    return self._tickets.pop(i)
        return None

    def pending(self) -> int:
        with self._lock:
            return len(self._tickets)

    def clear(self) -> None:
        with self._lock:
            self._tickets.clear()


_joins = _JoinRegistry()


def announce_join(devices=None, n_devices: Optional[int] = None,
                  block: Optional[int] = None) -> None:
    """Announces slots wanting to JOIN the next elastic run's mesh at a
    block boundary: explicit slots (parallel/mesh.Slot, or devices), or a
    target total `n_devices` resolved by mesh.join_candidates at admit
    time. `block` defers the admit to the first dispatched block >= block
    (None: the next boundary). Only runs under run_with_mesh_elasticity
    consume announcements."""
    _joins.announce(devices=devices, n_devices=n_devices, block=block)


def pending_joins() -> int:
    """Announced join tickets not yet consumed by an elastic run."""
    return _joins.pending()


def clear_joins() -> None:
    """Drops every pending join announcement (test isolation)."""
    _joins.clear()


# Growth is opt-in per driver invocation: only the thread inside
# run_with_mesh_elasticity's run() treats a pending ticket as a signal.
_growth = threading.local()


@contextlib.contextmanager
def _growth_scope():
    _growth.depth = getattr(_growth, "depth", 0) + 1
    try:
        yield
    finally:
        _growth.depth -= 1


def maybe_grow(block: int = 0) -> None:
    """Block-boundary hook (retry_call): raises MeshGrowthSignal when a
    join announcement matches and the thread is inside an elasticity
    scope; a no-op everywhere else."""
    if getattr(_growth, "depth", 0) <= 0:
        return
    ticket = _joins.take(block)
    if ticket is None:
        return
    raise MeshGrowthSignal(devices=ticket["devices"],
                           n_devices=ticket["n_devices"], block=block)


def is_device_fatal(exc: BaseException) -> bool:
    """Whether the failure means a slot dropped out of the mesh and the
    mesh can be rebuilt without it (never for a sticky CUDA error)."""
    if isinstance(exc, MeshGrowthSignal):
        return False
    if isinstance(exc, faults.InjectedDeviceLossError):
        return True
    if isinstance(exc, faults.InjectedFault):
        return False
    if poisons_context(exc):
        return False
    msg = str(exc)
    return any(marker in msg for marker in _DEVICE_FATAL_MARKERS)


def is_oom(exc: BaseException) -> bool:
    if isinstance(exc, (faults.InjectedOOMError, MemoryError)):
        return True
    if isinstance(exc, faults.InjectedFault):
        return False
    if poisons_context(exc) or is_device_fatal(exc):
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return any(marker in msg for marker in _OOM_MARKERS)


def is_transient(exc: BaseException) -> bool:
    """Whether re-dispatching the same launches can plausibly succeed."""
    if isinstance(exc, MeshGrowthSignal):
        return False
    if isinstance(exc,
                  (faults.InjectedDispatchError, faults.InjectedConsumeError,
                   faults.InjectedCollectiveError)):
        return True
    # A deadline expiry is transient by design: the retried block
    # re-derives the same key.
    if isinstance(exc, watchdog_lib.BlockTimeoutError):
        return True
    if isinstance(exc, faults.InjectedFault):  # oom / fatal / device loss
        return False
    if poisons_context(exc) or is_device_fatal(exc) or is_oom(exc):
        return False
    msg = str(exc)
    return any(marker in msg for marker in _TRANSIENT_MARKERS)


def is_timeout(exc: BaseException) -> bool:
    """Whether the failure is a deadline expiry. Timeouts are transient,
    but one that survives the whole retry budget degrades the block
    capacity as an OOM does."""
    if isinstance(exc, watchdog_lib.BlockTimeoutError):
        return True
    if isinstance(exc, faults.InjectedFault):
        return False
    return "DEADLINE_EXCEEDED" in str(exc)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: base * multiplier^attempt, capped.

    max_retries bounds retries per operation (one block dispatch, one
    host fetch); max_total_retries caps the job's total transient retries
    across every seam (None: no cap), threaded by the runtime entry
    (retry_budget_scope).
    """
    max_retries: int = 3
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    max_total_retries: Optional[int] = None

    def delay(self, attempt: int) -> float:
        return min(self.base_delay * self.multiplier**attempt,
                   self.max_delay)


DEFAULT_POLICY = RetryPolicy()


class RetryBudgetExhaustedError(RuntimeError):
    """The job's total transient-retry budget (RetryPolicy.
    max_total_retries) is spent. Not transient: it fails the job."""


# Per-job retry budget, scoped by runtime/entry.py on the driver thread.
_budget = threading.local()


@contextlib.contextmanager
def retry_budget_scope(max_total_retries: Optional[int]):
    """Scopes the job's total transient-retry budget onto this thread
    (None: unlimited). Nesting restores the outer budget on exit."""
    if max_total_retries is not None:
        max_total_retries = int(max_total_retries)
        if max_total_retries < 0:
            raise ValueError(
                f"retry_budget_scope: max_total_retries must be "
                f"non-negative or None, got {max_total_retries}")
    prev = getattr(_budget, "left", None)
    _budget.left = max_total_retries
    try:
        yield
    finally:
        _budget.left = prev


def consume_retry_budget(what: str = "operation") -> None:
    """Decrements the job's total retry budget before a transient retry;
    raises RetryBudgetExhaustedError at zero. A no-op without a scope."""
    left = getattr(_budget, "left", None)
    if left is None:
        return
    if left <= 0:
        telemetry.record("retry_budget_exhausted", what=what)
        raise RetryBudgetExhaustedError(
            f"retry budget exhausted: the job's max_total_retries cap "
            f"is spent and {what} wants another transient retry. The "
            f"job fails typed instead of retry-storming.")
    _budget.left = left - 1


def retry_call(fn: Callable,
               policy: Optional[RetryPolicy] = None,
               *,
               block: int = 0,
               what: str = "block dispatch",
               counter: str = "block_retries",
               sleep: Callable[[float], None] = time.sleep):
    """Calls fn(), retrying transient failures with bounded backoff.

    Consults the join registry and the fault hooks before each attempt
    (fatal, device_loss at dispatch, oom, dispatch). Non-transient errors,
    OOMs included, propagate at once.
    """
    policy = policy or DEFAULT_POLICY
    attempt = 0
    while True:
        try:
            # Scale-up poll first: a block boundary is the one safe point
            # to grow (nothing of this block has launched yet).
            maybe_grow(block)
            faults.maybe_fail("fatal", block)
            faults.maybe_fail("device_loss", block, point="dispatch")
            faults.maybe_fail("oom", block)
            faults.maybe_fail("dispatch", block)
            return fn()
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_transient(e) or attempt >= policy.max_retries:
                raise
            consume_retry_budget(what)
            delay = policy.delay(attempt)
            attempt += 1
            if is_timeout(e):
                telemetry.record("block_timeouts", block=block)
            telemetry.record(counter, block=block, what=what)
            logging.warning(
                "%s failed transiently at block %d (%s: %s); retry %d/%d "
                "in %.2fs — the retried launch re-derives the same block "
                "key, so noise is bit-identical (no second release)", what,
                block, type(e).__name__,
                str(e).splitlines()[0][:160], attempt, policy.max_retries,
                delay)
            sleep(delay)


def run_with_degradation(run_range: Callable[[int, int, int, int], None],
                         n_partitions: int,
                         block_partitions: int,
                         min_block_partitions: int = 8,
                         journal=None,
                         job_id: Optional[str] = None) -> int:
    """Drives a blocked pass with OOM-halving re-planning.

    run_range(base, capacity, generation, end) processes partitions
    [base, end) in blocks of `capacity`, raising BlockOOMError (with the
    failed in-plan block index) after consuming every block that completed
    before the failure. On OOM the capacity halves and the remaining range
    re-plans under the next generation, which feeds the block key, so a
    re-planned block never reuses a key another geometry consumed. Below
    min_block_partitions the BlockOOMError propagates.

    journal: None only (the journaled plan history is ROADMAP.md Queue 1
    step 4). Returns the final block capacity.
    """
    if journal is not None:
        raise NotImplementedError(
            "run_with_degradation(journal=): the journaled plan history "
            "is not ported yet (ROADMAP.md Queue 1 step 4)")
    del job_id
    ranges = [[0, block_partitions, 0]]
    idx = 0
    while idx < len(ranges):
        base, capacity, generation = ranges[idx]
        last = idx + 1 >= len(ranges)
        end = n_partitions if last else ranges[idx + 1][0]
        try:
            run_range(base, capacity, generation, end)
        except BlockOOMError as e:
            if not last:
                raise
            new_base = base + e.block * capacity
            if capacity // 2 < min_block_partitions:
                raise
            capacity //= 2
            # The event carries the device-memory watermark that
            # triggered it. Lazy import: observability sits above retry.
            from pipelinedp_tpu_torch.runtime import observability
            wm = observability.memory_watermark()
            telemetry.record("block_oom_degradations", block=e.block,
                             capacity=capacity,
                             mem_live_bytes=wm["live_bytes"],
                             mem_peak_bytes=wm["peak_bytes"],
                             mem_source=wm["source"])
            logging.warning(
                "block kernel OOM (or exhausted deadline) at partition "
                "base %d; halving partition block capacity to %d and "
                "re-planning the remaining %d partitions (generation %d). "
                "Already-consumed blocks keep their drained results; "
                "re-planned partitions draw fresh noise keys (nothing was "
                "released for them).", new_base, capacity,
                n_partitions - new_base, generation + 1)
            ranges.append([new_base, capacity, generation + 1])
        idx += 1
    return ranges[-1][1]


def run_with_mesh_degradation(run: Callable,
                              mesh,
                              *,
                              fallback: Optional[Callable] = None,
                              min_devices: int = 1,
                              job_id: str = "",
                              journal=None):
    """Drives a meshed driver with elastic device-loss degradation.

    run(mesh) executes the full driver on the given mesh; fallback(mesh)
    (when given) executes the unsharded driver on the one-slot mesh's
    device, the floor the mesh degrades onto (or the caller's own one-slot
    mesh). The JAX package's fallback takes no argument: the port's takes
    the surviving one-slot mesh, so the unsharded driver runs on that
    slot's device.

    On a device-fatal failure the loop probes the mesh's slots
    (parallel/mesh.probe_live_devices), rebuilds a mesh over at most D-1
    survivors and re-enters the driver; block keys do not depend on the
    mesh, so the degraded run is a replay of the same release. Fewer
    survivors than max(min_devices, 1) raise MeshDegradationError naming
    the job_id; the job's health is FAILED. A process whose every slot
    dropped is a host loss; this process left with no slot raises
    HostEvacuatedError.

    journal: None only (ROADMAP.md Queue 1 step 4). Returns whatever
    run() / fallback() returns.
    """
    return _elastic_loop(run, mesh, grow=False, fallback=fallback,
                         min_devices=min_devices, job_id=job_id,
                         journal=journal)


def run_with_mesh_elasticity(run: Callable,
                             mesh,
                             *,
                             fallback: Optional[Callable] = None,
                             min_devices: int = 1,
                             job_id: str = "",
                             journal=None):
    """run_with_mesh_degradation plus elastic scale-up.

    announce_join tickets are polled at every block boundary (retry_call's
    maybe_grow). When one matches, the driver unwinds (MeshGrowthSignal),
    the candidates are resolved (mesh.join_candidates) and probed
    (mesh.probe_live_devices), and the mesh rebuilds over the larger slot
    set: the current slots first, in their order, the admitted joiners
    after. A failed admit (an injected host_join_failure, a joiner failing
    its probe, a current slot dying mid-admit) aborts the grow: the ticket
    is spent, the old mesh carries on, and the job notes the aborted
    REJOINING event.
    """
    return _elastic_loop(run, mesh, grow=True, fallback=fallback,
                         min_devices=min_devices, job_id=job_id,
                         journal=journal)


def _admit_joiners(current, signal: MeshGrowthSignal, job_id: str):
    """Resolves and probes a grow ticket's candidates against the current
    mesh. Returns the admitted slots (empty: abort the grow). Any admit
    failure aborts rather than propagates."""
    from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
    joining = mesh_lib.join_candidates(current, devices=signal.devices,
                                       n_devices=signal.n_devices)
    if not joining:
        return []
    try:
        # Fault-injection hook: a joining slot dying mid-admit.
        faults.maybe_fail("host_join_failure", signal.block)
        live = mesh_lib.probe_live_devices(
            list(current.slots) + list(joining))
        live_ids = {getattr(d, "id", d) for d in live}
        if any(getattr(d, "id", d) not in live_ids for d in current.slots):
            raise RuntimeError(
                "a slot of the CURRENT mesh failed its liveness probe "
                "mid-admit; growing onto a set containing it would wedge "
                "the run")
        return [d for d in joining if getattr(d, "id", d) in live_ids]
    except Exception as e:  # noqa: BLE001 - any admit failure aborts the grow
        logging.warning(
            "elastic scale-UP for job %r aborted at block %d: %s: %s — "
            "the join ticket is dropped and the run continues on the "
            "old %d-slot mesh (still fully live; the joiners never "
            "carried any launched work).", job_id, signal.block,
            type(e).__name__, str(e).splitlines()[0][:160], current.size)
        return []


def _elastic_loop(run: Callable,
                  mesh,
                  *,
                  grow: bool,
                  fallback: Optional[Callable] = None,
                  min_devices: int = 1,
                  job_id: str = "",
                  journal=None):
    """The shared elastic engine: shrink on device loss (always), grow on
    join announcements (grow=True). Both directions re-enter run() on a
    rebuilt mesh."""
    from pipelinedp_tpu_torch.parallel import mesh as mesh_lib

    if journal is not None:
        raise NotImplementedError(
            "the elastic loop's journal= is not ported yet (ROADMAP.md "
            "Queue 1 step 4)")
    current = mesh
    planned = current.size
    floor = max(int(min_devices), 1)
    health = health_lib.current()
    if health is not None:
        health.note_mesh(planned, planned)
    if grow:
        telemetry.set_gauge("mesh_target_devices", planned,
                            job_id=job_id or None)
    while True:
        n_live = current.size
        try:
            if n_live <= 1 and fallback is not None:
                logging.warning(
                    "elastic mesh floor reached for job %r: running the "
                    "unsharded driver on the single remaining device "
                    "(results are identical — block keys are independent "
                    "of mesh geometry).", job_id)
                return fallback(current)
            if grow:
                with _growth_scope():
                    return run(current)
            return run(current)
        except MeshGrowthSignal as sig:
            admitted = _admit_joiners(current, sig, job_id)
            if not admitted:
                if health is not None:
                    health.note_fleet_event(
                        "REJOINING",
                        f"scale-UP aborted at block {sig.block}: join "
                        f"candidates failed the admit; continuing on "
                        f"{n_live} device(s)")
                continue
            current = mesh_lib.make_mesh(
                devices=list(current.slots) + list(admitted))
            planned = current.size
            telemetry.record("mesh_expansions", block=sig.block,
                             devices=planned)
            telemetry.set_gauge("mesh_target_devices", planned,
                                job_id=job_id or None)
            if health is not None:
                health.note_mesh(planned, planned)
                health.note_fleet_event(
                    "REJOINING",
                    f"admitted {len(admitted)} joining device(s) at "
                    f"block {sig.block}; mesh grew {n_live} -> {planned}")
            logging.warning(
                "elastic scale-UP for job %r: admitted %d joining slot(s) "
                "at block boundary %d; rebuilding a %d-slot mesh and "
                "re-entering the driver — the grown run re-derives the "
                "same block keys.", job_id, len(admitted), sig.block,
                planned)
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_device_fatal(e):
                raise
            telemetry.record("device_losses")
            live = mesh_lib.probe_live_devices(list(current.slots))
            # A process whose every slot dropped is a host loss.
            procs_before = set(mesh_lib.mesh_processes(current))
            procs_alive = {mesh_lib.device_process(d) for d in live}
            dead_procs = sorted(procs_before - procs_alive)
            if dead_procs:
                telemetry.record("host_losses", len(dead_procs))
                logging.warning(
                    "whole-host loss for job %r: process(es) %s lost every "
                    "slot; the mesh rebuilds over the surviving slots.",
                    job_id, dead_procs)
            # Shrink by at least one even if every slot answers the probe:
            # the failed launch names this geometry as unusable.
            target = min(len(live), n_live - 1)
            if health is not None:
                health.note_mesh(planned, max(target, 0))
            if target < floor:
                raise MeshDegradationError(
                    f"job {job_id!r}: device losses exhausted the elastic "
                    f"floor ({len(live)} live devices < "
                    f"min_devices={floor}, planned {planned}). Resume on a "
                    f"healthy slice with the same job_id={job_id!r} and "
                    f"the same inputs/seed (no journal configured — the "
                    f"block journal is not ported yet, so a resume re-runs "
                    f"every block under the same keys).") from e
            telemetry.record("mesh_degradations")
            if grow:
                telemetry.set_gauge("mesh_target_devices", target,
                                    job_id=job_id or None)
            survivors = live[:target]
            me = mesh_lib.process_index()
            if (len(procs_before) > 1 and
                    all(mesh_lib.device_process(d) != me
                        for d in survivors)):
                raise HostEvacuatedError(
                    f"job {job_id!r}: whole-host loss evacuated this "
                    f"process (process {me}) — none of the {target} "
                    f"surviving slots are addressable here.") from e
            logging.warning(
                "device loss for job %r (%s: %s); rebuilding a %d-slot "
                "mesh from %d survivors (planned %d) and re-entering the "
                "driver — re-dispatched blocks re-derive the same keys, "
                "so the degraded run is a replay of the same release.",
                job_id, type(e).__name__, str(e).splitlines()[0][:160],
                target, len(live), planned)
            current = mesh_lib.make_mesh(devices=survivors)
