"""Resident multi-tenant DP-aggregation service
(pipelinedp_tpu/service/service.py).

DPAggregationService holds ONE TorchBackend for its lifetime and runs the
jobs tenants submit on a bounded worker pool:

  * **One backend, many jobs.** Each job runs on a worker thread under
    its own job-scoped view (``TorchBackend.for_job``: its own noise seed
    and job id, the parent's device, dtype and knobs) inside its own
    ``health.job_scope(job_id)``, with its own NaiveBudgetAccountant of
    exactly its grant. Concurrent jobs release what their serial runs
    release.
  * **Tenant ledgers of record.** Per-tenant spend lives in a
    TenantLedger persisted through the CRC-verified BlockJournal (the
    odometer records are the ledger rows; the JAX service's ledger
    directories reload here and the other way round). submit() reserves
    the job's epsilon and refuses an over-budget job with
    TenantBudgetExceededError before any accountant or mechanism exists;
    execution runs under ``no_new_mechanisms``.
  * **Admission control.** A priority FIFO admits up to
    ``max_concurrent_jobs`` at once and queues the rest; a queued job that
    outlives ``queue_timeout_s`` is shed, and submissions are shed while
    the live memory watermark (torch.cuda.memory_allocated on the card)
    exceeds ``shed_watermark_fraction`` of the card's memory.
  * **Megabatched serving** (``batching=True``): identical-spec jobs that
    run at the same time release as lanes of ONE lane-batched release
    (service/batching.py), each lane equal to its solo run bit for bit.

Differences from the JAX service: torch has no jit cache, so
``JobHandle.jit_cache_misses`` and ``compile_reuse()`` report 0 misses;
a meshed backend's releases are serialized while the service runs
(parallel/sharded.py enable_collective_serialization), as the JAX
service serializes its collectives; a batched release that fails fails
its lanes' jobs instead of falling back to solo (service/batching.py).

Declared service metrics: ``service_jobs_admitted`` /
``service_jobs_queued`` / ``service_jobs_shed`` /
``service_jobs_cancelled`` counters, ``service_active_jobs`` /
``service_queue_depth`` gauges, and the batching tier's
``service_batch_launches`` / ``service_jobs_batched`` /
``service_batch_occupancy``.
"""

import contextlib
import dataclasses
import hashlib
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional

from pipelinedp_tpu_torch import aggregate_params as agg_params
from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch import dp_engine
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch import numeric as rt_numeric
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch.data_extractors import DataExtractors
from pipelinedp_tpu_torch.parallel import sharded
from pipelinedp_tpu_torch.runtime import health as rt_health
from pipelinedp_tpu_torch.runtime import observability as rt_observability
from pipelinedp_tpu_torch.runtime import telemetry as rt_telemetry
from pipelinedp_tpu_torch.runtime import watchdog as rt_watchdog
from pipelinedp_tpu_torch.runtime.concurrency import guarded_by
from pipelinedp_tpu_torch.runtime.journal import BlockJournal
from pipelinedp_tpu_torch.runtime.journal import StorageUnavailableError
from pipelinedp_tpu_torch.service.batching import BatchCoalescer
from pipelinedp_tpu_torch.service.errors import AdmissionRejectedError
from pipelinedp_tpu_torch.service.errors import JobCancelledError
from pipelinedp_tpu_torch.service.ledger import TenantLedger


def _tuple_extractors() -> DataExtractors:
    """Default extractors for (privacy_id, partition_key, value) rows -
    the columnar/streamed entries never consult them."""
    return DataExtractors(privacy_id_extractor=lambda r: r[0],
                          partition_extractor=lambda r: r[1],
                          value_extractor=lambda r: r[2])


@dataclasses.dataclass
class JobSpec:
    """One submission's aggregation request + privacy grant.

    params is an AggregateParams (DP aggregation) or a
    SelectPartitionsParams (standalone DP partition selection).
    epsilon/delta are the job's FULL budget - the admission grant the
    tenant ledger reserves; the job's accountant is constructed with
    exactly this budget, so the grant is also the hard spend ceiling.
    noise_seed pins the job's base PRNG key (None = fresh
    nondeterministic); priority orders the admission queue (LOWER
    values run first, >= 0; FIFO within a priority).
    """
    params: Any
    epsilon: float
    delta: float = 0.0
    data_extractors: Optional[DataExtractors] = None
    public_partitions: Any = None
    noise_seed: Optional[int] = None
    priority: int = 0

    @property
    def is_select_partitions(self) -> bool:
        return isinstance(self.params, agg_params.SelectPartitionsParams)

    @property
    def cache_key(self) -> str:
        """Digest of the kernel-relevant spec: jobs sharing it compile
        the same entry points (given same-bucket data shapes), which is
        what the per-spec compile-reuse stats group by."""
        payload = repr((type(self.params).__name__, self.params,
                        self.public_partitions is not None))
        return hashlib.sha1(payload.encode()).hexdigest()[:12]


class JobStatus:
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    SHED = "SHED"
    CANCELLED = "CANCELLED"


class JobHandle:
    """Future-like handle of one submitted job.

    deadline_s bounds the job's total submit-to-finish time (queue wait
    included); cancel() requests cooperative cancellation. Either way
    the job settles CANCELLED with a typed JobCancelledError, releases
    its reservation and charges nothing - its result is withheld at the
    service boundary, so no release ever left the process.
    """

    _GUARDED_BY = guarded_by("_lock", "_status", "_result", "_error",
                             "_spent_epsilon", "_jit_cache_misses",
                             "_started_at", "_finished_at", "_watchdog")

    def __init__(self, job_id: str, tenant_id: str, spec: JobSpec,
                 deadline_s: Optional[float] = None):
        self.job_id = job_id
        self.tenant_id = tenant_id
        self.spec = spec
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._status = JobStatus.QUEUED
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._spent_epsilon: Optional[float] = None
        self._jit_cache_misses: Optional[int] = None
        self._queued_at = time.monotonic()
        self._started_at: Optional[float] = None
        self._finished_at: Optional[float] = None
        self._cancel = threading.Event()
        self._deadline_at = (None if deadline_s is None
                             else self._queued_at + float(deadline_s))
        self._watchdog: Optional[rt_watchdog.Watchdog] = None

    # -- worker-side transitions ----------------------------------------

    def _set_running(self) -> None:
        with self._lock:
            self._status = JobStatus.RUNNING
            self._started_at = time.monotonic()

    def _complete(self, result: Any, spent_epsilon: float,
                  jit_cache_misses: int) -> None:
        with self._lock:
            self._status = JobStatus.DONE
            self._result = result
            self._spent_epsilon = spent_epsilon
            self._jit_cache_misses = jit_cache_misses
            self._finished_at = time.monotonic()
        self._done.set()

    def _fail(self, error: BaseException, shed: bool = False,
              cancelled: bool = False) -> None:
        with self._lock:
            self._status = (JobStatus.CANCELLED if cancelled else
                            JobStatus.SHED if shed else JobStatus.FAILED)
            self._error = error
            self._finished_at = time.monotonic()
        self._done.set()

    def _attach_watchdog(self,
                         wd: "Optional[rt_watchdog.Watchdog]") -> None:
        """Publishes the RUNNING job's per-job watchdog so cancel() can
        interrupt in-flight guarded operations (None detaches it when
        the run leaves the guarded region)."""
        with self._lock:
            self._watchdog = wd

    def _deadline_exceeded(self) -> bool:
        return (self._deadline_at is not None and
                time.monotonic() > self._deadline_at)

    # -- caller-side cancellation ----------------------------------------

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    def cancel(self) -> bool:
        """Requests cooperative cancellation; returns False when the job
        already finished (nothing to cancel). A QUEUED job cancels at
        dequeue; a RUNNING job's in-flight guarded operations are
        cancelled through its watchdog token (deadline_s jobs always
        carry one) and the job settles CANCELLED at the service's next
        cooperative checkpoint - native calls are never preempted."""
        if self._done.is_set():
            return False
        self._cancel.set()
        with self._lock:
            wd = self._watchdog
        if wd is not None:
            wd.cancel_all(detail=f"job {self.job_id} cancelled")
        return True

    # -- caller-side queries ---------------------------------------------

    @property
    def status(self) -> str:
        with self._lock:
            return self._status

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        """The job's released DP result; re-raises the job's failure
        (including AdmissionRejectedError for queue-timeout sheds)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id!r} did not finish within {timeout}s "
                f"(status {self.status})")
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._result

    def exception(self,
                  timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"job {self.job_id!r} still "
                               f"{self.status} after {timeout}s")
        with self._lock:
            return self._error

    @property
    def spent_epsilon(self) -> Optional[float]:
        """The completed job's accountant spend (None until DONE) -
        bit-exactly what the tenant ledger recorded for this job."""
        with self._lock:
            return self._spent_epsilon

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-finish wall seconds (queue wait included; None
        while the job is still queued or running)."""
        with self._lock:
            if self._finished_at is None:
                return None
            return self._finished_at - self._queued_at

    @property
    def jit_cache_misses(self) -> Optional[int]:
        """Compiles attributed to this job (None until DONE). Always 0
        once DONE: torch has no jit cache, and the port's kernels are
        built once per process (cuda_build), not per job."""
        with self._lock:
            return self._jit_cache_misses


@dataclasses.dataclass
class _Job:
    """Internal queue entry."""
    job_id: str
    tenant_id: str
    spec: JobSpec
    source: Any
    ledger: TenantLedger
    handle: JobHandle
    enqueued_at: float


# Sentinel priority: strictly below every job (user priorities clamp to
# >= 0), so stop() preempts queued work and workers exit immediately.
_STOP_PRIORITY = -1

# A resident service outlives millions of submissions: completed
# handles beyond this bound are evicted (oldest first; queued/running
# handles are always kept) so _handles and the stats() /
# ledgers_reconciled() scans stay O(recent), not O(service lifetime).
_MAX_RETAINED_HANDLES = 1024


def _evict_done(handles: List[JobHandle],
                cap: int) -> List[JobHandle]:
    """Drops the oldest FINISHED handles until len <= cap (or until
    only unfinished handles remain - those are never dropped)."""
    excess = len(handles) - cap
    kept = []
    for handle in handles:
        if excess > 0 and handle.done():
            excess -= 1
            continue
        kept.append(handle)
    return kept


class DPAggregationService:
    """See module docstring.

    Args:
        backend: the TorchBackend the service owns for its lifetime.
            Per-job views derive from it (``for_job``).
        ledger_dir: directory for the tenant ledgers of record
            (BlockJournal-persisted odometer trails, one per tenant -
            reloaded on service restart). None keeps ledgers in memory
            only (tests; no restart durability).
        max_concurrent_jobs: worker-pool width - jobs beyond it queue.
        tenant_budget_epsilon: every tenant's lifetime epsilon budget
            (math.inf disables the cap; the ledger still records).
        queue_timeout_s: a job that waits in the admission queue longer
            than this is shed with a retry-after instead of running
            arbitrarily late (also the default retry-after for
            watermark sheds).
        drain_timeout_s: how long drain() - the migration/rolling-
            restart teardown - waits for RUNNING jobs to finish before
            proceeding; queued jobs are cancelled for resubmission on
            the successor either way.
        shed_watermark_fraction: submissions are shed while the live
            device-memory watermark exceeds this fraction of the
            memory limit.
        memory_limit_bytes: the shed check's denominator. None reads
            the card's total memory (torch.cuda.get_device_properties)
            on a CUDA backend and disables the check on the CPU.
        batching: True enables megabatched serving - concurrently
            executing jobs whose releases share an exact fingerprint
            (config, clipping scalars, noise stds, padded row shape,
            device and dtype) run as lanes of ONE lane-batched release,
            each lane keyed by its own job's noise seed, so per-job
            results equal solo runs bit for bit. Single-job windows,
            mixed specs and specs without lane entries run solo.
        batch_window_ms: how long the first job of a coalescing group
            holds its launch open for identical-spec company before
            dispatching - the latency the batching tier is willing to
            pay for occupancy.
        max_batch_jobs: lane cap per megabatched launch; a group that
            fills dispatches immediately, without waiting out the
            window.
        tenant_accounting: what admission charges a tenant's spend as.
            "naive" (default): the bit-exact left-to-right epsilon sum
            - the ledger of record. "pld": the PLD-composed epsilon
            rebuilt from the same persisted trail (with a 1% safety
            margin, and never looser than naive) - at k Gaussian jobs
            ~sqrt(k) tighter, so the same lifetime budget admits more
            jobs. The naive sum stays the ledger of record and its
            reconciliation stays bit-exact in BOTH modes.
        pld_discretization: privacy-loss grid interval for the PLD
            spend rebuild (and the spectrum-cache key). Finer = more
            accurate composed bound, more memory/FFT time; ceiling
            rounding keeps every choice a sound upper bound.
    """

    _GUARDED_BY = guarded_by("_lock", "_ledgers", "_handles", "_seq",
                             "_active_jobs", "_stopped", "_spec_stats")

    def __init__(self,
                 backend: pipeline_backend.TorchBackend,
                 ledger_dir: Optional[str] = None,
                 *,
                 max_concurrent_jobs: int = 2,
                 tenant_budget_epsilon: float = float("inf"),
                 queue_timeout_s: float = 30.0,
                 drain_timeout_s: float = 30.0,
                 shed_watermark_fraction: float = 0.9,
                 memory_limit_bytes: Optional[int] = None,
                 batching: bool = False,
                 batch_window_ms: float = 25.0,
                 max_batch_jobs: int = 16,
                 tenant_accounting: str = "naive",
                 pld_discretization: float = 1e-4):
        if not isinstance(backend, pipeline_backend.TorchBackend):
            raise ValueError(
                f"DPAggregationService: backend must be a TorchBackend "
                f"(the service owns one device for its lifetime), "
                f"but {type(backend).__name__} given.")
        input_validators.validate_max_concurrent_jobs(
            max_concurrent_jobs, "DPAggregationService")
        input_validators.validate_tenant_budget_epsilon(
            tenant_budget_epsilon, "DPAggregationService")
        input_validators.validate_queue_timeout_s(
            queue_timeout_s, "DPAggregationService")
        input_validators.validate_drain_timeout_s(
            drain_timeout_s, "DPAggregationService")
        input_validators.validate_shed_watermark_fraction(
            shed_watermark_fraction, "DPAggregationService")
        input_validators.validate_batching(batching,
                                           "DPAggregationService")
        input_validators.validate_batch_window_ms(
            batch_window_ms, "DPAggregationService")
        input_validators.validate_max_batch_jobs(
            max_batch_jobs, "DPAggregationService")
        input_validators.validate_tenant_accounting(
            tenant_accounting, "DPAggregationService")
        input_validators.validate_pld_discretization(
            pld_discretization, "DPAggregationService")
        self._backend = backend
        self._ledger_journal = BlockJournal(ledger_dir)
        self._ledger_dir = ledger_dir
        self._max_concurrent_jobs = int(max_concurrent_jobs)
        self._tenant_budget_epsilon = float(tenant_budget_epsilon)
        self._queue_timeout_s = float(queue_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._shed_watermark_fraction = float(shed_watermark_fraction)
        self._memory_limit_bytes = (None if memory_limit_bytes is None
                                    else int(memory_limit_bytes))
        self._tenant_accounting = tenant_accounting
        self._pld_discretization = float(pld_discretization)
        # Megabatching only coalesces releases whose fingerprints match
        # exactly; a lone-lane window or a mixed spec runs solo, so a
        # disabled coalescer is "every lane solo".
        self._coalescer = (BatchCoalescer(batch_window_ms / 1000.0,
                                          max_batch_jobs)
                           if batching else None)
        self._lock = threading.Lock()
        self._ledgers: Dict[str, TenantLedger] = {}
        self._handles: List[JobHandle] = []
        self._seq = 0
        self._active_jobs = 0
        self._stopped = False
        # spec cache_key -> {"jobs": n, "jit_cache_misses": m}: the
        # cross-tenant compile-reuse evidence (bench receipt key).
        self._spec_stats: Dict[str, Dict[str, int]] = {}
        self._queue: "queue.PriorityQueue" = queue.PriorityQueue()
        # Worker threads run meshed releases concurrently: the one place
        # the port needs collective-launch serialization (see
        # parallel/sharded.py); enabled before the first worker starts,
        # dropped in stop() after every worker has joined.
        sharded.enable_collective_serialization()
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"dp-service-worker-{i}", daemon=True)
            for i in range(self._max_concurrent_jobs)
        ]
        for worker in self._workers:
            worker.start()

    # -- lifecycle -------------------------------------------------------

    def __enter__(self) -> "DPAggregationService":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.stop()

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stops the worker pool. Running jobs finish; queued jobs that
        never ran fail with AdmissionRejectedError and release their
        ledger reservations."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        if self._coalescer is not None:
            # Wake every open batch window NOW: pending groups dispatch
            # with the lanes they have (still bit-identical per lane)
            # instead of waiting out windows during shutdown.
            self._coalescer.close()
        for _ in self._workers:
            with self._lock:
                self._seq += 1
                seq = self._seq
            self._queue.put((_STOP_PRIORITY, seq, None))
        for worker in self._workers:
            worker.join(timeout=timeout_s)
        sharded.disable_collective_serialization()
        # Workers exited on the preempting sentinels; drain what queued
        # behind them.
        while True:
            try:
                _, _, job = self._queue.get_nowait()
            except queue.Empty:
                break
            if job is None:
                continue
            job.ledger.release(job.job_id)
            job.handle._fail(
                AdmissionRejectedError(
                    f"job {job.job_id!r} cancelled: service stopped "
                    f"before a worker picked it up"))
        self._set_queue_depth()

    def drain(self) -> Dict[str, int]:
        """Drains the service for a migration or rolling restart.

        Intake stops, RUNNING jobs get drain_timeout_s to finish (their
        charges persist to the ledger journal on completion, as every
        charge does), and queued jobs that never ran are cancelled -
        reservations released, handles failed with
        AdmissionRejectedError - so the caller resubmits them on the
        successor service. Nothing extra needs flushing: the tenant
        ledger trails are already durable per charge, journaled block
        results live in their own directory, and a successor constructed
        over the same ledger_dir reloads exactly the spend this instance
        recorded (TenantLedger reload + max_job_seq keep job ids from
        colliding, and idempotent charges keep replays from double-
        spending).

        Returns counts: {"completed": jobs that finished DONE,
        "cancelled": queued jobs cancelled for resubmission (plus jobs
        cancelled via JobHandle.cancel()/deadline_s),
        "failed": jobs that failed for any other reason,
        "shed": submissions shed before the drain}.
        """
        self.stop(timeout_s=self._drain_timeout_s)
        with self._lock:
            handles = list(self._handles)
        counts = {"completed": 0, "cancelled": 0, "failed": 0, "shed": 0}
        for handle in handles:
            status = handle.status
            if status == JobStatus.DONE:
                counts["completed"] += 1
            elif status == JobStatus.SHED:
                counts["shed"] += 1
            elif status == JobStatus.CANCELLED:
                counts["cancelled"] += 1
            elif status == JobStatus.FAILED:
                error = handle.exception(timeout=0)
                if isinstance(error, AdmissionRejectedError):
                    counts["cancelled"] += 1
                else:
                    counts["failed"] += 1
        logging.info(
            "service drained for handover: %d completed, %d queued "
            "job(s) cancelled for resubmission on the successor, %d "
            "failed, %d shed.", counts["completed"], counts["cancelled"],
            counts["failed"], counts["shed"])
        return counts

    # -- tenant ledgers --------------------------------------------------

    def tenant_ledger(self, tenant_id: str) -> TenantLedger:
        """The tenant's ledger, loaded from the ledger journal on first
        use (which is how recorded spend survives a service restart)."""
        with self._lock:
            ledger = self._ledgers.get(tenant_id)
        if ledger is not None:
            return ledger
        # Construct outside the lock (the reload reads journal files);
        # a concurrent first-use race is settled by setdefault.
        ledger = TenantLedger(tenant_id, self._tenant_budget_epsilon,
                              self._ledger_journal,
                              accounting_mode=self._tenant_accounting,
                              pld_discretization=self._pld_discretization)
        with self._lock:
            return self._ledgers.setdefault(tenant_id, ledger)

    def ledgers(self) -> Dict[str, Dict[str, Any]]:
        """{tenant_id: ledger snapshot} for every tenant seen."""
        with self._lock:
            ledgers = dict(self._ledgers)
        return {tid: led.snapshot() for tid, led in ledgers.items()}

    def ledgers_reconciled(self) -> bool:
        """True iff every completed job's ledger spend equals its
        accountant's spent epsilon bit-exactly (the acceptance bar for
        the ledger being the ledger OF RECORD)."""
        with self._lock:
            handles = list(self._handles)
        for handle in handles:
            if handle.status != JobStatus.DONE:
                continue
            ledger = self.tenant_ledger(handle.tenant_id)
            if ledger.job_spent_epsilon(
                    handle.job_id) != handle.spent_epsilon:
                return False
        return True

    # -- admission -------------------------------------------------------

    def submit(self, tenant_id: str, spec: JobSpec,
               source: Any, *,
               deadline_s: Optional[float] = None) -> JobHandle:
        """Admits one job for a tenant, or raises.

        Raises AdmissionRejectedError (with retry_after_s) when the
        memory watermark sheds the submission, TenantBudgetExceededError
        when the tenant's lifetime budget cannot cover spec.epsilon -
        both BEFORE any accountant or mechanism exists for the job.

        deadline_s bounds the job's total submit-to-finish wall time
        (queue wait included): a job past its deadline settles
        CANCELLED with JobCancelledError - reservation released,
        nothing charged, result withheld (see JobHandle.cancel).
        """
        input_validators.validate_job_id(tenant_id,
                                         "DPAggregationService.submit")
        if not isinstance(spec, JobSpec):
            raise ValueError(
                f"DPAggregationService.submit: spec must be a JobSpec, "
                f"but {type(spec).__name__} given.")
        input_validators.validate_epsilon_delta(spec.epsilon, spec.delta,
                                                "JobSpec")
        if deadline_s is not None:
            input_validators.validate_deadline_s(
                deadline_s, "DPAggregationService.submit")
        with self._lock:
            stopped = self._stopped
        if stopped:
            raise RuntimeError(
                "DPAggregationService.submit: the service is stopped.")
        self._shed_check()
        ledger = self.tenant_ledger(tenant_id)
        with self._lock:
            # Job ids must stay unique across service restarts: the
            # reloaded ledger keeps prior-run job ids in the same
            # format, and a colliding id would merge two runs' records
            # in job_spent_epsilon()/reconciles(). Seed the sequence
            # past everything the tenant's ledger has seen.
            self._seq = max(self._seq, ledger.max_job_seq())
            self._seq += 1
            seq = self._seq
        job_id = f"{tenant_id}--j{seq:05d}"
        # The admission grant: raises TenantBudgetExceededError while
        # the job still consists of nothing but this reservation.
        ledger.reserve(job_id, spec.epsilon)
        handle = JobHandle(job_id, tenant_id, spec,
                           deadline_s=deadline_s)
        job = _Job(job_id=job_id, tenant_id=tenant_id, spec=spec,
                   source=source, ledger=ledger, handle=handle,
                   enqueued_at=time.monotonic())
        with self._lock:
            # Re-checked at enqueue time: if stop() set _stopped after
            # the early check, the workers are exiting and the drain
            # may already have emptied the queue - a job put now would
            # never complete and its reservation would leak. Enqueue
            # and the _stopped flag flip under the same lock, so every
            # job is either visible to stop()'s drain or refused here.
            admitted = not self._stopped
            if admitted:
                self._handles.append(handle)
                if len(self._handles) > _MAX_RETAINED_HANDLES:
                    self._handles = _evict_done(self._handles,
                                                _MAX_RETAINED_HANDLES)
                self._queue.put((max(int(spec.priority), 0), seq, job))
        if not admitted:
            ledger.release(job_id)
            raise RuntimeError(
                "DPAggregationService.submit: the service is stopped.")
        rt_telemetry.record("service_jobs_queued")
        self._set_queue_depth()
        return handle

    def _shed_check(self) -> None:
        """Load shedding by memory watermark: refuse new work while the
        device set is nearly full instead of OOMing the jobs already on
        it. The watermark is the card's allocator stats on CUDA, the
        byte accountant elsewhere (observability.memory_watermark)."""
        limit = self._memory_limit_bytes
        if limit is None:
            limit = _device_bytes_limit(self._backend)
        if not limit:
            return
        wm = rt_observability.memory_watermark()
        threshold = self._shed_watermark_fraction * limit
        if wm["live_bytes"] > threshold:
            rt_telemetry.record("service_jobs_shed")
            raise AdmissionRejectedError(
                f"DPAggregationService: submission shed - live device "
                f"memory {wm['live_bytes']}B (source "
                f"{wm['source']!r}) exceeds "
                f"{self._shed_watermark_fraction:.0%} of the "
                f"{limit}B limit; retry after "
                f"{self._queue_timeout_s}s.",
                retry_after_s=self._queue_timeout_s)

    # -- execution -------------------------------------------------------

    def _set_queue_depth(self) -> None:
        rt_telemetry.set_gauge("service_queue_depth",
                               self._queue.qsize(), job_id=None)

    def _worker_loop(self) -> None:
        while True:
            _, _, job = self._queue.get()
            self._set_queue_depth()
            if job is None:
                return
            waited = time.monotonic() - job.enqueued_at
            if waited > self._queue_timeout_s:
                # Shed on dequeue: the job outlived its queue bound, so
                # running it now would be arbitrarily late - the caller
                # gets a typed retry-after and the reservation returns
                # to the tenant's budget.
                rt_telemetry.record("service_jobs_shed")
                job.ledger.release(job.job_id)
                job.handle._fail(
                    AdmissionRejectedError(
                        f"job {job.job_id!r} shed: waited "
                        f"{waited:.1f}s in the admission queue "
                        f"(queue_timeout_s={self._queue_timeout_s}); "
                        f"retry after {self._queue_timeout_s}s.",
                        retry_after_s=self._queue_timeout_s),
                    shed=True)
                continue
            if (job.handle.cancel_requested or
                    job.handle._deadline_exceeded()):
                # Cancelled (or past its deadline) while still queued:
                # settle before anything runs - the cheapest possible
                # cancellation, nothing to unwind.
                self._settle_cancelled(job)
                continue
            rt_telemetry.record("service_jobs_admitted")
            with self._lock:
                self._active_jobs += 1
                active = self._active_jobs
            rt_telemetry.set_gauge("service_active_jobs", active,
                                   job_id=None)
            job.handle._set_running()
            try:
                self._run_job(job)
            except Exception as e:  # noqa: BLE001 - last-ditch guard: _run_job settles the ledger itself, but anything escaping it (a charge/persist failure, a bug in the failure handler) must still fail the handle - or the caller blocks in result() forever and the pool permanently loses this worker
                logging.exception(
                    "service: job %s for tenant %s crashed outside its "
                    "failure handler", job.job_id, job.tenant_id)
                if not job.handle.done():
                    job.handle._fail(e)
            finally:
                with self._lock:
                    self._active_jobs -= 1
                    active = self._active_jobs
                rt_telemetry.set_gauge("service_active_jobs", active,
                                       job_id=None)

    def _settle_cancelled(self, job: _Job,
                          accountant: Any = None) -> None:
        """Settles a cancelled / deadline-exceeded job: reservation
        released, NOTHING charged, result withheld. Privacy-sound even
        after mechanisms registered, because the result never crosses
        the service boundary - handle.result() raises, so no noised
        value this job computed is ever released to the caller."""
        reason = ("cancelled" if job.handle.cancel_requested
                  else "deadline")
        job.ledger.release(job.job_id)
        if accountant is not None:
            rt_observability.prune_odometer(accountant=accountant)
        rt_telemetry.record("service_jobs_cancelled")
        job.handle._fail(
            JobCancelledError(
                f"job {job.job_id!r} {reason} "
                f"({'JobHandle.cancel() requested' if reason == 'cancelled' else 'deadline_s elapsed before completion'}); "
                f"nothing was charged - the result was withheld at the "
                f"service boundary and the reservation returned to the "
                f"tenant's budget.", reason=reason),
            cancelled=True)
        logging.info("service: job %s for tenant %s %s; reservation "
                     "released, nothing charged.", job.job_id,
                     job.tenant_id, reason)

    def _storage_shed(self, job: _Job, accountant: Any,
                      error: BaseException) -> None:
        """Fail-closed storage shed: the job's spend could not be made
        durable (StorageUnavailableError survived the journal's rewrite
        discipline), so the result is withheld, the reservation returns
        and the tenant retries after the store recovers. Zero odometer
        records remain for the job - TenantLedger.charge rolled back
        its in-memory append, so memory and disk agree that this job
        never charged."""
        job.ledger.release(job.job_id)
        if accountant is not None:
            rt_observability.prune_odometer(accountant=accountant)
        rt_telemetry.record("service_jobs_shed")
        job.handle._fail(
            AdmissionRejectedError(
                f"job {job.job_id!r} shed: the ledger store cannot "
                f"persist its spend ({type(error).__name__}: "
                f"{(str(error).splitlines() or [''])[0][:200]}); the "
                f"result was withheld and nothing was charged - retry "
                f"after {self._queue_timeout_s}s.",
                retry_after_s=self._queue_timeout_s),
            shed=True)
        logging.warning(
            "service: job %s for tenant %s shed - ledger store "
            "unavailable; result withheld, reservation released.",
            job.job_id, job.tenant_id)

    def _run_job(self, job: _Job) -> None:
        """Runs one admitted job on this worker thread, inside its own
        job_scope, with its own accountant and backend view; converts
        the admission reservation into ledger records (or releases /
        forfeits it on failure)."""
        spec = job.spec
        accountant = budget_accounting.NaiveBudgetAccountant(
            total_epsilon=spec.epsilon, total_delta=spec.delta)
        backend = self._backend.for_job(job_id=job.job_id,
                                        noise_seed=spec.noise_seed)
        engine = dp_engine.DPEngine(accountant, backend)
        extractors = spec.data_extractors or _tuple_extractors()
        # With batching on, this worker's dense release is offered to
        # the coalescer: an identical-fingerprint group runs as one
        # lane-batched release (this job as one lane, keyed by its own
        # noise seed - bit-identical to solo), anything else returns None
        # and the solo release runs. Everything around it - decode,
        # odometer, ledger charge, handle - is this job's own code path
        # either way.
        intercept = (executor.launch_interceptor(self._coalescer.offer)
                     if self._coalescer is not None
                     else contextlib.nullcontext())
        # A deadline_s job runs under its own per-job watchdog whose
        # deadline is the time the job has LEFT: expiry (or an explicit
        # cancel()) cancels in-flight guarded operations cooperatively,
        # and the checkpoints below settle the job CANCELLED.
        wd = None
        if job.handle._deadline_at is not None:
            remaining = max(job.handle._deadline_at - time.monotonic(),
                            0.01)
            wd = rt_watchdog.Watchdog(timeout_s=remaining)
        job.handle._attach_watchdog(wd)
        try:
            with rt_health.job_scope(job.job_id), intercept, \
                    rt_watchdog.activate(wd):
                if spec.is_select_partitions:
                    lazy = engine.select_partitions(job.source, spec.params,
                                                    extractors)
                else:
                    lazy = engine.aggregate(job.source, spec.params,
                                            extractors,
                                            spec.public_partitions)
                accountant.compute_budgets()
                # The session boundary: every mechanism registered at
                # graph build, the budget is final - device execution
                # (and any retry/replay inside it) must not grow the
                # ledger, or the job would spend past its admission
                # grant.
                with accountant.no_new_mechanisms(
                        f"service execution of job {job.job_id}"):
                    if spec.is_select_partitions:
                        result = list(lazy)
                    else:
                        result = dict(lazy)
        except StorageUnavailableError as e:
            # The mid-run journal/ledger persist path failed closed
            # (ENOSPC / sick fsync): shed, don't forfeit - the result
            # is withheld below the boundary, so nothing was released.
            job.handle._attach_watchdog(None)
            self._storage_shed(job, accountant, e)
            return
        except Exception as e:  # noqa: BLE001 - the worker must survive ANY job failure: the error re-raises to the caller through handle.result(), and the ledger settles conservatively below
            job.handle._attach_watchdog(None)
            if (job.handle.cancel_requested or
                    job.handle._deadline_exceeded()):
                # The failure is the cancellation surfacing (the
                # watchdog token cancelled an in-flight operation):
                # settle CANCELLED - result withheld, nothing charged.
                self._settle_cancelled(job, accountant)
                return
            if accountant.mechanism_count:
                # Mechanisms registered: releases may have left the
                # process before the failure - forfeit the full grant
                # (over-counting is privacy-safe).
                try:
                    job.ledger.charge_forfeit(job.job_id, spec.epsilon,
                                              reason=type(e).__name__)
                except StorageUnavailableError as storage_err:
                    # Even the forfeit could not be made durable. The
                    # rollback kept memory and disk agreeing (no trail);
                    # shed with the storage error - the result (if any)
                    # is withheld either way.
                    self._storage_shed(job, accountant, storage_err)
                    return
            else:
                job.ledger.release(job.job_id)
            rt_observability.prune_odometer(accountant=accountant)
            # A numeric-sentinel refusal surfaces through the shed path
            # (handle.was_shed + service_jobs_shed) so callers and
            # dashboards see "refused before release" rather than an
            # anonymous failure - but unlike a storage shed the grant
            # settles conservatively above (mechanisms were registered;
            # forfeiting over-counts, which is privacy-safe).
            shed = isinstance(e, rt_numeric.ReleaseIntegrityError)
            if shed:
                rt_telemetry.record("service_jobs_shed")
            # Fail the handle BEFORE formatting the log line: a
            # formatting surprise must never leave the caller blocked
            # in result() with the ledger already settled.
            job.handle._fail(e, shed=shed)
            logging.warning(
                "service: job %s for tenant %s failed (%s: %s); "
                "admission grant %s.", job.job_id, job.tenant_id,
                type(e).__name__,
                (str(e).splitlines() or [""])[0][:200],
                "forfeited" if accountant.mechanism_count else
                "released")
            return
        job.handle._attach_watchdog(None)
        if (job.handle.cancel_requested or
                job.handle._deadline_exceeded()):
            # Cancelled (or deadline elapsed) while the execution was
            # finishing: the result is withheld HERE, before any charge
            # and before it could ever reach the caller - which is what
            # makes charging nothing privacy-sound.
            self._settle_cancelled(job, accountant)
            return
        records = rt_observability.odometer_report(
            accountant=accountant)["records"]
        spent = accountant.spent_epsilon()
        try:
            job.ledger.charge(job.job_id, records)
        except StorageUnavailableError as e:
            # The charge's persist failed closed and rolled back: shed
            # with retry_after_s, result withheld, zero odometer
            # records for the job.
            self._storage_shed(job, accountant, e)
            return
        # The trail is charged to the tenant's ledger of record - drop
        # it from the process-global odometer, or a resident service
        # grows that trail (and every odometer_report scan) without
        # bound over its lifetime.
        rt_observability.prune_odometer(accountant=accountant)
        # torch has no jit cache: no job compiles anything of its own.
        misses = 0
        key = spec.cache_key
        with self._lock:
            stats = self._spec_stats.setdefault(
                key, {"jobs": 0, "jit_cache_misses": 0})
            stats["jobs"] += 1
        job.handle._complete(result, spent, misses)

    # -- introspection ---------------------------------------------------

    def handles(self) -> List[JobHandle]:
        """Retained job handles: every queued/running job, plus the
        most recent completed ones (bounded - see
        _MAX_RETAINED_HANDLES); stats() and ledgers_reconciled() roll
        up over this window, the ledgers keep the full history."""
        with self._lock:
            return list(self._handles)

    def compile_reuse(self) -> Dict[str, Dict[str, int]]:
        """{spec cache_key: {"jobs", "jit_cache_misses"}}: the completed
        jobs of each spec. jit_cache_misses is always 0: torch has no jit
        cache, and the kernels are built once per process."""
        with self._lock:
            return {k: dict(v) for k, v in self._spec_stats.items()}

    def stats(self) -> Dict[str, Any]:
        """Service-level rollup for receipts and debugging."""
        counters = rt_telemetry.snapshot()
        with self._lock:
            active = self._active_jobs
            handles = list(self._handles)
        by_status: Dict[str, int] = {}
        for handle in handles:
            by_status[handle.status] = by_status.get(handle.status, 0) + 1
        return {
            "jobs_admitted": counters.get("service_jobs_admitted", 0),
            "jobs_queued": counters.get("service_jobs_queued", 0),
            "jobs_shed": counters.get("service_jobs_shed", 0),
            "jobs_cancelled": counters.get("service_jobs_cancelled", 0),
            "active_jobs": active,
            "queue_depth": self._queue.qsize(),
            "jobs_by_status": by_status,
            "compile_reuse": self.compile_reuse(),
            "ledgers": self.ledgers(),
            "ledgers_reconciled": self.ledgers_reconciled(),
        }


def _device_bytes_limit(backend) -> Optional[int]:
    """The card's total memory on a CUDA backend (None on the CPU: the
    shed check then needs an explicit memory_limit_bytes)."""
    import torch
    if backend.device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(backend.device).total_memory)
