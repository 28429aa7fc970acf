"""Per-tenant privacy-budget ledgers (pipelinedp_tpu/service/ledger.py): the
persisted odometer records (runtime/observability.py) promoted to the
ledger of record.

A batch run's accountant dies with its process; a resident service
multiplexing many tenants needs each tenant's CUMULATIVE spend to
outlive every job, every accountant and every service restart. The
TenantLedger keeps exactly the odometer's per-mechanism record shape
(seq, job, metric, mechanism kind, weight/sensitivity, eps/delta
share, process provenance) and persists the trail through the same
CRC-verified BlockJournal machinery (key ``__odometer__``, fsync-then-
rename), keyed by the tenant id - so an auditor reads one store for
both block results and budget provenance, and a restarted service
reloads the trail through the same integrity checks a block replay
gets.

Accounting discipline (two-phase, mirroring the admission flow):

  * ``reserve(job_id, epsilon)`` - the admission grant. Refused with
    TenantBudgetExceededError when recorded spend + in-flight
    reservations + the request would exceed the lifetime budget; the
    refusal happens BEFORE any accountant or mechanism exists, so a
    rejected job provably spends nothing.
  * ``charge(job_id, records)`` - job completion converts the
    reservation into per-mechanism ledger records (the job's odometer
    trail, eps shares resolved by compute_budgets). Per job, the
    ledger's eps sum reproduces ``BudgetAccountant.spent_epsilon()``
    BIT-EXACTLY: records append in registration order and fold with
    the same left-to-right float64 fold the accountant uses, and the
    npz round-trip stores float64 exactly.
  * ``charge_forfeit(job_id, epsilon)`` - a job that failed AFTER
    registering mechanisms may have released noised values already;
    the full admission grant is conservatively charged as one
    synthetic record (over-counting is privacy-safe; under-counting
    never is). A job that failed before any registration releases its
    reservation instead.

Every total here (the cumulative spend, the reservations, each job's
spend) is an explicit left-to-right fold (_fold), not the builtin sum:
from Python 3.12 on that sum is compensated (Neumaier) for floats, so it
can differ in the last bit from the fold BudgetAccountant.spent_epsilon()
computes. The JAX package's ledger totals use the builtin (ROADMAP
Queue 3).
"""

import logging
import math
import re
import threading
from typing import Any, Dict, List, Optional

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch.runtime import journal as journal_lib
from pipelinedp_tpu_torch.runtime import observability
from pipelinedp_tpu_torch.runtime.concurrency import guarded_by
from pipelinedp_tpu_torch.service.errors import TenantBudgetExceededError

# The service's job-id format is "<tenant>--j<seq>"; the ledger parses
# the seq back out so a restarted service can seed its sequence past
# every persisted job id (see max_job_seq).
_JOB_SEQ_RE = re.compile(r"--j(\d+)$")

# Safety margin on the PLD-composed spend before admission charges it:
# the composed number is a pessimistic (ceiling-rounded) upper bound
# already, but it depends on the discretization knob, so admission adds
# 1% on top and never charges less than min(naive, pld * (1 + margin)).
# Both the naive sum and the inflated composed bound are sound upper
# bounds on the true spend, so their min is too.
PLD_ADMISSION_HEADROOM = 0.01


def _fold(values) -> float:
    """The left-to-right float64 sum of `values`."""
    total = 0.0
    for value in values:
        total += value
    return total


class TenantLedger:
    """One tenant's lifetime budget ledger (thread-safe; shared by the
    service's concurrent workers)."""

    # Workers reserve/charge concurrently while submit() reads
    # remaining budget; persistence runs OUTSIDE the lock (journal.put
    # fsyncs) with a version re-check loop for write ordering. The
    # PLD-composed spend is likewise rebuilt OUTSIDE the lock (an FFT
    # composition must never run under a lock workers contend on) and
    # cached against the trail version it was computed from.
    _GUARDED_BY = guarded_by("_lock", "_records", "_reserved", "_version",
                             "_pld_cached", "_pld_cache_version")

    def __init__(self, tenant_id: str, lifetime_epsilon: float, journal,
                 *,
                 accounting_mode: str = "naive",
                 pld_discretization: float = 1e-4):
        input_validators.validate_job_id(tenant_id, "TenantLedger")
        input_validators.validate_tenant_budget_epsilon(
            lifetime_epsilon, "TenantLedger")
        input_validators.validate_tenant_accounting(
            accounting_mode, "TenantLedger")
        input_validators.validate_pld_discretization(
            pld_discretization, "TenantLedger")
        self.tenant_id = tenant_id
        self.lifetime_epsilon = float(lifetime_epsilon)
        self.accounting_mode = accounting_mode
        self._pld_discretization = float(pld_discretization)
        self._journal = journal
        self._lock = threading.Lock()
        self._reserved: Dict[str, float] = {}
        # The ledger of record, reloaded through the CRC-verified
        # journal read path: a trail this process (or a predecessor)
        # persisted survives restarts; a corrupt trail quarantines like
        # any journal record and the tenant starts from what verifies.
        self._records: List[Dict[str, Any]] = list(
            observability.load_odometer(journal, tenant_id))
        self._version = 0
        self._pld_cached = 0.0
        self._pld_cache_version = -1

    # -- queries ---------------------------------------------------------

    @staticmethod
    def _job_sums(records: List[Dict[str, Any]]) -> Dict[str, float]:
        """Per-job eps sums, each folded in record order - the same
        left-to-right sum BudgetAccountant.spent_epsilon() computes, so
        a job's ledger spend reproduces its accountant bit-exactly."""
        sums: Dict[str, float] = {}
        for r in records:
            if r.get("eps") is None:
                continue
            job = r.get("job_id") or ""
            sums[job] = sums.get(job, 0.0) + r["eps"] * r.get("count", 1)
        return sums

    def spent_epsilon(self) -> float:
        """Cumulative recorded spend: the sum of per-job spends (each
        bit-exact vs its accountant), in first-recorded job order."""
        with self._lock:
            records = list(self._records)
        return _fold(self._job_sums(records).values())

    def job_spent_epsilon(self, job_id: str) -> float:
        """One job's recorded spend (0.0 when the job never charged)."""
        with self._lock:
            records = list(self._records)
        return self._job_sums(records).get(job_id, 0.0)

    def reserved_epsilon(self) -> float:
        with self._lock:
            return _fold(self._reserved.values())

    def pld_spent_epsilon(self) -> float:
        """Cumulative spend under PLD composition: the tenant's full
        persisted trail rebuilt through the batched frequency-domain
        engine (accounting/compose.py), queried at the trail's naive
        delta spend - directly comparable to ``spent_epsilon()``, and
        at k Gaussian jobs ~sqrt(k) times smaller.

        Cached against the trail version; a charge invalidates. Falls
        back to the naive sum when composition cannot produce a finite
        number (e.g. the target delta sits below the composed infinity
        mass) - the admission number must never be optimistic."""
        with self._lock:
            version = self._version
            if self._pld_cache_version == version:
                return self._pld_cached
            records = list(self._records)
        naive = _fold(self._job_sums(records).values())
        # The host composition (numpy), as the JAX package's: no kernel
        # runs here, so the naive fallback below cannot hide a failure of
        # the card's PLD kernels.
        from pipelinedp_tpu_torch.accounting import compose as compose_engine
        try:
            composed, _ = compose_engine.composed_epsilon_from_records(
                records, discretization=self._pld_discretization)
        except Exception:  # noqa: BLE001 - any rebuild failure (bad
            # record shape, grid overflow, FFT error) degrades to the
            # naive sum, which is always a sound admission bound; the
            # rebuild is advisory, never load-bearing for soundness.
            logging.exception(
                "tenant %r: PLD spend rebuild failed - falling back to "
                "the naive sum for this trail version.", self.tenant_id)
            composed = naive
        if not math.isfinite(composed):
            composed = naive
        from pipelinedp_tpu_torch.runtime import telemetry
        telemetry.set_gauge("tenant_pld_epsilon_saved",
                            max(naive - composed, 0.0),
                            job_id=self.tenant_id)
        with self._lock:
            # A charge may have raced the rebuild; only publish a cache
            # entry for the version it was computed from.
            if self._version == version:
                self._pld_cached = composed
                self._pld_cache_version = version
        return composed

    def admission_spent_epsilon(self) -> float:
        """The spend number ``reserve()`` charges against. Naive mode:
        the bit-exact sum (the ledger of record). PLD mode:
        min(naive, pld * (1 + PLD_ADMISSION_HEADROOM)) - both are
        sound upper bounds on the true spend, so the min is too, and
        the naive clamp guarantees PLD admission is never STRICTER
        than naive admission."""
        if self.accounting_mode != "pld":
            return self.spent_epsilon()
        composed = self.pld_spent_epsilon()
        return min(self.spent_epsilon(),
                   composed * (1.0 + PLD_ADMISSION_HEADROOM))

    def max_job_seq(self) -> int:
        """Largest job-sequence number among this ledger's recorded and
        in-flight job ids (0 when none match the service format). A
        restarted service starts its sequence PAST this: its job ids
        must never collide with a prior run's persisted ids, or
        job_spent_epsilon()/reconciles() would merge two runs' records
        under one id and the per-job bit-exact reconciliation breaks."""
        with self._lock:
            job_ids = {r.get("job_id") for r in self._records}
            job_ids.update(self._reserved)
        best = 0
        for job_id in job_ids:
            match = _JOB_SEQ_RE.search(job_id or "")
            if match:
                best = max(best, int(match.group(1)))
        return best

    def remaining_epsilon(self) -> float:
        """Lifetime budget minus the ADMISSION spend (naive sum, or the
        PLD-composed bound in pld mode) minus in-flight reservations
        (never below 0)."""
        spent = self.admission_spent_epsilon()
        with self._lock:
            reserved = _fold(self._reserved.values())
        return max(self.lifetime_epsilon - spent - reserved, 0.0)

    def records(self) -> List[Dict[str, Any]]:
        """The ordered ledger trail (copies)."""
        with self._lock:
            return [dict(r) for r in self._records]

    def snapshot(self) -> Dict[str, Any]:
        # Dual-spend columns: spent_epsilon stays the bit-exact naive
        # sum (the ledger of record, what reconciliation checks);
        # pld_spent_epsilon is the composed rebuild of the same trail;
        # admission_spent_epsilon is what reserve() actually charges
        # against under the configured accounting_mode.
        pld_spent = self.pld_spent_epsilon()
        with self._lock:
            records = list(self._records)
            reserved = dict(self._reserved)
        sums = self._job_sums(records)
        spent = _fold(sums.values())
        admission = (spent if self.accounting_mode != "pld" else
                     min(spent, pld_spent * (1.0 + PLD_ADMISSION_HEADROOM)))
        return {
            "tenant_id": self.tenant_id,
            "lifetime_epsilon": self.lifetime_epsilon,
            "accounting_mode": self.accounting_mode,
            "spent_epsilon": spent,
            "pld_spent_epsilon": pld_spent,
            "admission_spent_epsilon": admission,
            "reserved_epsilon": _fold(reserved.values()),
            "remaining_epsilon": max(
                self.lifetime_epsilon - admission - _fold(reserved.values()),
                0.0),
            "jobs": sums,
            "mechanisms": len(records),
        }

    def reconciles(self, job_id: str, accountant) -> bool:
        """True iff the job's ledger spend equals the accountant's
        apportioned epsilon bit-exactly (the acceptance bar: the ledger
        of record IS the accountant's trail, not an approximation)."""
        return self.job_spent_epsilon(job_id) == accountant.spent_epsilon()

    # -- admission lifecycle ---------------------------------------------

    def reserve(self, job_id: str, epsilon: float) -> None:
        """Admission grant: reserves `epsilon` against the lifetime
        budget, or raises TenantBudgetExceededError - before any
        accountant or mechanism exists for the job.

        In pld accounting mode the spend charged here is the composed
        bound (see admission_spent_epsilon), rebuilt OUTSIDE the lock;
        the version re-check loops when a concurrent charge landed
        mid-rebuild, so a reservation never admits against a stale
        trail."""
        epsilon = float(epsilon)
        while True:
            with self._lock:
                version = self._version
            # Rebuild (or hit the version cache) before taking the
            # lock - composition must not run under it.
            spent = self.admission_spent_epsilon()
            with self._lock:
                if self._version != version:
                    # A charge landed mid-rebuild; the spend number is
                    # for a trail that no longer exists. Go again.
                    continue
                reserved = _fold(self._reserved.values())
                if spent + reserved + epsilon > self.lifetime_epsilon:
                    raise TenantBudgetExceededError(
                        f"tenant {self.tenant_id!r}: requested epsilon "
                        f"{epsilon} exceeds the remaining lifetime budget "
                        f"(lifetime {self.lifetime_epsilon}, recorded spend "
                        f"{spent} under {self.accounting_mode!r} "
                        f"accounting, in-flight reservations {reserved}). "
                        f"The job was refused before any mechanism "
                        f"registered; nothing was spent.")
                self._reserved[job_id] = epsilon
                return

    def release(self, job_id: str) -> None:
        """Drops a reservation without charging (job shed before it
        ran, or failed before any mechanism registered)."""
        with self._lock:
            self._reserved.pop(job_id, None)

    def charge(self, job_id: str,
               records: List[Dict[str, Any]]) -> float:
        """Converts the reservation into ledger records (the job's
        ordered odometer trail) and persists the full trail. Returns
        the job's recorded spend.

        IDEMPOTENT per job_id: a job the trail already contains is
        never appended again - the existing spend is returned and the
        reservation (if any) simply dropped. This is the no-double-
        spend guard for fleet operations: a migrated job re-charging
        its carried-over trail on the target pod, or a restarted
        service replaying a completion whose persist DID land before
        the kill, records each job exactly once."""
        stamped = []
        for r in records:
            row = dict(r)
            row["job_id"] = job_id
            stamped.append(row)
        with self._lock:
            self._reserved.pop(job_id, None)
            if any(r.get("job_id") == job_id for r in self._records):
                already = True
            else:
                already = False
                base = len(self._records)
                for i, row in enumerate(stamped):
                    row["seq"] = base + i
                self._records.extend(stamped)
                self._version += 1
        if already:
            logging.info(
                "tenant %r: job %r is already on the ledger trail - "
                "charge is idempotent, returning the recorded spend "
                "without appending (migrated/replayed completion).",
                self.tenant_id, job_id)
            return self.job_spent_epsilon(job_id)
        try:
            self._persist_latest()
        except journal_lib.StorageUnavailableError:
            # Fail-closed: the store refused the trail (ENOSPC, sick
            # fsync). A spend memory claims but disk denies would
            # resurrect on the next successful persist AND vanish on a
            # restart - so the in-memory append rolls back and the
            # charge fails. The caller (service) withholds the job's
            # result and sheds; nothing was released, so not charging
            # is privacy-sound.
            with self._lock:
                self._records = [r for r in self._records
                                 if r.get("job_id") != job_id]
                self._version += 1
            logging.warning(
                "tenant %r: job %r charge rolled back - the ledger "
                "store cannot persist the trail right now; the job's "
                "result is withheld and the reservation returns.",
                self.tenant_id, job_id)
            raise
        return self.job_spent_epsilon(job_id)

    def charge_forfeit(self, job_id: str, epsilon: float,
                       reason: str = "job_failed") -> None:
        """Charges the FULL admission grant of a failed job that had
        already registered mechanisms (its releases may have left the
        process; under-counting is never privacy-safe)."""
        from pipelinedp_tpu_torch.runtime import health as rt_health
        self.charge(job_id, [{
            "seq": 0,
            "job_id": job_id,
            "metric": "admission_grant_forfeit",
            "mechanism_kind": reason,
            "weight": 1.0,
            "sensitivity": 0.0,
            "count": 1,
            "process_index": rt_health._process_index(),
            "eps": float(epsilon),
            "delta": 0.0,
        }])

    # -- persistence -----------------------------------------------------

    def _persist_latest(self) -> None:
        """Persists the trail through the journal, OUTSIDE the lock
        (journal.put fsyncs - a blocking write must never run under a
        lock workers contend on). Two concurrent charges could persist
        out of order, so the version re-check loops until the trail
        this thread wrote is the newest - the last write always carries
        every record."""
        while True:
            with self._lock:
                version = self._version
                trail = [dict(r) for r in self._records]
            observability.persist_odometer(self._journal, self.tenant_id,
                                           records=trail)
            with self._lock:
                if self._version == version:
                    return
