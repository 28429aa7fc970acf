"""Multi-tenant DP-aggregation service (pipelinedp_tpu/service/).

  * DPAggregationService: one TorchBackend for the service's lifetime;
    submit(tenant_id, spec, source) -> JobHandle runs jobs on a bounded
    worker pool, each under its own job_scope and backend view.
  * TenantLedger: persisted per-tenant budget ledgers (the odometer
    records as the ledger of record, journal-durable across restarts);
    admission refuses jobs whose epsilon exceeds the tenant's lifetime
    budget before any mechanism registers.
  * Admission control: priority FIFO up to max_concurrent_jobs, queueing
    beyond, load shedding by the memory watermark and the queue wait.
  * Megabatched serving (batching=True): BatchCoalescer runs concurrent
    identical-spec jobs as lanes of ONE lane-batched release on the card,
    each lane equal to its solo run bit for bit.
"""

from pipelinedp_tpu_torch.service.batching import BatchCoalescer
from pipelinedp_tpu_torch.service.errors import (
    AdmissionRejectedError,
    JobCancelledError,
    TenantBudgetExceededError,
)
from pipelinedp_tpu_torch.service.ledger import TenantLedger
from pipelinedp_tpu_torch.service.service import (
    DPAggregationService,
    JobHandle,
    JobSpec,
    JobStatus,
)

__all__ = [
    "AdmissionRejectedError",
    "BatchCoalescer",
    "DPAggregationService",
    "JobCancelledError",
    "JobHandle",
    "JobSpec",
    "JobStatus",
    "TenantBudgetExceededError",
    "TenantLedger",
]
