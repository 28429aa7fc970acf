"""Typed admission-control errors of the multi-tenant service
(pipelinedp_tpu/service/errors.py).

Separated from service.py so the ledger (which refuses over-budget
grants) and the service (which sheds load) can both raise them without
an import cycle.
"""

from typing import Optional


class AdmissionRejectedError(RuntimeError):
    """A submission was refused at the service boundary.

    Raised BEFORE any engine, accountant or mechanism exists for the
    job, so a rejected submission provably spends nothing. Load sheds
    carry ``retry_after_s`` - the backoff after which the condition
    (memory watermark, queue congestion) may have cleared; a tenant
    budget refusal carries None, because waiting cannot refill a
    lifetime budget.
    """

    def __init__(self, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class TenantBudgetExceededError(AdmissionRejectedError):
    """The tenant's lifetime epsilon budget cannot cover the requested
    grant (cumulative ledger spend + in-flight reservations + requested
    epsilon > tenant_budget_epsilon). Terminal for the tenant until an
    operator raises the budget - retry_after_s is always None."""

    def __init__(self, message: str):
        super().__init__(message, retry_after_s=None)


class JobCancelledError(RuntimeError):
    """The job was cancelled (JobHandle.cancel()) or its ``deadline_s``
    elapsed before completion.

    A cancelled job charges NOTHING: its result is withheld at the
    service boundary (never handed to the caller), so no release left
    the process and returning the reservation is privacy-sound - even
    when mechanisms had already registered. ``reason`` is "cancelled"
    or "deadline"."""

    def __init__(self, message: str, reason: str = "cancelled"):
        super().__init__(message)
        self.reason = reason
