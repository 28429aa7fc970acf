"""Runtime of the port (pipelinedp_tpu/runtime/, the parts ported so far):
the streamed ingest's overlapped encode and device row buffers
(pipeline.py), and what the multi-tenant service runs on: the metrics
registry (telemetry.py), span tracing (trace.py), per-job health
(health.py), the deadline watchdog (watchdog.py), the CRC-verified record
journal (journal.py), the budget odometer, memory watermarks and
Prometheus text (observability.py), and the lock-discipline declaration
(concurrency.py). The failure semantics of the meshed and blocked drivers:
deterministic fault injection (faults.py), retry, the OOM re-plan and
elastic meshes (retry.py), and the drivers' runtime entry (entry.py)."""

from pipelinedp_tpu_torch.runtime import entry
from pipelinedp_tpu_torch.runtime import faults
from pipelinedp_tpu_torch.runtime import health
from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.runtime import trace
from pipelinedp_tpu_torch.runtime.health import HealthState, JobHealth
from pipelinedp_tpu_torch.runtime.retry import (BlockOOMError,
                                                HostEvacuatedError,
                                                MeshDegradationError,
                                                RetryPolicy, announce_join,
                                                clear_joins,
                                                is_device_fatal,
                                                pending_joins, retry_call,
                                                run_with_degradation,
                                                run_with_mesh_degradation,
                                                run_with_mesh_elasticity)
from pipelinedp_tpu_torch.runtime.watchdog import BlockTimeoutError, Watchdog

__all__ = [
    "BlockOOMError",
    "BlockTimeoutError",
    "HealthState",
    "HostEvacuatedError",
    "JobHealth",
    "MeshDegradationError",
    "RetryPolicy",
    "Watchdog",
    "announce_join",
    "clear_joins",
    "entry",
    "faults",
    "health",
    "is_device_fatal",
    "pending_joins",
    "retry_call",
    "run_with_degradation",
    "run_with_mesh_degradation",
    "run_with_mesh_elasticity",
    "telemetry",
    "trace",
]
