"""The runtime entry of the meshed and blocked drivers.

Port of pipelinedp_tpu/runtime/entry.py. One decorator gives the four
meshed drivers (sharded_aggregate_arrays, sharded_select_partitions,
aggregate_blocked_sharded, select_partitions_blocked_sharded) and the two
unsharded blocked drivers one boundary for the runtime knobs:

  * validation: job_id, retry, elastic, elastic_grow and min_devices are
    checked here (input_validators), before any device work;
  * the job's health scope: the run executes inside health.job_scope, so
    telemetry counters and durations feed the job's record, and a raise
    marks it FAILED;
  * the retry budgets: the RetryPolicy's max_retries is scoped onto
    mesh.host_fetch (fetch_retry_scope), its max_total_retries onto every
    retry seam (retry.retry_budget_scope);
  * the elastic runner (meshed drivers only, the ones declared with a
    `fallback`): elastic=True wraps the run in retry.
    run_with_mesh_degradation, elastic_grow=True (which implies elastic)
    in run_with_mesh_elasticity. At one slot the fallback runs the
    unsharded driver on that slot's device.

journal=, timeout_s=, watchdog= and overlap= (the block journal, the
deadline watchdog and the overlapped drainer) are not ported yet and raise
NotImplementedError (ROADMAP.md Queue 1 step 4).
"""

import functools
import logging
import time
from typing import Callable, Optional

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch.runtime import health as rt_health
from pipelinedp_tpu_torch.runtime import retry as rt_retry
from pipelinedp_tpu_torch.runtime import telemetry as rt_telemetry
from pipelinedp_tpu_torch.runtime import trace as rt_trace


def _unported(kind: str, knob: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kind}: {knob}= is not ported yet (the block journal, the "
        f"deadline watchdog and the overlapped drainer are ROADMAP.md "
        f"Queue 1 step 4)")


def runtime_entry(kind: str, fallback: Optional[Callable] = None):
    """Decorator for a driver entry point (see the module docstring).

    kind: the default job id and the duration-stat name of the driver.
    fallback: meshed drivers only: fallback(mesh, args, kwargs, job_id)
        runs the unsharded equivalent on the one-slot `mesh`'s device
        (args are the driver's positional args, mesh first). Its presence
        marks the driver as meshed.
    """
    meshed = fallback is not None

    def deco(fn):

        @functools.wraps(fn)
        def wrapper(*args,
                    timeout_s: Optional[float] = None,
                    watchdog=None,
                    job_id: Optional[str] = None,
                    elastic: bool = False,
                    elastic_grow: bool = False,
                    min_devices: int = 1,
                    **kwargs):
            job = job_id or kind
            input_validators.validate_job_id(job, kind)
            if timeout_s is not None:
                raise _unported(kind, "timeout_s")
            if watchdog is not None:
                raise _unported(kind, "watchdog")
            if kwargs.pop("journal", None) is not None:
                raise _unported(kind, "journal")
            if kwargs.pop("overlap", False):
                raise _unported(kind, "overlap")
            if kwargs.get("retry") is not None:
                input_validators.validate_retry_policy(kwargs["retry"], kind)
            if "fused" in kwargs:
                input_validators.validate_fused_release(kwargs["fused"],
                                                        kind)
            input_validators.validate_elastic(elastic, kind)
            input_validators.validate_elastic_grow(elastic_grow, kind)
            input_validators.validate_min_devices(min_devices, kind)
            if elastic and not meshed:
                # The unsharded drivers have no mesh to degrade: the knob
                # is accepted (one backend config drives every route).
                logging.debug(
                    "%s: elastic=True ignored — the unsharded driver "
                    "already runs at the one-device floor.", kind)
            # Lazy: parallel imports runtime.
            from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
            fetch_retries = getattr(kwargs.get("retry"), "max_retries",
                                    None)
            total_retries = getattr(kwargs.get("retry"),
                                    "max_total_retries", None)
            t0 = time.perf_counter()
            with rt_health.job_scope(job), \
                    mesh_lib.fetch_retry_scope(fetch_retries), \
                    rt_retry.retry_budget_scope(total_retries), \
                    rt_trace.span(kind, job=job):
                if meshed and (elastic or elastic_grow):
                    elastic_runner = (rt_retry.run_with_mesh_elasticity
                                      if elastic_grow else
                                      rt_retry.run_with_mesh_degradation)
                    result = elastic_runner(
                        lambda m: fn(m, *args[1:], **kwargs),
                        args[0],
                        fallback=lambda m: fallback(m, args, kwargs, job),
                        min_devices=min_devices,
                        job_id=job)
                else:
                    result = fn(*args, **kwargs)
                rt_telemetry.record_duration(kind,
                                             time.perf_counter() - t0)
            return result

        return wrapper

    return deco
