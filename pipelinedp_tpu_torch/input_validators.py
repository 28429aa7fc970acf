"""Input validation helpers of the port (pipelinedp_tpu/input_validators.py:
the validators the aggregation paths, the streamed ingest, TorchBackend,
the runtime entry of the meshed and blocked drivers, the watchdog and the
multi-tenant service call)."""

import math
import numbers
import re

# Path separators, NUL and parent-directory references: a job or tenant id
# becomes a file-name component of the journal.
_JOB_ID_UNSAFE = re.compile(r"[/\\\x00]|(?:^|[/\\])\.\.(?:[/\\]|$)")


def validate_epsilon_delta(epsilon: float, delta: float, obj_name: str) -> None:
    """Validates that (epsilon, delta) is a well-formed DP budget.

    Raises:
        ValueError: epsilon is not a positive finite number or delta is not in
        [0, 1).
    """
    if not isinstance(epsilon, numbers.Number) or math.isnan(epsilon):
        raise ValueError(f"{obj_name}: epsilon must be a number, but "
                         f"{epsilon} given.")
    if epsilon <= 0 or math.isinf(epsilon):
        raise ValueError(f"{obj_name}: epsilon must be positive and finite, "
                         f"but epsilon={epsilon} given.")
    if not isinstance(delta, numbers.Number) or math.isnan(delta):
        raise ValueError(f"{obj_name}: delta must be a number, but "
                         f"{delta} given.")
    if delta < 0:
        raise ValueError(f"{obj_name}: delta must be non-negative, but "
                         f"delta={delta} given.")
    if delta >= 1:
        raise ValueError(f"{obj_name}: delta must be less than 1, but "
                         f"delta={delta} given.")


def validate_numeric_mode(numeric_mode, obj_name: str) -> None:
    """Validates the accumulation numeric mode: "fast" or "safe".

    Raises:
        ValueError: numeric_mode is not one of the two modes ("fast" is
        the historical bit-identical f32 segment reduction; "safe" runs
        the compensated (TwoSum hi/lo) scan — exact for integer-valued
        workloads to ~2^48 — and arms the release sentinel's overflow
        classification).
    """
    if numeric_mode not in ("fast", "safe"):
        raise ValueError(
            f"{obj_name}: numeric_mode must be 'fast' or 'safe', but "
            f"{numeric_mode!r} given — 'fast' keeps the bit-identical "
            f"historical accumulation, 'safe' switches the fused kernels "
            f"to compensated summation and fails closed (typed "
            f"NumericOverflowError, nothing released) on overflow.")


def validate_snap_grid_bits(snap_grid_bits, obj_name: str) -> None:
    """Validates the snapping-grid floor exponent: an integer in [-64, 64].

    Raises:
        ValueError: snap_grid_bits is not an integer in range (it floors
        the power-of-two snapping grid at 2**snap_grid_bits for the
        discrete/snapped mechanisms and the secure-noise tables; a
        float or a bool here is a bug, not a coarser grid).
    """
    if (not isinstance(snap_grid_bits, numbers.Number) or
            isinstance(snap_grid_bits, bool) or
            snap_grid_bits != int(snap_grid_bits) or
            not -64 <= snap_grid_bits <= 64):
        raise ValueError(
            f"{obj_name}: snap_grid_bits must be an integer in "
            f"[-64, 64], but {snap_grid_bits!r} given — releases snap to "
            f"the power-of-two grid max(mechanism grid, "
            f"2**snap_grid_bits), so the exponent must be a bounded "
            f"integer (None disables the floor).")


def validate_block_partitions(block_partitions, obj_name: str) -> None:
    """Validates the blocked route's partitions per block: a positive
    integer (a float or a bool here is a bug, not a block size)."""
    if (not isinstance(block_partitions, numbers.Integral) or
            isinstance(block_partitions, bool) or block_partitions <= 0):
        raise ValueError(
            f"{obj_name}: block_partitions must be a positive integer, but "
            f"{block_partitions!r} given (None: the blocked route's "
            f"default of 2^20 partitions a block).")


def validate_pipeline_depth(pipeline_depth, obj_name: str) -> None:
    """Validates the streaming-executor staging window: an integer >= 1.

    Raises:
        ValueError: pipeline_depth is not a positive integer (a depth of
        0 would deadlock the staging queue's backpressure semaphore
        before the first chunk).
    """
    if (not isinstance(pipeline_depth, numbers.Number) or
            isinstance(pipeline_depth, bool) or
            pipeline_depth != int(pipeline_depth) or pipeline_depth < 1):
        raise ValueError(
            f"{obj_name}: pipeline_depth must be an integer >= 1, but "
            f"{pipeline_depth!r} given — it bounds how many encoded "
            f"chunks the streaming ingest stages in flight (None takes "
            f"the shared PIPELINE_DEPTH default).")


def validate_encode_threads(encode_threads, obj_name: str) -> None:
    """Validates the host encode pool size: an integer >= 0.

    Raises:
        ValueError: encode_threads is not a non-negative integer (0 is
        the serial encode path; >= 1 enables the pipelined path with
        that many workers).
    """
    if (not isinstance(encode_threads, numbers.Number) or
            isinstance(encode_threads, bool) or
            encode_threads != int(encode_threads) or encode_threads < 0):
        raise ValueError(
            f"{obj_name}: encode_threads must be an integer >= 0, but "
            f"{encode_threads!r} given — 0 keeps the serial chunk "
            f"encode, >= 1 runs chunk factorization on that many host "
            f"threads feeding the staging queue (None auto-sizes).")


def validate_encode_mode(encode_mode, obj_name: str) -> None:
    """Validates the ingest encode mode: "host" or "hash_device".

    Raises:
        ValueError: encode_mode is not one of the two modes ("host" is
        the exact chunked vocabulary encoder; "hash_device" hashes keys
        on the host and factorizes on device, with partition-key decode
        deferred to DP-selected indices).
    """
    if encode_mode not in ("host", "hash_device"):
        raise ValueError(
            f"{obj_name}: encode_mode must be 'host' or 'hash_device', "
            f"but {encode_mode!r} given — 'host' runs the exact chunked "
            f"vocabulary encoder, 'hash_device' the on-device hash "
            f"factorization with decode-at-selected-indices (falls back "
            f"to 'host' on a detected hash collision).")


def validate_reshard(reshard, obj_name: str) -> None:
    """Validates a meshed backend's reshard mode: "auto", "host" or
    "device" (pipelinedp_tpu/pipeline_backend.py:550-552).

    Raises:
        ValueError: reshard is not one of the three modes.
    """
    if reshard not in ("auto", "host", "device"):
        raise ValueError(
            f"{obj_name}: reshard must be auto|host|device, got "
            f"{reshard!r} — 'auto' reshards device-resident rows on the "
            f"device and host rows by the host permutation, 'host' and "
            f"'device' force one path.")


def validate_pld_discretization(pld_discretization, obj_name: str) -> None:
    """Validates the PLD loss-grid discretization interval: a finite
    number in [1e-7, 0.5]. Finer than 1e-7 makes million-cell grids
    balloon past the composition engine's coarsening budget; coarser
    than 0.5 gives ceilings too loose to be useful.

    Raises:
        ValueError: pld_discretization is not a number in [1e-7, 0.5].
    """
    if (not isinstance(pld_discretization, numbers.Number) or
            isinstance(pld_discretization, bool) or
            math.isnan(pld_discretization) or
            not 1e-7 <= pld_discretization <= 0.5):
        raise ValueError(
            f"{obj_name}: pld_discretization must be a number in "
            f"[1e-7, 0.5], but {pld_discretization!r} given — it is "
            f"the privacy-loss grid interval; finer grids are more "
            f"accurate but cost memory and FFT time (pessimistic "
            f"ceiling rounding keeps every choice sound).")


def validate_timeout_s(timeout_s, obj_name: str) -> None:
    """Validates a watchdog deadline: a positive finite number of seconds.

    Raises:
        ValueError: timeout_s is not a positive finite number.
    """
    if (not isinstance(timeout_s, numbers.Number) or
            isinstance(timeout_s, bool) or math.isnan(timeout_s)):
        raise ValueError(f"{obj_name}: timeout_s must be a number of "
                         f"seconds, but {timeout_s!r} given.")
    if timeout_s <= 0 or math.isinf(timeout_s):
        raise ValueError(
            f"{obj_name}: timeout_s must be positive and finite, but "
            f"timeout_s={timeout_s} given - a non-positive deadline would "
            f"expire every block immediately; leave it None to disable "
            f"deadlines instead.")


def validate_job_id(job_id, obj_name: str) -> None:
    """Validates a journal job id: a non-empty, path-safe string.

    Raises:
        ValueError: job_id is empty, not a string, or contains path
        separators / parent-directory references / NUL (which the journal
        file-name sanitizer would fold together, silently colliding two
        different jobs' records).
    """
    if not isinstance(job_id, str):
        raise ValueError(f"{obj_name}: job_id must be a string, but "
                         f"{type(job_id).__name__} given.")
    if not job_id.strip():
        raise ValueError(f"{obj_name}: job_id must be non-empty — it keys "
                         f"this job's journal records; pass a stable "
                         f"identifier (or None to derive one from the "
                         f"kernel config).")
    if len(job_id) > 200:
        raise ValueError(f"{obj_name}: job_id is {len(job_id)} characters; "
                         f"the limit is 200 (it becomes a file-name "
                         f"component).")
    if _JOB_ID_UNSAFE.search(job_id) or job_id in (".", ".."):
        raise ValueError(
            f"{obj_name}: job_id {job_id!r} contains path separators or "
            f"directory references; journal records are files named after "
            f"the job id, so it must be path-safe.")


def validate_max_concurrent_jobs(max_concurrent_jobs, obj_name: str) -> None:
    """Validates the service worker-pool width: an integer >= 1.

    Raises:
        ValueError: max_concurrent_jobs is not a positive integer (it is
        the number of jobs the resident service executes concurrently -
        0 would admit work that no worker can ever run).
    """
    if (not isinstance(max_concurrent_jobs, numbers.Number) or
            isinstance(max_concurrent_jobs, bool) or
            max_concurrent_jobs != int(max_concurrent_jobs) or
            max_concurrent_jobs < 1):
        raise ValueError(
            f"{obj_name}: max_concurrent_jobs must be an integer >= 1, "
            f"but {max_concurrent_jobs!r} given - it sizes the service's "
            f"worker pool; submissions beyond it queue rather than "
            f"rejecting.")


def validate_tenant_budget_epsilon(tenant_budget_epsilon,
                                   obj_name: str) -> None:
    """Validates a tenant's lifetime epsilon budget: a positive number
    (math.inf = unlimited - the ledger still records spend).

    Raises:
        ValueError: tenant_budget_epsilon is not a positive number.
    """
    if (not isinstance(tenant_budget_epsilon, numbers.Number) or
            isinstance(tenant_budget_epsilon, bool) or
            math.isnan(tenant_budget_epsilon) or tenant_budget_epsilon <= 0):
        raise ValueError(
            f"{obj_name}: tenant_budget_epsilon must be a positive "
            f"number, but {tenant_budget_epsilon!r} given - it is the "
            f"lifetime epsilon a tenant's ledger may accumulate before "
            f"submissions are refused (math.inf disables the cap).")


def validate_queue_timeout_s(queue_timeout_s, obj_name: str) -> None:
    """Validates the admission-queue wait bound: a positive finite
    number of seconds.

    Raises:
        ValueError: queue_timeout_s is not a positive finite number (a
        non-positive bound would shed every queued job on dequeue).
    """
    if (not isinstance(queue_timeout_s, numbers.Number) or
            isinstance(queue_timeout_s, bool) or
            math.isnan(queue_timeout_s)):
        raise ValueError(f"{obj_name}: queue_timeout_s must be a number "
                         f"of seconds, but {queue_timeout_s!r} given.")
    if queue_timeout_s <= 0 or math.isinf(queue_timeout_s):
        raise ValueError(
            f"{obj_name}: queue_timeout_s must be positive and finite, "
            f"but queue_timeout_s={queue_timeout_s} given - jobs that "
            f"wait in the admission queue longer than this are shed "
            f"with a retry-after instead of running arbitrarily late.")


def validate_drain_timeout_s(drain_timeout_s, obj_name: str) -> None:
    """Validates the drain bound: a positive finite number of seconds.

    Raises:
        ValueError: drain_timeout_s is not a positive finite number (an
        unbounded drain would let one wedged job stall a rolling
        restart forever).
    """
    if (not isinstance(drain_timeout_s, numbers.Number) or
            isinstance(drain_timeout_s, bool) or
            math.isnan(drain_timeout_s)):
        raise ValueError(f"{obj_name}: drain_timeout_s must be a number "
                         f"of seconds, but {drain_timeout_s!r} given.")
    if drain_timeout_s <= 0 or math.isinf(drain_timeout_s):
        raise ValueError(
            f"{obj_name}: drain_timeout_s must be positive and finite, "
            f"but drain_timeout_s={drain_timeout_s} given - it bounds "
            f"how long drain() waits for running jobs before a "
            f"migration or rolling restart proceeds.")


def validate_deadline_s(deadline_s, obj_name: str) -> None:
    """Validates a job deadline: a positive finite number of seconds.

    Raises:
        ValueError: deadline_s is not a positive finite number (a
        non-positive deadline would cancel every job at dequeue; an
        infinite one is spelled deadline_s=None).
    """
    if (not isinstance(deadline_s, numbers.Number) or
            isinstance(deadline_s, bool) or
            math.isnan(deadline_s)):
        raise ValueError(f"{obj_name}: deadline_s must be a number "
                         f"of seconds, but {deadline_s!r} given.")
    if deadline_s <= 0 or math.isinf(deadline_s):
        raise ValueError(
            f"{obj_name}: deadline_s must be positive and finite, but "
            f"deadline_s={deadline_s} given - it bounds the job's total "
            f"submit-to-finish wall time (queue wait included); a job "
            f"past it settles CANCELLED with JobCancelledError, charges "
            f"nothing and releases its reservation. Use deadline_s=None "
            f"for no deadline.")


def validate_shed_watermark_fraction(shed_watermark_fraction,
                                     obj_name: str) -> None:
    """Validates the load-shed memory threshold: a number in (0, 1].

    Raises:
        ValueError: shed_watermark_fraction is not a number in (0, 1]
        (it is the fraction of the device-memory limit above which the
        service sheds new submissions instead of OOMing running jobs).
    """
    if (not isinstance(shed_watermark_fraction, numbers.Number) or
            isinstance(shed_watermark_fraction, bool) or
            math.isnan(shed_watermark_fraction) or
            not 0 < shed_watermark_fraction <= 1):
        raise ValueError(
            f"{obj_name}: shed_watermark_fraction must be a number in "
            f"(0, 1], but {shed_watermark_fraction!r} given - admissions "
            f"are shed when the live device-memory watermark exceeds "
            f"this fraction of the memory limit.")


def validate_batching(batching, obj_name: str) -> None:
    """Validates the megabatched-serving switch: a plain bool.

    Raises:
        ValueError: batching is not a bool (a truthy non-bool - say a
        window or a lane count passed by mistake - would silently route
        every job's release through the coalescing tier).
    """
    if not isinstance(batching, bool):
        raise ValueError(
            f"{obj_name}: batching must be a bool, but {batching!r} "
            f"given (True coalesces identical-spec concurrent jobs into "
            f"one lane-batched release launch; per-job results are "
            f"bit-identical either way).")


def validate_batch_window_ms(batch_window_ms, obj_name: str) -> None:
    """Validates the coalescing window: a positive finite number of
    milliseconds.

    Raises:
        ValueError: batch_window_ms is not a positive finite number (a
        non-positive window would close every batch before a second
        lane could join; an infinite one would park the first job of
        every spec forever).
    """
    if (not isinstance(batch_window_ms, numbers.Number) or
            isinstance(batch_window_ms, bool) or
            math.isnan(batch_window_ms)):
        raise ValueError(f"{obj_name}: batch_window_ms must be a number "
                         f"of milliseconds, but {batch_window_ms!r} "
                         f"given.")
    if batch_window_ms <= 0 or math.isinf(batch_window_ms):
        raise ValueError(
            f"{obj_name}: batch_window_ms must be positive and finite, "
            f"but batch_window_ms={batch_window_ms} given - it is how "
            f"long the first identical-spec job waits for others to "
            f"coalesce before launching (latency floor vs. batch "
            f"occupancy).")


def validate_max_batch_jobs(max_batch_jobs, obj_name: str) -> None:
    """Validates the batch lane cap: an integer >= 2.

    Raises:
        ValueError: max_batch_jobs is not an integer >= 2 (a 1-lane
        "batch" IS the solo path - the coalescer dispatches early once
        this many lanes joined, without waiting out the window).
    """
    if (not isinstance(max_batch_jobs, numbers.Number) or
            isinstance(max_batch_jobs, bool) or
            max_batch_jobs != int(max_batch_jobs) or max_batch_jobs < 2):
        raise ValueError(
            f"{obj_name}: max_batch_jobs must be an integer >= 2, but "
            f"{max_batch_jobs!r} given - it caps the lanes of one "
            f"megabatched launch; a full window dispatches immediately "
            f"(1 lane would just be the solo path with extra waiting).")


def validate_tenant_accounting(tenant_accounting, obj_name: str) -> None:
    """Validates the tenant-admission accounting mode: the string
    "naive" (admission charges the bit-exact left-to-right epsilon sum,
    the ledger-of-record) or "pld" (admission charges the PLD-composed
    epsilon rebuilt from the odometer trail, with a documented safety
    margin - the capacity multiplier).

    Raises:
        ValueError: tenant_accounting is not "naive" or "pld".
    """
    if tenant_accounting not in ("naive", "pld"):
        raise ValueError(
            f"{obj_name}: tenant_accounting must be 'naive' (admission "
            f"charges the bit-exact epsilon sum) or 'pld' (admission "
            f"charges the PLD-composed spend rebuilt from the odometer "
            f"trail), but {tenant_accounting!r} given.")


def validate_fused_release(fused_release, obj_name: str) -> None:
    """Validates the fused-release switch: a plain bool (the JAX package's
    validate_fused_release).

    Raises:
        ValueError: fused_release is not a bool (a truthy non-bool would
        quietly flip the dense routes between the compacting release and
        the unfused release with its host np.nonzero).
    """
    if not isinstance(fused_release, bool):
        raise ValueError(
            f"{obj_name}: fused_release must be a bool, but "
            f"{fused_release!r} given (True compacts the kept partitions "
            f"on the device, with an O(kept) drain; outputs are the same "
            f"either way).")


def validate_elastic(elastic, obj_name: str) -> None:
    """Validates the elastic mesh-degradation switch: a plain bool.

    Raises:
        ValueError: elastic is not a bool (a truthy non-bool — say a
        mesh or a device count passed by mistake — would silently enable
        or disable device-loss tolerance).
    """
    if not isinstance(elastic, bool):
        raise ValueError(f"{obj_name}: elastic must be a bool, but "
                         f"{elastic!r} given (True enables device-loss "
                         f"mesh degradation on the meshed drivers).")


def validate_elastic_grow(elastic_grow, obj_name: str) -> None:
    """Validates the elastic scale-UP switch: a plain bool.

    Raises:
        ValueError: elastic_grow is not a bool (a truthy non-bool — say
        a device list passed by mistake — would silently enable or
        disable join admission).
    """
    if not isinstance(elastic_grow, bool):
        raise ValueError(
            f"{obj_name}: elastic_grow must be a bool, but "
            f"{elastic_grow!r} given (True lets the meshed drivers admit "
            f"announced join candidates at block boundaries and grow the "
            f"mesh — shrink tolerance included, so it implies elastic).")


def validate_min_devices(min_devices, obj_name: str) -> None:
    """Validates the elastic degradation floor: an integer >= 1.

    Raises:
        ValueError: min_devices is not a positive integer.
    """
    if (not isinstance(min_devices, numbers.Number) or
            isinstance(min_devices, bool) or
            min_devices != int(min_devices) or min_devices < 1):
        raise ValueError(
            f"{obj_name}: min_devices must be an integer >= 1, but "
            f"{min_devices!r} given — it is the device count below which "
            f"an elastic run refuses to degrade further and fails with a "
            f"resume pointer instead.")


def validate_retry_policy(retry, obj_name: str) -> None:
    """Validates a runtime.RetryPolicy-shaped object's budgets.

    Raises:
        ValueError: negative max_retries, or negative/NaN delays.
    """
    max_retries = getattr(retry, "max_retries", None)
    if (not isinstance(max_retries, numbers.Number) or
            isinstance(max_retries, bool) or max_retries < 0 or
            max_retries != int(max_retries)):
        raise ValueError(
            f"{obj_name}: retry.max_retries must be a non-negative "
            f"integer, but {max_retries!r} given (0 disables retries; "
            f"use None for the retry= knob itself to take the default "
            f"policy).")
    for field in ("base_delay", "max_delay"):
        v = getattr(retry, field, 0.0)
        if (not isinstance(v, numbers.Number) or isinstance(v, bool) or
                math.isnan(v) or v < 0):
            raise ValueError(f"{obj_name}: retry.{field} must be a "
                             f"non-negative number of seconds, but "
                             f"{v!r} given.")
    budget = getattr(retry, "max_total_retries", None)
    if budget is not None and (
            not isinstance(budget, numbers.Number) or
            isinstance(budget, bool) or budget < 0 or
            budget != int(budget)):
        raise ValueError(
            f"{obj_name}: retry.max_total_retries must be None (no "
            f"per-job budget) or a non-negative integer, but "
            f"{budget!r} given — it caps the job's TOTAL transient "
            f"retries across every seam (dispatch retry, reshard "
            f"fallback, host fetch), so composed faults cannot spiral "
            f"one job into a retry storm.")
