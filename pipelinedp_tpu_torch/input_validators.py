"""Input validation helpers of the port (pipelinedp_tpu/input_validators.py:
the validators the aggregation paths, the streamed ingest and TorchBackend
call)."""

import math
import numbers


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
