"""Input validation helpers of the port (pipelinedp_tpu/input_validators.py:
the validators the dense aggregation path calls)."""

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
