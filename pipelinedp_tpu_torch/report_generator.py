"""Explain Computation reports.

A human-readable narration of one DP aggregation: input parameters plus the
ordered computation-graph stages. Stage descriptions may be callables so that
values that only exist after BudgetAccountant.compute_budgets() (eps/delta,
noise stddev) resolve lazily at report() time.

Port of pipelinedp_tpu/report_generator.py, unchanged in behaviour.
"""

from typing import Callable, Optional, Union

from pipelinedp_tpu_torch import aggregate_params as agg


class ReportGenerator:
    """Collects ordered stage descriptions for one DP aggregation."""

    def __init__(self,
                 params,
                 method_name: str,
                 is_public_partition: Optional[bool] = None):
        self._params_str = None
        if params:
            self._params_str = agg.parameters_to_readable_string(
                params, is_public_partition)
        self._method_name = method_name
        self._stages = []

    def add_stage(self, stage_description: Union[Callable, str]) -> None:
        """Adds a stage description; may be a Callable resolved at report()
        time (for budget-dependent text)."""
        self._stages.append(stage_description)

    def report(self) -> str:
        """Renders the report text."""
        if not self._params_str:
            return ""
        result = [f"DPEngine method: {self._method_name}"]
        result.append(self._params_str)
        result.append("Computation graph:")
        for i, stage in enumerate(self._stages):
            text = stage() if callable(stage) else stage
            result.append(f" {i + 1}. {text}")
        return "\n".join(result)


class ExplainComputationReport:
    """Out-param container holding the report for one DP aggregation."""

    def __init__(self):
        self._report_generator = None

    def _set_report_generator(self, report_generator: ReportGenerator):
        self._report_generator = report_generator

    def text(self) -> str:
        """Returns the report text.

        Raises:
            ValueError: called before the aggregation, or before
              BudgetAccountant.compute_budgets().
        """
        if self._report_generator is None:
            raise ValueError("The report_generator is not set.\nWas this object"
                             " passed as an argument to DP aggregation method?")
        try:
            return self._report_generator.report()
        except Exception as e:  # noqa: BLE001 - wrap-and-reraise: any stage-formatting failure becomes one actionable ValueError
            raise ValueError(
                "Explain computation report failed to be generated.\n"
                "Was BudgetAccountant.compute_budgets() called?") from e
