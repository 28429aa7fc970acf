"""Privacy budget accounting for DP pipelines.

Port of pipelinedp_tpu/budget_accounting.py: the two-phase protocol,
NaiveBudgetAccountant and PLDBudgetAccountant.

  1. Graph build: every mechanism calls request_budget() and receives a *lazy*
     MechanismSpec whose eps/delta/stddev are unset.
  2. Driver calls compute_budgets() once; eps/delta (Naive) or the minimal
     noise stddev (PLD) are filled into the same shared MechanismSpec
     objects.

The port's kernels take the filled values as launch arguments when the
lazy result is first iterated, so compute_budgets() may run after the
aggregation graph is built. PLD accounting composes on the host
(accounting/compose.py, numpy float64).
"""

import abc
import collections
import contextlib
import logging
import math
from dataclasses import dataclass
from typing import Optional

import pipelinedp_tpu_torch.aggregate_params as agg_params
from pipelinedp_tpu_torch import input_validators


def _pld_naive_fallback_eps() -> float:
    """Total epsilon above which the PLD accountant splits naively: the PLD
    grid's finite-loss cap (accounting/pld.py _MAX_FINITE_LOSS), past which
    composed-epsilon queries saturate."""
    from pipelinedp_tpu_torch.accounting import pld as pldlib
    return pldlib._MAX_FINITE_LOSS


@dataclass
class MechanismSpec:
    """Parameters of one DP mechanism, filled in by compute_budgets().

    MechanismType defines the kind of noise distribution.
    _noise_standard_deviation is the minimized noise standard deviation
    (normalized by sensitivity for PLD accounting).
    (_eps, _delta) are the (eps, delta)-DP parameters.
    """
    mechanism_type: agg_params.MechanismType
    _noise_standard_deviation: Optional[float] = None
    _eps: Optional[float] = None
    _delta: Optional[float] = None
    _count: int = 1

    @property
    def noise_standard_deviation(self):
        if self._noise_standard_deviation is None:
            raise AssertionError(
                "Noise standard deviation is not calculated yet.")
        return self._noise_standard_deviation

    @property
    def eps(self):
        if self._eps is None:
            raise AssertionError("Privacy budget is not calculated yet.")
        return self._eps

    @property
    def delta(self):
        if self._delta is None:
            raise AssertionError("Privacy budget is not calculated yet.")
        return self._delta

    @property
    def count(self):
        """The number of times the mechanism is going to be applied."""
        return self._count

    def set_eps_delta(self, eps: float, delta: Optional[float]) -> None:
        if eps is None:
            raise AssertionError("eps must not be None.")
        self._eps = eps
        self._delta = delta

    def set_noise_standard_deviation(self, stddev: float) -> None:
        self._noise_standard_deviation = stddev

    def use_delta(self) -> bool:
        return self.mechanism_type != agg_params.MechanismType.LAPLACE

    @property
    def standard_deviation_is_set(self) -> bool:
        return self._noise_standard_deviation is not None


@dataclass
class MechanismSpecInternal:
    """Sensitivity and weight, not exposed through MechanismSpec."""
    sensitivity: float
    weight: float
    mechanism_spec: MechanismSpec


Budget = collections.namedtuple("Budget", ["epsilon", "delta"])


class BudgetAccountant(abc.ABC):
    """Base class for budget accountants."""

    def __init__(self, total_epsilon: float, total_delta: float,
                 num_aggregations: Optional[int],
                 aggregation_weights: Optional[list]):
        input_validators.validate_epsilon_delta(total_epsilon, total_delta,
                                                "BudgetAccountant")
        self._total_epsilon = total_epsilon
        self._total_delta = total_delta

        self._scopes_stack = []
        self._mechanisms = []
        self._finalized = False
        if num_aggregations is not None and aggregation_weights is not None:
            raise ValueError(
                "'num_aggregations' and 'aggregation_weights' can not be set "
                "simultaneously.\nIf you wish all aggregations in the pipeline "
                "to have equal budgets, specify the total number of "
                "aggregations with 'num_aggregations'.\nIf you wish to have "
                "different budgets for different aggregations, specify them "
                "with 'aggregation_weights'")
        if num_aggregations is not None and num_aggregations <= 0:
            raise ValueError(f"'num_aggregations'={num_aggregations}, but it "
                             f"has to be positive.")
        self._expected_num_aggregations = num_aggregations
        self._expected_aggregation_weights = aggregation_weights
        self._actual_aggregation_weights = []

    @abc.abstractmethod
    def request_budget(
            self,
            mechanism_type: agg_params.MechanismType,
            sensitivity: float = 1,
            weight: float = 1,
            count: int = 1,
            noise_standard_deviation: Optional[float] = None) -> MechanismSpec:
        pass

    @abc.abstractmethod
    def compute_budgets(self):
        pass

    def scope(self, weight: float) -> 'BudgetAccountantScope':
        """A `with` scope whose mechanisms consume `weight` of the parent
        budget; mechanism weights are normalized on scope exit."""
        return BudgetAccountantScope(self, weight)

    @property
    def total_epsilon(self) -> float:
        """The (eps, delta)-DP budget this ledger apportions — the
        admission grant a multi-tenant session accounts against."""
        return self._total_epsilon

    @property
    def total_delta(self) -> float:
        return self._total_delta

    @property
    def mechanism_count(self) -> int:
        """Number of mechanisms registered in the ledger.

        The re-execution invariant of the fault-tolerant runtime is stated
        in terms of this count: mechanisms register at graph-build time
        only, so retried/resumed/degraded execution must leave it
        unchanged — composition accounting is only sound if a retry never
        multiplies registrations (a re-registration would double-spend
        epsilon for the same release).
        """
        return len(self._mechanisms)

    @contextlib.contextmanager
    def no_new_mechanisms(self, context: str = "execution"):
        """Scope asserting that no mechanism registers inside it.

        The runtime wraps device execution — including every retry,
        journal resume and OOM re-plan — in this guard: a registration
        there means some code path re-requested budget for a release that
        was already accounted, i.e. a silent epsilon double-spend. The
        guard turns that privacy bug into a loud failure.
        """
        before = len(self._mechanisms)
        yield
        grew = len(self._mechanisms) - before
        if grew:
            raise AssertionError(
                f"{grew} mechanism(s) registered with the BudgetAccountant "
                f"during {context}. Mechanisms must register at graph-build "
                f"time only; a registration during execution (e.g. from a "
                f"retried or re-planned block) would double-spend the "
                f"privacy budget.")

    def _compute_budget_for_aggregation(self, weight: float) -> Budget:
        """Returns the naive-composition budget of one aggregation (used for
        annotations only). Mutates internal aggregation bookkeeping; call only
        from DPEngine API functions."""
        self._actual_aggregation_weights.append(weight)
        if self._expected_num_aggregations:
            return Budget(self._total_epsilon / self._expected_num_aggregations,
                          self._total_delta / self._expected_num_aggregations)
        if self._expected_aggregation_weights:
            ratio = weight / sum(self._expected_aggregation_weights)
            return Budget(self._total_epsilon * ratio,
                          self._total_delta * ratio)
        return None

    def _check_aggregation_restrictions(self):
        if self._expected_num_aggregations:
            actual = len(self._actual_aggregation_weights)
            if actual != self._expected_num_aggregations:
                raise ValueError(
                    f"'num_aggregations'({self._expected_num_aggregations}) in "
                    f"the constructor of BudgetAccountant is different from the"
                    f" actual number of aggregations in the pipeline"
                    f"({actual}). If 'num_aggregations' is specified, you must "
                    f"have that many aggregations in the pipeline.")
            weights = self._actual_aggregation_weights
            if not all(w == 1 for w in weights):
                raise ValueError(
                    f"Aggregation weights = {weights}. If 'num_aggregations' is"
                    f" set in the constructor of BudgetAccountant, all "
                    f"aggregation weights have to be 1. If you'd like to have "
                    f"different weights use 'aggregation_weights'.")
        if self._expected_aggregation_weights:
            actual = self._actual_aggregation_weights
            expected = self._expected_aggregation_weights
            if len(actual) != len(expected):
                raise ValueError(
                    f"Length of 'aggregation_weights' in the constructor of "
                    f"BudgetAccountant is {len(expected)} != {len(actual)} the "
                    f"actual number of aggregations.")
            if not all(w1 == w2 for w1, w2 in zip(actual, expected)):
                raise ValueError(
                    f"'aggregation_weights' in the constructor "
                    f"({expected}) is different from actual aggregation "
                    f"weights ({actual}). If 'aggregation_weights' is "
                    f"specified, they must be the same.")

    def _register_mechanism(
            self, mechanism: MechanismSpecInternal) -> MechanismSpecInternal:
        self._mechanisms.append(mechanism)
        # A timeline mark and one ordered odometer record per registration
        # (runtime/observability.py): the record's eps / delta resolve
        # through the shared spec once compute_budgets fills it.
        from pipelinedp_tpu_torch.runtime import observability, telemetry
        telemetry.record(
            "budget_registrations",
            mechanism_type=str(
                getattr(mechanism.mechanism_spec, "mechanism_type", "")))
        observability.record_mechanism(self, mechanism)
        for scope in self._scopes_stack:
            scope.mechanisms.append(mechanism)
        return mechanism

    def spent_epsilon(self) -> float:
        """Epsilon apportioned so far: every computed mechanism's eps share
        times its count, folded left to right in registration order (0.0
        before compute_budgets). The odometer's records and a tenant
        ledger fold the same terms in the same order, so the three agree
        bit for bit. An explicit loop, not sum(): from Python 3.12 on,
        sum() of floats is compensated and can differ from this fold in
        the last bit."""
        total = 0.0
        for m in self._mechanisms:
            if m.mechanism_spec._eps is not None:
                total += m.mechanism_spec._eps * m.mechanism_spec.count
        return total

    def _enter_scope(self, scope):
        self._scopes_stack.append(scope)

    def _exit_scope(self):
        self._scopes_stack.pop()

    def _finalize(self):
        if self._finalized:
            raise Exception("compute_budgets can not be called twice.")
        self._finalized = True


class BudgetAccountantScope:
    """Scope that normalizes its mechanisms' weights to sum to scope weight."""

    def __init__(self, accountant: BudgetAccountant, weight: float):
        self.weight = weight
        self.accountant = accountant
        self.mechanisms = []

    def __enter__(self):
        self.accountant._enter_scope(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.accountant._exit_scope()
        self._normalise_mechanism_weights()

    def _normalise_mechanism_weights(self):
        if not self.mechanisms:
            return
        total_weight = sum(m.weight for m in self.mechanisms)
        factor = self.weight / total_weight
        for mechanism in self.mechanisms:
            mechanism.weight *= factor


class NaiveBudgetAccountant(BudgetAccountant):
    """Naive (basic) composition: eps split proportionally to weight across
    all mechanisms; delta split across delta-consuming mechanisms."""

    def __init__(self,
                 total_epsilon: float,
                 total_delta: float,
                 num_aggregations: Optional[int] = None,
                 aggregation_weights: Optional[list] = None):
        super().__init__(total_epsilon, total_delta, num_aggregations,
                         aggregation_weights)

    def request_budget(
            self,
            mechanism_type: agg_params.MechanismType,
            sensitivity: float = 1,
            weight: float = 1,
            count: int = 1,
            noise_standard_deviation: Optional[float] = None) -> MechanismSpec:
        if self._finalized:
            raise Exception(
                "request_budget() is called after compute_budgets(). "
                "Please ensure that compute_budgets() is called after DP "
                "aggregations.")
        if noise_standard_deviation is not None:
            raise NotImplementedError(
                "Noise standard deviation is not supported in request_budget.")
        if (mechanism_type == agg_params.MechanismType.GAUSSIAN and
                self._total_delta == 0):
            raise ValueError("The Gaussian mechanism requires that the "
                             "pipeline delta is greater than 0")
        mechanism_spec = MechanismSpec(mechanism_type=mechanism_type,
                                       _count=count)
        self._register_mechanism(
            MechanismSpecInternal(mechanism_spec=mechanism_spec,
                                  sensitivity=sensitivity,
                                  weight=weight))
        return mechanism_spec

    def compute_budgets(self):
        """Fills eps/delta into every previously returned MechanismSpec."""
        self._check_aggregation_restrictions()
        self._finalize()

        if not self._mechanisms:
            logging.warning("No budgets were requested.")
            return
        if self._scopes_stack:
            raise Exception(
                "Cannot call compute_budgets from within a budget scope.")

        total_weight_eps = total_weight_delta = 0
        for mechanism in self._mechanisms:
            total_weight_eps += mechanism.weight * mechanism.mechanism_spec.count
            if mechanism.mechanism_spec.use_delta():
                total_weight_delta += (mechanism.weight *
                                       mechanism.mechanism_spec.count)

        for mechanism in self._mechanisms:
            eps = delta = 0
            if total_weight_eps:
                eps = self._total_epsilon * mechanism.weight / total_weight_eps
            if mechanism.mechanism_spec.use_delta():
                if total_weight_delta:
                    delta = (self._total_delta * mechanism.weight /
                             total_weight_delta)
            mechanism.mechanism_spec.set_eps_delta(eps, delta)


class PLDBudgetAccountant(BudgetAccountant):
    """Privacy-loss-distribution accounting.

    Binary-searches the minimal normalized noise stddev such that the
    one-shot composition of all mechanisms' PLDs (accounting/compose.py,
    the host path) satisfies (total_eps, total_delta).
    """

    def __init__(self,
                 total_epsilon: float,
                 total_delta: float,
                 pld_discretization: float = 1e-4,
                 num_aggregations: Optional[int] = None,
                 aggregation_weights: Optional[list] = None):
        super().__init__(total_epsilon, total_delta, num_aggregations,
                         aggregation_weights)
        input_validators.validate_pld_discretization(
            pld_discretization, "PLDBudgetAccountant")
        self.minimum_noise_std = None
        self._pld_discretization = pld_discretization

    def request_budget(
            self,
            mechanism_type: agg_params.MechanismType,
            sensitivity: float = 1,
            weight: float = 1,
            count: int = 1,
            noise_standard_deviation: Optional[float] = None) -> MechanismSpec:
        if self._finalized:
            raise Exception(
                "request_budget() is called after compute_budgets(). "
                "Please ensure that compute_budgets() is called after DP "
                "aggregations.")
        if count != 1 or noise_standard_deviation is not None:
            raise NotImplementedError(
                "Count and noise standard deviation have not been implemented "
                "yet.")
        if (mechanism_type == agg_params.MechanismType.GAUSSIAN and
                self._total_delta == 0):
            raise AssertionError("The Gaussian mechanism requires that the "
                                 "pipeline delta is greater than 0")
        mechanism_spec = MechanismSpec(mechanism_type=mechanism_type)
        self._register_mechanism(
            MechanismSpecInternal(mechanism_spec=mechanism_spec,
                                  sensitivity=sensitivity,
                                  weight=weight))
        return mechanism_spec

    def compute_budgets(self):
        """Sets _noise_standard_deviation on every MechanismSpec (and
        eps/delta for GENERIC mechanisms)."""
        self._check_aggregation_restrictions()
        self._finalize()

        if not self._mechanisms:
            logging.warning("No budgets were requested.")
            return
        if self._scopes_stack:
            raise Exception(
                "Cannot call compute_budgets from within a budget scope.")

        if self._total_epsilon >= _pld_naive_fallback_eps():
            # Beyond the PLD finite-loss cap composition saturates; at such
            # budgets split naively (basic composition is sound), which
            # keeps the huge-epsilon determinism check working.
            self._compute_budgets_naive_fallback()
            return
        if self._total_delta == 0:
            sum_weights = sum(m.weight for m in self._mechanisms)
            minimum_noise_std = sum_weights / self._total_epsilon * math.sqrt(2)
        else:
            minimum_noise_std = self._find_minimum_noise_std()

        self.minimum_noise_std = minimum_noise_std
        for mechanism in self._mechanisms:
            mechanism_noise_std = (mechanism.sensitivity * minimum_noise_std /
                                   mechanism.weight)
            mechanism.mechanism_spec._noise_standard_deviation = (
                mechanism_noise_std)
            if (mechanism.mechanism_spec.mechanism_type ==
                    agg_params.MechanismType.GENERIC):
                epsilon_0 = math.sqrt(2) / mechanism_noise_std
                delta_0 = epsilon_0 / self._total_epsilon * self._total_delta
                mechanism.mechanism_spec.set_eps_delta(epsilon_0, delta_0)

    def _compute_budgets_naive_fallback(self):
        """Proportional eps/delta split with per-mechanism calibration:
        eps_i = eps * w_i / sum(w), delta split among delta-consuming
        mechanisms, each noise std from the single-mechanism calibration."""
        from pipelinedp_tpu_torch import dp_computations

        sum_weights = sum(m.weight for m in self._mechanisms)
        delta_users = [
            m for m in self._mechanisms
            if m.mechanism_spec.mechanism_type in (
                agg_params.MechanismType.GAUSSIAN,
                agg_params.MechanismType.GENERIC)
        ]
        max_std = 0.0
        for mechanism in self._mechanisms:
            eps_i = self._total_epsilon * mechanism.weight / sum_weights
            delta_i = (self._total_delta * mechanism.weight /
                       sum(m.weight for m in delta_users)
                       if mechanism in delta_users else 0.0)
            mech_type = mechanism.mechanism_spec.mechanism_type
            if mech_type == agg_params.MechanismType.GAUSSIAN:
                std = dp_computations.gaussian_sigma(eps_i, delta_i,
                                                     mechanism.sensitivity)
            elif mech_type == agg_params.MechanismType.GENERIC:
                std = math.sqrt(2) / eps_i * mechanism.sensitivity
                mechanism.mechanism_spec.set_eps_delta(eps_i, delta_i)
            else:
                std = math.sqrt(2) / eps_i * mechanism.sensitivity
            mechanism.mechanism_spec._noise_standard_deviation = std
            max_std = max(max_std, std * mechanism.weight /
                          mechanism.sensitivity)
        self.minimum_noise_std = max_std

    def _find_minimum_noise_std(self) -> float:
        """Binary search for the smallest noise std satisfying the budget."""
        threshold = 1e-4
        maximum_noise_std = self._calculate_max_noise_std()
        low, high = 0, maximum_noise_std
        while low + threshold < high:
            mid = (high - low) / 2 + low
            pld = self._compose_distributions(mid)
            pld_epsilon = pld.get_epsilon_for_delta(self._total_delta)
            if pld_epsilon <= self._total_epsilon:
                high = mid
            else:
                low = mid
        return high

    def _calculate_max_noise_std(self) -> float:
        """Doubles an upper bound until the composed epsilon fits."""
        max_noise_std = 1
        pld_epsilon = self._total_epsilon + 1
        while pld_epsilon > self._total_epsilon:
            max_noise_std *= 2
            pld = self._compose_distributions(max_noise_std)
            pld_epsilon = pld.get_epsilon_for_delta(self._total_delta)
        return max_noise_std

    def _compose_distributions(self, noise_standard_deviation: float):
        """Composes the PLDs of all registered mechanisms at the given
        normalized noise std: identical mechanisms (same kind and
        normalized scale) form one spectrum-power group, their pmfs come
        from the shared spectrum cache, and the set composes in one shot
        on the host."""
        from pipelinedp_tpu_torch.accounting import compose as compose_engine

        groups = collections.OrderedDict()
        for spec in self._mechanisms:
            mech_type = spec.mechanism_spec.mechanism_type
            if mech_type == agg_params.MechanismType.LAPLACE:
                # Laplace parameter b = std / sqrt(2).
                key = (str(mech_type),
                       spec.sensitivity * noise_standard_deviation /
                       math.sqrt(2) / spec.weight)
            elif mech_type == agg_params.MechanismType.GAUSSIAN:
                key = (str(mech_type),
                       spec.sensitivity * noise_standard_deviation /
                       spec.weight)
            elif mech_type == agg_params.MechanismType.GENERIC:
                # The generic mechanism's noise std read as a Laplace
                # calibration; delta proportional to epsilon.
                epsilon_0 = math.sqrt(2) / noise_standard_deviation
                delta_0 = epsilon_0 / self._total_epsilon * self._total_delta
                key = (str(mech_type), (epsilon_0, delta_0))
            else:
                raise ValueError(f"Unsupported mechanism {mech_type}")
            groups[key] = groups.get(key, 0) + 1
        plds = [
            compose_engine.CACHE.get(kind, scale, 1.0,
                                     self._pld_discretization)
            for kind, scale in groups
        ]
        return compose_engine.compose_plds(plds, list(groups.values()),
                                           device=False)
