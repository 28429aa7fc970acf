"""PLD accounting through the port's DPEngine (PLDBudgetAccountant on
TorchBackend) against the JAX package's (on TPUBackend), on the CPU.

Bounds stated here:
  * PLDBudgetAccountant: minimum_noise_std, every spec's noise std and a
    GENERIC spec's (eps, delta) are equal (==) to the JAX package's for the
    same requests (the same host arithmetic and composition).
  * the mechanisms built from std-given specs: std, noise parameter,
    sensitivity and grid equal (==).
  * released partitions: identical sets; released values within 1e-9
    relative (max(1, |x|)) of TPUBackend's (the float64 noise words agree
    to the ulp bounds of test_torch_threefry), exactly equal with
    secure_noise=True (values on their grids).
"""

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import dp_computations as jax_dpc
from pipelinedp_tpu_torch import dp_computations as dpc

pytestmark = pytest.mark.torch_port

_D = 1e-3

# (mechanism type names, sensitivity, weight) of each request.
REQUESTS = {
    "laplace": [("LAPLACE", 1.0, 1.0), ("LAPLACE", 2.0, 1.0),
                ("LAPLACE", 1.0, 3.0)],
    "gaussian": [("GAUSSIAN", 1.0, 1.0), ("GAUSSIAN", 1.0, 1.0),
                 ("GAUSSIAN", 3.0, 2.0)],
    "mixed_generic": [("GAUSSIAN", 1.0, 1.0), ("LAPLACE", 1.0, 1.0),
                      ("GENERIC", 1.0, 1.0)],
}


def accountant_run(mod, requests, eps, delta, scoped=False):
    acc = mod.PLDBudgetAccountant(eps, delta, pld_discretization=_D)
    specs = []
    if scoped:
        with acc.scope(weight=0.5):
            for kind, sens, weight in requests:
                specs.append(acc.request_budget(
                    getattr(mod.MechanismType, kind), sensitivity=sens,
                    weight=weight))
    else:
        for kind, sens, weight in requests:
            specs.append(acc.request_budget(getattr(mod.MechanismType, kind),
                                            sensitivity=sens, weight=weight))
    acc.compute_budgets()
    return acc.minimum_noise_std, [
        (s._noise_standard_deviation, s._eps, s._delta) for s in specs]


@pytest.mark.parametrize("name", sorted(REQUESTS))
@pytest.mark.parametrize("eps,delta", [(1.0, 1e-6), (3.0, 1e-5)])
def test_accountant_stds_equal_jax(name, eps, delta):
    got = accountant_run(tdp, REQUESTS[name], eps, delta)
    assert got == accountant_run(pdp, REQUESTS[name], eps, delta)
    assert got[0] > 0


def test_accountant_scoped_weights_equal_jax():
    requests = REQUESTS["mixed_generic"]
    assert accountant_run(tdp, requests, 1.0, 1e-6, scoped=True) == \
        accountant_run(pdp, requests, 1.0, 1e-6, scoped=True)


def test_accountant_delta_zero_closed_form_equals_jax():
    requests = REQUESTS["laplace"]
    got = accountant_run(tdp, requests, 2.0, 0.0)
    assert got == accountant_run(pdp, requests, 2.0, 0.0)
    assert got[0] == sum(w for _, _, w in requests) / 2.0 * np.sqrt(2)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_accountant_huge_eps_naive_fallback_equals_jax(name):
    got = accountant_run(tdp, REQUESTS[name], 1e5, 1e-6)
    assert got == accountant_run(pdp, REQUESTS[name], 1e5, 1e-6)


def test_accountant_refusals_as_jax():
    for mod in (pdp, tdp):
        acc = mod.PLDBudgetAccountant(1.0, 0.0, pld_discretization=_D)
        with pytest.raises(AssertionError, match="delta is greater than 0"):
            acc.request_budget(mod.MechanismType.GAUSSIAN)
        with pytest.raises(NotImplementedError):
            acc.request_budget(mod.MechanismType.LAPLACE, count=2)
        with pytest.raises(NotImplementedError):
            acc.request_budget(mod.MechanismType.LAPLACE,
                               noise_standard_deviation=1.0)
        acc.request_budget(mod.MechanismType.LAPLACE)
        acc.compute_budgets()
        with pytest.raises(Exception, match="after compute_budgets"):
            acc.request_budget(mod.MechanismType.LAPLACE)
        with pytest.raises(ValueError, match="pld_discretization"):
            mod.PLDBudgetAccountant(1.0, 1e-6, pld_discretization=0.9)
        # The naive accountant keeps refusing a given noise std, as the JAX
        # package's does.
        with pytest.raises(NotImplementedError):
            mod.NaiveBudgetAccountant(1.0, 1e-6).request_budget(
                mod.MechanismType.LAPLACE, noise_standard_deviation=1.0)


def test_budget_is_satisfied_at_the_minimum_std():
    acc = tdp.PLDBudgetAccountant(1.0, 1e-6, pld_discretization=_D)
    specs = [acc.request_budget(tdp.MechanismType.GAUSSIAN) for _ in range(4)]
    acc.compute_budgets()
    composed = acc._compose_distributions(acc.minimum_noise_std)
    assert composed.get_epsilon_for_delta(1e-6) <= 1.0 + 1e-6
    assert all(s.noise_standard_deviation == specs[0].noise_standard_deviation
               for s in specs)
    assert all(s.standard_deviation_is_set for s in specs)


def std_spec(mod, kind, std):
    spec = mod.budget_accounting.MechanismSpec(getattr(mod.MechanismType,
                                                       kind))
    spec.set_noise_standard_deviation(std)
    return spec


@pytest.mark.parametrize("kind", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("std", [0.37, 2.5])
def test_mechanisms_from_std_specs_equal_jax(kind, std):
    sens = dict(l0=3, linf=2.0)
    got = dpc.create_additive_mechanism(std_spec(tdp, kind, std),
                                        dpc.Sensitivities(**sens))
    want = jax_dpc.create_additive_mechanism(std_spec(pdp, kind, std),
                                             jax_dpc.Sensitivities(**sens))
    assert (got.std, got.noise_parameter, got.sensitivity) == \
        (want.std, want.noise_parameter, want.sensitivity)
    mean = dpc.create_mean_mechanism(
        1.5, std_spec(tdp, kind, std), dpc.Sensitivities(**sens),
        std_spec(tdp, kind, std / 2), dpc.Sensitivities(l0=3, linf=4.0))
    jmean = jax_dpc.create_mean_mechanism(
        1.5, std_spec(pdp, kind, std), jax_dpc.Sensitivities(**sens),
        std_spec(pdp, kind, std / 2), jax_dpc.Sensitivities(l0=3, linf=4.0))
    assert mean.sum_mechanism.std == jmean.sum_mechanism.std
    assert mean.count_mechanism.std == jmean.count_mechanism.std


@pytest.mark.parametrize("kind,integer", [("LAPLACE", True),
                                          ("LAPLACE", False),
                                          ("GAUSSIAN", False)])
def test_discrete_mechanisms_from_std_specs_equal_jax(kind, integer):
    key = np.array([3, 9], dtype=np.uint32)
    got = dpc.create_discrete_mechanism(
        std_spec(tdp, kind, 1.7), dpc.Sensitivities(l0=2, linf=1.0),
        value_is_integer=integer, snap_grid_bits=-4, key=key)
    want = jax_dpc.create_discrete_mechanism(
        std_spec(pdp, kind, 1.7), jax_dpc.Sensitivities(l0=2, linf=1.0),
        value_is_integer=integer, snap_grid_bits=-4,
        key=np.array([3, 9], dtype=np.uint32))
    assert type(got).__name__ == type(want).__name__
    assert (got.std, got.noise_parameter, got.sensitivity, got.grid) == \
        (want.std, want.noise_parameter, want.sensitivity, want.grid)
    assert [got.add_noise(10.0) for _ in range(5)] == \
        [want.add_noise(10.0) for _ in range(5)]


def rows(seed=0, n=8000, n_ids=2000, n_parts=40):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_ids, n).tolist()
    parts = (rng.random(n)**2 * n_parts).astype(int).tolist()
    values = rng.uniform(0, 5, n).tolist()
    return list(zip(users, parts, values))


ROWS = rows()
N_PARTS = 40


def release(mod, case):
    metrics, noise, public, backend_kw = CASES[case]
    if mod is pdp:
        backend = pdp.TPUBackend(noise_seed=7, **backend_kw)
    else:
        backend = tdp.TorchBackend(device="cpu", noise_seed=7,
                                   dtype=torch.float64, **backend_kw)
    acc = mod.PLDBudgetAccountant(2.0, 1e-6, pld_discretization=_D)
    params = mod.AggregateParams(
        metrics=[getattr(mod.Metrics, m) for m in metrics],
        noise_kind=getattr(mod.NoiseKind, noise),
        max_partitions_contributed=3, max_contributions_per_partition=2,
        min_value=0.0, max_value=5.0)
    res = mod.DPEngine(acc, backend).aggregate(
        ROWS, params, mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                         partition_extractor=lambda r: r[1],
                                         value_extractor=lambda r: r[2]),
        list(range(N_PARTS)) if public else None)
    acc.compute_budgets()
    return dict(res), acc.minimum_noise_std


BLOCKED = dict(large_partition_threshold=4, block_partitions=8)
CASES = {
    "count_sum_laplace_public": (("COUNT", "SUM"), "LAPLACE", True, {}),
    "mean_gaussian_public": (("COUNT", "SUM", "MEAN"), "GAUSSIAN", True, {}),
    "laplace_private": (("COUNT", "SUM", "PRIVACY_ID_COUNT"), "LAPLACE",
                        False, {}),
    "mean_gaussian_private": (("MEAN", "COUNT"), "GAUSSIAN", False, {}),
    "blocked_private": (("COUNT", "SUM"), "LAPLACE", False, BLOCKED),
    "blocked_public_gaussian": (("COUNT", "MEAN"), "GAUSSIAN", True,
                                BLOCKED),
    "secure_public": (("COUNT", "SUM", "MEAN"), "LAPLACE", True,
                      dict(secure_noise=True)),
    "secure_private_gaussian": (("COUNT", "SUM"), "GAUSSIAN", False,
                                dict(secure_noise=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_aggregate_under_pld_matches_tpu_backend(case):
    got, got_std = release(tdp, case)
    want, want_std = release(pdp, case)
    assert got_std == want_std
    assert set(got) == set(want)
    assert 0 < len(want) <= N_PARTS
    if not CASES[case][2]:
        assert len(want) < N_PARTS  # selection dropped some partitions
    exact = bool(CASES[case][3].get("secure_noise"))
    for key, metrics in want.items():
        assert got[key]._fields == metrics._fields
        for a, b in zip(got[key], metrics):
            if exact:
                assert a == b, (key, a, b)
            else:
                assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)


def test_engine_huge_eps_under_pld_releases_exact_aggregates():
    # eps 1e7 takes the naive fallback; the release is the exact count.
    want = {}
    for u, p, v in ROWS:
        want.setdefault(p, []).append(v)
    acc = tdp.PLDBudgetAccountant(1e7, 1e-6, pld_discretization=_D)
    res = tdp.DPEngine(acc, tdp.TorchBackend(
        device="cpu", noise_seed=1, dtype=torch.float64)).aggregate(
            ROWS, tdp.AggregateParams(metrics=[tdp.Metrics.COUNT],
                                      max_partitions_contributed=N_PARTS,
                                      max_contributions_per_partition=100),
            tdp.DataExtractors(privacy_id_extractor=lambda r: r[0],
                               partition_extractor=lambda r: r[1],
                               value_extractor=lambda r: r[2]),
            list(range(N_PARTS)))
    acc.compute_budgets()
    for key, metrics in dict(res).items():
        assert abs(metrics.count - len(want.get(key, []))) < 0.1


@pytest.mark.parametrize("strategy", ["TRUNCATED_GEOMETRIC",
                                      "LAPLACE_THRESHOLDING",
                                      "GAUSSIAN_THRESHOLDING"])
def test_select_partitions_under_pld_matches_jax(strategy):
    kept = {}
    for mod in (pdp, tdp):
        backend = (pdp.TPUBackend(noise_seed=5) if mod is pdp else
                   tdp.TorchBackend(device="cpu", noise_seed=5,
                                    dtype=torch.float64))
        acc = mod.PLDBudgetAccountant(0.3, 1e-6, pld_discretization=_D)
        res = mod.DPEngine(acc, backend).select_partitions(
            ROWS, mod.SelectPartitionsParams(
                max_partitions_contributed=2,
                partition_selection_strategy=getattr(
                    mod.PartitionSelectionStrategy, strategy)),
            mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                               partition_extractor=lambda r: r[1]))
        acc.compute_budgets()
        kept[mod.__name__] = sorted(res)
    assert kept["pipelinedp_tpu_torch"] == kept["pipelinedp_tpu"]
    assert 0 < len(kept["pipelinedp_tpu"]) < N_PARTS


@pytest.mark.parametrize("metric", ["VARIANCE", "PERCENTILE", "VECTOR_SUM"])
def test_unsupported_metrics_under_pld_raise_as_jax(metric):
    for mod in (pdp, tdp):
        m = (mod.Metrics.PERCENTILE(50) if metric == "PERCENTILE" else
             getattr(mod.Metrics, metric))
        kw = (dict(vector_size=2, vector_max_norm=1.0,
                   vector_norm_kind=mod.NormKind.L2)
              if metric == "VECTOR_SUM" else dict(min_value=0.0,
                                                  max_value=1.0))
        params = mod.AggregateParams(metrics=[m], max_partitions_contributed=1,
                                     max_contributions_per_partition=1, **kw)
        backend = (pdp.TPUBackend() if mod is pdp else
                   tdp.TorchBackend(device="cpu"))
        engine = mod.DPEngine(mod.PLDBudgetAccountant(1.0, 1e-6), backend)
        with pytest.raises(NotImplementedError, match="PLD"):
            engine.aggregate([(1, 1, 0.0)], params, mod.DataExtractors(
                privacy_id_extractor=lambda r: r[0],
                partition_extractor=lambda r: r[1],
                value_extractor=lambda r: r[2]))
