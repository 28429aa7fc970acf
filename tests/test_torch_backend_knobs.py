"""TorchBackend(large_partition_threshold=None) and
TorchBackend(max_partitions=...) against TPUBackend's on the CPU, float64
(JAX under x64), numpy-seeded rows.

Bounds stated here: the same kept partitions (and selected keys, in order)
as TPUBackend with the same knobs and seed; values within 1e-9 relative
(max(1, |x|)), the bound of test_torch_engine (float64 noise words agree to
the ulp bounds of test_torch_threefry). A max_partitions below the data's
partition count raises the same ValueError on both.
"""

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp

pytestmark = pytest.mark.torch_port

N_PARTS = 20


def rows(seed=3, n=1200, n_ids=300):
    rng = np.random.default_rng(seed)
    parts = (rng.integers(0, N_PARTS, n)**2) // N_PARTS
    return list(zip(rng.integers(0, n_ids, n).tolist(), parts.tolist(),
                    rng.uniform(0, 5, n).tolist()))


ROWS = rows()
EXTRACTORS = dict(privacy_id_extractor=lambda r: r[0],
                  partition_extractor=lambda r: r[1],
                  value_extractor=lambda r: r[2])


def backend(mod, **kw):
    return (pdp.TPUBackend(noise_seed=7, **kw) if mod is pdp else
            tdp.TorchBackend(device="cpu", noise_seed=7, dtype=torch.float64,
                             **kw))


def aggregate(mod, public, **kw):
    acc = mod.NaiveBudgetAccountant(total_epsilon=3.0, total_delta=1e-6)
    params = mod.AggregateParams(
        metrics=[mod.Metrics.COUNT, mod.Metrics.SUM,
                 mod.Metrics.PRIVACY_ID_COUNT],
        noise_kind=mod.NoiseKind.LAPLACE, max_partitions_contributed=3,
        max_contributions_per_partition=2, min_value=0.0, max_value=5.0)
    res = mod.DPEngine(acc, backend(mod, **kw)).aggregate(
        ROWS, params, mod.DataExtractors(**EXTRACTORS),
        list(range(N_PARTS)) if public else None)
    acc.compute_budgets()
    return dict(res)


def select(mod, **kw):
    acc = mod.NaiveBudgetAccountant(total_epsilon=3.0, total_delta=1e-6)
    res = mod.DPEngine(acc, backend(mod, **kw)).select_partitions(
        ROWS, mod.SelectPartitionsParams(max_partitions_contributed=3),
        mod.DataExtractors(**EXTRACTORS))
    acc.compute_budgets()
    return list(res)


def assert_close(got, want):
    assert got and set(got) == set(want)
    for key in want:
        for a, b in zip(got[key], want[key]):
            assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)


KNOBS = {
    "no_threshold": dict(large_partition_threshold=None),
    "max_partitions_dense": dict(max_partitions=48),
    # A wide result width sends a 20-partition dataset onto the blocked
    # route, as in the JAX package.
    "max_partitions_blocked": dict(max_partitions=48,
                                   large_partition_threshold=16,
                                   block_partitions=16),
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("public", [False, True])
def test_aggregate_matches_tpu_backend(knobs, public):
    assert_close(aggregate(tdp, public, **KNOBS[knobs]),
                 aggregate(pdp, public, **KNOBS[knobs]))


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_select_matches_tpu_backend(knobs):
    got = select(tdp, **KNOBS[knobs])
    assert got and got == select(pdp, **KNOBS[knobs])


@pytest.mark.parametrize("entry", ["aggregate", "select"])
def test_max_partitions_below_the_data_raises(entry):
    def run(mod):
        if entry == "aggregate":
            return aggregate(mod, False, max_partitions=5)
        return select(mod, max_partitions=5)

    with pytest.raises(ValueError) as got:
        run(tdp)
    with pytest.raises(ValueError) as want:
        run(pdp)
    assert "is smaller than the" in str(got.value)
    assert str(got.value).replace("TorchBackend", "TPUBackend") == \
        str(want.value)
