"""The port's generic backend vocabulary (pipelinedp_tpu_torch/
pipeline_backend.py LocalBackend, sampling_utils, contribution_bounders)
against the JAX package's LocalBackend on the same inputs.

Bounds stated here: every operation's output equal (==) to the JAX
package's, in the same order; sample_fixed_per_key under one seed samples
the same values; ValueSampler's keep decisions equal.
"""

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import contribution_bounders as jax_bounders
from pipelinedp_tpu import pipeline_backend as jax_backend
from pipelinedp_tpu import sampling_utils as jax_sampling
from pipelinedp_tpu_torch import contribution_bounders
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch import sampling_utils

pytestmark = pytest.mark.torch_port

ROWS = [(i % 7, f"k{i % 4}", float(i)) for i in range(40)]
KEYED = [(f"k{i % 5}", i) for i in range(30)]


def both(seed=None):
    return jax_backend.LocalBackend(seed=seed), \
        pipeline_backend.LocalBackend(seed=seed)


def add_one(x):
    return x + 1


# (name, input, args): each runs on both backends with the same arguments.
OPERATIONS = [
    ("map", list(range(10)), (add_one,)),
    ("map_with_side_inputs", [1, 2, 3],
     (lambda x, a, b: x + sum(a) * len(b), [[1, 2], (5, 6, 7)])),
    ("flat_map", [[1, 2], [], [3]], (lambda xs: [x * 2 for x in xs],)),
    ("flat_map_with_side_inputs", [1, 2],
     (lambda x, s: [x] * len(s), [[0, 0, 0]])),
    ("map_tuple", [(1, 2), (3, 4)], (lambda a, b: a * 10 + b,)),
    ("map_values", KEYED, (lambda v: v * v,)),
    ("group_by_key", KEYED, ()),
    ("filter", list(range(20)), (lambda x: x % 3 == 0,)),
    ("filter_by_key", KEYED, (["k1", "k3", "absent"],)),
    ("filter_by_key", KEYED, ({"k0"},)),
    ("filter_by_key", KEYED, ([],)),
    ("keys", KEYED, ()),
    ("values", KEYED, ()),
    ("count_per_element", ["a", "b", "a", "c", "a"], ()),
    ("sum_per_key", KEYED, ()),
    ("reduce_per_key", KEYED, (max,)),
    ("distinct", [3, 1, 3, 2, 1], ()),
    ("to_list", [1, 2, 3], ()),
]


@pytest.mark.parametrize("name,data,args", OPERATIONS,
                         ids=[f"{op[0]}-{i}" for i, op in
                              enumerate(OPERATIONS)])
def test_operation_matches_jax(name, data, args):
    jax_b, port_b = both()
    want = list(getattr(jax_b, name)(list(data), *args, "stage"))
    got = list(getattr(port_b, name)(list(data), *args, "stage"))
    if name == "distinct":
        want, got = sorted(want), sorted(got)
    assert got == want


def test_combine_accumulators_per_key_matches_jax():

    class Summing:

        def merge_accumulators(self, a, b):
            return a + b

    jax_b, port_b = both()
    data = [(k, [v]) for k, v in KEYED]
    assert list(port_b.combine_accumulators_per_key(data, Summing())) == \
        list(jax_b.combine_accumulators_per_key(data, Summing()))


def test_flatten_and_multi_transformable():
    jax_b, port_b = both()
    cols = ([1, 2], [], (3,))
    assert list(port_b.flatten(cols)) == list(jax_b.flatten(cols))
    col = port_b.to_multi_transformable_collection(x for x in range(4))
    assert list(col) == list(col) == [0, 1, 2, 3]
    assert port_b.to_collection([5], None, "s") == [5]


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_sample_fixed_per_key_under_a_seed(seed, n):
    jax_b, port_b = both(seed)
    data = [(f"k{i % 3}", i) for i in range(40)]
    got = list(port_b.sample_fixed_per_key(data, n))
    assert got == list(jax_b.sample_fixed_per_key(data, n))
    assert all(len(v) == min(n, 14 if k == "k0" else 13) for k, v in got)


def test_operations_are_lazy():
    calls = []

    def fn(x):
        calls.append(x)
        return x

    backend = pipeline_backend.LocalBackend()
    outs = [backend.map([1, 2], fn), backend.filter([1, 2], fn),
            backend.flat_map([[1]], lambda x: fn(x)),
            backend.map_values([(1, 2)], fn),
            backend.group_by_key(backend.map([(1, 2)], fn)),
            backend.reduce_per_key(backend.map([(1, 2)], fn), max)]
    assert calls == []
    for out in outs:
        list(out)
    assert calls


def test_generators_run_once_and_lists_again():
    backend = pipeline_backend.LocalBackend()
    col = backend.map(range(3), add_one)
    assert list(col) == [1, 2, 3]
    assert list(col) == []  # a generator, as the JAX package's
    again = backend.to_multi_transformable_collection(
        backend.map(range(3), add_one))
    assert list(backend.map(again, add_one)) == [2, 3, 4]
    assert list(backend.map(again, add_one)) == [2, 3, 4]


def test_unique_labels_as_jax():
    for suffix in ("", "s"):
        ours = pipeline_backend.UniqueLabelsGenerator(suffix)
        theirs = jax_backend.UniqueLabelsGenerator(suffix)
        for label in ("a", "a", "", "a", "b", ""):
            assert ours.unique(label) == theirs.unique(label)


def test_value_sampler_keep_decisions_equal():
    keys = ([f"pk{i}" for i in range(300)] + list(range(300)) +
            [(i, "x") for i in range(100)] + [None, 1.5, b"raw"])
    for rate in (0.0, 0.1, 0.5, 0.93, 1.0):
        ours = sampling_utils.ValueSampler(rate)
        theirs = jax_sampling.ValueSampler(rate)
        assert [ours.keep(k) for k in keys] == [theirs.keep(k) for k in keys]
    assert sampling_utils._compute_64bit_hash("pk") == \
        jax_sampling._compute_64bit_hash("pk")


def test_injectable_generators_as_jax():
    a = list(range(20))
    assert sampling_utils.choose_from_list_without_replacement(
        a, 5, np.random.default_rng(3)) == \
        jax_sampling.choose_from_list_without_replacement(
            a, 5, np.random.default_rng(3))
    assert sampling_utils.choose_from_list_without_replacement(a[:3], 5) == \
        a[:3]
    assert [sampling_utils.keep_with_probability(0.4,
                                                 np.random.default_rng(s))
            for s in range(30)] == \
        [jax_sampling.keep_with_probability(0.4, np.random.default_rng(s))
         for s in range(30)]


def test_collect_values_per_partition_key_as_jax():
    data = [(1, [("a", 1), ("b", 2), ("a", 3)]), (2, [("c", 4)])]
    jax_b, port_b = both()
    assert list(contribution_bounders.
                collect_values_per_partition_key_per_privacy_id(
                    data, port_b)) == list(
        jax_bounders.collect_values_per_partition_key_per_privacy_id(
            data, jax_b))


def test_torch_backend_is_a_local_backend_with_the_vocabulary():
    backend = tdp.TorchBackend(device="cpu", noise_seed=5)
    assert isinstance(backend, pipeline_backend.LocalBackend)
    assert isinstance(backend, pipeline_backend.PipelineBackend)
    jax_b = pdp.TPUBackend(noise_seed=5)
    data = [(f"k{i % 3}", i) for i in range(30)]
    assert list(backend.sample_fixed_per_key(data, 4)) == \
        list(jax_b.sample_fixed_per_key(data, 4))
    assert list(backend.group_by_key(backend.map(ROWS, lambda r: (r[1],
                                                                  r[0])))) \
        == list(jax_b.group_by_key(jax_b.map(ROWS, lambda r: (r[1], r[0]))))
    assert backend.device == torch.device("cpu")


def test_dp_engine_refuses_the_plain_local_backend():
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1, total_delta=1e-6)
    with pytest.raises(TypeError, match="item 14"):
        tdp.DPEngine(acc, pipeline_backend.LocalBackend())
    tdp.DPEngine(acc, tdp.TorchBackend(device="cpu"))
