"""The port's unfused dense release, TorchBackend(fused_release=False), on
the CPU: the fused chain without the kept-first compaction (no C6), its
dense [P] outputs and keep vector decoded by np.nonzero, unmeshed and
meshed, against the port's fused release and TPUBackend(fused_release=
False) (D = 2 of the conftest's 8 host devices when meshed); inputs from
numpy seeds, float64.

Bounds stated here:
  * unfused against fused in the port: the same partitions and values
    (==): the same kernels on the same inputs, only the compaction and
    the drain differ;
  * against the JAX package's unfused release: the same partitions,
    values within 1e-9 of max(1, |x|) (tests/test_torch_engine.py's and
    tests/test_torch_sharded.py's bound).
"""

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.parallel import reshard as jax_reshard
from pipelinedp_tpu_torch import executor, input_validators, kernels
from pipelinedp_tpu_torch.parallel import reshard
from pipelinedp_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.torch_port

F64 = torch.float64
SEED = 23
N_PARTS = 12
PUBLIC = list(range(N_PARTS))


@pytest.fixture(autouse=True)
def _fresh():
    reshard.reset_capacity_cache()
    jax_reshard.reset_capacity_cache()


def make_rows(n=1500, users=200, vector=0, seed=4):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = rng.integers(0, N_PARTS, n)
    if vector:
        values = rng.uniform(-2, 2, (n, vector))
        return [(int(u), int(p), v) for u, p, v in zip(pid, pk, values)]
    values = rng.uniform(0, 5, n)
    return [(int(u), int(p), float(v)) for u, p, v in zip(pid, pk, values)]


ROWS = make_rows()
VECTOR_ROWS = make_rows(vector=3)


def backend(mod, fused, n_shards=None, **kw):
    kw.update(noise_seed=SEED, fused_release=fused)
    if mod is pdp:
        if n_shards:
            kw["mesh"] = jax_make_mesh(n_devices=n_shards)
        return pdp.TPUBackend(**kw)
    if n_shards:
        kw["mesh"] = make_mesh(["cpu"] * n_shards)
    return tdp.TorchBackend(device="cpu", dtype=F64, **kw)


def extractors(mod):
    return mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                              partition_extractor=lambda r: r[1],
                              value_extractor=lambda r: r[2])


SPECS = {
    "private_laplace": (("COUNT", "SUM", "PRIVACY_ID_COUNT"), False, {}),
    "public_gaussian": (("COUNT", "MEAN", "VARIANCE"), True,
                        dict(noise_kind="GAUSSIAN")),
    "percentile": (("COUNT", ("PERCENTILE", 50), ("PERCENTILE", 90)), True,
                   {}),
    "vector_sum": (("VECTOR_SUM",), True,
                   dict(vector_size=3, vector_max_norm=2.0,
                        vector_norm_kind="L2", min_value=None,
                        max_value=None)),
}


def aggregate(mod, be, spec, rows=None):
    metrics, public, kw = SPECS[spec]
    fields = dict(max_partitions_contributed=3,
                  max_contributions_per_partition=2, min_value=0.0,
                  max_value=5.0)
    fields.update(kw)
    for name, enum in (("noise_kind", "NoiseKind"),
                       ("vector_norm_kind", "NormKind")):
        if name in fields:
            fields[name] = getattr(getattr(mod, enum), fields[name])
    metric_list = [getattr(mod.Metrics, m) if isinstance(m, str) else
                   getattr(mod.Metrics, m[0])(m[1]) for m in metrics]
    if rows is None:
        rows = VECTOR_ROWS if spec == "vector_sum" else ROWS
    acc = mod.NaiveBudgetAccountant(total_epsilon=4.0, total_delta=1e-5)
    res = mod.DPEngine(acc, be).aggregate(
        rows, mod.AggregateParams(metrics=metric_list, **fields),
        extractors(mod), PUBLIC if public else None)
    acc.compute_budgets()
    return dict(res)


def select(mod, be, rows=ROWS):
    acc = mod.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-5)
    res = mod.DPEngine(acc, be).select_partitions(
        rows, mod.SelectPartitionsParams(max_partitions_contributed=3),
        extractors(mod))
    acc.compute_budgets()
    return list(res)


def assert_equal_release(got, want):
    assert got and list(got) == list(want)
    for key in want:
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_close(got, want):
    assert got and set(got) == set(want)
    for key in want:
        for a, b in zip(got[key], want[key]):
            assert np.all(np.abs(np.asarray(a) - np.asarray(b)) <=
                          1e-9 * np.maximum(1.0, np.abs(np.asarray(b)))), (
                              key, a, b)


@pytest.mark.parametrize("n_shards", [None, 2])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_unfused_equals_fused(spec, n_shards, monkeypatch):
    """The same partitions and values, and no compaction launched."""
    fused = aggregate(tdp, backend(tdp, True, n_shards), spec)
    with monkeypatch.context() as m:
        m.setattr(kernels, "compact_kept", _refuse_compaction)
        unfused = aggregate(tdp, backend(tdp, False, n_shards), spec)
    assert_equal_release(unfused, fused)


def _refuse_compaction(*args, **kwargs):
    raise AssertionError("the unfused release ran the compaction (C6)")


@pytest.mark.parametrize("n_shards", [None, 2])
def test_unfused_select_equals_fused(n_shards, monkeypatch):
    fused = select(tdp, backend(tdp, True, n_shards))
    with monkeypatch.context() as m:
        m.setattr(kernels, "compact_kept", _refuse_compaction)
        unfused = select(tdp, backend(tdp, False, n_shards))
    assert fused and unfused == fused


@pytest.mark.parametrize("n_shards", [None, 2])
@pytest.mark.parametrize("spec", ["private_laplace", "percentile"])
def test_unfused_equals_the_jax_unfused_release(spec, n_shards):
    got = aggregate(tdp, backend(tdp, False, n_shards), spec)
    want = aggregate(pdp, backend(pdp, False, n_shards), spec)
    assert_close(got, want)


@pytest.mark.parametrize("n_shards", [None, 2])
def test_unfused_select_equals_the_jax_unfused_select(n_shards):
    got = select(tdp, backend(tdp, False, n_shards))
    want = select(pdp, backend(pdp, False, n_shards))
    assert got and sorted(got) == sorted(want)


def test_unfused_kernels_return_the_dense_columns():
    """executor.aggregate_kernel: the dense outputs and keep vector whose
    np.nonzero(keep) prefix is the fused release's kept-first columns."""
    enc = tdp.columnar.encode(ROWS, extractors(tdp), PUBLIC)
    params = tdp.AggregateParams(
        metrics=[tdp.Metrics.COUNT, tdp.Metrics.SUM],
        max_partitions_contributed=3, max_contributions_per_partition=2,
        min_value=0.0, max_value=5.0)
    acc = tdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-5)
    compound = tdp.combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    cfg = executor.make_kernel_config(params, compound, N_PARTS, False, None)
    rows = executor.padded_to_device(*executor.pad_rows(enc), "cpu", F64)
    args = (*rows, *executor.kernel_scalars(params),
            executor.compute_noise_stds(compound), np.array([0, 5],
                                                            np.uint32), cfg)
    outputs, keep, flags = executor.aggregate_kernel(*args)
    n_kept, order, kept_first, fused_flags = \
        executor.aggregate_release_kernel(*args)
    ids = np.nonzero(keep.numpy())[0]
    assert len(ids) == int(n_kept) == N_PARTS
    np.testing.assert_array_equal(ids, order[:len(ids)].numpy())
    for name, col in outputs.items():
        assert col.shape[0] == N_PARTS
        np.testing.assert_array_equal(col.numpy()[ids],
                                      kept_first[name][:len(ids)].numpy())
    assert int(flags) == int(fused_flags)


def test_unfused_release_is_refused_to_the_coalescer():
    """The megabatched service's interceptor is offered fused launches
    only; an unfused job runs solo (JAX executor.py:1377-1387)."""
    offered = []

    def interceptor(launch):
        offered.append(launch.kind)

    with executor.launch_interceptor(interceptor):
        aggregate(tdp, backend(tdp, False), "private_laplace")
        select(tdp, backend(tdp, False))
    assert offered == []
    with executor.launch_interceptor(interceptor):
        aggregate(tdp, backend(tdp, True), "private_laplace")
        select(tdp, backend(tdp, True))
    assert offered == ["aggregate", "select"]


def test_unfused_sentinel_fails_closed():
    """The flag word gates the unfused release too: an Inf released value
    raises before any partition is decoded, as the fused release does."""
    rows = [(u, u % 3, 1e308) for u in range(60)]
    for fused in (True, False):
        be = backend(tdp, fused)
        acc = tdp.NaiveBudgetAccountant(total_epsilon=1e6, total_delta=1e-5)
        res = tdp.DPEngine(acc, be).aggregate(
            rows, tdp.AggregateParams(
                metrics=[tdp.Metrics.SUM], max_partitions_contributed=1,
                max_contributions_per_partition=1, min_value=0.0,
                max_value=1.7e308), extractors(tdp), [0, 1, 2])
        acc.compute_budgets()
        with pytest.raises(tdp.numeric.ReleaseIntegrityError):
            list(res)


def test_validate_fused_release():
    input_validators.validate_fused_release(True, "t")
    input_validators.validate_fused_release(False, "t")
    for bad in (0, 1, None, "yes", np.bool_(True)):
        with pytest.raises(ValueError, match="fused_release"):
            input_validators.validate_fused_release(bad, "t")
    with pytest.raises(ValueError, match="fused_release"):
        tdp.TorchBackend(device="cpu", fused_release=1)
    be = tdp.TorchBackend(device="cpu", fused_release=False)
    assert be.fused_release is False
    assert be.for_job("j", noise_seed=3).fused_release is False
    assert tdp.TorchBackend(device="cpu").fused_release is True
