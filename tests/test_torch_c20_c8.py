"""C20 sweep_report and C8 quantile_descend: their plain versions against
the JAX package on the CPU (float64, x64 on), and the host packing of the
rebuilt C8 (quantiles and lane keys by value in the launch's parameters up
to a stated count, device arrays above it, cached per quantile tuple).

Bounds stated here:
  * C20 at the bucket edges (every partition in one bucket; sizes spread
    over every bucket with five left empty; P = 257, not a multiple of the
    kernel's 256-partition rounds), public and private: bucket and the
    integer-valued info columns equal, keep_prob / bucket_rows /
    bucket_info within 1e-9 relative (tests/test_torch_sweep.py's bounds:
    XLA contracts multiply-adds into FMAs, the port rounds every product).
  * C8 through executor.quantile_outputs at 1, 3, 33 (one past the
    by-value count) and 49 quantiles in the dense regime (P = 6), 3 and 49
    in the lazy one (P = 600), and its lane entries (two lanes, each under its own key,
    against the JAX package's solo release of that key): within 1e-9
    relative (max(1, |x|)); a leaf is 1/65,536 of the range wide, so every
    walk ends at the JAX package's leaf.
"""

import ctypes
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
from pipelinedp_tpu import combiners as jax_combiners
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu.analysis import error_model as jax_em
from pipelinedp_tpu.analysis import kernels as jax_kernels
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import cuda_build
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.analysis import error_model as em
from pipelinedp_tpu_torch.analysis import kernels as ak
from pipelinedp_tpu_torch.ops import threefry

pytestmark = pytest.mark.torch_port

F64 = torch.float64
LIMIT = kernels.DESCEND_VALUE_QUANTILES

# ---------------------------------------------------------------------------
# C20 at the bucket edges

P20 = 257
K20 = 6
BOUNDS = np.asarray(ak.BUCKET_BOUNDS, np.float64)
EMPTY = (2, 7, 13, 21, len(BOUNDS) - 1)


def bucket_sizes(case: str, rng) -> np.ndarray:
    """Partition sizes (each partition's COUNT raw sum) of one case."""
    if case == "one bucket":
        return rng.uniform(200.0, 499.0, P20)
    if case == "every bucket, five empty":
        lows = [i for i in range(len(BOUNDS)) if i not in EMPTY]
        pick = np.asarray(lows)[np.arange(P20) % len(lows)]
        top = np.append(BOUNDS[1:], BOUNDS[-1] * 2.0)
        return BOUNDS[pick] + (top[pick] - BOUNDS[pick]) * rng.uniform(
            0.0, 0.99, P20)
    return rng.integers(1, 80, P20).astype(np.float64)  # low buckets


def sweep_rows(case: str, seed: int):
    """Two preaggregated rows a partition whose counts add to the case's
    size; contributed 1-11 partitions."""
    rng = np.random.default_rng(seed)
    size = bucket_sizes(case, rng)
    split = rng.uniform(0.2, 0.8, P20)
    counts = np.concatenate([size * split, size - size * split])
    pk = np.concatenate([np.arange(P20), np.arange(P20)]).astype(np.int32)
    sums = np.round(rng.normal(1.5, 3.0, 2 * P20), 2)
    contributed = rng.integers(1, 12, 2 * P20).astype(np.float64)
    return counts, sums, contributed, pk


def sweep_config(public: bool):
    strategies = ("TRUNCATED_GEOMETRIC", "LAPLACE_THRESHOLDING",
                  "GAUSSIAN_THRESHOLDING")
    params = [pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT], noise_kind=pdp.NoiseKind.GAUSSIAN,
        max_partitions_contributed=1 + 3 * i,
        max_contributions_per_partition=1 + i % 2,
        partition_selection_strategy=getattr(pdp.PartitionSelectionStrategy,
                                             strategies[i % 3]))
        for i in range(K20)]
    stds = np.array([[jax_em.config_noise_std(p, pdp.Metrics.COUNT, 0.7,
                                              1e-6)] for p in params])
    return jax_kernels.build_config_arrays(
        params, [pdp.Metrics.COUNT], stds, None if public else (0.8, 1e-5))


SWEEP_CASES = [(case, public) for case in
               ("one bucket", "every bucket, five empty", "P not a multiple")
               for public in (True, False)]


@pytest.mark.parametrize("case,public", SWEEP_CASES,
                         ids=[f"{c.split(',')[0].replace(' ', '_')}-"
                              f"{'pub' if p else 'priv'}"
                              for c, p in SWEEP_CASES])
def test_sweep_report_plain_matches_jax_at_bucket_edges(case, public):
    counts, sums, contributed, pk = sweep_rows(case, 7)
    cfg = sweep_config(public)
    kw = dict(n_partitions_total=P20, metric_codes=(1,), public=public)
    want = {k: np.asarray(v) for k, v in jax_kernels.sweep_kernel(
        counts, sums, contributed, pk, cfg, **kw).items()}
    got = {k: v.numpy() for k, v in ak.sweep_kernel(
        counts, sums, contributed, pk, convert.sweep_config_arrays(cfg),
        **kw, device="cpu", dtype=F64).items()}
    buckets = np.bincount(got["bucket"], minlength=len(BOUNDS))
    if case == "one bucket":
        assert np.count_nonzero(buckets) == 1
    elif case.startswith("every"):
        assert set(np.flatnonzero(buckets == 0)) == set(EMPTY)
    np.testing.assert_array_equal(got["bucket"], want["bucket"])
    exact = [em.N_DATASET, em.N_EMPTY] if public else [em.N_DATASET]
    np.testing.assert_array_equal(got["bucket_info"][..., exact],
                                  want["bucket_info"][..., exact])
    for key in ("keep_prob", "bucket_rows", "bucket_info"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=0,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# C8's host packing


def test_value_quantiles_and_lane_words_are_cuda_builds_constants():
    assert LIMIT == cuda_build.DESCEND_VALUE_QUANTILES == 32
    assert kernels.DESCEND_LANE_WORDS == cuda_build.DESCEND_LANE_WORDS
    defines = cuda_build.DEFINES["quantile_descend"]
    assert defines["PDP_DESCEND_VALUE_QUANTILES"] == LIMIT
    assert defines["PDP_DESCEND_LANE_WORDS"] == kernels.DESCEND_LANE_WORDS
    assert "-DPDP_DESCEND_VALUE_QUANTILES=32" in cuda_build._flags(
        "quantile_descend")


@pytest.mark.parametrize("quantiles", [
    (0.5,), (0.9, 0.1, 0.5), (0.9, 0.1, 0.5, 0.5, 0.1, 0.99, 0.0, 1.0),
    tuple((j + 1) / 50 for j in range(49))[::-1]],
    ids=["one", "unsorted", "ties", "49-descending"])
def test_host_quantiles_hold_values_and_stable_ascending_order(quantiles):
    q, order = kernels._descend_host_quantiles(quantiles)
    assert list(q) == list(quantiles)
    want = np.argsort(np.asarray(quantiles), kind="stable")
    assert list(order) == want.tolist()
    # Ties keep their index order (cummax over them is the same either
    # way, but the walks' order is the kernel's dedup order).
    for a, b in zip(order, order[1:]):
        assert quantiles[a] < quantiles[b] or (quantiles[a] == quantiles[b]
                                               and a < b)


def test_host_quantiles_are_cached_per_exact_tuple():
    a = kernels._descend_host_quantiles((0.1, 0.5))
    assert kernels._descend_host_quantiles((0.1, 0.5)) is a
    b = kernels._descend_host_quantiles((0.1, 0.6))
    assert b is not a and list(b[0]) == [0.1, 0.6]


@pytest.mark.parametrize("n_q", [1, 3, LIMIT, LIMIT + 1, 49])
def test_descend_params_by_value_up_to_the_limit(monkeypatch, n_q):
    calls = []

    def device_arrays(quantiles, device):
        calls.append((quantiles, device))
        return 1234, 5678

    monkeypatch.setattr(kernels, "_descend_device_arrays", device_arrays)
    quantiles = [(j + 1) / (n_q + 1) for j in range(n_q)][::-1]
    q_host, order_host, q_dev, order_dev, scal, dims = \
        kernels._descend_params(quantiles, 2.5, True, -1.0, 9.0, 4, 16,
                                torch.device("cpu"))
    assert list(q_host) == quantiles
    assert list(order_host) == list(range(n_q))[::-1]
    assert list(scal) == [2.5, -1.0, 9.0]
    assert list(dims) == [n_q, 4, 16, 1]
    if n_q <= LIMIT:
        assert (q_dev, order_dev) == (0, 0) and not calls
    else:
        assert (q_dev, order_dev) == (1234, 5678)
        assert calls == [(tuple(quantiles), torch.device("cpu"))]


@pytest.mark.parametrize("n_lanes,words", [(1, 2), (16, 24), (21, 24),
                                           (40, 24), (256, 2), (257, 2)])
def test_lane_keys_by_value_up_to_the_lane_words(monkeypatch, n_lanes,
                                                 words):
    uploads = []

    def upload(values, dtype, device):
        uploads.append(values.copy())
        return torch.as_tensor(values)

    monkeypatch.setattr(kernels, "_pinned_upload", upload)
    table = np.arange(n_lanes * words, dtype=np.uint32).reshape(n_lanes,
                                                               words)
    host, dev, held = kernels._descend_lane_keys(table, torch.device("cpu"))
    if n_lanes * words <= kernels.DESCEND_LANE_WORDS:
        assert dev == 0 and not uploads
        assert host == held.ctypes.data
        got = np.ctypeslib.as_array(
            ctypes.cast(host, ctypes.POINTER(ctypes.c_uint32)),
            (n_lanes * words,))
        np.testing.assert_array_equal(got, table.reshape(-1))
    else:
        assert host == 0 and dev == held.data_ptr()
        np.testing.assert_array_equal(uploads[0].view(np.uint32), table)


# ---------------------------------------------------------------------------
# C8's plain versions against the JAX package


MIN_V, MAX_V = -1.0, 9.0


def quantile_config(n_q: int, n_partitions: int):
    """Both packages' configs with n_q percentiles (descending: the cummax
    runs in the reverse of their order) and COUNT, Laplace noise."""
    percentiles = [100.0 * (j + 1) / (n_q + 1) for j in range(n_q)][::-1]
    params = pdp.AggregateParams(
        metrics=[pdp.Metrics.PERCENTILE(p) for p in percentiles] +
        [pdp.Metrics.COUNT], noise_kind=pdp.NoiseKind.LAPLACE,
        max_partitions_contributed=3, max_contributions_per_partition=2,
        min_value=MIN_V, max_value=MAX_V)
    acc = pdp.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
    compound = jax_combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    jcfg = jax_executor.make_kernel_config(params, compound, n_partitions,
                                           False, None)
    return (params, jcfg, convert.kernel_config(dataclasses.asdict(jcfg)),
            jax_executor.compute_noise_stds(compound, params))


def quantile_rows(n_partitions: int, n_rows: int = 3000, seed: int = 5):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_rows // 6, n_rows).astype(np.int32)
    pk = rng.integers(0, n_partitions, n_rows).astype(np.int32)
    values = rng.uniform(MIN_V - 1.0, MAX_V + 1.0, n_rows)
    return pid, pk, values, np.ones(n_rows, bool)


def both_rows(n_q, n_partitions):
    """The configs of n_q percentiles and both packages' bounded rows, the
    rows bounded once a partition count (the bounding does not read the
    percentiles)."""
    _, jcfg, cfg, stds = quantile_config(n_q, n_partitions)
    return (jcfg, cfg, stds) + bounded_rows(n_partitions)


@functools.lru_cache(maxsize=None)
def bounded_rows(n_partitions):
    import jax
    params, jcfg, cfg, _ = quantile_config(3, n_partitions)
    pid, pk, values, valid = quantile_rows(n_partitions)
    key = np.array([3, 77], np.uint32)
    scal = jax_executor.kernel_scalars(params)
    _, _, _, _, qrows = jax_executor.bounded_row_columns(
        jnp.asarray(pid), jnp.asarray(pk), jnp.asarray(values),
        jnp.asarray(valid), *scal, jax.random.split(key, 2)[0], jcfg)
    key2, pair_start, cols, rows = executor.bounded_row_columns(
        *convert.row_tensors(pid, pk, values, valid, "cpu", F64), *scal,
        threefry.split(key, 2)[0], cfg)
    _, sorted_rows = executor.reduce_rows_to_partitions(
        key2, pair_start, cols, n_partitions, F64)
    return qrows, sorted_rows, rows


def jax_release(jcfg, stds, qrows, qkey):
    return {k: np.asarray(v) for k, v in jax_executor.quantile_outputs(
        tuple(jnp.asarray(a) for a in qrows), MIN_V, MAX_V,
        jnp.asarray(stds), qkey, jcfg).items()}


def assert_close(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        g = np.asarray(got[name])
        w = want[name]
        assert np.all(np.abs(g - w) <= 1e-9 * np.maximum(1.0, np.abs(w))), \
            name


# The lazy regime at one count by value and one above it: each new count
# costs the JAX package's lazy path a compile of ~3.5 s.
DESCENT_CASES = [(6, n_q) for n_q in (1, 3, LIMIT + 1, 49)] + \
    [(600, n_q) for n_q in (3, 49)]


@pytest.mark.parametrize("n_partitions,n_q", DESCENT_CASES,
                         ids=[f"{'dense' if p < 512 else 'lazy'}-{n}"
                              for p, n in DESCENT_CASES])
def test_descent_plain_matches_jax_quantile_outputs(n_partitions, n_q):
    jcfg, cfg, stds, qrows, sorted_rows, rows = both_rows(n_q, n_partitions)
    assert len(cfg.quantiles) == n_q
    qkey = np.array([11, 22], np.uint32)
    keep = torch.ones(n_partitions, dtype=torch.bool)
    flags = torch.zeros(1, dtype=torch.int32)
    got = executor.quantile_outputs(sorted_rows, rows, MIN_V, MAX_V,
                                    convert.noise_stds(stds), qkey, keep,
                                    flags, cfg, F64)
    assert_close({k: v.numpy() for k, v in got.items()},
                 jax_release(jcfg, stds, qrows, qkey))


def lanes_of(sorted_rows, rows, n_partitions, n_lanes):
    """n_lanes copies of one job's bounded rows as the lane-batched
    release lays them out: key2 = lane * P + partition (other rows past
    the lanes' range), each lane's rows and values after the last's."""
    (perm, skey2), (row_perm, values) = sorted_rows, rows
    n, m = perm.shape[0], values.shape[0]
    lane_keys = [torch.where(skey2 < n_partitions, skey2 + l * n_partitions,
                             n_lanes * n_partitions).to(skey2.dtype)
                 for l in range(n_lanes)]
    return ((torch.cat([perm + l * n for l in range(n_lanes)]),
             torch.cat(lane_keys)),
            (torch.cat([row_perm + l * m for l in range(n_lanes)]),
             values.repeat(n_lanes)))


@pytest.mark.parametrize("n_partitions", [6, 600], ids=["dense", "lazy"])
def test_descent_lanes_plain_match_jax_solo_releases(n_partitions):
    n_lanes, n_q = 2, 3
    jcfg, cfg, stds, qrows, sorted_rows, rows = both_rows(n_q, n_partitions)
    qkeys = np.array([[11, 22], [5, 9]], np.uint32)
    lane_sorted, lane_rows = lanes_of(sorted_rows, rows, n_partitions,
                                      n_lanes)
    keep = torch.ones(n_lanes * n_partitions, dtype=torch.bool)
    flags = torch.zeros(n_lanes, dtype=torch.int32)
    got = executor.quantile_outputs(lane_sorted, lane_rows, MIN_V, MAX_V,
                                    convert.noise_stds(stds), qkeys, keep,
                                    flags, cfg, F64, n_lanes=n_lanes)
    for lane in range(n_lanes):
        sl = slice(lane * n_partitions, (lane + 1) * n_partitions)
        assert_close({k: v[sl].numpy() for k, v in got.items()},
                     jax_release(jcfg, stds, qrows, qkeys[lane]))
