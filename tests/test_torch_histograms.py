"""The port's dataset histograms (pipelinedp_tpu_torch/dataset_histograms/)
against the JAX package's, on the CPU: compute_dataset_histograms_device
with device="cpu" (C5, C17 group_stats and C18 log_bins through their
plain versions) against the JAX package's device and columnar paths.

Bounds stated here:
  * the five integer histograms: every bin (lower, upper, count, sum, max)
    equal (==) to both JAX paths (the JAX device path's float32 bin sums
    are exact at these sizes; the port's are int64).
  * the float histogram against the JAX device path: the same buckets,
    bounds, counts and maxes (==), bucket sums within 1e-5 relative (the
    port rounds each bucket's float64 sum to float32; the JAX package adds
    float32 values one at a time); against the float64 columnar path the
    total count, as the JAX package's own test holds it.
  * the host modules (columnar path, queries, error estimator): equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinedp_tpu import aggregate_params as jax_agg
from pipelinedp_tpu.dataset_histograms import computing_histograms as jax_ch
from pipelinedp_tpu.dataset_histograms import device_histograms as jax_dh
from pipelinedp_tpu.dataset_histograms import histogram_error_estimator as \
    jax_est
from pipelinedp_tpu.dataset_histograms import histograms as jax_hist
from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.dataset_histograms import computing_histograms as ch
from pipelinedp_tpu_torch.dataset_histograms import device_histograms as dh
from pipelinedp_tpu_torch.dataset_histograms import histogram_error_estimator \
    as est
from pipelinedp_tpu_torch.dataset_histograms import histograms as hist

pytestmark = pytest.mark.torch_port

INT_FIELDS = (0, 1, 2, 4, 5)  # convert.HISTOGRAM_FIELDS but linf_sum
FLOAT_FIELD = 3


def random_columns(seed, n=3000, users=80, parts=40):
    # tests/test_dataset_histograms.py TestDeviceHistogramsParity's data.
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, users, n).astype(np.int32)
    pks = (np.power(rng.random(n), 2.5) * parts).astype(np.int32)
    values = (rng.random(n) * 7.0 - 2.0)
    return pids, pks, values


def port_device(pids, pks, values=None):
    return convert.histograms_fields(
        dh.compute_dataset_histograms_device(pids, pks, values,
                                             device="cpu"))


def assert_float_histogram_close(got, want):
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert (g[0], g[1], g[2], g[4]) == (w[0], w[1], w[2], w[4])
        assert abs(g[3] - w[3]) <= 1e-5 * max(1.0, abs(w[3]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_histograms_match_both_jax_paths(seed):
    pids, pks, values = random_columns(seed)
    got = port_device(pids, pks, values)
    jax_device = convert.histograms_fields(
        jax_dh.compute_dataset_histograms_device(pids, pks, values))
    jax_host = convert.histograms_fields(
        jax_ch.compute_dataset_histograms_columnar(pids, pks, values))
    for i in INT_FIELDS:
        assert got[i] == jax_device[i] == jax_host[i], i
    assert_float_histogram_close(got[FLOAT_FIELD], jax_device[FLOAT_FIELD])
    assert sum(b[2] for b in got[FLOAT_FIELD][1]) == \
        sum(b[2] for b in jax_host[FLOAT_FIELD][1])


def test_float_histogram_with_sums_on_edges():
    # Pair sums that land exactly on float32 edges (integers between the
    # min 0 and max 10000: edge i is i before rounding) and on the float64
    # edges of the host path.
    rng = np.random.default_rng(4)
    pids = np.arange(4000, dtype=np.int32)
    pks = rng.integers(0, 50, 4000).astype(np.int32)
    values = rng.integers(0, 10001, 4000).astype(np.float64)
    values[:2] = [0.0, 10000.0]
    got = port_device(pids, pks, values)
    want = convert.histograms_fields(
        jax_dh.compute_dataset_histograms_device(pids, pks, values))
    assert got == want
    assert got[FLOAT_FIELD][1]


@pytest.mark.parametrize("k", [999, 1000, 1001, 9999, 10000, 123456, 10**6])
def test_large_value_binning_decade_edges(k):
    pids = np.zeros(k, np.int32)
    pks = np.zeros(k, np.int32)
    got = port_device(pids, pks)
    want = convert.histograms_fields(
        jax_ch.compute_dataset_histograms_columnar(pids, pks))
    assert got[1] == want[1]  # l1
    assert got[2] == want[2]  # linf


def test_no_values_skips_float_histogram():
    pids, pks, _ = random_columns(7, n=500)
    got = port_device(pids, pks)
    assert got[FLOAT_FIELD] is None
    assert got[0][1]
    want = convert.histograms_fields(
        jax_dh.compute_dataset_histograms_device(pids, pks))
    assert got == want


def test_empty_input():
    got = dh.compute_dataset_histograms_device(np.zeros(0, np.int32),
                                               np.zeros(0, np.int32),
                                               np.zeros(0), device="cpu")
    assert got.l0_contributions_histogram.bins == []
    assert got.linf_sum_contributions_histogram.bins == []
    want = jax_dh.compute_dataset_histograms_device(np.zeros(0, np.int32),
                                                    np.zeros(0, np.int32),
                                                    np.zeros(0))
    assert convert.histograms_fields(got) == convert.histograms_fields(want)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pids, pks, values = random_columns(0, n=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        dh.compute_dataset_histograms_device(pids, pks, values)
    with pytest.raises(RuntimeError, match="CUDA"):
        dh.compute_dataset_histograms_device(pids, pks, values,
                                             device="cuda")


@pytest.mark.parametrize("seed", [0, 3])
def test_columnar_path_equals_jax(seed):
    pids, pks, values = random_columns(seed)
    assert convert.histograms_fields(
        ch.compute_dataset_histograms_columnar(pids, pks, values)) == \
        convert.histograms_fields(
            jax_ch.compute_dataset_histograms_columnar(pids, pks, values))


def test_log_bin_bounds_match_jax_in_int32():
    probe = [1, 2, 9, 10, 99, 100, 999, 1000, 1001, 1009, 1010, 9990, 9999,
             10000, 10001, 10099, 123456, 10**6, 10**7 + 1, 10**9 - 1, 10**9,
             10**9 + 1, 2**31 - 10**7, 2**31 - 1]
    values = np.unique(np.concatenate([
        probe, np.random.default_rng(0).integers(1, 2**31 - 1, 5000)]))
    lower, upper = kernels.log_bin_bounds(torch.from_numpy(values))
    jl, ju = jax_dh._log_bin_bounds(jnp.asarray(values, dtype=jnp.int32))
    np.testing.assert_array_equal(lower.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(upper.numpy(), np.asarray(ju))
    # Every lower has its own slot, ascending with the lower, and the slot
    # gives the lower back.
    uniq = torch.unique(lower)
    slots = kernels.log_bin_slot(uniq)
    assert bool((slots[1:] > slots[:-1]).all())
    assert int(slots.min()) >= 0
    assert int(slots.max()) < kernels.LOG_BIN_SLOTS
    assert torch.equal(kernels.log_bin_lower(slots), uniq)
    assert int(kernels.log_bin_slot(torch.tensor([2140000000]))) == \
        kernels.LOG_BIN_SLOTS - 1


def test_log_bins_int_plain_matches_jax_bin_kernel():
    rng = np.random.default_rng(5)
    values = np.concatenate([rng.integers(0, 3000, 900),
                             [1000, 10000, 999, 1010, 0, 1]]).astype(np.int32)
    mask = rng.random(values.size) < 0.8
    got = kernels.log_bins_int(torch.from_numpy(values),
                               torch.from_numpy(mask))
    want = jax.jit(jax_dh._bin_int_kernel)(jnp.asarray(values),
                                           jnp.asarray(mask))
    k = int(want[5])
    assert int(got[5]) == k
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g[:k].numpy(),
                                      np.asarray(w[:k]).round())
    assert all(int(g[k:].abs().sum()) == 0 for g in got[:5])


def test_log_bins_int_upper_overflow_raises_as_jax():
    values = np.array([2**31 - 5, 5], dtype=np.int32)
    mask = np.ones(2, bool)
    binned = kernels.log_bins_int(torch.from_numpy(values),
                                  torch.from_numpy(mask))
    with pytest.raises(OverflowError, match="int32"):
        dh._int_bins_to_histogram(binned, hist.HistogramType.L1_CONTRIBUTIONS)
    with pytest.raises(OverflowError, match="int32"):
        jax_dh._int_bins_to_histogram(
            jax_dh._bin_int_kernel(jnp.asarray(values), jnp.asarray(mask)),
            jax_hist.HistogramType.L1_CONTRIBUTIONS)


@pytest.mark.parametrize("seed", range(4))
def test_linspace_edges_match_jnp_linspace(seed):
    rng = np.random.default_rng(seed)
    f = jax.jit(lambda lo, hi: jnp.linspace(lo, hi, 10001))
    for _ in range(10):
        lo, hi = np.sort(rng.normal(size=2) *
                         10.0**rng.integers(-3, 6)).astype(np.float32)
        got = kernels.linspace_edges_f32(torch.tensor(lo), torch.tensor(hi),
                                         10000)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(f(jnp.float32(lo), jnp.float32(hi))))


def test_log_bins_float_plain_matches_jax_bin_kernel():
    rng = np.random.default_rng(6)
    values = (rng.normal(size=3000) * 40).astype(np.float32)
    mask = rng.random(3000) < 0.7
    lo_hi, edges, counts, sums, maxes = kernels.log_bins_float(
        torch.from_numpy(values), torch.from_numpy(mask), 10000)
    jlo, jhi, jcounts, jsums, jmaxes = jax.jit(
        jax_dh._bin_float_kernel, static_argnums=2)(
            jnp.asarray(values), jnp.asarray(mask), 10000)
    assert lo_hi.tolist() == [float(jlo), float(jhi)]
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(maxes.numpy(), np.asarray(jmaxes))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5,
                               atol=1e-5)


def test_group_stats_plain_first_rows_and_zeros_elsewhere():
    pid = torch.tensor([3, 1, 3, 1, 2, 3, 0, 0], dtype=torch.int32)
    pk = torch.tensor([7, 7, 7, 8, 7, 9, 0, 0], dtype=torch.int32)
    values = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 0.0, 0.0])
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.bool)
    perm = kernels.radix_sort([kernels.sunk_keys(pid, valid),
                               kernels.sunk_keys(pk, valid)])
    out = kernels.group_stats_pairs(pid, pk, values, valid, perm)
    # Sorted rows: (1,7) (1,8) (2,7) (3,7) (3,7) (3,9) pad pad.
    assert out["new_pair"].tolist() == [1, 1, 1, 1, 0, 1, 0, 0]
    assert out["new_pid"].tolist() == [1, 0, 1, 1, 0, 0, 0, 0]
    assert out["pair_len"].tolist() == [1, 1, 1, 2, 0, 1, 0, 0]
    assert out["pair_sum"].tolist() == [2.0, 8.0, 16.0, 5.0, 0, 32.0, 0, 0]
    assert out["l1"].tolist() == [2, 0, 1, 3, 0, 0, 0, 0]
    assert out["l0"].tolist() == [2, 0, 1, 2, 0, 0, 0, 0]
    i32max = 2**31 - 1
    assert out["pair_pk"].tolist() == [7, 8, 7, 7, i32max, 9, i32max, i32max]
    keys = kernels.sunk_keys(pk, valid)
    new_seg, seg_len = kernels.group_stats_keys(keys, valid,
                                                kernels.radix_sort([keys]))
    assert new_seg.tolist() == [1, 0, 0, 0, 1, 1, 0, 0]
    assert seg_len.tolist() == [4, 0, 0, 0, 1, 1, 0, 0]


def make_histograms(mod_hist):
    T = mod_hist.HistogramType
    FB = mod_hist.FrequencyBin

    def h(name, bins):
        return mod_hist.Histogram(name, [FB(*b) for b in bins])

    int_bins = [(1, 2, 10, 10, 1), (2, 3, 6, 12, 2), (5, 6, 3, 15, 5),
                (40, 41, 1, 40, 40)]
    float_bins = [(0.0, 0.5, 4, 1.0, 0.4), (0.5, 1.0, 7, 5.0, 0.9),
                  (2.5, 3.0, 2, 5.6, 2.9)]
    return mod_hist.DatasetHistograms(
        h(T.L0_CONTRIBUTIONS, int_bins), h(T.L1_CONTRIBUTIONS, int_bins),
        h(T.LINF_CONTRIBUTIONS, int_bins[:3]),
        h(T.LINF_SUM_CONTRIBUTIONS, float_bins),
        h(T.COUNT_PER_PARTITION, int_bins[1:]),
        h(T.COUNT_PRIVACY_ID_PER_PARTITION, int_bins))


def test_histogram_queries_equal_jax():
    got, want = make_histograms(hist), make_histograms(jax_hist)
    for field in convert.HISTOGRAM_FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert (g.lower, g.upper, g.is_integer) == (w.lower, w.upper,
                                                    w.is_integer)
        assert g.total_count() == w.total_count()
        assert g.total_sum() == w.total_sum()
        assert g.max_value() == w.max_value()
        q = [0.0, 0.1, 0.5, 0.9, 0.99, 1.0]
        assert g.quantiles(q) == w.quantiles(q)
        assert hist.compute_ratio_dropped(g) == \
            jax_hist.compute_ratio_dropped(w)
    assert hist.Histogram(hist.HistogramType.L0_CONTRIBUTIONS, []).lower is None
    with pytest.raises(ValueError):
        hist.Histogram(hist.HistogramType.L0_CONTRIBUTIONS, []).quantiles([0.5])


@pytest.mark.parametrize("metric", ["COUNT", "PRIVACY_ID_COUNT"])
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_error_estimator_equals_jax(metric, noise):
    pids, pks, values = random_columns(1)
    got = est.create_error_estimator(
        dh.compute_dataset_histograms_device(pids, pks, values, device="cpu"),
        1.5, getattr(agg.Metrics, metric), getattr(agg.NoiseKind, noise))
    want = jax_est.create_error_estimator(
        jax_dh.compute_dataset_histograms_device(pids, pks, values), 1.5,
        getattr(jax_agg.Metrics, metric), getattr(jax_agg.NoiseKind, noise))
    for l0 in (0, 1, 2, 5, 100):
        assert got.get_ratio_dropped_l0(l0) == want.get_ratio_dropped_l0(l0)
        for linf in (1, 3):
            assert got.estimate_rmse(l0 or 1, linf) == \
                want.estimate_rmse(l0 or 1, linf)
    with pytest.raises(ValueError):
        est.create_error_estimator(
            make_histograms(hist), 1.0, agg.Metrics.SUM, agg.NoiseKind.LAPLACE)


@pytest.mark.parametrize("dtype,span", [(np.int32, 2**31 - 1),
                                        (np.int64, 2**31 - 1),
                                        (np.int64, 2**40), (np.float64, 50)])
def test_columnar_pair_grouping_equals_jax_for_any_keys(dtype, span):
    # Negative and extreme keys, int64 keys past int32 and float keys: the
    # same histograms, float sums bit for bit.
    rng = np.random.default_rng(11)
    pids = rng.integers(-span, span, 2000).astype(dtype)
    pids[:50] = pids[50:100]  # repeated pairs
    pks = rng.integers(-span, span, 2000).astype(dtype)
    pks[:50] = pks[50:100]
    pids[100:120] = pids[0]
    values = rng.random(2000) * 3 - 1
    assert convert.histograms_fields(
        ch.compute_dataset_histograms_columnar(pids, pks, values)) == \
        convert.histograms_fields(
            jax_ch.compute_dataset_histograms_columnar(pids, pks, values))


# C17's entries with the sort's sorted first key, across C17's 2048-row tiles
# (csrc/group_stats.cu kTile). Every case is padded with invalid rows to one
# length, so the JAX kernel compiles once.
C17_TILE = 2048
C17_ROWS = 1 << 15


def pair_columns(seed, n_pids, max_pair=8, long_pid=None, p_invalid=0.1):
    """Rows of n_pids pids in random order, each pid 1-11 pairs of 1 to
    max_pair rows (long_pid: 2700 pairs, past several tiles), values not
    integers, some rows invalid."""
    rng = np.random.default_rng(seed)
    pids, pks, lengths = [], [], []
    for pid in range(n_pids):
        n_pairs = 2700 if pid == long_pid else int(rng.integers(1, 12))
        for pk in rng.choice(5000, n_pairs, replace=False):
            pids.append(pid)
            pks.append(pk)
            lengths.append(int(rng.integers(1, max_pair + 1)))
    pid = np.repeat(pids, lengths).astype(np.int32)
    pk = np.repeat(pks, lengths).astype(np.int32)
    order = rng.permutation(len(pid))
    values = (rng.standard_normal(len(pid)) * 100).astype(np.float32)
    valid = rng.random(len(pid)) >= p_invalid
    return pid[order], pk[order], values, valid


def sorted_stats(pid, pk, values, valid):
    """dh.group_stats on torch columns, and the pairs entry's outputs with
    its sort."""
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (pid, pk, values, valid)]
    perm, spid = kernels.radix_sort(
        [kernels.sunk_keys(t[0], t[3]), kernels.sunk_keys(t[1], t[3])],
        sorted_top=True)
    pairs = kernels.group_stats_pairs(*t, perm, sorted_pid=spid)
    return dh.group_stats(*t), pairs, perm


C17_CASES = {
    "tile - 1": dict(seed=1, n=C17_TILE - 1),
    "tile": dict(seed=2, n=C17_TILE),
    "tile + 1": dict(seed=3, n=C17_TILE + 1),
    "pairs of up to 8 rows": dict(seed=4, n_pids=600),
    "one pid over many tiles": dict(seed=5, n_pids=30, long_pid=4,
                                    p_invalid=0.01),
    "every row invalid": dict(seed=6, n=3000, p_invalid=1.0),
}


def c17_case(name):
    kw = dict(C17_CASES[name])
    n = kw.pop("n", None)
    pid, pk, values, valid = pair_columns(
        kw.pop("seed"), kw.pop("n_pids", (n or 0) // 4 + 1), **kw)
    if n is not None:
        pid, pk, values, valid = pid[:n], pk[:n], values[:n], valid[:n]
    pad = C17_ROWS - len(pid)
    return (np.pad(pid, (0, pad)), np.pad(pk, (0, pad)),
            np.pad(values, (0, pad)), np.pad(valid, (0, pad)))


@pytest.mark.parametrize("name", sorted(C17_CASES))
def test_group_stats_with_sorted_keys_match_jax(name):
    pid, pk, values, valid = c17_case(name)
    stats, pairs, perm = sorted_stats(pid, pk, values, valid)
    want = jax_dh._group_stats_kernel(jnp.asarray(pid), jnp.asarray(pk),
                                      jnp.asarray(values),
                                      jnp.asarray(valid), has_values=True)
    for key in ("l0", "l1", "linf", "count_per_pk", "pids_per_pk"):
        got = kernels.log_bins_int(*stats[key])
        k = int(want[key][5])
        assert int(got[5]) == k, key
        for g, w in zip(got[:5], want[key][:5]):
            np.testing.assert_array_equal(g[:k].numpy(),
                                          np.asarray(w[:k]).round())
    lo_hi, _, counts, sums, maxes = kernels.log_bins_float(
        *stats["linf_sum"], 10000)
    jlo, jhi, jcounts, jsums, jmaxes = want["linf_sum"]
    if valid.any():
        assert lo_hi.tolist() == [float(jlo), float(jhi)]
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(maxes.numpy(), np.asarray(jmaxes))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5,
                               atol=1e-4)
    # Pair sums: a float32 fold of each pair's rows in sorted order, from 0
    # (jax.ops.segment_sum on the CPU adds the same way), bit for bit.
    starts = np.nonzero(pairs["new_pair"].numpy())[0]
    lens = pairs["pair_len"].numpy()[starts]
    sv = values[perm.numpy()]
    fold = np.zeros(len(starts), np.float32)
    for k in range(int(lens.max(initial=0))):
        live = lens > k
        fold[live] = fold[live] + sv[starts[live] + k]
    np.testing.assert_array_equal(
        pairs["pair_sum"].numpy()[starts].view(np.int32), fold.view(np.int32))
    if name == "one pid over many tiles":
        assert int(pairs["l1"].max()) > 4 * C17_TILE
    if name.startswith("tile"):
        assert len(starts) and int(valid.sum()) <= C17_TILE + 1


def test_group_stats_sorted_key_is_checked(monkeypatch):
    pid, pk, values, valid = (torch.from_numpy(a) for a in c17_case("tile"))
    perm, spid = kernels.radix_sort([kernels.sunk_keys(pid, valid),
                                     kernels.sunk_keys(pk, valid)],
                                    sorted_top=True)
    for bad in (spid[:-1], spid.to(torch.int64)):
        with pytest.raises(ValueError, match="sorted_pid"):
            kernels.group_stats_pairs(pid, pk, values, valid, perm,
                                      sorted_pid=bad)
        with pytest.raises(ValueError, match="sorted_keys"):
            kernels.group_stats_keys(pk, valid, perm, sorted_keys=bad)
    # The plain versions take it and are otherwise unchanged.
    with_key = kernels.group_stats_pairs(pid, pk, values, valid, perm,
                                         sorted_pid=spid)
    without = kernels.group_stats_pairs(pid, pk, values, valid, perm)
    assert all(torch.equal(with_key[k], without[k]) for k in with_key)
    # On the card the sorted key is required: the check comes before any
    # build or launch.
    monkeypatch.setattr(kernels, "_on_cuda", lambda *tensors: True)
    with pytest.raises(ValueError, match="sorted_pid .* is required"):
        kernels.group_stats_pairs(pid, pk, values, valid, perm)
    with pytest.raises(ValueError, match="sorted_keys .* is required"):
        kernels.group_stats_keys(pk, valid, perm)
