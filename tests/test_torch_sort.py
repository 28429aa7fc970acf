"""The sort (C5 radix_sort) and compaction (C6 compact_kept) plain versions
against the JAX package's `executor._sort_rows` and `compact_release`, and
the total contribution bound (max_contributions) against its
`bounded_row_columns`, on the CPU in float64.

Bounds stated here:
  * sorts: the identical permutation of the carried payloads (a row index
    carried through lax.sort), ties in the uniform and padding sentinels
    included.
  * compaction: identical n_kept, order and gathered columns.
  * total bound: identical keep rows, pair starts and partitions; columns
    bit-identical on integer values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
from pipelinedp_tpu import combiners as jax_combiners
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.ops import threefry

pytestmark = pytest.mark.torch_port

F64 = torch.float64
INT32_MAX = np.iinfo(np.int32).max
SALT_KEY = np.array([3, 1234], np.uint32)


def rows(seed: int, n: int = 700, n_pids: int = 30, n_partitions: int = 9):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_pids, n).astype(np.int32)
    pk = rng.integers(0, n_partitions, n).astype(np.int32)
    valid = rng.random(n) > 0.15  # invalid rows carry the sentinels
    # Few distinct uniforms: ties that only a stable sort keeps in order.
    u = rng.integers(0, 6, n).astype(np.float64) / 8
    return pid, pk, valid, u


def jax_order(keys):
    """Row order of the JAX package's sort: an iota payload carried
    through _sort_rows."""
    iota = jnp.arange(keys[0].shape[0], dtype=jnp.int32)
    _, (perm,) = jax_executor._sort_rows([jnp.asarray(k) for k in keys],
                                         [iota])
    return np.asarray(perm)


def port_order(words, sorted_top=False):
    return kernels.radix_sort([torch.as_tensor(w) for w in words],
                              sorted_top=sorted_top)


def pair_keys(pid, pk, valid, salts, n_partitions):
    """The JAX package's (pid_sent, hash0, hash1, pk_sent) and the port's
    packed (k1, k2) for the same rows."""
    pid_sent = np.where(valid, pid, INT32_MAX).astype(np.int32)
    pk_sent = np.where(valid, pk, n_partitions).astype(np.int32)
    h0, h1 = jax_executor._pair_hash(jnp.asarray(pid_sent),
                                     jnp.asarray(pk_sent), SALT_KEY)
    k1, k2, _ = kernels.row_keys_plain(
        torch.as_tensor(pid), torch.as_tensor(pk), torch.as_tensor(valid),
        salts, None, n_partitions, None)
    return (pid_sent, np.asarray(h0), np.asarray(h1), pk_sent), (k1, k2)


@pytest.mark.parametrize("seed", [0, 1])
def test_bounding_sort_matches_lax_sort(seed):
    pid, pk, valid, u = rows(seed)
    jkeys, (k1, k2) = pair_keys(pid, pk, valid, threefry.bits(SALT_KEY, 4),
                                9)
    want = jax_order(list(jkeys) + [u])
    got = port_order([k1.numpy(), k2.numpy(), u])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_selection_sort_matches_lax_sort(seed):
    pid, pk, valid, _ = rows(seed)
    jkeys, (k1, k2) = pair_keys(pid, pk, valid, threefry.bits(SALT_KEY, 4),
                                9)
    np.testing.assert_array_equal(
        port_order([k1.numpy(), k2.numpy()]).numpy(), jax_order(jkeys))


@pytest.mark.parametrize("seed", [0, 1])
def test_partition_sort_matches_lax_sort(seed):
    _, pk, valid, _ = rows(seed)
    key2 = np.where(valid, pk, 9).astype(np.int32)  # P is the sentinel
    perm, skey2 = port_order([key2], sorted_top=True)
    want = jax_order([key2])
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(skey2.numpy(), key2[want])


@pytest.mark.parametrize("seed", [0, 1])
def test_total_bound_sort_matches_lax_sort(seed):
    pid, _, valid, u = rows(seed)
    pid_sent, u0 = kernels.total_bound_keys(
        torch.as_tensor(pid), torch.as_tensor(valid),
        np.array([5, 6], np.uint32), F64)
    np.testing.assert_array_equal(
        pid_sent.numpy(), np.where(valid, pid, INT32_MAX))
    # The drawn uniforms, and tied ones.
    for rand in (u0.numpy(), u):
        perm, spid = port_order([pid_sent.numpy(), rand], sorted_top=True)
        want = jax_order([pid_sent.numpy(), rand])
        np.testing.assert_array_equal(perm.numpy(), want)
        np.testing.assert_array_equal(spid.numpy(), pid_sent.numpy()[want])


def test_radix_sort_orders_negative_and_wide_keys():
    rng = np.random.default_rng(4)
    words = [rng.integers(-3, 3, 500).astype(np.int64) << 40,
             rng.integers(-2**31, 2**31 - 1, 500).astype(np.int32),
             (rng.normal(size=500).round(1) + 0.0).astype(np.float32)]
    np.testing.assert_array_equal(port_order(words).numpy(),
                                  np.lexsort(words[::-1]))


def test_radix_sort_rejects_bad_words():
    with pytest.raises(ValueError, match="1 to 4"):
        kernels.radix_sort([])
    with pytest.raises(ValueError, match="1 to 4"):
        kernels.radix_sort([torch.zeros(4, dtype=torch.int32)] * 5)
    with pytest.raises(ValueError, match="dtype"):
        kernels.radix_sort([torch.zeros(4, dtype=torch.bool)])
    with pytest.raises(ValueError, match="expected contiguous"):
        kernels.radix_sort([torch.zeros(4, dtype=torch.int32),
                            torch.zeros(5, dtype=torch.int32)])


@pytest.mark.parametrize("p,kept", [(1, "all"), (7, "none"), (2049, "half"),
                                    (5000, "half"), (4096, "all"),
                                    (3, "half")])
def test_compaction_matches_compact_release(p, kept):
    rng = np.random.default_rng(p)
    keep = {"all": np.ones(p, bool), "none": np.zeros(p, bool),
            "half": rng.random(p) < 0.5}[kept]
    cols = {"count": rng.normal(size=p), "sum": rng.normal(size=p)}
    n_want, order_want, cols_want = jax_executor.compact_release(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(keep))
    n_got, order_got, cols_got = executor.compact_release(
        {k: torch.as_tensor(v) for k, v in cols.items()},
        torch.as_tensor(keep))
    assert int(n_got) == int(n_want) == int(keep.sum())
    np.testing.assert_array_equal(order_got.numpy(), np.asarray(order_want))
    np.testing.assert_array_equal(order_got.numpy()[:int(n_got)],
                                  np.nonzero(keep)[0])
    for name in cols:
        np.testing.assert_array_equal(cols_got[name].numpy(),
                                      np.asarray(cols_want[name]))


def test_compaction_without_columns_and_rejections():
    keep = torch.tensor([False, True, True, False])
    n_kept, order, out = kernels.compact_kept(keep, {})
    assert int(n_kept) == 2 and out == {}
    assert order.tolist() == [1, 2, 0, 3]
    with pytest.raises(ValueError, match="share"):
        kernels.compact_kept(keep, {"a": torch.zeros(4, dtype=torch.int16)})
    with pytest.raises(ValueError, match="expected contiguous"):
        kernels.compact_kept(keep, {"a": torch.zeros(5)})


TOTAL_PARAMS = {
    "count_sum": dict(metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM],
                      max_contributions=5, min_value=0.0, max_value=5.0),
    "pid_count_mean": dict(metrics=[pdp.Metrics.PRIVACY_ID_COUNT,
                                    pdp.Metrics.MEAN],
                           max_contributions=3, min_value=-1.0,
                           max_value=4.0),
}


@pytest.mark.parametrize("name", sorted(TOTAL_PARAMS))
def test_total_bound_rows_match_bounded_row_columns(name):
    params = pdp.AggregateParams(**TOTAL_PARAMS[name])
    acc = pdp.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
    compound = jax_combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    jcfg = jax_executor.make_kernel_config(params, compound, 9, False, None)
    cfg = convert.kernel_config(dataclasses.asdict(jcfg))
    assert cfg.total_bound == params.max_contributions and cfg.l0 == 0
    pid, pk, valid, _ = rows(7)
    values = np.random.default_rng(7).integers(-2, 7, pid.shape[0]).astype(
        np.float64)
    key = np.array([0, 99], np.uint32)
    scal = jax_executor.kernel_scalars(params)
    spk, keep, pair_start, jcols, _ = jax_executor.bounded_row_columns(
        jnp.asarray(pid), jnp.asarray(pk), jnp.asarray(values),
        jnp.asarray(valid), *scal, jax.random.split(key, 2)[0], jcfg)
    keep = np.asarray(keep)
    key2, t_start, tcols, _ = executor.bounded_row_columns(
        *convert.row_tensors(pid, pk, values, valid, "cpu", F64), *scal,
        threefry.split(key, 2)[0], cfg)
    # The bound bites: some users lose rows, and every user keeps at most
    # max_contributions of them.
    assert 0 < keep.sum() < valid.sum()
    np.testing.assert_array_equal((key2 < 9).numpy(), keep)
    np.testing.assert_array_equal(t_start.numpy(), np.asarray(pair_start))
    np.testing.assert_array_equal(key2.numpy()[keep], np.asarray(spk)[keep])
    assert sorted(tcols) == sorted(jcols)
    for col in jcols:
        np.testing.assert_array_equal(tcols[col].numpy()[keep],
                                      np.asarray(jcols[col])[keep])
