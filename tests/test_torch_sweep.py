"""The port's utility-analysis sweep (pipelinedp_tpu_torch/analysis/
kernels.sweep_kernel with device="cpu": C5, C10 and the plain versions of
C19 sweep_stats and C20 sweep_report) against the JAX package's
sweep_kernel, jitted on the CPU with x64 as tests/test_analysis.py runs
it, on numpy inputs made from a seed.

Bounds stated here:
  * n_users, n_rows, bucket and the integer-valued info columns (public
    analysis's N_DATASET / N_EMPTY, private analysis's N_DATASET): equal.
  * stats: within 1e-12 relative. Found: equal (==) in every case, float64
    and float32; both add each partition's terms in row order from 0 and
    XLA contracts no multiply-add of the terms.
  * keep_prob, bucket_rows, bucket_info: within 1e-9 relative (float64).
    Found: ~5e-15. XLA's CPU code contracts multiply-adds of the window
    and the report rows into FMAs (var = l0v + std * std, xs = mu +
    offset * step, ...) and sums the window in another order; the port
    rounds every product.
  * float32 (JAX with x64 off): stats, n_users, n_rows, bucket equal;
    keep_prob within 2e-5 absolute, bucket_rows / bucket_info within
    2e-5 relative of the larger magnitude (float32 erfc / exp differ by
    ulps between XLA and torch, over a 64-point window).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
from pipelinedp_tpu import partition_selection as jax_ps
from pipelinedp_tpu.analysis import error_model as jax_em
from pipelinedp_tpu.analysis import kernels as jax_kernels
from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch import partition_selection
from pipelinedp_tpu_torch.analysis import error_model as em
from pipelinedp_tpu_torch.analysis import kernels as ak

pytestmark = pytest.mark.torch_port

STRATEGIES = ("TRUNCATED_GEOMETRIC", "LAPLACE_THRESHOLDING",
              "GAUSSIAN_THRESHOLDING")
N, P, K = 600, 29, 12


@pytest.fixture
def f32_compute():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def config_params(mod, metrics, k=K):
    """k configurations covering the three selector kinds, with and
    without pre_threshold, over several l0 / linf / sum bounds."""
    params = []
    for i in range(k):
        strategy = getattr(mod.PartitionSelectionStrategy,
                           STRATEGIES[i % 3])
        params.append(mod.AggregateParams(
            metrics=[getattr(mod.Metrics, m) for m in metrics],
            noise_kind=mod.NoiseKind.GAUSSIAN,
            max_partitions_contributed=1 + i % 5,
            max_contributions_per_partition=1 + i % 4,
            min_sum_per_partition=-1.0 - i % 2,
            max_sum_per_partition=2.0 + i,
            partition_selection_strategy=strategy,
            pre_threshold=(3 if (i // 3) % 2 else None)))
    return params


def rows(seed, n=N, p=P):
    """Preaggregated rows: counts, sums, contributed, pk_idx. Partition 0
    holds only ids that contribute one partition (q = 1 under every l0: a
    sigma = 0 partition); the last rows are padding (pk_idx P and -1)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 6, n).astype(np.float64)
    sums = np.round(rng.normal(1.5, 3.0, n), 2)
    contributed = rng.integers(1, 12, n).astype(np.float64)
    pk = rng.integers(1, p, n).astype(np.int32)
    pk[:9] = 0
    contributed[:9] = 1.0
    pk[-6:] = p
    pk[-9:-6] = -1
    return counts, sums, contributed, pk


def both_cfgs(metrics, public):
    jax_params = config_params(pdp, metrics)
    jax_metrics = [getattr(pdp.Metrics, m) for m in metrics]
    stds = np.array([[jax_em.config_noise_std(p, m, 0.7, 1e-6)
                      for m in jax_metrics] for p in jax_params]).reshape(
                          K, len(jax_metrics))
    sel = None if public else (0.8, 1e-5)
    jax_cfg = jax_kernels.build_config_arrays(jax_params, jax_metrics, stds,
                                              sel)
    port_cfg = ak.build_config_arrays(
        config_params(agg, metrics), [getattr(agg.Metrics, m)
                                      for m in metrics], stds, sel)
    codes = tuple(jax_kernels.METRIC_CODES[m] for m in jax_metrics)
    return jax_cfg, port_cfg, codes


def run_both(metrics, public, seed=3, dtype=torch.float64, config_chunk=5):
    jax_cfg, port_cfg, codes = both_cfgs(metrics, public)
    counts, sums, contributed, pk = rows(seed)
    kw = dict(n_partitions_total=P, metric_codes=codes, public=public,
              config_chunk=config_chunk)
    want = jax_kernels.sweep_kernel(counts, sums, contributed, pk, jax_cfg,
                                    **kw)
    got = ak.sweep_kernel(counts, sums, contributed, pk,
                          convert.sweep_config_arrays(jax_cfg), **kw,
                          device="cpu", dtype=dtype)
    # The port's own config arrays equal the carried ones.
    for ours, theirs in zip(port_cfg, jax_cfg):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def assert_integer_columns_equal(want, got, public):
    for key in ("n_users", "n_rows", "bucket"):
        np.testing.assert_array_equal(got[key], want[key].astype(
            got[key].dtype))
    exact = [em.N_DATASET, em.N_EMPTY] if public else [em.N_DATASET]
    np.testing.assert_array_equal(got["bucket_info"][..., exact],
                                  want["bucket_info"][..., exact])


def assert_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


CASES = [(m, public) for public in (True, False)
         for m in ([], ["COUNT"], ["SUM", "PRIVACY_ID_COUNT"])
         if m or not public]


@pytest.mark.parametrize("metrics,public", CASES,
                         ids=[f"{'pub' if p else 'priv'}-M{len(m)}"
                              for m, p in CASES])
def test_sweep_matches_jax_float64(metrics, public):
    want, got = run_both(metrics, public)
    assert_integer_columns_equal(want, got, public)
    assert got["stats"].shape == (K, P, len(metrics), em.STAT_WIDTH)
    assert_rel(got["stats"], want["stats"], 1e-12)
    np.testing.assert_array_equal(got["stats"], want["stats"])
    assert_rel(got["keep_prob"], want["keep_prob"], 1e-9)
    assert_rel(got["bucket_rows"], want["bucket_rows"], 1e-9)
    assert_rel(got["bucket_info"], want["bucket_info"], 1e-9)
    if public:
        assert (got["keep_prob"] == 1.0).all()
    else:
        # Partition 0 has sigma = 0: the keep probability at rint(mu) =
        # its 9 ids (XLA contracts the truncated geometric's (n1 - 1) *
        # eps1 + log(delta1) into an FMA, so the last ulp may differ).
        sel_cfg = torch.stack([torch.tensor(np.asarray(x)) for x in
                               convert.sweep_config_arrays(
                                   both_cfgs(metrics, public)[0])[4:]])
        at9 = kernels.sweep_keep_points(
            torch.full((K, 1), 9.0, dtype=torch.float64), sel_cfg)
        np.testing.assert_array_equal(got["keep_prob"][:, :1], at9.numpy())


def test_sweep_without_per_partition_outputs():
    jax_cfg, _, codes = both_cfgs(["COUNT"], False)
    counts, sums, contributed, pk = rows(4)
    got = ak.sweep_kernel(counts, sums, contributed, pk,
                          convert.sweep_config_arrays(jax_cfg),
                          n_partitions_total=P, metric_codes=codes,
                          public=False, return_per_partition=False,
                          device="cpu")
    assert set(got) == {"bucket_rows", "bucket_info", "n_users", "n_rows",
                        "bucket"}


@pytest.mark.parametrize("config_chunk", [1, 8, 64])
def test_config_chunk_does_not_change_the_result(config_chunk):
    _, port_cfg, codes = both_cfgs(["SUM"], False)
    counts, sums, contributed, pk = rows(5)
    kw = dict(n_partitions_total=P, metric_codes=codes, public=False,
              device="cpu")
    base = ak.sweep_kernel(counts, sums, contributed, pk, port_cfg,
                           config_chunk=5, **kw)
    got = ak.sweep_kernel(counts, sums, contributed, pk, port_cfg,
                          config_chunk=config_chunk, partition_chunk=7, **kw)
    for key in base:
        assert torch.equal(got[key], base[key]), key


@pytest.mark.parametrize("metrics,public", [(["COUNT"], True),
                                            (["SUM", "COUNT"], False)])
def test_sweep_matches_jax_float32(f32_compute, metrics, public):
    want, got = run_both(metrics, public, seed=6, dtype=torch.float32)
    assert got["stats"].dtype == np.float32
    for key in ("n_users", "n_rows", "bucket", "stats"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["keep_prob"], want["keep_prob"],
                               atol=2e-5, rtol=0)
    for key in ("bucket_rows", "bucket_info"):
        scale = np.maximum(np.abs(want[key]), np.abs(got[key])).max()
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=2e-5 * scale)


def test_sweep_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_cfg, codes = both_cfgs(["COUNT"], True)
    counts, sums, contributed, pk = rows(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ak.sweep_kernel(counts, sums, contributed, pk, port_cfg,
                        n_partitions_total=P, metric_codes=codes,
                        public=True)


def moments(kind):
    """Selection moments [K, 6] with sigma = 0 at half-integer, integer
    and zero mu (jnp.round rounds half to even, as rint), and sigma > 0."""
    mu = np.array([[0.5, 1.5, 2.5, 3.0, 0.0, 4.7]] * 3)
    var = np.array([[0.0, 0.0, 0.0, 0.0, 0.0, 1.3]] * 3)
    third = np.array([[0.0] * 5 + [0.2]] * 3)
    n_users = np.array([1.0, 2.0, 3.0, 3.0, 0.0, 9.0])
    params = [pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT], noise_kind=pdp.NoiseKind.GAUSSIAN,
        max_partitions_contributed=l0, max_contributions_per_partition=1,
        partition_selection_strategy=getattr(pdp.PartitionSelectionStrategy,
                                             kind),
        pre_threshold=pre) for l0, pre in ((1, None), (2, 2), (4, None))]
    cfg = jax_kernels.build_config_arrays(params, [pdp.Metrics.COUNT],
                                          np.ones((3, 1)), (30.0, 1e-3))
    return mu, var, third, n_users, cfg


@pytest.mark.parametrize("kind", STRATEGIES)
def test_windowed_keep_prob_half_integer_mu(kind):
    mu, var, third, n_users, cfg = moments(kind)
    want = np.asarray(jax_kernels._windowed_keep_prob(
        jnp.asarray(mu), jnp.asarray(var), jnp.asarray(third),
        jnp.asarray(n_users), cfg, window=64, partition_chunk=4))
    port = convert.sweep_config_arrays(cfg)
    sel = torch.tensor(np.stack([mu, var, third], axis=-1))
    stats = torch.zeros((3, 6, 1, em.STAT_WIDTH), dtype=torch.float64)
    cfg_t = [torch.tensor(np.asarray(x)) for x in port]
    _, got, _, _ = kernels.sweep_report(
        stats, sel, torch.tensor(n_users), torch.tensor(n_users), cfg_t[3],
        torch.stack(cfg_t[4:]).contiguous(),
        torch.tensor(ak.BUCKET_BOUNDS, dtype=torch.float64), public=False)
    assert_rel(got.numpy(), want, 1e-9)
    # rint: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2; half away from zero would differ.
    sel_cfg = torch.stack(cfg_t[4:]).contiguous()
    at = kernels.sweep_keep_points(
        torch.tensor([[0.0, 2.0, 2.0]] * 3, dtype=torch.float64), sel_cfg)
    np.testing.assert_allclose(got[:, :3].numpy(), at.numpy(), rtol=1e-12)


@pytest.mark.parametrize("kind", STRATEGIES)
def test_keep_points_match_jax_and_host_selectors(kind):
    jax_params = [pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT], noise_kind=pdp.NoiseKind.GAUSSIAN,
        max_partitions_contributed=l0, max_contributions_per_partition=1,
        partition_selection_strategy=getattr(pdp.PartitionSelectionStrategy,
                                             kind),
        pre_threshold=pre) for l0, pre in ((1, None), (3, None), (2, 4))]
    cfg = jax_kernels.build_config_arrays(jax_params, [pdp.Metrics.COUNT],
                                          np.ones((3, 1)), (2.0, 1e-5))
    counts = np.tile(np.arange(0, 60, dtype=np.float64), (3, 1))
    want = np.asarray(jax_kernels._keep_prob_batch(jnp.asarray(counts), cfg))
    port = convert.sweep_config_arrays(cfg)
    sel_cfg = torch.stack([torch.tensor(np.asarray(x))
                           for x in port[4:]]).contiguous()
    got = kernels.sweep_keep_points(torch.tensor(counts), sel_cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    for ki, p in enumerate(jax_params):
        strategy = getattr(agg.PartitionSelectionStrategy, kind)
        host = partition_selection.create_partition_selection_strategy(
            strategy, 2.0, 1e-5, p.max_partitions_contributed,
            p.pre_threshold).probability_of_keep_vec(
                counts[ki].astype(np.int64))
        jax_host = jax_ps.create_partition_selection_strategy(
            p.partition_selection_strategy, 2.0, 1e-5,
            p.max_partitions_contributed, p.pre_threshold
        ).probability_of_keep_vec(counts[ki].astype(np.int64))
        np.testing.assert_array_equal(host, jax_host)
        np.testing.assert_allclose(got[ki], host, atol=1e-9)


def test_wrappers_reject_bad_shapes():
    f = torch.float64
    z = torch.zeros(4, dtype=f)
    perm = torch.arange(4)
    offs = torch.tensor([0, 4])
    cfg = torch.ones((2, 1), dtype=f)
    with pytest.raises(ValueError, match="metric codes"):
        kernels.sweep_stats(z, z, z, perm, offs, torch.ones(2, dtype=f),
                            cfg, cfg, metric_codes=(0, 1, 2, 1),
                            private=True)
    with pytest.raises(ValueError, match="lo, hi"):
        kernels.sweep_stats(z, z, z, perm, offs, torch.ones(2, dtype=f),
                            cfg, cfg, metric_codes=(0, 1), private=True)
    with pytest.raises(ValueError, match="private analysis needs sel"):
        kernels.sweep_report(torch.zeros((2, 1, 1, 5), dtype=f), None,
                             torch.zeros(1, dtype=f), torch.zeros(1, dtype=f),
                             cfg, torch.ones((8, 2), dtype=f),
                             torch.zeros(29, dtype=f), public=False)
