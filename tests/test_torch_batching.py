"""Megabatched serving on the port (pipelinedp_tpu_torch/service/batching.py
and the lane entries of kernels.py), on the CPU: the plain versions.

Bounds stated here:
  * each lane entry's plain version equals the solo plain kernels on each
    lane's slice, exactly (integers and floats);
  * a lane of the port's batched release equals the port's solo release on
    its rows and key alone, exactly (every output column, order, flags);
  * the port's batched release against the JAX package's
    batched_aggregate_release_kernel / batched_select_partitions_release_kernel
    (x64, CPU) on the same rows and keys: n_kept, the kept ids and their
    order exact; the directly noised columns (count, sum,
    privacy_id_count) within 256 ulp of max(1, |x|) under Laplace noise and
    64 ulp under Gaussian noise (tests/test_torch_threefry.py), the
    derived mean and variance within 1e-9 of max(1, |x|), the bound of
    tests/test_torch_engine.py; the specs of tests/test_torch_batching_specs
    .py within their solo tests' bounds: percentiles 1e-9 of max(1, |x|)
    (test_torch_quantiles.py), vector sums 1e-12 (test_torch_vector.py),
    secure count / privacy_id_count / sum / vector_sum exact and the rest
    1e-9 (test_torch_secure.py), safe float32 sums and counts within one
    float32 ulp at epsilon 1e7 (test_torch_safe.py, JAX with x64 off);
  * the service: every batched job equals its solo run (release, spent
    epsilon, ledger), and equals the JAX service's job with the same seed
    within the bounds of tests/test_torch_engine.py.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu import combiners as jax_combiners
from pipelinedp_tpu.ops import secure_noise as jax_secure
from pipelinedp_tpu.ops import selection_ops as jax_selection_ops
from pipelinedp_tpu.runtime import telemetry as jax_telemetry
from pipelinedp_tpu.service import DPAggregationService as JaxService
from pipelinedp_tpu.service import JobSpec as JaxJobSpec
from pipelinedp_tpu_torch import combiners
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.ops import selection_ops
from pipelinedp_tpu_torch.ops import threefry
from pipelinedp_tpu_torch.runtime import observability as obs
from pipelinedp_tpu_torch.runtime import telemetry
from pipelinedp_tpu_torch.runtime import trace
from pipelinedp_tpu_torch.service import (DPAggregationService, JobSpec,
                                          JobStatus)
from pipelinedp_tpu_torch.service import batching

pytestmark = pytest.mark.torch_port

F64 = torch.float64
LANES, LANE_ROWS, P = 3, 300, 12


@pytest.fixture(autouse=True)
def _epoch():
    telemetry.reset()
    yield
    trace.disable()
    telemetry.reset()


def lane_rows(seed, n_lanes=LANES, n=LANE_ROWS, users=60, partitions=P):
    """[L, n] rows; lanes 0 and 1 share their privacy ids (equal keys may
    sit side by side across the lane boundary)."""
    r = np.random.default_rng(seed)
    pid = torch.as_tensor(r.integers(0, users, (n_lanes, n)),
                          dtype=torch.int32)
    pid[1] = pid[0]
    pk = torch.as_tensor(r.integers(0, partitions, (n_lanes, n)),
                         dtype=torch.int32)
    values = torch.as_tensor(r.uniform(0.0, 5.0, (n_lanes, n)), dtype=F64)
    valid = torch.as_tensor(r.uniform(size=(n_lanes, n)) < 0.95)
    return pid, pk, values, valid


def lane_keys(n_lanes=LANES):
    keys = np.array([[0, 40 + l] for l in range(n_lanes)], np.uint32)
    keys[1] = keys[0]  # two lanes with one key
    return keys


def lane_salts(keys):
    salts, linf, _, _ = executor.lane_release_keys(keys, ())
    return salts, linf


# ---------------------------------------------------------------------------
# Each lane entry's plain version against the solo plain kernels.


def sorted_lane_rows():
    pid, pk, values, valid = lane_rows(1)
    salts, linf = lane_salts(lane_keys())
    flat = [t.reshape(-1) for t in (pid, pk, values, valid)]
    lane, k1, k2, u = kernels.row_keys_lanes(flat[0], flat[1], flat[3],
                                             LANE_ROWS, salts, linf, P, F64)
    perm = kernels.radix_sort([lane, k1, k2, u])
    return (pid, pk, values, valid), flat, (lane, k1, k2, u), perm, salts, \
        linf


def test_row_keys_lanes_plain_is_each_lanes_row_keys():
    (pid, pk, _, valid), _, (lane, k1, k2, u), _, salts, linf = \
        sorted_lane_rows()
    for l in range(LANES):
        sl = slice(l * LANE_ROWS, (l + 1) * LANE_ROWS)
        want = kernels.row_keys_plain(pid[l], pk[l], valid[l], salts[l],
                                      linf[l], P, F64)
        for got, exp in zip((k1[sl], k2[sl], u[sl]), want):
            assert torch.equal(got, exp)
        assert bool((lane[sl] == l).all())
    no_u = kernels.row_keys_lanes(pid.reshape(-1), pk.reshape(-1),
                                  valid.reshape(-1), LANE_ROWS, salts, None,
                                  P, None)
    assert no_u[3] is None and torch.equal(no_u[1], k1)


def test_sort_with_the_lane_word_sorts_each_lane_as_alone():
    _, _, (lane, k1, k2, u), perm, _, _ = sorted_lane_rows()
    for l in range(LANES):
        sl = slice(l * LANE_ROWS, (l + 1) * LANE_ROWS)
        solo = kernels.radix_sort_plain([k1[sl], k2[sl], u[sl]])
        assert torch.equal(perm[sl] - l * LANE_ROWS, solo)


@pytest.mark.parametrize("clip_pair_sum", [False, True])
@pytest.mark.parametrize("linf", [0, 2])
def test_bound_rows_lanes_plain_is_each_lanes_bound_rows(linf, clip_pair_sum):
    _, flat, (_, k1, k2, _), perm, _, _ = sorted_lane_rows()
    cols = ("sum", "nsum", "nsum2")
    args = dict(n_partitions=P, linf=linf, l0=3, clip_per_value=True,
                clip_pair_sum=clip_pair_sum,
                scalars=(0.0, 5.0, 0.0, 6.0, 2.5), columns=cols)
    key2, start, got = kernels.bound_rows_lanes(perm, k1, k2, flat[2],
                                                flat[3], lane_rows=LANE_ROWS,
                                                **args)
    for l in range(LANES):
        sl = slice(l * LANE_ROWS, (l + 1) * LANE_ROWS)
        w2, ws, wc = kernels.bound_rows_plain(perm[sl] - l * LANE_ROWS,
                                              k1[sl], k2[sl], None,
                                              flat[2][sl], flat[3][sl],
                                              **args)
        assert torch.equal(key2[sl], torch.where(w2 < P, w2 + l * P,
                                                 LANES * P).int())
        assert torch.equal(start[sl], ws)
        for c in cols:
            assert torch.equal(got[c][sl], wc[c])


def lane_partitions():
    _, flat, (_, k1, k2, _), perm, _, _ = sorted_lane_rows()
    cols = ("sum", "nsum", "nsum2")
    key2, start, row_cols = kernels.bound_rows_lanes(
        perm, k1, k2, flat[2], flat[3], lane_rows=LANE_ROWS, n_partitions=P,
        linf=2, l0=3, clip_per_value=True, clip_pair_sum=False,
        scalars=(0.0, 5.0, 0.0, 0.0, 2.5), columns=cols)
    perm2, skey2 = kernels.radix_sort([key2], sorted_top=True)
    return skey2, perm2, start, row_cols


def test_reduce_partitions_lanes_plain_is_each_lanes_reduction():
    skey2, perm2, start, row_cols = lane_partitions()
    got = kernels.reduce_partitions_lanes(skey2, perm2, start, row_cols,
                                          LANE_ROWS, P, F64)
    for l in range(LANES):
        lo, hi = (int(torch.searchsorted(skey2, torch.tensor(v, dtype=
                                                             torch.int32)))
                  for v in (l * P, (l + 1) * P))
        want = kernels.reduce_partitions_plain(skey2[lo:hi], perm2[lo:hi],
                                               start, row_cols, P, F64,
                                               base=l * P)
        for name, col in want.items():
            assert torch.equal(got[name][l * P:(l + 1) * P], col), name


@pytest.mark.parametrize("private", [False, True])
def test_release_epilogue_lanes_plain_is_each_lanes_epilogue(private):
    skey2, perm2, start, row_cols = lane_partitions()
    cols = kernels.reduce_partitions_lanes(skey2, perm2, start, row_cols,
                                           LANE_ROWS, P, F64)
    plan = [("variance", ("variance", "count", "sum", "mean"), 0),
            ("privacy_id_count", ("privacy_id_count",), 3)]
    stds = np.array([2.0, 5.0, 40.0, 1.5])
    slots = np.stack([[threefry.fold_in(k, s) for s in range(4)]
                      for k in lane_keys()])
    key_sel = lane_keys() + 7
    sel = (selection_ops.selection_params_from_host(
        tdp.PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 5.0, 1e-3, 3,
        None) if private else None)
    keep, outs, flags = kernels.release_epilogue_lanes(
        cols, plan, stds, slots, tdp.NoiseKind.GAUSSIAN, False, 2.5, 0.0,
        sel, key_sel, 1, LANES)
    assert flags.shape == (LANES,)
    for l in range(LANES):
        sl = slice(l * P, (l + 1) * P)
        wk, wo, wf = kernels.release_epilogue_plain(
            {k: c[sl] for k, c in cols.items()}, plan, stds, slots[l],
            tdp.NoiseKind.GAUSSIAN, False, 2.5, 0.0, sel,
            key_sel[l] if private else None, 1)
        assert torch.equal(keep[sl], wk)
        assert int(flags[l]) == int(wf[0])
        for name, col in wo.items():
            assert torch.equal(outs[name][sl], col)


def test_compact_kept_lanes_plain_compacts_each_lane():
    gen = torch.Generator().manual_seed(3)
    keep = torch.rand(LANES * P, generator=gen) < 0.5
    cols = {"a": torch.randn(LANES * P, generator=gen, dtype=F64),
            "b": torch.randn(LANES * P, generator=gen, dtype=F64)}
    n_kept, order, out = kernels.compact_kept_lanes(keep, cols, LANES)
    assert order.shape == (LANES, P)
    for l in range(LANES):
        sl = slice(l * P, (l + 1) * P)
        wn, wo, wc = kernels.compact_kept_plain(keep[sl],
                                                {k: c[sl] for k, c in
                                                 cols.items()})
        assert int(n_kept[l]) == int(wn) and torch.equal(order[l], wo)
        for k in cols:
            assert torch.equal(out[k][l], wc[k])


def test_lane_capacity_bounds_the_int32_keys():
    assert kernels.lane_capacity(1 << 20, 17_770) == 2047  # 2^31 rows
    assert kernels.lane_capacity(64, 48) == 65535
    pid = torch.zeros(2 * 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        kernels.row_keys_lanes(pid, pid, pid.bool(), 8,
                               np.zeros((2, 4), np.uint32), None,
                               (1 << 30), None)


# ---------------------------------------------------------------------------
# The batched release against the solo release, and against the JAX
# package's batched kernels.

# name: (metrics, noise, private selection, options). The options are the
# specs the lane entries of PERCENTILE, VECTOR_SUM, max_contributions,
# pre-bounded rows, secure noise and safe mode carry, alone and together:
# tree (a height-3, branching-4 quantile tree), chunk (quantile_chunk:
# below P the lazy descent), vector (VECTOR_SUM's norm), max_contributions,
# enforced (contribution bounds already enforced), secure (snap_grid_bits,
# None: none), safe (float32, numeric_mode="safe"), eps. Their rows are
# integer-valued and lane 2 keeps no row.
SPECS = {
    "count_sum_laplace_private": (("COUNT", "SUM"), "LAPLACE", True, {}),
    "pid_count_laplace_public": (("COUNT", "PRIVACY_ID_COUNT"), "LAPLACE",
                                 False, {}),
    "mean_variance_gaussian_public": (("VARIANCE", "MEAN", "COUNT", "SUM"),
                                      "GAUSSIAN", False, {}),
    "mean_gaussian_private": (("MEAN",), "GAUSSIAN", True, {}),
    "percentile_dense_laplace": (("PERCENTILE", "COUNT"), "LAPLACE", False,
                                 {"tree": 3}),
    "percentile_lazy_gaussian_private": (("PERCENTILE",), "GAUSSIAN", True,
                                         {"tree": 3, "chunk": 4}),
    "vector_sum_l2_gaussian": (("VECTOR_SUM", "COUNT"), "GAUSSIAN", False,
                               {"vector": "L2"}),
    "max_contributions_laplace": (("COUNT", "SUM", "MEAN"), "LAPLACE", False,
                                  {"max_contributions": 4}),
    "bounds_enforced_private": (("COUNT", "SUM"), "LAPLACE", True,
                                {"enforced": True}),
    "secure_laplace_private": (("COUNT", "PRIVACY_ID_COUNT", "SUM", "MEAN",
                                "VARIANCE"), "LAPLACE", True,
                               {"secure": None}),
    "secure_snapped_gaussian": (("COUNT", "SUM"), "GAUSSIAN", False,
                                {"secure": 2}),
    "safe_count_sum": (("COUNT", "SUM"), "LAPLACE", False,
                       {"safe": True, "eps": 1e7}),
    "secure_percentile_lazy_private": (("PERCENTILE", "SUM"), "LAPLACE",
                                       True, {"secure": None, "tree": 3,
                                              "chunk": 4}),
    "secure_max_contributions": (("COUNT", "SUM"), "GAUSSIAN", False,
                                 {"secure": None, "max_contributions": 3}),
    "secure_vector_enforced": (("VECTOR_SUM",), "LAPLACE", False,
                               {"secure": None, "vector": "Linf",
                                "enforced": True}),
    "safe_vector_l1_private": (("VECTOR_SUM", "COUNT"), "GAUSSIAN", True,
                               {"safe": True, "vector": "L1"}),
    "safe_enforced_variance_private": (("COUNT", "SUM", "VARIANCE"),
                                       "LAPLACE", True,
                                       {"safe": True, "enforced": True,
                                        "eps": 1e7}),
    "safe_secure_percentile": (("PERCENTILE", "COUNT", "SUM"), "GAUSSIAN",
                               False, {"safe": True, "secure": None,
                                       "tree": 3}),
}
# The specs held against the JAX package's batched kernel: the first four
# and one of each formerly solo-only spec.
JAX_SPECS = sorted(list(SPECS)[:4] + [
    "percentile_dense_laplace", "percentile_lazy_gaussian_private",
    "vector_sum_l2_gaussian", "max_contributions_laplace",
    "bounds_enforced_private", "secure_laplace_private",
    "secure_snapped_gaussian", "safe_count_sum"])
VECTOR_SIZE = 3


def spec_metrics(mod, metrics):
    out = []
    for m in metrics:
        out += ([mod.Metrics.PERCENTILE(q) for q in (10, 50, 90)]
                if m == "PERCENTILE" else [getattr(mod.Metrics, m)])
    return out


def spec_params(mod, metrics, noise, opts):
    bounds = dict(min_value=0.0, max_value=5.0)
    if opts.get("max_contributions"):
        bounds["max_contributions"] = opts["max_contributions"]
    else:
        bounds.update(max_partitions_contributed=3,
                      max_contributions_per_partition=2)
    if opts.get("vector"):
        del bounds["min_value"], bounds["max_value"]
        bounds.update(vector_size=VECTOR_SIZE, vector_max_norm=6.0,
                      vector_norm_kind=getattr(mod.NormKind, opts["vector"]))
    return mod.AggregateParams(
        metrics=spec_metrics(mod, metrics),
        noise_kind=getattr(mod.NoiseKind, noise),
        contribution_bounds_already_enforced=bool(opts.get("enforced")),
        **bounds)


def release_config(mod, comb, exe, sel_ops, metrics, noise, private,
                   opts=None, eps=50.0):
    """(cfg, stds, scalars, secure tables or None) of a spec on one
    package: the JAX tables as (thr_hi, thr_lo, gran), the port's as
    executor.build_secure_tables'."""
    opts = opts or {}
    acc = mod.NaiveBudgetAccountant(total_epsilon=opts.get("eps", eps),
                                    total_delta=1e-3)
    params = spec_params(mod, metrics, noise, opts)
    compound = comb.create_compound_combiner(params, acc)
    budget = (acc.request_budget(mod.MechanismType.GENERIC) if private
              else None)
    acc.compute_budgets()
    sel = (sel_ops.selection_params_from_host(
        params.partition_selection_strategy, budget.eps, budget.delta, 3,
        None) if private else None)
    secure = "secure" in opts
    cfg = exe.make_kernel_config(
        params, compound, P, private, sel, secure=secure,
        numeric_mode="safe" if opts.get("safe") else "fast")
    if "tree" in opts:
        cfg = dataclasses.replace(cfg, tree_height=opts["tree"], branching=4)
    if "chunk" in opts:
        cfg = dataclasses.replace(cfg, quantile_chunk=opts["chunk"])
    if mod is pdp:
        stds = exe.compute_noise_stds(compound, params)
        sens = exe.compute_noise_sensitivities(compound, params)
    else:
        stds = exe.compute_noise_stds(compound)
        sens = exe.compute_noise_sensitivities(compound, params)
    tables = None
    if secure:
        floor = opts["secure"]
        if mod is pdp:
            hi, lo, gran = jax_secure.build_tables(
                stds, params.noise_kind, sensitivities=sens,
                grid_floor=None if floor is None else 2.0**floor)
            tables = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(gran))
        else:
            tables = exe.build_secure_tables(stds, sens, params.noise_kind,
                                             floor, "cpu")
    return cfg, np.asarray(stds), exe.kernel_scalars(params), tables


def spec_rows(name):
    """The lanes' rows of a spec: lane_rows(5) for the first four specs;
    for the others integer values (vectors [L, n, 3] for VECTOR_SUM,
    float32 in safe mode) and a lane 2 that keeps no row."""
    pid, pk, values, valid = lane_rows(5, users=400)
    opts = SPECS[name][3]
    if not opts:
        return pid, pk, values, valid
    r = np.random.default_rng(11)
    if opts.get("vector"):
        values = torch.as_tensor(
            r.integers(-3, 4, (LANES, LANE_ROWS, VECTOR_SIZE)), dtype=F64)
    else:
        values = torch.floor(values)
    valid[2] = False
    return pid, pk, values.to(torch.float32 if opts.get("safe") else F64), \
        valid


def port_release(name):
    cfg, stds, sc, tables = release_config(tdp, combiners, executor,
                                           selection_ops, *SPECS[name])
    pid, pk, values, valid = spec_rows(name)
    keys = lane_keys()
    return (pid, pk, values, valid, keys, cfg, stds, sc, tables,
            executor.batched_aggregate_release_kernel(
                pid, pk, values, valid, *sc, stds, keys, cfg, tables))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_batched_lane_equals_its_solo_release(name):
    pid, pk, values, valid, keys, cfg, stds, sc, tables, got = \
        port_release(name)
    n_kept, order, outputs, flags = got
    assert int(n_kept.sum()) > 0
    for l in range(LANES):
        want = executor.aggregate_release_kernel(
            pid[l], pk[l], values[l], valid[l], *sc, stds, keys[l], cfg,
            tables)
        assert int(n_kept[l]) == int(want[0])
        assert torch.equal(order[l], want[1])
        assert set(outputs) == set(want[2])
        for col, exp in want[2].items():
            assert torch.equal(outputs[col][l], exp), col
        assert int(flags[l]) == int(want[3].reshape(()))


def test_a_lane_without_rows_equals_its_solo_release():
    cfg, stds, sc, _ = release_config(tdp, combiners, executor,
                                      selection_ops,
                                      *SPECS["count_sum_laplace_private"])
    pid, pk, values, valid = lane_rows(6, users=400)
    valid[0] = False
    keys = lane_keys()
    n_kept, order, outputs, flags = executor.batched_aggregate_release_kernel(
        pid, pk, values, valid, *sc, stds, keys, cfg)
    for l in range(LANES):
        want = executor.aggregate_release_kernel(
            pid[l], pk[l], values[l], valid[l], *sc, stds, keys[l], cfg)
        assert int(n_kept[l]) == int(want[0])
        assert torch.equal(order[l], want[1])
        for col, exp in want[2].items():
            assert torch.equal(outputs[col][l], exp), col
    assert int(n_kept[0]) == 0


def ulp_bound(noise, name):
    if name in ("mean", "variance"):
        return None
    return 256 if noise == "LAPLACE" else 64


def assert_within_spec_bounds(name, col, a, b):
    """The port's released column a against JAX's b (kept partitions)
    within the bound the spec's solo tests state (module docstring)."""
    metrics, noise, _, opts = SPECS[name]
    scale = np.maximum(1.0, np.abs(b))
    if opts.get("safe"):
        ulp32 = np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(a - b) <= ulp32), col
    elif "secure" in opts and col in ("count", "privacy_id_count", "sum",
                                      "vector_sum"):
        np.testing.assert_array_equal(a, b, err_msg=col)
    elif col == "vector_sum":
        assert np.all(np.abs(a - b) <= 1e-12 * scale), col
    elif "secure" in opts or col.startswith("percentile"):
        assert np.all(np.abs(a - b) <= 1e-9 * scale), col
    else:
        bound = ulp_bound(noise, col)
        if bound is None:
            assert np.all(np.abs(a - b) <= 1e-9 * scale), col
        else:
            assert np.all(np.abs(a - b) <= bound * np.spacing(scale)), col


@pytest.fixture
def x64_off():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("name", JAX_SPECS)
def test_batched_release_matches_the_jax_batched_kernel(name, request):
    if SPECS[name][3].get("safe"):
        request.getfixturevalue("x64_off")
    pid, pk, values, valid, keys, _, _, _, _, got = port_release(name)
    cfg, stds, sc, tables = release_config(pdp, jax_combiners, jax_executor,
                                           jax_selection_ops, *SPECS[name])
    want = jax_executor.batched_aggregate_release_kernel(
        jnp.asarray(pid.numpy()), jnp.asarray(pk.numpy()),
        jnp.asarray(values.numpy()), jnp.asarray(valid.numpy()), *sc,
        jnp.asarray(stds), jnp.asarray(keys), cfg, secure_tables=tables)
    n_kept, order, outputs, _ = got
    for l in range(LANES):
        k = int(want[0][l])
        assert int(n_kept[l]) == k
        assert np.array_equal(order[l][:k].numpy(),
                              np.asarray(want[1][l][:k]))
        assert set(outputs) == set(want[2])
        for col, exp in want[2].items():
            assert_within_spec_bounds(
                name, col, outputs[col][l][:k].double().numpy(),
                np.asarray(exp[l][:k], np.float64))


@pytest.mark.parametrize("strategy", ["TRUNCATED_GEOMETRIC",
                                      "LAPLACE_THRESHOLDING",
                                      "GAUSSIAN_THRESHOLDING"])
def test_batched_selection_matches_solo_and_jax(strategy):
    pid, pk, _, valid = lane_rows(9, users=2000, n=3000)
    keys = lane_keys()
    sel = selection_ops.selection_params_from_host(
        getattr(tdp.PartitionSelectionStrategy, strategy), 3.0, 1e-3, 2,
        None)
    n_kept, order = executor.batched_select_partitions_release_kernel(
        pid, pk, valid, keys, 2, P, sel, F64)
    assert int(n_kept.sum()) > 0
    jsel = jax_selection_ops.selection_params_from_host(
        getattr(pdp.PartitionSelectionStrategy, strategy), 3.0, 1e-3, 2,
        None)
    jn, jorder = jax_executor.batched_select_partitions_release_kernel(
        jnp.asarray(pid.numpy()), jnp.asarray(pk.numpy()),
        jnp.asarray(valid.numpy()), jnp.asarray(keys), 2, P, jsel)
    for l in range(LANES):
        solo = executor.select_partitions_release_kernel(
            pid[l], pk[l], valid[l], keys[l], 2, P, sel, F64)
        assert int(n_kept[l]) == int(solo[0]) == int(jn[l])
        assert torch.equal(order[l], solo[1])
        k = int(jn[l])
        assert np.array_equal(order[l][:k].numpy(), np.asarray(jorder[l][:k]))


def test_unported_specs_are_named():
    """The specs that ran solo before their lane entries (PERCENTILE,
    VECTOR_SUM, max_contributions, pre-bounded rows, secure noise, safe
    mode) all batch now: lanes_unported is gone, and what the batched
    release still refuses it names. A secure spec without its tables and
    more lanes than its tables allow raise before any launch."""
    assert not hasattr(executor, "lanes_unported")
    assert not hasattr(batching, "_unported")
    cfg, stds, sc, tables = release_config(
        tdp, combiners, executor, selection_ops,
        *SPECS["secure_laplace_private"])
    with pytest.raises(ValueError, match="secure_tables"):
        executor.batched_aggregate_release_kernel(
            *spec_rows("secure_laplace_private"), *sc, stds, lane_keys(),
            cfg)
    cfg, stds, sc, _ = release_config(tdp, combiners, executor,
                                      selection_ops,
                                      *SPECS["percentile_dense_laplace"])
    wide = dataclasses.replace(cfg, tree_height=8, branching=16,
                               quantile_chunk=P)
    assert executor.batched_lane_capacity(wide, LANE_ROWS) == 0
    with pytest.raises(ValueError, match="lanes"):
        executor.batched_aggregate_release_kernel(
            *spec_rows("percentile_dense_laplace"), *sc, stds, lane_keys(),
            wide)


# ---------------------------------------------------------------------------
# The service with batching on.


def rows(seed, n=200, users=40, partitions=10):
    r = np.random.default_rng(seed)
    return [(int(r.integers(0, users)), f"p{int(r.integers(0, partitions))}",
             float(r.uniform(0, 5))) for _ in range(n)]


PUBLIC = [f"p{i}" for i in range(10)]


def agg_spec(mod, seed, metrics=("COUNT", "SUM"), priority=0, public=True,
             spec_cls=JobSpec, noise="LAPLACE", epsilon=1.0):
    params = mod.AggregateParams(
        metrics=[getattr(mod.Metrics, m) for m in metrics],
        noise_kind=getattr(mod.NoiseKind, noise),
        max_partitions_contributed=2, max_contributions_per_partition=3,
        min_value=0.0, max_value=5.0)
    return spec_cls(params=params, epsilon=epsilon, delta=1e-3,
                    noise_seed=seed, priority=priority,
                    public_partitions=PUBLIC if public else None)


def select_spec(mod, seed, spec_cls=JobSpec):
    return spec_cls(params=mod.SelectPartitionsParams(
        max_partitions_contributed=2), epsilon=3.0, delta=1e-3,
        noise_seed=seed)


def torch_backend():
    return tdp.TorchBackend(device="cpu", dtype=F64)


def run_service(jobs, batching, window_ms=30_000.0, **kwargs):
    """Runs (tenant, spec, rows) jobs at once; returns results, spent
    epsilons, the reconciliation verdict and each tenant's ledger trail."""
    service_kwargs = dict(max_concurrent_jobs=len(jobs), batching=batching,
                          batch_window_ms=window_ms,
                          max_batch_jobs=max(2, len(jobs)))
    service_kwargs.update(kwargs)
    with DPAggregationService(torch_backend(), **service_kwargs) as svc:
        handles = [svc.submit(t, s, r) for t, s, r in jobs]
        results = [h.result(timeout=120) for h in handles]
        spent = [h.spent_epsilon for h in handles]
        trails = {t: svc.tenant_ledger(t).records() for t, _, _ in jobs}
        reconciled = svc.ledgers_reconciled()
    return results, spent, reconciled, trails


def batch_counters():
    snap = telemetry.snapshot()
    return (snap.get("service_batch_launches", 0),
            snap.get("service_jobs_batched", 0))


@pytest.mark.hard_timeout(120)
@pytest.mark.parametrize("metrics,public", [
    (("COUNT", "SUM"), True), (("MEAN",), True),
    (("COUNT", "PRIVACY_ID_COUNT"), False)],
    ids=["count_sum", "mean", "pid_count_private"])
def test_batched_jobs_equal_their_solo_runs(metrics, public):
    jobs = [(f"tenant{i}", agg_spec(tdp, 50 + i, metrics, public=public,
                                    epsilon=1.0 if public else 20.0),
             rows(7 + i, users=400)) for i in range(4)]
    solo = run_service(jobs, batching=False)
    assert batch_counters() == (0, 0)
    batched = run_service(jobs, batching=True)
    assert batch_counters() == (1, 4)
    assert solo[2] and batched[2]
    assert solo[1] == batched[1]
    assert solo[3] == batched[3]
    assert solo[0] == batched[0]
    assert any(solo[0])


@pytest.mark.hard_timeout(120)
def test_batched_selection_jobs_equal_their_solo_runs():
    jobs = [(f"tenant{i}", select_spec(tdp, 70 + i),
             rows(19 + i, n=300, users=300)) for i in range(3)]
    solo = run_service(jobs, batching=False)
    batched = run_service(jobs, batching=True)
    assert batch_counters() == (1, 3)
    assert solo[0] == batched[0] and any(solo[0])
    assert solo[1] == batched[1] and solo[3] == batched[3]


@pytest.mark.hard_timeout(180)
@pytest.mark.parametrize("batching", [False, True])
def test_service_equals_the_jax_service_job_by_job(batching):
    jobs = [(f"tenant{i}", i, rows(31 + i, users=400)) for i in range(3)]
    port = run_service([(t, agg_spec(tdp, 90 + s, ("COUNT", "SUM", "MEAN")),
                         r) for t, s, r in jobs], batching=batching)
    jax_telemetry.reset()
    with JaxService(pdp.TPUBackend(), max_concurrent_jobs=3,
                    batching=batching, batch_window_ms=30_000.0,
                    max_batch_jobs=3) as svc:
        handles = [svc.submit(t, agg_spec(pdp, 90 + s, ("COUNT", "SUM",
                                                         "MEAN"),
                                          spec_cls=JaxJobSpec), r)
                   for t, s, r in jobs]
        want = [h.result(timeout=120) for h in handles]
        want_spent = [svc.tenant_ledger(t).job_spent_epsilon(h.job_id)
                      for (t, _, _), h in zip(jobs, handles)]
    jax_telemetry.reset()
    assert port[1] == want_spent
    for got, exp in zip(port[0], want):
        assert set(got) == set(exp) and got
        for key, metrics in exp.items():
            assert got[key]._fields == metrics._fields
            for a, b in zip(got[key], metrics):
                assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)


@pytest.mark.hard_timeout(120)
def test_mixed_specs_never_coalesce():
    jobs = [("ta", agg_spec(tdp, 1, ("COUNT",)), rows(1)),
            ("tb", agg_spec(tdp, 2, ("SUM",)), rows(2))]
    solo = run_service(jobs, batching=False, window_ms=200.0)
    batched = run_service(jobs, batching=True, window_ms=200.0)
    assert batch_counters() == (0, 0)
    assert batched[2] and solo[0] == batched[0]


@pytest.mark.hard_timeout(120)
def test_lone_window_runs_solo():
    job = [("t0", agg_spec(tdp, 5), rows(5))]
    solo = run_service(job, batching=False, window_ms=100.0)
    batched = run_service(job, batching=True, window_ms=100.0)
    assert batch_counters() == (0, 0)
    assert solo[0] == batched[0]


@pytest.mark.hard_timeout(120)
def test_unported_specs_run_solo_and_are_counted():
    """The percentile jobs that once ran solo (counted under a counter that
    is gone) coalesce now: one batched launch of both jobs, each equal to
    its solo run."""
    params = tdp.AggregateParams(
        metrics=[tdp.Metrics.PERCENTILE(50)], max_partitions_contributed=2,
        max_contributions_per_partition=3, min_value=0.0, max_value=5.0)
    jobs = [(f"t{i}", JobSpec(params=params, epsilon=1.0, delta=1e-6,
                              noise_seed=60 + i, public_partitions=PUBLIC),
             rows(60 + i)) for i in range(2)]
    solo = run_service(jobs, batching=False)
    batched = run_service(jobs, batching=True)
    assert batch_counters() == (1, 2)
    assert "service_jobs_solo_unported" not in telemetry.snapshot()
    assert solo[0] == batched[0] and all(solo[0])


@pytest.mark.hard_timeout(120)
def test_priority_is_kept_with_batching():
    with DPAggregationService(torch_backend(), max_concurrent_jobs=1,
                              batching=True, batch_window_ms=50.0,
                              max_batch_jobs=4,
                              queue_timeout_s=300.0) as svc:
        first = svc.submit("t0", agg_spec(tdp, 10), rows(3))
        late = svc.submit("t1", agg_spec(tdp, 11, priority=5), rows(3))
        urgent = svc.submit("t2", agg_spec(tdp, 12, priority=1), rows(3))
        for h in (first, late, urgent):
            h.result(timeout=120)
        assert urgent._started_at < late._started_at


@pytest.mark.hard_timeout(120)
def test_stop_wakes_a_pending_window():
    jobs = [(f"tenant{i}", agg_spec(tdp, 110 + i), rows(41 + i))
            for i in range(2)]
    solo = run_service(jobs, batching=False)
    telemetry.reset()
    with DPAggregationService(torch_backend(), max_concurrent_jobs=2,
                              batching=True, batch_window_ms=120_000.0,
                              max_batch_jobs=8) as svc:
        handles = [svc.submit(t, s, r) for t, s, r in jobs]
        deadline = time.monotonic() + 60.0
        while (not all(h.status == JobStatus.RUNNING for h in handles)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        time.sleep(0.5)
        svc.stop()
        results = [h.result(timeout=60) for h in handles]
        assert svc.ledgers_reconciled()
    assert batch_counters() == (1, 2)
    assert results == solo[0]


@pytest.mark.hard_timeout(120)
def test_batch_metrics_export_and_span():
    trace.enable()
    jobs = [(f"tenant{i}", agg_spec(tdp, 150 + i), rows(61 + i))
            for i in range(3)]
    run_service(jobs, batching=True)
    assert batch_counters() == (1, 3)
    assert telemetry.gauge_snapshot()["service_batch_occupancy"][""] == 3.0
    parsed = obs.parse_prometheus(obs.render_prometheus())
    assert parsed["pdp_service_batch_launches"]["type"] == "counter"
    assert parsed["pdp_service_batch_launches"]["samples"][""] == 1.0
    assert parsed["pdp_service_jobs_batched"]["samples"][""] == 3.0
    assert parsed["pdp_service_batch_occupancy"]["samples"][""] == 3.0
    spans = [e for e in trace.to_trace_events()["traceEvents"]
             if e["name"] == "batch_dispatch"]
    assert len(spans) == 1
    assert spans[0]["args"]["lanes"] == 3
    assert spans[0]["args"]["lane_bucket"] == 3
    assert trace.trace_summary()["spans"]["batch_dispatch"]["count"] == 1


@pytest.mark.hard_timeout(120)
def test_a_failed_batched_release_fails_every_lane(monkeypatch):
    calls = []

    def broken(*args, **kwargs):
        calls.append(threading.current_thread().name)
        raise RuntimeError("injected lane-entry launch failure")

    monkeypatch.setattr(executor, "batched_aggregate_release_kernel", broken)
    solo_calls = []
    original = executor.aggregate_release_kernel

    def solo(*args, **kwargs):
        solo_calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(executor, "aggregate_release_kernel", solo)
    jobs = [(f"tenant{i}", agg_spec(tdp, 170 + i), rows(71 + i))
            for i in range(3)]
    with DPAggregationService(torch_backend(), max_concurrent_jobs=3,
                              batching=True, batch_window_ms=30_000.0,
                              max_batch_jobs=3) as svc:
        handles = [svc.submit(t, s, r) for t, s, r in jobs]
        for h in handles:
            with pytest.raises(RuntimeError, match="injected lane-entry"):
                h.result(timeout=60)
            assert h.status == JobStatus.FAILED
            # Mechanisms had registered: the whole grant is forfeit.
            ledger = svc.tenant_ledger(h.tenant_id)
            assert ledger.job_spent_epsilon(h.job_id) == 1.0
            assert ledger.records()[0]["metric"] == "admission_grant_forfeit"
    assert len(calls) == 1
    assert not solo_calls, "a failed batched release never falls back"
    assert batch_counters() == (0, 0)


def test_group_key_splits_what_a_lane_cannot_share():
    base = dict(kind="aggregate", pid=np.zeros(8, np.int32),
                pk=np.zeros(8, np.int32), valid=np.ones(8, bool),
                key=np.zeros(2, np.uint32), device=torch.device("cpu"),
                dtype=F64, values=np.zeros(8), scalars=(0.0,) * 5,
                stds=np.ones(2), cfg=None)
    a = executor.ReleaseLaunch(**base)
    assert batching._group_key(a) == batching._group_key(
        executor.ReleaseLaunch(**dict(base, key=np.ones(2, np.uint32))))
    for change in (dict(stds=np.full(2, 2.0)), dict(dtype=torch.float32),
                   dict(pid=np.zeros(16, np.int32),
                        values=np.zeros(16))):
        assert batching._group_key(a) != batching._group_key(
            executor.ReleaseLaunch(**dict(base, **change)))


@pytest.mark.hard_timeout(60)
def test_launch_counts_survive_concurrent_workers():
    """The service's workers count launches from many threads at once: no
    increment is lost (more threads than cores, a short switch
    interval)."""
    import sys
    kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernels._count("row_keys_lanes")
                            for _ in range(2000)]) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts["row_keys_lanes"] == 32 * 2000
    kernels.reset_launch_counts()
