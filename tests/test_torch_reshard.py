"""The port's pid reshard (parallel/reshard.py) and the plain versions of
C22 reshard_count and C23 reshard_exchange, held against the JAX
package's reshard on its 8 CPU devices.

Bounds stated here: every comparison is exact (==). C22's destinations
equal _dest_shard's and its [D, D] table gives _count_stats_kernel's
[max send, max receive, total]; device_reshard_rows_by_pid (C22 + C23)
equals the JAX package's _exchange_kernel / device_reshard_rows_by_pid
row for row, padding included; the host path equals shard_rows_by_pid's
layout.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinedp_tpu.parallel import mesh as jax_mesh
from pipelinedp_tpu.parallel import reshard as jax_reshard
from pipelinedp_tpu.parallel import sharded as jax_sharded
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import mesh
from pipelinedp_tpu_torch.parallel import reshard
from pipelinedp_tpu_torch.runtime import telemetry

pytestmark = pytest.mark.torch_port

SHARD_COUNTS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _fresh_caches():
    reshard.reset_capacity_cache()
    jax_reshard.reset_capacity_cache()
    yield
    reshard.reset_capacity_cache()
    jax_reshard.reset_capacity_cache()


def rows(seed: int, n: int = 1500, width=None, users: int = 300,
         dominant: bool = False):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n).astype(np.int32)
    if dominant:
        pid[: n * 3 // 4] = 7
    pk = rng.integers(0, 20, n).astype(np.int32)
    shape = (n,) if width is None else (n, width)
    values = rng.uniform(-5, 5, shape)
    valid = rng.uniform(size=n) < 0.85
    return pid, pk, values, valid


def port_mesh(n_shards: int):
    return mesh.make_mesh(["cpu"] * n_shards)


def concat(shards, j):
    parts = [s[j] for s in shards]
    return None if parts[0] is None else torch.cat(parts).numpy()


def assert_rows_equal(got_shards, want):
    for j, w in enumerate(want):
        np.testing.assert_array_equal(concat(got_shards, j), np.asarray(w))


# ---------------------------------------------------------------------------
# C22


@pytest.mark.parametrize("salt", [0, 12345, 0xFFFFFFFF])
def test_dest_shard_equals_jax(salt):
    pid = np.concatenate([np.arange(-50, 4000), [2**31 - 1, -2**31]]).astype(
        np.int32)
    for d in (1, 2, 3, 4, 8):
        got = kernels.dest_shard(torch.from_numpy(pid), d, salt)
        want = jax_reshard._dest_shard(jnp.asarray(pid), d, salt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_reshard_count_plain_ranks_and_counts(n_shards):
    pid, _, _, valid = rows(1)
    dest, rank, counts = kernels.reshard_count(
        torch.from_numpy(pid), torch.from_numpy(valid), n_shards, 99)
    want_dest = np.where(
        valid, np.asarray(jax_reshard._dest_shard(jnp.asarray(pid), n_shards,
                                                  99)), n_shards)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(want_dest, minlength=n_shards + 1))
    seen = np.zeros(n_shards + 1, np.int64)
    for i, d in enumerate(want_dest):  # the stable rank, row by row
        assert rank[i] == seen[d]
        seen[d] += 1


@pytest.mark.parametrize("n_shards", SHARD_COUNTS[1:])
def test_count_table_gives_the_jax_stats(n_shards):
    pid, pk, values, valid = rows(2, dominant=n_shards == 4)
    per_in = mesh.rows_per_shard(len(pid), n_shards)
    jmesh = jax_mesh.make_mesh(n_devices=n_shards)
    jcols = jax_reshard._pad_and_shard(jmesh, per_in, jnp.asarray(pid),
                                       jnp.asarray(pk), jnp.asarray(values),
                                       jnp.asarray(valid))
    want = np.asarray(jax_reshard._count_stats_kernel(jcols[0], jcols[3],
                                                      n_shards, 0, jmesh))
    shards = reshard._pad_and_shard(port_mesh(n_shards), per_in,
                                    *map(torch.from_numpy,
                                         (pid, pk, values, valid)))
    table = np.stack([kernels.reshard_count(s[0], s[3], n_shards)[2][
        :n_shards].numpy() for s in shards])
    recv = table.sum(axis=0)
    np.testing.assert_array_equal([table.max(), recv.max(), recv.sum()],
                                  want)


# ---------------------------------------------------------------------------
# C23 and the device reshard


def jax_exchange(n_shards, pid, pk, values, valid):
    """The JAX package's exchange at the capacities its stats give."""
    jmesh = jax_mesh.make_mesh(n_devices=n_shards)
    per_in = jax_mesh.rows_per_shard(len(pid), n_shards)
    cols = jax_reshard._pad_and_shard(jmesh, per_in, jnp.asarray(pid),
                                      jnp.asarray(pk), jnp.asarray(values),
                                      jnp.asarray(valid))
    max_send, max_recv, _ = (int(x) for x in np.asarray(
        jax_reshard._count_stats_kernel(cols[0], cols[3], n_shards, 0,
                                        jmesh)))
    return jax_reshard._exchange_kernel(
        *cols, jax_mesh.round_capacity(max_send),
        jax_mesh.round_capacity(max_recv), n_shards, 0, jmesh)


@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("n_shards", SHARD_COUNTS[1:])
def test_exchange_equals_jax_exchange_row_for_row(n_shards, width):
    pid, pk, values, valid = rows(3 + n_shards, width=width)
    want = jax_exchange(n_shards, pid, pk, values, valid)
    got = reshard.device_reshard_rows_by_pid(
        port_mesh(n_shards), *map(torch.from_numpy, (pid, pk, values,
                                                     valid)))
    assert len(got) == n_shards
    assert len({s[0].shape[0] for s in got}) == 1
    assert_rows_equal(got, want)


@pytest.mark.parametrize("width", [None, 2])
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_device_reshard_equals_jax(n_shards, width):
    pid, pk, values, valid = rows(20 + n_shards, width=width)
    want = jax_reshard.device_reshard_rows_by_pid(
        jax_mesh.make_mesh(n_devices=n_shards), jnp.asarray(pid),
        jnp.asarray(pk), jnp.asarray(values), jnp.asarray(valid))
    got = reshard.device_reshard_rows_by_pid(
        port_mesh(n_shards), *map(torch.from_numpy, (pid, pk, values,
                                                     valid)))
    assert_rows_equal(got, want)
    # Every privacy id's valid rows on one shard.
    owner = {}
    for s, (s_pid, _, _, s_valid) in enumerate(got):
        for p in s_pid[s_valid].tolist():
            assert owner.setdefault(p, s) == s


def test_device_reshard_through_staged_slices():
    """Slots that differ as devices (cpu and cpu:0) take the staged
    slices and the copies of collectives.all_to_all: the same rows."""
    pid, pk, values, valid = rows(31, width=2)
    cols = tuple(map(torch.from_numpy, (pid, pk, values, valid)))
    same = reshard.device_reshard_rows_by_pid(port_mesh(4), *cols)
    reshard.reset_capacity_cache()
    split = reshard.device_reshard_rows_by_pid(
        mesh.Mesh(["cpu", "cpu:0", "cpu", "cpu:0"]), *cols)
    for j in range(4):
        np.testing.assert_array_equal(concat(split, j), concat(same, j))


def test_device_reshard_of_no_rows():
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0),
             np.zeros(0, bool))
    for n_shards in SHARD_COUNTS:
        want = jax_reshard.device_reshard_rows_by_pid(
            jax_mesh.make_mesh(n_devices=n_shards), *map(jnp.asarray, empty))
        got = reshard.device_reshard_rows_by_pid(
            port_mesh(n_shards), *map(torch.from_numpy, empty))
        assert_rows_equal(got, want)
        assert not any(bool(s[3].any()) for s in got)


def test_dominant_pid_warns_and_stays_exact(caplog):
    pid, pk, values, valid = rows(5, dominant=True)
    with caplog.at_level(logging.WARNING):
        got = reshard.device_reshard_rows_by_pid(
            port_mesh(4), *map(torch.from_numpy, (pid, pk, values, valid)))
    assert "max shard load" in caplog.text
    assert_rows_equal(got, jax_exchange(4, pid, pk, values, valid))


def test_capacity_cache_reuses_a_fitting_geometry():
    telemetry.reset()
    pid, pk, values, valid = rows(6)
    cols = tuple(map(torch.from_numpy, (pid, pk, values, valid)))
    first = reshard.device_reshard_rows_by_pid(port_mesh(4), *cols)
    # Fewer valid rows at the same geometry fit the cached capacities.
    fewer = cols[:3] + (cols[3] & (cols[0] % 2 == 0),)
    second = reshard.device_reshard_rows_by_pid(port_mesh(4), *fewer)
    assert second[0][0].shape == first[0][0].shape
    assert telemetry.snapshot().get("reshard_capacity_reuse", 0) == 1
    telemetry.reset()


# ---------------------------------------------------------------------------
# stage_rows_to_mesh


def test_stage_rejects_a_bad_mode():
    pid, pk, values, valid = rows(7, n=20)
    with pytest.raises(ValueError, match="auto|host|device"):
        reshard.stage_rows_to_mesh(port_mesh(2), pid, pk, values, valid,
                                   reshard="collective")


@pytest.mark.parametrize("n_shards", [2, 8])
def test_host_staging_is_the_lpt_layout(n_shards):
    pid, pk, values, valid = rows(8)
    got = reshard.stage_rows_to_mesh(port_mesh(n_shards), pid, pk, values,
                                     valid, dtype=torch.float64)
    want = jax_sharded.shard_rows_by_pid(pid, pk, values, valid, n_shards)
    assert_rows_equal(got, want)
    # Device tensors forced onto the host path take the same layout.
    forced = reshard.stage_rows_to_mesh(
        port_mesh(n_shards), *map(torch.from_numpy, (pid, pk, values,
                                                     valid)),
        reshard="host", dtype=torch.float64)
    assert_rows_equal(forced, want)


def test_host_rows_forced_onto_the_device_exchange():
    pid, pk, values, valid = rows(9)
    got = reshard.stage_rows_to_mesh(port_mesh(4), pid, pk, values, valid,
                                     reshard="device", dtype=torch.float64)
    assert_rows_equal(got, jax_exchange(4, pid, pk, values, valid))


def test_selection_staging_carries_no_values():
    pid, pk, _, valid = rows(10)
    for mode in ("host", "device"):
        got = reshard.stage_rows_to_mesh(port_mesh(4), pid, pk, None, valid,
                                         reshard=mode)
        assert all(s[2] is None for s in got)
        assert sum(int(s[3].sum()) for s in got) == int(valid.sum())


def test_device_path_moves_no_row_through_the_host():
    pid, pk, values, valid = rows(11, n=20000, users=5000)
    cols = tuple(map(torch.from_numpy, (pid, pk, values, valid)))
    with reshard.forbid_row_fetches():
        got = reshard.stage_rows_to_mesh(port_mesh(8), *cols)
    assert sum(int(s[3].sum()) for s in got) == int(valid.sum())
    with reshard.forbid_row_fetches():
        with pytest.raises(AssertionError, match="O\\(rows\\)"):
            cols[0].numpy()
        with pytest.raises(AssertionError, match="O\\(rows\\)"):
            np.asarray(cols[2])
        # A control table passes.
        assert mesh.host_fetch(cols[0]).shape == (20000,)
    assert cols[0].numpy().shape == (20000,)
