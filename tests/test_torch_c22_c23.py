"""C22 reshard_count's and C23 reshard_exchange's plain versions at the
edge shapes of chip_smoke.py's c22_c23_edge_phase, held against the JAX
package's reshard on the CPU, and the host plans of their wrappers.

Bounds stated here: every comparison is exact (==).
  * C22 at D = 1, 2, 3, 4, 8, 32 and 64; n = 0, 1, a tile (RESHARD_TILE)
    less one, a tile and a tile and one; ids at random, no row valid and
    every valid row to one destination: dest is the JAX _dest_shard (D for
    an invalid row), rank the row's stable rank in its bucket, counts the
    numpy bincount. For D <= 8 the [D, D] table of D such shards gives the
    JAX _count_stats_kernel's [max send, max receive, total] on D of the
    package's 8 CPU devices.
  * C23 at D = 1, 2, 3, 4 and 8 on n = 0, 1 and its own tile
    (EXCHANGE_TILE) less one, the tile and one more, the same patterns,
    float64 [n, 5] values, into the destinations' own columns (and into
    staged slices copied into place at a tile and one): the received
    columns equal the JAX _exchange_kernel's row for row, padding
    included. Each D compiles one JAX shape: its shards are the port's
    shards padded with invalid rows
    to a tile and one (an invalid row does not move, so the rows received
    are the same), its capacities hold every row a shard could send or
    receive, and past the port's out_cap its rows are padding only.
  * C23's fill from row 0 (a shard that receives nothing) and from
    out_cap (a shard whose receive fills its buffer) both occur.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinedp_tpu.parallel import mesh as jax_mesh
from pipelinedp_tpu.parallel import reshard as jax_reshard
from pipelinedp_tpu_torch import cuda_build
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel.mesh import round_capacity

pytestmark = pytest.mark.torch_port

TILE = kernels.RESHARD_TILE
SIZES = (0, 1, TILE - 1, TILE, TILE + 1)
# C23's tiles (the exchange holds C22's tables at these sizes too).
TILE23 = cuda_build.EXCHANGE_TILE
SIZES23 = (0, 1, TILE23 - 1, TILE23, TILE23 + 1)
PATTERNS = ("random", "invalid", "one")
WIDTH = 5


def shard_rows(seed, n, d, pattern):
    """(pid, pk, values float64 [n, WIDTH], valid) of one shard: ids at
    random (9 in 10 valid), no row valid, or every row valid with an id
    that goes to destination 0."""
    rng = np.random.default_rng(seed)
    if pattern == "one":
        cand = rng.integers(-2**31, 2**31, 2 * d * n + 64).astype(np.int32)
        to_zero = kernels.dest_shard(torch.from_numpy(cand), d, 0) == 0
        pid = cand[to_zero.numpy()][:n]
        assert len(pid) == n
        valid = np.ones(n, bool)
    else:
        pid = rng.integers(0, 2 * n + 1, n).astype(np.int32)
        valid = (rng.random(n) < 0.9) if pattern == "random" else np.zeros(
            n, bool)
    pk = rng.integers(-3, 1 << 20, n).astype(np.int32)
    values = rng.normal(size=(n, WIDTH))
    return pid, pk, values, valid


def mesh_rows(d, n, pattern):
    return [shard_rows(1000 * d + 7 * n + s, n, d, pattern)
            for s in range(d)]


# ---------------------------------------------------------------------------
# C22


COUNT_CASES = [(n, pattern) for n in SIZES for pattern in PATTERNS]


@functools.lru_cache(maxsize=None)
def count_cases(d):
    """{(n, pattern): (pid, valid, the JAX _dest_shard of pid)}: one JAX
    call over every case's ids, padded to one length for every D."""
    rows = {case: shard_rows(d + case[0], case[0], d, case[1])
            for case in COUNT_CASES}
    pids = np.concatenate([rows[case][0] for case in COUNT_CASES])
    padded = np.zeros(len(PATTERNS) * sum(SIZES), np.int32)
    padded[:len(pids)] = pids
    dest = np.asarray(jax_reshard._dest_shard(jnp.asarray(padded), d, 0))
    out, at = {}, 0
    for case in COUNT_CASES:
        pid, _, _, valid = rows[case]
        out[case] = (pid, valid, dest[at:at + len(pid)])
        at += len(pid)
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 32, 64])
def test_reshard_count_plain_at_the_edges(d, n, pattern):
    pid, valid, jax_dest = count_cases(d)[(n, pattern)]
    dest, rank, counts = kernels.reshard_count(
        torch.from_numpy(pid), torch.from_numpy(valid), d)
    want = np.where(valid, jax_dest, d)
    np.testing.assert_array_equal(dest.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(want, minlength=d + 1))
    order = np.argsort(want, kind="stable")
    starts = np.cumsum(np.bincount(want, minlength=d + 1)) - np.bincount(
        want, minlength=d + 1)
    want_rank = np.empty(n, np.int64)
    want_rank[order] = np.arange(n) - starts[want[order]]
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    if pattern == "one" and n:
        assert counts[0] == n


# ---------------------------------------------------------------------------
# C23 (and C22's table) against the JAX exchange


@functools.lru_cache(maxsize=None)
def jax_exchange(d, n, pattern):
    """The JAX package's stats and exchange of mesh_rows(d, n, pattern),
    each shard padded with invalid rows to TILE23 + 1 rows, at capacities
    that hold every row: ([max send, max receive, total], the four
    received columns as [d, d * cap_send, ...] arrays)."""
    per_in = TILE23 + 1
    # Capacities the port's never exceed: out_cap is round_capacity of at
    # most d * per_in rows.
    cap_send = -(-round_capacity(d * per_in) // d)
    cols = [np.concatenate([np.concatenate(
        [c, np.zeros((per_in - n,) + c.shape[1:], c.dtype)]) for c in
        shard]) for shard in zip(*mesh_rows(d, n, pattern))]
    jmesh = jax_mesh.make_mesh(n_devices=d)
    jcols = jax_reshard._pad_and_shard(jmesh, per_in,
                                       *(jnp.asarray(c) for c in cols))
    stats = np.asarray(jax_reshard._count_stats_kernel(jcols[0], jcols[3],
                                                       d, 0, jmesh))
    out = jax_reshard._exchange_kernel(*jcols, cap_send, d * cap_send, d,
                                       0, jmesh)
    return stats, [np.asarray(c).reshape((d, d * cap_send) + c.shape[1:])
                   for c in out]


def port_exchange(d, n, pattern, staged):
    """C22 and C23 (plain) a shard, as parallel/reshard.py runs them:
    ([D, D] send table, the D received (pid, pk, values, valid))."""
    shards = [tuple(map(torch.from_numpy, rows))
              for rows in mesh_rows(d, n, pattern)]
    counted = [kernels.reshard_count(s[0], s[3], d) for s in shards]
    table = np.stack([c[2][:d].numpy() for c in counted]).astype(np.int64)
    recv = table.sum(axis=0)
    out_cap = round_capacity(int(recv.max()))
    offsets = np.cumsum(table, axis=0) - table
    outs = [(torch.empty(out_cap, dtype=torch.int32),
             torch.empty(out_cap, dtype=torch.int32),
             torch.empty((out_cap, WIDTH), dtype=torch.float64),
             torch.empty(out_cap, dtype=torch.bool)) for _ in range(d)]
    for s, ((pid, pk, values, _), (dest, rank, _)) in enumerate(
            zip(shards, counted)):
        if staged:
            slices = [(torch.empty(int(table[s, t]), dtype=torch.int32),
                       torch.empty(int(table[s, t]), dtype=torch.int32),
                       torch.empty((int(table[s, t]), WIDTH),
                                   dtype=torch.float64),
                       torch.empty(int(table[s, t]), dtype=torch.bool))
                      for t in range(d)]
            targets = [c + (0,) for c in slices]
        else:
            targets = [outs[t] + (int(offsets[s, t]),) for t in range(d)]
        kernels.reshard_exchange(pid, pk, values, dest, rank, targets,
                                 outs[s] + (int(recv[s]),))
        if staged:
            for t in range(d):
                at = slice(int(offsets[s, t]),
                           int(offsets[s, t] + table[s, t]))
                for out, part in zip(outs[t], slices[t]):
                    out[at] = part
    return table, recv, outs


@pytest.mark.parametrize("n,staged", [(n, False) for n in SIZES23] +
                         [(TILE23 + 1, True)],
                         ids=[f"{n}-own" for n in SIZES23] +
                         [f"{TILE23 + 1}-staged"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_exchange_plain_equals_jax(d, n, staged):
    fills = set()
    for pattern in PATTERNS:
        stats, want = jax_exchange(d, n, pattern)
        table, recv, outs = port_exchange(d, n, pattern, staged)
        np.testing.assert_array_equal(
            [table.max(), recv.max(), recv.sum()], stats)
        out_cap = outs[0][0].shape[0]
        for t in range(d):
            for got, col, pad in zip(outs[t], want, (0, -1, 0.0, False)):
                np.testing.assert_array_equal(got.numpy(),
                                              col[t][:out_cap])
                assert (col[t][out_cap:] == pad).all()
        fills |= {"from 0" for r in recv if r == 0}
        fills |= {"none" for r in recv if r == out_cap}
    if n == TILE23:
        # every row invalid: every shard fills from 0; every valid row to
        # shard 0: D * TILE23 rows, out_cap itself, so it fills none
        assert fills == {"from 0", "none"}


# ---------------------------------------------------------------------------
# The wrappers' host plans


@pytest.mark.parametrize("d", [1, 4, 64])
@pytest.mark.parametrize("n", [0, 1, TILE - 3, TILE - 2, TILE + 1,
                               150 * TILE + 77])
def test_reshard_count_plan_covers_every_phase(n, d):
    tiles, scratch = kernels.reshard_count_plan(n, d)
    for phase in range(4):
        # the kernel's tiles: rows [k * TILE - phase, (k + 1) * TILE -
        # phase) a tile
        assert -(-(n + phase) // TILE) <= tiles if n else tiles == 0
    assert scratch == 256 + tiles * (d + 1) * 8
    assert tiles == (0 if n == 0 else -(-(n + 3) // TILE))


@pytest.mark.parametrize("n", [0, 1, 5, TILE + 1])
@pytest.mark.parametrize("d", [1, 4, 64])
def test_reshard_count_layout_keeps_pid_phase(n, d):
    _, scratch = kernels.reshard_count_plan(n, d)
    longest = kernels.reshard_count_layout(n, d, 3, 63)[-1]
    for phase in range(4):
        for lead in range(64):
            at, dest_at, rank_at, counts_at, length = \
                kernels.reshard_count_layout(n, d, phase, lead)
            assert at == lead
            # the scratch the C entry is told of: whole 256-byte blocks
            # from the allocation's first boundary, at least the plan's
            scratch_bytes = 4 * (dest_at - phase - at)
            assert scratch_bytes >= scratch and scratch_bytes % 256 == 0
            assert (dest_at - lead) % 4 == phase == (rank_at - lead) % 4
            assert dest_at + n <= rank_at and rank_at + n <= counts_at
            assert length == counts_at + d + 1 <= longest


def test_reshard_count_layout_views_on_the_cpu_are_the_plain_outputs():
    pid, _, _, valid = shard_rows(5, TILE + 1, 4, "random")
    got = kernels.reshard_count(torch.from_numpy(pid),
                                torch.from_numpy(valid), 4)
    want = kernels.reshard_count_plain(torch.from_numpy(pid),
                                       torch.from_numpy(valid), 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_values", [False, True])
def test_reshard_exchange_table_words(with_values):
    d = 3
    outs = [(torch.zeros(8, dtype=torch.int32),
             torch.zeros(8, dtype=torch.int32),
             torch.zeros(8) if with_values else None,
             torch.zeros(8, dtype=torch.bool), 2 * t + 1) for t in range(d)]
    fill = (torch.zeros(11, dtype=torch.int32),
            torch.zeros(11, dtype=torch.int32),
            torch.zeros(11) if with_values else None,
            torch.zeros(11, dtype=torch.bool), 4)
    words = kernels.reshard_exchange_table(outs, fill).tolist()
    assert len(words) == 5 * d + 6

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    for k in range(4):
        assert words[k * d:(k + 1) * d] == [ptr(o[k]) for o in outs]
    assert words[4 * d:5 * d] == [1, 3, 5]
    assert words[5 * d:] == [ptr(c) for c in fill[:4]] + [4, 11]


def test_exchange_tile_is_a_whole_number_of_groups():
    # csrc/reshard_exchange.cu stages a tile in four-row groups, two a
    # thread of 256; reshard_count.cu ranks 16 slots of 256 rows.
    assert cuda_build.EXCHANGE_TILE % (4 * 256) == 0
    assert TILE % (4 * 256) == 0 and TILE < 65536
