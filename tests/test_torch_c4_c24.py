"""C4 release_epilogue's host side and C24 mesh_factorize's sortless phases,
on the CPU.

C4: the ctypes copy of the kernel's Plan (field order, offsets and size of
the C struct), what release_epilogue_plan puts in it for a call (and that
a release's calls share one), the key table both entries hand the kernel
([L, 2 + 2S]: key_sel, then the slot keys, one row for the solo entry;
the kernel splits a secure slot's key itself), the host twin of
pdp::secure_key against threefry.split, and the one allocation the
outputs are views of.

C24: the local phase (C12's table and its heads, no sort), the merge (C12
over the gathered slots) and the remap, through
device_encode.mesh_factorize_codes on Mesh(["cpu"] * D), against the JAX
package's mesh_factorize_codes and _mesh_unique_cap_kernel on
make_mesh(n_devices=D); the ordering the merge rests on (a gathered slot's
index orders the hashes as their global first positions do); the count
hint (exact, above, absent: the same codes; one too small: raises).

Bounds: exact throughout (struct fields, key words, integer codes).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinedp_tpu import device_encode as jax_device_encode
from pipelinedp_tpu import ingest as jax_ingest
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu_torch import columnar, device_encode, ingest, kernels
from pipelinedp_tpu_torch.aggregate_params import (NoiseKind,
                                                   PartitionSelectionStrategy)
from pipelinedp_tpu_torch.ops import selection_ops, threefry
from pipelinedp_tpu_torch.parallel.mesh import (ShardedColumn, make_mesh,
                                                round_capacity)

pytestmark = pytest.mark.torch_port

SENT = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# C4 release_epilogue: the host plan

# (field, offset, bytes) of csrc/release_epilogue.cu's Plan under the C ABI
# of x86-64 and of the card: eight-byte doubles first, then ints, 384
# bytes with the tail padding to eight.
PLAN_LAYOUT = [("std", 0, 64), ("gran", 64, 64), ("sel", 128, 112),
               ("mid", 240, 8), ("min_v", 248, 8), ("max_rows", 256, 8),
               ("n_entries", 264, 4), ("kind", 268, 32),
               ("outputs", 300, 32), ("offset", 332, 32),
               ("n_slots", 364, 4), ("gaussian", 368, 4),
               ("degenerate", 372, 4), ("private_selection", 376, 4)]


def test_epilogue_plan_is_the_c_struct():
    plan = kernels._EpiloguePlan
    got = [(name, getattr(plan, name).offset, getattr(plan, name).size)
           for name, _ in plan._fields_]
    assert got == PLAN_LAYOUT
    assert ctypes.sizeof(plan) == 384
    assert kernels.EPILOGUE_MAX_ENTRIES == kernels.EPILOGUE_MAX_SLOTS == 8


GEOMETRIC = selection_ops.selection_params_from_host(
    PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, 1.0, 1e-6, 64, None)
LAPLACE_THRESHOLD = selection_ops.selection_params_from_host(
    PartitionSelectionStrategy.LAPLACE_THRESHOLDING, 0.5, 1e-7, 4, 3)
# name: (plan, slots, selection, noise, degenerate)
PLANS = {
    "wide, private": (
        [("variance", ("variance", "count", "sum", "mean"), 0),
         ("privacy_id_count", ("privacy_id_count",), 3)], 4, GEOMETRIC,
        NoiseKind.GAUSSIAN, False),
    "count and mean, public": (
        [("count", ("count",), 0), ("mean", ("mean", "sum"), 1)], 3, None,
        NoiseKind.LAPLACE, False),
    "degenerate variance": (
        [("variance", ("variance", "mean"), 0)], 3, None,
        NoiseKind.GAUSSIAN, True),
    "eight slots": (
        [("count", ("count",), 0), ("sum", ("sum",), 1),
         ("mean", ("mean",), 2), ("variance", ("variance",), 4),
         ("privacy_id_count", ("privacy_id_count",), 7)], 8,
        LAPLACE_THRESHOLD, NoiseKind.LAPLACE, False),
}


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_epilogue_plan_holds_the_call(name, secure):
    plan, n_slots, sel, noise, degenerate = PLANS[name]
    rng = np.random.default_rng(len(name) + 31 * secure)
    stds = rng.uniform(0.5, 50.0, n_slots)
    gran = 2.0**rng.integers(-4, 4, n_slots) if secure else None
    p = kernels.release_epilogue_plan(plan, stds, noise, degenerate, 3.5,
                                      -1.25, sel, 7, gran)
    k = len(plan)
    assert p.n_entries == k
    assert list(p.kind) == [kernels.PLAN_KINDS[kind] for kind, _, _ in plan
                            ] + [0] * (8 - k)
    assert list(p.outputs[:k]) == [
        sum(kernels.OUTPUT_BITS[o] for o in outs) for _, outs, _ in plan]
    assert list(p.offset[:k]) == [off for _, _, off in plan]
    assert p.n_slots == n_slots
    assert list(p.std) == list(stds) + [0.0] * (8 - n_slots)
    assert list(p.gran) == (list(gran) if secure else [0.0] * n_slots) + [
        0.0] * (8 - n_slots)
    assert tuple(p.sel) == (selection_ops.selection_scalars(sel) if sel else
                            (0.0,) * 14)
    assert (p.mid, p.min_v, p.max_rows) == (3.5, -1.25, 7.0)
    assert (p.gaussian, p.degenerate, p.private_selection) == (
        int(noise == NoiseKind.GAUSSIAN), int(degenerate), int(sel is not None))
    # A release's calls share the plan: the same values give the same one,
    # any other value another.
    assert kernels.release_epilogue_plan(
        [list(e) for e in plan], list(stds), noise, degenerate, 3.5, -1.25,
        sel, 7, gran) is p
    assert kernels.release_epilogue_plan(plan, stds, noise, degenerate, 3.5,
                                         -1.25, sel, 8, gran) is not p


def test_epilogue_plan_refuses_more_than_eight():
    count = ("count", ("count",), 0)
    with pytest.raises(ValueError, match="exceed"):
        kernels.release_epilogue_plan([count] * 9, np.ones(1),
                                      NoiseKind.LAPLACE, False, 0, 0, None, 1)
    with pytest.raises(ValueError, match="exceed"):
        kernels.release_epilogue_plan([count], np.ones(9), NoiseKind.LAPLACE,
                                      False, 0, 0, None, 1)


@pytest.mark.parametrize("selection", [False, True])
@pytest.mark.parametrize("n_slots", [1, 4, 8])
@pytest.mark.parametrize("n_lanes", [1, 3, 16])
def test_epilogue_lane_table(n_lanes, n_slots, selection):
    rng = np.random.default_rng(100 * n_lanes + 10 * n_slots + selection)
    slot_keys = rng.integers(0, 2**32, (n_lanes, n_slots, 2),
                             dtype=np.uint32)
    key_sel = rng.integers(0, 2**32, (n_lanes, 2), dtype=np.uint32)
    table = kernels.epilogue_lane_table(slot_keys,
                                        key_sel if selection else None)
    assert table.shape == (n_lanes, 2 + 2 * n_slots)
    assert table.dtype == np.uint32 and table.flags.c_contiguous
    np.testing.assert_array_equal(table[:, :2],
                                  key_sel if selection else 0)
    np.testing.assert_array_equal(
        table[:, 2:].reshape(n_lanes, n_slots, 2), slot_keys)
    # The service's 16-lane groups ride in the launch's parameters.
    assert (table.size <= kernels.EPILOGUE_LANE_WORDS) == (
        n_lanes * (2 + 2 * n_slots) <= 512)


@pytest.mark.parametrize("seed", range(6))
def test_secure_key_twin_is_threefry_split(seed):
    keys = np.random.default_rng(seed).integers(0, 2**32, (16, 2),
                                                dtype=np.uint32)
    if seed == 0:
        keys[:2] = [[0, 0], [SENT, SENT]]
    got = kernels._split_keys(keys.reshape(4, 4, 2))
    assert got.shape == (4, 4, 4) and got.dtype == np.uint32
    want = np.stack([threefry.split(k, 2).reshape(4) for k in keys])
    np.testing.assert_array_equal(got.reshape(16, 4), want)


@pytest.mark.parametrize("n_lanes", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_epilogue_outputs_are_views_of_one_allocation(dtype, n_lanes):
    total = 3 * 1001
    names = ["variance", "count", "sum", "mean"]
    keep, outs, flags = kernels._epilogue_outputs(total, names, dtype,
                                                  n_lanes,
                                                  torch.device("cpu"))
    base = keep.untyped_storage().data_ptr()
    assert keep.dtype == torch.bool and keep.shape == (total,)
    assert flags.dtype == torch.int32 and flags.shape == (n_lanes,)
    assert list(outs) == names
    ends = [(keep.data_ptr(), keep.data_ptr() + total)]
    for t in outs.values():
        assert t.dtype == dtype and t.shape == (total,) and t.is_contiguous()
        assert t.untyped_storage().data_ptr() == base
        assert (t.data_ptr() - base) % 256 == 0
        ends.append((t.data_ptr(), t.data_ptr() + total * dtype.itemsize))
    assert flags.untyped_storage().data_ptr() == base
    ends.append((flags.data_ptr(), flags.data_ptr() + 4 * n_lanes))
    ends.sort()
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


# ---------------------------------------------------------------------------
# C24 mesh_factorize: no sort


def hash_rows(raw, valid=None):
    return jax_device_encode.pack_hash_rows(jax_ingest.hash_key_column(raw),
                                            valid)


def sentinels(count):
    return np.full((count, 3), SENT, np.uint32)


def c24_cases():
    """Hash rows of 192 rows, split evenly at D = 1, 2, 3, 4, 8 (at least
    24 rows a shard: the JAX kernel needs uniq_cap, the rounded largest
    shard count, within a shard's rows)."""
    rng = np.random.default_rng(19)
    # Rows 0-95 draw from 3 keys, rows 96-191 from 9: six hashes first
    # appear on a later shard at every D > 1, and a hot key recurs on
    # every shard.
    later = hash_rows(np.concatenate([rng.integers(0, 3, 96),
                                      rng.integers(0, 9, 96)]))
    strs = np.char.add("k", rng.integers(0, 40, 150).astype(str))
    mixed = np.concatenate([sentinels(5), hash_rows(strs[:75],
                                                    rng.random(75) > 0.3),
                            sentinels(37), hash_rows(strs[75:])])
    return {
        "later shard first": later,
        # invalid rows keep their slots; sentinel runs cross shard edges
        "invalid and pads": mixed,
        "one hash everywhere": hash_rows(np.zeros(192, np.int64)),
        "every row distinct": hash_rows(np.arange(192)),
        "all pads": sentinels(192),
    }


C24_CASES = c24_cases()


def host(col):
    return (col.global_rows("cpu").numpy() if isinstance(col, ShardedColumn)
            else np.asarray(col))


def global_first_positions(rows):
    """{(hi, lo): first global row} over the non-sentinel rows."""
    first = {}
    for i, (hi, lo, _) in enumerate(rows.tolist()):
        if (hi, lo) != (SENT, SENT):
            first.setdefault((hi, lo), i)
    return first


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", sorted(C24_CASES))
def test_sortless_factorize_matches_jax(case, d):
    rows = C24_CASES[case]
    mesh = make_mesh(["cpu"] * d)
    t = torch.from_numpy(rows.view(np.int32))
    want, n_want = jax_device_encode.mesh_factorize_codes(
        jax_make_mesh(n_devices=d), jnp.asarray(rows))
    cap_want = jax_device_encode._mesh_unique_cap_kernel(
        jnp.asarray(rows), jax_make_mesh(n_devices=d))
    assert device_encode.mesh_unique_cap(mesh, t) == int(cap_want)
    for hint in (None, n_want, n_want + 7):
        codes, n = device_encode.mesh_factorize_codes(mesh, t,
                                                      n_distinct=hint)
        np.testing.assert_array_equal(host(codes), np.asarray(want))
        assert n == n_want
    if n_want:
        with pytest.raises(RuntimeError, match="n_distinct"):
            device_encode.mesh_factorize_codes(mesh, t,
                                               n_distinct=n_want - 1)


def test_reference_mesh_factorize_short_shard_raises():
    # A fault of the reference (ROADMAP.md Queue 3): the JAX kernel slices
    # chi[:uniq_cap] (pipelinedp_tpu/device_encode.py:356), and uniq_cap,
    # round_capacity of the largest shard's distinct count, can exceed a
    # shard's rows: here D = 2, 29 distinct hashes a shard, uniq_cap 32.
    # The port's factorize of the same rows gives the first-occurrence
    # codes columnar.factorize gives.
    keys = np.random.default_rng(21).permutation(58)
    rows = hash_rows(keys)
    assert round_capacity(29) == 32
    with pytest.raises(ValueError):
        jax_device_encode.mesh_factorize_codes(jax_make_mesh(n_devices=2),
                                               jnp.asarray(rows))
    codes, n = device_encode.mesh_factorize_codes(
        make_mesh(["cpu"] * 2), torch.from_numpy(rows.view(np.int32)))
    pairs = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | rows[:, 1]
    want, vocab = columnar.factorize(pairs)
    np.testing.assert_array_equal(host(codes), want)
    assert n == len(vocab) == 58


@pytest.mark.parametrize("d", [2, 3, 4, 8])
@pytest.mark.parametrize("case", ["later shard first", "invalid and pads"])
def test_gathered_slots_order_hashes_by_first_position(case, d):
    """The property the merge rests on: shard s's heads list its hashes in
    first-row order, the gathered slots list shard 0's, then shard 1's...,
    so the first slot of each hash comes in global first-position order
    and the merge's code of a live slot is its hash's rank by global first
    position."""
    rows = C24_CASES[case]
    mesh = make_mesh(["cpu"] * d)
    hashes = device_encode._as_sharded(mesh,
                                       torch.from_numpy(rows.view(np.int32)))
    runs = device_encode._local_runs(mesh, hashes, None)
    cap = round_capacity(max(int(r[1]) for r in runs))
    gathered = torch.cat([r[2][:cap] for r in runs])
    g = gathered.numpy().view(np.uint32)
    first = global_first_positions(rows)
    local = len(rows) // d
    slot_first = []
    for s in range(d):
        shard = rows[s * local:(s + 1) * local]
        shard_first = global_first_positions(shard)
        live = [tuple(x) for x in g[s * cap:(s + 1) * cap, :2].tolist()
                if tuple(x) != (SENT, SENT)]
        assert len(live) == int(runs[s][1])
        assert [shard_first[h] for h in live] == sorted(
            shard_first[h] for h in live)
        slot_first += [(h, first[h]) for h in live]
    seen, order = set(), []
    for h, pos in slot_first:
        if h not in seen:
            seen.add(h)
            order.append(pos)
    assert order == sorted(order) and seen == set(first)
    remap, n = kernels.mesh_merge_ranks(gathered)
    rank = {h: r for r, h in enumerate(sorted(first, key=first.get))}
    want = [rank.get(tuple(x), -1) for x in g[:, :2].tolist()]
    np.testing.assert_array_equal(remap.numpy(), want)
    assert int(n) == len(first)


@pytest.mark.parametrize("case", sorted(C24_CASES))
def test_local_phase_matches_c12_and_the_remap(case):
    """One shard's run: its local codes are C12's, its count C12's, its
    heads the distinct hashes by first row; the remap of a window is
    window[lcode] with -1 kept."""
    rows = C24_CASES[case]
    t = torch.from_numpy(rows.view(np.int32))
    lcode, n_new, heads = kernels.mesh_local_uniques(t)
    codes, n = kernels.factorize_codes(t)
    assert torch.equal(lcode, codes) and int(n_new) == int(n)
    first = global_first_positions(rows)
    h = heads.numpy().view(np.uint32)
    k = len(first)
    assert h.shape == (round_capacity(len(rows)), 3)
    assert [tuple(x) for x in h[:k, :2].tolist()] == sorted(first,
                                                            key=first.get)
    assert (h[:k, 2] == 1).all() and (h[k:] == SENT).all()
    window = torch.arange(100, 100 + max(k, 1), dtype=torch.int32)
    out = kernels.mesh_remap_rows(lcode, window).numpy()
    lc = lcode.numpy()
    np.testing.assert_array_equal(out, np.where(lc < 0, -1, lc + 100))


def test_pod_ingest_passes_the_host_counts(monkeypatch):
    """The hash_device pod ingest sizes the factorize's tables by the host
    merges' distinct counts: the privacy ids' and the partitions'."""
    hints = []
    real = device_encode.mesh_factorize_codes

    def spy(mesh, hashes, n_distinct=None):
        hints.append(n_distinct)
        return real(mesh, hashes, n_distinct=n_distinct)

    monkeypatch.setattr(device_encode, "mesh_factorize_codes", spy)
    rng = np.random.default_rng(5)
    pid = rng.integers(0, 300, 4096)
    pk = rng.integers(0, 37, 4096)
    chunks = [(pid[:2048], pk[:2048], np.ones(2048)),
              (pid[2048:], pk[2048:], np.ones(2048))]
    enc = ingest.encode_local_shard_to_mesh(chunks, make_mesh(["cpu"] * 4),
                                            encode_mode="hash_device")
    assert hints == [len(np.unique(pid)), len(np.unique(pk))]
    assert enc.n_privacy_ids == hints[0] and len(enc.partition_vocab) == 37
