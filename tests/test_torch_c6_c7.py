"""C6 compact_kept's host side and C7's lazy child counts with the leaf
buffer, on the CPU.

C6: the plan (kernels._CompactPlan: the C entry's words, the one
allocation's regions), cached per exact layout (P, lanes, shapes, element
size, device); the grid sizing from given occupancy figures (a run of tiles
a block, with the tiles below, at and above the grid); the outputs as views
of one allocation (dtypes, shapes, contiguity, regions that stay apart);
and a model of the cooperative kernel's two phases (model_compact below,
the kernel's arithmetic block by block: tile counts, the lane sums after
the grid barrier, kept-first ranks) over the plan's grid, held against the
plain version and the JAX package's compact_release (executor.py:936),
more than 32 columns and the lane layout included.

C7: quantile_child_counts with the leaf buffer, filled by the level-1 pass
and read by levels 2..h, against the JAX package's per-quantile segment
sums (tests/test_torch_quantiles.py's jax_child_counts) for the solo,
windowed (base != 0, perm None), lane (one range of L x P partitions) and
2-shard cases; levels 2..h read neither the permutations nor the values;
a buffer of the wrong length or type raises; and a whole lazy PERCENTILE
release on TorchBackend equals TPUBackend for the same seed.

Bounds: exact throughout (ids, counts, moved bits), but the release's
values: within 1e-9 relative, as tests/test_torch_quantiles.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu import executor as jax_executor
from pipelinedp_tpu_torch import kernels

pytestmark = pytest.mark.torch_port

TILE = kernels.COMPACT_TILE

# ---------------------------------------------------------------------------
# C6 compact_kept


@pytest.fixture
def fixed_occupancy(monkeypatch):
    """_compact_plan with the card's blocks set by the test."""
    blocks = {"n": 1056}
    monkeypatch.setattr(kernels, "_compact_max_blocks",
                        lambda index, elem: blocks["n"])
    kernels._compact_plan.cache_clear()
    yield blocks
    kernels._compact_plan.cache_clear()


def test_plan_is_cached_per_exact_layout(fixed_occupancy):
    key = (17770, 1, ((17770,), (17770, 5)), 4, 0, True)
    plan = kernels._compact_plan(*key)
    assert kernels._compact_plan(*key) is plan
    for other in ((17771, 1, ((17771,), (17771, 5)), 4, 0, True),
                  (17770, 1, ((17770,), (17770, 4)), 4, 0, True),
                  (17770, 1, ((17770,), (17770, 5)), 8, 0, True),
                  (17770, 1, ((17770,), (17770, 5)), 4, 1, True),
                  (17770, 1, ((17770,),), 4, 0, True)):
        assert kernels._compact_plan(*other) is not plan
    words = list(plan.words)
    # n, lanes, tiles, run, grid, elem, columns, then three offsets and a
    # (width, offset) pair a column.
    assert words[:7] == [17770, 1, 9, 1, 9, 4, 2]
    assert [words[10], words[12]] == [1, 5]
    assert len(words) == 10 + 2 * 2


@pytest.mark.parametrize("items,max_blocks,want", [
    (1, 1056, (1, 1)),          # P = 1: one tile
    (9, 1056, (9, 1)),          # P = 17,770: below the grid
    (1056, 1056, (1056, 1)),    # at the grid
    (1057, 1056, (529, 2)),     # one tile past: runs of two
    (8192, 1056, (1024, 8)),    # 2^24 partitions
    (8449, 1056, (939, 9)),     # runs past the 8 tiles' ballots kept
    (144, 7, (7, 21)),
])
def test_grid_takes_a_run_of_tiles_a_block(items, max_blocks, want):
    blocks, run = kernels.compact_kept_grid(items, max_blocks)
    assert (blocks, run) == want
    assert blocks <= max_blocks
    assert (blocks - 1) * run < items <= blocks * run


def test_grid_refuses_a_card_of_no_blocks():
    with pytest.raises(ValueError):
        kernels.compact_kept_grid(9, 0)


def regions(tensors):
    """[start, end) byte ranges of tensors."""
    return sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                  for t in tensors if t.numel())


@pytest.mark.parametrize("lanes,P,shapes,dtypes", [
    (1, 17770, [(), (5,)], [torch.float32, torch.int32]),
    (1, 0, [()], [torch.float64]),
    (3, 4001, [(), (), (4,)], [torch.int64, torch.float64, torch.float64]),
])
def test_outputs_are_views_of_one_allocation(lanes, P, shapes, dtypes):
    solo = lanes == 1
    lead = (P,) if solo else (lanes, P)
    cols = {f"c{j}": torch.zeros(lead + s, dtype=d)
            for j, (s, d) in enumerate(zip(shapes, dtypes))}
    elem = dtypes[0].itemsize
    plan = kernels._CompactPlan(P, lanes, tuple(tuple(c.shape)
                                                for c in cols.values()),
                                elem, 1056, solo)
    buf, n_kept, order, out = kernels._compact_outputs(plan, cols, "cpu")
    assert buf.numel() == plan.nbytes
    assert n_kept.dtype == order.dtype == torch.int64
    assert n_kept.shape == (() if solo else (lanes,))
    assert order.shape == lead and order.is_contiguous()
    for name, col in cols.items():
        assert out[name].dtype == col.dtype
        assert out[name].shape == col.shape
        assert out[name].is_contiguous()
    views = [n_kept, order] + list(out.values())
    for v in views:
        assert v.untyped_storage().data_ptr() == buf.data_ptr()
    spans = regions(views)
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b <= c  # no two outputs share a byte
    assert all(lo <= a and b <= hi for a, b in spans)
    # Writes to one output leave the others as they were.
    for j, v in enumerate(views):
        v.fill_(j + 1)
    for j, v in enumerate(views):
        assert bool((v == j + 1).all())


def model_compact(plan, keep, columns, out_views):
    """The cooperative kernel of csrc/compact_kept.cu, block by block over
    the plan's grid: phase 1 writes each tile's kept count, the grid
    barrier, then phase 2 sums each lane's tile counts (all, and those
    before the block's first tile of the lane) and scatters its tiles'
    rows kept-first. One pass a group of COMPACT_MAX_COLUMNS columns, as
    the C entry launches. keep [L * P]; columns / out_views [L, P, w]."""
    n, lanes, tiles, run, grid = list(plan.words)[:5]
    n_cols = plan.words[6]
    items = lanes * tiles
    keep = keep.reshape(lanes, n).numpy()
    assert len(columns) == n_cols
    order = np.zeros((lanes, n), np.int64)
    n_kept = np.full(lanes, -1, np.int64)
    outs = [np.zeros_like(c) for c in columns]
    groups = max(1, -(-n_cols // kernels.COMPACT_MAX_COLUMNS))
    for g in range(groups):
        group = range(g * kernels.COMPACT_MAX_COLUMNS,
                      min(n_cols, (g + 1) * kernels.COMPACT_MAX_COLUMNS))
        counts = np.full(items, -1, np.int64)
        for b in range(grid):  # phase 1
            for it in range(b * run, min(b * run + run, items)):
                l, t = divmod(it, tiles)
                counts[it] = keep[l, t * TILE:(t + 1) * TILE].sum()
        assert (counts >= 0).all()  # every tile has its count
        for b in range(grid):  # phase 2
            lane_now = -1
            for it in range(b * run, min(b * run + run, items)):
                l, t = divmod(it, tiles)
                if l != lane_now:
                    kept_all = counts[l * tiles:(l + 1) * tiles].sum()
                    before = counts[l * tiles:l * tiles + t].sum()
                    lane_now = l
                    if t == 0:
                        n_kept[l] = kept_all
                rows = np.arange(t * TILE, min((t + 1) * TILE, n))
                flags = keep[l, rows].astype(bool)
                kb = before + np.cumsum(flags) - flags
                dst = np.where(flags, kb, kept_all + (rows - kb))
                order[l, dst] = rows
                for j in group:
                    outs[j][l, dst] = columns[j][l, rows]
                before += int(flags.sum())
    for view, o in zip(out_views, outs):
        view.copy_(torch.from_numpy(o.reshape(view.shape)))
    return n_kept, order


def jax_compact(keep, columns):
    """The JAX package's compact_release on the CPU."""
    n_kept, order, out = jax_executor.compact_release(
        {k: jnp.asarray(v.numpy()) for k, v in columns.items()},
        jnp.asarray(keep.numpy()))
    return int(n_kept), np.asarray(order), {k: np.asarray(v)
                                           for k, v in out.items()}


def c6_case(rng, lanes, P, shapes, dtype, pattern):
    n = lanes * P
    keep = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "alternating": np.arange(n) % 2 == 0,
            "random": rng.random(n) < 0.4}[pattern]
    lead = (P,) if lanes == 1 else (lanes, P)
    cols = {f"c{j}": torch.as_tensor(
        rng.integers(-10**6, 10**6, lead + s)).to(dtype)
        for j, s in enumerate(shapes)}
    return torch.as_tensor(keep), cols


C6_CASES = {
    "P = 1": (1, 1, [()], torch.float32, "all"),
    "a tile less one": (1, TILE - 1, [(), ()], torch.float32, "random"),
    "a tile": (1, TILE, [(3,)], torch.float64, "alternating"),
    "a tile and one": (1, TILE + 1, [()], torch.int32, "random"),
    "17,770, keep none": (1, 17770, [(), (5,)], torch.float32, "none"),
    "17,770, keep all": (1, 17770, [()], torch.int64, "all"),
    "33 columns": (1, 5000, [()] * 33, torch.float32, "random"),
    "no columns": (1, 3000, [], torch.float32, "random"),
    "empty": (1, 0, [()], torch.float32, "random"),
    "lanes 16 x 1000": (16, 1000, [(), ()], torch.float32, "random"),
    "lanes 3 x 4100, D = 2": (3, 4100, [(2,)], torch.float64, "alternating"),
    "lanes 2 x 0": (2, 0, [()], torch.float32, "random"),
}


JAX_CASES = ("17,770, keep none", "33 columns", "lanes 3 x 4100, D = 2")


@pytest.mark.parametrize("max_blocks", [1056, 2], ids=["wide", "two"])
@pytest.mark.parametrize("case", list(C6_CASES))
def test_kernel_model_equals_plain_and_jax(case, max_blocks):
    lanes, P, shapes, dtype, pattern = C6_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + max_blocks)
    keep, cols = c6_case(rng, lanes, P, shapes, dtype, pattern)
    solo = lanes == 1
    plan = kernels._CompactPlan(P, lanes, tuple(tuple(c.shape)
                                                for c in cols.values()),
                                dtype.itemsize, max_blocks, solo)
    _, n_kept_v, order_v, out = kernels._compact_outputs(plan, cols, "cpu")
    width = [int(np.prod(c.shape[1 if solo else 2:])) for c in cols.values()]
    as_lanes = [c.reshape(lanes, P, w).numpy()
                for c, w in zip(cols.values(), width)]
    n_kept, order = model_compact(plan, keep.reshape(-1), as_lanes,
                                  list(out.values()))
    n_kept_v.copy_(torch.as_tensor(n_kept.reshape(n_kept_v.shape)))
    order_v.copy_(torch.from_numpy(order.reshape(order_v.shape)))
    if solo:
        want = kernels.compact_kept_plain(keep, cols)
    else:
        want = kernels.compact_kept_lanes_plain(keep, cols, lanes)
    assert torch.equal(n_kept_v, want[0].to(torch.int64))
    assert torch.equal(order_v, want[1])
    for name in cols:
        assert torch.equal(out[name], want[2][name])
    if max_blocks != 1056 or case not in JAX_CASES:
        return
    # The JAX package's compaction, lane by lane (a few shapes: each
    # compiles).
    for l in range(lanes):
        lane_cols = {k: (v if solo else v[l]) for k, v in cols.items()}
        j_kept, j_order, j_out = jax_compact(keep.reshape(lanes, P)[l],
                                             lane_cols)
        assert int(n_kept[l]) == j_kept
        np.testing.assert_array_equal(order[l], j_order)
        for name in cols:
            got = out[name] if solo else out[name][l]
            np.testing.assert_array_equal(got.numpy(), j_out[name])


# ---------------------------------------------------------------------------
# C7 quantile_counts: the lazy child counts with the leaf buffer

B, H, N_Q = 4, 3, 3  # a small tree: 64 leaves
MIN_V, MAX_V = -1.0, 9.0


def sorted_stream(rng, n, key_lo, key_hi, gathered=True):
    """n partition-sorted rows: skey2 in [key_lo, key_hi), values through
    two permutations (gathered) or already in sorted order."""
    skey2 = np.sort(rng.integers(key_lo, key_hi, n)).astype(np.int32)
    values = np.where(rng.random(n) < 0.5, rng.integers(1, 6, n) * 1.0,
                      rng.uniform(-3.0, 12.0, n))
    if not gathered:
        return skey2, None, None, values
    return (skey2, rng.permutation(n).astype(np.int64),
            rng.permutation(n).astype(np.int64), values)


def qrows(stream, P, base=0):
    """The JAX package's (row_pk, row_leaf, row_keep) of the sorted rows."""
    skey2, perm, row_perm, values = stream
    r = np.arange(skey2.size) if perm is None else perm
    v = values[r if row_perm is None else row_perm[r]]
    pk = skey2.astype(np.int64) - base
    leaf = np.asarray(jax_executor._leaf_indices(jnp.asarray(v), MIN_V,
                                                 MAX_V, B**H))
    return pk, leaf, (pk >= 0) & (pk < P)


def jax_child_counts(q, parent, level, P):
    """The lazy descent's child counts of one level (executor.py:796-806),
    as tests/test_torch_quantiles.py takes them."""
    row_pk, row_leaf, row_keep = (jnp.asarray(a) for a in q)
    row_node = (row_leaf // B**(H - level)).astype(jnp.int32)
    par = jnp.asarray(parent)[jnp.clip(row_pk, 0, P - 1)]
    in_path = row_keep & (row_node // B == par) & (row_pk < P)
    seg = jnp.where(in_path, row_pk * B + (row_node % B), P * B)
    counts = jax.ops.segment_sum(in_path.astype(jnp.int32), seg,
                                 num_segments=P * B + 1)[:P * B]
    return np.asarray(counts).reshape(P, B)


def tensors(stream):
    return tuple(None if a is None else torch.as_tensor(a) for a in stream)


def descend(rng, node, counts):
    """Every (partition, quantile) steps to a populated child where there
    is one, so the next level counts something."""
    c = counts.numpy()
    pick = np.where(c.any(-1), np.argmax(c + rng.random(c.shape), -1),
                    rng.integers(0, B, c.shape[:2]))
    return node * B + pick.astype(np.int32)


def run_levels(streams, P, base, rng, check_garbage=True):
    """The h levels over shards of sorted rows, each with its own leaf
    buffer; each level's shard sum against the JAX counts of all rows."""
    qs = [qrows(s, P, base) for s in streams]
    q_all = tuple(np.concatenate([q[j] for q in qs]) for j in range(3))
    node = np.zeros((P, N_Q), np.int32)
    leaves = [torch.full((s[0].size,), 12345, dtype=torch.int32)
              for s in streams]
    for level in range(1, H + 1):
        parts = []
        for stream, leaf in zip(streams, leaves):
            skey2, perm, row_perm, values = tensors(stream)
            if level > 1 and check_garbage:
                # Levels 2..h read skey2 and the buffer alone.
                values = torch.full_like(values, float("nan"))
                if perm is not None:
                    perm = torch.flip(perm, (0,))
            parts.append(kernels.quantile_child_counts(
                skey2, perm, row_perm, values, torch.as_tensor(node),
                level=level, tree_height=H, branching=B, min_v=MIN_V,
                max_v=MAX_V, base=base, leaf=leaf))
            if level == 1:
                q = qrows(stream, P, base)
                np.testing.assert_array_equal(
                    leaf.numpy(), np.where(q[2], q[1], -1))
        got = sum(parts)
        assert got.shape == (P, N_Q, B) and got.dtype == torch.int32
        for qi in range(N_Q):
            np.testing.assert_array_equal(
                got[:, qi].numpy(),
                jax_child_counts(q_all, node[:, qi], level, P))
        node = descend(rng, node, got)
    return node


@pytest.mark.parametrize("case", ["solo", "windowed", "lanes", "2 shards"])
def test_leaf_buffer_counts_equal_jax(case):
    rng = np.random.default_rng({"solo": 1, "windowed": 2, "lanes": 3,
                                 "2 shards": 4}[case])
    # 3000 rows over 40 partitions in every case: the JAX reference
    # compiles once.
    P, base = 40, 0
    if case == "solo":
        streams = [sorted_stream(rng, 3000, 0, P + 3)]  # some outside
    elif case == "windowed":
        base = 50  # a block of the blocked route, host-staged
        streams = [sorted_stream(rng, 3000, 35, 95, gathered=False)]
    elif case == "lanes":
        # 4 lanes of 10 partitions: key2 = lane * 10 + partition.
        streams = [sorted_stream(rng, 3000, 0, P + 1)]
    else:
        streams = [sorted_stream(rng, 1400, 0, P + 2),
                   sorted_stream(rng, 1600, 0, P + 2)]
    run_levels(streams, P, base, rng)


def test_leaf_buffer_equals_the_gather_at_every_level():
    rng = np.random.default_rng(9)
    P = 30
    stream = tensors(sorted_stream(rng, 2000, 0, P + 2))
    node = torch.zeros(P, N_Q, dtype=torch.int32)
    leaf = torch.empty(2000, dtype=torch.int32)
    tree = dict(tree_height=H, branching=B, min_v=MIN_V, max_v=MAX_V)
    for level in range(1, H + 1):
        got = kernels.quantile_child_counts(*stream, node, level=level,
                                            leaf=leaf, **tree)
        want = kernels.quantile_child_counts(*stream, node, level=level,
                                             **tree)
        assert torch.equal(got, want)
        node = torch.as_tensor(descend(rng, node.numpy(), got))


@pytest.mark.parametrize("leaf", [torch.empty(1999, dtype=torch.int32),
                                  torch.empty(2000, dtype=torch.int64),
                                  torch.empty(2, 1000, dtype=torch.int32)],
                         ids=["short", "int64", "2-d"])
def test_leaf_buffer_of_another_shape_raises(leaf):
    rng = np.random.default_rng(10)
    stream = tensors(sorted_stream(rng, 2000, 0, 12))
    with pytest.raises(ValueError, match="leaf"):
        kernels.quantile_child_counts(
            *stream, torch.zeros(10, N_Q, dtype=torch.int32), level=1,
            tree_height=H, branching=B, min_v=MIN_V, max_v=MAX_V, leaf=leaf)


def release(mod, rows, seed):
    backend = (pdp.TPUBackend(noise_seed=seed) if mod is pdp else
               tdp.TorchBackend(device="cpu", noise_seed=seed,
                                dtype=torch.float64))
    acc = mod.NaiveBudgetAccountant(total_epsilon=4.0, total_delta=1e-6)
    engine = mod.DPEngine(acc, backend)
    result = engine.aggregate(
        rows, mod.AggregateParams(
            metrics=[mod.Metrics.PERCENTILE(20), mod.Metrics.PERCENTILE(80),
                     mod.Metrics.COUNT],
            noise_kind=mod.NoiseKind.LAPLACE, max_partitions_contributed=2,
            max_contributions_per_partition=2, min_value=0.0,
            max_value=6.0),
        mod.DataExtractors(privacy_id_extractor=lambda r: r[0],
                           partition_extractor=lambda r: r[1],
                           value_extractor=lambda r: r[2]),
        [f"p{i}" for i in range(600)])
    acc.compute_budgets()
    return dict(result)


def test_lazy_percentile_release_equals_tpu_backend():
    # 600 public partitions: the lazy regime (more than 512), its descent
    # counting every level from the leaf buffer.
    rng = np.random.default_rng(11)
    rows = [(int(u), f"p{int(p)}", float(v)) for u, p, v in zip(
        rng.integers(0, 800, 4000), rng.integers(0, 600, 4000),
        rng.integers(1, 6, 4000))]
    want = release(pdp, rows, 17)
    got = release(tdp, rows, 17)
    assert len(want) == 600 and set(got) == set(want)
    for key, values in want.items():
        assert got[key]._fields == values._fields
        for a, b in zip(got[key], values):
            assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (key, a, b)
