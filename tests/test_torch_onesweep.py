"""C5's sort plan and its Onesweep passes, and C2's bounding across the
tile edges of its one-pass scan, on the CPU.

  * The plan (kernels.radix_sort_runs / radix_sort_plan, laid out for the
    kernel by kernels._sort_plan): the runs are the maximal runs of a
    word's varying bits (a numpy OR of every row with row 0), or, past 4
    runs, those runs with the narrowest constant gaps filled; the passes
    are ceil(packed bits / 8) a word. Exact.
  * A pass-by-pass model of csrc/radix_sort.cu (onesweep below: the
    varying-bit masks, the packed keys, each pass's per-tile digit counts,
    prefixes in tile order and stable scatter) against the stable argsort
    chain and the JAX package's bounding sort: the identical permutation,
    at tiles of 64 rows and of C5's 4096.
  * bound_rows_plain, through executor.bounded_row_columns, against the
    JAX package's bounded_row_columns on rows whose pairs and pids cross
    C2's 2048-row tile edges (one pair longer than a tile): identical keep
    rows, pair starts, partitions and integer-valued columns.
"""

import ctypes
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
from pipelinedp_tpu_torch import cuda_build
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.ops import threefry

pytestmark = pytest.mark.torch_port

INT32_MAX = np.iinfo(np.int32).max
C2_TILE = 2048  # csrc/bound_rows.cu kTile
M32 = 0xFFFFFFFF
SIGN64 = -(1 << 63)


# csrc/radix_sort.cu's arithmetic pass by pass, in torch on the CPU.


def ordered_bits(word: torch.Tensor) -> torch.Tensor:
    """The kernel's ordered_bits: int64 holding the unsigned bits that
    order as the word does (a 64-bit word's top bit is int64's sign)."""
    if word.dtype == torch.int32:
        return (word.to(torch.int64) & M32) ^ 0x80000000
    if word.dtype == torch.int64:
        return word ^ SIGN64
    if word.dtype == torch.float32:
        b = word.view(torch.int32).to(torch.int64) & M32
        return torch.where(b >> 31 == 1, b ^ M32, b ^ 0x80000000)
    b = word.view(torch.int64)
    return torch.where(b < 0, ~b, b ^ SIGN64)


def varying_masks(words):
    """radix_sort_varying's masks: each word's mapped rows ORed against
    row 0's (unsigned Python ints)."""
    masks = []
    for word in words:
        bits = ordered_bits(word)
        diff = (bits ^ bits[:1]).numpy().view(np.uint64)
        masks.append(int(np.bitwise_or.reduce(diff, initial=0)))
    return masks


def packed_keys(bits: torch.Tensor, runs) -> torch.Tensor:
    key = torch.zeros_like(bits)
    at = 0
    for lo, width in runs:
        mask = -1 if width == 64 else (1 << width) - 1
        key |= ((bits >> lo) & mask) << at
        at += width
    return key


def sweep_destinations(digits: torch.Tensor, tile: int) -> torch.Tensor:
    """The output row of every row of one pass over `digits` (rows in the
    current order): the digit's start (exclusive prefix of the histogram),
    plus its count in the earlier tiles (the look-back's sum), plus the
    row's rank among its tile's rows of that digit (stable)."""
    n = digits.shape[0]
    tiles = -(-n // tile)
    padded = torch.full((tiles * tile,), 256, dtype=torch.int64)  # no digit
    padded[:n] = digits
    onehot = torch.nn.functional.one_hot(padded, 257)[:, :256].view(
        tiles, tile, 256)
    counts = onehot.sum(1)
    hist = counts.sum(0)
    digit_start = torch.cumsum(hist, 0) - hist
    earlier = torch.cumsum(counts, 0) - counts
    rank = (torch.cumsum(onehot, 1) - onehot).view(tiles * tile, 256)[:n]
    t = torch.arange(n) // tile
    return (digit_start[digits] + earlier[t, digits] +
            rank.gather(1, digits[:, None])[:, 0])


def onesweep(words, tile: int = cuda_build.SORT_TILE) -> torch.Tensor:
    """C5's permutation by its own steps: the masks, the plan, then per
    word (least significant first) its packed keys gathered through the
    permutation so far and sorted 8 bits a pass."""
    n = words[0].shape[0]
    perm = torch.arange(n)
    plan = kernels.radix_sort_plan(varying_masks(words))
    for word, runs in reversed(list(zip(words, plan))):
        if not runs:
            continue
        key = packed_keys(ordered_bits(word)[perm], runs)
        for shift in range(0, sum(w for _, w in runs),
                           kernels.SORT_DIGIT_BITS):
            dst = sweep_destinations((key >> shift) & 255, tile)
            perm = torch.empty_like(perm).index_copy_(0, dst, perm)
            key = torch.empty_like(key).index_copy_(0, dst, key)
    return perm


def passes(plan) -> int:
    """Digit passes the kernel makes for a plan."""
    return kernels._sort_plan(plan).total_passes


def numpy_mask(word: np.ndarray) -> int:
    """Bits that differ from row 0 in some row (integers, or floats of one
    sign: the order-preserving map then flips the same bits in every row)."""
    raw = word.view(np.uint64 if word.itemsize == 8 else np.uint32)
    return int(np.bitwise_or.reduce(raw ^ raw[0]))


def numpy_runs(mask: int):
    bits = np.array([b for b in range(64) if mask >> b & 1], np.int64)
    if bits.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(bits) > 1)
    starts = np.concatenate([[bits[0]], bits[breaks + 1]])
    ends = np.concatenate([bits[breaks], [bits[-1]]]) + 1
    return [(int(a), int(b)) for a, b in zip(starts, ends)]


def word_with_runs(n_runs: int, wide: bool, seed: int) -> np.ndarray:
    """A column whose varying bits form n_runs runs of 1-5 bits (1-2 in
    int32), with constant gaps of 1-5 bits (1-3) and constant bits set
    around them."""
    rng = np.random.default_rng(seed)
    max_width, max_gap = (5, 5) if wide else (2, 3)
    at, runs = int(rng.integers(0, 2)), []
    for _ in range(n_runs):
        width = int(rng.integers(1, max_width + 1))
        runs.append((at, width))
        at += width + int(rng.integers(1, max_gap + 1))
    n = 3000
    base = int(rng.integers(0, 1 << (62 if wide else 30)))
    varying = sum(((1 << w) - 1) << lo for lo, w in runs)
    word = np.full(n, base & ~varying, np.int64)
    for lo, width in runs:
        field = rng.integers(0, 1 << width, n)
        field[0], field[1] = 0, (1 << width) - 1  # every bit varies
        word |= field.astype(np.int64) << lo
    return word if wide else word.astype(np.int32)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("n_runs", [0, 1, 4, 6])
def test_sort_plan_matches_numpy_varying_bits(n_runs, wide):
    word = word_with_runs(n_runs, wide, seed=n_runs + 10 * wide)
    mask = numpy_mask(word)
    true_runs = numpy_runs(mask)
    assert len(true_runs) == n_runs
    assert varying_masks([torch.as_tensor(word)]) == [mask]
    plan = kernels.radix_sort_plan([mask])
    runs = [(lo, lo + w) for lo, w in plan[0]]
    assert len(runs) == min(n_runs, 4)
    covered = sum(((1 << (b - a)) - 1) << a for a, b in runs)
    assert covered & mask == mask  # every varying bit is sorted
    assert all(runs[j][1] < runs[j + 1][0] for j in range(len(runs) - 1))
    if n_runs <= 4:
        assert runs == true_runs
    else:
        # The constant bits sorted are the n_runs - 4 narrowest gaps.
        gaps = sorted(true_runs[j + 1][0] - true_runs[j][1]
                      for j in range(n_runs - 1))
        assert bin(covered & ~mask).count("1") == sum(gaps[:n_runs - 4])
    bits = sum(b - a for a, b in runs)
    assert passes(plan) == -(-bits // 8)


def test_sort_plan_counts_passes_per_word():
    rng = np.random.default_rng(3)
    n = 4000
    words = [np.full(n, 7, np.int32),                       # constant
             rng.integers(0, 1 << 19, n).astype(np.int64) << 32,
             rng.random(n).astype(np.float32)]              # exponent mostly
    masks = [numpy_mask(w) for w in words]
    assert varying_masks([torch.as_tensor(w) for w in words]) == masks
    plan = kernels.radix_sort_plan(masks)
    assert plan[0] == ()
    assert plan[1] == ((32, 19),)
    widths = [sum(w for _, w in runs) for runs in plan]
    assert passes(plan) == sum(-(-b // 8) for b in widths)
    assert passes(kernels.radix_sort_plan([0, 0])) == 0


def test_sort_plan_struct_is_the_kernels_plan():
    """kernels._sort_plan: the varying words least significant first, each
    run packed above the word's earlier ones, ceil(bits / 8) passes a word
    numbered on from the last word's; the C layout of csrc/radix_sort.cu's
    Runs (80 bytes) and Plan (384)."""
    plan = (((0, 4),), (), ((3, 5), (40, 24)), ((1, 1), (9, 2), (20, 7)))
    got = kernels._sort_plan(plan)
    assert got.n_words == 3
    assert list(got.word[:3]) == [3, 2, 0]
    assert list(got.passes[:3]) == [2, 4, 1]
    assert list(got.first_pass[:3]) == [0, 2, 6]
    assert got.total_passes == 7
    runs = got.runs[1]  # word 2
    assert (runs.n, runs.bits) == (2, 29)
    assert list(runs.lo[:2]) == [3, 40] and list(runs.at[:2]) == [0, 5]
    assert list(runs.mask[:2]) == [31, (1 << 24) - 1]
    assert runs.varying == (31 << 3) | (((1 << 24) - 1) << 40)
    wide = kernels._sort_plan((((0, 64),),)).runs[0]
    assert (wide.bits, wide.mask[0], wide.varying) == (64, 2**64 - 1,
                                                       2**64 - 1)
    assert ctypes.sizeof(kernels._SortRuns) == 80
    assert ctypes.sizeof(kernels._SortPlan) == 384
    assert kernels._sort_plan(((), ())).total_passes == 0


def jax_order(keys):
    iota = jnp.arange(keys[0].shape[0], dtype=jnp.int32)
    _, (perm,) = jax_executor._sort_rows([jnp.asarray(k) for k in keys],
                                         [iota])
    return np.asarray(perm)


@pytest.mark.parametrize("tile", [64, cuda_build.SORT_TILE])
@pytest.mark.parametrize("seed", [0, 1])
def test_onesweep_model_matches_argsort_and_lax_sort(seed, tile):
    rng = np.random.default_rng(seed)
    n, n_partitions = 5000, 9
    pid = rng.integers(0, 300, n).astype(np.int32)
    pk = rng.integers(0, n_partitions, n).astype(np.int32)
    valid = rng.random(n) > 0.15
    u = rng.integers(0, 6, n).astype(np.float64) / 8  # ties kept in order
    salt_key = np.array([3, 1234], np.uint32)
    pid_sent = np.where(valid, pid, INT32_MAX).astype(np.int32)
    pk_sent = np.where(valid, pk, n_partitions).astype(np.int32)
    h0, h1 = jax_executor._pair_hash(jnp.asarray(pid_sent),
                                     jnp.asarray(pk_sent), salt_key)
    k1, k2, _ = kernels.row_keys_plain(
        torch.as_tensor(pid), torch.as_tensor(pk), torch.as_tensor(valid),
        threefry.bits(salt_key, 4), None, n_partitions, None)
    words = [k1, k2, torch.as_tensor(u)]
    got = onesweep(words, tile=tile)
    np.testing.assert_array_equal(got.numpy(),
                                  kernels.radix_sort_plain(words).numpy())
    want = jax_order([pid_sent, np.asarray(h0), np.asarray(h1), pk_sent, u])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
def test_onesweep_model_orders_signed_keys(dtype):
    rng = np.random.default_rng(5)
    n = 3000
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        word = rng.integers(info.min, info.max, n, dtype=np.int64).astype(
            dtype)
        word[:40] = word[40:80]  # ties
    else:
        word = (rng.standard_normal(n) * 10.0**rng.integers(-3, 4, n)).astype(
            dtype)
    words = [torch.as_tensor(word), torch.as_tensor(rng.random(n))]
    got = onesweep(words, tile=256)
    np.testing.assert_array_equal(got.numpy(),
                                  kernels.radix_sort_plain(words).numpy())


def tile_edge_rows(seed: int):
    """6144 rows (three of C2's tiles): pid 0 holds three pairs of 1000,
    1000 and 100 rows (in any hash order, a pair crosses row 2048 and so
    does the pid), pid 1 one pair of 3000 rows (past row 4096), the rest
    small pids, a tenth of whose rows are invalid."""
    rng = np.random.default_rng(seed)
    n = 3 * C2_TILE
    pid = np.concatenate([np.zeros(2100), np.ones(3000),
                          rng.integers(2, 60, n - 5100)]).astype(np.int32)
    pk = np.concatenate([np.repeat([0, 1, 2], [1000, 1000, 100]),
                         np.full(3000, 4),
                         rng.integers(0, 12, n - 5100)]).astype(np.int32)
    pk[(rng.random(n) < 0.1) & (pid >= 2)] = -1
    order = rng.permutation(n)
    values = rng.integers(-2, 8, n).astype(np.float64)
    return pid[order], pk[order], values, pk[order] >= 0


@pytest.mark.parametrize("seed", [0, 1])
def test_bound_rows_plain_matches_jax_across_tile_edges(seed):
    params = pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM,
                 pdp.Metrics.PRIVACY_ID_COUNT],
        max_partitions_contributed=2, max_contributions_per_partition=3,
        min_sum_per_partition=-1.0, max_sum_per_partition=6.0)
    acc = pdp.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
    compound = jax_combiners.create_compound_combiner(params, acc)
    acc.compute_budgets()
    jcfg = jax_executor.make_kernel_config(params, compound, 12, False, None)
    cfg = convert.kernel_config(dataclasses.asdict(jcfg))
    pid, pk, values, valid = tile_edge_rows(seed)
    key = np.array([0, 77 + seed], np.uint32)
    scal = jax_executor.kernel_scalars(params)
    spk, keep, pair_start, jcols, _ = jax_executor.bounded_row_columns(
        jnp.asarray(pid), jnp.asarray(pk), jnp.asarray(values),
        jnp.asarray(valid), *scal, jax.random.split(key, 2)[0], jcfg)
    keep = np.asarray(keep)
    key2, t_start, tcols, (perm, _) = executor.bounded_row_columns(
        *convert.row_tensors(pid, pk, values, valid, "cpu", torch.float64),
        *scal, threefry.split(key, 2)[0], cfg)
    # The runs the test is about: pid 0 spans the first tile edge and its
    # last pair crosses it; pid 1's pair spans the second.
    spid = pid[perm.numpy()]
    edge = C2_TILE
    assert spid[edge - 1] == spid[edge] == 0
    assert spid[2 * edge - 1] == spid[2 * edge] == 1
    np.testing.assert_array_equal((key2 < 12).numpy(), keep)
    np.testing.assert_array_equal(t_start.numpy(), np.asarray(pair_start))
    np.testing.assert_array_equal(key2.numpy()[keep], np.asarray(spk)[keep])
    assert sorted(tcols) == sorted(jcols)
    for col in jcols:
        np.testing.assert_array_equal(tcols[col].numpy()[keep],
                                      np.asarray(jcols[col])[keep])
