"""C18 log_bins and C14 append_rows: their plain versions against the JAX
package on the CPU at the rebuilt kernels' edge inputs, the batched
integer entry, and numpy models of what the CUDA code decides on the host
side of its arithmetic.

Bounds stated here:
  * C18's integer plain version against JAX _bin_int_kernel: every bin's
    lower, upper, count and max and the bin count equal (==); sums equal
    where every bin's sum stays below 2^24 (the JAX package sums float32
    cumsum differences, exact there), and otherwise equal to numpy's exact
    int64 sums and within 2^-24 x n x the largest value of JAX's.
  * C18's float plain version against JAX _bin_float_kernel: lo, hi,
    counts and maxes equal (==); each bucket's sum within 1e-5 of the sum
    of its |v| (the port rounds a float64 sum once, the JAX package adds
    float32 values one at a time).
  * log_bins_int_many's plain form: every record equal (==) to the single
    entry's, and compute_dataset_histograms_device(device="cpu") equal to
    the JAX device path's histograms (ints ==, float as above), through
    one batched call a histogram call.
  * kernels.float_buckets (the plain version's bucket) equal (==) to
    jnp.searchsorted(edges, v, side="right") - 1, clipped, on edges that
    decrease somewhere and on NaN edges and values too.
  * The guess-then-correct bucket (csrc/log_bins.cu Edges::bucket, with
    Edges::search the JAX package's scan) in numpy: equal (==) to
    clip(jnp.searchsorted(edges, v, side="right") - 1) on 10^5 random and
    adversarial float32 values a range.
  * C14's plain versions against JAX _grow_fn and against the pad rows the
    JAX accumulator leaves: equal (==), bit for bit where the pad is -0.0
    or the hash sentinel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinedp_tpu.dataset_histograms import device_histograms as jax_dh
from pipelinedp_tpu.runtime import pipeline as jax_pipeline
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.dataset_histograms import device_histograms as dh

pytestmark = pytest.mark.torch_port

N = 1024
BUCKETS = 10000
F32 = np.float32
BIG = float(np.finfo(F32).max)
_bin_int = jax.jit(jax_dh._bin_int_kernel)
_bin_float = jax.jit(jax_dh._bin_float_kernel, static_argnums=2)

# ---------------------------------------------------------------------------
# C18, integer


def int_case(name: str):
    rng = np.random.default_rng(sum(map(ord, name)))
    dense = np.ones(N, bool)
    if name == "one slot":
        return np.ones(N), dense
    if name == "five values":
        return rng.integers(1, 6, N), dense
    if name == "five values, sparse":
        return rng.integers(1, 6, N), rng.random(N) < 0.03
    if name == "ten decades":
        pow10 = 10**np.arange(10)
        edges = np.concatenate([pow10 - 1, pow10, pow10 + 1, [999, 1001]])
        rest = (10.0**rng.uniform(0, 9.3, N - len(edges))).astype(np.int64)
        return np.concatenate([edges, rest]), rng.random(N) < 0.9
    if name == "negatives and zero":
        return rng.integers(-50, 3, N), rng.random(N) < 0.8
    if name == "empty mask":
        return rng.integers(1, 5000, N), np.zeros(N, bool)
    if name == "skew over 40 slots":
        return np.minimum(rng.zipf(1.3, N), 40), dense
    raise KeyError(name)


INT_CASES = ("one slot", "five values", "five values, sparse",
             "ten decades", "negatives and zero", "empty mask",
             "skew over 40 slots")


def exact_bins(values, mask):
    """numpy's exact (lower -> (count, sum, max)) of the masked values."""
    v = values[mask].astype(np.int64)
    lower, _ = kernels.log_bin_bounds(torch.from_numpy(np.maximum(v, 1)))
    out = {}
    for low, x in zip(lower.tolist(), v.tolist()):
        c, s, m = out.get(low, (0, 0, -2**31))
        out[low] = (c + 1, s + x, max(m, x))
    return out


@pytest.mark.parametrize("name", INT_CASES)
def test_int_plain_matches_jax(name):
    values, mask = int_case(name)
    values = values.astype(np.int32)
    got = kernels.log_bins_int(torch.from_numpy(values),
                               torch.from_numpy(mask))
    want = _bin_int(jnp.asarray(values), jnp.asarray(mask))
    k = int(want[5])
    assert int(got[5]) == k
    for j in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[j][:k].numpy(),
                                      np.asarray(want[j][:k]).round())
    sums = got[3][:k].numpy()
    exact = exact_bins(values, mask)
    assert sums.tolist() == [exact[low][1] for low in got[0][:k].tolist()]
    jsums = np.asarray(want[3][:k], np.float64)
    if np.abs(sums).max(initial=0) < 2**24:
        np.testing.assert_array_equal(sums, jsums)
    else:
        bound = 2.0**-24 * N * np.abs(values[mask]).max()
        assert np.abs(sums - jsums).max() <= bound
    assert all(int(g[k:].abs().sum()) == 0 for g in got[:5])


def test_int_int32_extremes_match_numpy():
    values = np.array([2**31 - 1, 2**31 - 1000, -2**31, 1, 1000, 10**9],
                      np.int32)
    mask = np.ones(len(values), bool)
    got = kernels.log_bins_int(torch.from_numpy(values),
                               torch.from_numpy(mask))
    want = _bin_int(jnp.asarray(values), jnp.asarray(mask))
    k = int(got[5])
    assert k == int(want[5])
    for j in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[j][:k].numpy(),
                                      np.asarray(want[j][:k]).round())
    exact = exact_bins(values, mask)
    assert got[3][:k].tolist() == [exact[low][1]
                                   for low in got[0][:k].tolist()]


# ---------------------------------------------------------------------------
# C18, float


def float_case(name: str):
    rng = np.random.default_rng(sum(map(ord, name)))
    dense = np.ones(N, bool)
    if name == "five values":
        return rng.integers(1, 6, N), dense
    if name == "lo == hi":
        return np.full(N, 0.1), dense
    if name == "lo == hi == -0.0":
        return np.full(N, -0.0), dense
    if name == "-FLT_MAX to FLT_MAX":
        return np.concatenate([[-BIG, BIG], rng.normal(size=N - 2) * 1e37]), \
            dense
    if name == "values on edges":
        edges = kernels.linspace_edges_f32(torch.tensor(F32(-3.7)),
                                           torch.tensor(F32(12.9)),
                                           BUCKETS).numpy()
        return np.concatenate([[edges[0], edges[-1]],
                               rng.choice(edges, N - 2)]), dense
    if name == "a range of a few ulps":
        return F32(1e6) + F32(0.0625) * rng.integers(0, 17, N), dense
    if name == "negatives and -0.0":
        return np.concatenate([[-0.0, 0.0, -0.0], rng.normal(size=N - 3) *
                               40 - 30]), rng.random(N) < 0.9
    if name == "empty mask":
        return rng.normal(size=N), np.zeros(N, bool)
    raise KeyError(name)


FLOAT_CASES = ("five values", "lo == hi", "lo == hi == -0.0",
               "-FLT_MAX to FLT_MAX", "values on edges",
               "a range of a few ulps", "negatives and -0.0", "empty mask")


def assert_sums_within(sums, want, values, mask, edges):
    """Each bucket's sum within 1e-5 of the sum of its |v|."""
    v = values[mask].astype(np.float64)
    idx = kernels.float_buckets(torch.from_numpy(edges),
                                torch.from_numpy(values[mask])).numpy()
    mag = np.bincount(idx, weights=np.abs(v), minlength=len(want))
    err = np.abs(sums.astype(np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-5 * mag).all()


@pytest.mark.parametrize("name", FLOAT_CASES)
def test_float_plain_matches_jax(name):
    values, mask = float_case(name)
    values = values.astype(F32)
    lo_hi, edges, counts, sums, maxes = kernels.log_bins_float(
        torch.from_numpy(values), torch.from_numpy(mask), BUCKETS)
    jlo, jhi, jcounts, jsums, jmaxes = _bin_float(
        jnp.asarray(values), jnp.asarray(mask), BUCKETS)
    assert lo_hi.tolist() == [float(jlo), float(jhi)]
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(maxes.numpy(), np.asarray(jmaxes))
    assert_sums_within(sums.numpy(), jsums, values, mask, edges.numpy())
    assert int(counts.sum()) == int(mask.sum())


def scan_search(edges, values):
    """jnp.searchsorted(edges, values, side="right") - 1, clipped, as its
    scan (and the kernel's Edges::search) runs: ceil(log2(len + 1))
    halvings of [0, len), also where the edges decrease somewhere."""
    n = len(edges)
    low = np.zeros(len(values), np.int64)
    high = np.full(len(values), n, np.int64)
    for _ in range(n.bit_length()):
        mid = (low + high) // 2
        e = edges[mid]
        left = (values < e) | (np.isnan(e) & ~np.isnan(values))
        low, high = np.where(left, low, mid), np.where(left, mid, high)
    return np.clip(high - 1, 0, n - 2)


def jax_buckets(edges, values):
    idx = jnp.searchsorted(jnp.asarray(edges), jnp.asarray(values),
                           side="right") - 1
    return np.clip(np.asarray(idx), 0, len(edges) - 2)


def test_float_few_ulp_range_matches_jax():
    # A range of a few ulps gives edges that decrease in places; there the
    # port places each value as the JAX package's jnp.searchsorted does
    # (torch.searchsorted's binary search would place some elsewhere).
    values, mask = float_case("a range of a few ulps")
    values = values.astype(F32)
    lo_hi, edges, counts, _, maxes = kernels.log_bins_float(
        torch.from_numpy(values), torch.from_numpy(mask), BUCKETS)
    e = edges.numpy()
    assert not (e[:-1] <= e[1:]).all()
    idx = scan_search(e, values)
    np.testing.assert_array_equal(idx, jax_buckets(e, values))
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(idx, minlength=BUCKETS))
    jlo, jhi, jcounts, _, jmaxes = _bin_float(jnp.asarray(values),
                                              jnp.asarray(mask), BUCKETS)
    assert lo_hi.tolist() == [float(jlo), float(jhi)]
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(maxes.numpy(), np.asarray(jmaxes))


@pytest.mark.parametrize("case", ["shuffled", "descending", "nan edges",
                                  "nan values", "two edges",
                                  "three edges"])
def test_float_buckets_equal_jnp_searchsorted(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    n = {"two edges": 2, "three edges": 3}.get(case, 1001)
    edges = np.sort(rng.normal(size=n)).astype(F32)
    values = np.concatenate([rng.normal(size=3000), rng.choice(edges, 500),
                             [-0.0, 0.0, np.inf, -np.inf]]).astype(F32)
    if case == "shuffled":
        edges = rng.permutation(edges)
    if case == "descending":
        edges = edges[::-1].copy()
    if case == "nan edges":
        edges[rng.choice(n, 40, replace=False)] = np.nan
    if case == "nan values":
        values[rng.choice(len(values), 40, replace=False)] = np.nan
    got = kernels.float_buckets(torch.from_numpy(edges),
                                torch.from_numpy(values)).numpy()
    want = jax_buckets(edges, values)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(scan_search(edges, values), want)


# ---------------------------------------------------------------------------
# The batched integer entry


def test_many_plain_records_equal_single_calls():
    stats = []
    for name in INT_CASES:
        values, mask = int_case(name)
        stats.append((torch.from_numpy(values.astype(np.int32)),
                      torch.from_numpy(mask)))
    stats.append((torch.zeros(0, dtype=torch.int32),
                  torch.zeros(0, dtype=torch.bool)))
    packed = kernels.log_bins_int_many(stats)
    assert packed.shape == (len(stats), kernels.LOG_BINS_RECORD)
    for one, (values, mask) in zip(kernels.log_bins_int_unpack(packed),
                                   stats):
        for g, w in zip(one, kernels.log_bins_int(values, mask)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)


def test_pack_unpack_round_trip():
    values, mask = int_case("ten decades")
    one = kernels.log_bins_int(torch.from_numpy(values.astype(np.int32)),
                               torch.from_numpy(mask))
    packed = kernels.log_bins_int_pack([one, one])
    again = kernels.log_bins_int_unpack(packed)
    assert len(again) == 2
    for g, w in zip(again[1], one):
        assert torch.equal(g, w)
    # The record's bytes: counts, sums, n_bins, lowers, uppers, maxes.
    k = kernels.LOG_BIN_SLOTS
    assert kernels.LOG_BINS_RECORD == 8 * k * 2 + 8 + 4 * k * 3
    assert int(packed[0].view(torch.int64)[2 * k]) == int(one[5])


@pytest.mark.parametrize("bad", ["none", "too many", "dtype", "devices",
                                 "lengths"])
def test_many_rejects_bad_stats(bad):
    v = torch.ones(8, dtype=torch.int32)
    m = torch.ones(8, dtype=torch.bool)
    stats = {"none": [],
             "too many": [(v, m)] * (kernels.LOG_BINS_MAX_STATS + 1),
             "dtype": [(v.long(), m)],
             "devices": [(v, m), (v.to("meta"), m.to("meta"))],
             "lengths": [(v, m[:4])]}[bad]
    with pytest.raises(ValueError):
        kernels.log_bins_int_many(stats)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_call_batches_the_five_int_histograms(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    n = 3000
    pids = rng.integers(0, 80, n).astype(np.int32)
    pks = (np.power(rng.random(n), 2.5) * 40).astype(np.int32)
    values = rng.random(n) * 7.0 - 2.0
    calls = []
    many = kernels.log_bins_int_many

    def counted(stats):
        calls.append(len(stats))
        return many(stats)

    monkeypatch.setattr(kernels, "log_bins_int_many", counted)
    monkeypatch.setattr(kernels, "log_bins_int", None)
    got = convert.histograms_fields(dh.compute_dataset_histograms_device(
        pids, pks, values, device="cpu"))
    assert calls == [5]
    want = convert.histograms_fields(jax_dh.compute_dataset_histograms_device(
        pids, pks, values))
    for i in (0, 1, 2, 4, 5):
        assert got[i] == want[i]
    gf, wf = got[3][1], want[3][1]
    assert [b[:3] for b in gf] == [b[:3] for b in wf]
    np.testing.assert_allclose([b[3] for b in gf], [b[3] for b in wf],
                               rtol=1e-5, atol=1e-4)
    assert [b[4] for b in gf] == [b[4] for b in wf]


# ---------------------------------------------------------------------------
# The float bucket: guess, one step, else the binary search (numpy model
# of csrc/log_bins.cu Edges::bucket)


def model_bucket(values, edges):
    """Edges::bucket on float32 values: returns (buckets, rows that fell
    back to the binary search)."""
    n = len(edges) - 1
    lo, hi = edges[0], edges[-1]
    monotone = bool((edges[:-1] <= edges[1:]).all())
    search = scan_search(edges, values)
    if not monotone:
        return search, np.ones(len(values), bool)
    with np.errstate(all="ignore"):
        g = (values.astype(np.float64) - np.float64(lo)) * (
            np.float64(n) / (np.float64(hi) - np.float64(lo)))
    b = np.where(g >= 0, np.where(g < n - 1, np.floor(np.nan_to_num(g)),
                                  n - 1), 0).astype(np.int64)
    e0, e1 = edges[b], edges[b + 1]
    down = (e0 > values) & (b > 0)
    up = ~(e0 > values) & ~(e1 > values) & (b < n - 1)
    b = b - down + up
    e0, e1 = edges[b], edges[b + 1]
    ok = ((b == 0) | ~(e0 > values)) & ((b == n - 1) | (e1 > values))
    return np.where(ok, b, search), ~ok


RANGES = {"unit": (0.0, 1.0), "ratings": (1.0, 5.0),
          "negative": (-1234.5, -0.001), "wide": (-BIG, BIG),
          "lo == hi": (0.1, 0.1), "few ulps": (1e6, 1e6 + 1.0),
          "tiny": (1e-30, 3e-30)}


@pytest.mark.parametrize("name", sorted(RANGES))
def test_guessed_bucket_equals_searchsorted(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    lo, hi = (F32(x) for x in RANGES[name])
    edges = kernels.linspace_edges_f32(torch.tensor(lo), torch.tensor(hi),
                                       BUCKETS).numpy()
    span = np.float64(hi) - np.float64(lo)
    inside = (np.float64(lo) + rng.random(50_000) * span).astype(F32)
    on = rng.choice(edges, 20_000)
    with np.errstate(over="ignore"):  # past FLT_MAX: dropped below
        near = np.concatenate([np.nextafter(on[:10_000], F32(np.inf)),
                               np.nextafter(on[10_000:], F32(-np.inf))])
        outside = np.array([-BIG, BIG, lo, hi, -0.0, 0.0,
                            np.nextafter(lo, F32(-np.inf)),
                            np.nextafter(hi, F32(np.inf))], F32)
    values = np.concatenate([inside, on, near, outside,
                             rng.choice(inside, 10_000 - len(outside))])
    values = values[np.isfinite(values)].astype(F32)
    assert len(values) >= 99_000
    got, fell_back = model_bucket(values, edges)
    want = jax_buckets(edges, values)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(scan_search(edges, values), want)
    if name in ("unit", "ratings", "negative", "wide", "tiny"):
        # Monotone edges: the guess or one step holds for nearly all rows,
        # and torch.searchsorted's upper bound is the same bucket.
        assert fell_back.mean() < 0.01
        upper = (torch.searchsorted(torch.from_numpy(edges),
                                    torch.from_numpy(values), right=True) -
                 1).clamp(0, BUCKETS - 1).numpy()
        np.testing.assert_array_equal(upper, want)


def test_kernel_entry_edges_are_the_models():
    # The edges the model steps against are the plain version's (the
    # kernel computes the same expression, tested == on the card).
    values = np.array([1.0, 2.0, 3.0, 5.0], F32)
    _, edges, counts, _, _ = kernels.log_bins_float(
        torch.from_numpy(values), torch.ones(4, dtype=torch.bool), BUCKETS)
    got, _ = model_bucket(values, edges.numpy())
    want = np.flatnonzero(counts.numpy())
    assert sorted(set(got.tolist())) == want.tolist()


# ---------------------------------------------------------------------------
# C14


def columns(rng, cap, layout):
    """(torch buffers, numpy twins) of cap rows: layout ((dtype, width),)."""
    out = []
    for dtype, width in layout:
        shape = (cap,) + ((width,) if width > 1 else ())
        a = (rng.normal(size=shape) if np.dtype(dtype).kind == "f" else
             rng.integers(-2**30, 2**30, shape)).astype(dtype)
        out.append(a)
    return [torch.from_numpy(a.copy()) for a in out], out


LAYOUTS = {
    "host route": (((np.int32, 1), (np.int32, 1), (np.float32, 1)),
                   (0, -1, 0.0)),
    "hash route": (((np.int32, 3), (np.int32, 3), (np.float32, 1)),
                   (-1, -1, 0.0)),
    "8-byte, widths 1 and 5": (((np.int64, 1), (np.float64, 5),
                                (np.int32, 5)), (-7, -0.0, 3)),
    "float64 values, vector 5": (((np.int32, 1), (np.int32, 1),
                                  (np.float64, 5)), (0, -1, 0.0)),
}


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint64)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("cap,new_cap", [(13, 16), (16, 16), (5, 1031)])
def test_grow_matches_jax_grow_fn(layout, cap, new_cap):
    rng = np.random.default_rng(cap + new_cap)
    cols, fills = LAYOUTS[layout]
    bufs, arrays = columns(rng, cap, cols)
    got = kernels.grow_rows(bufs, new_cap, fills)
    want = jax_pipeline._grow_fn(False, fills)(
        tuple(jnp.asarray(a) for a in arrays), new_cap=new_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", [1, 5, 13, 16, 1001])
def test_fill_tail_matches_the_jax_accumulators_pad(layout, n):
    # The JAX accumulator pads a first append to executor.row_bucket(n)
    # with its fills; the port lands the rows and fills the tail.
    rng = np.random.default_rng(n)
    cols, fills = LAYOUTS[layout]
    _, arrays = columns(rng, n, cols)
    acc = jax_pipeline.DeviceRowAccumulator(donate=True, fills=fills,
                                            batch_rows=1)
    acc.append(*arrays, n)
    want = acc._bufs
    cap = want[0].shape[0]
    bufs = [torch.empty((cap,) + a.shape[1:], dtype=torch.from_numpy(a).dtype)
            for a in arrays]
    for b, a in zip(bufs, arrays):
        b[:n] = torch.from_numpy(a)
    kernels.fill_tail(bufs, n, fills)
    for g, w in zip(bufs, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))


def test_column_words_keep_the_pads_bits():
    f32, f64 = torch.float32, torch.float64
    words = kernels._column_words((
        (torch.int32, 3, -1, -1.0), (f64, 5, -0.0, -1.0), (f32, 1, 0.0, 1.0)))
    assert words == (3, 4, 0xFFFFFFFF, 5, 8, -2**63, 1, 4, 0)
    # -0.0 and 0.0 compare equal; the sign in the key keeps them apart.
    assert kernels._column_words(((f64, 1, 0.0, 1.0),))[2] == 0
    assert kernels._column_words(((f64, 1, -0.0, -1.0),))[2] == -2**63
